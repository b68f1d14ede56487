"""Parity of the port's speculative paged serving with the JAX reference on
the CPU, where every wrapper runs its plain PyTorch version.

* the verify plain version (`repro_torch.kernels.paged_gqa_verify`) against
  the JAX oracle and the Pallas kernel in interpret mode (2e-5, float32
  softmaxes taken in another order), on float32 and fp8 pools; its row v is
  bit-equal to the port's decode plain version at base + v + 1;
* `verify_step_paged` logits against JAX's (1e-4) on reduced dsr1d and
  gpt2-xl, and `self_spec_draft`'s views;
* the port's speculative batcher on its own: the skip=1 oracle accepts
  everything, an EOS inside the window is clipped, rollback frees pages
  mid-stream, the ledger's draft lane, and the reference's validation
  messages. Its parity with the JAX batcher is `test_torch_spec_serve.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels.paged_gqa_verify import paged_gqa_verify as jax_verify
from repro.kernels.quant import to_fp8_codes as jax_fp8_codes
from repro.models import build_model
from repro.models.transformer import init_paged_cache as jax_init_paged
from repro.models.transformer import \
    write_prefill_to_pages as jax_write_pages
import repro_torch.configs as tconfigs
from repro_torch.kernels.paged_gqa_decode import paged_gqa_decode_ref
from repro_torch.kernels.paged_gqa_verify import (paged_gqa_verify,
                                                  paged_gqa_verify_ref)
from repro_torch.kernels.quant import to_fp8_codes
from repro_torch.models import (DecoderLM, init_paged_cache, self_spec_draft,
                                write_prefill_to_pages)
from repro_torch.params import from_jax_params, init_params
from repro_torch.serve import PagedContinuousBatcher, PagedKVLedger, Request

ATOL = 2e-5
LOGIT_ATOL = 1e-4
ARCH = "dsr1d-qwen-1.5b"
GEOMETRY = dict(num_slots=2, page_size=8, num_pages=64, max_pages_per_slot=8,
                chunk_steps=4)


def _verify_case(seed, B, H, K, d, ps, P, N, V):
    """As the reference's `tests/test_kernels.py:_verify_case`: random pools
    and ragged base lengths; every slot's table covers base + V rows, and
    slot 0's base is a page multiple (an exactly full and a partial last
    page)."""
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(N, K, ps, d)).astype(np.float32)
    vp = rng.normal(size=(N, K, ps, d)).astype(np.float32)
    q = rng.normal(size=(B, V, H, d)).astype(np.float32)
    cap = P * ps - V
    base = rng.integers(1, cap + 1, B)
    base[0] = min(ps * max(1, int(base[0]) // ps), cap)
    table = np.zeros((B, P), np.int32)
    ids = list(range(1, N))
    rng.shuffle(ids)
    for b in range(B):
        for j in range(-(-(int(base[b]) + V) // ps)):
            table[b, j] = ids.pop()
    return q, kp, vp, table, base.astype(np.int32)


@pytest.mark.parametrize("pools", ["float32", "fp8"])
@pytest.mark.parametrize("B,H,K,d,ps,P,N,V", [
    (2, 4, 4, 32, 8, 4, 12, 3),    # MHA
    (3, 8, 2, 64, 16, 3, 16, 4),   # GQA group 4
    (2, 12, 3, 32, 8, 4, 12, 5),   # non-power-of-two heads
])
def test_verify_plain_version_matches_jax(B, H, K, d, ps, P, N, V, pools):
    q, kp, vp, table, base = _verify_case(20 + B + V, B, H, K, d, ps, P, N,
                                          V)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    if pools == "fp8":
        jk, jv = jax_fp8_codes(jk), jax_fp8_codes(jv)
        tk, tv = to_fp8_codes(tk), to_fp8_codes(tv)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(base))
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
             torch.from_numpy(base))
    got = paged_gqa_verify(*targs)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  paged_gqa_verify_ref(*targs).numpy())
    for backend in ("ref", "interpret"):
        want = np.asarray(jax_verify(*jargs, backend=backend))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_verify_rows_are_decode_rows_bit_for_bit():
    """Row v of the verify plain version is the decode plain version at
    base + v + 1, so speculative logits equal stepping token by token."""
    q, kp, vp, table, base = map(torch.from_numpy, _verify_case(
        31, 2, 8, 2, 32, 8, 4, 16, 3))
    out = paged_gqa_verify(q, kp, vp, table, base)
    for v in range(3):
        row = paged_gqa_decode_ref(q[:, v], kp, vp, table, base + v + 1)
        assert torch.equal(out[:, v], row)


@pytest.fixture(scope="module", params=[ARCH, "gpt2-xl"])
def pair2(request):
    cfg = reduced(get_arch(request.param), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def test_verify_step_logits_match_jax(pair2):
    """Two slots prefilled into pages, then one V = 3 window each through
    `verify_step_paged` in both packages: logits within 1e-4, pools after
    the window's scatter within 1e-4, and `pos` left where it was."""
    cfg, tcfg, jm, jparams, tm, tparams = pair2
    rng = np.random.default_rng(3)
    ps, P, N, V = 8, 6, 24, 3
    jcache = jax_init_paged(cfg, 2, N, ps, P, dtype=jnp.float32)
    tcache = init_paged_cache(tcfg, 2, N, ps, P, dtype=torch.float32,
                              device="cpu")
    first_page = 1
    for slot, n in enumerate((15, 9)):
        prompt = rng.integers(0, cfg.vocab_size, n)
        npg = -(-(n + V) // ps)
        pages = np.arange(first_page, first_page + npg, dtype=np.int32)
        first_page += npg
        L = -(-n // ps) * ps
        _, jd = jm.prefill(jparams, {"tokens": jnp.asarray(prompt[None])}, L)
        _, td = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt[None])},
                           L)
        held = pages[:L // ps]
        jcache = jax_write_pages(cfg, jcache, jd, slot, jnp.asarray(held))
        write_prefill_to_pages(tcfg, tcache, td, slot, torch.from_numpy(held))
        jcache["page_table"] = jcache["page_table"].at[slot, :npg].set(
            jnp.asarray(pages))
        tcache["page_table"][slot, :npg] = torch.from_numpy(pages)
    window = rng.integers(0, cfg.vocab_size, (2, V))
    jl, jcache = jm.verify_step_paged(jparams, jcache, jnp.asarray(window),
                                      attn_backend="ref")
    tl, tcache = tm.verify_step_paged(tparams, tcache,
                                      torch.from_numpy(window))
    assert tl.shape == (2, V, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [15, 9])
    np.testing.assert_allclose(tcache["slots"][0]["kp"].numpy(),
                               np.asarray(jcache["slots"][0]["kp"]),
                               atol=LOGIT_ATOL, rtol=0)


def test_self_spec_draft_slices_views(pair2):
    _, tcfg, _, _, tm, tparams = pair2
    draft, dparams = self_spec_draft(tm, tparams, skip=2)
    assert draft.cfg.num_layers == 1
    assert draft.cfg.name == f"{tcfg.name}-selfspec2"
    full = tparams["blocks"][0]["attn"]["wq"]
    cut = dparams["blocks"][0]["attn"]["wq"]
    assert cut.shape == (1,) + full.shape[1:]
    # a view of the target's storage, not a copy
    assert cut.untyped_storage().data_ptr() == \
        full.untyped_storage().data_ptr()
    assert dparams["embed"] is tparams["embed"]
    with pytest.raises(ValueError, match="skip"):
        self_spec_draft(tm, tparams, skip=0)


# ------------------------------------------------------------- the batcher
@pytest.fixture(scope="module")
def small4():
    """4 layers, so the skip-2 self-spec draft (2 layers) is a different
    model that rejects candidates."""
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=4)
    tparams = init_params(tcfg, torch.Generator().manual_seed(1),
                          device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (7, 12, 5)]
    return tm, tparams, prompts


def _serve(batcher, request_cls, prompts, new, eos=None):
    for i, (p, n) in enumerate(zip(prompts, new)):
        batcher.submit(request_cls(rid=i, tokens=p, max_new_tokens=n,
                                   eos_id=eos))
    return [r.output for r in sorted(batcher.run(), key=lambda r: r.rid)]


def test_oracle_draft_accepts_everything(small4):
    """skip=1 self-speculation is the target: every candidate is accepted,
    k + 1 tokens per full round."""
    tm, tparams, prompts = small4
    new = [12, 12]
    ref = _serve(PagedContinuousBatcher(tm, tparams, **GEOMETRY), Request,
                 prompts[:2], new)
    draft, dparams = self_spec_draft(tm, tparams, skip=1)
    tb = PagedContinuousBatcher(tm, tparams, speculate_k=3,
                                draft_model=draft, draft_params=dparams,
                                **GEOMETRY)
    assert _serve(tb, Request, prompts[:2], new) == ref
    # 11 decode tokens per request at 4 per round: 3 rounds each
    assert tb.stats.spec_rounds == 6
    assert tb.stats.accepted_tokens == 22


def test_eos_inside_the_window_is_clipped(small4):
    """An EOS landing mid-window stops the request exactly where the
    sequential loop stops; tokens after it are dropped."""
    tm, tparams, prompts = small4
    new = [30, 30]
    ref = _serve(PagedContinuousBatcher(tm, tparams, **GEOMETRY), Request,
                 prompts[:2], new)
    eos = int(ref[0][5])
    ref_eos = _serve(PagedContinuousBatcher(tm, tparams, **GEOMETRY),
                     Request, prompts[:2], new, eos=eos)
    assert len(ref_eos[0]) <= 6 < len(ref[0])
    tb = PagedContinuousBatcher(tm, tparams, speculate_k=3, **GEOMETRY)
    assert _serve(tb, Request, prompts[:2], new, eos=eos) == ref_eos
    assert tb.ledger.allocator.n_allocated == 0


def test_rollback_frees_pages_midstream(small4):
    """Rejected tails free pages before the final retire: the trace has
    more negative deltas than requests, integrates to zero, and the
    allocator drains."""
    tm, tparams, prompts = small4
    tb = PagedContinuousBatcher(tm, tparams, speculate_k=3, **GEOMETRY)
    _serve(tb, Request, prompts[:2], [16, 18])
    st = tb.stats
    assert st.rolled_back_pages > 0
    assert st.pages_freed > st.rolled_back_pages
    ev = np.asarray(tb.ledger.trace.ev_dneeded)
    assert (ev < 0).sum() > 2
    assert ev.sum() == 0
    assert tb.ledger.allocator.n_allocated == 0
    assert tb.ledger.draft_pages == {} and tb.ledger.occupancy_bytes() == 0


def test_ledger_draft_lane_prices_and_truncates():
    led = PagedKVLedger(32, 100, page_size=4)
    led.enable_draft_lane(40)
    led.admit(0, 3, 0.0)
    led.admit_draft(0, 3, 0.0)
    led.grow(0, 5, 1.0)
    led.grow_draft(0, 5, 1.0)
    assert led.occupancy_bytes() == 5 * 100 + 5 * 40
    freed_t, freed_d = led.truncate_rows(0, 9, 2.0)       # keep 3 pages
    assert len(freed_t) == len(freed_d) == 2
    assert led.trace.ev_dneeded[-2:] == [-200, -80]
    assert led.retire(0, 3.0) == 6
    assert led.allocator.n_allocated == 0 and sum(led.trace.ev_dneeded) == 0


def test_spec_validation_matches_the_reference(small4):
    tm, tparams, _ = small4
    with pytest.raises(ValueError, match="speculate_k must be >= 1"):
        PagedContinuousBatcher(tm, tparams, speculate_k=0, **GEOMETRY)
    with pytest.raises(NotImplementedError, match="collect_logits"):
        PagedContinuousBatcher(tm, tparams, speculate_k=2,
                               collect_logits=True, **GEOMETRY)
    with pytest.raises(NotImplementedError, match="int8"):
        PagedContinuousBatcher(tm, tparams, speculate_k=2, kv_dtype="int8",
                               **GEOMETRY)
    draft, _ = self_spec_draft(tm, tparams, skip=2)
    with pytest.raises(ValueError, match="together"):
        PagedContinuousBatcher(tm, tparams, speculate_k=2, draft_model=draft,
                               **GEOMETRY)
    # speculation composes with the prefix cache, as in the reference (its
    # parity is tests/test_torch_prefix_spec.py): the draft lane rides the
    # shared ledger
    cb = PagedContinuousBatcher(tm, tparams, speculate_k=2, prefix_cache=True,
                                **GEOMETRY)
    assert cb.ledger.draft_page_bytes == cb.draft_page_bytes
    cache = init_paged_cache(tm.cfg, 1, 4, 8, 2, dtype=torch.float32,
                             device="cpu", kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8 KV pages"):
        tm.verify_step_paged(tparams, cache, torch.zeros((1, 2),
                                                         dtype=torch.long))
