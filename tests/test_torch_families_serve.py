"""Parity of the port's three batchers with the JAX reference on the other
decoder families, on the CPU (reduced configs, float32, the reference's
weights through `from_jax_params`):

* `PagedContinuousBatcher` on olmoe (MoE) and mamba2 (SSD blocks only:
  pages are allocated and priced at 0 bytes, the state is dense per slot);
* `BatchedServer` on internvl2 with prefix embeddings;
* every refusal the reference makes on these stacks, in its words.

Tokens, trace events, `PagedStats` and access bytes are equal; logits
agree within 1e-4. `ContinuousBatcher` on these families is in
`test_torch_families_dense.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model as jax_build_model
from repro.models.transformer import self_spec_draft as jax_self_spec_draft
from repro.serve import BatchedServer as JaxServer
from repro.serve import PagedContinuousBatcher as JaxPaged
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
import repro_torch.configs as tconfigs
from repro_torch.models import DecoderLM, self_spec_draft
from repro_torch.params import from_jax_params
from repro_torch.serve import (BatchedServer, PagedContinuousBatcher,
                               PagedStats, Request, ServeConfig)

LOGIT_ATOL = 1e-4
PAGED = dict(num_slots=2, page_size=8, num_pages=32, max_pages_per_slot=8,
             chunk_steps=4)
# reduced depths: one or two pattern repetitions, recurrentgemma's with
# its tail block (4 = 3 + 1), llama4's one repetition (3 chunked + 1 full)
LAYERS = {"olmoe-1b-7b": 2, "mamba2-130m": 2, "recurrentgemma-2b": 4,
          "llama4-scout-17b-a16e": 4, "internvl2-2b": 2}


def models(name):
    """(cfg, port cfg, JAX model, port model) of a reduced family."""
    cfg = reduced(get_arch(name), layers=LAYERS[name])
    tcfg = tconfigs.reduced(tconfigs.get_arch(name), layers=LAYERS[name])
    jm = jax_build_model(cfg, compute_dtype=jnp.float32, remat="none")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, tm


@functools.lru_cache(maxsize=None)
def pair(name):
    """(cfg, port cfg, JAX model, its params, port model, the same params
    as tensors) for a reduced family, built once per test process (the
    reference's init dominates these tests' time)."""
    cfg, tcfg, jm, tm = models(name)
    jparams = jm.init(jax.random.PRNGKey(3))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def stream_of(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    budgets = rng.integers(3, 14, len(lengths))
    return [(rng.integers(0, vocab, int(n)), int(k))
            for n, k in zip(lengths, budgets)]


def run_both(jb, tb, stream):
    for i, (p, k) in enumerate(stream):
        jb.submit(JaxRequest(rid=i, tokens=p, max_new_tokens=k))
        tb.submit(Request(rid=i, tokens=p, max_new_tokens=k))
    jdone = sorted(jb.run(), key=lambda r: r.rid)
    tdone = sorted(tb.run(), key=lambda r: r.rid)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]
    return jdone, tdone


def same_trace(jt, tt):
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.capacity == jt.capacity
    if tt.ev_times:                  # mamba2's zero-byte pages emit none
        assert tt.as_arrays()[1][-1] == 0


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-130m"])
def test_paged_batcher_matches_jax(name):
    cfg, tcfg, jm, jparams, tm, tparams = pair(name)
    # ragged prompts within one SSD chunk (32) of the reduced mamba2, two
    # lengths (the reference compiles a prefill for each)
    stream = stream_of(cfg.vocab_size, [7, 30, 30, 7], seed=1)
    jb = JaxPaged(jm, jparams, attn_backend="ref", **PAGED)
    tb = PagedContinuousBatcher(tm, tparams, **PAGED)
    run_both(jb, tb, stream)
    assert tb.page_bytes == jb.page_bytes
    if name == "mamba2-130m":        # pages held, no KV bytes on them
        assert tb.page_bytes == 0 and tb.stats.pages_allocated > 0
    same_trace(jb.ledger.trace, tb.ledger.trace)
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    assert tb.ledger.allocator.n_allocated == 0


def test_batched_server_prefix_embeds_matches_jax():
    cfg, tcfg, jm, jparams, tm, tparams = pair("internvl2-2b")
    rng = np.random.default_rng(4)
    n_pfx = cfg.frontend.num_prefix_tokens
    prompts = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    embeds = rng.standard_normal((2, n_pfx, cfg.d_model)).astype(np.float32)
    scfg = dict(max_len=n_pfx + 11 + 6, max_new_tokens=6)
    jres = JaxServer(jm, jparams, JaxServeConfig(**scfg),
                     collect_logits=True).generate(
        {"tokens": jnp.asarray(prompts), "prefix_embeds": jnp.asarray(embeds)})
    tres = BatchedServer(tm, tparams, ServeConfig(**scfg),
                         collect_logits=True).generate(
        {"tokens": prompts, "prefix_embeds": embeds})
    np.testing.assert_array_equal(tres["tokens"], np.asarray(jres["tokens"]))
    np.testing.assert_allclose(tres["logits"], jres["logits"],
                               atol=LOGIT_ATOL, rtol=0)
    # the prefix changes what is generated
    plain = BatchedServer(tm, tparams, ServeConfig(**scfg),
                          collect_logits=True).generate({"tokens": prompts})
    assert not np.allclose(plain["logits"], tres["logits"])


def _message(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("name,kw", [
    ("recurrentgemma-2b", {}), ("llama4-scout-17b-a16e", {}),
    ("mamba2-130m", dict(prefix_cache=True)),
    ("mamba2-130m", dict(prefill_chunk_tokens=8)),
    ("mamba2-130m", dict(speculate_k=2))])
def test_paged_refusals_are_the_references(name, kw):
    """Paged decode of window-bounded stacks, and prefix caching, chunked
    prefill or speculation on stacks that are not pure full attention
    (refused before any weight is read)."""
    cfg, tcfg, jm, tm = models(name)
    want = _message(lambda: JaxPaged(jm, None, **PAGED, **kw))
    assert _message(lambda: PagedContinuousBatcher(tm, None, **PAGED,
                                                   **kw)) == want


def test_model_refusals_are_the_references():
    cfg, tcfg, jm, tm = models("recurrentgemma-2b")
    assert _message(lambda: self_spec_draft(tm, None)) == \
        _message(lambda: jax_self_spec_draft(jm, None))
    cfg, tcfg, jm, tm = models("mamba2-130m")
    tok = np.zeros((1, 4), np.int32)
    assert _message(lambda: tm.prefill_shared(
        None, {"tokens": tok}, None)) == _message(
        lambda: jm.prefill_shared(None, {"tokens": jnp.asarray(tok)}, None))
    assert _message(lambda: tm.verify_step_paged(None, None, tok)) == \
        _message(lambda: jm.verify_step_paged(None, None, jnp.asarray(tok)))
