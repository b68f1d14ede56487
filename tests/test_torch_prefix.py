"""Parity of the port's prefix sharing with the JAX reference on the CPU:
`serve.prefix` (refcounted allocator, radix index, dual-trace ledger) under
one scripted sequence of verbs; the model's page verbs
(`gather_prefix_pages`, `prefix_tail_rows`, `write_shared_prefill_to_pages`,
`copy_pages`) bit for bit on native, int8 and fp8 pools; `prefill_shared`
against the reference's (which pads its keys to `pad_to`); and
`PagedContinuousBatcher(prefix_cache=True)` against the JAX batcher under
identical prompts (the shared-prefix harness on all three pools is
`test_torch_prefix_serve.py`, eviction and speculation
`test_torch_prefix_spec.py`, kept apart so each file runs in under a
minute on one core). The copies of `obs/telemetry.py` and
`traffic/generators.py` are held to their originals."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.telemetry as jtel
import repro.serve.prefix as jprefix
import repro.traffic.generators as jgen
from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.models import transformer as jtf
from repro.serve import PagedContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
import repro_torch.configs as tconfigs
import repro_torch.obs.telemetry as ttel
import repro_torch.serve.prefix as tprefix
import repro_torch.traffic.generators as tgen
from repro_torch.kernels.quant import to_fp8_codes
from repro_torch.models import DecoderLM
from repro_torch.models import transformer as ttf
from repro_torch.params import from_jax_params
from repro_torch.serve import PagedContinuousBatcher, PagedStats, Request

ARCH = "dsr1d-qwen-1.5b"
GEOMETRY = dict(num_slots=2, page_size=8, num_pages=64, max_pages_per_slot=8,
                chunk_steps=4)


@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_arch(ARCH), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def _shared_prompts(vocab, seed=0):
    """The reference tests' harness (`tests/test_prefix_serving.py`): three
    prompts sharing a 21-token prefix (mid-page for page_size 8) plus one
    unshared prompt."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 21)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, k)])
               for k in (9, 5, 13)]
    prompts.append(rng.integers(0, vocab, 11))
    return prompts, [7, 9, 6, 8]


# ------------------------------------------------------------ serve.prefix
def _ledger_script(mod):
    """One fixed sequence of ledger verbs, with everything observable
    logged: probes, admissions, inserts, a COW split, growth, a draft lane
    with a rollback, retirement and LRU eviction, refcounts after each."""
    ps = 4
    L = mod.SharedKVLedger(20, 100, ps, num_slots=3, max_pages_per_slot=6)
    L.enable_draft_lane(40)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 50, 10)
    prompts = [np.r_[base, rng.integers(0, 50, k)] for k in (3, 6, 1)]
    prompts.append(rng.integers(0, 50, 9))
    log = []

    def state(tag):
        log.append((tag, dict(sorted(L.allocator._refs.items())),
                    sorted(L.index.pages()), L.allocator.n_free,
                    {k: list(v) for k, v in L.slot_pages.items()},
                    {k: list(v) for k, v in L.draft_pages.items()}))

    t = 0.0
    for slot, p in enumerate(prompts[:3]):
        m = L.index.probe(p, limit=len(p) - 1)
        log.append(("probe", list(m.pages), m.tail_page, m.tail_tokens,
                    m.tokens(ps)))
        fresh = L.admit(slot, mod.pages_for(len(p), ps) - len(m.pages), t,
                        shared=m.pages)
        log.append(("admit", fresh,
                    L.insert_run(p, L.slot_pages[slot], t)))
        state("admitted")
        t += 0.5
    # slot 0's decode writes into its cached partial page: COW it
    idx = len(L.slot_pages[0]) - 1
    log.append(("cow", L.cow(0, idx, t)))
    with pytest.raises(ValueError):
        L.cow(0, idx, t)                    # now private
    log.append(("grow", L.grow(0, 6, t), L.grow(0, 6, t)))
    log.append(("draft", L.admit_draft(1, 4, t), L.grow_draft(1, 5, t)))
    log.append(("truncate", L.truncate_rows(1, 9, t + 0.25)))
    state("grown")
    log.append(("retire", L.retire(1, t + 1), L.retire(2, t + 1)))
    state("retired")
    log.append(("evict", L.evict_for(3, t + 2), L.index.runs()))
    m = L.index.probe(prompts[3])
    log.append(("miss", list(m.pages), m.tail_page, m.tail_tokens))
    log.append(("retire", L.retire(0, t + 3), L.evict_for(100, t + 4)))
    state("drained")
    log.append(("bytes", L.occupancy_bytes(), L.logical_bytes()))
    for tr in (L.trace, L.logical):
        log.append((tr.mem_name, tr.capacity, tr.ev_times, tr.ev_dneeded,
                    tr.ev_dobsolete))
    return log


def test_prefix_ledger_matches_reference():
    got, want = _ledger_script(tprefix), _ledger_script(jprefix)
    assert got == want
    assert any(e[0] == "evict" and e[1] > 0 for e in got)
    kv = got[-2]
    assert sum(kv[3]) == 0 and sum(kv[4]) == 0 and min(kv[4]) < 0  # drained


def test_shared_allocator_refcounts():
    for mod in (tprefix, jprefix):
        a = mod.SharedPageAllocator(4)
        p = a.alloc(2)
        a.retain(p)
        assert a.release(p) == [] and a.refcount(p[0]) == 1
        assert a.release(p) == p and a.n_free == 3
        with pytest.raises(ValueError):
            a.release(p[:1])
        with pytest.raises(ValueError):
            a.retain(p[:1])


# ------------------------------------------------------------ page verbs
def _caches(cfg, kv, seed):
    """A JAX paged cache for 2 slots x 12 pages of 8 rows with seeded pool
    contents, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    jc = jtf.init_paged_cache(cfg, 2, 12, 8, 6, dtype=jnp.float32,
                              kv_dtype=kv)
    e = dict(jc["slots"][0])
    for key in ("kp", "vp"):
        x = rng.normal(size=e[key].shape).astype(np.float32)
        if kv == "int8":
            x = rng.integers(-127, 128, e[key].shape).astype(np.int8)
        elif kv == "fp8":
            x = to_fp8_codes(torch.from_numpy(4 * x)).numpy()
        e[key] = jnp.asarray(x)
    for key in ("ks", "vs"):
        if key in e:
            e[key] = jnp.asarray(rng.uniform(1e-3, 0.1, e[key].shape)
                                 .astype(np.float32))
    jc = dict(jc, slots=[e])
    tc = {"slots": [{k: torch.from_numpy(np.array(v)) for k, v in e.items()}],
          "pos": torch.from_numpy(np.array(jc["pos"])),
          "page_table": torch.from_numpy(np.array(jc["page_table"])),
          "active": torch.from_numpy(np.array(jc["active"]))}
    return jc, tc


def _same_cache(jc, tc):
    for key, a in jc["slots"][0].items():
        np.testing.assert_array_equal(tc["slots"][0][key].numpy(),
                                      np.asarray(a))
    for key in ("pos", "page_table", "active"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))


@pytest.mark.parametrize("kv", ["native", "int8", "fp8"])
def test_page_verbs_match_reference_bit_for_bit(small, kv):
    cfg, tcfg = small[:2]
    jc, tc = _caches(cfg, kv, seed=11)
    ids, m, j = [5, 2, 9], 21, 5            # 2 full pages + 5 tail rows
    jp = jtf.gather_prefix_pages(cfg, jc, jnp.asarray(ids), m)
    tp = ttf.gather_prefix_pages(tcfg, tc, ids, m)
    for key in ("k", "v"):
        got, want = tp["slots"][0][key], np.asarray(jp["slots"][0][key])
        assert got.shape == want.shape == (2, 1, m, 2, cfg.head_dim)
        np.testing.assert_array_equal(got.numpy(), want)
        if kv != "native":
            assert got.dtype == torch.float32
    jh, th = jtf.prefix_tail_rows(jp, j), ttf.prefix_tail_rows(tp, j)
    np.testing.assert_array_equal(th["slots"][0]["k"].numpy(),
                                  np.asarray(jh["slots"][0]["k"]))
    rng = np.random.default_rng(12)
    suf = {key: rng.normal(size=(2, 1, 14, 2, cfg.head_dim))
           .astype(np.float32) for key in ("k", "v")}
    jsuf = {"slots": [{k: jnp.asarray(v) for k, v in suf.items()}],
            "tail": []}
    tsuf = {"slots": [{k: torch.from_numpy(v) for k, v in suf.items()}],
            "tail": []}
    jc = jtf.write_shared_prefill_to_pages(
        cfg, jc, jsuf, jh, 1, jnp.asarray(ids[:2], jnp.int32),
        jnp.asarray([7, 3, 11], jnp.int32))
    ttf.write_shared_prefill_to_pages(tcfg, tc, tsuf, th, 1, ids[:2],
                                      [7, 3, 11])
    _same_cache(jc, tc)
    assert int(tc["pos"][1]) == 16 + j + 14
    jc = jtf.copy_pages(cfg, jc, jnp.int32(3), jnp.int32(4))
    ttf.copy_pages(tcfg, tc, 3, 4)
    _same_cache(jc, tc)


def test_prefill_shared_matches_reference(small):
    """Suffix logits within 1e-4 and suffix KV within 1e-5 of the
    reference's fixed-width (`pad_to`) shared prefill, from the same
    gathered prefix; and the suffix's logits agree with a plain prefill of
    the whole prompt."""
    cfg, tcfg, jm, jparams, tm, tparams = small
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab_size, 30)
    m = 21
    _, dense = jm.prefill(jparams, {"tokens": jnp.asarray(prompt[None, :m])},
                          cache_len=m)
    pfx = {key: np.array(dense["slots"][0][key]) for key in ("k", "v")}
    jpfx = {"slots": [{k: jnp.asarray(v) for k, v in pfx.items()}],
            "tail": []}
    tpfx = {"slots": [{k: torch.from_numpy(v) for k, v in pfx.items()}],
            "tail": []}
    suffix = prompt[None, m:]
    jl, jkv = jm.prefill_shared(jparams, {"tokens": jnp.asarray(suffix)},
                                jpfx, pad_to=64)
    tl, tkv = tm.prefill_shared(tparams, {"tokens": torch.from_numpy(suffix)},
                                tpfx, pad_to=64)
    assert tl.shape == jl.shape
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= 1e-4
    for key in ("k", "v"):
        got = tkv["slots"][0][key].numpy()
        want = np.asarray(jkv["slots"][0][key])
        assert got.shape == want.shape == (2, 1, 9, 2, cfg.head_dim)
        assert float(np.abs(got - want).max()) <= 1e-5
    full, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt[None])},
                         32)
    assert float((full - tl).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="pad_to"):
        tm.prefill_shared(tparams, {"tokens": torch.from_numpy(suffix)},
                          tpfx, pad_to=16)


# ------------------------------------------------------------ the batcher
def _run_both(small, prompts, new, **kw):
    cfg, tcfg, jm, jparams, tm, tparams = small
    geo = dict(GEOMETRY, **{k: v for k, v in kw.items() if k in GEOMETRY})
    extra = {k: v for k, v in kw.items() if k not in GEOMETRY}
    jb = JaxBatcher(jm, jparams, attn_backend="ref", **geo, **extra)
    tb = PagedContinuousBatcher(tm, tparams, **geo, **extra)
    outs = []
    for b, cls in ((jb, JaxRequest), (tb, Request)):
        for i, (p, n) in enumerate(zip(prompts, new)):
            b.submit(cls(rid=i, tokens=p, max_new_tokens=n))
        outs.append([r.output for r in sorted(b.run(), key=lambda r: r.rid)])
    return jb, tb, outs[0], outs[1]


def assert_same_prefix_run(jb, tb, jout, tout):
    assert tout == jout and len(tout) > 0
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    for name in ("trace", "logical"):
        jt, tt = getattr(jb.ledger, name), getattr(tb.ledger, name)
        assert (tt.mem_name, tt.capacity) == (jt.mem_name, jt.capacity)
        assert tt.ev_times == jt.ev_times
        assert tt.ev_dneeded == jt.ev_dneeded
        assert tt.ev_dobsolete == jt.ev_dobsolete
    assert tb.ledger.allocator._refs == jb.ledger.allocator._refs
    assert sorted(tb.ledger.index.pages()) == sorted(jb.ledger.index.pages())
    assert tb.ledger.index.runs() == jb.ledger.index.runs()
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    jbun, tbun = jb.occupancy_bundle(), tb.occupancy_bundle()
    assert tbun.graph_name == jbun.graph_name
    assert tbun.total_time == jbun.total_time
    assert sorted(tbun.traces) == ["kv", "kv_logical"]


def test_identical_prompts_share_pages(small):
    """Two identical 30-token prompts: 29 tokens reused (3 full pages + 5
    rows of the cached partial page), a COW split, physical below
    logical, as the reference's own test asserts of itself."""
    vocab = small[0].vocab_size
    prompt = np.random.default_rng(1).integers(0, vocab, 30)
    jb, tb, jout, tout = _run_both(small, [prompt, prompt], [6, 6],
                                   prefix_cache=True)
    assert_same_prefix_run(jb, tb, jout, tout)
    assert tout[0] == tout[1]
    assert tb.stats.prefix_hits == 1
    assert tb.stats.prefix_tokens_reused == 29
    assert tb.stats.cow_splits >= 1


# ------------------------------------------------------------ the copies
@pytest.mark.parametrize("port,ref", [(ttel, jtel), (tgen, jgen)],
                         ids=["telemetry", "generators"])
def test_copied_module_equals_original(port, ref):
    """The copy's code is the original's: the same syntax tree once the
    module docstrings (which name the copy) are dropped."""
    def tree(mod):
        t = ast.parse(Path(mod.__file__).read_text())
        t.body = t.body[1:] if isinstance(t.body[0], ast.Expr) else t.body
        return ast.dump(t)
    assert tree(port) == tree(ref)


def test_telemetry_copy_behaves_as_original():
    xs = np.random.default_rng(0).lognormal(0, 2, 500)
    got = []
    for mod in (ttel, jtel):
        tel = mod.Telemetry(enabled=True)
        tel.counter("c").inc(3)
        tel.gauge("g").set(7)
        tel.gauge("g").set(2)
        h = tel.histogram("h")
        h.observe_array(xs)
        other = mod.Telemetry(enabled=True)
        other.histogram("h").observe(5.0, n=4)
        tel.merge(other)
        tel.add_span("s", 0.0, 1.5, rid=1)
        got.append((tel.snapshot(), [h.quantile(q) for q in
                                     (0.0, 0.5, 0.9, 0.99, 1.0)],
                    mod.noop_registry().enabled,
                    list(mod.log_bucket_edges()[:5])))
    assert got[0] == got[1]


def test_generators_copy_behaves_as_original():
    lengths = tgen.LengthModel(prompt_mean=128, prompt_sigma=0.5,
                               output_mean=64, max_len=1024)
    jlengths = jgen.LengthModel(prompt_mean=128, prompt_sigma=0.5,
                                output_mean=64, max_len=1024)
    for wl in ("chat_sysprompt", "fewshot", "agentic_fanout", "plain"):
        got = tgen.generate_workload(wl, 4.0, 8.0, seed=3, lengths=lengths,
                                     prefix_len=384, sharing=4)
        want = jgen.generate_workload(wl, 4.0, 8.0, seed=3,
                                      lengths=jlengths, prefix_len=384,
                                      sharing=4)
        assert [tuple(vars(s).values()) for s in got] == \
            [tuple(vars(s).values()) for s in want]
        toks = tgen.materialize_tokens(got, 1000, seed=3)
        assert all(np.array_equal(a, b) for a, b in
                   zip(toks, jgen.materialize_tokens(want, 1000, seed=3)))
