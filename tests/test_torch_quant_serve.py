"""Parity of the port's quantized KV serving with the JAX reference on the
CPU, on reduced dsr1d-qwen-1.5b and gpt2-xl (2 layers), for int8 pages
(per-row float32 scales) and fp8 E4M3 code pages:

  * the batcher: one seeded stream through both batchers must give the same
    greedy tokens, trace events, `PagedStats`, `AccessStats` and
    `page_bytes`, and `collect_logits` rows within 1e-4 (float32 products
    in another order, as `test_torch_models.py`);
  * Stage II: each quantized trace's sweep equals the JAX float64 numpy
    sweep (counts equal, energies rel 1e-12).

The model on these pools, step by step: `test_torch_quant_models.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.explorer import sweep as jax_sweep
from repro.models import build_model
from repro.serve import PagedContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
import repro_torch.configs as tconfigs
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.models import DecoderLM
from repro_torch.params import from_jax_params
from repro_torch.serve import PagedContinuousBatcher, PagedStats, Request

ARCHS = ["dsr1d-qwen-1.5b", "gpt2-xl"]
KV = ["int8", "fp8"]
ATOL = 1e-4
GEOMETRY = dict(num_slots=2, page_size=8, num_pages=32, max_pages_per_slot=8,
                chunk_steps=4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = reduced(get_arch(request.param), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def _stream(vocab, seed=3):
    """Ragged prompts (partial last pages) from three lengths, so the
    reference compiles three prefills."""
    rng = np.random.default_rng(seed)
    lengths = rng.choice([9, 17, 26], 5)
    budgets = rng.integers(3, 12, 5)
    return [(rng.integers(0, vocab, int(n)), int(k))
            for n, k in zip(lengths, budgets)]


@pytest.fixture(scope="module", params=KV)
def served(pair, request):
    cfg, tcfg, jm, jparams, tm, tparams = pair
    kv = request.param
    jb = JaxBatcher(jm, jparams, attn_backend="ref", kv_dtype=kv,
                    collect_logits=True, **GEOMETRY)
    tb = PagedContinuousBatcher(tm, tparams, kv_dtype=kv,
                                collect_logits=True, **GEOMETRY)
    for i, (prompt, budget) in enumerate(_stream(cfg.vocab_size)):
        jb.submit(JaxRequest(rid=i, tokens=prompt, max_new_tokens=budget))
        tb.submit(Request(rid=i, tokens=prompt, max_new_tokens=budget))
    jdone = sorted(jb.run(), key=lambda r: r.rid)
    tdone = sorted(tb.run(), key=lambda r: r.rid)
    return jb, tb, jdone, tdone


def test_quantized_serving_tokens_and_logits_match_jax(served):
    jb, tb, jdone, tdone = served
    assert tb.kv_dtype == jb.kv_dtype
    assert tb.page_bytes == jb.page_bytes
    assert tb.row_bytes == jb.row_bytes
    assert [r.rid for r in tdone] == list(range(5))
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]
    for t, j in zip(tdone, jdone):
        assert len(t.logits) == len(j.logits) == len(t.output)
        np.testing.assert_allclose(np.stack(t.logits),
                                   np.stack(j.logits).astype(np.float32),
                                   atol=ATOL, rtol=0)


def test_quantized_serving_trace_and_stats_match_jax(served):
    jb, tb, _, _ = served
    jt, tt = jb.ledger.trace, tb.ledger.trace
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.ev_dobsolete == jt.ev_dobsolete
    assert tt.capacity == jt.capacity
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    assert tb.access.n_reads("kv") == jb.access.n_reads("kv")


def test_quantized_trace_sweep_matches_jax_numpy(served):
    jb, tb, _, _ = served
    tbundle = tb.occupancy_bundle()
    m = min_capacity_mib(tbundle.traces["kv"].peak_needed())
    kw = dict(mem_name="kv", capacities_mib=[m, m + 1], banks=[1, 2, 4],
              prune=True)
    want = jax_sweep(jb.occupancy_bundle(), backend="numpy", **kw)
    got = sweep(tbundle, device="cpu", **kw)
    assert [(r.capacity_mib, r.banks, r.result.n_transitions)
            for r in got.rows] == [(r.capacity_mib, r.banks,
                                    r.result.n_transitions)
                                   for r in want.rows]
    assert len(got.rows) > 0
    for a, b in zip(got.rows, want.rows):
        assert abs(a.result.e_total / b.result.e_total - 1.0) <= 1e-12
