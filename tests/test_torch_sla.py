"""Parity of the port's SLA scheduling with the JAX reference on the CPU,
like with like (`tests/test_sla_scheduling.py`'s scenarios, chunked against
the reference's chunked run, never against a monolithic one): chunked
prefill plain and on a prefix hit, and the admission queue's order.
Tokens, `PagedStats`, occupancy-trace events, per-request preemptions and
finish times must be equal. Preemption is `test_torch_sla_preempt.py`,
long prompts `test_torch_sla_long.py` (apart so that each file runs in
under a minute on one core)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.serve import PagedContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
import repro_torch.configs as tconfigs
from repro_torch.models import DecoderLM
from repro_torch.params import from_jax_params
from repro_torch.serve import (AdmissionQueue, PagedContinuousBatcher,
                               PagedStats, Request)

ARCH = "dsr1d-qwen-1.5b"
GEOMETRY = dict(num_slots=2, page_size=8, num_pages=32, max_pages_per_slot=8,
                chunk_steps=4)


@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_arch(ARCH), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, jm, jparams, tm, tparams


def _pair(small, **kw):
    _, jm, jparams, tm, tparams = small
    kw = dict(GEOMETRY, **kw)
    return (JaxBatcher(jm, jparams, attn_backend="ref", **kw),
            PagedContinuousBatcher(tm, tparams, **kw))


def _submit(jb, tb, rid, tokens, new, **kw):
    jb.submit(JaxRequest(rid=rid, tokens=tokens, max_new_tokens=new, **kw))
    tb.submit(Request(rid=rid, tokens=tokens, max_new_tokens=new, **kw))


def _assert_same(jb, tb, jdone, tdone, logits=False):
    jdone = sorted(jdone, key=lambda r: r.rid)
    tdone = sorted(tdone, key=lambda r: r.rid)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.preemptions for r in tdone] == [r.preemptions for r in jdone]
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    names = ("trace", "logical") if tb.prefix_cache else ("trace",)
    for name in names:
        jt, tt = getattr(jb.ledger, name), getattr(tb.ledger, name)
        assert tt.ev_times == jt.ev_times
        assert tt.ev_dneeded == jt.ev_dneeded
        assert tt.ev_dobsolete == jt.ev_dobsolete
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    if logits:
        for j, t in zip(jdone, tdone):
            err = np.abs(np.stack(t.logits) - np.stack(j.logits)).max()
            assert err <= 1e-4


# ------------------------------------------------------------ chunked prefill
def test_chunked_prefill_matches_reference_chunked(small):
    """Prompts of 40, 17 and 33 tokens in 16-token slices, one slot: the
    port's chunked run against the reference's chunked run (the reference
    fails its own chunked-vs-monolithic bit identity, so like with like),
    logits within 1e-4."""
    cfg = small[0]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 17, 33)]
    jb, tb = _pair(small, num_slots=1, prefill_chunk_tokens=16,
                   collect_logits=True)
    for i, (p, n) in enumerate(zip(prompts, (6, 5, 7))):
        _submit(jb, tb, i, p, n)
    _assert_same(jb, tb, jb.run(), tb.run(), logits=True)
    assert tb.stats.prefill_slices >= 3 + 3      # 40 -> 3 slices, 33 -> 3


def test_chunked_prefill_validation(small):
    _, _, _, tm, tparams = small
    for bad in (12, 0):
        with pytest.raises(ValueError, match="multiple of"):
            PagedContinuousBatcher(tm, tparams, prefill_chunk_tokens=bad,
                                   **GEOMETRY)
    with pytest.raises(ValueError, match="on_long_prompt"):
        PagedContinuousBatcher(tm, tparams, on_long_prompt="drop",
                               **GEOMETRY)


def test_chunked_suffix_on_prefix_hit(small):
    """The reference's `test_chunked_suffix_prefill_on_prefix_hit_bit_
    identical` stream: two prompts sharing a 21-token (mid-page) prefix,
    served with the prefix cache and the suffix sliced."""
    cfg = small[0]
    rng = np.random.default_rng(17)
    shared = rng.integers(0, cfg.vocab_size, 21)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (37, 41)]
    jb, tb = _pair(small, num_slots=1, num_pages=64, max_pages_per_slot=12,
                   prefix_cache=True, prefill_chunk_tokens=16)
    for i, (p, n) in enumerate(zip(prompts, (6, 5))):
        _submit(jb, tb, i, p, n)
    _assert_same(jb, tb, jb.run(), tb.run())
    assert tb.stats.prefix_hits == 1
    assert tb.stats.prefill_slices >= 4 + 3


# ------------------------------------------------------------ priorities
def test_priority_queue_orders_classes_fifo_within():
    q = AdmissionQueue()
    for i, p in enumerate([0, 2, 1, 2, 0]):
        q.push(Request(rid=i, tokens=np.arange(4), priority=p))
    assert [q.pop().rid for _ in range(5)] == [1, 3, 2, 0, 4]
    assert len(q) == 0


