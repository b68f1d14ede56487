"""Parity of the port's priority preemption with the JAX reference on the
CPU (`tests/test_sla_scheduling.py`'s scenarios): a higher-priority arrival
preempting a slot, and preempting a page holder under pool pressure, each
with and without the prefix cache; equal priorities never preempting.
Tokens, `PagedStats`, trace events, per-request preemptions and finish
times must be equal."""
import numpy as np
import pytest

from repro.serve import Request as JaxRequest
from repro_torch.serve import Request
from test_torch_sla import _assert_same, _pair, _submit, small  # noqa: F401


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preemption_frees_slot_for_high_priority(small, prefix_cache):
    """One slot: rid 0 decodes a chunk, then a priority-1 arrival preempts
    it; the victim requeues and re-prefills from scratch."""
    cfg = small[0]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (10, 14, 12)]
    jb, tb = _pair(small, num_slots=1, chunk_steps=2,
                   prefix_cache=prefix_cache)
    dones = []
    for b in (jb, tb):
        cls = JaxRequest if b is jb else Request
        b.submit(cls(rid=0, tokens=prompts[0], max_new_tokens=20))
        b._admit([])
        done = []
        b._decode_chunk(done)
        b.submit(cls(rid=1, tokens=prompts[1], max_new_tokens=20,
                     priority=1))
        b.submit(cls(rid=2, tokens=prompts[2], max_new_tokens=20))
        dones.append(done + b.run())
    _assert_same(jb, tb, *dones)
    by = {r.rid: r for r in dones[1]}
    assert by[0].preemptions >= 1 and tb.stats.preemptions >= 1
    assert by[1].finished_s < by[0].finished_s
    assert tb.ledger.allocator.n_allocated == (
        tb.ledger.index.n_cached_pages if prefix_cache else 0)


def test_equal_priority_never_preempts(small):
    cfg = small[0]
    rng = np.random.default_rng(14)
    jb, tb = _pair(small, num_slots=1, chunk_steps=2)
    for i in range(3):
        _submit(jb, tb, i, rng.integers(0, cfg.vocab_size, 8), 6,
                priority=5)
    tdone = tb.run()
    _assert_same(jb, tb, jb.run(), tdone)
    assert tb.stats.preemptions == 0
    assert [r.rid for r in tdone] == [0, 1, 2]


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preemption_on_page_pressure(small, prefix_cache):
    """Slots are free but the pool is not: a high-priority head evicts a
    lower-priority page holder (with the prefix cache, after evicting
    whatever cached prefixes it can)."""
    cfg = small[0]
    jb, tb = _pair(small, num_pages=7, max_pages_per_slot=6, chunk_steps=2,
                   prefix_cache=prefix_cache)
    dones = []
    for b in (jb, tb):
        cls = JaxRequest if b is jb else Request
        b.submit(cls(rid=0, tokens=np.arange(33) % cfg.vocab_size,
                     max_new_tokens=8))
        b._admit([])
        b.submit(cls(rid=1, tokens=(np.arange(33) * 5) % cfg.vocab_size,
                     max_new_tokens=8, priority=3))
        dones.append(b.run())
    _assert_same(jb, tb, *dones)
    by = {r.rid: r for r in dones[1]}
    assert tb.stats.preemptions >= 1
    assert by[1].finished_s < by[0].finished_s
