"""Parity of the port's long-prompt handling with the JAX reference on the
CPU (`tests/test_sla_scheduling.py`'s scenarios): a long prompt admitted in
chunked slices while a short request streams between them, and
`on_long_prompt` reject / truncate in the dense and the paged batcher
(plain, prefix-cached and speculative)."""
import numpy as np
import pytest

from repro.serve import OutOfPages as JaxOutOfPages
from repro.serve import Request as JaxRequest
from repro.serve.scheduler import ContinuousBatcher as JaxDense
from repro_torch.serve import ContinuousBatcher, OutOfPages, Request
from test_torch_sla import _assert_same, _pair, _submit, small  # noqa: F401


def test_chunked_prefill_interleaves_decode_between_slices(small):
    """A 48-token prompt admitted in slices while a short request streams
    its tokens between them."""
    cfg = small[0]
    rng = np.random.default_rng(12)
    short = rng.integers(0, cfg.vocab_size, 9)
    long = rng.integers(0, cfg.vocab_size, 48)
    jb, tb = _pair(small, prefill_chunk_tokens=16)
    _submit(jb, tb, 0, short, 12)
    _submit(jb, tb, 1, long, 5)
    tdone = tb.run()
    _assert_same(jb, tb, jb.run(), tdone)
    assert tb.stats.prefill_slices >= 3
    assert tb.stats.peak_active_slots == 2
    assert tb.ledger.allocator.n_allocated == 0


def test_long_prompt_dense(small):
    cfg, jm, jparams, tm, tparams = small
    for cls, req in ((JaxDense, JaxRequest), (ContinuousBatcher, Request)):
        model, params = (jm, jparams) if cls is JaxDense else (tm, tparams)
        cb = cls(model, params, num_slots=1, max_len=32)
        with pytest.raises(ValueError, match="max_len"):
            cb.submit(req(rid=0, tokens=np.arange(40) % cfg.vocab_size,
                          max_new_tokens=4))
        assert len(cb.queue) == 0
    outs = []
    for cls, req in ((JaxDense, JaxRequest), (ContinuousBatcher, Request)):
        model, params = (jm, jparams) if cls is JaxDense else (tm, tparams)
        cb = cls(model, params, num_slots=1, max_len=32,
                 on_long_prompt="truncate")
        cb.submit(req(rid=0, tokens=np.arange(50) % cfg.vocab_size,
                      max_new_tokens=4))
        (r,) = cb.run()
        assert len(r.tokens) == 32 and len(r.output) == 4
        assert cb.stats.admitted_kv_bytes == cb.stats.retired_kv_bytes
        outs.append((r.output, cb.trace.ev_times, cb.trace.ev_dneeded))
    assert outs[0] == outs[1]


def test_long_prompt_paged(small):
    cfg = small[0]
    jb, tb = _pair(small)
    for b, cls, exc in ((jb, JaxRequest, JaxOutOfPages),
                        (tb, Request, OutOfPages)):
        with pytest.raises(exc):
            b.submit(cls(rid=0, tokens=np.arange(70) % cfg.vocab_size,
                         max_new_tokens=4))
        assert len(b.queue) == 0
    for kw in (dict(), dict(prefix_cache=True), dict(speculate_k=2)):
        jb, tb = _pair(small, on_long_prompt="truncate", **kw)
        _submit(jb, tb, 0, np.arange(70) % cfg.vocab_size, 5)
        tdone = tb.run()
        _assert_same(jb, tb, jb.run(), tdone)
        extra = kw.get("speculate_k", 0)
        assert len(tdone[0].tokens) == 8 * 8 - 4 - extra
        assert len(tdone[0].output) == 5
        assert tb.ledger.trace.peak_needed() <= tb.ledger.trace.capacity
