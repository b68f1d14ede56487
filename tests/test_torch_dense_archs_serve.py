"""The four dense assigned configs (reduced, and granite at its group of
48) on the port's dense batchers against the JAX reference on the CPU, with
the same weights: `BatchedServer` gives the same greedy tokens (and logits
within 1e-4), `ContinuousBatcher` the same tokens, finish times, trace
events, `AccessStats` and `SchedulerStats`. The paged batcher's parity is
`test_torch_dense_archs.py`; speculation and quantized pools are
`test_torch_dense_archs_spec.py`."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import BatchedServer as JaxServer
from repro.serve import ContinuousBatcher as JaxDense
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.serve import (BatchedServer, ContinuousBatcher, Request,
                               SchedulerStats, ServeConfig)
from test_torch_dense_archs import DENSE_ARCHS, GROUP48, build_pair

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module", params=DENSE_ARCHS + (GROUP48,))
def pair(request):
    return build_pair(request.param, seed=2)


def test_batched_server_matches_jax(pair):
    cfg, jm, jparams, tm, tparams = pair
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 9))
    jres = JaxServer(jm, jparams, JaxServeConfig(max_len=24, max_new_tokens=6),
                     collect_logits=True).generate(
        {"tokens": jnp.asarray(prompts, jnp.int32)})
    tres = BatchedServer(tm, tparams, ServeConfig(max_len=24,
                                                  max_new_tokens=6),
                         collect_logits=True).generate({"tokens": prompts})
    np.testing.assert_array_equal(tres["tokens"], np.asarray(jres["tokens"]))
    np.testing.assert_allclose(tres["logits"], jres["logits"],
                               atol=LOGIT_ATOL, rtol=0)
    assert tres["stats"].tokens_generated == 18


def test_continuous_batcher_matches_jax(pair):
    """Prompts of two lengths (two prefills for the reference to compile),
    the third running past max_len = 24."""
    cfg, jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(4)
    stream = [(rng.integers(0, cfg.vocab_size, n), k)
              for n, k in ((7, 9), (18, 6), (18, 10), (7, 8))]
    jb = JaxDense(jm, jparams, num_slots=2, max_len=24)
    tb = ContinuousBatcher(tm, tparams, num_slots=2, max_len=24)
    for i, (p, k) in enumerate(stream):
        jb.submit(JaxRequest(rid=i, tokens=p, max_new_tokens=k))
        tb.submit(Request(rid=i, tokens=p, max_new_tokens=k))
    jdone = sorted(jb.run(), key=lambda r: r.rid)
    tdone = sorted(tb.run(), key=lambda r: r.rid)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]
    jt, tt = jb.trace, tb.trace
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.capacity == jt.capacity and tt.as_arrays()[1][-1] == 0
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    fields = SchedulerStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
