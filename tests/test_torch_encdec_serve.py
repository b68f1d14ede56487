"""The port's encoder-decoder (seamless-m4t) served against the JAX
reference on the CPU, where kernels 2, 3, 4 and 7 run their plain
versions:

* `BatchedServer.generate` with frames: greedy tokens equal, the
  collected logits within 1e-5 of max(1, |reference|), and the KV events
  its meter receives (admission, decode growth, release: bytes, request
  and cause) equal to the reference server's;
* the Stage-II sweep of that trace (`examples.encdec_serving.sweep_log`)
  equal to the reference's `explorer.sweep` of the same events: the same
  (C, B) rows, energies within rel 1e-12;
* the batchers with no encoder-decoder path refuse it, as the
  reference's do: the paged batcher ("model lacks a paged decode path"),
  the dense continuous batcher (no frames), the decoder-only model and
  its paged cache.

The reference's weights cross through `from_jax_params`; inputs come from
`np.random.default_rng` (the walkthrough's `inputs`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.explorer import sweep as jax_sweep
from repro.models import build_model as jax_build_model
from repro.serve import BatchedServer as JaxServer
from repro.serve import ContinuousBatcher as JaxContinuous
from repro.serve import PagedContinuousBatcher as JaxPaged
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.sim.trace import AccessStats as JaxAccess
from repro.sim.trace import OccupancyTrace as JaxTrace
from repro.sim.trace import TraceBundle as JaxBundle
import repro_torch.configs as tconfigs
from repro_torch.examples.encdec_serving import (ARCH, KVLog, RUNS, inputs,
                                                 log_bundle, serve,
                                                 sweep_log)
from repro_torch.models import DecoderLM, EncDecModel, init_paged_cache
from repro_torch.params import from_jax_params
from repro_torch.serve import ContinuousBatcher, PagedContinuousBatcher

# logits: absolute at most 1, else relative to the reference's magnitude
LOGIT_ATOL = 1e-5
# Stage-II energies of the same trace
SWEEP_RTOL = 1e-12


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_arch(ARCH), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=2)
    jm = jax_build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(5))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = EncDecModel(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def test_batched_server_tokens_logits_and_events_match_reference(models):
    cfg, tcfg, jm, jparams, tm, tparams = models
    run = RUNS[False]
    frames, tokens = inputs(tcfg, run, 23)
    got = serve(tm, tparams, frames, tokens, run["new"],
                collect_logits=True)
    jlog = KVLog()
    want = JaxServer(jm, jparams, JaxServeConfig(
        max_len=run["prompt"] + run["new"], max_new_tokens=run["new"]),
        collect_logits=True, meter=jlog).generate(
        {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    wl = np.asarray(want["logits"])
    err = np.abs(got["logits"] - wl).max()
    assert err <= LOGIT_ATOL * max(1.0, np.abs(wl).max()), err
    assert got["stats"].tokens_generated == run["batch"] * run["new"]
    assert got["log"].events == jlog.events
    assert [e[3] for e in jlog.events] == ["admission", "decode_growth",
                                           None]

    # Stage II over the port's trace: the port's sweep against the
    # reference's on the same events
    table = sweep_log(got["log"], "cpu")
    b = log_bundle(got["log"])
    tr = b.traces["kv"]
    jtr = JaxTrace("kv", 0)
    jtr.extend(tr.ev_times, tr.ev_dneeded, tr.ev_dobsolete)
    caps = sorted({r.capacity_mib for r in table.rows})
    jtable = jax_sweep(JaxBundle(b.graph_name, b.total_time, {"kv": jtr},
                                 JaxAccess()), mem_name="kv",
                       capacities_mib=caps, banks=[1, 2, 4, 8, 16],
                       prune=True)
    assert [(r.capacity_mib, r.banks) for r in table.rows] == \
        [(r.capacity_mib, r.banks) for r in jtable.rows]
    for r, j in zip(table.rows, jtable.rows):
        assert abs(r.result.e_total / j.result.e_total - 1.0) <= SWEEP_RTOL
        assert r.result.n_transitions == j.result.n_transitions


def test_batchers_without_an_encdec_path_refuse_it(models):
    cfg, tcfg, jm, jparams, tm, tparams = models
    with pytest.raises(TypeError, match="paged decode path"):
        JaxPaged(jm, jparams)
    with pytest.raises(TypeError, match="paged decode path"):
        PagedContinuousBatcher(tm, tparams)
    with pytest.raises(TypeError, match="encoder-decoder"):
        ContinuousBatcher(tm, tparams)
    # the reference's dense batcher admits the model, then fails at the
    # first prefill: its requests carry no frames
    jcb = JaxContinuous(jm, jparams, num_slots=1, max_len=16)
    jcb.submit(JaxRequest(rid=0, tokens=np.arange(4, dtype=np.int32),
                          max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jcb.run()
    for fn in (lambda: DecoderLM(tcfg, device="cpu"),
               lambda: init_paged_cache(tcfg, 1, 4, 8, 2)):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            fn()
