"""The four dense assigned configs on the port's paged batcher, against the
JAX reference on the CPU: qwen2-7b (QKV bias, RoPE theta 1e6),
tinyllama-1.1b, deepseek-coder-33b (theta 1e5) and granite-34b (MQA, GELU
MLP, LayerNorm, learned positions, tied head), each at
`reduced(..., layers=2)`, plus granite at its real attention shape
(`granite_group48`: the reduced config with H48 K1 d128, a group of 48,
which the card's decode kernels run in row chunks).

Both packages get the same weights (`params.from_jax_params`) and one
seeded stream of six ragged requests, one stopping at EOS: greedy tokens,
finish times, occupancy-trace events, `PagedStats` and `AccessStats` must be
equal. `test_torch_dense_archs_serve.py` holds the dense batchers,
speculation and the quantized pools to the reference with these fixtures.
"""
import dataclasses

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
from repro_torch.serve import PagedContinuousBatcher, PagedStats, Request

DENSE_ARCHS = ("qwen2-7b", "tinyllama-1.1b", "deepseek-coder-33b",
               "granite-34b")
GROUP48 = "granite_group48"
GEOMETRY = dict(num_slots=2, page_size=8, num_pages=32, max_pages_per_slot=8,
                chunk_steps=4)


def configs(name):
    """(JAX config, port config) of a reduced dense arch or of the
    group-48 granite variant."""
    arch = "granite-34b" if name == GROUP48 else name
    cfg = reduced(get_arch(arch), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch), layers=2)
    if name == GROUP48:
        shape = dict(num_heads=48, num_kv_heads=1, head_dim=128)
        cfg = dataclasses.replace(cfg, **shape)
        tcfg = dataclasses.replace(tcfg, **shape)
    return cfg, tcfg


def build_pair(name, seed=1):
    """The JAX model and weights, and the port's model on the CPU with the
    same weights."""
    cfg, tcfg = configs(name)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, jm, jparams, tm, tparams


def stream(vocab, seed=0):
    """Six ragged prompts (partial last pages) from two lengths, so the
    reference compiles two prefills, not six."""
    rng = np.random.default_rng(seed)
    lengths = rng.choice([9, 30], 6)
    budgets = rng.integers(3, 14, 6)
    return [(rng.integers(0, vocab, int(n)), int(k))
            for n, k in zip(lengths, budgets)]


def serve_both(pair, requests, eos=None, **kw):
    """The same requests through the JAX and the port's paged batcher
    (`eos`: {request index: EOS id}); returns both batchers and their
    finished requests by rid."""
    _, jm, jparams, tm, tparams = pair
    jb = JaxBatcher(jm, jparams, attn_backend="ref", **GEOMETRY, **kw)
    tb = PagedContinuousBatcher(tm, tparams, **GEOMETRY, **kw)
    for i, (prompt, budget) in enumerate(requests):
        e = (eos or {}).get(i)
        jb.submit(JaxRequest(rid=i, tokens=prompt, max_new_tokens=budget,
                             eos_id=e))
        tb.submit(Request(rid=i, tokens=prompt, max_new_tokens=budget,
                          eos_id=e))
    return (jb, tb, sorted(jb.run(), key=lambda r: r.rid),
            sorted(tb.run(), key=lambda r: r.rid))


def assert_same_run(jb, tb, jdone, tdone):
    """Tokens, finish times, trace events, `PagedStats` and `AccessStats`
    equal, the pool drained."""
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]
    jt, tt = jb.ledger.trace, tb.ledger.trace
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.ev_dobsolete == jt.ev_dobsolete
    assert tt.capacity == jt.capacity
    assert tt.peak_needed() > 0 and tt.as_arrays()[1][-1] == 0
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    assert tb.ledger.allocator.n_allocated == 0


@pytest.fixture(scope="module", params=DENSE_ARCHS + (GROUP48,))
def served(request):
    pair = build_pair(request.param)
    requests = stream(pair[0].vocab_size)
    # the third request stops at EOS: its id is the fourth token the port
    # emits for it alone
    probe = PagedContinuousBatcher(pair[3], pair[4], **GEOMETRY)
    probe.submit(Request(rid=0, tokens=requests[2][0], max_new_tokens=6))
    eos = probe.run()[0].output[3]
    return (request.param, pair) + serve_both(pair, requests, {2: eos})


def test_config_features_survive_reduction(served):
    """Each reduced config keeps what sets its arch apart."""
    name, (cfg, _, _, tm, _), *_ = served
    tcfg = tm.cfg
    assert tcfg.name == cfg.name and tcfg.num_layers == 2
    want = {"qwen2-7b": dict(attn_bias=True, rope_theta=1e6),
            "tinyllama-1.1b": dict(ffn_kind="swiglu", norm="rmsnorm"),
            "deepseek-coder-33b": dict(rope_theta=1e5),
            "granite-34b": dict(num_kv_heads=1, ffn_kind="gelu_mlp",
                                norm="layernorm", pos_emb="learned",
                                tie_embeddings=True),
            GROUP48: dict(num_heads=48, num_kv_heads=1, head_dim=128,
                          ffn_kind="gelu_mlp")}[name]
    assert {k: getattr(tcfg, k) for k in want} == want
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)


def test_greedy_tokens_and_finish_times_are_identical(served):
    _, _, jb, tb, jdone, tdone = served
    assert [r.rid for r in tdone] == list(range(6))
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert len(tdone[2].output) <= 4          # retired at EOS
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]


def test_trace_events_and_stats_are_identical(served):
    _, _, jb, tb, jdone, tdone = served
    assert_same_run(jb, tb, jdone, tdone)
    jbundle, tbundle = jb.occupancy_bundle(), tb.occupancy_bundle()
    assert tbundle.total_time == jbundle.total_time
    assert tbundle.graph_name == jbundle.graph_name
    assert tb.page_bytes == jb.page_bytes
