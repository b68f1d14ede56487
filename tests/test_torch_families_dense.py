"""Parity of the port's `ContinuousBatcher` with the JAX reference on the
other decoder families, on the CPU (reduced configs, float32, the
reference's weights through `from_jax_params`): recurrentgemma (RG-LRU +
sliding-window rings, with a tail block), llama4-scout (chunked rings + a
full layer, MoE with a shared expert) and mamba2 (SSD state), with a
request decoding past the rings' length. Tokens, trace events,
`SchedulerStats` and access bytes are equal.
"""
import pytest

from repro.serve import ContinuousBatcher as JaxDense
from repro_torch.serve import ContinuousBatcher, SchedulerStats
from test_torch_families_serve import pair, run_both, same_trace, stream_of


@pytest.mark.parametrize("name", ["recurrentgemma-2b",
                                  "llama4-scout-17b-a16e", "mamba2-130m"])
def test_continuous_batcher_matches_jax(name):
    """Three 64-token prompts (one prefill shape for the reference to
    compile; two SSD chunks of the reduced mamba2) fill the rings of 64
    rows; the second decodes 24 tokens past them."""
    cfg, tcfg, jm, jparams, tm, tparams = pair(name)
    stream = stream_of(cfg.vocab_size, [64, 64, 64], seed=2)
    stream[1] = (stream[1][0], 24)
    jb = JaxDense(jm, jparams, num_slots=2, max_len=64)
    tb = ContinuousBatcher(tm, tparams, num_slots=2, max_len=64)
    run_both(jb, tb, stream)
    same_trace(jb.trace, tb.trace)
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    fields = SchedulerStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
