"""Granite-34b at its real attention shape (the reduced config with H48 K1
d128, a group of 48) on the port's paged batcher against the JAX reference
on the CPU, with the same weights: speculative decoding at k 3 with the
skip-2 self-spec draft (192 verify rows per KV head), and int8 and fp8 KV
pages. Tokens, finish times, trace events, `PagedStats` (speculation
counters included) and `AccessStats` must be equal, and speculation must
give the plain run's tokens."""
import pytest

from test_torch_dense_archs import (GROUP48, assert_same_run, build_pair,
                                    serve_both, stream)


@pytest.fixture(scope="module")
def granite48():
    pair = build_pair(GROUP48, seed=3)
    return pair, stream(pair[0].vocab_size, seed=1)


def test_speculation_at_group_48_matches_jax(granite48):
    pair, requests = granite48
    jb, tb, jdone, tdone = serve_both(pair, requests, speculate_k=3)
    assert_same_run(jb, tb, jdone, tdone)
    assert tb.stats.spec_rounds > 0 and tb.stats.drafted_tokens > 0
    assert tb.draft_model.cfg.num_layers == 1
    plain = serve_both(pair, requests)[3]
    assert [r.output for r in tdone] == [r.output for r in plain]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pages_at_group_48_match_jax(granite48, kv_dtype):
    pair, requests = granite48
    jb, tb, jdone, tdone = serve_both(pair, requests, kv_dtype=kv_dtype)
    assert_same_run(jb, tb, jdone, tdone)
    assert tb.page_bytes == jb.page_bytes
