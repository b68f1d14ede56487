"""Parity of the port's prefix-cached paged batcher with the JAX reference
on the CPU: the reference tests' shared-prefix harness
(`tests/test_prefix_serving.py`, three prompts sharing a mid-page prefix and
one unshared) through `PagedContinuousBatcher(prefix_cache=True)` in both
packages, on native, int8 and fp8 pages. Tokens, both traces' events,
`PagedStats`, refcounts and the radix index must be equal."""
import pytest

from test_torch_prefix import (_run_both, _shared_prompts,  # noqa: F401
                               assert_same_prefix_run, small)


@pytest.mark.parametrize("kv", ["native", "int8", "fp8"])
def test_prefix_batcher_matches_reference(small, kv):
    prompts, new = _shared_prompts(small[0].vocab_size)
    jb, tb, jout, tout = _run_both(small, prompts, new, prefix_cache=True,
                                   kv_dtype=kv)
    assert_same_prefix_run(jb, tb, jout, tout)
    st = tb.stats
    assert st.prefix_hits == 2 and st.prefix_tokens_reused > 0
    assert st.cow_splits >= 1
    phys = tb.ledger.trace.peak_needed()
    assert phys < tb.ledger.logical.peak_needed()
    assert phys % tb.page_bytes == 0
