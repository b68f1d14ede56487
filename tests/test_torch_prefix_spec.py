"""Parity of the port's prefix-cached paged batcher with the JAX reference
on the CPU under LRU eviction and with speculative decoding: tokens, both
traces' events, `PagedStats`, refcounts and the radix index must be
equal."""
import numpy as np

from test_torch_prefix import (_run_both, assert_same_prefix_run,  # noqa: F401
                               small)


def test_prefix_batcher_with_speculation_matches_reference(small):
    """The reference's `test_spec_composes_with_prefix_cache` stream: the
    draft lane never shares, rollback never frees a shared page."""
    vocab = small[0].vocab_size
    rng = np.random.default_rng(6)
    shared = rng.integers(0, vocab, 17)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               for n in (9, 7, 12)]
    new = [8, 9, 7]
    jb, tb, jout, tout = _run_both(small, prompts, new, num_pages=128,
                                   max_pages_per_slot=10, prefix_cache=True,
                                   speculate_k=2)
    assert_same_prefix_run(jb, tb, jout, tout)
    assert tb.stats.prefix_hits >= 1 and tb.stats.spec_rounds > 0
    assert tb.ledger.draft_pages == {}
    assert tb.ledger.allocator.n_allocated == tb.ledger.index.n_cached_pages


def test_prefix_eviction_matches_reference(small):
    """Distinct prompts through a pool that cannot keep every cached run
    (the reference's `test_eviction_under_page_pressure`), then a repeat
    that hits: LRU order decides what is left to hit."""
    vocab = small[0].vocab_size
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, 25) for _ in range(5)]
    prompts.append(prompts[4][:20])
    jb, tb, jout, tout = _run_both(small, prompts, [5] * 6, num_slots=1,
                                   num_pages=12, prefix_cache=True)
    assert_same_prefix_run(jb, tb, jout, tout)
    assert tb.stats.evicted_pages > 0 and tb.stats.prefix_hits >= 1
