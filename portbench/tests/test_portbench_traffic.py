"""The traffic generator: each mix repeats per seed, stays inside its
clamps, and gives every seed the same lengths block by block; replayed
lists and Poisson arrivals do the same from data alone."""
import itertools
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench.harness.traffic import length_pairs, requests

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob(
    "*.json"))
SEEDS = (0, 2 ** 31 + 11, 987654321)


def _take(mix, seed, n, vocab=1000):
    """(prompt ids, new tokens) of the first `n` requests."""
    return [(t, k) for _, t, k in _timed(mix, seed, n, vocab)]


def _timed(mix, seed, n, vocab=1000):
    return list(itertools.islice(requests(mix, seed, vocab), n))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = json.loads(path.read_text())
    for seed in SEEDS:
        a, b = _take(mix, seed, 70), _take(mix, seed, 70)
        assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
                   for x, y in zip(a, b))
    assert not np.array_equal(_take(mix, 1, 1)[0][0], _take(mix, 2, 1)[0][0])


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_within_clamps_and_ids_within_vocab(path):
    mix = json.loads(path.read_text())
    p, o = mix["prompt"], mix["output"]
    for toks, n in _take(mix, 5, 3 * mix["block"], vocab=777):
        assert p["min"] <= len(toks) <= p["max"]
        assert o["min"] <= n <= o["max"]
        assert 0 <= toks.min() and toks.max() < 777


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_gets_the_same_lengths_per_block(path):
    mix = json.loads(path.read_text())
    n = mix["block"]
    want = Counter(map(tuple, length_pairs(mix).tolist()))
    for seed in SEEDS:
        reqs = _take(mix, seed, 2 * n)
        for blk in (reqs[:n], reqs[n:]):
            assert Counter((len(t), k) for t, k in blk) == want
    orders = {tuple(len(t) for t, _ in _take(mix, s, n)) for s in SEEDS}
    assert len(orders) == len(SEEDS)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_block_lengths_follow_the_clamped_lognormal(path):
    mix = json.loads(path.read_text())
    pairs = length_pairs(mix)
    for col, key in ((0, "prompt"), (1, "output")):
        q = mix[key]
        v = np.sort(pairs[:, col])
        # quantile lengths: ascending, median near the lognormal's median
        median = q["mean"] * np.exp(-0.5 * q["sigma"] ** 2)
        assert abs(np.median(v) - np.clip(median, q["min"], q["max"])) \
            <= 0.05 * median + 1


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_a_backlog_is_due_at_once(path):
    mix = json.loads(path.read_text())
    assert mix["arrivals"] == "backlog"
    assert {d for d, _, _ in _timed(mix, 3, 2 * mix["block"])} == {0.0}


REPLAY = {"arrivals": "backlog",
          "replay": [[16384, 32], [17873, 32], [19363, 32], [20852, 32]]}


def test_a_replayed_list_cycles_in_its_order_rotated_by_the_seed():
    n = len(REPLAY["replay"])
    want = [tuple(p) for p in REPLAY["replay"]]
    for seed in SEEDS + (2 ** 31 + 2,):
        got = [(len(t), k) for t, k in _take(REPLAY, seed, 3 * n, vocab=50)]
        r = seed % n
        assert got == (want[r:] + want[:r]) * 3
        assert got != want * 3 or r == 0
    a, b = _take(REPLAY, 9, 5), _take(REPLAY, 9, 5)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


POISSON = {"arrivals": "poisson", "rate": 4.0, "block": 16,
           "pairing_seed": 0,
           "prompt": {"mean": 300, "sigma": 0.5, "min": 64, "max": 1024},
           "output": {"mean": 100, "sigma": 0.5, "min": 16, "max": 256}}


def test_poisson_arrivals_are_the_same_gaps_per_block_in_another_order():
    n = POISSON["block"]
    per_seed = []
    for seed in SEEDS:
        due = np.array([d for d, _, _ in _timed(POISSON, seed, 2 * n)])
        gaps = np.diff(np.concatenate([[0.0], due]))
        assert (gaps > 0).all()
        a, b = np.sort(gaps[:n]), np.sort(gaps[n:])
        assert np.allclose(a, b)
        # the exponential's quantiles: mean gap near 1 / rate
        assert abs(a.mean() * POISSON["rate"] - 1) < 0.1
        per_seed.append(tuple(gaps[:n]))
        assert _timed(POISSON, seed, 5)[4][0] == due[4]
    assert len(set(per_seed)) == len(SEEDS)
