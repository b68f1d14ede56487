"""The Stage-II bank kernels' decompositions, held on the CPU through their
mirrors in `repro_torch.kernels.bank_energy.ref`:

* `exact_bank_stats_chunked_ref` computes the exact idle-run statistics as
  the `exact_bank_stats` kernel does: per chunk the runs that begin and end
  in it, the last fall of each bank and its open rise, then a prefix max of
  the last falls over the chunks as each chunk's carry-in;
* `bank_energy_tiled_ref` computes the lower-bound statistics as the
  `bank_energy` kernel does: per-tile partials, reduced in tile order.

Both are held to the JAX package's float64 numpy references (counts equal,
seconds within rel 1e-12: float64 sums in another order), to the port's
unchunked plain versions, and to the interpret-mode Pallas kernels at
`block_s` 64 on the traces of the JAX package's own kernel tests, at those
tests' rtol/atol 5e-3 (the Pallas kernels are float32). Chunks and tiles of
1, 7, 64, S and S + 1 segments put runs across every kind of edge.
"""
import numpy as np
import pytest
import torch

from repro.kernels.bank_energy.ops import bank_activity_stats as jax_bound
from repro.kernels.bank_energy.ops import candidate_grid
from repro.kernels.bank_energy.ops import exact_bank_stats as jax_exact
from repro.kernels.bank_energy.ref import bank_energy_np, exact_bank_stats_np
from repro_torch.kernels.bank_energy import (bank_energy_ref,
                                             bank_energy_tiled_ref,
                                             exact_bank_stats_chunked_ref,
                                             exact_bank_stats_ref)

REL = 1e-12
PALLAS_TOL = 5e-3
# (kind, S, C, most banks): activity that jumps at almost every segment or
# wanders slowly (long runs across chunks), 1 to 256 banks, 1 to 5000
# segments
TRACES = [("jump", 1, 3, 4), ("jump", 2, 2, 1), ("walk", 50, 5, 32),
          ("jump", 777, 4, 256), ("walk", 1500, 4, 256),
          ("jump", 5000, 3, 32), ("walk", 5000, 3, 32)]


def _trace(kind, S, C, nb_max, seed=0):
    """Durations with zeros among microsecond and millisecond segments,
    byte-valued occupancy, bank counts from 1 to `nb_max` whose usable
    sizes spread the activity over all banks, and thresholds of which
    about a third are zero."""
    rng = np.random.default_rng([S, C, nb_max, seed])
    d = np.where(rng.random(S) < 0.5, 1e-6, rng.random(S) * 1e-2)
    d[rng.random(S) < 0.2] = 0.0
    if kind == "jump":
        o = rng.integers(0, 2**27, S).astype(np.float64)
        o[rng.random(S) < 0.3] = 0.0
    else:
        o = np.abs(np.cumsum(rng.normal(0, 2**21, S))) % 2**27
        o = np.round(o / 1024) * 1024
    nb = rng.integers(1, nb_max + 1, C).astype(np.float64)
    nb[0], nb[-1] = 1.0, float(nb_max)
    u = 2**27 / (nb * rng.uniform(0.8, 2.0, C))
    th = rng.uniform(0, 1e-2, C) * rng.integers(0, 3, C)
    return d, o, u, nb, th


def _exact_inputs(nseg, seed=6):
    """The traces of the JAX package's exact-kernel tests."""
    rng = np.random.default_rng(seed)
    d = rng.random(nseg) * 1e-3 + 1e-6
    occ = (rng.integers(0, 130 * 2**20, nseg) // 1024 * 1024).astype(
        np.float64)
    us, nb, _ = candidate_grid(
        [c * 2**20 for c in (48, 64, 128)], [1, 4, 16, 32], 0.9)
    th = np.tile([1e-4, 5e-4, 1e-3, 2e-3], 3)
    return d, occ, us, nb, th


def _rel(a, b):
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x, np.float64)) for x in xs]


def _edges(S):
    return sorted({1, 7, 64, S, S + 1})


@pytest.mark.parametrize("kind,S,C,nb_max", TRACES)
def test_chunked_exact_mirror_matches_numpy_and_plain(kind, S, C, nb_max):
    d, o, u, nb, th = _trace(kind, S, C, nb_max)
    want = exact_bank_stats_np(d, o, u, nb, th)
    plain = exact_bank_stats_ref(*_torch(d, o, u, nb, th)).numpy()
    np.testing.assert_array_equal(plain[:, [1, 3]], want[:, [1, 3]])
    for chunk in _edges(S):
        got = exact_bank_stats_chunked_ref(*_torch(d, o, u, nb, th),
                                           chunk).numpy()
        np.testing.assert_array_equal(got[:, [1, 3]], want[:, [1, 3]])
        assert _rel(got, want) <= REL, chunk
        assert _rel(got, plain) <= REL, chunk


@pytest.mark.parametrize("nseg", [1, 17, 256])
def test_chunked_exact_mirror_matches_interpret_pallas(nseg):
    d, o, u, nb, th = _exact_inputs(nseg)
    want = np.asarray(jax_exact(d, o, u, nb, th, backend="interpret",
                                block_s=64))
    for chunk in _edges(nseg):
        got = exact_bank_stats_chunked_ref(*_torch(d, o, u, nb, th),
                                           chunk).numpy()
        np.testing.assert_allclose(got, want, rtol=PALLAS_TOL,
                                   atol=PALLAS_TOL)


@pytest.mark.parametrize("kind,S,C,nb_max", TRACES)
def test_tiled_bound_mirror_matches_numpy_and_plain(kind, S, C, nb_max):
    d, o, u, nb, _ = _trace(kind, S, C, nb_max, seed=1)
    want = bank_energy_np(d, o, u, nb)
    plain = bank_energy_ref(*_torch(d, o, u, nb)).numpy()
    for tile in _edges(S):
        got = bank_energy_tiled_ref(*_torch(d, o, u, nb), tile).numpy()
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        assert _rel(got, want) <= REL, tile
        assert _rel(got, plain) <= REL, tile


@pytest.mark.parametrize("nseg", [1, 17, 256])
def test_tiled_bound_mirror_matches_interpret_pallas(nseg):
    d, o, u, nb, _ = _exact_inputs(nseg, seed=7)
    want = np.asarray(jax_bound(d, o, u, nb, backend="interpret",
                                block_s=64))
    for tile in _edges(nseg):
        got = bank_energy_tiled_ref(*_torch(d, o, u, nb), tile).numpy()
        np.testing.assert_allclose(got, want, rtol=PALLAS_TOL,
                                   atol=PALLAS_TOL)


def test_chunked_mirror_of_an_idle_bank_across_every_chunk():
    """One bank never required after segment 0: its single idle run spans
    every later chunk, opens in none of them and is closed by the trace
    end; a second bank rises once, in the last chunk, after an idle run
    that began in the first."""
    S = 300
    d = np.full(S, 1e-3)
    o = np.zeros(S)
    o[0] = 3.0
    o[-5] = 1.5
    u, nb, th = np.array([1.0]), np.array([3.0]), np.array([0.1])
    want = exact_bank_stats_np(d, o, u, nb, th)
    for chunk in (1, 7, 64):
        got = exact_bank_stats_chunked_ref(*_torch(d, o, u, nb, th),
                                           chunk).numpy()
        np.testing.assert_array_equal(got[:, [1, 3]], want[:, [1, 3]])
        assert _rel(got, want) <= REL


def test_mirrors_reject_empty_chunks():
    d, o, u, nb, th = _torch(*_trace("jump", 10, 2, 4))
    with pytest.raises(ValueError):
        exact_bank_stats_chunked_ref(d, o, u, nb, th, 0)
    with pytest.raises(ValueError):
        bank_energy_tiled_ref(d, o, u, nb, 0)
