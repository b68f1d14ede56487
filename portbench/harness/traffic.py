"""The one traffic generator: requests from a mix's parameters
(`portbench/traffic/<mix>.json`) and the run's seed.

Lengths come in blocks that are the same for every seed; the seed chooses
only the order within each block and the token ids. So seeds change the
arithmetic, not the amount of work, and two runs of a cell differ by the
program's noise. A mix gives its lengths one of two ways:

  * "prompt" and "output" ({"mean", "sigma", "min", "max"}: a lognormal's
    mean and the sigma of its underlying normal, clamped to [min, max]),
    with "block" (requests per block) and "pairing_seed" (fixes which
    output length goes with which prompt length, the same for every run).
    `LengthModel` is a frozen copy of the port's clamped lognormal length
    model (`repro_torch/traffic/generators.py`), with a clamp of its own
    for prompts and for outputs, its lengths taken at the distribution's
    quantiles rather than drawn. Each block comes in an order drawn from
    the seed.
  * "replay": a fixed list of [prompt, output] length pairs, the block,
    cycled in its own order rotated by the seed (the longest contexts are
    best replayed from a set).

and its arrivals one of two ways ("arrivals"):

  * "backlog": every request is due at once; the harness keeps the queue
    a refill deep (offline batches).
  * "poisson": requests are due at "rate" requests a second; the gaps of
    each block are the exponential's quantiles, in an order drawn from the
    seed (open loop: the harness submits each request at its due time).

Further keys, such as "source", describe the mix and are not read."""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, Tuple

import numpy as np

ARRIVALS = ("backlog", "poisson")


@dataclass(frozen=True)
class LengthModel:
    """Lognormal prompt / output token-length distributions, each clamped
    to its own [min, max]."""
    prompt_mean: float = 128.0
    prompt_sigma: float = 0.8        # sigma of underlying normal
    output_mean: float = 64.0
    output_sigma: float = 0.6
    prompt_min: int = 1
    prompt_max: int = 2048
    output_min: int = 1
    output_max: int = 2048

    @staticmethod
    def _quantiles(mean, sigma, lo, hi, n: int) -> np.ndarray:
        mu = np.log(mean) - 0.5 * sigma ** 2
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        v = np.exp(mu + sigma * z)
        return np.clip(np.rint(v).astype(np.int64), lo, hi)

    def quantile_lengths(self, n: int):
        """(prompt lengths, output lengths): n of each, at the quantiles
        (i + 0.5) / n of the clamped lognormals, ascending."""
        return (self._quantiles(self.prompt_mean, self.prompt_sigma,
                                self.prompt_min, self.prompt_max, n),
                self._quantiles(self.output_mean, self.output_sigma,
                                self.output_min, self.output_max, n))


def length_model(mix: dict) -> LengthModel:
    p, o = mix["prompt"], mix["output"]
    return LengthModel(prompt_mean=p["mean"], prompt_sigma=p["sigma"],
                       output_mean=o["mean"], output_sigma=o["sigma"],
                       prompt_min=p["min"], prompt_max=p["max"],
                       output_min=o["min"], output_max=o["max"])


def length_pairs(mix: dict) -> np.ndarray:
    """The mix's block: (block, 2) int64 rows of (prompt, output) lengths,
    the same for every seed."""
    if mix.get("arrivals") not in ARRIVALS:
        raise ValueError(f"unknown arrivals {mix.get('arrivals')!r}; "
                         f"the generator knows {ARRIVALS}")
    if "replay" in mix:
        pairs = np.asarray(mix["replay"], dtype=np.int64).reshape(-1, 2)
        if not len(pairs) or pairs.min() < 1:
            raise ValueError("a replayed list needs positive lengths")
        return pairs
    n = int(mix["block"])
    p, o = length_model(mix).quantile_lengths(n)
    perm = np.random.default_rng(int(mix["pairing_seed"])).permutation(n)
    return np.stack([p, o[perm]], axis=1)


def _gaps(mix: dict, n: int) -> np.ndarray:
    """A block's arrival gaps in seconds, ascending: zeros for a backlog,
    the exponential's quantiles (i + 0.5) / n at the mix's rate for a
    Poisson stream."""
    if mix["arrivals"] == "backlog":
        return np.zeros(n)
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / float(mix["rate"])


def requests(mix: dict, seed: int,
             vocab: int) -> Iterator[Tuple[float, np.ndarray, int]]:
    """Endless (due seconds from the window's start, prompt token ids, new
    tokens): block after block of the mix's length pairs, in an order
    drawn from `seed` (a replayed list: its own order, rotated by `seed`),
    token ids uniform over [0, vocab) drawn from `seed`."""
    pairs = length_pairs(mix)
    n = len(pairs)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x70b])
    arr = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xa77])
    gaps = _gaps(mix, n)
    rotated = np.roll(np.arange(n), -(int(seed) % n))
    due = 0.0
    while True:
        order = rotated if "replay" in mix else rng.permutation(n)
        for i, g in zip(order, arr.permutation(gaps)):
            due += float(g)
            s, k = int(pairs[i, 0]), int(pairs[i, 1])
            yield due, rng.integers(0, vocab, size=s, dtype=np.int64), k
