"""Seeded serving-traffic generators: request arrival processes + lengths;
a copy of the reference package's `repro/traffic/generators.py`.

Production KV occupancy is driven by *load*, not by a single sequence's
length: requests arrive and finish at different times, so the on-chip KV
footprint fluctuates with concurrency — the regime where time-resolved
analysis (and therefore power gating) pays off most. Each generator here is a
pure function of its seed and emits a list of `RequestSpec`s; the same spec
list replayed against two architectures gives the MHA-vs-GQA comparison
under *identical* traffic.

Arrival processes:
  * "poisson"  — homogeneous Poisson(rate) over [0, horizon).
  * "bursty"   — 2-state Markov-modulated Poisson process (MMPP-2): calm and
                 burst states with different rates, exponential dwell times.
  * "diurnal"  — non-homogeneous Poisson with a sinusoidal rate profile
                 (one "day" compressed into `period_s`), drawn by thinning.
  * "replay"   — explicit arrival times (trace replay from a log).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class RequestSpec:
    """One request of a traffic trace: all times in seconds.

    `prefix_id`/`prefix_len` mark a shared prompt prefix: every request
    carrying the same `prefix_id` begins with the identical `prefix_len`
    leading tokens (materialized by `materialize_tokens`). Plain workloads
    leave them at None/0."""
    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    prefix_id: Optional[int] = None
    prefix_len: int = 0


@dataclass(frozen=True)
class LengthModel:
    """Lognormal prompt / output token-length distributions, clamped to
    [min_len, max_len]. Defaults loosely follow public serving traces
    (short chatty prompts, a heavy tail of long generations)."""
    prompt_mean: float = 128.0
    prompt_sigma: float = 0.8        # sigma of underlying normal
    output_mean: float = 64.0
    output_sigma: float = 0.6
    min_len: int = 1
    max_len: int = 2048

    def draw(self, rng: np.random.Generator, n: int):
        def lognorm(mean, sigma):
            mu = np.log(mean) - 0.5 * sigma ** 2
            v = np.exp(rng.normal(mu, sigma, size=n))
            return np.clip(np.rint(v).astype(np.int64),
                           self.min_len, self.max_len)
        return lognorm(self.prompt_mean, self.prompt_sigma), \
            lognorm(self.output_mean, self.output_sigma)


def _specs(arrivals: np.ndarray, lengths: LengthModel,
           rng: np.random.Generator) -> List[RequestSpec]:
    arrivals = np.sort(np.asarray(arrivals, np.float64))
    p, o = lengths.draw(rng, len(arrivals))
    return [RequestSpec(rid=i, arrival_s=float(t), prompt_len=int(pi),
                        output_len=int(oi))
            for i, (t, pi, oi) in enumerate(zip(arrivals, p, o))]


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def poisson(rate: float, horizon_s: float, *, seed: int = 0,
            lengths: Optional[LengthModel] = None) -> List[RequestSpec]:
    """Homogeneous Poisson arrivals at `rate` req/s over [0, horizon)."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(rate * horizon_s)
    arrivals = rng.uniform(0.0, horizon_s, size=n)
    return _specs(arrivals, lengths or LengthModel(), rng)


def bursty(rate: float, horizon_s: float, *, seed: int = 0,
           burst_factor: float = 8.0, calm_dwell_s: float = 4.0,
           burst_dwell_s: float = 1.0,
           lengths: Optional[LengthModel] = None) -> List[RequestSpec]:
    """MMPP-2: calm state at `rate_calm`, burst state at
    `burst_factor * rate_calm`, with the calm rate chosen so the long-run
    mean equals `rate`. Exponential dwell times in each state."""
    rng = np.random.default_rng(seed)
    pi_burst = burst_dwell_s / (calm_dwell_s + burst_dwell_s)
    rate_calm = rate / (1 - pi_burst + pi_burst * burst_factor)
    arrivals: List[float] = []
    t, in_burst = 0.0, False
    while t < horizon_s:
        dwell = rng.exponential(burst_dwell_s if in_burst else calm_dwell_s)
        end = min(t + dwell, horizon_s)
        r = rate_calm * (burst_factor if in_burst else 1.0)
        n = rng.poisson(r * (end - t))
        arrivals.extend(rng.uniform(t, end, size=n))
        t, in_burst = end, not in_burst
    return _specs(np.asarray(arrivals), lengths or LengthModel(), rng)


def diurnal(rate: float, horizon_s: float, *, seed: int = 0,
            peak_to_trough: float = 4.0, period_s: Optional[float] = None,
            lengths: Optional[LengthModel] = None) -> List[RequestSpec]:
    """Non-homogeneous Poisson whose rate ramps sinusoidally between trough
    and peak (mean = `rate`), one full cycle per `period_s` (default: the
    horizon). Sampled exactly by thinning against the peak rate."""
    rng = np.random.default_rng(seed)
    period = period_s or horizon_s
    # mean of trough + (peak-trough) * (1+sin)/2 over a cycle is the midpoint
    trough = 2.0 * rate / (1.0 + peak_to_trough)
    peak = peak_to_trough * trough

    def lam(t):
        phase = 2 * np.pi * t / period
        return trough + (peak - trough) * 0.5 * (1 + np.sin(phase - np.pi / 2))

    n_cand = rng.poisson(peak * horizon_s)
    cand = rng.uniform(0.0, horizon_s, size=n_cand)
    keep = rng.uniform(0.0, peak, size=n_cand) < lam(cand)
    return _specs(cand[keep], lengths or LengthModel(), rng)


def replay(arrival_times_s: Sequence[float], *, seed: int = 0,
           prompt_lens: Optional[Sequence[int]] = None,
           output_lens: Optional[Sequence[int]] = None,
           lengths: Optional[LengthModel] = None) -> List[RequestSpec]:
    """Trace replay: explicit arrivals; lengths taken from the log when
    given, else drawn from the (seeded) length model."""
    rng = np.random.default_rng(seed)
    times = np.asarray(arrival_times_s, np.float64)
    if (prompt_lens is None) != (output_lens is None):
        raise ValueError("replay needs both prompt_lens and output_lens "
                         "(or neither)")
    if prompt_lens is not None:
        if not (len(times) == len(prompt_lens) == len(output_lens)):
            raise ValueError("replay arrays must have equal length")
        order = np.argsort(times, kind="stable")   # keep log pairing intact
        return [RequestSpec(i, float(times[j]), int(prompt_lens[j]),
                            int(output_lens[j]))
                for i, j in enumerate(order)]
    return _specs(times, lengths or LengthModel(), rng)


GENERATORS: Dict[str, object] = {
    "poisson": poisson,
    "bursty": bursty,
    "diurnal": diurnal,
}


def generate(arrival: str, rate: float, horizon_s: float, *, seed: int = 0,
             lengths: Optional[LengthModel] = None,
             **kwargs) -> List[RequestSpec]:
    """Dispatch by arrival-process name ("replay" needs `replay()` directly)."""
    if arrival not in GENERATORS:
        raise KeyError(f"unknown arrival process {arrival!r}; "
                       f"known: {sorted(GENERATORS)} (+ replay)")
    fn = GENERATORS[arrival]
    return fn(rate, horizon_s, seed=seed, lengths=lengths, **kwargs)


# ---------------------------------------------------------------------------
# Shared-prefix workload families
# ---------------------------------------------------------------------------
#
# Real traffic repeats long prompt prefixes across requests — chat system
# prompts, few-shot templates, agentic fan-out. Each family below draws
# arrivals from one of the processes above, then attaches prefix structure:
# `sharing` controls the expected number of requests per distinct prefix
# (sharing factor), the length knobs the shared-prefix length distribution.
# The specs carry (prefix_id, prefix_len) only; `materialize_tokens` turns
# them into concrete token arrays whose leading tokens actually coincide.

def _arrival_times(arrival: str, rate: float, horizon_s: float, seed: int,
                   **kw) -> np.ndarray:
    specs = generate(arrival, rate, horizon_s, seed=seed, **kw)
    return np.asarray([s.arrival_s for s in specs], np.float64)


def _family_rng(seed: int, tag: int) -> np.random.Generator:
    """Substream for a workload family's structure draws, keyed away from
    the bare `seed` the arrival process consumes — otherwise prefix
    lengths/assignments would be transforms of the very bits that set the
    arrival times (same PCG64 state)."""
    return np.random.default_rng([seed, 0x9E3779B9, tag])


def _clamped_lognorm(rng, mean: float, sigma: float, n: int, lo: int,
                     hi: int) -> np.ndarray:
    mu = np.log(max(mean, 1.0)) - 0.5 * sigma ** 2
    v = np.exp(rng.normal(mu, sigma, size=n))
    return np.clip(np.rint(v).astype(np.int64), lo, hi)


def _finish(arrivals, prefix_ids, prefix_lens, turn_lens, out_lens,
            max_len: int) -> List[RequestSpec]:
    order = np.argsort(arrivals, kind="stable")
    specs = []
    for i, j in enumerate(order):
        plen = int(prefix_lens[j]) + int(turn_lens[j])
        plen = min(plen, max_len)
        pfx = min(int(prefix_lens[j]), plen - 1)    # >= 1 unshared token
        specs.append(RequestSpec(
            rid=i, arrival_s=float(arrivals[j]), prompt_len=plen,
            output_len=int(out_lens[j]), prefix_id=int(prefix_ids[j]),
            prefix_len=max(pfx, 0)))
    return specs


def chat_sysprompt(rate: float, horizon_s: float, *, seed: int = 0,
                   lengths: Optional[LengthModel] = None,
                   arrival: str = "poisson", prefix_len: float = 512.0,
                   prefix_sigma: float = 0.25,
                   sharing: float = 8.0) -> List[RequestSpec]:
    """Multi-tenant chat: each tenant owns one system prompt (lognormal
    length around `prefix_len`); every request opens with its tenant's
    prompt followed by a per-request user turn. Expected requests per
    tenant == `sharing`."""
    lengths = lengths or LengthModel()
    rng = _family_rng(seed, 1)
    t = _arrival_times(arrival, rate, horizon_s, seed)
    n = len(t)
    n_tenants = max(1, int(round(n / max(sharing, 1.0))))
    tenant_pfx = _clamped_lognorm(rng, prefix_len, prefix_sigma, n_tenants,
                                  1, lengths.max_len - 1)
    tenant = rng.integers(0, n_tenants, size=n)
    turn, out = lengths.draw(rng, n)
    return _finish(t, tenant, tenant_pfx[tenant], turn, out, lengths.max_len)


def fewshot(rate: float, horizon_s: float, *, seed: int = 0,
            lengths: Optional[LengthModel] = None,
            arrival: str = "poisson", shots: int = 4,
            example_len: float = 128.0, example_sigma: float = 0.2,
            sharing: float = 8.0) -> List[RequestSpec]:
    """Few-shot templates: each template concatenates `shots` examples
    (lognormal length around `example_len`), shared by ~`sharing` requests;
    the per-request query is drawn from the length model."""
    lengths = lengths or LengthModel()
    rng = _family_rng(seed, 2)
    t = _arrival_times(arrival, rate, horizon_s, seed)
    n = len(t)
    n_tpl = max(1, int(round(n / max(sharing, 1.0))))
    tpl_pfx = np.stack([
        _clamped_lognorm(rng, example_len, example_sigma, shots, 1,
                         lengths.max_len // max(shots, 1)).sum()
        for _ in range(n_tpl)])
    tpl_pfx = np.clip(tpl_pfx, 1, lengths.max_len - 1)
    tpl = rng.integers(0, n_tpl, size=n)
    turn, out = lengths.draw(rng, n)
    return _finish(t, tpl, tpl_pfx[tpl], turn, out, lengths.max_len)


def agentic_fanout(rate: float, horizon_s: float, *, seed: int = 0,
                   lengths: Optional[LengthModel] = None,
                   arrival: str = "poisson", fanout: int = 8,
                   spread_s: float = 0.5, prefix_len: float = 512.0,
                   prefix_sigma: float = 0.4) -> List[RequestSpec]:
    """Agentic fan-out: parent tasks arrive at `rate / fanout`; each spawns
    `fanout` sub-requests within `spread_s` seconds, all sharing the
    parent's accumulated context as their prefix (sharing factor ==
    `fanout`, and the copies are nearly simultaneous — the hardest case
    for a non-sharing allocator)."""
    lengths = lengths or LengthModel()
    rng = _family_rng(seed, 3)
    parents = _arrival_times(arrival, rate / max(fanout, 1), horizon_s, seed)
    n_par = len(parents)
    par_pfx = _clamped_lognorm(rng, prefix_len, prefix_sigma, n_par, 1,
                               lengths.max_len - 1)
    t = np.repeat(parents, fanout) + rng.uniform(0.0, spread_s,
                                                 size=n_par * fanout)
    ids = np.repeat(np.arange(n_par), fanout)
    turn, out = lengths.draw(rng, n_par * fanout)
    return _finish(t, ids, par_pfx[ids], turn, out, lengths.max_len)


WORKLOADS: Dict[str, object] = {
    "chat_sysprompt": chat_sysprompt,
    "fewshot": fewshot,
    "agentic_fanout": agentic_fanout,
}


def generate_workload(workload: str, rate: float, horizon_s: float, *,
                      seed: int = 0, lengths: Optional[LengthModel] = None,
                      **kwargs) -> List[RequestSpec]:
    """Dispatch by workload-family name; "plain" falls through to the
    arrival-process dispatcher (no prefix structure)."""
    if workload == "plain":
        kwargs.pop("prefix_len", None)
        kwargs.pop("sharing", None)
        return generate(kwargs.pop("arrival", "poisson"), rate, horizon_s,
                        seed=seed, lengths=lengths, **kwargs)
    if workload not in WORKLOADS:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(WORKLOADS)} (+ plain)")
    fn = WORKLOADS[workload]
    # families expose different knobs (fewshot has shots, fanout has no
    # sharing, ...): drop the ones a family doesn't take so campaign/CLI
    # code can pass one uniform knob set
    import inspect
    accepted = set(inspect.signature(fn).parameters)
    kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    return fn(rate, horizon_s, seed=seed, lengths=lengths, **kwargs)


def materialize_tokens(specs: Sequence[RequestSpec], vocab_size: int,
                       seed: int = 0) -> List[np.ndarray]:
    """Concrete token arrays for a spec list, aligned by position.

    Requests sharing a `prefix_id` get byte-identical leading
    `prefix_len` tokens (drawn once per group from a substream keyed by
    the id), followed by a per-request tail — deterministic in (seed,
    prefix_id, rid) regardless of list order."""
    group_len: Dict[int, int] = {}
    for s in specs:
        if s.prefix_id is not None:
            group_len[s.prefix_id] = max(group_len.get(s.prefix_id, 0),
                                         s.prefix_len)
    group_tok = {
        g: np.random.default_rng([seed, 1000003, g]).integers(
            0, vocab_size, size=n, dtype=np.int64)
        for g, n in group_len.items()}
    out = []
    for s in specs:
        tail_rng = np.random.default_rng([seed, 7919, s.rid])
        pfx = (group_tok[s.prefix_id][:s.prefix_len]
               if s.prefix_id is not None else
               np.zeros(0, np.int64))
        tail = tail_rng.integers(0, vocab_size,
                                 size=max(s.prompt_len - len(pfx), 0),
                                 dtype=np.int64)
        out.append(np.concatenate([pfx, tail]))
    return out
