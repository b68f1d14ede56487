"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Drives the port's main path: paged serving of full-width dsr1d-qwen-1.5b
(random bf16 weights from a seeded generator), then the Stage-II (C, B)
sweep over the serving trace. It builds the CUDA kernels from
`src/repro_torch/csrc/` first, holds every kernel against its plain PyTorch
version at the main path's shapes, and checks that the main path launched
each kernel. Each phase prints one JSON line; the last two lines are the
card's `nvidia-smi` name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Any failed phase raises: the script exits nonzero without that line, as it
does when no CUDA device is present.

Run from the root of the repository:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
ARCH = "dsr1d-qwen-1.5b"
SLOTS, PAGE_SIZE, CHUNK_STEPS = 8, 16, 16
REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 16, 64, 512, 64
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core rate,
# float32 and float64 rates outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.float64: 34e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
REPLACES = {
    "paged_gqa_decode": "src/repro/kernels/paged_gqa_decode/kernel.py:174",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
    "exact_bank_stats": "src/repro/kernels/bank_energy/kernel.py:144",
    "bank_energy": "src/repro/kernels/bank_energy/kernel.py:192",
}
SOURCE = {
    "paged_gqa_decode": "src/repro_torch/csrc/paged_gqa_decode.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "exact_bank_stats": "src/repro_torch/csrc/bank_energy.cu",
    "bank_energy": "src/repro_torch/csrc/bank_energy.cu",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn` over `reps` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def prompt_lengths() -> np.ndarray:
    return np.random.default_rng(SEED).integers(PROMPT_MIN, PROMPT_MAX + 1,
                                                REQUESTS)


# ---------------------------------------------------------------- kernels
def decode_case(gen, B, H, K, d, lengths, dtype, num_pages):
    """Random pools and ragged page tables; slot 0 is inactive (all null
    page, length 1)."""
    from repro_torch.serve.paged import pages_for
    P = pages_for(int(max(lengths)), PAGE_SIZE)
    dev = "cuda"
    q = torch.randn((B, H, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((num_pages, K, PAGE_SIZE, d), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((num_pages, K, PAGE_SIZE, d), generator=gen,
                     device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    table = torch.zeros((B, P), dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    nxt = 0
    for b in range(B):
        n = pages_for(int(lengths[b]), PAGE_SIZE) if b else 0
        table[b, :n] = perm[nxt:nxt + n].int()
        nxt += n
    lens[0] = 1
    return q, kp, vp, table, lens


def kernel_phase(gen) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_gqa_decode import (paged_gqa_decode,
                                                      paged_gqa_decode_ref)
    cfg = get_arch(ARCH)
    gpt2 = get_arch("gpt2-xl")
    lengths = prompt_lengths()
    rows = {}

    # paged decode at the serve's shapes: 8 slots mid-decode
    dec_lens = np.r_[1, lengths[1:SLOTS] + NEW_TOKENS // 2]
    per_slot = -(-(PROMPT_MAX + NEW_TOKENS) // PAGE_SIZE)
    num_pages = SLOTS * per_slot + 1
    for tag, c, dtype in ((ARCH, cfg, torch.bfloat16),
                          (ARCH, cfg, torch.float32),
                          ("gpt2-xl", gpt2, torch.float32)):
        q, kp, vp, table, lens = decode_case(
            gen, SLOTS, c.num_heads, c.num_kv_heads, c.head_dim, dec_lens,
            dtype, num_pages)
        out = paged_gqa_decode(q, kp, vp, table, lens)
        ref = paged_gqa_decode_ref(q.float(), kp.float(), vp.float(), table,
                                   lens)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out.float()).all()), "decode finite")
        check(err <= TOL[dtype], f"paged decode {tag} {dtype}: {err}")
        isz = q.element_size()
        nbytes = (2 * q.numel() * isz + table.numel() * 4 + lens.numel() * 4
                  + 2 * int(lens.sum()) * c.num_kv_heads * c.head_dim * isz)
        flops = 4.0 * int(lens.sum()) * c.num_heads * c.head_dim
        b_ms, b_by = bound(nbytes, flops, dtype)
        row = dict(shape=f"B{SLOTS} H{c.num_heads} K{c.num_kv_heads} "
                   f"d{c.head_dim} ps{PAGE_SIZE} ctx{int(lens.sum())}",
                   arch=tag, dtype=str(dtype), max_abs_err=err,
                   tolerance=TOL[dtype],
                   ms=cuda_ms(lambda: paged_gqa_decode(q, kp, vp, table,
                                                       lens)),
                   plain_ms=cuda_ms(lambda: paged_gqa_decode_ref(
                       q, kp, vp, table, lens), reps=5),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        rows.setdefault("paged_gqa_decode", []).append(row)

    # prefill attention at the serve's longest and a ragged prompt
    for tag, c, S, dtype in ((ARCH, cfg, int(lengths.max()), torch.bfloat16),
                             (ARCH, cfg, int(lengths.max()), torch.float32),
                             (ARCH, cfg, int(lengths.min()), torch.float32),
                             ("gpt2-xl", gpt2, 333, torch.float32)):
        H, K, d = c.num_heads, c.num_kv_heads, c.head_dim
        q = torch.randn((1, S, H, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, S, K, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, S, K, d), generator=gen, device="cuda").to(dtype)
        out = flash_attention(q, k, v)
        ref = flash_attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out.float()).all()), "flash finite")
        check(err <= TOL[dtype], f"flash {tag} S={S} {dtype}: {err}")
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
        flops = 4.0 * H * d * S * (S + 1) / 2
        b_ms, b_by = bound(nbytes, flops, dtype)
        # the library yardstick: one SDPA call on heads-major views, with
        # the KV heads repeated for the GQA group beforehand
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  for x in (k, v))
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        row = dict(shape=f"B1 S{S} H{H} K{K} d{d}", arch=tag,
                   dtype=str(dtype), max_abs_err=err, tolerance=TOL[dtype],
                   ms=cuda_ms(lambda: flash_attention(q, k, v)),
                   plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v),
                                    reps=5),
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        rows.setdefault("flash_attention", []).append(row)
    return rows


# -------------------------------------------------------------- bank kernels
def bank_case(durations, occupancy, usable, nbanks, threshold) -> dict:
    """Both bank kernels against their plain versions on one trace and
    candidate grid; counts must match exactly, seconds to rel 1e-12."""
    from repro_torch.kernels.bank_energy import (bank_activity_stats,
                                                 bank_energy_ref,
                                                 exact_bank_stats,
                                                 exact_bank_stats_ref)
    t = [torch.as_tensor(np.asarray(x, np.float64), device="cuda")
         for x in (durations, occupancy, usable, nbanks, threshold)]
    d, o, u, nb, th = t
    S, C = len(d), len(u)
    out = {}
    for name, fn, ref, args, cnt, sec in (
            ("exact_bank_stats", exact_bank_stats, exact_bank_stats_ref,
             (d, o, u, nb, th), [1, 3], [0, 2, 4]),
            ("bank_energy", bank_activity_stats, bank_energy_ref,
             (d, o, u, nb), [1], [0])):
        got = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        check(bool(torch.equal(got[:, cnt], want[:, cnt])),
              f"{name}: counts differ from the plain version")
        rel = float(((got[:, sec] - want[:, sec]).abs()
                     / want[:, sec].abs().clamp_min(1e-300)).max())
        check(rel <= 1e-12, f"{name}: seconds rel err {rel}")
        ncols = got.shape[1]
        nbytes = 16 * S + 8 * C * (len(args) - 2) + 8 * C * ncols
        flops = 4.0 * S * C
        b_ms, b_by = bound(nbytes, flops, torch.float64)
        out[name] = dict(shape=f"S{S} C{C}", dtype="float64",
                         max_abs_err=max_err(got, want), max_rel_err=rel,
                         tolerance="counts exact, seconds rel 1e-12",
                         ms=cuda_ms(lambda: fn(*args), reps=5),
                         plain_ms=cuda_ms(lambda: ref(*args), reps=2,
                                          warmup=1),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def synthetic_trace(S: int, C: int):
    """A seeded trace of `S` segments (a mix of microsecond and
    millisecond durations, KiB-granular occupancy up to 128 MiB) and `C`
    candidates: capacities 16..128 MiB x banks 1..32 x thresholds."""
    rng = np.random.default_rng(SEED)
    d = np.where(rng.random(S) < 0.5, 1e-6, rng.random(S) * 1e-3)
    o = np.round(np.cumsum(rng.normal(0, 2**16, S)).clip(0) % 2**27 / 1024)
    o = o * 1024.0
    caps = np.arange(16, 129, 16) * 2.0**20
    banks = np.array([1, 2, 4, 8, 16, 32], float)
    grid = [(c, b) for c in caps for b in banks]
    reps = -(-C // len(grid))
    cb = np.array((grid * reps)[:C])
    usable = 0.9 * (cb[:, 0] / cb[:, 1])
    threshold = rng.uniform(0, 2e-3, C)
    return d, o, usable, cb[:, 1], threshold


# ------------------------------------------------------------------- main
def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.cacti import characterize
    from repro_torch.core.candidates import Candidate
    from repro_torch.core.explorer import MIB, min_capacity_mib, sweep
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    from repro_torch.serve import PagedContinuousBatcher, Request

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         libraries=sorted(p.name for p in libs.values()))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = kernel_phase(gen)
    emit("kernels", **rows)

    # ---- reference: the port on the card vs its plain path on the CPU ----
    small = reduced(get_arch(ARCH), layers=2)
    cpu_params = init_params(small, torch.Generator().manual_seed(SEED),
                             device="cpu")
    outs = {"cuda": (DecoderLM(small, torch.float32, "cuda"),
                     _to(cpu_params, "cuda")),
            "cpu": (DecoderLM(small, torch.float32, "cpu"), cpu_params)}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, small.vocab_size, int(n))
               for n in rng.integers(5, 60, 6)]
    served = {}
    for dev, (m, p) in outs.items():
        cb = PagedContinuousBatcher(m, p, num_slots=3, page_size=8,
                                    num_pages=40, max_pages_per_slot=12,
                                    chunk_steps=4)
        for i, pr in enumerate(prompts):
            cb.submit(Request(rid=i, tokens=pr, max_new_tokens=12))
        done = sorted(cb.run(), key=lambda r: r.rid)
        tab = sweep(cb.occupancy_bundle(), mem_name="kv",
                    capacities_mib=[1, 2], banks=[1, 2, 4], device=dev,
                    prune=True)
        served[dev] = ([r.output for r in done],
                       [(r.capacity_mib, r.banks, r.result.e_total)
                        for r in tab.rows])
    tok_eq = served["cuda"][0] == served["cpu"][0]
    check(tok_eq, "reduced-model greedy tokens on the card == CPU plain path")
    check([r[:2] for r in served["cuda"][1]] == [r[:2] for r in
                                                 served["cpu"][1]],
          "reduced-model sweep rows on the card == CPU plain path")
    emit("reference", arch=small.name, requests=len(prompts),
         tokens_equal=tok_eq, sweep_rows=len(served["cuda"][1]))

    # ---- serve: the main path at full width, launch counts from 0 ----
    cfg = get_arch(ARCH)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, compute_dtype=torch.bfloat16, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lengths = prompt_lengths()
    per_slot = -(-(PROMPT_MAX + NEW_TOKENS - 1) // PAGE_SIZE)
    cb = PagedContinuousBatcher(
        model, params, num_slots=SLOTS, page_size=PAGE_SIZE,
        num_pages=SLOTS * per_slot + 1, max_pages_per_slot=per_slot,
        chunk_steps=CHUNK_STEPS)
    prng = np.random.default_rng(SEED + 1)
    for i, n in enumerate(lengths):
        cb.submit(Request(rid=i, tokens=prng.integers(0, cfg.vocab_size,
                                                      int(n)),
                          max_new_tokens=NEW_TOKENS))
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = cb.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    st = cb.stats
    check(len(done) == REQUESTS and st.finished == REQUESTS,
          "all requests finished")
    check(all(len(r.output) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.output)
              for r in done), "every request has NEW_TOKENS in-vocab tokens")
    serve_counts = build.launch_counts()
    steps = st.chunks * CHUNK_STEPS
    check(serve_counts["paged_gqa_decode"] == cfg.num_layers * steps,
          f"decode launches {serve_counts['paged_gqa_decode']} == layers x "
          f"steps {cfg.num_layers * steps}")
    check(serve_counts["flash_attention"] == cfg.num_layers * st.prefills,
          "prefill launches == layers x prefills")
    emit("serve", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype="bfloat16",
         slots=SLOTS, page_size=PAGE_SIZE, chunk_steps=CHUNK_STEPS,
         requests_finished=st.finished, decode_tokens=st.decode_steps,
         decode_steps=steps, chunks=st.chunks, prefills=st.prefills,
         peak_pages=st.peak_pages, page_bytes=cb.page_bytes,
         wall_s=serve_s, init_s=init_s,
         # wall time of the whole run, admission prefills included
         decode_tokens_per_s=st.decode_steps / serve_s,
         launches=serve_counts)

    # ---- stage2: pruned sweep on the serve trace (still counted) ----
    bundle = cb.occupancy_bundle()
    trace = bundle.traces["kv"]
    m = min_capacity_mib(trace.peak_needed())
    sweep_kw = dict(mem_name="kv", capacities_mib=[m, m + 32, m + 64],
                    banks=[1, 2, 4, 8, 16], prune=True)
    t0 = time.perf_counter()
    table = sweep(bundle, device="cuda", **sweep_kw)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = build.launch_counts()
    check(len(table.rows) > 0, "sweep table is non-empty")
    for name in REPLACES:
        check(launches[name] > 0, f"main path launched {name}")
    plain = sweep(bundle, device="cpu", **sweep_kw)
    check([(r.capacity_mib, r.banks) for r in table.rows]
          == [(r.capacity_mib, r.banks) for r in plain.rows],
          "sweep rows equal the plain-version sweep")
    rel = max(abs(a.result.e_total / b.result.e_total - 1.0)
              for a, b in zip(table.rows, plain.rows))
    check(rel <= 1e-12, f"sweep e_total rel err {rel}")
    check(all(a.result.n_transitions == b.result.n_transitions
              for a, b in zip(table.rows, plain.rows)),
          "sweep transition counts equal")
    best = table.best()
    emit("stage2", segments=len(trace.segments(bundle.total_time)[0]),
         peak_needed_bytes=trace.peak_needed(), capacities_mib=[m, m + 32,
                                                                m + 64],
         rows=len(table.rows), e_total_rel_err=rel, sweep_s=sweep_s,
         best={"capacity_mib": best.capacity_mib, "banks": best.banks,
               "e_total_j": best.result.e_total})

    # the bank kernels at the sweep's own inputs, then at scale
    dur, occ = trace.occupancy_series(bundle.total_time, use="needed")
    # the sweep's gated candidates (conservative policy: alpha 0.9, 5x
    # break-even)
    cands = [Candidate(c * MIB, b, 0.9, "gate", 5.0)
             for c in sweep_kw["capacities_mib"] for b in sweep_kw["banks"]]
    th = np.array([c.min_gate_multiple * characterize(
        c.capacity, c.banks).break_even_s for c in cands])
    bank_main = bank_case(dur, occ, [c.usable_bytes for c in cands],
                          [float(c.banks) for c in cands], th)
    t0 = time.perf_counter()
    bank_big = bank_case(*synthetic_trace(1 << 20, 360))
    emit("bank_kernels", main_path=bank_main, synthetic_1m_x_360=bank_big,
         wall_s=time.perf_counter() - t0)

    kernels = []
    for name in ("paged_gqa_decode", "flash_attention"):
        row = rows[name][0]            # the main path's dtype (bfloat16)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], dtype=row["dtype"]))
    for name in ("exact_bank_stats", "bank_energy"):
        row = bank_main[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            shape=row["shape"], dtype="float64"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
