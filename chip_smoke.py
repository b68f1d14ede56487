"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Drives the port's paths: paged serving of full-width dsr1d-qwen-1.5b
(random bf16 weights from a seeded generator) with native bf16 pages, then
the Stage-II (C, B) sweep over the serving trace; the same stream with int8
and with fp8 KV pages, each trace gated at the bf16 run's peak capacity;
the int8 SwiGLU FFN of layer 0 through the int8 matmul; the same stream
again with speculative decoding (k = 3, the skip-2 self-spec draft), whose
target verifies each round through the paged verify kernel; and dense
serving (`BatchedServer`, `ContinuousBatcher`) through the dense GQA decode
kernel; and the paper's own flow: Stage I (the host simulator) of
full-width dsr1d-qwen-1.5b (GQA) and gpt2-xl (MHA), prefill at M 2048 and
a decode horizon of about a million trace segments, each trace swept on
the card with pruning off and on and held to the same sweep on the CPU,
then the `trapti` CLI once on the card. It builds the
CUDA kernels from `src/repro_torch/csrc/` first, holds every kernel against
its plain PyTorch version at its path's shapes, and checks that each path
launched its kernels (launch counts are set to 0 just before a path and
read just after it). The bf16 tensor-core prefill kernel is also held to
its mirror and to equal rows for a shorter prompt, and the split-context
decode kernels (dense, paged on float, fp8 and int8 pools, and verify) to
their split mirrors and to equal rows at batch 1 and 8, each verify row to
the paged decode kernel at its length bit for bit, and the fp8 decode to
the 256-entry table; the int8 matmul's int32 accumulators are held
exactly and its output bit for bit. Prefill, dense decode, paged decode,
verify and the int8 matmul also get device times from a CUDA graph,
beside one library call's where there is one (SDPA, `torch._int_mm`).
The bank kernels are also run at a million segments (360 candidates, and
the pruned sweep's single incumbent), where the exact kernel's scan and
walk are timed apart beside the serial floor (a small kernel adding the
trace's length of f64 numbers in one thread) and its running time is held
to np.cumsum bit for bit; both bank kernels give the same bits twice.
The bank kernels are also timed at each decode horizon's own shape.
Each phase prints one JSON line; the last three lines
are the kernel summary, the card's `nvidia-smi` name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Any failed phase raises: the script exits nonzero without that line, as it
does when no CUDA device is present.

Run from the root of the repository:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
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
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 and int8
# tensor-core rates, float32 and float64 rates outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12,
              torch.float32: 67e12, torch.float64: 34e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
REPLACES = {
    "paged_gqa_decode": "src/repro/kernels/paged_gqa_decode/kernel.py:174",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
    "exact_bank_stats": "src/repro/kernels/bank_energy/kernel.py:144",
    "bank_energy": "src/repro/kernels/bank_energy/kernel.py:192",
    "paged_gqa_decode_quant":
        "src/repro/kernels/paged_gqa_decode/kernel.py:118",
    "int8_matmul": "src/repro/kernels/int8_matmul/kernel.py:41",
    "paged_gqa_verify": "src/repro/kernels/paged_gqa_verify/kernel.py:77",
    "gqa_decode": "src/repro/kernels/gqa_decode/kernel.py:66",
}
SOURCE = {
    "paged_gqa_decode": "src/repro_torch/csrc/paged_gqa_decode.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "exact_bank_stats": "src/repro_torch/csrc/bank_energy.cu",
    "bank_energy": "src/repro_torch/csrc/bank_energy.cu",
    "paged_gqa_decode_quant": "src/repro_torch/csrc/paged_gqa_decode.cu",
    "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu",
    "paged_gqa_verify": "src/repro_torch/csrc/paged_gqa_verify.cu",
    "gqa_decode": "src/repro_torch/csrc/gqa_decode.cu",
}
# the kernels of the bf16 main path (serve + sweep); `running_time` is the
# exact bank kernel's scan, launched once per sweep
MAIN_PATH_KERNELS = ("paged_gqa_decode", "flash_attention",
                     "exact_bank_stats", "bank_energy")
BANK_VARIANT = {
    "exact_bank_stats": "sequential f64 scan, then a segment-parallel event "
                        "walk (chunk summaries, prefix max over chunks)",
    "bank_energy": "one pass: tiles x candidate groups, per-tile partials "
                   "reduced in tile order"}
KV_DTYPES = ("native", "int8", "fp8")
# full-width dsr1d SwiGLU: M = the serve's longest prompt, D 1536, F 8960
FFN_SHAPES = ((1536, 8960), (8960, 1536))
# speculative serving: drafted tokens per round, self-spec layer skip
SPEC_K, SPEC_SKIP = 3, 2
# dense serving: BatchedServer batch x prompt -> new tokens; ContinuousBatcher
# requests (the serve's first prompts) and cache length
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 8, 128, 32
DENSE_REQUESTS, DENSE_MAX_LEN = 4, 640
# Stage I: the paper's two workloads (full width, all layers) on the
# baseline accelerator's 128 MiB SRAM, prefill at M 2048 and the decode
# horizon through PSS; each trace swept over its minimum capacity and the
# next two 16 MiB steps, the CLI's default banks (`explorer.DEFAULT_BANKS`),
# the conservative policy
STAGE1_ARCHS = ("dsr1d-qwen-1.5b", "gpt2-xl")
STAGE1_SRAM_MIB, STAGE1_M = 128, 2048
STAGE1_HORIZON = dict(start_ctx=2048, steps=1024, batch=16, fidelity="pss")


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


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of `fn`: `calls` back-to-back calls
    captured in one CUDA graph, replayed `reps` times between CUDA events
    (median). Unlike `cuda_ms` it leaves out the host's launch overhead,
    which exceeds a kernel of a few microseconds."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def timed(fn, lib) -> dict:
    """The times of a kernel and of its one-call library yardstick: CUDA
    events around one call, host launch overhead included, as every row is
    timed (`ms`, `library_ms`), and device time per call from a CUDA graph
    (`device_ms`, `library_device_ms`)."""
    return dict(ms=cuda_ms(fn), library_ms=cuda_ms(lib),
                device_ms=graph_ms(fn), library_device_ms=graph_ms(lib))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def serial_floor_ms(S: int) -> float:
    """Milliseconds of S dependent f64 additions in one thread on the card
    (`serial_floor_f64` of csrc/bank_energy.cu; CUDA events, median of 5),
    the serial floor of the exact kernel's running time."""
    import ctypes
    from repro_torch.kernels import build
    floor = build.CudaKernel("serial_floor", "bank_energy",
                             "serial_floor_f64",
                             [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_void_p])
    x = torch.rand(4, dtype=torch.float64, device="cuda") * 1e-3
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    return cuda_ms(lambda: floor(build.ptr(x), build.ptr(out), S,
                                 build.stream_ptr(x)), reps=5, warmup=1)


def profiled_kernels(fn, calls: int = 5) -> dict:
    """{kernel name: device milliseconds per call} of the kernels `fn`
    launches, PyTorch's own and copies left out, from torch.profiler's
    trace of `calls` calls ({} if the trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and not any(x in ev.key for x in ("at::", "Memcpy", "Memset",
                                                "Activity")):
            out[ev.key[:64]] = float(t) / calls / 1e3
    return out


def kernel_ms(profile: dict, names):
    """The device milliseconds of `profiled_kernels`' result in the kernels
    whose names contain one of `names` (None if it holds none of them)."""
    times = [t for k, t in profile.items() if any(n in k for n in names)]
    return sum(times) if times else None


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
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode, paged_gqa_decode_ref, paged_gqa_decode_split_ref)
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
        rows.setdefault("paged_gqa_decode", []).append(decode_row(
            tag, c, paged_gqa_decode, paged_gqa_decode_ref,
            (q, kp, vp, table, lens), lens, kp.element_size(),
            paged_gqa_decode_split_ref))

    # the same kernel on the pools of the quantized and mixed paths: fp8
    # E4M3 codes, and float32 pages under a bfloat16 model (kv_dtype="fp32")
    from repro_torch.kernels.quant import quantize_page_rows, to_fp8_codes
    for pools in ("fp8", "float32"):
        q, kp, vp, table, lens = decode_case(
            gen, SLOTS, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            dec_lens, torch.float32, num_pages)
        q = q.to(torch.bfloat16)
        if pools == "fp8":
            kp, vp = to_fp8_codes(kp), to_fp8_codes(vp)
        rows["paged_gqa_decode"].append(decode_row(
            f"{ARCH} pools {pools}", cfg, paged_gqa_decode,
            paged_gqa_decode_ref, (q, kp, vp, table, lens), lens,
            kp.element_size(), paged_gqa_decode_split_ref))
    rows["fp8_decode"] = fp8_code_check()

    # the int8 kernel at the int8 path's shapes: pools quantized per row.
    # gpt2-xl runs in float32, as kernel 1's gpt2-xl case: with a bf16
    # query the output's own rounding (half a bf16 step is 0.0156 for
    # values in [4, 8)) exceeds the absolute bf16 tolerance
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode_quant, paged_gqa_decode_quant_mirror_ref,
        paged_gqa_decode_quant_ref, paged_gqa_decode_quant_split_ref)
    for tag, c, dtype in ((ARCH, cfg, torch.bfloat16),
                          (ARCH, cfg, torch.float32),
                          ("gpt2-xl", gpt2, torch.float32)):
        q, kf, vf, table, lens = decode_case(
            gen, SLOTS, c.num_heads, c.num_kv_heads, c.head_dim, dec_lens,
            torch.float32, num_pages)
        q = q.to(dtype)
        (kp, ks), (vp, vs) = quantize_page_rows(kf), quantize_page_rows(vf)
        args = (q, kp, vp, ks, vs, table, lens)
        row = decode_row(f"{tag} int8", c, paged_gqa_decode_quant,
                         paged_gqa_decode_quant_ref, args, lens, 1,
                         paged_gqa_decode_quant_split_ref, scale_bytes=4)
        out = paged_gqa_decode_quant(*args)
        mirror = paged_gqa_decode_quant_mirror_ref(*args)
        row["max_abs_err_mirror"] = max_err(out, mirror)
        check(row["max_abs_err_mirror"] <= TOL[dtype],
              f"int8 decode {tag} vs mirror: {row['max_abs_err_mirror']}")
        rows.setdefault("paged_gqa_decode_quant", []).append(row)

    # prefill attention at the serve's longest and a ragged prompt
    S_max, S_min = int(lengths.max()), int(lengths.min())
    for tag, c, S, dtype in ((ARCH, cfg, S_max, torch.bfloat16),
                             (ARCH, cfg, S_max, torch.float32),
                             (ARCH, cfg, S_min, torch.float32),
                             ("gpt2-xl", gpt2, 333, torch.bfloat16),
                             ("gpt2-xl", gpt2, 333, torch.float32)):
        rows.setdefault("flash_attention", []).append(
            flash_row(gen, tag, c, S, S_min, dtype))

    rows["int8_matmul"] = [int8_mm_row(gen, int(lengths.max()), k, n)
                           for k, n in FFN_SHAPES]

    # speculative verify at the spec serve's shapes: V = k + 1 window rows
    # over the same mid-decode contexts
    from repro_torch.kernels.quant import to_fp8_codes
    V = SPEC_K + 1
    for tag, c, dtype, pools in ((ARCH, cfg, torch.bfloat16, "bfloat16"),
                                 (ARCH, cfg, torch.bfloat16, "fp8"),
                                 (ARCH, cfg, torch.float32, "float32"),
                                 ("gpt2-xl", gpt2, torch.float32, "float32")):
        q, kp, vp, table, lens = decode_case(
            gen, SLOTS, c.num_heads, c.num_kv_heads, c.head_dim,
            dec_lens + V, torch.float32, num_pages)
        q = torch.randn((SLOTS, V, c.num_heads, c.head_dim), generator=gen,
                        device="cuda").to(dtype)
        if pools == "fp8":
            kp, vp = to_fp8_codes(kp), to_fp8_codes(vp)
        else:
            kp, vp = kp.to(dtype), vp.to(dtype)
        base = (lens - V).clamp(min=0)
        rows.setdefault("paged_gqa_verify", []).append(verify_row(
            f"{tag} pools {pools}", c, (q, kp, vp, table, base)))

    # dense decode at the dense serve's cache length, through the
    # (B, K, T, d) view of a (B, T, K, d) cache, as the decode step passes
    # it: BatchedServer's batch of 8, then ContinuousBatcher's batch of 1
    dense_lens = np.r_[lengths[:SLOTS - 1] + NEW_TOKENS // 2, DENSE_MAX_LEN]
    for tag, c, dtype, lens in ((ARCH, cfg, torch.bfloat16, dense_lens),
                                (ARCH, cfg, torch.float32, dense_lens),
                                ("gpt2-xl", gpt2, torch.float32, dense_lens),
                                (ARCH, cfg, torch.bfloat16, dense_lens[:1])):
        rows.setdefault("gqa_decode", []).append(
            dense_row(gen, tag, c, lens, dtype))
    return rows


def flash_row(gen, tag, c, S, S_min, dtype) -> dict:
    """The prefill kernel `flash_attention` dispatches to (`variant`)
    against the float32 plain version at one prompt; a bf16 prompt also
    against the tensor-core kernel's mirror (within one bf16 step at the
    output's largest magnitude, and each element within one bf16 step of
    the mirror's plus MIRROR_ATOL) and, cut to S_min, for equal
    shared rows (0.0). The
    library yardstick is one SDPA call on heads-major views, with the KV
    heads repeated for the GQA group beforehand."""
    from repro_torch.kernels.flash_attention import (
        MIRROR_ATOL, bf16_excess, bf16_step, flash_attention,
        flash_attention_bf16_mirror_ref, flash_attention_ref, variant)
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
    want = "tensor-core" if dtype == torch.bfloat16 else "cuda-core"
    check(variant(q) == want, f"flash {tag} {dtype} runs the {want} kernel")
    extra = {}
    if dtype == torch.bfloat16:
        mirror = flash_attention_bf16_mirror_ref(q, k, v)
        extra = dict(max_abs_err_mirror=max_err(out, mirror),
                     mirror_step=float(bf16_step(mirror).max()),
                     mirror_excess=bf16_excess(out, mirror),
                     mirror_tolerance=MIRROR_ATOL,
                     prefix_rows=S_min, prefix_max_abs_diff=max_err(
                         out[:, :S_min], flash_attention(
                             q[:, :S_min], k[:, :S_min], v[:, :S_min])))
        check(extra["max_abs_err_mirror"] <= extra["mirror_step"],
              f"flash {tag} vs its bf16 mirror: "
              f"{extra['max_abs_err_mirror']} > one bf16 step of the output "
              f"{extra['mirror_step']}")
        check(extra["mirror_excess"] <= MIRROR_ATOL,
              f"flash {tag} vs its bf16 mirror: an element strays "
              f"{extra['mirror_excess']} beyond one bf16 step, > "
              f"{MIRROR_ATOL}")
        check(extra["prefix_max_abs_diff"] == 0.0,
              f"flash {tag}: rows of prompt[:{S_min}] vs prompt[:{S}] "
              f"differ by {extra['prefix_max_abs_diff']}")
    isz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
    flops = 4.0 * H * d * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops, dtype)
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
              for x in (k, v))
    return dict(shape=f"B1 S{S} H{H} K{K} d{d}", arch=tag, dtype=str(dtype),
                variant=variant(q), max_abs_err=err, tolerance=TOL[dtype],
                **extra,
                **timed(lambda: flash_attention(q, k, v),
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)),
                plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v),
                                 reps=5),
                bound_ms=b_ms, bound_by=b_by)


def verify_row(tag, c, args) -> dict:
    """The verify kernel against its plain version (on a float32 copy of q)
    and its split mirror at one case, each window row against the decode
    kernel at base + v + 1, which computes the same operations (0.0), and
    each slot's batch-1 call against the batch-8 call (0.0)."""
    from repro_torch.kernels.paged_gqa_decode import paged_gqa_decode
    from repro_torch.kernels.paged_gqa_verify import (
        paged_gqa_verify, paged_gqa_verify_ref, paged_gqa_verify_split_ref)
    q, kp, vp, table, base = args
    V = q.shape[1]
    out = paged_gqa_verify(*args)
    want = paged_gqa_verify_ref(q.float(), *args[1:])
    rows_vs_decode = max(max_err(out[:, v], paged_gqa_decode(
        q[:, v], kp, vp, table, base + v + 1)) for v in range(V))
    torch.cuda.synchronize()
    err = max_err(out, want)
    check(bool(torch.isfinite(out.float()).all()), f"verify {tag} finite")
    check(err <= TOL[q.dtype], f"paged verify {tag} {q.dtype}: {err}")
    check(rows_vs_decode == 0.0,
          f"paged verify {tag}: window rows vs decode {rows_vs_decode}")
    extra = split_checks(f"verify {tag}", paged_gqa_verify,
                         paged_gqa_verify_split_ref, out, args)
    # each slot reads its context plus the window once; window row v scores
    # base + v + 1 rows
    K, d, H = c.num_kv_heads, c.head_dim, c.num_heads
    read_rows = int((base + V).sum())
    scored = int((base[:, None] + torch.arange(1, V + 1, device="cuda")
                  ).sum())
    nbytes = (2 * q.numel() * q.element_size() + table.numel() * 4
              + base.numel() * 4 + 2 * read_rows * K * d * kp.element_size())
    b_ms, b_by = bound(nbytes, 4.0 * scored * H * d, q.dtype)
    return dict(shape=f"B{SLOTS} V{V} H{H} K{K} d{d} ps{PAGE_SIZE} "
                f"ctx{read_rows}", arch=tag, dtype=str(q.dtype),
                max_abs_err=err, tolerance=TOL[q.dtype],
                max_abs_err_rows_vs_decode=rows_vs_decode, **extra,
                ms=cuda_ms(lambda: paged_gqa_verify(*args)),
                device_ms=graph_ms(lambda: paged_gqa_verify(*args)),
                plain_ms=cuda_ms(lambda: paged_gqa_verify_ref(*args), reps=5),
                bound_ms=b_ms, bound_by=b_by,
                # a page gather plus SDPA is not one call
                library_ms=None)


def dense_row(gen, tag, c, lengths, dtype) -> dict:
    """The dense decode kernel against its plain version and its split
    mirror on a (B, T, K, d) cache seen as (B, K, T, d); at B > 1 each
    sequence's batch-1 call must give its batch row bit for bit (0.0). The
    library yardstick is one SDPA call with the lengths mask and the KV
    heads shared by the group."""
    from repro_torch.kernels.gqa_decode import (SPLIT_ROWS, gqa_decode,
                                                gqa_decode_ref,
                                                gqa_decode_split_ref,
                                                num_splits)
    B, T = len(lengths), DENSE_MAX_LEN
    H, K, d = c.num_heads, c.num_kv_heads, c.head_dim
    q = torch.randn((B, H, d), generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn((B, T, K, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2) for _ in range(2))
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    out = gqa_decode(q, kc, vc, lens)
    want = gqa_decode_ref(q.float(), kc, vc, lens)
    mirror = gqa_decode_split_ref(q.float(), kc, vc, lens, SPLIT_ROWS)
    torch.cuda.synchronize()
    err, err_mirror = max_err(out, want), max_err(out, mirror)
    check(bool(torch.isfinite(out.float()).all()), f"dense {tag} finite")
    check(err <= TOL[dtype], f"gqa_decode {tag} {dtype}: {err}")
    check(err_mirror <= TOL[dtype],
          f"gqa_decode {tag} {dtype} vs split mirror: {err_mirror}")
    extra = {}
    if B > 1:
        extra["batch_invariance_max_abs_diff"] = max(
            max_err(out[b:b + 1], gqa_decode(q[b:b + 1], kc[b:b + 1],
                                               vc[b:b + 1], lens[b:b + 1]))
            for b in range(B))
        check(extra["batch_invariance_max_abs_diff"] == 0.0,
              f"gqa_decode {tag}: batch-1 rows differ from the batch-{B} "
              f"call by {extra['batch_invariance_max_abs_diff']}")
    ctx = int(lens.clamp(max=T).sum())
    nbytes = (2 * q.numel() * q.element_size() + lens.numel() * 4
              + 2 * ctx * K * d * q.element_size())
    b_ms, b_by = bound(nbytes, 4.0 * ctx * H * d, dtype)
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    return dict(shape=f"B{B} T{T} H{H} K{K} d{d} ctx{ctx} (B,T,K,d) view",
                arch=tag, dtype=str(dtype),
                variant=f"split: split_rows {SPLIT_ROWS}, nsplit "
                f"{num_splits(T)}",
                max_abs_err=err, tolerance=TOL[dtype],
                max_abs_err_mirror=err_mirror, **extra,
                **timed(lambda: gqa_decode(q, kc, vc, lens),
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(
                            qs, kc, vc, attn_mask=mask, enable_gqa=True)),
                plain_ms=cuda_ms(lambda: gqa_decode_ref(q, kc, vc, lens),
                                 reps=5),
                bound_ms=b_ms, bound_by=b_by)


def split_checks(tag, fn, mirror, out, args) -> dict:
    """A paged split-context kernel `fn` (1, 5 or 6; `args` end with the
    page table and the lengths) against its split mirror, element by
    element (float32 within TOL; bf16 within one bf16 step of the mirror's
    element plus MIRROR_ATOL), and each slot's batch-1 call against its row
    of the batch-8 call, at the same table width (0.0)."""
    from repro_torch.kernels.flash_attention import MIRROR_ATOL, bf16_excess
    from repro_torch.kernels.gqa_decode import SPLIT_ROWS, num_splits
    q, table, lens = args[0], args[-2], args[-1]
    split = mirror(*args)
    batch1 = max(max_err(out[b:b + 1], fn(
        q[b:b + 1], *args[1:-2], table[b:b + 1], lens[b:b + 1]))
        for b in range(q.shape[0]))
    torch.cuda.synchronize()
    got = dict(variant=f"split: split_rows {SPLIT_ROWS}, nsplit "
               f"{num_splits(table.shape[1] * PAGE_SIZE)}",
               max_abs_err_split_mirror=max_err(out, split),
               batch_invariance_max_abs_diff=batch1)
    if q.dtype == torch.bfloat16:
        got.update(split_mirror_excess=bf16_excess(out, split),
                   mirror_tolerance=MIRROR_ATOL)
        check(got["split_mirror_excess"] <= MIRROR_ATOL,
              f"{tag} vs its split mirror: an element strays "
              f"{got['split_mirror_excess']} beyond one bf16 step")
    else:
        check(got["max_abs_err_split_mirror"] <= TOL[q.dtype],
              f"{tag} vs its split mirror: "
              f"{got['max_abs_err_split_mirror']}")
    check(batch1 == 0.0, f"{tag}: batch-1 rows differ from the "
          f"batch-{q.shape[0]} call by {batch1}")
    return got


def fp8_code_check() -> dict:
    """The kernels' E4M3 decode against the plain version's 256-entry table
    (NaN codes included): one slot of length 1, its V row holding every
    code, comes out of the decode kernel as that row (p = 1)."""
    from repro_torch.kernels.paged_gqa_decode import paged_gqa_decode
    from repro_torch.kernels.quant import fp8_table
    kp = torch.zeros((2, 1, PAGE_SIZE, 256), dtype=torch.uint8, device="cuda")
    vp = kp.clone()
    vp[1, 0, 0] = torch.arange(256, dtype=torch.uint8, device="cuda")
    one = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    got = paged_gqa_decode(torch.zeros((1, 1, 256), device="cuda"), kp, vp,
                           one, one[0])[0, 0]
    want = fp8_table().cuda()
    nan_equal = bool(torch.equal(got.isnan(), want.isnan()))
    mismatched = int((got.nan_to_num() != want.nan_to_num()).sum())
    check(nan_equal and mismatched == 0, f"fp8 decode vs the 256-entry "
          f"table: {mismatched} codes differ, NaN codes equal: {nan_equal}")
    return dict(codes=256, nan_codes=int(want.isnan().sum()),
                mismatched_codes=mismatched)


def decode_row(tag, c, fn, ref, args, lens, pool_isz, mirror,
               scale_bytes=0):
    """One paged decode kernel against its plain version (on float32 copies
    of q) at one case, the tolerance q's dtype's, and against its split
    mirror (`split_checks`). Times: CUDA events around one call (`ms`) and
    device time from a CUDA graph (`device_ms`)."""
    q = args[0]
    out = fn(*args)
    want = ref(q.float(), *args[1:])
    torch.cuda.synchronize()
    err = max_err(out, want)
    check(bool(torch.isfinite(out.float()).all()), f"decode {tag} finite")
    check(err <= TOL[q.dtype], f"paged decode {tag} {q.dtype}: {err}")
    extra = split_checks(f"paged decode {tag}", fn, mirror, out, args)
    ctx = int(lens.sum())
    K, d = c.num_kv_heads, c.head_dim
    nbytes = (2 * q.numel() * q.element_size() + args[-2].numel() * 4
              + lens.numel() * 4 + 2 * ctx * K * (d * pool_isz + scale_bytes))
    b_ms, b_by = bound(nbytes, 4.0 * ctx * c.num_heads * d, q.dtype)
    return dict(shape=f"B{SLOTS} H{c.num_heads} K{K} d{d} ps{PAGE_SIZE} "
                f"ctx{ctx}", arch=tag, dtype=str(q.dtype),
                max_abs_err=err, tolerance=TOL[q.dtype], **extra,
                ms=cuda_ms(lambda: fn(*args)),
                device_ms=graph_ms(lambda: fn(*args)),
                plain_ms=cuda_ms(lambda: ref(*args), reps=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def int8_mm_row(gen, M, K, N) -> dict:
    """The int8 matmul at one FFN shape, on operands quantized as the int8
    SwiGLU quantizes them: the int32 accumulators equal the plain version's
    exactly, the scaled output within float32's TOL and bit for bit. The
    library yardstick is `torch._int_mm` plus the same epilogue, timed as
    the kernel is: CUDA events around one call and a CUDA graph."""
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_acc,
                                                 int8_matmul_acc_ref,
                                                 int8_matmul_ref,
                                                 quantize_cols,
                                                 quantize_rows, split_k)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    (xq, sx), (wq, sw) = quantize_rows(x), quantize_cols(w)
    acc, acc_ref = int8_matmul_acc(xq, wq), int8_matmul_acc_ref(xq, wq)
    out, want = int8_matmul(xq, wq, sx, sw), int8_matmul_ref(xq, wq, sx, sw)
    torch.cuda.synchronize()
    check(bool(torch.equal(acc, acc_ref)), f"int8 matmul {M}x{K}x{N}: int32 "
          "accumulators differ from the plain version")
    err = max_err(out, want)
    check(err <= TOL[torch.float32], f"int8 matmul {M}x{K}x{N}: {err}")
    check(bool(torch.equal(out, want)), f"int8 matmul {M}x{K}x{N}: output "
          "not bit-equal to the plain version's")
    nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
    b_ms, b_by = bound(nbytes, 2.0 * M * K * N, torch.int8)
    splits = split_k(M, N, K, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return dict(shape=f"M{M} K{K} N{N}", dtype="int8", max_abs_err=err,
                bit_equal=True,
                tolerance="int32 accumulators exact, output bit for bit",
                variant=f"mma.sync m16n8k32 s8, 128 x 128 tiles, split_k "
                f"{splits}",
                # the yardstick only: the port never calls torch._int_mm
                **timed(lambda: int8_matmul(xq, wq, sx, sw),
                        lambda: torch._int_mm(xq, wq).float() * sx * sw),
                plain_ms=cuda_ms(lambda: int8_matmul_ref(xq, wq, sx, sw),
                                 reps=5),
                bound_ms=b_ms, bound_by=b_by)


# -------------------------------------------------------------- bank kernels
def bank_case(durations, occupancy, usable, nbanks, threshold,
              at_scale: bool = False) -> dict:
    """Both bank kernels against their plain versions on one trace and
    candidate grid; counts must match exactly, seconds to rel 1e-12, and a
    second call must give the same bits. `at_scale` adds the variant, the
    device time from the profiler, and for the exact kernel the scan and
    the walk timed apart (CUDA events around each launch) beside the
    serial floor, after checking the card's running time against np.cumsum
    bit for bit."""
    from repro_torch.kernels.bank_energy import (bank_activity_stats,
                                                 bank_energy_ref,
                                                 exact_bank_stats,
                                                 exact_bank_stats_ref,
                                                 running_time)
    t = [torch.as_tensor(np.asarray(x, np.float64), device="cuda")
         for x in (durations, occupancy, usable, nbanks, threshold)]
    d, o, u, nb, th = t
    S, C = len(d), len(u)
    out, profs = {}, {}
    for name, fn, ref, args, cnt, sec, kern in (
            ("exact_bank_stats", exact_bank_stats, exact_bank_stats_ref,
             (d, o, u, nb, th), [1, 3], [0, 2, 4],
             ("running_time_kernel", "exact_walk_kernel",
              "exact_resolve_kernel")),
            ("bank_energy", bank_activity_stats, bank_energy_ref,
             (d, o, u, nb), [1], [0],
             ("bank_energy_kernel", "energy_reduce_kernel"))):
        got = fn(*args)
        again = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        check(bool(torch.equal(got[:, cnt], want[:, cnt])),
              f"{name}: counts differ from the plain version")
        rel = float(((got[:, sec] - want[:, sec]).abs()
                     / want[:, sec].abs().clamp_min(1e-300)).max())
        check(rel <= 1e-12, f"{name}: seconds rel err {rel}")
        repeat = float((got - again).abs().max())
        check(bool(torch.equal(got, again)),
              f"{name}: two calls differ by {repeat}")
        ncols = got.shape[1]
        nbytes = 16 * S + 8 * C * (len(args) - 2) + 8 * C * ncols
        flops = 4.0 * S * C
        b_ms, b_by = bound(nbytes, flops, torch.float64)
        out[name] = dict(shape=f"S{S} C{C}", dtype="float64",
                         max_abs_err=max_err(got, want), max_rel_err=rel,
                         tolerance="counts exact, seconds rel 1e-12",
                         repeat_max_abs_diff=repeat,
                         ms=cuda_ms(lambda: fn(*args), reps=5),
                         plain_ms=cuda_ms(lambda: ref(*args), reps=2,
                                          warmup=1),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if at_scale:
            profs[name] = profiled_kernels(lambda: fn(*args))
            out[name].update(variant=BANK_VARIANT[name],
                             device_ms=kernel_ms(profs[name], kern))
    if at_scale:
        cum = running_time(d)
        want = np.r_[0.0, np.cumsum(np.asarray(durations, np.float64))]
        check(bool(np.array_equal(cum.cpu().numpy().view(np.int64),
                                  want.view(np.int64))),
              f"running time at S{S} equals np.cumsum bit for bit")
        prof = profs["exact_bank_stats"]
        out["exact_bank_stats"].update(
            scan_device_ms=kernel_ms(prof, ("running_time_kernel",)),
            walk_device_ms=kernel_ms(prof, ("exact_walk_kernel",
                                            "exact_resolve_kernel")),
            running_time_equals_np_cumsum=True,
            scan_ms=cuda_ms(lambda: running_time(d), reps=5),
            walk_ms=cuda_ms(lambda: exact_bank_stats(d, o, u, nb, th,
                                                     cum=cum), reps=5),
            serial_floor_ms=serial_floor_ms(S))
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


# ------------------------------------------------ speculative and dense paths
def reference_spec_dense() -> dict:
    """The reduced dsr1d model with 4 layers, float32, on the card and on the
    CPU plain path: speculative serving (k = 2, skip-2 draft) gives equal
    greedy tokens, `PagedStats` spec counters and sweep rows; dense
    `ContinuousBatcher` and `BatchedServer` give equal greedy tokens."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.explorer import sweep
    from repro_torch.examples.quant_serving import serve_stream
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    from repro_torch.serve import (BatchedServer, ContinuousBatcher, Request,
                                   ServeConfig)
    small = reduced(get_arch(ARCH), layers=4)
    cpu_params = init_params(small, torch.Generator().manual_seed(SEED + 4),
                             device="cpu")
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, small.vocab_size, int(n))
               for n in rng.integers(5, 40, 5)]
    got = {}
    for dev, p in (("cuda", _to(cpu_params, "cuda")), ("cpu", cpu_params)):
        m = DecoderLM(small, torch.float32, dev)
        cb, done = serve_stream(m, p, prompts, "native", 14, num_slots=3,
                                page_size=8, num_pages=64,
                                max_pages_per_slot=8, chunk_steps=6,
                                speculate_k=2)
        st = cb.stats
        tab = sweep(cb.occupancy_bundle(), mem_name="kv",
                    capacities_mib=[1, 2], banks=[1, 2, 4], device=dev,
                    prune=True)
        dense = ContinuousBatcher(m, p, num_slots=2, max_len=48)
        for i, pr in enumerate(prompts):
            dense.submit(Request(rid=i, tokens=pr, max_new_tokens=10))
        batch = np.stack([pr[:5] for pr in prompts])
        srv = BatchedServer(m, p, ServeConfig(max_len=24, max_new_tokens=8))
        got[dev] = dict(
            spec_tokens=[r.output for r in done],
            spec_counters=(st.spec_rounds, st.drafted_tokens,
                           st.accepted_tokens, st.rolled_back_pages),
            spec_sweep=[(r.capacity_mib, r.banks) for r in tab.rows],
            dense_tokens=[r.output for r in sorted(dense.run(),
                                                   key=lambda r: r.rid)],
            server_tokens=srv.generate({"tokens": batch})["tokens"].tolist())
    for key in got["cpu"]:
        check(got["cuda"][key] == got["cpu"][key],
              f"reduced-model {key} on the card == CPU plain path")
    spec = got["cuda"]["spec_counters"]
    check(spec[3] > 0, "the reduced spec run rolled pages back")
    return dict(spec_k=2, spec_layers=small.num_layers,
                spec_counters_equal=True, spec_rounds=spec[0],
                spec_accepted=spec[2], spec_rolled_back_pages=spec[3],
                spec_sweep_rows=len(got["cuda"]["spec_sweep"]),
                dense_tokens_equal=True, server_tokens_equal=True)


def serve_dense(model, params, prompts) -> dict:
    """Full-width dense serving: `BatchedServer` over a batch of seeded
    prompts, then `ContinuousBatcher` over the serve's first prompts, each
    with launch counts set to 0 just before and read just after; every
    decode step of every layer must launch the dense decode kernel once."""
    from repro_torch.kernels import build
    from repro_torch.serve import (BatchedServer, ContinuousBatcher, Request,
                                   ServeConfig)
    cfg = model.cfg
    L = cfg.num_layers
    batch = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT))
    srv = BatchedServer(model, params, ServeConfig(
        max_len=DENSE_PROMPT + DENSE_NEW, max_new_tokens=DENSE_NEW))
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.generate({"tokens": batch})
    torch.cuda.synchronize()
    server_s = time.perf_counter() - t0
    server_launches = build.launch_counts()["gqa_decode"]
    toks = res["tokens"]
    check(toks.shape == (DENSE_BATCH, DENSE_NEW)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "BatchedServer: in-vocab tokens of the expected shape")
    check(server_launches == L * (DENSE_NEW - 1),
          f"BatchedServer: gqa_decode launches {server_launches} == layers x "
          f"steps {L * (DENSE_NEW - 1)}")

    cb = ContinuousBatcher(model, params, num_slots=DENSE_REQUESTS,
                           max_len=DENSE_MAX_LEN)
    for i, p in enumerate(prompts[:DENSE_REQUESTS]):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=DENSE_NEW))
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = cb.run()
    torch.cuda.synchronize()
    batcher_s = time.perf_counter() - t0
    batcher_launches = build.launch_counts()["gqa_decode"]
    st = cb.stats
    check(st.finished == DENSE_REQUESTS
          and all(len(r.output) == DENSE_NEW for r in done),
          "ContinuousBatcher: every request finished with its tokens")
    check(batcher_launches == L * st.decode_steps,
          f"ContinuousBatcher: gqa_decode launches {batcher_launches} == "
          f"layers x decode steps {L * st.decode_steps}")
    check(int(cb.trace.as_arrays()[1][-1]) == 0,
          "ContinuousBatcher: the trace drains to 0")
    return dict(
        server=dict(batch=DENSE_BATCH, prompt=DENSE_PROMPT, new=DENSE_NEW,
                    prefill_s=res["stats"].prefill_s,
                    decode_s=res["stats"].decode_s,
                    decode_tokens_per_s=res["stats"].decode_tokens_per_s,
                    wall_s=server_s, gqa_decode_launches=server_launches),
        batcher=dict(requests=DENSE_REQUESTS, max_len=DENSE_MAX_LEN,
                     new=DENSE_NEW, decode_steps=st.decode_steps,
                     wall_s=batcher_s,
                     # wall time of the whole run, admission prefills included
                     decode_tokens_per_s=st.decode_steps / batcher_s,
                     peak_kv_bytes=cb.trace.peak_needed(),
                     gqa_decode_launches=batcher_launches),
        launches=server_launches + batcher_launches)


# -------------------------------------------------------------- stage one
def stage1_sweep(sim, capacities, prune: bool) -> dict:
    """One Stage-II sweep of a Stage-I result's SRAM trace on the card,
    launch counts set to 0 just before and read just after, held to the
    same sweep's plain float64 version on the CPU: the same (C, B) rows,
    transition counts equal, e_total within rel 1e-12. Every sweep runs the
    exact kernel after one scan of the trace; a pruned one also the lower
    bound (kernel 4), an exact one never."""
    from repro_torch.core.explorer import sweep
    from repro_torch.kernels import build
    kw = dict(capacities_mib=capacities, prune=prune)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = sweep(sim, device="cuda", **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = build.launch_counts()
    t0 = time.perf_counter()
    plain = sweep(sim, device="cpu", **kw)
    plain_s = time.perf_counter() - t0
    tag = f"stage1 {sim.graph_name} prune={prune}"
    check(len(table.rows) > 0, f"{tag}: sweep table is non-empty")
    check([(r.capacity_mib, r.banks) for r in table.rows]
          == [(r.capacity_mib, r.banks) for r in plain.rows],
          f"{tag}: rows equal the plain-version sweep")
    check(all(a.result.n_transitions == b.result.n_transitions
              for a, b in zip(table.rows, plain.rows)),
          f"{tag}: transition counts equal")
    rel = max(abs(a.result.e_total / b.result.e_total - 1.0)
              for a, b in zip(table.rows, plain.rows))
    check(rel <= 1e-12, f"{tag}: e_total rel err {rel}")
    launched = {k: counts[k] for k in ("running_time", "exact_bank_stats",
                                       "bank_energy")}
    check(launched["running_time"] == 1,
          f"{tag}: the sweep ran the scan once ({launched['running_time']})")
    check(launched["exact_bank_stats"] >= 1, f"{tag}: launched kernel 3")
    check((launched["bank_energy"] >= 1) == prune,
          f"{tag}: kernel 4 launched {launched['bank_energy']} times")
    best = table.best()
    return dict(prune=prune, rows=len(table.rows), e_total_rel_err=rel,
                sweep_s=card_s, plain_cpu_s=plain_s, launches=launched,
                best={"capacity_mib": best.capacity_mib, "banks": best.banks,
                      "e_total_j": best.result.e_total})


def stage1_phase():
    """The paper's two-stage flow at full width: for each paper model,
    Stage I on the host (prefill at M 2048 by `simulate`, the decode
    horizon by `simulate_decode`), each SRAM trace swept on the card with
    pruning off and on (`stage1_sweep`), the bank kernels timed at the
    decode horizon's shape against their plain versions (`bank_case`),
    then `python -m repro_torch.launch.trapti` once on the card. Returns
    (the phase's fields, kernel 3's and 4's launches per sweep, their rows
    at each decode horizon's shape)."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.core.cacti import characterize
    from repro_torch.core.candidates import Candidate
    from repro_torch.core.explorer import DEFAULT_BANKS, MIB, min_capacity_mib
    from repro_torch.core.workload import build_graph
    from repro_torch.sim.accelerator import baseline_accelerator
    from repro_torch.sim.engine import simulate
    from repro_torch.sim.pss import simulate_decode
    accel = baseline_accelerator(STAGE1_SRAM_MIB)
    out, launches, horizon = {}, {}, {}
    for name in STAGE1_ARCHS:
        cfg = get_arch(name)
        t0 = time.perf_counter()
        prefill = simulate(build_graph(cfg, M=STAGE1_M, subops=4), accel)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decode = simulate_decode(cfg, accel, **STAGE1_HORIZON)
        decode_s = time.perf_counter() - t0
        check(decode.fidelity == "pss", f"{name}: the horizon ran PSS")
        out[name], launches[name] = {}, {}
        for phase, sim, host_s in (("prefill", prefill, prefill_s),
                                   ("decode", decode, decode_s)):
            trace = sim.traces["sram"]
            dur, occ = trace.occupancy_series(sim.total_time, use="needed")
            check(len(dur) > 0 and bool(np.isfinite(dur).all())
                  and bool((dur > 0).all()) and bool((occ >= 0).all()),
                  f"{name} {phase}: finite positive segments")
            peak = trace.peak_needed()
            m = min_capacity_mib(peak)
            caps = [m, m + 16, m + 32]
            sweeps = {key: stage1_sweep(sim, caps, prune)
                      for key, prune in (("prune_off", False),
                                         ("prune_on", True))}
            launches[name][phase] = {key: s["launches"]
                                     for key, s in sweeps.items()}
            out[name][phase] = dict(
                graph=sim.graph_name, segments=len(dur),
                peak_needed_bytes=peak,
                zero_occupancy_share=float((occ == 0).mean()),
                stage1_host_s=host_s, total_time_s=sim.total_time,
                writebacks=sim.writebacks, capacities_mib=caps, **sweeps)
        # the bank kernels at the decode horizon's shape: the sweep's 18
        # (C, B) candidates, gated (alpha 0.9, 5x break-even)
        dur, occ = decode.traces["sram"].occupancy_series(decode.total_time,
                                                          use="needed")
        caps = out[name]["decode"]["capacities_mib"]
        cands = [Candidate(c * MIB, b, 0.9, "gate", 5.0)
                 for c in caps for b in DEFAULT_BANKS]
        th = [c.min_gate_multiple * characterize(c.capacity,
                                                 c.banks).break_even_s
              for c in cands]
        rows = bank_case(dur, occ, [c.usable_bytes for c in cands],
                         [float(c.banks) for c in cands], th, at_scale=True)
        for kernel, row in rows.items():
            horizon.setdefault(kernel, {})[name] = row
    peak = {ph: {n: out[n][ph]["peak_needed_bytes"] for n in STAGE1_ARCHS}
            for ph in ("prefill", "decode")}
    # the trapti CLI on the card (dsr1d prefill: find_min_sram, one sweep)
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "trapti.json"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.trapti", "--arch",
             "dsr1d-qwen-1.5b", "--json", str(report)],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600,
            env={**os.environ,
                 "PYTHONPATH": str(Path(__file__).resolve().parent / "src")})
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0,
              f"trapti CLI exit {cli.returncode}: {cli.stderr[-2000:]}")
        payload = json.loads(report.read_text())
    check(payload["memories"].get("sram", {}).get("best_banks", 0) >= 1,
          "trapti CLI reported a best (C, B) for the SRAM")
    fields = dict(
        accelerator=accel.name, sram_mib=STAGE1_SRAM_MIB, prefill_M=STAGE1_M,
        horizon=STAGE1_HORIZON, banks=list(DEFAULT_BANKS),
        policy="conservative", models=out,
        # printed, not gated: MHA's peak over GQA's
        mha_over_gqa_peak_needed={
            ph: v["gpt2-xl"] / v["dsr1d-qwen-1.5b"] for ph, v in peak.items()},
        decode_horizon_kernels=horizon,
        trapti_cli=dict(argv="--arch dsr1d-qwen-1.5b --json", exit=0,
                        wall_s=cli_s, report=payload))
    per_kernel = {k: {n: {ph: {key: v[k] for key, v in s.items()}
                          for ph, s in launches[n].items()}
                      for n in STAGE1_ARCHS}
                  for k in ("exact_bank_stats", "bank_energy")}
    return fields, per_kernel, horizon


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
    from repro_torch.examples.int8_serving import quantized_ffn
    from repro_torch.examples.quant_serving import (agreement,
                                                    gate_at_capacity,
                                                    serve_stream)
    from repro_torch.models import DecoderLM
    from repro_torch.models.ffn import apply_ffn
    from repro_torch.models.transformer import layer
    from repro_torch.params import init_params

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
    sweep_rows = {}
    for kv in KV_DTYPES:
        served = {}
        for dev, (m, p) in outs.items():
            cb, done = serve_stream(m, p, prompts, kv, 12, num_slots=3,
                                    page_size=8, num_pages=40,
                                    max_pages_per_slot=12, chunk_steps=4)
            tab = sweep(cb.occupancy_bundle(), mem_name="kv",
                        capacities_mib=[1, 2], banks=[1, 2, 4], device=dev,
                        prune=True)
            served[dev] = ([r.output for r in done],
                           [(r.capacity_mib, r.banks, r.result.e_total)
                            for r in tab.rows])
        check(served["cuda"][0] == served["cpu"][0],
              f"reduced-model greedy tokens with {kv} pages on the card == "
              "CPU plain path")
        check([r[:2] for r in served["cuda"][1]] == [r[:2] for r in
                                                     served["cpu"][1]],
              f"reduced-model sweep rows with {kv} pages on the card == CPU "
              "plain path")
        sweep_rows[kv] = len(served["cuda"][1])
    spec_dense = reference_spec_dense()
    emit("reference", arch=small.name, requests=len(prompts),
         kv_dtypes=list(KV_DTYPES), tokens_equal=True, sweep_rows=sweep_rows,
         **spec_dense)

    # ---- serve: the main path at full width, launch counts from 0 ----
    cfg = get_arch(ARCH)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, compute_dtype=torch.bfloat16, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prng = np.random.default_rng(SEED + 1)
    prompts = [prng.integers(0, cfg.vocab_size, int(n))
               for n in prompt_lengths()]
    cb, done, serve_s, serve_counts = serve_full(model, params, prompts,
                                                 "native")
    st = cb.stats
    steps = st.chunks * CHUNK_STEPS
    check(serve_counts["paged_gqa_decode"] == cfg.num_layers * steps,
          f"decode launches {serve_counts['paged_gqa_decode']} == layers x "
          f"steps {cfg.num_layers * steps}")
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
    for name in MAIN_PATH_KERNELS:
        check(launches[name] > 0, f"main path launched {name}")
    check(launches["running_time"] == 1,
          f"the pruned sweep ran the scan once ({launches['running_time']})")
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
    big = synthetic_trace(1 << 20, 360)
    bank_big = bank_case(*big, at_scale=True)
    # the pruned sweep's incumbent call: the same trace, one candidate
    bank_one = bank_case(*big[:2], *(x[:1] for x in big[2:]), at_scale=True)
    emit("bank_kernels", main_path=bank_main, synthetic_1m_x_360=bank_big,
         synthetic_1m_x_1=bank_one, wall_s=time.perf_counter() - t0)

    # ---- serve_quant: the same stream with int8 and with fp8 pages ----
    quant = {}
    for kv, kernel in (("int8", "paged_gqa_decode_quant"),
                       ("fp8", "paged_gqa_decode")):
        qcb, qdone, q_s, counts = serve_full(model, params, prompts, kv)
        qst = qcb.stats
        q_steps = qst.chunks * CHUNK_STEPS
        check(counts[kernel] == cfg.num_layers * q_steps,
              f"{kv}: {kernel} launches {counts[kernel]} == layers x steps "
              f"{cfg.num_layers * q_steps}")
        other = ({"paged_gqa_decode", "paged_gqa_decode_quant"} - {kernel})
        check(all(counts[k] == 0 for k in other),
              f"{kv}: no launches of {other}")
        quant[kv] = qcb
        emit("serve_quant", kv_dtype=kv, requests_finished=qst.finished,
             decode_tokens=qst.decode_steps, decode_steps=q_steps,
             peak_pages=qst.peak_pages, page_bytes=qcb.page_bytes,
             row_bytes=qcb.row_bytes,
             peak_kv_bytes=qcb.ledger.trace.peak_needed(), wall_s=q_s,
             decode_tokens_per_s=qst.decode_steps / q_s,
             # reported only: random bf16 weights at full width may diverge
             requests_agreeing_with_bf16=agreement(qdone, done),
             first_divergence_from_bf16=[first_divergence(a.output, b.output)
                                         for a, b in zip(qdone, done)],
             launches=counts)
        if kv == "int8":
            launches["paged_gqa_decode_quant"] = counts[kernel]

    # ---- stage2_quant: each dtype's trace gated at the bf16 peak ----
    bundles = {"native": bundle, **{kv: c.occupancy_bundle()
                                    for kv, c in quant.items()}}
    cap = trace.peak_needed()
    t0 = time.perf_counter()
    on_card = gate_at_capacity(bundles, cap, device="cuda")
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    on_cpu = gate_at_capacity(bundles, cap, device="cpu")
    energy = {}
    for kv in bundles:
        a, b = on_card[kv], on_cpu[kv]
        check(bool(np.array_equal(a.n_off, b.n_off)
                   and np.array_equal(a.evaluated, b.evaluated)),
              f"stage2_quant {kv}: rows equal the plain version's")
        rel_q = float(np.max(np.abs(a.e_total / b.e_total - 1.0)))
        check(rel_q <= 1e-12, f"stage2_quant {kv}: e_total rel err {rel_q}")
        energy[kv] = dict(e_total_j=float(a.e_total[0]), e_total_rel_err=rel_q,
                          n_off=int(a.n_off[0]),
                          peak_needed_bytes=bundles[kv].traces[
                              "kv"].peak_needed())
    emit("stage2_quant", capacity_bytes=cap, banks=8, alpha=1.0,
         energy=energy, wall_s_card=gate_s,
         saving_vs_bf16={kv: 1.0 - energy[kv]["e_total_j"]
                         / energy["native"]["e_total_j"] for kv in quant})

    # ---- int8_ffn: layer 0's SwiGLU through the int8 matmul ----
    ffn0 = layer(params["blocks"][0], 0)["ffn"]
    M = int(prompt_lengths().max())
    x = torch.randn((1, M, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8 = quantized_ffn(ffn0, x)
    torch.cuda.synchronize()
    ffn_s = time.perf_counter() - t0
    launches["int8_matmul"] = build.launch_counts()["int8_matmul"]
    check(launches["int8_matmul"] == 3, "int8 FFN launched the int8 matmul "
          "once per projection")
    check(q8.shape == x.shape and bool(torch.isfinite(q8).all()),
          "int8 FFN output finite, of the input's shape")
    fp = apply_ffn(cfg, ffn0, x).float()
    rel_fp = float(torch.linalg.norm(q8 - fp) / torch.linalg.norm(fp))
    plain = quantized_ffn(_to(ffn0, "cpu"), x.cpu())
    rel_plain = float(torch.linalg.norm(q8.cpu() - plain)
                      / torch.linalg.norm(plain))
    check(rel_plain <= 1e-3, f"int8 FFN on the card vs its CPU plain path: "
          f"rel L2 {rel_plain}")
    emit("int8_ffn", arch=cfg.name, layer=0, M=M, d_model=cfg.d_model,
         d_ff=cfg.d_ff, rel_l2_vs_bf16_ffn=rel_fp,
         rel_l2_vs_cpu_plain=rel_plain, wall_s=ffn_s,
         launches=launches["int8_matmul"])

    # ---- serve_spec: the same stream, speculative (k = 3, skip-2 draft) ----
    scb, sdone, spec_s, spec_counts = serve_full(model, params, prompts,
                                                 "native", speculate_k=SPEC_K)
    sst = scb.stats
    rounds = sst.chunks * scb.spec_rounds_per_chunk   # every round runs
    draft_layers = scb.draft_model.cfg.num_layers
    check(sst.accepted_tokens == sst.decode_steps,
          f"spec: accepted tokens {sst.accepted_tokens} == decode tokens "
          f"{sst.decode_steps}")
    check(sst.drafted_tokens == sst.spec_rounds * SPEC_K,
          "spec: drafted tokens == spec rounds x k")
    check(scb.ledger.allocator.n_allocated == 0
          and int(scb.ledger.trace.as_arrays()[1][-1]) == 0,
          "spec: the allocator drains to 0 and the trace integrates to 0")
    check(spec_counts["paged_gqa_verify"] == cfg.num_layers * rounds,
          f"spec: paged_gqa_verify launches {spec_counts['paged_gqa_verify']}"
          f" == layers x rounds {cfg.num_layers * rounds}")
    check(spec_counts["paged_gqa_decode"]
          == draft_layers * (SPEC_K + 1) * rounds,
          f"spec: draft paged_gqa_decode launches "
          f"{spec_counts['paged_gqa_decode']} == draft layers x (k + 1) x "
          f"rounds {draft_layers * (SPEC_K + 1) * rounds}")
    launches["paged_gqa_verify"] = spec_counts["paged_gqa_verify"]
    spec_bundle = scb.occupancy_bundle()
    spec_trace = spec_bundle.traces["kv"]
    ev = np.asarray(spec_trace.ev_dneeded)
    spec_energy = gate_at_capacity({"native": bundle, "spec": spec_bundle},
                                   cap, device="cuda")
    sm = min_capacity_mib(spec_trace.peak_needed())
    spec_sweep_kw = dict(sweep_kw, capacities_mib=[sm, sm + 32, sm + 64])
    spec_table = sweep(spec_bundle, device="cuda", **spec_sweep_kw)
    spec_plain = sweep(spec_bundle, device="cpu", **spec_sweep_kw)
    check([(r.capacity_mib, r.banks) for r in spec_table.rows]
          == [(r.capacity_mib, r.banks) for r in spec_plain.rows],
          "spec sweep rows equal the plain-version sweep")
    emit("serve_spec", speculate_k=SPEC_K, draft=scb.draft_model.cfg.name,
         draft_layers=draft_layers, dtype="bfloat16",
         requests_finished=sst.finished, decode_tokens=sst.decode_steps,
         chunks=sst.chunks, rounds_run=rounds, spec_rounds=sst.spec_rounds,
         drafted_tokens=sst.drafted_tokens,
         accepted_tokens=sst.accepted_tokens,
         # tokens per slot-round (1 .. k + 1) and accepted drafts / drafted
         tokens_per_round=sst.accepted_tokens / max(sst.spec_rounds, 1),
         draft_acceptance=(sst.accepted_tokens - sst.spec_rounds)
         / max(sst.drafted_tokens, 1),
         rolled_back_pages=sst.rolled_back_pages,
         # negative deltas besides each retire's two (target and draft lane)
         negative_midstream_deltas=int((ev < 0).sum()) - 2 * sst.finished,
         peak_pages=sst.peak_pages, peak_kv_bytes=spec_trace.peak_needed(),
         wall_s=spec_s, decode_tokens_per_s=sst.decode_steps / spec_s,
         first_divergence_from_bf16=[first_divergence(a.output, b.output)
                                     for a, b in zip(sdone, done)],
         stage2_at_bf16_peak=dict(
             capacity_bytes=cap, banks=8,
             e_total_j={k: float(v.e_total[0])
                        for k, v in spec_energy.items()}),
         sweep_rows=len(spec_table.rows), launches=spec_counts)

    # ---- serve_dense: BatchedServer and ContinuousBatcher ----
    dense = serve_dense(model, params, prompts)
    launches["gqa_decode"] = dense.pop("launches")
    emit("serve_dense", arch=cfg.name, dtype="bfloat16", **dense)

    # ---- stage1: the paper's flow, Stage I on the host, Stage II here ----
    stage1, stage1_launches, horizon_rows = stage1_phase()
    emit("stage1", **stage1)

    kernels = []
    for name, row in (("paged_gqa_decode", rows["paged_gqa_decode"][0]),
                      ("flash_attention", rows["flash_attention"][0]),
                      ("paged_gqa_decode_quant",
                       rows["paged_gqa_decode_quant"][0]),
                      ("int8_matmul", rows["int8_matmul"][0]),
                      ("exact_bank_stats",
                       dict(bank_main["exact_bank_stats"], dtype="float64",
                            scan_launches=launches["running_time"],
                            stage1_launches=stage1_launches[
                                "exact_bank_stats"],
                            stage1_decode_horizon=horizon_rows[
                                "exact_bank_stats"])),
                      ("bank_energy",
                       dict(bank_main["bank_energy"], dtype="float64",
                            stage1_launches=stage1_launches["bank_energy"],
                            stage1_decode_horizon=horizon_rows[
                                "bank_energy"])),
                      ("paged_gqa_verify", rows["paged_gqa_verify"][0]),
                      ("gqa_decode", rows["gqa_decode"][0])):
        # rows[...][0] is the main path's dtype (bfloat16)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], dtype=row["dtype"],
            **{key: row[key] for key in ("variant", "device_ms",
                                         "library_device_ms",
                                         "scan_launches", "stage1_launches",
                                         "stage1_decode_horizon")
               if key in row}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def first_divergence(a, b) -> int:
    """Index of the first token where two greedy outputs differ (their
    length if they never do)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def serve_full(model, params, prompts, kv_dtype: str,
               speculate_k=None):
    """The full-width stream through one batcher with `kv_dtype` pages (and
    speculation when `speculate_k` is set: the pool then holds both lanes),
    launch counts set to 0 just before and read just after. Checks that
    every request finished with NEW_TOKENS in-vocab tokens and that each
    admission ran the prefill kernel once per layer (of the draft too).
    Returns (batcher, finished requests by rid, wall seconds, launch
    counts)."""
    from repro_torch.kernels import build
    from repro_torch.serve import PagedContinuousBatcher, Request
    cfg = model.cfg
    per_slot = -(-(PROMPT_MAX + NEW_TOKENS - 1 + (speculate_k or 0))
                 // PAGE_SIZE)
    lanes = 1 if speculate_k is None else 2
    cb = PagedContinuousBatcher(
        model, params, num_slots=SLOTS, page_size=PAGE_SIZE,
        num_pages=lanes * SLOTS * per_slot + 1, max_pages_per_slot=per_slot,
        chunk_steps=CHUNK_STEPS, kv_dtype=kv_dtype, speculate_k=speculate_k)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=NEW_TOKENS))
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = sorted(cb.run(), key=lambda r: r.rid)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = build.launch_counts()
    st = cb.stats
    tag = kv_dtype if speculate_k is None else f"{kv_dtype} spec"
    check(len(done) == len(prompts) and st.finished == len(prompts),
          f"{tag}: all requests finished")
    check(all(len(r.output) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.output)
              for r in done),
          f"{tag}: every request has NEW_TOKENS in-vocab tokens")
    layers = cfg.num_layers
    if speculate_k is not None:
        layers += cb.draft_model.cfg.num_layers
    check(counts["flash_attention"] == layers * st.prefills,
          f"{tag}: prefill launches == layers x prefills")
    return cb, done, wall_s, counts


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
