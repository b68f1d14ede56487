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
then the `trapti` CLI once on the card; and prefix-cached serving of
shared-prefix traffic (`chat_sysprompt`) with chunked suffix prefills and
priority-1 arrivals that preempt, in a pool small enough to evict cached
prefixes, whose physical ("kv") and logical ("kv_logical") traces are
both swept (`serve_prefix`), after the same mechanisms on a 2-layer model
held to the CPU plain path on native, int8 and fp8 pages and with
speculation (`reference_prefix`); the traffic campaigns of
`launch/traffic.py` (plain traffic with a streamed bank-energy meter,
shared-prefix traffic, speculative decoding; gpt2-xl beside dsr1d), their
Stage-II legs on the card held to the same campaigns on the CPU, then the
CLI once (`traffic`); and the prefix-cached serve again with a telemetry
registry and a streamed meter, held to the same serve without them, to a
CPU dry run of its counters, spans and SLO percentiles, and to Stage II
on its trace (`serve_obs`); and the other decoder families (`families`,
`repro_torch.examples.families_serving`): reduced configs of olmoe (MoE),
recurrentgemma (RG-LRU + sliding-window rings), mamba2 (SSD), internvl2
(prefix embeddings) and llama4-scout (chunked rings + MoE with a shared
expert) on the card held to the CPU, then each at full width with random
bf16 weights through its batchers (llama4-scout cut to 4 of its 48
layers), launches counted per path against layers x calls, every trace
swept on the card and held to the CPU sweep, with kernels 7, 1 and 2 held
to their plain versions at the families' shapes; and the
encoder-decoder (`encdec`, `repro_torch.examples.encdec_serving`): kernel
2 without its causal mask at seamless-m4t's encoder (B4 x 1024 over 1024
rows) and cross (32 over 1024 rows) shapes in both variants and at ragged
lengths, held to its plain version and bf16 mirror, kernel 7 at the cross
and self decode shapes held to its split mirror, the reduced model on the
card against the CPU (encoder output, tokens, logits, KV events), then
full-width seamless-m4t-large-v2 with random bf16 weights served by
`BatchedServer` (frames B4 x 1024, prompts 32, 32 new tokens), launches
counted against layers x calls, its KV trace swept through kernels 3 and
4 on the card against the CPU; and training (`train`, no kernel of the
port on this path: the loss runs plain PyTorch as the reference's runs
jnp): three steps of reduced dsr1d-qwen-1.5b and reduced olmoe (MoE aux
loss) on the card against the CPU, a preempted `TrainLoop` resumed from
its checkpoint against the uninterrupted run (bit for bit), then
full-width tinyllama-1.1b through `launch/train.py`'s entry point (B8 x
S64, float32, four steps writing one checkpoint, then one more step
restored from it; checkpoints in temporary directories the phase
deletes), with the step time and peak memory; and the four dense
assigned configs (`dense_archs`, run right after the kernels phase while
nothing else holds device memory): kernels 1 (bf16 and fp8 pools), 5, 6
(V 4, 192 query rows a KV head) and 7 at granite-34b's MQA group of 48
(H48 K1 d128, run in row chunks), kernel 1 at qwen2-7b's,
deepseek-coder-33b's and tinyllama-1.1b's groups and kernel 2 at granite's
and tinyllama's prefill, each held to its plain version, split mirror,
batch-1 rows and a second call; each config reduced to 2 layers (granite
also at H48 K1 d128) on the card against the CPU through the paged,
speculative, batched and dense batchers; then each at full width with
random bf16 weights (tinyllama-1.1b, qwen2-7b, deepseek-coder-33b,
granite-34b, freed one by one) serving the serve phase's first 8 requests
x 32 new tokens on bf16 pages, granite also on fp8 and int8 pages,
speculatively and densely, launches counted against layers x calls and
every trace swept on the card against the CPU. It builds the
CUDA kernels from `src/repro_torch/csrc/` first, holds every kernel against
its plain PyTorch version at its path's shapes, and checks that each path
launched its kernels (launch counts are set to 0 just before a path and
read just after it). The bf16 tensor-core prefill kernel is also held to
its mirror and to equal rows for a shorter prompt, and the split-context
decode kernels (dense, paged on float, fp8 and int8 pools, and verify) to
their split mirrors and to equal rows at batch 1 and 8, each verify row to
the paged decode kernel at its length bit for bit, and the fp8 decode to
the 256-entry table; the int8 matmul's int32 accumulators are held
exactly and its output bit for bit. The prefill kernel also runs with a
query offset (the suffix rows of a shared prefill, offsets 0, 16, 21 and
384 x 1, 37 and 256 rows, bf16 and float32), held to its plain version and
mirror with the offset and to the offset-0 call's rows bit for bit, and
timed beside SDPA with the offset-causal mask. Prefill, dense decode,
paged decode, verify and the int8 matmul also get device times from a CUDA
graph, beside one library call's where there is one (SDPA,
`torch._int_mm`).
The bank kernels are also run at a million segments (360 candidates, and
the pruned sweep's single incumbent), where the exact kernel's scan and
walk are timed apart beside the serial floor (a small kernel adding the
trace's length of f64 numbers in one thread) and its running time is held
to np.cumsum bit for bit; both bank kernels give the same bits twice.
The bank kernels are also timed at each decode horizon's own shape.
Last (`roofline`), full-width dsr1d-qwen-1.5b and gpt2-xl run one prefill
of B1 x S2048 (kernel 2) and one dense decode step of B8 over 2,048 rows
(kernel 7), each timed against the ideal time of `launch/roofline.py`'s
H100 roofline (a time below it less 5% fails the phase); the reduced model
is placed on the host mesh (`make_host_mesh()`) and served under it; and
the dry run (`launch/dryrun.py`, decode_32k on both production meshes)
and its report run in subprocesses.
Each phase prints one JSON line (device, kernels, dense_archs_init and
dense_archs_full for each dense config, dense_archs, reference,
reference_prefix, serve, stage2, bank_kernels, serve_quant, stage2_quant,
int8_ffn, serve_spec, serve_dense, serve_prefix, traffic, serve_obs,
stage1, families_full for each family, families, encdec, train,
roofline); the last three
lines are the kernel summary, the card's `nvidia-smi` name and power
limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Any failed phase raises: the script exits nonzero without that line, as it
does when no CUDA device is present.

Run from the root of the repository:  python3 chip_smoke.py
(`--only dense_archs`, `--only families`, `--only encdec`, `--only
train` or `--only roofline` builds the kernels and runs that phase
alone.)
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
# the prefill kernel with a query offset (the suffix rows of a shared or
# chunked prefill): cached rows m (page-aligned 16, mid-page 21) x suffix rows
FLASH_OFFSETS, FLASH_SUFFIXES = (0, 16, 21, 384), (1, 37, 256)
# shared-prefix serving: chat_sysprompt traffic (the reference example's
# family; prefix ~384 tokens, ~4 requests a tenant), suffix prefills in
# 256-token slices; after two chunks 4 priority-1 requests with 512-token
# prompts arrive. The pool holds 15 pages a slot (a quarter of the longest
# request's worst case), so cached prefixes are evicted and the priority
# requests preempt
PREFIX_REQUESTS, PREFIX_CHUNK = 16, 256
PREFIX_POOL_PAGES = SLOTS * 15 + 1
URGENT, URGENT_LEN = 4, 512
# traffic campaigns as `python -m repro_torch.launch.traffic --prune` runs
# them by default (the requested GQA model beside the gpt2-xl MHA
# reference, poisson at 4/s over 30 s, seed 0, 8 slots, max_len 1024, the
# default banks, alpha 0.9): plain traffic with the obs CLI's default meter,
# shared-prefix traffic and speculative decoding, one simulator each
TRAFFIC_ARCHS = ("gpt2-xl", "dsr1d-qwen-1.5b")
TRAFFIC = dict(arrivals=("poisson",), rates=(4.0,), seeds=(0,),
               horizon_s=30.0, num_slots=8, max_len=1024, prune=True)
CAMPAIGNS = {"plain": dict(meter_spec="32,8,0.9,conservative"),
             "chat_sysprompt": dict(workload="chat_sysprompt"),
             "spec_k4": dict(speculate_k=4)}
# the instrumented serve: the serve_prefix configuration, its first 8
# requests with 32 new tokens each, a registry and a streamed meter
OBS_REQUESTS, OBS_NEW_TOKENS = 8, 32
OBS_METER = "64,16,0.9,conservative"
# the decoder families (`repro_torch.examples.families_serving.FAMILIES`):
# each reduced to one or two pattern repetitions for the card-vs-CPU check
# (recurrentgemma's with its tail block), then at full width
FAMILY_REDUCED_LAYERS = {"olmoe-1b-7b": 2, "recurrentgemma-2b": 4,
                         "mamba2-130m": 2, "internvl2-2b": 2,
                         "llama4-scout-17b-a16e": 4}
FAMILY_BATCHERS = ("paged", "dense", "batched")
# training: reduced configs held to the CPU (dsr1d, and olmoe for the MoE
# aux loss), then full-width tinyllama-1.1b (the training CLI's default
# arch) through the CLI: batch x sequence, steps before the checkpoint
TRAIN_REDUCED = (ARCH, "olmoe-1b-7b")
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 4
# the four dense assigned configs (`dense_archs`), in order of size: each
# reduced to 2 layers for the card-vs-CPU check (granite also at its real
# attention shape, MQA with a group of 48), then at full width with random
# bf16 weights, serving the serve phase's first 8 requests x 32 new tokens.
# A config is cut in depth only if its weights and the reserve (pools,
# activations, the prefill's logits) exceed the free device memory
DENSE_ARCHS = ("tinyllama-1.1b", "qwen2-7b", "deepseek-coder-33b",
               "granite-34b")
GROUP48 = dict(num_heads=48, num_kv_heads=1, head_dim=128)
DENSE_ARCH_REQUESTS, DENSE_ARCH_NEW = 8, 32
DENSE_ARCH_RESERVE = 6 << 30
# the roofline phase: the two paper models at full width (random bf16
# weights), one prefill of B x S and one dense decode step of B rows over a
# cache of T rows, each timed (CUDA events, the median of ROOFLINE_REPS
# calls after ROOFLINE_WARMUP) against the roofline's ideal time on one card
# (`launch/roofline.py`); a time below the ideal less ROOFLINE_MARGIN would
# mean a wrong constant or count. Kernels 2 and 7 are first held against
# their plain versions at these shapes (flash_row with prefix rows cut to
# ROOFLINE_PREFIX, dense_row). Then the host mesh and the dry run CLI
ROOFLINE_ARCHS = ("dsr1d-qwen-1.5b", "gpt2-xl")
ROOFLINE_PREFILL, ROOFLINE_DECODE = (1, 2048), (8, 2048)
ROOFLINE_PREFIX = 1000
ROOFLINE_REPS, ROOFLINE_WARMUP, ROOFLINE_MARGIN = 7, 2, 0.05


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


def device_busy_ms(fn):
    """Milliseconds in which the card ran work during one call of `fn`:
    the union of torch.profiler's device events (kernels, copies), overlaps
    merged. User ranges (`record_function`, the program's host spans) are
    left out: their device-side copies span the range, not work. None
    where the profiler records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


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
    return float((a.detach().float() - b.detach().float()).abs().max())


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

    rows["flash_attention_offset"] = [
        flash_offset_row(gen, cfg, dtype, m, S)
        for dtype in (torch.bfloat16, torch.float32)
        for m in FLASH_OFFSETS for S in FLASH_SUFFIXES]

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


def flash_offset_row(gen, c, dtype, m, S) -> dict:
    """The prefill kernel with `q_offset = m` over m + S keys, the suffix
    rows of a shared prefill: against the float32 plain version with the
    offset (the row's tolerance), a bf16 query also against the tensor-core
    mirror with the offset (within one bf16 step at the output's largest
    magnitude, each element within one step plus MIRROR_ATOL), and every
    row against row m + s of the offset-0 call over the same keys (0.0).
    The library yardstick is one SDPA call with the boolean offset-causal
    mask and the KV heads shared by the group."""
    from repro_torch.kernels.flash_attention import (
        MIRROR_ATOL, bf16_excess, bf16_step, flash_attention,
        flash_attention_bf16_mirror_ref, flash_attention_ref, variant)
    H, K, d = c.num_heads, c.num_kv_heads, c.head_dim
    T = m + S
    q_all = torch.randn((1, T, H, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, T, K, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, T, K, d), generator=gen, device="cuda").to(dtype)
    q = q_all[:, m:]
    out = flash_attention(q, k, v, q_offset=m)
    whole = flash_attention(q_all, k, v)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), m)
    torch.cuda.synchronize()
    tag = f"flash offset m={m} S={S} {dtype}"
    err, diff0 = max_err(out, ref), max_err(out, whole[:, m:])
    check(bool(torch.isfinite(out.float()).all()), f"{tag}: finite")
    check(err <= TOL[dtype], f"{tag}: {err}")
    check(diff0 == 0.0, f"{tag}: rows differ from the offset-0 call's rows "
          f"{m}.. by {diff0}")
    extra = {}
    if dtype == torch.bfloat16:
        mirror = flash_attention_bf16_mirror_ref(q, k, v, m)
        extra = dict(max_abs_err_mirror=max_err(out, mirror),
                     mirror_step=float(bf16_step(mirror).max()),
                     mirror_excess=bf16_excess(out, mirror))
        check(extra["max_abs_err_mirror"] <= extra["mirror_step"],
              f"{tag} vs its bf16 mirror: {extra['max_abs_err_mirror']}")
        check(extra["mirror_excess"] <= MIRROR_ATOL,
              f"{tag} vs its bf16 mirror: an element strays "
              f"{extra['mirror_excess']} beyond one bf16 step")
    isz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
    flops = 4.0 * H * d * (S * m + S * (S + 1) / 2)
    b_ms, b_by = bound(nbytes, flops, dtype)
    mask = (torch.arange(S, device="cuda")[:, None] + m
            >= torch.arange(T, device="cuda")[None, :])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def fn():
        return flash_attention(q, k, v, q_offset=m)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    return dict(shape=f"B1 m{m} S{S} H{H} K{K} d{d}", q_offset=m,
                dtype=str(dtype), variant=variant(q), max_abs_err=err,
                tolerance=TOL[dtype], offset0_rows_max_abs_diff=diff0,
                **extra, offset_ms=cuda_ms(fn), offset_device_ms=graph_ms(fn),
                library_offset_ms=cuda_ms(lib),
                library_offset_device_ms=graph_ms(lib),
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


def dense_row(gen, tag, c, lengths, dtype, T: int = DENSE_MAX_LEN) -> dict:
    """The dense decode kernel against its plain version and its split
    mirror on a (B, T, K, d) cache seen as (B, K, T, d); at B > 1 each
    sequence's batch-1 call must give its batch row bit for bit (0.0). The
    library yardstick is one SDPA call with the lengths mask and the KV
    heads shared by the group."""
    from repro_torch.kernels.gqa_decode import (SPLIT_ROWS, gqa_decode,
                                                gqa_decode_ref,
                                                gqa_decode_split_ref,
                                                num_splits)
    B = len(lengths)
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


# ------------------------------------------- prefix, chunked and priority
def prefix_serve(model, params, prompts, urgent, new_tokens: int, **kw):
    """Serve `prompts` (greedy, `new_tokens` each) through one paged batcher
    built with `kw`; after two chunks the `urgent` prompts arrive at
    priority 1, then the batcher drains. Returns (batcher, finished
    requests sorted by rid)."""
    from repro_torch.serve import PagedContinuousBatcher, Request
    cb = PagedContinuousBatcher(model, params, **kw)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=new_tokens))
    done = cb.run(max_chunks=2)
    for j, p in enumerate(urgent):
        cb.submit(Request(rid=len(prompts) + j, tokens=p,
                          max_new_tokens=new_tokens, priority=1))
    done += cb.run()
    return cb, sorted(done, key=lambda r: r.rid)


def chat_prompts(vocab: int, n: int, lengths, prefix_len: int):
    """The first `n` requests of the seeded `chat_sysprompt` workload (4
    requests a tenant, rate 4/s over 8 s), materialized into tokens."""
    from repro_torch.traffic import generate_workload, materialize_tokens
    specs = generate_workload("chat_sysprompt", rate=4.0, horizon_s=8.0,
                              seed=SEED, lengths=lengths,
                              prefix_len=prefix_len, sharing=4)[:n]
    return materialize_tokens(specs, vocab, seed=SEED)


def mechanisms(st) -> dict:
    """The prefix, chunking and preemption counters of a `PagedStats`."""
    return dict(prefix_hits=st.prefix_hits,
                prefix_tokens_reused=st.prefix_tokens_reused,
                cow_splits=st.cow_splits, evicted_pages=st.evicted_pages,
                prefill_slices=st.prefill_slices, preemptions=st.preemptions)


def reference_prefix() -> dict:
    """The reduced dsr1d model with 2 layers, float32, on the card and on
    the CPU plain path: shared-prefix traffic served with the prefix cache,
    16-token prefill slices (the longest suffix is longer), two priority-1
    requests after two chunks, and a pool of 33 pages, so that every
    mechanism fires (hits, COW splits, evictions, slices, preemptions), on
    native, int8 and fp8 pages and speculatively (k 2, native pages). Greedy
    tokens, per-request preemptions, every `PagedStats` counter, the events
    of "kv" and "kv_logical" and both traces' (C, B) sweep rows must be
    equal."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.explorer import sweep
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    from repro_torch.traffic import LengthModel
    small = reduced(get_arch(ARCH), layers=2)
    cpu_params = init_params(small, torch.Generator().manual_seed(SEED + 6),
                             device="cpu")
    prompts = chat_prompts(small.vocab_size, 8, LengthModel(
        prompt_mean=16, prompt_sigma=0.4, output_mean=8, max_len=96), 40)
    urgent = list(np.random.default_rng(SEED + 5).integers(
        0, small.vocab_size, (2, 48)))
    geometry = dict(num_slots=2, page_size=8, num_pages=34,
                    max_pages_per_slot=16, chunk_steps=4,
                    prefill_chunk_tokens=16, prefix_cache=True)
    cases = {"native": dict(kv_dtype="native"), "int8": dict(kv_dtype="int8"),
             "fp8": dict(kv_dtype="fp8"),
             "native spec k2": dict(kv_dtype="native", speculate_k=2)}
    out = {}
    for tag, kw in cases.items():
        got = {}
        for dev, p in (("cuda", _to(cpu_params, "cuda")), ("cpu", cpu_params)):
            m = DecoderLM(small, torch.float32, dev)
            cb, done = prefix_serve(m, p, prompts, urgent, 24, **geometry,
                                    **kw)
            bundle = cb.occupancy_bundle()
            traces = {n: bundle.traces[n] for n in ("kv", "kv_logical")}
            got[dev] = dict(
                tokens=[r.output for r in done],
                preemptions=[r.preemptions for r in done],
                stats=vars(cb.stats),
                events={n: (t.ev_times, t.ev_dneeded, t.ev_dobsolete)
                        for n, t in traces.items()},
                sweep={n: [(r.capacity_mib, r.banks, r.result.n_transitions)
                           for r in sweep(bundle, mem_name=n,
                                          capacities_mib=[1, 2],
                                          banks=[1, 2, 4], device=dev,
                                          prune=True).rows]
                       for n in traces})
        for key in got["cpu"]:
            check(got["cuda"][key] == got["cpu"][key],
                  f"reference_prefix {tag}: {key} on the card == CPU plain "
                  "path")
        st = cb.stats
        fired = mechanisms(st)
        check(all(v > 0 for v in fired.values()),
              f"reference_prefix {tag}: every mechanism fired {fired}")
        check(len(done) == len(prompts) + len(urgent),
              f"reference_prefix {tag}: every request finished")
        out[tag] = dict(fired, prefills=st.prefills, chunks=st.chunks,
                        spec_rounds=st.spec_rounds,
                        sweep_rows={n: len(v) for n, v in
                                    got["cuda"]["sweep"].items()})
    return dict(arch=small.name, layers=small.num_layers, dtype="float32",
                requests=len(prompts), priority_requests=len(urgent),
                geometry=geometry, cases=out, tokens_equal=True,
                stats_equal=True, events_equal=True, sweep_rows_equal=True)


def serve_prefix(model, params) -> tuple:
    """Full-width prefix-cached serving: chat_sysprompt traffic with 384-token
    system prompts through 8 slots, suffix prefills in 256-token slices,
    then 4 priority-1 requests with 512-token prompts after two chunks, in a
    pool small enough that cached prefixes are evicted. Launch counts are
    set to 0 just before and read just after. Every mechanism must fire,
    every request finish, every prefill forward (all shared prefills here)
    launch the prefill kernel once per layer and every decode step the
    paged decode kernel once per layer; the card's sweeps of "kv" and
    "kv_logical" must equal the CPU's. The same stream served without the
    prefix cache gives the count of requests whose tokens agree (reported,
    not gated). Returns (the phase's fields, the flash and decode launch
    counts)."""
    from repro_torch.core.explorer import min_capacity_mib, sweep
    from repro_torch.kernels import build
    from repro_torch.serve.paged import pages_for
    from repro_torch.traffic import LengthModel
    cfg = model.cfg
    L = cfg.num_layers
    prompts = chat_prompts(cfg.vocab_size, PREFIX_REQUESTS, LengthModel(
        prompt_mean=128, prompt_sigma=0.5, output_mean=64, max_len=1024), 384)
    urgent = list(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (URGENT, URGENT_LEN)))
    per_slot = pages_for(max(len(p) for p in prompts + urgent)
                         + NEW_TOKENS - 1, PAGE_SIZE)
    geometry = dict(num_slots=SLOTS, page_size=PAGE_SIZE,
                    num_pages=PREFIX_POOL_PAGES, max_pages_per_slot=per_slot,
                    chunk_steps=CHUNK_STEPS, prefill_chunk_tokens=PREFIX_CHUNK)
    # count the prefill forwards (plain and shared) and their seconds
    forwards = {"prefill": 0, "prefill_shared": 0}
    prefill_s = [0.0]

    def counted(name):
        fn = getattr(type(model), name).__get__(model)

        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            prefill_s[0] += time.perf_counter() - t0
            forwards[name] += 1
            return out
        return call

    for name in forwards:
        setattr(model, name, counted(name))
    try:
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb, done = prefix_serve(model, params, prompts, urgent, NEW_TOKENS,
                                prefix_cache=True, **geometry)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = build.launch_counts()
    finally:
        for name in forwards:
            delattr(model, name)
    st = cb.stats
    fired = mechanisms(st)
    check(all(v > 0 for v in fired.values()),
          f"serve_prefix: every mechanism fired {fired}")
    check(len(done) == PREFIX_REQUESTS + URGENT
          and st.finished == PREFIX_REQUESTS + URGENT
          and all(len(r.output) == NEW_TOKENS
                  and all(0 <= t < cfg.vocab_size for t in r.output)
                  for r in done),
          "serve_prefix: every request finished with NEW_TOKENS in-vocab "
          "tokens")
    n_fwd = forwards["prefill"] + forwards["prefill_shared"]
    check(counts["flash_attention"] == L * n_fwd,
          f"serve_prefix: flash_attention launches "
          f"{counts['flash_attention']} == layers x prefill forwards "
          f"{L * n_fwd}")
    check(forwards["prefill"] == 0 and st.prefills <= n_fwd
          <= st.prefills + st.prefill_slices,
          f"serve_prefix: every admission prefilled through prefill_shared, "
          f"one forward per slice ({forwards}, {fired})")
    steps = st.chunks * CHUNK_STEPS
    check(counts["paged_gqa_decode"] == L * steps,
          f"serve_prefix: paged_gqa_decode launches "
          f"{counts['paged_gqa_decode']} == layers x steps {L * steps}")
    check(int(cb.ledger.trace.as_arrays()[1][-1]) == 0
          and cb.ledger.allocator.n_allocated
          == cb.ledger.index.n_cached_pages,
          "serve_prefix: no slot holds pages at the end, only the cache")
    bundle = cb.occupancy_bundle()
    traces = {}
    for name in ("kv", "kv_logical"):
        tr = bundle.traces[name]
        mc = min_capacity_mib(tr.peak_needed())
        kw = dict(mem_name=name, capacities_mib=[mc, mc + 32, mc + 64],
                  banks=[1, 2, 4, 8, 16], prune=True)
        build.reset_launch_counts()
        table = sweep(bundle, device="cuda", **kw)
        torch.cuda.synchronize()
        sweep_counts = build.launch_counts()
        plain = sweep(bundle, device="cpu", **kw)
        check([(r.capacity_mib, r.banks, r.result.n_transitions)
               for r in table.rows]
              == [(r.capacity_mib, r.banks, r.result.n_transitions)
                  for r in plain.rows],
              f"serve_prefix: {name} sweep rows and transition counts equal "
              "the plain-version sweep")
        rel = max(abs(a.result.e_total / b.result.e_total - 1.0)
                  for a, b in zip(table.rows, plain.rows))
        check(rel <= 1e-12, f"serve_prefix: {name} e_total rel err {rel}")
        check(sweep_counts["running_time"] == 1
              and sweep_counts["exact_bank_stats"] >= 1,
              f"serve_prefix: the {name} sweep ran kernel 3 after one scan")
        best = table.best()
        traces[name] = dict(
            peak_needed_bytes=tr.peak_needed(),
            peak_pages=tr.peak_needed() // cb.page_bytes,
            capacities_mib=kw["capacities_mib"], rows=len(table.rows),
            e_total_rel_err=rel,
            best={"capacity_mib": best.capacity_mib, "banks": best.banks,
                  "e_total_j": best.result.e_total},
            sweep_launches={k: sweep_counts[k] for k in (
                "running_time", "exact_bank_stats", "bank_energy")})
    # the same stream without the prefix cache (reported, not gated: the
    # reference fails this property itself, and projections of different
    # row counts may round differently)
    _, plain_done = prefix_serve(model, params, prompts, urgent, NEW_TOKENS,
                                 **geometry)
    admitted = sum(len(r.tokens) * (1 + r.preemptions) for r in done)
    fields = dict(
        arch=cfg.name, layers=L, dtype="bfloat16", kv_dtype="native",
        slots=SLOTS, page_size=PAGE_SIZE, chunk_steps=CHUNK_STEPS,
        prefill_chunk_tokens=PREFIX_CHUNK, num_pages=PREFIX_POOL_PAGES,
        max_pages_per_slot=per_slot, requests=PREFIX_REQUESTS,
        priority_requests=URGENT, priority_prompt=URGENT_LEN,
        prompt_lengths=[len(p) for p in prompts], new_tokens=NEW_TOKENS,
        requests_finished=st.finished, **fired, prefills=st.prefills,
        prefill_forwards=forwards, chunks=st.chunks,
        decode_tokens=st.decode_steps, decode_steps=steps,
        wall_s=wall_s, prefill_s=prefill_s[0],
        # wall time of the whole run, admission prefills included
        decode_tokens_per_s=st.decode_steps / wall_s,
        prompt_tokens_admitted=admitted,
        reused_share=st.prefix_tokens_reused / admitted,
        peak_pages=st.peak_pages, page_bytes=cb.page_bytes, traces=traces,
        requests_equal_without_prefix_cache=sum(
            a.output == b.output for a, b in zip(done, plain_done)),
        launches={k: counts[k] for k in ("flash_attention",
                                         "paged_gqa_decode")})
    return fields, counts


# ------------------------------------------------------ traffic and telemetry
def _plain(x):
    """Dataclasses as nested dicts, arrays as lists: the rows of a campaign
    as comparable plain values."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _rel_close(a, b, rtol: float) -> bool:
    """Plain values equal, floats within `rtol` relative."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_rel_close(a[k], b[k], rtol)
                                              for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_rel_close(x, y, rtol)
                                        for x, y in zip(a, b))
    if isinstance(a, float) and a != b:
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b


def traffic_phase() -> tuple:
    """The traffic campaigns of `CAMPAIGNS` (`run_campaign`, host
    simulators, Stage II on the device) on the card and on the CPU, launch
    counts set to 0 just before the card's and read just after. Every row
    must agree: the online legs exactly, the offline (oracle, no-gating)
    legs within rel 1e-12, the metered report exactly. Then the CLI once on
    the card. Returns (the phase's fields, the card's launch counts)."""
    import tempfile
    from repro_torch.core.explorer import DEFAULT_BANKS
    from repro_torch.kernels import build
    from repro_torch.traffic import run_campaign
    runs = {}
    counts = {}
    for dev in ("cuda", "cpu"):
        reports, wall = {}, {}
        if dev == "cuda":
            build.reset_launch_counts()
            torch.cuda.synchronize()
        for tag, kw in CAMPAIGNS.items():
            t0 = time.perf_counter()
            reports[tag] = run_campaign(TRAFFIC_ARCHS, device=dev,
                                        **TRAFFIC, **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall[tag] = time.perf_counter() - t0
        if dev == "cuda":
            counts = build.launch_counts()
        runs[dev] = (reports, wall)
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    out = {}
    for tag in CAMPAIGNS:
        a, b = _plain(card[tag].rows), _plain(cpu[tag].rows)
        check(len(a) == len(b) > 0, f"traffic {tag}: rows on both devices")
        for ra, rb in zip(a, b):
            ca, cb_ = ra.pop("comparison"), rb.pop("comparison")
            check(ra == rb, f"traffic {tag}: row fields equal "
                  f"({ra['scenario']['arch']} C {ra['capacity_mib']} "
                  f"B {ra['banks']})")
            check(ca["online"] == cb_["online"]
                  and ca["forecast"] == cb_["forecast"],
                  f"traffic {tag}: online legs equal")
            check(all(_rel_close(ca[leg], cb_[leg], 1e-12)
                      for leg in ("oracle", "none")),
                  f"traffic {tag}: offline legs within rel 1e-12")
        rel = max(abs(r.comparison.oracle.e_total
                      / s.comparison.oracle.e_total - 1.0)
                  for r, s in zip(card[tag].rows, cpu[tag].rows))
        sims = {}
        for (arch, _), sim in sorted(card[tag].sims.items()):
            util = [r for r in card[tag].rows if r.scenario.arch == arch][0]
            sims[arch] = dict(
                requests=sim.stats.finished,
                segments=len(sim.trace.occupancy_series(sim.total_time)[0]),
                peak_mib=util.peak_mib, mean_mib=util.mean_mib)
        best = {r.scenario.arch: dict(capacity_mib=r.capacity_mib,
                                      banks=r.banks,
                                      e_online_j=r.e_online,
                                      e_oracle_j=r.e_oracle,
                                      e_none_j=r.e_none)
                for r in card[tag].best_per_scenario()}
        energy = card[tag].rows[0].energy
        out[tag] = dict(rows=len(a), sims=sims, best=best,
                        oracle_e_total_rel_err=rel,
                        wall_s_card=runs["cuda"][1][tag],
                        wall_s_cpu=runs["cpu"][1][tag],
                        **({} if energy is None else {"meter": dict(
                            e_total_j=energy.result.e_total,
                            wakes=energy.wakes,
                            j_per_request=list(energy.j_per_request))}))
    launched = {k: counts[k] for k in ("running_time", "exact_bank_stats",
                                       "bank_energy")}
    check(launched["exact_bank_stats"] > 0 and launched["bank_energy"] > 0,
          f"traffic: the campaigns launched kernels 3 and 4 ({launched})")
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "traffic.json"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.traffic", "--json",
             str(report)], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=600,
            env={**os.environ,
                 "PYTHONPATH": str(Path(__file__).resolve().parent / "src")})
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0,
              f"traffic CLI exit {cli.returncode}: {cli.stderr[-2000:]}")
        cli_rows = json.loads(report.read_text())["rows"]
    check(len(cli_rows) > 0 and {r["arch"] for r in cli_rows}
          == set(TRAFFIC_ARCHS), "traffic CLI rows of both models")
    fields = dict(archs=list(TRAFFIC_ARCHS), banks=list(DEFAULT_BANKS),
                  alpha=0.9, **TRAFFIC, campaigns=out, launches=launched,
                  traffic_cli=dict(argv="--json", exit=0, wall_s=cli_s,
                                   rows=len(cli_rows)))
    return fields, launched


def obs_stream(vocab: int):
    """The serve_prefix configuration's first OBS_REQUESTS requests (seeded
    chat_sysprompt traffic, 384-token system prompts), with each tenant's
    name: [(tokens, tenant)]."""
    from repro_torch.traffic import (LengthModel, generate_workload,
                                     materialize_tokens)
    specs = generate_workload("chat_sysprompt", rate=4.0, horizon_s=8.0,
                              seed=SEED, lengths=LengthModel(
                                  prompt_mean=128, prompt_sigma=0.5,
                                  output_mean=64, max_len=1024),
                              prefix_len=384, sharing=4)[:OBS_REQUESTS]
    toks = materialize_tokens(specs, vocab, seed=SEED)
    return [(t, f"tenant{s.prefix_id}") for s, t in zip(specs, toks)]


def obs_serve(model, params, stream, instrumented: bool):
    """Serve `stream` through the serve_prefix geometry, with an enabled
    registry and the OBS_METER meter when `instrumented`. Returns (batcher,
    finished requests by rid, registry, meter, wall seconds, launch
    counts)."""
    from repro_torch.kernels import build
    from repro_torch.obs import BankEnergyMeter, Telemetry
    from repro_torch.serve import PagedContinuousBatcher, Request
    from repro_torch.serve.paged import pages_for
    per_slot = pages_for(max(len(t) for t, _ in stream) + OBS_NEW_TOKENS - 1,
                         PAGE_SIZE)
    tel = Telemetry(enabled=True) if instrumented else None
    meter = BankEnergyMeter.from_spec(OBS_METER) if instrumented else None
    cb = PagedContinuousBatcher(
        model, params, num_slots=SLOTS, page_size=PAGE_SIZE,
        num_pages=PREFIX_POOL_PAGES, max_pages_per_slot=per_slot,
        chunk_steps=CHUNK_STEPS, prefix_cache=True,
        prefill_chunk_tokens=PREFIX_CHUNK, telemetry=tel, meter=meter)
    for i, (t, tenant) in enumerate(stream):
        cb.submit(Request(rid=i, tokens=t, max_new_tokens=OBS_NEW_TOKENS,
                          tenant=tenant))
    cuda = model.device.type == "cuda"
    build.reset_launch_counts()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = sorted(cb.run(), key=lambda r: r.rid)
    if cuda:
        torch.cuda.synchronize()
    return (cb, done, tel, meter, time.perf_counter() - t0,
            build.launch_counts())


def serve_obs(model, params) -> tuple:
    """The instrumented serve (`obs_serve`) at full width on the card, held
    to the same stream served on the card without instrumentation (tokens,
    stats, both traces' events) and to a CPU dry run with a 1-layer model of
    the full vocabulary (counters, spans and latency percentiles: the clock
    is logical and, with no EOS, scheduling depends only on token counts).
    The meter must be Stage II on the "kv" trace bit for bit and within rel
    1e-12 of the card's batched engine, its attribution must conserve the
    live total, and the Perfetto export must re-read and integrate to the
    trace. Returns (the phase's fields, the card's launch counts)."""
    import dataclasses
    import tempfile
    from repro_torch.core.candidates import Candidate, evaluate_candidates
    from repro_torch.core.gating import evaluate
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM
    from repro_torch.obs import counter_integral, export_chrome_trace
    from repro_torch.params import init_params
    cfg = model.cfg
    L = cfg.num_layers
    stream = obs_stream(cfg.vocab_size)
    cb, done, tel, meter, wall_s, counts = obs_serve(model, params, stream,
                                                     True)
    pcb, pdone, _, _, plain_s, plain_counts = obs_serve(model, params,
                                                        stream, False)
    st = cb.stats
    fields_all = dataclasses.fields(st)
    stat = {f.name: getattr(st, f.name) for f in fields_all
            if not f.name.endswith("_s")}
    check([r.output for r in done] == [r.output for r in pdone],
          "serve_obs: tokens equal the uninstrumented serve's")
    check(stat == {k: getattr(pcb.stats, k) for k in stat},
          "serve_obs: PagedStats equal the uninstrumented serve's")
    for name in ("trace", "logical"):
        a, b = getattr(cb.ledger, name), getattr(pcb.ledger, name)
        check((a.ev_times, a.ev_dneeded, a.ev_dobsolete)
              == (b.ev_times, b.ev_dneeded, b.ev_dobsolete),
              f"serve_obs: {name} events equal the uninstrumented serve's")
    check(counts == plain_counts, "serve_obs: the same kernel launches with "
          "and without instrumentation")
    check(len(done) == OBS_REQUESTS and all(
        len(r.output) == OBS_NEW_TOKENS for r in done),
        "serve_obs: every request finished with OBS_NEW_TOKENS tokens")
    snap = tel.snapshot()
    c = snap["counters"]
    mirror = {"admitted": "admitted", "retired": "finished",
              "prefills": "prefills", "chunks": "chunks",
              "decode_steps": "decode_steps",
              "pages_allocated": "pages_allocated",
              "pages_freed": "pages_freed", "pages_evicted": "evicted_pages",
              "cow_splits": "cow_splits", "prefix_hits": "prefix_hits",
              "prefix_tokens_reused": "prefix_tokens_reused",
              "preemptions": "preemptions",
              "prefill_slices": "prefill_slices"}
    check(all(c.get(f"serve.paged.{k}", 0) == getattr(st, f)
              for k, f in mirror.items()),
          "serve_obs: serve.paged.* counters equal the PagedStats fields")
    steps = st.chunks * CHUNK_STEPS
    check(counts["paged_gqa_decode"] == L * steps
          and counts["flash_attention"] > 0
          and counts["flash_attention"] % L == 0,
          f"serve_obs: kernels 1 and 2 launched ({counts})")
    slo = cb.slo_summary()

    # the CPU dry run: the same stream, a 1-layer model of the full vocab
    cpu_cfg = dataclasses.replace(cfg, num_layers=1)
    cpu_model = DecoderLM(cpu_cfg, torch.float32, "cpu")
    cpu_params = init_params(cpu_cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    t0 = time.perf_counter()
    dcb, _, dtel, _, _, _ = obs_serve(cpu_model, cpu_params, stream, True)
    dry_s = time.perf_counter() - t0
    dslo = dcb.slo_summary()
    check(dtel.snapshot()["counters"] == c,
          "serve_obs: counters equal the CPU dry run's")
    check([(s.name, s.t0, s.t1, s.attrs) for s in tel.spans]
          == [(s.name, s.t0, s.t1, s.attrs) for s in dtel.spans],
          "serve_obs: spans (name, t0, t1, attrs) equal the CPU dry run's")
    lat = [k for k in vars(slo) if k.startswith(("ttft", "tbt", "e2e",
                                                 "n_requests"))]
    check({k: getattr(slo, k) for k in lat}
          == {k: getattr(dslo, k) for k in lat}
          and slo.kv_peak_bytes / cb.page_bytes
          == dslo.kv_peak_bytes / dcb.page_bytes,
          "serve_obs: SLO percentiles equal the CPU dry run's (kv bytes "
          "in pages)")

    # the meter: Stage II on the "kv" trace, bit for bit and on the card
    end = cb.occupancy_bundle().total_time
    res = meter.finalize(end)
    dur, occ = cb.ledger.trace.occupancy_series(end, use="needed")
    ref = evaluate(dur, occ, capacity=meter.capacity, banks=meter.banks,
                   policy=meter.policy, n_reads=0, n_writes=0,
                   char=meter.char)
    check((res.e_leak, res.e_sw, res.n_transitions)
          == (ref.e_leak, ref.e_sw, ref.n_transitions),
          "serve_obs: meter == gating.evaluate bit for bit")
    pol = meter.policy
    build.reset_launch_counts()
    eng = evaluate_candidates(dur, occ, [Candidate(
        meter.capacity, meter.banks, pol.alpha, "gate",
        pol.min_gate_multiple)], n_reads=0, n_writes=0, device="cuda")
    meter_counts = build.launch_counts()
    eng_rel = abs(float(eng.e_total[0]) / res.e_total - 1.0)
    check(eng_rel <= 1e-12 and int(eng.n_off[0]) == res.n_transitions
          and meter_counts["exact_bank_stats"] == 1,
          f"serve_obs: meter vs the card's evaluate_candidates rel {eng_rel}")
    live = meter.energy_j(end)
    req_j = meter.request_energy_j(end)
    cons = abs((sum(req_j.values()) + meter.floor_j(end)) / live - 1.0)
    check(cons <= 1e-12, f"serve_obs: attribution conserves rel {cons}")
    rep = meter.report(end)

    # the Perfetto export re-reads and integrates to the trace
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "obs.json"
        bundle = cb.occupancy_bundle()
        export_chrome_trace(str(path), tel, traces=bundle.traces.values(),
                            end_time=end, meter=meter,
                            other_data={"slo": vars(slo)})
        evs = json.loads(path.read_text())["traceEvents"]
        n_events = len(evs)
    area = counter_integral(evs, "kv occupancy [B]", end * 1e6)
    want = cb.ledger.trace.time_integral(end, use="needed") * 1e6
    check(abs(area - want) <= 1e-9 * want,
          f"serve_obs: exported KV track integral {area} vs {want}")
    fields = dict(
        arch=cfg.name, layers=L, dtype="bfloat16", kv_dtype="native",
        slots=SLOTS, page_size=PAGE_SIZE, chunk_steps=CHUNK_STEPS,
        prefill_chunk_tokens=PREFIX_CHUNK, num_pages=PREFIX_POOL_PAGES,
        requests=OBS_REQUESTS, new_tokens=OBS_NEW_TOKENS, meter=OBS_METER,
        prompt_lengths=[len(t) for t, _ in stream], **mechanisms(st),
        chunks=st.chunks, counters=c, spans=len(tel.spans),
        span_names=sorted({s.name for s in tel.spans}),
        slo=vars(slo), wakes=meter.wake_counts(end),
        j_per_request_p50_p90_p99=list(rep.j_per_request),
        meter_e_total_j=res.e_total, meter_n_transitions=res.n_transitions,
        meter_vs_card_engine_rel=eng_rel, conservation_rel=cons,
        tenant_j=meter.tenant_energy_j(end), floor_j=meter.floor_j(end),
        peak_pages=cb.ledger.trace.peak_needed() // cb.page_bytes,
        perfetto_events=n_events, wall_s=wall_s, wall_s_uninstrumented=plain_s,
        cpu_dry_run_s=dry_s, launches={k: counts[k] for k in (
            "flash_attention", "paged_gqa_decode")})
    return fields, counts


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
# ------------------------------------------------------ the decoder families
def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _trace_events(engine):
    """(event times, deltas) of a batcher's "kv" trace (None for
    `BatchedServer`, which keeps none)."""
    if not hasattr(engine, "occupancy_bundle"):
        return None
    tr = engine.occupancy_bundle().traces["kv"]
    return list(tr.ev_times), list(tr.ev_dneeded)


def _logits_err(a, b) -> float:
    """Largest |card - CPU| over a list of logits arrays, relative to the
    CPU logits' magnitude when it exceeds 1."""
    return max(float(np.abs(x - y).max() / max(1.0, np.abs(y).max()))
               for x, y in zip(a, b))


def _sweep_equal(tag, a, b) -> dict:
    """A card sweep against the CPU sweep of the same trace: rows equal,
    e_total within rel 1e-12, transition counts equal."""
    check([(r.capacity_mib, r.banks) for r in a.rows]
          == [(r.capacity_mib, r.banks) for r in b.rows],
          f"{tag}: sweep rows equal the CPU sweep's")
    rel = max(abs(x.result.e_total / y.result.e_total - 1.0)
              for x, y in zip(a.rows, b.rows))
    check(rel <= 1e-12, f"{tag}: sweep e_total rel err {rel}")
    check(all(x.result.n_transitions == y.result.n_transitions
              for x, y in zip(a.rows, b.rows)),
          f"{tag}: sweep transition counts equal")
    best = a.best()
    return dict(rows=len(a.rows), e_total_rel_err=rel,
                best={"capacity_mib": best.capacity_mib, "banks": best.banks,
                      "e_total_j": best.result.e_total})


def family_parity(name: str) -> dict:
    """A reduced config of one family (FAMILY_REDUCED_LAYERS, float32) on
    the card against its plain path on the CPU, with the same weights
    (drawn on the CPU): prefill + 3 decode steps (logits within TOL of
    their magnitude, greedy tokens equal), then each of the family's
    batchers: tokens, trace events and Stage-II rows equal, logits within
    TOL where the batcher collects them."""
    from repro_torch.examples.families_serving import (
        FAMILIES, family_config, prefix_embeds_of, prompts_of, serve_family,
        sweep_trace)
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    cfg = family_config(name, False, FAMILY_REDUCED_LAYERS[name])
    cpu_params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    runs = {"cuda": (DecoderLM(cfg, torch.float32, "cuda"),
                     _to(cpu_params, "cuda")),
            "cpu": (DecoderLM(cfg, torch.float32, "cpu"), cpu_params)}
    prompts = prompts_of(cfg, name, False, SEED)
    tol = TOL[torch.float32]

    # prefill + 3 decode steps on the dense cache, both driven by the CPU's
    # greedy tokens
    batch = {"tokens": np.asarray(prompts[0])[None]}
    embeds = prefix_embeds_of(cfg, 1, SEED)
    if embeds is not None:
        batch["prefix_embeds"] = embeds
    n_in = len(prompts[0]) + (0 if embeds is None else embeds.shape[1])
    cache_len = max(n_in + 8, cfg.local_window)
    logits, caches = {}, {}
    for dev, (m, p) in runs.items():
        inp = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        lg, caches[dev] = m.prefill(p, inp, cache_len)
        logits[dev] = [lg[0, -1].float().cpu().numpy()]
    for _ in range(3):
        tok = torch.tensor([[int(np.argmax(logits["cpu"][-1]))]])
        for dev, (m, p) in runs.items():
            lg, caches[dev] = m.decode_step(p, caches[dev], tok.to(dev))
            logits[dev].append(lg[0, -1].float().cpu().numpy())
    step_err = _logits_err(logits["cuda"], logits["cpu"])
    check(step_err <= tol, f"{name} reduced: prefill/decode logits on the "
          f"card vs CPU {step_err}")
    check([int(np.argmax(x)) for x in logits["cuda"]]
          == [int(np.argmax(x)) for x in logits["cpu"]],
          f"{name} reduced: prefill/decode greedy tokens on the card == CPU")
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               kinds=sorted(set(cfg.layer_kinds())),
               decode_logits_err=step_err)
    for batcher in FAMILIES[name]["batchers"]:
        res = {dev: serve_family(m, p, name, batcher, prompts, False,
                                 collect_logits=True)
               for dev, (m, p) in runs.items()}
        a, b = res["cuda"], res["cpu"]
        tag = f"{name} reduced {batcher}"
        check(a["outputs"] == b["outputs"],
              f"{tag}: greedy tokens on the card == CPU")
        row = dict(requests=len(prompts), tokens=a["tokens"],
                   tokens_equal=True)
        if "logits" in a:
            row["logits_err"] = _logits_err(a["logits"], b["logits"])
            check(row["logits_err"] <= tol,
                  f"{tag}: logits {row['logits_err']}")
        ev = _trace_events(a["engine"])
        if ev is not None:
            check(ev == _trace_events(b["engine"]),
                  f"{tag}: trace events on the card == CPU")
            row["trace_events"] = len(ev[0])
            ta = sweep_trace(a["engine"], "cuda")
            if ta is not None:
                row["sweep"] = _sweep_equal(
                    tag, ta, sweep_trace(b["engine"], "cpu"))
        out[batcher] = row
    return out


def family_full(name: str) -> tuple:
    """One family at full width (cut in depth where FAMILIES says why) with
    seeded random bf16 weights, through each of its batchers, launch counts
    set to 0 just before each and read just after: each kernel's launches
    must equal the layers x calls the run makes, every request gets its new
    tokens in the vocabulary, and each trace's card sweep equals the CPU
    sweep. Returns (fields, summed launches of the paths)."""
    from repro_torch.configs import get_arch
    from repro_torch.examples.families_serving import (
        FAMILIES, family_config, prompts_of, serve_family, sweep_trace)
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    from repro_torch.serve import kv_bytes_at, slot_state_bytes
    run = FAMILIES[name]
    cfg = family_config(name, True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, compute_dtype=torch.bfloat16, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               published_layers=get_arch(name).num_layers,
               cut=run.get("cut"), d_model=cfg.d_model,
               kinds=sorted(set(cfg.layer_kinds())), dtype="bfloat16",
               param_bytes=sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
               peak_device_bytes_after_init=torch.cuda.max_memory_allocated(),
               init_s=init_s)
    prompts = prompts_of(cfg, name, True, SEED)
    totals = {}
    for batcher in run["batchers"]:
        tag = f"{name} full {batcher}"
        build.reset_launch_counts()
        torch.cuda.synchronize()
        res = serve_family(model, params, name, batcher, prompts, True)
        counts = build.launch_counts()
        for k, n in res["expected"].items():
            check(counts[k] == n, f"{tag}: {k} launches {counts[k]} == "
                  f"layers x calls {n}")
        check(all(len(o) == run["new"]
                  and all(0 <= t < cfg.vocab_size for t in o)
                  for o in res["outputs"]),
              f"{tag}: every request has its new tokens, in the vocabulary")
        eng = res["engine"]
        row = dict(requests=len(prompts),
                   prompt_tokens=int(sum(len(p) for p in prompts)),
                   tokens=res["tokens"], wall_s=res["wall_s"],
                   tokens_per_s=res["tokens"] / res["wall_s"],
                   launches={k: counts[k] for k in res["expected"]})
        for k in res["expected"]:
            totals[k] = totals.get(k, 0) + counts[k]
        if hasattr(eng, "occupancy_bundle"):
            tr = eng.occupancy_bundle().traces["kv"]
            row["trace_peak_bytes"] = tr.peak_needed()
            row["trace_events"] = len(tr.ev_times)
        if batcher == "paged":
            row.update(page_bytes=eng.page_bytes,
                       pages_allocated=eng.stats.pages_allocated,
                       peak_pages=eng.stats.peak_pages)
            if name == "mamba2-130m":
                check(eng.page_bytes == 0 and eng.stats.pages_allocated > 0
                      and eng.stats.admitted_kv_bytes == 0,
                      f"{tag}: pages allocated at 0 KV bytes")
        if name == "recurrentgemma-2b":
            # the rings saturate at the window, the recurrent state is a
            # fixed per-slot term: the 2048-token prompt's KV never grows
            W, new = cfg.local_window, run["new"]
            growth = sum(d > 0 for d in tr.ev_dneeded) - len(prompts)
            want = sum(max(0, min(len(p) + new - 1, W) - len(p))
                       for p in prompts)
            check(growth == want, f"{tag}: decode-growth events {growth} "
                  f"== tokens decoded below the window {want}")
            check(kv_bytes_at(cfg, W + new) == kv_bytes_at(cfg, W)
                  and slot_state_bytes(cfg) > 0,
                  f"{tag}: KV saturates at local_window, state is fixed")
            row.update(decode_growth_events=growth,
                       slot_kv_bytes_at_window=kv_bytes_at(cfg, W),
                       slot_state_bytes=slot_state_bytes(cfg))
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = sweep_trace(eng, "cuda")
        if table is not None:
            torch.cuda.synchronize()
            row["sweep_s"] = time.perf_counter() - t0
            bank = build.launch_counts()
            check(bank["exact_bank_stats"] > 0,
                  f"{tag}: the sweep launched exact_bank_stats")
            for k in ("exact_bank_stats", "bank_energy"):
                totals[k] = totals.get(k, 0) + bank[k]
            row["sweep"] = dict(_sweep_equal(
                tag, table, sweep_trace(eng, "cpu")),
                launches={k: bank[k] for k in ("exact_bank_stats",
                                                "bank_energy")})
        out[batcher] = row
    del model, params, res, eng
    torch.cuda.empty_cache()
    return out, totals


def family_kernel_rows(gen) -> dict:
    """Kernels 7, 1 and 2 at the families' shapes, each against its plain
    version: dense decode on recurrentgemma's local ring (B1, T 2048, d
    256, K 1, group 10) and on llama4-scout's chunked rings (B4, T 8192,
    H40 K8 d128); paged decode and prefill at olmoe's H16 K16 d128."""
    from repro_torch.configs import get_arch
    rg, l4 = get_arch("recurrentgemma-2b"), get_arch("llama4-scout-17b-a16e")
    om = get_arch("olmoe-1b-7b")
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode, paged_gqa_decode_ref, paged_gqa_decode_split_ref)
    rows = {"gqa_decode": [
        dense_row(gen, "recurrentgemma-2b local ring", rg,
                  [rg.local_window], torch.bfloat16, T=rg.local_window),
        dense_row(gen, "llama4-scout chunked ring", l4,
                  [528, 316, 144, 80], torch.bfloat16, T=l4.local_window)]}
    lengths = prompt_lengths()
    dec_lens = np.r_[1, lengths[1:SLOTS] + NEW_TOKENS // 2]
    per_slot = -(-(PROMPT_MAX + NEW_TOKENS) // PAGE_SIZE)
    q, kp, vp, table, lens = decode_case(
        gen, SLOTS, om.num_heads, om.num_kv_heads, om.head_dim, dec_lens,
        torch.bfloat16, SLOTS * per_slot + 1)
    rows["paged_gqa_decode"] = [decode_row(
        "olmoe-1b-7b", om, paged_gqa_decode, paged_gqa_decode_ref,
        (q, kp, vp, table, lens), lens, kp.element_size(),
        paged_gqa_decode_split_ref)]
    rows["flash_attention"] = [flash_row(gen, "olmoe-1b-7b", om, PROMPT_MAX,
                                         PROMPT_MIN, torch.bfloat16)]
    return rows


def families_phase(gen) -> tuple:
    """The decoder families: kernels 7, 1 and 2 at their shapes, the five
    families reduced on the card against the CPU, then each at full width.
    Returns (the phase's fields, the summed launches of the full-width
    paths, the kernel rows)."""
    t0 = time.perf_counter()
    krows = family_kernel_rows(gen)
    parity = {name: family_parity(name) for name in FAMILY_REDUCED_LAYERS}
    full, launches = {}, {}
    for name in FAMILY_REDUCED_LAYERS:
        full[name], counts = family_full(name)
        emit("families_full", **full[name])
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    fields = dict(
        reduced=parity, full={n: {k: v for k, v in f.items()
                                  if k in FAMILY_BATCHERS or k in (
                                      "layers", "cut", "param_bytes")}
                              for n, f in full.items()},
        kernel_rows={k: [{x: r[x] for x in (
            "shape", "arch", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms") + tuple(
            x for x in ("device_ms", "library_device_ms") if x in r)}
            for r in v] for k, v in krows.items()},
        launches=launches, seconds=time.perf_counter() - t0)
    return fields, launches, krows


def noncausal_row(gen, tag, c, B, S, T, dtype=torch.bfloat16) -> dict:
    """Kernel 2 without its causal mask (the encoder, cross attention over
    the memory): every row attends all T keys. Held to the float32 plain
    version (the row's tolerance) and, in bf16, to the tensor-core mirror
    (one bf16 step at the output's largest magnitude, each element within
    one step plus MIRROR_ATOL); ragged S and T masked; two calls give the
    same bits. The library yardstick is one SDPA call without a mask on
    heads-major views."""
    from repro_torch.kernels.flash_attention import (
        MIRROR_ATOL, bf16_excess, bf16_step, flash_attention,
        flash_attention_bf16_mirror_ref, flash_attention_ref, variant)
    H, K, d = c.num_heads, c.num_kv_heads, c.head_dim
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, K, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, K, d), generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=False)
    torch.cuda.synchronize()
    name = f"flash non-causal {tag} B{B} S{S} T{T} {dtype}"
    err = max_err(out, ref)
    check(bool(torch.isfinite(out.float()).all()), f"{name}: finite")
    check(err <= TOL[dtype], f"{name}: {err}")
    check(max_err(out, flash_attention(q, k, v, causal=False)) == 0.0,
          f"{name}: two calls give the same bits")
    extra = {}
    if dtype == torch.bfloat16:
        mirror = flash_attention_bf16_mirror_ref(q, k, v, causal=False)
        extra = dict(max_abs_err_mirror=max_err(out, mirror),
                     mirror_step=float(bf16_step(mirror).max()),
                     mirror_excess=bf16_excess(out, mirror))
        check(extra["max_abs_err_mirror"] <= extra["mirror_step"],
              f"{name} vs its bf16 mirror: {extra['max_abs_err_mirror']}")
        check(extra["mirror_excess"] <= MIRROR_ATOL,
              f"{name} vs its bf16 mirror: an element strays "
              f"{extra['mirror_excess']} beyond one bf16 step")
    isz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
    b_ms, b_by = bound(nbytes, 4.0 * B * H * d * S * T, dtype)
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
              for x in (k, v))
    return dict(shape=f"B{B} S{S} T{T} H{H} K{K} d{d}", arch=tag,
                dtype=str(dtype), causal=False, variant=variant(q),
                max_abs_err=err, tolerance=TOL[dtype], **extra,
                **timed(lambda: flash_attention(q, k, v, causal=False),
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=False)),
                plain_ms=cuda_ms(lambda: flash_attention_ref(
                    q, k, v, causal=False), reps=5),
                bound_ms=b_ms, bound_by=b_by)


def encdec_phase(gen) -> tuple:
    """seamless-m4t on the card (`repro_torch.examples.encdec_serving`):
    kernel 2 without its mask at the encoder and cross shapes in both
    variants (and causal at the decoder's), kernel 7 at the cross and self
    decode shapes; the reduced model on the card against the CPU (encoder
    output, tokens, logits, KV events, launches); then full width with
    random bf16 weights served by `BatchedServer`, launches counted against
    layers x calls, and its KV trace swept through kernels 3 and 4 on the
    card against the CPU sweep. Returns (fields, the full-width launches,
    the kernel rows)."""
    from repro_torch.examples.encdec_serving import (
        RUNS, config, expected_launches, inputs, serve, sweep_log)
    from repro_torch.kernels import build
    from repro_torch.models import EncDecModel
    from repro_torch.params import init_params
    t_phase = time.perf_counter()
    cfg, run = config(True), RUNS[True]
    B, S_enc, S, new = run["batch"], run["frames"], run["prompt"], run["new"]
    rows = {
        "noncausal": [
            noncausal_row(gen, "seamless encoder", cfg, B, S_enc, S_enc),
            noncausal_row(gen, "seamless cross", cfg, B, S, S_enc),
            noncausal_row(gen, "seamless ragged", cfg, B, 37, S_enc - 27),
            noncausal_row(gen, "seamless encoder", cfg, B, S_enc, S_enc,
                          torch.float32),
            noncausal_row(gen, "seamless cross", cfg, B, S, S_enc,
                          torch.float32)],
        "causal": flash_row(gen, "seamless-m4t decoder", cfg, 256, S,
                            torch.bfloat16),
        "gqa_decode": [
            dense_row(gen, "seamless cross decode", cfg, [S_enc] * B,
                      torch.bfloat16, T=S_enc),
            dense_row(gen, "seamless self decode", cfg,
                      [S + 1, S + 9, S + 17, S + new - 1], torch.bfloat16,
                      T=S + new)]}

    # reduced seamless, card against CPU, same weights (drawn on the CPU)
    small, srun = config(False), RUNS[False]
    cpu_params = init_params(small, torch.Generator().manual_seed(SEED),
                             device="cpu")
    frames, tokens = inputs(small, srun, SEED)
    models = {dev: (EncDecModel(small, torch.float32, dev), p) for dev, p in
              (("cuda", _to(cpu_params, "cuda")), ("cpu", cpu_params))}
    enc_err = max_err(*(m.encode(p, frames).cpu()
                        for m, p in models.values()))
    check(enc_err <= TOL[torch.float32],
          f"reduced seamless: encoder output on the card vs CPU {enc_err}")
    res = {}
    for dev, (m, p) in models.items():
        build.reset_launch_counts()
        res[dev] = serve(m, p, frames, tokens, srun["new"],
                         collect_logits=True)
        res[dev]["launches"] = build.launch_counts()
    check(np.array_equal(res["cuda"]["tokens"], res["cpu"]["tokens"]),
          "reduced seamless: greedy tokens on the card == CPU")
    check(res["cuda"]["log"].events == res["cpu"]["log"].events,
          "reduced seamless: KV trace events on the card == CPU")
    lerr = _logits_err(list(res["cuda"]["logits"]),
                       list(res["cpu"]["logits"]))
    check(lerr <= TOL[torch.float32],
          f"reduced seamless: logits on the card vs CPU {lerr}")
    small_want = expected_launches(small, srun["new"])
    small_counts = {k: res["cuda"]["launches"][k] for k in small_want}
    check(small_counts == small_want, f"reduced seamless: launches "
          f"{small_counts} == layers x calls {small_want}")
    del models, res

    # full width, random bf16 weights
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = EncDecModel(cfg, torch.bfloat16, "cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames, tokens = inputs(cfg, run, SEED + 2)
    serve(model, params, frames, tokens, 2)               # warm-up
    want = expected_launches(cfg, new)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    full = serve(model, params, frames, tokens, new)
    counts = build.launch_counts()
    for k, n in want.items():
        check(counts[k] == n, f"seamless full: {k} launches {counts[k]} "
              f"== layers x calls {n}")
    out_tok, st = full["tokens"], full["stats"]
    check(out_tok.shape == (B, new)
          and bool(((out_tok >= 0) & (out_tok < cfg.vocab_size)).all()),
          "seamless full: every sequence has its new tokens, in the "
          "vocabulary")
    peak = torch.cuda.max_memory_allocated()
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = sweep_log(full["log"], "cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    bank = {k: build.launch_counts()[k]
            for k in ("exact_bank_stats", "bank_energy")}
    check(all(bank.values()), f"seamless full: the sweep launched kernels "
          f"3 and 4 {bank}")
    swept = dict(_sweep_equal("seamless full", table,
                              sweep_log(full["log"], "cpu")),
                 events=len(full["log"].events), sweep_s=sweep_s,
                 launches=bank)
    decode_steps = new - 1
    fields = dict(
        kernel_rows=rows["noncausal"],
        causal_row={x: rows["causal"][x] for x in (
            "shape", "max_abs_err", "max_abs_err_mirror", "mirror_excess",
            "prefix_max_abs_diff", "ms", "device_ms", "bound_ms")},
        decode_rows=rows["gqa_decode"],
        reduced=dict(arch=small.name, layers=small.num_layers,
                     encoder_layers=small.encoder_layers, **srun,
                     encoder_max_abs_err=enc_err, tokens_equal=True,
                     events_equal=True, logits_err=lerr,
                     launches=small_counts),
        full=dict(arch=cfg.name, layers=cfg.num_layers,
                  encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
                  vocab=cfg.vocab_size, dtype="bfloat16", **run,
                  param_bytes=sum(t.numel() * t.element_size()
                                  for t in _leaves(params)),
                  init_s=init_s, prefill_s=st.prefill_s,
                  decode_s=st.decode_s,
                  ms_per_decode_step=st.decode_s / decode_steps * 1e3,
                  decode_tokens_per_s=B * decode_steps / st.decode_s,
                  tokens_generated=st.tokens_generated,
                  wall_s=full["wall_s"], peak_device_bytes=peak,
                  launches={k: counts[k] for k in want}, sweep=swept),
        seconds=time.perf_counter() - t_phase)
    del model, params
    torch.cuda.empty_cache()
    return fields, dict({k: counts[k] for k in want}, **bank), rows


def train_steps(model, params, batches) -> tuple:
    """One AdamW step of `make_train_step` (constant lr 1e-3) per batch
    from `params`. Returns (losses, final params)."""
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import make_train_step
    opt = AdamW(lr=constant(1e-3))
    step = make_train_step(model, opt)
    state = opt.init(params)
    losses = []
    for b in batches:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
    return losses, params


def train_phase() -> dict:
    """Training on the card (no kernel of the port on this path: the loss
    runs plain PyTorch, as the reference's runs jnp): three steps of
    reduced dsr1d-qwen-1.5b and of reduced olmoe (its MoE aux loss in the
    loss) against the same steps on the CPU (losses within rel 1e-4); a
    preempted `TrainLoop` resumed from its checkpoint against the
    uninterrupted run (params bit for bit); then full-width tinyllama-1.1b
    through `launch/train.py`'s entry point (float32 weights, moments and
    compute, remat none, as the reference's CLI): TRAIN_STEPS steps at
    B8 x S64 writing one checkpoint, then the CLI again one step further,
    which restores it and runs one step. Checkpoints go to temporary
    directories the phase deletes."""
    import shutil
    import tempfile
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch import train as train_cli
    from repro_torch.models import DecoderLM
    from repro_torch.optim import AdamW, constant
    from repro_torch.params import init_params
    from repro_torch.train import LoopConfig, TrainLoop
    t_phase = time.perf_counter()

    # reduced dsr1d and olmoe: the card against the CPU from the same
    # weights and batches
    reduced_rows = []
    for name in TRAIN_REDUCED:
        small = reduced(get_arch(name), layers=2)
        cpu_params = init_params(small, torch.Generator().manual_seed(SEED),
                                 device="cpu")
        data = SyntheticTokens(DataConfig(vocab_size=small.vocab_size,
                                          seq_len=64, global_batch=4,
                                          seed=SEED))
        batches = [data.batch_at(i) for i in range(3)]
        losses = {dev: train_steps(DecoderLM(small, torch.float32, dev),
                                   _to(cpu_params, dev), batches)[0]
                  for dev in ("cuda", "cpu")}
        rel = max(abs(a / b - 1.0) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
        check(rel <= 1e-4, f"reduced {name} train: losses on the card vs "
              f"CPU rel {rel}")
        reduced_rows.append(dict(arch=small.name, layers=2, steps=3,
                                 batch=4, seq=64, moe=small.moe is not None,
                                 losses_card=losses["cuda"],
                                 losses_cpu=losses["cpu"],
                                 loss_rel_err=rel))

    # preemption on the card: fail at step 3, resume from the checkpoint
    small = reduced(get_arch(ARCH), layers=2)
    data = SyntheticTokens(DataConfig(vocab_size=small.vocab_size,
                                      seq_len=64, global_batch=4, seed=SEED))
    opt = AdamW(lr=constant(1e-3))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def loop(name, fail_at=None):
            return TrainLoop(DecoderLM(small, torch.float32, "cuda"), opt,
                             data, LoopConfig(total_steps=6, ckpt_every=2,
                                              ckpt_dir=os.path.join(tmp,
                                                                    name)),
                             fail_at_step=fail_at)
        whole = loop("whole").run()
        failed = False
        try:
            loop("preempted", fail_at=3).run()
        except RuntimeError:
            failed = True
        check(failed, "preemption: the injected failure fired")
        resumed = loop("preempted").run()
        check(resumed["history"][0]["step"] == 2,
              "preemption: the resumed run starts at the checkpoint")
        check(all(torch.equal(a, b) for a, b in zip(
            _leaves(whole["params"]), _leaves(resumed["params"]))),
              "preemption: final params on the card equal the "
              "uninterrupted run's bit for bit")
        check([h["loss"] for h in whole["history"][2:]]
              == [h["loss"] for h in resumed["history"]],
              "preemption: losses after the resume equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # full width: tinyllama-1.1b through the training CLI
    cfg = get_arch(TRAIN_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--ckpt-every", str(TRAIN_STEPS),
                "--ckpt-dir", tmp, "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train_cli.main(argv + ["--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        kept = sorted(os.listdir(tmp))
        check(kept == [f"step_{TRAIN_STEPS:08d}"],
              f"tinyllama train: one checkpoint written {kept}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(tmp, kept[0], f))
                         for f in os.listdir(os.path.join(tmp, kept[0])))
        t0 = time.perf_counter()
        again = train_cli.main(argv + ["--steps", str(TRAIN_STEPS + 1)])
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), "tinyllama train: checkpoints deleted")
    hist, rest = first["history"], again["history"]
    check([h["step"] for h in hist] == list(range(TRAIN_STEPS))
          and [h["step"] for h in rest] == [TRAIN_STEPS],
          "tinyllama train: the second run restored the checkpoint and ran "
          "one step")
    losses = [h["loss"] for h in hist + rest]
    check(all(np.isfinite(x) for x in losses),
          f"tinyllama train: losses finite {losses}")
    # the first step also warms up the allocator and autograd
    step_ms = [h["time_s"] * 1e3 for h in hist + rest]
    fields = dict(
        reduced=reduced_rows,
        preemption=dict(arch=small.name, total_steps=6, ckpt_every=2,
                        fail_at_step=3, resumed_at=2, params_bit_equal=True,
                        losses_equal=True),
        full=dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
                  params=cfg.param_count(), weights="float32",
                  compute="float32", remat="none", batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
                  step_ms=step_ms,
                  median_step_ms=float(np.median(step_ms[1:TRAIN_STEPS])),
                  tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * 1e3
                  / float(np.median(step_ms[1:TRAIN_STEPS])),
                  max_memory_allocated=peak, checkpoint_bytes=ckpt_bytes,
                  first_run_s=first_s, restore_run_s=again_s,
                  restored_at=TRAIN_STEPS),
        seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return fields


# ------------------------------------------------ the four dense configs
def dense_arch_config(name: str, group48: bool = False):
    """A dense config reduced to 2 layers (float32 card-vs-CPU runs); with
    `group48` granite at its real attention shape (H48 K1 d128), which the
    decode kernels run in row chunks."""
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(name), layers=2)
    return dataclasses.replace(cfg, **GROUP48) if group48 else cfg


def repeat_equal(tag, fn, args) -> None:
    """Two calls of a kernel on the same inputs give the same bits."""
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    check(bool(torch.equal(a, b)), f"{tag}: two calls give the same bits")


def dense_arch_kernel_rows(gen) -> dict:
    """Kernels 1, 5, 6, 7 and 2 at the dense configs' shapes, each against
    its plain version (and the decode kernels against their split mirrors,
    batch-1 rows against the batch's at 0.0, verify rows against decode
    rows at 0.0): paged decode at granite's H48 K1 d128 (bf16 and fp8
    pools), at qwen2-7b's H28 K4, deepseek-coder-33b's H56 K8 (d128) and
    tinyllama's H32 K4 d64 (bf16); int8 paged decode and verify (V 4: 192
    rows a KV head) at granite's; dense decode at granite's B8 T640 beside
    SDPA with the lengths mask; prefill at granite's S499 H48 K1 and
    tinyllama's, beside SDPA. At granite's shape two calls must give the
    same bits."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode, paged_gqa_decode_quant,
        paged_gqa_decode_quant_mirror_ref, paged_gqa_decode_quant_ref,
        paged_gqa_decode_quant_split_ref, paged_gqa_decode_ref,
        paged_gqa_decode_split_ref)
    from repro_torch.kernels.paged_gqa_verify import paged_gqa_verify
    from repro_torch.kernels.quant import quantize_page_rows, to_fp8_codes
    cfgs = {n: get_arch(n) for n in DENSE_ARCHS}
    gr = cfgs["granite-34b"]
    lengths = prompt_lengths()
    dec_lens = np.r_[1, lengths[1:SLOTS] + NEW_TOKENS // 2]
    per_slot = -(-(PROMPT_MAX + NEW_TOKENS) // PAGE_SIZE)
    num_pages = SLOTS * per_slot + 1
    rows = {k: [] for k in ("paged_gqa_decode", "paged_gqa_decode_quant",
                            "paged_gqa_verify", "gqa_decode",
                            "flash_attention")}
    for name, pools in (("granite-34b", "bfloat16"), ("granite-34b", "fp8"),
                        ("qwen2-7b", "bfloat16"),
                        ("deepseek-coder-33b", "bfloat16"),
                        ("tinyllama-1.1b", "bfloat16")):
        c = cfgs[name]
        q, kp, vp, table, lens = decode_case(
            gen, SLOTS, c.num_heads, c.num_kv_heads, c.head_dim, dec_lens,
            torch.float32, num_pages)
        q = q.to(torch.bfloat16)
        kp, vp = ((to_fp8_codes(kp), to_fp8_codes(vp)) if pools == "fp8"
                  else (kp.to(torch.bfloat16), vp.to(torch.bfloat16)))
        args = (q, kp, vp, table, lens)
        rows["paged_gqa_decode"].append(dict(decode_row(
            f"{name} pools {pools}", c, paged_gqa_decode,
            paged_gqa_decode_ref, args, lens, kp.element_size(),
            paged_gqa_decode_split_ref), pools=pools))
        if c is gr:
            repeat_equal(f"paged decode {name} {pools}", paged_gqa_decode,
                         args)

    q, kf, vf, table, lens = decode_case(
        gen, SLOTS, gr.num_heads, gr.num_kv_heads, gr.head_dim, dec_lens,
        torch.float32, num_pages)
    (kp, ks), (vp, vs) = quantize_page_rows(kf), quantize_page_rows(vf)
    args = (q.to(torch.bfloat16), kp, vp, ks, vs, table, lens)
    row = decode_row("granite-34b int8", gr, paged_gqa_decode_quant,
                     paged_gqa_decode_quant_ref, args, lens, 1,
                     paged_gqa_decode_quant_split_ref, scale_bytes=4)
    row["max_abs_err_mirror"] = max_err(paged_gqa_decode_quant(*args),
                                        paged_gqa_decode_quant_mirror_ref(
                                            *args))
    check(row["max_abs_err_mirror"] <= TOL[torch.bfloat16],
          f"int8 decode granite vs mirror: {row['max_abs_err_mirror']}")
    repeat_equal("int8 decode granite-34b", paged_gqa_decode_quant, args)
    rows["paged_gqa_decode_quant"].append(row)

    V = SPEC_K + 1
    for pools in ("bfloat16", "fp8"):
        q, kp, vp, table, lens = decode_case(
            gen, SLOTS, gr.num_heads, gr.num_kv_heads, gr.head_dim,
            dec_lens + V, torch.float32, num_pages)
        q = torch.randn((SLOTS, V, gr.num_heads, gr.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kp, vp = ((to_fp8_codes(kp), to_fp8_codes(vp)) if pools == "fp8"
                  else (kp.to(torch.bfloat16), vp.to(torch.bfloat16)))
        args = (q, kp, vp, table, (lens - V).clamp(min=0))
        rows["paged_gqa_verify"].append(dict(verify_row(
            f"granite-34b pools {pools}", gr, args), pools=pools))
        repeat_equal(f"verify granite-34b {pools}", paged_gqa_verify, args)

    dense_lens = np.r_[lengths[:SLOTS - 1] + NEW_TOKENS // 2, DENSE_MAX_LEN]
    rows["gqa_decode"].append(dense_row(gen, "granite-34b", gr, dense_lens,
                                        torch.bfloat16))
    S_max, S_min = int(lengths.max()), int(lengths.min())
    for name in ("granite-34b", "tinyllama-1.1b"):
        rows["flash_attention"].append(flash_row(
            gen, name, cfgs[name], S_max, S_min, torch.bfloat16))
    return rows


def _reduced_serve(model, params, prompts, batcher, **kw) -> dict:
    """One reduced-model run (greedy, 10 new tokens) through `batcher`:
    "paged" (3 slots, page 8, chunks of 6; logits collected unless
    speculating), "batched" (the prompts' first 5 tokens, 8 new) or
    "dense" (2 slots, max_len 64). Returns {"outputs", "logits",
    "engine"}."""
    from repro_torch.serve import (BatchedServer, ContinuousBatcher,
                                   PagedContinuousBatcher, Request,
                                   ServeConfig)
    if batcher == "batched":
        eng = BatchedServer(model, params, ServeConfig(
            max_len=24, max_new_tokens=8), collect_logits=True)
        res = eng.generate({"tokens": np.stack([p[:5] for p in prompts])})
        return dict(outputs=[list(map(int, r)) for r in res["tokens"]],
                    logits=list(res["logits"]), engine=eng)
    if batcher == "paged":
        logits = "speculate_k" not in kw
        eng = PagedContinuousBatcher(
            model, params, num_slots=3, page_size=8, num_pages=64,
            max_pages_per_slot=8, chunk_steps=6, collect_logits=logits, **kw)
    else:
        eng = ContinuousBatcher(model, params, num_slots=2, max_len=64)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=10))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return dict(outputs=[r.output for r in done], engine=eng,
                logits=[np.stack(r.logits) for r in done]
                if batcher == "paged" and "speculate_k" not in kw else None)


def dense_arch_parity(name: str, group48: bool = False) -> dict:
    """A dense config reduced to 2 layers (float32; `group48`: granite at
    H48 K1 d128) on the card against its plain path on the CPU, with the
    same weights (drawn on the CPU), through the paged batcher, the
    speculative paged batcher (k 3, skip-2 draft), `BatchedServer` and
    `ContinuousBatcher`: greedy tokens and trace events equal, `PagedStats`
    equal on the speculative run, logits within TOL of their magnitude,
    and the paged trace's card sweep equal to the CPU sweep."""
    import dataclasses
    from repro_torch.examples.families_serving import sweep_trace
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    cfg = dense_arch_config(name, group48)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    runs = {"cuda": (DecoderLM(cfg, torch.float32, "cuda"),
                     _to(cpu_params, "cuda")),
            "cpu": (DecoderLM(cfg, torch.float32, "cpu"), cpu_params)}
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(5, 40, 5)]
    tol = TOL[torch.float32]
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               heads=f"H{cfg.num_heads} K{cfg.num_kv_heads} d{cfg.head_dim}")
    for batcher, kw in (("paged", {}), ("spec", dict(speculate_k=SPEC_K)),
                        ("batched", {}), ("dense", {})):
        res = {dev: _reduced_serve(m, p, prompts,
                                   "paged" if batcher == "spec" else batcher,
                                   **kw)
               for dev, (m, p) in runs.items()}
        a, b = res["cuda"], res["cpu"]
        tag = f"{cfg.name} {out['heads']} {batcher}"
        check(a["outputs"] == b["outputs"],
              f"{tag}: greedy tokens on the card == CPU")
        row = dict(requests=len(a["outputs"]),
                   tokens=sum(len(o) for o in a["outputs"]),
                   tokens_equal=True)
        if a["logits"] is not None:
            row["logits_err"] = _logits_err(a["logits"], b["logits"])
            check(row["logits_err"] <= tol,
                  f"{tag}: logits {row['logits_err']}")
        ev = _trace_events(a["engine"])
        if ev is not None:
            check(ev == _trace_events(b["engine"]),
                  f"{tag}: trace events on the card == CPU")
            row["trace_events"] = len(ev[0])
        if batcher == "spec":
            sa, sb = (dataclasses.asdict(r["engine"].stats) for r in (a, b))
            check(sa == sb, f"{tag}: PagedStats on the card == CPU")
            check(sa["spec_rounds"] > 0, f"{tag}: speculation ran")
            row.update(spec_rounds=sa["spec_rounds"],
                       accepted_tokens=sa["accepted_tokens"])
        if batcher == "paged":
            check(dataclasses.asdict(a["engine"].stats)
                  == dataclasses.asdict(b["engine"].stats),
                  f"{tag}: PagedStats on the card == CPU")
            row["sweep"] = _sweep_equal(tag, sweep_trace(a["engine"], "cuda"),
                                        sweep_trace(b["engine"], "cpu"))
        out[batcher] = row
    return out


def dense_arch_full(name: str) -> tuple:
    """One dense config at full width with seeded random bf16 weights (cut
    in depth only if weights and DENSE_ARCH_RESERVE do not fit the free
    device memory, and then printed with why), served the serve phase's
    stream cut to DENSE_ARCH_REQUESTS requests x DENSE_ARCH_NEW tokens on
    native bf16 pages; granite-34b also on fp8 and int8 pages,
    speculatively (k 3, skip-2 draft) and densely (`BatchedServer`,
    `ContinuousBatcher`). Launch counts are set to 0 just before each path
    and read just after: each kernel's launches must equal layers x calls,
    every request gets its new tokens in the vocabulary, and each paged
    trace's card sweep equals the CPU sweep. Returns (fields, summed
    launches of the paths)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.examples.families_serving import sweep_trace
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM
    from repro_torch.params import init_params
    cfg = published = get_arch(name)
    free, total = torch.cuda.mem_get_info()
    emit("dense_archs_init", arch=name, mem_free_bytes=free,
         mem_total_bytes=total, weight_bytes=2 * cfg.param_count(),
         reserve_bytes=DENSE_ARCH_RESERVE)
    cut = None
    if 2 * cfg.param_count() + DENSE_ARCH_RESERVE > free:
        one = 2 * dataclasses.replace(cfg, num_layers=1).param_count()
        per_layer = 2 * dataclasses.replace(
            cfg, num_layers=2).param_count() - one
        layers = int((free - DENSE_ARCH_RESERVE - (one - per_layer))
                     // per_layer)
        check(layers >= 1, f"{name}: not one layer fits {free} bytes free")
        cfg = dataclasses.replace(cfg, num_layers=layers)
        cut = (f"{layers} of {published.num_layers} layers: "
               f"{2 * published.param_count()} bytes of bf16 weights and a "
               f"{DENSE_ARCH_RESERVE}-byte reserve exceed the {free} bytes "
               "free")
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, compute_dtype=torch.bfloat16, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out = dict(arch=name, layers=L, published_layers=published.num_layers,
               cut=cut, d_model=cfg.d_model,
               heads=f"H{cfg.num_heads} K{cfg.num_kv_heads} d{cfg.head_dim}",
               vocab=cfg.vocab_size, dtype="bfloat16",
               param_bytes=sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
               mem_free_bytes_before_init=free,
               init_s=time.perf_counter() - t0)
    prng = np.random.default_rng(SEED + 1)
    prompts = [prng.integers(0, cfg.vocab_size, int(n))
               for n in prompt_lengths()[:DENSE_ARCH_REQUESTS]]
    totals = {}

    def count(tag, counts, want):
        """Checks each kernel of `want` launched its layers x calls, adds
        the path's launches to `totals`; returns those of `want`."""
        for k, n in want.items():
            check(counts[k] == n, f"{name} {tag}: {k} launches {counts[k]} "
                  f"== layers x calls {n}")
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        return {k: counts[k] for k in want}

    def swept(tag, cb) -> dict:
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        table = sweep_trace(cb, "cuda")
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t
        bank = build.launch_counts()
        check(bank["exact_bank_stats"] > 0,
              f"{name} {tag}: the sweep launched exact_bank_stats")
        for k in ("exact_bank_stats", "bank_energy"):
            totals[k] = totals.get(k, 0) + bank[k]
        return dict(_sweep_equal(f"{name} {tag}", table,
                                 sweep_trace(cb, "cpu")),
                    sweep_s=sweep_s,
                    launches={k: bank[k] for k in ("exact_bank_stats",
                                                   "bank_energy")})

    kv_kernel = {"native": "paged_gqa_decode", "fp8": "paged_gqa_decode",
                 "int8": "paged_gqa_decode_quant"}
    for kv in ("native",) + (("fp8", "int8") if name == "granite-34b"
                             else ()):
        clock = {}
        cb, done, wall_s, counts = serve_full(
            model, params, prompts, kv, new_tokens=DENSE_ARCH_NEW,
            clock=clock)
        st = cb.stats
        steps = st.chunks * CHUNK_STEPS
        tr = cb.occupancy_bundle().traces["kv"]
        decode_s = wall_s - clock["prefill_s"]
        out[kv] = dict(
            requests=len(done), prompt_tokens=int(sum(map(len, prompts))),
            decode_tokens=st.decode_steps, decode_steps=steps,
            chunks=st.chunks, prefills=st.prefills, wall_s=wall_s,
            prefill_s=clock["prefill_s"],
            tokens_per_s=st.decode_steps / wall_s,
            # decode wall time (the batcher's host work included) per
            # device step, the admission prefills taken out
            ms_per_decode_step=1e3 * decode_s / steps,
            page_bytes=cb.page_bytes, peak_pages=st.peak_pages,
            trace_peak_bytes=tr.peak_needed(),
            launches=count(kv, counts, {kv_kernel[kv]: L * steps,
                                        "flash_attention": L * st.prefills}))
        check(all(counts[k] == 0 for k in set(kv_kernel.values())
                  - {kv_kernel[kv]}) and counts["paged_gqa_verify"] == 0,
              f"{name} {kv}: no other decode kernel launched")
        out[kv]["sweep"] = swept(kv, cb)
        del cb, done
    if name == "granite-34b":
        scb, sdone, spec_s, counts = serve_full(
            model, params, prompts, "native", speculate_k=SPEC_K,
            new_tokens=DENSE_ARCH_NEW)
        sst = scb.stats
        rounds = sst.chunks * scb.spec_rounds_per_chunk
        draft_layers = scb.draft_model.cfg.num_layers
        check(sst.accepted_tokens == sst.decode_steps,
              f"{name} spec: accepted tokens == decode tokens")
        check(scb.ledger.allocator.n_allocated == 0
              and int(scb.ledger.trace.as_arrays()[1][-1]) == 0,
              f"{name} spec: the allocator drains to 0")
        out["spec"] = dict(
            speculate_k=SPEC_K, draft_layers=draft_layers, rounds_run=rounds,
            spec_rounds=sst.spec_rounds, drafted_tokens=sst.drafted_tokens,
            accepted_tokens=sst.accepted_tokens,
            decode_tokens=sst.decode_steps, wall_s=spec_s,
            tokens_per_s=sst.decode_steps / spec_s,
            trace_peak_bytes=scb.occupancy_bundle().traces[
                "kv"].peak_needed(),
            launches=count("spec", counts, {
                "paged_gqa_verify": L * rounds,
                "paged_gqa_decode": draft_layers * (SPEC_K + 1) * rounds}))
        out["spec"]["sweep"] = swept("spec", scb)
        del scb, sdone
        dense = serve_dense(model, params, prompts)
        totals["gqa_decode"] = totals.get("gqa_decode", 0) + dense.pop(
            "launches")
        dense["server"]["ms_per_decode_step"] = (
            1e3 * dense["server"]["decode_s"] / (DENSE_NEW - 1))
        out["dense"] = dense
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t0
    del model, params
    torch.cuda.empty_cache()
    return out, totals


def dense_archs_phase(gen) -> tuple:
    """The four dense assigned configs: kernels 1, 5, 6, 7 and 2 at their
    shapes, each reduced (and granite at its group of 48) on the card
    against the CPU through the paged, speculative, batched and dense
    batchers, then each at full width. Returns (the phase's fields, the
    summed launches of the full-width paths, the kernel rows)."""
    t0 = time.perf_counter()
    krows = dense_arch_kernel_rows(gen)
    parity = {name: dense_arch_parity(name) for name in DENSE_ARCHS}
    parity["granite-34b group 48"] = dense_arch_parity("granite-34b", True)
    torch.cuda.empty_cache()
    full, launches = {}, {}
    for name in DENSE_ARCHS:
        full[name], counts = dense_arch_full(name)
        emit("dense_archs_full", **full[name])
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    def brief(f):
        out = {k: f[k] for k in ("layers", "cut", "param_bytes",
                                 "peak_device_bytes", "seconds")}
        for kv in ("native", "fp8", "int8", "spec"):
            if kv in f:
                out[kv] = {x: f[kv][x] for x in ("tokens_per_s",
                                                 "ms_per_decode_step")
                           if x in f[kv]}
        return out

    fields = dict(
        reduced=parity, full={n: brief(f) for n, f in full.items()},
        kernel_rows={k: [{x: r[x] for x in (
            "shape", "arch", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms") + tuple(
            x for x in ("device_ms", "library_device_ms", "pools") if x in r)}
            for r in v] for k, v in krows.items()},
        launches=launches, seconds=time.perf_counter() - t0)
    return fields, launches, krows


def roofline_phase(smi: str) -> tuple:
    """Measured steps against the H100 roofline, the host mesh and the dry
    run. For each of ROOFLINE_ARCHS at full width, kernel 2 (`flash_row`,
    bf16, B1 x S) and kernel 7 (`dense_row`, bf16, B rows of T) are first
    held against their plain versions at the steps' own shapes. Then
    `prefill` at ROOFLINE_PREFILL (kernel 2 in every layer) and
    `decode_step` at ROOFLINE_DECODE over a full dense cache of random rows
    (kernel 7 in every layer; the position is reset to the cache's last row
    before each call), each held to max(model_flops / PEAK_FLOPS,
    min_hbm_bytes / HBM_BW) of a `ShapeConfig` of its kind, batch and
    length on one card, less ROOFLINE_MARGIN, with launches counted from 0
    around the timed calls; one more call of each under torch.profiler
    gives the card's busy time (`device_busy_ms`). Then `make_host_mesh()`
    (a (1, 1) mesh over the card, a single-rank NCCL group destroyed
    after): the reduced dsr1d-qwen-1.5b's parameters placed on it by
    `template_shardings`; DTensors through `meshctx.constrain` and the
    windowed attention's `_constrain_chunks`, redistributed to the specs'
    placements with their values kept; and the reduced model's
    `BatchedServer` tokens under `use_mesh` against those without (its
    layers are full attention and its tensors plain, so this shows only
    that the context changes nothing). Then the dry run CLI (decode_32k on
    both production meshes) and the report CLI, in subprocesses. Returns
    (fields, launch counts of the timed calls, kernel rows)."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.kernels import build
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import DecoderLM, init_cache
    from repro_torch.models.attention import _constrain_chunks
    from repro_torch.models.meshctx import constrain, use_mesh
    from repro_torch.models.sharding import SERVE_RULES, template_shardings
    from repro_torch.params import (init_params, map_tree, param_axes,
                                    param_specs)
    from repro_torch.serve import BatchedServer, ServeConfig
    t_phase = time.perf_counter()
    calls = ROOFLINE_REPS + ROOFLINE_WARMUP
    counts = {"flash_attention": 0, "gqa_decode": 0}
    krows = {"flash_attention": [], "gqa_decode": []}
    steps = []
    for name in ROOFLINE_ARCHS:
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        krows["flash_attention"].append(flash_row(
            gen, name, cfg, ROOFLINE_PREFILL[1], ROOFLINE_PREFIX,
            torch.bfloat16))
        Bd, T = ROOFLINE_DECODE
        krows["gqa_decode"].append(dense_row(gen, name, cfg, [T] * Bd,
                                             torch.bfloat16, T=T))
        model = DecoderLM(cfg, compute_dtype=torch.bfloat16, device="cuda")
        params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
        B, S = ROOFLINE_PREFILL
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        logits, cache = model.prefill(params, {"tokens": tokens}, S)
        check(logits.shape == (B, 1, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"{name} prefill logits finite, (B, 1, V)")
        del logits, cache
        build.reset_launch_counts()
        prefill_ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens},
                                                   S),
                             reps=ROOFLINE_REPS, warmup=ROOFLINE_WARMUP)
        n = build.launch_counts()
        check(n["flash_attention"] == cfg.num_layers * calls,
              f"{name} prefill: kernel 2 launched {n['flash_attention']} == "
              f"layers x calls {cfg.num_layers * calls}")
        counts["flash_attention"] += n["flash_attention"]
        prefill_busy = device_busy_ms(
            lambda: model.prefill(params, {"tokens": tokens}, S))

        cache = init_cache(cfg, Bd, T, torch.bfloat16, "cuda")
        for e in cache["slots"] + cache["tail"]:
            for x in e.values():
                x.normal_(generator=gen)
        tok = torch.randint(0, cfg.vocab_size, (Bd, 1), generator=gen,
                            device="cuda", dtype=torch.int32)

        def decode():
            cache["pos"] = T - 1
            return model.decode_step(params, cache, tok)
        logits, _ = decode()
        check(logits.shape == (Bd, 1, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"{name} decode logits finite, (B, 1, V)")
        build.reset_launch_counts()
        decode_ms = cuda_ms(decode, reps=ROOFLINE_REPS,
                            warmup=ROOFLINE_WARMUP)
        n = build.launch_counts()
        check(n["gqa_decode"] == cfg.num_layers * calls,
              f"{name} decode: kernel 7 launched {n['gqa_decode']} == "
              f"layers x calls {cfg.num_layers * calls}")
        counts["gqa_decode"] += n["gqa_decode"]
        decode_busy = device_busy_ms(decode)

        for kind, (b, s), ms, busy in (
                ("prefill", ROOFLINE_PREFILL, prefill_ms, prefill_busy),
                ("decode", ROOFLINE_DECODE, decode_ms, decode_busy)):
            shape = ShapeConfig(f"{kind}_{s}", s, b, kind)
            flops = rl.model_flops(cfg, shape)
            nbytes = rl.min_hbm_bytes(cfg, shape, 1)
            ideal_ms = rl.ideal_seconds(cfg, shape, 1) * 1e3
            check(ms >= (1.0 - ROOFLINE_MARGIN) * ideal_ms,
                  f"{name} {kind}: measured {ms} ms below the roofline's "
                  f"ideal {ideal_ms} ms less {ROOFLINE_MARGIN:.0%}")
            steps.append(dict(
                arch=name, kind=kind, batch=b, seq_len=s, ms=ms,
                ideal_ms=ideal_ms, ratio=ms / ideal_ms,
                # one profiled call: the card's busy time, and its share of
                # the median step (None: the profiler saw no device event)
                device_busy_ms=busy,
                busy_share=None if busy is None else busy / ms,
                bound_by=("operations" if flops / rl.PEAK_FLOPS
                          >= nbytes / rl.HBM_BW else "bytes"),
                model_flops=flops, min_hbm_bytes=nbytes,
                kernel="flash_attention" if kind == "prefill"
                else "gqa_decode"))
        del model, params, cache, logits
    torch.cuda.empty_cache()

    # the host mesh: (1, 1) over the card; the reduced model placed on it
    # and served with and without it
    mesh = make_host_mesh()
    check(tuple(mesh.mesh.shape) == (1, 1) and mesh.device_type == "cuda"
          and mesh.mesh_dim_names == ("data", "model"),
          "make_host_mesh() is a (1, 1) (data, model) mesh over cuda")
    small = reduced(get_arch(ARCH), layers=2)
    sp = init_params(small, torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda")
    placed = map_tree(template_shardings(param_axes(small),
                                         param_specs(small), mesh,
                                         SERVE_RULES), sp,
                      lambda pl, x, _: distribute_tensor(x, mesh, pl))
    n_leaves = [0]

    def same(d, x, _):
        check(isinstance(d, DTensor) and torch.equal(d.to_local(), x),
              "a placed leaf's local shard is the leaf")
        n_leaves[0] += 1
    map_tree(placed, sp, same)
    del placed

    # a DTensor through the constraints: the windowed attention's chunks
    # (B, nc, W, K, G, h) and (B, nc, W, K, h); "pod" is not on the mesh
    both = [Replicate(), Replicate()]
    qc = torch.randn((2, 3, 4, 2, 3, 8), generator=gen, device="cuda")
    kc = torch.randn((2, 3, 4, 2, 8), generator=gen, device="cuda")
    dq, dk = (distribute_tensor(x, mesh, both) for x in (qc, kc))
    with use_mesh(mesh):
        cq, ck, cv = _constrain_chunks(dq, dk, dk)
        cx = constrain(dk, (("pod", "data"), None, "model"))
    for got, want, pl in ((cq, qc, (Shard(0), Shard(2))),
                          (ck, kc, (Shard(0), Replicate())),
                          (cv, kc, (Shard(0), Replicate())),
                          (cx, kc, (Shard(0), Shard(2)))):
        check(isinstance(got, DTensor) and tuple(got.placements) == pl
              and torch.equal(got.full_tensor(), want),
              f"constrain: placements {got.placements} == {pl}, values kept")
    sm = DecoderLM(small, compute_dtype=torch.float32, device="cuda")
    prompts = np.random.default_rng(SEED).integers(0, small.vocab_size,
                                                   (4, 24))

    def serve():
        srv = BatchedServer(sm, sp, ServeConfig(max_len=64,
                                                max_new_tokens=8))
        return srv.generate({"tokens": prompts})["tokens"]
    plain = serve()
    with use_mesh(mesh):
        meshed = serve()
    check(np.array_equal(plain, meshed),
          "reduced serve tokens under use_mesh == without")
    dist.destroy_process_group()
    host_mesh = dict(shape=list(mesh.mesh.shape), device=mesh.device_type,
                     placed_leaves=n_leaves[0], arch=small.name,
                     dtensors_constrained=4,
                     # full-attention layers on plain tensors: no constraint
                     # acts in this serve
                     tokens_equal_under_use_mesh=True)
    del sp, sm

    # the dry run and its report, in subprocesses (neither uses the card)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))

    def run(args):
        r = subprocess.run([sys.executable, "-m", *args], env=env,
                           capture_output=True, text=True, timeout=300)
        check(r.returncode == 0, f"{args[0]} exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
        return r.stdout
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.json"
        run(["repro_torch.launch.dryrun", "--arch", ARCH, "--shape",
             "decode_32k", "--mesh", "both", "--out", str(out)])
        cells = json.loads(out.read_text())
        report = run(["repro_torch.launch.report", str(out)])
    check([(c["status"], c.get("chips")) for c in cells]
          == [("OK", 256), ("OK", 512)],
          f"dry run cells OK on 256 and 512 chips: "
          f"{[(c['status'], c.get('chips')) for c in cells]}")
    check("cells: OK=2 SKIP=0 FAIL=0" in report, "report renders 2 OK cells")
    dryrun = dict(arch=ARCH, shape="decode_32k", wall_s=time.perf_counter()
                  - t0, cells=[dict(mesh=c["mesh"], chips=c["chips"],
                                    place_s=c["compile_s"],
                                    count_s=c["probe_s"],
                                    roofline={k: c["roofline"][k] for k in (
                                        "t_compute_ms", "t_memory_ms",
                                        "t_collective_ms", "dominant",
                                        "roofline_fraction")})
                               for c in cells])
    return (dict(nvidia_smi=smi, peak_flops=rl.PEAK_FLOPS,
                 hbm_bw=rl.HBM_BW, link_bw=rl.LINK_BW,
                 margin=ROOFLINE_MARGIN, reps=ROOFLINE_REPS, steps=steps,
                 host_mesh=host_mesh, dryrun=dryrun, launches=counts,
                 kernel_rows=krows, seconds=time.perf_counter() - t_phase),
            counts, krows)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["dense_archs", "families", "encdec",
                                       "train", "roofline"],
                    help="build the kernels and run this phase alone (no "
                         "summary, no last line)")
    args = ap.parse_args()
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
    if args.only == "dense_archs":
        emit("dense_archs", **dense_archs_phase(gen)[0])
        return
    if args.only == "families":
        emit("families", **families_phase(gen)[0])
        return
    if args.only == "encdec":
        emit("encdec", **encdec_phase(gen)[0])
        return
    if args.only == "train":
        emit("train", **train_phase())
        return
    if args.only == "roofline":
        emit("roofline", **roofline_phase(smi)[0])
        return
    rows = kernel_phase(gen)
    emit("kernels", **rows)

    # ---- dense_archs: qwen2-7b, tinyllama, deepseek-coder-33b, granite-34b
    # reduced on the card against the CPU, then at full width; first, while
    # nothing else holds device memory, so that the 33B models fit whole ----
    torch.cuda.empty_cache()
    dense_archs, da_launches, da_rows = dense_archs_phase(gen)
    emit("dense_archs", **dense_archs)

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
    emit("reference_prefix", **reference_prefix())

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
         launches=serve_counts, paged_steps=vars(model.step_counts))

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
         draft_paged_steps=vars(scb.draft_model.step_counts),
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

    # ---- serve_prefix: prefix cache, chunked prefill, priority preemption --
    prefix_fields, prefix_counts = serve_prefix(model, params)
    emit("serve_prefix", **prefix_fields)

    # ---- traffic: the traffic campaigns, Stage II on the card vs CPU ----
    traffic, traffic_counts = traffic_phase()
    emit("traffic", **traffic)

    # ---- serve_obs: the prefix serve with telemetry and a meter ----
    obs_fields, obs_counts = serve_obs(model, params)
    emit("serve_obs", **obs_fields)

    # ---- stage1: the paper's flow, Stage I on the host, Stage II here ----
    stage1, stage1_launches, horizon_rows = stage1_phase()
    emit("stage1", **stage1)

    # ---- families: MoE, windowed, recurrent and VLM decoders, reduced on
    # the card against the CPU, then at full width, each path counted ----
    del model, params
    torch.cuda.empty_cache()
    families, fam_launches, fam_rows = families_phase(gen)
    emit("families", **families)

    # ---- encdec: seamless-m4t served, kernel 2 without its causal mask ----
    encdec, encdec_launches, encdec_rows = encdec_phase(gen)
    emit("encdec", **encdec)

    # ---- train: reduced on the card vs CPU, full-width tinyllama CLI ----
    emit("train", **train_phase())

    # ---- roofline: measured prefill and decode against the H100 roofline,
    # the host mesh, the dry run and its report ----
    roofline, roofline_counts, roofline_rows = roofline_phase(smi)
    emit("roofline", **roofline)

    def fam_row(r):
        return {k: r[k] for k in ("shape", "arch", "max_abs_err", "ms",
                                  "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms") if k in r}

    def dense_archs_fields(name):
        return dict(dense_archs_launches=da_launches.get(name, 0),
                    dense_archs_rows=[fam_row(r) for r in da_rows[name]])

    offset = rows["flash_attention_offset"]
    flash = dict(
        rows["flash_attention"][0],
        prefix_serve_launches=prefix_counts["flash_attention"],
        serve_obs_launches=obs_counts["flash_attention"],
        offset_cases=dict(
            cases=len(offset),
            max_abs_err=max(r["max_abs_err"] for r in offset),
            offset0_rows_max_abs_diff=max(r["offset0_rows_max_abs_diff"]
                                          for r in offset),
            # the largest bf16 case: q_offset 384, 256 suffix rows
            largest={k: offset[len(FLASH_OFFSETS) * len(FLASH_SUFFIXES) - 1][k]
                     for k in ("shape", "dtype", "offset_ms",
                               "offset_device_ms", "library_offset_ms",
                               "library_offset_device_ms", "bound_ms",
                               "bound_by")}))
    flash.update(roofline_launches=roofline_counts["flash_attention"],
                 roofline_rows=[fam_row(r)
                                for r in roofline_rows["flash_attention"]],
                 dense_archs_launches=da_launches["flash_attention"],
                 dense_archs_rows=[fam_row(r)
                                   for r in da_rows["flash_attention"]],
                 families_launches=fam_launches["flash_attention"],
                 families_rows=[fam_row(r)
                                for r in fam_rows["flash_attention"]],
                 encdec_launches=encdec_launches["flash_attention"],
                 noncausal_cases=[dict(fam_row(r), dtype=r["dtype"],
                                       variant=r["variant"])
                                  for r in encdec_rows["noncausal"]])
    kernels = []
    for name, row in (("paged_gqa_decode",
                       dict(rows["paged_gqa_decode"][0],
                            **dense_archs_fields("paged_gqa_decode"),
                            serve_obs_launches=obs_counts[
                                "paged_gqa_decode"],
                            families_launches=fam_launches[
                                "paged_gqa_decode"],
                            families_rows=[fam_row(r) for r in fam_rows[
                                "paged_gqa_decode"]])),
                      ("flash_attention", flash),
                      ("paged_gqa_decode_quant",
                       dict(rows["paged_gqa_decode_quant"][0],
                            **dense_archs_fields("paged_gqa_decode_quant"))),
                      ("int8_matmul", rows["int8_matmul"][0]),
                      ("exact_bank_stats",
                       dict(bank_main["exact_bank_stats"], dtype="float64",
                            scan_launches=launches["running_time"],
                            traffic_launches=traffic_counts[
                                "exact_bank_stats"],
                            stage1_launches=stage1_launches[
                                "exact_bank_stats"],
                            stage1_decode_horizon=horizon_rows[
                                "exact_bank_stats"],
                            families_launches=fam_launches[
                                "exact_bank_stats"],
                            encdec_launches=encdec_launches[
                                "exact_bank_stats"])),
                      ("bank_energy",
                       dict(bank_main["bank_energy"], dtype="float64",
                            traffic_launches=traffic_counts["bank_energy"],
                            stage1_launches=stage1_launches["bank_energy"],
                            stage1_decode_horizon=horizon_rows[
                                "bank_energy"],
                            families_launches=fam_launches["bank_energy"],
                            encdec_launches=encdec_launches["bank_energy"])),
                      ("paged_gqa_verify",
                       dict(rows["paged_gqa_verify"][0],
                            **dense_archs_fields("paged_gqa_verify"))),
                      ("gqa_decode", dict(
                          rows["gqa_decode"][0],
                          **dense_archs_fields("gqa_decode"),
                          families_launches=fam_launches["gqa_decode"],
                          families_rows=[fam_row(r) for r in fam_rows[
                              "gqa_decode"]],
                          encdec_launches=encdec_launches["gqa_decode"],
                          roofline_launches=roofline_counts["gqa_decode"],
                          roofline_rows=[fam_row(r) for r in roofline_rows[
                              "gqa_decode"]],
                          encdec_rows=[fam_row(r) for r in encdec_rows[
                              "gqa_decode"]]))):
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
                                         "stage1_decode_horizon",
                                         "prefix_serve_launches",
                                         "traffic_launches",
                                         "serve_obs_launches",
                                         "offset_cases",
                                         "dense_archs_launches",
                                         "dense_archs_rows",
                                         "families_launches",
                                         "families_rows",
                                         "encdec_launches",
                                         "noncausal_cases", "encdec_rows",
                                         "roofline_launches",
                                         "roofline_rows")
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
               speculate_k=None, new_tokens: int = NEW_TOKENS,
               clock: dict = None):
    """The full-width stream through one batcher with `kv_dtype` pages (and
    speculation when `speculate_k` is set: the pool then holds both lanes),
    launch counts set to 0 just before and read just after. Checks that
    every request finished with `new_tokens` in-vocab tokens and that each
    admission ran the prefill kernel once per layer (of the draft too).
    With `clock`, the target's prefills are synchronised and their seconds
    summed into clock["prefill_s"]. The paged decode steps (the draft's
    when speculating) must be CUDA-graph replays after the warm-up, from
    one capture (`step_counts`, set to 0 before). Returns (batcher,
    finished requests by rid, wall seconds, launch counts)."""
    from repro_torch.kernels import build
    from repro_torch.models.paged_graph import StepCounts
    from repro_torch.serve import PagedContinuousBatcher, Request
    cfg = model.cfg
    per_slot = -(-(PROMPT_MAX + new_tokens - 1 + (speculate_k or 0))
                 // PAGE_SIZE)
    lanes = 1 if speculate_k is None else 2
    cb = PagedContinuousBatcher(
        model, params, num_slots=SLOTS, page_size=PAGE_SIZE,
        num_pages=lanes * SLOTS * per_slot + 1, max_pages_per_slot=per_slot,
        chunk_steps=CHUNK_STEPS, kv_dtype=kv_dtype, speculate_k=speculate_k)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=new_tokens))
    if clock is not None:
        clock["prefill_s"] = 0.0
        prefill = model.prefill

        def timed_prefill(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = prefill(*a, **kw)
            torch.cuda.synchronize()
            clock["prefill_s"] += time.perf_counter() - t
            return out
        model.prefill = timed_prefill   # this instance only, removed below
    stepper = model if speculate_k is None else cb.draft_model
    stepper.step_counts = StepCounts()
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = sorted(cb.run(), key=lambda r: r.rid)
        torch.cuda.synchronize()
    finally:
        if clock is not None:
            del model.prefill
    wall_s = time.perf_counter() - t0
    counts = build.launch_counts()
    st = cb.stats
    tag = kv_dtype if speculate_k is None else f"{kv_dtype} spec"
    check(len(done) == len(prompts) and st.finished == len(prompts),
          f"{tag}: all requests finished")
    check(all(len(r.output) == new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.output)
              for r in done),
          f"{tag}: every request has its new tokens, in the vocabulary")
    layers = cfg.num_layers
    if speculate_k is not None:
        layers += cb.draft_model.cfg.num_layers
    check(counts["flash_attention"] == layers * st.prefills,
          f"{tag}: prefill launches == layers x prefills")
    steps = st.chunks * CHUNK_STEPS if speculate_k is None else (
        st.chunks * cb.spec_rounds_per_chunk * (speculate_k + 1))
    check_graphed(tag, stepper.step_counts, steps)
    return cb, done, wall_s, counts


def check_graphed(tag: str, counts, steps: int) -> None:
    """`steps` paged decode steps of one new batcher: the warm-up's eager
    steps, one capture, every later step a replay."""
    from repro_torch.models.paged_graph import WARMUP_STEPS, StepCounts
    eager = min(steps, WARMUP_STEPS)
    want = StepCounts(captures=int(steps > eager), replays=steps - eager,
                      eager=eager)
    check(counts == want, f"{tag}: paged steps {counts} == {want}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
