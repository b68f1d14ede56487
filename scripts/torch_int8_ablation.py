"""Where the int8 matmul kernel's time goes: build timing-only variants of
`src/repro_torch/csrc/int8_matmul.cu` that each drop one stage, and time
them beside the kernel itself on one card.

    python scripts/torch_int8_ablation.py [--out FILE]

Variants (each a text edit of the source, which must apply exactly once):
`kernel` (unchanged), `no_mma` (the consumers skip the tensor-core
products but still load their fragments), `no_transpose` (the producers
skip the w transposes), `no_copy` (the producers issue no copies of x or
w) and `no_epilogue` (the consumers write nothing). Only `kernel` computes
the product: the others are for timing. Each is compiled with the flags
`repro_torch.kernels.build` uses into build/ablation/ and timed at the
int8 SwiGLU's two shapes (`chip_smoke.py`'s FFN_SHAPES, M = the longest
prompt) as device time per call from a CUDA graph of 20 calls, split as
the wrapper splits it. Prints one JSON line per variant and shape, then
the card's `nvidia-smi` name and power limit; `--out` also writes them to
FILE. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(1, str(REPO))

VARIANTS = {
    "kernel": [],
    "no_mma": [("          mma_s8(acc[mt][nt], af, bf[nt][0], bf[nt][1]);",
                "          acc[mt][nt][0] ^= af[0] ^ bf[nt][0];")],
    "no_transpose": [("        transpose_b(b_sh + ts",
                      "        if (M < 0) transpose_b(b_sh + ts")],
    "no_copy": [("        load_tile<kVec>(a_sh + st",
                 "        if (M < 0) load_tile<kVec>(a_sh + st"),
                ("        load_tile<kVec>(raw_sh + st",
                 "        if (M < 0) load_tile<kVec>(raw_sh + st")],
    "no_epilogue": [("  const bool pair = (N & 1) == 0;",
                     "  if (N > 0) return;\n"
                     "  const bool pair = (N & 1) == 0;")],
}


def build_variants(out_dir: Path) -> dict:
    """Compile every variant in parallel; returns {name: library path}."""
    from repro_torch.kernels import build
    src = (build.CSRC / "int8_matmul.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit does not apply once: {old}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.int8_matmul import (quantize_cols,
                                                 quantize_rows, split_k)
    if not torch.cuda.is_available():
        sys.exit("torch_int8_ablation: no CUDA device available")
    libs = build_variants(REPO / "build" / "ablation")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    M = int(cs.prompt_lengths().max())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    P, I = ctypes.c_void_p, ctypes.c_int
    lines = []
    for K, N in cs.FFN_SHAPES:
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        (xq, sx), (wq, sw) = quantize_rows(x), quantize_cols(w)
        splits = split_k(M, N, K, sms)
        out = torch.empty((M, N), device="cuda")
        acc = torch.empty((M, N), dtype=torch.int32, device="cuda")
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).int8_matmul_fwd
            fn.argtypes = [P, P, P, P, P, P, I, I, I, I, P]

            def call(fn=fn):
                rc = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                        sw.data_ptr(), out.data_ptr(), acc.data_ptr(), M, N,
                        K, splits, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            lines.append(json.dumps(dict(
                variant=name, shape=f"M{M} K{K} N{N}", split_k=splits,
                device_ms=cs.graph_ms(call))))
            print(lines[-1], flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines.append(smi)
    print(smi, flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
