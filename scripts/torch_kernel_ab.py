"""Time the PyTorch port's paged decode, verify and int8 kernels of two
source trees in one run, on one card, in turns (for example parent,
change, change, parent).

    python scripts/torch_kernel_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout of this repository (a `git archive` of
another commit unpacked anywhere, or `.`). For each, in the order given, a
subprocess puts TREE/src first on the path, builds that tree's kernels
(into TREE/build/kernels) and times, at the shapes `chip_smoke.py` gives
them (8 slots of dsr1d-qwen-1.5b mid-decode, bf16 query):

* `paged_gqa_decode` (Pallas kernel 1) on bf16 and on fp8 pools;
* `paged_gqa_decode_quant` (Pallas kernel 5) on int8 pools with per-row
  scales;
* `paged_gqa_verify` (Pallas kernel 6), k 3 (4 window rows), on bf16 and
  on fp8 pools;
* `gqa_decode` (Pallas kernel 7) on a bf16 dense cache of 640 rows, the
  dense serve's, through the (B, K, T, d) view the decode step passes;
* `int8_matmul` (Pallas kernel 8) at the int8 SwiGLU's two shapes, with
  `torch._int_mm` plus the same epilogue as the yardstick.

Inputs come from the same seeded generator in every subprocess. Each case
reports `device_ms` (a CUDA graph of 20 calls) and `ms` (CUDA events
around one call), as `chip_smoke.py` times them. One JSON line per tree and
run, then a summary line with the card's `nvidia-smi` name and power
limit; `--out` also writes the lines to FILE. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def measure(tree: Path) -> dict:
    """The timings of one tree, in this process (which must not have
    imported `repro_torch` yet)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.int8_matmul import (int8_matmul, quantize_cols,
                                                 quantize_rows)
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode, paged_gqa_decode_quant)
    from repro_torch.kernels.paged_gqa_verify import paged_gqa_verify
    from repro_torch.kernels.quant import quantize_page_rows, to_fp8_codes
    # the port is imported from `tree` first, so chip_smoke's own path
    # entry, added when it is imported, leaves it in place
    sys.path.insert(1, str(REPO))
    import chip_smoke as cs
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cfg = get_arch(cs.ARCH)
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lengths = cs.prompt_lengths()
    dec_lens = np.r_[1, lengths[1:cs.SLOTS] + cs.NEW_TOKENS // 2]
    per_slot = -(-(cs.PROMPT_MAX + cs.NEW_TOKENS) // cs.PAGE_SIZE)
    V = cs.SPEC_K + 1
    bf16 = torch.bfloat16
    paged = f"H{H} K{K} d{d} ps{cs.PAGE_SIZE}"
    cases = []    # (kernel, pools, shape, function, arguments)
    for kernel, fn, window in (("paged_gqa_decode", paged_gqa_decode, 0),
                               ("paged_gqa_verify", paged_gqa_verify, V)):
        q, kf, vf, table, lens = cs.decode_case(
            gen, cs.SLOTS, H, K, d, dec_lens + window, torch.float32,
            cs.SLOTS * per_slot + 1)
        shape = f"B{cs.SLOTS} {paged} ctx{int(lens.sum())}"
        if window:    # V window rows after base = lens - V
            q = torch.randn((cs.SLOTS, V, H, d), generator=gen,
                            device="cuda")
            lens = (lens - V).clamp(min=0)
            ctx = int(lens.sum()) + cs.SLOTS * V    # context plus window
            shape = f"B{cs.SLOTS} V{V} {paged} ctx{ctx}"
        for pools, kv in (("bf16", (kf.to(bf16), vf.to(bf16))),
                          ("fp8", (to_fp8_codes(kf), to_fp8_codes(vf)))):
            cases.append((kernel, pools, shape, fn,
                          (q.to(bf16), *kv, table, lens)))
        if not window:
            (kp, ks), (vp, vs) = quantize_page_rows(kf), quantize_page_rows(vf)
            cases.append(("paged_gqa_decode_quant", "int8", shape,
                          paged_gqa_decode_quant,
                          (q.to(bf16), kp, vp, ks, vs, table, lens)))
    T = cs.DENSE_MAX_LEN
    kc, vc = (torch.randn((cs.SLOTS, T, K, d), generator=gen, device="cuda")
              .to(bf16).transpose(1, 2) for _ in range(2))
    lens = torch.as_tensor(np.r_[lengths[:cs.SLOTS - 1] + cs.NEW_TOKENS // 2,
                                 T], dtype=torch.int32, device="cuda")
    q = torch.randn((cs.SLOTS, H, d), generator=gen, device="cuda").to(bf16)
    cases.append(("gqa_decode", "dense bf16",
                  f"B{cs.SLOTS} T{T} H{H} K{K} d{d} ctx{int(lens.sum())}",
                  gqa_decode, (q, kc, vc, lens)))
    rows = [dict(kernel=kernel, pools=pools, shape=shape,
                 device_ms=cs.graph_ms(lambda: fn(*args)),
                 ms=cs.cuda_ms(lambda: fn(*args)))
            for kernel, pools, shape, fn, args in cases]
    M = int(lengths.max())
    for K, N in cs.FFN_SHAPES:
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        (xq, sx), (wq, sw) = quantize_rows(x), quantize_cols(w)
        rows.append(dict(kernel="int8_matmul", shape=f"M{M} K{K} N{N}",
                         **cs.timed(lambda: int8_matmul(xq, wq, sx, sw),
                                    lambda: torch._int_mm(xq, wq).float()
                                    * sx * sw)))
    return dict(tree=str(tree), kind=torch.cuda.get_device_name(0),
                rows=rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(measure(a.trees[0].resolve())), flush=True)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = []
    for i, tree in enumerate(a.trees):
        res = subprocess.run([sys.executable, __file__, "--one",
                              str(tree.resolve())], capture_output=True,
                             text=True, check=True)
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["turn"] = i
        lines.append(json.dumps(got))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"nvidia_smi": smi, "trees": [
        str(t) for t in a.trees]}))
    print(lines[-1], flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
