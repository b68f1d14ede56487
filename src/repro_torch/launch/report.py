"""Render the dry run's JSON (`launch/dryrun.py --out`) as the §Dry-run and
§Roofline tables; port of the reference's `repro/launch/report.py`. The
ideal time is each cell's `t_ideal_ms`, which `launch/roofline.py` computes
on the H100 constants.

Usage: PYTHONPATH=src python -m repro_torch.launch.report dryrun.json
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}G"


def dryrun_table(cells) -> str:
    out = ["| arch | shape | mesh | status | place s | count s | "
           "peak memory/dev | coll bytes/dev | notes |",
           "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        r = c.get("roofline", {})
        peak = r.get("peak_memory_per_device")
        coll = r.get("coll_bytes_per_device")
        note = c.get("reason", "") or c.get("error", "")
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['status']} | "
            f"{c.get('compile_s', '-')} | {c.get('probe_s', '-')} | "
            f"{fmt_bytes(peak)} | {fmt_bytes(coll)} | {note} |")
    return "\n".join(out)


def roofline_table(cells) -> str:
    out = ["| arch | shape | mesh | t_comp ms | t_mem ms | t_coll ms | "
           "dominant | useful | t_ideal ms | roofl% |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["status"] != "OK":
            continue
        r = c["roofline"]
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{r['t_compute_ms']:.1f} | {r['t_memory_ms']:.1f} | "
            f"{r['t_collective_ms']:.1f} | {r['dominant']} | "
            f"{r['useful_flops_ratio']:.2f} | {r['t_ideal_ms']:.1f} | "
            f"{r['roofline_fraction']*100:.1f} |")
    return "\n".join(out)


def summarize(cells) -> str:
    ok = [c for c in cells if c["status"] == "OK"]
    skip = [c for c in cells if c["status"] == "SKIP"]
    fail = [c for c in cells if c["status"] == "FAIL"]
    doms = {}
    for c in ok:
        doms[c["roofline"]["dominant"]] = doms.get(
            c["roofline"]["dominant"], 0) + 1
    worst = sorted(ok, key=lambda c: c["roofline"]["roofline_fraction"])[:5]
    most_coll = sorted(ok, key=lambda c: -c["roofline"]["t_collective_ms"])[:5]
    lines = [f"cells: OK={len(ok)} SKIP={len(skip)} FAIL={len(fail)}",
             f"dominant terms: {doms}",
             "worst roofline fraction: "
             + ", ".join(f"{c['arch']}/{c['shape']}/{c['mesh']}"
                         f"={c['roofline']['roofline_fraction']*100:.1f}%"
                         for c in worst),
             "most collective-bound: "
             + ", ".join(f"{c['arch']}/{c['shape']}/{c['mesh']}"
                         f"={c['roofline']['t_collective_ms']:.0f}ms"
                         for c in most_coll)]
    return "\n".join(lines)


def main() -> None:
    path = sys.argv[1]
    with open(path) as f:
        cells = json.load(f)
    print("## §Dry-run\n")
    print(summarize(cells))
    print()
    print(dryrun_table(cells))
    print("\n## §Roofline\n")
    print(roofline_table(cells))


if __name__ == "__main__":
    main()
