"""Readings that a cell's correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n,...> [--fp8-pages-seeds <n,...>] [--fault <name>] \
        [--out <file.jsonl>]

For each seed of `--seeds`, one process runs the cell as the benchmark does
(a shorter window: long enough to finish the mix's longest requests) and
prints the program's numbers beside the float8 control's on the same
sample (`control`). For each seed of `--fp8-pages-seeds` it also
runs the program with its own fp8 KV-page path switched on, a second
control. With `--fault`, every run of `--seeds` has that fault of
`harness/faults.py` planted in the timed path instead, and reads no
control. One JSON object per run goes to standard output and `--out`. The
benchmark's own runs never run this."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fp8-pages-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import pin_caches
    pin_caches(ROOT)
    import torch
    from portbench.harness.faults import FAULTS
    from portbench.harness.serve import run_cell
    from portbench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(ROOT, args.workload)
    fp8 = dataclasses.replace(cell, config={**cell.config, "kv_dtype": "fp8"})
    hook = FAULTS[args.fault] if args.fault else None
    runs = [(cell, int(s), hook) for s in args.seeds.split(",") if s]
    runs += [(fp8, int(s), None) for s in args.fp8_pages_seeds.split(",")
             if s]
    out = open(args.out, "a") if args.out else None
    try:
        for c, seed, fault in runs:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            r = run_cell(c, seed, args.seconds, False, device="cuda",
                         hook=fault, control=fault is None)
            row = {"workload": args.workload, "seed": seed,
                   "kv_dtype": c.config["kv_dtype"],
                   "fault": fault and fault.__name__, "correct": r["correct"],
                   "readings": r["readings"], "control": r["control"],
                   "sample_tokens": r["sample_tokens"], "tok_s": r["tok_s"],
                   "attempted": r["attempted"],
                   "memory_peak_bytes": r["memory_peak_bytes"],
                   "run_s": time.perf_counter() - t,
                   "card": torch.cuda.get_device_name(0)}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
