"""Run one cell of the port's benchmark once, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell,
its configuration, traffic mix and metrics are found by name
(`portbench/harness/spec.py`), each metric read from the run's record by
its own reader. With `--trace 0` the result carries the cell's end-to-end
metrics; with `--trace 1` its per-layer metrics, the
traced window's device busy time and a breakdown. The last line of
standard output is one JSON object; the numbers that decide `correct`
come last in it, and as the last lines of standard error. Without a CUDA
device, with fewer cards than the cell asks for, or with JAX loaded in the
process once the window has closed, the run prints no result and exits
with a code other than 0. Build and kernel caches stay inside the
checkout (`build/`)."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels already build into `build/kernels/`)."""
    b = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(b / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(b / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(b / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: `repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches(ROOT)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from portbench.harness.serve import log, run_cell
    from portbench.harness.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"no program to measure: {ROOT / 'src' / 'repro_torch'} is "
            "missing from the checkout")
        return 3
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and never "
            "falls back to the CPU")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        log(f"modules of JAX or the JAX package loaded: {loaded}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"]}
    rec = res["record"]
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = m.reader(rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out.update(metrics=metrics, device=device,
                   breakdown=tr["breakdown"])
        log(f"traced run: {res['tok_s']:.1f} tokens/s, set-up "
            f"{res['setup_s']:.3f} s")
    else:
        metrics = {m.name: {"value": m.reader(rec), "unit": m.unit}
                   for m in cell.end_to_end}
        empty = [k for k, v in metrics.items() if v["value"] is None]
        if empty:
            log(f"end-to-end metrics with nothing to read in "
                f"{args.workload}: {empty}")
            return 5
        out.update(metrics=metrics, device=device)
    out["checks"] = res["checks"]
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
