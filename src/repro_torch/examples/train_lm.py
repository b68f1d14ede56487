"""End-to-end training walkthrough of the port: train a ~100M-parameter
GQA LM with the whole substrate (deterministic data pipeline, AdamW with a
cosine schedule, asynchronous atomic checkpoints, the straggler monitor)
and a mid-run preemption and recovery (the reference's
`examples/train_lm.py`).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \
          [--steps 300] [--device cpu]

On the card (the default) the loss runs plain PyTorch, attention included
(`models.attention.blocked_attention`), as the reference's runs jnp.
Checkpoints go under `--ckpt-dir`, by default a directory in the system's
temporary directory, outside the repository; it is emptied first.
"""
import argparse
import os
import shutil
import tempfile
from dataclasses import replace

import torch

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train import LoopConfig, TrainLoop


def small_lm():
    """~100M-parameter tinyllama-family config."""
    base = get_arch("tinyllama-1.1b")
    return replace(base, name="tinyllama-100m", num_layers=4, d_model=512,
                   num_heads=8, num_kv_heads=2, head_dim=64, d_ff=1536,
                   vocab_size=32000, max_seq_len=1024)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = small_lm()
    model = build_model(cfg, compute_dtype=torch.float32, remat="none",
                        device=args.device)
    print(f"model: {cfg.name}  ~{cfg.param_count() / 1e6:.0f}M params")

    opt = AdamW(lr=cosine_with_warmup(1e-3, args.steps // 10, args.steps),
                weight_decay=0.01)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch, seed=42))
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=50,
                          ckpt_dir=args.ckpt_dir, log_every=25)

    # ---- phase 1: run until an injected preemption at 60% ----
    fail_at = int(args.steps * 0.6)
    print(f"phase 1: training with injected preemption at step {fail_at}")
    try:
        TrainLoop(model, opt, data, loop_cfg, fail_at_step=fail_at).run()
    except RuntimeError as e:
        print(f"  !! {e}; restarting from the latest checkpoint")

    # ---- phase 2: restart; the loop resumes from the checkpoint ----
    out = TrainLoop(model, opt, data, loop_cfg).run()
    hist = out["history"]
    print(f"phase 2: resumed at step {hist[0]['step']}")
    for h in hist[::25] + [hist[-1]]:
        flag = " STRAGGLER" if h["straggler"] else ""
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"{h['time_s'] * 1e3:6.1f} ms{flag}")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'OK: decreasing' if last < first else 'WARN: not decreasing'})")
    return out


if __name__ == "__main__":
    main()
