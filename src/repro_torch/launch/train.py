"""Training launcher of the port: builds the model, optimizer and data from
an arch config and runs the fault-tolerant loop (the reference's
`repro/launch/train.py`, with `--device`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 200 --batch 8 --seq 64 [--device cpu]

On the card (the default device) the loss runs plain PyTorch, full
attention included (`models.attention.blocked_attention`), as the
reference's loss runs jnp; no kernel of the port lies on this path.
Checkpoints go under `--ckpt-dir`, by default a
directory in the system's temporary directory, outside the repository.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch, reduced as make_reduced
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train import LoopConfig, TrainLoop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8ef"])
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(cfg, compute_dtype=torch.float32, remat="none",
                        device=args.device)
    opt = AdamW(lr=cosine_with_warmup(args.lr, args.steps // 10, args.steps))
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))
    loop = TrainLoop(model, opt, data, LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, compression=args.compression),
        fail_at_step=args.fail_at)
    out = loop.run()
    h = out["history"]
    print(f"steps {h[0]['step']}..{h[-1]['step']}  "
          f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}  "
          f"stragglers={len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
