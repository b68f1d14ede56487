"""int8 quantized serving path on the port: int8 weights and activations
through the hand-written int8 matmul kernel (`kernels.int8_matmul`), which
halves the weight bytes a decode step must stream. Counterpart of the
reference's `examples/int8_serving.py`.

Quantizes dsr1d-qwen's SwiGLU FFN and compares the int8 forward of layer 0
with the float FFN (`models.ffn.apply_ffn`), then the end-to-end logit
error and top-1 agreement of a prefill whose weights are all fake-quantized
to int8 (per column).

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.int8_serving
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.int8_serving \
                       --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.int8_matmul import quantized_linear
from repro_torch.models import DecoderLM
from repro_torch.models.ffn import apply_ffn
from repro_torch.models.transformer import layer
from repro_torch.params import init_params


def quantized_ffn(p_ffn: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU with every matmul through the int8 kernel (its plain version
    on the CPU): activations quantized per row, weights per column. x:
    (B, S, D) -> (B, S, D) float32."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    g = F.silu(quantized_linear(x2, p_ffn["w_gate"]))
    u = quantized_linear(x2, p_ffn["w_up"])
    out = quantized_linear((g * u).to(x.dtype), p_ffn["w_down"])
    return out.reshape(B, S, -1)


def fake_quant(w: torch.Tensor) -> torch.Tensor:
    """Round a float weight of rank >= 2 to int8 steps per column (along
    axis -2) and back; other tensors pass through."""
    if w.dim() < 2 or not w.is_floating_point():
        return w
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127) * s


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true",
                    help="the config's published widths (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_arch("dsr1d-qwen-1.5b")
    if not args.full_width:
        cfg = reduced(cfg)
    dtype = torch.bfloat16 if args.full_width else torch.float32
    model = DecoderLM(cfg, compute_dtype=dtype, device=args.device)
    dev = model.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev, dtype=dtype)
    rng = np.random.default_rng(args.seed)

    # --- per-layer FFN comparison ------------------------------------------
    ffn0 = layer(params["blocks"][0], 0)["ffn"]
    x = torch.as_tensor(rng.standard_normal((2, 32, cfg.d_model)),
                        dtype=dtype, device=dev)
    fp = apply_ffn(cfg, ffn0, x).float()
    q8 = quantized_ffn(ffn0, x)
    rel = float(torch.linalg.norm(q8 - fp) / torch.linalg.norm(fp))
    print(f"{cfg.name} ({dtype}, {dev}): FFN int8 vs {dtype} relative L2 "
          f"error: {rel:.4f}")

    # --- end-to-end logits: swap all weights with fake-quantized copies ----
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                             device=dev)
    logits_fp, _ = model.prefill(params, {"tokens": tokens}, 48)
    logits_q8, _ = model.prefill(_tree_map(fake_quant, params),
                                 {"tokens": tokens}, 48)
    err = float((logits_q8.float() - logits_fp.float()).abs().max())
    agree = float((logits_q8.argmax(-1) == logits_fp.argmax(-1))
                  .float().mean())
    print(f"end-to-end (all weights int8-fake-quantized): "
          f"max|dlogit|={err:.3f}  top-1 agreement={agree * 100:.0f}%")

    # weight-bytes saving for the decode roofline
    n = cfg.param_count()
    print(f"weight bytes: bf16 {2 * n / 1e6:.1f} MB -> int8 {n / 1e6:.1f} MB "
          f"(decode mandatory-bytes term halves)")


if __name__ == "__main__":
    main()
