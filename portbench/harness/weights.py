"""Random bfloat16 weights from the run's seed, made on the device, and the
view of them that the program takes.

The benchmark's layout (read by `reference.decoder`) holds each kind of
leaf stacked over the layers, norm gains as gains:

    embed (rows, D)      token embedding; rows >= vocab (the program pads
                         its vocabulary), the reference reads the first vocab
    pos (P, D)           gpt2: learned positions
    wq (L, D, H d), wk and wv (L, D, K d), wo (L, H d, D)
    bq, bk, bv (L, .)    qwen2: q/k/v biases
    ln1_g, ln2_g (L, D)  norm gains; gpt2 also ln1_b, ln2_b
    w_gate, w_up (L, D, F), w_down (L, F, D)   (qwen2's SwiGLU)
    w_up (L, D, F), b_up (L, F), w_down (L, F, D), b_down (L, D)   (gpt2)
    lnf_g (D,), gpt2 also lnf_b
    head (D, rows)       an untied LM head; the reference reads the first
                         vocab columns

Each leaf is one draw from a `torch.Generator` on the device, in the order
of `_leaves`, so the same seed gives the same weights."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.decoder import Shape

WEIGHT_DTYPE = torch.bfloat16


def _leaves(s: Shape, rows: int) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std): kind "w" normal * std, "gain" 1 + std *
    normal (clipped), "bias" normal * std."""
    L, D, F = s.layers, s.d, s.ffn
    Q, KV = s.q_dim, s.kv_dim
    # gpt2: GPT-2's own scheme, residual projections scaled by
    # 1/sqrt(2 L) and small biases; with unscaled projections and biases of
    # 0.1 the 48-layer stream collapses onto one direction and the model
    # serves one token whatever the context
    res = (2 * L) ** -0.5 if s.family == "gpt2" else 1.0
    bias = 0.02 if s.family == "gpt2" else 0.1
    out = [("embed", (rows, D), "w", 0.02)]
    if s.family == "gpt2":
        out.append(("pos", (s.positions, D), "w", 0.02))
    out += [("wq", (L, D, Q), "w", D ** -0.5),
            ("wk", (L, D, KV), "w", D ** -0.5),
            ("wv", (L, D, KV), "w", D ** -0.5),
            ("wo", (L, Q, D), "w", res * Q ** -0.5),
            ("ln1_g", (L, D), "gain", 0.1), ("ln2_g", (L, D), "gain", 0.1),
            ("lnf_g", (D,), "gain", 0.1)]
    if s.family == "qwen2":
        out += [("bq", (L, Q), "bias", 0.1), ("bk", (L, KV), "bias", 0.1),
                ("bv", (L, KV), "bias", 0.1),
                ("w_gate", (L, D, F), "w", D ** -0.5),
                ("w_up", (L, D, F), "w", D ** -0.5),
                ("w_down", (L, F, D), "w", F ** -0.5)]
    else:
        out += [("ln1_b", (L, D), "bias", bias),
                ("ln2_b", (L, D), "bias", bias), ("lnf_b", (D,), "bias", bias),
                ("w_up", (L, D, F), "w", D ** -0.5),
                ("b_up", (L, F), "bias", bias),
                ("w_down", (L, F, D), "w", res * F ** -0.5),
                ("b_down", (L, D), "bias", bias)]
    if not s.tied:
        # an untied head at the embedding's scale: Qwen2's initializer_range
        out.append(("head", (D, rows), "w", 0.02))
    return out


def make_weights(s: Shape, seed: int, device, rows: int
                 ) -> Dict[str, torch.Tensor]:
    """The benchmark's weights for `seed`, bfloat16 on `device`; `rows`
    embedding rows (at least the vocabulary)."""
    if rows < s.vocab:
        raise ValueError(f"{rows} embedding rows < vocab {s.vocab}")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    out = {}
    for name, shape, kind, std in _leaves(s, rows):
        t = torch.randn(shape, generator=g, device=device, dtype=WEIGHT_DTYPE)
        t.mul_(std)
        if kind == "gain":
            # gains within [0.55, 1.9]: gain - 1 is then exact in bfloat16
            t.clamp_(-0.45, 0.9).add_(1.0)
        out[name] = t
    return out


def _norm(arch, w, g: str, b: str) -> dict:
    if arch.norm == "layernorm":
        return {"scale": w[g], "bias": w[b]}
    # the program's RMSNorm stores gain - 1 (exact for these gains)
    return {"scale": (w[g].float() - 1.0).to(w[g].dtype)}


def program_params(arch, w: Dict[str, torch.Tensor]) -> dict:
    """The program's parameter tree (`repro_torch.params` layout: one
    stacked block dict, no tail) over the same tensors."""
    attn = {k: w[k] for k in ("wq", "wk", "wv", "wo")}
    if arch.attn_bias:
        attn.update(bq=w["bq"], bk=w["bk"], bv=w["bv"])
    if arch.ffn_kind == "swiglu":
        ffn = {k: w[k] for k in ("w_gate", "w_up", "w_down")}
    else:
        ffn = {k: w[k] for k in ("w_up", "b_up", "w_down", "b_down")}
    embed = {"tok": w["embed"]}
    if arch.pos_emb == "learned":
        embed["pos"] = w["pos"]
    if not arch.tie_embeddings:
        embed["head"] = w["head"]
    block = {"norm1": _norm(arch, w, "ln1_g", "ln1_b"), "attn": attn,
             "norm2": _norm(arch, w, "ln2_g", "ln2_b"), "ffn": ffn}
    return {"embed": embed, "blocks": [block], "tail": [],
            "final_norm": _norm(arch, w, "lnf_g", "lnf_b")}
