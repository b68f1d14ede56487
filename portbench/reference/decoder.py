"""Plain float32 forward passes of the benchmark's two model families,
written from their published equations, to judge what the program serves.

  * Qwen2 (DeepSeek-R1-Distill-Qwen): token embedding; per block RMSNorm,
    q/k/v projections with biases and o without, rotary embedding over the
    whole head (rotate-half, theta from the config), grouped-query causal
    attention (query head h reads KV head h // (H / K)), residual, RMSNorm,
    SwiGLU MLP, residual; a final RMSNorm and the LM head (its own matrix
    where the configuration unties it).
  * GPT-2: token plus learned position embeddings; per block LayerNorm,
    multi-head causal attention, residual, LayerNorm, MLP with biases and
    the tanh form of GELU ("gelu_new"), residual; a final LayerNorm and the
    LM head.

Weights come in the benchmark's own layout (`harness.weights`): bfloat16
tensors stacked over the layers, with norm gains as gains. Every product
runs in float32 (the caller turns TF32 off) and attention runs in blocks of
query rows, so an 8k-token prompt fits. `fp8=True` rounds both operands of
every weight product to float8 E4M3 (a scale per row of the activations
and per output column of the weights), the precision below the bfloat16
the configurations state: that is the control a sound comparison has to
fail. This module imports nothing of the program."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence

import torch

E4M3_MAX = 448.0


@dataclass(frozen=True)
class Shape:
    """The sizes of one configuration file, under one set of names."""
    family: str           # "qwen2" | "gpt2"
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    eps: float
    rope_theta: float = 0.0
    positions: int = 0    # learned position rows (gpt2)
    tied: bool = True     # LM head is the token embedding

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def shape_of(conf: dict) -> Shape:
    """The `Shape` of a configuration file (Hugging Face key names)."""
    kind = conf["model_type"]
    if kind == "qwen2":
        if conf["hidden_act"] != "silu":
            raise ValueError(f"qwen2 with {conf['hidden_act']!r} MLP")
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        return Shape("qwen2", conf["num_hidden_layers"], d, h,
                     conf["num_key_value_heads"], d // h,
                     conf["intermediate_size"], conf["vocab_size"],
                     conf["rms_norm_eps"], rope_theta=conf["rope_theta"],
                     tied=bool(conf["tie_word_embeddings"]))
    if kind == "gpt2":
        if conf["activation_function"] != "gelu_new":
            raise ValueError(f"gpt2 with {conf['activation_function']!r}")
        d, h = conf["n_embd"], conf["n_head"]
        return Shape("gpt2", conf["n_layer"], d, h, h, d // h,
                     conf["n_inner"] or 4 * d, conf["vocab_size"],
                     conf["layer_norm_epsilon"],
                     positions=conf["n_positions"],
                     tied=bool(conf["tie_word_embeddings"]))
    raise ValueError(f"unknown model_type {kind!r}")


def _qdq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` rounded to E4M3 with one scale per slice along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.float()
    if fp8:
        return _qdq(x, -1) @ _qdq(w, 0)
    return x @ w


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * g.float()


def _layernorm(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (T, n, d) at positions 0..T-1,
    angles in float64."""
    T, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    ang = torch.cat([ang, ang], dim=-1)[:, None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _causal_attention(q, k, v, block: int) -> torch.Tensor:
    """q (T, H, d), k and v (T, K, d) -> (T, H, d); row i attends keys
    0..i; query head h reads KV head h // (H / K)."""
    T, H, d = q.shape
    K = k.shape[1]
    G = H // K
    kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)          # (K, T, d)
    out = torch.empty_like(q)
    for a in range(0, T, block):
        b = min(T, a + block)
        qb = q[a:b].reshape(b - a, K, G, d).permute(1, 2, 0, 3)
        s = torch.einsum("kgnd,ktd->kgnt", qb, kt[:, :b]) / math.sqrt(d)
        rows = torch.arange(a, b, device=q.device)[:, None]
        cols = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("kgnt,ktd->kgnd", p, vt[:, :b])      # (K, G, n, d)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, d)
    return out


def _embed(shape: Shape, w, tokens: torch.Tensor) -> torch.Tensor:
    x = w["embed"][tokens.to(w["embed"].device).long()].float()
    if shape.family == "gpt2":
        x = x + w["pos"][:tokens.shape[0]].float()
    return x


def layer0_kv(shape: Shape, w: Dict[str, torch.Tensor],
              tokens: torch.Tensor):
    """The first layer's keys (after the rotary embedding, for qwen2) and
    values over `tokens` (T,): two float32 (T, K, d) tensors."""
    T = tokens.shape[0]
    x = _embed(shape, w, tokens)
    K, d = shape.kv_heads, shape.head_dim
    if shape.family == "qwen2":
        h = _rms(x, w["ln1_g"][0], shape.eps)
        k = _mm(h, w["wk"][0], False) + w["bk"][0].float()
        v = _mm(h, w["wv"][0], False) + w["bv"][0].float()
        return _rotary(k.view(T, K, d), shape.rope_theta), v.view(T, K, d)
    h = _layernorm(x, w["ln1_g"][0], w["ln1_b"][0], shape.eps)
    return (_mm(h, w["wk"][0], False).view(T, K, d),
            _mm(h, w["wv"][0], False).view(T, K, d))


def logits_at(shape: Shape, w: Dict[str, torch.Tensor],
              tokens: torch.Tensor, read: Sequence[int], *,
              fp8: bool = False, block: int = 1024) -> torch.Tensor:
    """Float32 logits (len(read), vocab) of the causal forward over
    `tokens` (T,) at the positions `read`."""
    T = tokens.shape[0]
    dev = w["embed"].device
    x = _embed(shape, w, tokens)
    H, K, d = shape.heads, shape.kv_heads, shape.head_dim
    for i in range(shape.layers):
        if shape.family == "qwen2":
            h = _rms(x, w["ln1_g"][i], shape.eps)
            q = _mm(h, w["wq"][i], fp8) + w["bq"][i].float()
            k = _mm(h, w["wk"][i], fp8) + w["bk"][i].float()
            v = _mm(h, w["wv"][i], fp8) + w["bv"][i].float()
            q = _rotary(q.view(T, H, d), shape.rope_theta)
            k = _rotary(k.view(T, K, d), shape.rope_theta)
            v = v.view(T, K, d)
        else:
            h = _layernorm(x, w["ln1_g"][i], w["ln1_b"][i], shape.eps)
            q = _mm(h, w["wq"][i], fp8).view(T, H, d)
            k = _mm(h, w["wk"][i], fp8).view(T, K, d)
            v = _mm(h, w["wv"][i], fp8).view(T, K, d)
        o = _causal_attention(q, k, v, block).reshape(T, H * d)
        x = x + _mm(o, w["wo"][i], fp8)
        del q, k, v, o
        if shape.family == "qwen2":
            h = _rms(x, w["ln2_g"][i], shape.eps)
            g = torch.nn.functional.silu(_mm(h, w["w_gate"][i], fp8))
            x = x + _mm(g * _mm(h, w["w_up"][i], fp8), w["w_down"][i], fp8)
        else:
            h = _layernorm(x, w["ln2_g"][i], w["ln2_b"][i], shape.eps)
            u = _gelu_new(_mm(h, w["w_up"][i], fp8) + w["b_up"][i].float())
            x = x + _mm(u, w["w_down"][i], fp8) + w["b_down"][i].float()
        del h
    x = x[torch.as_tensor(list(read), device=dev)]
    if shape.family == "qwen2":
        x = _rms(x, w["lnf_g"], shape.eps)
    else:
        x = _layernorm(x, w["lnf_g"], w["lnf_b"], shape.eps)
    head = (w["embed"][:shape.vocab].T if shape.tied
            else w["head"][:, :shape.vocab])
    return _mm(x, head, fp8)
