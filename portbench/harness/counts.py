"""The yardstick: the chip's peaks, and the operations and bytes of the
model and of its attention kernels, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM part (dense bfloat16 989
TFLOP/s, HBM3 3.35 TB/s), at the card's full 700 W. A share of a peak is
stated against these, whatever power limit the card runs at.

Counts (multiply-adds count 2):
  * a weight product of an (n, a) activation by an (a, b) matrix: 2 n a b;
  * causal attention over S rows: row i attends i + 1 keys, 4 H d per key
    (2 for q.k, 2 for p.v), so 2 H d S (S + 1) a layer;
  * prefill computes the LM head at the last position only;
  * a decode token of context `rows` (keys attended) costs the weight
    products, 4 H d rows a layer of attention and one LM-head row.
Bytes of a kernel count each input read once and the output written once:
prefill attention reads q, k, v and writes o; paged decode reads q, the live
K and V rows of each active slot, the page table and the lengths, and
writes o."""
from __future__ import annotations

from typing import Optional, Sequence

from portbench.reference.decoder import Shape

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
BF16 = 2


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of a card by its `torch.cuda.get_device_name()`, or None
    for a card the table does not hold."""
    return PEAKS.get(device_name)


def weight_params(s: Shape) -> int:
    """Parameters of the per-token weight products, LM head excluded."""
    ffn = (3 if s.family == "qwen2" else 2) * s.d * s.ffn
    return s.layers * (2 * s.d * s.q_dim + 2 * s.d * s.kv_dim + ffn)


def head_flops(s: Shape) -> int:
    return 2 * s.d * s.vocab


def attn_prefill_flops(s: Shape, S: int) -> int:
    """One layer's causal attention over S rows."""
    return 2 * s.heads * s.head_dim * S * (S + 1)


def attn_prefill_bytes(s: Shape, S: int) -> int:
    return BF16 * S * (2 * s.q_dim + 2 * s.kv_dim)


def prefill_flops(s: Shape, S: int) -> int:
    """A whole prefill of S prompt tokens."""
    return (2 * weight_params(s) * S + s.layers * attn_prefill_flops(s, S)
            + head_flops(s))


def decode_flops(s: Shape, rows: int) -> int:
    """One generated token that attends `rows` keys."""
    return (2 * weight_params(s) + 4 * s.heads * s.head_dim * rows * s.layers
            + head_flops(s))


def attn_decode_flops(s: Shape, rows: Sequence[int]) -> int:
    """One layer's paged decode over the active slots' key counts."""
    return 4 * s.heads * s.head_dim * int(sum(rows))


def attn_decode_bytes(s: Shape, rows: Sequence[int], slots: int,
                      table_pages: int) -> int:
    """One layer's paged decode call over `slots` slots, of which the
    active ones hold `rows` live rows: their K and V rows, every slot's
    query and output, the page table and the lengths (int32)."""
    kv = BF16 * 2 * s.kv_dim * int(sum(rows))
    return kv + BF16 * 2 * slots * s.q_dim + 4 * slots * (table_pages + 1)


def ideal_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of operations over
    peak rate and bytes over peak bandwidth."""
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"])
