"""Plain PyTorch version of paged GQA speculative verification.

As the reference's `repro/kernels/paged_gqa_verify/ref.py`: row v of the
speculative window is scored by the port's decode plain version at length
`base_lens + v + 1`, one call per window row. That makes the CPU path's
verify logits bit-identical per row to stepping the non-speculative decode
path token by token, so speculative greedy tokens equal non-speculative
ones. `paged_gqa_verify_split_ref` does the same over the decode kernel's
split-context mirror, which the card's verify kernel is held to: tests
only."""
from __future__ import annotations

import torch

from repro_torch.kernels.gqa_decode.ref import SPLIT_ROWS
from repro_torch.kernels.paged_gqa_decode.ref import (
    paged_gqa_decode_ref, paged_gqa_decode_split_ref)


def paged_gqa_verify_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         base_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, V, H, d); k_pages, v_pages: (N, K, ps, d) (any float dtype or
    fp8 E4M3 codes); page_table: (B, P) int32; base_lens: (B,) context
    lengths before the speculative window. Returns (B, V, H, d)."""
    V = q.shape[1]
    rows = [paged_gqa_decode_ref(q[:, v], k_pages, v_pages, page_table,
                                 base_lens + (v + 1)) for v in range(V)]
    return torch.stack(rows, dim=1)


def paged_gqa_verify_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               page_table: torch.Tensor,
                               base_lens: torch.Tensor,
                               split_rows: int = SPLIT_ROWS) -> torch.Tensor:
    """The verify kernel's arithmetic, arguments as `paged_gqa_verify_ref`:
    row v is `paged_gqa_decode_split_ref` at base_lens + v + 1."""
    rows = [paged_gqa_decode_split_ref(q[:, v], k_pages, v_pages, page_table,
                                       base_lens + (v + 1), split_rows)
            for v in range(q.shape[1])]
    return torch.stack(rows, dim=1)
