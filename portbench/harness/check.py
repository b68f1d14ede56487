"""Deciding `correct`: the served tokens of a sample of finished requests,
and the page rows of requests still in flight, judged by the plain float32
reference.

For each sampled request the reference runs once, causally, over its
prompt followed by its served tokens, and reads the logits at every
position where the program served a token. A served token's gap is how far
its reference logit lies below the reference's best logit there: 0 where
the program served the reference's own greedy choice, small where rounding
made two near-equal logits trade places, large where the program served a
token the model does not rank first. `gap` is the widest over the sample.

The control (`control_gaps`) puts the reference in the program's place at
the precision below the configuration's: float8 E4M3 weight products. At
the same positions it takes the token that the lower precision ranks first
and reads that token's gap in the float32 reference.

`kv_err` reads the first layer's K and V rows that the program wrote into
the pages of slots still active when the window closed (prompt rows by
`write_prefill_to_pages`, decode rows by the decode steps) against the
reference's: 2^-9-scale rounding in bfloat16 pages, ten times more in the
program's own fp8 page path, and order one for a row in the wrong place."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.decoder import layer0_kv, logits_at


def sample(finished: Sequence[tuple], seed: int, tokens: int,
           max_requests: int) -> List[int]:
    """Indices into `finished` ((prompt, output) pairs): the longest
    request (prompt plus output), then others in an order drawn from
    `seed`, until the sample holds `tokens` served tokens or
    `max_requests` requests."""
    if not finished:
        return []
    lens = [len(p) + len(o) for p, o in finished]
    first = int(np.argmax(lens))
    rest = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xc4e]) \
        .permutation(len(finished))
    out, served = [first], len(finished[first][1])
    for i in rest:
        if served >= tokens or len(out) >= max_requests:
            break
        if i != first:
            out.append(int(i))
            served += len(finished[i][1])
    return out


def _inputs(prompt, output):
    seq = torch.as_tensor(np.concatenate([np.asarray(prompt),
                                          np.asarray(output[:-1])]))
    S = len(prompt)
    return seq, list(range(S - 1, S - 1 + len(output)))


def gaps(shape, w, prompt, output) -> np.ndarray:
    """The reference's gap of each served token of one request."""
    seq, read = _inputs(prompt, output)
    ref = logits_at(shape, w, seq, read)
    served = torch.as_tensor(list(output), device=ref.device).long()
    g = ref.max(-1).values - ref.gather(1, served[:, None])[:, 0]
    return g.cpu().numpy()


def control_gaps(shape, w, prompt, output) -> np.ndarray:
    """The gap of the token that the float8 reference ranks first, at each
    position of the same prompt and served tokens."""
    seq, read = _inputs(prompt, output)
    ref = logits_at(shape, w, seq, read)
    pick = logits_at(shape, w, seq, read, fp8=True).argmax(-1)
    g = ref.max(-1).values - ref.gather(1, pick[:, None])[:, 0]
    return g.cpu().numpy()


def kv_err(shape, w, tokens, k_rows: torch.Tensor,
           v_rows: torch.Tensor) -> float:
    """Relative RMS error of the first layer's K and V rows that the
    program holds in a slot's pages (T, K, d), against the reference's
    over the slot's tokens: the precision of the stored rows, and where
    they were stored."""
    k, v = layer0_kv(shape, w, tokens)
    err = (k_rows.float() - k).square().sum() + (v_rows.float() - v
                                                 ).square().sum()
    return float(torch.sqrt(err / (k.square().sum() + v.square().sum())))


def gap_numbers(per_request: List[np.ndarray]) -> Dict[str, float]:
    """{"gap": the widest gap over the sample}; empty for an empty
    sample."""
    if not per_request:
        return {}
    return {"gap": float(np.concatenate(per_request).max())}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} for every limit; a number not measured
    reads as failing (NaN)."""
    return {k: {"value": float(values.get(k, float("nan"))),
                "limit": float(lim)} for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
