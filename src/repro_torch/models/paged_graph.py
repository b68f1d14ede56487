"""The paged decode step replayed as one CUDA graph.

A paged decode step launches a few thousand small kernels (norms,
projections, RoPE, page-row writes, kernel 1, the FFN, every layer), each
issued by the host; the card finishes a step when the host finishes issuing
it. `StepGraph` runs the step's whole body once per call on buffers it owns
(the tokens, positions, page table and liveness mask; the pools, recurrent
states and parameters are the caller's, at the addresses its key records).
On the card the first `WARMUP_STEPS` calls run the body eagerly, on a side
stream, so that cuBLAS, the kernels' libraries and their attributes are
initialised; the next call captures it into a CUDA graph, and that call and
every later one replay it. Elsewhere the body runs eagerly on the same
buffers, so CPU tests hold the buffers' contract.

Each call copies the caller's `tokens`, `pos`, `page_table` and `active`
into the buffers (the batcher rebinds the table and the mask between steps
and admissions write positions in place), runs the step, and hands back
copies: the logits, and the advanced positions as the new `cache["pos"]`.
So a caller may hold a step's logits and positions across later calls, as
it may on the eager path.

The graph captures addresses, shapes and dtypes: `layout_key` lists those
of every tensor the body reads that the buffers do not hold, with the
matrix-product precision flags, and a call whose key differs from the
graph's gets a new `StepGraph`. Kernel launch counts (`kernels.build`)
grow by the captured launches at each replay; the capture itself counts
none."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator

import torch

from repro_torch.kernels import build

WARMUP_STEPS = 2


@dataclass
class StepCounts:
    """Paged decode steps of one model: graphs captured, calls served by a
    replay, and calls whose ops ran eagerly (the CPU path, and the warm-up
    calls before a capture)."""
    captures: int = 0
    replays: int = 0
    eager: int = 0


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _layout(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype)


def layout_key(params: dict, cache: dict, tokens: torch.Tensor) -> tuple:
    """What a captured step depends on besides the values in its buffers:
    the address, shape, strides and dtype of every parameter, pool and
    recurrent state; the shapes and dtypes of the buffers' sources; the
    matrix-product precision flags."""
    held = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for tree in (params, cache["slots"], cache["tail"])
                 for t in _tensors(tree))
    m = torch.backends.cuda.matmul
    return held + (_layout(tokens), _layout(cache["pos"]),
                   _layout(cache["page_table"]), _layout(cache["active"]),
                   (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
                    m.allow_fp16_reduced_precision_reduction))


class StepGraph:
    """One paged decode step of one cache layout on buffers it owns; see
    the module's docstring. `step(cache, tokens)` is the body: it returns
    (logits, advanced positions) and writes the pools and states in place,
    reading positions, table and mask from `cache`."""

    def __init__(self, key: tuple, cache: dict, tokens: torch.Tensor):
        self.key = key
        own = torch.contiguous_format
        self.tokens = tokens.clone(memory_format=own)
        self.pos = cache["pos"].clone(memory_format=own)
        self.page_table = cache["page_table"].clone(memory_format=own)
        self.active = cache["active"].clone(memory_format=own)
        self.cuda = self.pos.device.type == "cuda"
        self.warm = 0
        self.graph = None
        self.out = None
        self.launches: Dict[str, int] = {}

    def _cache(self, cache: dict) -> dict:
        return {"slots": cache["slots"], "tail": cache["tail"],
                "pos": self.pos, "page_table": self.page_table,
                "active": self.active}

    def _eager(self, step: Callable, cache: dict):
        if not self.cuda:
            return step(self._cache(cache), self.tokens)
        # every side-stream step waits for the caller's stream first, and
        # the caller's waits for it after: blocks the step frees are reused
        # only behind work already issued
        cur = torch.cuda.current_stream(self.pos.device)
        side = torch.cuda.Stream(self.pos.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = step(self._cache(cache), self.tokens)
        cur.wait_stream(side)
        return out

    def _capture(self, step: Callable, cache: dict) -> None:
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = step(self._cache(cache), self.tokens)
        self.graph = graph
        after = build.launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        build.add_launches(self.launches, -1)     # captured, not run

    def __call__(self, step: Callable, cache: dict, tokens: torch.Tensor,
                 counts: StepCounts) -> torch.Tensor:
        """One step: the caller's inputs copied in, the graph replayed (or
        the body run), copies of the logits returned and of the advanced
        positions left in `cache["pos"]`."""
        self.tokens.copy_(tokens)
        self.pos.copy_(cache["pos"])
        self.page_table.copy_(cache["page_table"])
        self.active.copy_(cache["active"])
        if self.graph is None and self.cuda and self.warm >= WARMUP_STEPS:
            self._capture(step, cache)
            counts.captures += 1
        if self.graph is not None:
            self.graph.replay()
            build.add_launches(self.launches)
            counts.replays += 1
        else:
            self.out = self._eager(step, cache)
            self.warm += 1
            counts.eager += 1
        logits, pos = self.out
        cache["pos"] = pos.clone()
        return logits.clone()
