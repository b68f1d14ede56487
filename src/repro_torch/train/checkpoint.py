"""Atomic, asynchronous checkpoints; port of the reference's
`repro/train/checkpoint.py`, with its directory layout and files:

    <dir>/step_<N>/
        index.json            (key paths, shapes, dtypes, metadata)
        p<proc>_l<leaf>.npy   (one file per leaf: its raw bytes as uint8)

Key paths and leaf order are `jax.tree_util`'s (`optim.tree`), so a
checkpoint of a numpy tree written by either package restores in the
other. Writes go to `step_<N>.tmp_p<proc>` and are renamed into place
(atomic on POSIX), so a crash mid-save never corrupts the latest
checkpoint; `latest_step` and `prune` ignore temporary directories.
`AsyncCheckpointer` saves on a background thread; `wait()` joins it.
Leaves may be tensors (any device) or numpy arrays. A bfloat16 tensor is
written through a uint16 view of its bits and restored the same way, so
the bytes cross unchanged and the port needs no `ml_dtypes`; numpy has
no bfloat16, so a numpy `tree_like` gets such a leaf's bits as uint16.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import (tree_leaves_with_path, tree_map,
                                    tree_unflatten_like)


def _host(leaf) -> Any:
    """A host snapshot of a leaf: a CPU tensor copy, or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _bytes(leaf) -> Tuple[np.ndarray, list, str]:
    """(raw bytes as uint8, shape, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, name = t.view(torch.uint16).numpy(), "bfloat16"
        else:
            arr = t.numpy()
            name = str(arr.dtype)
    else:
        arr = np.asarray(leaf)
        name = str(arr.dtype)
    return np.frombuffer(arr.tobytes(), np.uint8), list(arr.shape), name


def save(ckpt_dir: str, step: int, tree: Any,
         metadata: Optional[Dict] = None, process_index: int = 0) -> str:
    proc = process_index
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp_p{proc}"
    os.makedirs(tmp, exist_ok=True)
    index = {"step": int(step), "metadata": metadata or {}, "leaves": []}
    for i, (kpath, leaf) in enumerate(tree_leaves_with_path(tree)):
        raw, shape, dtype = _bytes(leaf)
        fname = f"p{proc}_l{i:05d}.npy"
        np.save(os.path.join(tmp, fname), raw)
        index["leaves"].append({"key": kpath, "file": fname,
                                "shape": shape, "dtype": dtype})
    if proc == 0:
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(tmp)            # another process/run already committed
    else:
        os.rename(tmp, final)         # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and "tmp_p" not in name:
            try:
                steps.append(int(name.split("_")[1]))
            except (ValueError, IndexError):
                continue
    return max(steps) if steps else None


def _leaf(raw: np.ndarray, meta: dict, like) -> Any:
    """A stored leaf in the kind of `like`: a tensor on like's device, else
    a numpy array."""
    name = meta["dtype"]
    arr = np.frombuffer(raw.tobytes(), np.uint16 if name == "bfloat16"
                        else np.dtype(name)).reshape(meta["shape"])
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(arr.copy())
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            process_index: int = 0) -> Tuple[int, Any]:
    """Restore into the structure of `tree_like` (key paths and shapes
    validated). Tensor leaves of `tree_like` come back as tensors on their
    device, other leaves as numpy arrays."""
    proc = process_index
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    flat = tree_leaves_with_path(tree_like)
    assert len(flat) == len(index["leaves"]), \
        f"leaf count mismatch: {len(flat)} vs {len(index['leaves'])}"
    leaves = []
    for (kpath, like), meta in zip(flat, index["leaves"]):
        assert kpath == meta["key"], (kpath, meta["key"])
        raw = np.load(os.path.join(d, meta["file"].replace(
            "p0_", f"p{proc}_") if proc else meta["file"]))
        arr = _leaf(raw, meta, like)
        assert list(arr.shape) == list(np.shape(like)), (kpath, arr.shape)
        leaves.append(arr)
    return step, tree_unflatten_like(tree_like, leaves)


def prune(ckpt_dir: str, keep_last: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and "tmp" not in n)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background saves; `wait()` joins outstanding work."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[Dict] = None) -> None:
        self.wait()
        # copied to the host on the caller's thread, so the values are
        # those of this step whatever the caller does next
        host_tree = tree_map(_host, tree)

        def work():
            save(self.ckpt_dir, step, host_tree, metadata)
            prune(self.ckpt_dir, self.keep_last)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
