"""Training step: loss -> gradients -> (optional compression) -> AdamW;
port of the reference's `repro/train/step.py`.

Gradients come from autograd through the model's loss, where the reference
runs `jax.value_and_grad`: the loss is plain PyTorch on every device, its
attention the plain `models.attention.blocked_attention` (the reference's
loss runs jnp attention; the port has no backward kernel yet). The step is
functional: it returns new parameter and optimizer-state trees. Grad mode
is switched on only inside the step (`torch.enable_grad`), so a caller's
mode is left as it was.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.optim import AdamW, AdamWState, apply_compression
from repro_torch.optim.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (dtypes kept)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict[str, Any]):
    """(loss, gradient tree of `params`) of `loss_fn(params, batch)`: each
    leaf is differentiated through a detached copy, so `params` gains no
    autograd state. A leaf the loss does not reach gets a zero gradient,
    as under `jax.grad`."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten_like(params, grads)


def make_train_step(model, optimizer: AdamW, compression: str = "none",
                    microbatches: int = 1) -> Callable:
    """Returns step(params, opt_state, batch[, comp_err]) -> (params,
    opt_state, metrics[, comp_err]).

    `microbatches > 1` accumulates gradients: the batch is split into that
    many chunks along its first axis, run one after another, so peak
    activation memory scales with the chunk while the optimizer sees the
    mean gradient (the chunks' sum from float32 zeros, times 1 / k, as the
    reference's scan)."""
    device = model.device

    def grads_of(params, batch):
        if microbatches <= 1:
            return value_and_grad(model.loss, params, batch)

        def chunk(x, i):
            b = x.shape[0]
            assert b % microbatches == 0, (b, microbatches)
            n = b // microbatches
            return x[i * n:(i + 1) * n]

        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        grad_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        for i in range(microbatches):
            loss, grads = value_and_grad(
                model.loss, params, {k: chunk(v, i) for k, v in batch.items()})
            grad_sum = tree_map(torch.add, grad_sum, grads)
            loss_sum = loss_sum + loss
        inv = 1.0 / microbatches
        return loss_sum * inv, tree_map(lambda g: g * inv, grad_sum)

    def step(params, opt_state: AdamWState, batch, comp_err=None):
        loss, grads = grads_of(params, batch_to(batch, device))
        grads, new_err = apply_compression(grads, compression, comp_err)
        new_params, new_state, metrics = optimizer.update(
            grads, opt_state, params)
        metrics["loss"] = loss
        if compression == "int8ef":
            return new_params, new_state, metrics, new_err
        return new_params, new_state, metrics

    return step


def make_eval_step(model) -> Callable:
    """step(params, batch) -> the loss, with no autograd state."""
    def step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch_to(batch, model.device))
    return step
