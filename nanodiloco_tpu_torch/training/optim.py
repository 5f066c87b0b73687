"""Optimizers and schedule: port of ``nanodiloco_tpu/training/optim.py``.

- Inner: global-norm clip at 1.0, then AdamW(lr, betas=(0.9, 0.999),
  eps=1e-8, weight_decay=0.01) under a linear-warmup + cosine schedule.
- Outer: SGD(outer_lr, momentum=0.9, nesterov=True).

DiLoCo clips each worker's gradient by that worker's own global norm (the
JAX package clips under ``vmap``). With the worker axis stacked as the
leading dimension of every tensor, ``clip_grad_norm_`` would take one norm
across all workers, so ``clip_per_worker_`` does it by hand. AdamW is
elementwise, so one ``torch.optim.AdamW`` over the stacked tensors is
exactly W independent optimizers sharing one step count and schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def warmup_cosine_schedule(
    base_lr: float, warmup_steps: int, total_steps: int
) -> Callable[[int], float]:
    """HF ``get_cosine_schedule_with_warmup`` (num_cycles 0.5): linear
    0 -> base_lr over ``warmup_steps``, then cosine to 0 at
    ``total_steps``. ``count`` is the number of completed steps, so the
    first update uses lr = 0 exactly."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * count / max(1.0, warmup_steps)
        progress = (count - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def inner_optimizer(
    params: Iterable[torch.Tensor],
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> torch.optim.AdamW:
    """AdamW whose lr the caller sets from the schedule before each step.
    ``foreach=False``: one tensor at a time keeps the optimizer's
    temporaries at the size of the largest tensor, not of all of them."""
    return torch.optim.AdamW(
        params, lr=0.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
        foreach=False,
    )


@torch.no_grad()
def clip_per_worker_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip, in place, each worker's slice ``g[w]`` of every gradient by
    that worker's global norm over all tensors, as optax's
    ``clip_by_global_norm`` does for one worker: unchanged below
    ``max_norm``, scaled to norm ``max_norm`` above it. Returns the [W]
    pre-clip norms."""
    sq = sum(
        torch.linalg.vector_norm(g.reshape(g.shape[0], -1).float(), dim=1) ** 2
        for g in grads
    )
    norm = sq.sqrt()
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.view((-1,) + (1,) * (g.ndim - 1)).to(g.dtype))
    return norm


def outer_optimizer(
    params: Iterable[torch.Tensor],
    outer_lr: float,
    momentum: float = 0.9,
    nesterov: bool = True,
) -> torch.optim.SGD:
    """Nesterov-momentum SGD on the snapshot, stepped with the averaged
    pseudo-gradient in ``.grad`` (torch's recurrence equals optax's)."""
    return torch.optim.SGD(
        params, lr=outer_lr, momentum=momentum, nesterov=nesterov, foreach=False
    )
