"""Optimizers and schedule: port of ``nanodiloco_tpu/training/optim.py``.

- Inner: global-norm clip at 1.0, then AdamW(lr, betas=(0.9, 0.999),
  eps=1e-8, weight_decay=0.01) under a linear-warmup + cosine schedule.
- Outer: SGD(outer_lr, momentum=0.9, nesterov=True).

DiLoCo clips each worker's gradient by that worker's own global norm (the
JAX package clips under ``vmap``). With the worker axis stacked as the
leading dimension of every tensor, ``clip_grad_norm_`` would take one norm
across all workers, so ``clip_per_worker_`` does it by hand.

The JAX package ``vmap``s its optax state, so each worker owns its step
count: under heterogeneous H a frozen worker's count, bias correction and
schedule position all stop. ``StackedAdamW`` keeps that: one ``[W]`` step
count per tensor and one learning rate per worker, each worker's update
being torch's single-tensor AdamW arithmetic on its slice.

The outer step is functional (``nesterov_direction``): the momentum is an
explicit tensor, not optimizer state keyed by the parameter object, so
the async path can anchor the update at a pending merge, streaming can
keep one momentum per fragment of layer slices, and the snapshot's
storage may move to the host between syncs.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

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


class StackedAdamW:
    """AdamW over worker-stacked ``[W, ...]`` tensors: W independent
    optimizers, as the JAX package's vmapped optax state.

    ``state[p]`` holds ``exp_avg`` and ``exp_avg_sq`` (shaped like ``p``)
    and ``step``, a ``[W]`` float32 CPU tensor of each worker's completed
    updates (the names of ``torch.optim.AdamW``'s state, which the
    checkpoint keeps). ``step(lrs, active)`` updates worker w with
    learning rate ``lrs[w]`` where ``active[w]``; an inactive worker's
    slice, moments and count stay as they are."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        weight_decay: float = 0.01,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ) -> None:
        self.params = list(params)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.num_workers = int(self.params[0].shape[0])
        self.state: dict[torch.Tensor, dict[str, torch.Tensor]] = {
            p: {
                "step": torch.zeros(self.num_workers, dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
            for p in self.params
        }

    def counts(self) -> list[int]:
        """Completed updates per worker (every tensor holds the same)."""
        return [int(c) for c in self.state[self.params[0]]["step"].tolist()]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _update(self, p, g, m, v, lr: float, step: float) -> None:
        """torch's single-tensor AdamW on one worker's slice."""
        p.mul_(1 - lr * self.weight_decay)
        m.lerp_(g, 1 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        bias_correction1 = 1 - self.b1 ** step
        bias_correction2_sqrt = math.sqrt(1 - self.b2 ** step)
        denom = (v.sqrt() / bias_correction2_sqrt).add_(self.eps)
        p.addcdiv_(m, denom, value=-(lr / bias_correction1))

    @torch.no_grad()
    def step(self, lrs: Sequence[float], active: Sequence[bool] | None = None) -> None:
        W = self.num_workers
        active = [True] * W if active is None else [bool(a) for a in active]
        for p in self.params:
            st = self.state[p]
            steps = st["step"]
            for w in range(W):
                if active[w]:
                    steps[w] += 1
            counts = steps.tolist()
            m, v, g = st["exp_avg"], st["exp_avg_sq"], p.grad
            for w in range(W):
                if active[w]:
                    self._update(p[w], g[w], m[w], v[w], float(lrs[w]), counts[w])

    @torch.no_grad()
    def reset_moments(self, keep: Sequence[bool]) -> None:
        """Zero the float moments of every worker whose ``keep`` is false:
        a fresh-init equivalent (a NaN moment never decays). The step
        counts stay, as the JAX package keeps its integer leaves."""
        for st in self.state.values():
            for w, k in enumerate(keep):
                if not k:
                    st["exp_avg"][w].zero_()
                    st["exp_avg_sq"][w].zero_()


def inner_optimizer(
    params: Iterable[torch.Tensor],
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> StackedAdamW:
    """AdamW whose per-worker lrs the caller passes to each step, from the
    schedule at each worker's own count."""
    return StackedAdamW(params, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


@torch.no_grad()
def clip_per_worker_(grads: list[torch.Tensor], max_norm: float,
                     counted: Sequence[bool] | None = None,
                     group_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
                     ) -> torch.Tensor:
    """Clip, in place, each worker's slice ``g[w]`` of every gradient by
    that worker's global norm over all tensors, as optax's
    ``clip_by_global_norm`` does for one worker: unchanged below
    ``max_norm``, scaled to norm ``max_norm`` above it. Returns the [W]
    pre-clip norms. A worker whose norm is not finite scales only its own
    slices: no value crosses the worker axis.

    Sharded (``parallel/sharding.py``), ``grads`` are this rank's slices:
    ``group_sum`` adds the [W] squared norms over the worker group's
    ranks, and ``counted[i]`` says whether this rank counts tensor i (a
    whole tensor, held alike by several ranks, is counted once)."""
    sq = sum(
        torch.linalg.vector_norm(g.reshape(g.shape[0], -1).float(), dim=1) ** 2
        for g, c in zip(grads, counted or [True] * len(grads)) if c
    )
    if group_sum is not None:
        sq = group_sum(sq)
    norm = sq.sqrt()
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.view((-1,) + (1,) * (g.ndim - 1)).to(g.dtype))
    return norm


@torch.no_grad()
def nesterov_direction(
    delta: torch.Tensor, buf: torch.Tensor, momentum: float = 0.9, nesterov: bool = True,
) -> torch.Tensor:
    """One Nesterov-momentum SGD step as optax's ``sgd(lr, momentum,
    nesterov)`` computes it, over an explicit momentum tensor: ``buf <-
    momentum * buf + delta`` in place (a zero ``buf`` makes the first step
    ``buf = delta``, as torch's SGD does), and the returned direction
    ``delta + momentum * buf`` (``buf`` itself without Nesterov). The
    caller adds it with ``alpha=-lr`` (the update is ``-lr *
    direction``), one pass over the parameter."""
    buf.mul_(momentum).add_(delta)
    return torch.add(delta, buf, alpha=momentum) if nesterov else buf
