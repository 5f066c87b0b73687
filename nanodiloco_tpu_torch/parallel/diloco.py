"""DiLoCo, classic rounds: port of ``nanodiloco_tpu/parallel/diloco.py``.

One process and one device hold all W workers. Every worker's
parameters live in one tensor per weight with a leading worker axis
``[W, ...]`` (the JAX package's stacked pytree, which it ``vmap``s): the
model runs all workers in one batched pass, so each op, the attention
kernels included, launches once for W workers. Workers stay independent
under autograd because the summed per-worker losses touch disjoint
slices.

- Inner step: ``grad_accum`` microbatches, each backpropagating its
  per-worker ``sum_loss`` into ``.grad``; dividing worker w's slice by its
  token total gives the exact token-weighted mean of the JAX package.
  Then a per-worker global-norm clip and AdamW under warmup-cosine.
- Outer step: pseudo-gradient ``snapshot - mean_w(params_w)``, Nesterov
  SGD on the snapshot, every worker reset to it. The inner AdamW state is
  not reset, as in the JAX package.

Updates happen in place (PyTorch idiom; the JAX state is immutable and
donated): ``inner_step``/``outer_step``/``round_step`` return the same
state object they were given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    Params,
    causal_lm_loss,
    init_params,
    resolve_device,
    tree_leaves,
    tree_map,
)
from nanodiloco_tpu_torch.training.optim import (
    clip_per_worker_,
    inner_optimizer,
    outer_optimizer,
    warmup_cosine_schedule,
)


@dataclasses.dataclass(frozen=True)
class DilocoConfig:
    """The classic-round fields of the JAX ``DilocoConfig``. The rest of
    its options are listed and raise until they are ported."""

    num_workers: int = 1
    inner_steps: int = 100          # H: inner steps between outer syncs
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr: float = 4e-4                # inner AdamW lr
    outer_lr: float = 0.7           # outer SGD lr
    outer_momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    grad_accum: int = 1             # microbatches per inner step
    offload_snapshot: bool = False
    outer_comm_dtype: str | None = None
    outer_wire_collective: bool = False
    quarantine_nonfinite: bool = False
    dynamics_metrics: bool = False
    async_outer: bool = False
    inner_steps_per_worker: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        waiting = {
            "offload_snapshot": self.offload_snapshot,
            "outer_comm_dtype": self.outer_comm_dtype is not None,
            "outer_wire_collective": self.outer_wire_collective,
            "quarantine_nonfinite": self.quarantine_nonfinite,
            "dynamics_metrics": self.dynamics_metrics,
            "async_outer": self.async_outer,
            "inner_steps_per_worker": self.inner_steps_per_worker is not None,
        }
        asked = [name for name, on in waiting.items() if on]
        if asked:
            raise NotImplementedError(
                f"DiLoCo options {asked} are not ported yet (ROADMAP.md, Queue A item 2)"
            )


@dataclasses.dataclass
class DilocoState:
    params: Params                     # [W, ...] leaf tensors, requires_grad
    inner_opt: torch.optim.AdamW       # its state holds the [W, ...] moments
    snapshot: Params                   # unstacked: params at the last sync
    outer_opt: torch.optim.SGD         # its state holds the Nesterov momentum
    inner_step_count: int = 0          # completed inner steps


class Diloco:
    """Owns the inner and outer steps of classic DiLoCo on one device."""

    def __init__(self, model_cfg: LlamaConfig, cfg: DilocoConfig,
                 device: str | torch.device = "cuda"):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.schedule = warmup_cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps)

    # -- init ---------------------------------------------------------------

    def init_state(
        self, generator: torch.Generator | None = None, params: Params | None = None
    ) -> DilocoState:
        """Every worker and the snapshot start from one tree: ``params``
        if given (e.g. converted from the JAX package with
        ``params_from_numpy``), else ``init_params(generator, ...)``."""
        if params is None:
            if generator is None:
                raise ValueError("init_state needs a generator or params")
            params = init_params(generator, self.model_cfg, self.device)
        W = self.cfg.num_workers
        snapshot = tree_map(lambda p: p.detach().to(self.device).clone(), params)
        stacked = tree_map(
            lambda p: p.unsqueeze(0).repeat((W,) + (1,) * p.ndim).requires_grad_(True),
            snapshot,
        )
        return DilocoState(
            params=stacked,
            inner_opt=inner_optimizer(tree_leaves(stacked), self.cfg.weight_decay),
            snapshot=snapshot,
            outer_opt=outer_optimizer(
                tree_leaves(snapshot), self.cfg.outer_lr, self.cfg.outer_momentum,
                self.cfg.nesterov,
            ),
        )

    # -- inner step (no cross-worker traffic) --------------------------------

    def _as_tokens(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return t.to(device=self.device, dtype=torch.long)

    def inner_step(self, state: DilocoState, tokens, loss_mask):
        """tokens/loss_mask: [W, accum, B, S]. One AdamW update per worker
        from ``accum`` token-weighted microbatch gradients. Returns
        (state, [W] losses), each the mean of the microbatch mean losses."""
        tokens = self._as_tokens(tokens)
        loss_mask = self._as_tokens(loss_mask)
        W, A = self.cfg.num_workers, self.cfg.grad_accum
        if tokens.ndim != 4:
            raise ValueError(f"tokens must be [W, accum, B, S]; got shape {tuple(tokens.shape)}")
        if tokens.shape[0] != W:
            raise ValueError(f"batch worker axis is {tokens.shape[0]} but num_workers is {W}")
        if tokens.shape[1] != A:
            raise ValueError(f"batch accumulation axis is {tokens.shape[1]} but grad_accum is {A}")
        leaves = tree_leaves(state.params)
        loss_sum = torch.zeros(W, device=self.device)
        n_sum = torch.zeros(W, device=self.device)
        for a in range(A):
            loss, aux = causal_lm_loss(
                state.params, tokens[:, a], self.model_cfg, loss_mask[:, a]
            )
            aux["sum_loss"].sum().backward()
            loss_sum += loss.detach()
            n_sum += aux["n_tokens"].detach()
        with torch.no_grad():
            inv = 1.0 / n_sum.clamp_min(1e-9)
            for p in leaves:
                p.grad.mul_(inv.view((-1,) + (1,) * (p.ndim - 1)).to(p.grad.dtype))
            if self.cfg.clip_norm is not None:
                clip_per_worker_([p.grad for p in leaves], self.cfg.clip_norm)
        for group in state.inner_opt.param_groups:
            group["lr"] = self.schedule(state.inner_step_count)
        state.inner_opt.step()
        state.inner_opt.zero_grad(set_to_none=True)
        state.inner_step_count += 1
        return state, loss_sum / A

    # -- outer step (the only cross-worker traffic) --------------------------

    @torch.no_grad()
    def outer_step(self, state: DilocoState) -> DilocoState:
        """Nesterov SGD on the snapshot with ``snapshot - mean_w(params_w)``,
        then every worker reset to the new snapshot."""
        snaps, workers = tree_leaves(state.snapshot), tree_leaves(state.params)
        for s, p in zip(snaps, workers):
            s.grad = s - p.mean(dim=0)
        state.outer_opt.step()
        for s, p in zip(snaps, workers):
            s.grad = None
            p.copy_(s.unsqueeze(0).expand_as(p))
        return state

    def round_step(self, state: DilocoState, tokens, loss_mask):
        """One full round: ``inner_steps`` inner updates, then the outer
        sync. tokens/loss_mask: [H, W, accum, B, S]. Returns (state,
        [H, W] losses)."""
        H = self.cfg.inner_steps
        if len(tokens) != H or np.ndim(tokens) != 5:
            raise ValueError(
                f"round tokens must be [inner_steps={H}, W, accum, B, S]; "
                f"got {tuple(np.shape(tokens))}"
            )
        losses = []
        for h in range(H):
            state, loss = self.inner_step(state, tokens[h], loss_mask[h])
            losses.append(loss)
        return self.outer_step(state), torch.stack(losses)
