"""Streaming DiLoCo (arXiv:2501.18512): port of
``nanodiloco_tpu/parallel/streaming.py``.

- Fragments. The parameter tree splits into P fragments of contiguous
  layers (a fragment is the slice ``layers[lo:hi]`` of every stacked layer
  tensor; ``embed`` rides with fragment 0, ``final_norm`` and ``lm_head``
  with fragment P-1). Each fragment still syncs once every H inner steps,
  but the fragments' syncs are staggered H/P steps apart.
- Launch and apply. A fragment's sync is a launch (its pseudo-gradient
  and the Nesterov step on the fragment's own momentum give a pending
  merged fragment) and, ``delay`` inner steps later, an apply (every
  worker blends the pending fragment in, ``theta_w <- a * global + (1 -
  a) * theta_w``, and it becomes the fragment's snapshot). With
  ``num_fragments=1, delay=0, merge_alpha=1`` this is classic DiLoCo bit
  for bit.

Cadence (1-based inner-step index t): fragment p launches when
``t % H == round((p + 1) * H / P) % H`` and applies ``delay`` steps
after, so fragment P-1 launches at t = H, 2H, ... as classic DiLoCo syncs.

A fragment's tensors are views into the stacked parameters and the
snapshot: launches and applies write through them in place. Under a
process group a launch's merge is the classic one's (``Diloco``'s partial
sums and one all-reduce a leaf), on the fragment's leaves. Streaming
over pipeline or sequence parallelism is not ported (ROADMAP item 7):
the port's model refuses ring attention and has no pipeline stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nanodiloco_tpu_torch.models.llama import Params, tree_leaves, tree_map
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig, DilocoState
from nanodiloco_tpu_torch.training.optim import StackedAdamW


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Streaming knobs on top of DilocoConfig (H = DilocoConfig.inner_steps)."""

    num_fragments: int = 2
    delay: int = 1            # inner steps between a fragment's launch and apply
    merge_alpha: float = 1.0  # 1 = hard reset to global (classic); 0.5 = the paper's mix

    def __post_init__(self):
        if self.num_fragments < 1:
            raise ValueError("num_fragments must be >= 1")
        if self.delay < 0:
            raise ValueError("delay must be >= 0")
        if not 0.0 < self.merge_alpha <= 1.0:
            raise ValueError("merge_alpha must be in (0, 1]")


@dataclasses.dataclass
class StreamingState:
    params: Params                  # stacked [W, ...]
    inner_opt: StackedAdamW
    snapshot: Params                # unstacked: the last merged params
    outer_opt_states: list[Params]  # per fragment: its Nesterov momentum
    pending: list[Params]           # per fragment: the merge awaiting its apply
    inner_step_count: int = 0


def fragment_bounds(num_layers: int, num_fragments: int) -> list[tuple[int, int]]:
    """Split [0, num_layers) into num_fragments near-even contiguous ranges."""
    if num_fragments > num_layers:
        raise ValueError(f"num_fragments={num_fragments} exceeds num_layers={num_layers}")
    edges = [round(i * num_layers / num_fragments) for i in range(num_fragments + 1)]
    return [(edges[i], edges[i + 1]) for i in range(num_fragments)]


def fragment_slice(tree: Params, p: int, bounds: list, stacked: bool) -> Params:
    """Fragment p's subtree of a param-shaped tree, as views. ``stacked``
    marks the leading [W] worker axis (the layer axis shifts by one)."""
    lo, hi = bounds[p]
    idx = (slice(None),) * (1 if stacked else 0) + (slice(lo, hi),)
    sub: Params = {"layers": {k: v[idx] for k, v in tree["layers"].items()}}
    if p == 0:
        sub["embed"] = tree["embed"]
    if p == len(bounds) - 1:
        sub["final_norm"] = tree["final_norm"]
        if "lm_head" in tree:
            sub["lm_head"] = tree["lm_head"]
    return sub


@torch.no_grad()
def fragment_write(full: Params, sub: Params, p: int, bounds: list, stacked: bool) -> Params:
    """Copy ``sub`` into fragment p's slice of ``full``, in place; returns
    ``full``."""
    for dst, src in zip(tree_leaves(fragment_slice(full, p, bounds, stacked)),
                        tree_leaves(sub)):
        dst.copy_(src)
    return full


class StreamingDiloco(Diloco):
    """Diloco with fragment-wise staggered outer syncs. Drive it with
    ``step(state, tokens, mask, t)`` (``t`` the 1-based inner-step index)
    or a whole round at a time with ``round_step``."""

    def __init__(self, model_cfg, cfg: DilocoConfig, scfg: StreamingConfig,
                 device: str | torch.device = "cuda", mesh=None):
        super().__init__(model_cfg, cfg, device, mesh)
        if cfg.quarantine_nonfinite:
            raise ValueError(
                "quarantine_nonfinite is classic-DiLoCo-only: streaming's fragment "
                "launches are staggered mid-round, so there is no single sync point "
                "at which a round's [W] finiteness verdict exists"
            )
        if cfg.dynamics_metrics:
            raise ValueError(
                "dynamics_metrics is classic-DiLoCo-only: streaming has no single "
                "sync point at which the whole-model pseudo-gradient and drift exist"
            )
        if cfg.async_outer:
            raise ValueError(
                "async_outer is classic-DiLoCo-only: streaming IS the fragment-"
                "granularity async outer step; a round-granularity delay on top would "
                "double-defer the same merges. Use the streaming delay here"
            )
        if cfg.inner_steps_per_worker is not None:
            raise ValueError(
                "inner_steps_per_worker is classic-DiLoCo-only: streaming's fragment "
                "cadence is derived from the uniform inner-step index"
            )
        if cfg.offload_snapshot:
            raise ValueError(
                "offload_snapshot is classic-DiLoCo-only: streaming reads snapshot "
                "slices on a staggered schedule, with no between-rounds window to "
                "park them in host memory"
            )
        self.scfg = scfg
        H, P = cfg.inner_steps, scfg.num_fragments
        if scfg.delay >= H:
            raise ValueError(f"delay={scfg.delay} must be < inner_steps={H}")
        if P > H:
            raise ValueError(
                f"num_fragments={P} exceeds inner_steps={H}: launch offsets would "
                "collide, defeating the stagger"
            )
        self.bounds = fragment_bounds(model_cfg.num_hidden_layers, P)
        self._launch_offsets = [round((p + 1) * H / P) % H for p in range(P)]

    def sync_payload_report(self) -> dict:
        """One streaming launch moves one fragment (~1/P of the tree): the
        mean over fragments."""
        rep = super().sync_payload_report()
        P = self.scfg.num_fragments
        rep["bytes_per_sync"] //= P
        rep["f32_bytes"] //= P
        rep["wire"] += f"; mean per fragment launch, {P} staggered/round"
        return rep

    # -- cadence -------------------------------------------------------------

    def due(self, t: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(fragments to launch, fragments to apply) at inner step t (1-based)."""
        H = self.cfg.inner_steps
        launch = tuple(p for p, off in enumerate(self._launch_offsets) if t % H == off)
        if self.scfg.delay == 0:
            return launch, launch
        apply_ = tuple(
            p for p, off in enumerate(self._launch_offsets)
            if t > self.scfg.delay and (t - self.scfg.delay) % H == off
        )
        return launch, apply_

    # -- init ----------------------------------------------------------------

    def init_state(self, generator: torch.Generator | None = None,
                   params: Params | None = None) -> StreamingState:  # type: ignore[override]
        base = super().init_state(generator, params)
        frags = [fragment_slice(base.snapshot, p, self.bounds, stacked=False)
                 for p in range(self.scfg.num_fragments)]
        return StreamingState(
            params=base.params, inner_opt=base.inner_opt, snapshot=base.snapshot,
            outer_opt_states=[tree_map(torch.zeros_like, f) for f in frags],
            pending=[tree_map(torch.clone, f) for f in frags],
            inner_step_count=base.inner_step_count,
        )

    # -- steps ---------------------------------------------------------------

    def step(self, state: StreamingState, tokens, loss_mask, t: int):
        """Inner step t with the fragment launches and applies due at t.
        A pending merge due at t applies BEFORE the step's inner update;
        with delay 0 launch and apply follow it, classic DiLoCo's order.
        Returns (state, [W] losses)."""
        launch, apply_ = self.due(t)
        if self.scfg.delay > 0:
            for p in apply_:
                self._apply_fragment(state, p)
        _, loss = self.inner_step(state_as_diloco(state), tokens, loss_mask)
        state.inner_step_count += 1
        for p in launch:
            self._launch_fragment(state, p)
            if self.scfg.delay == 0:
                self._apply_fragment(state, p)
        return state, loss

    def round_step(self, state: StreamingState, tokens, loss_mask):  # type: ignore[override]
        """One H-step round. tokens/loss_mask: [H, W, accum, B, S]. Returns
        (state, [H, W] losses, an all-ones [W] mask): the shape of the
        classic ``round_step`` (quarantine is refused here), the losses
        gathered from every rank under a process group."""
        H = self.cfg.inner_steps
        if len(tokens) != H or np.ndim(tokens) != 5:
            raise ValueError(
                f"round tokens must be [inner_steps={H}, W, accum, B, S]; "
                f"got {tuple(np.shape(tokens))}"
            )
        losses = []
        for h in range(H):
            state, loss = self.step(state, tokens[h], loss_mask[h],
                                    state.inner_step_count + 1)
            losses.append(loss)
        return (state, self.gather_workers(torch.stack(losses), dim=1),
                torch.ones(self.cfg.num_workers, dtype=torch.bool))

    @torch.no_grad()
    def _launch_fragment(self, state: StreamingState, p: int) -> None:
        """Fragment p's pseudo-gradient and Nesterov step -> pending[p]."""
        snap = fragment_slice(state.snapshot, p, self.bounds, stacked=False)
        frag_w = fragment_slice(state.params, p, self.bounds, stacked=True)
        snaps, pend = tree_leaves(snap), tree_leaves(state.pending[p])

        def merge(i: int, direction: torch.Tensor, alpha: float) -> None:
            pend[i].copy_(snaps[i]).add_(direction, alpha=alpha)

        self._outer_leaves(snap, frag_w, state.outer_opt_states[p], None, merge, False)

    @torch.no_grad()
    def _apply_fragment(self, state: StreamingState, p: int) -> None:
        """Blend pending fragment p into every worker, ``a * global + (1 -
        a) * theta_w``, and make it the fragment's snapshot (the next
        pseudo-gradient is measured from the merged point)."""
        a = self.scfg.merge_alpha
        merged = state.pending[p]
        frag_w = fragment_slice(state.params, p, self.bounds, stacked=True)
        for g, w in zip(tree_leaves(merged), tree_leaves(frag_w)):
            w = w.detach()
            w.copy_(a * g.unsqueeze(0) + (1.0 - a) * w)
        fragment_write(state.snapshot, merged, p, self.bounds, stacked=False)


def state_as_diloco(state: StreamingState) -> DilocoState:
    """A StreamingState seen through the DilocoState fields ``inner_step``
    reads and writes (params, inner_opt, inner_step_count); the caller
    carries the count back."""
    return DilocoState(params=state.params, inner_opt=state.inner_opt,
                       snapshot=state.snapshot, outer_opt_state={},
                       inner_step_count=state.inner_step_count)
