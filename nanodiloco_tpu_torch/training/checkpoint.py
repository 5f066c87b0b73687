"""Checkpoint and resume of the whole DiLoCo state: port of
``nanodiloco_tpu/training/checkpoint.py`` (orbax there, ``torch.save``
here).

One file per step, ``step_<n>.pt``: a ``torch.save`` of one named tree
whose fields follow the JAX ``DilocoState``:

- ``params``: every worker's weights, ``[W, ...]`` per leaf;
- ``inner_opt_state``: AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``
  by leaf name (``"layers/wq"``, ...);
- ``snapshot``: the weights at the last outer sync;
- ``outer_opt_state``: the Nesterov ``momentum_buffer`` by leaf name;
- ``inner_step_count``: completed inner steps.

A save writes ``step_<n>.tmp``, fsyncs it, renames it into place and
fsyncs the directory, so a crash mid-save never becomes ``latest_step``.
Saves are synchronous only (the JAX module's own note says why its
asynchronous mode is not to be trusted). A restore memory-maps the file
on the host and copies it leaf by leaf into the live state, so the card
never holds two states: at Llama-3-8B width one state is most of it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable

import torch

from nanodiloco_tpu_torch.models.llama import Params
from nanodiloco_tpu_torch.parallel.diloco import DilocoState
from nanodiloco_tpu_torch.resilience.retry import RetryPolicy, retry_call

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def named_leaves(tree: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``[("embed", t), ("final_norm", t), ("layers/attn_norm", t), ...]``
    in ``tree_leaves`` order (sorted keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def state_tree(state: DilocoState) -> dict[str, Any]:
    """The named tree a checkpoint holds. Its tensors are the live ones
    (detached views, no copies)."""
    inner, outer = {}, {}
    for name, p in named_leaves(state.params):
        st = state.inner_opt.state.get(p)
        if st:
            inner[name] = {k: st[k] for k in ("exp_avg", "exp_avg_sq", "step")}
    for name, s in named_leaves(state.snapshot):
        st = state.outer_opt.state.get(s)
        if st and st.get("momentum_buffer") is not None:
            outer[name] = {"momentum_buffer": st["momentum_buffer"]}

    def detached(tree):
        if isinstance(tree, dict):
            return {k: detached(v) for k, v in tree.items()}
        return tree.detach()

    return {
        "params": detached(state.params),
        "inner_opt_state": inner,
        "snapshot": detached(state.snapshot),
        "outer_opt_state": outer,
        "inner_step_count": int(state.inner_step_count),
    }


class CheckpointManager:
    """``retry``: a RetryPolicy wrapped around every save and restore
    attempt (jittered exponential backoff with a deadline); None keeps
    the raw single attempt. ``on_event`` receives a ``{"retry": op,
    "attempt": ..., ...}`` record per backoff (the train loop passes the
    metrics logger, so IO flakiness lands in the run's JSONL)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        retry: RetryPolicy | None = None,
        on_event: Callable[[dict], None] | None = None,
    ) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.retry = retry
        self._on_event = on_event or (lambda rec: None)
        os.makedirs(self.directory, exist_ok=True)

    def _attempt(self, op: str, fn: Callable[[], Any]) -> Any:
        def note(attempt: int, exc: BaseException, delay: float) -> None:
            self._on_event({
                "retry": op, "attempt": attempt,
                "delay_s": round(delay, 3),
                "error": f"{type(exc).__name__}: {exc}"[:300],
            })

        if self.retry is None:
            return fn()
        return retry_call(fn, op=op, policy=self.retry, on_retry=note)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list[int]:
        """Committed steps, oldest first (``.tmp`` files never count)."""
        found = (_STEP_FILE.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: DilocoState) -> None:
        """Write ``step_<step>.pt`` (replacing one of that step) and keep
        the newest ``max_to_keep``."""
        tree = state_tree(state)
        final, tmp = self.path(step), os.path.join(self.directory, f"step_{step}.tmp")

        def attempt():
            torch.save(tree, tmp)
            _fsync(tmp)
            os.replace(tmp, final)
            _fsync(self.directory)

        self._attempt("ckpt_save", attempt)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self.path(old))

    def _load(self, step: int | None) -> dict[str, Any]:
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        return self._attempt(
            "ckpt_restore",
            lambda: torch.load(self.path(step), map_location="cpu", mmap=True,
                               weights_only=True),
        )

    def restore_raw(self, step: int | None = None, only: set[str] | None = None) -> dict:
        """The saved tree without a live state to restore into: nested
        dicts of CPU tensors memory-mapped from the file (a leaf's bytes
        are read only when it is used). ``only`` names the top-level
        fields to return (e.g. {"snapshot"} for serving: the merged
        weights alone, no per-worker params and no moments)."""
        saved = self._load(step)
        if only is None:
            return saved
        missing = set(only) - set(saved)
        if missing:
            raise KeyError(f"checkpoint has no field(s) {sorted(missing)}; "
                           f"available: {sorted(saved)}")
        return {k: saved[k] for k in only}

    def saved_worker_count(self, step: int | None = None) -> int:
        """Leading (worker) dimension of the saved params (the file is
        memory-mapped; no array data is read)."""
        return int(named_leaves(self._load(step)["params"])[0][1].shape[0])

    @torch.no_grad()
    def restore(self, state: DilocoState, step: int | None = None) -> DilocoState:
        """Copy the checkpoint into ``state``, a live state of the same
        worker count and model: every leaf bit for bit, AdamW's moments
        and step counts and the outer momentum included."""
        saved = self._load(step)
        _copy_into(state.params, saved["params"], "params")
        _copy_into(state.snapshot, saved["snapshot"], "snapshot")
        for name, p in named_leaves(state.params):
            st = saved["inner_opt_state"].get(name)
            if st is not None:
                live = state.inner_opt.state[p]
                for k in ("exp_avg", "exp_avg_sq"):
                    if k not in live:
                        live[k] = torch.empty_like(p)
                    live[k].copy_(st[k])
                live["step"] = st["step"].clone()
        _restore_momentum(state, saved)
        state.inner_step_count = int(saved["inner_step_count"])
        return state

    @torch.no_grad()
    def restore_elastic(self, fresh_state: DilocoState, step: int | None = None) -> DilocoState:
        """Restore into a DIFFERENT worker count. Checkpoints are written
        at outer-sync boundaries, where every worker equals the snapshot,
        so: the snapshot, the outer momentum and the step count are
        restored exactly; every worker of ``fresh_state`` is set to the
        snapshot; AdamW's moments start at zero (they are per-worker state
        of the old W) with its step count advanced to the restored step,
        so neither the bias correction nor the LR schedule re-warms."""
        saved = self._load(step)
        _copy_into(fresh_state.snapshot, saved["snapshot"], "snapshot")
        _restore_momentum(fresh_state, saved)
        count = int(saved["inner_step_count"])
        for (_, p), (_, s) in zip(named_leaves(fresh_state.params),
                                  named_leaves(fresh_state.snapshot)):
            p.copy_(s.unsqueeze(0).expand_as(p))
            fresh_state.inner_opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }
        fresh_state.inner_step_count = count
        return fresh_state


def _copy_into(live: Params, saved: Params, field: str) -> None:
    saved_leaves = dict(named_leaves(saved))
    for name, t in named_leaves(live):
        if name not in saved_leaves:
            raise KeyError(f"checkpoint {field} has no leaf {name!r} (different model?)")
        s = saved_leaves[name]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {field} leaf {name!r} is {s.dtype} {tuple(s.shape)}, the "
                f"live one {t.dtype} {tuple(t.shape)} (different model or worker count?)"
            )
        t.copy_(s)


def _restore_momentum(state: DilocoState, saved: dict[str, Any]) -> None:
    for name, s in named_leaves(state.snapshot):
        st = saved["outer_opt_state"].get(name)
        if st is not None:
            live = state.outer_opt.state[s]
            if live.get("momentum_buffer") is None:
                live["momentum_buffer"] = torch.empty_like(s)
            live["momentum_buffer"].copy_(st["momentum_buffer"])


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
