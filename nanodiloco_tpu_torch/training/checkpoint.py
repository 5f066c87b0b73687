"""Checkpoint and resume of the whole DiLoCo state: port of
``nanodiloco_tpu/training/checkpoint.py`` (orbax there, ``torch.save``
here).

One file per step, ``step_<n>.pt``: a ``torch.save`` of one named tree
whose fields follow the JAX ``DilocoState``:

- ``params``: every worker's weights, ``[W, ...]`` per leaf;
- ``inner_opt_state``: AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``
  (a ``[W]`` count per worker) by leaf name (``"layers/wq"``, ...); a
  file with one scalar ``step`` per leaf restores with it broadcast;
- ``snapshot``: the weights at the last outer sync;
- ``outer_opt_state``: the Nesterov ``momentum_buffer`` by leaf name;
- ``inner_step_count``: completed inner steps;

and, for the async outer path (JAX ``AsyncDilocoState``), ``pending``
(the FIFO of launched merges, oldest first), ``pending_round`` and
``launched_round``; for streaming DiLoCo (JAX ``StreamingState``),
``outer_opt_states`` (one momentum tree per fragment) and ``pending``
(one merged fragment per fragment) in place of ``outer_opt_state``.

A save writes ``step_<n>.tmp``, fsyncs it, renames it into place and
fsyncs the directory, so a crash mid-save never becomes ``latest_step``.
Saves are synchronous only (the JAX module's own note says why its
asynchronous mode is not to be trusted). Every save and restore attempt
asks the fault plan first (``resilience/faults.check_io``), so an
injected ``io_error`` runs through the retry path. A restore memory-maps the file
on the host and copies it leaf by leaf into the live state, so the card
never holds two states: at Llama-3-8B width one state is most of it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable

import torch

from nanodiloco_tpu_torch.models.llama import Params, tree_leaves
from nanodiloco_tpu_torch.resilience import faults
from nanodiloco_tpu_torch.resilience.retry import RetryPolicy, retry_call

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def committed_steps(directory: str) -> list[int]:
    """The committed checkpoint steps in ``directory``, oldest first: a
    save writes ``step_<n>.tmp`` and renames it to ``step_<n>.pt`` once
    it is on disk, so ``.tmp`` files never count."""
    found = (_STEP_FILE.fullmatch(name) for name in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def named_leaves(tree: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``[("embed", t), ("final_norm", t), ("layers/attn_norm", t), ...]``
    in ``tree_leaves`` order (sorted keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _momentum_tree(momentum: Params) -> dict[str, dict[str, torch.Tensor]]:
    return {name: {"momentum_buffer": b.detach()} for name, b in named_leaves(momentum)}


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def state_tree(state) -> dict[str, Any]:
    """The named tree a checkpoint holds. Its tensors are the live ones
    (detached views, no copies)."""
    inner = {}
    for name, p in named_leaves(state.params):
        st = state.inner_opt.state[p]
        inner[name] = {k: st[k] for k in ("exp_avg", "exp_avg_sq", "step")}
    tree = {
        "params": _detached(state.params),
        "inner_opt_state": inner,
        "snapshot": _detached(state.snapshot),
        "inner_step_count": int(state.inner_step_count),
    }
    if hasattr(state, "outer_opt_states"):  # streaming
        tree["outer_opt_states"] = [_momentum_tree(m) for m in state.outer_opt_states]
        tree["pending"] = [_detached(f) for f in state.pending]
        return tree
    tree["outer_opt_state"] = _momentum_tree(state.outer_opt_state)
    if hasattr(state, "pending"):  # async outer
        tree["pending"] = [_detached(f) for f in state.pending]
        tree["pending_round"] = torch.tensor(state.pending_round, dtype=torch.int64)
        tree["launched_round"] = int(state.launched_round)
    return tree


def _state_kind(state) -> str:
    if hasattr(state, "outer_opt_states"):
        return "streaming"
    return "async" if hasattr(state, "pending") else "classic"


def _check_kind(saved: dict, state) -> None:
    """A checkpoint restores only into a state of its own kind."""
    kind = _state_kind(state)
    need = {"streaming": {"outer_opt_states", "pending"},
            "async": {"outer_opt_state", "pending", "pending_round", "launched_round"},
            "classic": {"outer_opt_state"}}[kind]
    missing = need - set(saved)
    extra = {"pending", "outer_opt_states"} & set(saved) - need
    if missing or extra:
        raise KeyError(
            f"checkpoint has no field(s) {sorted(missing)} or extra field(s) "
            f"{sorted(extra)}; available: {sorted(saved)} (target state is {kind}: "
            "match streaming_fragments and async_outer to the checkpoint)"
        )


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
        return committed_steps(self.directory)

    @property
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write ``step_<step>.pt`` (replacing one of that step) and keep
        the newest ``max_to_keep``."""
        tree = state_tree(state)
        final, tmp = self.path(step), os.path.join(self.directory, f"step_{step}.tmp")

        def attempt():
            faults.check_io("save")  # injection hook (io_error op=save)
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
        def attempt():
            faults.check_io("restore")  # injection hook (io_error op=restore)
            return torch.load(self.path(step), map_location="cpu", mmap=True,
                              weights_only=True)

        return self._attempt("ckpt_restore", attempt)

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
    def restore(self, state, step: int | None = None):
        """Copy the checkpoint into ``state``, a live state of the same
        kind, worker count and model: every leaf bit for bit, AdamW's
        moments and step counts, the outer momentum and the async or
        streaming pending merges included."""
        saved = self._load(step)
        _check_kind(saved, state)
        _copy_into(state.params, saved["params"], "params")
        _copy_into(state.snapshot, saved["snapshot"], "snapshot")
        W = int(tree_leaves(state.params)[0].shape[0])
        for name, p in named_leaves(state.params):
            st = saved["inner_opt_state"].get(name)
            if st is not None:
                live = state.inner_opt.state[p]
                for k in ("exp_avg", "exp_avg_sq"):
                    live[k].copy_(st[k])
                live["step"] = _worker_steps(st["step"], W)
        _restore_outer(state, saved)
        if _state_kind(state) == "async":
            state.pending_round = [int(r) for r in saved["pending_round"].tolist()]
            state.launched_round = int(saved["launched_round"])
        state.inner_step_count = int(saved["inner_step_count"])
        return state

    @torch.no_grad()
    def restore_elastic(self, fresh_state, step: int | None = None):
        """Restore into a DIFFERENT worker count. Checkpoints are written
        at outer-sync boundaries, where every worker equals the snapshot,
        so: the snapshot, the outer momentum (every fragment's, under
        streaming), the pending merges and launch rounds (async and
        streaming: global state, exact) and the step count are restored
        exactly; every worker of ``fresh_state`` is set to the snapshot;
        AdamW's moments start at zero (they are per-worker state of the
        old W) with every worker's step count advanced to the restored
        step, so neither the bias correction nor the LR schedule
        re-warms."""
        saved = self._load(step)
        _check_kind(saved, fresh_state)
        _copy_into(fresh_state.snapshot, saved["snapshot"], "snapshot")
        _restore_outer(fresh_state, saved)
        count = int(saved["inner_step_count"])
        W = int(tree_leaves(fresh_state.params)[0].shape[0])
        for (_, p), (_, s) in zip(named_leaves(fresh_state.params),
                                  named_leaves(fresh_state.snapshot)):
            p.copy_(s.unsqueeze(0).expand_as(p))
            live = fresh_state.inner_opt.state[p]
            live["exp_avg"].zero_()
            live["exp_avg_sq"].zero_()
            live["step"] = torch.full((W,), float(count))
        if _state_kind(fresh_state) == "async":
            fresh_state.pending_round = [int(r) for r in saved["pending_round"].tolist()]
            fresh_state.launched_round = int(saved["launched_round"])
        fresh_state.inner_step_count = count
        return fresh_state


def _worker_steps(saved_step: torch.Tensor, num_workers: int) -> torch.Tensor:
    """The [W] step counts of a saved leaf: a file of PRs before the
    per-worker counts holds one scalar, which every worker shares."""
    if saved_step.ndim == 0:
        return torch.full((num_workers,), float(saved_step))
    return saved_step.to(torch.float32).clone()


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


def _copy_momentum(live: Params, saved: dict) -> None:
    for name, b in named_leaves(live):
        st = saved.get(name)
        if st is not None:
            b.copy_(st["momentum_buffer"])


def _restore_outer(state, saved: dict[str, Any]) -> None:
    """The outer momentum and, where the state has them, the pending
    merges."""
    if _state_kind(state) == "streaming":
        if len(saved["outer_opt_states"]) != len(state.outer_opt_states):
            raise ValueError(
                f"checkpoint has {len(saved['outer_opt_states'])} fragments, the run "
                f"{len(state.outer_opt_states)} (streaming_fragments differs?)"
            )
        for live, sv in zip(state.outer_opt_states, saved["outer_opt_states"]):
            _copy_momentum(live, sv)
    else:
        _copy_momentum(state.outer_opt_state, saved["outer_opt_state"])
    if hasattr(state, "pending"):
        if len(saved["pending"]) != len(state.pending):
            raise ValueError(
                f"checkpoint has {len(saved['pending'])} pending merges, the run "
                f"{len(state.pending)} (outer_delay or streaming_fragments differs?)"
            )
        for live, sv in zip(state.pending, saved["pending"]):
            _copy_into(live, sv, "pending")


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
