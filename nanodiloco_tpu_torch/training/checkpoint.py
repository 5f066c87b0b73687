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

Under a process group (``parallel/mesh.py``) the file is the same, with
every worker's rows: rank 0 writes the tree's skeleton at the full
``[W, ...]`` shapes without its bytes (``torch.serialization.skip_data``),
maps the file shared and fills it leaf by leaf, gathering the other
ranks' rows of one leaf at a time (it never holds more than one leaf of
theirs); the step is committed by rank 0 alone and the other ranks wait
for its verdict. A restore reads the file on every rank, each keeping its
own rows, so a checkpoint does not depend on the world size it was
written at: it resumes at another, and at another W elastically.
Under fsdp and tp (``parallel/sharding.py``) the file still holds whole
leaves: rank 0 places each rank's slice of a leaf where its box lies
(the snapshot's and the momentum's from worker group 0's ranks alone),
and a restore keeps this rank's box of each leaf, so the same file
resumes at any ``(G, fsdp, tp)``, one process included.
It writes no CRC-32 into the zip records: ``torch.load`` never reads one
back (a flipped data byte loads silently with or without it), and
computing it took about half of a save's time.
Saves are synchronous only (the JAX module's own note says why its
asynchronous mode is not to be trusted). Every save and restore attempt
asks the fault plan first (``resilience/faults.check_io``), so an
injected ``io_error`` runs through the retry path. A restore memory-maps the file
on the host and copies it leaf by leaf into the live state, so the card
never holds two states: at Llama-3-8B width one state is most of it.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import re
from typing import Any, Callable

import torch
from torch.utils.serialization import config as serialization_config

from nanodiloco_tpu_torch.models.llama import Params, tree_leaves
from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh
from nanodiloco_tpu_torch.parallel.sharding import local_box, named_leaves, spec_of, whole_shape
from nanodiloco_tpu_torch.resilience import faults
from nanodiloco_tpu_torch.resilience.retry import RetryPolicy, retry_call

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def committed_steps(directory: str) -> list[int]:
    """The committed checkpoint steps in ``directory``, oldest first: a
    save writes ``step_<n>.tmp`` and renames it to ``step_<n>.pt`` once
    it is on disk, so ``.tmp`` files never count."""
    found = (_STEP_FILE.fullmatch(name) for name in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


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


def _tensor_items(tree, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """Every tensor of a nested dict/list tree with its path, in a fixed
    (insertion) order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tensor_items(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _tensor_items(v, path + (i,))]
    return [(path, tree)] if torch.is_tensor(tree) else []


def _leaf_name(path: tuple) -> str | None:
    """The parameter a ``state_tree`` path holds a copy or a moment of
    ("layers/wq", ...), None for a path that is no parameter's (the step
    counts, the launch rounds)."""
    if path[-1] in ("exp_avg", "exp_avg_sq", "momentum_buffer"):
        return path[-2]
    if path[0] in ("params", "snapshot"):
        return "/".join(path[1:])
    if path[0] == "pending":
        return "/".join(str(k) for k in path[2:])
    return None


def _spec(path: tuple, mesh: WorkerMesh) -> tuple:
    """How a ``state_tree`` path's tensor is laid out over the mesh: the
    worker axis of the per-worker leaves (the params and the inner moments
    and step counts), then a parameter's own spec under fsdp or tp."""
    name = _leaf_name(path)
    spec = spec_of(name) if name is not None and mesh.sharded else ()
    return (("diloco",) + spec) if path[0] in ("params", "inner_opt_state") else spec


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _skeleton(tree: dict, mesh: WorkerMesh):
    """``tree`` with each leaf a rank holds part of replaced by a fake
    tensor of the whole shape (no storage): the per-worker leaves at the
    full ``[W, ...]``, under fsdp and tp every parameter's whole. What rank
    0 writes without data and fills afterwards."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        spec = _spec(path, mesh) if torch.is_tensor(t) else ()
        if spec:
            shape = whole_shape(t.shape, spec, mesh)
            if spec[0] == "diloco":
                shape = (mesh.num_workers,) + shape[1:]
            with mode:
                return torch.empty(shape, dtype=t.dtype)
        return t

    return walk(tree, ())


class CheckpointManager:
    """``retry``: a RetryPolicy wrapped around every save and restore
    attempt (jittered exponential backoff with a deadline); None keeps
    the raw single attempt. ``on_event`` receives a ``{"retry": op,
    "attempt": ..., ...}`` record per backoff (the train loop passes the
    metrics logger, so IO flakiness lands in the run's JSONL). ``mesh``:
    the process group's view of the workers (None, or one without a
    group: the state holds every worker)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        retry: RetryPolicy | None = None,
        on_event: Callable[[dict], None] | None = None,
        mesh: WorkerMesh | None = None,
    ) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.retry = retry
        self._on_event = on_event or (lambda rec: None)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
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
        the newest ``max_to_keep``. Under a process group every rank
        calls it: see ``_save_gathered``."""
        tree = state_tree(state)
        final, tmp = self.path(step), os.path.join(self.directory, f"step_{step}.tmp")
        if self.mesh is not None:
            return self._save_gathered(step, tree, final, tmp)

        def attempt():
            faults.check_io("save")  # injection hook (io_error op=save)
            with serialization_config.patch({"save.compute_crc32": False}):
                torch.save(tree, tmp)
            _fsync(tmp)
            os.replace(tmp, final)
            _fsync(self.directory)

        self._attempt("ckpt_save", attempt)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self.path(old))

    @torch.no_grad()
    def _save_gathered(self, step: int, tree: dict, final: str, tmp: str) -> None:
        """The save under a process group. Rank 0 writes the tree's
        skeleton, every leaf at its whole shape (the per-worker ones at
        ``[W, ...]``), without its bytes (``torch.serialization.skip_data``),
        reserves its blocks (a full disk fails here, as an error, not as a
        fault in the fill), maps the file shared and fills it leaf by leaf,
        gathering the other ranks' slices of one leaf at a time; it alone
        commits, and every rank learns each outcome."""
        mesh = self.mesh
        err = None
        if mesh.is_root:
            skeleton = _skeleton(tree, mesh)

            def attempt():
                faults.check_io("save")  # injection hook (io_error op=save)
                with torch.serialization.skip_data(materialize_fake_tensors=True), \
                        serialization_config.patch({"save.compute_crc32": False}):
                    torch.save(skeleton, tmp)
                _reserve(tmp)

            try:
                self._attempt("ckpt_save", attempt)
            except Exception as e:
                err = e
            del skeleton
        self._verdict(err, f"write checkpoint step {step}")
        out = None
        if mesh.is_root:
            with torch.serialization.set_default_mmap_options(mmap.MAP_SHARED):
                out = torch.load(tmp, map_location="cpu", mmap=True, weights_only=True)
        for path, t in _tensor_items(tree):
            spec = _spec(path, mesh)
            if not spec:
                if out is not None:
                    _at(out, path).copy_(t)
                continue
            # a per-worker leaf from every rank; a whole-model one (the
            # snapshot's, a momentum's) from worker group 0's ranks
            group = "all" if spec[0] == "diloco" else "shard"
            if group == "shard" and mesh.group_index:
                continue
            parts = mesh.gather_to_root(t, tag="checkpoint", group=group)
            if out is not None:
                dst = _at(out, path)
                for r, part in enumerate(parts):
                    dst[local_box(spec, dst.shape, dataclasses.replace(mesh, rank=r))].copy_(part)
            del parts
        err = None
        if mesh.is_root:
            del out
            try:
                _fsync(tmp)
                os.replace(tmp, final)
                _fsync(self.directory)
                for old in self.steps()[: -self.max_to_keep]:
                    os.remove(self.path(old))
            except Exception as e:
                err = e
        self._verdict(err, f"commit checkpoint step {step}")

    def _verdict(self, err: BaseException | None, what: str) -> None:
        """Rank 0's outcome of a step of a gathered save, on every rank: a
        failure raises everywhere at the same point (no rank is left
        waiting in a collective)."""
        flag = torch.tensor([int(err is None)], dtype=torch.int32)
        self.mesh.broadcast_(flag, tag="checkpoint")
        if int(flag.item()):
            return
        if err is not None:
            raise err
        raise RuntimeError(f"rank 0 failed to {what}")

    def _mine(self, tree, path: tuple = ()):
        """This rank's box of every tensor of a saved tree, as views: its
        worker rows of a per-worker leaf and its slices under fsdp and tp
        (the whole tree without a process group)."""
        if self.mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: self._mine(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._mine(v, path + (i,)) for i, v in enumerate(tree)]
        if not torch.is_tensor(tree) or not tree.ndim:
            return tree
        return tree[local_box(_spec(path, self.mesh), tree.shape, self.mesh)]

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
        saved = self._mine(saved)
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
        saved = {k: v for k, v in saved.items() if k not in ("params", "inner_opt_state")}
        saved = self._mine(saved)
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


def _reserve(path: str) -> None:
    """Allocate every block of ``path`` (a sparse skeleton's holes
    included), so filling it through a shared mapping cannot run out of
    space."""
    fd = os.open(path, os.O_RDWR)
    try:
        os.posix_fallocate(fd, 0, os.fstat(fd).st_size)
    finally:
        os.close(fd)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
