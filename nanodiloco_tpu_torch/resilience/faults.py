"""Schedule-driven fault injection: prove every recovery path, deterministically.

A copy of ``nanodiloco_tpu/resilience/faults.py`` (the JAX package's
``__init__`` imports jax, so the port keeps its own), with the
``nan_params`` surgery on the port's stacked ``[W, ...]`` torch state.

A resilience feature that has only ever seen hand-crafted states is a
claim, not a capability: the quarantine/heal path was exercised by
tests that poke NaNs into a ``DilocoState`` by hand, the watchdog's
stall sentinel by an injected clock, and resume by polite in-process
restarts. A fault PLAN drives the same failures through the REAL
training stack — the train loop's rounds, the checkpoint manager's
IO, the round-ahead prefetch thread — at an exact, reproducible step, so CI can
assert the outcome of each fault class end to end.

The plan is a JSON document (``--fault-plan plan.json``)::

    {"faults": [
      {"kind": "nan_params", "step": 4, "worker": 1},
      {"kind": "io_error",   "step": 3, "op": "save", "count": 2},
      {"kind": "stall",      "step": 2, "seconds": 1.5},
      {"kind": "crash",      "step": 5}
    ]}

Every fault is keyed by ``step`` (real inner-step count) and fires ONCE
when the train loop's step cursor reaches it — deterministic by step, no
wall-clock randomness, identical on every run with the same plan. The
train loop arms the plan with the cursor at 0 before its startup IO, so a
``step: 0`` io_error hits the initial dataset fetch / checkpoint
restore; steps >= 1 fire inside the training loop:

- ``nan_params``: poison worker ``worker``'s stacked replica with NaN
  before the dispatch covering ``step`` — the exact state surgery the
  hand-crafted quarantine unit tests perform (``poison_worker_params``
  is shared with them), now arriving through the live loop so
  ``quarantine_nonfinite`` + ``_heal_inner_opt`` are exercised end to
  end.
- ``io_error``: the next ``count`` checkpoint ``save``/``restore``
  attempts (``op``) raise ``InjectedIOError`` — exercises the retry/
  backoff path and, past the retry deadline, the alarm-and-continue
  degradation.
- ``stall``: the next round-prefetch call sleeps ``seconds`` — trips the
  watchdog's stall sentinel through the real heartbeat machinery.
- ``crash``: hard exit (``os._exit(code)``, default
  ``CRASH_EXIT_CODE``) at the first hook point at/after ``step`` —
  exercises checkpoint resume under the supervisor. ``"raise": true``
  raises ``InjectedCrash`` instead, for in-process tests that must
  survive the "crash".
- ``straggler``: for the next ``rounds`` rounds at/after ``step``, the
  train loop's per-round straggler hook sleeps ``seconds`` attributed to
  worker ``worker`` — a REAL wall-clock delay through the real loop, so
  the straggler policy's demote/restore and the goodput ledger's
  ``straggler_wait`` attribution are exercised end to end (in the
  stacked single-program harness this injected skew is the only source
  of per-worker duration spread — a real multi-island deployment gets
  it from per-island timing).
- ``resize``: write ``workers`` into the supervisor's on-disk
  ``workers.target`` control file (``"file"``, defaulting to
  ``$NANODILOCO_WORKERS_TARGET`` — the env the supervisor exports) and
  request a clean preempt exit at the next round boundary, so the
  supervisor relaunches the child at the new width through the SAME
  control-plane path an operator's write takes.

Hook contract: every hook is a module function that returns immediately
when no plan is installed (one ``is None`` check — the smoke gate
asserts a plan-free run and a no-op-plan run produce the same
trajectory). The train loop owns the step cursor (``advance``); the
checkpoint manager and batch feeder just ask.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

KINDS = ("nan_params", "io_error", "stall", "crash", "straggler", "resize")
IO_OPS = ("save", "restore", "fetch")

#: Exit code of an injected crash — distinct from the preempt (75) and
#: watchdog (76) codes so the supervisor books it against the restart
#: budget like any other crash.
CRASH_EXIT_CODE = 71


class InjectedIOError(OSError):
    """Raised by the io_error fault inside checkpoint save/restore."""


class InjectedCrash(RuntimeError):
    """Raise-mode crash fault (``"raise": true``) — lets an in-process
    test exercise the crash/resume path without losing its interpreter."""

    def __init__(self, step: int, code: int) -> None:
        super().__init__(f"injected crash at step {step} (exit code {code})")
        self.step = step
        self.code = code


class FaultPlan:
    """Parsed, validated fault schedule with firing bookkeeping.

    Thread-safe: the batch feeder's stall hook runs on the fused loop's
    prefetch thread while the train loop advances the cursor on the main
    thread.

    ``marker_path``: persistence for the fired set ACROSS process
    restarts. A crash fault kills the process; on resume the same plan
    file loads again, and without a record of what already fired the
    crash would re-fire at the same step forever — an injected fault
    must fire once per run lineage, not once per process. ``load``
    wires ``<plan>.fired`` automatically (one fault index per line,
    appended at fire time); use a fresh plan path (or delete the
    marker) to rerun a fault sequence from scratch."""

    def __init__(
        self, faults: list[dict[str, Any]], marker_path: str | None = None
    ) -> None:
        self._lock = threading.Lock()
        self._cursor = -1
        self._marker = marker_path
        self.fired: list[dict[str, Any]] = []  # records, in firing order
        already = set()
        if marker_path and os.path.exists(marker_path):
            with open(marker_path) as fh:
                already = {
                    int(x) for x in fh.read().split() if x.strip().isdigit()
                }
        self.faults = []
        for i, f in enumerate(faults):
            if not isinstance(f, dict):
                raise ValueError(f"fault #{i} is not an object: {f!r}")
            kind = f.get("kind")
            if kind not in KINDS:
                raise ValueError(
                    f"fault #{i} has unknown kind {kind!r}; use one of {KINDS}"
                )
            if not isinstance(f.get("step"), int) or f["step"] < 0:
                raise ValueError(
                    f"fault #{i} ({kind}) needs an integer step >= 0; got "
                    f"{f.get('step')!r}"
                )
            f = dict(f)
            if kind == "nan_params":
                if not isinstance(f.get("worker"), int) or f["worker"] < 0:
                    raise ValueError(
                        f"nan_params fault #{i} needs an integer worker >= 0"
                    )
            elif kind == "io_error":
                if f.get("op", "save") not in IO_OPS:
                    raise ValueError(
                        f"io_error fault #{i} op must be one of {IO_OPS}; "
                        f"got {f.get('op')!r}"
                    )
                f.setdefault("op", "save")
                f["count"] = int(f.get("count", 1))
                if f["count"] < 1:
                    raise ValueError(f"io_error fault #{i} count must be >= 1")
            elif kind == "stall":
                f["seconds"] = float(f.get("seconds", 1.0))
                if f["seconds"] <= 0:
                    raise ValueError(f"stall fault #{i} seconds must be > 0")
            elif kind == "crash":
                f["code"] = int(f.get("code", CRASH_EXIT_CODE))
                f["raise"] = bool(f.get("raise", False))
            elif kind == "straggler":
                if not isinstance(f.get("worker"), int) or f["worker"] < 0:
                    raise ValueError(
                        f"straggler fault #{i} needs an integer worker >= 0"
                    )
                f["seconds"] = float(f.get("seconds", 1.0))
                if f["seconds"] <= 0:
                    raise ValueError(
                        f"straggler fault #{i} seconds must be > 0"
                    )
                f["rounds"] = int(f.get("rounds", 1))
                if f["rounds"] < 1:
                    raise ValueError(
                        f"straggler fault #{i} rounds must be >= 1"
                    )
                f["_rounds_left"] = f["rounds"]
            elif kind == "resize":
                if not isinstance(f.get("workers"), int) or f["workers"] < 1:
                    raise ValueError(
                        f"resize fault #{i} needs an integer workers >= 1"
                    )
                if f.get("file") is not None and not isinstance(
                    f["file"], str
                ):
                    raise ValueError(
                        f"resize fault #{i} file must be a path string"
                    )
            f["_idx"] = i
            f["_fired"] = i in already
            if f["_fired"] and kind == "io_error":
                f["count"] = 0  # fully spent in a previous process life
            if f["_fired"] and kind == "straggler":
                f["_rounds_left"] = 0  # spent in a previous process life
            self.faults.append(f)

    @classmethod
    def from_dict(
        cls, doc: dict[str, Any], marker_path: str | None = None
    ) -> "FaultPlan":
        faults = doc.get("faults")
        if not isinstance(faults, list):
            raise ValueError(
                'fault plan must be {"faults": [...]} with a list of fault '
                f"objects; got {type(faults).__name__}"
            )
        return cls(faults, marker_path=marker_path)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f), marker_path=path + ".fired")

    # -- loop-side cursor --------------------------------------------------

    def advance(self, step: int) -> None:
        """Move the step cursor forward (the train loop calls this at the top
        of every dispatch unit — per step stepwise, per round fused)."""
        with self._lock:
            if step > self._cursor:
                self._cursor = step

    def _mark(self, f: dict[str, Any]) -> None:
        """Flip a fault to fired (caller holds the lock): record it for
        the JSONL timeline and append its index to the marker file so a
        crash-killed process does not re-fire it after resume."""
        f["_fired"] = True
        self.fired.append(self._record(f))
        if self._marker:
            try:
                with open(self._marker, "a") as fh:
                    fh.write(f"{f['_idx']}\n")
                    fh.flush()
                    os.fsync(fh.fileno())
            except OSError:
                pass  # a read-only plan dir degrades to per-process firing

    def take_due(self, kind: str) -> list[dict[str, Any]]:
        """Due (step <= cursor), unfired faults of ``kind`` — marked
        fired and recorded. The train loop consumes nan_params/crash this
        way at its hook points."""
        out = []
        with self._lock:
            for f in self.faults:
                if f["kind"] == kind and not f["_fired"] and f["step"] <= self._cursor:
                    self._mark(f)
                    out.append(f)
        return out

    def _record(self, f: dict[str, Any]) -> dict[str, Any]:
        return {
            k: v for k, v in f.items() if not k.startswith("_") and k != "raise"
        }

    def drain_fired(self) -> list[dict[str, Any]]:
        """Fired-fault records accumulated since the last drain — the
        train loop logs each as a ``{"fault": kind, ...}`` JSONL record so
        ``report`` can reconstruct the fault timeline. Covers faults
        fired off-thread too (a stall fires inside the prefetch
        thread's feed call)."""
        with self._lock:
            out, self.fired = self.fired, []
        return out

    # -- hook-side queries -------------------------------------------------

    def io_should_fail(self, op: str) -> bool:
        """True while a due io_error fault for ``op`` has attempts left
        (each call consumes one — ``count`` consecutive attempts fail,
        then the operation succeeds and the retry path is proven)."""
        with self._lock:
            for f in self.faults:
                if (
                    f["kind"] == "io_error"
                    and f["op"] == op
                    and f["step"] <= self._cursor
                    and f["count"] > 0
                ):
                    f["count"] -= 1
                    if not f["_fired"]:
                        self._mark(f)
                    return True
        return False

    def stall_seconds(self) -> float:
        """Seconds the next feed call should sleep (0.0 = no due stall)."""
        with self._lock:
            for f in self.faults:
                if f["kind"] == "stall" and not f["_fired"] and f["step"] <= self._cursor:
                    self._mark(f)
                    return f["seconds"]
        return 0.0

    def straggle_due(self) -> dict[int, float]:
        """Per-worker straggler seconds for the CURRENT round
        (``{worker: seconds}``; empty = no due straggler). Each due
        straggler fault contributes its ``seconds`` once per round for
        ``rounds`` consecutive calls — the train loop calls this exactly
        once per round."""
        out: dict[int, float] = {}
        with self._lock:
            for f in self.faults:
                if (
                    f["kind"] == "straggler"
                    and f["step"] <= self._cursor
                    and f.get("_rounds_left", 0) > 0
                ):
                    f["_rounds_left"] -= 1
                    if not f["_fired"]:
                        self._mark(f)
                    w = int(f["worker"])
                    out[w] = out.get(w, 0.0) + f["seconds"]
        return out


# -- module-level installation (the zero-cost-when-absent contract) ---------

_PLAN: FaultPlan | None = None


def install_plan(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def clear_plan() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> FaultPlan | None:
    return _PLAN


def check_io(op: str) -> None:
    """io_error hook (checkpoint.py save/restore attempts). One ``is
    None`` check on the fault-free path."""
    if _PLAN is None:
        return
    if _PLAN.io_should_fail(op):
        raise InjectedIOError(f"injected {op} failure (fault plan)")


def maybe_stall() -> float:
    """stall hook (the train loop's round prefetch). One ``is None``
    check on the fault-free path; sleeps in the calling thread so the
    watchdog's heartbeat machinery sees a REAL gap. Returns the seconds
    slept (0.0 when none), which the train loop books as the goodput
    ledger's ``stall``."""
    if _PLAN is None:
        return 0.0
    s = _PLAN.stall_seconds()
    if s > 0:
        time.sleep(s)
    return s


def maybe_straggle(owned=None) -> dict[int, float]:
    """straggler hook (train-loop round body, once per round): sleep the
    due per-worker straggler seconds ON the round's clock — a real
    wall-clock delay the round time, straggler policy, and goodput
    ledger all observe — and return the ``{worker: seconds}``
    attribution. ``owned``: the workers this process holds (all by
    default); under a process group only the rank holding a worker sleeps
    for it, and every rank returns the whole attribution. One ``is None``
    check on the fault-free path."""
    if _PLAN is None:
        return {}
    due = _PLAN.straggle_due()
    owned = None if owned is None else set(owned)
    total = sum(s for w, s in due.items() if owned is None or w in owned)
    if total > 0:
        time.sleep(total)
    return due


def fire_crash(fault: dict[str, Any]) -> None:
    """Execute a due crash fault the train loop took via ``take_due``. The
    hard default (``os._exit``) skips every teardown path on purpose —
    that IS the fault being simulated; raise-mode is for in-process
    tests."""
    if fault.get("raise"):
        raise InjectedCrash(fault["step"], fault["code"])
    import os

    # the hard crash skips EVERY teardown path by design — the flight
    # recorder must dump before the exit or the black box dies with the
    # process (the whole point of a black box)
    try:
        from nanodiloco_tpu_torch.obs import flightrec

        flightrec.dump_current(f"crash_fault:step{fault['step']}")
    except Exception:
        pass
    os._exit(fault["code"])


def poison_worker_params(state, worker: int):
    """NaN worker ``worker``'s slice of every stacked ``[W, ...]`` leaf of
    ``state.params`` in place (returns the state) — the nan_params fault's
    surgery, the same the hand-crafted quarantine tests perform
    (``p[worker] = nan`` per leaf), so the injected path and the
    unit-tested path cannot drift apart. torch is imported here: the
    fault module stays import-cheap for the hook sites."""
    import torch

    from nanodiloco_tpu_torch.models.llama import tree_leaves

    with torch.no_grad():
        for p in tree_leaves(state.params):
            p[worker] = float("nan")
    return state
