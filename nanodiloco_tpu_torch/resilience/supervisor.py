"""Preemption-safe auto-resume supervisor: restart the run, don't babysit it.

A copy of ``nanodiloco_tpu/resilience/supervisor.py`` (the JAX
package's ``__init__`` imports jax, so the port keeps its own). Two
edits: the child is ``python -m nanodiloco_tpu_torch``, and progress is
read from the port's checkpoint files (``step_<n>.pt``).

The training process owns graceful PREEMPTION (SIGTERM/SIGINT →
checkpoint at the next round boundary → exit ``PREEMPT_EXIT_CODE``);
this module owns everything after the exit. The supervisor runs the
train CLI as a child process and applies a policy per exit class:

- exit 0 — the run finished; the supervisor exits 0.
- ``PREEMPT_EXIT_CODE`` (75, EX_TEMPFAIL) — a preemption the child
  handled cleanly: restart IMMEDIATELY, no backoff, no restart budget
  consumed. Preemptible capacity cycling is the normal case DiLoCo
  exists for, not a failure.
- ``WATCHDOG_EXIT_CODE`` (76) — the child's watchdog pulled the run
  down (stall/NaN under ``--watch-action checkpoint-exit``): treated as
  a crash below, but recorded with its own reason.
- anything else (injected crash, OOM, segfault, a real bug) — restart
  from the latest checkpoint with jittered exponential backoff, against
  a ``max_restarts`` budget. Crash-LOOP detection: a restart that made
  no forward progress (latest checkpoint step did not advance) counts
  DOUBLE against the budget — a run dying at the same step is a bug,
  not bad luck, and must not burn capacity all night.
- after ``degrade_after`` consecutive no-progress failures at the
  current worker count, the supervisor degrades ELASTICALLY: it halves
  ``--num-workers`` (floored at ``min_workers``) and relaunches — the
  train loop's elastic resume (``CheckpointManager.restore_elastic``)
  restores the snapshot/outer state exactly at the new width (measured
  cost: +3.9% loss for ~10 steps, parity by ~50 — PERF.md). A crash
  caused by a sick host or a lost slice keeps the JOB alive at reduced
  width instead of dying at full width forever.

The supervisor forwards SIGTERM/SIGINT to the child and, once the
child has exited, exits itself with the child's code — preempting the
supervisor preempts the whole tree cleanly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from typing import Callable

from nanodiloco_tpu_torch.resilience.retry import jittered_backoff
from nanodiloco_tpu_torch.training.checkpoint import committed_steps

#: EX_TEMPFAIL — the child checkpointed at a round boundary and exited
#: because it was asked to (SIGTERM/SIGINT). Resume immediately.
PREEMPT_EXIT_CODE = 75
#: The child's watchdog forced an exit (--watch-action checkpoint-exit).
WATCHDOG_EXIT_CODE = 76

#: Environment variable the supervisor sets for the child: how many
#: restarts (of any class) preceded this launch. The train loop logs it
#: in its ``resume`` JSONL record so the fault timeline survives in one
#: stream.
RESTART_ENV = "NANODILOCO_RESTART"

#: Environment variable the supervisor sets for the child: seconds of
#: wall-clock between the PREVIOUS child's exit and this launch (the
#: relaunch gap — backoff sleep plus spawn overhead). The child's
#: goodput ledger (obs/goodput.py) books it as ``restart_downtime``, so
#: the gap during which NO process existed still lands in the one
#: JSONL stream and the stitched end-to-end goodput fraction is honest.
DOWNTIME_ENV = "NANODILOCO_DOWNTIME_S"

#: Environment variable the supervisor sets for the child: the path of
#: the on-disk ``workers.target`` control file the supervisor re-reads
#: between child lifetimes. The child never resizes itself — but its
#: ``resize`` fault kind (resilience/faults.py) writes the requested
#: width here and preempt-exits, so an injected capacity change flows
#: through the REAL control-plane path end to end.
WORKERS_TARGET_ENV = "NANODILOCO_WORKERS_TARGET"


def find_blackbox_dump(
    log_dir: str | None, since_unix: float, child_pid: int | None = None
) -> str | None:
    """Newest ``*-blackbox.json`` flight-recorder dump (obs/flightrec)
    in ``log_dir`` written by THIS child — how the supervisor attaches
    the crashed child's black box to its ``crash`` event without
    knowing the child's run name. The dump document's own ``pid`` is
    the discriminator when the caller knows the child's (two supervised
    runs sharing one log dir, or a stale dump from a previous child
    surviving a short backoff, must never cross-attach); the document's
    ``t_unix`` (falling back to file mtime) must be at/after the
    child's launch. None when the child never dumped (or the dir is
    unset/missing)."""
    if not log_dir or not os.path.isdir(log_dir):
        return None
    best: tuple[float, str] | None = None
    try:
        names = os.listdir(log_dir)
    except OSError:
        return None
    for name in names:
        if not name.endswith("-blackbox.json"):
            continue
        path = os.path.join(log_dir, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue  # torn/foreign file — never a crash's evidence
        if not isinstance(doc, dict) or not doc.get("blackbox"):
            continue
        pid = doc.get("pid")
        if (
            child_pid is not None and pid is not None
            and int(pid) != int(child_pid)
        ):
            continue
        t = doc.get("t_unix")
        if not isinstance(t, (int, float)):
            try:
                t = os.path.getmtime(path)
            except OSError:
                continue
        if t >= since_unix and (best is None or t > best[0]):
            best = (t, path)
    return best[1] if best else None


def latest_checkpoint_step(directory: str | None) -> int | None:
    """Latest committed checkpoint step in the port's checkpoint dir,
    read from file names alone (``committed_steps``: ``step_<n>.pt``,
    never a ``.tmp`` mid-save); None when there is none."""
    if not directory or not os.path.isdir(directory):
        return None
    steps = committed_steps(directory)
    return steps[-1] if steps else None


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_restarts: int = 8        # crash budget (progress-less crashes count 2)
    backoff_base_s: float = 1.0  # first crash backoff; doubles per consecutive crash
    backoff_max_s: float = 60.0
    degrade_after: int = 3       # consecutive no-progress crashes before degrading
    min_workers: int = 1
    checkpoint_dir: str | None = None  # progress detection (and the resume story)
    # where the child writes its flight-recorder black box — the crash
    # event attaches the newest dump found here (None = don't look)
    log_dir: str | None = None
    # -- elastic scale-UP (capacity is additive, not only degradable) --
    # consecutive progress-making child lifetimes (preempt resumes or
    # crashes that advanced the checkpoint) before DOUBLING
    # --num-workers, capped at max_workers; 0 disables the automatic
    # path. The train loop's restore_elastic widens the run: new
    # replicas seed from the synchronized snapshot, inner moments fresh.
    scale_up_after: int = 0
    max_workers: int | None = None
    # on-disk control file re-read between child lifetimes: an integer
    # worker-count target written by an operator (or the child's
    # injected ``resize`` fault, via WORKERS_TARGET_ENV). An explicit
    # target beats the automatic doubling and moves in BOTH directions
    # (clamped to [min_workers, max_workers]).
    workers_target_file: str | None = None


class Supervisor:
    """``command`` is the full child argv (the CLI builds
    ``[sys.executable, "-m", "nanodiloco_tpu_torch", ...train flags]``).
    ``emit`` receives one dict per supervision event (launch/exit/
    restart/degrade/giveup) — the CLI prints them, tests assert on them.
    ``popen``/``sleep``/``rng`` are injectable for tests."""

    def __init__(
        self,
        command: list[str],
        cfg: SupervisorConfig | None = None,
        emit: Callable[[dict], None] | None = None,
        popen: Callable[..., "subprocess.Popen"] = subprocess.Popen,
        sleep: Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
        env: dict[str, str] | None = None,
        wall: Callable[[], float] = time.time,
    ) -> None:
        self.command = list(command)
        self.cfg = cfg or SupervisorConfig()
        if self.cfg.scale_up_after > 0 and self.cfg.max_workers is None:
            raise ValueError(
                "scale_up_after requires max_workers: automatic doubling "
                "needs a ceiling (a silent no-op here would look like the "
                "feature is broken)"
            )
        self._raw_emit = emit or (lambda rec: None)
        self._popen = popen
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._env = dict(env) if env is not None else dict(os.environ)
        # injectable wall clock: every event is timestamped and the
        # child-lifetime/downtime durations derive from it — tests drive
        # a fake timeline instead of sleeping
        self._wall = wall
        self._child: subprocess.Popen | None = None
        self._terminating = False
        # last control-file target acted on: only a NEW value retargets,
        # so a stale workers.target left on disk cannot fight a later
        # crash_degrade back up forever
        self._target_seen: int | None = None
        self.restarts = 0            # launches after the first, any class
        self.budget_used = 0         # crash budget consumed
        self.downtime_total_s = 0.0  # relaunch gaps accumulated (crash+preempt)
        self.workers = self._read_workers()

    def _emit(self, rec: dict) -> None:
        """Every supervision event carries ``t_unix``: the JSONL was
        orderable but UNDATABLE before — a crash-loop timeline without
        timestamps cannot answer "how long were we down"."""
        self._raw_emit({**rec, "t_unix": round(self._wall(), 3)})

    # -- child argv surgery --------------------------------------------------

    def _read_workers(self) -> int:
        argv = self.command
        for i, a in enumerate(argv):
            if a == "--num-workers" and i + 1 < len(argv):
                return int(argv[i + 1])
            if a.startswith("--num-workers="):
                return int(a.split("=", 1)[1])
        return 1

    def _set_workers(self, n: int) -> None:
        argv = self.command
        for i, a in enumerate(argv):
            if a == "--num-workers" and i + 1 < len(argv):
                argv[i + 1] = str(n)
                break
            if a.startswith("--num-workers="):
                argv[i] = f"--num-workers={n}"
                break
        else:
            argv += ["--num-workers", str(n)]
        self.workers = n

    # -- elastic resize (scale_up / scale_down) ------------------------------

    def _resize(self, new_w: int, reason: str) -> None:
        """Retarget the child's width and emit the symmetric scale event
        (``scale_up``/``scale_down`` with ``workers_from``/``workers_to``
        — the crash-loop ``degrade`` halving reports through the same
        event family, so every width change in the run's history reads
        from one place)."""
        if new_w == self.workers:
            return
        self._emit({
            "event": "scale_up" if new_w > self.workers else "scale_down",
            "reason": reason,
            "workers_from": self.workers,
            "workers_to": new_w,
        })
        self._set_workers(new_w)

    def _read_target_file(self) -> int | None:
        """Integer worker target from the control file, or None when the
        file is absent/unreadable/garbage (a torn write must never crash
        the supervisor — the next lifetime boundary re-reads)."""
        path = self.cfg.workers_target_file
        if not path:
            return None
        try:
            with open(path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _clamp_workers(self, n: int) -> int:
        n = max(n, self.cfg.min_workers, 1)
        if self.cfg.max_workers is not None:
            n = min(n, self.cfg.max_workers)
        return n

    def _take_new_target(self) -> int | None:
        """Control-file target, only when it CHANGED since the last one
        acted on — a stale value left on disk must not re-apply after a
        crash_degrade moved the width away from it."""
        target = self._read_target_file()
        if target is None or target == self._target_seen:
            return None
        self._target_seen = target
        return target

    def _apply_resize_requests(self, consecutive_progress: int) -> bool:
        """Between-lifetimes resize check, explicit target first: the
        control file (both directions) beats the automatic doubling
        (``scale_up_after`` progress-making lifetimes → 2x, capped at
        ``max_workers``). Returns True when the automatic path consumed
        the progress streak (the caller resets its counter)."""
        target = self._take_new_target()
        if target is not None:
            self._resize(self._clamp_workers(target), "control_file")
            return False
        if (
            self.cfg.scale_up_after > 0
            and self.cfg.max_workers is not None
            and consecutive_progress >= self.cfg.scale_up_after
            and self.workers < self.cfg.max_workers
        ):
            self._resize(
                min(self.cfg.max_workers, self.workers * 2), "scale_up_after"
            )
            return True
        return False

    # -- signal forwarding ---------------------------------------------------

    def _forward(self, signum, frame) -> None:
        self._terminating = True
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
            except (ProcessLookupError, OSError):
                pass

    # -- the supervision loop ------------------------------------------------

    def run(self) -> int:
        cfg = self.cfg
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, self._forward)
        consecutive_no_progress = 0
        # progress-making lifetimes since the last crash/resize — the
        # automatic scale-up path's health streak
        consecutive_progress = 0
        progress = latest_checkpoint_step(cfg.checkpoint_dir)
        # downtime accounting: the gap between a child's exit and the
        # next launch (backoff + spawn overhead) is wall-clock the RUN
        # paid with no process alive — each launch reports its gap, the
        # child books it as restart_downtime in its goodput ledger
        # (DOWNTIME_ENV), and the terminal event carries the total
        prev_exit_wall: float | None = None
        try:
            while True:
                t_launch = self._wall()
                downtime_s = (
                    max(0.0, t_launch - prev_exit_wall)
                    if prev_exit_wall is not None else 0.0
                )
                self.downtime_total_s += downtime_s
                env = {
                    **self._env,
                    RESTART_ENV: str(self.restarts),
                    DOWNTIME_ENV: f"{downtime_s:.3f}",
                    # the resize fault's write target (see faults.py):
                    # a child-requested width change flows through the
                    # same control file an operator would write
                    **({WORKERS_TARGET_ENV: cfg.workers_target_file}
                       if cfg.workers_target_file else {}),
                }
                self._emit({
                    "event": "launch", "restart": self.restarts,
                    "workers": self.workers,
                    "resume_step": progress,
                    **({"downtime_s": round(downtime_s, 3)}
                       if prev_exit_wall is not None else {}),
                })
                self._child = self._popen(self.command, env=env)
                # the child's pid discriminates ITS blackbox dump from a
                # previous child's (or another run's) in a shared log dir
                child_pid = getattr(self._child, "pid", None)
                rc = self._child.wait()
                self._child = None
                t_exit = self._wall()
                prev_exit_wall = t_exit
                child_s = round(max(0.0, t_exit - t_launch), 3)
                new_progress = latest_checkpoint_step(cfg.checkpoint_dir)
                advanced = (
                    new_progress is not None
                    and (progress is None or new_progress > progress)
                )
                if rc == 0:
                    self._emit({
                        "event": "finished", "restarts": self.restarts,
                        "child_s": child_s,
                        "downtime_total_s": round(self.downtime_total_s, 3),
                    })
                    return 0
                if self._terminating:
                    # the OPERATOR preempted the supervisor tree: the
                    # child checkpointed and exited; do not restart —
                    # hand the child's code up so a wrapping scheduler
                    # sees the same preempt semantics
                    self._emit({"event": "terminated", "exit_code": rc,
                                "child_s": child_s})
                    return rc
                if rc == PREEMPT_EXIT_CODE:
                    # a clean preemption: immediate resume, no backoff,
                    # no budget — this is the DiLoCo operating mode, not
                    # a failure
                    self.restarts += 1
                    self._emit({
                        "event": "preempt_resume", "restart": self.restarts,
                        "resume_step": new_progress, "child_s": child_s,
                    })
                    progress = new_progress
                    consecutive_no_progress = 0
                    # elastic resize between lifetimes: an explicit
                    # workers.target beats the automatic doubling earned
                    # by `scale_up_after` consecutive healthy lifetimes
                    consecutive_progress = (
                        consecutive_progress + 1 if advanced else 0
                    )
                    if self._apply_resize_requests(consecutive_progress):
                        consecutive_progress = 0
                    continue
                # crash class (injected crash, watchdog exit, OOM, bug)
                consecutive_progress = 0  # instability pauses scale-up
                cost = 1 if advanced else 2  # no forward progress counts double
                self.budget_used += cost
                self.restarts += 1
                consecutive_no_progress = 0 if advanced else consecutive_no_progress + 1
                reason = "watchdog" if rc == WATCHDOG_EXIT_CODE else "crash"
                # attach the crashed child's black box (obs/flightrec):
                # the dump it wrote on the way down is the only record
                # of its final moments — the crash event is where an
                # operator (or report blackbox) should find it
                blackbox = find_blackbox_dump(cfg.log_dir, t_launch, child_pid)
                self._emit({
                    "event": "crash", "reason": reason, "exit_code": rc,
                    "budget_used": self.budget_used,
                    "budget": cfg.max_restarts,
                    "progress_step": new_progress, "advanced": advanced,
                    "child_s": child_s,
                    **({"blackbox": blackbox} if blackbox else {}),
                })
                if self.budget_used > cfg.max_restarts:
                    self._emit({
                        "event": "giveup", "exit_code": rc,
                        "budget_used": self.budget_used,
                        "downtime_total_s": round(self.downtime_total_s, 3),
                    })
                    return rc
                if (
                    consecutive_no_progress >= cfg.degrade_after
                    and self.workers > cfg.min_workers
                ):
                    # crash-loop degradation reports through the same
                    # symmetric scale event family as every other width
                    # change (was a bespoke silent `degrade` event)
                    self._resize(
                        max(cfg.min_workers, self.workers // 2),
                        "crash_degrade",
                    )
                    consecutive_no_progress = 0
                else:
                    # an operator may retarget width mid-crash-loop: the
                    # control file is re-read between EVERY pair of
                    # lifetimes, not only on healthy resumes
                    target = self._take_new_target()
                    if target is not None:
                        self._resize(self._clamp_workers(target),
                                     "control_file")
                delay = jittered_backoff(
                    consecutive_no_progress - 1,
                    cfg.backoff_base_s, cfg.backoff_max_s, self._rng,
                )
                self._emit({"event": "backoff", "delay_s": round(delay, 3)})
                self._sleep(delay)
                if self._terminating:
                    # the operator terminated the TREE while no child was
                    # alive (mid-backoff): relaunching now would ignore
                    # the request and block in wait() for a whole run —
                    # honor it instead of spawning fresh work
                    self._emit({"event": "terminated", "exit_code": rc})
                    return rc
                progress = new_progress
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)


def supervise_main(argv: list[str]) -> None:
    """``nanodiloco_tpu_torch supervise [flags] -- <train flags...>`` — run the
    train CLI under the supervisor. The checkpoint dir is read from the
    train flags when not given explicitly; without one the supervisor
    still restarts, but every restart starts from scratch (warned)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="nanodiloco_tpu_torch supervise",
        description="Run training as a supervised child process: preempt "
                    "exits (code 75) resume immediately; crashes restart "
                    "from the latest checkpoint with backoff, a budget, "
                    "crash-loop detection, and elastic degradation.",
    )
    p.add_argument("--max-restarts", type=int, default=8,
                   help="crash budget (a crash with no checkpoint progress "
                        "since the last launch counts double); preempt "
                        "resumes are free")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="first crash backoff in seconds (doubles per "
                        "consecutive no-progress crash, jittered)")
    p.add_argument("--backoff-max", type=float, default=60.0)
    p.add_argument("--degrade-after", type=int, default=3,
                   help="consecutive no-progress crashes before halving "
                        "--num-workers (elastic resume restores the "
                        "snapshot exactly at the new width)")
    p.add_argument("--min-workers", type=int, default=1)
    p.add_argument("--scale-up-after", type=int, default=0,
                   help="consecutive progress-making child lifetimes "
                        "(preempt resumes / crashes that advanced the "
                        "checkpoint) before DOUBLING --num-workers, capped "
                        "at --max-workers (0 disables; elastic resume "
                        "seeds the new replicas from the snapshot)")
    p.add_argument("--max-workers", type=int, default=None,
                   help="worker-count ceiling for scale-up (required for "
                        "--scale-up-after; also clamps control-file "
                        "targets)")
    p.add_argument("--workers-target-file", type=str, default=None,
                   metavar="FILE",
                   help="on-disk workers.target control file re-read "
                        "between child lifetimes: write an integer worker "
                        "count to retarget the next relaunch's width in "
                        "EITHER direction (scale_up/scale_down events; "
                        "exported to the child as $" + WORKERS_TARGET_ENV +
                        " so the `resize` fault kind can request it)")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="progress-detection dir; default: the --checkpoint-dir "
                        "in the train flags")
    p.add_argument("--events-jsonl", type=str, default=None, metavar="JSONL",
                   help="append every supervision event (launch/crash/"
                        "preempt_resume/backoff/degrade/giveup, each with "
                        "t_unix + child/downtime durations) to this JSONL — "
                        "the supervisor's half of the run timeline")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="train CLI flags, after an optional `--`")
    args = p.parse_args(argv)
    train_args = args.train_args
    if train_args[:1] == ["--"]:
        train_args = train_args[1:]

    def _train_flag(name: str) -> str | None:
        # LAST occurrence wins, matching what argparse does in the
        # child — watching a dir the child doesn't write would turn
        # every crash into a fake no-progress crash
        val = None
        for i, a in enumerate(train_args):
            if a == name and i + 1 < len(train_args):
                val = train_args[i + 1]
            elif a.startswith(name + "="):
                val = a.split("=", 1)[1]
        return val

    ckpt = args.checkpoint_dir or _train_flag("--checkpoint-dir")
    if ckpt is None:
        print(
            "[supervise] warning: no --checkpoint-dir in the train flags — "
            "every restart will begin from step 0", file=sys.stderr,
        )
    # where the child's flight recorder dumps its black box: the train
    # CLI's --log-dir (its default is "runs") — the crash event attaches
    # the newest dump found there
    log_dir = _train_flag("--log-dir") or "runs"
    cfg = SupervisorConfig(
        max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base,
        backoff_max_s=args.backoff_max,
        degrade_after=args.degrade_after,
        min_workers=args.min_workers,
        scale_up_after=args.scale_up_after,
        max_workers=args.max_workers,
        workers_target_file=args.workers_target_file,
        checkpoint_dir=ckpt,
        log_dir=log_dir,
    )

    events_file = None
    if args.events_jsonl:
        d = os.path.dirname(os.path.abspath(args.events_jsonl))
        os.makedirs(d, exist_ok=True)
        events_file = open(args.events_jsonl, "a")

    def _emit(rec: dict) -> None:
        print(f"[supervise] {rec}", flush=True)
        if events_file is not None:
            events_file.write(json.dumps(rec) + "\n")
            events_file.flush()

    sup = Supervisor(
        [sys.executable, "-m", "nanodiloco_tpu_torch", *train_args],
        cfg,
        emit=_emit,
    )
    try:
        raise SystemExit(sup.run())
    finally:
        if events_file is not None:
            events_file.close()
