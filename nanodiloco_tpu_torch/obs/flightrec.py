"""Crash flight recorder: a bounded black box that survives the crash.

A copy of ``nanodiloco_tpu/obs/flightrec.py`` (jax-free; the JAX
package's ``__init__`` imports jax, so the port keeps its own).

The tracer's Chrome export and the metrics JSONL answer "what happened"
for runs that ENDED politely. This module keeps a bounded ring buffer of
recent events (depth-0 spans and JSONL records) and dumps it ATOMICALLY
to ``<log_dir>/<run>-blackbox.json`` when something fatal happens: an
unhandled exception escaping ``train()``, or a fatal signal
(SIGABRT/SIGBUS/SIGSEGV/SIGFPE, best effort).

Like the tracer, the recorder is installed process-globally so feeding
it is non-invasive: ``record_event`` is a no-op (one ``is None`` check)
until something installs a recorder, so library call sites never need
an ``if recording:`` guard.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Callable

#: Default ring capacity. ~512 events is minutes of context at round
#: cadence and a few KB on disk — a black box, not a second trace.
DEFAULT_CAPACITY = 512

#: Signals worth a best-effort dump. SIGTERM/SIGINT are NOT here: those
#: are the preemption path, owned by the train loop's graceful-stop
#: latch, and a dump would misreport a clean preempt as a crash.
FATAL_SIGNALS = tuple(
    s for s in ("SIGABRT", "SIGBUS", "SIGSEGV", "SIGFPE")
    if hasattr(signal, s)
)


class FlightRecorder:
    """Bounded, thread-safe ring of recent events with an atomic dump.

    ``clock``/``wall`` are injectable (tests drive the timeline).
    ``dump_path`` may be set at construction or later (the train loop
    only knows the run name after the logger resolves it)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        dump_path: str | None = None,
        wall: Callable[[], float] = time.time,
    ) -> None:
        self._events: deque[dict[str, Any]] = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._wall = wall
        self.dump_path = dump_path
        self._dumped: str | None = None  # last dump reason (once is enough)
        self._dropped = 0

    def record(self, kind: str, /, **data: Any) -> None:
        # positional-only ``kind``: event data regularly carries its own
        # "kind" key (watchdog alarms, JSONL records) and must not
        # collide with the event's type
        ev = {"kind": str(kind), "t_unix": round(self._wall(), 3)}
        if data:
            ev["data"] = data
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def dump(self, reason: str, path: str | None = None) -> str | None:
        """Write the black box atomically (tmp+rename — a crash mid-dump
        must never leave a torn file where forensics expects JSON).
        Returns the written path, or None when no path is configured or
        the disk refuses (a full disk must not mask the real crash).
        Repeated dumps overwrite: the LAST fatal event wins, and the
        reasons accumulate in the document so a dump-then-die sequence
        stays visible."""
        path = path or self.dump_path
        if not path:
            return None
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            prior = self._dumped
            self._dumped = reason
        doc = {
            "blackbox": True,
            "reason": reason,
            **({"prior_reason": prior} if prior else {}),
            "t_unix": round(self._wall(), 3),
            "pid": os.getpid(),
            **({"dropped_events": dropped} if dropped else {}),
            "events": events,
        }
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            return None
        return path


# -- process-global installation (the tracer's non-invasive pattern) ---------

_current: FlightRecorder | None = None
_lock = threading.Lock()


def install(rec: FlightRecorder | None) -> FlightRecorder | None:
    """Install ``rec`` as the process-wide recorder (None uninstalls).
    Returns the PREVIOUS recorder so callers can restore it — the train
    loop does, keeping concurrent tests from leaking recorders."""
    global _current
    with _lock:
        prev = _current
        _current = rec
    return prev


def current() -> FlightRecorder | None:
    return _current


def record_event(kind: str, /, **data: Any) -> None:
    """Record on the current recorder; free no-op when none installed."""
    rec = _current
    if rec is not None:
        rec.record(kind, **data)


def dump_current(reason: str) -> str | None:
    """Dump the current recorder's ring; None when none installed (or
    no dump path configured)."""
    rec = _current
    return rec.dump(reason) if rec is not None else None


# -- fatal-signal arming (faulthandler-adjacent) ------------------------------

_prev_handlers: dict[int, Any] = {}


def arm_fatal_signals() -> None:
    """Best-effort dump on SIGABRT/SIGBUS/SIGSEGV/SIGFPE: the handler
    dumps the ring, restores the default disposition, and re-raises so
    the process still dies with the original signal (exit codes and
    core dumps must stay honest). Main-thread only (the OS contract);
    silently a no-op elsewhere or on exotic embeddings. Pair with
    ``disarm_fatal_signals`` at teardown — an embedding process (tests,
    a notebook) must get its handlers back."""
    if threading.current_thread() is not threading.main_thread():
        return

    def _handler(signum, frame):
        try:
            dump_current(f"signal:{signal.Signals(signum).name}")
        except Exception:
            pass
        try:
            signal.signal(signum, _prev_handlers.get(signum, signal.SIG_DFL))
        except (ValueError, OSError):
            pass
        os.kill(os.getpid(), signum)

    for name in FATAL_SIGNALS:
        sig = getattr(signal, name)
        try:
            prev = signal.signal(sig, _handler)
        except (ValueError, OSError, RuntimeError):
            continue
        _prev_handlers.setdefault(sig, prev)


def disarm_fatal_signals() -> None:
    if threading.current_thread() is not threading.main_thread():
        return
    while _prev_handlers:
        sig, prev = _prev_handlers.popitem()
        try:
            signal.signal(sig, prev)
        except (ValueError, OSError, RuntimeError):
            pass
