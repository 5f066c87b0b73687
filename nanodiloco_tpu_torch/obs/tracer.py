"""Lightweight host-side span tracer with Chrome trace-event export.

The training subset of ``nanodiloco_tpu/obs/tracer.py`` (jax-free; the
JAX package's ``__init__`` imports jax, so the port keeps its own):
``SpanTracer``, ``set_tracer``, ``current_tracer`` and ``trace_span``.
The causal request tracing of the serving stack (``TraceContext``,
sampling, ``stitch_trace``) and the multi-host trace merge are not
ported.

The tracer answers "where does each ROUND's wall-clock go, host-side,
for the whole run" at the cost of two ``perf_counter`` calls per span.
Spans nest via a per-thread stack, export as Chrome trace-event JSON
(``chrome://tracing`` / Perfetto open it directly), and aggregate into
per-phase totals (``t_data``/``t_inner``/``t_sync``/...) that the train
loop folds into every step's JSONL record, so a metrics stream alone
reconstructs the round budget.

Usage::

    with trace_span("sync"):
        ...                      # nested trace_span calls nest in the UI

    tracer = current_tracer()
    totals = tracer.phase_totals()   # {"sync": 0.173, ...}, resets
    tracer.export_chrome("trace.json")
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

from nanodiloco_tpu_torch.obs import flightrec


class SpanTracer:
    """Records nested host-side spans; thread-safe, clock-injectable.

    ``clock`` must be a monotonic seconds source (tests inject a fake).
    ``max_events`` bounds memory on long runs: beyond the cap the OLDEST
    events are dropped (the exported trace keeps the most recent window).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        max_events: int = 500_000,
        process_name: str = "nanodiloco rank0",
    ) -> None:
        self._clock = clock
        self._max_events = max_events
        self.process_name = process_name
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._dropped = 0
        # tid -> human thread name, recorded at span time so the export
        # can emit Chrome thread_name metadata (main/prefetch lanes)
        self._thread_names: dict[int, str] = {}
        self._local = threading.local()
        # wall-clock anchor: trace timestamps are perf_counter-relative
        self._t0 = self._clock()
        self._wall0 = time.time()
        # per-phase accumulation window (phase_totals resets it)
        self._totals: dict[str, float] = {}

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **args: Any):
        """Record one span around the enclosed block. Exceptions
        propagate; the span still closes (the trace must show the round
        that crashed, not lose it)."""
        stack = self._stack()
        depth = len(stack)
        t0 = self._clock()
        stack.append(name)
        try:
            yield self
        finally:
            stack.pop()
            t1 = self._clock()
            tid = threading.get_ident()
            ev = {"name": name, "t0": t0, "dur": t1 - t0, "depth": depth, "tid": tid}
            if args:
                ev["args"] = args
            with self._lock:
                if tid not in self._thread_names:
                    self._thread_names[tid] = threading.current_thread().name
                if self._max_events > 0:
                    self._events.append(ev)
                    if len(self._events) > self._max_events:
                        drop = len(self._events) - self._max_events
                        del self._events[:drop]
                        self._dropped += drop
                if depth == 0:
                    self._totals[name] = self._totals.get(name, 0.0) + (t1 - t0)
            if depth == 0:
                # black-box feed: the crash dump's timeline shows which
                # phases ran up to the fatal moment
                flightrec.record_event("span", name=name, s=round(t1 - t0, 6))

    def phase_totals(self, reset: bool = True) -> dict[str, float]:
        """Seconds per DEPTH-0 span name since the last reset — the
        per-round phase budget. Only top-level spans count, so nested
        detail spans never double-bill their parent phase."""
        with self._lock:
            out = dict(self._totals)
            if reset:
                self._totals = {}
        return out

    @property
    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict[str, Any]:
        """Chrome trace-event JSON object: complete ("X") events, nesting
        implied by containment on one tid, and metadata ("M") events that
        name the process and each thread."""
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            thread_names = dict(self._thread_names)
        tev: list[dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": self.process_name}}
        ]
        for tid, tname in sorted(thread_names.items()):
            tev.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                        "args": {"name": tname}})
        tev += [
            {
                "name": e["name"],
                "ph": "X",
                "ts": (e["t0"] - self._t0) * 1e6,   # microseconds
                "dur": e["dur"] * 1e6,
                "pid": pid,
                "tid": e["tid"],
                **({"args": e["args"]} if "args" in e else {}),
            }
            for e in events
        ]
        return {
            "traceEvents": tev,
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": "nanodiloco_tpu_torch.obs",
                "wall_start_unix": self._wall0,
                "process_index": 0,
                **({"dropped_events": dropped} if dropped else {}),
            },
        }

    def export_chrome(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path`` (atomic: tmp+rename, so
        a crash mid-write never leaves a torn file). Returns the path."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path


class _NullTracer(SpanTracer):
    """Default when nothing installed a tracer: records nothing, so
    library code never needs an ``if tracing:`` guard."""

    def __init__(self) -> None:
        super().__init__(max_events=0)

    @contextmanager
    def span(self, name: str, **args: Any):
        yield self

    def phase_totals(self, reset: bool = True) -> dict[str, float]:
        return {}


_null = _NullTracer()
_current: SpanTracer = _null
_current_lock = threading.Lock()


def set_tracer(tracer: SpanTracer | None) -> SpanTracer:
    """Install ``tracer`` as the process-wide current tracer (None
    restores the no-op default). Returns the PREVIOUS tracer so callers
    can restore it."""
    global _current
    with _current_lock:
        prev = _current
        _current = tracer if tracer is not None else _null
    return prev


def current_tracer() -> SpanTracer:
    return _current


@contextmanager
def trace_span(name: str, **args: Any):
    """``with trace_span("sync"):`` — record on the current tracer,
    resolved at ENTRY so an install/restore race mid-span still closes
    the span on the tracer that opened it."""
    with _current.span(name, **args) as t:
        yield t
