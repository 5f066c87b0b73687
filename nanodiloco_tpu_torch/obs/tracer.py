"""Lightweight host-side span tracer with Chrome trace-event export.

The training subset of ``nanodiloco_tpu/obs/tracer.py`` (jax-free; the
JAX package's ``__init__`` imports jax, so the port keeps its own):
``SpanTracer``, ``set_tracer``, ``current_tracer`` and ``trace_span``,
and the request-span surface the serve scheduler and server call:
``TraceContext`` (the W3C-traceparent-style wire context),
``record_span`` for already-timed request phases, and the head-based
sampling that ``serve --trace-sample-rate`` / ``--trace-reservoir`` set
for contexts minted at this edge (``new_trace`` / ``accept``).
``activate``, ``stitch_trace`` and the multi-host trace merge are not
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
from typing import Any, Callable, NamedTuple

from nanodiloco_tpu_torch.obs import flightrec


class TraceContext(NamedTuple):
    """One hop's position in a causal trace.

    ``trace_id`` names the whole request tree (32 hex chars),
    ``span_id`` is THIS hop's own span (16 hex), ``parent_span_id`` the
    hop that caused it (None at the root), and ``sampled`` carries the
    head-based decision every downstream process must honour.
    """

    trace_id: str
    span_id: str
    parent_span_id: str | None
    sampled: bool

    def child(self) -> "TraceContext":
        """A fresh span id parented under this one; trace id and the
        sampling decision ride along unchanged."""
        return TraceContext(self.trace_id, _new_span_id(), self.span_id, self.sampled)

    def to_wire(self) -> str:
        """Wire form ``00-<trace_id>-<span_id>-<flags>``: the receiver
        parents its spans under OUR span id. Flags: ``01`` sampled."""
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    @classmethod
    def from_wire(cls, wire: Any) -> "TraceContext | None":
        """Parse an incoming ``trace_context`` string; None on anything
        malformed (a garbage header degrades to untraced, never a 4xx)."""
        if not isinstance(wire, str):
            return None
        parts = wire.strip().split("-")
        if len(parts) != 4:
            return None
        _ver, tid, sid, flags = parts
        if len(tid) != 32 or len(sid) != 16:
            return None
        try:
            int(tid, 16), int(sid, 16)
        except ValueError:
            return None
        return cls(tid.lower(), sid.lower(), None, flags == "01")


def _new_span_id() -> str:
    return os.urandom(8).hex()


def _new_trace_id() -> str:
    return os.urandom(16).hex()


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
        sample_rate: float = 1.0,
        reservoir_per_window: int = 2,
        reservoir_window_s: float = 60.0,
    ) -> None:
        self._clock = clock
        self._max_events = max_events
        self.process_name = process_name
        # head-based sampling: the edge process decides once per trace
        # (a pure function of the trace id), topped up by a bounded
        # reservoir of reservoir_per_window traces per window
        self.sample_rate = float(sample_rate)
        self._reservoir_per_window = int(reservoir_per_window)
        self._reservoir_window_s = float(reservoir_window_s)
        self._reservoir_left = self._reservoir_per_window
        self._reservoir_window_t0: float | None = None
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

    # -- causal context -------------------------------------------------

    def head_sample(self, trace_id: str) -> bool:
        """The once-per-trace sampling decision: deterministic in the
        trace id, topped up by the bounded reservoir."""
        if self.sample_rate >= 1.0:
            return True
        if (self.sample_rate > 0.0
                and int(trace_id[:13] or "0", 16) / float(16 ** 13) < self.sample_rate):
            return True
        now = self._clock()
        with self._lock:
            if (self._reservoir_window_t0 is None
                    or now - self._reservoir_window_t0 >= self._reservoir_window_s):
                self._reservoir_window_t0 = now
                self._reservoir_left = self._reservoir_per_window
            if self._reservoir_left > 0:
                self._reservoir_left -= 1
                return True
        return False

    def new_trace(self) -> TraceContext:
        """Mint a root context at the edge."""
        tid = _new_trace_id()
        return TraceContext(tid, _new_span_id(), None, self.head_sample(tid))

    def accept(self, wire: Any) -> TraceContext:
        """Adopt an incoming wire context, or mint a fresh trace when
        there is none; a propagated sampling decision wins."""
        ctx = TraceContext.from_wire(wire)
        return ctx if ctx is not None else self.new_trace()

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

    def record_span(self, name: str, t0: float, t1: float,
                    ctx: TraceContext | None = None, **args: Any) -> None:
        """Record an ALREADY-TIMED span: ``t0``/``t1`` are values of THIS
        tracer's clock, captured by the caller (the serve scheduler times
        queued/prefill/decode with its own clock and reports them after
        the fact). Recorded at depth 0, so serve phases aggregate into
        ``phase_totals``. ``ctx`` names the span's place in a causal
        trace; an unsampled or absent context adds nothing."""
        if self._max_events <= 0:
            return
        tid = threading.get_ident()
        ev = {"name": name, "t0": float(t0), "dur": max(0.0, float(t1) - float(t0)),
              "depth": 0, "tid": tid}
        if ctx is not None and ctx.sampled:
            args = {**args, "trace_id": ctx.trace_id, "span_id": ctx.span_id}
            if ctx.parent_span_id:
                args["parent_span_id"] = ctx.parent_span_id
        if args:
            ev["args"] = args
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(ev)
            if len(self._events) > self._max_events:
                drop = len(self._events) - self._max_events
                del self._events[:drop]
                self._dropped += drop
            self._totals[name] = self._totals.get(name, 0.0) + ev["dur"]

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
