"""Lightweight host-side span tracer with Chrome trace-event export.

A copy of ``nanodiloco_tpu/obs/tracer.py`` (jax-free; the
JAX package's ``__init__`` imports jax, so the port keeps its own):
``SpanTracer``, ``set_tracer``, ``current_tracer`` and ``trace_span``,
and the request-span surface the serve scheduler and server call:
``TraceContext`` (the W3C-traceparent-style wire context),
``record_span`` for already-timed request phases, ``activate`` (spans
parented under an accepted context), and the head-based sampling that
``serve --trace-sample-rate`` / ``--trace-reservoir`` set for contexts
minted at this edge (``new_trace`` / ``accept``); and the causal
assembly ``report merge-trace`` / ``report trace`` run over the shards
of a fleet's processes: ``merge_chrome_traces``, ``stitch_trace``,
``critical_path`` and ``render_waterfall``.

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
        process_index: int = 0,
        process_name: str | None = None,
        sample_rate: float = 1.0,
        reservoir_per_window: int = 2,
        reservoir_window_s: float = 60.0,
    ) -> None:
        self._clock = clock
        self._max_events = max_events
        # which process of a multi-process run this tracer records; carried
        # in the export's metadata so merge_chrome_traces can assign
        # stable pids
        self.process_index = int(process_index)
        # display name for the Chrome process lane: a serve or router
        # tracer names itself so a merged timeline shows labeled lanes
        self.process_name = process_name or f"nanodiloco rank{self.process_index}"
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
    def activate(self, ctx: TraceContext | None):
        """Bind ``ctx`` as this thread's remote parent: ``span()`` calls
        inside the block parent under it (depth-0 spans become children
        of the accepted context's span id). Nesting restores the outer
        binding on exit."""
        prev = getattr(self._local, "ctx", None)
        self._local.ctx = ctx
        try:
            yield self
        finally:
            self._local.ctx = prev

    def active_context(self) -> TraceContext | None:
        return getattr(self._local, "ctx", None)

    @contextmanager
    def span(self, name: str, **args: Any):
        """Record one span around the enclosed block. Exceptions
        propagate; the span still closes (the trace must show the round
        that crashed, not lose it). Under an activated sampled context
        the span gains causal ids: parent = the enclosing span on this
        thread's stack, else the accepted remote context."""
        stack = self._stack()
        depth = len(stack)
        ctx: TraceContext | None = getattr(self._local, "ctx", None)
        span_ctx: TraceContext | None = None
        if ctx is not None and ctx.sampled:
            parent = (stack[-1][1] or ctx) if stack else ctx
            span_ctx = parent.child()
        t0 = self._clock()
        stack.append((name, span_ctx if span_ctx is not None else ctx))
        try:
            yield self
        finally:
            stack.pop()
            t1 = self._clock()
            tid = threading.get_ident()
            ev = {"name": name, "t0": t0, "dur": t1 - t0, "depth": depth, "tid": tid}
            if span_ctx is not None:
                args = {**args, "trace_id": span_ctx.trace_id, "span_id": span_ctx.span_id}
                if span_ctx.parent_span_id:
                    args["parent_span_id"] = span_ctx.parent_span_id
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
                "process_index": self.process_index,
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

def trace_shard_path(path: str, process_index: int) -> str:
    """Where process ``k`` of a pod writes its trace shard:
    ``trace.json`` -> ``trace.rank1.json`` etc. Rank 0 keeps the
    requested path unchanged, so single-process behaviour (and every
    existing consumer of ``--trace-out``) is untouched."""
    if process_index == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{process_index}{ext or '.json'}"


def merge_chrome_traces(docs: list[dict[str, Any]]) -> dict[str, Any]:
    """Fold per-process trace shards into ONE Chrome trace: ``pid`` =
    process index, timestamps re-anchored onto a common wall clock, and
    process/thread-name metadata rewritten per pid — so the 2-process
    multihost run renders as a single Perfetto timeline where both
    hosts' ``sync`` spans line up (outer-step skew, finally visible).

    Alignment uses each shard's ``wall_start_unix`` anchor (recorded at
    tracer construction): shard timestamps are perf_counter-relative,
    so shifting each by ``(wall0_k - min(wall0)) * 1e6`` puts every
    shard on the earliest shard's clock. Shards without an anchor (a
    foreign trace) merge unshifted. Pid collisions (two shards both
    claiming rank 0) fall back to ordinal pids — the merge must never
    silently overlay two processes onto one lane."""
    if not docs:
        raise ValueError("no trace shards to merge")
    anchors = [
        (doc.get("otherData") or {}).get("wall_start_unix") for doc in docs
    ]
    known = [a for a in anchors if isinstance(a, (int, float))]
    base = min(known) if known else None
    merged: list[dict[str, Any]] = []
    used_pids: set[int] = set()
    for i, (doc, anchor) in enumerate(zip(docs, anchors)):
        other = doc.get("otherData") or {}
        pid = other.get("process_index")
        if not isinstance(pid, int) or pid in used_pids:
            pid = i
            while pid in used_pids:
                pid += 1
        used_pids.add(pid)
        shift_us = (
            (anchor - base) * 1e6
            if base is not None and isinstance(anchor, (int, float))
            else 0.0
        )
        saw_process_name = False
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                saw_process_name |= ev.get("name") == "process_name"
            elif "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            merged.append(ev)
        if not saw_process_name:
            merged.append({
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"nanodiloco rank{pid}"},
            })
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "tracer": "nanodiloco_tpu_torch.obs merge-trace",
            "merged_shards": len(docs),
            **({"wall_start_unix": base} if base is not None else {}),
        },
    }


# -- causal assembly: shards -> one tree -> where the latency went ------

_EPS = 1e-9


def stitch_trace(docs: list[dict[str, Any]], needle: str) -> dict[str, Any]:
    """Assemble ONE request's causal tree from per-process trace shards.

    ``needle`` is a trace id or a request id. Shards are re-anchored
    onto a common wall clock exactly like ``merge_chrome_traces``; the
    needle is first resolved BOTH ways (a request id pulls in every
    trace id its spans carry and vice versa), then every matching span
    becomes a node and nodes link by ``parent_span_id``. Spans from
    uninstrumented/old shards carry no ids but still join by request id
    — they surface as extra roots under a synthetic ``trace`` node, so
    a fleet mid-rollout still yields one tree instead of an error.
    Times are seconds, rebased so the earliest span starts at 0."""
    merged = merge_chrome_traces(docs)
    pname: dict[Any, str] = {}
    xevents: list[dict[str, Any]] = []
    for ev in merged["traceEvents"]:
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                pname[ev.get("pid")] = (ev.get("args") or {}).get("name")
        elif ev.get("ph") == "X":
            xevents.append(ev)
    trace_ids, request_ids = {needle}, {needle}
    for ev in xevents:
        a = ev.get("args") or {}
        if a.get("trace_id") == needle and a.get("request_id"):
            request_ids.add(a["request_id"])
        if a.get("request_id") == needle and a.get("trace_id"):
            trace_ids.add(a["trace_id"])
    by_id: dict[str, dict] = {}
    picked: list[dict] = []
    for ev in xevents:
        a = ev.get("args") or {}
        if not (a.get("trace_id") in trace_ids
                or a.get("request_id") in request_ids):
            continue
        node = {
            "name": ev.get("name"),
            "process": pname.get(ev.get("pid")) or f"pid{ev.get('pid')}",
            "start_s": float(ev.get("ts") or 0.0) / 1e6,
            "dur_s": max(0.0, float(ev.get("dur") or 0.0) / 1e6),
            "span_id": a.get("span_id"),
            "parent_span_id": a.get("parent_span_id"),
            "trace_id": a.get("trace_id"),
            "request_id": a.get("request_id"),
            "args": {k: v for k, v in a.items()
                     if k not in ("trace_id", "span_id", "parent_span_id")},
            "children": [],
        }
        node["end_s"] = node["start_s"] + node["dur_s"]
        picked.append(node)
        if node["span_id"]:
            by_id.setdefault(node["span_id"], node)
    if not picked:
        raise ValueError(f"no spans match {needle!r} in the given shards")
    t_min = min(n["start_s"] for n in picked)
    for n in picked:
        n["start_s"] -= t_min
        n["end_s"] -= t_min
    roots: list[dict] = []
    for n in sorted(picked, key=lambda n: (n["start_s"], -n["dur_s"])):
        parent = by_id.get(n["parent_span_id"]) if n["parent_span_id"] else None
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)
    tid = next((n["trace_id"] for n in picked if n["trace_id"]), None)
    if len(roots) == 1:
        root = roots[0]
    else:
        # >1 root: shards joined only by request id (old emitters), or a
        # torn trace — a synthetic node makes the slack between them an
        # honest residual instead of an invisible drop
        root = {
            "name": "trace", "process": "(stitched)",
            "span_id": None, "parent_span_id": None,
            "trace_id": tid, "request_id": None, "args": {},
            "start_s": min(n["start_s"] for n in roots),
            "end_s": max(n["end_s"] for n in roots),
            "children": roots,
        }
        root["dur_s"] = root["end_s"] - root["start_s"]
    return {
        "root": root,
        "spans": picked,
        "trace_id": tid,
        "request_ids": sorted(r for r in {n["request_id"] for n in picked}
                              if r),
        "causal_spans": sum(1 for n in picked if n["span_id"]),
        "request_id_joined": sum(1 for n in picked if not n["span_id"]),
        "shards": len(docs),
    }


def critical_path(root: dict[str, Any]) -> list[dict[str, Any]]:
    """The chain of segments that determined the root span's duration:
    walk backwards from each span's end to the latest-ending child that
    could have gated it, recurse, and book every uncovered stretch to
    the span that owned the clock at that moment. Segment kinds:
    ``span`` (a leaf's own work), ``self`` (a parent's own leading
    work), ``residual`` (time inside a parent covered by NO child —
    network, queue slack between hops, cross-shard stitch skew —
    reported as its own segment, never dropped). Segments partition
    ``[root.start, root.end]`` exactly, so they sum to the root
    duration by construction."""
    segs: list[dict[str, Any]] = []

    def seg(node: dict, t0: float, t1: float, kind: str) -> None:
        if t1 - t0 > _EPS:
            segs.append({
                "span": node["name"], "process": node["process"],
                "t0_s": t0, "t1_s": t1, "seconds": t1 - t0, "kind": kind,
                **({"outcome": node["args"]["outcome"]}
                   if node.get("args", {}).get("outcome") else {}),
            })

    def walk(node: dict, t_hi: float) -> None:
        t = min(node["end_s"], t_hi)
        remaining = list(node["children"])
        while True:
            best, best_e = None, 0.0
            for c in remaining:
                ce = min(c["end_s"], t)
                if ce - c["start_s"] <= _EPS:
                    continue
                if best is None or ce > best_e:
                    best, best_e = c, ce
            if best is None:
                break
            remaining.remove(best)
            seg(node, best_e, t, "residual")
            walk(best, best_e)
            t = max(best["start_s"], node["start_s"])
        seg(node, node["start_s"], t,
            "span" if not node["children"] else "self")

    walk(root, root["end_s"])
    segs.sort(key=lambda s: s["t0_s"])
    return segs


def render_waterfall(stitched: dict[str, Any], width: int = 56) -> str:
    """ASCII waterfall of a stitched trace: one row per span, bar
    position/length proportional to when it ran inside the root span."""
    root = stitched["root"]
    total = max(root["end_s"] - root["start_s"], _EPS)
    lines: list[str] = []

    def row(node: dict, depth: int) -> None:
        off = int((node["start_s"] - root["start_s"]) / total * width)
        w = max(1, round((node["end_s"] - node["start_s"]) / total * width))
        off = min(off, width - 1)
        bar = " " * off + "#" * min(w, width - off)
        label = ("  " * depth + node["name"])[:26]
        outcome = (node.get("args") or {}).get("outcome")
        tail = f"  [{outcome}]" if outcome else ""
        dur_s = node["end_s"] - node["start_s"]
        lines.append(
            f"{label:<26s} |{bar:<{width}s}| "
            f"{dur_s * 1e3:9.3f} ms  {node['process']}{tail}"
        )
        for c in sorted(node["children"], key=lambda c: c["start_s"]):
            row(c, depth + 1)

    row(root, 0)
    return "\n".join(lines)
