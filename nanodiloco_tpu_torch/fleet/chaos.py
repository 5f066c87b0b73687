"""Fleet chaos harness: schedule-driven wire faults in front of real replicas.

``resilience/faults.py`` proved every TRAINING recovery path by driving
failures through the real stack at exact, reproducible steps. The fleet
grew the same way training did — router, canary deploy, autoscaler,
collector — but its failure paths were hardened only by hand-found
review fixes. This module closes that gap for SERVING: a deterministic
fault plan (keyed by per-target request/probe ordinals — zero
wall-clock randomness, identical on every run with the same plan)
realized by a stdlib ``ChaosProxy`` that sits ON THE WIRE in front of a
real replica, so every fault is observed exactly as production would
see it — through sockets, not through monkeypatched Python.

The plan is a JSON document (``fleet --chaos-plan plan.json``)::

    {"faults": [
      {"kind": "latency",     "target": "r0", "requests": [2], "seconds": 0.5},
      {"kind": "slow_drip",   "target": "r1", "requests": [4], "seconds": 0.5},
      {"kind": "reset",       "target": "r2", "requests": [5]},
      {"kind": "blackhole",   "target": "r0", "requests": [6], "seconds": 8},
      {"kind": "error_500",   "target": "r1", "requests": [7, 8, 9]},
      {"kind": "garbage_json","target": "r0", "requests": [10]},
      {"kind": "flap_health", "target": "r2", "probes": [3]},
      {"kind": "kill",        "target": "r2", "requests": [11]}
    ]}

Fault kinds (the gray-failure taxonomy the router's resilience stack —
deadline propagation, hedging, retry budgets, circuit breakers — must
survive):

- ``latency``: hold the request ``seconds`` before forwarding — the
  slow-but-200 replica binary healthz cannot see (hedge territory).
- ``slow_drip``: forward normally, then dribble the response body out
  in ``chunk_bytes`` pieces spread over ``seconds`` — a slow byte
  stream, not a slow first byte.
- ``reset``: forward, write a PARTIAL body, then abort the connection
  with an RST (``SO_LINGER`` 0) — the classic mid-response connection
  reset; the stream must be retried, never dropped.
- ``blackhole``: read the request, then hold the socket up to
  ``seconds`` and close WITHOUT replying — accept-and-never-answer,
  deadline propagation's worst case.
- ``error_500``: answer 500 with a JSON error body, upstream untouched.
- ``garbage_json``: answer 200 with a body that is not JSON — the
  intermediary error page / corrupted response case.
- ``flap_health``: answer the listed ``/healthz`` PROBE ordinals 503 —
  a flapping health endpoint must cost a tick of readiness, not an
  ejection.
- ``kill``: invoke the harness's ``on_kill(target)`` callback (which
  kills the real replica process) and abort the triggering connection —
  a hard replica death WITH streams in flight. Without a callback (the
  CLI fronting external replicas it does not own) the fault is
  record-only plus the abort.

Ordinals count per target per channel: ``requests`` index the
``POST /v1/generate`` calls THIS proxy has seen (0-based), ``probes``
index its ``GET /healthz`` calls. Every other path (``/admin/*``,
``/v1/cancel``, ``/readyz``, ``/metrics``) forwards untouched and
consumes no ordinal — a cancel must never eat a scheduled fault.

Hook contract mirrors ``FaultPlan``: each (fault, ordinal) pair fires
exactly once, fired records accumulate for ``drain_fired()`` (the
``{"chaos": kind, ...}`` JSONL timeline ``summarize_run`` reads), and
``counts()`` feeds the ``nanodiloco_chaos_injected`` counter family.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import urlsplit

KINDS = (
    "latency", "slow_drip", "reset", "blackhole", "error_500",
    "garbage_json", "flap_health", "kill",
)

#: kinds keyed by /healthz probe ordinals; everything else keys on
#: /v1/generate request ordinals
PROBE_KINDS = ("flap_health",)


class ChaosPlan:
    """Parsed, validated chaos schedule with firing bookkeeping.

    Thread-safe: one plan is shared by every proxy in a drill (each
    proxy's handler threads consult it concurrently), and the per-
    target per-channel ordinal is supplied by the proxy — the plan
    itself holds no clocks and no randomness."""

    def __init__(self, faults: list[dict[str, Any]]) -> None:
        self._lock = threading.Lock()
        self.fired: list[dict[str, Any]] = []   # records, in firing order
        self._counts: dict[str, int] = {}
        self.faults = []
        for i, f in enumerate(faults):
            if not isinstance(f, dict):
                raise ValueError(f"chaos fault #{i} is not an object: {f!r}")
            kind = f.get("kind")
            if kind not in KINDS:
                raise ValueError(
                    f"chaos fault #{i} has unknown kind {kind!r}; use one "
                    f"of {KINDS}"
                )
            if not isinstance(f.get("target"), str) or not f["target"]:
                raise ValueError(
                    f"chaos fault #{i} ({kind}) needs a non-empty target "
                    f"replica name; got {f.get('target')!r}"
                )
            f = dict(f)
            key = "probes" if kind in PROBE_KINDS else "requests"
            other = "requests" if key == "probes" else "probes"
            if f.get(other) is not None:
                raise ValueError(
                    f"chaos fault #{i} ({kind}) keys on {key!r}, not "
                    f"{other!r}"
                )
            ords = f.get(key)
            if not (isinstance(ords, list) and ords and all(
                isinstance(o, int) and not isinstance(o, bool) and o >= 0
                for o in ords
            )):
                raise ValueError(
                    f"chaos fault #{i} ({kind}) needs {key!r}: a non-empty "
                    f"list of integer ordinals >= 0; got {ords!r}"
                )
            f[key] = sorted(set(ords))
            if kind in ("latency", "slow_drip"):
                f["seconds"] = float(f.get("seconds", 0.5))
                if f["seconds"] <= 0:
                    raise ValueError(
                        f"{kind} fault #{i} seconds must be > 0"
                    )
            if kind == "slow_drip":
                f["chunk_bytes"] = int(f.get("chunk_bytes", 64))
                if f["chunk_bytes"] < 1:
                    raise ValueError(
                        f"slow_drip fault #{i} chunk_bytes must be >= 1"
                    )
            if kind == "blackhole":
                f["seconds"] = float(f.get("seconds", 30.0))
                if f["seconds"] <= 0:
                    raise ValueError(
                        f"blackhole fault #{i} seconds must be > 0"
                    )
            f["_idx"] = i
            f["_fired"] = set()   # ordinals already fired
            self.faults.append(f)

    @classmethod
    def from_dict(cls, doc: dict[str, Any]) -> "ChaosPlan":
        faults = doc.get("faults")
        if not isinstance(faults, list):
            raise ValueError(
                'chaos plan must be {"faults": [...]} with a list of fault '
                f"objects; got {type(faults).__name__}"
            )
        return cls(faults)

    @classmethod
    def load(cls, path: str) -> "ChaosPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def take(self, channel: str, target: str,
             ordinal: int) -> list[dict[str, Any]]:
        """Due, unfired faults for this (channel, target, ordinal) —
        marked fired and recorded. ``channel`` is ``"request"`` or
        ``"probe"``; each (fault, ordinal) pair fires exactly once."""
        key = "probes" if channel == "probe" else "requests"
        out = []
        with self._lock:
            for f in self.faults:
                if (f["target"] == target and f.get(key)
                        and ordinal in f[key]
                        and ordinal not in f["_fired"]):
                    f["_fired"].add(ordinal)
                    kind = f["kind"]
                    self._counts[kind] = self._counts.get(kind, 0) + 1
                    self.fired.append({
                        "chaos": kind, "target": target, "ordinal": ordinal,
                        **{k: v for k, v in f.items()
                           if not k.startswith("_")
                           and k not in ("kind", "target", key)},
                    })
                    out.append(f)
        return out

    def counts(self) -> dict[str, int]:
        """Injections by kind so far — the chaos counter family's data."""
        with self._lock:
            return dict(sorted(self._counts.items()))

    def drain_fired(self) -> list[dict[str, Any]]:
        """Fired records since the last drain — the harness logs each as
        a ``{"chaos": kind, ...}`` JSONL record, the fault-timeline
        shape ``summarize_run`` reads."""
        with self._lock:
            out, self.fired = self.fired, []
        return out


def chaos_families(counts: dict[str, int]) -> list:
    """The chaos injection counter family for ``render_exposition`` —
    one family, labeled by fault kind, embedded by whoever owns the
    drill's exposition (the proxy's ``/chaos/status`` carries the same
    numbers as JSON)."""
    if not counts:
        return []
    return [(
        "nanodiloco_chaos_injected", "counter",
        "wire faults injected by the chaos proxy, by kind (schedule-"
        "driven, per-target request/probe ordinals — deterministic)",
        [({"kind": k}, v) for k, v in sorted(counts.items())]
        + [(None, sum(counts.values()))],
    )]


class ChaosProxy:
    """A stdlib HTTP proxy fronting ONE replica, realizing the plan's
    faults for its ``target`` name. Start with ``start()``; the fleet
    router is pointed at ``url`` instead of the replica's own address,
    so every fault arrives through a real socket.

    ``on_kill(target)`` is the harness's replica-killer (SIGKILL a
    serve subprocess, ``stop()`` an in-process server); ``None`` makes
    ``kill`` faults record-only plus the connection abort."""

    def __init__(self, upstream_url: str, plan: ChaosPlan, target: str, *,
                 host: str = "127.0.0.1", port: int = 0,
                 on_kill: Callable[[str], None] | None = None) -> None:
        sp = urlsplit(upstream_url)
        if not sp.hostname or not sp.port:
            raise ValueError(
                f"upstream_url must be http://host:port; got {upstream_url!r}"
            )
        self.upstream_host = sp.hostname
        self.upstream_port = int(sp.port)
        self.plan = plan
        self.target = target
        self.on_kill = on_kill
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._request_ordinal = 0
        self._probe_ordinal = 0
        self._thread: threading.Thread | None = None

        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                proxy._handle(self, b"")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                proxy._handle(self, self.rfile.read(n) if n else b"")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self.url = f"http://{host}:{self.port}"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ChaosProxy":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"nanodiloco-chaos-{self.target}", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None

    # -- the wire ----------------------------------------------------------

    def _ordinal(self, channel: str) -> int:
        with self._lock:
            if channel == "probe":
                n = self._probe_ordinal
                self._probe_ordinal += 1
            else:
                n = self._request_ordinal
                self._request_ordinal += 1
        return n

    def _handle(self, h: BaseHTTPRequestHandler, body: bytes) -> None:
        path = h.path.split("?", 1)[0]
        if path == "/chaos/status":
            self._reply_json(h, 200, {
                "target": self.target,
                "counts": self.plan.counts(),
            })
            return
        faults: list[dict] = []
        if h.command == "POST" and path == "/v1/generate":
            faults = self.plan.take("request", self.target,
                                    self._ordinal("request"))
        elif h.command == "GET" and path == "/healthz":
            faults = self.plan.take("probe", self.target,
                                    self._ordinal("probe"))
        by_kind = {f["kind"]: f for f in faults}

        if "flap_health" in by_kind:
            self._reply_json(h, 503, {"alive": False, "chaos": "flap_health"})
            return
        if "error_500" in by_kind:
            self._reply_json(h, 500, {"error": "chaos injected 500"})
            return
        if "garbage_json" in by_kind:
            raw = b"<html>502 bad gateway (chaos)</html>"
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(raw)))
            h.end_headers()
            h.wfile.write(raw)
            return
        if "blackhole" in by_kind:
            # accept, read, never answer: hold the socket (bounded, so a
            # stopping drill does not leak the handler thread), then
            # close without a byte — the caller's timeout is the only
            # way out
            self._stop.wait(by_kind["blackhole"]["seconds"])
            self._abort(h)
            return
        if "kill" in by_kind:
            if self.on_kill is not None:
                try:
                    self.on_kill(self.target)
                except Exception:
                    pass  # the drill's killer failing must not also
                    # kill the proxy's handler thread
            self._abort(h)
            return
        if "latency" in by_kind:
            # request-path latency: the replica sees the request late,
            # the client sees the answer late — the slow-but-200 shape
            self._stop.wait(by_kind["latency"]["seconds"])

        code, headers, payload = self._forward(h.command, path, body)
        if code is None:
            # upstream dead (a killed replica behind a still-living
            # proxy): surface it as the wire would — an aborted
            # connection, not a synthesized status the router might
            # misread as the replica's own answer
            self._abort(h)
            return

        if "reset" in by_kind and payload:
            h.send_response(code)
            for k, v in headers:
                h.send_header(k, v)
            h.end_headers()
            try:
                h.wfile.write(payload[: max(1, len(payload) // 2)])
                h.wfile.flush()
            except OSError:
                pass
            self._abort(h)
            return

        h.send_response(code)
        for k, v in headers:
            h.send_header(k, v)
        h.end_headers()
        try:
            if "slow_drip" in by_kind and payload:
                f = by_kind["slow_drip"]
                chunks = [payload[i:i + f["chunk_bytes"]]
                          for i in range(0, len(payload), f["chunk_bytes"])]
                pause = f["seconds"] / max(1, len(chunks))
                for c in chunks:
                    h.wfile.write(c)
                    h.wfile.flush()
                    self._stop.wait(pause)
            elif payload:
                h.wfile.write(payload)
        except OSError:
            pass  # client gone mid-body: its problem, not the proxy's

    def _forward(self, method: str, path: str,
                 body: bytes) -> tuple[int | None, list, bytes]:
        try:
            conn = HTTPConnection(self.upstream_host, self.upstream_port,
                                  timeout=600.0)
            hdrs = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=body or None, headers=hdrs)
            r = conn.getresponse()
            payload = r.read()
            headers = [(k, v) for k, v in r.getheaders()
                       if k.lower() in ("content-type", "content-length")]
            if not any(k.lower() == "content-length" for k, _ in headers):
                headers.append(("Content-Length", str(len(payload))))
            conn.close()
            return r.status, headers, payload
        except OSError:
            return None, [], b""

    def _reply_json(self, h: BaseHTTPRequestHandler, code: int,
                    doc: dict) -> None:
        raw = (json.dumps(doc) + "\n").encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(raw)))
        h.end_headers()
        h.wfile.write(raw)

    def _abort(self, h: BaseHTTPRequestHandler) -> None:
        """Drop the connection with an RST (SO_LINGER 0): the peer sees
        a connection reset, not a polite FIN it could mistake for a
        complete short response."""
        try:
            h.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0),
            )
        except OSError:
            pass
        try:
            h.connection.close()
        except OSError:
            pass
        h.close_connection = True


#: The committed drill every harness runs (``serve_bench --workload
#: chaos`` and ``chip_agenda.py chaos``): one fault of every kind
#: against a 3-replica fleet — slow-but-200 latency and a drip on two
#: replicas, a mid-response reset, a 500 burst long enough to trip r1's
#: circuit breaker, a garbage body, one flapped healthz probe (must NOT
#: eject), a blackhole (deadline propagation's worst case), and a hard
#: kill of r2 with streams in flight. Ordinals are per-target request
#: counts, so the drill is schedule-driven regardless of which client
#: request lands where.
DRILL_PLAN = {"faults": [
    {"kind": "latency", "target": "r0", "requests": [1], "seconds": 1.0},
    {"kind": "slow_drip", "target": "r1", "requests": [2],
     "seconds": 0.4, "chunk_bytes": 48},
    {"kind": "reset", "target": "r2", "requests": [2]},
    {"kind": "error_500", "target": "r1", "requests": [3, 4, 5]},
    {"kind": "garbage_json", "target": "r0", "requests": [4]},
    {"kind": "flap_health", "target": "r2", "probes": [2]},
    {"kind": "blackhole", "target": "r0", "requests": [6], "seconds": 8.0},
    {"kind": "kill", "target": "r2", "requests": [5]},
]}


def proxy_fleet(replicas, plan: ChaosPlan, *,
                host: str = "127.0.0.1",
                on_kill: Callable[[str], None] | None = None):
    """Front each ``Replica`` with a started ``ChaosProxy`` and return
    ``(proxied_replicas, proxies)`` — the proxied list carries the SAME
    names and blackbox paths with proxy URLs, so the router's view of
    the fleet is unchanged except that every byte now crosses the
    chaos wire. Callers own ``stop()`` on the returned proxies."""
    import dataclasses

    proxies = []
    proxied = []
    for r in replicas:
        p = ChaosProxy(r.url, plan, r.name, host=host,
                       on_kill=on_kill).start()
        proxies.append(p)
        proxied.append(dataclasses.replace(r, url=p.url))
    return proxied, proxies


# noqa convenience: time is used by nothing above on purpose — every
# delay is a stop-event wait so a stopping drill never hangs teardown
_ = time
