"""Fleet router: N serve replicas behind one front door.

The serving tier (nanodiloco_tpu_torch/serve) is one replica: one engine, one
scheduler, one HTTP endpoint. This module is the fleet layer above it —
the piece that turns "a server" into "a service" (ROADMAP item 1, the
millions-of-users scenario; MegaScale's every-second-accounted
discipline, arXiv:2402.15627, applied to serving):

- **Load spreading.** ``POST /v1/generate`` forwards each request to the
  least-loaded READY replica, scored from the gauges the replicas
  already expose on their health bodies: queue depth + busy slots
  first, then most free KV blocks (HBM headroom breaks ties — two
  replicas with equal queues differ in how many more admissions their
  block pools can take). A local in-flight counter per replica keeps
  the spread honest BETWEEN health ticks.
- **Ejection.** A health loop probes every replica's ``/healthz``
  (liveness) and ``/readyz`` (readiness). An explicit 503 on /healthz
  means the engine loop DIED — that replica never recovers and is
  ejected immediately; an unreachable socket is ejected after
  ``eject_after_failures`` consecutive probes (a restart window is not
  a death). The ejection event attaches the replica's flight-recorder
  black box (``serve --blackbox`` dump) when one exists: the forensics
  travel WITH the fleet event, not in a log directory someone has to
  know about.
- **Drain/refill weight pushes.** ``push_weights`` walks the target
  replicas ONE AT A TIME: drain (the replica flips not-ready and stops
  admitting; the router stops routing to it), wait — bounded — for
  in-flight streams to finish, ``/admin/swap`` the new checkpoint in,
  resume. One replica is re-weighting at any moment, so fleet capacity
  never drops by more than one replica. The wait is hygiene, not
  correctness: the engine's weight-generation machinery makes a swap
  under stragglers safe (they finish on the old weights).
- **Fleet goodput.** Every replica-second is attributed to a state
  (``obs.goodput.FLEET_STATE_CAUSES``: serving-ready / serving-unready
  / draining / ejected / scaling-up / scaling-down), so ONE number says
  what fraction of the fleet's tracked replica-seconds was actually
  available to serve tokens — the goodput ledger's discipline extended
  across the fleet, including the autoscaler's transition seconds.
  Every promote/rollback/eject/drain/swap event lands in the deploy
  JSONL (``events_jsonl``) read by ``summarize_run`` / ``report``.
- **Request-level resilience.** End-to-end deadline propagation (a
  client ``timeout_s`` bounds the whole request and rides to the
  replica as ``deadline_s``, so the scheduler's expiry stops decoding
  for departed clients), hedged requests (p95-derived hedge delay,
  first answer wins, the loser cancelled through ``/v1/cancel`` so its
  slot and KV blocks free), a token-bucket retry budget (retries and
  hedges capped as a fraction of recent successes — overload degrades
  into honest errors, never a retry storm), and a per-replica circuit
  breaker (rolling failure/slow-rate window, half-open single-probe
  recovery) that catches the slow-but-200 gray failures the binary
  healthz eject cannot — feeding route-around and the ``breaker_open``
  goodput bucket, never ejection. Drilled end-to-end by
  ``fleet/chaos.py``.
- **Elastic membership + class-aware admission.** ``add_replica`` /
  ``remove_replica`` let the autoscaler (``fleet/autoscaler.py``) grow
  and shrink the fleet through the same drain discipline as a weight
  push, and ``set_admission`` / ``POST /fleet/admission`` sets the
  priority ceiling above which requests are SHED with a terminal 429
  (``"shed": true`` in the body — distinct from a busy 429, which is
  retried on another replica).

Testability follows the scheduler's discipline: the probe and post
functions, clock, and sleep are injectable, so every routing and
ejection decision is provable with scripted replicas and a fake clock —
no sockets, no model (tests/test_fleet.py).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from nanodiloco_tpu_torch.obs import flightrec
from nanodiloco_tpu_torch.obs.goodput import FLEET_STATE_CAUSES
from nanodiloco_tpu_torch.obs.tracer import TraceContext
from nanodiloco_tpu_torch.obs.telemetry import (
    OPENMETRICS_CONTENT_TYPE,
    nearest_rank_percentile,
    render_exposition,
)
from nanodiloco_tpu_torch.serve.client import http_get, http_post_json

#: deploy-event kinds the router/controller counters track (one counter
#: family on /metrics; unknown kinds still log, they just don't gauge)
EVENT_KINDS = (
    "promote", "rollback", "rollback_failed", "eject", "drain", "swap",
    "swap_failed", "canary_start", "canary_baseline",
    "canary_baseline_failed", "canary_verdict", "canary_failed",
    "canary_deferred", "slo_burn", "slo_clear",
    # elastic capacity (fleet/autoscaler.py): membership changes, the
    # autoscaler's decisions, spot-preemption recoveries, and admission
    # ceiling moves
    "replica_added", "replica_removed", "scale_up", "scale_down",
    "preempt", "preempt_resume", "shed_level",
    # per-replica circuit breaker (request-level resilience): trip,
    # half-open recovery probe window, and recovery — route-around
    # transitions, never ejections
    "breaker_open", "breaker_half_open", "breaker_close",
)

#: breaker transition -> the deploy-event kind it logs as
_BREAKER_EVENT = {"open": "breaker_open", "half_open": "breaker_half_open",
                  "close": "breaker_close"}
# gauge encoding for nanodiloco_router_breaker_state (unknown reads as
# open: fail toward "this replica is not routable")
_BREAKER_STATE_GAUGE = {"closed": 0, "half_open": 1, "open": 2}


@dataclasses.dataclass(frozen=True)
class Replica:
    """One serve replica the router fronts. ``url`` is the base
    (``http://host:port``); ``blackbox`` is the path of the replica's
    ``serve --blackbox`` dump, attached to its ejection event when the
    file exists."""

    name: str
    url: str
    blackbox: str | None = None


class _Breaker:
    """Per-replica circuit breaker over FORWARD outcomes — the gray-
    failure detector the binary healthz eject cannot be. A rolling
    window of per-attempt results trips ``open`` once the bad rate
    (transport errors and 5xx, plus successes slower than ``slow_s``
    when set) reaches ``failure_rate`` with at least ``min_samples``
    observations. Open cools for ``open_s`` on the injected clock, then
    ``half_open`` admits EXACTLY ONE probe request, whose outcome
    closes the breaker (window cleared) or re-opens it. The breaker
    feeds ROUTE-AROUND (pick ranking) and the ``breaker_open`` goodput
    bucket, never ejection: a gray replica is slow, not dead.

    All mutation happens under the router's lock. ``pending`` holds
    transition names the router drains into deploy events (the drain
    happens on the request path and every health tick, so a transition
    is never silently swallowed by whichever code path advanced it)."""

    def __init__(self, clock: Callable[[], float], *, window: int = 20,
                 min_samples: int = 5, failure_rate: float = 0.5,
                 open_s: float = 10.0,
                 slow_s: float | None = None) -> None:
        self._clock = clock
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.failure_rate = float(failure_rate)
        self.open_s = float(open_s)
        self.slow_s = None if slow_s is None else float(slow_s)
        self.state = "closed"
        self.opens = 0
        self.pending: list[str] = []
        self._results: deque = deque(maxlen=self.window)
        self._opened_at = 0.0
        self._probing = False

    def _trip(self) -> None:
        self.state = "open"
        self._opened_at = self._clock()
        self._probing = False
        self.opens += 1
        self._results.clear()
        self.pending.append("open")

    def note(self, ok: bool, latency_s: float | None = None) -> None:
        """Record one forwarded-attempt outcome."""
        bad = (not ok) or (self.slow_s is not None
                           and latency_s is not None
                           and latency_s > self.slow_s)
        state = self.current()
        if state == "open":
            return  # a straggler attempt launched before the trip:
            # its late result must not extend the cooldown
        if state == "half_open":
            self._probing = False
            if bad:
                self._trip()
            else:
                self.state = "closed"
                self._results.clear()
                self.pending.append("close")
            return
        self._results.append(bad)
        n = len(self._results)
        if (n >= self.min_samples
                and sum(self._results) / n >= self.failure_rate):
            self._trip()

    def current(self) -> str:
        """The state, advancing open -> half_open once ``open_s`` has
        cooled on the injected clock."""
        if (self.state == "open"
                and self._clock() - self._opened_at >= self.open_s):
            self.state = "half_open"
            self._probing = False
            self.pending.append("half_open")
        return self.state

    def rank(self) -> int:
        """Routing preference: 0 closed, 1 half-open awaiting its one
        recovery probe, 2 open (or half-open with the probe already in
        flight). Rank-2 replicas remain PICKABLE when nothing better
        exists — a degraded answer beats a 503."""
        s = self.current()
        if s == "closed":
            return 0
        if s == "half_open" and not self._probing:
            return 1
        return 2


class _ReplicaState:
    """Per-replica tracking: status, readiness, last health stats, and
    per-state wall-clock seconds (the fleet goodput numerator). All
    mutation happens under the router's lock."""

    def __init__(self, replica: Replica, clock: Callable[[], float],
                 status: str = "serving",
                 breaker: _Breaker | None = None) -> None:
        self.replica = replica
        # serving | draining | ejected | scaling_up | scaling_down —
        # the latter two are the autoscaler's transition states: a
        # launched-but-not-yet-ready replica and a retiring one. Their
        # seconds land in their OWN goodput buckets (FLEET_STATE_CAUSES
        # is the closed set), never silently folded into unready.
        self.status = status
        self.ready = False             # last readiness probe
        self.failures = 0              # consecutive unreachable probes
        self.stats: dict = {}          # queue_depth/slots_busy/kv_blocks_free/...
        self.router_inflight = 0       # requests this router has in flight here
        self.breaker = breaker or _Breaker(clock)
        self._clock = clock
        self._since = clock()
        self.seconds = {cause: 0.0 for cause in FLEET_STATE_CAUSES}

    def _bucket(self) -> str:
        if self.status == "serving":
            # a tripped (or half-open) breaker is a named goodput cause:
            # the replica is nominally serving but the router is routing
            # around a gray failure — those seconds must never be booked
            # as ready capacity nor silently dropped
            if self.breaker.current() != "closed":
                return "breaker_open"
            return "serving_ready" if self.ready else "serving_unready"
        return self.status

    def account(self) -> None:
        """Fold elapsed time into the CURRENT state bucket (called on
        every transition and before every snapshot, so the partition is
        exact by construction — the goodput ledger's rule)."""
        now = self._clock()
        self.seconds[self._bucket()] += max(0.0, now - self._since)
        self._since = now

    def set(self, status: str | None = None,
            ready: bool | None = None) -> None:
        self.account()
        if status is not None:
            self.status = status
        if ready is not None:
            self.ready = ready


class FleetRouter:
    """HTTP front + health loop + drain/refill weight pushes over a
    replica set. ``probe``/``post`` are injectable (tests script them);
    the defaults speak the serve wire contract via ``serve/client``."""

    def __init__(
        self,
        replicas: list[Replica],
        *,
        port: int = 0,
        host: str = "0.0.0.0",
        probe: Callable[[Replica], dict] | None = None,
        post: Callable[..., tuple[int, dict]] | None = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        health_interval_s: float = 1.0,
        probe_timeout_s: float = 2.0,
        eject_after_failures: int = 3,
        drain_timeout_s: float = 30.0,
        request_timeout_s: float = 600.0,
        hedge_after_s: float | None = None,
        hedge_min_delay_s: float = 0.05,
        hedge_min_samples: int = 16,
        retry_budget_ratio: float = 0.2,
        retry_budget_min: float = 3.0,
        retry_budget_cap: float = 10.0,
        breaker_window: int = 20,
        breaker_min_samples: int = 5,
        breaker_failure_rate: float = 0.5,
        breaker_open_s: float = 10.0,
        breaker_slow_s: float | None = None,
        events_jsonl: str | None = None,
        tracer=None,
        quiet: bool = False,
    ) -> None:
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique; got {names}")
        self._clock = clock
        self._wall = wall
        self._sleep = sleep
        self._probe = probe or self._http_probe
        self._post = post or self._http_post
        self.health_interval_s = float(health_interval_s)
        # per-GET bound for the health probes, deliberately well below
        # the request timeout: the sweep is CONCURRENT (one thread per
        # replica, joined against this bound), so one dead host (SYN
        # timeout, no RST) costs one probe_timeout_s, not (N-1) of them
        # stacked in front of every other replica's ejection
        self.probe_timeout_s = float(probe_timeout_s)
        self.eject_after_failures = int(eject_after_failures)
        self.drain_timeout_s = float(drain_timeout_s)
        self._request_timeout_s = float(request_timeout_s)
        # request-level resilience. Hedge delay: None = adaptive (p95 of
        # recent winner latencies once hedge_min_samples exist, floored
        # at hedge_min_delay_s); > 0 = fixed; <= 0 = hedging disabled.
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self._hedge_after_s = (None if hedge_after_s is None
                               else float(hedge_after_s))
        # token-bucket retry budget: a retry/hedge costs 1 token, every
        # success deposits retry_budget_ratio (capped) — under fleet-
        # wide failure the budget drains and excess retries become
        # honest errors instead of amplifying into a retry storm
        self.retry_budget_ratio = float(retry_budget_ratio)
        self.retry_budget_cap = float(retry_budget_cap)
        self._retry_tokens = float(retry_budget_min)
        self._breaker_kw = dict(
            window=breaker_window, min_samples=breaker_min_samples,
            failure_rate=breaker_failure_rate, open_s=breaker_open_s,
            slow_s=breaker_slow_s,
        )
        self._resilience = {
            "hedges": 0, "hedge_wins": 0, "retries": 0,
            "retry_budget_exhausted": 0, "deadline_expired": 0,
            "breaker_opens": 0,
        }
        self._latencies: deque = deque(maxlen=512)  # winner latencies
        self.events_jsonl = events_jsonl
        # per-request span sink (obs/tracer.SpanTracer or None): the
        # router records route/forward spans via record_span with ITS
        # OWN clock's timestamps, tagged with the request_id join key —
        # construct the tracer with the same clock callable. Exported
        # through `fleet --trace-out` + `report merge-trace`, these put
        # the router hop on the same Perfetto timeline as the replica's
        # queued/prefill/decode spans for the same request.
        self.tracer = tracer
        self.quiet = quiet
        # SLO burn state (obs/slo action hook, via set_slo_burning or
        # POST /fleet/slo): replica-scope rules make that replica
        # NOT-PREFERRED (routed to only when no clean replica is ready
        # — route-around before any 503-ejection: a burning replica is
        # slow, not dead); fleet-scope rules gate the deploy
        # controller's canary (slo_burning()).
        self._slo_not_preferred: dict[str, set] = {}   # replica -> rule names
        # burning fleet-scope alerts, keyed (rule, target): the monitor
        # fires per (rule, target) pair, and collapsing to rule names
        # would let one target's resolve clear the canary gate while
        # another target's alert still burns
        self._slo_fleet: set = set()                   # {(rule, target)}
        self._req_seq = 0
        self._states = [
            _ReplicaState(r, clock, breaker=self._make_breaker())
            for r in replicas
        ]
        self._by_name = {st.replica.name: st for st in self._states}
        # reentrant: the health tick ejects (and so logs/counts an
        # event) while holding the state lock
        self._lock = threading.RLock()
        # serializes whole push_weights calls (controller thread vs an
        # operator's /fleet/push) — see push_weights
        self._push_lock = threading.Lock()
        self._events_lock = threading.Lock()
        self._counters: dict[str, int] = {}
        # class-aware admission: classes ABOVE this ceiling are shed at
        # the router (terminal 429 with "shed": true) — set by the
        # autoscaler / POST /fleet/admission under fleet burn or
        # forecasted exhaustion; 9 admits everything
        self._admission_max_priority = 9
        self._shed_by_class: dict[int, int] = {}
        # goodput seconds of replicas REMOVED from the fleet (scale-in):
        # retained so the fleet fraction stays every-second-accounted —
        # a retired replica's serving life must not vanish from the
        # denominator
        self._departed_seconds = {cause: 0.0 for cause in FLEET_STATE_CAUSES}
        self._departed_count = 0
        self._t0 = clock()
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self._http_thread: threading.Thread | None = None

        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # scrapes must not spam stdout
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, doc: dict) -> None:
                self._reply(code, (json.dumps(doc) + "\n").encode(),
                            "application/json")

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._reply(200, router.render_metrics().encode(),
                                OPENMETRICS_CONTENT_TYPE)
                elif path in ("/healthz", "/readyz"):
                    code, doc = router.health()
                    self._reply_json(code, doc)
                elif path == "/fleet/status":
                    self._reply_json(200, router.fleet_stats())
                else:
                    self._reply(404, b"not found\n", "text/plain")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._reply_json(400, {"error": f"bad JSON: {e}"})
                    return
                if path == "/v1/generate":
                    code, out = router.handle_generate(doc)
                    self._reply_json(code, out)
                elif path == "/fleet/push":
                    code, out = router.handle_push(doc)
                    self._reply_json(code, out)
                elif path == "/fleet/slo":
                    code, out = router.handle_slo(doc)
                    self._reply_json(code, out)
                elif path == "/fleet/admission":
                    code, out = router.handle_admission(doc)
                    self._reply_json(code, out)
                else:
                    self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetRouter":
        self.health_tick()  # replicas routable before the first request
        if self._health_thread is None:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="nanodiloco-fleet-health",
                daemon=True,
            )
            self._health_thread.start()
        if self._http_thread is None:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="nanodiloco-fleet-http", daemon=True,
            )
            self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in (self._health_thread, self._http_thread):
            if t is not None:
                t.join(timeout=5)
        self._health_thread = self._http_thread = None
        # the final fleet-goodput record: the one number for this
        # router's whole life, next to the deploy events that shaped it
        self._append_jsonl({"fleet_goodput": self.fleet_stats()})

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.health_tick()
            except Exception:  # a probe bug must never kill routing
                pass
            self._stop.wait(self.health_interval_s)

    # -- wire defaults (injectable) ------------------------------------------

    def _http_probe(self, replica: Replica) -> dict:
        """One observation of a replica over the wire:
        ``{"reachable", "live", "ready", "stats"}``. The stats ride on
        the health/readiness BODIES (queue_depth, slots_busy,
        kv_blocks_free, deploy_generation, in_flight) — no /metrics
        parse on the health path."""
        out: dict = {"reachable": False, "live": False, "ready": False,
                     "stats": {}}
        try:
            code, body = http_get(replica.url + "/healthz",
                                  timeout=self.probe_timeout_s)
        except (OSError, http.client.HTTPException):
            # HTTPException covers a connection RESET mid-body
            # (IncompleteRead) — a chaos-grade gray failure that is
            # neither a refused socket nor a parsed status
            return out
        out["reachable"] = True
        out["live"] = code == 200
        try:
            doc = json.loads(body)
        except (json.JSONDecodeError, ValueError):
            doc = {}
        for k in ("queue_depth", "slots_busy", "kv_blocks_free",
                  "deploy_generation", "draining", "device_seconds_total",
                  "role"):
            if doc.get(k) is not None:
                out["stats"][k] = doc[k]
        try:
            rcode, rbody = http_get(replica.url + "/readyz",
                                    timeout=self.probe_timeout_s)
            out["ready"] = rcode == 200
            rdoc = json.loads(rbody)
            if isinstance(rdoc, dict) and rdoc.get("in_flight") is not None:
                out["stats"]["in_flight"] = rdoc["in_flight"]
        except (OSError, json.JSONDecodeError, ValueError,
                http.client.HTTPException):
            out["ready"] = False
        return out

    def _http_post(self, replica: Replica, path: str, doc: dict,
                   timeout: float | None = None) -> tuple[int, dict]:
        return http_post_json(
            replica.url + path, doc,
            timeout=self._request_timeout_s if timeout is None else timeout,
        )

    # -- health + ejection ---------------------------------------------------

    def health_tick(self) -> None:
        """One CONCURRENT probe sweep over the non-ejected replicas:
        refresh readiness + load stats, count consecutive failures,
        eject. Probes run in parallel, each under the same per-probe
        bound — sequentially, one blackholed host (SYN timeout, no RST)
        put the LAST replica's detection ``(N-1) * probe_timeout_s``
        behind the dead one; concurrently the whole sweep is bounded by
        roughly one probe's timeout regardless of N."""
        with self._lock:
            states = [st for st in self._states if st.status != "ejected"]
        results: dict[str, dict] = {}

        def _probe_one(st: _ReplicaState) -> None:
            try:
                results[st.replica.name] = self._probe(st.replica) or {}
            except Exception:  # a probe bug must never kill the sweep
                results[st.replica.name] = {}

        threads = []
        for st in states:
            t = threading.Thread(target=_probe_one, args=(st,),
                                 name="nanodiloco-fleet-probe",
                                 daemon=True)
            t.start()
            threads.append(t)
        # real-time join bound (probe threads are real even under an
        # injected clock): 2x covers the probe's two GETs (healthz +
        # readyz), the headroom covers thread scheduling. A probe still
        # hung past the bound reads as this tick's unreachable.
        deadline = time.monotonic() + 2 * self.probe_timeout_s + 1.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        for st in states:
            r = results.get(st.replica.name) or {}
            with self._lock:
                if st.status == "ejected":  # a push thread raced us
                    continue
                confirm = self._apply_probe_locked(st, r, confirmed=False)
            if confirm:
                # one flapped /healthz 503 must not eject (the chaos
                # taxonomy's flap_health case): re-probe before calling
                # it the engine loop's death. The replica is unroutable
                # while unconfirmed, and a PERSISTENT 503 still ejects
                # within this same tick.
                try:
                    r2 = self._probe(st.replica) or {}
                except Exception:
                    r2 = {}
                with self._lock:
                    if st.status != "ejected":
                        self._apply_probe_locked(st, r2, confirmed=True)
            # advance the breaker's open->half_open cooldown and flush
            # any transition events it accumulated off the request path
            with self._lock:
                if st.status != "ejected":
                    st.breaker.current()
            self._drain_breaker(st)

    def _apply_probe_locked(self, st: _ReplicaState, r: dict,
                            confirmed: bool) -> bool:
        """Apply one probe observation (caller holds the lock). Returns
        True when the observation was a reachable-but-503 healthz that
        needs a confirming re-probe before the eject."""
        stats = r.get("stats") or {}
        if stats:
            st.stats.update(stats)
        if st.status == "scaling_up":
            # a booting replica is EXPECTED unreachable (process
            # start + compile): no failure budget until it has
            # joined. First live+ready probe promotes it to a
            # routing candidate and closes its scaling_up
            # seconds bucket.
            if r.get("live") and r.get("ready"):
                st.failures = 0
                st.set(status="serving", ready=True)
            return False
        if r.get("live"):
            st.failures = 0
            # a replica draining ITSELF (a push in progress)
            # stays unroutable regardless of its readyz
            st.set(ready=bool(r.get("ready"))
                   and st.status == "serving")
            return False
        if st.status == "scaling_down":
            return False  # retiring: unreachable is the expected end
        if r.get("reachable"):
            # an explicit /healthz 503: the engine loop DIED. It never
            # comes back — eject (after one confirming re-probe, which
            # separates a flapping health endpoint from a dead loop),
            # don't wait out the failure budget meant for restarts.
            if not confirmed:
                st.set(ready=False)
                return True
            self._eject_locked(st, "healthz_503")
            return False
        st.failures += 1
        st.set(ready=False)
        if st.failures >= self.eject_after_failures:
            self._eject_locked(st, "unreachable")
        return False

    def _eject_locked(self, st: _ReplicaState, reason: str) -> None:
        """Eject a replica (caller holds the lock): it stops being a
        routing candidate permanently, and its flight-recorder black
        box — if one landed on disk — is attached to the event, so the
        ejection carries its own forensics."""
        st.set(status="ejected", ready=False)
        fields: dict = {"replica": st.replica.name, "reason": reason}
        bb = self._read_blackbox(st.replica)
        if bb:
            fields["blackbox"] = bb
        self.log_event("eject", **fields)

    def _read_blackbox(self, replica: Replica) -> dict | None:
        path = replica.blackbox
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                doc = json.load(f)
            return {
                "path": path,
                "reason": doc.get("reason"),
                "t_unix": doc.get("t_unix"),
                "events": len(doc.get("events") or []),
            }
        except (OSError, json.JSONDecodeError, ValueError):
            return {"path": path}

    # -- elastic membership (fleet/autoscaler.py) ----------------------------

    def add_replica(self, replica: Replica, *,
                    source: str = "autoscaler") -> None:
        """Join a replica to the fleet in the ``scaling_up`` state: its
        seconds are booked to the ``scaling_up`` goodput bucket until
        the health loop sees it live AND ready, at which point it
        becomes a routing candidate. Boot-time unreachability costs it
        nothing (the failure budget starts once it has joined)."""
        with self._lock:
            if replica.name in self._by_name:
                raise ValueError(
                    f"replica {replica.name!r} is already in the fleet"
                )
            st = _ReplicaState(replica, self._clock, status="scaling_up",
                               breaker=self._make_breaker())
            self._states.append(st)
            self._by_name[replica.name] = st
        self.log_event("replica_added", replica=replica.name,
                       url=replica.url, source=source)

    def remove_replica(self, name: str, *, drain: bool = True,
                       reason: str = "scale_down") -> dict:
        """Retire a replica: flip it to ``scaling_down`` (unroutable),
        optionally drain it and wait — bounded — for in-flight streams,
        then drop it from the fleet. Its per-state seconds are folded
        into the departed ledger so the fleet goodput fraction keeps
        accounting for every second it existed."""
        with self._lock:
            st = self._by_name.get(name)
            if st is None:
                raise ValueError(f"unknown replica {name!r}; replicas "
                                 f"are {self.replica_names()}")
            was_ejected = st.status == "ejected"
            if not was_ejected:
                st.set(status="scaling_down", ready=False)
        if drain and not was_ejected:
            try:
                self._post(st.replica, "/admin/drain", {}, timeout=30.0)
                t0 = self._clock()
                while self._clock() - t0 < self.drain_timeout_s:
                    r = self._probe(st.replica)
                    if not r.get("reachable"):
                        break
                    if (r.get("stats") or {}).get("in_flight", 0) == 0:
                        break
                    self._sleep(0.05)
            except (OSError, ValueError, http.client.HTTPException):
                pass  # an unreachable retiree is already as drained
                # as it will ever be
        with self._lock:
            st.account()
            for k, v in st.seconds.items():
                self._departed_seconds[k] += v
            self._departed_count += 1
            self._states.remove(st)
            del self._by_name[name]
            seconds = {k: round(v, 6) for k, v in st.seconds.items()}
        self.log_event("replica_removed", replica=name, reason=reason,
                       seconds=seconds)
        return {"replica": name, "seconds": seconds}

    # -- class-aware admission (overload shedding) ---------------------------

    def handle_admission(self, doc: dict) -> tuple[int, dict]:
        """POST /fleet/admission: ``{"max_priority": N}`` — set the
        class-shedding ceiling (classes above N get terminal shed
        429s). The autoscaler's wire form; operators can use it too."""
        try:
            mp = self.set_admission(doc.get("max_priority"))
        except ValueError as e:
            return 400, {"error": str(e)}
        return 200, {"max_priority": mp, "shed_by_class": dict(
            sorted(self._shed_by_class.items()))}

    def set_admission(self, max_priority: int, *,
                      reason: str | None = None) -> int:
        """Set the admission ceiling; an actual change logs a
        ``shed_level`` event (the honest record of when the fleet
        started/stopped sacrificing which classes)."""
        if not isinstance(max_priority, int) or isinstance(
                max_priority, bool) or not -1 <= max_priority <= 9:
            raise ValueError(
                f"max_priority must be an integer in [-1, 9]; got "
                f"{max_priority!r}"
            )
        with self._lock:
            changed = self._admission_max_priority != max_priority
            self._admission_max_priority = max_priority
        if changed:
            self.log_event(
                "shed_level", max_priority=max_priority,
                **({"reason": reason} if reason else {}),
            )
        return max_priority

    def admission_max_priority(self) -> int:
        with self._lock:
            return self._admission_max_priority

    # -- request-level resilience (breaker / retry budget / hedging) ---------

    def _make_breaker(self) -> _Breaker:
        return _Breaker(self._clock, **self._breaker_kw)

    def _drain_breaker(self, st: _ReplicaState) -> None:
        """Flush a breaker's pending transitions into deploy events +
        the trip counter (called wherever the breaker may have
        advanced: after a forward outcome, and every health tick)."""
        with self._lock:
            pend, st.breaker.pending = list(st.breaker.pending), []
            for tr in pend:
                if tr == "open":
                    self._resilience["breaker_opens"] += 1
        for tr in pend:
            self.log_event(_BREAKER_EVENT[tr], replica=st.replica.name)

    def _breaker_note(self, st: _ReplicaState, ok: bool,
                      latency_s: float | None = None) -> None:
        with self._lock:
            st.breaker.note(ok, latency_s)
        self._drain_breaker(st)

    def breaker_open_replicas(self) -> list[str]:
        """Serving replicas whose breaker is open or half-open — routed
        around, so NOT usable supply (the autoscaler subtracts them
        from the capacity model's serving set)."""
        with self._lock:
            return sorted(
                st.replica.name for st in self._states
                if st.status == "serving"
                and st.breaker.current() != "closed"
            )

    def _retry_take(self, kind: str) -> bool:
        """Spend one retry-budget token on a retry or hedge. An empty
        bucket refuses (counted): under fleet-wide failure the router
        stops amplifying load and returns the honest error instead."""
        with self._lock:
            if self._retry_tokens >= 1.0:
                self._retry_tokens -= 1.0
                self._resilience[
                    "hedges" if kind == "hedge" else "retries"] += 1
                return True
            self._resilience["retry_budget_exhausted"] += 1
            return False

    def _retry_deposit(self) -> None:
        with self._lock:
            self._retry_tokens = min(
                self.retry_budget_cap,
                self._retry_tokens + self.retry_budget_ratio,
            )

    def _hedge_delay(self) -> float | None:
        """Seconds to wait before hedging, or None when hedging should
        not arm: fixed when ``hedge_after_s`` > 0, disabled when <= 0,
        else the p95 of recent winner latencies (floored at
        ``hedge_min_delay_s``) once enough samples exist — hedge only
        the TAIL, never the typical request."""
        if self._hedge_after_s is not None:
            return self._hedge_after_s if self._hedge_after_s > 0 else None
        with self._lock:
            lats = sorted(self._latencies)
        if len(lats) < self.hedge_min_samples:
            return None
        return max(self.hedge_min_delay_s,
                   nearest_rank_percentile(lats, 0.95))

    def _cancel_request(self, replica: Replica, rid: str) -> None:
        """Fire-and-forget ``/v1/cancel`` to a hedge/deadline loser:
        frees its slot and KV blocks through the scheduler's existing
        ticket-cancel path. Never awaited — a blackholed loser must not
        add its own timeout to the winner's latency."""
        def _run():
            try:
                self._post(replica, "/v1/cancel", {"request_id": rid},
                           timeout=10.0)
            except Exception:
                pass  # best-effort: the replica-side deadline expiry
                # is the backstop for an unreachable loser

        threading.Thread(target=_run, daemon=True,
                         name="nanodiloco-fleet-cancel").start()

    # -- routing -------------------------------------------------------------

    def pick(self, tier: str | None = None) -> _ReplicaState | None:
        """Least-loaded READY replica: lowest queue depth + busy slots
        (+ this router's own in-flight count, which keeps the spread
        honest between health ticks), then MOST free KV blocks, then
        name for determinism. ``tier`` restricts candidates to the
        replicas whose declared role serves that tier (disaggregated
        serving — see ``_tier_match``)."""
        return self._pick_excluding(set(), tier=tier)

    @staticmethod
    def _tier_match(stats: dict, tier: str | None) -> bool:
        """Does a replica's declared role serve ``tier``? A replica
        that never declared one (an older serve build) reads as
        ``both`` — monolithic, eligible for either tier."""
        if tier is None:
            return True
        role = stats.get("role") or "both"
        return role == tier or role == "both"

    def tier_counts(self) -> dict:
        """Serving-and-ready replicas by declared role — the
        ``nanodiloco_fleet_tier_replicas`` gauge and the disagg
        autoscaler's tier census."""
        out = {"prefill": 0, "decode": 0, "both": 0}
        with self._lock:
            for st in self._states:
                if st.status == "serving" and st.ready:
                    role = st.stats.get("role") or "both"
                    out[role if role in out else "both"] += 1
        return out

    def tier_capacity_names(self, tier: str | None) -> list[str]:
        """Replica names that count as USABLE capacity for ``tier``:
        serving, ready, breaker closed, role matching. This is what the
        tier-scoped ``CapacityModel`` targets — an open-breaker or
        draining prefill replica must never count toward decode
        capacity (nor vice versa)."""
        with self._lock:
            return sorted(
                st.replica.name for st in self._states
                if st.status == "serving" and st.ready
                and st.breaker.current() == "closed"
                and self._tier_match(st.stats, tier)
            )

    def _span(self, name: str, t0: float, t1: float, request_id: str,
              ctx=None, **args) -> None:
        if self.tracer is not None:
            self.tracer.record_span(
                name, t0, t1, ctx=ctx, request_id=request_id, **args
            )

    def _accept_trace(self, doc: dict):
        """The route span's causal context: adopt the client's wire
        context (its sampling decision wins) or mint a fresh trace at
        this edge. None when no tracer is installed — every ctx=
        consumer treats None as untraced."""
        if self.tracer is None:
            return None
        wire = TraceContext.from_wire(doc.get("trace_context"))
        if wire is not None:
            return wire.child()
        return self.tracer.new_trace()

    def handle_generate(self, doc: dict) -> tuple[int, dict]:
        """Forward one request with the full resilience stack:

        - **Deadline propagation.** A client ``timeout_s`` becomes the
          router's whole budget (``request_timeout_s`` otherwise): each
          attempt's wire timeout is the REMAINING budget, and the
          forwarded body carries ``deadline_s`` (min of remaining and
          any client-supplied deadline) so the scheduler's expiry stops
          decoding for a departed client instead of burning attributed
          device-seconds. An exhausted budget is an honest 504.
        - **Retry.** One retry on a DIFFERENT replica when an attempt
          answers 503/429-busy/5xx or the socket fails (the health loop
          owns ejection — a forward failure only counts against the
          failure budget). Retries spend the token-bucket retry budget;
          an empty bucket returns the honest error instead of
          amplifying fleet-wide failure into a retry storm.
        - **Hedging.** When the sole attempt outlives the hedge delay
          (p95 of recent winner latencies, or a fixed override), a
          second attempt launches on another ready replica; first
          answer wins, the loser is cancelled through the replica's
          ticket-cancel path (slot + KV blocks freed). Hedges spend the
          same retry budget.
        - A 429 carrying ``"shed": true`` stays TERMINAL fleet policy
          (never retried, never hedged) — the two-429 contract is
          unchanged.

        The ``request_id`` join key is stamped HERE when the client did
        not supply one, and the SAME body — same id — rides every
        attempt: stamping per-attempt would hand the retry/hedge
        replica a different id and break the router-span/replica-span
        trace join for exactly the requests that needed diagnosing
        (merged traces join BOTH attempts of a hedged request). The
        response echoes ``served_by`` (which replica actually answered
        — on a retry or a hedge win that is NOT the first pick)."""
        rid = doc.get("request_id")
        if not isinstance(rid, str) or not rid:
            with self._lock:
                self._req_seq += 1
                rid = f"rtr-{self._req_seq}"
        doc = {**doc, "request_id": rid}
        route_ctx = self._accept_trace(doc)
        timeout_s = doc.pop("timeout_s", None)
        if timeout_s is not None:
            if (isinstance(timeout_s, bool)
                    or not isinstance(timeout_s, (int, float))
                    or not timeout_s > 0):
                return 400, {
                    "error": f"timeout_s must be a positive number of "
                             f"seconds; got {timeout_s!r}",
                    "request_id": rid,
                }
            timeout_s = float(timeout_s)
        t_route = self._clock()
        budget = (timeout_s if timeout_s is not None
                  else self._request_timeout_s)
        deadline_at = t_route + budget
        # class-aware shedding at the front door: a request whose class
        # is above the admission ceiling never touches a replica — the
        # 429 says so explicitly ("shed": true + the class), because it
        # is fleet POLICY, not one replica's backpressure, and the
        # client must not retry it anywhere
        prio = doc.get("priority", 1)
        if not isinstance(prio, int) or isinstance(prio, bool):
            prio = 1  # malformed: let the replica's 400 handle it
        with self._lock:
            ceiling = self._admission_max_priority
            if prio > ceiling:
                self._shed_by_class[prio] = (
                    self._shed_by_class.get(prio, 0) + 1
                )
        if prio > ceiling:
            self._span("route", t_route, self._clock(), rid,
                       ctx=route_ctx, outcome="shed", shed_class=prio)
            return 429, {
                "error": f"priority class {prio} is shed under overload "
                         f"(admitting classes 0..{ceiling})",
                "shed": True,
                "shed_class": prio,
                "max_priority": ceiling,
                "request_id": rid,
            }
        tried: set[str] = set()
        last_429: tuple[int, dict] | None = None
        last_err: tuple[int, dict] | None = None
        outstanding: dict[int, _ReplicaState] = {}
        results: queue.Queue = queue.Queue()
        launched = 0
        hedged = False

        def _launch(st: _ReplicaState, is_hedge: bool) -> None:
            nonlocal launched
            idx = launched
            launched += 1
            name = st.replica.name
            tried.add(name)
            outstanding[idx] = st
            with self._lock:
                st.router_inflight += 1
            remaining = max(0.05, deadline_at - self._clock())
            fwd = dict(doc)
            # every attempt — first pick, retry, hedge — is its OWN
            # child span of the route span, and the replica parents its
            # queued/prefill/decode spans under this attempt's id: a
            # hedge's two legs stay two branches of one tree
            fwd_ctx = route_ctx.child() if route_ctx is not None else None
            if fwd_ctx is not None:
                fwd["trace_context"] = fwd_ctx.to_wire()
            if timeout_s is not None or doc.get("deadline_s") is not None:
                # propagate the deadline replica-side: the scheduler's
                # expiry machinery stops decoding for a client that has
                # already departed (min with any client deadline_s so
                # the router only ever TIGHTENS it)
                d = remaining
                cd = doc.get("deadline_s")
                if (isinstance(cd, (int, float))
                        and not isinstance(cd, bool) and cd > 0):
                    d = min(d, float(cd))
                fwd["deadline_s"] = round(d, 6)
                post_timeout = remaining + 0.25
            else:
                post_timeout = None

            def _run():
                t0 = self._clock()
                try:
                    try:
                        code, out = self._post(
                            st.replica, "/v1/generate", fwd,
                            timeout=post_timeout,
                        )
                    finally:
                        # finally, not per-path: an exception outside
                        # the routed-around classes must never leak the
                        # in-flight count (it feeds the load key — a
                        # leak penalizes this replica forever)
                        with self._lock:
                            st.router_inflight -= 1
                except (OSError, ValueError, http.client.HTTPException):
                    # ValueError = a non-JSON body (misconfigured URL,
                    # an intermediary's error page); HTTPException = a
                    # connection reset mid-body (IncompleteRead): route
                    # around either — a bad replica must cost the
                    # client a retry, not a dropped connection
                    with self._lock:
                        st.failures += 1
                        st.set(ready=False)
                    self._breaker_note(
                        st, ok=False,
                        latency_s=max(0.0, self._clock() - t0))
                    self._span("forward", t0, self._clock(), rid,
                               ctx=fwd_ctx, replica=name, retry=idx > 0,
                               hedge=is_hedge, outcome="error")
                    results.put((is_hedge, idx, st, None, None, t0))
                    return
                # 503 (dead loop or draining) and 429 (backpressure)
                # are routing signals, not breaker badness; 5xx and
                # slow 200s feed the gray-failure window
                self._breaker_note(
                    st, ok=code < 500 or code == 503,
                    latency_s=max(0.0, self._clock() - t0))
                self._span("forward", t0, self._clock(), rid,
                           ctx=fwd_ctx, replica=name, retry=idx > 0,
                           hedge=is_hedge, code=code,
                           outcome=("ok" if code == 200
                                    else "busy" if code == 429
                                    else "unavailable" if code == 503
                                    else "error"))
                results.put((is_hedge, idx, st, code, out, t0))

            threading.Thread(
                target=_run, daemon=True,
                name="nanodiloco-fleet-forward",
            ).start()

        while True:
            now = self._clock()
            if deadline_at - now <= 0:
                # the client's budget is gone: cancel whatever is still
                # in flight (frees replica slots + KV blocks) and say
                # so honestly — never pin a departed client behind the
                # fleet-wide request timeout
                with self._lock:
                    self._resilience["deadline_expired"] += 1
                for lst in outstanding.values():
                    self._cancel_request(lst.replica, rid)
                self._span("route", t_route, now, rid, ctx=route_ctx,
                           outcome="deadline_expired", attempts=launched)
                return 504, {
                    "error": f"deadline exceeded: timeout_s="
                             f"{round(budget, 3)} elapsed before any "
                             f"replica answered",
                    "request_id": rid,
                    **({"tried": sorted(tried)} if tried else {}),
                }
            if not outstanding:
                if launched >= 2:
                    break  # first attempt + one retry/hedge: exhausted
                st = self._pick_excluding(tried)
                if st is None:
                    self._span("route", t_route, self._clock(), rid,
                               ctx=route_ctx, outcome="no_ready_replica")
                    return 503, {"error": "no ready replica",
                                 "request_id": rid,
                                 **({"tried": sorted(tried)}
                                    if tried else {})}
                if launched > 0 and not self._retry_take("retry"):
                    break  # budget empty: the honest error, no storm
                _launch(st, is_hedge=False)
            hedge_delay = None
            if launched == 1 and len(outstanding) == 1 and not hedged:
                hedge_delay = self._hedge_delay()
            wait_s = (deadline_at - self._clock() if hedge_delay is None
                      else min(deadline_at - self._clock(), hedge_delay))
            try:
                # REAL-time wait on the result queue (the attempt
                # threads are real even under an injected clock); the
                # deadline itself is re-checked on the injected clock
                # at the top of every iteration
                is_hedge, idx, st, code, out, t0 = results.get(
                    timeout=max(0.001, wait_s))
            except queue.Empty:
                if hedge_delay is not None:
                    # the sole attempt has outlived the hedge delay:
                    # launch the second attempt on another ready
                    # replica — first answer wins. Armed once per
                    # request, budget-gated like a retry.
                    hedged = True
                    st2 = self._pick_excluding(tried)
                    if st2 is not None and self._retry_take("hedge"):
                        _launch(st2, is_hedge=True)
                continue
            outstanding.pop(idx, None)
            name = st.replica.name
            if code is None:
                continue  # transport failure (marked in the thread)
            if code == 503:
                # the replica's loop is dead or it is draining: route
                # around it now; the health loop decides ejection
                with self._lock:
                    st.set(ready=False)
                continue
            if code == 429:
                if isinstance(out, dict) and out.get("shed"):
                    # a class-SHED 429 is terminal: the replica refused
                    # this class as policy, and every other replica
                    # enforces the same ceiling — retrying would
                    # pointlessly hammer the fleet with traffic it is
                    # deliberately sacrificing. Propagated verbatim
                    # (shed class and ceiling in the body).
                    with self._lock:
                        sc = out.get("shed_class")
                        sc = sc if isinstance(sc, int) else prio
                        self._shed_by_class[sc] = (
                            self._shed_by_class.get(sc, 0) + 1
                        )
                    for lst in outstanding.values():
                        self._cancel_request(lst.replica, rid)
                    self._span("route", t_route, self._clock(), rid,
                               ctx=route_ctx, outcome="shed", replica=name)
                    return 429, {**out, "replica": name,
                                 "request_id": rid}
                # busy 429: queue full HERE, not fleet-wide — try
                # another replica; if every candidate is saturated, the
                # client gets the honest 429 (backpressure), never a
                # fake 503 — with the join key, so the overload is
                # traceable
                # a non-dict body (an intermediary's error page) is
                # wrapped rather than passed through raw: EVERY router
                # response carries the request_id join key, including
                # the ones that needed diagnosing most
                last_429 = (code, {**out, "replica": name,
                                   "request_id": rid}
                            if isinstance(out, dict)
                            else {"error": out, "replica": name,
                                  "request_id": rid})
                continue
            if code >= 500:
                # any other 5xx (chaos-injected or a replica bug):
                # route around it like a transport failure, but keep
                # the body — if every attempt fails the client gets the
                # replica's own error, not a synthesized 503
                last_err = (code, {**out, "replica": name,
                                   "request_id": rid}
                            if isinstance(out, dict)
                            else {"error": out, "replica": name,
                                  "request_id": rid})
                continue
            # first usable answer wins
            if code == 200:
                with self._lock:
                    self._latencies.append(max(0.0, self._clock() - t0))
                    if is_hedge:
                        self._resilience["hedge_wins"] += 1
                self._retry_deposit()
            for lst in outstanding.values():
                # the hedge loser: cancelled through the replica's
                # ticket-cancel path, freeing its slot and KV blocks
                self._cancel_request(lst.replica, rid)
            if isinstance(out, dict):
                out = {**out, "replica": name, "served_by": name}
                out.setdefault("request_id", rid)
                if route_ctx is not None and route_ctx.sampled:
                    out.setdefault("trace_id", route_ctx.trace_id)
            self._span("route", t_route, self._clock(), rid,
                       ctx=route_ctx, outcome="ok", served_by=name,
                       attempts=launched)
            return code, out
        self._span("route", t_route, self._clock(), rid, ctx=route_ctx,
                   outcome="exhausted", attempts=len(tried))
        if last_429 is not None:
            return last_429
        if last_err is not None:
            # a hedged/retried request that lost on BOTH attempts
            # returns ONE honest error (the last replica body), never
            # two answers and never a silent drop
            return last_err
        return 503, {"error": "no replica could take the request",
                     "request_id": rid, "tried": sorted(tried)}

    def _pick_excluding(self, names: set[str],
                        tier: str | None = None) -> _ReplicaState | None:
        with self._lock:
            cands = [st for st in self._states
                     if st.status == "serving" and st.ready
                     and st.replica.name not in names
                     and self._tier_match(st.stats, tier)]
            if not cands:
                return None

            def key(st: _ReplicaState):
                s = st.stats
                load = ((s.get("queue_depth") or 0)
                        + (s.get("slots_busy") or 0) + st.router_inflight)
                free = s.get("kv_blocks_free")
                # breaker route-around OUTRANKS everything: an open-
                # breaker replica is picked only when no closed (or
                # probe-ready half-open) candidate exists — degraded
                # beats 503. SLO not-preferred orders within each
                # breaker rank; load order within each SLO class.
                return (st.breaker.rank(),
                        st.replica.name in self._slo_not_preferred,
                        load, -(free if free is not None else -1),
                        st.replica.name)

            best = min(cands, key=key)
            if best.breaker.rank() == 1:
                # consume the half-open probe slot: exactly one request
                # tests a recovering replica at a time
                best.breaker._probing = True
            return best

    # -- SLO burn state (obs/slo action hook) --------------------------------

    def handle_slo(self, doc: dict) -> tuple[int, dict]:
        """POST /fleet/slo: ``{"rule", "target", "scope", "firing"}`` —
        the wire form of the SLO monitor's action hook (an external
        ``obs-watch`` process observes the fleet and posts burn
        transitions here)."""
        rule = doc.get("rule")
        if not isinstance(rule, str) or not rule:
            return 400, {"error": "rule must be a non-empty string"}
        firing = doc.get("firing")
        if not isinstance(firing, bool):
            return 400, {"error": f"firing must be a boolean; got {firing!r}"}
        scope = doc.get("scope", "replica")
        if scope not in ("replica", "fleet"):
            return 400, {"error": f"scope must be replica|fleet; got {scope!r}"}
        target = doc.get("target")
        if scope == "replica" and target not in self._by_name:
            return 400, {"error": f"unknown replica {target!r}; "
                                  f"replicas are {self.replica_names()}"}
        self.set_slo_burning(rule, target, firing, scope=scope)
        return 200, {"ok": True, **self.slo_state()}

    def set_slo_burning(self, rule: str, target: str | None, firing: bool,
                        *, scope: str = "replica") -> None:
        """Apply one SLO transition. Replica scope: mark/unmark
        ``target`` not-preferred (route-around). Fleet scope: add/
        remove ``rule`` from the set gating the deploy controller's
        canary. Idempotent — only an actual state change logs a
        ``slo_burn``/``slo_clear`` deploy event."""
        with self._lock:
            if scope == "fleet":
                key = (rule, target or "")
                changed = (key in self._slo_fleet) != firing
                if firing:
                    self._slo_fleet.add(key)
                else:
                    self._slo_fleet.discard(key)
                tgt = target or "fleet"
            else:
                rules = self._slo_not_preferred.setdefault(target, set())
                changed = (rule in rules) != firing
                if firing:
                    rules.add(rule)
                else:
                    rules.discard(rule)
                    if not rules:
                        del self._slo_not_preferred[target]
                tgt = target
        if changed:
            self.log_event("slo_burn" if firing else "slo_clear",
                           rule=rule, target=tgt, scope=scope)

    def slo_burning(self) -> bool:
        """True while any FLEET-scope SLO rule burns — the deploy
        controller's canary gate (replica-scope burns route around,
        they do not block deployment: one slow replica must not freeze
        the train->serve loop)."""
        with self._lock:
            return bool(self._slo_fleet)

    def slo_state(self) -> dict:
        with self._lock:
            return self._slo_state_locked()

    def _slo_state_locked(self) -> dict:
        return {
            "slo_fleet_burning": sorted(
                rule if not target else f"{rule}@{target}"
                for rule, target in self._slo_fleet
            ),
            "slo_not_preferred": {
                name: sorted(rules)
                for name, rules in sorted(
                    self._slo_not_preferred.items()
                )
            },
        }

    # -- drain/refill weight pushes ------------------------------------------

    def handle_push(self, doc: dict) -> tuple[int, dict]:
        ckpt = doc.get("checkpoint_dir")
        if not isinstance(ckpt, str) or not ckpt:
            return 400, {"error": "checkpoint_dir must be a non-empty string"}
        step = doc.get("step")
        if step is not None and (isinstance(step, bool)
                                 or not isinstance(step, int)):
            return 400, {"error": f"step must be an integer; got {step!r}"}
        reps = doc.get("replicas")
        if reps is not None and not (
            isinstance(reps, list) and all(isinstance(r, str) for r in reps)
        ):
            return 400, {"error": "replicas must be a list of names"}
        results = self.push_weights(ckpt, step, replicas=reps)
        ok = bool(results) and all(r.get("ok") for r in results)
        return (200 if ok else 502), {"ok": ok, "results": results}

    def push_weights(self, checkpoint_dir: str, step: int | None = None,
                     *, replicas: list[str] | None = None) -> list[dict]:
        """Drain/refill each target replica ONE AT A TIME (fleet
        capacity never drops by more than one replica): drain -> wait
        (bounded) for in-flight streams to finish -> /admin/swap ->
        resume. Returns one result dict per replica, in push order.
        Serialized under a push lock: the deploy controller's thread
        and an operator's /fleet/push must never interleave drains and
        resumes on the same replica (push 2's resume landing mid-push
        1's drain wait would both corrupt the wait and break the
        one-replica-at-a-time capacity invariant)."""
        with self._push_lock:
            targets = [
                st for st in self._states
                if st.status == "serving"
                and (replicas is None or st.replica.name in replicas)
            ]
            if replicas is not None:
                missing = set(replicas) - {st.replica.name
                                           for st in targets}
                if missing:
                    return [{"replica": n, "ok": False,
                             "error": "not a serving replica"}
                            for n in sorted(missing)]
            return [self._push_one(st, checkpoint_dir, step)
                    for st in targets]

    def _push_one(self, st: _ReplicaState, checkpoint_dir: str,
                  step: int | None) -> dict:
        name = st.replica.name
        self.log_event("drain", replica=name,
                       **({"step": step} if step is not None else {}))
        with self._lock:
            st.set(status="draining", ready=False)
        try:
            self._post(st.replica, "/admin/drain", {}, timeout=30.0)
            # bounded wait for in-flight streams: hygiene for a clean
            # canary window, NOT correctness — the engine's generation
            # machinery lets stragglers finish on the old weights even
            # if the swap lands under them
            t0 = self._clock()
            while self._clock() - t0 < self.drain_timeout_s:
                r = self._probe(st.replica)
                if (r.get("stats") or {}).get("in_flight", 0) == 0:
                    break
                self._sleep(0.05)
            body = {"checkpoint_dir": checkpoint_dir}
            if step is not None:
                body["step"] = step
            code, out = self._post(st.replica, "/admin/swap", body)
            ok = code == 200 and isinstance(out, dict) and out.get("swapped")
            self._post(st.replica, "/admin/resume", {}, timeout=30.0)
            with self._lock:
                if ok:
                    st.stats["deploy_generation"] = out.get(
                        "deploy_generation"
                    )
                # routable again immediately; the next health tick
                # re-reads the replica's own readiness. Guarded: the
                # health loop may have EJECTED this replica while the
                # push was mid-flight (it crashed during the drain
                # wait) — resurrecting it would re-route traffic to a
                # corpse and double-count its eventual re-ejection.
                if st.status == "draining":
                    st.set(status="serving", ready=True)
            if ok:
                self.log_event(
                    "swap", replica=name,
                    deploy_generation=out.get("deploy_generation"),
                    **({"step": step} if step is not None else {}),
                )
                return {"replica": name, "ok": True,
                        "deploy_generation": out.get("deploy_generation")}
            err = out.get("error") if isinstance(out, dict) else str(out)
            self.log_event("swap_failed", replica=name, code=code,
                           error=err,
                           **({"step": step} if step is not None else {}))
            return {"replica": name, "ok": False, "code": code,
                    "error": err}
        except (OSError, ValueError, http.client.HTTPException) as e:
            # ValueError covers JSONDecodeError: a replica answering a
            # plain-text body (an old serve without /admin routes, a
            # proxy error page) must be a failed push, not an exception
            # that silently kills the deploy controller's thread;
            # HTTPException covers a connection reset mid-body
            try:
                # the drain may have SUCCEEDED before the failure: a
                # replica left draining admits nothing forever (queued
                # requests expire at their deadlines) — best-effort
                # resume, because a failed push must cost a retry, not
                # a replica's whole capacity
                self._post(st.replica, "/admin/resume", {}, timeout=30.0)
            except (OSError, ValueError, http.client.HTTPException):
                pass
            with self._lock:
                if st.status == "draining":  # not ejected mid-push
                    st.set(status="serving")
                st.failures += 1
            self.log_event("swap_failed", replica=name, error=str(e),
                           **({"step": step} if step is not None else {}))
            return {"replica": name, "ok": False, "error": str(e)}

    # -- events + observability ----------------------------------------------

    def log_event(self, kind: str, **fields) -> dict:
        """One deploy event: counted for /metrics, appended to the
        deploy JSONL (``{"deploy_event": kind, ...}`` — the record shape
        ``summarize_run`` and ``report faults`` read), mirrored into the
        flight-recorder ring, and printed unless quiet."""
        with self._lock:
            self._counters[kind] = self._counters.get(kind, 0) + 1
        rec = {"deploy_event": kind, "t_unix": round(self._wall(), 3),
               **fields}
        self._append_jsonl(rec)
        try:
            flightrec.record_event("deploy", kind=kind, **{
                k: v for k, v in fields.items() if not isinstance(v, dict)
            })
        except Exception:
            pass
        if not self.quiet:
            print(f"[fleet] {json.dumps(rec)}", flush=True)
        return rec

    def _append_jsonl(self, rec: dict) -> None:
        if not self.events_jsonl:
            return
        try:
            d = os.path.dirname(os.path.abspath(self.events_jsonl))
            os.makedirs(d, exist_ok=True)
            with self._events_lock, open(self.events_jsonl, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # a full disk must not take down routing

    def replica_names(self) -> list[str]:
        return [st.replica.name for st in self._states]

    def url_of(self, name: str) -> str:
        return self._by_name[name].replica.url

    def state_of(self, name: str) -> dict:
        st = self._by_name[name]
        with self._lock:
            return {"name": name, "status": st.status, "ready": st.ready,
                    "failures": st.failures, "stats": dict(st.stats)}

    def fleet_stats(self) -> dict:
        """The fleet snapshot: readiness counts, per-replica deploy
        generations, event counters, and the fleet goodput fraction —
        replica-seconds spent serving-AND-ready over EVERY tracked
        replica-second (what fraction of the fleet's capacity was
        actually available; drains, ejections, scale transitions, and
        dead time all show up as the gap to 1.0). The denominator is
        the sum of all state buckets, live AND departed: for a static
        fleet that equals wall-clock x replicas exactly, and for an
        autoscaled fleet it keeps every second accounted — a replica
        that existed for 10s contributes 10s, not the router's whole
        elapsed time, and a retired replica's life never vanishes."""
        with self._lock:
            for st in self._states:
                st.account()
            elapsed = max(0.0, self._clock() - self._t0)
            n = len(self._states)
            by_state = dict(self._departed_seconds)
            for st in self._states:
                for k, v in st.seconds.items():
                    by_state[k] += v
            total_s = sum(by_state.values())
            ready_s = by_state["serving_ready"]
            out = {
                "replicas_total": n,
                "replicas_ready": sum(
                    1 for st in self._states
                    if st.status == "serving" and st.ready
                ),
                "replicas_serving": sum(
                    1 for st in self._states if st.status == "serving"
                ),
                "replicas_ejected": sum(
                    1 for st in self._states if st.status == "ejected"
                ),
                "replicas_scaling_up": sum(
                    1 for st in self._states
                    if st.status == "scaling_up"
                ),
                "replicas_departed": self._departed_count,
                # serving-and-ready replicas by declared role — the
                # disaggregated tier census (all "both" for a
                # monolithic fleet)
                "replicas_by_tier": {
                    role: sum(
                        1 for st in self._states
                        if st.status == "serving" and st.ready
                        and (st.stats.get("role") or "both") == role
                    )
                    for role in ("prefill", "decode", "both")
                },
                "deploy_generations": {
                    st.replica.name: st.stats.get("deploy_generation")
                    for st in self._states
                },
                # per-replica attributed device-seconds (from the last
                # health probe's body): where the fleet's dispatch
                # budget is going, replica by replica
                "device_seconds_by_replica": {
                    st.replica.name: st.stats["device_seconds_total"]
                    for st in self._states
                    if st.stats.get("device_seconds_total") is not None
                },
                "events": dict(sorted(self._counters.items())),
                "elapsed_s": round(elapsed, 6),
                "replica_ready_s": round(ready_s, 6),
                "replica_seconds": {
                    st.replica.name: {
                        k: round(v, 6) for k, v in st.seconds.items()
                    }
                    for st in self._states
                },
                # the fleet-total partition by state (departed replicas
                # included): every scale-up/scale-down second is an
                # explicit line item here, never dropped
                "seconds_by_state": {
                    k: round(v, 6) for k, v in by_state.items()
                },
                "fleet_goodput_fraction": (
                    round(ready_s / total_s, 6) if total_s > 0 else None
                ),
                # request-level resilience: hedge/retry/deadline
                # counters, the retry-budget level, and the per-replica
                # breaker picture (summarize_run surfaces these from
                # the final fleet_goodput record)
                **{k: v for k, v in self._resilience.items()},
                "retry_budget_tokens": round(self._retry_tokens, 3),
                "breaker_state": {
                    st.replica.name: st.breaker.state
                    for st in self._states if st.status != "ejected"
                },
                "replicas_breaker_open": sum(
                    1 for st in self._states
                    if st.status == "serving"
                    and st.breaker.state != "closed"
                ),
                "admission_max_priority": self._admission_max_priority,
                "shed_by_class": {
                    c: v for c, v in sorted(self._shed_by_class.items())
                },
                **self._slo_state_locked(),
            }
        return out

    def health(self) -> tuple[int, dict]:
        s = self.fleet_stats()
        doc = {
            "healthy": s["replicas_ready"] > 0,
            "replicas_ready": s["replicas_ready"],
            "replicas_total": s["replicas_total"],
        }
        return (200 if doc["healthy"] else 503), doc

    def render_metrics(self) -> str:
        s = self.fleet_stats()
        families: list = [
            ("nanodiloco_fleet_replicas_ready", "gauge",
             "replicas serving AND ready (routing candidates)",
             [(None, s["replicas_ready"])]),
            ("nanodiloco_fleet_replicas_serving", "gauge",
             "replicas not ejected (draining included)",
             [(None, s["replicas_serving"])]),
            ("nanodiloco_fleet_replicas_total", "gauge",
             "replicas this router was configured with",
             [(None, s["replicas_total"])]),
        ]
        gens = [(name, g) for name, g in
                sorted(s["deploy_generations"].items()) if g is not None]
        if gens:
            families.append((
                "nanodiloco_deploy_generation", "gauge",
                "weight generation each replica serves (bumped by every "
                "hot swap)",
                [({"replica": name}, g) for name, g in gens],
            ))
        families.append((
            "nanodiloco_fleet_events", "counter",
            "deploy events by kind (promote/rollback/eject/drain/swap/"
            "canary)",
            [({"event": k}, v) for k, v in sorted(s["events"].items())]
            + [(None, sum(s["events"].values()))],
        ))
        if s["fleet_goodput_fraction"] is not None:
            families.append((
                "nanodiloco_fleet_goodput_fraction", "gauge",
                "replica-seconds serving-and-ready over all tracked "
                "replica-seconds — the fleet's every-second-accounted "
                "availability number",
                [(None, s["fleet_goodput_fraction"])],
            ))
        dev = s.get("device_seconds_by_replica") or {}
        if dev:
            families.append((
                "nanodiloco_fleet_replica_device_seconds", "counter",
                "attributed dispatch seconds per replica (from the "
                "health probe body) — the fleet's device-second budget "
                "split replica by replica",
                [({"replica": name}, v)
                 for name, v in sorted(dev.items())]
                + [(None, round(sum(dev.values()), 6))],
            ))
        families.append((
            "nanodiloco_fleet_state_seconds", "gauge",
            "replica-seconds by state (departed replicas included) — "
            "scale_up/scale_down transition time is an explicit line "
            "item, never dropped",
            [({"state": k}, v)
             for k, v in sorted(s["seconds_by_state"].items())],
        ))
        families.append((
            "nanodiloco_fleet_admission_max_priority", "gauge",
            "highest priority class the fleet currently admits (9 = "
            "all; lower = class-aware overload shedding active)",
            [(None, s["admission_max_priority"])],
        ))
        if s["shed_by_class"]:
            families.append((
                "nanodiloco_fleet_shed", "counter",
                "requests shed by class-aware admission control, by "
                "priority class (terminal 429s, never retried)",
                [({"priority": str(c)}, v)
                 for c, v in sorted(s["shed_by_class"].items())]
                + [(None, sum(s["shed_by_class"].values()))],
            ))
        families.extend([
            ("nanodiloco_router_hedges", "counter",
             "hedged second attempts launched (first answer wins; the "
             "loser is cancelled replica-side)",
             [(None, s["hedges"])]),
            ("nanodiloco_router_hedge_wins", "counter",
             "hedged requests won by the second attempt",
             [(None, s["hedge_wins"])]),
            ("nanodiloco_router_retries", "counter",
             "retry attempts the token-bucket retry budget admitted",
             [(None, s["retries"])]),
            ("nanodiloco_router_retry_budget_exhausted", "counter",
             "retries/hedges refused because the retry budget was "
             "empty (the anti-retry-storm backstop)",
             [(None, s["retry_budget_exhausted"])]),
            ("nanodiloco_router_deadline_expired", "counter",
             "requests answered 504 because the client deadline "
             "elapsed at the router",
             [(None, s["deadline_expired"])]),
            ("nanodiloco_router_breaker_opens", "counter",
             "circuit-breaker trips (closed/half-open -> open)",
             [(None, s["breaker_opens"])]),
            ("nanodiloco_router_retry_budget_tokens", "gauge",
             "retry-budget tokens currently available",
             [(None, s["retry_budget_tokens"])]),
        ])
        if s["breaker_state"]:
            families.append((
                "nanodiloco_router_breaker_state", "gauge",
                "per-replica circuit-breaker state (0 closed, 1 "
                "half-open, 2 open) — route-around, never ejection",
                [({"replica": name}, _BREAKER_STATE_GAUGE.get(v, 2))
                 for name, v in sorted(s["breaker_state"].items())],
            ))
        families.append((
            "nanodiloco_fleet_slo_burning", "gauge",
            "1 while any fleet-scope SLO rule burns (the canary gate)",
            [(None, int(bool(s["slo_fleet_burning"])))],
        ))
        if s["slo_not_preferred"]:
            families.append((
                "nanodiloco_fleet_replica_not_preferred", "gauge",
                "replicas routed around for a burning replica-scope SLO "
                "(still serving — route-around, not ejection)",
                [({"replica": name}, 1)
                 for name in sorted(s["slo_not_preferred"])],
            ))
        tiers = s.get("replicas_by_tier") or {}
        if tiers:
            families.append((
                "nanodiloco_fleet_tier_replicas", "gauge",
                "serving-and-ready replicas by declared disaggregation "
                "role (prefill/decode/both; a monolithic fleet is all "
                "'both')",
                [({"tier": t}, n) for t, n in sorted(tiers.items())],
            ))
        families.extend(self._extra_metric_families(s))
        return render_exposition(families)

    def _extra_metric_families(self, stats: dict) -> list:
        """Subclass hook (fleet/disagg.py): extra metric families
        appended to the router exposition — the DisaggRouter's handoff
        counters and latency histogram land through here."""
        return []
