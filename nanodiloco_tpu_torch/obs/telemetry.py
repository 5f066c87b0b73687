"""Telemetry: a copy of ``nanodiloco_tpu/obs/telemetry.py`` (the JAX
package's ``__init__`` imports jax, so the port keeps its own), with
``torch.profiler`` where the JAX one captures ``jax.profiler``.

- ``TelemetryServer``: the trainer's live endpoint (``--metrics-port``).
  ``GET /metrics`` is OpenMetrics text whose gauges are fed from the
  same ``MetricsLogger.log`` path that writes the JSONL (loss, tokens/s,
  phase seconds, the resilience counters: alarms, injected faults, IO
  retries, resumes, restarts; the drift and elastic gauges, the goodput
  badput seconds, the devtime ledgers); ``GET /healthz`` answers 200/503
  from the watchdog's live ``status_doc``; ``POST /debug/profile``
  captures the live process;
- ``acquire_profiler_window`` / ``release_profiler_window``: the lock a
  planned capture holds so a live one answers 409;
- ``nearest_rank_percentile`` and ``Histogram`` (OpenMetrics cumulative
  buckets with per-bucket exemplars);
- ``render_exposition`` and its label helpers, and ``parse_metrics_text``
  with the exposition scanner of ``nanodiloco_tpu/obs/collector.py`` it
  rests on;
- ``handle_profile_request``: ``POST /debug/profile?seconds=N`` captures
  a ``torch.profiler`` trace (CPU and, on the card, CUDA activity) of the
  live process.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from nanodiloco_tpu_torch.obs.devtime import devtime_families
from nanodiloco_tpu_torch.obs.goodput import CAUSES

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

# JSONL key -> (metric name, help). All gauges: "last observed value".
_GAUGE_KEYS = {
    "loss": ("nanodiloco_loss", "last logged training loss"),
    "eval_loss": ("nanodiloco_eval_loss", "last held-out eval loss"),
    "perplexity": ("nanodiloco_perplexity", "last training perplexity"),
    "lr": ("nanodiloco_lr", "current inner learning rate"),
    "step": ("nanodiloco_step", "last logged real (inner) step"),
    "tokens_per_sec": (
        "nanodiloco_tokens_per_sec", "cumulative training throughput"
    ),
    "comm_share": (
        "nanodiloco_comm_share",
        "outer-sync share of wall clock (the DiLoCo ratio)",
    ),
    "avg_sync_time_s": (
        "nanodiloco_avg_sync_time_seconds", "mean outer-sync wall clock"
    ),
    "wire_bytes_per_sync": (
        "nanodiloco_wire_bytes_per_sync", "per-worker wire bytes per outer sync"
    ),
    "hbm_peak_bytes": (
        "nanodiloco_hbm_peak_bytes", "peak device memory in use"
    ),
    "quarantined_workers": (
        "nanodiloco_quarantined_workers", "workers masked out of the last sync"
    ),
    # elastic DiLoCo (training/elastic.py): the live fleet width and
    # per-worker realized inner steps — the scrapeable view of
    # join/shrink and straggler demotions
    "workers_active": (
        "nanodiloco_workers_active",
        "workers contributing to the last outer sync",
    ),
    # DiLoCo dynamics metrics (parallel/diloco.py::_sync_dynamics):
    # drift, momentum, and update-alignment — the quantities quantized
    # outer comm needs to stay tame (arXiv:2501.18512)
    "drift_max": (
        "nanodiloco_drift_max",
        "max pairwise worker replica distance / snapshot norm at the "
        "last sync",
    ),
    "drift_mean": (
        "nanodiloco_drift_mean",
        "RMS pairwise worker replica distance / snapshot norm at the "
        "last sync",
    ),
    "outer_momentum_norm": (
        "nanodiloco_outer_momentum_norm",
        "outer Nesterov momentum norm after the last sync",
    ),
    "outer_update_cos": (
        "nanodiloco_outer_update_cos",
        "cosine(mean pseudo-gradient, applied outer update descent "
        "direction) at the last sync",
    ),
    # async delayed-apply outer step (parallel/diloco.py async_outer):
    # rounds between the applied merge's launch and its apply — the
    # realized staleness of the overlap (streaming logs its fragment
    # stagger here as a fraction of a round)
    "outer_staleness": (
        "nanodiloco_outer_staleness",
        "rounds the last applied outer merge landed late "
        "(async delayed-apply / streaming stagger)",
    ),
}


# -- histograms (OpenMetrics cumulative-bucket form) --------------------------

# latency buckets in seconds: sub-ms to a minute, the span a serving
# TTFT / queue-wait / decode-tick distribution actually occupies
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def nearest_rank_percentile(sorted_vals, p: float):
    """Standard nearest-rank percentile over an ascending-sorted list:
    the smallest value with at least ``ceil(p*n)`` observations at or
    below it; None on empty input. ONE implementation for every
    window-percentile consumer (the serve scheduler's TTFT gauges,
    ``scripts/serve_bench.py``'s client-side stats) — the biased
    ``int(p*n)`` indexing both used to hand-roll read p50 of two
    samples as the larger one."""
    if not sorted_vals:
        return None
    k = max(0, math.ceil(p * len(sorted_vals)) - 1)
    return sorted_vals[min(len(sorted_vals) - 1, k)]


class Histogram:
    """Fixed-bucket cumulative histogram (the OpenMetrics shape: every
    bucket counts observations <= its upper bound, ``+Inf`` counts all).
    Thread-safe: the serve tick thread observes while HTTP threads
    snapshot. Gauge-window percentiles (a TTFT snapshot) answered
    "what was p95 over the last 512 requests"; a real histogram lets a
    scraper compute rates and quantiles over ANY window, aggregated
    across processes — the difference between a demo metric and one
    Prometheus can actually alert on."""

    def __init__(self, buckets=DEFAULT_TIME_BUCKETS) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("a histogram needs at least one bucket bound")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"duplicate bucket bounds: {buckets}")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = overflow (+Inf only)
        # one exemplar per bucket: (trace_id, observed value) of the
        # LAST sampled observation that landed there — bounded memory
        # (len(bounds)+1 slots), the metrics→trace link per bucket
        self._exemplars: list[tuple[str, float] | None] = (
            [None] * (len(bounds) + 1)
        )
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: str | None = None) -> None:
        """Record one observation. ``exemplar`` (optional) is the trace
        id of the request that produced it — kept one-per-bucket, last
        writer wins, so the exposition can link a latency bucket back
        to a concrete sampled trace. Pass None (the default) for
        unsampled observations: the counts still move, only the link
        is withheld."""
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            if exemplar:
                self._exemplars[i] = (str(exemplar), v)
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """``{"buckets": [(le, cumulative), ..., ("+Inf", count)],
        "count": n, "sum": s}`` — the exposition-ready cumulative form.
        When any exemplar was recorded the dict also carries
        ``"exemplars": {le: (trace_id, value)}`` keyed by the bucket
        each exemplar LANDED in (exemplars are per-bucket, not
        cumulative — OpenMetrics requires an exemplar's value to lie
        inside its bucket's range)."""
        with self._lock:
            counts = list(self._counts)
            exemplars = list(self._exemplars)
            total, s = self._count, self._sum
        cum = 0
        buckets: list[tuple[float | str, int]] = []
        ex: dict[float | str, tuple[str, float]] = {}
        for j, (bound, c) in enumerate(zip(self.bounds, counts)):
            cum += c
            buckets.append((bound, cum))
            if exemplars[j] is not None:
                ex[bound] = exemplars[j]
        buckets.append(("+Inf", total))
        if exemplars[-1] is not None:
            ex["+Inf"] = exemplars[-1]
        snap: dict = {"buckets": buckets, "count": total, "sum": s}
        if ex:
            snap["exemplars"] = ex
        return snap


class TelemetryServer:
    """Scrapeable mirror of the metrics stream. ``observe(rec)`` is
    called by ``MetricsLogger.log`` with every record (metrics AND
    alarms — one source of truth); ``health_fn`` returns the watchdog's
    status document on each /healthz hit (live state, not a cached
    copy). Thread-safe: the HTTP threads read under the same lock the
    train loop writes under."""

    def __init__(
        self,
        port: int = 0,
        host: str = "0.0.0.0",
        health_fn: Callable[[], dict] | None = None,
        profile_dir: str | None = None,
    ) -> None:
        self._health_fn = health_fn
        # on-demand live profiling: POST /debug/profile?seconds=N
        # captures a torch.profiler trace from THIS process into
        # ``profile_dir`` (None = the endpoint answers 404 — profiling
        # must be an operator opt-in, the capture is heavyweight)
        self.profile_dir = profile_dir
        self._lock = threading.Lock()
        self._gauges: dict[str, float] = {}
        self._worker_pg: dict[int, float] = {}  # worker -> last pg norm
        self._worker_h: dict[int, float] = {}   # worker -> realized H
        self._elastic: dict[str, int] = {}      # elastic records by kind
        self._phases: dict[str, float] = {}
        self._badput: dict[str, float] = {}  # cause -> cumulative seconds
        self._alarms: dict[str, int] = {}
        self._faults: dict[str, int] = {}    # injected-fault records by kind
        self._retries: dict[str, int] = {}   # IO retry records by op
        self._devtime: dict | None = None    # last devtime snapshot
        self._resumes = 0                    # checkpoint-resume records
        self._outer_syncs = 0
        self._wire_total = 0.0
        self._thread: threading.Thread | None = None

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # a scrape must not spam stdout
                pass

            def _reply(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server.render_metrics().encode()
                    ctype = OPENMETRICS_CONTENT_TYPE
                    code = 200
                elif path == "/healthz":
                    code, doc = server.health()
                    body = (json.dumps(doc) + "\n").encode()
                    ctype = "application/json"
                else:
                    code, body, ctype = 404, b"not found\n", "text/plain"
                self._reply(code, body, ctype)

            def do_POST(self):
                if self.path.split("?", 1)[0] != "/debug/profile":
                    self._reply(404, b"not found\n", "text/plain")
                    return
                code, doc = handle_profile_request(
                    server.profile_dir, self.path
                )
                self._reply(
                    code, (json.dumps(doc) + "\n").encode(),
                    "application/json",
                )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TelemetryServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="nanodiloco-telemetry",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- ingest (the MetricsLogger.log path) ---------------------------------

    def observe(self, rec: dict[str, Any]) -> None:
        with self._lock:
            for k, v in rec.items():
                if v is None:
                    continue
                if k == "alarm":
                    self._alarms[str(v)] = self._alarms.get(str(v), 0) + 1
                elif k == "fault":
                    self._faults[str(v)] = self._faults.get(str(v), 0) + 1
                elif k == "retry":
                    self._retries[str(v)] = self._retries.get(str(v), 0) + 1
                elif k == "resume":
                    self._resumes += 1
                elif k == "restart_count" and isinstance(v, (int, float)):
                    # supervisor-side restart counter, carried in by the
                    # resume record so a scrape sees restart pressure
                    self._gauges["nanodiloco_restarts"] = float(v)
                elif k == "outer_synced":
                    self._outer_syncs += int(bool(v))
                elif k == "wire_bytes_total":
                    self._wire_total = float(v)
                elif k == "pg_norm" and isinstance(v, (list, tuple)):
                    # per-worker pseudo-gradient norms from the sync's
                    # dynamics record -> one labeled gauge per worker
                    for w, nv in enumerate(v):
                        if isinstance(nv, (int, float)):
                            self._worker_pg[w] = float(nv)
                elif k == "elastic":
                    # elastic DiLoCo decisions by kind (straggler
                    # demote/restore, resize absorbed at resume) — the
                    # demotion total is its own headline counter
                    self._elastic[str(v)] = self._elastic.get(str(v), 0) + 1
                elif k == "inner_steps_realized" and isinstance(
                    v, (list, tuple)
                ):
                    # a resize drops/adds workers: the realized-H gauge
                    # family must track the CURRENT fleet, not keep
                    # ghost series for departed workers
                    self._worker_h = {
                        w: float(nv) for w, nv in enumerate(v)
                        if isinstance(nv, (int, float))
                    }
                elif k == "goodput" and isinstance(v, dict):
                    # goodput ledger snapshot (obs/goodput): the
                    # fraction as a gauge, every badput cause's
                    # cumulative seconds as a labeled counter family —
                    # the scrapeable wall-clock budget
                    gf = v.get("goodput_fraction")
                    if isinstance(gf, (int, float)):
                        self._gauges["nanodiloco_goodput_fraction"] = float(gf)
                    for cause in CAUSES:
                        if cause == "compute":
                            continue
                        s = v.get(f"{cause}_s")
                        if isinstance(s, (int, float)):
                            self._badput[cause] = float(s)
                elif k.startswith("t_") and isinstance(v, (int, float)):
                    self._phases[k[2:]] = float(v)
                elif k == "devtime" and isinstance(v, dict):
                    # DispatchAccountant snapshot (obs/devtime): the
                    # ledgers are cumulative, so keeping the LAST
                    # snapshot renders correct counters
                    self._devtime = v
                elif k == "cost_analysis" and isinstance(v, dict):
                    fpt = v.get("flops_per_token")
                    if isinstance(fpt, (int, float)):
                        self._gauges["nanodiloco_flops_per_token"] = float(fpt)
                elif k in _GAUGE_KEYS and isinstance(v, (int, float)):
                    self._gauges[_GAUGE_KEYS[k][0]] = float(v)

    # -- render --------------------------------------------------------------

    def render_metrics(self) -> str:
        """OpenMetrics text via the shared ``render_exposition`` (the
        serve endpoint, nanodiloco_tpu/serve/server.py, uses the same
        renderer so every /metrics in the project speaks one dialect)."""
        with self._lock:
            gauges = dict(self._gauges)
            worker_pg = dict(self._worker_pg)
            worker_h = dict(self._worker_h)
            elastic = dict(self._elastic)
            phases = dict(self._phases)
            badput = dict(self._badput)
            alarms = dict(self._alarms)
            faults = dict(self._faults)
            retries = dict(self._retries)
            resumes = self._resumes
            syncs = self._outer_syncs
            wire_total = self._wire_total
            devtime = self._devtime
        helps = {name: h for name, h in _GAUGE_KEYS.values()}
        helps["nanodiloco_flops_per_token"] = (
            "analytic FLOPs per token of one training microbatch "
            "(obs/costs probe)"
        )
        helps["nanodiloco_restarts"] = (
            "supervisor restarts preceding this process (from the "
            "resume record)"
        )
        helps["nanodiloco_goodput_fraction"] = (
            "fraction of this lifetime's wall-clock attributed to "
            "compute (obs/goodput ledger)"
        )
        families: list = [
            (name, "gauge", helps.get(name), [(None, gauges[name])])
            for name in sorted(gauges)
        ]
        if worker_pg:
            families.append((
                "nanodiloco_worker_pg_norm", "gauge",
                "per-worker pseudo-gradient norm at the last outer sync",
                [({"worker": str(w)}, worker_pg[w])
                 for w in sorted(worker_pg)],
            ))
        if worker_h:
            families.append((
                "nanodiloco_inner_steps_realized", "gauge",
                "per-worker realized inner steps in the last round "
                "(elastic DiLoCo heterogeneous H)",
                [({"worker": str(w)}, worker_h[w])
                 for w in sorted(worker_h)],
            ))
        if elastic:
            families.append((
                "nanodiloco_straggler_demotions", "counter",
                "straggler-policy demotions observed (elastic records "
                "of kind straggler_demote)",
                [(None, elastic.get("straggler_demote", 0))],
            ))
            families.append((
                "nanodiloco_elastic_events", "counter",
                "elastic DiLoCo records by kind (straggler "
                "demote/restore, resize absorbed at resume, schedule "
                "reset)",
                [({"kind": k}, elastic[k]) for k in sorted(elastic)]
                + [(None, sum(elastic.values()))],
            ))
        if phases:
            families.append((
                "nanodiloco_phase_seconds", "gauge",
                "last round's host-side phase budget",
                [({"phase": ph}, phases[ph]) for ph in sorted(phases)],
            ))
        if badput:
            families.append((
                "nanodiloco_badput_seconds", "counter",
                "this lifetime's wall-clock seconds NOT spent computing, "
                "by attributed cause (obs/goodput ledger)",
                [({"cause": c}, badput[c]) for c in sorted(badput)],
            ))
        # resilience counters: alarms/injected faults by kind, IO retries
        # by op, checkpoint resumes — the scrapeable fault timeline
        for name, help_text, label, by in (
            ("nanodiloco_alarms", "watchdog alarms by kind", "kind", alarms),
            ("nanodiloco_faults", "injected faults fired, by kind", "kind",
             faults),
            ("nanodiloco_retries", "IO retry attempts, by operation", "op",
             retries),
        ):
            families.append((
                name, "counter", help_text,
                [({label: k}, by[k]) for k in sorted(by)]
                + [(None, sum(by.values()))],
            ))
        families.append(("nanodiloco_resumes", "counter",
                         "checkpoint resumes observed by this process",
                         [(None, resumes)]))
        families.append(("nanodiloco_outer_syncs", "counter",
                         "outer syncs completed",
                         [(None, syncs)]))
        families.append((
            "nanodiloco_wire_bytes", "counter",
            "cumulative per-worker outer-sync wire bytes",
            [(None, wire_total)],
        ))
        # per-program device/compile-second ledgers (obs/devtime): the
        # SAME family definition the serve /metrics uses, so the two
        # tiers' expositions cannot drift
        families.extend(devtime_families(devtime))
        return render_exposition(families)

    def health(self) -> tuple[int, dict]:
        """(status code, document). Unhealthy (503) = stalled, crashed,
        or any ``nan_loss`` alarm on record; everything else — spikes,
        throughput dips, a finished run — reports 200 with the detail
        in the body."""
        if self._health_fn is None:
            return 200, {"state": "unknown", "healthy": True}
        try:
            doc = dict(self._health_fn())
        except Exception as e:  # a broken probe is itself unhealthy
            return 503, {"state": "error", "healthy": False, "error": str(e)}
        kinds = doc.get("alarm_kinds") or {}
        unhealthy = (
            doc.get("state") in ("stalled", "crashed")
            or kinds.get("nan_loss", 0) > 0
        )
        doc["healthy"] = not unhealthy
        return (503 if unhealthy else 200), doc



_PROFILE_LOCK = threading.Lock()
_PROFILE_SEQ = [0]
PROFILE_MAX_SECONDS = 60.0


def acquire_profiler_window() -> None:
    """Blocking-acquire the process-global profiler for a planned trace
    window. While held, live ``/debug/profile`` captures answer 409;
    conversely a live capture in flight makes this WAIT (bounded by
    ``PROFILE_MAX_SECONDS``) instead of letting a planned capture start
    a second profiler. Pair every acquire with
    ``release_profiler_window``."""
    _PROFILE_LOCK.acquire()


def release_profiler_window() -> None:
    _PROFILE_LOCK.release()


def capture_live_profile(out_dir: str, seconds: float) -> dict:
    """Capture a ``torch.profiler`` trace of THIS live process for
    ``seconds`` into a fresh subdirectory of ``out_dir`` (a Chrome
    trace, ``trace.json``) and return ``{"trace_dir", "seconds"}``: the
    one time profiling matters is when a RUNNING job misbehaves, and
    restarting it to profile destroys the evidence.

    Raises RuntimeError when a capture is already in progress and
    ValueError on an out-of-range duration.
    The sleep happens on the caller's thread (an HTTP handler thread on
    the serving/telemetry endpoints) — training/serving dispatch is
    NEVER blocked; the profiler collects from the live threads."""
    seconds = float(seconds)
    if not 0.0 < seconds <= PROFILE_MAX_SECONDS:
        raise ValueError(
            f"seconds must be in (0, {PROFILE_MAX_SECONDS:g}]; got {seconds}"
        )
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise RuntimeError("a profile capture is already in progress")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        _PROFILE_SEQ[0] += 1
        trace_dir = os.path.join(out_dir, f"capture-{_PROFILE_SEQ[0]:03d}")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as e:
            # an embedder's own profiler holds the global one: busy, not broken
            raise RuntimeError(f"profiler unavailable: {e}") from e
        try:
            time.sleep(seconds)
        finally:
            prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        return {"trace_dir": trace_dir, "seconds": seconds}
    finally:
        _PROFILE_LOCK.release()


def handle_profile_request(
    profile_dir: str | None, raw_path: str
) -> tuple[int, dict]:
    """Shared POST /debug/profile handler body for the telemetry and
    serving endpoints: parse ``?seconds=N`` (default 2), run the
    capture, map failures to HTTP semantics (404 endpoint disabled,
    400 bad duration, 409 capture already running)."""
    if profile_dir is None:
        return 404, {
            "error": "live profiling is not configured on this server "
                     "(no profile directory)"
        }
    q = parse_qs(urlparse(raw_path).query)
    try:
        seconds = float(q.get("seconds", ["2"])[0])
    except ValueError:
        return 400, {"error": f"bad seconds value: {q['seconds'][0]!r}"}
    try:
        return 200, capture_live_profile(profile_dir, seconds)
    except ValueError as e:
        return 400, {"error": str(e)}
    except RuntimeError as e:
        return 409, {"error": str(e)}
    except Exception as e:  # a broken profiler must not kill the server
        return 500, {"error": f"{type(e).__name__}: {e}"}


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() and abs(v) < 2**53 else repr(v)


def escape_label_value(v: Any) -> str:
    """OpenMetrics label-value escaping: backslash, double-quote, and
    line feed are the three characters the spec's ABNF escapes. A
    CARRIAGE RETURN is escaped too (``\\r``, a dialect extension the
    parser in ``obs/collector`` inverts): the spec simply forbids raw
    CR, and emitting one TEARS the line-oriented exposition for every
    ``splitlines()``-based consumer — a label value fed from operator
    input (an error string off an HTTP response ends ``\\r\\n``) used
    to silently corrupt the scrape into garbage keys. Everything else
    passes through."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\r", "\\r")
    )


def _escape_help(text: str) -> str:
    """HELP-text escaping (backslash and line feed — CR too, same
    torn-line hazard as label values; quotes are legal in help)."""
    return (
        str(text).replace("\\", "\\\\").replace("\n", "\\n")
        .replace("\r", "\\r")
    )


def _render_labels(labels: dict[str, Any]) -> str:
    return ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
    )


def render_exposition(families) -> str:
    """OpenMetrics text from ``(name, type, help, samples)`` families.

    - gauge/counter: ``samples`` is ``[(labels_or_None, value)]`` with
      ``labels`` a dict — values are escaped here (``\\``, ``"`` and
      newline per the spec), so callers never hand-render label strings.
      Counters follow the spec's family-name / ``_total``-sample split.
    - histogram: ``samples`` is a ``Histogram.snapshot()`` dict —
      rendered as the cumulative ``_bucket{le=...}`` series plus
      ``_count`` and ``_sum`` — or a list of
      ``(labels_or_None, snapshot)`` pairs for a labeled histogram
      family (e.g. the serve queue-wait split by ``priority``); each
      pair's labels ride on every ``_bucket``/``_count``/``_sum``
      sample of its series, with ``le`` appended last. A snapshot's
      optional ``"exemplars"`` map (``{le: (trace_id, value)}``)
      renders as OpenMetrics exemplars on the matching ``_bucket``
      lines — ``... # {trace_id="..."} value`` — linking the bucket to
      a sampled trace.

    Every family gets ``# HELP`` and ``# TYPE`` metadata (HELP text
    escaped); ``# EOF`` terminates the exposition (a truncated scrape
    must be detectable as truncated). Shared by the training telemetry
    endpoint above and the serving endpoint
    (nanodiloco_tpu/serve/server.py) — one dialect everywhere."""
    lines: list[str] = []
    for name, mtype, help_text, samples in families:
        lines.append(f"# HELP {name} {_escape_help(help_text or name)}")
        lines.append(f"# TYPE {name} {mtype}")
        if mtype == "histogram":
            series = [(None, samples)] if isinstance(samples, dict) else samples
            for labels, snap in series:
                base = _render_labels(labels) + "," if labels else ""
                suffix = f"{{{_render_labels(labels)}}}" if labels else ""
                exemplars = snap.get("exemplars") or {}
                for le, cum in snap["buckets"]:
                    le_s = le if isinstance(le, str) else _fmt(float(le))
                    line = f'{name}_bucket{{{base}le="{le_s}"}} {int(cum)}'
                    ex = exemplars.get(le)
                    if ex is not None:
                        # OpenMetrics exemplar: " # {labels} value" —
                        # the trace id of a sampled observation that
                        # landed in THIS bucket (value inside its range)
                        tid, ev = ex
                        line += (
                            f' # {{trace_id="{escape_label_value(tid)}"}}'
                            f" {_fmt(float(ev))}"
                        )
                    lines.append(line)
                lines.append(f"{name}_count{suffix} {int(snap['count'])}")
                lines.append(f"{name}_sum{suffix} {_fmt(float(snap['sum']))}")
            continue
        sample_name = name + "_total" if mtype == "counter" else name
        for labels, value in samples:
            if labels:
                lines.append(
                    f"{sample_name}{{{_render_labels(labels)}}} {_fmt(value)}"
                )
            else:
                lines.append(f"{sample_name} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# -- the exposition scanner (nanodiloco_tpu/obs/collector.py) --------------


def _unescape_label_value(s: str) -> str:
    """Invert ``escape_label_value`` in ONE pass. Sequential
    ``.replace`` calls are wrong here: a literal backslash followed by
    the letter n escapes to ``\\\\n`` (three backslash-ish chars), and
    replacing ``\\n`` first would turn the tail of it into a newline."""
    out: list[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            elif nxt == "r":
                # the renderer's CR extension (escape_label_value): a
                # raw CR would tear the line-oriented format, so it
                # travels escaped and is restored here
                out.append("\r")
            else:  # unknown escape: keep verbatim (tolerant)
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(s: str) -> tuple[dict[str, str], str]:
    """Parse ``{k="v",...}`` at the head of ``s`` with a real scanner
    (escaped quotes and backslashes inside values; a naive split on
    ``","``/``"="`` corrupts both). Returns ``(labels, rest)`` where
    ``rest`` is everything after the closing brace."""
    assert s[0] == "{"
    labels: dict[str, str] = {}
    i = 1
    while i < len(s) and s[i] != "}":
        j = s.index("=", i)
        name = s[i:j].strip().lstrip(",").strip()
        i = j + 1
        if i >= len(s) or s[i] != '"':
            raise ValueError(f"label {name!r} value is not quoted")
        i += 1
        raw: list[str] = []
        while i < len(s):
            if s[i] == "\\" and i + 1 < len(s):
                raw.append(s[i:i + 2])
                i += 2
                continue
            if s[i] == '"':
                break
            raw.append(s[i])
            i += 1
        if i >= len(s):
            raise ValueError("unterminated label value")
        labels[name] = _unescape_label_value("".join(raw))
        i += 1  # past the closing quote
        if i < len(s) and s[i] == ",":
            i += 1
    if i >= len(s):
        raise ValueError("unterminated label set")
    return labels, s[i + 1:]


def _split_exemplar(rest: str) -> tuple[str, tuple[dict, float] | None]:
    """Split an OpenMetrics exemplar suffix (`` # {labels} value``) off
    the text FOLLOWING a sample's label set (safe: label values were
    already consumed, so a ``#`` here cannot be inside a quoted
    string). Returns ``(value_text, exemplar_or_None)`` with exemplar
    as ``(labels, value)``. A malformed suffix is kept in the value
    text untouched — tolerance belongs to the caller's float()."""
    cut = rest.find(" # ")
    if cut < 0:
        return rest, None
    head, tail = rest[:cut], rest[cut + 3:].strip()
    if not tail.startswith("{"):
        return rest, None
    try:
        ex_labels, ex_rest = _parse_labels(tail)
        parts = ex_rest.strip().split()
        if not parts:
            return rest, None
        return head, (ex_labels, float(parts[0]))
    except (ValueError, IndexError):
        return rest, None


def parse_sample_line_ex(
    line: str,
) -> tuple[str, dict[str, str] | None, float, tuple[dict, float] | None]:
    """One exposition sample line -> ``(sample_name, labels, value,
    exemplar)`` where ``exemplar`` is ``(labels, value)`` from an
    OpenMetrics `` # {...} v`` suffix, or None. Raises ValueError on
    anything that is not a sample (comments, blanks, junk) — callers
    decide how tolerant to be."""
    line = line.strip()
    if not line or line.startswith("#"):
        raise ValueError("not a sample line")
    brace = line.find("{")
    if brace >= 0:
        name = line[:brace]
        labels, rest = _parse_labels(line[brace:])
        rest, ex = _split_exemplar(rest)
        parts = rest.strip().split()
        if not parts:  # truncated line: ValueError, never IndexError —
            # scrape_once's per-target isolation catches ValueError
            raise ValueError(f"no value on sample line: {line!r}")
        return name, labels, float(parts[0]), ex
    parts = line.split()
    if len(parts) < 2:
        raise ValueError(f"no value on sample line: {line!r}")
    return parts[0], None, float(parts[1]), None


def parse_sample_line(line: str) -> tuple[str, dict[str, str] | None, float]:
    """One exposition sample line -> ``(sample_name, labels, value)``,
    exemplar-tolerant (an OpenMetrics `` # {...} v`` suffix is parsed
    and dropped). Raises ValueError on non-sample lines."""
    name, labels, value, _ex = parse_sample_line_ex(line)
    return name, labels, value


def sample_key(name: str, labels: dict[str, str] | None) -> str:
    """The canonical flat key for one sample — EXACTLY the text
    ``render_exposition`` emits for it (label order preserved, values
    escaped), so keys survive a parse->flatten->compare round trip."""
    if labels:
        return f"{name}{{{_render_labels(labels)}}}"
    return name


def parse_metrics_text(text: str) -> dict[str, float]:
    """Parse an OpenMetrics exposition into ``{sample_name: value}``
    with the label set in the key in CANONICAL rendered form (e.g.
    ``nanodiloco_alarms_total{kind="nan_loss"}``). The consumer half of
    the scrape loop (tests, chip_agenda's telemetry phase) — tolerant
    of unknown lines. Built on the structured scanner in
    ``obs/collector``: the old ``rpartition(" ")`` shortcut silently
    mis-keyed any sample whose label VALUE carried an escaped newline
    (the rendered ``\\n`` splits the line in ``splitlines``-based
    consumers) and could not tell an escaped quote from the value
    delimiter — the renderer escapes correctly, so the parser must
    unescape correctly or the dialect does not round-trip."""
    out: dict[str, float] = {}
    for line in text.split("\n"):
        try:
            name, labels, value = parse_sample_line(line)
        except (ValueError, IndexError):
            continue
        out[sample_key(name, labels)] = value
    return out
