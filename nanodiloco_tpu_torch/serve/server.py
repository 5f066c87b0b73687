"""Stdlib HTTP serving daemon over the scheduler + engine.

A copy of ``nanodiloco_tpu/serve/server.py``, its imports pointed at the
port. An endpoint that reaches an engine call the port lacks
(``/admin/swap``, ``/admin/kv/export``, ``/admin/kv/import``) answers
501 with the engine's message, which names the missing piece.

Same pattern and lifecycle as the training telemetry endpoint
(``obs/telemetry.py``): ``http.server`` on daemon threads, no new
dependencies, ``port=0`` picks a free port exposed as ``.port``. The
server owns the scheduler's tick loop on one dedicated thread; HTTP
handler threads only ``submit`` and wait on their ticket, so the
engine is single-threaded by construction.

Endpoints:
- ``POST /v1/generate`` — JSON in: ``{"prompt": str}`` or
  ``{"token_ids": [int]}`` plus optional ``max_new_tokens``,
  ``temperature``, ``top_k``, ``top_p``, ``seed``, ``stop`` (bool:
  finish at the tokenizer's EOS, default true), ``stop_token`` (int
  override), ``deadline_s``, ``priority`` (SLO class 0-9, 0 = most
  urgent, default 1 — admission is EDF within a class), and
  ``prefix_cache`` (bool, default true: opt this request out of
  shared-prefix KV reuse). JSON out: generated ``text`` (when a
  tokenizer is configured) + ``token_ids`` (truncated at the stop
  token, like the ``generate`` CLI) + ``finish_reason`` + ``timing``
  (queued/TTFT/decode seconds). 400 on a malformed request, 429 when
  the admission queue is full (backpressure — the client retries
  later), 503 once the engine loop has died.
- ``GET /healthz`` — LIVENESS: 200 while the tick loop is alive, 503
  after it died; body carries queue depth, slot occupancy, the KV
  block-pool free count, and the deploy generation (the fleet router's
  routing inputs). ``?ready=1`` answers the READINESS contract instead.
- ``GET /readyz`` — READINESS: 200 only when the loop is alive AND the
  scheduler is not draining. A replica draining for a weight push is
  alive-but-not-ready — the router must route around it, not eject it
  as dead (liveness and readiness are different questions, and
  conflating them turns every deploy into a false crash).
- ``POST /v1/cancel`` — ``{"request_id": str}``: cancel that in-flight
  stream through the scheduler's ticket-cancel path (slot and paged KV
  blocks free at the next tick). The fleet router's hedge-loser and
  deadline-expiry cleanup; 404 when nothing by that id is in flight.
- ``POST /admin/drain`` / ``POST /admin/resume`` — stop/resume
  admission (in-flight streams always finish); the fleet router brackets
  a weight push with these.
- ``POST /admin/swap`` — ``{"checkpoint_dir": str, "step": int?}``:
  load that checkpoint's merged snapshot (the ``restore_raw``
  self-describing path) and hot-swap it into the engine between ticks
  (``swap_weights``) — the KV pool survives, in-flight streams finish
  on the old weights, the prefix cache is invalidated. 404 unless the
  server was built with a ``swap_loader`` (the serve CLI wires one; a
  bare embedded server is not remotely re-weightable by default).
- ``GET /metrics`` — OpenMetrics serve gauges (queue depth, slot
  occupancy, TTFT last/p50/p95, decode tokens/s), counters (requests
  by outcome, tokens), and real histograms (cumulative buckets +
  ``_count``/``_sum`` for TTFT, queue wait, per-tick decode latency),
  rendered by the same ``render_exposition`` the training telemetry
  endpoint uses.
- ``POST /debug/profile?seconds=N`` — capture a ``torch.profiler`` trace
  of the live serving process (``profile_dir`` opt-in; 404 without it,
  409 while a capture runs) — the on-demand twin of the training
  telemetry endpoint's.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from nanodiloco_tpu_torch.obs.devtime import devtime_families
from nanodiloco_tpu_torch.obs.telemetry import (
    OPENMETRICS_CONTENT_TYPE,
    handle_profile_request,
    render_exposition,
)
from nanodiloco_tpu_torch.obs.tracer import TraceContext
from nanodiloco_tpu_torch.serve import kvship
from nanodiloco_tpu_torch.serve.scheduler import (
    ClassShed,
    GenRequest,
    QueueFull,
    Scheduler,
)


class ServeServer:
    """HTTP front end + tick-loop owner. ``tokenizer`` is optional: with
    one, ``prompt`` strings are accepted and ``text`` is returned, and
    its EOS id is the default stop token; without, clients send
    ``token_ids``."""

    def __init__(
        self,
        scheduler: Scheduler,
        tokenizer=None,
        *,
        port: int = 0,
        host: str = "0.0.0.0",
        default_max_new_tokens: int = 64,
        max_new_tokens_cap: int = 256,
        request_timeout_s: float = 600.0,
        default_deadline_s: float | None = None,
        idle_sleep_s: float = 0.002,
        profile_dir: str | None = None,
        swap_loader=None,
        swap_timeout_s: float = 120.0,
        tick_delay_s: float = 0.0,
        role: str = "both",
    ) -> None:
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode', or 'both'; got {role!r}"
            )
        self._scheduler = scheduler
        self._tokenizer = tokenizer
        # disaggregated-serving tier (fleet/disagg.py): declared in the
        # health body so the router can route admissions to the prefill
        # tier and handoffs to the decode tier. "both" (the default) is
        # a monolithic replica — eligible for either.
        self.role = role
        # POST /debug/profile?seconds=N target directory (None = the
        # endpoint answers 404; live profiling is an operator opt-in)
        self.profile_dir = profile_dir
        # POST /admin/swap loader: (checkpoint_dir, step|None) -> params
        # matching the engine's serving config (raise ValueError when it
        # does not — the handler's 400). None = the endpoint answers 404.
        self._swap_loader = swap_loader
        self._swap_timeout_s = float(swap_timeout_s)
        self._default_new = int(default_max_new_tokens)
        self._cap_new = int(max_new_tokens_cap)
        self._timeout_s = float(request_timeout_s)
        self._default_deadline_s = default_deadline_s
        self._idle_sleep_s = float(idle_sleep_s)
        # straggler INJECTION (serve --inject-tick-delay-s): sleep this
        # long before every scheduling tick, inflating TTFT and decode
        # latency without touching correctness — the serve-side twin of
        # the trainer's stall fault (resilience/faults), used by the
        # SLO drill (chip_agenda slo_watch) to make one replica burn
        # its latency budget while staying alive and routable
        self._tick_delay_s = float(tick_delay_s)
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None
        self._http_thread: threading.Thread | None = None
        self._loop_error: str | None = None
        # in-flight tickets by request_id, for POST /v1/cancel (the
        # fleet router's hedge-loser / departed-client path): cancel
        # rides the scheduler's existing ticket-cancel machinery, so a
        # cancelled stream frees its slot and paged KV blocks instead
        # of decoding tokens nobody will read
        self._inflight: dict[str, object] = {}
        self._inflight_lock = threading.Lock()

        server = self

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
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    self._reply(200, server.render_metrics().encode(),
                                OPENMETRICS_CONTENT_TYPE)
                elif path == "/readyz" or (
                    # parsed, not substring-matched: a stray query
                    # whose TEXT contains "ready=1" (?thready=1) must
                    # not silently flip a liveness probe to readiness
                    path == "/healthz"
                    and "1" in parse_qs(query).get("ready", [])
                ):
                    code, doc = server.readiness()
                    self._reply_json(code, doc)
                elif path == "/healthz":
                    code, doc = server.health()
                    self._reply_json(code, doc)
                else:
                    self._reply(404, b"not found\n", "text/plain")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path == "/debug/profile":
                    code, out = handle_profile_request(
                        server.profile_dir, self.path
                    )
                    self._reply_json(code, out)
                    return
                if path in ("/admin/drain", "/admin/resume", "/admin/swap",
                            "/admin/admission", "/admin/kv/export",
                            "/admin/kv/import"):
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        doc = json.loads(self.rfile.read(n) or b"{}")
                        if not isinstance(doc, dict):
                            raise ValueError("body must be a JSON object")
                    except ValueError as e:
                        self._reply_json(400, {"error": f"bad JSON: {e}"})
                        return
                    code, out = server.handle_admin(path, doc)
                    self._reply_json(code, out)
                    return
                if path not in ("/v1/generate", "/v1/cancel"):
                    self._reply(404, b"not found\n", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(doc, dict):
                        raise ValueError("request body must be a JSON object")
                except ValueError as e:
                    self._reply_json(400, {"error": f"bad JSON: {e}"})
                    return
                if path == "/v1/cancel":
                    code, out = server.handle_cancel(doc)
                else:
                    code, out = server.handle_generate(doc)
                self._reply_json(code, out)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeServer":
        # engine loop FIRST: the socket already accepts connections from
        # __init__, and a request handled before the loop thread exists
        # would get a spurious 503 from loop_alive()
        if self._loop_thread is None:
            self._loop_thread = threading.Thread(
                target=self._loop, name="nanodiloco-serve-engine", daemon=True,
            )
            self._loop_thread.start()
        if self._http_thread is None:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="nanodiloco-serve-http", daemon=True,
            )
            self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
            self._loop_thread = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
            self._http_thread = None

    def _loop(self) -> None:
        """The engine's single tick thread: tick until stopped; idle
        politely when no slot is live and the queue is empty."""
        while not self._stop.is_set():
            if self._tick_delay_s > 0:
                time.sleep(self._tick_delay_s)
            try:
                live = self._scheduler.tick()
            except Exception as e:
                # a dead loop must flip /healthz to 503, not vanish —
                # and its black box must land on disk: the engine
                # thread's death is exactly the event no clean-exit
                # exporter will ever see (obs/flightrec)
                self._loop_error = f"{type(e).__name__}: {e}"
                try:
                    from nanodiloco_tpu_torch.obs import flightrec

                    flightrec.record_event(
                        "serve_loop_death", error=self._loop_error
                    )
                    flightrec.dump_current(
                        f"serve_loop:{type(e).__name__}"
                    )
                except Exception:
                    pass
                return
            if live == 0 and (
                self._scheduler.queue_depth() == 0
                or getattr(self._scheduler, "draining", False)
            ):
                # a draining scheduler admits nothing: spinning on a
                # non-empty queue would be a busy loop going nowhere
                time.sleep(self._idle_sleep_s)

    def loop_alive(self) -> bool:
        t = self._loop_thread
        return t is not None and t.is_alive() and self._loop_error is None

    # -- request handling ----------------------------------------------------

    def handle_generate(self, doc: dict) -> tuple[int, dict]:
        if not self.loop_alive():
            return 503, {"error": "engine loop is not running",
                         "detail": self._loop_error}
        try:
            request = self._parse_request(doc)
        except (ValueError, TypeError) as e:  # TypeError: e.g. int(None)
            return 400, {"error": str(e)}
        try:
            ticket = self._scheduler.submit(request)
        except ClassShed as e:
            # overload SHED, not backpressure: the body says so
            # explicitly ("shed": true + the sacrificed class) because
            # the two 429s demand opposite client behavior — a busy 429
            # is retried on another replica by the fleet router, a shed
            # 429 is fleet policy and terminal
            return 429, {
                "error": str(e),
                "shed": True,
                "shed_class": e.shed_class,
                "max_priority": e.max_priority,
            }
        except QueueFull as e:
            return 429, {"error": str(e)}
        return self._await_ticket(request, ticket)

    def _await_ticket(self, request: GenRequest,
                      ticket) -> tuple[int, dict]:
        """Wait a submitted ticket out and format the HTTP answer — the
        shared tail of /v1/generate and /admin/kv/import (an imported
        stream is an in-flight request like any other: cancellable by
        id, deadline-bounded, same result shape)."""
        # register for /v1/cancel under the SAME id the scheduler will
        # echo (client-supplied, or the scheduler's req-<rid> fallback);
        # a duplicate id overwrites — cancel then targets the newest
        rid_key = request.request_id or f"req-{ticket.rid}"
        with self._inflight_lock:
            self._inflight[rid_key] = ticket
        try:
            deadline = request.deadline_s
            timeout = self._timeout_s if deadline is None else deadline + 5.0
            result = ticket.wait(timeout)
        finally:
            with self._inflight_lock:
                if self._inflight.get(rid_key) is ticket:
                    del self._inflight[rid_key]
        if result is None:
            # nobody is left to read the stream: cancel so the scheduler
            # frees the slot instead of decoding to completion
            ticket.cancel()
            return 504, {"error": f"request timed out after {timeout:.0f}s"}
        if result["finish_reason"] == "error":
            # client mistakes were already rejected with 400 at parse
            # time (backend.validate); a prefill failure here is a
            # server-side fault (OOM, corrupt params) — 5xx, retryable
            return 500, {"error": result.get("error", "engine prefill failed")}
        tokens = result["tokens"]
        if request.stop_token is not None and request.stop_token in tokens:
            tokens = tokens[: tokens.index(request.stop_token)]
        out = {
            "id": result["rid"],
            # the join key across client logs, serve trace spans, and
            # the latency histograms: client-supplied or scheduler-
            # assigned, always echoed
            "request_id": result["request_id"],
            "finish_reason": result["finish_reason"],
            "token_ids": tokens,
            "prompt_tokens": len(request.prompt),
            "completion_tokens": len(tokens),
            "timing": {
                "queued_s": result["queued_s"],
                "ttft_s": result["ttft_s"],
                "decode_s": result["decode_s"],
                "total_s": result["total_s"],
                # attribution: this request's apportioned share of
                # dispatch seconds and its KV residency bill — the
                # per-request cost line, summable against the engine's
                # per-program device-second counters
                "prefill_device_s": result.get("prefill_device_s", 0.0),
                "decode_device_s": result.get("decode_device_s", 0.0),
                "kv_block_seconds": result.get("kv_block_seconds", 0.0),
            },
        }
        if self._tokenizer is not None:
            out["text"] = self._tokenizer.decode([int(t) for t in tokens])
        # echo the causal trace id for sampled requests — the client
        # (or router) needs it to find this request's spans; unsampled
        # and malformed contexts stay silent, same as the span path
        if request.trace_context:
            wire = TraceContext.from_wire(request.trace_context)
            if wire is not None and wire.sampled:
                out["trace_id"] = wire.trace_id
        return 200, out

    def handle_cancel(self, doc: dict) -> tuple[int, dict]:
        """POST /v1/cancel: ``{"request_id": str}`` — cancel an
        in-flight stream by its join key. The fleet router's hedge
        loser and deadline-expired paths land here; the scheduler's
        ticket-cancel machinery frees the slot and paged KV blocks at
        the next tick. 404 (``cancelled: false``) when nothing by that
        id is in flight — already finished, or never arrived."""
        rid = doc.get("request_id")
        if not isinstance(rid, str) or not rid:
            return 400, {"error": "request_id must be a non-empty string"}
        with self._inflight_lock:
            ticket = self._inflight.get(rid)
        if ticket is None:
            return 404, {"cancelled": False, "request_id": rid}
        ticket.cancel()
        return 200, {"cancelled": True, "request_id": rid}

    def _parse_request(self, doc: dict) -> GenRequest:
        if "token_ids" in doc:
            ids = doc["token_ids"]
            if (not isinstance(ids, list) or not ids
                    or not all(isinstance(t, int) for t in ids)):
                raise ValueError("token_ids must be a non-empty list of ints")
        elif "prompt" in doc:
            if self._tokenizer is None:
                raise ValueError(
                    "this server has no tokenizer; send token_ids"
                )
            if not isinstance(doc["prompt"], str) or not doc["prompt"]:
                raise ValueError("prompt must be a non-empty string")
            ids = self._tokenizer.encode(doc["prompt"])
            if not ids:
                raise ValueError("prompt is empty after tokenization")
        else:
            raise ValueError("request needs 'prompt' or 'token_ids'")
        max_new = int(doc.get("max_new_tokens", self._default_new))
        if not 1 <= max_new <= self._cap_new:
            raise ValueError(
                f"max_new_tokens must be in [1, {self._cap_new}]; got {max_new}"
            )
        temperature = float(doc.get("temperature", 0.0))
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0; got {temperature}")
        top_k = int(doc.get("top_k", 0))
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0; got {top_k}")
        top_p = float(doc.get("top_p", 1.0))
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
        stop_token = doc.get("stop_token")
        if stop_token is None and doc.get("stop", True):
            stop_token = getattr(self._tokenizer, "eos_id", None)
        request_id = doc.get("request_id")
        if request_id is not None:
            if not isinstance(request_id, str) or not request_id:
                raise ValueError("request_id must be a non-empty string")
            if len(request_id) > 128:
                raise ValueError(
                    f"request_id is too long ({len(request_id)} chars; "
                    "max 128)"
                )
        priority = doc.get("priority", 1)
        if not isinstance(priority, int) or isinstance(priority, bool) \
                or not 0 <= priority <= 9:
            raise ValueError(
                f"priority must be an integer in [0, 9] (0 = most "
                f"urgent); got {priority!r}"
            )
        prefix_cache = doc.get("prefix_cache", True)
        if not isinstance(prefix_cache, bool):
            raise ValueError(
                f"prefix_cache must be a boolean; got {prefix_cache!r}"
            )
        speculate = doc.get("speculate", True)
        if not isinstance(speculate, bool):
            raise ValueError(
                f"speculate must be a boolean; got {speculate!r}"
            )
        prefill_only = doc.get("prefill_only", False)
        if not isinstance(prefill_only, bool):
            raise ValueError(
                f"prefill_only must be a boolean; got {prefill_only!r}"
            )
        trace_context = doc.get("trace_context")
        if trace_context is not None and (
                not isinstance(trace_context, str) or not trace_context):
            raise ValueError(
                "trace_context must be a non-empty string"
            )
        deadline = doc.get("deadline_s", self._default_deadline_s)
        # reject impossible shapes at submit time (400), not in the loop
        backend = self._scheduler.backend
        if hasattr(backend, "validate"):
            backend.validate(ids, max_new)
        return GenRequest(
            prompt=tuple(int(t) for t in ids),
            max_new_tokens=max_new,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            seed=int(doc.get("seed", 0)),
            stop_token=None if stop_token is None else int(stop_token),
            deadline_s=None if deadline is None else float(deadline),
            request_id=request_id,
            priority=priority,
            prefix_cache=prefix_cache,
            speculate=speculate,
            prefill_only=prefill_only,
            trace_context=trace_context,
        )

    def _request_spec(self, req: GenRequest, request_id: str) -> dict:
        """A GenRequest back in wire form — the ``request`` field of a
        shipped KV payload, so the importing replica rebuilds the EXACT
        sampling state through its own ``_parse_request`` validation.
        ``prefill_only`` deliberately does not travel: the import side
        resumes DECODE. ``deadline_s`` ships as the original relative
        budget — the decode replica restarts the window at import."""
        spec = {
            "token_ids": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "top_p": float(req.top_p),
            "seed": int(req.seed),
            "request_id": request_id,
            "priority": int(req.priority),
            "prefix_cache": bool(req.prefix_cache),
            "speculate": bool(req.speculate),
        }
        if req.stop_token is not None:
            spec["stop_token"] = int(req.stop_token)
        else:
            # an explicit no-stop must survive the trip: without this,
            # the importer's default would re-attach its tokenizer EOS
            spec["stop"] = False
        if req.deadline_s is not None:
            spec["deadline_s"] = float(req.deadline_s)
        return spec

    # -- fleet control plane -------------------------------------------------

    def handle_admin(self, path: str, doc: dict) -> tuple[int, dict]:
        """The drain/resume/swap endpoints the fleet router drives
        (fleet/router.py) — a replica's side of a weight push."""
        sched = self._scheduler
        if path == "/admin/drain":
            sched.drain()
            return 200, {"draining": True, "in_flight": sched.in_flight()}
        if path == "/admin/resume":
            sched.resume()
            return 200, {"draining": False}
        if path == "/admin/admission":
            # class-aware shedding ceiling (fleet router / autoscaler):
            # {"max_priority": N} — classes above N are refused with the
            # shed 429 until raised again
            mp = doc.get("max_priority")
            try:
                return 200, {
                    "max_priority": sched.set_admission_max_priority(mp)
                }
            except (ValueError, AttributeError) as e:
                return 400, {"error": str(e)}
        missing = self._not_ported({
            "/admin/kv/export": "export_kv",
            "/admin/kv/import": "import_kv",
            "/admin/swap": "swap_weights",
        }.get(path))
        if missing is not None:
            return 501, {"error": missing}
        if path == "/admin/kv/export":
            return self._handle_kv_export(doc)
        if path == "/admin/kv/import":
            return self._handle_kv_import(doc)
        # /admin/swap
        if self._swap_loader is None:
            return 404, {
                "error": "this server has no swap loader (the serve CLI "
                         "configures one; embedded servers pass "
                         "swap_loader=)"
            }
        backend = sched.backend
        if not hasattr(backend, "swap_weights"):
            return 404, {"error": "backend does not support weight swaps"}
        if not self.loop_alive():
            return 503, {"error": "engine loop is not running",
                         "detail": self._loop_error}
        ckpt = doc.get("checkpoint_dir")
        step = doc.get("step")
        if not isinstance(ckpt, str) or not ckpt:
            return 400, {"error": "checkpoint_dir must be a non-empty string"}
        if step is not None and (isinstance(step, bool)
                                 or not isinstance(step, int)):
            return 400, {"error": f"step must be an integer; got {step!r}"}
        try:
            # the LOAD runs on this HTTP thread (disk + host work); only
            # the swap itself crosses to the tick thread
            params = self._swap_loader(ckpt, step)
        except (ValueError, FileNotFoundError, KeyError, SystemExit) as e:
            return 400, {"error": f"cannot load checkpoint: {e}"}
        handle = sched.call_on_tick(lambda: backend.swap_weights(params))
        if not handle.wait(self._swap_timeout_s):
            return 504, {"error": "swap did not run within "
                                  f"{self._swap_timeout_s:.0f}s (tick "
                                  "loop wedged?)"}
        if handle.error:
            # swap_weights validates loudly (tree/shape mismatch) — the
            # checkpoint is the problem, not the server
            return 400, {"error": handle.error}
        return 200, {
            "swapped": True,
            "deploy_generation": handle.result,
            "checkpoint_dir": ckpt,
            **({"step": step} if step is not None else {}),
        }

    def _not_ported(self, call: str | None) -> str | None:
        """The engine's message for an engine call the port lacks, or
        None (the backend offers it, or names no unported calls)."""
        if call is None:
            return None
        return getattr(self._scheduler.backend, "not_ported", {}).get(call)

    # -- KV shipping (disaggregated serving; fleet/disagg.py) ----------------

    def _handle_kv_export(self, doc: dict) -> tuple[int, dict]:
        """POST /admin/kv/export: ``{"request_id": str}`` — ship a
        PARKED prefilled stream's KV rows + resume cursor out and free
        its slot. 404 when nothing by that id is parked (expired past
        the park TTL, already exported, or never prefilled here)."""
        rid = doc.get("request_id")
        if not isinstance(rid, str) or not rid:
            return 400, {"error": "request_id must be a non-empty string"}
        if not self.loop_alive():
            return 503, {"error": "engine loop is not running",
                         "detail": self._loop_error}
        sched = self._scheduler
        # the router's export-leg trace context rides the export doc so
        # the scheduler's kv_export span joins the causal tree
        tctx = doc.get("trace_context")
        tctx = tctx if isinstance(tctx, str) and tctx else None
        handle = sched.call_on_tick(
            lambda: sched.export_parked(rid, trace_context=tctx)
        )
        if not handle.wait(self._swap_timeout_s):
            return 504, {"error": "export did not run within "
                                  f"{self._swap_timeout_s:.0f}s (tick "
                                  "loop wedged?)"}
        if handle.error:
            return 500, {"error": handle.error}
        if handle.result is None:
            return 404, {
                "error": f"no parked stream {rid!r} (expired, already "
                         "exported, or never prefilled here)"
            }
        raw, parked = handle.result
        shipped = kvship.ShippedKV(
            config=raw["config"],
            generation=raw["generation"],
            wire_dtype=raw["wire_dtype"],
            prompt_len=len(parked.request.prompt),
            pos=raw["pos"],
            step_idx=len(parked.tokens) - 1,
            emitted=list(parked.tokens),
            k=raw["k"], v=raw["v"],
            ks=raw.get("ks"), vs=raw.get("vs"),
            request=self._request_spec(parked.request, parked.request_id),
        )
        return 200, kvship.pack(shipped)

    def _handle_kv_import(self, doc: dict) -> tuple[int, dict]:
        """POST /admin/kv/import: body is a packed ship payload
        (``kvship.pack``) — map the shipped KV rows into this engine's
        own block pool and resume the stream mid-request. The answer IS
        the finished generate response (same shape as /v1/generate:
        the imported stream is in-flight here, cancellable by its id).
        400 malformed payload, 409 fingerprint mismatch (wrong config /
        weight generation), 429 no slot or KV blocks right now."""
        if not self.loop_alive():
            return 503, {"error": "engine loop is not running",
                         "detail": self._loop_error}
        try:
            shipped = kvship.unpack(doc)
        except kvship.ShipFormatError as e:
            return 400, {"error": str(e)}
        try:
            spec = dict(shipped.request)
            # the router's import-leg trace context arrives at the TOP
            # level of the packed payload (the spec itself is the
            # original request, minted before any handoff existed);
            # inject it so the decode-side spans parent under that leg
            tctx = doc.get("trace_context")
            if isinstance(tctx, str) and tctx and "trace_context" not in spec:
                spec["trace_context"] = tctx
            request = self._parse_request(spec)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad shipped request spec: {e}"}
        sched = self._scheduler
        handle = sched.call_on_tick(
            lambda: sched.admit_import(request, shipped)
        )
        if not handle.wait(self._swap_timeout_s):
            return 504, {"error": "import did not run within "
                                  f"{self._swap_timeout_s:.0f}s (tick "
                                  "loop wedged?)"}
        if handle.error:
            # the tick thread serialized the raise as "Type: message";
            # map the type back onto the wire contract (409 = the
            # pairing is wrong and retrying THIS replica is pointless;
            # 429 = capacity, the router tries another decode replica)
            if handle.error.startswith("ShipMismatchError"):
                return 409, {"error": handle.error}
            if handle.error.startswith(("BlocksExhausted", "QueueFull")):
                return 429, {"error": handle.error}
            return 400, {"error": handle.error}
        return self._await_ticket(request, handle.result)

    # -- observability -------------------------------------------------------

    def health(self) -> tuple[int, dict]:
        s = self._scheduler.stats()
        alive = self.loop_alive()
        doc = {
            "healthy": alive,
            "queue_depth": s["queue_depth"],
            "slots_busy": s["slots_busy"],
            "slots_total": s["slots_total"],
            "served": s["served"],
            # the fleet router's routing inputs ride on the liveness
            # body (one GET per health tick, no /metrics parse): current
            # load, KV headroom, drain state, deploy generation, and the
            # disaggregated-serving tier this replica belongs to
            "draining": s.get("draining", False),
            "role": self.role,
        }
        kv = s.get("kv_pool")
        if isinstance(kv, dict) and kv.get("blocks_free") is not None:
            doc["kv_blocks_free"] = kv["blocks_free"]
        if s.get("deploy_generation") is not None:
            doc["deploy_generation"] = s["deploy_generation"]
        # total attributed device-seconds (all classes): the router's
        # per-replica cost gauge, riding the same one-GET probe
        dev = s.get("device_seconds_by_priority")
        if dev:
            doc["device_seconds_total"] = round(sum(dev.values()), 6)
        if self._loop_error:
            doc["error"] = self._loop_error
        return (200 if alive else 503), doc

    def readiness(self) -> tuple[int, dict]:
        """READINESS, split from liveness: can this replica take NEW
        traffic right now? A draining replica is alive (/healthz 200 —
        the router must not eject it as dead) but not ready (503 here)
        until its weight push resumes it."""
        alive = self.loop_alive()
        sched = self._scheduler
        draining = bool(getattr(sched, "draining", False))
        doc = {
            "ready": alive and not draining,
            "draining": draining,
            "in_flight": sched.in_flight(),
            "queue_depth": sched.queue_depth(),
        }
        gen = getattr(sched.backend, "deploy_generation", None)
        if gen is not None:
            doc["deploy_generation"] = int(gen)
        if self._loop_error:
            doc["error"] = self._loop_error
        return (200 if doc["ready"] else 503), doc

    def render_metrics(self) -> str:
        s = self._scheduler.stats()
        gauges = [
            ("nanodiloco_serve_queue_depth",
             "requests waiting for a slot", s["queue_depth"]),
            ("nanodiloco_serve_slots_busy",
             "slots with a live request (prefilling or decoding)",
             s["slots_busy"]),
            ("nanodiloco_serve_slots_prefilling",
             "slots mid-chunked-prefill", s.get("slots_prefilling")),
            ("nanodiloco_serve_slots_parked",
             "slots holding a prefilled stream awaiting KV export (the "
             "disaggregated handoff window)", s.get("slots_parked")),
            ("nanodiloco_serve_slots_total",
             "decode slots in the engine batch", s["slots_total"]),
            ("nanodiloco_serve_prefill_chunks_pending",
             "staged prefill chunks waiting for a tick interleave slot",
             s.get("prefill_chunks_pending")),
            ("nanodiloco_serve_ttft_seconds",
             "last request's time to first token", s["ttft_last_s"]),
            ("nanodiloco_serve_ttft_p50_seconds",
             "median TTFT over the last 512 admissions", s["ttft_p50_s"]),
            ("nanodiloco_serve_ttft_p95_seconds",
             "p95 TTFT over the last 512 admissions", s["ttft_p95_s"]),
            ("nanodiloco_serve_decode_tokens_per_sec",
             "aggregate decode throughput across live slots",
             s["decode_tokens_per_sec"]),
            ("nanodiloco_serve_tp_degree",
             "tensor-parallel shards the decode tick spans (1 = "
             "unsharded)", s.get("tp_degree")),
            ("nanodiloco_deploy_generation",
             "weight generation this replica serves (bumped by every "
             "hot swap; 0 = the boot checkpoint)",
             s.get("deploy_generation")),
            ("nanodiloco_serve_draining",
             "1 while admission is drained for a weight push (alive "
             "but not ready)", int(s["draining"]) if "draining" in s
             else None),
        ]
        families: list = [
            (name, "gauge", help_text, [(None, value)])
            for name, help_text, value in gauges
            if value is not None
        ]
        outcomes = s["requests_by_outcome"]
        families.append((
            "nanodiloco_serve_requests", "counter",
            "requests by terminal outcome",
            [({"outcome": k}, v) for k, v in outcomes.items()]
            + [(None, sum(outcomes.values()))],
        ))
        families.append((
            "nanodiloco_serve_tokens", "counter",
            "tokens sampled (prefill + decode)", [(None, s["tokens_out"])],
        ))
        families.append((
            "nanodiloco_serve_prefill_chunks", "counter",
            "prefill chunks run (one per tick interleave slot)",
            [(None, s.get("prefill_chunks_total", 0))],
        ))
        # disaggregated-serving tier + handoff traffic: the role gauge
        # (always present — the router's tier map), the abandoned-park
        # counter, and the KV ship meters (export/import split by the
        # direction label; present only once a ship has happened)
        families.append((
            "nanodiloco_serve_role", "gauge",
            "disaggregated-serving tier this replica declares (1 under "
            "its role label: prefill, decode, or both)",
            [({"role": self.role}, 1)],
        ))
        if s.get("park_expired") is not None:
            families.append((
                "nanodiloco_serve_park_expired", "counter",
                "parked prefilled slots reclaimed without export "
                "(abandoned disaggregated handoffs — TTL or deadline "
                "fired before /admin/kv/export)",
                [(None, s["park_expired"])],
            ))
        ship = s.get("kvship")
        if ship is not None:
            families.append((
                "nanodiloco_kv_ship_requests", "counter",
                "KV ship operations by direction (export = parked "
                "streams shipped out, import = shipped streams resumed "
                "here)",
                [({"direction": "export"}, ship["export_requests"]),
                 ({"direction": "import"}, ship["import_requests"])],
            ))
            families.append((
                "nanodiloco_kv_ship_bytes", "counter",
                "raw KV payload bytes shipped (pre-base64), by direction",
                [({"direction": "export"}, ship["export_bytes"]),
                 ({"direction": "import"}, ship["import_bytes"])],
            ))
            families.append((
                "nanodiloco_kv_ship_blocks", "counter",
                "KV cache blocks shipped (exporter's block geometry on "
                "export, importer's on import), by direction",
                [({"direction": "export"}, ship["export_blocks"]),
                 ({"direction": "import"}, ship["import_blocks"])],
            ))
            families.append((
                "nanodiloco_kv_ship_seconds", "counter",
                "host seconds spent gathering/scattering shipped KV, by "
                "direction",
                [({"direction": "export"}, ship["export_seconds"]),
                 ({"direction": "import"}, ship["import_seconds"])],
            ))
        if s.get("admission_blocked_no_slot") is not None:
            families.append((
                "nanodiloco_serve_admission_blocked", "counter",
                "ticks the next queued request could not be admitted, "
                "by cause (no_slot = slots exhausted, no_blocks = KV "
                "block pool exhausted)",
                [({"reason": "no_slot"}, s["admission_blocked_no_slot"]),
                 ({"reason": "no_blocks"},
                  s["admission_blocked_no_blocks"])],
            ))
        # paged KV block pool: the gauges that turn "how many more
        # requests fit this chip" from folklore into a scrape
        kv = s.get("kv_pool")
        if kv is not None:
            families.append((
                "nanodiloco_kv_blocks_free", "gauge",
                "KV cache blocks available for admission",
                [(None, kv["blocks_free"])],
            ))
            families.append((
                "nanodiloco_kv_blocks_used", "gauge",
                "KV cache blocks held by live slots and cached prefixes",
                [(None, kv["blocks_used"])],
            ))
            families.append((
                "nanodiloco_kv_block_evictions", "counter",
                "prefix-cache KV blocks dereferenced by LRU eviction",
                [(None, kv["block_evictions"])],
            ))
            families.append((
                "nanodiloco_kv_block_size_tokens", "gauge",
                "token rows per KV block", [(None, kv["block_size"])],
            ))
            per_shard = kv.get("blocks_free_per_shard")
            if per_shard:
                # its own family (not labeled samples on
                # nanodiloco_kv_blocks_free): a sum-by-family aggregation
                # over shard labels would multiply the global pool's
                # free count by tp — the prefix-cache lookup lesson
                families.append((
                    "nanodiloco_kv_blocks_free_per_shard", "gauge",
                    "KV blocks free per tensor-parallel shard (the host "
                    "pool is global: a block id names the same physical "
                    "block on every shard)",
                    [({"shard": str(sh)}, v)
                     for sh, v in sorted(per_shard.items())],
                ))
            hist = kv.get("hist_blocks_per_request")
            if hist is not None:
                families.append((
                    "nanodiloco_kv_blocks_per_request", "histogram",
                    "KV blocks a request held over its life (observed "
                    "at release)", hist,
                ))
        # speculative decoding: the draft/accept economics — the
        # acceptance-rate gauge is what says whether speculation is
        # earning its verify overhead on the live traffic mix
        spec = s.get("spec")
        if spec is not None:
            families.append((
                "nanodiloco_spec_draft_tokens", "counter",
                "draft tokens proposed by prompt-lookup speculation",
                [(None, spec["draft_tokens"])],
            ))
            families.append((
                "nanodiloco_spec_accepted", "counter",
                "draft tokens accepted by batched verification",
                [(None, spec["accepted_tokens"])],
            ))
            families.append((
                "nanodiloco_spec_rejected", "counter",
                "draft tokens rejected by batched verification",
                [(None, spec["rejected_tokens"])],
            ))
            if spec.get("acceptance_rate") is not None:
                families.append((
                    "nanodiloco_spec_acceptance_rate", "gauge",
                    "accepted / drafted over the engine's life",
                    [(None, spec["acceptance_rate"])],
                ))
            hist = spec.get("hist_tokens_per_tick")
            if hist is not None:
                families.append((
                    "nanodiloco_spec_tokens_per_tick", "histogram",
                    "tokens emitted per DRAFTING slot per speculative "
                    "tick (accepted prefix + the verified bonus token)",
                    hist,
                ))
        # shared-prefix KV cache: the counters that tell an operator
        # whether the system-prompt traffic is actually being reused
        pc = s.get("prefix_cache")
        if pc is not None:
            families.append((
                "nanodiloco_serve_prefix_cache_lookups", "counter",
                "prefix-cache lookups by result",
                [({"result": "hit"}, pc["hits"]),
                 ({"result": "miss"}, pc["misses"])],
            ))
            families.append((
                "nanodiloco_serve_prefix_cache_hit_tokens", "counter",
                "prompt tokens served from cached prefix K/V instead of "
                "prefill compute", [(None, pc["hit_tokens"])],
            ))
            families.append((
                "nanodiloco_serve_prefix_cache_insertions", "counter",
                "prefix chunks admitted to the cache",
                [(None, pc["insertions"])],
            ))
            families.append((
                "nanodiloco_serve_prefix_cache_evictions", "counter",
                "prefix chunks LRU-evicted", [(None, pc["evictions"])],
            ))
            families.append((
                "nanodiloco_serve_prefix_cache_tokens", "gauge",
                "tokens currently held in cached prefix chunks",
                [(None, pc["cached_tokens"])],
            ))
        # real distributions (cumulative buckets + _count/_sum): what a
        # scraper can alert and aggregate on, unlike the window gauges
        for name, help_text, key in (
            ("nanodiloco_serve_ttft_histogram_seconds",
             "time to first token, submit to first sampled token",
             "hist_ttft"),
            ("nanodiloco_serve_queue_wait_seconds",
             "slot wait, submit to admission", "hist_queue_wait"),
            ("nanodiloco_serve_decode_tick_seconds",
             "one compiled decode step advancing all live slots",
             "hist_decode_tick"),
        ):
            families.append((name, "histogram", help_text, s[key]))
        by_prio = s.get("hist_queue_wait_by_priority") or {}
        if by_prio:
            families.append((
                "nanodiloco_serve_queue_wait_by_priority_seconds",
                "histogram",
                "slot wait split by SLO priority class (0 = most urgent)",
                [({"priority": str(p)}, snap)
                 for p, snap in by_prio.items()],
            ))
        # class-aware overload shedding: the admission ceiling, the
        # per-class shed counts, and the per-class TTFT p95 — together
        # the honest story of WHO is being sacrificed under overload
        # and whether the protected class's latency actually held
        if s.get("admission_max_priority") is not None:
            families.append((
                "nanodiloco_serve_admission_max_priority", "gauge",
                "highest priority class currently admitted (9 = all; "
                "lower = overload shedding active)",
                [(None, s["admission_max_priority"])],
            ))
        shed = s.get("shed_by_priority") or {}
        if shed:
            families.append((
                "nanodiloco_serve_shed", "counter",
                "requests refused by class-aware overload shedding, by "
                "priority class",
                [({"priority": str(p)}, n)
                 for p, n in sorted(shed.items())]
                + [(None, sum(shed.values()))],
            ))
        ttft_by_prio = s.get("ttft_p95_by_priority") or {}
        if ttft_by_prio:
            families.append((
                "nanodiloco_serve_class_ttft_p95_seconds", "gauge",
                "p95 TTFT split by SLO priority class (0 = most urgent "
                "— the class whose SLO must hold while lower classes "
                "shed)",
                [({"priority": str(p)}, v)
                 for p, v in sorted(ttft_by_prio.items())
                 if v is not None],
            ))
        # per-class cost metering: device-seconds consumed and KV
        # block-seconds held, rolled up from per-request attribution —
        # the billing counters for the millions-of-users story
        dev_by_prio = s.get("device_seconds_by_priority") or {}
        if dev_by_prio:
            families.append((
                "nanodiloco_serve_device_seconds", "counter",
                "attributed dispatch seconds (prefill + decode) by SLO "
                "priority class, summed over finished requests",
                [({"priority": str(p)}, v)
                 for p, v in sorted(dev_by_prio.items())]
                + [(None, round(sum(dev_by_prio.values()), 6))],
            ))
        kvbs_by_prio = s.get("kv_block_seconds_by_priority") or {}
        if kvbs_by_prio:
            families.append((
                "nanodiloco_serve_kv_block_seconds", "counter",
                "KV block-seconds held (blocks x residency time) by SLO "
                "priority class, settled at release",
                [({"priority": str(p)}, v)
                 for p, v in sorted(kvbs_by_prio.items())]
                + [(None, round(sum(kvbs_by_prio.values()), 6))],
            ))
        # decode-tick interference: the DistServe tier-split signal —
        # p50 decode tick with vs without staged prefill chunks pending
        if s.get("decode_interference_ratio") is not None:
            families.append((
                "nanodiloco_serve_decode_interference_ratio", "gauge",
                "p50 decode tick time with pending prefill chunks / p50 "
                "without (>1 = prefill interleave is stretching decode "
                "ticks; the prefill/decode tier-split sizing signal)",
                [(None, s["decode_interference_ratio"])],
            ))
        # per-program dispatch ledgers from the engine's accountant —
        # one family definition (obs/devtime) shared with the trainer's
        # telemetry endpoint so the exposition cannot drift
        families.extend(devtime_families(s.get("devtime")))
        return render_exposition(families)
