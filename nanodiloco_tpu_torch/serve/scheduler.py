"""SLO-aware admission + deterministic tick loop for the serving engine.

A copy of ``nanodiloco_tpu/serve/scheduler.py`` (jax-free), its
imports pointed at the port.

The scheduler is the testable half of continuous batching: it owns WHICH
request runs in WHICH slot WHEN, and nothing else. The model lives
behind a small backend surface (``start_prefill(slot, request) ->
chunks_pending``, ``prefill_step(slot) -> first_token | None``,
``step() -> [B] tokens``, ``release(slot)``), so every scheduling
decision — admission order, chunk interleaving, slot refill mid-decode,
EOS retirement, queue-full backpressure, deadline expiry, starvation
boosts — is provable with a scripted fake backend and an injected clock,
no model and no RNG ambiguity (the same injectable-clock discipline as
``obs/watchdog.py`` and ``resilience/retry.py``).

Admission is deadline/priority ordered, not FIFO (deadlines also
trigger expiry): among queued requests the
scheduler picks the lowest ``priority`` class first (0 = most urgent)
and earliest deadline within a class (EDF; deadline-less requests sort
last, then submit order breaks ties). One bound keeps best-effort
traffic live: a request queued longer than ``starvation_s`` is admitted
next regardless of class, so a stream of urgent work can delay
best-effort requests but never starve them forever.

Prefill is CHUNKED (Sarathi-Serve, arXiv:2403.02310): admission stages a
request into its slot; each tick then runs AT MOST ONE prefill chunk,
between decode ticks, so a 4k-token prompt admits incrementally and
never freezes live decode streams. When several slots are mid-prefill,
the chunk goes to the fewest-chunks-remaining slot first
(shortest-remaining-first: a short prompt's single chunk never waits
behind a long prompt's fifty, which is what bounds short-request TTFT
under interference), with priority class then submit order as ties —
bounded by aging: a slot bypassed ``prefill_aging_ticks`` consecutive
ticks takes the next chunk regardless, so a steady stream of one-chunk
shorts delays a long prefill but can never starve it.

Tick anatomy (one call, strictly ordered, deterministic):
1. expire queued requests whose deadline passed (they never held a
   slot) and drop cancelled ones;
2. expire/cancel requests mid-prefill — a deadline can pass between
   chunks; the slot is released with the usual empty-result expiry;
3. admit from the queue into free slots in SLO order (above) — staging
   only, no model compute yet; a paged backend may refuse for lack of
   free KV BLOCKS (``BlocksExhausted``), which leaves the request
   queued head-of-line with nothing allocated — admission gates on
   blocks as well as slots, and the stall is counted per cause;
4. run ONE prefill chunk for the neediest mid-prefill slot; a final
   chunk yields the request's first token (it may also finish it
   outright: stop token or ``max_new_tokens == 1``);
5. if any slot is decoding, ONE decode step advances them all; the
   backend returns a token VECTOR per slot (one token without
   speculation, up to k+1 with it — never zero), delivered in order
   with the stop token and length bound scanned WITHIN the vector;
   finished slots (stop token / length / deadline) are retired and
   their slots are free for the next tick's admission pass — requests
   join and leave the batch mid-stream, there is no barrier between
   requests. Decode stats count EMITTED tokens, not ticks.

Threading: ``submit`` may be called from any thread (the HTTP handlers);
``tick`` must be called from exactly one thread. The queue is the only
shared state and sits under a lock; everything else belongs to the tick
thread. Completion is delivered through a ``Ticket`` the submitter
waits on.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

import numpy as np

from nanodiloco_tpu_torch.obs import flightrec
from nanodiloco_tpu_torch.obs.telemetry import Histogram, nearest_rank_percentile
from nanodiloco_tpu_torch.obs.tracer import TraceContext
from nanodiloco_tpu_torch.serve.block_pool import BlocksExhausted


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission queue is at capacity —
    the server's 429 backpressure signal. The message names WHAT the
    queue is stuck behind (no free slot vs no free KV blocks) so a 429
    distinguishes slot-bound from HBM-bound saturation."""


class ClassShed(QueueFull):
    """Raised by ``submit`` when the request's priority class is above
    the current admission ceiling (``set_admission_max_priority``) —
    overload shedding, NOT backpressure. The distinction matters on the
    wire: a busy 429 means "this replica, right now" and the fleet
    router retries another replica; a shed 429 means "this CLASS, fleet
    policy" and retrying elsewhere would pointlessly hammer every
    replica — the server marks it ``"shed": true`` so the router
    propagates it terminally."""

    def __init__(self, shed_class: int, max_priority: int) -> None:
        super().__init__(
            f"priority class {shed_class} is shed under overload "
            f"(admitting classes 0..{max_priority})"
        )
        self.shed_class = int(shed_class)
        self.max_priority = int(max_priority)


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One generation request. ``deadline_s`` is a RELATIVE budget from
    submission; a request past it is expired (queued or mid-prefill) or
    retired with its partial output (decoding). ``priority`` is the SLO
    class (0 = most urgent; admission is EDF within a class; default 1
    = normal, best-effort traffic should use a higher number).
    ``prefix_cache`` opts this request out of shared-prefix KV reuse
    (both reading and populating) when False. ``speculate`` opts this
    request out of speculative decoding when False (it decodes one
    token per tick even on an engine with ``spec_k > 0``; greedy and
    sampled streams are bit-identical either way — the opt-out is a
    latency/fairness knob, not a correctness one). ``request_id`` is an
    optional client-supplied correlation id echoed in the result (and
    stamped on the request's trace spans); absent, the scheduler
    derives one from its rid so client logs, serve spans, and
    histograms always have a join key. ``prefill_only`` is the
    disaggregated-serving admission mode (fleet/disagg.py): the request
    finishes at its FIRST token with ``finish_reason="prefilled"`` and
    its slot is PARKED — cache rows intact, not decoding — until
    ``/admin/kv/export`` ships them to a decode replica (or the park
    TTL/deadline reclaims the slot)."""

    prompt: tuple[int, ...]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token: int | None = None
    deadline_s: float | None = None
    request_id: str | None = None
    priority: int = 1
    prefix_cache: bool = True
    speculate: bool = True
    prefill_only: bool = False
    # causal trace context in wire form (obs/tracer.TraceContext): the
    # router's per-attempt span id — this request's queued/prefill/
    # decode spans parent under it, so a fleet trace stitches into one
    # tree. None = untraced (solo clients, old routers).
    trace_context: str | None = None


class Ticket:
    """Handle returned by ``submit``: ``wait(timeout)`` blocks until the
    scheduler finishes the request and returns the result dict
    (``None`` on timeout). ``cancel()`` asks the scheduler to drop the
    request at its next opportunity — a queued or mid-prefill request
    never decodes, a decoding one is retired with its partial output —
    so an abandoned client (HTTP timeout, disconnect) stops spending
    slot capacity on tokens nobody will read."""

    def __init__(self, rid: int) -> None:
        self.rid = rid
        self.result: dict | None = None
        self._event = threading.Event()
        self._cancelled = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def wait(self, timeout: float | None = None) -> dict | None:
        self._event.wait(timeout)
        return self.result


class ControlHandle:
    """Handle for a function handed to the tick thread via
    ``Scheduler.call_on_tick``: ``wait(timeout)`` blocks until the tick
    loop has run it (returns True), then ``result``/``error`` carry the
    outcome. Exists because the engine belongs to the tick thread — a
    weight hot-swap arriving over HTTP must run BETWEEN ticks, never
    concurrently with a compiled dispatch."""

    def __init__(self, fn: Callable[[], object]) -> None:
        self.fn = fn
        self.result: object | None = None
        self.error: str | None = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


@dataclasses.dataclass
class _Queued:
    ticket: Ticket
    request: GenRequest
    submitted_at: float
    deadline_at: float | None


@dataclasses.dataclass
class _Prefilling:
    """A slot whose request is staged but still prefilling in chunks.
    ``bypassed`` counts consecutive ticks the SRPT pick went elsewhere —
    the aging input that keeps a long prefill from starving."""

    ticket: Ticket
    request: GenRequest
    submitted_at: float
    deadline_at: float | None
    admitted_at: float
    chunks_left: int
    chunks_run: int = 0
    bypassed: int = 0
    # device-time attribution (obs/devtime): measured chunk seconds
    # billed wholly to this request, and the KV blocks it holds (a
    # paged allocation is all-or-nothing at admission) for the
    # block-seconds bill at release
    prefill_device_s: float = 0.0
    blocks_held: int = 0


@dataclasses.dataclass
class _Parked:
    """A prefilled stream whose slot is held for KV export (the
    disaggregated handoff window). The ticket already finished — with
    ``finish_reason="prefilled"`` and the first token — so nothing
    waits on this; the slot's cache rows survive until
    ``export_parked`` ships them, or the deadline/park-TTL sweep
    reclaims an abandoned handoff."""

    request: GenRequest
    request_id: str
    tokens: list[int]
    submitted_at: float
    deadline_at: float | None
    admitted_at: float
    parked_at: float
    prefill_device_s: float = 0.0
    blocks_held: int = 0


@dataclasses.dataclass
class _Running:
    ticket: Ticket
    request: GenRequest
    submitted_at: float
    deadline_at: float | None
    admitted_at: float
    first_token_at: float
    tokens: list[int]
    # device-time attribution: prefill seconds carried over from the
    # _Prefilling phase; decode seconds are this slot's share of each
    # measured tick (split over the slots it advanced, weighted by
    # emitted positions)
    prefill_device_s: float = 0.0
    decode_device_s: float = 0.0
    blocks_held: int = 0


class Scheduler:
    """SLO-ordered admission + slot allocation over a backend with
    ``num_slots`` slots. ``clock`` is injectable (monotonic seconds);
    ``starvation_s`` bounds how long priority traffic may delay a
    best-effort request (None = pure priority/EDF, starvable)."""

    def __init__(
        self,
        backend,
        *,
        max_queue: int = 64,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        starvation_s: float | None = 30.0,
        prefill_aging_ticks: int = 8,
        park_ttl_s: float = 30.0,
    ) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1; got {max_queue}")
        if starvation_s is not None and starvation_s <= 0:
            raise ValueError(
                f"starvation_s must be positive or None; got {starvation_s}"
            )
        if prefill_aging_ticks < 1:
            raise ValueError(
                f"prefill_aging_ticks must be >= 1; got {prefill_aging_ticks}"
            )
        if park_ttl_s <= 0:
            raise ValueError(f"park_ttl_s must be > 0; got {park_ttl_s}")
        self.backend = backend
        # how long a prefilled slot may sit parked awaiting KV export
        # before the sweep reclaims it (a crashed/partitioned router
        # must not leak slots and blocks through abandoned handoffs)
        self.park_ttl_s = float(park_ttl_s)
        self._clock = clock
        # in-slot aging bound for the per-tick chunk pick (step 4): a
        # mid-prefill slot bypassed this many consecutive ticks gets
        # the next chunk regardless of shortest-remaining-first
        self.prefill_aging_ticks = int(prefill_aging_ticks)
        # per-request span sink (obs/tracer.SpanTracer or None): the
        # scheduler reports each request's queued/prefill/decode phases
        # via record_span with ITS OWN clock's timestamps — construct
        # the tracer with the same clock callable, or the serve trace's
        # lanes won't align. Export through trace_shard_path / `report
        # merge-trace` puts serve spans on the same Perfetto timeline
        # as the training shards.
        self.tracer = tracer
        self.max_queue = int(max_queue)
        self.starvation_s = starvation_s
        self._slots: list[_Prefilling | _Running | _Parked | None] = (
            [None] * backend.num_slots
        )
        self._queue: collections.deque[_Queued] = collections.deque()
        self._lock = threading.Lock()
        self._next_rid = 0
        # drain state (fleet weight pushes): True stops ADMISSION only —
        # queued requests stay queued (deadlines still expire them),
        # in-flight prefills and streams run to completion. The serving
        # replica reports not-READY while draining but stays LIVE: the
        # router must stop routing to it, not eject it as dead.
        self._draining = False
        # control queue: functions other threads hand to the tick thread
        # (weight swaps mutate the engine, which is single-threaded by
        # construction); run at the top of the next tick
        self._control: collections.deque[ControlHandle] = collections.deque()
        # stats (read by the server's gauges; written by the tick thread
        # except rejected, which submit bumps under the queue lock)
        self._served = 0
        self._rejected = 0
        self._expired = 0
        self._cancelled = 0
        self._errors = 0
        # parked slots reclaimed without export (disagg handoffs the
        # router abandoned — TTL or deadline fired before /admin/kv/export)
        self._park_expired = 0
        # class-aware overload shedding: requests whose priority is
        # ABOVE this ceiling are refused at submit (ClassShed -> a
        # terminal 429) so the highest classes' SLO holds while load
        # exceeds capacity. 9 admits every class (the priority range is
        # 0..9); the fleet router / autoscaler lowers it under
        # forecasted exhaustion via /admin/admission.
        self._admission_max_priority = 9
        self._shed_by_priority: dict[int, int] = {}
        # admission-stall accounting: ticks on which the next queued
        # request could not be admitted, split by WHY — every slot
        # occupied ("no_slot") vs the backend's KV block pool unable to
        # hold the request right now ("no_blocks"). The split is what
        # tells an operator whether to add slots or HBM.
        self._blocked_no_slot = 0
        self._blocked_no_blocks = 0
        self._tokens_out = 0
        self._decode_tokens = 0
        self._decode_s = 0.0
        self._prefill_chunks = 0   # chunks run (counter)
        # device-time and cost attribution (obs/devtime): measured
        # prefill-dispatch seconds (the decode twin is _decode_s), the
        # per-class device-second and KV-block-second rollups the
        # billing counters export, and the two decode-tick windows the
        # interference ratio derives from — tick p50 with vs without
        # pending prefill chunks, the DistServe tier-split signal
        # (arXiv:2401.09670; ROADMAP item 1)
        self._prefill_s = 0.0
        self._device_s_by_priority: dict[int, float] = {}
        self._kv_block_s_by_priority: dict[int, float] = {}
        self._tick_with_prefill: collections.deque[float] = (
            collections.deque(maxlen=512)
        )
        self._tick_no_prefill: collections.deque[float] = (
            collections.deque(maxlen=512)
        )
        self._ttft: collections.deque[float] = collections.deque(maxlen=512)
        # per-class TTFT windows: the gauge the highest class's SLO rule
        # alerts on — the fleet-wide TTFT p95 is meaningless under
        # class-aware shedding (it mixes the protected class with the
        # best-effort one being sacrificed)
        self._ttft_by_priority: dict[int, collections.deque] = {}
        # real distributions for the scrape (cumulative-bucket
        # histograms; the deque above remains for last/p50/p95 gauges):
        # TTFT submit->first-token, slot wait submit->admit (overall AND
        # split by priority class — the per-class wait is what an SLO
        # dashboard actually alerts on), and the per-tick decode latency
        self.hist_ttft = Histogram()
        self.hist_queue_wait = Histogram()
        self.hist_decode_tick = Histogram()
        self.hist_queue_wait_by_priority: dict[int, Histogram] = {}

    # -- submission (any thread) --------------------------------------------

    def submit(self, request: GenRequest) -> Ticket:
        now = self._clock()
        with self._lock:
            if request.priority > self._admission_max_priority:
                self._shed_by_priority[request.priority] = (
                    self._shed_by_priority.get(request.priority, 0) + 1
                )
                raise ClassShed(request.priority,
                                self._admission_max_priority)
            if len(self._queue) >= self.max_queue:
                self._rejected += 1
                raise QueueFull(
                    f"admission queue is full ({self.max_queue} waiting"
                    f"{self._saturation_detail()})"
                )
            ticket = Ticket(self._next_rid)
            self._next_rid += 1
            deadline = (
                now + request.deadline_s
                if request.deadline_s is not None else None
            )
            self._queue.append(_Queued(ticket, request, now, deadline))
        return ticket

    # -- drain + tick-thread control (any thread) ----------------------------

    def drain(self) -> None:
        """Stop admitting queued requests (in-flight streams finish;
        the queue keeps accepting submissions and keeps expiring
        deadlines). The replica's /readyz flips not-ready so the fleet
        router routes around it during a weight push."""
        self._draining = True

    def resume(self) -> None:
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def admission_max_priority(self) -> int:
        return self._admission_max_priority

    def set_admission_max_priority(self, max_priority: int) -> int:
        """Set the class-shedding ceiling: requests with ``priority >
        max_priority`` are refused with ``ClassShed`` (a terminal 429)
        until the ceiling is raised again. 9 admits everything; 0 sheds
        all but the most urgent class; -1 (the floor) sheds even class
        0 — a full admission stop that, unlike ``drain``, answers with
        an honest shed body instead of flipping readiness."""
        if not isinstance(max_priority, int) or isinstance(
                max_priority, bool) or not -1 <= max_priority <= 9:
            raise ValueError(
                f"max_priority must be an integer in [-1, 9]; got "
                f"{max_priority!r}"
            )
        self._admission_max_priority = max_priority
        return max_priority

    def in_flight(self) -> int:
        """Slots holding a request (prefilling or decoding) — what a
        drain waits on before a weight push proceeds."""
        return sum(1 for s in self._slots if s is not None)

    def call_on_tick(self, fn: Callable[[], object]) -> ControlHandle:
        """Schedule ``fn`` onto the tick thread (run before the next
        tick's scheduling passes). The returned handle carries the
        result — or the error: a control function raising must report
        to ITS caller, never kill the serving loop."""
        handle = ControlHandle(fn)
        with self._lock:
            self._control.append(handle)
        return handle

    # -- KV shipping (disaggregated serving; run via call_on_tick) -----------

    def export_parked(self, request_id: str,
                      trace_context: str | None = None):
        """Ship a PARKED request's raw KV out and free its slot. Tick
        thread only (hand it over with ``call_on_tick``). Returns
        ``(raw_export, parked)`` — the backend's ``export_kv`` dict plus
        the parked record (cursor, emitted tokens, original request) —
        or ``None`` when no parked slot matches (expired, already
        exported, or never here: the server's 404). ``trace_context``
        is the router's export-leg wire context; the ``kv_export`` span
        parents under it."""
        t0 = self._clock()
        ctx = None
        if self.tracer is not None and trace_context:
            wire = TraceContext.from_wire(trace_context)
            ctx = wire.child() if wire is not None else None
        for s, run in enumerate(self._slots):
            if isinstance(run, _Parked) and run.request_id == request_id:
                raw = self.backend.export_kv(s)
                self._backend_release(s)
                self._slots[s] = None
                self._span("kv_export", t0, self._clock(), request_id,
                           ctx=ctx, slot=s, outcome="ok")
                return raw, run
        self._span("kv_export", t0, self._clock(), request_id,
                   ctx=ctx, outcome="missing")
        return None

    def _import_ctx(self, request: GenRequest):
        """The kv_import span's context: a child of the router's
        import-leg wire context (rides in the shipped request spec)."""
        if self.tracer is None or not request.trace_context:
            return None
        wire = TraceContext.from_wire(request.trace_context)
        return wire.child() if wire is not None else None

    def admit_import(self, request: GenRequest, shipped) -> Ticket:
        """Admit a SHIPPED stream straight into a free slot, bypassing
        the queue: the prompt is already prefilled — its KV rows arrive
        in ``shipped`` — so the slot goes directly to ``_Running`` and
        the next decode tick resumes the stream mid-request. Tick
        thread only (``call_on_tick``); the HTTP handler maps the
        raises: ``ShipMismatchError`` -> 409, ``BlocksExhausted`` /
        ``QueueFull`` -> 429, anything else -> 400."""
        t0 = self._clock()
        imp_ctx = self._import_ctx(request)
        # shipped requests carry the router's correlation id; "(ship)"
        # only when a direct caller omitted one (no ticket exists yet)
        rid = request.request_id or "(ship)"
        slot = next(
            (s for s in range(len(self._slots)) if self._slots[s] is None),
            None,
        )
        if slot is None:
            self._span("kv_import", t0, self._clock(), rid,
                       ctx=imp_ctx, outcome="busy")
            raise QueueFull(
                "no free KV import slot"
                f"{self._saturation_detail()}"
            )
        with self._lock:
            ticket = Ticket(self._next_rid)
            self._next_rid += 1
        now = self._clock()
        try:
            # raises ShipMismatchError / ShipFormatError / BlocksExhausted /
            # ValueError having allocated nothing (all-or-nothing import)
            self.backend.import_kv(slot, request, shipped)
        except Exception:
            self._span("kv_import", t0, self._clock(), rid,
                       ctx=imp_ctx, outcome="error")
            raise
        self._span("kv_import", t0, self._clock(), rid,
                   ctx=imp_ctx, slot=slot, outcome="ok")
        held = getattr(self.backend, "blocks_held", None)
        deadline = (
            now + request.deadline_s
            if request.deadline_s is not None else None
        )
        run = _Running(
            ticket, request, now, deadline, now, now,
            [int(t) for t in shipped.emitted],
            blocks_held=int(held(slot)) if held is not None else 0,
        )
        # a ship can arrive already satisfied (stop token in the emitted
        # tail, or emitted == max_new_tokens): retire instantly rather
        # than decode a finished stream
        reason = self._finish_reason(run, now)
        if reason is not None:
            self._backend_release(slot)
            self._retire(run, reason, now)
        else:
            self._slots[slot] = run
        return ticket

    # -- the tick loop (one thread) ------------------------------------------

    def tick(self) -> int:
        """One deterministic scheduling round (see module docstring).
        Returns the number of occupied slots (prefilling or decoding)
        after the tick, so a serving loop can idle when there is no
        work."""
        # 0. run control functions handed over from other threads (a
        # weight hot-swap): they mutate the backend, which belongs to
        # this thread; an error is the CALLER's to read, never fatal to
        # the serving loop
        while True:
            with self._lock:
                if not self._control:
                    break
                handle = self._control.popleft()
            try:
                handle.result = handle.fn()
            except Exception as e:
                handle.error = f"{type(e).__name__}: {e}"
            handle._event.set()
        now = self._clock()
        # 1. drop queued requests whose deadline passed or whose client
        # cancelled (they never held a slot)
        dropped: list[tuple[_Queued, str]] = []
        with self._lock:
            still = collections.deque()
            for q in self._queue:
                if q.ticket.cancelled:
                    dropped.append((q, "cancelled"))
                elif q.deadline_at is not None and now >= q.deadline_at:
                    dropped.append((q, "deadline"))
                else:
                    still.append(q)
            self._queue = still
        for q, reason in dropped:
            if reason == "deadline":
                self._expired += 1
            else:
                self._cancelled += 1
            self._span("queued", q.submitted_at, now,
                       self._req_id(q.ticket, q.request),
                       ctx=self._ctx(q.request), outcome=reason)
            self._finish(q.ticket, q.request, [], reason,
                         q.submitted_at, None, None, now)

        # 2. expire/cancel requests caught mid-prefill: a deadline can
        # pass between two chunks of a long prompt; the slot frees with
        # the same empty-result expiry a queued request gets
        for s, run in enumerate(self._slots):
            if not isinstance(run, _Prefilling):
                continue
            if run.ticket.cancelled:
                reason = "cancelled"
                self._cancelled += 1
            elif run.deadline_at is not None and now >= run.deadline_at:
                reason = "deadline"
                self._expired += 1
            else:
                continue
            self._backend_release(s)
            self._slots[s] = None
            self._span("prefill", run.admitted_at, now,
                       self._req_id(run.ticket, run.request),
                       ctx=self._ctx(run.request), slot=s,
                       chunks=run.chunks_run, outcome=reason)
            # chunks already run billed their seconds to this request —
            # an expiry mid-prefill must not drop them (no second
            # silently vanishes), and the blocks it held settle here
            self._finish(run.ticket, run.request, [], reason,
                         run.submitted_at, run.admitted_at, None, now,
                         prefill_device_s=run.prefill_device_s,
                         kv_block_seconds=(
                             run.blocks_held * (now - run.admitted_at)))

        # 2b. reclaim PARKED slots whose handoff was abandoned: the
        # ticket already finished ("prefilled"), so this is pure
        # resource recovery — a router that crashed or partitioned
        # between prefill and export must not leak the slot and its KV
        # blocks forever
        for s, run in enumerate(self._slots):
            if not isinstance(run, _Parked):
                continue
            if ((run.deadline_at is not None and now >= run.deadline_at)
                    or now - run.parked_at >= self.park_ttl_s):
                self._backend_release(s)
                self._slots[s] = None
                self._park_expired += 1

        # 3. admit into free slots in SLO order (priority class, EDF
        # within it, starvation bound on top) — staging only; the model
        # work happens one chunk per tick in step 4. A cancelled or
        # invalid PEEK retries the SAME free slot with the next queued
        # request: a dud at the queue head must not cost a viable
        # request its admission tick. Admission gates on KV BLOCKS as
        # well as slots: a backend that cannot currently hold the
        # request's cache raises ``BlocksExhausted`` having allocated
        # NOTHING — the request is left queued (head-of-line, so SLO
        # order is preserved; blocks free as live requests retire) and
        # the stall is counted under its own reason.
        slot = 0
        blocked_on_blocks = False
        # a draining scheduler admits NOTHING (the whole point of the
        # drain: in-flight streams finish, the queue holds) — and the
        # stall counters stay quiet: a drain is an operator action, not
        # a capacity signal
        while not self._draining and slot < len(self._slots):
            if self._slots[slot] is not None:
                slot += 1
                continue
            q = self._peek_queued()
            if q is None:
                break
            if q.ticket.cancelled:  # cancelled between sweep and peek
                self._dequeue(q)
                self._cancelled += 1
                now2 = self._clock()
                self._span("queued", q.submitted_at, now2,
                           self._req_id(q.ticket, q.request),
                           ctx=self._ctx(q.request), outcome="cancelled")
                self._finish(q.ticket, q.request, [], "cancelled",
                             q.submitted_at, None, None, now2)
                continue
            rid_str = self._req_id(q.ticket, q.request)
            t_admit = self._clock()
            try:
                chunks = int(self.backend.start_prefill(slot, q.request))
            except BlocksExhausted:
                # nothing was allocated (the pool's alloc is
                # all-or-nothing) and the request stays exactly where
                # it was in the queue — retried next tick
                blocked_on_blocks = True
                self._blocked_no_blocks += 1
                break
            except ValueError as e:
                # a bad REQUEST must not kill the loop; anything else
                # (OOM, a donated-then-deleted cache) propagates and
                # kills the tick loop — a broken engine must flip
                # /healthz to 503, not limp along half-alive
                self._dequeue(q)
                self._errors += 1
                self._span("queued", q.submitted_at, t_admit, rid_str,
                           ctx=self._ctx(q.request), outcome="error")
                self._finish(q.ticket, q.request, [], "error",
                             q.submitted_at, None, None, self._clock(),
                             error=str(e))
                continue
            self._dequeue(q)
            wait = t_admit - q.submitted_at
            # exemplar: the sampled trace id rides into whichever bucket
            # this observation lands in, linking the histogram back to
            # one real request's causal tree
            self.hist_queue_wait.observe(
                wait, exemplar=self._trace_id(q.request))
            self._priority_hist(q.request.priority).observe(wait)
            self._span("queued", q.submitted_at, t_admit, rid_str,
                       ctx=self._ctx(q.request), slot=slot,
                       priority=q.request.priority)
            # KV blocks the admission just allocated (all-or-nothing,
            # constant until release): the block-seconds bill is
            # blocks x held-time, settled at release. Backends without
            # the accessor (dense, fakes) bill zero.
            held = getattr(self.backend, "blocks_held", None)
            self._slots[slot] = _Prefilling(
                q.ticket, q.request, q.submitted_at, q.deadline_at,
                t_admit, chunks,
                blocks_held=int(held(slot)) if held is not None else 0,
            )
            slot += 1
        if (not self._draining and not blocked_on_blocks
                and self.queue_depth() > 0
                and all(s is not None for s in self._slots)):
            self._blocked_no_slot += 1

        # 4. ONE prefill chunk, to the fewest-chunks-remaining slot
        # (shortest-remaining-first bounds short-request TTFT while a
        # long prefill is in flight), priority then admission order as
        # tie-breaks. Aging caps the delay: a slot bypassed
        # ``prefill_aging_ticks`` consecutive ticks takes the next
        # chunk regardless of SRPT — without it, a steady stream of
        # one-chunk shorts would starve a long prefill forever (the
        # admission-level starvation bound stops at the queue pop; this
        # is its in-slot counterpart).
        pf_slots = [
            s for s, r in enumerate(self._slots)
            if isinstance(r, _Prefilling)
        ]
        if pf_slots:
            aged = [s for s in pf_slots
                    if self._slots[s].bypassed >= self.prefill_aging_ticks]
            if aged:
                s = max(aged, key=lambda i: (self._slots[i].bypassed,
                                             -self._slots[i].ticket.rid))
            else:
                s = min(pf_slots, key=lambda i: (
                    self._slots[i].chunks_left,
                    self._slots[i].request.priority,
                    self._slots[i].ticket.rid,
                ))
            for other in pf_slots:
                if other != s:
                    self._slots[other].bypassed += 1
            run = self._slots[s]
            run.bypassed = 0
            # the chunk's measured seconds bill WHOLLY to this request
            # (one chunk advances exactly one prefill) — the scheduler's
            # own clock, so scripted backends and injected clocks in
            # tests attribute the same way the engine path does
            t_pf0 = self._clock()
            tok0 = self.backend.prefill_step(s)
            pf_dt = self._clock() - t_pf0
            self._prefill_s += pf_dt
            run.prefill_device_s += pf_dt
            self._prefill_chunks += 1
            run.chunks_run += 1
            run.chunks_left = max(0, run.chunks_left - 1)
            if tok0 is not None:
                t_first = self._clock()
                rid_str = self._req_id(run.ticket, run.request)
                self.hist_ttft.observe(t_first - run.submitted_at,
                                       exemplar=self._trace_id(run.request))
                self._span("prefill", run.admitted_at, t_first, rid_str,
                           ctx=self._ctx(run.request),
                           slot=s, prompt_tokens=len(run.request.prompt),
                           chunks=run.chunks_run)
                with self._lock:  # stats() sorts this deque from HTTP threads
                    self._ttft.append(t_first - run.submitted_at)
                    dq = self._ttft_by_priority.setdefault(
                        int(run.request.priority),
                        collections.deque(maxlen=256),
                    )
                    dq.append(t_first - run.submitted_at)
                self._tokens_out += 1
                live = _Running(run.ticket, run.request, run.submitted_at,
                                run.deadline_at, run.admitted_at, t_first,
                                [int(tok0)],
                                prefill_device_s=run.prefill_device_s,
                                blocks_held=run.blocks_held)
                reason = self._finish_reason(live, t_first)
                if reason is not None:
                    # prefill already activated the slot in the backend;
                    # an unreleased instant-finish would decode as a
                    # zombie
                    self._backend_release(s)
                    self._slots[s] = None
                    self._retire(live, reason, t_first)
                elif run.request.prefill_only:
                    # disaggregated admission: the stream finishes HERE
                    # with its first token; the slot parks — cache rows
                    # intact, not decoding — until /admin/kv/export
                    # ships them (or the TTL/deadline sweep reclaims an
                    # abandoned handoff). Billing settles now: block
                    # residency DURING the park is the handoff's cost,
                    # billed at export/expiry, not to the request.
                    self._slots[s] = _Parked(
                        run.request, rid_str, [int(tok0)],
                        run.submitted_at, run.deadline_at,
                        run.admitted_at, t_first,
                        prefill_device_s=run.prefill_device_s,
                        blocks_held=run.blocks_held,
                    )
                    self._served += 1
                    self._finish(
                        run.ticket, run.request, [int(tok0)], "prefilled",
                        run.submitted_at, run.admitted_at, t_first, t_first,
                        prefill_device_s=run.prefill_device_s,
                        kv_block_seconds=(
                            run.blocks_held * (t_first - run.admitted_at)),
                    )
                else:
                    self._slots[s] = live

        # 5. one decode step for everyone live. The backend emits a
        # token VECTOR per slot (1..k+1 under speculative decoding;
        # legacy/fake backends may still return one scalar per slot):
        # tokens are delivered in order, scanning for the stop token
        # and the length bound WITHIN the vector — a draft window that
        # sails past EOS must not leak post-stop tokens into the
        # result. Decode stats count EMITTED tokens, not ticks: at one
        # token per tick the two were equal, so the old tick count was
        # latently wrong the moment multi-token emission landed.
        live = [
            s for s in range(len(self._slots))
            if isinstance(self._slots[s], _Running)
        ]
        if live:
            t0 = self._clock()
            toks = self.backend.step()
            t1 = self._clock()
            tick_dt = t1 - t0
            self._decode_s += tick_dt
            self.hist_decode_tick.observe(tick_dt)
            # interference window split: was prefill work pending while
            # this decode tick ran? (staged chunks interleave with
            # decode — the p50 gap between the two windows is the
            # DistServe tier-split sizing signal)
            if any(isinstance(r, _Prefilling) for r in self._slots):
                self._tick_with_prefill.append(tick_dt)
            else:
                self._tick_no_prefill.append(tick_dt)
            # normalize every slot's emission vector FIRST: the tick's
            # measured seconds are apportioned over the slots it
            # advanced, weighted by emitted positions (plain decode
            # emits 1 per slot — an equal split; a verify tick's wider
            # emissions carry proportionally more of the window). The
            # weights sum the shares back to exactly tick_dt — no
            # second dropped or double-billed, even when a slot
            # finishes (stop/length/deadline) inside this very tick.
            vecs: dict[int, list] = {}
            for s in live:
                vec = toks[s]
                if not isinstance(vec, (list, tuple, np.ndarray)):
                    vec = [vec]  # scalar-per-slot backends
                vecs[s] = vec
            wsum = sum(max(1, len(v)) for v in vecs.values())
            for s in live:
                run = self._slots[s]
                vec = vecs[s]
                run.decode_device_s += (
                    tick_dt * max(1, len(vec)) / wsum
                )
                req = run.request
                reason = None
                emitted = 0
                for tok in vec:
                    run.tokens.append(int(tok))
                    emitted += 1
                    if (req.stop_token is not None
                            and run.tokens[-1] == req.stop_token):
                        reason = "stop"
                        break
                    if len(run.tokens) >= req.max_new_tokens:
                        reason = "length"
                        break
                self._tokens_out += emitted
                self._decode_tokens += emitted
                if reason is None:
                    reason = self._finish_reason(run, t1)
                if reason is not None:
                    self._backend_release(s)
                    self._slots[s] = None
                    self._span("decode", run.first_token_at, t1,
                               self._req_id(run.ticket, run.request),
                               ctx=self._ctx(run.request),
                               tokens=len(run.tokens), outcome=reason)
                    self._retire(run, reason, t1)
        return sum(1 for s in self._slots if s is not None)

    def _peek_queued(self) -> _Queued | None:
        """The next request to admit, WITHOUT removing it (removal is
        ``_dequeue``, called only once admission commits — a
        block-starved request must stay queued in place). Starvation
        bound first: when the OLDEST queued request (FIFO head) has
        waited past ``starvation_s``, it goes next no matter its class.
        Otherwise lowest priority number wins; within a class, earliest
        deadline (EDF; deadline-less requests last); submit order breaks
        ties (rids are issued in submit order)."""
        now = self._clock()
        with self._lock:
            if not self._queue:
                return None
            if (
                self.starvation_s is not None
                and now - self._queue[0].submitted_at >= self.starvation_s
            ):
                return self._queue[0]
            return min(self._queue, key=lambda q: (
                q.request.priority,
                q.deadline_at if q.deadline_at is not None else float("inf"),
                q.ticket.rid,
            ))

    def _dequeue(self, q: _Queued) -> None:
        """Commit a peeked request's removal (only the tick thread ever
        removes, so the element is still present)."""
        with self._lock:
            try:
                self._queue.remove(q)
            except ValueError:  # pragma: no cover - single remover
                pass

    def _saturation_detail(self) -> str:
        """Why the system is not draining, for the 429 message: KV
        block availability when the backend pages its cache ('' for
        dense backends) — a client/operator reading the error learns
        whether the ceiling is slots or HBM."""
        kv_stats = getattr(self.backend, "kv_stats", None)
        if kv_stats is None:
            return ""
        try:
            kv = kv_stats()
        except Exception:  # pragma: no cover - defensive: message only
            return ""
        if not kv:
            return ""
        return (
            f"; KV blocks {kv['blocks_free']}/{kv['num_blocks']} free"
        )

    def _priority_hist(self, priority: int) -> Histogram:
        h = self.hist_queue_wait_by_priority.get(int(priority))
        if h is None:
            # first request of a class: insert under the lock — stats()
            # snapshots this dict from the HTTP threads, and an
            # unguarded insert mid-iteration is a RuntimeError there
            with self._lock:
                h = self.hist_queue_wait_by_priority.setdefault(
                    int(priority), Histogram()
                )
        return h

    def _req_id(self, ticket: Ticket, request: GenRequest) -> str:
        """The request's correlation id: client-supplied when present,
        else derived from the scheduler's rid — the SAME string lands in
        the result dict, the HTTP response, and the trace spans."""
        return request.request_id or f"req-{ticket.rid}"

    def _span(self, name: str, t0: float, t1: float, request_id: str,
              ctx=None, **args) -> None:
        if self.tracer is not None:
            self.tracer.record_span(
                name, t0, t1, ctx=ctx, request_id=request_id, **args
            )

    def _ctx(self, request: GenRequest) -> TraceContext | None:
        """A fresh span context for one of this request's phase spans,
        parented under the router's forwarded wire context. Each call
        mints a sibling (queued/prefill/decode sit side by side under
        the same forward span). None when untraced."""
        if self.tracer is None or not request.trace_context:
            return None
        wire = TraceContext.from_wire(request.trace_context)
        return wire.child() if wire is not None else None

    def _trace_id(self, request: GenRequest) -> str | None:
        """The SAMPLED trace id for exemplar attachment, else None —
        unsampled traces must not leak ids into the exposition."""
        if not request.trace_context:
            return None
        wire = TraceContext.from_wire(request.trace_context)
        return wire.trace_id if wire is not None and wire.sampled else None

    def _backend_release(self, slot: int) -> None:
        release = getattr(self.backend, "release", None)
        if release is not None:
            release(slot)

    def _finish_reason(self, run: _Running, now: float) -> str | None:
        req = run.request
        if req.stop_token is not None and run.tokens[-1] == req.stop_token:
            return "stop"
        if len(run.tokens) >= req.max_new_tokens:
            return "length"
        if run.ticket.cancelled:
            return "cancelled"
        if run.deadline_at is not None and now >= run.deadline_at:
            return "deadline"
        return None

    def _retire(self, run: _Running, reason: str, now: float) -> None:
        if reason == "cancelled":
            self._cancelled += 1
        else:
            self._served += 1
        self._finish(run.ticket, run.request, run.tokens, reason,
                     run.submitted_at, run.admitted_at, run.first_token_at,
                     now,
                     prefill_device_s=run.prefill_device_s,
                     decode_device_s=run.decode_device_s,
                     # blocks are allocated all-or-nothing at admission
                     # and constant until release — the block-seconds
                     # bill settles exactly here, at release time
                     kv_block_seconds=run.blocks_held * (now - run.admitted_at))

    def _finish(self, ticket: Ticket, request: GenRequest, tokens: list[int],
                reason: str, submitted_at: float, admitted_at: float | None,
                first_token_at: float | None, now: float,
                error: str | None = None,
                prefill_device_s: float = 0.0,
                decode_device_s: float = 0.0,
                kv_block_seconds: float = 0.0) -> None:
        result = {
            "rid": ticket.rid,
            "request_id": self._req_id(ticket, request),
            "tokens": list(tokens),
            "finish_reason": reason,
            # time spent WAITING for a slot (a never-admitted request
            # waited its whole life); ttft additionally includes prefill
            "queued_s": (
                (admitted_at if admitted_at is not None else now)
                - submitted_at
            ),
            "ttft_s": (
                first_token_at - submitted_at
                if first_token_at is not None else None
            ),
            "decode_s": (
                now - first_token_at if first_token_at is not None else 0.0
            ),
            "total_s": now - submitted_at,
            # attribution: THIS request's measured share of dispatch
            # seconds (prefill chunks billed whole, decode/verify ticks
            # apportioned by emitted positions) and its KV residency
            # bill (blocks x seconds held) — the per-request cost line
            "prefill_device_s": prefill_device_s,
            "decode_device_s": decode_device_s,
            "kv_block_seconds": kv_block_seconds,
        }
        if error is not None:
            result["error"] = error
        # per-class cost rollup (the billing/capacity counters): one
        # central accumulation point so every finish path — retire,
        # expiry mid-prefill, instant-finish — bills identically.
        # All-zero finishes (never-admitted drops) add nothing.
        if prefill_device_s or decode_device_s or kv_block_seconds:
            prio = int(request.priority)
            with self._lock:
                self._device_s_by_priority[prio] = (
                    self._device_s_by_priority.get(prio, 0.0)
                    + prefill_device_s + decode_device_s
                )
                if kv_block_seconds:
                    self._kv_block_s_by_priority[prio] = (
                        self._kv_block_s_by_priority.get(prio, 0.0)
                        + kv_block_seconds
                    )
        # black-box feed (obs/flightrec): one bounded event per request
        # outcome, so an engine-loop death dump shows the requests in
        # flight around the fatal tick. No-op without a recorder.
        flightrec.record_event(
            "serve_finish",
            request_id=result["request_id"], reason=reason,
            tokens=len(tokens),
            **({"error": error} if error else {}),
        )
        ticket.result = result
        ticket._event.set()

    # -- observability -------------------------------------------------------

    def queue_depth(self) -> int:
        """Cheap accessor for the serving loop's idle check."""
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        """Snapshot for the serve gauges. TTFT percentiles come from a
        rolling window of the last 512 admissions, by the standard
        nearest-rank definition (``nearest_rank_percentile``)."""
        with self._lock:
            depth = len(self._queue)
            ttft_snapshot = list(self._ttft)  # tick appends under the lock
            prio_hists = dict(self.hist_queue_wait_by_priority)
            ttft_by_prio = {
                p: list(dq) for p, dq in self._ttft_by_priority.items()
            }
            shed_by_prio = dict(self._shed_by_priority)
            device_s_by_prio = dict(self._device_s_by_priority)
            kv_block_s_by_prio = dict(self._kv_block_s_by_priority)
            ticks_with_pf = sorted(self._tick_with_prefill)
            ticks_no_pf = sorted(self._tick_no_prefill)
        ttft = sorted(ttft_snapshot)

        def pct(p: float) -> float | None:
            return nearest_rank_percentile(ttft, p)

        prefilling = [
            s for s in self._slots if isinstance(s, _Prefilling)
        ]
        out = {
            "queue_depth": depth,
            "slots_busy": sum(1 for s in self._slots if s is not None),
            "slots_prefilling": len(prefilling),
            # slots holding a prefilled stream awaiting KV export (the
            # disagg handoff window) + handoffs abandoned past the TTL
            "slots_parked": sum(
                1 for s in self._slots if isinstance(s, _Parked)
            ),
            "park_expired": self._park_expired,
            "slots_total": len(self._slots),
            # chunk backlog: how much staged prefill work is waiting for
            # tick interleave slots — the gauge that shows a long prompt
            # being fed through without stalling decode
            "prefill_chunks_pending": sum(p.chunks_left for p in prefilling),
            "prefill_chunks_total": self._prefill_chunks,
            "served": self._served,
            "rejected": self._rejected,
            "expired": self._expired,
            "cancelled": self._cancelled,
            "errors": self._errors,
            # the same five outcomes as ONE dict — the shape the serve
            # /metrics outcome family and the SLO error-rate rule
            # (obs/slo) consume, so the label set has a single source
            "requests_by_outcome": {
                "served": self._served,
                "rejected": self._rejected,
                "expired": self._expired,
                "cancelled": self._cancelled,
                "error": self._errors,
                # class-shed refusals are their OWN outcome, not folded
                # into "rejected": busy-rejections are capacity noise,
                # sheds are deliberate policy — an SLO error-rate rule
                # must be able to tell them apart
                "shed": sum(shed_by_prio.values()),
            },
            # class-aware overload shedding state: the ceiling and the
            # per-class shed counts (the honest 429 story — which
            # classes are being sacrificed, how often)
            "admission_max_priority": self._admission_max_priority,
            "shed_by_priority": {
                p: n for p, n in sorted(shed_by_prio.items())
            },
            # admission stalls split by cause: slots exhausted vs the
            # paged backend's KV block pool exhausted — the 429/backlog
            # diagnosis gauge pair
            "admission_blocked_no_slot": self._blocked_no_slot,
            "admission_blocked_no_blocks": self._blocked_no_blocks,
            "tokens_out": self._tokens_out,
            "decode_s": self._decode_s,
            # EMITTED decode tokens (multi-token speculative ticks
            # included), not ticks x slots — the rate a client actually
            # receives tokens at
            "decode_tokens": self._decode_tokens,
            "decode_tokens_per_sec": (
                self._decode_tokens / self._decode_s
                if self._decode_s > 0 else None
            ),
            "ttft_last_s": ttft_snapshot[-1] if ttft_snapshot else None,
            "ttft_p50_s": pct(0.50),
            "ttft_p95_s": pct(0.95),
            # per-class TTFT p95 (last 256 admissions of each class):
            # what the highest class's SLO rule watches while lower
            # classes shed
            "ttft_p95_by_priority": {
                p: nearest_rank_percentile(sorted(vals), 0.95)
                for p, vals in sorted(ttft_by_prio.items())
                if vals
            },
            # full distributions (cumulative-bucket form) for the
            # histogram families on /metrics
            "hist_ttft": self.hist_ttft.snapshot(),
            "hist_queue_wait": self.hist_queue_wait.snapshot(),
            "hist_decode_tick": self.hist_decode_tick.snapshot(),
            "hist_queue_wait_by_priority": {
                p: h.snapshot() for p, h in sorted(prio_hists.items())
            },
            # measured prefill dispatch seconds (chunk-billed; the
            # decode counterpart is decode_s above) — with decode_s,
            # the scheduler-level side of the reconciliation identity
            "prefill_device_s": self._prefill_s,
            # per-class cost counters: the billing and capacity-planning
            # rollup of per-request attribution (device-seconds consumed
            # and KV block-seconds held, by priority class)
            "device_seconds_by_priority": {
                p: round(v, 6) for p, v in sorted(device_s_by_prio.items())
            },
            "kv_block_seconds_by_priority": {
                p: round(v, 6) for p, v in sorted(kv_block_s_by_prio.items())
            },
        }
        # decode-tick interference: p50 tick time with vs without
        # staged prefill chunks pending — the DistServe-style
        # prefill/decode tier-split sizing signal (ROADMAP item 1). Two
        # scalars, not a histogram family: the ratio is the signal.
        p50_w = nearest_rank_percentile(ticks_with_pf, 0.50)
        p50_n = nearest_rank_percentile(ticks_no_pf, 0.50)
        if p50_w is not None:
            out["decode_tick_p50_with_prefill_s"] = p50_w
        if p50_n is not None:
            out["decode_tick_p50_no_prefill_s"] = p50_n
        if p50_w is not None and p50_n is not None and p50_n > 0:
            out["decode_interference_ratio"] = round(p50_w / p50_n, 4)
        # tensor-parallel degree (engines expose ``tp``; 1 = unsharded):
        # a gauge, so dashboards can tell a TP fleet member from a solo
        # replica without parsing flags. Fake/scripted backends without
        # the attribute simply omit the key.
        tp = getattr(self.backend, "tp", None)
        if tp is not None:
            out["tp_degree"] = int(tp)
        # hot-swap deployment state (fleet/): which weight generation
        # this replica serves, and whether it is draining for a push.
        # Fake/scripted backends without the attribute omit the key.
        out["draining"] = self._draining
        gen = getattr(self.backend, "deploy_generation", None)
        if gen is not None:
            out["deploy_generation"] = int(gen)
        prefix_stats = getattr(self.backend, "prefix_stats", None)
        if prefix_stats is not None:
            ps = prefix_stats()
            if ps is not None:
                out["prefix_cache"] = ps
        kv_stats = getattr(self.backend, "kv_stats", None)
        if kv_stats is not None:
            kv = kv_stats()
            if kv is not None:
                out["kv_pool"] = kv
        spec_stats = getattr(self.backend, "spec_stats", None)
        if spec_stats is not None:
            spec = spec_stats()
            if spec is not None:
                out["spec"] = spec
        # KV ship traffic (export/import requests, bytes, blocks,
        # seconds) — present only once a replica has actually shipped,
        # so non-disagg stats JSONLs are unchanged
        kvship_stats = getattr(self.backend, "kvship_stats", None)
        if kvship_stats is not None:
            ship = kvship_stats()
            if ship is not None:
                out["kvship"] = ship
        # per-program dispatch ledgers from the engine's accountant
        # (device/compile seconds by kind:bucket:layout) — fakes
        # without the accessor omit the key, same as spec/kv above
        devtime_stats = getattr(self.backend, "devtime_stats", None)
        if devtime_stats is not None:
            dt = devtime_stats()
            if dt is not None:
                out["devtime"] = dt
        return out
