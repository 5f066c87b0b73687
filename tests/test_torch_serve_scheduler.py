"""The port's scheduler (nanodiloco_tpu_torch/serve/scheduler.py, a copy
of nanodiloco_tpu/serve/scheduler.py) under the JAX package's scheduler
tests, run unchanged against the port's imports.

Scheduler unit tests (nanodiloco_tpu/serve/scheduler): SLO-ordered
admission (priority classes, EDF, starvation bound), chunked-prefill
interleaving, slot refill mid-decode, EOS retirement, queue-full
backpressure, and deadline expiry — all against a scripted fake backend
and an injected clock. Deterministic, model-free, tier-1: no jax, no
new compiled programs (the admission-wire tests at the bottom use a
loopback ServeServer over the same fake backend)."""

import pytest

from nanodiloco_tpu_torch.serve.scheduler import (
    ClassShed,
    GenRequest,
    QueueFull,
    Scheduler,
)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeBackend:
    """Scripted slot backend speaking the chunked surface: each
    request's token stream comes from its seed (``scripts[seed]``);
    ``chunks[seed]`` (default 1) is how many ``prefill_step`` calls its
    prefill takes — the final one returns the first token. Records the
    call sequence so tests can assert scheduling decisions, not just
    outcomes."""

    def __init__(self, num_slots: int, scripts: dict[int, list[int]],
                 chunks: dict[int, int] | None = None) -> None:
        self.num_slots = num_slots
        self.scripts = scripts
        self.chunks = chunks or {}
        self.cursor: list[int] = [0] * num_slots
        self.seed_at: list[int | None] = [None] * num_slots
        self.pending: list[list | None] = [None] * num_slots
        self.log: list[tuple] = []

    def start_prefill(self, slot: int, request: GenRequest) -> int:
        n = self.chunks.get(request.seed, 1)
        self.log.append(("start", slot, request.seed))
        self.pending[slot] = [request.seed, n]
        return n

    def prefill_step(self, slot: int) -> int | None:
        seed, left = self.pending[slot]
        self.log.append(("chunk", slot, seed))
        left -= 1
        if left > 0:
            self.pending[slot][1] = left
            return None
        self.pending[slot] = None
        self.seed_at[slot] = seed
        self.cursor[slot] = 1
        return self.scripts[seed][0]

    def step(self) -> list[int]:
        self.log.append(("step", tuple(self.seed_at)))
        out = []
        for s in range(self.num_slots):
            seed = self.seed_at[s]
            if seed is None:
                out.append(-1)
                continue
            out.append(self.scripts[seed][self.cursor[s]])
            self.cursor[s] += 1
        return out

    def release(self, slot: int) -> None:
        self.log.append(("release", slot))
        self.seed_at[slot] = None
        self.pending[slot] = None


def _sched(num_slots=2, scripts=None, max_queue=4, clock=None, chunks=None,
           **kw):
    scripts = scripts or {}
    clock = clock or FakeClock()
    backend = FakeBackend(num_slots, scripts, chunks)
    return Scheduler(backend, max_queue=max_queue, clock=clock, **kw), \
        backend, clock


def _drain(sched, tickets, limit=50):
    for _ in range(limit):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            return
    raise AssertionError("scheduler did not drain")


# -- admission + continuous batching ------------------------------------------


def test_fifo_within_class_fills_free_slots_lowest_first():
    sched, backend, _ = _sched(
        scripts={1: [10, 11, 12], 2: [20, 21, 22], 3: [30, 31, 32]}
    )
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=3, seed=1))
    t2 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=3, seed=2))
    t3 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=3, seed=3))
    live = sched.tick()
    assert live == 2  # two slots, third request still queued
    assert [e for e in backend.log if e[0] == "start"][:2] == [
        ("start", 0, 1), ("start", 1, 2)
    ]
    assert sched.stats()["queue_depth"] == 1
    _drain(sched, (t1, t2, t3))
    assert t1.result["tokens"] == [10, 11, 12]
    assert t2.result["tokens"] == [20, 21, 22]
    assert t3.result["tokens"] == [30, 31, 32]
    assert all(t.result["finish_reason"] == "length" for t in (t1, t2, t3))


def test_slot_refill_mid_decode_no_stop_the_world():
    """Request C is admitted into A's freed slot while B is still
    decoding — B's stream never pauses and C's prefill chunk lands
    between decode steps (continuous batching, not batch barriers)."""
    sched, backend, _ = _sched(
        scripts={1: [10, 11], 2: [20, 21, 22, 23, 24], 3: [30, 31, 32]}
    )
    ta = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=1))
    tb = sched.submit(GenRequest(prompt=(5,), max_new_tokens=5, seed=2))
    sched.tick()  # admit A+B, A's chunk runs + A decodes once
    sched.tick()  # B's chunk runs; A finishes
    assert ta.done() and ta.result["tokens"] == [10, 11]
    assert not tb.done()
    tc = sched.submit(GenRequest(prompt=(5,), max_new_tokens=3, seed=3))
    start_idx = len(backend.log)
    sched.tick()  # C admitted into A's old slot while B decodes
    assert ("start", 0, 3) in backend.log
    # B stepped in EVERY tick from C's admission on, including the one
    # that ran C's prefill chunk — no stop-the-world
    steps = [e for e in backend.log[start_idx:] if e[0] == "step"]
    assert steps and all(2 in e[1] for e in steps)
    _drain(sched, (tb, tc))
    assert tc.result["tokens"] == [30, 31, 32]
    assert tb.result["tokens"] == [20, 21, 22, 23, 24]


def test_eos_retirement_frees_slot_and_truncates():
    sched, backend, _ = _sched(
        scripts={1: [10, 99, 12, 13], 2: [20, 21, 22]}, num_slots=1
    )
    t1 = sched.submit(
        GenRequest(prompt=(5,), max_new_tokens=4, seed=1, stop_token=99)
    )
    t2 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=3, seed=2))
    sched.tick()  # admit 1, chunk + step emits 99 -> retired
    assert t1.done()
    assert t1.result["tokens"] == [10, 99]
    assert t1.result["finish_reason"] == "stop"
    assert ("release", 0) in backend.log
    _drain(sched, (t2,))
    assert t2.result["tokens"] == [20, 21, 22]


def test_instant_stop_at_prefill_releases_the_slot():
    """First sampled token == stop_token: the request finishes at its
    final prefill chunk, its backend slot is RELEASED (an unreleased
    instant finish would keep decoding as a zombie and, under MoE,
    spend shared expert capacity), and the slot admits the next queued
    request on the following tick."""
    sched, backend, _ = _sched(
        scripts={1: [99], 2: [20, 21]}, num_slots=1
    )
    t1 = sched.submit(
        GenRequest(prompt=(5,), max_new_tokens=4, seed=1, stop_token=99)
    )
    t2 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=2))
    sched.tick()
    assert t1.done() and t1.result["finish_reason"] == "stop"
    assert backend.log[:3] == [
        ("start", 0, 1), ("chunk", 0, 1), ("release", 0)
    ]
    _drain(sched, (t2,))
    assert t2.done() and t2.result["tokens"] == [20, 21]


def test_queue_full_raises_and_counts_rejection():
    sched, _, _ = _sched(max_queue=2, scripts={1: [10]})
    sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1))
    sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1))
    with pytest.raises(QueueFull):
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1))
    assert sched.stats()["rejected"] == 1
    assert sched.stats()["queue_depth"] == 2


# -- SLO-aware admission ordering ---------------------------------------------


def test_priority_classes_admit_before_fifo_order():
    """A later-submitted priority-0 request takes the free slot ahead
    of earlier priority-1 and priority-2 traffic; within a class,
    submit order still holds."""
    sched, backend, _ = _sched(
        num_slots=1,
        scripts={1: [10], 2: [20], 3: [30], 4: [40]},
        starvation_s=None,
    )
    tickets = [
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1,
                                priority=2)),
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=2,
                                priority=1)),
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=3,
                                priority=0)),
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=4,
                                priority=1)),
    ]
    _drain(sched, tickets)
    order = [e[2] for e in backend.log if e[0] == "start"]
    assert order == [3, 2, 4, 1]  # class 0, then class 1 in FIFO, then 2


def test_edf_within_priority_class():
    """Within one class the earliest DEADLINE goes first, regardless of
    submit order; deadline-less requests sort after any deadline."""
    sched, backend, _ = _sched(
        num_slots=1, scripts={1: [10], 2: [20], 3: [30]},
        starvation_s=None,
    )
    tickets = [
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1)),
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=2,
                                deadline_s=50.0)),
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=3,
                                deadline_s=20.0)),
    ]
    _drain(sched, tickets)
    order = [e[2] for e in backend.log if e[0] == "start"]
    assert order == [3, 2, 1]
    assert all(t.result["finish_reason"] == "length" for t in tickets)


def test_starvation_bound_boosts_best_effort():
    """A best-effort request (priority 9) overtaken by a stream of
    priority-0 arrivals is admitted anyway once its wait crosses
    ``starvation_s`` — delayed, never starved."""
    clock = FakeClock()
    scripts = {k: [100 + k] for k in range(20)}
    sched, backend, clock = _sched(
        num_slots=1, scripts=scripts, clock=clock, max_queue=32,
        starvation_s=5.0,
    )
    tb = sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=0,
                                 priority=9))
    urgent = []
    # urgent arrivals keep coming; each tick serves one request fully
    for k in range(1, 8):
        urgent.append(sched.submit(
            GenRequest(prompt=(5,), max_new_tokens=1, seed=k, priority=0)
        ))
        clock.advance(1.0)
        sched.tick()
    order = [e[2] for e in backend.log if e[0] == "start"]
    # seed 0 was boosted once its wait reached 5s — BEFORE the later
    # urgent arrivals that would otherwise always outrank it
    assert 0 in order
    boosted_at = order.index(0)
    assert 0 < boosted_at < len(order) - 1
    assert tb.done() and tb.result["tokens"] == [100]


def test_pure_priority_starves_without_bound():
    """Contrast pin for the test above: with starvation_s=None the
    best-effort request never runs while urgent traffic keeps arriving."""
    clock = FakeClock()
    scripts = {k: [100 + k] for k in range(20)}
    sched, backend, clock = _sched(
        num_slots=1, scripts=scripts, clock=clock, max_queue=32,
        starvation_s=None,
    )
    tb = sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=0,
                                 priority=9))
    for k in range(1, 8):
        sched.submit(
            GenRequest(prompt=(5,), max_new_tokens=1, seed=k, priority=0)
        )
        clock.advance(1.0)
        sched.tick()
    assert not tb.done()
    assert 0 not in [e[2] for e in backend.log if e[0] == "start"]


# -- chunked prefill ----------------------------------------------------------


def test_long_prefill_interleaves_with_decode():
    """One chunk per tick: a 5-chunk prompt admits while another
    request decodes, and the decoder advances on EVERY tick of the long
    prefill — the stall chunked prefill exists to remove."""
    sched, backend, _ = _sched(
        scripts={1: [10, 11, 12, 13, 14, 15, 16, 17],
                 2: [20, 21]},
        chunks={2: 5},
    )
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=8, seed=1))
    sched.tick()  # 1 decoding
    t2 = sched.submit(GenRequest(prompt=(5,) * 50, max_new_tokens=2, seed=2))
    for _ in range(5):
        sched.tick()
    # every tick while 2 prefilled also stepped 1's decode
    chunk_ticks = [i for i, e in enumerate(backend.log) if e[0] == "chunk"
                   and e[2] == 2]
    steps = [i for i, e in enumerate(backend.log) if e[0] == "step"]
    assert len(chunk_ticks) == 5
    for c in chunk_ticks[:-1]:
        assert any(s > c for s in steps), "decode stalled behind prefill"
    _drain(sched, (t1, t2))
    assert t1.result["tokens"] == [10, 11, 12, 13, 14, 15, 16, 17]
    assert t2.result["tokens"] == [20, 21]


def test_short_prefill_jumps_long_prefill_srpt():
    """Shortest-remaining-first chunk scheduling: a 1-chunk short
    admitted while a 10-chunk long is mid-prefill gets the very next
    chunk slot — its TTFT is bounded by ~one tick, not the long
    prompt's remaining chunks."""
    sched, backend, _ = _sched(
        scripts={1: [10, 11], 2: [20, 21]},
        chunks={1: 10, 2: 1},
    )
    tl = sched.submit(GenRequest(prompt=(5,) * 100, max_new_tokens=2, seed=1))
    sched.tick()  # long admitted, chunk 1/10
    sched.tick()  # chunk 2/10
    ts = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=2))
    sched.tick()  # short admitted; SRPT: ITS chunk runs, not the long's
    chunk_seeds = [e[2] for e in backend.log if e[0] == "chunk"]
    assert chunk_seeds[:3] == [1, 1, 2]
    # the short's whole life fit in ONE tick (chunk -> first token ->
    # decode step) while the long still has 8 chunks to go
    assert ts.done() and ts.result["tokens"] == [20, 21]
    assert not tl.done()
    _drain(sched, (tl, ts))
    assert tl.result["tokens"] == [10, 11]


def test_aging_bounds_srpt_long_prefill_starvation():
    """SRPT alone would starve a long prefill under a steady stream of
    one-chunk shorts (every fresh short outranks it each tick); the
    aging bound caps the bypass streak, so the long request is delayed
    but completes. Contrast half: the chunk it takes every
    ``prefill_aging_ticks+1`` ticks barely moves short latency."""
    scripts = {0: [50, 51]}
    scripts.update({k: [100 + k] for k in range(1, 40)})
    sched, backend, _ = _sched(
        num_slots=2, scripts=scripts, max_queue=64,
        chunks={0: 6}, prefill_aging_ticks=3,
    )
    tl = sched.submit(GenRequest(prompt=(5,) * 60, max_new_tokens=2, seed=0))
    sched.tick()  # long admitted alone: its chunk 1/6 runs
    shorts = []
    for k in range(1, 25):  # one fresh 1-chunk short EVERY tick
        shorts.append(sched.submit(
            GenRequest(prompt=(5,), max_new_tokens=1, seed=k)
        ))
        sched.tick()
        if tl.done():
            break
    assert tl.done(), "long prefill starved behind the short stream"
    assert tl.result["tokens"] == [50, 51]
    # the long's chunks were interleaved at the aging cadence: never
    # more than prefill_aging_ticks shorts between two long chunks
    long_chunk_idx = [i for i, e in enumerate(backend.log)
                      if e[0] == "chunk" and e[2] == 0]
    gaps = [b - a for a, b in zip(long_chunk_idx, long_chunk_idx[1:])]
    assert gaps and max(gaps) <= 4 * (3 + 1)  # bounded, not unbounded
    # shorts kept flowing throughout (no inversion into long-first):
    # each aged tick defers at most one short, so at most one pending
    # short per long chunk taken during the stream (5) plus the
    # final-tick arrival
    assert sum(1 for t in shorts if t.done()) >= len(shorts) - 6


def test_bad_queue_head_does_not_cost_a_free_slot():
    """A ValueError pop (invalid request at the queue head) retries the
    SAME free slot with the next queued request in the same tick — a
    dud must not forfeit a viable request's admission tick."""

    class Exploding(FakeBackend):
        def start_prefill(self, slot, request):
            if request.seed == 13:
                raise ValueError("bad request")
            return super().start_prefill(slot, request)

    backend = Exploding(1, {1: [10, 11]})
    sched = Scheduler(backend, max_queue=8, clock=FakeClock())
    bad = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=13))
    good = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=1))
    sched.tick()  # bad errors AND good admits+completes, one tick
    assert bad.done() and bad.result["finish_reason"] == "error"
    assert good.done() and good.result["tokens"] == [10, 11]


def test_deadline_expires_mid_chunked_prefill():
    """A deadline passing BETWEEN chunks retires the request with the
    usual empty-output expiry and frees the slot (mid-prefill must not
    be a deadline blind spot)."""
    clock = FakeClock()
    sched, backend, clock = _sched(
        num_slots=1, scripts={1: [10], 2: [20, 21]},
        chunks={1: 10}, clock=clock,
    )
    t1 = sched.submit(GenRequest(prompt=(5,) * 100, max_new_tokens=1, seed=1,
                                 deadline_s=1.0))
    sched.tick()  # admitted, chunk 1/10
    sched.tick()  # chunk 2/10
    clock.advance(2.0)  # deadline passes mid-prefill
    sched.tick()
    assert t1.done()
    assert t1.result["finish_reason"] == "deadline"
    assert t1.result["tokens"] == []
    assert ("release", 0) in backend.log
    assert sched.stats()["expired"] == 1
    # the slot is genuinely free: the next request admits and completes
    t2 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=2))
    _drain(sched, (t2,))
    assert t2.result["tokens"] == [20, 21]


def test_cancel_mid_chunked_prefill_frees_slot():
    sched, backend, _ = _sched(
        num_slots=1, scripts={1: [10]}, chunks={1: 10},
    )
    t1 = sched.submit(GenRequest(prompt=(5,) * 100, max_new_tokens=1, seed=1))
    sched.tick()
    sched.tick()
    t1.cancel()
    sched.tick()
    assert t1.done()
    assert t1.result["finish_reason"] == "cancelled"
    assert t1.result["tokens"] == []
    assert ("release", 0) in backend.log
    assert sched.stats()["cancelled"] == 1


def test_prefill_chunk_stats():
    sched, backend, _ = _sched(
        num_slots=2, scripts={1: [10], 2: [20]}, chunks={1: 4, 2: 2},
    )
    sched.submit(GenRequest(prompt=(5,) * 40, max_new_tokens=1, seed=1))
    sched.submit(GenRequest(prompt=(5,) * 20, max_new_tokens=1, seed=2))
    sched.tick()  # both admitted; one chunk ran (SRPT: seed 2)
    s = sched.stats()
    assert s["slots_prefilling"] == 2
    assert s["prefill_chunks_total"] == 1
    assert s["prefill_chunks_pending"] == 4 + 2 - 1
    for _ in range(8):
        sched.tick()
    s = sched.stats()
    assert s["prefill_chunks_pending"] == 0
    assert s["prefill_chunks_total"] == 6


def test_prefix_stats_passthrough():
    """A backend exposing ``prefix_stats`` (the engine's prefix cache)
    surfaces it verbatim in the scheduler stats; one without stays
    absent."""
    sched, backend, _ = _sched(scripts={})
    assert "prefix_cache" not in sched.stats()
    backend.prefix_stats = lambda: {"hits": 3, "misses": 1}
    assert sched.stats()["prefix_cache"] == {"hits": 3, "misses": 1}


# -- deadlines / cancellation (queued + decoding) -----------------------------


def test_queued_deadline_expires_before_a_slot_is_held():
    clock = FakeClock()
    sched, backend, clock = _sched(
        num_slots=1, scripts={1: [10, 11, 12, 13, 14], 2: [20, 21]},
        clock=clock,
    )
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=5, seed=1))
    sched.tick()  # request 1 takes the only slot
    t2 = sched.submit(
        GenRequest(prompt=(5,), max_new_tokens=2, seed=2, deadline_s=1.0)
    )
    sched.tick()  # 2 waits queued (EDF can't preempt a held slot)
    clock.advance(2.0)  # past request 2's deadline while still queued
    sched.tick()
    assert t2.done()
    assert t2.result["finish_reason"] == "deadline"
    assert t2.result["tokens"] == []
    assert not any(e == ("start", 0, 2) for e in backend.log)
    assert sched.stats()["expired"] == 1
    _drain(sched, (t1,))
    assert t1.result["tokens"] == [10, 11, 12, 13, 14]


def test_running_deadline_retires_with_partial_output():
    clock = FakeClock()
    sched, _, clock = _sched(
        num_slots=1, scripts={1: [10, 11, 12, 13, 14, 15]}, clock=clock
    )
    t1 = sched.submit(
        GenRequest(prompt=(5,), max_new_tokens=6, seed=1, deadline_s=1.5)
    )
    sched.tick()   # prefill + 1 step: [10, 11]
    clock.advance(2.0)
    sched.tick()   # one more step lands, then the deadline retires it
    assert t1.done()
    assert t1.result["finish_reason"] == "deadline"
    assert t1.result["tokens"] == [10, 11, 12]
    assert sched.stats()["slots_busy"] == 0


def test_cancel_queued_request_never_takes_a_slot():
    sched, backend, _ = _sched(
        num_slots=1, scripts={1: [10, 11, 12], 2: [20, 21]}
    )
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=3, seed=1))
    t2 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=2))
    sched.tick()  # 1 holds the slot, 2 queued
    t2.cancel()
    for _ in range(4):
        sched.tick()
    assert t2.result["finish_reason"] == "cancelled"
    assert t2.result["tokens"] == []
    assert not any(e == ("start", 0, 2) for e in backend.log)
    assert t1.result["tokens"] == [10, 11, 12]
    assert sched.stats()["cancelled"] == 1


def test_cancel_running_request_retires_with_partial_output():
    sched, backend, _ = _sched(
        num_slots=1, scripts={1: [10, 11, 12, 13, 14, 15]}
    )
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=6, seed=1))
    sched.tick()  # prefill + one step: [10, 11]
    t1.cancel()
    sched.tick()  # one more token lands, then the cancel retires it
    assert t1.done()
    assert t1.result["finish_reason"] == "cancelled"
    assert t1.result["tokens"] == [10, 11, 12]
    assert ("release", 0) in backend.log
    assert sched.stats()["slots_busy"] == 0


def test_queued_s_measures_wait_not_prefill():
    """queued_s is the time WAITING for a slot (submit -> admission);
    ttft_s additionally includes the prefill — with a clock that steps
    on every observation the two must differ."""

    class SteppingClock(FakeClock):
        def __call__(self) -> float:
            self.t += 0.5
            return self.t

    sched, _, _ = _sched(num_slots=1, scripts={1: [10, 11]},
                         clock=SteppingClock())
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=1))
    sched.tick()
    assert t1.done()
    assert t1.result["queued_s"] < t1.result["ttft_s"]


def test_prefill_error_fails_one_request_not_the_loop():
    class Exploding(FakeBackend):
        def start_prefill(self, slot, request):
            if request.seed == 13:
                raise ValueError("prompt too long for the engine")
            return super().start_prefill(slot, request)

    backend = Exploding(1, {1: [10, 11]})
    sched = Scheduler(backend, max_queue=4, clock=FakeClock())
    bad = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=13))
    good = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=1))
    sched.tick()
    assert bad.done() and bad.result["finish_reason"] == "error"
    assert "too long" in bad.result["error"]
    for _ in range(3):
        sched.tick()
    assert good.done() and good.result["tokens"] == [10, 11]
    assert sched.stats()["errors"] == 1


def test_ttft_percentiles_use_nearest_rank():
    """Pin the nearest-rank percentile (smallest value with at least
    ceil(p*n) observations at or below it): the old ``int(p*len)``
    index read p50 of two samples as the LARGER one and p95 of twenty
    as the max."""
    sched, _, _ = _sched(scripts={})
    sched._ttft.extend([1.0, 2.0])
    s = sched.stats()
    assert s["ttft_p50_s"] == 1.0          # was 2.0 under int(p*n)
    sched._ttft.clear()
    sched._ttft.extend([float(i) for i in range(1, 21)])  # 1..20
    s = sched.stats()
    assert s["ttft_p50_s"] == 10.0         # ceil(.5*20)=10 -> 10th value
    assert s["ttft_p95_s"] == 19.0         # ceil(.95*20)=19 -> 19th, not max
    sched._ttft.clear()
    sched._ttft.extend([3.0])
    s = sched.stats()
    assert s["ttft_p50_s"] == 3.0 and s["ttft_p95_s"] == 3.0


def test_request_spans_and_histograms():
    """Per-request observability: queued/prefill/decode spans land on
    the injected tracer with the request's correlation id, the prefill
    span counts its chunks, and the TTFT / queue-wait (overall AND
    per-priority) / per-tick-decode histograms fill with correct
    cumulative buckets."""
    from nanodiloco_tpu_torch.obs.tracer import SpanTracer

    clock = FakeClock()
    tracer = SpanTracer(clock=clock)  # SAME clock as the scheduler
    backend = FakeBackend(1, {1: [10, 11, 12], 2: [20, 21]}, {1: 2})
    sched = Scheduler(backend, max_queue=4, clock=clock, tracer=tracer)
    t1 = sched.submit(GenRequest(prompt=(5, 6), max_new_tokens=3, seed=1,
                                 request_id="client-abc", priority=0))
    t2 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=2))
    for _ in range(8):
        clock.advance(0.25)
        sched.tick()
    assert t1.done() and t2.done()
    # the client-supplied id is echoed; the scheduler derives one
    # (from its rid) when the client sent none
    assert t1.result["request_id"] == "client-abc"
    assert t2.result["request_id"] == f"req-{t2.rid}"
    by_name: dict[str, list] = {}
    for e in tracer.events:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == {"queued", "prefill", "decode"}
    assert len(by_name["queued"]) == 2 and len(by_name["prefill"]) == 2
    span_ids = {e["args"]["request_id"] for e in by_name["decode"]}
    assert span_ids == {"client-abc", f"req-{t2.rid}"}
    assert by_name["prefill"][0]["args"]["prompt_tokens"] == 2
    assert by_name["prefill"][0]["args"]["chunks"] == 2
    # histograms: 2 admissions, every decode tick observed
    s = sched.stats()
    assert s["hist_ttft"]["count"] == 2
    assert s["hist_queue_wait"]["count"] == 2
    # per-priority split: one admission each in class 0 and class 1
    assert set(s["hist_queue_wait_by_priority"]) == {0, 1}
    assert s["hist_queue_wait_by_priority"][0]["count"] == 1
    assert s["hist_queue_wait_by_priority"][1]["count"] == 1
    ticks = len([e for e in backend.log if e[0] == "step"])
    assert s["hist_decode_tick"]["count"] == ticks
    # cumulative-bucket invariants: monotone, +Inf bucket == count
    buckets = s["hist_ttft"]["buckets"]
    cums = [c for _, c in buckets]
    assert cums == sorted(cums)
    assert buckets[-1] == ("+Inf", 2)
    assert s["hist_ttft"]["sum"] > 0


def test_class_shed_refuses_above_ceiling_terminally():
    """Overload shedding, not backpressure: a request whose class is
    above the admission ceiling raises ``ClassShed`` (a ``QueueFull``
    subclass carrying the sacrificed class and the ceiling), counts
    under its OWN outcome — never folded into busy rejections — and a
    request at the ceiling still admits."""
    sched, backend, _ = _sched(num_slots=1, scripts={1: [10]})
    assert sched.admission_max_priority == 9
    assert sched.set_admission_max_priority(2) == 2
    with pytest.raises(ClassShed) as exc:
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1,
                                priority=5))
    assert isinstance(exc.value, QueueFull)       # one except-arm upstream
    assert exc.value.shed_class == 5 and exc.value.max_priority == 2
    t = sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1,
                                priority=2))
    _drain(sched, (t,))
    s = sched.stats()
    assert s["shed_by_priority"] == {5: 1}
    assert s["requests_by_outcome"]["shed"] == 1
    assert s["rejected"] == 0                     # sheds are not "rejected"
    assert s["admission_max_priority"] == 2
    # -1 is the full stop: even class 0 sheds (unlike drain, the client
    # gets the honest body, not a readiness flip)
    sched.set_admission_max_priority(-1)
    with pytest.raises(ClassShed):
        sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1,
                                priority=0))


def test_set_admission_max_priority_validates():
    sched, _, _ = _sched(scripts={})
    for bad in (10, -2, "3", True, None, 2.0):
        with pytest.raises(ValueError):
            sched.set_admission_max_priority(bad)
    assert sched.admission_max_priority == 9      # bad sets changed nothing


def test_ttft_p95_split_by_priority_class():
    """The per-class TTFT percentiles exist so the protected class's
    latency is visible SEPARATELY while lower classes shed — a blended
    p95 would hide exactly the number the SLO rule watches."""

    class SteppingClock(FakeClock):
        def __call__(self) -> float:
            self.t += 0.25
            return self.t

    sched, _, _ = _sched(num_slots=2, scripts={1: [10], 2: [20]},
                         clock=SteppingClock())
    t0 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=1,
                                 priority=0))
    t3 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=1, seed=2,
                                 priority=3))
    _drain(sched, (t0, t3))
    by_prio = sched.stats()["ttft_p95_by_priority"]
    assert set(by_prio) == {0, 3}
    assert all(v > 0 for v in by_prio.values())


def test_admission_ceiling_and_shed_429_over_the_wire():
    """The wire half of the shed contract: /admin/admission sets the
    ceiling, a shed /v1/generate answers 429 with the explicit
    ``shed: true`` body (the fleet router's terminal-vs-retry pivot),
    and /metrics exposes ceiling + per-class shed counters."""
    from nanodiloco_tpu_torch.serve import ServeServer, http_get, http_post_json

    sched, _, _ = _sched(num_slots=1, scripts={1: [10, 11]})
    server = ServeServer(sched, port=0, host="127.0.0.1").start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, out = http_post_json(base + "/admin/admission",
                                   {"max_priority": 0})
        assert code == 200 and out["max_priority"] == 0
        code, out = http_post_json(base + "/v1/generate", {
            "token_ids": [5], "max_new_tokens": 2, "seed": 1,
            "priority": 3, "stop": False,
        })
        assert code == 429
        assert out["shed"] is True and out["shed_class"] == 3
        assert out["max_priority"] == 0
        # the admitted class still serves
        code, out = http_post_json(base + "/v1/generate", {
            "token_ids": [5], "max_new_tokens": 2, "seed": 1,
            "priority": 0, "stop": False,
        })
        assert code == 200 and out["token_ids"] == [10, 11]
        m = http_get(base + "/metrics")[1]
        assert "nanodiloco_serve_admission_max_priority 0" in m
        assert 'nanodiloco_serve_shed_total{priority="3"} 1' in m
        assert 'nanodiloco_serve_requests_total{outcome="shed"} 1' in m
        assert 'nanodiloco_serve_class_ttft_p95_seconds{priority="0"}' in m
        # invalid ceilings are 400s, and the running value is untouched
        for bad in (10, "3", None):
            code, out = http_post_json(base + "/admin/admission",
                                       {"max_priority": bad})
            assert code == 400
        assert sched.admission_max_priority == 0
    finally:
        server.stop()


def test_stats_timing_uses_injected_clock():
    class SteppingClock(FakeClock):
        def __call__(self) -> float:
            self.t += 0.5  # every observation advances half a second
            return self.t

    sched, _, _ = _sched(num_slots=1, scripts={1: [10, 11]},
                         clock=SteppingClock())
    t1 = sched.submit(GenRequest(prompt=(5,), max_new_tokens=2, seed=1))
    sched.tick()
    assert t1.done()
    s = sched.stats()
    assert s["served"] == 1
    assert s["ttft_last_s"] is not None and s["ttft_last_s"] > 0
    assert s["decode_s"] == pytest.approx(0.5)
    assert s["decode_tokens_per_sec"] == pytest.approx(2.0)
    assert t1.result["ttft_s"] == pytest.approx(s["ttft_last_s"])
    assert t1.result["total_s"] > t1.result["ttft_s"]
