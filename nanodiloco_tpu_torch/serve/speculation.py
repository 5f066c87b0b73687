"""Host-side draft proposer for speculative decoding: prompt-lookup.

A copy of ``nanodiloco_tpu/serve/speculation.py``, which is jax-free.

Prompt-lookup (n-gram) speculation needs no second model: the draft for
a request's next few tokens is the continuation of the most recent
earlier occurrence of its current n-gram tail, searched over the
request's OWN prompt + emitted output. Repetitive traffic — templated
prompts, few-shot scaffolds, code, and the self-repeating loops greedy
decoding falls into — pays off heavily; adversarial (random) traffic
simply produces no n-gram match and therefore no drafts, so the engine
falls back to the plain one-token tick with near-zero overhead. The
same premise vLLM-style engines exploit (arXiv:2309.06180 lineage);
model-free makes it a pure win before a draft model exists.

The proposer is pure host-side bookkeeping on the tick thread (the
engine calls it between compiled dispatches), so it must be cheap:
per-slot context lists plus an incremental hash index mapping every
(n, gram) to the END position of its most recent occurrence. Append is
O(ngram levels); propose is O(ngram levels) dict lookups. Nothing here
touches the device.

Acceptance feedback drives two independent adaptive controls. SIZING:
full acceptance nudges the request's draft length up toward ``max_k``,
a zero-accept tick halves it (floor 1). GATING: a rolling per-draft
acceptance EMA below ``ACCEPT_FLOOR`` stops the slot proposing at all
— verification widens the tick, and coincidental n-gram matches on
structureless traffic accept just often enough that a
reset-on-any-accept backoff would thrash forever instead of converging
to plain decode. Suppressed slots re-probe with one cheap draft on a
SHARED cadence (``new_tick``/``PROBE_PERIOD``) so recovery stays
possible without desynchronized probes re-widening every other tick.
Per-request opt-out is the engine's concern (``GenRequest.speculate``);
a slot that opted out is simply never registered here.
"""

from __future__ import annotations

__all__ = ["PromptLookupProposer"]


class PromptLookupProposer:
    """Per-slot prompt-lookup draft state. Lifecycle mirrors a slot's:
    ``begin`` at prefill completion (prompt + first token), ``propose``
    before each speculative tick, ``observe`` with the tick's emitted
    tokens, ``feedback`` with (proposed, accepted) for adaptive k,
    ``release`` when the slot retires. Single-threaded by design (the
    engine tick thread), like the block pool."""

    # a slot whose rolling per-draft acceptance falls below this stops
    # proposing: a draft only pays when its acceptance beats the
    # verify-widening overhead, and coincidental 1-gram matches on
    # structureless traffic accept ~1/top_k of the time — well below
    # break-even, but never zero, so a reset-on-any-accept backoff
    # would thrash forever instead of converging
    ACCEPT_FLOOR = 0.35
    EMA_DECAY = 0.7
    # suppressed slots re-probe with ONE draft on a shared cadence (all
    # suppressed slots probe on the SAME tick — desynchronized probes
    # would widen a verify tick every few ticks and re-create the
    # overhead the floor exists to kill)
    PROBE_PERIOD = 16
    # fresh streams ramp k up from here on success instead of opening
    # at max_k: a lookup-hostile stream's exploration then costs narrow
    # verify ticks, and a lookup-friendly one reaches max_k within
    # max_k - START_K fully-accepted ticks
    START_K = 2

    def __init__(self, max_k: int, max_ngram: int = 3) -> None:
        if max_k < 1:
            raise ValueError(f"max_k must be >= 1; got {max_k}")
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1; got {max_ngram}")
        self.max_k = int(max_k)
        self.max_ngram = int(max_ngram)
        self._ctx: dict[int, list[int]] = {}
        # per slot: (n, gram tuple) -> end position of the most recent
        # PREVIOUS occurrence. A gram is indexed only once at least one
        # token follows it, so the context's own tail is never returned
        # as its own (empty) continuation.
        self._index: dict[int, dict[tuple, int]] = {}
        self._cur_k: dict[int, int] = {}
        # per-slot rolling per-draft acceptance (optimistic start: a
        # fresh stream speculates immediately; structureless traffic
        # sinks below the floor within a few ticks)
        self._ema: dict[int, float] = {}
        self._clock = 0  # shared tick counter driving the probe cadence

    # -- slot lifecycle ------------------------------------------------------

    def begin(self, slot: int, prompt_ids, first_token: int) -> None:
        """Register a slot at prefill completion: context = prompt +
        the first sampled token, index built by replaying appends."""
        self._ctx[slot] = []
        self._index[slot] = {}
        self._cur_k[slot] = min(self.START_K, self.max_k)
        self._ema[slot] = 1.0
        self.observe(slot, list(prompt_ids) + [int(first_token)])

    def release(self, slot: int) -> None:
        self._ctx.pop(slot, None)
        self._index.pop(slot, None)
        self._cur_k.pop(slot, None)
        self._ema.pop(slot, None)

    def new_tick(self) -> None:
        """Advance the shared probe clock; the engine calls this once
        per decode tick, before asking any slot for drafts."""
        self._clock += 1

    # -- the draft loop ------------------------------------------------------

    def propose(self, slot: int, cap: int) -> list[int]:
        """Up to ``min(cap, adaptive k)`` draft tokens for ``slot``:
        the continuation of the most recent earlier occurrence of the
        longest matching n-gram tail (longest n wins — a 3-gram match
        is a far stronger signal than a 1-gram). Empty when nothing
        matches: no match, no speculation, no cost."""
        ctx = self._ctx.get(slot)
        if ctx is None:
            return []
        k = min(int(cap), self._cur_k[slot], self.max_k)
        if self._ema[slot] < self.ACCEPT_FLOOR:
            # suppressed: acceptance has not been paying for the verify
            # widening; re-probe with ONE cheap draft on the shared
            # cadence so a stream whose text turns repetitive recovers
            if self._clock % self.PROBE_PERIOD:
                return []
            k = min(k, 1)
        if k <= 0:
            return []
        idx = self._index[slot]
        for n in range(min(self.max_ngram, len(ctx)), 0, -1):
            end = idx.get((n, tuple(ctx[-n:])))
            if end is not None:
                avail = ctx[end:]
                # a RECENT match leaves fewer than k known continuation
                # tokens — cycle them: a greedy stream locked into a
                # period-p loop matches p tokens back, and wrapping
                # predicts the whole loop for any k (wrong wraps just
                # reject; the genuine prefix still accepts)
                return [avail[i % len(avail)] for i in range(k)]
        return []

    def observe(self, slot: int, emitted) -> None:
        """Append the tick's emitted tokens to the slot's context,
        indexing each gram the moment it gains a continuation."""
        ctx = self._ctx.get(slot)
        if ctx is None:
            return
        idx = self._index[slot]
        for tok in emitted:
            p = len(ctx)
            for n in range(1, self.max_ngram + 1):
                if p - n >= 0:
                    idx[(n, tuple(ctx[p - n:p]))] = p
            ctx.append(int(tok))

    def feedback(self, slot: int, proposed: int, accepted: int) -> None:
        """Adaptive draft budget: full acceptance grows the slot's k by
        one (capped at max_k), a zero-accept tick halves it (floor 1),
        partial acceptance holds steady. Independently, the rolling
        per-draft acceptance EMA decides whether the slot proposes AT
        ALL (see ``ACCEPT_FLOOR``): sizing and gating are separate —
        a stream can deserve short drafts without deserving none."""
        if slot not in self._cur_k or proposed <= 0:
            return
        rate = accepted / proposed
        self._ema[slot] = (
            self.EMA_DECAY * self._ema[slot] + (1.0 - self.EMA_DECAY) * rate
        )
        if accepted >= proposed:
            self._cur_k[slot] = min(self.max_k, self._cur_k[slot] + 1)
        elif accepted == 0:
            self._cur_k[slot] = max(1, self._cur_k[slot] // 2)

    def current_k(self, slot: int) -> int:
        """The slot's adaptive draft budget right now (tests + gauges)."""
        return self._cur_k.get(slot, 0)
