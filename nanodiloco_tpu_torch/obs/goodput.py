"""Goodput ledger: attribute EVERY wall-clock second of a run to a cause.

A copy of ``nanodiloco_tpu/obs/goodput.py``'s training half (the JAX
package's ``__init__`` imports jax, so the port keeps its own): the
closed cause set, ``GoodputLedger``, which the train loop opens first
and snapshots into the JSONL once per round and once at teardown, and
``stitch_goodput_records``, which ``report goodput`` and
``summarize_run`` use to fold the per-lifetime snapshots of a
(restart-appended) JSONL into one run-level ledger; and the fleet's
state set (``FLEET_STATE_CAUSES``), the bucket names of the fleet
router's replica-second ledger.

Accounting contract: ``sum(cause seconds) == elapsed wall-clock``
exactly, by construction (attributed phase seconds are clamped to the
window they were observed in, the remainder is ``other`` or a
caller-chosen residual cause); seconds that passed while no process
existed (the supervisor's relaunch gap) are booked as
``restart_downtime``; the ledger is host-side observation only. In the
port, the first round's compute is ``compile_warmup``: it holds the
kernels' first-use build and cuBLAS's first heuristics.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Iterable

#: The closed cause set. ``compute`` is the only goodput cause — every
#: other bucket is badput an operator can act on.
CAUSES = (
    "compute",            # inner steps actually producing tokens
    "outer_sync",         # sync path / async residual apply-wait
    "compile_warmup",     # first-dispatch compiles + measure-comm probes
    "checkpoint",         # save path on the training thread
    "data_wait",          # the loop blocked on batch assembly
    "eval",               # held-out eval + MoE probes
    "resume_restore",     # checkpoint restore at startup
    "stall",              # watchdog-attributed dead time
    "straggler_wait",     # measured wait on a slow worker (elastic DiLoCo)
    "restart_downtime",   # supervisor relaunch gap (no process existed)
    "other",              # startup/logging/unattributed residual
)

#: The closed cause set for FLEET goodput (the serving twin of
#: ``CAUSES``): every replica-second the fleet router tracks lands in
#: exactly one of these buckets (``fleet/router.py`` imports this tuple
#: as its bucket names — one source of truth, so the autoscaler cannot
#: invent a state the accounting silently drops). ``serving_ready`` is
#: the only goodput bucket; ``scaling_up``/``scaling_down`` book the
#: autoscaler's transition seconds explicitly.
FLEET_STATE_CAUSES = (
    "serving_ready",      # probed ready: usable serving capacity
    "serving_unready",    # alive but failing probes (compile, overload)
    "draining",           # admission stopped for a weight push
    "ejected",            # ejected after repeated probe failures
    "scaling_up",         # launched by the autoscaler, not yet ready
    "scaling_down",       # retiring: drain -> remove in progress
    "breaker_open",       # circuit breaker open/half-open: gray failure
)


#: tracer depth-0 span name -> cause. ``t_``-prefixed JSONL keys map
#: through the same table (``observe_phases`` strips the prefix).
PHASE_CAUSE = {
    "inner": "compute",
    "sync": "outer_sync",
    "ckpt": "checkpoint",
    "data": "data_wait",
    "eval": "eval",
    "restore": "resume_restore",
    "comm_probe": "compile_warmup",  # extra compile + throwaway rounds
    # the per-round straggler wait the train loop splits OUT of the
    # inner span (t_straggler in the round budget): healthy workers'
    # seconds spent on the slowest island, attributed — never silently
    # inflating compute or outer_sync
    "straggler": "straggler_wait",
    "cost_analysis": "other",
    "log": "other",
    # the injected stall the train loop splits out of the data wait
    # (the prefetch thread slept it): watchdog-attributable dead time
    "stall": "stall",
}


class GoodputLedger:
    """Per-process-lifetime wall-clock partition. ``clock`` is a
    monotonic seconds source (tests inject a fake); ``wall`` stamps
    snapshots with absolute time. ``lifetime`` is the supervisor's
    restart ordinal, the key ``stitch_goodput_records`` groups by."""

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        wall: Callable[[], float] = time.time,
        lifetime: int = 0,
    ) -> None:
        self._clock = clock
        self._wall = wall
        self.lifetime = int(lifetime)
        # stamped into every snapshot: the stitcher's discriminator
        # between two PROCESSES that share a lifetime ordinal (the
        # supervisor's restart count resets per invocation)
        self._pid = os.getpid()
        self._t0: float | None = None
        self._attributed: dict[str, float] = {c: 0.0 for c in CAUSES}
        # seconds that happened OUTSIDE this process's clock (the
        # supervisor's relaunch gap): they extend elapsed as well as
        # their cause, so the partition includes time no process saw
        self._external = 0.0
        self._tokens = 0

    def start(self) -> "GoodputLedger":
        """Open the ledger window (idempotent — the first call wins, so
        'as early in the process as possible' is safe to call twice)."""
        if self._t0 is None:
            self._t0 = self._clock()
        return self

    def note(self, cause: str, seconds: float) -> None:
        """Attribute ``seconds`` of this lifetime's elapsed wall-clock
        to ``cause``."""
        if cause not in self._attributed:
            raise ValueError(f"unknown goodput cause {cause!r}; use one of {CAUSES}")
        self._attributed[cause] += max(0.0, float(seconds))

    def book_external(self, cause: str, seconds: float) -> None:
        """Attribute seconds that elapsed while THIS process did not
        exist (the supervisor's relaunch gap, handed down via the
        downtime env var): they extend the ledger's elapsed total too —
        downtime is part of the run's wall-clock even though no clock of
        ours was running."""
        s = max(0.0, float(seconds))
        self.note(cause, s)
        self._external += s

    def observe_phases(
        self, phases: dict[str, float], warmup: bool = False
    ) -> None:
        """Fold one round's phase budget into the ledger. Accepts both
        raw tracer names (``inner``) and JSONL keys (``t_inner``);
        unknown phases land in ``other`` — a new span name must never
        silently vanish from the partition. ``warmup=True`` routes
        compute-destined seconds to ``compile_warmup`` instead: the
        first dispatch of each program carries its XLA compile, and
        calling that round "compute" would flatter the fraction."""
        for key, v in phases.items():
            if not isinstance(v, (int, float)) or v is None:
                continue
            name = key[2:] if key.startswith("t_") else key
            cause = PHASE_CAUSE.get(name, "other")
            if warmup and cause == "compute":
                cause = "compile_warmup"
            self.note(cause, v)

    def add_tokens(self, n: int) -> None:
        """Tokens produced this lifetime (the numerator of
        tokens-per-wall-clock-second-including-restarts)."""
        self._tokens += int(n)

    # -- snapshots -----------------------------------------------------------

    def elapsed_s(self) -> float:
        self.start()
        return (self._clock() - self._t0) + self._external

    def snapshot(
        self, final: bool = False, residual_cause: str = "other"
    ) -> dict[str, Any]:
        """The running ledger record (cumulative for this lifetime):
        per-cause seconds with the unattributed residual folded into
        ``residual_cause`` (``other`` normally; a watchdog-stall exit
        books its dead tail as ``stall``), elapsed, goodput fraction,
        tokens. The returned causes PARTITION elapsed exactly. When
        attribution overshoots elapsed (sub-ms clock skew between the
        tracer's clock and ours), causes are scaled down to fit — the
        partition property holds in both directions."""
        elapsed = self.elapsed_s()
        causes = {c: self._attributed[c] for c in CAUSES}
        attributed = sum(causes.values())
        residual = elapsed - attributed
        if residual >= 0:
            causes[residual_cause] += residual
        elif attributed > 0:
            scale = elapsed / attributed
            causes = {c: v * scale for c, v in causes.items()}
        rec: dict[str, Any] = {
            "lifetime": self.lifetime,
            "pid": self._pid,
            "elapsed_s": round(elapsed, 6),
            "tokens": self._tokens,
            "t_unix": round(self._wall(), 3),
        }
        for c in CAUSES:
            rec[f"{c}_s"] = round(causes[c], 6)
        rec["goodput_fraction"] = round(
            causes["compute"] / elapsed, 6
        ) if elapsed > 0 else None
        if elapsed > 0:
            rec["tokens_per_wall_s"] = round(self._tokens / elapsed, 3)
        if final:
            rec["final"] = True
        return rec


def stitch_goodput_records(records: Iterable[dict]) -> dict[str, Any] | None:
    """Fold the ``goodput`` snapshots of a (restart-appended) JSONL into
    ONE run-level ledger: the LAST snapshot of each process lifetime
    stands for that lifetime (snapshots are cumulative; a crashed
    lifetime's last snapshot is everything it managed to record), cause
    seconds and tokens sum across lifetimes, and the merged fraction is
    compute / total elapsed — restarts included, because each resumed
    lifetime booked its relaunch gap as ``restart_downtime``.

    Lifetimes are segmented by JSONL ORDER, not keyed by the ordinal
    alone: the supervisor's restart ordinal resets to 0 on every
    ``supervise`` invocation, so a run supervised twice appends two
    ``lifetime: 0`` series to one file — a new segment starts whenever
    the ordinal changes, the writing PROCESS changes (the ``pid`` each
    snapshot carries — the only discriminator when a fresh process's
    first compile-heavy round makes its elapsed overtake the previous
    invocation's), or — for pid-less older records — the cumulative
    ``elapsed_s`` goes backwards. Keying by ordinal would silently drop
    the first invocation's seconds from the "honest end-to-end" number.
    Returns None when no snapshot exists (an older JSONL — consumers
    must tolerate runs that predate the ledger)."""
    segments: list[dict] = []
    cur: dict | None = None
    for r in records:
        g = r.get("goodput") if isinstance(r, dict) else None
        if not (isinstance(g, dict)
                and isinstance(g.get("elapsed_s"), (int, float))):
            continue
        try:
            life = int(g.get("lifetime", 0))
        except (TypeError, ValueError):
            life = 0
        pid = g.get("pid")
        same_segment = (
            cur is not None
            and life == cur["_life"]
            # cumulative elapsed must be monotone within one process...
            and float(g["elapsed_s"]) >= cur["elapsed_s"]
            # ...and a pid change splits even when a fresh process's
            # compile-heavy first round overtakes the previous
            # invocation's elapsed (pid-less older records keep the
            # elapsed heuristic alone)
            and not (
                pid is not None and cur.get("pid") is not None
                and pid != cur.get("pid")
            )
        )
        if same_segment:
            segments[-1] = cur = {**g, "_life": life}
        else:
            cur = {**g, "_life": life}
            segments.append(cur)
    if not segments:
        return None
    causes = {c: 0.0 for c in CAUSES}
    elapsed = 0.0
    tokens = 0
    for g in segments:
        elapsed += float(g["elapsed_s"])
        tokens += int(g.get("tokens") or 0)
        for c in CAUSES:
            v = g.get(f"{c}_s")
            if isinstance(v, (int, float)):
                causes[c] += float(v)
    out: dict[str, Any] = {
        "lifetimes": len(segments),
        "elapsed_s": round(elapsed, 6),
        "tokens": tokens,
    }
    for c in CAUSES:
        out[f"{c}_s"] = round(causes[c], 6)
    out["goodput_fraction"] = (
        round(causes["compute"] / elapsed, 6) if elapsed > 0 else None
    )
    if elapsed > 0:
        out["tokens_per_wall_s"] = round(tokens / elapsed, 3)
    badput = {c: causes[c] for c in CAUSES if c != "compute"}
    top = max(badput, key=lambda c: badput[c]) if any(badput.values()) else None
    out["badput_top_cause"] = top
    return out
