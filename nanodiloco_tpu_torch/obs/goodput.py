"""Goodput records: what ``summarize_run`` reads of them.

The reader half of ``nanodiloco_tpu/obs/goodput.py`` (jax-free; the JAX
package's ``__init__`` imports jax, so the port keeps its own): the
closed cause set and ``stitch_goodput_records``, which ``report`` uses to
fold the per-lifetime ``{"goodput": ...}`` snapshots of a JSONL into one
run-level ledger. The ledger that writes those snapshots during training
(``GoodputLedger``) is not ported, so a port run's JSONL carries none and
its summary has no goodput keys; a JAX run's JSONL summarizes the same
through either package.
"""

from __future__ import annotations

from typing import Any, Iterable

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
