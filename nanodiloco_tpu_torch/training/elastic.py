"""Elastic DiLoCo control plane: straggler policy + H-schedule carrying.
A copy of ``nanodiloco_tpu/training/elastic.py`` (standard library only).

The DiLoCo premise is islands of compute on poor interconnect
(arXiv:2311.08105); on preemptible pools one slow island must not
stall the fleet, and MegaScale's effective-training-time discipline
(arXiv:2402.15627) says the fix has to be MEASURED: every second a
healthy worker spends waiting on a straggler is badput the goodput
ledger should attribute (``straggler_wait``), and every capacity or
schedule decision should be a logged record, not a silent halving.

Two pieces live here, both pure host-side control logic (what CPU
pins; the chip only confirms wall-clock):

- :class:`StragglerPolicy` — per-round demote/restore decisions from
  per-worker round durations. A worker whose PER-STEP seconds exceed
  ``factor ×`` the median of the OTHER workers' per-step seconds gets
  its inner-step budget H lowered proportionally (so its round time
  would land near the fleet's) for subsequent rounds, and restored to
  full H when it recovers. Leave-one-out medians matter at small W: a
  2-island fleet's plain median is the mean of both, so a straggler
  would drag its own detection threshold up with it. Per-step
  normalization (duration / realized budget) is what makes detection
  work WHILE demoted: a demoted worker that is still slow per step
  stays demoted; one that recovered reads normal and is restored.
  Every decision is returned as a JSONL-ready ``elastic`` record.

- H-schedule sidecar — ``elastic_schedule.json`` next to the
  checkpoints, carrying the CURRENT per-worker budgets (and the
  demotion counter) across process lifetimes. The checkpoint already
  carries the width (the stacked params' leading dim); the sidecar
  carries the schedule. Same-width resumes restore the schedule exactly (elastic
  resume at unchanged width stays bit-exact); a width change resets to
  uniform H — worker identity is not preserved across a resize (every
  replica reseeds from the snapshot), so per-worker history would be
  attributed to the wrong islands.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Any


class StragglerPolicy:
    """Round-boundary demote/restore of per-worker inner-step budgets.

    ``factor``: a worker straggles when its per-step seconds exceed
    ``factor ×`` the fleet median per-step seconds. ``min_steps``
    floors every demotion — a worker never drops below it (it must
    keep contributing SOMETHING for its pseudo-gradient weight to stay
    nonzero). ``observe`` mutates ``budgets`` in place and returns the
    decision records; the caller feeds the new budgets to
    ``Diloco.set_inner_budget`` for subsequent rounds.
    """

    def __init__(
        self,
        inner_steps: int,
        num_workers: int,
        factor: float,
        min_steps: int = 1,
        initial: list[int] | None = None,
    ) -> None:
        if factor <= 1.0:
            raise ValueError(
                f"straggler factor must be > 1 (got {factor}): at <= 1 "
                "every worker at/above the median would demote"
            )
        if not 1 <= min_steps <= inner_steps:
            raise ValueError(
                f"min_steps must be in [1, inner_steps={inner_steps}]; "
                f"got {min_steps}"
            )
        self.inner_steps = int(inner_steps)
        self.num_workers = int(num_workers)
        self.factor = float(factor)
        self.min_steps = int(min_steps)
        self.budgets = list(initial or [inner_steps] * num_workers)
        if len(self.budgets) != num_workers:
            raise ValueError(
                f"initial budgets have {len(self.budgets)} entries for "
                f"{num_workers} workers"
            )
        self.demotions_total = 0
        self.restores_total = 0

    def observe(self, worker_seconds: list[float]) -> list[dict[str, Any]]:
        """Fold one round's per-worker durations in; returns the
        decision records (empty when the fleet is healthy). Durations
        are normalized per REALIZED step against the budgets in effect
        for the observed round, then each worker is compared to the
        median of the OTHER workers (leave-one-out — at W=2 a plain
        median IS the straggler-contaminated mean)."""
        if len(worker_seconds) != self.num_workers:
            raise ValueError(
                f"worker_seconds has {len(worker_seconds)} entries for "
                f"{self.num_workers} workers"
            )
        decisions: list[dict[str, Any]] = []
        if self.num_workers < 2:
            return decisions  # no fleet to straggle behind
        per_step = [
            max(0.0, float(s)) / max(b, 1)
            for s, b in zip(worker_seconds, self.budgets)
        ]
        for w, s in enumerate(per_step):
            others = per_step[:w] + per_step[w + 1:]
            median = statistics.median(others)
            if median <= 0:
                continue
            straggling = s > self.factor * median
            if straggling:
                # lower H so the straggler's round time would land near
                # the fleet's at its observed per-step speed
                target = max(
                    self.min_steps,
                    min(self.inner_steps, int(self.inner_steps * median / s)),
                )
                if target < self.budgets[w]:
                    decisions.append({
                        "elastic": "straggler_demote",
                        "worker": w,
                        "h_from": self.budgets[w],
                        "h_to": target,
                        "per_step_s": round(s, 6),
                        "median_per_step_s": round(median, 6),
                        "factor": self.factor,
                    })
                    self.budgets[w] = target
                    self.demotions_total += 1
            elif self.budgets[w] < self.inner_steps:
                # recovered: per-step time back within the straggler
                # bound — restore the full budget in one step (the
                # policy re-demotes next round if that was optimistic)
                decisions.append({
                    "elastic": "straggler_restore",
                    "worker": w,
                    "h_from": self.budgets[w],
                    "h_to": self.inner_steps,
                    "per_step_s": round(s, 6),
                    "median_per_step_s": round(median, 6),
                })
                self.budgets[w] = self.inner_steps
                self.restores_total += 1
        return decisions


# -- H-schedule sidecar (checkpoint-carried, both resize directions) ---------

SCHEDULE_FILE = "elastic_schedule.json"


def save_schedule(
    checkpoint_dir: str,
    step: int,
    num_workers: int,
    budgets: list[int],
    demotions_total: int = 0,
) -> None:
    """Atomically persist the live H schedule next to the checkpoints
    (writer rank only — the caller gates). A torn write must never be
    readable: write-to-temp + rename, the checkpoints' own discipline."""
    doc = {
        "step": int(step),
        "num_workers": int(num_workers),
        "inner_steps_per_worker": [int(b) for b in budgets],
        "straggler_demotions_total": int(demotions_total),
    }
    path = os.path.join(checkpoint_dir, SCHEDULE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_schedule(checkpoint_dir: str) -> dict[str, Any] | None:
    """The persisted H schedule, or None when absent/torn/foreign —
    older checkpoints (and uniform-H runs) have no sidecar and resume
    exactly as before."""
    path = os.path.join(checkpoint_dir, SCHEDULE_FILE)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not isinstance(
        doc.get("inner_steps_per_worker"), list
    ):
        return None
    return doc


def resume_budgets(
    checkpoint_dir: str | None,
    num_workers: int,
    inner_steps: int,
    initial: list[int],
) -> tuple[list[int], int, bool]:
    """Budgets to resume with: ``(budgets, demotions_total, reset)``.

    Same width → the sidecar's schedule, exactly (bit-exact resume at
    unchanged width). Width changed (or no/invalid sidecar) → the
    run's configured initial schedule, demotion counter fresh, with
    ``reset`` True when a sidecar existed but its width no longer
    matches — the caller logs that as an ``elastic`` record so the
    schedule reset is visible in the run timeline."""
    if not checkpoint_dir:
        return list(initial), 0, False
    doc = load_schedule(checkpoint_dir)
    if doc is None:
        return list(initial), 0, False
    saved = [int(b) for b in doc["inner_steps_per_worker"]]
    if (
        int(doc.get("num_workers", -1)) == num_workers
        and len(saved) == num_workers
        and all(1 <= b <= inner_steps for b in saved)
    ):
        return saved, int(doc.get("straggler_demotions_total", 0)), False
    return list(initial), 0, True
