"""Fleet capacity model: per-replica series -> demand/supply forecasts.

The collector (``obs/collector.py``) holds per-replica time series; the
autoscaler (``fleet/autoscaler.py``) needs ONE fleet-level answer:
"is demand trending past supply, and how many seconds until something
runs out?". ``CapacityModel`` is that join, built entirely from the
SeriesStore's forecasting queries (``slope``/``forecast_exhaustion``/
``rate``) — never raw point gauges, which is the whole point: a point
gauge says the fleet is fine right up until the tick it is not
(MegaScale's operability premise, arXiv:2402.15627).

Every estimate carries a CONFIDENCE HORIZON: the span of samples that
backs it. A forecast farther out than ``beyond_factor`` x that span is
extrapolating past its evidence and is dropped (reported as "not
imminent"), and an estimate backed by less than ``min_horizon_s`` of
data is flagged not-confident — the autoscaler treats both as "do
nothing yet", so a replica that just booted (two samples, wild slope)
cannot trigger a phantom scale event.

Stdlib only, no device work; everything is testable with a scripted
SeriesStore and a fake clock.
"""

from __future__ import annotations

import dataclasses

from nanodiloco_tpu_torch.obs.collector import SeriesStore

# the serve-replica sample names the model joins over (the exact names
# serve/server.py render_metrics emits; collector keys are
# "{target}:{sample}")
QUEUE_DEPTH_SAMPLE = "nanodiloco_serve_queue_depth"
KV_FREE_SAMPLE = "nanodiloco_kv_blocks_free"
SLOTS_TOTAL_SAMPLE = "nanodiloco_serve_slots_total"
REQUESTS_TOTAL_SAMPLE = "nanodiloco_serve_requests_total"


@dataclasses.dataclass(frozen=True)
class CapacityEstimate:
    """One fleet-level capacity reading at time ``at``.

    Demand: ``queue_depth``/``queue_slope`` (fleet-summed waiting
    requests and their per-second trend) and ``request_rate``
    (completed requests/s). Supply: ``kv_blocks_free`` (fleet-summed
    headroom). Forecasts: ``kv_exhaustion_s`` (seconds until the FIRST
    replica's KV pool hits 0 — min over replicas, because the fleet
    degrades when one replica saturates, not when the average does) and
    ``queue_exhaustion_s`` (seconds until the first replica's queue
    depth crosses its slot capacity). ``horizon_s`` is the sample span
    backing the estimate; ``confident`` is False until that span
    reaches the model's ``min_horizon_s``."""

    at: float
    replicas: int
    queue_depth: float | None
    queue_slope: float | None
    request_rate: float | None
    kv_blocks_free: float | None
    kv_exhaustion_s: float | None
    queue_exhaustion_s: float | None
    horizon_s: float
    confident: bool

    def exhaustion_s(self) -> float | None:
        """The nearest credible exhaustion across resources (None =
        nothing forecast to run out)."""
        etas = [e for e in (self.kv_exhaustion_s, self.queue_exhaustion_s)
                if e is not None]
        return min(etas) if etas else None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class CapacityModel:
    """Turn a SeriesStore of per-replica serve metrics into fleet-level
    ``CapacityEstimate``s.

    ``targets`` names the replicas to join over; by default they are
    DISCOVERED from the store (every target that has ever reported a
    queue-depth sample), so a fleet the autoscaler itself grows is
    picked up without re-plumbing. ``window_s`` bounds every trend
    query; ``min_horizon_s`` is the minimum backing span before
    ``confident`` flips True; forecasts beyond ``beyond_factor`` x the
    backing span are dropped as extrapolation."""

    def __init__(
        self,
        store: SeriesStore,
        *,
        targets: list[str] | None = None,
        window_s: float = 60.0,
        min_horizon_s: float = 5.0,
        beyond_factor: float = 10.0,
    ) -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0; got {window_s}")
        if beyond_factor <= 0:
            raise ValueError(
                f"beyond_factor must be > 0; got {beyond_factor}"
            )
        self.store = store
        self._targets = list(targets) if targets is not None else None
        self.window_s = float(window_s)
        self.min_horizon_s = float(min_horizon_s)
        self.beyond_factor = float(beyond_factor)
        self._excluded: frozenset[str] = frozenset()

    def set_excluded(self, names) -> None:
        """Replicas to leave out of the supply join (e.g. circuit-breaker
        open: still scraping, but not credible capacity)."""
        self._excluded = frozenset(str(n) for n in names)

    def set_targets(self, names) -> None:
        """Pin the replica set the model joins over, replacing
        discovery. The disaggregated autoscaler (fleet/disagg.py) calls
        this every tick with ONE TIER's usable replicas
        (``FleetRouter.tier_capacity_names``), so a prefill replica's
        queue and KV headroom never count toward decode capacity — each
        tier's model sees only its own supply."""
        self._targets = [str(n) for n in names]

    def targets(self) -> list[str]:
        if self._targets is not None:
            names = list(self._targets)
        else:
            suffix = f":{QUEUE_DEPTH_SAMPLE}"
            names = sorted(
                k[: -len(suffix)]
                for k in self.store.keys()
                if k.endswith(suffix) and ":" not in k[: -len(suffix)]
            )
        if self._excluded:
            names = [n for n in names if n not in self._excluded]
        return names

    def _span(self, key: str, now: float) -> float:
        samples = self.store.window(key, now - self.window_s, now)
        if len(samples) < 2:
            return 0.0
        return samples[-1][0] - samples[0][0]

    def _credible(self, eta: float | None, horizon: float) -> float | None:
        """Drop forecasts that extrapolate past their evidence."""
        if eta is None or horizon <= 0:
            return None
        return eta if eta <= self.beyond_factor * horizon else None

    def estimate(self, now: float) -> CapacityEstimate:
        store = self.store
        targets = self.targets()
        q_depth_sum: float | None = None
        q_slope_sum: float | None = None
        rate_sum: float | None = None
        kv_free_sum: float | None = None
        kv_etas: list[float] = []
        q_etas: list[float] = []
        spans: list[float] = []
        fresh = 0
        for t in targets:
            qk = f"{t}:{QUEUE_DEPTH_SAMPLE}"
            last = store.latest(qk)
            if last is None or last[0] < now - self.window_s:
                continue  # stale/retired replica: not part of supply
            fresh += 1
            span = self._span(qk, now)
            spans.append(span)
            q_depth_sum = (q_depth_sum or 0.0) + last[1]
            qs = store.slope(qk, self.window_s, now)
            if qs is not None:
                q_slope_sum = (q_slope_sum or 0.0) + qs
            rr = store.rate(
                f"{t}:{REQUESTS_TOTAL_SAMPLE}", self.window_s, now
            )
            if rr is not None:
                rate_sum = (rate_sum or 0.0) + rr
            kvk = f"{t}:{KV_FREE_SAMPLE}"
            kv_last = store.latest(kvk)
            if kv_last is not None and kv_last[0] >= now - self.window_s:
                kv_free_sum = (kv_free_sum or 0.0) + kv_last[1]
                eta = self._credible(
                    store.forecast_exhaustion(
                        kvk, 0.0, self.window_s, now, kind="floor"
                    ),
                    self._span(kvk, now),
                )
                if eta is not None:
                    kv_etas.append(eta)
            slots = store.latest(f"{t}:{SLOTS_TOTAL_SAMPLE}")
            if slots is not None and slots[1] > 0:
                eta = self._credible(
                    store.forecast_exhaustion(
                        qk, slots[1], self.window_s, now, kind="ceiling"
                    ),
                    span,
                )
                if eta is not None:
                    q_etas.append(eta)
        horizon = min(spans) if spans else 0.0
        return CapacityEstimate(
            at=now,
            replicas=fresh,
            queue_depth=q_depth_sum,
            queue_slope=q_slope_sum,
            request_rate=rate_sum,
            kv_blocks_free=kv_free_sum,
            kv_exhaustion_s=min(kv_etas) if kv_etas else None,
            queue_exhaustion_s=min(q_etas) if q_etas else None,
            horizon_s=horizon,
            confident=bool(spans) and horizon >= self.min_horizon_s,
        )
