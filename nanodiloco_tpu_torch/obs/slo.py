"""Declarative SLOs with multi-window burn-rate alerting.

The serving quantities worth alerting on are exactly the vLLM-lineage
ones this repo already exposes as gauges (arXiv:2309.06180): TTFT
percentiles, client-visible decode tokens/s, KV-block headroom — plus
the fleet's own goodput fraction and the trainer's outer staleness.
The alerting discipline is the classic fast+slow MULTI-WINDOW burn
rate: a FAST window trips quickly on a real incident (minutes of
latency budget burning now) and a SLOW window confirms it is not a
blip, so a single bad scrape never pages and a sustained burn always
does. Recovery is debounced: the fast window must stay clean for
``clear_debounce_s`` before an alert resolves, so a flapping signal
emits one firing/resolved pair, not a storm.

Each rule names a series in the collector's store (``obs/collector``),
a bound, and a direction (``ceiling``: bad above; ``floor``: bad
below). The burn fraction of a window is the fraction of its samples
in breach (for the derived error-rate rule: whether the windowed
error/total counter-increase ratio breaches). A rule fires for a
target when BOTH windows exceed their burn thresholds.

Breaches emit ``slo_alert`` JSONL records — the same schema family as
the watchdog's alarm records, so they flow into ``report faults``,
``summarize_run`` (``slo_alerts_total`` / ``slo_worst_rule`` /
``slo_burn_seconds``), and the ``nanodiloco_slo_alerts_total{rule}``
counter family — and call an action hook the fleet wires up: the
router marks a burning replica not-preferred (route-around BEFORE any
503-ejection; the replica is slow, not dead) and the
``DeployController`` refuses to start a canary while a fleet-scope
rule burns (deploying into an incident is how incidents compound).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable

from nanodiloco_tpu_torch.obs.collector import SeriesStore
from nanodiloco_tpu_torch.obs.telemetry import render_exposition


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One declarative SLO. ``key`` is the collector sample key WITHOUT
    the target prefix (the rule is evaluated per target that exposes
    it). ``scope`` says what the action hook should do about a breach:
    ``replica`` rules route around the burning target; ``fleet`` rules
    gate deployment. ``derive="error_rate"`` ignores ``key`` and
    computes the windowed error/total ratio from the
    ``requests_by_outcome`` counter family instead."""

    name: str
    key: str
    bound: float
    kind: str = "ceiling"            # "ceiling" | "floor"
    scope: str = "replica"           # "replica" | "fleet"
    fast_window_s: float = 5.0
    slow_window_s: float = 30.0
    fast_burn: float = 0.5           # breach fraction tripping the fast window
    slow_burn: float = 0.25          # breach fraction confirming over the slow
    clear_debounce_s: float = 5.0
    derive: str | None = None        # None | "error_rate"

    def __post_init__(self) -> None:
        if self.kind not in ("ceiling", "floor"):
            raise ValueError(f"kind must be ceiling|floor; got {self.kind!r}")
        if self.scope not in ("replica", "fleet"):
            raise ValueError(f"scope must be replica|fleet; got {self.scope!r}")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                "windows must satisfy 0 < fast_window_s <= slow_window_s; "
                f"got {self.fast_window_s}/{self.slow_window_s}"
            )
        if not 0.0 < self.fast_burn <= 1.0 or not 0.0 < self.slow_burn <= 1.0:
            raise ValueError("burn thresholds must be in (0, 1]")

    def breached(self, value: float) -> bool:
        return value > self.bound if self.kind == "ceiling" \
            else value < self.bound


# series keys as the serve/router /metrics endpoints expose them
TTFT_P95_KEY = "nanodiloco_serve_ttft_p95_seconds"
# the protected class's latency under class-aware shedding: the gauge
# the fleet-wide p95 cannot substitute for (it mixes the protected
# class with the best-effort classes being sacrificed)
CLASS0_TTFT_P95_KEY = 'nanodiloco_serve_class_ttft_p95_seconds{priority="0"}'
DECODE_TPS_KEY = "nanodiloco_serve_decode_tokens_per_sec"
KV_FREE_KEY = "nanodiloco_kv_blocks_free"
FLEET_GOODPUT_KEY = "nanodiloco_fleet_goodput_fraction"
OUTER_STALENESS_KEY = "nanodiloco_outer_staleness"
REQUESTS_ERROR_KEY = 'nanodiloco_serve_requests_total{outcome="error"}'
REQUESTS_TOTAL_KEY = "nanodiloco_serve_requests_total"


def standard_rules(
    *,
    ttft_p95_max_s: float | None = None,
    class0_ttft_p95_max_s: float | None = None,
    decode_tps_min: float | None = None,
    error_rate_max: float | None = None,
    kv_blocks_free_min: float | None = None,
    fleet_goodput_min: float | None = None,
    outer_staleness_max: float | None = None,
    fast_window_s: float = 5.0,
    slow_window_s: float = 30.0,
    fast_burn: float = 0.5,
    slow_burn: float = 0.25,
    clear_debounce_s: float = 5.0,
) -> list[SLORule]:
    """The repo's standard SLO set; a None threshold omits its rule.
    Rule names are stable identifiers (they key the alert counter
    family and the compare summary)."""
    win = dict(fast_window_s=fast_window_s, slow_window_s=slow_window_s,
               fast_burn=fast_burn, slow_burn=slow_burn,
               clear_debounce_s=clear_debounce_s)
    rules: list[SLORule] = []
    if ttft_p95_max_s is not None:
        rules.append(SLORule("short_ttft_p95_s", TTFT_P95_KEY,
                             ttft_p95_max_s, "ceiling", "replica", **win))
    if class0_ttft_p95_max_s is not None:
        # the class-aware shedding contract: while lower classes shed,
        # THIS rule is the one that must stay quiet
        rules.append(SLORule("class0_ttft_p95_s", CLASS0_TTFT_P95_KEY,
                             class0_ttft_p95_max_s, "ceiling", "replica",
                             **win))
    if decode_tps_min is not None:
        rules.append(SLORule("decode_tokens_per_sec", DECODE_TPS_KEY,
                             decode_tps_min, "floor", "replica", **win))
    if error_rate_max is not None:
        rules.append(SLORule("error_rate", REQUESTS_TOTAL_KEY,
                             error_rate_max, "ceiling", "replica",
                             derive="error_rate", **win))
    if kv_blocks_free_min is not None:
        rules.append(SLORule("kv_blocks_free", KV_FREE_KEY,
                             kv_blocks_free_min, "floor", "replica", **win))
    if fleet_goodput_min is not None:
        rules.append(SLORule("fleet_goodput_fraction", FLEET_GOODPUT_KEY,
                             fleet_goodput_min, "floor", "fleet", **win))
    if outer_staleness_max is not None:
        rules.append(SLORule("outer_staleness", OUTER_STALENESS_KEY,
                             outer_staleness_max, "ceiling", "fleet", **win))
    return rules


class _AlertState:
    """Per (rule, target) state machine: ok -> firing -> (debounced)
    resolved. Burn seconds accumulate while firing — the compare-gated
    incident cost."""

    def __init__(self) -> None:
        self.firing = False
        self.fired_at: float | None = None
        self.clean_since: float | None = None
        self.burn_s = 0.0
        self.last_eval_t: float | None = None


class SLOMonitor:
    """Evaluate ``rules`` over a collector's ``SeriesStore``.

    ``targets`` are the collector's target names; each rule is
    evaluated against every target whose store carries its series (a
    fleet-goodput rule only matches the router target, TTFT rules only
    the replicas — no manual wiring). ``on_alert(rule, target,
    firing)`` is the action hook; a hook failure is counted, never
    fatal (alert evaluation must survive a dead router). ``clock`` is
    the store's timebase (monotonic); ``wall`` stamps the JSONL."""

    def __init__(
        self,
        store: SeriesStore,
        rules: list[SLORule],
        targets: list[str],
        *,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        alerts_jsonl: str | None = None,
        on_alert: Callable[[SLORule, str, bool], None] | None = None,
        quiet: bool = True,
    ) -> None:
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"rule names must be unique; got {names}")
        self.store = store
        self.rules = list(rules)
        self.targets = list(targets)
        self._clock = clock
        self._wall = wall
        self.alerts_jsonl = alerts_jsonl
        self._on_alert = on_alert
        self.quiet = quiet
        self._lock = threading.Lock()
        self._jsonl_lock = threading.Lock()
        self._states: dict[tuple[str, str], _AlertState] = {}
        self.alerts_fired: dict[str, int] = {}   # rule -> firing transitions
        self.hook_errors = 0
        # transitions whose hook call FAILED (router booting, transient
        # socket error): retried with the pair's CURRENT state on every
        # evaluate until one lands — a route-around lost to a refused
        # connection would otherwise never happen at all
        self._hook_pending: set[tuple[str, str]] = set()

    # -- burn math -----------------------------------------------------------

    def _series_key(self, target: str, sample: str) -> str:
        return f"{target}:{sample}"

    def burn_fraction(self, rule: SLORule, target: str, window_s: float,
                      now: float) -> float | None:
        """Fraction of the window in breach: per-sample for plain
        series; for the derived error rate, 1.0/0.0 on whether the
        windowed increase ratio breaches (a ratio has no per-sample
        form). None when the window holds no evidence — absence never
        TRIPS an alert (firing needs both windows on real samples);
        for an already-firing alert, sustained absence counts as clean
        and resolves after the debounce (see _evaluate_one)."""
        if rule.derive == "error_rate":
            total = self.store.increase(
                self._series_key(target, REQUESTS_TOTAL_KEY), window_s, now
            )
            if not total:
                return None
            errors = self.store.increase(
                self._series_key(target, REQUESTS_ERROR_KEY), window_s, now
            ) or 0.0
            return 1.0 if (errors / total) > rule.bound else 0.0
        samples = self.store.window(
            self._series_key(target, rule.key), now - window_s, now
        )
        if not samples:
            return None
        bad = sum(1 for _, v in samples if rule.breached(v))
        return bad / len(samples)

    def _matches(self, rule: SLORule, target: str) -> bool:
        key = REQUESTS_TOTAL_KEY if rule.derive == "error_rate" else rule.key
        return self.store.latest(self._series_key(target, key)) is not None

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One evaluation sweep; returns the alert records EMITTED this
        sweep (firing and resolved transitions only — steady states are
        silent, burn seconds still accumulate)."""
        now = self._clock() if now is None else now
        emitted: list[dict] = []
        for rule in self.rules:
            for target in self.targets:
                if not self._matches(rule, target):
                    continue
                rec = self._evaluate_one(rule, target, now)
                if rec is not None:
                    emitted.append(rec)
        self._retry_pending_hooks()
        return emitted

    def _retry_pending_hooks(self) -> None:
        for rule_name, target in sorted(self._hook_pending):
            rule = next((r for r in self.rules if r.name == rule_name),
                        None)
            if rule is None:
                self._hook_pending.discard((rule_name, target))
                continue
            with self._lock:
                st = self._states.get((rule_name, target))
                firing = bool(st is not None and st.firing)
            # the CURRENT state, not the state at failure time: if the
            # alert resolved while the router was unreachable, the
            # retry must deliver the clear, never a stale burn
            self._call_hook(rule, target, firing)

    def _evaluate_one(self, rule: SLORule, target: str,
                      now: float) -> dict | None:
        fast = self.burn_fraction(rule, target, rule.fast_window_s, now)
        slow = self.burn_fraction(rule, target, rule.slow_window_s, now)
        transition: str | None = None
        # decide under the lock, EMIT outside it: _emit runs the action
        # hook (an HTTP POST to the router, seconds under a timeout),
        # and holding the lock across it would stall the watcher's own
        # /metrics endpoint exactly during the incident it reports
        with self._lock:
            st = self._states.setdefault((rule.name, target), _AlertState())
            if st.firing and st.last_eval_t is not None and fast is not None:
                # burn accrues only while there is EVIDENCE: a series
                # that vanished (route-around starved the error-rate
                # counters of traffic) must not inflate the
                # compare-gated burn seconds from silence
                st.burn_s += max(0.0, now - st.last_eval_t)
            st.last_eval_t = now
            if not st.firing:
                # fast window trips, slow window confirms — both must
                # burn for the alert to fire (the multi-window AND)
                if (fast is not None and slow is not None
                        and fast >= rule.fast_burn
                        and slow >= rule.slow_burn):
                    st.firing = True
                    st.fired_at = now
                    st.clean_since = None
                    self.alerts_fired[rule.name] = (
                        self.alerts_fired.get(rule.name, 0) + 1
                    )
                    transition = "firing"
            else:
                # firing: resolve only after the fast window stays
                # CLEAN for the debounce period — a flapping burn
                # re-arms the clean timer instead of emitting
                # resolve/fire pairs. NO EVIDENCE counts as clean:
                # the system's own remediation can starve the signal
                # (route-around leaves the error-rate counters flat),
                # and an alert that can never resolve burns forever;
                # re-firing requires both windows to trip on real
                # evidence again, so this cannot mask a live burn
                clean = fast is None or fast == 0.0
                if not clean:
                    st.clean_since = None
                else:
                    if st.clean_since is None:
                        st.clean_since = now
                    if now - st.clean_since >= rule.clear_debounce_s:
                        st.firing = False
                        st.clean_since = None
                        transition = "resolved"
        if transition is None:
            return None
        return self._emit(rule, target, transition, fast, slow, st)

    def _emit(self, rule: SLORule, target: str, state: str,
              fast: float | None, slow: float | None,
              st: _AlertState, **extra) -> dict:
        rec = {
            "slo_alert": rule.name,
            "state": state,
            "target": target,
            "scope": rule.scope,
            "bound": rule.bound,
            "kind": rule.kind,
            "fast_burn": None if fast is None else round(fast, 4),
            "slow_burn": None if slow is None else round(slow, 4),
            "t_unix": round(self._wall(), 3),
            **extra,
        }
        if state != "firing":
            rec["burn_s"] = round(st.burn_s, 3)
        self._append_jsonl(rec)
        self._call_hook(rule, target, state == "firing")
        if not self.quiet:
            print(f"[slo] {json.dumps(rec)}", flush=True)
        return rec

    def _call_hook(self, rule: SLORule, target: str, firing: bool) -> None:
        if self._on_alert is None:
            return
        try:
            self._on_alert(rule, target, firing)
            self._hook_pending.discard((rule.name, target))
        except Exception:
            # a dead router must not kill alerting — count it and queue
            # the pair for retry on the next evaluate
            self.hook_errors += 1
            self._hook_pending.add((rule.name, target))

    def _append_jsonl(self, rec: dict) -> None:
        if not self.alerts_jsonl:
            return
        try:
            d = os.path.dirname(os.path.abspath(self.alerts_jsonl))
            os.makedirs(d, exist_ok=True)
            with self._jsonl_lock, open(self.alerts_jsonl, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # a full disk must not take down alerting

    # -- state surface -------------------------------------------------------

    def firing(self) -> list[tuple[str, str]]:
        """Currently-firing ``(rule, target)`` pairs."""
        with self._lock:
            return sorted(k for k, st in self._states.items() if st.firing)

    def fleet_burning(self) -> bool:
        """True while any FLEET-scope rule fires — the deploy
        controller's canary gate."""
        scopes = {r.name: r.scope for r in self.rules}
        return any(scopes.get(rule) == "fleet"
                   for rule, _t in self.firing())

    def burn_seconds(self) -> dict[str, float]:
        """Cumulative firing seconds per rule (all targets summed)."""
        out: dict[str, float] = {}
        with self._lock:
            for (rule, _target), st in self._states.items():
                out[rule] = out.get(rule, 0.0) + st.burn_s
        return {k: round(v, 3) for k, v in out.items()}

    def finalize(self) -> dict:
        """Shutdown: resolve still-firing alerts (reason=shutdown, so
        the JSONL's burn accounting is complete) and append one
        ``slo_summary`` record — the artifact ``summarize_run`` reads
        even when no individual alert ever resolved."""
        now = self._clock()
        with self._lock:
            open_keys = [k for k, st in self._states.items() if st.firing]
        for rule_name, target in open_keys:
            rule = next(r for r in self.rules if r.name == rule_name)
            with self._lock:
                st = self._states[(rule_name, target)]
                if st.last_eval_t is not None:
                    st.burn_s += max(0.0, now - st.last_eval_t)
                    st.last_eval_t = now
                st.firing = False
            self._emit(rule, target, "resolved", None, None, st,
                       reason="shutdown")
        burn = self.burn_seconds()
        summary = {
            "slo_summary": {
                "alerts_total": sum(self.alerts_fired.values()),
                "alerts_by_rule": dict(sorted(self.alerts_fired.items())),
                "burn_seconds_by_rule": burn,
                "burn_seconds_total": round(sum(burn.values()), 3),
                **({"worst_rule": max(burn, key=burn.get)} if burn else {}),
            },
            "t_unix": round(self._wall(), 3),
        }
        self._append_jsonl(summary)
        return summary

    def render_metrics(self) -> str:
        """The monitor's exposition (served by ``obs-watch``):
        ``nanodiloco_slo_alerts_total{rule}``, per-pair burning gauges,
        and cumulative burn seconds."""
        with self._lock:
            firing = sorted(
                (k, st.burn_s) for k, st in self._states.items()
                if st.firing
            )
            # snapshot under the lock: the evaluator inserts a rule's
            # first firing transition concurrently with HTTP scrapes
            # of this endpoint — an unguarded iteration would crash
            # the watcher's own /metrics exactly as an incident starts
            fired = dict(self.alerts_fired)
            hook_errors = self.hook_errors
        burn = self.burn_seconds()
        families: list = [(
            "nanodiloco_slo_alerts", "counter",
            "SLO burn-rate alerts fired, by rule",
            [({"rule": r}, n) for r, n in sorted(fired.items())]
            + [(None, sum(fired.values()))],
        )]
        if firing:
            families.append((
                "nanodiloco_slo_burning", "gauge",
                "1 per (rule, target) currently firing",
                [({"rule": r, "target": t}, 1) for (r, t), _ in firing],
            ))
        if burn:
            families.append((
                "nanodiloco_slo_burn_seconds", "counter",
                "cumulative seconds each rule has spent firing",
                [({"rule": r}, s) for r, s in sorted(burn.items())]
                + [(None, round(sum(burn.values()), 3))],
            ))
        if hook_errors:
            families.append((
                "nanodiloco_slo_hook_errors", "counter",
                "action-hook invocations that raised",
                [(None, hook_errors)],
            ))
        return render_exposition(families)


def router_action_hook(post: Callable[[str, dict], Any],
                       router_url: str) -> Callable[[SLORule, str, bool], None]:
    """The wire form of the action hook: POST each transition to the
    fleet router's ``/fleet/slo`` endpoint (replica-scope -> the router
    marks that replica not-preferred; fleet-scope -> the deploy
    controller's canary gate). ``post`` is ``(url, doc) -> (code,
    body)`` — injectable; the default caller passes
    ``serve/client.http_post_json``."""

    def hook(rule: SLORule, target: str, firing: bool) -> None:
        result = post(router_url.rstrip("/") + "/fleet/slo", {
            "rule": rule.name,
            "scope": rule.scope,
            "target": target,
            "firing": firing,
        })
        # http_post_json returns 4xx/5xx instead of raising: a refused
        # transition (mismatched target name, router mid-restart) must
        # surface as a hook FAILURE — counted, queued for retry — not a
        # silent success that never route-arounds anything
        if isinstance(result, tuple) and result and isinstance(
            result[0], int
        ) and not 200 <= result[0] < 300:
            raise OSError(
                f"/fleet/slo answered {result[0]}: {result[1]}"
            )

    return hook
