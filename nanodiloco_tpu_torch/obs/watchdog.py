"""Training watchdog: in-loop sentinels + a heartbeat stall detector.

A copy of ``nanodiloco_tpu/obs/watchdog.py`` (the JAX package's
``__init__`` imports jax, so the port keeps its own). The train loop
feeds it only after a round's sync point (the round's losses on the
host), never from queued device work.

A long unattended run degrades in ways a loss curve viewed tomorrow
cannot undo: a NaN poisons every later step, a data stall silently
freezes the job while the accelerator claim burns, a recompile storm
collapses throughput. The watchdog turns each of these into a
structured ``alarm`` record in the SAME JSONL stream the metrics go to
(one source of truth), and optionally mirrors a small ``status.json``
to disk for external pollers (cron, chip_watch.sh, a dashboard) that
must not parse an unbounded JSONL to answer "is it alive".

Sentinels (called in-loop by the train loop; pure host arithmetic):
- ``nan_loss``: any non-finite logged loss.
- ``loss_spike``: z-score of the new loss against a rolling window
  exceeds ``loss_zscore`` (and the loss ROSE — a falling outlier is
  good news, not an alarm).
- ``throughput_collapse``: tokens/sec drops below
  ``tps_collapse_frac`` x the rolling median.
- ``stall``: no heartbeat for ``stall_factor`` x the rolling mean
  round time (checked by a daemon thread, since a stalled loop by
  definition cannot check itself; ``check_stall`` is also callable
  directly with an injected clock for tests).

Alarm records: ``{"alarm": <kind>, "step": ..., <detail keys>}`` —
consumers filter on the ``alarm`` key; ``summarize_run`` counts them.
Each kind re-arms only after a healthy observation, so a persisting
condition logs one alarm per episode, not one per step.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable

from nanodiloco_tpu_torch.obs import flightrec


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    loss_zscore: float = 6.0     # spike threshold; <=0 disables
    loss_window: int = 32        # rolling window for mean/std and median
    tps_collapse_frac: float = 0.4   # alarm below frac*median; <=0 disables
    stall_factor: float = 5.0    # alarm after factor*mean round time; <=0 off
    min_stall_s: float = 30.0    # never call a stall before this many seconds
    poll_s: float = 2.0          # heartbeat thread cadence
    # divergence sentinel: alarm when the cross-worker drift (max
    # pairwise replica distance / snapshot norm, the per-sync
    # `drift_max` dynamics metric) exceeds this, or goes non-finite —
    # the early warning that fires BEFORE a replica reaches
    # quarantine-level blow-up. <=0 disables.
    drift_threshold: float = 0.0


class Watchdog:
    """``emit`` receives each alarm record (the train loop passes
    ``logger.log``); ``status_path`` mirrors live state to disk.
    ``clock`` is injectable (monotonic seconds) so the stall path is
    testable without sleeping."""

    def __init__(
        self,
        cfg: WatchdogConfig | None = None,
        emit: Callable[[dict], None] | None = None,
        status_path: str | None = None,
        clock: Callable[[], float] = time.monotonic,
        on_fatal: Callable[[str, int], None] | None = None,
        fatal_kinds: tuple[str, ...] = ("stall", "nan_loss"),
    ) -> None:
        self.cfg = cfg or WatchdogConfig()
        self._emit = emit or (lambda rec: None)
        self.status_path = status_path
        self._clock = clock
        # observe -> ACT: alarms of a fatal kind also invoke this
        # callback (the train loop's --watch-action checkpoint-exit path
        # hangs its emergency-stop latch here). May fire from the
        # heartbeat daemon thread; exceptions are swallowed — the
        # watchdog must never take training down by accident.
        self._on_fatal = on_fatal
        self._fatal_kinds = tuple(fatal_kinds)
        self._lock = threading.Lock()
        self._losses: deque[float] = deque(maxlen=max(2, self.cfg.loss_window))
        self._tps: deque[float] = deque(maxlen=max(2, self.cfg.loss_window))
        self._beats: deque[float] = deque(maxlen=8)  # recent beat intervals
        self._last_beat: float | None = None
        self._last_step = 0
        self._alarm_count = 0
        self._alarm_kinds: dict[str, int] = {}
        self._last_alarm: dict | None = None
        self._final_state: str | None = None  # set by stop()
        # per-kind armed flags: one alarm per episode
        self._armed = {"nan_loss": True, "loss_spike": True,
                       "throughput_collapse": True, "stall": True,
                       "divergence": True}
        self._status_extra: dict[str, Any] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # run age: /healthz and --status-file must answer "how long has
        # this run existed", not just "how fresh is the last step" — a
        # restart loop looks perfectly fresh step-wise while uptime
        # keeps resetting
        self._started_unix = time.time()

    # -- alarm plumbing ------------------------------------------------------

    def _fire(self, kind: str, step: int, **detail: Any) -> None:
        with self._lock:
            if not self._armed.get(kind, True):
                return
            self._armed[kind] = False
            self._alarm_count += 1
            self._alarm_kinds[kind] = self._alarm_kinds.get(kind, 0) + 1
            rec = {"alarm": kind, "step": step, **detail}
            self._last_alarm = rec
        self._emit(rec)
        self._write_status()
        if kind in self._fatal_kinds:
            # black-box dump on FATAL alarms regardless of watch action:
            # a stalled/NaN'd run is exactly the one whose recent
            # timeline must survive whatever happens next (the emit
            # above already put the alarm record in the ring via the
            # logger feed). Observe-only runs keep the dump too — it is
            # evidence, not an action.
            try:
                flightrec.dump_current(f"watchdog:{kind}")
            except Exception:
                pass
            if self._on_fatal is not None:
                try:
                    self._on_fatal(kind, step)
                except Exception:
                    pass

    def alarm(self, kind: str, step: int, **detail: Any) -> None:
        """Explicitly-raised external alarm (e.g. the train loop's
        checkpoint-save-failed degradation). Unlike the sentinels it is
        per-EVENT, not per-episode: every call records, none is gated by
        the armed flags, and none triggers the fatal action (the caller
        already decided to degrade, not to die)."""
        with self._lock:
            self._alarm_count += 1
            self._alarm_kinds[kind] = self._alarm_kinds.get(kind, 0) + 1
            rec = {"alarm": kind, "step": step, **detail}
            self._last_alarm = rec
        self._emit(rec)
        self._write_status()

    def _rearm(self, kind: str) -> None:
        with self._lock:
            self._armed[kind] = True

    @property
    def alarm_count(self) -> int:
        return self._alarm_count

    @property
    def alarm_kinds(self) -> dict[str, int]:
        with self._lock:
            return dict(self._alarm_kinds)

    @property
    def last_alarm(self) -> dict | None:
        return self._last_alarm

    # -- sentinels -----------------------------------------------------------

    def observe_loss(self, step: int, loss: float) -> None:
        loss = float(loss)
        if not math.isfinite(loss):
            self._fire("nan_loss", step, loss=str(loss))
            return  # a non-finite value must not enter the window
        self._rearm("nan_loss")
        zt = self.cfg.loss_zscore
        with self._lock:
            window = list(self._losses)
            self._losses.append(loss)
        if zt > 0 and len(window) >= max(8, self.cfg.loss_window // 4):
            mean = sum(window) / len(window)
            var = sum((x - mean) ** 2 for x in window) / len(window)
            # std floor: an early flat window (or constant synthetic
            # data) would alarm on any wiggle at all without it
            std = max(math.sqrt(var), 1e-3, abs(mean) * 1e-3)
            z = (loss - mean) / std
            if z > zt:
                self._fire(
                    "loss_spike", step, loss=round(loss, 6),
                    window_mean=round(mean, 6), zscore=round(z, 2),
                )
                return
        self._rearm("loss_spike")

    def observe_drift(self, step: int, drift: float, **detail: Any) -> None:
        """Divergence sentinel (per-episode, like the other sentinels):
        called once per outer sync with the normalized cross-worker
        drift (`drift_max` from the dynamics metrics). Alarms when the
        drift exceeds ``drift_threshold`` — or is non-finite, which
        means a replica already blew up (quarantine territory; the
        sentinel exists to fire BEFORE that, but a NaN drift must never
        read as healthy)."""
        if self.cfg.drift_threshold <= 0:
            return
        drift = float(drift)
        if not math.isfinite(drift) or drift > self.cfg.drift_threshold:
            self._fire(
                "divergence", step,
                drift=(str(drift) if not math.isfinite(drift)
                       else round(drift, 6)),
                threshold=self.cfg.drift_threshold,
                **detail,
            )
            return
        self._rearm("divergence")

    def observe_throughput(self, step: int, tokens_per_sec: float) -> None:
        tps = float(tokens_per_sec)
        if not math.isfinite(tps) or tps <= 0:
            return
        frac = self.cfg.tps_collapse_frac
        with self._lock:
            window = sorted(self._tps)
            self._tps.append(tps)
        if frac > 0 and len(window) >= max(4, self.cfg.loss_window // 8):
            median = window[len(window) // 2]
            if tps < frac * median:
                self._fire(
                    "throughput_collapse", step,
                    tokens_per_sec=round(tps, 1),
                    rolling_median=round(median, 1),
                )
                return
        self._rearm("throughput_collapse")

    # -- heartbeat / stall ---------------------------------------------------

    def heartbeat(self, step: int, **status: Any) -> None:
        """Called once per round (or per step) by the train loop; extra
        kwargs land in status.json verbatim (last loss, tps, ...)."""
        now = self._clock()
        with self._lock:
            if self._last_beat is not None:
                self._beats.append(now - self._last_beat)
            self._last_beat = now
            self._last_step = int(step)
            self._status_extra.update(status)
        self._rearm("stall")
        flightrec.record_event("heartbeat", step=int(step), **status)
        self._write_status()

    def check_stall(self, now: float | None = None) -> bool:
        """True (and one alarm per episode) when the time since the last
        heartbeat exceeds ``stall_factor`` x the rolling mean beat
        interval (floored at ``min_stall_s``). Needs >=2 beats — there
        is no cadence to violate before that."""
        if self.cfg.stall_factor <= 0:
            return False
        now = self._clock() if now is None else now
        with self._lock:
            last, beats, step = self._last_beat, list(self._beats), self._last_step
        if last is None or not beats:
            return False
        mean_beat = sum(beats) / len(beats)
        limit = max(self.cfg.stall_factor * mean_beat, self.cfg.min_stall_s)
        silent = now - last
        if silent > limit:
            self._fire(
                "stall", step,
                silent_s=round(silent, 1), limit_s=round(limit, 1),
                mean_round_s=round(mean_beat, 2),
            )
            return True
        return False

    def start(self) -> None:
        """Start the daemon heartbeat-checker thread (no-op when stall
        detection is disabled)."""
        if self.cfg.stall_factor <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._poll_loop, name="nanodiloco-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self, final_status: str = "finished") -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.cfg.poll_s + 1)
            self._thread = None
        with self._lock:
            # status_doc() answers with this from now on — a /healthz
            # probe after teardown must see crashed/finished, not a
            # stale "running"
            self._final_state = final_status
        self._write_status(state=final_status)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.check_stall()
            except Exception:
                # the watchdog must never take the training loop down
                pass

    # -- status.json / live status ------------------------------------------

    def _status_doc_locked(self, state: str) -> dict:
        """Build the status document; caller holds ``self._lock``."""
        stalled = not self._armed["stall"]
        now = time.time()
        return {
            "state": "stalled" if (state == "running" and stalled) else state,
            "step": self._last_step,
            "updated_unix": now,
            "started_unix": self._started_unix,
            "uptime_s": round(now - self._started_unix, 3),
            "alarms": self._alarm_count,
            **({"alarm_kinds": dict(self._alarm_kinds)}
               if self._alarm_kinds else {}),
            **({"last_alarm": self._last_alarm} if self._last_alarm else {}),
            **self._status_extra,
        }

    def status_doc(self) -> dict:
        """The live status document — exactly what ``--status-file``
        writes, but returned in-process so a PULL consumer (the
        telemetry server's /healthz) never has to round-trip through
        disk. After ``stop()`` it reports the final state."""
        with self._lock:
            return self._status_doc_locked(self._final_state or "running")

    def _write_status(self, state: str = "running") -> None:
        if not self.status_path:
            return
        # the whole build+write+rename runs under the lock: the daemon
        # thread (stall alarm) and the train loop (heartbeat) share ONE
        # tmp file, and interleaved writes into it would let os.replace
        # publish garbled JSON — the exact torn state tmp+rename exists
        # to prevent
        with self._lock:
            doc = self._status_doc_locked(state)
            tmp = self.status_path + ".tmp"
            try:
                d = os.path.dirname(os.path.abspath(self.status_path))
                os.makedirs(d, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, self.status_path)  # atomic for POLLERS
            except OSError:
                pass  # a full disk must not kill training
