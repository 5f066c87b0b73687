"""Device-time accounting: every dispatched second attributed to a program.

A copy of ``nanodiloco_tpu/obs/devtime.py`` (jax-free). In the port
the engine fences each section with ``torch.cuda.synchronize`` on the
card (a host read of the sampled tokens where there is one), and a
program's "compile" second is its first eager dispatch: cuBLAS
heuristics and the caching allocator's first growth.

MegaScale's every-second discipline (arXiv:2402.15627) applied one
level below the wall clock: the serving engine and the training loop
wrap every compiled-program call site — prefill chunk, decode tick,
verify window, weight swap; training round / outer boundary — in a
fence-timed section keyed by the same ``(kind, bucket, layout)``
scheme ``Engine.compile_counts()`` already uses, so "where do the
device-seconds go" has a scrapeable answer per executable instead of
one coarse decode-tick histogram.

Two ledgers, partitioned — every measured second lands in exactly one:

- ``device_seconds`` — warm dispatches of an already-compiled program.
- ``compile_seconds`` — the FIRST dispatch of each program key. Static
  shapes mean one key is one executable, so the first fence-timed
  section is the one that traces and compiles; booking it separately
  keeps warm-path rates honest (the first decode tick is ~1000x a warm
  one) and gives compile time its own budget line, the way the goodput
  ledger books ``compile_warmup``.

The sections are host-side fences (``perf_counter`` around a dispatch
that blocks on its outputs): on CPU they measure host compute, on an
accelerator dispatch + device execution. That is the honest contract
PERF.md records — attribution *structure* is pinned everywhere, the
absolute magnitudes are a chip-sitting claim.

``devtime_families()`` renders the two counter families
(``nanodiloco_device_seconds_total{program=...}`` /
``nanodiloco_compile_seconds_total{program=...}``) for BOTH /metrics
servers (serve's and the trainer's telemetry endpoint) from one
snapshot shape, so the exposition cannot drift between tiers.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable


def program_key(kind: str, bucket: int, layout: str) -> str:
    """One program's ledger key: ``kind:bucket:layout`` — the same
    naming ``Engine.compile_counts()`` reports cache sizes under, so an
    operator can line up "how many executables" with "how many seconds"
    without a translation table."""
    return f"{kind}:{int(bucket)}:{layout}"


class DispatchAccountant:
    """Thread-safe per-program device/compile-second ledgers.

    ``clock`` is injectable (tests drive sections with a scripted
    clock); all mutation is lock-guarded — the serve tick thread
    records while HTTP scrape threads snapshot."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._device_s: dict[str, float] = {}
        self._compile_s: dict[str, float] = {}
        self._dispatches: dict[str, int] = {}

    @contextmanager
    def section(self, kind: str, bucket: int, layout: str,
                *, first_is_compile: bool = True):
        """Fence-timed section around one program dispatch. The caller
        must block on the dispatch's outputs INSIDE the section (the
        fence is what makes the measurement mean anything under async
        dispatch). With ``first_is_compile`` (the default for jitted
        programs) the key's first section lands in the compile ledger;
        pass False for sites that never compile (weight swap is
        ``device_put`` + validation, warm from the start)."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(kind, bucket, layout, self._clock() - t0,
                        first_is_compile=first_is_compile)

    def record(self, kind: str, bucket: int, layout: str, seconds: float,
               *, first_is_compile: bool = True) -> None:
        """Book an already-measured fence-timed duration (call sites
        that time their dispatch anyway — the training loop's round
        fence — record the same number here rather than double-timing)."""
        key = program_key(kind, bucket, layout)
        s = max(0.0, float(seconds))
        with self._lock:
            n = self._dispatches.get(key, 0)
            self._dispatches[key] = n + 1
            if n == 0 and first_is_compile:
                self._compile_s[key] = self._compile_s.get(key, 0.0) + s
            else:
                self._device_s[key] = self._device_s.get(key, 0.0) + s

    def snapshot(self) -> dict:
        """The stats-JSONL / ``scheduler.stats()`` shape: rounded
        per-program ledgers plus dispatch counts. Keys sorted so the
        JSONL diffs cleanly run to run."""
        with self._lock:
            return {
                "device_seconds_by_program": {
                    k: round(v, 6) for k, v in sorted(self._device_s.items())
                },
                "compile_seconds_by_program": {
                    k: round(v, 6) for k, v in sorted(self._compile_s.items())
                },
                "dispatches_by_program": dict(sorted(self._dispatches.items())),
            }

    def total_device_seconds(self) -> float:
        """Warm-dispatch seconds across every program (the serve bench's
        measured-window numerator, via snapshot deltas)."""
        with self._lock:
            return sum(self._device_s.values())

    def reset(self) -> None:
        """Zero every ledger AND the first-dispatch memory — warm-up
        traffic (``Engine.warm_spec``, bench warm legs) must not leak
        into measured windows, the same contract as
        ``reset_spec_stats``. Compile state resets too: a post-reset
        first dispatch of a key is warm in reality (the executable is
        cached), so callers that want compile seconds kept should
        snapshot before resetting."""
        with self._lock:
            self._device_s.clear()
            self._compile_s.clear()
            self._dispatches.clear()

    def reset_device_seconds(self) -> None:
        """Zero the warm-dispatch ledger but KEEP compile seconds and
        the first-dispatch memory: warmup traffic (``warm_spec``'s
        ramp) is exactly when programs compile — those seconds are real
        and stay — while its throwaway warm ticks must not leak into
        the device-second budget, the ``reset_spec_stats`` contract."""
        with self._lock:
            self._device_s.clear()


def devtime_families(snapshot: dict | None) -> list:
    """``render_exposition`` families for one accountant snapshot —
    shared by the serve server, the trainer's telemetry endpoint, and
    the fleet router so ``nanodiloco_device_seconds`` /
    ``nanodiloco_compile_seconds`` are ONE family definition everywhere
    (the metrics-name lint depends on that)."""
    if not snapshot:
        return []
    families: list = []
    dev = snapshot.get("device_seconds_by_program") or {}
    if dev:
        families.append((
            "nanodiloco_device_seconds", "counter",
            "fence-timed seconds in warm compiled-program dispatches, "
            "by program (kind:bucket:layout — compile_counts keying)",
            [({"program": k}, v) for k, v in sorted(dev.items())]
            + [(None, round(sum(dev.values()), 6))],
        ))
    comp = snapshot.get("compile_seconds_by_program") or {}
    if comp:
        families.append((
            "nanodiloco_compile_seconds", "counter",
            "fence-timed seconds in each program's FIRST dispatch "
            "(trace + XLA compile under static shapes), by program",
            [({"program": k}, v) for k, v in sorted(comp.items())]
            + [(None, round(sum(comp.values()), 6))],
        ))
    return families
