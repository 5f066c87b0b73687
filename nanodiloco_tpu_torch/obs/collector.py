"""Fleet metric collector: scrape /metrics endpoints into time series.

Every tier of this system already EXPOSES gauges — the trainer's
TelemetryServer, each serve replica, the fleet router — but a gauge is
a point in time: nobody watches the fleet OVER time, so nothing can say
"TTFT p95 has been over budget for 40 of the last 60 seconds" (the
question an SLO burn rate asks, obs/slo.py) and an incident leaves no
timeline behind. MegaScale's operability premise (arXiv:2402.15627) is
continuous collection plus cross-component joins; this module is the
collection half, stdlib only, in the repo's own dialect:

- ``parse_exposition`` — a STRUCTURED OpenMetrics parser that
  round-trips ``render_exposition`` (obs/telemetry.py): gauges,
  counters (the family-name / ``_total``-sample split), labeled
  histogram families (cumulative ``_bucket{le=...}`` + ``_count`` /
  ``_sum``), and label values with the three escaped characters
  (``\\``, ``"``, newline) — unescaped in a single pass, because the
  sequential-``str.replace`` shortcut corrupts a literal backslash
  followed by ``n``. ``render_exposition(parse_exposition(text))``
  reproduces ``text`` byte-for-byte for everything this repo emits
  (property-tested), so the scrape path and the exposition path cannot
  drift.
- ``SeriesStore`` — bounded per-series ring buffers of ``(t, value)``
  samples (oldest evicted; a collector watching a week-long run must
  not grow without bound) with the query surface the SLO engine needs:
  windowed samples, windowed mean/max/min, counter ``increase``/
  ``rate`` (positive deltas only, so a process restart reads as a
  reset, not a negative rate), nearest-rank percentiles over a
  window, and the FORECASTING queries the autoscaler acts on
  (``fleet/autoscaler.py``): ``slope`` (Theil-Sen robust trend,
  counter-reset tolerant) and ``forecast_exhaustion`` (seconds until
  a series crosses a floor/ceiling at the current trend).
- ``Collector`` — the scrape loop over named targets. Clock, wall
  clock, sleep, and the HTTP fetch are all injectable (tests script a
  fleet with a fake clock and no sockets; the default fetch is the
  ``serve/client`` wire helper), every sample lands in the store keyed
  ``target:sample`` with the label text kept verbatim
  (``r0:nanodiloco_serve_requests_total{outcome="error"}``), and each
  scrape optionally appends a snapshot record to a JSONL so ``report
  timeseries`` can render the incident's timeline after the fact.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Callable

from nanodiloco_tpu_torch.obs.telemetry import (
    _fmt,
    _render_labels,
    nearest_rank_percentile,
    render_exposition,
)

# -- the exposition parser (the consumer half of render_exposition) ----------


def _unescape_label_value(s: str) -> str:
    """Invert ``escape_label_value`` in ONE pass. Sequential
    ``.replace`` calls are wrong here: a literal backslash followed by
    the letter n escapes to ``\\\\n`` (three backslash-ish chars), and
    replacing ``\\n`` first would turn the tail of it into a newline."""
    out: list[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            elif nxt == "r":
                # the renderer's CR extension (escape_label_value): a
                # raw CR would tear the line-oriented format, so it
                # travels escaped and is restored here
                out.append("\r")
            else:  # unknown escape: keep verbatim (tolerant)
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _unescape_help(s: str) -> str:
    """Invert ``_escape_help`` (backslash, newline, and the CR
    extension)."""
    out: list[str] = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            if s[i + 1] == "\\":
                out.append("\\")
                i += 2
                continue
            if s[i + 1] == "n":
                out.append("\n")
                i += 2
                continue
            if s[i + 1] == "r":
                out.append("\r")
                i += 2
                continue
        out.append(s[i])
        i += 1
    return "".join(out)


def _parse_labels(s: str) -> tuple[dict[str, str], str]:
    """Parse ``{k="v",...}`` at the head of ``s`` with a real scanner
    (escaped quotes and backslashes inside values; a naive split on
    ``","``/``"="`` corrupts both). Returns ``(labels, rest)`` where
    ``rest`` is everything after the closing brace."""
    assert s[0] == "{"
    labels: dict[str, str] = {}
    i = 1
    while i < len(s) and s[i] != "}":
        j = s.index("=", i)
        name = s[i:j].strip().lstrip(",").strip()
        i = j + 1
        if i >= len(s) or s[i] != '"':
            raise ValueError(f"label {name!r} value is not quoted")
        i += 1
        raw: list[str] = []
        while i < len(s):
            if s[i] == "\\" and i + 1 < len(s):
                raw.append(s[i:i + 2])
                i += 2
                continue
            if s[i] == '"':
                break
            raw.append(s[i])
            i += 1
        if i >= len(s):
            raise ValueError("unterminated label value")
        labels[name] = _unescape_label_value("".join(raw))
        i += 1  # past the closing quote
        if i < len(s) and s[i] == ",":
            i += 1
    if i >= len(s):
        raise ValueError("unterminated label set")
    return labels, s[i + 1:]


def _split_exemplar(rest: str) -> tuple[str, tuple[dict, float] | None]:
    """Split an OpenMetrics exemplar suffix (`` # {labels} value``) off
    the text FOLLOWING a sample's label set (safe: label values were
    already consumed, so a ``#`` here cannot be inside a quoted
    string). Returns ``(value_text, exemplar_or_None)`` with exemplar
    as ``(labels, value)``. A malformed suffix is kept in the value
    text untouched — tolerance belongs to the caller's float()."""
    cut = rest.find(" # ")
    if cut < 0:
        return rest, None
    head, tail = rest[:cut], rest[cut + 3:].strip()
    if not tail.startswith("{"):
        return rest, None
    try:
        ex_labels, ex_rest = _parse_labels(tail)
        parts = ex_rest.strip().split()
        if not parts:
            return rest, None
        return head, (ex_labels, float(parts[0]))
    except (ValueError, IndexError):
        return rest, None


def parse_sample_line_ex(
    line: str,
) -> tuple[str, dict[str, str] | None, float, tuple[dict, float] | None]:
    """One exposition sample line -> ``(sample_name, labels, value,
    exemplar)`` where ``exemplar`` is ``(labels, value)`` from an
    OpenMetrics `` # {...} v`` suffix, or None. Raises ValueError on
    anything that is not a sample (comments, blanks, junk) — callers
    decide how tolerant to be."""
    line = line.strip()
    if not line or line.startswith("#"):
        raise ValueError("not a sample line")
    brace = line.find("{")
    if brace >= 0:
        name = line[:brace]
        labels, rest = _parse_labels(line[brace:])
        rest, ex = _split_exemplar(rest)
        parts = rest.strip().split()
        if not parts:  # truncated line: ValueError, never IndexError —
            # scrape_once's per-target isolation catches ValueError
            raise ValueError(f"no value on sample line: {line!r}")
        return name, labels, float(parts[0]), ex
    parts = line.split()
    if len(parts) < 2:
        raise ValueError(f"no value on sample line: {line!r}")
    return parts[0], None, float(parts[1]), None


def parse_sample_line(line: str) -> tuple[str, dict[str, str] | None, float]:
    """One exposition sample line -> ``(sample_name, labels, value)``,
    exemplar-tolerant (an OpenMetrics `` # {...} v`` suffix is parsed
    and dropped). Raises ValueError on non-sample lines."""
    name, labels, value, _ex = parse_sample_line_ex(line)
    return name, labels, value


def sample_key(name: str, labels: dict[str, str] | None) -> str:
    """The canonical flat key for one sample — EXACTLY the text
    ``render_exposition`` emits for it (label order preserved, values
    escaped), so keys survive a parse->flatten->compare round trip."""
    if labels:
        return f"{name}{{{_render_labels(labels)}}}"
    return name


def parse_exposition(text: str) -> list:
    """Parse an OpenMetrics exposition into the SAME ``families``
    structure ``render_exposition`` consumes: ``(name, type, help,
    samples)`` with gauge/counter samples as ``[(labels_or_None,
    value)]`` and histogram samples as ``[(labels_or_None,
    {"buckets": [...], "count": n, "sum": s})]``.

    Strict about this repo's dialect (it must round-trip byte-for-byte:
    ``render_exposition(parse_exposition(t)) == t``), tolerant about
    the rest: unknown comment lines are skipped, samples arriving
    before any ``# TYPE`` get an implicit untyped(gauge) family."""
    families: list = []
    meta: dict[str, tuple[str | None, str | None]] = {}  # name -> (help, type)
    order: list[str] = []
    raw: dict[str, list[tuple[str, dict | None, float]]] = {}

    def ensure(name: str) -> None:
        if name not in meta:
            meta[name] = (None, None)
            order.append(name)
            raw[name] = []

    current: str | None = None
    for line in text.split("\n"):
        stripped = line.strip()
        if not stripped:
            continue
        if stripped.startswith("#"):
            parts = stripped.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                ensure(name)
                h, t = meta[name]
                if parts[1] == "HELP":
                    h = _unescape_help(parts[3]) if len(parts) > 3 else ""
                else:
                    t = parts[3] if len(parts) > 3 else "untyped"
                meta[name] = (h, t)
                current = name
            continue  # EOF marker and foreign comments
        try:
            sname, labels, value, ex = parse_sample_line_ex(stripped)
        except ValueError:
            continue  # tolerant of junk lines in foreign expositions
        owner = None
        if current is not None:
            _, mtype = meta[current]
            suffixes = {
                "counter": ("_total",),
                "histogram": ("_bucket", "_count", "_sum"),
            }.get(mtype or "", ("",))
            if sname == current or any(
                sname == current + sfx for sfx in suffixes
            ):
                owner = current
        if owner is None:
            owner = sname
            ensure(owner)
        raw[owner].append((sname, labels, value, ex))

    for name in order:
        help_text, mtype = meta[name]
        samples = raw[name]
        if mtype == "histogram":
            series: dict[tuple, dict] = {}  # label-sig (minus le) -> snap
            sig_labels: dict[tuple, dict | None] = {}
            for sname, labels, value, ex in samples:
                rest = dict(labels or {})
                le = rest.pop("le", None)
                sig = tuple(sorted(rest.items()))
                if sig not in series:
                    series[sig] = {"buckets": [], "count": 0, "sum": 0.0}
                    sig_labels[sig] = rest or None
                snap = series[sig]
                if sname == name + "_bucket":
                    if le is None:  # foreign bucket without an le
                        # label: skip the sample, never crash the
                        # scrape (float(None) is a TypeError that
                        # would escape the per-target isolation)
                        continue
                    bound = le if le == "+Inf" else float(le)
                    snap["buckets"].append((bound, int(value)))
                    if ex is not None and "trace_id" in ex[0]:
                        # rebuild the snapshot's exemplars map so the
                        # byte round-trip holds with exemplars present
                        snap.setdefault("exemplars", {})[bound] = (
                            ex[0]["trace_id"], ex[1]
                        )
                elif sname == name + "_count":
                    snap["count"] = int(value)
                elif sname == name + "_sum":
                    snap["sum"] = float(value)
            fam_samples = [(sig_labels[sig], series[sig]) for sig in series]
        elif mtype == "counter":
            fam_samples = [
                (labels, value) for _sname, labels, value, _ex in samples
            ]
        else:
            fam_samples = [
                (labels, value) for _sname, labels, value, _ex in samples
            ]
        families.append((name, mtype or "untyped", help_text, fam_samples))
    return families


def flatten_families(families: list) -> dict[str, float]:
    """Families -> one flat ``{sample_key: value}`` dict, keys exactly
    as rendered (``name_total{label="v"}``), histograms expanded to
    their ``_bucket``/``_count``/``_sum`` samples — the shape the
    series store ingests."""
    out: dict[str, float] = {}
    for name, mtype, _help, samples in families:
        if mtype == "histogram":
            series = (
                [(None, samples)] if isinstance(samples, dict) else samples
            )
            for labels, snap in series:
                for le, cum in snap["buckets"]:
                    # telemetry's _fmt, not a local copy: the key/render
                    # byte parity depends on ONE formatting rule
                    le_s = le if isinstance(le, str) else _fmt(float(le))
                    bl = dict(labels or {})
                    bl["le"] = le_s
                    out[sample_key(name + "_bucket", bl)] = float(cum)
                out[sample_key(name + "_count", labels)] = float(snap["count"])
                out[sample_key(name + "_sum", labels)] = float(snap["sum"])
            continue
        sname = name + "_total" if mtype == "counter" else name
        for labels, value in samples:
            out[sample_key(sname, labels)] = float(value)
    return out


# -- the time-series store ----------------------------------------------------


class SeriesStore:
    """Bounded per-series ring buffers of ``(t, value)`` samples.
    ``maxlen`` bounds EVERY series (oldest samples evicted); all reads
    and writes are lock-guarded — the scrape loop appends while the SLO
    evaluator and HTTP threads query."""

    def __init__(self, maxlen: int = 2048, *,
                 long_bucket_s: float = 60.0,
                 long_maxlen: int = 1024) -> None:
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1; got {maxlen}")
        if long_bucket_s <= 0:
            raise ValueError(
                f"long_bucket_s must be > 0; got {long_bucket_s}"
            )
        if long_maxlen < 1:
            raise ValueError(f"long_maxlen must be >= 1; got {long_maxlen}")
        self.maxlen = int(maxlen)
        # long-horizon retention tier BEHIND the ring buffers: every
        # sample also lands in a time-bucketed downsample (one point
        # per ``long_bucket_s``, the bucket's LAST value — the same
        # convention a counter scrape keeps), bounded by
        # ``long_maxlen`` buckets. At the defaults that is ~17 hours
        # of per-minute trend per series behind a ~2048-sample ring —
        # the forecaster and the offline dashboard keep multi-hour
        # history without unbounded memory.
        self.long_bucket_s = float(long_bucket_s)
        self.long_maxlen = int(long_maxlen)
        self._series: dict[str, collections.deque] = {}
        # key -> (closed-bucket deque of (bucket_start_t, last_value),
        #         open bucket id or None, open bucket's last value)
        self._long: dict[str, collections.deque] = {}
        self._long_open: dict[str, tuple[int, float]] = {}
        self._lock = threading.Lock()

    def add(self, key: str, t: float, value: float) -> None:
        t = float(t)
        value = float(value)
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = collections.deque(maxlen=self.maxlen)
            dq.append((t, value))
            # feed the long tier: flush the open bucket when this
            # sample starts a later one (out-of-order samples within a
            # flushed bucket are rare and simply start a new bucket)
            bucket = int(t // self.long_bucket_s)
            open_ = self._long_open.get(key)
            if open_ is not None and open_[0] != bucket:
                ldq = self._long.get(key)
                if ldq is None:
                    ldq = self._long[key] = collections.deque(
                        maxlen=self.long_maxlen
                    )
                ldq.append((open_[0] * self.long_bucket_s, open_[1]))
            self._long_open[key] = (bucket, value)

    def long_window(self, key: str, since: float,
                    until: float | None = None) -> list[tuple[float, float]]:
        """Downsampled long-horizon samples (one per bucket, the
        bucket's last value, stamped at the bucket start), oldest
        first; the still-open bucket is included, stamped at its own
        bucket start. The dashboard's multi-hour trend source."""
        with self._lock:
            samples = list(self._long.get(key, ()))
            open_ = self._long_open.get(key)
            if open_ is not None:
                samples.append(
                    (open_[0] * self.long_bucket_s, open_[1])
                )
        return [
            (t, v) for t, v in samples
            if t >= since and (until is None or t <= until)
        ]

    def long_snapshot(self) -> dict[str, list[tuple[float, float]]]:
        """Every series' long-tier samples (open bucket included)."""
        with self._lock:
            keys = set(self._long) | set(self._long_open)
        return {k: self.long_window(k, float("-inf")) for k in sorted(keys)}

    def keys(self, contains: str | None = None) -> list[str]:
        with self._lock:
            ks = list(self._series)
        if contains:
            ks = [k for k in ks if contains in k]
        return sorted(ks)

    def latest(self, key: str) -> tuple[float, float] | None:
        with self._lock:
            dq = self._series.get(key)
            return dq[-1] if dq else None

    def window(self, key: str, since: float,
               until: float | None = None) -> list[tuple[float, float]]:
        """Samples with ``since <= t`` (and ``t <= until`` when given),
        oldest first."""
        with self._lock:
            dq = self._series.get(key)
            if not dq:
                return []
            samples = list(dq)
        return [
            (t, v) for t, v in samples
            if t >= since and (until is None or t <= until)
        ]

    def agg(self, key: str, window_s: float, now: float,
            fn: str = "mean") -> float | None:
        """Windowed aggregate over the last ``window_s`` seconds:
        ``mean``/``max``/``min``/``last``; None with no samples."""
        vals = [v for _, v in self.window(key, now - window_s, now)]
        if not vals:
            return None
        if fn == "mean":
            return sum(vals) / len(vals)
        if fn == "max":
            return max(vals)
        if fn == "min":
            return min(vals)
        if fn == "last":
            return vals[-1]
        raise ValueError(f"unknown aggregate {fn!r}")

    def percentile(self, key: str, p: float, window_s: float,
                   now: float) -> float | None:
        """Nearest-rank percentile of the windowed samples (the same
        definition every other percentile in this repo uses)."""
        vals = sorted(v for _, v in self.window(key, now - window_s, now))
        return nearest_rank_percentile(vals, p)

    def increase(self, key: str, window_s: float,
                 now: float) -> float | None:
        """Counter increase over the window: the sum of POSITIVE
        deltas, so a process restart (the counter drops to 0) reads as
        a reset rather than a huge negative rate. None with fewer than
        two samples in the window."""
        samples = self.window(key, now - window_s, now)
        if len(samples) < 2:
            return None
        inc = 0.0
        for (_, a), (_, b) in zip(samples, samples[1:]):
            if b > a:
                inc += b - a
        return inc

    def rate(self, key: str, window_s: float, now: float) -> float | None:
        """Per-second counter rate over the window (increase / elapsed
        between the first and last windowed samples)."""
        samples = self.window(key, now - window_s, now)
        if len(samples) < 2:
            return None
        elapsed = samples[-1][0] - samples[0][0]
        if elapsed <= 0:
            return None
        inc = self.increase(key, window_s, now)
        return None if inc is None else inc / elapsed

    # Theil-Sen is O(n^2) in pair count; windows are resampled down to
    # this many points first (evenly strided, newest kept) so a maxed-out
    # ring buffer cannot turn one autoscaler tick into ~2M pair slopes
    _SLOPE_MAX_POINTS = 48

    def slope(self, key: str, window_s: float, now: float,
              *, counter: bool = False) -> float | None:
        """Robust per-second trend over the window: the Theil-Sen
        estimator (median of all pairwise slopes), so one garbage sample
        — a scrape racing a restart, a transient spike — cannot swing
        the estimate the way least-squares would, and the autoscaler
        never acts on a phantom trend.

        With ``counter=True`` the samples are first folded into a
        monotone cumulative series using the same positive-deltas-only
        rule as ``increase()``: a process restart (counter drops toward
        0) reads as a reset, not a cliff of negative slope. None with
        fewer than two samples or no elapsed time."""
        samples = self.window(key, now - window_s, now)
        if len(samples) < 2:
            return None
        if samples[-1][0] - samples[0][0] <= 0:
            return None
        if counter:
            folded: list[tuple[float, float]] = [(samples[0][0], 0.0)]
            cum = 0.0
            for (_, a), (t, b) in zip(samples, samples[1:]):
                if b > a:
                    cum += b - a
                folded.append((t, cum))
            samples = folded
        if len(samples) > self._SLOPE_MAX_POINTS:
            stride = len(samples) / self._SLOPE_MAX_POINTS
            samples = [
                samples[min(len(samples) - 1, int(i * stride))]
                for i in range(self._SLOPE_MAX_POINTS - 1)
            ] + [samples[-1]]
        slopes: list[float] = []
        for i in range(len(samples)):
            t0, v0 = samples[i]
            for t1, v1 in samples[i + 1:]:
                if t1 > t0:
                    slopes.append((v1 - v0) / (t1 - t0))
        if not slopes:
            return None
        slopes.sort()
        mid = len(slopes) // 2
        if len(slopes) % 2:
            return slopes[mid]
        return (slopes[mid - 1] + slopes[mid]) / 2.0

    def forecast_exhaustion(self, key: str, bound: float, window_s: float,
                            now: float, *,
                            kind: str = "floor") -> float | None:
        """Seconds until the series crosses ``bound`` at its current
        ``slope()`` — the question "when does ``kv_blocks_free`` hit 0"
        or "when does queue depth hit slot capacity", asked of the
        trend rather than the point gauge. ``kind="floor"`` forecasts a
        falling series crossing down through the bound; ``"ceiling"`` a
        rising series crossing up. Returns 0.0 when the latest sample
        is already past the bound, None when the series is trending
        away from it (or has no usable trend)."""
        if kind not in ("floor", "ceiling"):
            raise ValueError(f"kind must be 'floor' or 'ceiling'; got "
                             f"{kind!r}")
        last = self.latest(key)
        if last is None:
            return None
        _, v = last
        if kind == "floor" and v <= bound:
            return 0.0
        if kind == "ceiling" and v >= bound:
            return 0.0
        s = self.slope(key, window_s, now)
        if s is None:
            return None
        if kind == "floor":
            return (bound - v) / s if s < 0 else None
        return (bound - v) / s if s > 0 else None

    def snapshot(self) -> dict[str, list[tuple[float, float]]]:
        with self._lock:
            return {k: list(dq) for k, dq in self._series.items()}


# -- the scrape loop ----------------------------------------------------------


def _default_fetch(url: str, timeout: float) -> str:
    from nanodiloco_tpu_torch.serve.client import http_get

    code, body = http_get(url, timeout=timeout)
    if code != 200:
        raise OSError(f"scrape answered {code}")
    return body


class Collector:
    """Poll each target's ``/metrics`` on a cadence into a SeriesStore.

    ``targets`` is ``[(name, base_url)]``; the series key is
    ``name:sample`` with the sample's label text verbatim. ``fetch``,
    ``clock`` (monotonic — the store's timebase), ``wall``, and
    ``sleep`` are injectable so every scrape decision is testable with
    a scripted fleet and a fake clock. When ``series_jsonl`` is set,
    each scrape appends one ``{"series": target, "t_unix", "t",
    "samples": {...}}`` record per reachable target — the artifact
    ``report timeseries`` renders after the incident."""

    def __init__(
        self,
        targets: list[tuple[str, str]],
        *,
        interval_s: float = 1.0,
        timeout_s: float = 5.0,
        fetch: Callable[[str, float], str] | None = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        store: SeriesStore | None = None,
        maxlen: int = 2048,
        series_jsonl: str | None = None,
    ) -> None:
        if not targets:
            raise ValueError("a collector needs at least one target")
        names = [n for n, _ in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"target names must be unique; got {names}")
        self.targets = [(str(n), str(u).rstrip("/")) for n, u in targets]
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._fetch = fetch or _default_fetch
        self._clock = clock
        self._wall = wall
        self._sleep = sleep
        self.store = store or SeriesStore(maxlen=maxlen)
        self.series_jsonl = series_jsonl
        self._jsonl_lock = threading.Lock()
        self.scrapes = 0
        self.scrape_errors: dict[str, int] = {}
        self.last_scrape_t: float | None = None

    def key(self, target: str, sample: str) -> str:
        return f"{target}:{sample}"

    def set_targets(self, targets: list[tuple[str, str]]) -> None:
        """Replace the target set (the fleet autoscaler follows elastic
        membership with this: launched replicas start being scraped,
        retired ones stop). Series already collected for a departed
        target stay in the store — history must survive the replica."""
        if not targets:
            raise ValueError("a collector needs at least one target")
        names = [n for n, _ in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"target names must be unique; got {names}")
        self.targets = [(str(n), str(u).rstrip("/")) for n, u in targets]

    def scrape_once(self) -> dict[str, Any]:
        """One sweep over every target: fetch, parse, store. Returns
        ``{target: sample_count | {"error": ...}}`` — a failed target
        never aborts the sweep (an unreachable replica is exactly when
        the rest of the fleet's series matter most)."""
        now = self._clock()
        out: dict[str, Any] = {}
        for name, url in self.targets:
            try:
                text = self._fetch(url + "/metrics", self.timeout_s)
                samples = flatten_families(parse_exposition(text))
            except (OSError, ValueError) as e:
                self.scrape_errors[name] = self.scrape_errors.get(name, 0) + 1
                out[name] = {"error": f"{type(e).__name__}: {e}"}
                continue
            for sample, value in samples.items():
                if math.isnan(value):
                    continue  # a NaN sample poisons every window query
                self.store.add(self.key(name, sample), now, value)
            out[name] = len(samples)
            self._append_snapshot(name, now, samples)
        self.scrapes += 1
        self.last_scrape_t = now
        return out

    def _append_snapshot(self, target: str, t: float,
                         samples: dict[str, float]) -> None:
        if not self.series_jsonl:
            return
        rec = {
            "series": target,
            "t_unix": round(self._wall(), 3),
            "t": round(t, 6),
            "samples": samples,
        }
        try:
            d = os.path.dirname(os.path.abspath(self.series_jsonl))
            os.makedirs(d, exist_ok=True)
            with self._jsonl_lock, open(self.series_jsonl, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # a full disk must not take down collection

    def run(self, stop: threading.Event | None = None,
            max_scrapes: int | None = None,
            on_scrape: Callable[[dict], None] | None = None) -> None:
        """Scrape until ``stop`` is set (or ``max_scrapes`` exhausted).
        ``on_scrape`` runs after every sweep — the SLO monitor's
        evaluate hook rides here, so collection and evaluation share
        one cadence."""
        n = 0
        while stop is None or not stop.is_set():
            result = self.scrape_once()
            if on_scrape is not None:
                on_scrape(result)
            n += 1
            if max_scrapes is not None and n >= max_scrapes:
                return
            if stop is not None:
                stop.wait(self.interval_s)
            else:
                self._sleep(self.interval_s)

    def render_metrics(self) -> str:
        """The collector's OWN exposition (the obs-watch endpoint):
        scrape counters and per-target error counts — the watcher is
        itself watchable."""
        families: list = [
            ("nanodiloco_obs_scrapes", "counter",
             "collector scrape sweeps completed", [(None, self.scrapes)]),
            ("nanodiloco_obs_series", "gauge",
             "distinct series held in the ring-buffer store",
             [(None, len(self.store.keys()))]),
        ]
        if self.scrape_errors:
            families.append((
                "nanodiloco_obs_scrape_errors", "counter",
                "failed scrape attempts by target",
                [({"target": t}, n)
                 for t, n in sorted(self.scrape_errors.items())]
                + [(None, sum(self.scrape_errors.values()))],
            ))
        return render_exposition(families)


# -- after-the-fact timeline (report timeseries) ------------------------------

SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 60) -> str:
    """ASCII(-ish) sparkline of a series, resampled to ``width`` points
    (stride sampling keeps the newest point). Flat series render as a
    mid-level bar, not a crash into the bottom glyph."""
    if not values:
        return ""
    width = max(1, int(width))  # --width 0 must not divide by zero
    if len(values) > width:
        stride = len(values) / width
        values = [values[min(len(values) - 1, int(i * stride))]
                  for i in range(width - 1)] + [values[-1]]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return SPARK_CHARS[3] * len(values)
    span = hi - lo
    return "".join(
        SPARK_CHARS[min(len(SPARK_CHARS) - 1,
                        int((v - lo) / span * len(SPARK_CHARS)))]
        for v in values
    )


def read_series_jsonl(path: str) -> dict[str, list[tuple[float, float]]]:
    """Collector snapshot JSONL -> ``{target:sample: [(t_unix, v)]}``,
    torn trailing lines tolerated (the collector may still be
    appending)."""
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    recs, _torn = read_jsonl_records(path)
    out: dict[str, list[tuple[float, float]]] = {}
    for r in recs:
        target = r.get("series")
        samples = r.get("samples")
        t = r.get("t_unix", r.get("t"))
        if not target or not isinstance(samples, dict) or t is None:
            continue
        for sample, value in samples.items():
            if isinstance(value, (int, float)):
                out.setdefault(f"{target}:{sample}", []).append(
                    (float(t), float(value))
                )
    return out
