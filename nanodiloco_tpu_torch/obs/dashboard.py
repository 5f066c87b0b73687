"""Offline metrics dashboard: one self-contained static HTML page.

The incident question "what did the fleet do" must be answerable with
NOTHING running — no collector, no replicas, no plotting stack, no
network. ``render_dashboard`` turns a series dict (from a collector
``--series-jsonl`` artifact, or synthesized from a serve stats JSONL)
into a single HTML file: unicode-sparkline tables for SLO burn, fleet
goodput, the device-second budget by program, cost per class, and a
capacity forecast, styled by an inline stylesheet. No scripts, no
external fetches — the artifact opens from disk years later.

Section routing is substring-based over the ``target:sample`` keys the
collector writes (``flatten_families`` naming: counters carry
``_total``, labels verbatim), so the page organizes any fleet's scrape
without a per-deployment config. The capacity forecast reuses the
collector's Theil-Sen ``slope``/``forecast_exhaustion`` by replaying
the samples through a throwaway ``SeriesStore`` — ONE trend estimator
in the repo, online and offline.
"""

from __future__ import annotations

import html
import json

from nanodiloco_tpu_torch.obs.collector import SeriesStore, sparkline

Series = dict[str, list[tuple[float, float]]]

# (section title, blurb, substring matchers) — first match wins, so a
# key lands in exactly one section
_SECTIONS: list[tuple[str, str, tuple[str, ...]]] = [
    ("SLO burn",
     "multi-window burn-rate alerting state: alert counts, burning "
     "pairs, cumulative burn seconds",
     ("nanodiloco_slo_",)),
    ("Fleet goodput",
     "replica-seconds serving-and-ready over every tracked "
     "replica-second, plus fleet membership state",
     ("fleet_goodput_fraction", "fleet_replicas", "fleet_state_seconds",
      "goodput_fraction")),
    ("Device-second budget by program",
     "fence-timed dispatch and compile seconds per compiled program "
     "(kind:bucket:layout)",
     ("nanodiloco_device_seconds", "nanodiloco_compile_seconds",
      "fleet_replica_device_seconds")),
    ("Cost per class",
     "attributed device-seconds and KV block-seconds by SLO priority "
     "class — the billing rollup",
     ("serve_device_seconds", "serve_kv_block_seconds",
      "decode_interference_ratio")),
    ("Capacity forecast",
     "the supply/demand gauges the predictive autoscaler trends: KV "
     "headroom, queue depth, slots (Theil-Sen slope per second; "
     "exhaustion ETA when the trend crosses the bound)",
     ("kv_blocks_free", "serve_queue_depth", "serve_slots_busy",
      "forecast_")),
]

_STYLE = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2rem auto; max-width: 72rem; color: #1a2330;
       background: #fafbfc; }
h1 { font-size: 1.4rem; border-bottom: 2px solid #2b6cb0;
     padding-bottom: .3rem; }
h2 { font-size: 1.05rem; margin-top: 2rem; color: #2b6cb0; }
p.blurb { color: #5a6675; font-size: .85rem; margin: .2rem 0 .6rem; }
table { border-collapse: collapse; width: 100%; font-size: .8rem; }
th, td { text-align: left; padding: .25rem .6rem;
         border-bottom: 1px solid #e3e8ee; }
th { color: #5a6675; font-weight: 600; }
td.spark { font-family: 'SF Mono', Menlo, Consolas, monospace;
           font-size: .9rem; color: #2b6cb0; letter-spacing: -1px;
           white-space: nowrap; }
td.num { font-variant-numeric: tabular-nums; white-space: nowrap; }
td.key { font-family: 'SF Mono', Menlo, Consolas, monospace;
         font-size: .75rem; word-break: break-all; }
p.empty { color: #8a94a3; font-style: italic; font-size: .85rem; }
footer { margin-top: 2.5rem; color: #8a94a3; font-size: .75rem;
         border-top: 1px solid #e3e8ee; padding-top: .5rem; }
"""


def _fmt(v: float | None) -> str:
    if v is None:
        return "—"
    return f"{v:.4g}"


def _section_rows(keys: list[str], series: Series, width: int) -> str:
    rows = []
    for key in keys:
        samples = series[key]
        vals = [v for _, v in samples]
        rows.append(
            "<tr>"
            f"<td class=key>{html.escape(key)}</td>"
            f"<td class=spark>{sparkline(vals, width=width)}</td>"
            f"<td class=num>{_fmt(min(vals))}</td>"
            f"<td class=num>{_fmt(max(vals))}</td>"
            f"<td class=num>{_fmt(vals[-1])}</td>"
            f"<td class=num>{len(vals)}</td>"
            "</tr>"
        )
    return "\n".join(rows)


def _forecast_rows(keys: list[str], series: Series) -> str:
    """Trend table for the capacity section: replay each series through
    a throwaway SeriesStore so the SAME Theil-Sen slope the live
    autoscaler acts on is what the offline page reports."""
    rows = []
    for key in keys:
        samples = series[key]
        store = SeriesStore(maxlen=max(2, len(samples)))
        for t, v in samples:
            store.add(key, t, v)
        t_last = samples[-1][0]
        window = max(1e-9, t_last - samples[0][0])
        slope = store.slope(key, window, t_last)
        eta = None
        if "free" in key or "slots" in key:
            eta = store.forecast_exhaustion(key, 0.0, window, t_last,
                                            kind="floor")
        slope_s = "—" if slope is None else f"{slope:+.4g}/s"
        eta_s = ("—" if eta is None
                 else ("now" if eta == 0.0 else f"{eta:.0f}s"))
        rows.append(
            "<tr>"
            f"<td class=key>{html.escape(key)}</td>"
            f"<td class=num>{_fmt(samples[-1][1])}</td>"
            f"<td class=num>{slope_s}</td>"
            f"<td class=num>{eta_s}</td>"
            "</tr>"
        )
    return "\n".join(rows)


def render_dashboard(series: Series, *, title: str = "nanodiloco fleet",
                     width: int = 60) -> str:
    """The page. Keys route to the first section whose substring
    matches; everything unmatched lands in a final "Other series"
    table so no scraped series silently vanishes from the artifact."""
    remaining = sorted(series)
    parts = [
        "<!DOCTYPE html>",
        "<html lang=\"en\"><head><meta charset=\"utf-8\">",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_STYLE}</style>",
        "</head><body>",
        f"<h1>{html.escape(title)} — offline metrics dashboard</h1>",
    ]
    header = ("<tr><th>series</th><th>trend</th><th>min</th><th>max</th>"
              "<th>last</th><th>n</th></tr>")
    for sec_title, blurb, needles in _SECTIONS:
        matched = [k for k in remaining
                   if any(n in k for n in needles)]
        remaining = [k for k in remaining if k not in matched]
        parts.append(f"<h2>{html.escape(sec_title)}</h2>")
        parts.append(f"<p class=blurb>{html.escape(blurb)}</p>")
        if not matched:
            parts.append("<p class=empty>no matching series in this "
                         "artifact</p>")
            continue
        parts.append(f"<table>{header}"
                     f"{_section_rows(matched, series, width)}</table>")
        if sec_title == "Capacity forecast":
            parts.append(
                "<table><tr><th>series</th><th>last</th>"
                "<th>Theil-Sen slope</th><th>exhaustion ETA</th></tr>"
                f"{_forecast_rows(matched, series)}</table>"
            )
    if remaining:
        parts.append("<h2>Other series</h2>")
        parts.append("<p class=blurb>every remaining scraped series — "
                     "nothing in the artifact is dropped</p>")
        parts.append(f"<table>{header}"
                     f"{_section_rows(remaining, series, width)}</table>")
    n_samples = sum(len(v) for v in series.values())
    parts.append(
        f"<footer>{len(series)} series · {n_samples} samples · "
        "rendered fully offline by <code>nanodiloco_tpu_torch report "
        "dashboard</code> — no scripts, no network</footer>"
    )
    parts.append("</body></html>")
    return "\n".join(parts)


def serve_stats_series(path: str) -> Series:
    """Synthesize a series dict from a serve stats JSONL (the
    ``--stats-jsonl`` artifact): each ``serve_stats`` record becomes
    one sample per scalar metric, keyed ``serve:<metric>`` in the same
    label syntax the collector writes, so ``render_dashboard`` routes
    them to the same sections a scraped fleet's series land in. Nested
    attribution dicts (devtime ledgers, per-class costs) expand into
    labeled keys. Records without ``t_unix`` (older JSONLs) use the
    record index as the time axis."""
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    recs, _torn = read_jsonl_records(path)
    out: Series = {}

    def add(sample: str, t: float, v: float) -> None:
        out.setdefault(f"serve:{sample}", []).append((t, float(v)))

    idx = 0.0
    for r in recs:
        if not r.get("serve_stats"):
            continue
        t = float(r.get("t_unix", idx))
        idx += 1.0
        for k, v in r.items():
            if isinstance(v, bool) or k in ("serve_stats", "t_unix"):
                continue
            if isinstance(v, (int, float)):
                add(k, t, v)
        dt = r.get("devtime")
        if isinstance(dt, dict):
            for ledger, family in (
                ("device_seconds_by_program",
                 "nanodiloco_device_seconds_total"),
                ("compile_seconds_by_program",
                 "nanodiloco_compile_seconds_total"),
            ):
                for prog, v in (dt.get(ledger) or {}).items():
                    add(f'{family}{{program="{prog}"}}', t, v)
        for rec_key, family in (
            ("device_seconds_by_priority",
             "nanodiloco_serve_device_seconds_total"),
            ("kv_block_seconds_by_priority",
             "nanodiloco_serve_kv_block_seconds_total"),
        ):
            for prio, v in (r.get(rec_key) or {}).items():
                add(f'{family}{{priority="{prio}"}}', t, v)
        kv = r.get("kv_pool")
        if isinstance(kv, dict):
            for k in ("blocks_free", "blocks_used"):
                if isinstance(kv.get(k), (int, float)):
                    add(f"nanodiloco_kv_{k}", t, kv[k])
    return out


def load_dashboard_series(path: str) -> Series:
    """Auto-detect the artifact flavor: collector snapshot records
    (``{"series": target, "samples": {...}}``) read via
    ``read_series_jsonl``; serve stats records via
    ``serve_stats_series``. Raises ``ValueError`` when neither yields
    a single series (a typo'd path should fail loudly, not render an
    empty page)."""
    from nanodiloco_tpu_torch.obs.collector import read_series_jsonl

    flavor = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                if rec.get("series") and isinstance(
                    rec.get("samples"), dict
                ):
                    flavor = "collector"
                    break
                if rec.get("serve_stats"):
                    flavor = "serve"
                    break
    if flavor == "collector":
        series = read_series_jsonl(path)
    elif flavor == "serve":
        series = serve_stats_series(path)
    else:
        raise ValueError(
            f"{path} holds neither collector series records nor "
            "serve_stats records"
        )
    if not series:
        raise ValueError(f"no usable series in {path}")
    return series
