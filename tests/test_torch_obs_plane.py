"""The port's fleet observability plane against the JAX package's:
``obs/collector.py`` (the OpenMetrics parser, ``SeriesStore`` and its
window / rate / slope / exhaustion queries, the scrape loop),
``obs/slo.py`` (multi-window burn-rate alerting and its action hook),
``obs/forecast.py`` (``CapacityModel``) and ``obs/dashboard.py``, and
the CLI that drives them (``obs-watch``, ``report timeseries``,
``report dashboard``).

Host logic only: both packages read the same expositions and series
(built from a numpy seed) on the same fake clocks, and must give the
same parses, query answers, alerts, forecasts and pages. One test runs
``obs-watch`` over a real socket.
"""

import functools
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import nanodiloco_tpu.obs.collector as jax_collector
import nanodiloco_tpu.obs.dashboard as jax_dashboard
import nanodiloco_tpu.obs.forecast as jax_forecast
import nanodiloco_tpu.obs.slo as jax_slo
import nanodiloco_tpu_torch.obs.collector as torch_collector
import nanodiloco_tpu_torch.obs.dashboard as torch_dashboard
import nanodiloco_tpu_torch.obs.forecast as torch_forecast
import nanodiloco_tpu_torch.obs.slo as torch_slo
from nanodiloco_tpu.cli import report_main as jax_report_main
from nanodiloco_tpu_torch.__main__ import main as torch_main
from nanodiloco_tpu_torch.__main__ import report_main as torch_report_main
from nanodiloco_tpu_torch.obs.telemetry import Histogram, render_exposition

COLLECTORS = {"jax": jax_collector, "torch": torch_collector}
NASTY = ["plain", 'quoted "v"', "back\\slash", "multi\nline", "trail\\", ""]


def within(seconds):
    """The test's own time limit: its body runs in a thread, and the
    test fails if that thread has not finished after ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # re-raised on the test's thread
                    box["error"] = e
            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            assert not t.is_alive(), f"{fn.__name__} took longer than {seconds} s"
            if "error" in box:
                raise box["error"]
        return run
    return wrap


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def families(seed: int) -> list:
    """Gauges, counters and labeled histograms (one with an exemplar),
    with label values carrying every escaped character."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        kind = ["gauge", "counter", "histogram", "gauge"][i]
        name = f"nanodiloco_plane_{i}"
        if kind == "histogram":
            series = []
            for s in range(2):
                h = Histogram(buckets=(0.001, 0.5, 2.5, 60.0))
                for v in rng.uniform(0, 100, size=int(rng.integers(0, 8))):
                    h.observe(float(v), exemplar=f"{s:032x}" if s else None)
                series.append(({"priority": str(s), "tag": NASTY[s + seed % 3]},
                               h.snapshot()))
            out.append((name, kind, "help with \\ and\nnewline", series))
            continue
        samples = [(None if j == 0 else {"kind": NASTY[(j + seed) % len(NASTY)],
                                         "worker": str(j)},
                    float(np.round(rng.uniform(-5, 5), 3))) for j in range(3)]
        out.append((name, kind, "plain help", samples))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_exposition_parse_matches_jax_and_round_trips(seed):
    text = render_exposition(families(seed))
    parsed = {n: m.parse_exposition(text) for n, m in COLLECTORS.items()}
    assert parsed["torch"] == parsed["jax"]
    assert render_exposition(parsed["torch"]) == text  # byte for byte
    flat = {n: m.flatten_families(parsed[n]) for n, m in COLLECTORS.items()}
    assert flat["torch"] == flat["jax"] and flat["torch"]
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    for ln in lines:
        assert torch_collector.parse_sample_line(ln) == jax_collector.parse_sample_line(ln)


def series_store(mod, seed: int):
    """One gauge (a noisy ramp), one counter with a reset, one sparse
    series, on a 1 Hz fake timebase with gaps."""
    rng = np.random.default_rng(seed)
    st = mod.SeriesStore(maxlen=64)
    t = 0.0
    c = 0.0
    for i in range(90):
        t += float(rng.choice([0.5, 1.0, 1.0, 3.0]))
        st.add("r0:gauge", t, float(40.0 - 0.4 * i + rng.normal(0, 1.5)))
        c = 0.0 if i == 50 else c + float(rng.integers(0, 5))
        st.add("r0:counter_total", t, c)
        if i % 9 == 0:
            st.add("r1:sparse", t, float(i))
    return st, t


@pytest.mark.parametrize("seed", range(3))
def test_series_store_queries_match_jax(seed):
    stores = {n: series_store(m, seed) for n, m in COLLECTORS.items()}
    answers = {}
    for name, (st, now) in stores.items():
        a = [st.keys(), st.keys("r0"), st.latest("r1:sparse"), st.snapshot(),
             st.long_snapshot()]
        for key in ("r0:gauge", "r0:counter_total", "r1:sparse", "missing"):
            for w in (2.0, 10.0, 45.0, 400.0):
                a += [st.window(key, now - w), st.long_window(key, now - w),
                      st.percentile(key, 0.95, w, now),
                      st.increase(key, w, now), st.rate(key, w, now),
                      st.slope(key, w, now), st.slope(key, w, now, counter=True),
                      st.forecast_exhaustion(key, 0.0, w, now)]
                a += [st.agg(key, w, now, fn) for fn in ("mean", "max", "min", "last")]
        answers[name] = a
    assert answers["torch"] == answers["jax"]


def test_collector_scrape_loop_matches_jax(tmp_path):
    """A scripted fleet (one target flaps unreachable, one returns a
    garbage body once) scraped on a fake clock: the same store, the
    same snapshot JSONL, the same error counts and self-exposition."""
    texts = [render_exposition(families(s)) for s in range(5)]

    def run(mod, d):
        clock = FakeClock()
        calls = {}

        def fetch(url, timeout):
            n = calls[url] = calls.get(url, 0) + 1
            if "r1" in url and n % 3 == 0:
                raise OSError("connection refused")
            if "r2" in url and n == 4:
                return "garbage{"
            return texts[(n + len(url)) % len(texts)]

        col = mod.Collector([("r0", "http://x/r0/"), ("r1", "http://x/r1"),
                             ("r2", "http://x/r2")], fetch=fetch, clock=clock,
                            wall=clock, sleep=clock.advance, maxlen=16,
                            series_jsonl=str(d / "series.jsonl"))
        results = []
        col.run(max_scrapes=6, on_scrape=results.append)
        col.set_targets([("r0", "http://x/r0")])
        results.append(col.scrape_once())
        return (results, col.store.snapshot(), col.scrape_errors, col.render_metrics(),
                (d / "series.jsonl").read_text(),
                mod.read_series_jsonl(str(d / "series.jsonl")))

    seen = {}
    for name, mod in COLLECTORS.items():
        (tmp_path / name).mkdir()
        seen[name] = run(mod, tmp_path / name)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][2] == {"r1": 2}


def slo_drill(mod, collector_mod, d):
    """Three replicas and a router on one fake clock: r1's TTFT burns
    then recovers, r2's error counter climbs, the fleet goodput dips;
    the hook fails once (a router mid-restart) and is retried."""
    rng = np.random.default_rng(7)
    clock = FakeClock(0.0)
    store = collector_mod.SeriesStore()
    rules = mod.standard_rules(ttft_p95_max_s=0.5, error_rate_max=0.2,
                               fleet_goodput_min=0.9, kv_blocks_free_min=4.0,
                               fast_window_s=4.0, slow_window_s=12.0,
                               clear_debounce_s=3.0)
    hooks = []

    def on_alert(rule, target, firing):
        hooks.append((rule.name, target, firing))
        if len(hooks) == 2:
            raise OSError("router restarting")

    mon = mod.SLOMonitor(store, rules, ["r0", "r1", "r2", "router"], clock=clock,
                         wall=lambda: 1e9 + clock(), alerts_jsonl=str(d / "alerts.jsonl"),
                         on_alert=on_alert)
    records, errs, total = [], 0.0, 0.0
    for tick in range(60):
        clock.advance(1.0)
        t = clock()
        burn = 15 <= tick < 35
        store.add(f"r0:{mod.TTFT_P95_KEY}", t, float(rng.uniform(0.05, 0.2)))
        store.add(f"r1:{mod.TTFT_P95_KEY}", t,
                  float(rng.uniform(0.8, 2.0) if burn else rng.uniform(0.05, 0.2)))
        total += 10
        errs += 4 if 20 <= tick < 40 else 0
        store.add(f"r2:{mod.REQUESTS_TOTAL_KEY}", t, total)
        store.add(f'r2:{mod.REQUESTS_ERROR_KEY}', t, errs)
        store.add(f"r2:{mod.KV_FREE_KEY}", t, float(20 - tick // 3))
        store.add(f"router:{mod.FLEET_GOODPUT_KEY}", t, 0.8 if 25 <= tick < 45 else 0.99)
        records += mon.evaluate()
        if tick in (20, 30, 50):
            records.append({"firing": mon.firing(), "fleet": mon.fleet_burning(),
                            "burn": mon.burn_seconds()})
    summary = mon.finalize()
    return (records, hooks, mon.hook_errors, summary, mon.render_metrics(),
            (d / "alerts.jsonl").read_text())


def test_slo_monitor_burn_alerts_match_jax(tmp_path):
    seen = {}
    for name, (mod, cmod) in {"jax": (jax_slo, jax_collector),
                              "torch": (torch_slo, torch_collector)}.items():
        (tmp_path / name).mkdir()
        seen[name] = slo_drill(mod, cmod, tmp_path / name)
    assert seen["torch"] == seen["jax"]
    records, hooks, hook_errors, summary, _, _ = seen["torch"]
    fired = {(r["slo_alert"], r["target"]) for r in records
             if r.get("state") == "firing"}
    assert ("short_ttft_p95_s", "r1") in fired and ("error_rate", "r2") in fired
    assert ("fleet_goodput_fraction", "router") in fired
    assert hook_errors == 1 and len(hooks) > len(fired)  # the failed one retried


def test_slo_rule_validation_and_router_hook():
    for mod in (jax_slo, torch_slo):
        for bad in (dict(kind="sideways"), dict(scope="planet"),
                    dict(fast_window_s=10.0, slow_window_s=5.0), dict(fast_burn=0.0)):
            with pytest.raises(ValueError):
                mod.SLORule("x", "k", 1.0, **bad)
    calls = {}
    for name, mod in (("jax", jax_slo), ("torch", torch_slo)):
        posted = []
        hook = mod.router_action_hook(lambda url, doc: posted.append((url, doc)) or (409, {}),
                                      "http://router/")
        rule = mod.standard_rules(ttft_p95_max_s=1.0)[0]
        with pytest.raises(OSError):
            hook(rule, "r0", True)
        calls[name] = posted
    assert calls["torch"] == calls["jax"]


def capacity_run(mod, cmod):
    store = cmod.SeriesStore()
    rng = np.random.default_rng(3)
    out = []
    for i in range(40):
        t = float(i)
        for tgt, kv0, dkv in (("r0", 100, -2.0), ("r1", 80, -0.5), ("auto1", 60, 0.0)):
            if tgt == "auto1" and i < 20:
                continue
            if tgt == "r1" and i > 30:
                continue  # stale: drops out of the supply
            store.add(f"{tgt}:{mod.QUEUE_DEPTH_SAMPLE}", t, float(i // 4 + rng.integers(0, 2)))
            store.add(f"{tgt}:{mod.KV_FREE_SAMPLE}", t, kv0 + dkv * i)
            store.add(f"{tgt}:{mod.SLOTS_TOTAL_SAMPLE}", t, 4.0)
            store.add(f"{tgt}:{mod.REQUESTS_TOTAL_SAMPLE}", t, float(3 * i))
    model = mod.CapacityModel(store, window_s=15.0)
    for now in (4.0, 10.0, 25.0, 39.0):
        e = model.estimate(now)
        out.append((model.targets(), e.to_dict(), e.exhaustion_s()))
    model.set_excluded(["r0"])
    out.append(model.estimate(39.0).to_dict())
    model.set_targets(["r1"])
    out.append((model.targets(), model.estimate(39.0).to_dict()))
    with pytest.raises(ValueError):
        mod.CapacityModel(store, window_s=0)
    return out


def test_capacity_model_forecasts_match_jax():
    assert (capacity_run(torch_forecast, torch_collector)
            == capacity_run(jax_forecast, jax_collector))


def dashboard_series():
    return {
        'r0:nanodiloco_device_seconds_total{program="decode:1:dense"}':
            [(0.0, 0.1), (1.0, 0.3), (2.0, 0.7)],
        'r0:nanodiloco_serve_device_seconds_total{priority="0"}': [(0.0, 0.05), (1.0, 0.15)],
        "r0:nanodiloco_kv_blocks_free": [(0.0, 90.0), (1.0, 60.0), (2.0, 30.0)],
        "router:nanodiloco_fleet_goodput_fraction": [(0.0, 1.0), (1.0, 0.97)],
        'watch:nanodiloco_slo_burning{rule="ttft<p95>",target="r0"}': [(0.0, 0.0), (1.0, 1.0)],
        "r0:nanodiloco_serve_tokens_total": [(0.0, 10.0), (1.0, 48.0)],
    }


def write_serve_stats(path):
    with open(path, "w") as f:
        for i in range(3):
            f.write(json.dumps({
                "serve_stats": True, "t_unix": 100.0 + i, "queue_depth": i, "slots_busy": 2,
                "devtime": {"device_seconds_by_program": {"decode:1:dense": 0.1 * (i + 1)},
                            "compile_seconds_by_program": {"decode:1:dense": 1.5}},
                "device_seconds_by_priority": {"0": 0.02 * (i + 1)},
                "kv_pool": {"blocks_free": 50 - i, "blocks_used": 10 + i}}) + "\n")


def page_of(html):
    """A page without its footer's CLI name (each package names its own)."""
    return html.replace("nanodiloco_tpu_torch report", "nanodiloco_tpu report")


def test_dashboard_matches_jax(tmp_path):
    pages = {n: page_of(m.render_dashboard(dashboard_series(), title="<fleet & co>", width=20))
             for n, m in (("jax", jax_dashboard), ("torch", torch_dashboard))}
    assert pages["torch"] == pages["jax"]
    assert "&lt;fleet &amp; co&gt;" in pages["torch"] and "<script" not in pages["torch"]
    assert page_of(torch_dashboard.render_dashboard({})) == jax_dashboard.render_dashboard({})
    stats = tmp_path / "stats.jsonl"
    write_serve_stats(stats)
    for fn in ("serve_stats_series", "load_dashboard_series"):
        assert getattr(torch_dashboard, fn)(str(stats)) == getattr(jax_dashboard, fn)(str(stats))
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    for mod in (jax_dashboard, torch_dashboard):
        with pytest.raises((ValueError, SystemExit)):
            mod.load_dashboard_series(str(bad))


class MetricsHandler(BaseHTTPRequestHandler):
    """A replica's /metrics: a queue that grows one request a scrape."""

    scrapes = 0

    def log_message(self, *a):
        pass

    def do_GET(self):
        type(self).scrapes += 1
        body = render_exposition([
            ("nanodiloco_serve_queue_depth", "gauge", "q", [(None, float(self.scrapes))]),
            ("nanodiloco_serve_ttft_p95_seconds", "gauge", "t", [(None, 2.0)]),
        ]).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@within(60)
def test_obs_watch_and_reports_over_a_socket(tmp_path, capsys):
    """``obs-watch`` scrapes a live endpoint into a series JSONL and an
    alert JSONL; ``report timeseries`` and ``report dashboard`` render
    it exactly as the JAX CLI renders the same file."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), MetricsHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        series, alerts = tmp_path / "series.jsonl", tmp_path / "alerts.jsonl"
        torch_main(["obs-watch", "--target", f"r0=http://127.0.0.1:{httpd.server_address[1]}",
                    "--interval-s", "0.05", "--duration-s", "0.6", "--quiet",
                    "--series-jsonl", str(series), "--alerts-jsonl", str(alerts),
                    "--ttft-p95-max", "0.5", "--fast-window-s", "0.1",
                    "--slow-window-s", "0.2", "--clear-debounce-s", "0.1"])
    finally:
        httpd.shutdown()
        httpd.server_close()
    recs = [json.loads(line) for line in series.read_text().splitlines()]
    assert len(recs) >= 3 and all(r["series"] == "r0" for r in recs)
    alert_recs = [json.loads(line) for line in alerts.read_text().splitlines()]
    assert any(r.get("state") == "firing" for r in alert_recs)
    assert any("slo_summary" in r for r in alert_recs)
    with pytest.raises(SystemExit):
        torch_main(["obs-watch", "--target", "r0=http://127.0.0.1:1"])  # no rule
    capsys.readouterr()
    printed = {}
    for name, main in (("jax", jax_report_main), ("torch", torch_report_main)):
        main(["timeseries", str(series), "--width", "20"])
        main(["timeseries", str(series), "--json", "--all"])
        main(["dashboard", str(series), "-o", str(tmp_path / f"{name}.html")])
        printed[name] = capsys.readouterr().out.replace(f"{name}.html", "page.html")
    assert printed["torch"] == printed["jax"]
    assert "nanodiloco_serve_queue_depth" in printed["torch"]
    assert page_of((tmp_path / "torch.html").read_text()) == (tmp_path / "jax.html").read_text()
