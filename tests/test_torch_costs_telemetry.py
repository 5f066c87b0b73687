"""The port's cost analytics (nanodiloco_tpu_torch/obs/costs.py), its
trainer telemetry endpoint (obs/telemetry.py) and its ``report`` verbs,
on the CPU, against the JAX package (tests/test_obs.py:736-849,
tests/test_telemetry.py:36-135,207,320, tests/test_resilience.py:843,866).

- The meta-device FLOP probe lands within 2x of the hand formula, as JAX's
  XLA count must (loss_chunk=0, as there); the hand formula is one
  function in both packages and gives the same number.
- The peak table goes by the card's name (PCIe before SXM, the override
  first); the CPU has none, so no MFU.
- The telemetry server renders what JAX's renders for the same observed
  records (the same exposition text), over a real socket, and a live
  port run's scrape matches its own JSONL.
- ``report cost|faults|goodput|blackbox|drift`` print JAX's text for the
  same JSONL, byte for byte.
"""

import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from nanodiloco_tpu.cli import report_main as jax_report
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.obs import costs as jax_costs
from nanodiloco_tpu.obs import telemetry as jax_telemetry
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.models.config import LLAMA3_8B, LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params
from nanodiloco_tpu_torch.obs import costs, flightrec, telemetry
from nanodiloco_tpu_torch.obs.telemetry import TelemetryServer, parse_metrics_text
from nanodiloco_tpu_torch.obs.watchdog import Watchdog, WatchdogConfig
from nanodiloco_tpu_torch.training.metrics import MetricsLogger, compare_runs, summarize_run
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

SMALL = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port: int, path: str, timeout: float = 5.0):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- costs ----------------------------------------------------------------------

def test_cost_probe_matches_hand_formula():
    model = dataclasses.replace(SMALL, loss_chunk=0)
    B, S = 2, 64
    params = init_params(torch.Generator().manual_seed(0), model, "cpu")
    flops = costs.microbatch_flops(params, model, (B, S))
    hand = costs.train_flops_per_token(model, S)
    assert 0.5 < (flops / (B * S)) / hand < 2.0
    assert hand == jax_costs.train_flops_per_token(JaxConfig(**model.to_dict()), S)
    # the probe allocates nothing: the 8B width's one-layer step counts
    # on the meta device in a moment, within 2x of its hand formula
    c8 = dataclasses.replace(LLAMA3_8B, num_hidden_layers=1)
    meta = {"embed": torch.empty(c8.vocab_size, c8.hidden_size, device="meta"),
            "final_norm": torch.empty(c8.hidden_size, device="meta"),
            "lm_head": torch.empty(c8.hidden_size, c8.vocab_size, device="meta"),
            "layers": {k: torch.empty(s, device="meta") for k, s in {
                "attn_norm": (1, 4096), "wq": (1, 4096, 4096), "wk": (1, 4096, 1024),
                "wv": (1, 4096, 1024), "wo": (1, 4096, 4096), "mlp_norm": (1, 4096),
                "w_gate": (1, 4096, 14336), "w_up": (1, 4096, 14336),
                "w_down": (1, 14336, 4096)}.items()}}
    ratio = costs.microbatch_flops(meta, c8, (1, 2048)) / 2048 / costs.train_flops_per_token(
        c8, 2048)
    assert 1.0 <= ratio < 2.0
    assert costs.train_flops_per_token(c8, 2048) == pytest.approx(4.561379328e9)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA H100 SXM5 80GB", 989.0), ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_table_by_card_name(monkeypatch, name, peak):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert costs.detect_peak_tflops("cuda") == (peak, name)
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123.5")
    assert costs.detect_peak_tflops("cuda") == (123.5, name)


def test_cpu_has_no_peak_and_no_mfu(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert costs.detect_peak_tflops("cpu") == (None, "cpu")
    rec = costs.build_cost_record(program="round", probe={"flops": 2e9}, probe_tokens=1000,
                                  model_cfg=SMALL, seq=64, device="cpu")
    assert "peak_tflops" not in rec and costs.analytic_mfu(rec, 1e6) is None
    assert "flops_billed" not in rec and "bytes_accessed_billed" not in rec


def test_build_cost_record_and_analytic_mfu(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "100.0")
    ours = costs.build_cost_record(program="round", probe={"flops": 2e9}, probe_tokens=1000,
                                   num_devices=2, model_cfg=SMALL, seq=64, device="cpu")
    theirs = jax_costs.build_cost_record(program="round", probe={"flops": 2e9},
                                         probe_tokens=1000, num_devices=2,
                                         model_cfg=JaxConfig(**SMALL.to_dict()), seq=64)
    assert {k: v for k, v in ours.items() if k != "device_kind"} == {
        k: v for k, v in theirs.items() if k != "device_kind"}
    assert ours["flops_per_token"] == pytest.approx(2e6) and ours["peak_tflops"] == 100.0
    assert costs.analytic_mfu(ours, 1e6) == pytest.approx(0.01)


def test_train_logs_the_cost_record(tmp_path):
    # loss_chunk=0: at this size the chunked cross-entropy pads its rows to
    # a 512-row chunk, counted work the hand formula does not see
    summary = train(TrainConfig(seed=0, batch_size=2, per_device_batch_size=2, seq_length=32,
                                warmup_steps=1, total_steps=2, inner_steps=2, num_workers=2,
                                model=dataclasses.replace(SMALL, loss_chunk=0), quiet=True,
                                log_dir=str(tmp_path), run_name="c"), device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "c.jsonl")]
    cost = [r for r in recs if "cost_analysis" in r]
    assert len(cost) == 1 and cost[0]["step"] == 0
    rec = cost[0]["cost_analysis"]
    assert rec["tokens_counted"] == 2 * 32 and rec["device_kind"] == "cpu"
    assert 0.5 < rec["flops_per_token"] / rec["flops_per_token_hand"] < 2.0
    assert "t_cost_analysis" in recs[1]  # the probe's phase, in round 1's budget
    assert summarize_run(str(tmp_path / "c.jsonl")).get("mfu_analytic") is None
    assert summary["alarms"] == 0


def write_cost_run(path, tps, final_loss, peak=0.1):
    with open(path, "w") as f:
        f.write(json.dumps({"cost_analysis": {
            "program": "round", "flops": 1e9, "tokens_counted": 1000, "flops_per_token": 1e6,
            "flops_per_token_hand": 9e5, "peak_tflops": peak, "num_devices": 1,
            "device_kind": "test"}, "step": 0}) + "\n")
        for i, loss in enumerate([final_loss + 1.0, final_loss], start=1):
            f.write(json.dumps({"loss": loss, "tokens_per_sec": tps, "step": i,
                                "outer_synced": 1, "wire_bytes_per_sync": 1000,
                                "wire_bytes_total": 1000 * i}) + "\n")


def test_summarize_and_compare_gate_mfu_analytic(tmp_path):
    base, slow = str(tmp_path / "base.jsonl"), str(tmp_path / "slow.jsonl")
    write_cost_run(base, tps=1000.0, final_loss=3.0)
    write_cost_run(slow, tps=500.0, final_loss=3.0)
    sb, sc = summarize_run(base), summarize_run(slow)
    assert sb["mfu_analytic"] == pytest.approx(1000.0 * 1e6 / (0.1 * 1e12))
    assert "mfu_analytic" in compare_runs(sb, sc)["regressions"]


# -- report verbs: JAX's text for the same JSONL ---------------------------------

def resilience_jsonl(path):
    recs = [
        {"loss": 5.0, "step": 1},
        {"fault": "io_error", "step": 3, "op": "save", "count": 0},
        {"retry": "ckpt_save", "attempt": 1, "delay_s": 0.1, "error": "x"},
        {"alarm": "ckpt_save_failed", "step": 3, "error": "x"},
        {"fault": "crash", "step": 5, "code": 71, "fired_at_step": 6},
        {"resume": 3, "restart_count": 1, "elastic": False, "step": 3},
        {"elastic": "straggler_demote", "worker": 0, "h_from": 3, "h_to": 2, "step": 6},
        {"loss": 4.0, "step": 4, "outer_synced": 1, "pg_norm": [0.5, 0.6], "drift_max": 0.02,
         "drift_mean": 0.015, "outer_momentum_norm": 1.1, "outer_update_cos": 0.97,
         "quarantined_workers": 1, "tokens_per_sec": 100.0, "wire_bytes_per_sync": 10,
         "wire_bytes_total": 10},
        {"alarm": "divergence", "step": 4, "drift": 0.9, "threshold": 0.5},
        {"preempt": "preempt", "exit_code": 75, "step": 6},
        {"goodput": {"lifetime": 0, "elapsed_s": 80.0, "compute_s": 60.0,
                     "outer_sync_s": 12.0, "other_s": 8.0, "tokens": 800}},
        {"goodput": {"lifetime": 1, "elapsed_s": 20.0, "compute_s": 10.0,
                     "restart_downtime_s": 6.0, "other_s": 4.0, "tokens": 200, "final": True}},
        {"step": None, "outer_synced": 1, "drift_max": 0.03, "drift_mean": None,
         "pg_norm": [0.5, None]},
    ]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("verb", ["faults", "goodput", "drift", "cost", "blackbox"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_report_verbs_print_what_jax_prints(verb, fmt, tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    if verb == "cost":
        write_cost_run(path, tps=1000.0, final_loss=3.0)
    elif verb == "blackbox":
        path = str(tmp_path / "x-blackbox.json")
        rec = flightrec.FlightRecorder(capacity=8, dump_path=path,
                                       wall=lambda: 1700000000.0)
        rec.record("span", name="inner", s=1.5)
        rec.record("alarm", kind="nan_loss")
        rec.dump("crash_fault:step5")
    else:
        resilience_jsonl(path)
    argv = [verb, path] + (["--json"] if fmt == "json" else [])
    cli.main(["report", *argv])
    ours = capsys.readouterr().out
    jax_report(argv)
    assert ours == capsys.readouterr().out and ours.strip()


def test_reports_refuse_what_has_nothing(tmp_path):
    bare = str(tmp_path / "bare.jsonl")
    with open(bare, "w") as f:
        f.write(json.dumps({"loss": 1.0, "step": 1, "tokens_per_sec": 1.0}) + "\n")
    for verb in ("cost", "goodput"):
        with pytest.raises(SystemExit):
            cli.main(["report", verb, bare])
    with open(tmp_path / "notdump.json", "w") as f:
        json.dump({"hello": 1}, f)
    with pytest.raises(SystemExit):
        cli.main(["report", "blackbox", str(tmp_path / "notdump.json")])
    # the fleet's verbs (ported since) refuse a training JSONL as the JAX
    # CLI does: no span for the needle, no collector series, no series of
    # either kind for a dashboard; the commands refuse to start without
    # a replica or a target
    with pytest.raises(SystemExit):
        cli.main(["report", "trace", "req-1", bare])
    with pytest.raises(SystemExit, match="no matching series"):
        cli.main(["report", "timeseries", bare])
    with pytest.raises(ValueError, match="neither collector series records"):
        cli.main(["report", "dashboard", bare, "-o", str(tmp_path / "page.html")])
    for command in ("fleet", "obs-watch"):
        with pytest.raises(SystemExit):
            cli.main([command])


# -- telemetry -------------------------------------------------------------------

RECORDS = [
    {"loss": 2.5, "tokens_per_sec": 1234.5, "step": 7, "comm_share": 0.125, "t_inner": 0.8,
     "t_data": 0.1, "outer_synced": 1, "wire_bytes_per_sync": 1000, "wire_bytes_total": 1000,
     "avg_sync_time_s": None},
    {"alarm": "loss_spike", "step": 8},
    {"loss": 2.4, "step": 9, "outer_synced": 0, "cost_analysis": {"flops_per_token": 5e5}},
    {"pg_norm": [0.25, 0.75], "drift_max": 0.01, "drift_mean": 0.008,
     "outer_momentum_norm": 1.5, "outer_update_cos": 0.93, "step": 10,
     "inner_steps_realized": [3, 2], "elastic": "straggler_demote"},
    {"fault": "crash", "step": 5}, {"fault": "nan_params", "step": 4},
    {"retry": "ckpt_save", "attempt": 1}, {"resume": 3, "restart_count": 2, "elastic": False},
    {"goodput": {"lifetime": 0, "elapsed_s": 10.0, "compute_s": 6.0, "stall_s": 1.0,
                 "other_s": 3.0, "goodput_fraction": 0.6, "tokens": 100}},
    {"devtime": {"dispatches": {"train_round/2/w2": 2}, "compile_s": {"train_round/2/w2": 1.0},
                 "device_s": {"train_round/2/w2": 0.5}}},
]


def test_metrics_exposition_equals_jax_over_a_socket():
    srv = TelemetryServer(port=0).start()
    ref = jax_telemetry.TelemetryServer(port=0)
    try:
        for rec in RECORDS:
            srv.observe(rec)
            ref.observe(rec)
        code, body = _get(srv.port, "/metrics")
        # the same text but the flops_per_token help, which names the
        # port's own probe
        own = lambda text: [line for line in text.splitlines()  # noqa: E731
                            if not line.startswith("# HELP nanodiloco_flops_per_token")]
        assert code == 200 and own(body) == own(ref.render_metrics())
        m = parse_metrics_text(body)
        # the last record that carries a step sets the step gauge
        assert m["nanodiloco_loss"] == 2.4 and m["nanodiloco_step"] == 4
        assert m['nanodiloco_alarms_total{kind="loss_spike"}'] == 1
        assert m["nanodiloco_outer_syncs_total"] == 1
        assert m["nanodiloco_flops_per_token"] == 5e5
        assert m['nanodiloco_worker_pg_norm{worker="1"}'] == 0.75
        assert m['nanodiloco_faults_total{kind="crash"}'] == 1 and m["nanodiloco_faults_total"] == 2
        assert m['nanodiloco_retries_total{op="ckpt_save"}'] == 1
        assert m["nanodiloco_resumes_total"] == 1 and m["nanodiloco_restarts"] == 2
        assert m["nanodiloco_goodput_fraction"] == 0.6
        assert m['nanodiloco_badput_seconds_total{cause="stall"}'] == 1.0
        assert "nanodiloco_avg_sync_time_seconds" not in m
        assert body.rstrip().endswith("# EOF")
        assert _get(srv.port, "/nope")[0] == 404
    finally:
        srv.stop()
        ref._httpd.server_close()


def test_healthz_follows_watchdog_and_flips_503_on_nan_and_stall():
    logger = MetricsLogger("hz", out_dir=None, quiet=True)
    t = [0.0]
    wd = Watchdog(WatchdogConfig(stall_factor=3.0, min_stall_s=5.0), emit=logger.log,
                  clock=lambda: t[0])
    srv = TelemetryServer(port=0, health_fn=wd.status_doc).start()
    logger.telemetry = srv
    bare = TelemetryServer(port=0).start()
    try:
        for step, now in enumerate([0.0, 10.0, 20.0]):
            t[0] = now
            wd.heartbeat(step, loss=2.0)
        code, body = _get(srv.port, "/healthz")
        assert code == 200 and json.loads(body)["healthy"] is True
        t[0] = 60.0
        assert wd.check_stall()
        code, body = _get(srv.port, "/healthz")
        assert code == 503 and json.loads(body)["state"] == "stalled"
        t[0] = 61.0
        wd.heartbeat(4)
        assert _get(srv.port, "/healthz")[0] == 200
        wd.observe_loss(5, float("nan"))
        code, body = _get(srv.port, "/healthz")
        assert code == 503 and json.loads(body)["alarm_kinds"]["nan_loss"] == 1
        m = parse_metrics_text(_get(srv.port, "/metrics")[1])
        assert m['nanodiloco_alarms_total{kind="nan_loss"}'] == 1
        wd.stop("finished")
        code, body = _get(srv.port, "/healthz")
        assert code == 503 and json.loads(body)["state"] == "finished"
        assert _get(bare.port, "/healthz")[0] == 200  # no probe, no claim
    finally:
        srv.stop()
        bare.stop()
        logger.finish()


def test_profiler_window_turns_live_captures_away(tmp_path):
    srv = TelemetryServer(port=0, profile_dir=str(tmp_path)).start()
    try:
        telemetry.acquire_profiler_window()
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/debug/profile?seconds=0.1",
                                         data=b"", method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 409
        finally:
            telemetry.release_profiler_window()
    finally:
        srv.stop()


def test_live_run_scrape_matches_jsonl(tmp_path):
    """A port train() with metrics_port=0 serves /metrics while it trains;
    a scrape taken after a sync record holds values the JSONL also holds."""
    scraped, found, ports = {}, threading.Event(), []
    orig = TelemetryServer.start

    def start(self):
        srv = orig(self)
        ports.append(srv.port)

        def poll():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not found.is_set():
                try:
                    m = parse_metrics_text(_get(srv.port, "/metrics", timeout=2)[1])
                except OSError:
                    break
                if "nanodiloco_drift_max" in m:
                    scraped.update(m)
                    found.set()
                time.sleep(0.005)

        threading.Thread(target=poll, daemon=True).start()
        return srv

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TelemetryServer, "start", start)
        train(TrainConfig(seed=0, batch_size=2, per_device_batch_size=2, seq_length=32,
                          warmup_steps=1, total_steps=40, inner_steps=2, num_workers=2,
                          model=SMALL, quiet=True, log_dir=str(tmp_path), run_name="t",
                          metrics_port=0, cost_analysis=False), device="cpu")
    assert found.is_set()
    recs = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    losses = {r["loss"] for r in recs if "loss" in r}
    drifts = {r["drift_max"] for r in recs if "drift_max" in r}
    assert scraped["nanodiloco_loss"] in losses and scraped["nanodiloco_drift_max"] in drifts
    assert scraped["nanodiloco_step"] in {r["step"] for r in recs if "step" in r}
    with socket.socket() as s:  # teardown stopped the server
        assert s.connect_ex(("127.0.0.1", ports[0])) != 0
