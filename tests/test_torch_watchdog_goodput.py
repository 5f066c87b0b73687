"""The port's watchdog (nanodiloco_tpu_torch/obs/watchdog.py) and goodput
ledger (nanodiloco_tpu_torch/obs/goodput.py) against the JAX package's,
on the CPU (tests/test_obs.py:109-197,549,690 and
tests/test_goodput.py:55-181,249-274,425-602).

Both are host arithmetic over observed numbers: the same observation
sequence (numpy-seeded losses and throughputs, an injected clock) must
give the same alarm records, status documents and ledger snapshots in
both packages, exactly. Then the partition property on the port's real
train() runs: the causes sum to the elapsed time (1%: the snapshot rounds
each cause to 6 digits), the first round's compute is compile_warmup, and
a crashed lifetime and its resumed successor stitch with the relaunch gap.
"""

import json
import os

import numpy as np
import pytest
import torch

from nanodiloco_tpu.obs import goodput as jax_goodput
from nanodiloco_tpu.obs import watchdog as jax_watchdog
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.obs import flightrec, watchdog
from nanodiloco_tpu_torch.obs import goodput as port_goodput
from nanodiloco_tpu_torch.obs.flightrec import FlightRecorder
from nanodiloco_tpu_torch.obs.goodput import CAUSES, GoodputLedger, stitch_goodput_records
from nanodiloco_tpu_torch.resilience.faults import InjectedCrash
from nanodiloco_tpu_torch.resilience.supervisor import DOWNTIME_ENV, RESTART_ENV
from nanodiloco_tpu_torch.training.metrics import MetricsLogger, summarize_run
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

PACKAGES = {"jax": jax_watchdog, "port": watchdog}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    prev = flightrec.install(None)
    yield
    flightrec.install(prev)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def both(script, cfg_kw=None, **kw):
    """Run ``script(wd, clock)`` on a fresh watchdog of each package; the
    emitted records must be equal. Returns the port's."""
    out = {}
    for name, mod in PACKAGES.items():
        recs, clk = [], FakeClock()
        wd = mod.Watchdog(mod.WatchdogConfig(**(cfg_kw or {})), emit=recs.append, clock=clk,
                          **kw)
        script(wd, clk)
        out[name] = recs
    assert out["port"] == out["jax"]
    return out["port"]


def test_watchdog_nan_alarm_fires_once_per_episode():
    def script(wd, clk):
        wd.observe_loss(1, float("nan"))
        wd.observe_loss(2, float("nan"))
        wd.observe_loss(3, 2.0)
        wd.observe_loss(4, float("inf"))

    recs = both(script)
    assert [(r["alarm"], r["step"]) for r in recs] == [("nan_loss", 1), ("nan_loss", 4)]


def test_watchdog_loss_spike_zscore():
    losses = 2.0 + 0.01 * np.random.default_rng(0).standard_normal(16)

    def script(wd, clk):
        for i, x in enumerate(losses):
            wd.observe_loss(i, float(x))
        wd.observe_loss(100, 50.0)
        wd.observe_loss(101, 0.5)  # a downward outlier is good news

    recs = both(script, dict(loss_zscore=4.0, loss_window=16))
    assert [r["alarm"] for r in recs] == ["loss_spike"] and recs[0]["zscore"] > 4.0


def test_watchdog_throughput_collapse():
    tps = 1000.0 + 10 * np.random.default_rng(1).standard_normal(8)

    def script(wd, clk):
        for i, x in enumerate(tps):
            wd.observe_throughput(i, float(x))
        wd.observe_throughput(9, 100.0)

    recs = both(script, dict(tps_collapse_frac=0.5, loss_window=32))
    assert [r["alarm"] for r in recs] == ["throughput_collapse"]


def test_watchdog_stall_via_injected_clock():
    results = []

    def script(wd, clk):
        for step, t in enumerate([0.0, 10.0, 20.0]):
            clk.t = t
            wd.heartbeat(step)
        clk.t = 25.0
        results.append(wd.check_stall())
        clk.t = 51.0
        results.extend([wd.check_stall(), wd.check_stall()])
        clk.t = 52.0
        wd.heartbeat(4)
        clk.t = 120.0
        results.append(wd.check_stall())

    recs = both(script, dict(stall_factor=3.0, min_stall_s=5.0))
    assert results == [False, True, True, True] * 2
    assert [r["alarm"] for r in recs] == ["stall", "stall"]


def test_watchdog_divergence_sentinel():
    def script(wd, clk):
        for step, drift in ((2, 0.1), (4, 0.6), (6, 0.7), (8, 0.2), (10, float("nan"))):
            wd.observe_drift(step, drift)

    recs = both(script, dict(drift_threshold=0.5))
    assert [(r["step"], r["drift"]) for r in recs] == [(4, 0.6), (10, "nan")]
    assert both(lambda wd, clk: wd.observe_drift(2, 1e9), dict(drift_threshold=0.0)) == []


def test_watchdog_explicit_alarm_and_on_fatal():
    fatal = []

    def script(wd, clk):
        wd.alarm("ckpt_save_failed", 3, error="x")
        wd.alarm("ckpt_save_failed", 6, error="y")  # per event, never gated
        wd.observe_loss(7, float("nan"))
        wd.observe_throughput(8, 1.0)

    recs = both(script, on_fatal=lambda kind, step: fatal.append((kind, step)))
    assert [r["alarm"] for r in recs] == ["ckpt_save_failed", "ckpt_save_failed", "nan_loss"]
    assert fatal == [("nan_loss", 7)] * 2


def test_watchdog_status_doc_file_and_alarm_kinds(tmp_path):
    docs = {}
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.json")
        wd = mod.Watchdog(mod.WatchdogConfig(), emit=lambda r: None, status_path=path)
        wd.heartbeat(3, loss=2.0, tokens_per_sec=123.4)
        assert json.load(open(path))["state"] == "running"
        wd.observe_loss(4, float("nan"))
        wd.observe_loss(5, 2.0)
        wd.observe_loss(6, float("nan"))
        wd.stop("finished")
        doc = wd.status_doc()
        assert doc["uptime_s"] == pytest.approx(doc["updated_unix"] - doc["started_unix"],
                                                abs=0.05)
        docs[name] = {k: v for k, v in doc.items()
                      if k not in ("updated_unix", "started_unix", "uptime_s")}
        assert json.load(open(path))["state"] == "finished"
    assert docs["port"] == docs["jax"]
    assert docs["port"]["alarm_kinds"] == {"nan_loss": 2} and docs["port"]["step"] == 3


def test_watchdog_alarm_lands_in_metrics_jsonl(tmp_path):
    logger = MetricsLogger("wdrun", out_dir=str(tmp_path), quiet=True)
    wd = watchdog.Watchdog(watchdog.WatchdogConfig(), emit=logger.log)
    wd.observe_loss(5, float("nan"))
    logger.finish()
    assert [json.loads(line) for line in open(tmp_path / "wdrun.jsonl")] == [
        {"alarm": "nan_loss", "step": 5, "loss": "nan"}]


def test_watchdog_fatal_alarm_dumps_blackbox(tmp_path):
    path = str(tmp_path / "wd-blackbox.json")
    flightrec.install(FlightRecorder(dump_path=path))
    t = [0.0]
    wd = watchdog.Watchdog(watchdog.WatchdogConfig(stall_factor=2.0, min_stall_s=1.0,
                                                   poll_s=1000.0),
                           emit=lambda rec: None, clock=lambda: t[0])
    wd.heartbeat(1)
    t[0] = 1.0
    wd.heartbeat(2)
    t[0] = 50.0
    assert wd.check_stall() is True
    doc = json.load(open(path))
    assert doc["reason"] == "watchdog:stall"
    assert "heartbeat" in [e["kind"] for e in doc["events"]]


# -- the ledger ---------------------------------------------------------------

def ledgers(lifetime=0):
    """A ledger of each package on one injected clock."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    return t, {name: mod.GoodputLedger(clock=clock, wall=lambda: 5000.0,
                                       lifetime=lifetime).start()
               for name, mod in (("jax", jax_goodput), ("port", port_goodput))}


def same_snapshots(leds, **kw) -> dict:
    snaps = {name: {k: v for k, v in led.snapshot(**kw).items() if k != "pid"}
             for name, led in leds.items()}
    assert snaps["port"] == snaps["jax"]
    return snaps["port"]


def test_ledger_partition_is_exact_under_injected_clock():
    t, leds = ledgers(lifetime=3)
    t[0] = 100.0
    for led in leds.values():
        led.observe_phases({"t_inner": 55.0, "t_sync": 12.0, "t_data": 6.0, "t_ckpt": 4.0,
                            "t_eval": 3.0, "t_log": 1.0})
        led.add_tokens(12_000)
    snap = same_snapshots(leds)
    assert snap["lifetime"] == 3 and snap["elapsed_s"] == 100.0
    assert sum(snap[f"{c}_s"] for c in CAUSES) == pytest.approx(100.0)
    assert snap["other_s"] == pytest.approx(100.0 - 55 - 12 - 6 - 4 - 3)
    assert snap["goodput_fraction"] == pytest.approx(0.55)
    assert snap["tokens_per_wall_s"] == pytest.approx(120.0)


def test_ledger_warmup_external_overshoot_and_residual():
    t, leds = ledgers()
    for led in leds.values():
        led.book_external("restart_downtime", 30.0)
    t[0] = 50.0
    for led in leds.values():
        led.observe_phases({"t_inner": 40.0, "t_comm_probe": 5.0}, warmup=True)
        led.observe_phases({"t_mystery": 2.0})
    snap = same_snapshots(leds)
    assert snap["compute_s"] == 0.0 and snap["compile_warmup_s"] == 45.0
    assert snap["elapsed_s"] == 80.0 and snap["restart_downtime_s"] == 30.0
    assert snap["other_s"] >= 2.0
    t[0] = 60.0
    for led in leds.values():
        led.observe_phases({"t_inner": 20.0, "t_sync": 10.0})  # overshoots 90 s
    snap = same_snapshots(leds, final=True, residual_cause="stall")
    assert sum(snap[f"{c}_s"] for c in CAUSES) == pytest.approx(90.0)
    assert snap["final"] is True and snap["stall_s"] == 0.0
    t2, leds2 = ledgers()
    t2[0] = 20.0
    for led in leds2.values():
        led.observe_phases({"t_inner": 5.0})
    snap = same_snapshots(leds2, final=True, residual_cause="stall")
    assert snap["stall_s"] == pytest.approx(15.0) and snap["other_s"] == 0.0


def test_ledger_books_the_ports_stall_and_straggler_phases():
    """The port splits an injected stall out of the data wait (t_stall)
    and a straggle out of the inner span (t_straggler)."""
    t = [0.0]
    led = GoodputLedger(clock=lambda: t[0]).start()
    t[0] = 10.0
    led.observe_phases({"t_data": 1.0, "t_stall": 2.0, "t_straggler": 3.0, "t_inner": 4.0})
    snap = led.snapshot()
    assert (snap["data_wait_s"], snap["stall_s"], snap["straggler_wait_s"],
            snap["compute_s"]) == (1.0, 2.0, 3.0, 4.0)


STITCH_CASES = {
    "last_snapshot_per_lifetime": [
        {"goodput": {"lifetime": 0, "elapsed_s": 10.0, "compute_s": 8.0, "other_s": 2.0,
                     "tokens": 100}},
        {"goodput": {"lifetime": 0, "elapsed_s": 40.0, "compute_s": 30.0, "other_s": 10.0,
                     "tokens": 400}},
        {"loss": 1.0, "step": 3},
        {"goodput": {"lifetime": 1, "elapsed_s": 60.0, "compute_s": 40.0,
                     "restart_downtime_s": 12.5, "other_s": 7.5, "tokens": 600,
                     "final": True}},
    ],
    "repeated_ordinals": [
        {"goodput": {"lifetime": 0, "elapsed_s": 30.0, "compute_s": 30.0, "tokens": 300}},
        {"goodput": {"lifetime": 1, "elapsed_s": 20.0, "compute_s": 20.0, "tokens": 200}},
        {"goodput": {"lifetime": 0, "elapsed_s": 10.0, "compute_s": 5.0, "other_s": 5.0,
                     "tokens": 50}},
        {"goodput": {"lifetime": 0, "elapsed_s": 40.0, "compute_s": 30.0, "other_s": 10.0,
                     "tokens": 400, "final": True}},
    ],
    "pid_split": [
        {"goodput": {"lifetime": 0, "pid": 100, "elapsed_s": 8.0, "compute_s": 8.0,
                     "tokens": 80}},
        {"goodput": {"lifetime": 0, "pid": 200, "elapsed_s": 12.0, "compute_s": 4.0,
                     "other_s": 8.0, "tokens": 40}},
    ],
    "none": [{"loss": 1.0}, {"alarm": "stall"}],
}


@pytest.mark.parametrize("case", STITCH_CASES)
def test_stitch_matches_jax(case):
    recs = STITCH_CASES[case]
    st = stitch_goodput_records(recs)
    assert st == jax_goodput.stitch_goodput_records(recs)
    want = {"last_snapshot_per_lifetime": (2, 100.0, 0.70), "repeated_ordinals": (3, 90.0,
                                                                                   80 / 90),
            "pid_split": (2, 20.0, 0.6), "none": None}[case]
    if want is None:
        assert st is None
    else:
        assert (st["lifetimes"], st["elapsed_s"]) == pytest.approx(want[:2])
        assert st["goodput_fraction"] == pytest.approx(want[2])


def write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_report_goodput_renders_and_summarize_surfaces_keys(tmp_path, capsys):
    from nanodiloco_tpu.cli import report_main as jax_report

    jsonl = str(tmp_path / "run.jsonl")
    write_jsonl(jsonl, [
        {"loss": 2.0, "step": 1},
        {"goodput": {"lifetime": 0, "elapsed_s": 80.0, "compute_s": 60.0,
                     "outer_sync_s": 12.0, "other_s": 8.0, "tokens": 800}},
        {"goodput": {"lifetime": 1, "elapsed_s": 20.0, "compute_s": 10.0,
                     "restart_downtime_s": 6.0, "other_s": 4.0, "tokens": 200, "final": True}},
    ])
    for argv in (["goodput", jsonl], ["goodput", jsonl, "--json"]):
        cli.main(["report", *argv])
        ours = capsys.readouterr().out
        jax_report(argv)
        assert ours == capsys.readouterr().out
    assert "2 process lifetime(s)" in ours or json.loads(ours)["lifetimes"] == 2
    summary = summarize_run(jsonl)
    assert summary["goodput_fraction"] == pytest.approx(0.7)
    assert summary["badput_top_cause"] == "outer_sync" and summary["goodput_lifetimes"] == 2
    old = str(tmp_path / "old.jsonl")
    write_jsonl(old, [{"loss": 2.0, "step": 1}])
    with pytest.raises(SystemExit):
        cli.main(["report", "goodput", old])


SMALL = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=64)


def tiny_cfg(log_dir, run_name, **kw):
    return TrainConfig(**{**dict(seed=1337, batch_size=4, per_device_batch_size=2,
                                 seq_length=32, warmup_steps=2, total_steps=6, inner_steps=3,
                                 lr=1e-3, num_workers=2, model=SMALL, log_dir=log_dir,
                                 quiet=True, run_name=run_name, measure_comm=False,
                                 cost_analysis=False), **kw})


def snaps(jsonl):
    return [r["goodput"] for r in map(json.loads, open(jsonl)) if "goodput" in r]


def assert_partition(snap):
    assert sum(snap[f"{c}_s"] for c in CAUSES) == pytest.approx(snap["elapsed_s"], rel=0.01)
    assert 0 <= snap["goodput_fraction"] <= 1


@pytest.mark.parametrize("mode", ["classic", "async"])
def test_goodput_partition_real_run(tmp_path, mode):
    kw = {"async_outer": True, "outer_delay": 1} if mode == "async" else {}
    train(tiny_cfg(str(tmp_path), "gp", **kw), device="cpu")
    ss = snaps(tmp_path / "gp.jsonl")
    assert len(ss) == 3 and ss[-1].get("final") is True
    for s in ss:
        assert_partition(s)
    final = ss[-1]
    assert final["compile_warmup_s"] > 0 and final["compute_s"] > 0
    assert final["compute_s"] + final["outer_sync_s"] <= final["elapsed_s"]
    assert final["tokens"] == 6 * 2 * 2 * 2 * 32
    summary = summarize_run(str(tmp_path / "gp.jsonl"))
    assert 0 < summary["goodput_fraction"] <= 1 and summary["steps"] == 6
    assert summary["restart_downtime_s"] == 0.0


def test_crash_resume_lineage_stitches_with_downtime(tmp_path, monkeypatch):
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"kind": "crash", "step": 4, "raise": True}]}, f)
    cfg = tiny_cfg(str(tmp_path), "gp-crash", checkpoint_dir=str(tmp_path / "ckpt"),
                   fault_plan=plan, total_steps=9)
    with pytest.raises(InjectedCrash):
        train(cfg, device="cpu")
    doc = json.load(open(tmp_path / "gp-crash-blackbox.json"))
    assert doc["reason"].startswith("train_exception:InjectedCrash")
    assert any(e["kind"] == "span" for e in doc["events"])
    snaps0 = snaps(tmp_path / "gp-crash.jsonl")
    assert snaps0 and all(s["lifetime"] == 0 for s in snaps0)
    monkeypatch.setenv(RESTART_ENV, "1")
    monkeypatch.setenv(DOWNTIME_ENV, "7.500")
    train(cfg, device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "gp-crash.jsonl")]
    assert [r["restart_count"] for r in recs if "resume" in r] == [1]
    st = stitch_goodput_records(recs)
    assert st["lifetimes"] == 2 and st["restart_downtime_s"] == pytest.approx(7.5)
    for s in snaps(tmp_path / "gp-crash.jsonl"):
        assert_partition(s)
    assert os.path.exists(tmp_path / "gp-crash-blackbox.json")
