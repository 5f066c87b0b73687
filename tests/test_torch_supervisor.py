"""The port's supervisor (nanodiloco_tpu_torch/resilience/supervisor.py)
against the JAX package's, on the CPU.

The policy (tests/test_resilience.py:633-805, tests/test_goodput.py:335)
is driven with fake children: the same scripted exit codes, checkpoint
progress and wall clock go to both packages' ``Supervisor``, which must
make the same decisions (the same events, exit code, restarts, budget and
child argv). Progress differs by layout only: the port reads committed
``step_<n>.pt`` files (``.tmp`` never counts), the JAX package orbax's
digit-named directories; the fake child commits both. One real
``python -m nanodiloco_tpu_torch supervise`` over a crash fault then
resumes to the same final state as an uninterrupted run, bit for bit.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanodiloco_tpu.resilience import supervisor as jax_sup
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import tree_leaves
from nanodiloco_tpu_torch.resilience import supervisor as sup
from nanodiloco_tpu_torch.resilience.supervisor import (
    DOWNTIME_ENV,
    PREEMPT_EXIT_CODE,
    RESTART_ENV,
    WATCHDOG_EXIT_CODE,
    Supervisor,
    SupervisorConfig,
    latest_checkpoint_step,
)
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.train_loop import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread (bit-identical reruns on the CPU need it),
    restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeChild:
    def __init__(self, rc, pid):
        self.rc, self.pid = rc, pid

    def wait(self):
        return self.rc

    def poll(self):
        return self.rc


class Script:
    """Scripted child lifetimes: each launch takes the next exit code
    (the last repeats), lives 10 fake seconds and, when ``ckpt`` is set,
    commits a new checkpoint step in both packages' layouts."""

    def __init__(self, codes, ckpt=None, on_launch=None):
        self.codes, self.ckpt, self.on_launch = codes, ckpt, on_launch
        self.t = [1000.0]
        self.launches: list[tuple[list[str], dict]] = []

    def popen(self, cmd, env=None):
        n = len(self.launches)
        self.launches.append((list(cmd), dict(env)))
        if self.on_launch:
            self.on_launch(n, env)
        self.t[0] += 10.0
        if self.ckpt:
            step = (n + 1) * 3
            os.makedirs(os.path.join(self.ckpt, str(step)), exist_ok=True)
            open(os.path.join(self.ckpt, f"step_{step}.pt"), "wb").close()
            open(os.path.join(self.ckpt, f"step_{step + 1}.tmp"), "wb").close()
        return FakeChild(self.codes[min(n, len(self.codes) - 1)], 4000 + n)

    def sleep(self, s):
        self.t[0] += s


def run_both(tmp_path, codes, cfg_kw, argv=("train",), ckpt=False, target=None):
    """Run one scripted scenario through each package's Supervisor; returns
    {"jax": ..., "port": ...} with each run's decisions."""
    out = {}
    for name, mod in (("jax", jax_sup), ("port", sup)):
        d = tmp_path / name
        d.mkdir()
        ck = str(d / "ck") if ckpt else None
        if ck:
            os.makedirs(ck)
        kw = dict(cfg_kw)
        if ck:
            kw["checkpoint_dir"] = ck
        on_launch = None
        if target is not None:
            tfile = d / "workers.target"
            tfile.write_text(str(target[0]))
            kw["workers_target_file"] = str(tfile)

            # target[0] is on disk at the start, target[k] written during
            # launch k (an operator's write while that child runs)
            def on_launch(n, env, tfile=tfile):
                assert env[mod.WORKERS_TARGET_ENV] == str(tfile)
                if 1 <= n < len(target):
                    tfile.write_text(str(target[n]))
        script = Script(codes, ck, on_launch)
        events = []
        s = mod.Supervisor(list(argv), mod.SupervisorConfig(**kw), emit=events.append,
                           popen=script.popen, sleep=script.sleep, rng=random.Random(0),
                           wall=lambda script=script: script.t[0])
        rc = s.run()
        out[name] = {"rc": rc, "events": events, "restarts": s.restarts,
                     "budget_used": s.budget_used, "workers": s.workers,
                     "argv": [c for c, _ in script.launches],
                     "env": [{k: v for k, v in e.items()
                              if k in (RESTART_ENV, DOWNTIME_ENV)}
                             for _, e in script.launches]}
    return out


SCENARIOS = {
    # preemption is the operating mode: immediate restarts, no budget
    "preempt_resumes_without_budget": dict(
        codes=[PREEMPT_EXIT_CODE, PREEMPT_EXIT_CODE, 0], cfg=dict(max_restarts=0)),
    # no-progress crashes count double: budget 3 ends at the second
    "crash_burns_budget_and_gives_up": dict(
        codes=[9], cfg=dict(max_restarts=3, degrade_after=99)),
    # a crash after checkpoint progress costs 1
    "progress_halves_crash_cost": dict(
        codes=[9], cfg=dict(max_restarts=3, degrade_after=99), ckpt=True),
    "watchdog_exit_counts_as_crash": dict(
        codes=[WATCHDOG_EXIT_CODE, 0], cfg=dict(max_restarts=3)),
    "degrades_worker_count": dict(
        codes=[9], cfg=dict(max_restarts=50, degrade_after=2, min_workers=1),
        argv=("train", "--num-workers", "4")),
    "auto_scale_up_after_healthy_lifetimes": dict(
        codes=[PREEMPT_EXIT_CODE] * 4 + [0],
        cfg=dict(max_restarts=0, scale_up_after=2, max_workers=4), ckpt=True,
        argv=("train", "--num-workers", "1")),
    "control_file_scales_up_and_down": dict(
        codes=[PREEMPT_EXIT_CODE, PREEMPT_EXIT_CODE, 0], cfg=dict(max_restarts=0, max_workers=4),
        argv=("train", "--num-workers", "2"), target=(8, 1)),
    "crash_then_preempt_then_finish": dict(
        codes=[71, PREEMPT_EXIT_CODE, 0], cfg=dict(backoff_base_s=4.0), ckpt=True),
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_supervisor_decisions_match_jax(name, tmp_path):
    sc = SCENARIOS[name]
    runs = run_both(tmp_path, sc["codes"], sc["cfg"], argv=sc.get("argv", ("train",)),
                    ckpt=sc.get("ckpt", False), target=sc.get("target"))
    port, jx = runs["port"], runs["jax"]
    assert port == jx
    kinds = [e["event"] for e in port["events"]]
    if name == "preempt_resumes_without_budget":
        assert port["rc"] == 0 and port["restarts"] == 2 and port["budget_used"] == 0
        assert "backoff" not in kinds and kinds.count("preempt_resume") == 2
    elif name == "crash_burns_budget_and_gives_up":
        assert port["rc"] == 9 and port["budget_used"] == 4 and kinds[-1] == "giveup"
    elif name == "progress_halves_crash_cost":
        # the port's own step_<n>.pt files are read as progress
        crashes = [e for e in port["events"] if e["event"] == "crash"]
        assert all(e["advanced"] for e in crashes) and len(crashes) == 4
        assert port["budget_used"] == 4
    elif name == "watchdog_exit_counts_as_crash":
        crash = [e for e in port["events"] if e["event"] == "crash"][0]
        assert crash["reason"] == "watchdog" and port["budget_used"] == 2
    elif name == "degrades_worker_count":
        downs = [(e["workers_from"], e["workers_to"], e["reason"])
                 for e in port["events"] if e["event"] == "scale_down"]
        assert downs == [(4, 2, "crash_degrade"), (2, 1, "crash_degrade")]
        assert port["argv"][-1] == ["train", "--num-workers", "1"]
    elif name == "auto_scale_up_after_healthy_lifetimes":
        assert [(e["workers_from"], e["workers_to"]) for e in port["events"]
                if e["event"] == "scale_up"] == [(1, 2), (2, 4)]
    elif name == "control_file_scales_up_and_down":
        assert [(e["event"], e["workers_from"], e["workers_to"]) for e in port["events"]
                if e["event"] in ("scale_up", "scale_down")] == [
            ("scale_up", 2, 4), ("scale_down", 4, 1)]
    else:
        assert kinds == ["launch", "crash", "backoff", "launch", "preempt_resume", "launch",
                         "finished"]
        assert [e[RESTART_ENV] for e in port["env"]] == ["0", "1", "2"]
        assert float(port["env"][1][DOWNTIME_ENV]) == pytest.approx(
            port["events"][2]["delay_s"], abs=0.01)


def test_supervisor_scale_up_after_requires_max_workers():
    with pytest.raises(ValueError, match="requires max_workers"):
        Supervisor(["train"], SupervisorConfig(scale_up_after=2))


def test_latest_checkpoint_step_reads_committed_files_only(tmp_path):
    assert latest_checkpoint_step(str(tmp_path / "missing")) is None
    d = tmp_path / "ck"
    d.mkdir()
    assert latest_checkpoint_step(str(d)) is None
    for name in ("step_3.pt", "step_12.pt", "step_15.tmp", "step_x.pt", "model_config.json",
                 "schedule.json"):
        (d / name).write_text("")
    (d / "20").mkdir()  # an orbax directory is not the port's layout
    assert latest_checkpoint_step(str(d)) == 12


def test_latest_checkpoint_step_agrees_with_the_checkpoint_manager(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"))
    assert latest_checkpoint_step(ck.directory) is None is ck.latest_step
    for step in (2, 4):
        torch.save({"x": torch.zeros(1)}, ck.path(step))
    (tmp_path / "ck" / "step_6.tmp").write_bytes(b"")
    assert latest_checkpoint_step(ck.directory) == ck.latest_step == 4


def test_supervisor_events_are_dated_and_blackbox_attached(tmp_path):
    """tests/test_goodput.py:335 on the port's layout: every event carries
    t_unix, the crash event attaches the crashed child's own black box
    (a stale dump of another pid never), the relaunch gap reaches the child
    as its downtime env."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    blackbox = tmp_path / "run-blackbox.json"
    (tmp_path / "other-blackbox.json").write_text(json.dumps(
        {"blackbox": True, "pid": 999_999, "t_unix": 2000.0, "events": []}))
    t, codes, launches = [1000.0], [71, 75, 0], []

    def popen(cmd, env=None):
        launches.append(dict(env))
        rc = codes[len(launches) - 1]
        t[0] += 10.0
        (ckpt / f"step_{2 * len(launches)}.pt").write_bytes(b"")
        if rc == 71:
            blackbox.write_text(json.dumps(
                {"blackbox": True, "pid": 4242, "t_unix": t[0], "events": []}))
        return FakeChild(rc, 4242)

    events = []
    s = Supervisor(["train"], SupervisorConfig(checkpoint_dir=str(ckpt), log_dir=str(tmp_path),
                                               backoff_base_s=4.0),
                   emit=events.append, popen=popen, sleep=lambda x: t.__setitem__(0, t[0] + x),
                   rng=random.Random(0), wall=lambda: t[0])
    assert s.run() == 0
    assert all("t_unix" in e for e in events)
    assert events[1]["child_s"] == 10.0 and events[1]["blackbox"] == str(blackbox)
    assert events[3]["downtime_s"] == pytest.approx(events[2]["delay_s"], abs=0.01)
    assert events[5]["downtime_s"] == pytest.approx(0.0)
    assert [e[RESTART_ENV] for e in launches] == ["0", "1", "2"]
    assert launches[0][DOWNTIME_ENV] == "0.000"


def test_supervise_main_runs_the_port_cli(monkeypatch, tmp_path):
    """The child is ``python -m nanodiloco_tpu_torch`` with the train
    flags; the checkpoint and log dirs come from the last occurrence of
    each flag, as argparse reads them in the child."""
    seen = {}

    class Capture:
        def __init__(self, command, cfg, emit=None, **kw):
            seen["command"], seen["cfg"] = command, cfg

        def run(self):
            return 0

    monkeypatch.setattr(sup, "Supervisor", Capture)
    with pytest.raises(SystemExit) as e:
        sup.supervise_main(["--max-restarts", "2", "--", "--checkpoint-dir", "a",
                            "--checkpoint-dir=b", "--log-dir", "L", "--device", "cpu"])
    assert e.value.code == 0
    assert seen["command"][:3] == [sys.executable, "-m", "nanodiloco_tpu_torch"]
    assert seen["command"][3:] == ["--checkpoint-dir", "a", "--checkpoint-dir=b",
                                   "--log-dir", "L", "--device", "cpu"]
    assert (seen["cfg"].checkpoint_dir, seen["cfg"].log_dir, seen["cfg"].max_restarts) == (
        "b", "L", 2)


TRAIN_FLAGS = ["--device", "cpu", "--seed", "1", "--num-workers", "2", "--batch-size", "2",
               "--per-device-batch-size", "2", "--seq-length", "32", "--inner-steps", "2",
               "--warmup-steps", "1", "--total-steps", "8", "--no-cost-analysis", "--quiet"]


def test_real_supervised_crash_resumes_bit_exact(tmp_path):
    """``supervise`` over a real crash fault (os._exit(71) at step 5): the
    second child resumes from the step-4 checkpoint and finishes with the
    parameters an uninterrupted run reaches, bit for bit; the JSONL's two
    lifetimes stitch into one goodput ledger with the relaunch gap."""
    model = tmp_path / "model.json"
    model.write_text(json.dumps(LlamaConfig(
        vocab_size=384, hidden_size=32, intermediate_size=64, num_attention_heads=4,
        num_hidden_layers=2, max_position_embeddings=64).to_dict()))
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [{"kind": "crash", "step": 5}]}))
    ck = tmp_path / "ck"
    flags = TRAIN_FLAGS + ["--llama-config-file", str(model)]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "supervise", "--backoff-base", "0.05",
         "--events-jsonl", str(tmp_path / "events.jsonl"), "--", *flags,
         "--checkpoint-dir", str(ck), "--log-dir", str(tmp_path / "runs"), "--run-name", "s",
         "--fault-plan", str(plan)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    events = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    assert [e["event"] for e in events] == ["launch", "crash", "backoff", "launch", "finished"]
    assert events[1]["exit_code"] == 71 and events[1]["progress_step"] == 4
    assert os.path.exists(events[1]["blackbox"])
    recs = [json.loads(line) for line in open(tmp_path / "runs" / "s.jsonl")]
    assert [(r["resume"], r["restart_count"]) for r in recs if "resume" in r] == [(4, 1)]
    from nanodiloco_tpu_torch.obs.goodput import stitch_goodput_records

    stitched = stitch_goodput_records(recs)
    assert stitched["lifetimes"] == 2 and stitched["restart_downtime_s"] > 0

    from nanodiloco_tpu_torch.__main__ import config_from_args, parse_args

    cfg = config_from_args(parse_args(flags + ["--log-dir", str(tmp_path / "twin")]))
    twin = train(cfg, device="cpu")
    saved = CheckpointManager(str(ck)).restore_raw(8, only={"params"})["params"]
    from nanodiloco_tpu_torch.training.checkpoint import named_leaves

    for (name, a), (_, b) in zip(named_leaves(saved), named_leaves(twin["state"].params)):
        assert torch.equal(a, b.detach()), name
    assert np.isfinite(twin["final_loss"]) and len(tree_leaves(twin["state"].params)) == 12
