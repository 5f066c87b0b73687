"""Fault injection in the port (nanodiloco_tpu_torch/resilience/faults.py)
and through its train(), on the CPU, against the JAX package: the plan's
parsing and firing (tests/test_resilience.py:94-153), every fault kind
through the real loop (:241-630, tests/test_elastic.py:495-626), and the
port's fault, retry and elastic records key for key against JAX's
``train()`` under one plan.

Both runs start from one numpy parameter tree (the JAX init, carried
into the port through a test-only patch of its initializer) and read the
same batches: their losses differ by float32 summation order only, 1e-5
relative (tests/test_torch_train_loop.py). A crash resumed from its
checkpoint repeats the same arithmetic: bit for bit. A real crash
(``os._exit``) runs only in a subprocess; in process the plan's
``"raise": true`` variant stands in, as in the JAX tests.
"""

import functools
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.training.train_loop import TrainConfig as JaxTrainConfig
from nanodiloco_tpu.training.train_loop import train as jax_train
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, tree_leaves
from nanodiloco_tpu_torch.obs.watchdog import WatchdogConfig
from nanodiloco_tpu_torch.parallel import diloco as port_diloco
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.resilience import faults
from nanodiloco_tpu_torch.resilience.faults import (
    CRASH_EXIT_CODE,
    FaultPlan,
    InjectedCrash,
    clear_plan,
    install_plan,
    poison_worker_params,
)
from nanodiloco_tpu_torch.resilience.retry import RetryPolicy
from nanodiloco_tpu_torch.resilience.supervisor import (
    PREEMPT_EXIT_CODE,
    WATCHDOG_EXIT_CODE,
    WORKERS_TARGET_ENV,
    latest_checkpoint_step,
)
from nanodiloco_tpu_torch.training import train_loop
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.elastic import load_schedule
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

SMALL = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=64)
COMMON = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
              warmup_steps=2, total_steps=9, inner_steps=3, lr=1e-3, num_workers=2,
              quiet=True, measure_comm=False, cost_analysis=False)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread per test worker process (bit-identical reruns
    need it: several threads sum the embedding backward in varying
    order), restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    clear_plan()


def small_cfg(tmp_path, **kw) -> TrainConfig:
    return TrainConfig(**{**COMMON, "model": SMALL, "log_dir": str(tmp_path / "runs"), **kw})


def write_plan(tmp_path, fault_list, name="plan.json") -> str:
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump({"faults": fault_list}, f)
    return path


def read_lines(path):
    return [json.loads(line) for line in open(path)]


def run_jsonl(tmp_path, run_name):
    return str(tmp_path / "runs" / f"{run_name}.jsonl")


# -- the plan's mechanics -------------------------------------------------------

def test_fault_plan_validates_schema():
    with pytest.raises(ValueError, match="unknown kind"):
        FaultPlan([{"kind": "meteor", "step": 1}])
    with pytest.raises(ValueError, match="integer step"):
        FaultPlan([{"kind": "crash", "step": -1}])
    with pytest.raises(ValueError, match="integer step"):
        FaultPlan([{"kind": "crash", "step": "soon"}])
    with pytest.raises(ValueError, match="op must be"):
        FaultPlan([{"kind": "io_error", "step": 1, "op": "delete"}])
    with pytest.raises(ValueError, match="integer worker"):
        FaultPlan([{"kind": "nan_params", "step": 1}])
    with pytest.raises(ValueError, match='"faults"'):
        FaultPlan.from_dict({"fault": []})


def test_fault_plan_validates_new_kinds(tmp_path):
    with pytest.raises(ValueError, match="integer worker"):
        FaultPlan([{"kind": "straggler", "step": 1}])
    with pytest.raises(ValueError, match="seconds must be > 0"):
        FaultPlan([{"kind": "straggler", "step": 1, "worker": 0, "seconds": 0}])
    with pytest.raises(ValueError, match="rounds must be >= 1"):
        FaultPlan([{"kind": "straggler", "step": 1, "worker": 0, "rounds": 0}])
    with pytest.raises(ValueError, match="workers >= 1"):
        FaultPlan([{"kind": "resize", "step": 1, "workers": 0}])
    p = FaultPlan([{"kind": "straggler", "step": 2, "worker": 1, "seconds": 0.5, "rounds": 2}])
    assert p.straggle_due() == {}
    p.advance(2)
    assert p.straggle_due() == {1: 0.5} and p.straggle_due() == {1: 0.5}
    assert p.straggle_due() == {}
    assert [r["kind"] for r in p.drain_fired()] == ["straggler"]


def test_fault_plan_fires_once_by_step_cursor():
    p = FaultPlan([
        {"kind": "nan_params", "step": 4, "worker": 0},
        {"kind": "stall", "step": 2, "seconds": 0.01},
        {"kind": "io_error", "step": 1, "op": "save", "count": 2},
    ])
    assert p.take_due("nan_params") == [] and p.stall_seconds() == 0.0
    assert not p.io_should_fail("save")
    p.advance(4)
    assert len(p.take_due("nan_params")) == 1 and p.take_due("nan_params") == []
    assert p.stall_seconds() == 0.01 and p.stall_seconds() == 0.0
    assert p.io_should_fail("save") and p.io_should_fail("save")
    assert not p.io_should_fail("save") and not p.io_should_fail("restore")
    assert sorted(r["kind"] for r in p.drain_fired()) == ["io_error", "nan_params", "stall"]
    assert p.drain_fired() == []


CRASH_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
from nanodiloco_tpu_torch.resilience.faults import FaultPlan, fire_crash
plan = FaultPlan.load(sys.argv[1])
plan.advance(5)
fire_crash(plan.take_due("crash")[0])
"""


def test_fault_plan_marker_survives_process_death(tmp_path):
    """A real crash (os._exit in a child process) exits 71 and leaves the
    .fired marker; the same plan loaded after the "restart" does not fire
    it again."""
    plan_path = write_plan(tmp_path, [{"kind": "crash", "step": 3}])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = subprocess.run([sys.executable, "-c", CRASH_CHILD, plan_path, root],
                        timeout=120).returncode
    assert rc == CRASH_EXIT_CODE
    p2 = FaultPlan.load(plan_path)
    p2.advance(5)
    assert p2.take_due("crash") == []


def test_hooks_are_noops_without_a_plan():
    assert faults.active_plan() is None
    faults.check_io("save")
    t0 = time.perf_counter()
    assert faults.maybe_stall() == 0.0 and faults.maybe_straggle() == {}
    assert time.perf_counter() - t0 < 0.05


def test_crash_exit_code_is_distinct():
    assert CRASH_EXIT_CODE not in (0, PREEMPT_EXIT_CODE, WATCHDOG_EXIT_CODE)


def test_injected_nan_equals_handcrafted_poison():
    """poison_worker_params is the quarantine tests' surgery (p[k] = nan per
    leaf); a round then quarantines and heals the worker."""
    W, H = 4, 2
    cfg = DilocoConfig(num_workers=W, inner_steps=H, warmup_steps=0, total_steps=20,
                       lr=1e-3, quarantine_nonfinite=True)
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(0), JaxConfig(**SMALL.to_dict())))
    dl = Diloco(SMALL, cfg, device="cpu")
    injected = poison_worker_params(dl.init_state(params=params_from_numpy(tree, "cpu")), 2)
    hand = dl.init_state(params=params_from_numpy(tree, "cpu"))
    with torch.no_grad():
        for p in tree_leaves(hand.params):
            p[2] = float("nan")
    for a, b in zip(tree_leaves(injected.params), tree_leaves(hand.params)):
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    rng = np.random.default_rng(100)
    toks = torch.from_numpy(rng.integers(0, SMALL.vocab_size, (H, W, 1, 2, 16)))
    masks = torch.ones_like(toks)
    for state in (injected, hand):
        dl.round_step(state, toks, masks)
    for a, b in zip(tree_leaves(injected.snapshot), tree_leaves(hand.snapshot)):
        assert torch.equal(a, b) and torch.isfinite(a).all()


# -- the same plan through JAX's train() and the port's -------------------------

MIXED_PLAN = [
    {"kind": "io_error", "step": 3, "op": "save", "count": 2},
    {"kind": "nan_params", "step": 4, "worker": 1},
    {"kind": "stall", "step": 4, "seconds": 0.2},
    {"kind": "straggler", "step": 7, "worker": 0, "seconds": 1.0, "rounds": 1},
]
MIXED = dict(total_steps=12, quarantine_nonfinite=True, straggler_factor=2.0)


@pytest.fixture(scope="module")
def mixed_runs(tmp_path_factory):
    """One JAX run and one port run of MIXED_PLAN, from one init tree."""
    d = tmp_path_factory.mktemp("mixed")
    jcfg = JaxConfig(**SMALL.to_dict())
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(COMMON["seed"]), jcfg))
    out = {}
    with jax.default_matmul_precision("highest"):
        out["jsum"] = jax_train(JaxTrainConfig(
            **{**COMMON, **MIXED}, model=jcfg, log_dir=str(d / "jax"), run_name="r",
            checkpoint_dir=str(d / "jck"), dynamics_metrics=False, preempt_signals=False,
            fault_plan=write_plan(d, MIXED_PLAN, "jplan.json")))
    clear_plan()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_diloco, "init_params",
                   lambda generator, cfg, device: params_from_numpy(tree, device))
        out["psum"] = train(TrainConfig(
            **{**COMMON, **MIXED}, model=SMALL, log_dir=str(d / "port"), run_name="r",
            checkpoint_dir=str(d / "pck"), dynamics_metrics=False,
            fault_plan=write_plan(d, MIXED_PLAN, "pplan.json")), device="cpu")
    out["jax"] = read_lines(d / "jax" / "r.jsonl")
    out["port"] = read_lines(d / "port" / "r.jsonl")
    out["pck"] = str(d / "pck")
    return out


# the record keys whose values are measured times
TIMED = {"t_unix", "per_step_s", "median_per_step_s", "delay_s", "error"}


def events(recs, key):
    return sorted((json.dumps({k: v for k, v in r.items() if k not in TIMED}, sort_keys=True)
                   for r in recs if r.get(key)))


@pytest.mark.parametrize("key", ["fault", "retry", "elastic"])
def test_fault_records_match_jax_key_for_key(mixed_runs, key):
    """Every fault, retry and elastic record of the port equals JAX's, all
    keys and their values (the measured seconds apart: keys only)."""
    port, jx = events(mixed_runs["port"], key), events(mixed_runs["jax"], key)
    assert port == jx and port
    keysets = lambda recs: sorted(tuple(sorted(r)) for r in recs if r.get(key))  # noqa: E731
    assert keysets(mixed_runs["port"]) == keysets(mixed_runs["jax"])


def test_mixed_plan_losses_and_quarantine_match_jax(mixed_runs):
    steps = lambda recs: [r for r in recs if "loss" in r]  # noqa: E731
    jsteps, psteps = steps(mixed_runs["jax"]), steps(mixed_runs["port"])
    assert [r["step"] for r in psteps] == [r["step"] for r in jsteps] == list(range(1, 13))
    np.testing.assert_allclose([r["loss"] for r in psteps], [r["loss"] for r in jsteps],
                               rtol=1e-5)
    q = {r["step"]: r["quarantined_workers"] for r in psteps if r["outer_synced"]}
    assert q == {r["step"]: r["quarantined_workers"] for r in jsteps if r["outer_synced"]}
    assert q == {3: 0, 6: 1, 9: 0, 12: 0}  # the sync covering step 4, healed after
    realized = [r["inner_steps_realized"] for r in psteps if r["outer_synced"]]
    assert realized == [r["inner_steps_realized"] for r in jsteps if r["outer_synced"]]


def test_io_error_fault_retries_and_recovers(mixed_runs):
    recs = mixed_runs["port"]
    assert len([r for r in recs if r.get("retry") == "ckpt_save"]) == 2
    assert not [r for r in recs if r.get("alarm") == "ckpt_save_failed"]
    assert latest_checkpoint_step(mixed_runs["pck"]) == 12


def test_straggler_fault_demotes_then_restores_and_books_wait(mixed_runs):
    """The injected straggle lands as t_straggler and goodput
    straggler_wait, demotes worker 0 for the next round and is restored
    when it passes; the sidecar carries the restored schedule."""
    recs, summary = mixed_runs["port"], mixed_runs["psum"]
    assert summary["straggler_demotions"] == 1
    assert summary["inner_steps_per_worker"] == [3, 3]
    el = [r for r in recs if r.get("elastic")]
    assert [r["elastic"] for r in el] == ["straggler_demote", "straggler_restore"]
    assert el[0]["worker"] == 0 and el[0]["h_to"] < el[0]["h_from"]
    assert isinstance(el[0]["t_unix"], float)
    straggled = [r for r in recs if r.get("outer_synced") and r.get("t_straggler")]
    assert straggled and straggled[0]["t_straggler"] >= 1.0
    assert [r for r in recs if r.get("goodput")][-1]["goodput"]["straggler_wait_s"] >= 1.0
    assert load_schedule(mixed_runs["pck"])["inner_steps_per_worker"] == [3, 3]


def test_stall_fault_sleeps_in_the_prefetch_and_is_booked(mixed_runs):
    recs = mixed_runs["port"]
    stalls = [r for r in recs if r.get("fault") == "stall"]
    assert len(stalls) == 1 and stalls[0]["seconds"] == 0.2
    gp = [r for r in recs if r.get("goodput")][-1]["goodput"]
    assert 0 < gp["stall_s"] <= 0.25


# -- each path on its own -------------------------------------------------------

def test_nan_fault_through_live_loop_quarantines_and_heals(tmp_path):
    plan = write_plan(tmp_path, [{"kind": "nan_params", "step": 4, "worker": 1}])
    summary = train(small_cfg(tmp_path, quarantine_nonfinite=True, fault_plan=plan,
                              run_name="nanfault"), device="cpu")
    assert np.isfinite(summary["final_loss"])
    assert all(torch.isfinite(t).all() for t in tree_leaves(summary["state"].params))
    lines = read_lines(run_jsonl(tmp_path, "nanfault"))
    assert [r for r in lines if r.get("fault")] == [
        {"fault": "nan_params", "step": 4, "worker": 1, "fired_at_step": 6}]


def test_persistent_save_failure_degrades_not_aborts(tmp_path):
    plan = write_plan(tmp_path, [{"kind": "io_error", "step": 3, "op": "save", "count": 4}])
    ck = str(tmp_path / "ckpt")
    summary = train(small_cfg(tmp_path, checkpoint_dir=ck, fault_plan=plan, run_name="iodead"),
                    device="cpu")
    assert np.isfinite(summary["final_loss"])
    lines = read_lines(run_jsonl(tmp_path, "iodead"))
    alarms = [r for r in lines if r.get("alarm") == "ckpt_save_failed"]
    assert len(alarms) == 1 and "Injected" in alarms[0]["error"]
    assert summary["alarms"] >= 1
    assert latest_checkpoint_step(ck) == 9


def test_restore_hits_io_fault_and_retries(tmp_path):
    events_ = []
    mngr = CheckpointManager(str(tmp_path / "ck"), on_event=events_.append,
                             retry=RetryPolicy(max_attempts=3, base_delay_s=0.01,
                                               deadline_s=5.0))
    dl = Diloco(SMALL, DilocoConfig(num_workers=2), device="cpu")
    state = dl.init_state(torch.Generator().manual_seed(0))
    mngr.save(1, state)
    want = [t.clone() for t in tree_leaves(state.snapshot)]
    with torch.no_grad():
        for t in tree_leaves(state.snapshot):
            t.zero_()
    plan = FaultPlan([{"kind": "io_error", "step": 0, "op": "restore", "count": 1}])
    plan.advance(0)
    install_plan(plan)
    try:
        mngr.restore(state)
    finally:
        clear_plan()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.snapshot), want))
    assert len(events_) == 1 and events_[0]["retry"] == "ckpt_restore"


def test_restore_io_fault_fires_through_train(tmp_path):
    ck = str(tmp_path / "ckpt")
    train(small_cfg(tmp_path / "a", total_steps=3, checkpoint_dir=ck, run_name="part"),
          device="cpu")
    plan = write_plan(tmp_path, [{"kind": "io_error", "step": 0, "op": "restore", "count": 1}])
    summary = train(small_cfg(tmp_path / "b", checkpoint_dir=ck, fault_plan=plan,
                              run_name="res"), device="cpu")
    assert np.isfinite(summary["final_loss"])
    lines = read_lines(run_jsonl(tmp_path / "b", "res"))
    assert [r for r in lines if r.get("retry") == "ckpt_restore"]
    assert [r for r in lines if "resume" in r][0]["resume"] == 3


def test_stall_fault_trips_the_watchdog_through_train(tmp_path, monkeypatch):
    """The prefetch's injected stall opens a real silent gap between round
    heartbeats: the stall sentinel fires on the real clock."""
    # the watchdog's 30 s floor and 2 s poll, scaled down to the test's clock
    monkeypatch.setattr(train_loop, "WatchdogConfig",
                        functools.partial(WatchdogConfig, min_stall_s=0.3, poll_s=0.075))
    plan = write_plan(tmp_path, [{"kind": "stall", "step": 4, "seconds": 1.2}])
    summary = train(small_cfg(tmp_path, total_steps=12, fault_plan=plan, watch_stall_factor=2.0,
                              status_file=str(tmp_path / "status.json"), run_name="stall"),
                    device="cpu")
    lines = read_lines(run_jsonl(tmp_path, "stall"))
    alarms = [r for r in lines if r.get("alarm") == "stall"]
    # the stall sleeps in round 3's prefetch, submitted in round 2 (cursor 6):
    # the silent gap follows round 2's heartbeat
    assert alarms and alarms[0]["step"] == 6 and summary["alarms"] >= 1
    status = json.load(open(tmp_path / "status.json"))
    assert status["state"] == "finished" and status["alarm_kinds"]["stall"] >= 1


def test_crash_resume_matches_uninterrupted_at_every_boundary(tmp_path):
    full = train(small_cfg(tmp_path / "a", run_name="full"), device="cpu")
    full_by_step = {r["step"]: r["loss"] for r in read_lines(run_jsonl(tmp_path / "a", "full"))
                    if "loss" in r}
    plan = write_plan(tmp_path, [{"kind": "crash", "step": 5, "raise": True}])
    ck = str(tmp_path / "ckpt")
    with pytest.raises(InjectedCrash):
        train(small_cfg(tmp_path / "b", checkpoint_dir=ck, fault_plan=plan, run_name="crashed"),
              device="cpu")
    assert latest_checkpoint_step(ck) == 3
    # the same plan file again: the fired marker keeps the crash from recurring
    resumed = train(small_cfg(tmp_path / "c", checkpoint_dir=ck, fault_plan=plan,
                              run_name="resumed"), device="cpu")
    res_lines = read_lines(run_jsonl(tmp_path / "c", "resumed"))
    assert [r for r in res_lines if "resume" in r][0]["resume"] == 3
    steps = [r for r in res_lines if "loss" in r]
    assert [r["step"] for r in steps] == list(range(4, 10))
    for r in steps:
        assert r["loss"] == full_by_step[r["step"]], r["step"]
    for x, y in zip(tree_leaves(full["state"].params), tree_leaves(resumed["state"].params)):
        assert torch.equal(x, y)


def test_watchdog_nan_checkpoint_exit(tmp_path):
    plan = write_plan(tmp_path, [{"kind": "nan_params", "step": 2, "worker": 0}])
    with pytest.raises(SystemExit) as e:
        train(small_cfg(tmp_path, fault_plan=plan, checkpoint_dir=str(tmp_path / "ckpt"),
                        watch_action="checkpoint-exit", run_name="wexit"), device="cpu")
    assert e.value.code == WATCHDOG_EXIT_CODE
    lines = read_lines(run_jsonl(tmp_path, "wexit"))
    assert [r for r in lines if r.get("alarm") == "nan_loss"]
    pre = [r for r in lines if r.get("preempt")]
    assert pre and pre[0]["preempt"] == "watchdog:nan_loss"
    assert pre[0]["exit_code"] == WATCHDOG_EXIT_CODE
    assert latest_checkpoint_step(str(tmp_path / "ckpt")) == pre[0]["checkpoint_step"] == 3


def test_resize_fault_writes_target_and_preempts(tmp_path, monkeypatch):
    target = str(tmp_path / "workers.target")
    monkeypatch.setenv(WORKERS_TARGET_ENV, target)
    plan = write_plan(tmp_path, [{"kind": "resize", "step": 4, "workers": 4}])
    ck = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as e:
        train(small_cfg(tmp_path, fault_plan=plan, checkpoint_dir=ck, run_name="resize"),
              device="cpu")
    assert e.value.code == PREEMPT_EXIT_CODE
    assert open(target).read().strip() == "4"
    assert latest_checkpoint_step(ck) % 3 == 0
    lines = read_lines(run_jsonl(tmp_path, "resize"))
    assert [r for r in lines if r.get("fault") == "resize"]
    assert [r for r in lines if r.get("preempt")][0]["preempt"] == "resize"


def test_watch_action_and_worker_bound_validated(tmp_path):
    with pytest.raises(ValueError, match="watch_action"):
        train(small_cfg(tmp_path, watch_action="explode"), device="cpu")
    for kind in ("nan_params", "straggler"):
        plan = write_plan(tmp_path, [{"kind": kind, "step": 1, "worker": 7}])
        with pytest.raises(ValueError, match="only 2 worker"):
            train(small_cfg(tmp_path, fault_plan=plan), device="cpu")
    assert faults.active_plan() is None
