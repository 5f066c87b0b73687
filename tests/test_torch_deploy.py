"""The port's canary deploy (nanodiloco_tpu_torch/fleet/deploy.py, the
one fleet module rewritten rather than copied) against the JAX package:

- ``canary_eval_loss``: the same held-out batch (the synthetic corpus
  at the held-out seed, packed with the run's tokenizer) through the
  port's ``causal_lm_loss`` gives the JAX loss on the same snapshot,
  within 1e-5 relative in float32; a NaN snapshot gives a non-finite
  loss on both; the default device is the card, and without one it
  raises;
- the train → serve loop on the CPU: the port's ``train()`` writes its
  ``step_<n>.pt`` checkpoints, two of the port's serve replicas behind
  the port's router run the real canary bench, a better step is
  promoted fleet-wide (the fleet then serves JAX's solo greedy streams
  of those weights), a step poisoned with NaN is rolled back and never
  canaried again, and ``report faults`` lists the two verdicts in order;
- the ``fleet`` CLI with ``--watch-checkpoint-dir`` in a subprocess
  does the same promotion and leaves the final fleet-goodput record.
"""

import functools
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanodiloco_tpu.cli as jax_cli
import nanodiloco_tpu.fleet.deploy as jax_deploy
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu_torch.__main__ import _load_checkpoint_snapshot
from nanodiloco_tpu_torch.__main__ import main as torch_main
from nanodiloco_tpu_torch.fleet import DeployController, FleetRouter, Replica
from nanodiloco_tpu_torch.fleet import deploy as torch_deploy
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_to_numpy
from nanodiloco_tpu_torch.serve import InferenceEngine, Scheduler, ServeServer, http_post_json
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

JG = importlib.import_module("nanodiloco_tpu.models.generate")
CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16)
# the canary gate: the loss rule at its default; the serving legs
# loosened, because a shared CPU's latency and tokens/s move more
# between two benches than a card's (the loss and NaN rules decide here)
GATE = dict(max_loss_increase=0.02, max_tps_drop=0.95, max_latency_increase=50.0)
BENCH = dict(clients=2, requests_per_client=1, max_new_tokens=8, prompt_len=12,
             device="cpu")


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


def wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port training run with a checkpoint every round (steps 2, 4, 6),
    and the live state it ends in."""
    d = tmp_path_factory.mktemp("deploy")
    summary = train(TrainConfig(
        model=CFG, seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
        warmup_steps=2, total_steps=6, inner_steps=2, lr=3e-3, num_workers=2,
        checkpoint_dir=str(d / "ck"), log_dir=None, quiet=True, dynamics_metrics=False),
        device="cpu")
    return {"dir": d, "ck": str(d / "ck"), "state": summary["state"]}


def watch_dir(run, name, steps):
    """A checkpoint dir holding ``steps`` of the run (and its sidecar)."""
    d = run["dir"] / name
    d.mkdir()
    shutil.copy(os.path.join(run["ck"], "model_config.json"), d)
    for s in steps:
        shutil.copy(os.path.join(run["ck"], f"step_{s}.pt"), d)
    return str(d)


def poison(run, directory, step):
    """Write ``step`` through the port's CheckpointManager from the run's
    state with its merged snapshot set to NaN."""
    state = run["state"]
    saved = [t.clone() for t in _leaves(state.snapshot)]
    try:
        for t in _leaves(state.snapshot):
            t.fill_(float("nan"))
        CheckpointManager(directory, max_to_keep=10).save(step, state)
    finally:
        for t, s in zip(_leaves(state.snapshot), saved):
            t.copy_(s)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def jax_canary_loss(monkeypatch, directory, step):
    """The JAX package's canary_eval_loss on the port checkpoint's
    snapshot: its loader is handed the same tree as numpy."""
    cfg, sidecar, snap = _load_checkpoint_snapshot(directory, step)
    tree = params_to_numpy(snap)
    monkeypatch.setattr(jax_cli, "_load_checkpoint_snapshot",
                        lambda d, s: (JaxConfig(**cfg.to_dict()), sidecar,
                                      jax.tree.map(jnp.asarray, tree)))
    with jax.default_matmul_precision("highest"):
        return jax_deploy.canary_eval_loss(directory, step)


@pytest.mark.parametrize("step", [2, 4, 6])
def test_canary_eval_loss_matches_jax(run, monkeypatch, step):
    ours = torch_deploy.canary_eval_loss(run["ck"], step, device="cpu")
    ref = jax_canary_loss(monkeypatch, run["ck"], step)
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_canary_eval_loss_nan_snapshot_and_default_device(run, monkeypatch):
    d = watch_dir(run, "nan", [])
    poison(run, d, 8)
    assert np.isnan(torch_deploy.canary_eval_loss(d, 8, device="cpu"))
    assert np.isnan(jax_canary_loss(monkeypatch, d, 8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_deploy.canary_eval_loss(run["ck"], 2)


def serve(directory, step):
    """A port serve replica of ``step`` with the CLI's swap loader."""
    cfg, _, params = _load_checkpoint_snapshot(directory, step)
    eng = InferenceEngine(params, cfg, num_slots=2, max_len=64, device="cpu")
    server = ServeServer(Scheduler(eng), port=0, host="127.0.0.1", max_new_tokens_cap=64,
                         swap_loader=lambda d, s: _load_checkpoint_snapshot(d, s)[2]).start()
    return server


def jax_solo(directory, step, prompt, n):
    cfg, _, snap = _load_checkpoint_snapshot(directory, step)
    params = jax.tree.map(jnp.asarray, params_to_numpy(snap))
    with jax.default_matmul_precision("highest"):
        out = JG.generate(params, jnp.asarray([prompt], jnp.int32),
                          JaxConfig(**cfg.to_dict()), n)
    return np.asarray(out)[0].tolist()


@within(120)
def test_promote_then_rollback_over_the_port_fleet(run, tmp_path, capsys):
    d = watch_dir(run, "watch", [2, 4])
    servers = [serve(d, 2), serve(d, 2)]
    events = str(tmp_path / "events.jsonl")
    router = FleetRouter([Replica(f"r{i}", f"http://127.0.0.1:{s.port}")
                          for i, s in enumerate(servers)],
                         host="127.0.0.1", events_jsonl=events, quiet=True,
                         drain_timeout_s=5.0, health_interval_s=0.1).start()
    try:
        router.health_tick()
        ctl = DeployController(router, d, initial_step=2, bench_kwargs=BENCH, **GATE)
        assert ctl.poll_once() == "promote" and ctl.deployed_step == 4
        router.health_tick()  # one swap each: generation 1 on both
        assert router.fleet_stats()["deploy_generations"] == {"r0": 1, "r1": 1}
        prompt = [5, 9, 2, 11, 3]
        for _ in range(2):
            code, out = router.handle_generate({"token_ids": prompt, "max_new_tokens": 8,
                                                "temperature": 0.0, "stop": False})
            assert code == 200 and out["token_ids"] == jax_solo(d, 4, prompt, 8)
        poison(run, d, 6)
        assert ctl.poll_once() == "rollback" and ctl.failed_steps == {6}
        assert ctl.poll_once() is None  # never canaried again
        router.health_tick()  # the canary swapped to 6 and back to 4; r1 never moved
        assert router.fleet_stats()["deploy_generations"] == {"r0": 3, "r1": 1}
        # the rest of the fleet never saw the poisoned weights, and the
        # canary, whose slots served them, keeps no row of theirs (the
        # port zeroes a slot's rows at admission; the JAX engine does not)
        for server in (servers[1], servers[0]):
            code, out = http_post_json(f"http://127.0.0.1:{server.port}/v1/generate", {
                "token_ids": prompt, "max_new_tokens": 8, "temperature": 0.0, "stop": False})
            assert code == 200 and out["token_ids"] == jax_solo(d, 4, prompt, 8)
    finally:
        router.stop()
        for s in servers:
            s.stop()
    recs = [json.loads(line) for line in open(events)]
    kinds = [r["deploy_event"] for r in recs if "deploy_event" in r]
    assert kinds.index("promote") < kinds.index("rollback")
    verdicts = [r for r in recs if r.get("deploy_event") == "canary_verdict"]
    assert [v["ok"] for v in verdicts] == [True, False]
    assert verdicts[1]["regressions"] == ["canary_eval_loss_nonfinite"]
    # the loss leg's kernel launches: none on the CPU
    assert all(v["record"]["kernel_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                                  "flash_bwd_dkv": 0} for v in verdicts)
    assert recs[-1]["fleet_goodput"]["replicas_total"] == 2
    capsys.readouterr()
    torch_main(["report", "faults", events, "--json"])
    listed = [e["event"] for e in json.loads(capsys.readouterr().out)]
    assert listed == ["promote", "rollback"]


KV_MODES = {"dense": {}, "paged": {"kv_block_size": 4},
            "paged_int8": {"kv_block_size": 4, "kv_dtype": "int8"}}


@pytest.mark.parametrize("kv", KV_MODES.values(), ids=KV_MODES.keys())
def test_nan_weights_leave_no_stale_kv_rows(run, kv):
    """A replica that serves a request under NaN weights (a canary of a
    poisoned checkpoint), is swapped back and serves again from the same
    slot: its first two streams are the JAX engine's, and the third is the
    same request's stream on a fresh port engine with the clean weights,
    dense, paged and paged int8. (The JAX engine's third stream is garbage:
    it keeps the NaN rows the poisoned weights wrote; the port zeroes a
    slot's rows when it hands the slot to a request.)"""
    from nanodiloco_tpu.serve import GenRequest as JaxRequest
    from nanodiloco_tpu.serve import InferenceEngine as JaxEngine
    from nanodiloco_tpu.serve import Scheduler as JaxScheduler
    from nanodiloco_tpu_torch.serve import GenRequest

    cfg, _, snap = _load_checkpoint_snapshot(run["ck"], 4)
    tree = params_to_numpy(snap)
    nan_tree = jax.tree.map(lambda a: np.full_like(a, np.nan), tree)
    plan = ((None, (5, 9, 2, 11)), (nan_tree, (1, 2, 3, 4, 5, 6, 7, 8)), (tree, (5, 9, 2, 11)))
    streams = {}
    for name, eng_cls, sched_cls, req_cls, to_params, c, extra, steps in (
            ("jax", JaxEngine, JaxScheduler, JaxRequest,
             lambda t: jax.tree.map(jnp.asarray, t), JaxConfig(**cfg.to_dict()), {}, plan[:2]),
            ("torch", InferenceEngine, Scheduler, GenRequest,
             lambda t: jax.tree.map(torch.from_numpy, t), cfg, {"device": "cpu"}, plan),
            ("fresh", InferenceEngine, Scheduler, GenRequest,
             lambda t: jax.tree.map(torch.from_numpy, t), cfg, {"device": "cpu"}, plan[2:])):
        eng = eng_cls(to_params(tree), c, num_slots=1, max_len=32, **kv, **extra)
        sched = sched_cls(eng)
        out = []
        for params, prompt in steps:
            if params is not None:
                eng.swap_weights(to_params(params))
            t = sched.submit(req_cls(prompt=prompt, max_new_tokens=6, seed=0))
            for _ in range(100):
                sched.tick()
                if t.done():
                    break
            out.append(t.result["tokens"])
        streams[name] = out
    assert streams["torch"][:2] == streams["jax"]
    # the repaired stream: a fresh engine's, and JAX's first stream (the
    # same prompt under the same clean weights)
    assert streams["torch"][2] == streams["fresh"][0] == streams["jax"][0]
    assert len(streams["fresh"][0]) == 6


def _poisoned_engine(kv, **extra):
    """A 2-slot engine on the CPU whose whole arena holds non-finite rows
    (int8 rows cannot: their scales do)."""
    from nanodiloco_tpu_torch.models.llama import init_params

    params = init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    eng = InferenceEngine(params, CFG, num_slots=2, max_len=32, device="cpu", **kv, **extra)
    for t in (eng.pool or eng.cache).values():
        t.fill_(127 if t.dtype == torch.int8 else float("nan"))
    return eng


@pytest.mark.parametrize("kv", KV_MODES.values(), ids=KV_MODES.keys())
def test_admission_zeroes_the_rows_a_slot_reads(kv):
    """A request served under NaN weights leaves non-finite rows; once it
    is released, the next request admitted to its slot reads only zeros
    there (its dense rows, or its freshly allocated blocks in every arena
    tensor), while a live request in the other slot keeps its rows."""
    from nanodiloco_tpu_torch.models.llama import init_params, tree_map
    from nanodiloco_tpu_torch.serve import GenRequest

    params = init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    eng = InferenceEngine(params, CFG, num_slots=2, max_len=32, device="cpu", **kv)

    def rows(slot):  # what the slot's attention reads, arena by arena
        if not eng.paged:
            return [t[:, slot] for t in eng.cache.values()]
        return [t[:, eng._slot_blocks[slot]] for t in eng.pool.values()]

    eng.prefill(1, GenRequest(prompt=(7, 8, 9), max_new_tokens=4))
    live = [r.clone() for r in rows(1)]
    eng.swap_weights(tree_map(lambda t: torch.full_like(t, float("nan")), params))
    eng.prefill(0, GenRequest(prompt=(1, 2, 3, 4, 5), max_new_tokens=4))
    assert any(not torch.isfinite(r.float()).all() for r in rows(0))
    eng.release(0)
    eng.swap_weights(params)
    eng.start_prefill(0, GenRequest(prompt=(1, 2, 3, 4, 5, 6), max_new_tokens=4))
    assert all(not r.any() for r in rows(0))
    assert all(torch.equal(a, b) for a, b in zip(rows(1), live))
    assert all(r.any() for r in live)


@pytest.mark.parametrize("kv", [KV_MODES["paged"], KV_MODES["paged_int8"]],
                         ids=["paged", "paged_int8"])
def test_the_block_sentinels_read_is_zeroed_when_freed(kv):
    """Table sentinels read the pool's last block, so every slot's masked
    rows reach it: when a request that held it releases it, it is zeroed
    (a block another slot still references is left alone)."""
    from nanodiloco_tpu_torch.serve import GenRequest

    eng = _poisoned_engine(kv, kv_pool_blocks=4)
    last = eng.block_pool.num_blocks - 1
    eng.start_prefill(0, GenRequest(prompt=tuple(range(1, 13)), max_new_tokens=4))
    assert last in eng._slot_blocks[0]
    for t in eng.pool.values():  # the rows its poisoned request wrote
        t[:, eng._slot_blocks[0]] = 127 if t.dtype == torch.int8 else float("nan")
    eng.block_pool.ref([last])  # a second holder: nothing is freed yet
    eng.release(0)
    assert all((t[:, last] != 0).all() for t in eng.pool.values())
    eng._free_blocks([last])
    assert all(not t[:, last].any() for t in eng.pool.values())
    assert eng.block_pool.free_blocks == eng.block_pool.num_blocks


@within(120)
def test_fleet_cli_watches_and_promotes(run, tmp_path):
    d = watch_dir(run, "cli", [2, 4])
    servers = [serve(d, 2), serve(d, 2)]
    events = tmp_path / "events.jsonl"
    cmd = [sys.executable, "-m", "nanodiloco_tpu_torch", "fleet", "--host", "127.0.0.1",
           "--watch-checkpoint-dir", d, "--initial-step", "2", "--device", "cpu",
           "--poll-interval-s", "0.2", "--health-interval-s", "0.1", "--drain-timeout-s", "5",
           "--canary-clients", "2", "--canary-requests", "1", "--canary-max-new-tokens", "8",
           "--max-tps-drop", "0.95", "--max-latency-increase", "50",
           "--events-jsonl", str(events), "--quiet"]
    for s in servers:
        cmd += ["--replica", f"http://127.0.0.1:{s.port}"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        def promoted():
            return events.exists() and any(
                json.loads(line).get("deploy_event") == "promote"
                for line in events.read_text().splitlines())
        assert wait_for(promoted, 90.0), proc.stdout.read() if proc.poll() else ""
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        for s in servers:
            s.stop()
    recs = [json.loads(line) for line in events.read_text().splitlines()]
    promote = next(r for r in recs if r.get("deploy_event") == "promote")
    assert promote["step"] == 4 and promote["prior_step"] == 2
    assert "fleet_goodput" in recs[-1]
    assert "fleet router on 127.0.0.1:" in out and "watching" in out


def test_report_faults_lists_the_deploy_verdicts_beside_jax_events(tmp_path, capsys):
    """``report faults`` of a fleet's events JSONL lists every event that
    the JAX verb lists, and adds the deploy verdicts (promote, rollback,
    rollback_failed) in their places, which the JAX verb leaves out."""
    recs = [
        {"deploy_event": "canary_start", "step": 4, "replica": "r0", "baseline_step": 2},
        {"deploy_event": "slo_burn", "slo": "ttft_p95", "replica": "r1"},
        {"deploy_event": "promote", "step": 4, "replicas": ["r0", "r1"], "prior_step": 2},
        {"deploy_event": "canary_deferred", "step": 6, "replica": "r0",
         "reason": "fleet SLO burning"},
        {"deploy_event": "slo_clear", "slo": "ttft_p95", "replica": "r1"},
        {"deploy_event": "rollback", "step": 6, "restored_step": 4,
         "regressions": ["canary_eval_loss_nonfinite"]},
        {"deploy_event": "swap", "replica": "r0", "step": 4},
        {"deploy_event": "rollback_failed", "step": 8, "restored_step": None,
         "regressions": ["canary_request_errors"],
         "error": "no prior deployed step to restore"},
    ]
    path = tmp_path / "fleet.jsonl"
    path.write_text("".join(json.dumps({"t_unix": float(i), **r}) + "\n"
                            for i, r in enumerate(recs)))
    listed = {}
    for name, cli_main in (("jax", jax_cli.main), ("torch", torch_main)):
        capsys.readouterr()
        cli_main(["report", "faults", str(path), "--json"])
        listed[name] = json.loads(capsys.readouterr().out)
    verdicts = ("promote", "rollback", "rollback_failed")
    assert [e["event"] for e in listed["jax"]] == ["slo_burn", "canary_deferred", "slo_clear"]
    assert [e for e in listed["torch"] if e["event"] not in verdicts] == listed["jax"]
    assert [e["event"] for e in listed["torch"]] == [
        "slo_burn", "promote", "canary_deferred", "slo_clear", "rollback", "rollback_failed"]
    assert [e for e in listed["torch"] if e["event"] in verdicts] == [
        {"event": r["deploy_event"], "t_unix": float(i),
         **{k: v for k, v in r.items() if k != "deploy_event"}}
        for i, r in enumerate(recs) if r["deploy_event"] in verdicts]
