"""The port's train() (nanodiloco_tpu_torch.training.train_loop), its
metrics JSONL, ``report``/``report compare`` and CLI, against the JAX
package's ``train()`` on the CPU at a tiny size.

Both runs start from one parameter tree: the JAX side's
``init_params(jax.random.key(seed))``, carried into the port through a
test-only patch of its initializer. They read the same synthetic corpus
through the same batcher (identical batches), so the losses differ only
by float32 summation order: per-step ``loss`` and ``eval_loss`` within
1e-5 relative (the tolerance of tests/test_torch_diloco.py). Resume after
a SIGTERM repeats the same arithmetic on the same numbers: bit for bit.
"""

import dataclasses
import json
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from nanodiloco_tpu.cli import build_parser
from nanodiloco_tpu.cli import config_from_args as jax_config_from_args
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.training import metrics as jax_metrics
from nanodiloco_tpu.training.train_loop import TrainConfig as JaxTrainConfig
from nanodiloco_tpu.training.train_loop import train as jax_train
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.data import pipeline, tokenshard
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, tree_leaves
from nanodiloco_tpu_torch.obs import tracer
from nanodiloco_tpu_torch.parallel import diloco as port_diloco
from nanodiloco_tpu_torch.resilience.retry import RetryError
from nanodiloco_tpu_torch.training import metrics
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16)
COMMON = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
              warmup_steps=2, total_steps=6, inner_steps=3, lr=1e-3, num_workers=2,
              eval_every=1, eval_batches=2, quiet=True)
# JSONL keys only the JAX loop writes: the fused loop's differenced comm
# probe (t_comm_probe: the port times the outer step directly), and the
# compiled program's own billed cost (eager PyTorch has none)
UNPORTED_KEYS = {"t_comm_probe"}
UNPORTED_COST_KEYS = {"flops_billed", "bytes_accessed_billed"}
# the records that are not per-step metrics, compared on their own
SIDE_RECORDS = ("goodput", "cost_analysis")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; torch's
    default of one intra-op thread per core in each would oversubscribe
    the cores. One thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read(path):
    return [json.loads(line) for line in open(path)]


def step_records(path):
    return [r for r in read(path) if not any(k in r for k in SIDE_RECORDS)]


def side_records(path, kind):
    """(step, keys of the record's body) of each ``kind`` record."""
    return [(r.get("step"), set(r[kind])) for r in read(path) if kind in r]


def port_config(tmp_path, **kw) -> TrainConfig:
    return TrainConfig(**{**COMMON, "model": CFG, "log_dir": str(tmp_path / "runs"), **kw})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run and one port run of 2 rounds with eval and
    checkpoints, from the same initial parameters."""
    d = tmp_path_factory.mktemp("runs")
    jcfg = JaxConfig(**CFG.to_dict())
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(COMMON["seed"]), jcfg))
    with jax.default_matmul_precision("highest"):
        jsum = jax_train(JaxTrainConfig(
            **COMMON, model=jcfg, log_dir=str(d / "jax"), run_name="jax",
            checkpoint_dir=str(d / "jck"), dynamics_metrics=False, preempt_signals=False,
        ))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_diloco, "init_params",
                   lambda generator, cfg, device: params_from_numpy(tree, device))
        # the dynamics readout off on both sides, as the JAX run has it
        psum = train(TrainConfig(**COMMON, model=CFG, log_dir=str(d / "port"),
                                 run_name="port", checkpoint_dir=str(d / "pck"),
                                 dynamics_metrics=False),
                     device="cpu")
    return {"jax": jsum, "port": psum, "tree": tree,
            "jax_jsonl": str(d / "jax" / "jax.jsonl"),
            "port_jsonl": str(d / "port" / "port.jsonl")}


def test_losses_and_eval_match_jax(runs):
    jrecs, precs = step_records(runs["jax_jsonl"]), step_records(runs["port_jsonl"])
    assert len(jrecs) == len(precs) == 6
    np.testing.assert_allclose([r["loss"] for r in precs], [r["loss"] for r in jrecs],
                               rtol=1e-5)
    jev = [r for r in jrecs if "eval_loss" in r]
    pev = [r for r in precs if "eval_loss" in r]
    assert [r["step"] for r in pev] == [r["step"] for r in jev] == [3, 6]
    np.testing.assert_allclose([r["eval_loss"] for r in pev], [r["eval_loss"] for r in jev],
                               rtol=1e-5)
    assert [r["eval_tokens"] for r in pev] == [r["eval_tokens"] for r in jev]
    np.testing.assert_allclose(runs["port"]["eval_loss"], runs["jax"]["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(runs["port"]["final_loss"], runs["jax"]["final_loss"],
                               rtol=1e-5)


def test_step_counters_match_jax(runs):
    keys = ("step", "effective_step", "total_samples", "outer_synced")
    jrecs, precs = step_records(runs["jax_jsonl"]), step_records(runs["port_jsonl"])
    assert [[r[k] for k in keys] for r in precs] == [[r[k] for k in keys] for r in jrecs]
    np.testing.assert_allclose([r["lr"] for r in precs], [r["lr"] for r in jrecs], rtol=1e-6)


def test_record_keys_match_jax_but_the_unported(runs):
    """Every step record carries the JAX keys minus the unported ones. In
    round 1 the JAX fused loop has no ``t_sync`` yet (its differenced
    estimate lands from round 2); the port times the sync every round."""
    jrecs, precs = step_records(runs["jax_jsonl"]), step_records(runs["port_jsonl"])
    for i, (j, p) in enumerate(zip(jrecs, precs)):
        want = set(j) - UNPORTED_KEYS
        got = set(p) - ({"t_sync"} if i < 3 else set())
        assert got == want, (i, got ^ want)
    # the goodput snapshots (one a round and a final one) and the one
    # cost_analysis record, at the same steps with the same keys
    assert (side_records(runs["port_jsonl"], "goodput")
            == side_records(runs["jax_jsonl"], "goodput"))
    [(jstep, jkeys)] = side_records(runs["jax_jsonl"], "cost_analysis")
    assert side_records(runs["port_jsonl"], "cost_analysis") == [
        (jstep, jkeys - UNPORTED_COST_KEYS)]
    summary_keys = {"final_loss", "steps", "avg_sync_time_s", "comm_share", "run_name",
                    "state", "eval_loss", "eval_perplexity", "eval_tokens"}
    assert summary_keys <= set(runs["port"])
    assert summary_keys - {"state"} <= set(runs["jax"])


@pytest.mark.parametrize("which", ["port_jsonl", "jax_jsonl"])
def test_summaries_agree_with_jax(runs, which):
    ours = metrics.summarize_run(runs[which])
    assert ours == jax_metrics.summarize_run(runs[which])
    assert {"final_loss", "final_eval_loss", "tokens_per_sec_last"} <= set(ours)


@pytest.mark.parametrize("key,change,regressed", [
    ("final_loss", 1.05, True),
    ("final_loss", 1.01, False),
    ("final_eval_loss", 1.03, True),
    ("tokens_per_sec_last", 0.7, True),
    ("tokens_per_sec_last", 0.9, False),
    ("comm_share_last", 0.1, True),
    ("comm_share_last", 0.01, False),
])
def test_compare_runs_verdicts_match_jax(runs, key, change, regressed):
    base = metrics.summarize_run(runs["port_jsonl"])
    cand = dict(base)
    cand[key] = base[key] + change if key == "comm_share_last" else base[key] * change
    ours = metrics.compare_runs(base, cand)
    assert ours == jax_metrics.compare_runs(base, cand)
    assert ours["regressions"] == ([key] if regressed else [])


@pytest.mark.parametrize("regress,code", [(False, 0), (True, 1)])
def test_report_compare_exit_codes(runs, tmp_path, regress, code, capsys):
    cand = metrics.summarize_run(runs["port_jsonl"])
    if regress:
        cand["final_loss"] *= 1.5
    path = tmp_path / "cand.json"
    path.write_text(json.dumps(cand))
    if code:
        with pytest.raises(SystemExit) as e:
            cli.main(["report", "compare", runs["port_jsonl"], str(path)])
        assert e.value.code == code
    else:
        cli.main(["report", "compare", runs["port_jsonl"], str(path)])
    out = capsys.readouterr().out
    assert ("REGRESSION in final_loss" if regress else "verdict: OK") in out
    cli.main(["report", runs["port_jsonl"]])
    assert "final_eval_loss" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [],
    ["--seed", "3", "--batch-size", "16", "--per-device-batch-size", "4",
     "--seq-length", "64", "--warmup-steps", "5", "--total-steps", "50",
     "--inner-steps", "10", "--lr", "1e-3", "--outer-lr", "0.5", "--num-workers", "2"],
    ["--dataset-path", "d.tshrd", "--data-layout", "padded", "--eval-every", "2",
     "--eval-batches", "3"],
    ["--checkpoint-dir", "ck", "--checkpoint-every", "4", "--no-resume",
     "--log-dir", "L", "--run-name", "R"],
    ["--no-measure-comm", "--trace-out", "t.json", "--no-preempt-signals", "--quiet"],
], ids=["defaults", "reference", "data-eval", "ckpt-log", "obs"])
def test_cli_flags_parse_like_jax(argv):
    ours = cli.config_from_args(cli.parse_args(argv))
    want = jax_config_from_args(build_parser().parse_args(argv))
    for f in dataclasses.fields(TrainConfig):
        if f.name != "model":
            assert getattr(ours, f.name) == getattr(want, f.name), f.name
    assert ours.grad_accum == want.grad_accum


def test_sigterm_exits_75_with_a_checkpoint_and_resumes_exactly(runs, tmp_path, monkeypatch):
    """A SIGTERM raised while the prefetch thread draws round 2's first
    batch stops the run at the next round boundary with a checkpoint
    there; the resumed run equals the uninterrupted one (the module's
    port run, same initial parameters) bit for bit."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install on the main thread only")
    real_iter = pipeline.DilocoBatcher.iter_from

    def signalling(self, start):
        for step, batch in enumerate(real_iter(self, start), start=start):
            if step == 3:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    ck_dir = str(tmp_path / "ck")
    monkeypatch.setattr(port_diloco, "init_params",
                        lambda generator, cfg, device: params_from_numpy(runs["tree"], device))
    monkeypatch.setattr(pipeline.DilocoBatcher, "iter_from", signalling)
    with pytest.raises(SystemExit) as e:
        # checkpoint_every past the run: the only save is the preemption's
        train(port_config(tmp_path / "b", checkpoint_dir=ck_dir, checkpoint_every=5,
                          run_name="stopped"), device="cpu")
    monkeypatch.undo()
    assert e.value.code == 75
    assert signal.getsignal(signal.SIGTERM) is before
    step = CheckpointManager(ck_dir).latest_step
    assert step == 3
    preempt = [r for r in read(tmp_path / "b" / "runs" / "stopped.jsonl") if "preempt" in r]
    assert preempt == [{"preempt": "preempt", "exit_code": 75, "checkpoint_step": step,
                        "step": step}]
    resumed = train(port_config(tmp_path / "c", checkpoint_dir=ck_dir), device="cpu")
    full = runs["port"]
    np.testing.assert_allclose(resumed["losses"], full["losses"][step:], rtol=0, atol=0)
    assert resumed["eval_loss"] == full["eval_loss"]
    for a, b in zip(tree_leaves(resumed["state"].params) + tree_leaves(resumed["state"].snapshot),
                    tree_leaves(full["state"].params) + tree_leaves(full["state"].snapshot)):
        assert torch.equal(a, b)


def test_no_prefetch_thread_survives_a_failed_train(tmp_path, monkeypatch):
    def boom(self, state):
        raise RuntimeError("injected outer-step failure")

    monkeypatch.setattr(port_diloco.Diloco, "outer_step", boom)
    prev = tracer.current_tracer()
    with pytest.raises(RuntimeError, match="injected"):
        train(port_config(tmp_path, run_name="crashed"), device="cpu")
    assert not [t for t in threading.enumerate() if t.name.startswith("prefetch")]
    assert tracer.current_tracer() is prev
    box = json.load(open(tmp_path / "runs" / "crashed-blackbox.json"))
    assert box["reason"] == "train_exception:RuntimeError"


def test_train_on_a_tokenshard(tmp_path):
    """--dataset-path X.tshrd: the manifest sizes the vocabulary (no fit)
    and the holdout comes from the shard's tail; another path is read as
    an HF datasets directory."""
    rows = pipeline.pack_corpus(pipeline.synthetic_corpus(n_docs=200, seed=0),
                                ByteTokenizer(), 32)
    path = str(tmp_path / "data.tshrd")
    tokenshard.write_shard(path, rows)
    with open(path + ".manifest.json", "w") as f:
        json.dump({"vocab_size": 512, "tokenizer": "byte-level"}, f)
    summary = train(port_config(tmp_path, dataset_path=path,
                                checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    assert summary["model"]["vocab_size"] == 512
    assert np.isfinite(summary["final_loss"]) and np.isfinite(summary["eval_loss"])
    sidecar = json.load(open(tmp_path / "ck" / "model_config.json"))
    assert sidecar["model"]["vocab_size"] == 512 and sidecar["tokenizer"] is None
    with pytest.raises(ValueError, match="seq-length"):
        train(port_config(tmp_path, dataset_path=path, seq_length=64), device="cpu")
    # any other path is an HF datasets directory, fetched under retries
    with pytest.raises(RetryError, match="hf_dir not found"):
        train(port_config(tmp_path, dataset_path=str(tmp_path / "hf_dir")), device="cpu")


@pytest.mark.parametrize("layout,measure_comm", [("padded", True), ("packed", False)])
def test_layouts_and_trace_export(tmp_path, layout, measure_comm):
    """The padded layout end to end, the Chrome trace of the phases, and
    --no-measure-comm: the outer step then runs inside the inner phase,
    unfenced, and the sync keys are None, as in the JAX fused loop
    before its estimate lands."""
    padded = dict(data_layout="padded", seq_length=128,
                  model=dataclasses.replace(CFG, attention_impl="dense"))
    summary = train(port_config(tmp_path, measure_comm=measure_comm, run_name="run",
                                trace_out=str(tmp_path / "trace.json"),
                                **(padded if layout == "padded" else {})), device="cpu")
    assert np.isfinite(summary["final_loss"]) and np.isfinite(summary["eval_loss"])
    trace = json.load(open(tmp_path / "trace.json"))
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"data", "inner", "eval", "log"} <= names
    assert ("sync" in names) == measure_comm
    last = step_records(tmp_path / "runs" / "run.jsonl")[-1]
    assert ("t_sync" in last) == measure_comm
    assert (last["comm_share"] is None) == (summary["comm_share"] is None) == (not measure_comm)
