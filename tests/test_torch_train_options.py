"""The port's train() and CLI with the DiLoCo options against the JAX
package's train() on the CPU at a tiny size: the default JSONL (the
dynamics readout and the wire keys are on by default in both), the sync
records of quarantine with the integer wire and the offload, and the
option flags.

Both runs start from one parameter tree (the JAX side's init, carried
into the port through a test-only patch of its initializer, as in
tests/test_torch_train_loop.py) and read the same batches. Tolerances:
losses 1e-5 relative (float32 summation order); the dynamics 1e-4
relative; under the int4 and int8 wires the losses after the first sync
1e-4 (a quantized element may land one bin off, see
tests/test_torch_wire.py); the mode keys (wire bytes, quarantined and
active workers, budgets, staleness, the async tags) exactly.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from nanodiloco_tpu.cli import build_parser
from nanodiloco_tpu.cli import config_from_args as jax_config_from_args
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.training.train_loop import TrainConfig as JaxTrainConfig
from nanodiloco_tpu.training.train_loop import train as jax_train
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.parallel import diloco as port_diloco
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16)
COMMON = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
              warmup_steps=2, total_steps=6, inner_steps=3, lr=1e-3, num_workers=2,
              quiet=True)
# JSONL keys and records of JAX subsystems the port has not ported
# (device-time accounting, cost analysis, the fused loop's differenced
# comm probe, the goodput ledger)
UNPORTED_KEYS = {"devtime", "t_cost_analysis", "t_comm_probe"}
UNPORTED_RECORDS = ("goodput", "cost_analysis")
DYN_KEYS = ("pg_norm", "drift_max", "drift_mean", "outer_momentum_norm", "outer_update_cos")
MODE_KEYS = ("wire_bytes_per_sync", "wire_compression", "wire_bytes_total",
             "quarantined_workers", "workers_active", "inner_steps_realized",
             "outer_staleness", "async_outer", "outer_delay")
# the mode of this file; tests/test_torch_train_modes.py runs the rest
# (async with heterogeneous H, streaming, the straggler policy) through
# the same comparison
MODES = {
    "quarantine-int8-wire-offload": dict(quarantine_nonfinite=True, outer_comm_dtype="int8",
                                         outer_wire_collective=True, offload_snapshot=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; one
    torch thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def records(path):
    return [r for r in (json.loads(line) for line in open(path))
            if not any(k in r for k in UNPORTED_RECORDS)]


def run_both(d, name, **kw):
    """(JAX records, port records, JAX summary, port summary)."""
    jcfg = JaxConfig(**CFG.to_dict())
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(COMMON["seed"]), jcfg))
    with jax.default_matmul_precision("highest"):
        # no cost analysis on the JAX side: its extra lowering is not ported
        jsum = jax_train(JaxTrainConfig(**COMMON, **kw, model=jcfg, log_dir=str(d / "jax"),
                                        run_name=name, preempt_signals=False,
                                        cost_analysis=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_diloco, "init_params",
                   lambda generator, cfg, device: params_from_numpy(tree, device))
        psum = train(TrainConfig(**COMMON, **kw, model=CFG, log_dir=str(d / "port"),
                                 run_name=name), device="cpu")
    return (records(d / "jax" / f"{name}.jsonl"), records(d / "port" / f"{name}.jsonl"),
            jsum, psum)


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("default"), "default", eval_every=1,
                    eval_batches=2)


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    return {name: run_both(d, name, measure_comm=False, **kw) for name, kw in MODES.items()}


def test_default_jsonl_keys_match_jax(default_runs):
    """The default run writes JAX's record keys, the dynamics and wire
    keys included, minus the unported subsystems'. In round 1 the JAX
    fused loop has no t_sync yet (its differenced estimate lands from
    round 2); the port times the sync every round."""
    jrecs, precs, jsum, psum = default_runs
    assert len(jrecs) == len(precs) == 6
    for i, (j, p) in enumerate(zip(jrecs, precs)):
        got = set(p) - ({"t_sync"} if i < 3 else set())
        assert got == set(j) - UNPORTED_KEYS, (i, got ^ (set(j) - UNPORTED_KEYS))
    syncs = [r for r in precs if r["outer_synced"]]
    assert all(set(DYN_KEYS) <= set(r) and "wire_bytes_per_sync" in r for r in syncs)
    summary_keys = {"wire_bytes_per_sync", "wire_compression", "wire_bytes_total"}
    assert summary_keys <= set(psum) and summary_keys <= set(jsum)
    assert all(psum[k] == jsum[k] for k in summary_keys)


def test_default_losses_and_dynamics_match_jax(default_runs):
    jrecs, precs, _, _ = default_runs
    np.testing.assert_allclose([r["loss"] for r in precs], [r["loss"] for r in jrecs],
                               rtol=1e-5)
    for j, p in zip(jrecs, precs):
        if p["outer_synced"]:
            for k in DYN_KEYS:
                np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=k)
            for k in ("wire_bytes_per_sync", "wire_compression", "wire_bytes_total",
                      "workers_active"):
                assert p[k] == j[k], k


def check_mode_against_jax(runs, options):
    """A mode's records and summary against the JAX run's."""
    jrecs, precs, jsum, psum = runs
    lossy = options.get("outer_comm_dtype") in ("int4", "int8")
    losses = np.array([r["loss"] for r in precs if "loss" in r])
    jlosses = np.array([r["loss"] for r in jrecs if "loss" in r])
    np.testing.assert_allclose(losses[:3], jlosses[:3], rtol=1e-5)
    np.testing.assert_allclose(losses[3:], jlosses[3:], rtol=1e-4 if lossy else 1e-5)
    # every record at its step, the per-step ones and the async boundary
    # records alike, with the same keys
    assert [r["step"] for r in precs] == [r["step"] for r in jrecs]
    for j, p in zip(jrecs, precs):
        assert set(p) - {"t_sync"} == set(j) - UNPORTED_KEYS - {"t_sync"}, p["step"]
        for k in MODE_KEYS:
            if k in j:
                assert p[k] == j[k], (p["step"], k)
        for k in DYN_KEYS:
            if k in j:
                np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=k)
    for k in ("async_outer", "outer_delay", "inner_steps_per_worker", "straggler_demotions",
              "wire_bytes_per_sync", "wire_compression", "wire_bytes_total"):
        assert (k in psum) == (k in jsum), k
        if k in jsum:
            assert psum[k] == jsum[k], k


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_sync_records_match_jax(mode_runs, mode):
    check_mode_against_jax(mode_runs[mode], MODES[mode])


@pytest.mark.parametrize("argv", [
    ["--streaming-fragments", "2", "--streaming-delay", "0", "--merge-alpha", "0.5"],
    ["--async-outer", "--outer-delay", "2", "--num-workers", "2"],
    ["--inner-steps-per-worker", "3,1", "--straggler-factor", "2.5",
     "--straggler-min-steps", "2", "--num-workers", "2"],
    ["--outer-comm-dtype", "int4", "--outer-wire-collective", "--quarantine-nonfinite",
     "--offload-snapshot", "--no-dynamics-metrics"],
], ids=["streaming", "async", "hetero", "wire-quarantine"])
def test_option_flags_parse_like_jax(argv):
    ours = cli.config_from_args(cli.parse_args(argv))
    want = jax_config_from_args(build_parser().parse_args(argv))
    for f in dataclasses.fields(TrainConfig):
        if f.name != "model":
            assert getattr(ours, f.name) == getattr(want, f.name), f.name


def test_cli_runs_an_async_hetero_job(tmp_path, capsys):
    cli.main(["--device", "cpu", "--num-workers", "2", "--batch-size", "2",
              "--per-device-batch-size", "2", "--seq-length", "32", "--inner-steps", "2",
              "--warmup-steps", "1", "--total-steps", "4", "--async-outer",
              "--inner-steps-per-worker", "2,1", "--outer-comm-dtype", "int8",
              "--log-dir", str(tmp_path), "--run-name", "cli", "--quiet"])
    recs = [json.loads(line) for line in open(tmp_path / "cli.jsonl")]
    syncs = [r for r in recs if r.get("outer_synced")]
    assert [r["inner_steps_realized"] for r in syncs] == [[2, 1], [2, 1]]
    assert all(r["async_outer"] for r in syncs)
