"""The reference's logging surface in the port: ``--project``, ``--wandb``
and ``--wandb-config-file`` on the training CLI, and the wandb sink of
``MetricsLogger``, against the JAX package's CLI and logger.

No ``wandb`` package is installed or needed: a stub module put in
``sys.modules`` records what the sink hands it (``init``'s arguments,
every ``log`` record, ``finish``), and ``sys.modules["wandb"] = None``
makes the import fail as it does where wandb is missing. The port's runs
are tiny training jobs through ``python -m nanodiloco_tpu_torch``'s
``main`` on the CPU.
"""

import dataclasses
import json
import re
import sys
import types

import pytest
import torch

from nanodiloco_tpu.cli import build_parser
from nanodiloco_tpu.cli import config_from_args as jax_config_from_args
from nanodiloco_tpu.training import metrics as jax_metrics
from nanodiloco_tpu.utils.utils import create_run_name as jax_create_run_name
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

TINY = {"vocab_size": 384, "hidden_size": 32, "intermediate_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 1,
        "max_position_embeddings": 64}
WANDB_CONFIG = {"nodes": 2, "location": "h100", "backend": "nccl", "measure_comms": True}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test worker (the suite runs several),
    restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stub_wandb() -> types.ModuleType:
    """A ``wandb`` module that records its calls."""
    mod = types.ModuleType("wandb")
    mod.inits, mod.records, mod.finished = [], [], 0

    def init(**kw):
        mod.inits.append(kw)

    def log(rec):
        mod.records.append(json.loads(json.dumps(rec)))

    def finish():
        mod.finished += 1

    mod.init, mod.log, mod.finish = init, log, finish
    return mod


def argv_for(tmp_path, log_dir: str, *extra: str) -> list[str]:
    """A tiny training job's flags (both CLIs parse them): 2 workers, 2
    rounds of 2 inner steps, no cost-analysis record."""
    model = tmp_path / "tiny.json"
    model.write_text(json.dumps(TINY))
    return ["--llama-config-file", str(model), "--seed", "0", "--batch-size", "2",
            "--per-device-batch-size", "2", "--seq-length", "32", "--warmup-steps", "1",
            "--total-steps", "4", "--inner-steps", "2", "--num-workers", "2",
            "--no-cost-analysis", "--log-dir", str(tmp_path / log_dir), "--quiet", *extra]


def wandb_file(tmp_path, config: dict) -> str:
    path = tmp_path / "wandb.json"
    path.write_text(json.dumps(config))
    return str(path)


def port_run(argv: list[str], capsys) -> dict:
    summary = cli.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    return summary


def test_wandb_sink_gets_what_jax_gives_it(tmp_path, monkeypatch, capsys):
    """For one argv with a fixed --run-name: ``wandb.init``'s project, name
    and config equal those of the JAX package's MetricsLogger built from
    its ``config_from_args`` as its ``train()`` builds it (the model's
    fields and the wandb config's keys); every record goes to
    ``wandb.log`` exactly as it goes to the JSONL; ``finish`` ends the
    run once."""
    stub = stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    argv = argv_for(tmp_path, "runs", "--wandb", "--project", "proj-x", "--run-name", "fixed",
                    "--wandb-config-file", wandb_file(tmp_path, WANDB_CONFIG))
    port_run(argv, capsys)
    ours, records = list(stub.inits), list(stub.records)
    assert stub.finished == 1

    cfg = jax_config_from_args(build_parser().parse_args(argv))
    jax_metrics.MetricsLogger(
        cfg.run_name, out_dir=None, use_wandb=cfg.use_wandb, wandb_project=cfg.project,
        config={**dataclasses.asdict(cfg.model), **cfg.wandb_config}, quiet=True,
        process_index=0)
    assert len(ours) == 1 and stub.inits[1:] == ours
    assert ours[0]["project"] == "proj-x" and ours[0]["name"] == "fixed"
    assert ours[0]["config"]["location"] == "h100"

    jsonl, torn = read_jsonl_records(str(tmp_path / "runs" / "fixed.jsonl"))
    assert torn == 0 and records == jsonl and any("loss" in r for r in records)


# values that time the run (wall-clock seconds and rates, process ids,
# Unix time), and the dicts keyed by them
TIMING = re.compile(r"^t_|_s$|per_sec|seconds|per_wall|fraction|share|^pid$|t_unix")


def untimed(x):
    """``x`` with every timing value (``TIMING``) replaced by None."""
    if isinstance(x, dict):
        return {k: None if TIMING.search(k) else untimed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def test_wandb_absent_leaves_the_jsonl_as_without_the_flag(tmp_path, monkeypatch, capsys):
    """Where ``wandb`` cannot be imported, ``--wandb`` (and a project)
    changes nothing: the JSONL holds the same lines, key for key and value
    for value, as a run without the flag, apart from the run's timings."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    base = argv_for(tmp_path, "plain", "--run-name", "r")
    port_run(base, capsys)
    flagged = argv_for(tmp_path, "flagged", "--run-name", "r", "--wandb", "--project", "p")
    port_run(flagged, capsys)
    lines = []
    for log_dir in ("plain", "flagged"):
        with open(tmp_path / log_dir / "r.jsonl") as f:
            lines.append([json.dumps(untimed(json.loads(line))) for line in f])
    assert lines[0] == lines[1] and len(lines[0]) >= 4


@pytest.mark.parametrize("measure_comms", [False, True, None])
@pytest.mark.parametrize("flag", [[], ["--measure-comm"], ["--no-measure-comm"]])
def test_measure_comm_default_follows_the_wandb_config_like_jax(tmp_path, measure_comms, flag):
    """``--measure-comm`` defaults to the wandb config's ``measure_comms``
    (on without one, or without the key); the flag overrides it: the
    port's TrainConfig equals JAX's ``config_from_args`` in every field
    they share, wandb_config and measure_comm included."""
    config = {} if measure_comms is None else {"measure_comms": measure_comms}
    argv = ["--wandb-config-file", wandb_file(tmp_path, config), *flag]
    ours = cli.config_from_args(cli.parse_args(argv))
    want = jax_config_from_args(build_parser().parse_args(argv))
    assert ours.measure_comm == want.measure_comm
    assert ours.measure_comm == (flag == ["--measure-comm"] if flag else measure_comms is not False)
    assert (ours.wandb_config, ours.project, ours.use_wandb) == (
        want.wandb_config, want.project, want.use_wandb)


def test_wandb_config_location_enters_the_run_name(tmp_path, monkeypatch, capsys):
    """Without --run-name the generated name takes the wandb config's
    ``nodes`` and ``location`` as JAX's does (``{type}_n{N}_{loc}_...``),
    and names the run's JSONL."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    config = {"location": "h100", "measure_comms": False}
    summary = port_run(argv_for(tmp_path, "named", "--wandb-config-file",
                                wandb_file(tmp_path, config)), capsys)
    ours = summary["run_name"].split("_")
    want = jax_create_run_name("nanodiloco-tpu", {"nodes": 2, **config}).split("_")
    assert ours[0] == "nanodiloco-torch" and ours[1:3] == want[1:3] == ["n2", "h100"]
    assert len(ours) == len(want)
    assert (tmp_path / "named" / f"{summary['run_name']}.jsonl").exists()
    assert summary["avg_sync_time_s"] is None  # measure_comms false: the sync is not fenced
