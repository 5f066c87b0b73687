"""The port's train() under a torch.distributed process group: two gloo
ranks on the CPU, each holding two of W = 4 DiLoCo workers, against one
process holding all four.

One group of ranks runs every case (this file started as a script, once,
in a module fixture); the parent runs the one-process references and
the checks. Cases: a plain run (losses, snapshot, one run name, rank-0
sinks, per-rank trace shards); a checkpoint at step 2 resumed at the same
world size (bit for bit), one written by the two ranks resumed by one
process, one written by one process resumed by the two ranks, and an
elastic resume at W = 2; a stop latched on rank 1 alone; W not a multiple
of the world size; and the training CLI started as two processes with
torchrun's variables (``--device cpu``).

Tolerance against one process: losses 1e-5 relative, the snapshot 1e-4
relative + 5e-5 absolute (tests/test_torch_train_loop.py's, against the
JAX package). The ranks merge ``sum_w c_w (s - p_w)`` over the collective
where one process takes ``s - sum_w c_w p_w``: the same sum in another
order, so the two differ by float32 roundoff that later AdamW steps carry
on. Within one world size the arithmetic is the same on the same numbers:
a resume is bit for bit.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import tree_leaves
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

WORLD = 2
CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16)
RUN = dict(seed=0, batch_size=2, per_device_batch_size=1, seq_length=32, warmup_steps=1,
           inner_steps=2, total_steps=6, lr=1e-3, num_workers=4, model=CFG, quiet=True,
           cost_analysis=False, preempt_signals=False)
LOSS_RTOL = 1e-5
SNAP_RTOL, SNAP_ATOL = 1e-4, 5e-5


def run(out: Path, **kw) -> dict:
    return train(TrainConfig(**{**RUN, "log_dir": None, **kw}), device="cpu")


def pack(summary: dict) -> dict:
    state = summary["state"]
    return {"losses": summary["losses"], "run_name": summary["run_name"],
            "rank": summary["rank"], "world": summary["world"],
            "snapshot": [t.clone() for t in tree_leaves(state.snapshot)],
            "params": [t.detach().clone() for t in tree_leaves(state.params)]}


def cli_args(out: Path) -> list[str]:
    (out / "model.json").write_text(json.dumps(CFG.to_dict()))
    return ["--device", "cpu", "--llama-config-file", str(out / "model.json"),
            "--seed", "0", "--batch-size", "2", "--per-device-batch-size", "1",
            "--seq-length", "32", "--warmup-steps", "1", "--inner-steps", "2",
            "--total-steps", "6", "--lr", "1e-3", "--num-workers", "4",
            "--no-cost-analysis", "--log-dir", str(out / "cli_runs"), "--quiet"]


def rank_main(out: Path) -> None:
    """One rank's cases, its results in ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from nanodiloco_tpu_torch.parallel.mesh import init_from_env

    torch.set_num_threads(1)
    init_from_env("cpu")
    rank = dist.get_rank()
    res = {"a": pack(run(out, log_dir=str(out / "runs"), quiet=False,
                         trace_out=str(out / "trace.json"),
                         status_file=str(out / "status.json")))}
    ck = str(out / "ck_ranks")
    run(out, total_steps=2, checkpoint_dir=ck)
    if rank == 0:  # a copy for the one-process resume, before this one adds steps
        shutil.copytree(ck, out / "ck_ranks_one")
    dist.barrier()
    res["resumed"] = pack(run(out, checkpoint_dir=ck, log_dir=str(out / "resume_runs"),
                              run_name="resumed"))
    res["from_one"] = pack(run(out, checkpoint_dir=str(out / "ck_one")))
    res["elastic"] = pack(run(out, num_workers=2, checkpoint_dir=str(out / "ck_elastic")))
    # a stop latched on rank 1 alone (a resize fault in its own plan)
    plan = out / f"plan{rank}.json"
    plan.write_text(json.dumps({"faults": [{"kind": "resize", "step": 2, "workers": 2}]
                                if rank == 1 else []}))
    try:
        run(out, checkpoint_dir=str(out / "ck_stop"), fault_plan=str(plan),
            log_dir=str(out / "stop_runs"), run_name="stop")
        res["stop"] = None
    except SystemExit as e:
        res["stop"] = e.code
    try:
        run(out, num_workers=3, batch_size=1)
        res["uneven"] = None
    except ValueError as e:
        res["uneven"] = str(e)
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two ranks' results, the CLI group's exit codes and the
    directory; the one-process checkpoints they resume are written
    first."""
    import torch_dist_launch as launch

    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("dist_train")
    run(out, total_steps=2, checkpoint_dir=str(out / "ck_one"))
    shutil.copytree(out / "ck_one", out / "ck_elastic")
    shutil.copytree(out / "ck_one", out / "ck_elastic_one")
    ranks = launch.start([sys.executable, __file__, str(out)], WORLD, out, "ranks")
    cli = launch.start([sys.executable, "-m", "nanodiloco_tpu_torch", *cli_args(out)],
                       WORLD, out, "cli")
    rcs = launch.wait(ranks, 120, out, "ranks")
    cli_rcs = launch.wait(cli, 120, out, "cli")
    assert rcs == [0] * WORLD, [(out / f"ranks.{r}.log").read_text()[-3000:]
                                for r in range(WORLD)]
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"res": res, "out": out, "cli_rcs": cli_rcs}


@pytest.fixture(scope="module")
def one_process(group):
    """The one-process references: uninterrupted, and resumed from each
    checkpoint of the group."""
    out = group["out"]
    return {"a": pack(run(out)),
            "resumed": pack(run(out, checkpoint_dir=str(out / "ck_ranks_one"))),
            "elastic": pack(run(out, num_workers=2,
                                checkpoint_dir=str(out / "ck_elastic_one")))}


def assert_close_runs(got: dict, want: dict) -> None:
    np.testing.assert_allclose(np.array(got["losses"]), np.array(want["losses"]),
                               rtol=LOSS_RTOL)
    for g, w in zip(got["snapshot"], want["snapshot"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=SNAP_RTOL, atol=SNAP_ATOL)


def rows(res: list[dict], key: str) -> list[torch.Tensor]:
    """The ranks' worker rows of a case, stacked back to all W."""
    return [torch.cat(parts) for parts in zip(*(r[key]["params"] for r in res))]


def test_two_ranks_match_one_process(group, one_process):
    res, want = group["res"], one_process["a"]
    for r in res:
        assert (r["a"]["rank"], r["a"]["world"]) == (res.index(r), WORLD)
        # every rank returns the gathered [steps][W] losses and the same snapshot
        assert r["a"]["losses"] == res[0]["a"]["losses"]
        for a, b in zip(r["a"]["snapshot"], res[0]["a"]["snapshot"]):
            assert torch.equal(a, b)
        assert all(p.shape[0] == 2 for p in r["a"]["params"])
    assert np.array(res[0]["a"]["losses"]).shape == (6, 4)
    assert_close_runs(res[0]["a"], want)
    for g, w in zip(rows(res, "a"), want["params"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=SNAP_RTOL, atol=SNAP_ATOL)


def test_one_run_name_and_rank_zero_sinks(group):
    """One run name, one JSONL, stdout on rank 0 only, the status file,
    and one trace shard per rank (merged into one timeline)."""
    from nanodiloco_tpu_torch.obs.tracer import merge_chrome_traces
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    res, out = group["res"], group["out"]
    name = res[0]["a"]["run_name"]
    assert res[1]["a"]["run_name"] == name and name.startswith("nanodiloco-torch_n4_")
    assert sorted(p.name for p in (out / "runs").iterdir()) == [f"{name}.jsonl"]
    recs = [r for r in read_jsonl_records(str(out / "runs" / f"{name}.jsonl"))[0]
            if "loss" in r]
    assert [r["step"] for r in recs] == list(range(1, 7))
    assert [r["loss"] for r in recs] == pytest.approx(
        np.mean(res[0]["a"]["losses"], axis=1).tolist(), rel=1e-6)
    assert f"[{name}]" in (out / "ranks.0.log").read_text()
    assert "[nanodiloco" not in (out / "ranks.1.log").read_text()
    assert json.loads((out / "status.json").read_text())["state"] == "finished"
    shards = [json.loads((out / f).read_text()) for f in ("trace.json", "trace.rank1.json")]
    merged = merge_chrome_traces(shards)
    assert {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"} == {0, 1}


def test_resume_same_world_size_bit_for_bit(group):
    """Two rounds, a checkpoint, then a resume to round 3, all at two
    ranks: the uninterrupted two-rank run's every loss and leaf, bits
    included."""
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    res = group["res"]
    for r in res:
        got, want = r["resumed"], r["a"]
        assert got["losses"] == want["losses"][2:]
        for a, b in zip(got["snapshot"] + got["params"], want["snapshot"] + want["params"]):
            assert torch.equal(a, b)
    recs = read_jsonl_records(str(group["out"] / "resume_runs" / "resumed.jsonl"))[0]
    assert recs[0]["resume"] == 2 and not recs[0]["elastic"]


@pytest.mark.parametrize("case", ["ranks_to_one", "one_to_ranks", "elastic_4_to_2"])
def test_resume_across_world_sizes(group, one_process, case):
    """One checkpoint file whatever the world size: written by two ranks
    and resumed by one process, written by one and resumed by two, and
    resumed at W = 2 (elastic) by both."""
    res, want_a = group["res"], one_process["a"]
    if case == "ranks_to_one":
        got = one_process["resumed"]
        want = {**res[0]["a"], "losses": res[0]["a"]["losses"][2:]}
        assert CheckpointManager(str(group["out"] / "ck_ranks_one")).saved_worker_count() == 4
    elif case == "one_to_ranks":
        got = res[0]["from_one"]
        want = {**want_a, "losses": want_a["losses"][2:]}
    else:
        got, want = res[0]["elastic"], one_process["elastic"]
        assert all(p.shape[0] == 1 for p in got["params"])
    assert_close_runs(got, want)


def test_stop_on_one_rank_stops_both(group):
    """A stop latched on rank 1 alone: both ranks leave at the same round
    boundary with exit code 75, after one checkpoint there, and rank 0
    logs the stop."""
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    res, out = group["res"], group["out"]
    assert [r["stop"] for r in res] == [75, 75]
    assert CheckpointManager(str(out / "ck_stop")).steps() == [2]
    recs = read_jsonl_records(str(out / "stop_runs" / "stop.jsonl"))[0]
    stops = [r for r in recs if "preempt" in r]
    assert len(stops) == 1 and stops[0]["exit_code"] == 75
    assert stops[0]["preempt"] == "peer_stop" and stops[0]["checkpoint_step"] == 2
    assert max(r["step"] for r in recs if "loss" in r) == 2


def test_workers_not_multiple_of_world_raises(group):
    for r in group["res"]:
        assert "num_workers=3 is not a multiple of the world size 2" in r["uneven"]


def test_cli_two_processes(group):
    """``python -m nanodiloco_tpu_torch --device cpu`` started twice with
    torchrun's variables: both exit 0, one JSONL whose losses are the
    two-rank train()'s, the summary printed once."""
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    out = group["out"]
    assert group["cli_rcs"] == [0, 0], (out / "cli.0.log").read_text()[-3000:]
    files = list((out / "cli_runs").iterdir())
    assert len(files) == 1
    recs = [r for r in read_jsonl_records(str(files[0]))[0] if "loss" in r]
    assert [r["loss"] for r in recs] == pytest.approx(
        np.mean(group["res"][0]["a"]["losses"], axis=1).tolist(), rel=1e-6)
    summaries = [line for r in range(WORLD)
                 for line in (out / f"cli.{r}.log").read_text().splitlines()
                 if line.startswith("{") and '"final_loss"' in line]
    assert len(summaries) == 1 and json.loads(summaries[0])["world"] == WORLD


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
