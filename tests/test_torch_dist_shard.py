"""FSDP and tensor parallelism inside a DiLoCo worker (parallel/mesh.py's
inner axes, parallel/sharding.py, parallel/tensor.py): four gloo ranks on
the CPU against one process of the port and against the JAX package on
one CPU device.

One group of four ranks runs every case (this file started as a script,
once, in a module fixture); the parent computes the references and
checks. W = 2 workers, a tiny float32 model (2 layers, d 64, 4 heads, 2
KV heads, ``remat``), one round of 2 inner steps and the outer step, in
five layouts: ``tp2`` (ranks 0-1) and ``fsdp2`` (ranks 2-3) side by side,
each one worker group of two ranks; ``fsdp2xtp2`` and ``G2xtp2`` over all
four; ``tp4`` over all four at 4 KV heads (tp must divide them). Then:

- the integer int8 wire at ``G2xtp2`` on identical replicas: its
  pseudo-gradient bit for bit against JAX's (integers summed exactly; the
  per-leaf scale is the max over every shard, JAX's whole-leaf one);
- what each rank hands to the collectives in the ``fsdp2xtp2`` round
  against ``sharding.inner_step_bytes`` and ``Diloco.sync_wire_bytes``;
- ``unshard(shard(tree))`` bit for bit;
- the DiLoCo options at ``fsdp2xtp2`` against one process: quarantine
  (worker 1's replica poisoned: every shard of it), heterogeneous H, the
  async outer step (two rounds and the flush) and streaming (2 fragments,
  delay 1);
- ``train()`` at ``fsdp2xtp2``: its checkpoint resumed in one process
  (every leaf bit for bit), one process's resumed by the ranks (bit for
  bit), its own resumed by the ranks (the uninterrupted run's bits), and
  the training CLI with ``--fsdp 2 --tp 2`` in the ranks' group;
- the ``ValueError``s of a layout the mesh does not divide.

Tolerances against one process and against JAX: losses 1e-5 relative,
the snapshot 1e-4 relative + 5e-5 absolute (tests/test_torch_dist_train.py's
and tests/test_torch_train_loop.py's, PERF.md §2): a sharded rank adds a
product's partial sums over the tp ranks and a gradient's over the fsdp
ranks in another order than one process, float32 roundoff that the
AdamW steps carry on. The dynamics readout at 1e-5 relative.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params, tree_leaves, tree_map
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh, record_collectives
from nanodiloco_tpu_torch.parallel.sharding import (
    inner_step_bytes,
    map_leaves,
    named_leaves,
    shard,
    unshard,
)
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

WORLD, W = 4, 2
CFG = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=32, attention_impl="flash", loss_chunk=16,
                  remat=True)
CONFIGS = {"kv2": CFG, "kv4": dataclasses.replace(CFG, num_key_value_heads=4)}
# name: (fsdp, tp, global ranks or None for all four, config)
LAYOUTS = {"tp2": (1, 2, (0, 1), "kv2"), "fsdp2": (2, 1, (2, 3), "kv2"),
           "fsdp2xtp2": (2, 2, None, "kv2"), "G2xtp2": (1, 2, None, "kv2"),
           "tp4": (1, 4, None, "kv4")}
H, A, B, S = 2, 1, 2, 16
ROUND = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=4, lr=1e-2,
             grad_accum=A)
RUN = dict(seed=0, batch_size=2, per_device_batch_size=2, seq_length=32, warmup_steps=1,
           inner_steps=2, lr=1e-3, num_workers=W, model=CFG, quiet=True,
           cost_analysis=False, preempt_signals=False, log_dir=None)
LOSS_RTOL = 1e-5
SNAP_RTOL, SNAP_ATOL = 1e-4, 5e-5


def numpy_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Random weights (std 0.1, norms near 1), numpy, the port's tree."""
    rng = np.random.default_rng(seed)
    shapes = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return map_leaves(shapes, lambda n, t: ((1.0 if "norm" in n else 0.0)
                                            + 0.1 * rng.standard_normal(tuple(t.shape))
                                            ).astype(np.float32))


def torch_tree(tree: dict) -> dict:
    return map_leaves(tree, lambda n, a: torch.from_numpy(np.array(a)))


def round_inputs() -> tuple[np.ndarray, np.ndarray]:
    """[H, W, A, B, S] tokens and masks; the masks left-pad a few
    positions, so rows carry different token counts."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, CFG.vocab_size, (H, W, A, B, S)).astype(np.int64)
    pad = rng.integers(0, S // 2, (H, W, A, B, 1))
    return tokens, (np.arange(S) >= pad).astype(np.int64)


def replicas(seed: int = 5) -> tuple[dict, dict]:
    """A snapshot and W replicas near it (the integer wire's inputs)."""
    snap = numpy_params(CFG, seed)
    rng = np.random.default_rng(seed + 1)
    workers = map_leaves(snap, lambda n, a: (a[None] + 0.05 * rng.standard_normal(
        (W,) + a.shape)).astype(np.float32))
    return snap, workers


def run_round(cfg: LlamaConfig, mesh) -> dict:
    """One round of ``cfg`` on ``mesh``'s layout (one process: WorkerMesh(W)),
    with the dynamics readout: the gathered losses, the whole snapshot,
    the readout and what this rank put on the collectives."""
    from nanodiloco_tpu_torch.parallel.feed import BatchFeeder

    dl = Diloco(cfg, DilocoConfig(**ROUND, dynamics_metrics=True), "cpu", mesh)
    state = dl.init_state(params=torch_tree(numpy_params(cfg)))
    tokens, mask = round_inputs()
    feed = BatchFeeder(dl.mesh)
    with record_collectives() as rec:
        state, losses, _, dyn = dl.round_step(state, feed(tokens), feed(mask))
    return {"losses": losses.clone(), "snapshot": unshard(state.snapshot, dl.mesh),
            "dynamics": {k: v.clone() for k, v in dyn.items()}, "records": rec,
            "wire": dl.sync_wire_bytes(state.snapshot)}


OPTIONS = {"quarantine": dict(quarantine_nonfinite=True),
           "hetero": dict(inner_steps_per_worker=(2, 1)),
           "async": dict(async_outer=True, outer_delay=1), "streaming": {}}


def run_option(name: str, mesh) -> dict:
    """One round of a DiLoCo option on ``mesh`` (two and the flush for
    async): the gathered losses, the whole snapshot and replicas."""
    from nanodiloco_tpu_torch.parallel.feed import BatchFeeder
    from nanodiloco_tpu_torch.parallel.streaming import StreamingConfig, StreamingDiloco

    cfg = DilocoConfig(**ROUND, **OPTIONS[name])
    dl = (StreamingDiloco(CFG, cfg, StreamingConfig(num_fragments=2, delay=1), "cpu", mesh)
          if name == "streaming" else Diloco(CFG, cfg, "cpu", mesh))
    state = dl.init_state(params=torch_tree(numpy_params(CFG)))
    tokens, mask = round_inputs()
    feed = BatchFeeder(dl.mesh)
    tokens, mask = feed(tokens), feed(mask)
    out = {}
    if name == "async":
        losses = []
        for _ in range(2):
            state, loss, _ = dl.async_round_step(state, tokens, mask)
            losses.append(dl.gather_workers(loss, dim=1))
        state, _ = dl.async_flush(state)
        out["losses"] = torch.cat(losses)
    elif name == "quarantine":
        state, loss = dl.inner_round(state, tokens, mask)
        if dl.mesh.owns(1):  # worker 1's replica blows up on the round's last update
            with torch.no_grad():
                for p in tree_leaves(state.params):
                    p[1 - dl.mesh.lo] = float("nan")
        state, eff, _ = dl.outer_step(state)
        out["losses"], out["mask"] = dl.gather_workers(loss, dim=1), eff.tolist()
    else:
        out["losses"] = dl.round_step(state, tokens, mask)[1]
    out["snapshot"] = unshard(state.snapshot, dl.mesh)
    out["params"] = unshard(tree_map(lambda p: p.detach(), state.params), dl.mesh,
                            worker_axis=True)
    return out


def whole_state(state, mesh) -> dict:
    """Every per-leaf tensor of a state, whole along fsdp and tp: params,
    AdamW moments, snapshot, momentum."""
    def moment(key):
        return map_leaves(state.params, lambda n, p: state.inner_opt.state[p][key])

    out = {"params": unshard(tree_map(lambda p: p.detach(), state.params), mesh,
                             worker_axis=True),
           "exp_avg": unshard(moment("exp_avg"), mesh, worker_axis=True),
           "exp_avg_sq": unshard(moment("exp_avg_sq"), mesh, worker_axis=True),
           "snapshot": unshard(state.snapshot, mesh),
           "momentum": unshard(state.outer_opt_state, mesh)}
    return {k: [t.clone() for t in tree_leaves(v)] for k, v in out.items()}


def cli_args(out: Path) -> list[str]:
    """The CLI's flags for the first round of train()'s fsdp 2 x tp 2 run
    (``out/model.json`` written by the parent)."""
    return ["--device", "cpu", "--llama-config-file", str(out / "model.json"), "--seed", "0",
            "--batch-size", "2", "--per-device-batch-size", "2", "--seq-length", "32",
            "--warmup-steps", "1", "--inner-steps", "2", "--total-steps", "2", "--lr", "1e-3",
            "--num-workers", "2", "--fsdp", "2", "--tp", "2", "--no-cost-analysis",
            "--log-dir", str(out / "cli_runs"), "--run-name", "cli", "--quiet"]


def rank_main(out: Path) -> None:
    """One rank's cases, its results in ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from nanodiloco_tpu_torch import __main__ as cli
    from nanodiloco_tpu_torch.parallel.mesh import init_from_env

    torch.set_num_threads(1)
    init_from_env("cpu")
    rank = dist.get_rank()
    res: dict = {"layouts": {}}
    # every rank builds every mesh, in one order (building a group is
    # collective); the two-rank layouts run side by side
    meshes = {name: WorkerMesh.build(W, fsdp, tp, ranks)
              for name, (fsdp, tp, ranks, _) in LAYOUTS.items()}
    for name, mesh in meshes.items():
        if mesh is not None:
            got = run_round(CONFIGS[LAYOUTS[name][3]], mesh)
            if mesh.is_root or name == "fsdp2xtp2":
                res["layouts"][name] = got
    mesh = meshes["G2xtp2"]
    # the integer int8 wire on identical replicas
    snap, workers = replicas()
    dl = Diloco(CFG, DilocoConfig(num_workers=W, outer_comm_dtype="int8",
                                  outer_wire_collective=True), "cpu", mesh)
    s_tree = shard(torch_tree(snap), mesh)
    p_tree = shard(torch_tree(workers), mesh, worker_axis=True)
    with record_collectives() as rec:
        scales = dl.shared_scales(s_tree, p_tree, None)
        pg = [dl._pseudograd_of(s, p, None, sc) for s, p, sc in
              zip(tree_leaves(s_tree), tree_leaves(p_tree), scales)]
    names = [n for n, _ in named_leaves(s_tree)]
    pg_tree = map_leaves(s_tree, lambda n, t: pg[names.index(n)])
    res["int8"] = {"pseudograd": [t.clone() for t in tree_leaves(unshard(pg_tree, mesh))],
                   "records": rec}
    four = meshes["fsdp2xtp2"]
    res["options"] = {name: run_option(name, four) for name in OPTIONS}
    whole = torch_tree(numpy_params(CFG))
    res["round_trip"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(unshard(shard(whole, four), four)), tree_leaves(whole)))
    # train() at fsdp 2 x tp 2
    a = train(TrainConfig(**RUN, total_steps=4, fsdp=2, tp=2,
                          checkpoint_dir=str(out / "ck_a")), device="cpu")
    res["train"] = {"losses": a["losses"], "coords": a["coords"],
                    "state": whole_state(a["state"], four)}
    if rank == 0:  # the same run resumed at step 2
        shutil.copytree(out / "ck_a", out / "ck_b")
        (out / "ck_b" / "step_4.pt").unlink()
    dist.barrier()
    b = train(TrainConfig(**RUN, total_steps=4, fsdp=2, tp=2,
                          checkpoint_dir=str(out / "ck_b")), device="cpu")
    res["resumed"] = whole_state(b["state"], four) | {"losses": b["losses"]}
    one = train(TrainConfig(**RUN, total_steps=2, fsdp=2, tp=2,
                            checkpoint_dir=str(out / "ck_one_ranks")), device="cpu")
    res["from_one"] = whole_state(one["state"], four)
    summary = cli.main(cli_args(out))
    res["cli"] = {"losses": summary["losses"], "world": summary["world"]}
    refused = {}
    for case, make in {
        "workers": lambda: WorkerMesh.current(3, 1, 2),
        "world": lambda: WorkerMesh.current(2, 3, 1),
        "batch": lambda: train(TrainConfig(**{**RUN, "batch_size": 1,
                                              "per_device_batch_size": 1},
                                           total_steps=2, fsdp=2, tp=2), "cpu"),
        "kv_heads": lambda: Diloco(CFG, DilocoConfig(num_workers=W), "cpu",
                                   meshes["tp4"]),
    }.items():
        try:
            make()
            refused[case] = None
        except ValueError as e:
            refused[case] = str(e)
    res["refused"] = refused
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


def jax_round(cfg: LlamaConfig) -> dict:
    """The JAX package's round of the same inputs on one CPU device."""
    import jax
    import jax.numpy as jnp

    from nanodiloco_tpu.models import LlamaConfig as JaxConfig
    from nanodiloco_tpu.parallel import Diloco as JaxDiloco
    from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
    from nanodiloco_tpu.parallel import MeshConfig, build_mesh

    jdl = JaxDiloco(JaxConfig(**cfg.to_dict()),
                    JaxDilocoConfig(**ROUND, dynamics_metrics=False),
                    build_mesh(MeshConfig(diloco=1), devices=jax.devices()[:1]))
    tokens, mask = round_inputs()
    with jax.default_matmul_precision("highest"):
        state = jdl.init_state(jax.random.key(0),
                               params=jax.tree.map(jnp.asarray, numpy_params(cfg)))
        state, losses, _ = jdl.round_step(state, tokens.astype(np.int32),
                                          mask.astype(np.int32))
    return {"losses": np.asarray(losses),
            "snapshot": [np.asarray(x) for x in jax.tree.leaves(state.snapshot)]}


def jax_int8_pseudograd() -> list[np.ndarray]:
    import jax
    import jax.numpy as jnp

    from nanodiloco_tpu.models import LlamaConfig as JaxConfig
    from nanodiloco_tpu.parallel import Diloco as JaxDiloco
    from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
    from nanodiloco_tpu.parallel import MeshConfig, build_mesh

    jdl = JaxDiloco(JaxConfig(**CFG.to_dict()),
                    JaxDilocoConfig(num_workers=W, outer_comm_dtype="int8",
                                    outer_wire_collective=True),
                    build_mesh(MeshConfig(diloco=1), devices=jax.devices()[:1]))
    snap, workers = replicas()
    out = jax.jit(jdl._pseudograd)(jax.tree.map(jnp.asarray, snap),
                                   jax.tree.map(jnp.asarray, workers), None)
    return [np.asarray(x) for x in jax.tree.leaves(out)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four ranks' results, and the references computed while they
    run: one process of the port, the JAX package, and the one-process
    checkpoints."""
    import torch_dist_launch as launch

    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("dist_shard")
    (out / "model.json").write_text(json.dumps(CFG.to_dict()))
    one = train(TrainConfig(**RUN, total_steps=2, checkpoint_dir=str(out / "ck_one")),
                device="cpu")
    shutil.copytree(out / "ck_one", out / "ck_one_ranks")
    procs = launch.start([sys.executable, __file__, str(out)], WORLD, out, "ranks")
    ref = {"one_ckpt": whole_state(one["state"], WorkerMesh(W)),
           "port": {k: run_round(cfg, WorkerMesh(W)) for k, cfg in CONFIGS.items()},
           "jax": {k: jax_round(cfg) for k, cfg in CONFIGS.items()},
           "jax_int8": jax_int8_pseudograd(),
           "options": {name: run_option(name, WorkerMesh(W)) for name in OPTIONS}}
    rcs = launch.wait(procs, 150, out, "ranks")
    assert rcs == [0] * WORLD, [(out / f"ranks.{r}.log").read_text()[-3000:]
                                for r in range(WORLD)]
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"res": res, "ref": ref, "out": out}


def close(got_losses, got_snap, want_losses, want_snap) -> None:
    np.testing.assert_allclose(np.asarray(got_losses), np.asarray(want_losses),
                               rtol=LOSS_RTOL)
    for g, w in zip(got_snap, want_snap):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=SNAP_RTOL,
                                   atol=SNAP_ATOL)


def layout_result(group, name: str) -> dict:
    ranks = LAYOUTS[name][2]
    return group["res"][0 if ranks is None else ranks[0]]["layouts"][name]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_round_matches_one_process(group, name):
    got = layout_result(group, name)
    want = group["ref"]["port"][LAYOUTS[name][3]]
    close(got["losses"], tree_leaves(got["snapshot"]), want["losses"],
          tree_leaves(want["snapshot"]))
    for k, v in want["dynamics"].items():
        np.testing.assert_allclose(got["dynamics"][k].numpy(), v.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_round_matches_jax(group, name):
    got = layout_result(group, name)
    want = group["ref"]["jax"][LAYOUTS[name][3]]
    close(got["losses"], tree_leaves(got["snapshot"]), want["losses"], want["snapshot"])


@pytest.mark.parametrize("name", list(OPTIONS))
def test_diloco_options_at_fsdp2_tp2_match_one_process(group, name):
    want = group["ref"]["options"][name]
    for r in group["res"]:
        got = r["options"][name]
        close(got["losses"], tree_leaves(got["snapshot"]), want["losses"],
              tree_leaves(want["snapshot"]))
        for g, w in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=SNAP_RTOL, atol=SNAP_ATOL)
        if name == "quarantine":
            assert got["mask"] == want["mask"] == [True, False]


def test_int8_integer_wire_bit_for_bit_at_g2_tp2(group):
    want = group["ref"]["jax_int8"]
    for r in group["res"]:
        got = r["int8"]
        assert len(got["pseudograd"]) == len(want)
        for g, w in zip(got["pseudograd"], want):
            assert np.array_equal(g.numpy(), w)
        # the integers on the diloco group alone (int16 sums in int32
        # words), the scale vector's MAX over every rank
        ops = {(x["op"], x["tag"], x["group"], x["dtype"]) for x in got["records"]}
        assert ops == {("all_reduce_max", "scale", "all", "float32"),
                       ("all_reduce_sum", "pseudograd", "diloco", "int32")}


def test_collective_bytes_match_the_sharding(group):
    """What every rank of the fsdp 2 x tp 2 round handed each collective:
    the inner steps' fsdp and tp traffic as ``inner_step_bytes`` predicts,
    the merge as ``sync_wire_bytes`` (a rank's share of the snapshot)."""
    mesh = WorkerMesh(W, 0, WORLD, True, "gloo", 2, 2)
    want = {k: H * v for k, v in inner_step_bytes(CFG, mesh, B // 2, S, A).items()}
    for r in group["res"]:
        got_round = r["layouts"]["fsdp2xtp2"]
        got: dict = {}
        for x in got_round["records"]:
            got[(x["op"], x["tag"])] = got.get((x["op"], x["tag"]), 0) + x["bytes"]
        assert got.pop(("all_reduce_sum", "pseudograd")) == \
            got_round["wire"]["wire_bytes_per_sync"]
        for key in [k for k in got if k[1] in ("workers", "mask", "dynamics")]:
            got.pop(key)  # the losses' and the readout's, not the sharding's
        assert got == want


def test_shard_unshard_round_trip(group):
    assert all(r["round_trip"] for r in group["res"])


def test_checkpoint_resumes_across_layouts_bit_for_bit(group):
    """train() at fsdp 2 x tp 2: its checkpoint resumed by one process holds
    every leaf of the ranks' state; one process's checkpoint resumed by
    the ranks is that process's state; the ranks' step-2 checkpoint
    resumed to step 4 is the uninterrupted run."""
    out, res = group["out"], group["res"]
    ranks_final = res[0]["train"]["state"]
    resumed_one = train(TrainConfig(**RUN, total_steps=4, checkpoint_dir=str(out / "ck_a")),
                        device="cpu")
    one = whole_state(resumed_one["state"], WorkerMesh(W))
    for key, leaves in ranks_final.items():
        assert all(torch.equal(a, b) for a, b in zip(leaves, one[key])), key
    for r in res:
        for key, leaves in group["ref"]["one_ckpt"].items():
            assert all(torch.equal(a, b) for a, b in zip(r["from_one"][key], leaves)), key
        assert r["resumed"]["losses"] == r["train"]["losses"][2:]
        for key, leaves in r["train"]["state"].items():
            assert all(torch.equal(a, b) for a, b in zip(r["resumed"][key], leaves)), key


def test_train_and_cli_at_fsdp2_tp2(group):
    """train() and the CLI in the ranks' group: every rank returns the
    worker's losses [steps][W], its coordinates, and the CLI's round
    equals train()'s first."""
    res = group["res"]
    assert [r["train"]["coords"] for r in res] == [
        {"diloco": 0, "fsdp": f, "tp": t} for f in range(2) for t in range(2)]
    losses = np.asarray(res[0]["train"]["losses"])
    assert losses.shape == (4, W) and np.isfinite(losses).all()
    for r in res:
        assert r["train"]["losses"] == res[0]["train"]["losses"]
        assert r["cli"]["world"] == WORLD
        np.testing.assert_allclose(r["cli"]["losses"], losses[:2], rtol=1e-6)


@pytest.mark.parametrize("case,fragment", [
    ("workers", "num_workers=3 is not a multiple of the 2 worker groups"),
    ("world", "world size 4 is not a multiple of fsdp * tp"),
    ("batch", "per_device_batch_size=1 is not a multiple of fsdp=2"),
    ("kv_heads", "num_key_value_heads=2 is not a multiple of tp=4"),
])
def test_layouts_the_mesh_does_not_divide_raise(group, case, fragment):
    for r in group["res"]:
        assert fragment in (r["refused"][case] or ""), r["refused"][case]


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
