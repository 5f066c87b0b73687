"""The outer step's merge under a torch.distributed process group: two
gloo ranks on the CPU, each holding two of W = 4 workers, against the JAX
package at W = 4 and against the one-process port.

One group of ranks runs every case (this file started as a script, once,
in a module fixture) and writes what it got; the parent computes the
references and checks.

- The pseudo-gradient of identical replicas (tests/test_torch_wire.py's
  ``test_pseudograd_matches_jax`` cases: every wire, unmasked and with
  worker 2 masked, and worker 2 poisoned with NaN) against JAX: the
  integer wire bit for bit (its sums are integers: exact in any order);
  every other wire at that file's 1e-6 relative + 4 float32 ulps of the
  snapshot's largest element (the ranks sum ``c_w wire(s - p_w)`` over the
  collective in another order than JAX's mean).
- What each rank hands to the collectives in one outer step, by wire:
  dtypes and bytes against ``sync_wire_bytes`` (2 bytes a parameter where
  the accumulator is int16, packed two to an int32 word) and, for the
  integer wire, against JAX's audit rule (``allreduce_wire_report``: no
  float all-reduce but the f32 [n_leaves] scale vector).
- One round of each option against the one-process port: the integer
  wire, quarantine, heterogeneous H, the dynamics readout, the async
  outer step and streaming. Losses at 1e-6 relative; snapshots and
  replicas at 1e-5 relative + 1e-6 absolute: the float merge's roundoff
  (above) enters the inner steps that follow an async or streaming apply,
  whose AdamW update divides by the root of the second moment, so an
  element with a small one carries it further. The integer wire's
  snapshot and the quarantine mask exact, the dynamics readout at 1e-5
  relative (its pairwise drift is the one-process arithmetic on gathered
  replicas; the cosine reads the update, which carries the merge's
  roundoff).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params, tree_leaves
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig, DilocoState
from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh, record_collectives
from nanodiloco_tpu_torch.parallel.streaming import StreamingConfig, StreamingDiloco
from nanodiloco_tpu_torch.training.optim import inner_optimizer

WORLD, W = 2, 4
TINY = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=32)
WIRES = [(None, False), ("bfloat16", False), ("int8", False), ("int4", False),
         ("int8", True), ("int4", True)]
MASKS = [None, (1, 1, 0, 1)]
MODES = {"f32": {}, "bf16": dict(outer_comm_dtype="bfloat16"),
         "int8": dict(outer_comm_dtype="int8"),
         "int8-wire": dict(outer_comm_dtype="int8", outer_wire_collective=True),
         "int4-wire": dict(outer_comm_dtype="int4", outer_wire_collective=True),
         "int16-wire": dict(outer_comm_dtype="int16", outer_wire_collective=True)}
H, A, B, S = 2, 1, 2, 16
ROUND = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=8, lr=1e-2,
             grad_accum=A)
OPTIONS = {"int8-wire": dict(outer_comm_dtype="int8", outer_wire_collective=True),
           "quarantine": dict(quarantine_nonfinite=True),
           "hetero": dict(inner_steps_per_worker=(2, 1, 2, 1)),
           "dynamics": dict(dynamics_metrics=True),
           "async": dict(async_outer=True, outer_delay=1),
           "streaming": {}}


def snapshot_and_workers(seed=1, spread=0.1):
    """tests/test_torch_wire.py's inputs: {"w": [16], "b": [4, 4]} and
    [W, ...] replicas near them."""
    rng = np.random.default_rng(seed)
    snap = {"w": rng.standard_normal(16).astype(np.float32),
            "b": (rng.standard_normal((4, 4)) * 5.0).astype(np.float32)}
    workers = {k: (v[None] + rng.standard_normal((W,) + v.shape) * spread).astype(np.float32)
               for k, v in snap.items()}
    return snap, workers


def make_dl(kw: dict, mesh=None, streaming=False):
    cfg = DilocoConfig(**kw)
    if streaming:
        return StreamingDiloco(TINY, cfg, StreamingConfig(num_fragments=2, delay=1),
                               device="cpu", mesh=mesh)
    return Diloco(TINY, cfg, device="cpu", mesh=mesh)


def pseudograd(dl, snap, workers, mask, lo, hi):
    weights = None if mask is None else [float(m) for m in mask]
    return {k: dl._pseudograd_of(torch.from_numpy(snap[k]),
                                 torch.from_numpy(workers[k][lo:hi]), weights).numpy()
            for k in snap}


def toy_state(snap, workers, lo, hi):
    params = {k: torch.tensor(v[lo:hi]).requires_grad_(True) for k, v in workers.items()}
    return DilocoState(params=params, inner_opt=inner_optimizer(tree_leaves(params)),
                       snapshot={k: torch.tensor(v) for k, v in snap.items()},
                       outer_opt_state={k: torch.zeros(v.shape) for k, v in snap.items()})


def round_inputs():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, TINY.vocab_size, (2, H, W, A, B, S)).astype(np.int64)
    return tokens, np.ones_like(tokens)


def run_option(name: str, mesh) -> dict:
    """One round (two for async: its first boundary applies an init
    copy) of an option at W = 4: the gathered losses, the snapshot, and
    the option's own readout. ``mesh`` None: this process's group, or
    all four workers on one process (``WorkerMesh(W)``)."""
    kw = {**ROUND, **OPTIONS[name]}
    dl = make_dl(kw, mesh, streaming=name == "streaming")
    lo, hi = dl.mesh.lo, dl.mesh.hi
    state = dl.init_state(params=init_params(torch.Generator().manual_seed(0), TINY, "cpu"))
    tokens, mask = round_inputs()
    out = {}
    if name == "async":
        losses = []
        for r in range(2):
            state, loss, aux = dl.async_round_step(state, tokens[r][:, lo:hi],
                                                   mask[r][:, lo:hi])
            losses.append(dl.gather_workers(loss, dim=1))
        state, aux = dl.async_flush(state)
        out["losses"] = torch.cat(losses)
        out["staleness"] = aux["outer_staleness"]
    elif name == "quarantine":
        state, loss = dl.inner_round(state, tokens[0][:, lo:hi], mask[0][:, lo:hi])
        if dl.mesh.owns(2):  # worker 2's replica blows up on the round's last update
            with torch.no_grad():
                for p in tree_leaves(state.params):
                    p[2 - lo] = float("nan")
        state, eff, _ = dl.outer_step(state)
        out["losses"] = dl.gather_workers(loss, dim=1)
        out["mask"] = eff.tolist()
        out["exp_avg"] = [st["exp_avg"].clone() for st in state.inner_opt.state.values()]
    else:
        res = dl.round_step(state, tokens[0][:, lo:hi], mask[0][:, lo:hi])
        out["losses"] = res[1]
        if name == "dynamics":
            out["dynamics"] = {k: v.clone() for k, v in res[3].items()}
    out["snapshot"] = [t.clone() for t in tree_leaves(state.snapshot)]
    out["params"] = [t.detach().clone() for t in tree_leaves(state.params)]
    return out


# the int16 sum at its bound: the int8 wire at W = 258 (258 * 127 = 32766)
PACKED_W, PACKED_Q = 258, 127


def packed_parts(rank: int) -> dict[str, torch.Tensor]:
    """Each rank's partial sums (of its 129 workers) at the extremes and
    between them, an odd length (the pad lane) included."""
    bound = (PACKED_W // WORLD) * PACKED_Q
    rng = np.random.default_rng(rank)
    return {"max": torch.full((7,), bound, dtype=torch.int32),
            "min": torch.full((6,), -bound, dtype=torch.int32),
            "mixed": torch.tensor(rng.integers(-bound, bound + 1, 9), dtype=torch.int32),
            "edges": torch.tensor([bound, -bound, 0, 1, -1], dtype=torch.int32)
            * (1 if rank == 0 else -1)}


def packed_cases(mesh) -> dict:
    from nanodiloco_tpu_torch.parallel.diloco import _packed_int16_sum

    big = WorkerMesh(PACKED_W, mesh.rank, mesh.world, True, mesh.backend)
    with record_collectives() as rec:
        out = {k: _packed_int16_sum(big, v, PACKED_W * PACKED_Q)
               for k, v in packed_parts(mesh.rank).items()}
    return {"out": out, "records": rec}


def rank_main(out: Path) -> None:
    """One rank's cases, its results in ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from nanodiloco_tpu_torch.parallel.mesh import init_from_env

    torch.set_num_threads(1)
    init_from_env("cpu")
    mesh = WorkerMesh.current(W)
    lo, hi = mesh.lo, mesh.hi
    snap, workers = snapshot_and_workers()
    res = {"pseudograd": {}, "wire": {}, "options": {}}
    for wire, collective in WIRES:
        dl = make_dl(dict(num_workers=W, outer_comm_dtype=wire,
                          outer_wire_collective=collective))
        for mask in MASKS:
            got = pseudograd(dl, snap, workers, mask, lo, hi)
            nan = None
            if mask is not None:
                poisoned = {k: v.copy() for k, v in workers.items()}
                for v in poisoned.values():
                    v[2] = np.nan
                nan = pseudograd(dl, snap, poisoned, mask, lo, hi)
            res["pseudograd"][(wire, collective, mask)] = (got, nan)
    for name, kw in MODES.items():
        dl = make_dl(dict(num_workers=W, **kw))
        state = toy_state(snap, workers, lo, hi)
        with record_collectives() as rec:
            dl.outer_step(state)
        res["wire"][name] = {"records": rec, "snapshot": dict(state.snapshot),
                             "wire_bytes": dl.sync_wire_bytes(state.snapshot)}
    for name in OPTIONS:
        res["options"][name] = run_option(name, None)
    res["packed"] = packed_cases(mesh)
    torch.save(res, out / f"rank{mesh.rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Both ranks' results, and the one-process references computed while
    the ranks run."""
    import torch_dist_launch as launch

    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("dist_merge")
    procs = launch.start([sys.executable, __file__, str(out)], WORLD, out, "ranks")
    single = {name: run_option(name, WorkerMesh(W)) for name in OPTIONS}
    snap, workers = snapshot_and_workers()
    toy = {}
    for name, kw in MODES.items():
        state = toy_state(snap, workers, 0, W)
        make_dl(dict(num_workers=W, **kw), WorkerMesh(W)).outer_step(state)
        toy[name] = dict(state.snapshot)
    rcs = launch.wait(procs, 120, out, "ranks")
    assert rcs == [0] * WORLD, [(out / f"ranks.{r}.log").read_text()[-3000:]
                                for r in range(WORLD)]
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"res": res, "single": single, "toy": toy}


@functools.cache
def jax_reference(wire, collective, mask) -> dict:
    """JAX's pseudo-gradient of the same inputs at W = 4, jitted (one
    compile, not one per eager op; the integer wire's bits are the eager
    path's)."""
    import jax
    import jax.numpy as jnp
    from test_torch_wire import jax_dl

    snap, workers = snapshot_and_workers()
    jdl = jax_dl(W, outer_comm_dtype=wire, outer_wire_collective=collective)
    m = None if mask is None else jnp.asarray(mask, jnp.float32)
    out = jax.jit(jdl._pseudograd)(jax.tree.map(jnp.asarray, snap),
                                   jax.tree.map(jnp.asarray, workers), m)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("wire,collective", WIRES)
@pytest.mark.parametrize("mask", MASKS, ids=["unmasked", "worker-2-masked"])
def test_pseudograd_matches_jax(group, wire, collective, mask):
    snap, _ = snapshot_and_workers()
    want = jax_reference(wire, collective, mask)
    for r in group["res"]:
        got, nan = r["pseudograd"][(wire, collective, mask)]
        for k in snap:
            if collective:
                np.testing.assert_array_equal(got[k], want[k])
            else:
                ulps = 4 * np.finfo(np.float32).eps * np.abs(snap[k]).max()
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=ulps)
            if nan is not None:
                # a masked worker's NaN changes nothing, on either rank
                np.testing.assert_array_equal(nan[k], got[k])


HLO_TYPES = {"float32": "f32", "bfloat16": "bf16", "int8": "s8", "int16": "s16",
             "int32": "s32"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wire_bytes_and_dtypes(group, mode):
    """What one outer step hands to the collectives, on each rank: the
    merge's payload is ``sync_wire_bytes`` (less the integer wire's 4-byte
    survivor count, which the ranks read from the gathered mask); the
    integer wire carries integers and one f32 [n_leaves] vector of
    absmaxes only, as JAX's HLO audit requires; the snapshot after it is
    the one-process port's (the integer wire's bit for bit)."""
    from nanodiloco_tpu.utils.utils import allreduce_wire_report

    n, n_leaves = 32, 2
    for r in group["res"]:
        got = r["wire"][mode]
        recs, ledger = got["records"], got["wire_bytes"]
        assert {x["op"] for x in recs} <= {"all_reduce_sum", "all_reduce_max"}
        payload = [x for x in recs if x["tag"] == "pseudograd"]
        total = sum(x["bytes"] for x in recs)
        hlo = "\n".join(f"%ar{i} = {HLO_TYPES[x['dtype']]}[{x['numel']}] all-reduce(%p{i})"
                        for i, x in enumerate(recs))
        ints, wide = allreduce_wire_report(hlo, scale_leaves=n_leaves)
        if MODES[mode].get("outer_wire_collective"):
            acc = {"int8-wire": 2, "int4-wire": 1, "int16-wire": 4}[mode]
            assert sum(x["bytes"] for x in payload) == acc * n
            assert {x["dtype"] for x in payload} == {
                {2: "int32", 1: "int8", 4: "int32"}[acc]}
            if acc == 2:  # the int16 sum, two lanes to an int32 word
                assert [x["numel"] for x in payload] == [8, 8]
            assert [x for x in recs if x["tag"] == "scale"] == [
                {"op": "all_reduce_max", "dtype": "float32", "numel": n_leaves,
                 "bytes": 4 * n_leaves, "tag": "scale"}]
            assert total == ledger["wire_bytes_per_sync"] - 4
            assert wide == [] and len(ints) == n_leaves
            for k, v in got["snapshot"].items():
                assert torch.equal(v, group["toy"][mode][k])
        else:
            assert {x["dtype"] for x in payload} == {"float32"}
            assert total == sum(x["bytes"] for x in payload) == ledger["wire_bytes_per_sync"]
            assert total == ledger["raw_bytes_per_sync"] == 4 * n and ints == []
            for k, v in got["snapshot"].items():
                np.testing.assert_allclose(v.numpy(), group["toy"][mode][k].numpy(),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_round_matches_one_process(group, name):
    want = group["single"][name]
    for rank, r in enumerate(group["res"]):
        got = r["options"][name]
        np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(), rtol=1e-6)
        for g, w in zip(got["snapshot"], want["snapshot"]):
            if name == "int8-wire":
                assert torch.equal(g, w)
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
        for g, w in zip(got["params"], want["params"]):
            np.testing.assert_allclose(g.numpy(), w[2 * rank:2 * rank + 2].numpy(),
                                       rtol=1e-5, atol=1e-6)
        if name == "quarantine":
            assert got["mask"] == want["mask"] == [True, True, False, True]
            for g, w in zip(got["exp_avg"], want["exp_avg"]):
                assert torch.equal(g, w[2 * rank:2 * rank + 2])
        if name == "dynamics":
            for k, v in want["dynamics"].items():
                np.testing.assert_allclose(got["dynamics"][k].numpy(), v.numpy(), rtol=1e-5)
            assert got["dynamics"]["pg_norm"].shape == (W,)
        if name == "async":
            assert got["staleness"] == want["staleness"] == 1


def test_packed_int16_sum_is_exact_at_its_bound(group):
    """The int16 sum as two offset lanes in an int32 word: the exact sum of
    both ranks' parts at +-W*q_max (W = 258 on the int8 wire, the largest
    int16 case), in between, and at an odd length; 2 bytes an element
    (one pad lane at an odd length)."""
    want = {k: packed_parts(0)[k].long() + packed_parts(1)[k].long() for k in packed_parts(0)}
    for r in group["res"]:
        for k, v in want.items():
            assert torch.equal(r["packed"]["out"][k].long(), v), k
        assert [x["dtype"] for x in r["packed"]["records"]] == ["int32"] * 4
        assert [x["bytes"] for x in r["packed"]["records"]] == [16, 12, 20, 12]
    assert int(want["max"][0]) == PACKED_W * PACKED_Q <= 32767


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
