"""Heterogeneous per-worker H and the straggler policy in the port
(nanodiloco_tpu_torch.parallel.diloco, training/optim.py::StackedAdamW,
training/elastic.py) against the JAX package's, on the CPU from
numpy-seeded inputs. Mirrors tests/test_elastic.py's hetero, policy,
sidecar and schedule-resume tests.

Tolerances: whole rounds against JAX, the classic path's (1e-5 on the
losses, 1e-4 relative + 5e-5 absolute on the snapshot,
tests/test_torch_diloco.py), over three rounds with budgets (1, 2), where
a per-worker count, lr or bias correction gone wrong would show from the
second round on; the per-worker step counts exactly. Within the port,
bit for bit: uniform budgets against classic, the async boundary against
the synchronous weighted step, StackedAdamW against W independent
``torch.optim.AdamW``s. The straggler policy and the schedule sidecar are
a copy of the JAX module, held to the same decisions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu.training import elastic as jax_elastic
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, params_to_numpy, tree_leaves
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training import elastic as port_elastic
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.optim import StackedAdamW
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train
from test_torch_diloco import CFG, numpy_params

SMALL = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                    max_position_embeddings=64, attention_impl="flash", loss_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; one
    torch thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dl_cfg(W, H, **kw):
    return dict(num_workers=W, inner_steps=H, warmup_steps=2, total_steps=30, lr=1e-2, **kw)


def tokens(rounds, W, H, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, CFG.vocab_size, (rounds, H, W, 1, 2, 16)).astype(np.int32)
    return tok, np.ones_like(tok)


def port(W, H, tree=None, **kw):
    dl = Diloco(CFG, DilocoConfig(**dl_cfg(W, H, **kw)), device="cpu")
    return dl, dl.init_state(params=params_from_numpy(tree or numpy_params(CFG), device="cpu"))


def test_stacked_adamw_is_w_independent_torch_adamws():
    """Per-worker lrs and an inactive worker: each slice follows its own
    ``torch.optim.AdamW`` (single-tensor) bit for bit, and the frozen
    worker's slice, moments and count stay."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 5, 4)).astype(np.float32)
    p = torch.tensor(x0)
    opt = StackedAdamW([p])
    refs = [torch.tensor(x0[w]) for w in range(3)]
    ref_opts = [torch.optim.AdamW([r], lr=0.0, weight_decay=0.01, foreach=False)
                for r in refs]
    lrs = [1e-2, 3e-3, 5e-2]
    for step in range(6):
        g = rng.standard_normal((3, 5, 4)).astype(np.float32)
        active = [True, step < 2, True]
        p.grad = torch.tensor(g)
        opt.step(lrs, active)
        for w in range(3):
            if active[w]:
                refs[w].grad = torch.tensor(g[w])
                ref_opts[w].param_groups[0]["lr"] = lrs[w]
                ref_opts[w].step()
    for w in range(3):
        assert torch.equal(p[w], refs[w])
        st = ref_opts[w].state[refs[w]]
        assert torch.equal(opt.state[p]["exp_avg"][w], st["exp_avg"])
    assert opt.counts() == [6, 2, 6]


def test_hetero_uniform_budgets_match_classic_bitwise():
    """Equal budgets are classic DiLoCo bit for bit in the port: every
    worker makes the same per-slice AdamW update at the same count and lr,
    and equal weights give the merge the classic coefficients 1/W."""
    tok, mask = tokens(2, 2, 3)
    (cdl, cs), (hdl, hs) = port(2, 3), port(2, 3, inner_steps_per_worker=(3, 3))
    for r in range(2):
        _, lc, _ = cdl.round_step(cs, tok[r], mask[r])
        _, lh, _ = hdl.round_step(hs, tok[r], mask[r])
        assert torch.equal(lc, lh)
    for a, b in zip(tree_leaves(cs.params) + tree_leaves(cs.snapshot),
                    tree_leaves(hs.params) + tree_leaves(hs.snapshot)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def hetero_rounds():
    """Three rounds with budgets (1, 2), W=2, H=2, both sides."""
    W, H, R = 2, 2, 3
    tok, mask = tokens(R, W, H, seed=5)
    tree = numpy_params(CFG)
    kw = dl_cfg(W, H, inner_steps_per_worker=(1, 2))
    jdl = JaxDiloco(JaxConfig(**CFG.to_dict()), JaxDilocoConfig(**kw),
                    build_mesh(MeshConfig(diloco=W)))
    dl, state = port(W, H, tree, inner_steps_per_worker=(1, 2))
    jl, pl, jcounts, pcounts = [], [], [], []
    with jax.default_matmul_precision("highest"):
        js = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        for r in range(R):
            js, jloss, _ = jdl.round_step(js, tok[r], mask[r])
            state, ploss, _ = dl.round_step(state, tok[r], mask[r])
            jl.append(np.asarray(jloss))
            pl.append(ploss.numpy())
            jcounts.append(np.asarray(js.inner_opt_state[1][0].count).tolist())
            pcounts.append(state.inner_opt.counts())
    return (np.stack(pl), np.stack(jl), pcounts, jcounts, params_to_numpy(state.snapshot),
            jax.tree.map(np.asarray, js.snapshot))


def test_hetero_three_rounds_match_jax(hetero_rounds):
    pl, jl, pcounts, jcounts, snap, jsnap = hetero_rounds
    assert pcounts == jcounts == [[1, 2], [2, 4], [3, 6]]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(snap), jax.tree.leaves(jsnap)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)


def test_hetero_worker_freezes_past_budget():
    """Past its budget a worker's params, moments and step count stay
    until the sync; the other keeps updating."""
    dl, state = port(2, 3, inner_steps_per_worker=(3, 1))
    tok, mask = tokens(1, 2, 3)
    dl.inner_step(state, tok[0, 0], mask[0, 0])
    snap = lambda w: [t.detach()[w].clone() for t in tree_leaves(state.params)]  # noqa: E731
    moments = lambda: [st["exp_avg"][1].clone() for st in state.inner_opt.state.values()]  # noqa: E731
    w0, w1, m1 = snap(0), snap(1), moments()
    dl.inner_step(state, tok[0, 1], mask[0, 1])
    assert any(not torch.equal(a, b) for a, b in zip(w0, snap(0)))
    assert all(torch.equal(a, b) for a, b in zip(w1, snap(1)))
    assert all(torch.equal(a, b) for a, b in zip(m1, moments()))
    assert state.inner_opt.counts() == [2, 1]


def test_hetero_weighted_merge_is_realized_share():
    """Plain SGD outer (lr 1, no momentum): the new snapshot is snapshot -
    sum_w H_w (snapshot - p_w) / sum_w H_w on the pre-sync replicas."""
    budgets = (4, 1)
    dl, state = port(2, 4, inner_steps_per_worker=budgets, outer_momentum=0.0,
                     nesterov=False, outer_lr=1.0)
    tok, mask = tokens(1, 2, 4)
    dl.inner_round(state, tok[0], mask[0])
    # copies: the outer step writes the live tensors in place
    old = jax.tree.map(np.copy, params_to_numpy(state.snapshot))
    workers = jax.tree.map(np.copy, params_to_numpy(state.params))
    dl.outer_step(state)
    for s, p, new in zip(jax.tree.leaves(old), jax.tree.leaves(workers),
                         jax.tree.leaves(params_to_numpy(state.snapshot))):
        pg = sum(b * (s - p[w]) for w, b in enumerate(budgets)) / sum(budgets)
        np.testing.assert_allclose(new, s - pg, rtol=2e-5, atol=2e-6)


def test_hetero_budget_validation_and_retarget():
    dl, _ = port(2, 3, inner_steps_per_worker=(3, 3))
    with pytest.raises(ValueError, match="one entry per worker"):
        dl.set_inner_budget([1])
    with pytest.raises(ValueError, match="must be in"):
        dl.set_inner_budget([0, 3])
    dl.set_inner_budget([2, 3])
    assert dl.inner_budget == (2, 3)
    classic, _ = port(2, 3)
    assert classic.inner_budget is None
    with pytest.raises(RuntimeError, match="not enabled"):
        classic.set_inner_budget([3, 3])


def test_hetero_async_boundary_weights_merge():
    """Delay-0 async with unequal budgets is the synchronous weighted
    outer step, bit for bit."""
    tree = numpy_params(CFG)
    sdl, ss = port(2, 3, tree, inner_steps_per_worker=(3, 1))
    adl, sa = port(2, 3, tree, inner_steps_per_worker=(3, 1), async_outer=True, outer_delay=0)
    tok, mask = tokens(1, 2, 3)
    sdl.inner_round(ss, tok[0], mask[0])
    adl.inner_round(sa, tok[0], mask[0])
    sdl.outer_step(ss)
    adl.async_boundary(sa)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ss.snapshot),
                                                 tree_leaves(sa.snapshot)))


def test_async_deferred_boundary_weights_previous_rounds_budgets():
    """A retarget between rounds does not change the weights of the
    already-run round's deferred boundary: boundary-first rounds equal
    the stepwise order (boundary before the retarget) exactly."""
    tree = numpy_params(CFG)
    kw = dict(inner_steps_per_worker=(2, 1), async_outer=True, outer_delay=1)
    tok, mask = tokens(2, 2, 2, seed=9)
    sdl, ss = port(2, 2, tree, **kw)
    sdl.inner_round(ss, tok[0], mask[0])
    sdl.async_boundary(ss)
    sdl.set_inner_budget([2, 2])
    sdl.inner_round(ss, tok[1], mask[1])
    sdl.async_flush(ss)
    fdl, fs = port(2, 2, tree, **kw)
    fdl.inner_round_step(fs, tok[0], mask[0])
    fdl.set_inner_budget([2, 2])
    fdl.async_round_step(fs, tok[1], mask[1])
    fdl.async_flush(fs)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ss.snapshot),
                                                 tree_leaves(fs.snapshot)))


ELASTIC = {"port": port_elastic, "jax": jax_elastic}


@pytest.mark.parametrize("mod", sorted(ELASTIC))
def test_straggler_policy_demotes_and_restores(mod):
    p = ELASTIC[mod].StragglerPolicy(inner_steps=8, num_workers=4, factor=2.0)
    d = p.observe([1.0, 1.0, 4.0, 1.0])
    assert [x["elastic"] for x in d] == ["straggler_demote"]
    assert d[0]["worker"] == 2 and d[0]["h_from"] == 8 and d[0]["h_to"] == 2
    assert p.budgets == [8, 8, 2, 8] and p.demotions_total == 1
    d = p.observe([1.0, 1.0, 1.0, 1.0])  # still 4x slower per step
    assert d == [] and p.budgets == [8, 8, 2, 8]
    d = p.observe([1.0, 1.0, 0.25, 1.0])  # recovered
    assert [x["elastic"] for x in d] == ["straggler_restore"]
    assert d[0]["h_to"] == 8 and p.budgets == [8, 8, 8, 8] and p.restores_total == 1


@pytest.mark.parametrize("mod", sorted(ELASTIC))
def test_straggler_policy_leave_one_out_median_at_w2(mod):
    p = ELASTIC[mod].StragglerPolicy(inner_steps=4, num_workers=2, factor=2.0)
    d = p.observe([1.0, 3.0])
    assert [x["elastic"] for x in d] == ["straggler_demote"]
    assert d[0]["worker"] == 1 and d[0]["h_to"] == 1


@pytest.mark.parametrize("mod", sorted(ELASTIC))
def test_straggler_policy_floor_and_validation(mod):
    policy = ELASTIC[mod].StragglerPolicy
    with pytest.raises(ValueError, match="factor must be > 1"):
        policy(4, 2, 1.0)
    with pytest.raises(ValueError, match="min_steps"):
        policy(4, 2, 2.0, min_steps=5)
    assert policy(4, 2, 2.0, min_steps=2).observe([0.1, 100.0])[0]["h_to"] == 2
    assert policy(4, 1, 2.0).observe([5.0]) == []


@pytest.mark.parametrize("mod", sorted(ELASTIC))
def test_schedule_sidecar_roundtrip_and_width_reset(mod, tmp_path):
    m = ELASTIC[mod]
    d = str(tmp_path)
    m.save_schedule(d, step=12, num_workers=2, budgets=[3, 1], demotions_total=2)
    assert m.load_schedule(d)["inner_steps_per_worker"] == [3, 1]
    assert m.resume_budgets(d, 2, 3, [3, 3]) == ([3, 1], 2, False)
    assert m.resume_budgets(d, 4, 3, [3, 3, 3, 3]) == ([3, 3, 3, 3], 0, True)
    assert m.resume_budgets(str(tmp_path / "nope"), 2, 3, [3, 3]) == ([3, 3], 0, False)
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / m.SCHEDULE_FILE).write_text("{nope")
    assert m.resume_budgets(str(tmp_path / "torn"), 2, 3, [3, 3]) == ([3, 3], 0, False)


def small_run(tmp_path, **kw):
    base = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
                warmup_steps=2, total_steps=9, inner_steps=3, lr=1e-3, num_workers=2,
                model=SMALL, log_dir=str(tmp_path / "runs"), quiet=True, measure_comm=False)
    return TrainConfig(**{**base, **kw})


def read_lines(path):
    return [json.loads(line) for line in open(path)]


def test_hetero_schedule_resumes_at_same_width(tmp_path):
    """A demoted schedule survives a same-width restart through the
    sidecar; a width change resets it with an h_schedule_reset record."""
    ck = str(tmp_path / "ckpt")
    train(small_run(tmp_path / "a", total_steps=3, checkpoint_dir=ck,
                    inner_steps_per_worker=(3, 2), run_name="first"), device="cpu")
    port_elastic.save_schedule(ck, step=3, num_workers=2, budgets=[3, 1], demotions_total=1)
    summary = train(small_run(tmp_path / "b", total_steps=6, checkpoint_dir=ck,
                              inner_steps_per_worker=(3, 2), run_name="second"), device="cpu")
    assert summary["inner_steps_per_worker"] == [3, 1]
    syncs = [r for r in read_lines(tmp_path / "b" / "runs" / "second.jsonl")
             if r.get("outer_synced")]
    assert tuple(syncs[0]["inner_steps_realized"]) == (3, 1)
    summary = train(small_run(tmp_path / "c", num_workers=4, total_steps=9, checkpoint_dir=ck,
                              straggler_factor=2.0, run_name="wide"), device="cpu")
    assert summary["inner_steps_per_worker"] == [3, 3, 3, 3]
    assert summary["straggler_demotions"] == 0
    lines = read_lines(tmp_path / "c" / "runs" / "wide.jsonl")
    assert [r for r in lines if r.get("elastic") == "h_schedule_reset"]


def test_checkpoint_with_scalar_steps_restores_per_worker(tmp_path):
    """A checkpoint from before the per-worker counts holds one scalar
    ``step`` per leaf: it restores with every worker at that count, and
    the resumed round equals the one from the [W]-count checkpoint."""
    dl, state = port(2, 2)
    tok, mask = tokens(2, 2, 2, seed=4)
    dl.round_step(state, tok[0], mask[0])
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(2, state)
    tree = torch.load(ck.path(2), weights_only=True)
    for st in tree["inner_opt_state"].values():
        assert st["step"].tolist() == [2.0, 2.0]
        st["step"] = torch.tensor(2.0)
    old = CheckpointManager(str(tmp_path / "old"))
    torch.save(tree, old.path(2))
    resumed = []
    for mgr in (ck, old):
        fresh_dl, fresh = port(2, 2)
        mgr.restore(fresh)
        assert all(st["step"].tolist() == [2.0, 2.0] for st in fresh.inner_opt.state.values())
        fresh_dl.round_step(fresh, tok[1], mask[1])
        resumed.append(tree_leaves(fresh.params) + tree_leaves(fresh.snapshot))
    assert all(torch.equal(a, b) for a, b in zip(*resumed))
