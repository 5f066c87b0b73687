"""The port's async delayed-apply outer step
(nanodiloco_tpu_torch.parallel.diloco: ``async_boundary``,
``async_round_step``, ``async_flush``, ``async_drain``; train()'s async
loop and checkpoints) against the JAX package's, on the CPU from
numpy-seeded inputs. Mirrors tests/test_async_outer.py.

Tolerances: three boundary-first rounds at delay 1 against JAX, the
classic path's 1e-5 on losses and 1e-4 relative + 5e-5 absolute on the
snapshot (tests/test_torch_diloco.py), the dynamics of each boundary 1e-4
relative, the launch bookkeeping exactly. Within the port, bit for bit:
delay 0 against the synchronous outer step (stepwise boundaries and the
boundary-first packaging), boundary-first rounds against stepwise
boundaries at delay 1, train() at delay 0 against classic, and a resume
from a checkpoint with a launched merge in flight against the
uninterrupted run.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, params_to_numpy, tree_leaves
from nanodiloco_tpu_torch.parallel.diloco import AsyncDilocoState, Diloco, DilocoConfig
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.metrics import summarize_run
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train
from test_torch_diloco import CFG, numpy_params

W, H, K = 2, 2, 3
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


def rounds(seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, CFG.vocab_size, (K, H, W, 1, 2, 16)).astype(np.int32)
    return tok, np.ones_like(tok)


def dcfg(**kw):
    return dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=20, lr=1e-2, **kw)


def port(tree, **kw):
    dl = Diloco(CFG, DilocoConfig(**dcfg(**kw)), device="cpu")
    return dl, dl.init_state(params=params_from_numpy(tree, device="cpu"))


def leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_delay0_equals_classic_bitwise():
    """Delay 0 is the synchronous outer step exactly, through stepwise
    boundaries and through the boundary-first packaging (inner-only first
    round, boundary + round after, the flush at the end)."""
    tok, mask = rounds()
    tree = numpy_params(CFG)
    cdl, cs = port(tree)
    closs = [cdl.round_step(cs, tok[k], mask[k])[1] for k in range(K)]
    adl, sw = port(tree, async_outer=True, outer_delay=0)
    swloss = []
    for k in range(K):
        swloss.append(adl.inner_round(sw, tok[k], mask[k])[1])
        _, aux = adl.async_boundary(sw)
        assert aux["outer_staleness"] == 0
    assert torch.equal(torch.stack(closs), torch.stack(swloss))
    assert leaves_equal(cs.snapshot, sw.snapshot) and leaves_equal(cs.params, sw.params)
    _, fu = port(tree, async_outer=True, outer_delay=0)
    fuloss = [adl.inner_round_step(fu, tok[0], mask[0])[1]]
    fuloss += [adl.async_round_step(fu, tok[k], mask[k])[1] for k in range(1, K)]
    adl.async_flush(fu)
    assert torch.equal(torch.stack(closs), torch.stack(fuloss))
    assert leaves_equal(cs.snapshot, fu.snapshot) and leaves_equal(cs.params, fu.params)


@pytest.fixture(scope="module")
def delay1_runs():
    """K boundary-first rounds at delay 1 with the readout on: stepwise
    boundaries in the port, the packaging on both sides."""
    tok, mask = rounds(seed=2)
    tree = numpy_params(CFG)
    jdl = JaxDiloco(JaxConfig(**CFG.to_dict()),
                    JaxDilocoConfig(**dcfg(async_outer=True, outer_delay=1,
                                           dynamics_metrics=True)),
                    build_mesh(MeshConfig(diloco=W)))
    jloss, jaux = [], []
    with jax.default_matmul_precision("highest"):
        js = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        js, l0, _ = jdl.inner_round_step(js, tok[0], mask[0])
        jloss.append(np.asarray(l0))
        for k in range(1, K):
            js, lk, aux = jdl.async_round_step(js, tok[k], mask[k])
            jloss.append(np.asarray(lk))
            jaux.append(aux)
        js, aux = jdl.async_flush(js)
        jaux.append(aux)
    adl, sw = port(tree, async_outer=True, outer_delay=1, dynamics_metrics=True)
    marks = []
    for k in range(K):
        adl.inner_round(sw, tok[k], mask[k])
        _, aux = adl.async_flush(sw) if k == K - 1 else adl.async_boundary(sw)
        marks.append((aux["boundary_round"], aux["applied_launch_round"],
                      aux["outer_staleness"]))
    _, fu = port(tree, async_outer=True, outer_delay=1, dynamics_metrics=True)
    ploss, paux = [adl.inner_round_step(fu, tok[0], mask[0])[1]], []
    for k in range(1, K):
        _, lk, aux = adl.async_round_step(fu, tok[k], mask[k])
        ploss.append(lk)
        paux.append(aux)
    _, aux = adl.async_flush(fu)
    paux.append(aux)
    return dict(js=js, jloss=np.stack(jloss), jaux=jaux, sw=sw, marks=marks, fu=fu,
                ploss=torch.stack(ploss).numpy(), paux=paux, tree=tree, tok=tok, mask=mask)


def test_delay1_packaging_matches_stepwise_and_staleness(delay1_runs):
    r = delay1_runs
    # boundary 1 applies the init copy; every later apply is the merge
    # launched one round earlier
    assert r["marks"] == [(1, 0, 1), (2, 1, 1), (3, 2, 1)]
    assert [a["boundary_round"] for a in r["paux"]] == [1, 2, 3]
    assert leaves_equal(r["sw"].snapshot, r["fu"].snapshot)
    assert leaves_equal(r["sw"].params, r["fu"].params)
    assert isinstance(r["fu"], AsyncDilocoState) and r["fu"].launched_round == K
    assert r["fu"].pending_round == [0] and leaves_equal(r["fu"].pending[0], r["fu"].snapshot)
    # the delayed trajectory is not the synchronous one
    cdl, cs = port(r["tree"])
    for k in range(K):
        cdl.round_step(cs, r["tok"][k], r["mask"][k])
    assert not leaves_equal(cs.snapshot, r["fu"].snapshot)


def test_delay1_matches_jax(delay1_runs):
    r = delay1_runs
    np.testing.assert_allclose(r["ploss"], r["jloss"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(r["fu"].snapshot)),
                    jax.tree.leaves(jax.tree.map(np.asarray, r["js"].snapshot))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)
    for pa, ja in zip(r["paux"], r["jaux"]):
        for k in ("boundary_round", "applied_launch_round", "outer_staleness"):
            assert pa[k] == int(ja[k]), k
        for k, v in pa["dynamics"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ja["dynamics"][k]), rtol=1e-4,
                                       err_msg=k)
    assert int(r["js"].launched_round) == r["fu"].launched_round


def test_async_elastic_restore_preserves_pending(tmp_path):
    """restore_elastic into another worker count keeps the snapshot, the
    pending merge, the launch marks and the momentum exactly and rebuilds
    the workers from the snapshot."""
    tok, mask = rounds(seed=3)
    tree = numpy_params(CFG)
    dl, state = port(tree, async_outer=True, outer_delay=1)
    for k in range(2):
        dl.inner_round(state, tok[k], mask[k])
        dl.async_boundary(state)
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(2 * H, state)
    one = Diloco(CFG, DilocoConfig(**{**dcfg(async_outer=True, outer_delay=1),
                                      "num_workers": 1}), device="cpu")
    fresh = one.init_state(torch.Generator().manual_seed(7))
    assert ck.saved_worker_count() == 2
    restored = ck.restore_elastic(fresh)
    assert leaves_equal(restored.snapshot, state.snapshot)
    assert leaves_equal(restored.pending[0], state.pending[0])
    assert leaves_equal(restored.outer_opt_state, state.outer_opt_state)
    assert restored.launched_round == state.launched_round == 2
    assert restored.pending_round == state.pending_round == [2]
    for p, s in zip(tree_leaves(restored.params), tree_leaves(restored.snapshot)):
        assert p.shape[0] == 1 and torch.equal(p[0], s)
    assert restored.inner_opt.counts() == [2 * H]
    with pytest.raises(KeyError, match="pending"):
        ck.restore(port(tree)[1])  # an async checkpoint into a classic state


def small_run(tmp_path, **kw):
    base = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
                warmup_steps=2, total_steps=9, inner_steps=3, lr=1e-3, num_workers=2,
                model=SMALL, log_dir=str(tmp_path / "runs"), quiet=True)
    return TrainConfig(**{**base, **kw})


def read_lines(path):
    return [json.loads(line) for line in open(path)]


def test_train_async_delay0_matches_classic(tmp_path):
    a = train(small_run(tmp_path / "a", total_steps=6), device="cpu")
    b = train(small_run(tmp_path / "b", total_steps=6, async_outer=True, outer_delay=0),
              device="cpu")
    assert b["final_loss"] == a["final_loss"] and b["losses"] == a["losses"]
    assert leaves_equal(a["state"].params, b["state"].params)


@pytest.fixture(scope="module")
def async_run(tmp_path_factory):
    """A 3-round delay-1 run checkpointing every round (max_to_keep 3
    keeps steps 3, 6 and 9)."""
    d = tmp_path_factory.mktemp("async")
    summary = train(small_run(d, async_outer=True, outer_delay=1, run_name="async",
                              checkpoint_dir=str(d / "ck")), device="cpu")
    return d, summary


def test_train_async_jsonl_staleness_and_summary(async_run):
    d, summary = async_run
    assert summary["async_outer"] is True and summary["outer_delay"] == 1
    recs = read_lines(d / "runs" / "async.jsonl")
    stale = [r for r in recs if r.get("outer_staleness") is not None]
    # boundary 1 applies the warm-up init copy: no staleness at step 3
    assert sorted(r["step"] for r in stale) == [6, 9]
    assert all(r["outer_staleness"] == 1 for r in stale)
    assert len([r for r in recs if r.get("drift_max") is not None]) == 3
    syncs = [r for r in recs if r.get("outer_synced")]
    assert len(syncs) == 3 and all(r.get("async_outer") and r["outer_delay"] == 1
                                   for r in syncs)
    out = summarize_run(str(d / "runs" / "async.jsonl"))
    assert out["async_outer"] is True and out["outer_delay"] == 1
    assert out["outer_staleness_last"] == 1 and out["outer_staleness_max"] == 1
    assert "drift_max_last" in out


@pytest.mark.parametrize("resume_at", [3, 6], ids=["warmup-owed", "merge-in-flight"])
def test_async_resume_bit_exact_with_pending_merge(async_run, tmp_path, resume_at):
    """A checkpoint of a round that is not the last lands before the
    round's boundary (launched_round behind it): from step 3 the owed
    boundary applies an init copy, from step 6 the checkpoint holds a
    launched merge not yet applied. Both resumes equal the uninterrupted
    run bit for bit."""
    d, full = async_run
    ck = tmp_path / "ck"
    shutil.copytree(d / "ck", ck)
    for step in (6, 9):
        if step > resume_at:
            os.remove(ck / f"step_{step}.pt")
    saved = CheckpointManager(str(ck)).restore_raw()
    assert saved["launched_round"] == resume_at // 3 - 1
    resumed = train(small_run(tmp_path, async_outer=True, outer_delay=1,
                              checkpoint_dir=str(ck), run_name="resumed"), device="cpu")
    assert resumed["rounds"] == 3 - resume_at // 3
    assert resumed["losses"] == full["losses"][resume_at:]
    assert leaves_equal(resumed["state"].params, full["state"].params)
    assert leaves_equal(resumed["state"].snapshot, full["state"].snapshot)


def test_train_rejects_async_with_streaming(tmp_path):
    with pytest.raises(ValueError, match="classic-rounds-only"):
        train(small_run(tmp_path, async_outer=True, streaming_fragments=2), device="cpu")
