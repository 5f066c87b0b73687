"""The port's checkpoint and resume (nanodiloco_tpu_torch.training.checkpoint
and train()'s resume) on the CPU at a tiny size; the elastic restore
against the JAX package's ``restore_elastic`` on one numpy state.

Tolerance: none. A checkpoint stores the live tensors and a restore
copies them back, so every leaf, AdamW's moments and per-worker step
counts and the outer momentum return bit for bit, and a resumed run repeats the same
float32 arithmetic on the same numbers as an uninterrupted one
(``rtol=0, atol=0``). The elastic restore copies the same numbers on
both sides, so the port and JAX agree exactly too.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, tree_leaves
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training import checkpoint as ckpt_mod
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager, named_leaves
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16)
H, A, B, S = 2, 2, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; torch's
    default of one intra-op thread per core in each would oversubscribe
    the cores. One thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_config(tmp_path, **kw) -> TrainConfig:
    base = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
                warmup_steps=2, total_steps=6, inner_steps=3, lr=1e-3, num_workers=2,
                model=CFG, log_dir=str(tmp_path / "runs"), quiet=True)
    return TrainConfig(**{**base, **kw})


def trained_state(num_workers=2, seed=0):
    """A port state after one round (inner moments, step counts and outer
    momentum all set)."""
    dl = Diloco(CFG, DilocoConfig(num_workers=num_workers, inner_steps=H, warmup_steps=1,
                                  total_steps=8, lr=1e-2, grad_accum=A), device="cpu")
    state = dl.init_state(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (H, num_workers, A, B, S)).astype(np.int32)
    dl.round_step(state, toks, np.ones_like(toks))
    return dl, state


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.snapshot),
                    tree_leaves(b.params) + tree_leaves(b.snapshot)):
        assert torch.equal(x, y)
    for pa, pb in zip(tree_leaves(a.params), tree_leaves(b.params)):
        sa, sb = a.inner_opt.state[pa], b.inner_opt.state[pb]
        assert sa.keys() == sb.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for ma, mb in zip(tree_leaves(a.outer_opt_state), tree_leaves(b.outer_opt_state)):
        assert torch.equal(ma, mb)
    assert a.inner_step_count == b.inner_step_count


def test_save_restore_round_trip_is_bit_exact(tmp_path):
    dl, state = trained_state()
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(state.inner_step_count, state)
    assert ck.latest_step == H and ck.saved_worker_count() == 2
    fresh = dl.init_state(torch.Generator().manual_seed(99))
    assert not torch.equal(tree_leaves(fresh.params)[0], tree_leaves(state.params)[0])
    ck.restore(fresh)
    assert_states_equal(fresh, state)
    # the file holds one named tree with the JAX DilocoState's field names
    tree = torch.load(ck.path(H), weights_only=True)
    assert set(tree) == {"params", "inner_opt_state", "snapshot", "outer_opt_state",
                         "inner_step_count"}
    names = [n for n, _ in named_leaves(state.params)]
    assert list(tree["inner_opt_state"]) == names and list(tree["outer_opt_state"]) == names
    assert "layers/wq" in names


def test_save_writes_no_crc_and_load_never_checked_one(tmp_path):
    """A save skips the zip records' CRC-32 (about half of a save's time),
    and restores bit-exactly without it; torch.load does not verify the
    CRC of a file that has one either: a flipped data byte loads
    silently, so the CRC guarded no restore."""
    dl, state = trained_state()
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(state.inner_step_count, state)
    with zipfile.ZipFile(ck.path(H)) as z:
        data = [i for i in z.infolist() if "/data/" in i.filename]
    assert data and all(i.CRC == 0 for i in data)
    fresh = dl.init_state(torch.Generator().manual_seed(99))
    ck.restore(fresh)
    assert_states_equal(fresh, state)

    x = torch.arange(256, dtype=torch.float32)
    path = tmp_path / "crc.pt"
    torch.save({"x": x}, path)
    raw = bytearray(path.read_bytes())
    at = raw.find(x[200].numpy().tobytes())
    raw[at] ^= 1
    path.write_bytes(bytes(raw))
    for mmap in (False, True):
        got = torch.load(path, weights_only=True, mmap=mmap)["x"]
        assert not torch.equal(got, x) and torch.equal(got[:200], x[:200])


def test_restore_rejects_another_model(tmp_path):
    _, state = trained_state()
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(H, state)
    other = Diloco(LlamaConfig(**{**CFG.to_dict(), "hidden_size": 64}),
                   DilocoConfig(num_workers=2, inner_steps=H), device="cpu")
    with pytest.raises(ValueError, match="different model"):
        ck.restore(other.init_state(torch.Generator().manual_seed(0)))


def test_resume_6_equals_3_plus_3(tmp_path):
    """Stop at step 3 (one sync), resume to 6, and land bit-identical to
    an uninterrupted run (the JAX package's tests/test_train_loop.py
    ``test_checkpoint_resume_exact``)."""
    full = train(run_config(tmp_path / "a"), device="cpu")
    train(run_config(tmp_path / "b", total_steps=3,
                     checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    resumed = train(run_config(tmp_path / "c", checkpoint_dir=str(tmp_path / "ck")),
                    device="cpu")
    assert resumed["rounds"] == 1
    np.testing.assert_allclose(resumed["losses"], full["losses"][3:], rtol=0, atol=0)
    assert_states_equal(resumed["state"], full["state"])
    recs = [json.loads(line) for line in open(tmp_path / "c" / "runs" /
                                               f"{resumed['run_name']}.jsonl")]
    assert recs[0]["resume"] == 3 and recs[0]["elastic"] is False


def test_crash_between_write_and_rename_keeps_previous_step(tmp_path, monkeypatch):
    _, state = trained_state()
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(2, state)

    class Killed(BaseException):
        """Stands for the process dying: no retry may catch it."""

    def killed(*args):
        raise Killed

    monkeypatch.setattr(ckpt_mod.os, "replace", killed)
    with pytest.raises(Killed):
        ck.save(4, state)
    monkeypatch.undo()
    assert os.path.exists(tmp_path / "ck" / "step_4.tmp")
    assert ck.latest_step == 2
    assert CheckpointManager(str(tmp_path / "ck")).latest_step == 2
    ck.save(4, state)  # the next attempt overwrites the stale temporary
    assert ck.steps() == [2, 4] and not os.path.exists(tmp_path / "ck" / "step_4.tmp")


def test_max_to_keep(tmp_path):
    _, state = trained_state()
    ck = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for step in (2, 4, 6, 8, 10):
        ck.save(step, state)
    assert ck.steps() == [6, 8, 10]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_10.pt", "step_6.pt", "step_8.pt"]


def test_save_retries_a_transient_error_and_logs_it(tmp_path, monkeypatch):
    real_save, calls = torch.save, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("injected: storage blip")
        return real_save(*args, **kwargs)

    monkeypatch.setattr(torch, "save", flaky)
    summary = train(run_config(tmp_path, total_steps=3,
                               checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "runs" /
                                               f"{summary['run_name']}.jsonl")]
    retries = [r for r in recs if "retry" in r]
    assert len(retries) == 1 and retries[0]["retry"] == "ckpt_save"
    assert "injected" in retries[0]["error"]
    assert not any("alarm" in r for r in recs)
    assert CheckpointManager(str(tmp_path / "ck")).latest_step == 3


def jax_state_one_round(tree, tokens):
    jdl = JaxDiloco(JaxConfig(**CFG.to_dict()),
                    JaxDilocoConfig(num_workers=2, inner_steps=H, warmup_steps=1,
                                    total_steps=8, lr=1e-2, grad_accum=A,
                                    dynamics_metrics=False),
                    build_mesh(MeshConfig(diloco=2)))
    with jax.default_matmul_precision("highest"):
        state = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        state, _, _ = jdl.round_step(state, tokens, np.ones_like(tokens))
    return state


def leaf_map(tree) -> dict[str, np.ndarray]:
    """JAX pytree (dicts) -> {"layers/wq": array, ...}."""
    return {
        "/".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def port_state_from_jax(jstate):
    """A port W=2 state holding exactly the JAX state's numbers."""
    dl = Diloco(CFG, DilocoConfig(num_workers=2, inner_steps=H, warmup_steps=1,
                                  total_steps=8, lr=1e-2, grad_accum=A), device="cpu")
    state = dl.init_state(params=params_from_numpy(jax.tree.map(np.asarray, jstate.snapshot),
                                                   device="cpu"))
    adam = jstate.inner_opt_state[1][0]
    params, mu, nu = leaf_map(jstate.params), leaf_map(adam.mu), leaf_map(adam.nu)
    trace = leaf_map(jstate.outer_opt_state[0].trace)
    count = int(np.asarray(adam.count)[0])
    with torch.no_grad():
        for name, p in named_leaves(state.params):
            p.copy_(torch.from_numpy(params[name].copy()))
            state.inner_opt.state[p] = {
                "step": torch.full((2,), float(count)),
                "exp_avg": torch.from_numpy(mu[name].copy()),
                "exp_avg_sq": torch.from_numpy(nu[name].copy()),
            }
        for name, b in named_leaves(state.outer_opt_state):
            b.copy_(torch.from_numpy(trace[name].copy()))
    state.inner_step_count = int(jstate.inner_step_count)
    return state


def test_elastic_restore_2_to_4_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32),
        jax_init(jax.random.key(0), JaxConfig(**CFG.to_dict())),
    )
    tokens = rng.integers(0, CFG.vocab_size, (H, 2, A, B, S)).astype(np.int32)
    jstate = jax_state_one_round(tree, tokens)

    jck = JaxCheckpointManager(str(tmp_path / "jax"))
    jck.save(H, jstate)
    jdl4 = JaxDiloco(JaxConfig(**CFG.to_dict()),
                     JaxDilocoConfig(num_workers=4, inner_steps=H, warmup_steps=1,
                                     total_steps=8, lr=1e-2, grad_accum=A,
                                     dynamics_metrics=False),
                     build_mesh(MeshConfig(diloco=4)))
    jres = jck.restore_elastic(jdl4.init_state(jax.random.key(7)))
    jck.close()

    ck = CheckpointManager(str(tmp_path / "port"))
    ck.save(H, port_state_from_jax(jstate))
    assert ck.saved_worker_count() == 2
    dl4 = Diloco(CFG, DilocoConfig(num_workers=4, inner_steps=H, warmup_steps=1,
                                   total_steps=8, lr=1e-2, grad_accum=A), device="cpu")
    res = ck.restore_elastic(dl4.init_state(torch.Generator().manual_seed(7)))

    jsnap, jtrace = leaf_map(jres.snapshot), leaf_map(jres.outer_opt_state[0].trace)
    jparams, jadam = leaf_map(jres.params), jres.inner_opt_state[1][0]
    jmu, jnu = leaf_map(jadam.mu), leaf_map(jadam.nu)
    assert res.inner_step_count == int(jres.inner_step_count) == H
    assert (np.asarray(jadam.count) == H).all()
    momentum = dict(named_leaves(res.outer_opt_state))
    for name, s in named_leaves(res.snapshot):
        np.testing.assert_array_equal(s.numpy(), jsnap[name])
        np.testing.assert_array_equal(momentum[name].numpy(), jtrace[name])
    for name, p in named_leaves(res.params):
        assert p.shape[0] == 4
        np.testing.assert_array_equal(p.detach().numpy(), jparams[name])
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.broadcast_to(jsnap[name], p.shape))
        st = res.inner_opt.state[p]
        assert st["step"].tolist() == [H] * 4
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
        assert not jmu[name].any() and not jnu[name].any()
