"""The port's classic DiLoCo (nanodiloco_tpu_torch.parallel.diloco) and
optimizers against the JAX package's, on the CPU in float32, from one
numpy parameter tree and one numpy token stream.

Tolerances: both sides run the same float32 arithmetic in another
summation order (~1e-6 relative per op): 1e-5 on the losses. AdamW's
update m / sqrt(v) has magnitude ~lr whatever the gradient's size, so
for a parameter whose gradient is near zero that noise becomes a visible
fraction of lr: the snapshot after four steps at lr 1e-2 (and the outer
step's 0.7 x 1.9 Nesterov factor) is held to 1e-4 relative plus 5e-5
absolute, 0.5% of one inner update. Schedules and the single-tensor
optimizer recurrences differ only in float32 vs float64 scalar math: 1e-5,
and near the end of the cosine, where the lr nears 0, float32's cos
carries ~1e-7 of the base lr absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu.training import optim as jax_optim
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, params_to_numpy
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training.optim import (
    clip_per_worker_,
    inner_optimizer,
    outer_optimizer,
    warmup_cosine_schedule,
)

CFG = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=32, attention_impl="flash", loss_chunk=16)
W, H, A, B, S = 2, 2, 2, 2, 16


def numpy_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Random weights (std 0.1, norms near 1) in the JAX layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(
        lambda x: x.shape, jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict()))
    )

    def make(path, shape):
        base = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes, is_leaf=lambda x: isinstance(x, tuple))


def round_batches(rounds=2, seed=3):
    """[rounds, H, W, A, B, S] tokens and masks; masks left-pad a random
    number of positions so microbatches carry different token counts."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab_size, (rounds, H, W, A, B, S)).astype(np.int32)
    pad = rng.integers(0, S // 2, (rounds, H, W, A, B, 1))
    mask = (np.arange(S) >= pad).astype(np.int32)
    return tokens, mask


@pytest.mark.parametrize("clip_norm", [1.0, 0.05])
def test_two_rounds_match_jax(clip_norm):
    """W=2, H=2, accum=2, two rounds: per-step [W] losses and the final
    snapshot. ``clip_norm=0.05`` keeps the per-worker clip active on every
    step, where the two workers' norms differ."""
    tree = numpy_params(CFG)
    tokens, mask = round_batches()
    common = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=4,
                  lr=1e-2, grad_accum=A, clip_norm=clip_norm)

    jdl = JaxDiloco(JaxConfig(**CFG.to_dict()),
                    JaxDilocoConfig(**common, dynamics_metrics=False),
                    build_mesh(MeshConfig(diloco=W)))
    with jax.default_matmul_precision("highest"):
        jstate = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        jlosses = []
        for r in range(2):
            jstate, losses, _ = jdl.round_step(jstate, tokens[r], mask[r])
            jlosses.append(np.asarray(losses))
        jsnap = jax.tree.map(np.asarray, jstate.snapshot)

    dl = Diloco(CFG, DilocoConfig(**common), device="cpu")
    state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
    tlosses = []
    for r in range(2):
        state, losses = dl.round_step(state, tokens[r], mask[r])
        tlosses.append(losses.numpy())
    assert state.inner_step_count == 4

    np.testing.assert_allclose(np.stack(tlosses), np.stack(jlosses), rtol=1e-5)
    tsnap = params_to_numpy(state.snapshot)
    for a, b in zip(jax.tree.leaves(tsnap), jax.tree.leaves(jsnap)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)
    # every worker was reset to the snapshot
    for p, s in zip(jax.tree.leaves(params_to_numpy(state.params)), jax.tree.leaves(tsnap)):
        assert np.array_equal(p[0], s) and np.array_equal(p[1], s)


def test_per_worker_clip_matches_optax_under_vmap():
    """Each worker is clipped by its own global norm: worker 0 (norm ~5)
    is scaled to 1, worker 1 (norm ~0.5) is left alone."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((2, 3, 4)).astype(np.float32),
             rng.standard_normal((2, 5)).astype(np.float32)]
    norms = np.sqrt(sum((g.reshape(2, -1) ** 2).sum(1) for g in grads))
    target = np.array([5.0, 0.5])
    grads = [(g * (target / norms).reshape((-1,) + (1,) * (g.ndim - 1))).astype(np.float32)
             for g in grads]

    clip = optax.clip_by_global_norm(1.0)
    want = jax.vmap(lambda gs: clip.update(gs, clip.init(gs))[0])(
        [jnp.asarray(g) for g in grads]
    )
    got = [torch.from_numpy(g.copy()) for g in grads]
    pre = clip_per_worker_(got, 1.0)
    np.testing.assert_allclose(pre.numpy(), target, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    # one norm across the stacked workers would clip worker 1 as well
    shared = [torch.zeros(g.shape) for g in grads]
    for p, g in zip(shared, grads):
        p.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_(shared, 1.0)
    assert not np.allclose(shared[1].grad[1].numpy(), got[1][1].numpy())


def test_schedule_matches_jax():
    ours = warmup_cosine_schedule(4e-4, 10, 100)
    ref = jax_optim.warmup_cosine_schedule(4e-4, 10, 100)
    assert ours(0) == 0.0
    for step in range(110):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-7 * 4e-4)


def _optax_run(tx, x0, grads):
    params = jnp.asarray(x0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params)


@pytest.fixture
def problem():
    rng = np.random.default_rng(42)
    x0 = rng.standard_normal(16).astype(np.float32)
    grads = [rng.standard_normal(16).astype(np.float32) * (0.5 + i % 3) for i in range(12)]
    return x0, grads


def test_outer_nesterov_matches_jax(problem):
    x0, grads = problem
    p = torch.tensor(x0)
    opt = outer_optimizer([p], 0.7)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    want = _optax_run(jax_optim.outer_optimizer(0.7), x0, grads)
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-5, atol=1e-6)


def test_inner_clip_adamw_schedule_matches_jax(problem):
    """One worker: clip at 1.0 -> AdamW under warmup-cosine, as the
    Diloco inner step drives it."""
    x0, grads = problem
    p = torch.tensor(x0)[None].clone()
    opt = inner_optimizer([p])
    schedule = warmup_cosine_schedule(1e-2, 3, 12)
    for step, g in enumerate(grads):
        p.grad = torch.tensor(g)[None].clone()
        clip_per_worker_([p.grad], 1.0)
        opt.param_groups[0]["lr"] = schedule(step)
        opt.step()
    want = _optax_run(jax_optim.inner_optimizer(1e-2, 3, 12), x0, grads)
    np.testing.assert_allclose(p[0].numpy(), want, rtol=1e-5, atol=1e-6)


def test_inner_step_checks_batch_shape():
    dl = Diloco(CFG, DilocoConfig(num_workers=W, grad_accum=A), device="cpu")
    state = dl.init_state(params=params_from_numpy(numpy_params(CFG), device="cpu"))
    tokens, mask = round_batches(rounds=1)
    with pytest.raises(ValueError, match="worker axis"):
        dl.inner_step(state, tokens[0, 0, :1], mask[0, 0, :1])
    with pytest.raises(ValueError, match="accumulation axis"):
        dl.inner_step(state, tokens[0, 0, :, :1], mask[0, 0, :, :1])


@pytest.mark.parametrize(
    "option",
    [{"quarantine_nonfinite": True}, {"outer_comm_dtype": "bfloat16"},
     {"dynamics_metrics": True}, {"async_outer": True},
     {"inner_steps_per_worker": (1, 2)}, {"offload_snapshot": True}],
)
def test_options_not_ported_raise(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        DilocoConfig(num_workers=2, **option)
