"""MoE through the port's model and training (nanodiloco_tpu_torch:
models/llama.py, parallel/diloco.py, training/train_loop.py, the
checkpoint and the CLI) against the JAX package, on the CPU in float32
at a tiny size (2 layers, hidden 32, 4 experts), from one numpy tree.

Tolerances, as in tests/test_torch_model.py and tests/test_torch_diloco.py:
the forward and loss within 1e-5, gradients 1e-4 relative with a 1e-6
floor; the DiLoCo losses 1e-5 and the snapshot 1e-4 relative plus 5e-5
absolute (AdamW turns float32 noise in a near-zero gradient into a
fraction of lr). The router probe's dropped fraction counts assignments,
so it is JAX's exactly; its entropy 1e-5. A resumed run repeats the same
float32 arithmetic: bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import causal_lm_loss as jax_loss
from nanodiloco_tpu.models import forward as jax_forward
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.models.moe import make_router_stats_fn as jax_stats_fn
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    causal_lm_loss,
    forward,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
)
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.parallel.streaming import fragment_bounds, fragment_slice
from nanodiloco_tpu_torch.training import train_loop
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=48,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16,
                  num_experts=4, num_experts_per_tok=2, router_aux_coef=0.1)
MODES = {
    "dense": dict(expert_capacity_factor=0.5),
    "ragged": dict(moe_dispatch="ragged"),
    "expert_choice": dict(router_type="experts_choose", expert_capacity_factor=0.5),
}
W, H, A, B, S = 2, 2, 2, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six test workers each using every core run
    5-10x slower, and CPU runs are bit-reproducible only on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mode_cfg(mode: str, **kw) -> LlamaConfig:
    return dataclasses.replace(CFG, **MODES[mode], **kw)


def numpy_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Random weights (std 0.1, the router 0.5, norms near 1) in the JAX
    layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda x: x.shape,
                          jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict())))

    def make(path, shape):
        name = jax.tree_util.keystr(path)
        base, std = (1.0, 0.1) if "norm" in name else (0.0, 0.5 if "router" in name else 0.1)
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes, is_leaf=lambda x: isinstance(x, tuple))


def batch(seed=1, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, :5] = 0
    return tokens, mask


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_and_loss_match_jax(mode, impl):
    """Logits, the loss with its router term, ``router_aux`` and every
    gradient; under flash the mask still keeps pads out of routing."""
    cfg = mode_cfg(mode, attention_impl=impl)
    jcfg = JaxConfig(**cfg.to_dict())
    tree = numpy_params(cfg)
    tokens, mask = batch()
    with jax.default_matmul_precision("highest"):
        jp = jax.tree.map(jnp.asarray, tree)
        jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
        j_logits, j_aux = jax_forward(jp, jt, jcfg, attn_mask=jm, with_aux=True)
        (j_loss, j_d), j_grads = jax.value_and_grad(
            lambda p: jax_loss(p, jt, jcfg, loss_mask=jm), has_aux=True)(jp)
    params = params_from_numpy(tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    t, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask).long()
    logits, aux = forward(params, t, cfg, attn_mask=m, with_aux=True)
    loss, d = causal_lm_loss(params, t, cfg, loss_mask=m)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(j_aux), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(d["router_aux"].detach()), float(j_d["router_aux"]),
                               rtol=1e-5, atol=1e-7)
    assert (float(d["router_aux"].detach()) == 0.0) == (mode == "expert_choice")
    grads = jax.tree.map(lambda p: p.grad.numpy(), params)
    for tg, jg in zip(jax.tree.leaves(grads), jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)


def test_init_params_and_tree_size_count_the_router():
    dl = Diloco(CFG, DilocoConfig(num_workers=1, inner_steps=1), device="cpu")
    state = dl.init_state(torch.Generator().manual_seed(0))
    leaves = tree_leaves(state.snapshot)
    assert dl._tree_size(None) == (sum(t.numel() for t in leaves), len(leaves))
    assert CFG.num_params() == sum(t.numel() for t in leaves)


def round_batches(rounds=2, seed=3):
    """[rounds, H, W, A, B, S] tokens and masks, left pads of random
    length. Tokens come from the first 64 of the vocabulary, as in
    tests/test_torch_diloco.py, whose snapshot tolerance holds for rows
    that see real gradients: an embedding row read only at a pad gets a
    near-zero gradient, where AdamW's m / sqrt(v) turns float32 noise into
    a visible fraction of lr."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (rounds, H, W, A, B, S)).astype(np.int32)
    pad = rng.integers(0, S // 2, (rounds, H, W, A, B, 1))
    return tokens, (np.arange(S) >= pad).astype(np.int32)


@pytest.mark.parametrize("mode", list(MODES))
def test_diloco_rounds_match_jax(mode):
    """W=2, H=2, grad_accum 2, two rounds, microbatches of different token
    counts: the router term enters each microbatch's gradient weighted by
    its token count, as JAX's token-weighted accumulation of the mean
    loss has it (router_aux_coef 0.1 makes a missing term visible)."""
    cfg = mode_cfg(mode)
    tree = numpy_params(cfg)
    tokens, mask = round_batches()
    common = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=4, lr=1e-2,
                  grad_accum=A)
    jdl = JaxDiloco(JaxConfig(**cfg.to_dict()),
                    JaxDilocoConfig(**common, dynamics_metrics=False),
                    build_mesh(MeshConfig(diloco=W)))
    with jax.default_matmul_precision("highest"):
        jstate = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        jlosses = []
        for r in range(2):
            jstate, losses, _ = jdl.round_step(jstate, tokens[r], mask[r])
            jlosses.append(np.asarray(losses))
        jsnap = jax.tree.map(np.asarray, jstate.snapshot)
    dl = Diloco(cfg, DilocoConfig(**common), device="cpu")
    state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
    tlosses = [dl.round_step(state, tokens[r], mask[r])[1].numpy() for r in range(2)]
    np.testing.assert_allclose(np.stack(tlosses), np.stack(jlosses), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.snapshot)), jax.tree.leaves(jsnap)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)


def run_config(tmp_path, model=CFG, **kw) -> TrainConfig:
    base = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
                warmup_steps=1, total_steps=4, inner_steps=2, lr=1e-3, num_workers=2,
                model=model, log_dir=str(tmp_path / "runs"), quiet=True)
    return TrainConfig(**{**base, **kw})


def records(tmp_path, summary) -> list[dict]:
    with open(tmp_path / "runs" / f"{summary['run_name']}.jsonl") as f:
        return [r for r in map(json.loads, f) if "loss" in r]


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_train_records_router_stats_on_synced_steps_equal_to_jax_probe(mode, tmp_path,
                                                                       monkeypatch):
    """The probe runs once per sync on the snapshot and one microbatch;
    its keys sit on the synced records only and equal JAX's
    ``make_router_stats_fn`` on the same snapshot and tokens."""
    cfg = mode_cfg(mode)
    seen = []
    real = train_loop.make_router_stats_fn

    def spy(model_cfg):
        fn = real(model_cfg)

        def probe(params, tokens):
            out = fn(params, tokens)
            # copies: a CPU tensor's numpy view would see later outer steps
            snap = jax.tree.map(np.copy, params_to_numpy(params))
            seen.append((snap, tokens.numpy().copy(), out))
            return out

        return probe

    monkeypatch.setattr(train_loop, "make_router_stats_fn", spy)
    summary = train(run_config(tmp_path, model=cfg), device="cpu")
    recs = records(tmp_path, summary)
    synced = [r for r in recs if r["outer_synced"]]
    assert len(seen) == len(synced) == 2
    assert not any("moe_dropped_frac" in r for r in recs if not r["outer_synced"])
    jfn = jax_stats_fn(JaxConfig(**cfg.to_dict()))
    for rec, (snap, tokens, out) in zip(synced, seen):
        assert tokens.shape == (2, 32)
        with jax.default_matmul_precision("highest"):
            want = jfn(jax.tree.map(jnp.asarray, snap), jnp.asarray(tokens))
        assert rec["moe_dropped_frac"] == out["moe_dropped_frac"]
        assert np.float32(out["moe_dropped_frac"]) == np.float32(want["moe_dropped_frac"])
        np.testing.assert_allclose(rec["moe_router_entropy"], float(want["moe_router_entropy"]),
                                   rtol=1e-5)
        assert (rec["moe_dropped_frac"] > 0) == (mode == "dense")
    # the last probe read the final snapshot
    for a, b in zip(jax.tree.leaves(seen[-1][0]),
                    jax.tree.leaves(params_to_numpy(summary["state"].snapshot))):
        np.testing.assert_array_equal(a, b)


def test_moe_checkpoint_resume_is_bit_exact_and_elastic(tmp_path):
    """Stop after one sync and resume to two: bit-identical to an
    uninterrupted run, the [W, L, E, d, f] leaves included; then resume
    the same checkpoint at another worker count (restore_elastic)."""
    cfg = mode_cfg("ragged")
    full = train(run_config(tmp_path / "a", model=cfg), device="cpu")
    ck = str(tmp_path / "ck")
    train(run_config(tmp_path / "b", model=cfg, total_steps=2, checkpoint_dir=ck),
          device="cpu")
    resumed = train(run_config(tmp_path / "c", model=cfg, checkpoint_dir=ck), device="cpu")
    assert resumed["rounds"] == 1
    np.testing.assert_allclose(resumed["losses"], full["losses"][2:], rtol=0, atol=0)
    for x, y in zip(tree_leaves(resumed["state"].params) + tree_leaves(resumed["state"].snapshot),
                    tree_leaves(full["state"].params) + tree_leaves(full["state"].snapshot)):
        assert torch.equal(x, y)
    assert resumed["state"].params["layers"]["w_gate"].shape == (2, 2, 4, 32, 48)
    wide = train(run_config(tmp_path / "d", model=cfg, num_workers=3, batch_size=6,
                            checkpoint_dir=ck, total_steps=6), device="cpu")
    assert wide["state"].params["layers"]["router"].shape == (3, 2, 32, 4)
    assert all(np.isfinite(wide["losses"]).all(axis=1))


def test_streaming_fragments_carry_the_moe_leaves():
    """Streaming DiLoCo fragments every stacked layer leaf by layer, the
    router and the [L, E, ...] experts included."""
    state = Diloco(CFG, DilocoConfig(num_workers=2, inner_steps=1), device="cpu").init_state(
        torch.Generator().manual_seed(0))
    bounds = fragment_bounds(CFG.num_hidden_layers, 2)
    parts = [fragment_slice(state.params, p, bounds, stacked=True) for p in range(2)]
    # the layer leaves (nine and the router) are split, the rest sit in one part
    assert sum(len(tree_leaves(p)) for p in parts) == len(tree_leaves(state.params)) + 10
    assert parts[1]["layers"]["w_down"].shape == (2, 1, 4, 48, 32)
    assert parts[0]["layers"]["router"].shape == (2, 1, 32, 4)


def test_cli_trains_the_moe_config_file(tmp_path):
    """``python -m nanodiloco_tpu_torch --llama-config-file
    configs/llama_moe.json`` on the CPU: the run finishes with the router
    stats on its synced records, and ``generate`` runs from its
    checkpoint."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    cmd = [sys.executable, "-m", "nanodiloco_tpu_torch", "--device", "cpu",
           "--llama-config-file", os.path.join(ROOT, "configs", "llama_moe.json"),
           "--num-workers", "2", "--batch-size", "2", "--per-device-batch-size", "1",
           "--seq-length", "32", "--inner-steps", "2", "--warmup-steps", "1",
           "--total-steps", "2", "--checkpoint-dir", str(tmp_path / "ck"),
           "--log-dir", str(tmp_path / "runs"), "--run-name", "moe", "--quiet"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "runs" / "moe.jsonl") as f:
        recs = [r for r in map(json.loads, f) if "loss" in r]
    assert [r["outer_synced"] for r in recs] == [0, 1]
    assert 0.0 <= recs[-1]["moe_dropped_frac"] < 1.0 and recs[-1]["moe_router_entropy"] > 0.0
    with open(tmp_path / "ck" / "model_config.json") as f:
        assert json.load(f)["model"]["num_experts"] == 8
    gen = subprocess.run(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "generate", "--checkpoint-dir",
         str(tmp_path / "ck"), "--device", "cpu", "--prompt", "Hello", "--max-new-tokens", "4",
         "--temperature", "0"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert gen.returncode == 0, gen.stderr[-3000:]
    assert gen.stdout.strip()
