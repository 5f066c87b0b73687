"""The port's Llama model (nanodiloco_tpu_torch.models) against the JAX
package's, on the CPU in float32: one numpy parameter tree and one numpy
token batch go to both sides.

Tolerances: both sides compute in float32 (JAX under "highest" matmul
precision); they differ only in summation order and in libm (rsqrt, exp,
pow in the RoPE table), about 1e-6 relative per op. Through two layers and
the loss that stays below 1e-5 on logits and loss and 1e-4 relative on
gradients (whose small entries carry the most relative error, hence the
absolute floor of 1e-6 at parameter-gradient scale ~1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import causal_lm_loss as jax_loss
from nanodiloco_tpu.models import forward as jax_forward
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu_torch.models.config import LLAMA3_8B, LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    causal_lm_loss,
    forward,
    init_params,
    params_from_numpy,
    params_to_numpy,
)

BASE = dict(
    vocab_size=96, hidden_size=32, intermediate_size=64, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, max_position_embeddings=64,
)


def numpy_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Random weights (std 0.1, norms near 1) in the JAX layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda x: x.shape, jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict())))

    def make(path, shape):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes, is_leaf=lambda x: isinstance(x, tuple))


def batch(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, :5] = 0  # a left-padded row
    return tokens, mask


def jax_side(cfg, tree, tokens, mask):
    jcfg = JaxConfig(**cfg.to_dict())
    params = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        logits = jax_forward(params, tokens, jcfg, attn_mask=mask)
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jax_loss(p, tokens, jcfg, loss_mask=mask), has_aux=True
        )(params)
    return np.asarray(logits), float(loss), aux, jax.tree.map(np.asarray, grads)


def torch_side(cfg, tree, tokens, mask):
    params = params_from_numpy(tree, device="cpu")
    for p in jax.tree.leaves(params):
        p.requires_grad_(True)
    t, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask).long()
    logits = forward(params, t, cfg, attn_mask=m)
    loss, aux = causal_lm_loss(params, t, cfg, loss_mask=m)
    loss.backward()
    grads = jax.tree.map(lambda p: p.grad.numpy(), params)
    aux = {k: float(v.detach()) for k, v in aux.items()}
    return logits.detach().numpy(), float(loss.detach()), aux, grads


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_logits_loss_grads_match_jax(impl, tie, loss_chunk):
    cfg = LlamaConfig(**BASE, attention_impl=impl, tie_word_embeddings=tie,
                      loss_chunk=loss_chunk)
    tree = numpy_params(cfg)
    tokens, mask = batch(cfg)
    j_logits, j_loss, j_aux, j_grads = jax_side(cfg, tree, tokens, mask)
    t_logits, t_loss, t_aux, t_grads = torch_side(cfg, tree, tokens, mask)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert float(t_aux["n_tokens"]) == float(j_aux["n_tokens"])
    np.testing.assert_allclose(float(t_aux["sum_loss"]), float(j_aux["sum_loss"]), rtol=1e-5)
    assert jax.tree.structure(t_grads) == jax.tree.structure(j_grads)
    for tg, jg in zip(jax.tree.leaves(t_grads), jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """Per-layer recompute (torch.utils.checkpoint; "dots" saves the
    matmul outputs and recomputes the rest, JAX's dots_saveable) changes
    memory, not math; the dots gradients also match JAX's under the same
    policy (the tolerance of test_logits_loss_grads_match_jax)."""
    cfg = LlamaConfig(**BASE, attention_impl="flash")
    tree = numpy_params(cfg)
    tokens, mask = batch(cfg)
    remat = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    _, loss_a, _, grads_a = torch_side(cfg, tree, tokens, mask)
    _, loss_b, _, grads_b = torch_side(remat, tree, tokens, mask)
    assert loss_a == loss_b
    for a, b in zip(jax.tree.leaves(grads_a), jax.tree.leaves(grads_b)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    if policy == "dots":
        _, _, _, j_grads = jax_side(remat, tree, tokens, mask)
        for tg, jg in zip(jax.tree.leaves(grads_b), jax.tree.leaves(j_grads)):
            np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)


def test_dots_policy_recomputes_no_matmul():
    """Under "dots" the backward recomputes the layer without its matmuls
    (their outputs were saved); under "nothing" it runs the layer's
    forward matmuls again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMatmuls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                        torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = LlamaConfig(**BASE, attention_impl="flash", loss_chunk=0)
    tree = numpy_params(cfg)
    tokens, mask = (torch.from_numpy(x).long() for x in batch(cfg))
    backward = {}
    for policy in ("none", "nothing", "dots"):
        c = cfg if policy == "none" else dataclasses.replace(cfg, remat=True,
                                                             remat_policy=policy)
        params = params_from_numpy(tree, device="cpu")
        for p in jax.tree.leaves(params):
            p.requires_grad_(True)
        loss, _ = causal_lm_loss(params, tokens, c, loss_mask=mask)
        with CountMatmuls() as counter:
            loss.backward()
        backward[policy] = counter.n
    # at least the seven projections of each layer again (on the CPU the
    # attention's plain version adds its own products)
    assert backward["nothing"] >= backward["none"] + 7 * cfg.num_hidden_layers
    assert backward["dots"] == backward["none"]


def test_worker_stacked_forward_equals_per_worker():
    """[W, B, S] tokens with [W, ...] params run every worker at once;
    each worker's slice equals its own unstacked forward and loss."""
    cfg = LlamaConfig(**BASE, attention_impl="flash", loss_chunk=16)
    trees = [numpy_params(cfg, seed=s) for s in (0, 1)]
    toks = [batch(cfg, seed=s) for s in (2, 3)]
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), *trees)
    p = params_from_numpy(stacked, device="cpu")
    t = torch.from_numpy(np.stack([x[0] for x in toks])).long()
    m = torch.from_numpy(np.stack([x[1] for x in toks])).long()
    logits = forward(p, t, cfg)
    loss, aux = causal_lm_loss(p, t, cfg, loss_mask=m)
    assert loss.shape == (2,) and aux["n_tokens"].shape == (2,)
    for w in range(2):
        pw = params_from_numpy(trees[w], device="cpu")
        tw, mw = t[w], m[w]
        torch.testing.assert_close(logits[w], forward(pw, tw, cfg), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(loss[w], causal_lm_loss(pw, tw, cfg, loss_mask=mw)[0],
                                   rtol=1e-6, atol=1e-6)


def test_params_numpy_round_trip():
    cfg = LlamaConfig(**BASE)
    tree = numpy_params(cfg)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("tie", [False, True])
def test_init_params_layout_matches_jax(tie):
    cfg = LlamaConfig(**BASE, tie_word_embeddings=tie)
    gen = torch.Generator().manual_seed(0)
    ours = params_to_numpy(init_params(gen, cfg, device="cpu"))
    ref = jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict()))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert sum(a.size for a in jax.tree.leaves(ours)) == cfg.num_params()
    assert abs(float(np.std(ours["layers"]["wq"])) - cfg.initializer_range) < 2e-3


def test_fully_masked_rows_no_nan():
    """A left-padded row (query 0 sees no valid key) keeps the loss and
    every gradient finite, as in the JAX package's dense path."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_attention_heads=4, num_hidden_layers=2)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for p in jax.tree.leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 16, dtype=torch.long)
    mask[0, :8] = 0
    loss, _ = causal_lm_loss(params, tokens, cfg, loss_mask=mask)
    assert torch.isfinite(loss)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in jax.tree.leaves(params))


def test_llama3_8b_config_loads_unchanged():
    cfg = LlamaConfig.from_json("configs/llama3_8b.json")
    ref = JaxConfig.from_json("configs/llama3_8b.json")
    assert cfg.to_dict() == ref.to_dict()
    assert LLAMA3_8B.to_dict() == __import__(
        "nanodiloco_tpu.models.config", fromlist=["LLAMA3_8B"]
    ).LLAMA3_8B.to_dict()
    assert cfg.num_params() == ref.num_params()


def test_entry_points_raise_without_a_card():
    """The default device is CUDA; with no card the entry points raise
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator(), LlamaConfig(**BASE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"x": np.zeros(2, np.float32)})


@pytest.mark.parametrize(
    "change, error",
    [({"attention_impl": "ring"}, NotImplementedError)],
)
def test_paths_not_ported_raise(change, error):
    cfg = LlamaConfig(**{**BASE, **change})
    with pytest.raises(error, match="not ported"):
        init_params(torch.Generator(), cfg, device="cpu")


@pytest.mark.parametrize("moe", [dict(num_experts=4), dict(num_experts=8, moe_dispatch="ragged"),
                                 dict(num_experts=4, router_type="experts_choose")])
def test_init_params_builds_the_jax_moe_shapes(moe):
    """An MoE config gets the JAX tree: the router [L, d, E] and the
    expert FFN stacked [L, E, d, f] / [L, E, f, d], in param_dtype."""
    cfg = LlamaConfig(**{**BASE, **moe})
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                        jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict())))
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")),
                       init_params(torch.Generator(), cfg, device="cpu"))
    assert got == want
    assert got["layers"]["router"][0] == (2, 32, moe["num_experts"])
