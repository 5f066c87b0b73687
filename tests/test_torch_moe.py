"""The port's MoE MLP (nanodiloco_tpu_torch/models/moe.py) against the JAX
package's (nanodiloco_tpu/models/moe.py), on the CPU in float32: one
numpy tree of router and expert weights and one numpy batch of hidden
states go to both sides.

Tolerances. Both sides compute in float32 (JAX at matmul precision
"highest") and route identically, so they differ only in summation
order: the output, the aux term and the router entropy agree within
1e-5, the gradients within 1e-4 relative with a 1e-5 floor (the small
entries carry the most relative error). The dropped fraction counts
assignments, so it must be exactly JAX's float32 value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models.moe import expert_capacity as jax_capacity
from nanodiloco_tpu.models.moe import moe_mlp as jax_moe
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.moe import _top, expert_capacity, moe_mlp

D, F_, E = 16, 24, 4
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six test workers each using every core run
    5-10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(**kw) -> LlamaConfig:
    base = dict(hidden_size=D, intermediate_size=F_, num_attention_heads=2, num_experts=E,
                num_experts_per_tok=2)
    return LlamaConfig(**{**base, **kw})


def weights(seed=0, e=E, router_std=0.5) -> dict:
    rng = np.random.default_rng(seed)
    return {"router": (router_std * rng.standard_normal((D, e))).astype(np.float32),
            "w_gate": (0.2 * rng.standard_normal((e, D, F_))).astype(np.float32),
            "w_up": (0.2 * rng.standard_normal((e, D, F_))).astype(np.float32),
            "w_down": (0.2 * rng.standard_normal((e, F_, D))).astype(np.float32)}


def hidden(b=2, s=12, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def left_padded(b=2, s=12) -> np.ndarray:
    valid = np.ones((b, s), np.int32)
    valid[0, :4] = 0
    return valid


def jax_side(cfg, layer, h, valid):
    """(y, aux, stats, dlayer, dh) of sum(y^2) + aux through JAX."""
    jcfg = JaxConfig(**cfg.to_dict())
    v = None if valid is None else jnp.asarray(valid)

    def f(lay, hh):
        y, aux, stats = jax_moe(jcfg, hh, lay, valid=v, with_stats=True)
        return jnp.sum(y * y) + aux, (y, aux, stats)

    with jax.default_matmul_precision("highest"):
        (_, (y, aux, stats)), (dl, dh) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, layer), jnp.asarray(h))
    return (np.asarray(y), float(aux), np.asarray(stats),
            {k: np.asarray(x) for k, x in dl.items()}, np.asarray(dh))


def torch_side(cfg, layers, h, valid):
    """The port on W stacked workers: layers is a list of W numpy trees,
    h [W, B, S, d], valid [W, B, S] or None. Returns numpy (y, aux,
    stats, dlayer, dh) with the worker axis."""
    lay = {k: torch.tensor(np.stack([l[k] for l in layers])).requires_grad_(True)
           for k in layers[0]}
    hh = torch.tensor(h).requires_grad_(True)
    v = None if valid is None else torch.tensor(valid)
    y, aux, stats = moe_mlp(cfg, hh, lay, valid=v, with_stats=True)
    ((y * y).sum() + aux.sum()).backward()
    return (y.detach().numpy(), aux.detach().numpy(), stats.detach().numpy(),
            {k: x.grad.numpy() for k, x in lay.items()}, hh.grad.numpy())


def assert_matches(cfg, layer, h, valid):
    jy, jaux, jstats, jdl, jdh = jax_side(cfg, layer, h, valid)
    ty, taux, tstats, tdl, tdh = torch_side(cfg, [layer], h[None],
                                            None if valid is None else valid[None])
    np.testing.assert_allclose(ty[0], jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux[0], jaux, rtol=TOL, atol=TOL)
    assert np.float32(tstats[0, 0]) == np.float32(jstats[0])  # dropped: exact
    np.testing.assert_allclose(tstats[0, 1], jstats[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tdh[0], jdh, rtol=1e-4, atol=TOL)
    for k in layer:
        np.testing.assert_allclose(tdl[k][0], jdl[k], rtol=1e-4, atol=TOL, err_msg=k)
    return tstats[0]


MODES = {
    "dense_ample": dict(expert_capacity_factor=1.25),
    "dense_binding": dict(expert_capacity_factor=0.25),
    "ragged": dict(moe_dispatch="ragged", expert_capacity_factor=0.25),
    "expert_choice": dict(router_type="experts_choose", expert_capacity_factor=0.25),
    "top1": dict(num_experts_per_tok=1, expert_capacity_factor=0.5),
}


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_mlp_matches_jax(mode, padded):
    stats = assert_matches(config(**MODES[mode]), weights(), hidden(),
                           left_padded() if padded else None)
    if mode in ("dense_binding", "expert_choice"):
        assert stats[0] > 0.1  # the capacity binds: tokens drop
    if mode == "ragged":
        assert stats[0] == 0.0


@pytest.mark.parametrize("mode", ["dense_binding", "ragged", "expert_choice"])
def test_forced_ties_route_lower_index_first(mode):
    """Equal router logits: experts 1 and 2 share a router column, and the
    batch repeats a token row (equal affinities across tokens for
    expert-choice). ``_top`` must give JAX's lower-index-first order."""
    layer = weights()
    layer["router"][:, 2] = layer["router"][:, 1]
    h = hidden()
    h[:, 6:] = h[:, :6]
    assert_matches(config(**MODES[mode]), layer, h, None)
    # a zero router: every expert ties for every token
    layer["router"][:] = 0.0
    assert_matches(config(**MODES[mode]), layer, h, left_padded())


def test_top_orders_ties_by_lower_index():
    x = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = _top(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == [[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.mark.parametrize("mode", ["dense_binding", "ragged", "expert_choice"])
def test_padding_claims_no_capacity(mode):
    """Pads route nowhere: the real tokens' outputs are those of a call
    on the real tokens alone (whose capacity is sized from the same T),
    whatever the pads hold."""
    cfg = config(**MODES[mode])
    layer = {k: torch.tensor(v)[None] for k, v in weights().items()}
    h = torch.tensor(hidden(b=1))[None]
    valid = torch.ones(1, 1, 12, dtype=torch.int32)
    valid[..., 8:] = 0
    with torch.no_grad():
        y, _, stats = moe_mlp(cfg, h, layer, valid=valid, with_stats=True)
        noise = h.clone()
        noise[..., 8:, :] = 100.0 * torch.randn(4, D, generator=torch.Generator().manual_seed(3))
        y2, _, stats2 = moe_mlp(cfg, noise, layer, valid=valid, with_stats=True)
    np.testing.assert_array_equal(y[..., :8, :].numpy(), y2[..., :8, :].numpy())
    assert stats.tolist() == stats2.tolist()
    if mode != "ragged":
        # pads get no expert output at all
        assert float(y[..., 8:, :].abs().max()) == 0.0


def test_two_stacked_workers_equal_two_single_worker_jax_calls():
    """Routing, capacity, drops and the aux terms are per worker: W=2
    stacked at a binding capacity equals JAX run on each worker alone (T
    folded over W would drop other tokens)."""
    cfg = config(expert_capacity_factor=0.25)
    layers = [weights(0), weights(1)]
    h = np.stack([hidden(seed=1), hidden(seed=2)])
    valid = np.stack([left_padded(), np.ones((2, 12), np.int32)])
    ty, taux, tstats, tdl, tdh = torch_side(cfg, layers, h, valid)
    for w in range(2):
        jy, jaux, jstats, jdl, jdh = jax_side(cfg, layers[w], h[w], valid[w])
        np.testing.assert_allclose(ty[w], jy, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(taux[w], jaux, rtol=TOL, atol=TOL)
        assert np.float32(tstats[w, 0]) == np.float32(jstats[0])
        np.testing.assert_allclose(tdh[w], jdh, rtol=1e-4, atol=TOL)
        for k in jdl:
            np.testing.assert_allclose(tdl[k][w], jdl[k], rtol=1e-4, atol=TOL, err_msg=k)
    assert tstats[0, 0] != tstats[1, 0]


@pytest.mark.parametrize("mode", ["dense", "ragged", "experts_choose"])
def test_single_ample_expert_equals_dense_mlp(mode):
    kw = ({"moe_dispatch": "ragged"} if mode == "ragged"
          else {"router_type": "experts_choose"} if mode == "experts_choose" else {})
    cfg = config(num_experts=1, num_experts_per_tok=1, expert_capacity_factor=2.0, **kw)
    lay = {k: torch.tensor(v)[None] for k, v in weights(e=1).items()}
    h = torch.tensor(hidden())[None]
    y, aux = moe_mlp(cfg, h, lay)
    dense = F.silu(h @ lay["w_gate"][0, 0]) * (h @ lay["w_up"][0, 0]) @ lay["w_down"][0, 0]
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)
    assert float(aux[0]) == (0.0 if mode == "experts_choose" else 1.0)


@pytest.mark.parametrize("n, k, e, cf", [(24, 2, 4, 1.25), (24, 2, 4, 0.25), (7, 1, 8, 1.0),
                                         (8192, 2, 8, 1.25), (1, 2, 64, 1.25)])
def test_expert_capacity_matches_jax(n, k, e, cf):
    cfg = config(num_experts=e, num_experts_per_tok=k, expert_capacity_factor=cf)
    assert expert_capacity(cfg, n) == jax_capacity(JaxConfig(**cfg.to_dict()), n)


def test_sequence_parallel_routing_waits_for_item_7():
    cfg = config()
    lay = {k: torch.tensor(v)[None] for k, v in weights().items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe_mlp(cfg, torch.tensor(hidden())[None], lay, sp_axis="sp")


@pytest.mark.parametrize("mode", ["dense_ample", "ragged", "expert_choice"])
def test_no_one_hot_routing_tensor_is_built(mode):
    """No tensor of the forward or the backward is as large as a [T, E, C]
    one-hot (JAX's dispatch/combine; [T, k, E, C] is larger still): rows
    move by index."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.n = max(self.n, t.numel())
            return out

    cfg = config(**MODES[mode])
    t = 128
    cap = expert_capacity(config(), t)  # at the default capacity factor
    lay = {k: torch.tensor(v)[None].requires_grad_(True) for k, v in weights().items()}
    h = torch.tensor(hidden(b=2, s=t // 2))[None].requires_grad_(True)
    with Largest() as m:
        y, aux = moe_mlp(cfg, h, lay)
        ((y * y).sum() + aux.sum()).backward()
    assert m.n < t * E * cap // 4, (m.n, t * E * cap)
