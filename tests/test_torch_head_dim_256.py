"""Head dims up to 256 (ROADMAP C3; above 256 in
``tests/test_torch_attention_tf32_fwd.py``) on the CPU, against the JAX
package: the dispatcher at hd 136, 192 (zero-padded to 256) and 256, one
DiLoCo round of a model at hd 256, the split rules of the tf32x3
backward at the hd-256 tiles (32-row streamed tiles, B3's columns in two
CTAs) and of the wgmma B3, and the routes at 256 and above.

On the CPU the port's dispatcher runs each kernel's plain version at the
padded width, the JAX dispatcher its scan path: the same float32 sums in
another order, so the output is held at (2e-5, 2e-5) and the gradients at
(1e-4, 1e-4), as ``test_head_dims_outside_the_six_match_jax`` holds the
padded head dims below 128. The training round is held at the
train-parity tolerances of ``tests/test_torch_diloco.py``: losses 1e-5
relative, the snapshot 1e-4 relative plus 5e-5 absolute, at lr 1e-3; at
lr 1e-2 each weight may also move twice as far as the JAX package's own
flash and dense attention move it apart (the tests' docstrings say why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, params_to_numpy
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test worker (the suite runs several),
    restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("hd, h, hkv, causal", [
    (136, 2, 2, True), (136, 4, 2, False),
    (192, 4, 2, True), (192, 2, 2, False),
    (256, 8, 1, True), (256, 8, 1, False),
    (256, 2, 2, True), (256, 2, 2, False),
])
def test_flash_attention_matches_jax(hd, h, hkv, causal):
    """Output and dQ, dK, dV of the port's dispatcher against the JAX
    dispatcher's at hd 136 and 192 (padded to 256 with the true head dim's
    scale) and at 256 (Gemma-2B's attention widths: 8 query heads on one
    KV head), MHA and GQA, causal and full, each with hd columns."""
    b, s = 1, 48
    q, k, v, ct = arrays((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd),
                         seed=hd + h)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_size=16, impl="scan")
        return jnp.sum(out * ct), out

    with jax.default_matmul_precision("highest"):
        (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_padded_head_dims_reach_the_kernels_at_256():
    """A head dim from 129 to 255 reaches the kernels at width 256 with the
    true head dim's scale (the tensors the dispatcher hands the autograd
    Function: [BH, S, 256]), and the output keeps the true head dim."""
    q = torch.from_numpy(arrays((1, 24, 2, 200), seed=5)[0])
    seen = []
    real = fa.FlashAttention.apply

    def spy(q, k, v, causal, scale):
        seen.append((q.shape, scale))
        return real(q, k, v, causal, scale)

    fa.FlashAttention.apply = spy
    try:
        out = flash_attention(q, q, q)
    finally:
        fa.FlashAttention.apply = real
    assert seen == [(torch.Size([2, 24, 256]), 200 ** -0.5)]
    assert out.shape == q.shape


CFG = LlamaConfig(vocab_size=64, hidden_size=512, intermediate_size=256,
                  num_attention_heads=2, num_key_value_heads=1, num_hidden_layers=2,
                  max_position_embeddings=32, attention_impl="flash", loss_chunk=16)
W, H, A, B, S = 2, 2, 1, 2, 16


def numpy_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Random weights (std 0.05, norms near 1) in the JAX layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(
        lambda x: x.shape, jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict()))
    )

    def make(path, shape):
        base = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes, is_leaf=lambda x: isinstance(x, tuple))


def one_round(lr: float, attention_impl: str = "flash", port: bool = True):
    """One DiLoCo round (W 2, H 2) of CFG from ``numpy_params`` at ``lr``:
    the JAX package's per-step [W] losses and snapshot leaves, and (with
    ``port``) the port's."""
    cfg = dataclasses.replace(CFG, attention_impl=attention_impl)
    tree = numpy_params(cfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (H, W, A, B, S)).astype(np.int32)
    mask = np.ones_like(tokens)
    common = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=4, lr=lr,
                  grad_accum=A)

    jdl = JaxDiloco(JaxConfig(**cfg.to_dict()),
                    JaxDilocoConfig(**common, dynamics_metrics=False),
                    build_mesh(MeshConfig(diloco=W)))
    with jax.default_matmul_precision("highest"):
        jstate = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        jstate, jlosses, _ = jdl.round_step(jstate, tokens, mask)
        want = (np.asarray(jlosses), jax.tree.leaves(jax.tree.map(np.asarray, jstate.snapshot)))
    if not port:
        return want, None
    dl = Diloco(cfg, DilocoConfig(**common), device="cpu")
    state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
    state, losses, _ = dl.round_step(state, tokens, mask)
    return want, (losses.numpy(), jax.tree.leaves(params_to_numpy(state.snapshot)))


def test_one_round_at_hd_256_matches_jax():
    """One DiLoCo round (W 2, H 2) of a 2-layer float32 model at hd 256
    (hidden 512 over 2 query heads and 1 KV head) with flash attention:
    the per-step [W] losses and the snapshot against the JAX package's.

    lr 1e-3, where every leaf is within 7.8e-6. At lr 1e-2 one of the
    2.4M weights, w_down[0, 97, 306], lands 8.1e-5 off: worker 0's first
    gradient there is -1.39e-7 in both packages (among the smallest 0.003%
    of w_down's, median 2.7e-3; 14x AdamW's eps; the two packages'
    gradients differ by up to 1.0e-7 over w_down), so AdamW's
    m / (sqrt(v) + eps) turns float32 summation order into up to lr of
    update. The JAX package moves the same weight 3.6e-5 between its own
    flash and dense attention (every other weight under 3.7e-6), the port
    2.6e-5. ``test_one_round_at_hd_256_at_lr_1e_2`` holds lr 1e-2 by that
    reading."""
    assert CFG.hidden_size // CFG.num_attention_heads == 256
    (jlosses, jsnap), (losses, snap) = one_round(1e-3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for a, b in zip(snap, jsnap):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)


def test_one_round_at_hd_256_at_lr_1e_2():
    """The round of ``test_one_round_at_hd_256_matches_jax`` at lr 1e-2,
    as ``tests/test_torch_diloco.py`` runs its rounds: losses at 1e-5
    relative; each snapshot weight within 1e-4 relative plus 5e-5
    absolute plus twice what the JAX package itself moves it between its
    flash and dense attention (the same sums in another order), the
    reading of the weights where AdamW amplifies summation order."""
    (jlosses, jsnap), (losses, snap) = one_round(1e-2)
    (_, jdense), _ = one_round(1e-2, attention_impl="dense", port=False)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for a, b, d in zip(snap, jsnap, jdense):
        bound = 5e-5 + 1e-4 * np.abs(b) + 2 * np.abs(b - d)
        assert np.all(np.abs(a - b) <= bound), np.abs(a - b).max()


# (B, H, Hkv, S, causal): chip_smoke.py's hd-256 shapes
@pytest.mark.parametrize("shape, dq_splits, dkv_splits", [
    ((4, 8, 1, 2048, True), 1, 2),     # train_hd256 (W 2 x b 2): 1024 and 256 CTAs
    ((1, 8, 1, 1024, True), 3, 9),     # gemma2b_f32_hd256: 128 and 32 CTAs
    ((1, 4, 2, 333, True), 11, 11),    # ragged_gqa2_bf16_hd256: 24 and 24 CTAs
    ((1, 2, 2, 77, False), 3, 3),      # noncausal_f32_hd256: 3 K tiles, 3 q tiles
])
def test_split_rule_at_hd_256(shape, dq_splits, dkv_splits):
    """At hd 256 B2 loops over 32-key tiles and B3 over 32-row q tiles,
    with two CTAs (column halves) per (KV head, 64-key tile): the fewest
    parts that give two waves of 132 CTAs, never more than the loop's
    steps."""
    b, h, hkv, s, causal = shape
    got = (fa.bwd_splits("flash_bwd_dq", b * h, b * hkv, s, s, causal, 256),
           fa.bwd_splits("flash_bwd_dkv", b * h, b * hkv, s, s, causal, 256))
    assert got == (dq_splits, dkv_splits)


# (B, H, Hkv, S, causal): chip_smoke.py's bf16 hd-256 shapes
@pytest.mark.parametrize("shape, dkv_splits", [
    ((4, 8, 1, 2048, True), 1),      # train_hd256: 256 CTAs, over one wave already
    ((2, 8, 1, 2048, True), 3),      # gemma2b_hd256: 128 CTAs, 256 pairs each
    ((1, 4, 2, 333, True), 11),      # ragged_gqa2_bf16_hd256: 24 CTAs, 12 pairs
    ((1, 4, 2, 130, False), 6),      # noncausal_gqa2_bf16_hd256: 12 CTAs, 6 pairs
])
def test_wgmma_split_rule_at_hd_256(shape, dkv_splits):
    """The wgmma B3 at bf16 hd 256 has two CTAs (column halves) per (KV
    head, 64-key tile), one an SM, looping over group x 64-row q tiles: it
    splits that loop only where the grid is under one wave of 132, into
    the fewest parts that give two, never more than the loop's steps. The
    wgmma B2 never splits, nor does any wgmma kernel below 256."""
    b, h, hkv, s, causal = shape
    args = (b * h, b * hkv, s, s, causal)
    assert fa.bwd_splits("flash_bwd_dkv", *args, 256, "wgmma") == dkv_splits
    assert fa.bwd_splits("flash_bwd_dq", *args, 256, "wgmma") == 1
    assert fa.bwd_splits("flash_bwd_dkv", *args, 128, "wgmma") == 1


def test_route_table_at_256():
    """hd 256 is a route of all three kernels in float32 and bf16. In bf16
    all three run the wgmma kernels (B1 the warp-specialised forward); in
    float32 all three run three-product TF32."""
    assert 256 in fa.HEAD_DIMS
    want = {torch.float32: ("tf32x3",) * 3, torch.bfloat16: ("wgmma",) * 3}
    for dtype, variants in want.items():
        assert tuple(fa.ROUTES[name, dtype, 256] for name in fa.KERNEL_NAMES) == variants


@pytest.mark.parametrize("hd", [512, 768, 1024])
def test_routes_above_256_are_tf32x3(hd):
    """Every multiple of 256 above 256 is taken, by rule (it is no row of
    ROUTES), and routed to three-product TF32 in both dtypes; the head dims
    between are padded up to it."""
    assert fa.takes(hd) and not fa.takes(hd - 8)
    assert not any(key[2] == hd for key in fa.ROUTES)
    assert fa.width(hd - 248) == fa.width(hd) == hd
    for name in fa.KERNEL_NAMES:
        for dtype in (torch.float32, torch.bfloat16):
            assert fa.route(name, dtype, hd) == "tf32x3"


@pytest.mark.parametrize("drift", [None, (256, 64, 2), (256, 32, 1), (128, 32, 1)])
def test_split_rule_tables_are_held_against_the_library(drift):
    """``_tf32_lib`` holds stream_rows and col_parts against each library's
    ``nd_tf32_geometry`` (the kernels' Layout) for every kernel at every
    (dtype, head dim) the tf32x3 kernels serve, two wide head dims
    included: a library that agrees loads, one whose tiles drifted at one
    head dim raises naming it."""
    asked = []

    def geometry(kernel, dtype, hd, rows, parts):
        asked.append((kernel, dtype, hd))
        want = (fa.stream_rows(hd), fa.col_parts(fa.KERNEL_NAMES[kernel], hd))
        rows._obj.value, parts._obj.value = drift[1:] if drift and drift[0] == hd else want
        return 0

    if drift is None:
        fa._check_geometry(geometry)
        f32 = {(0, hd) for hd in (*fa.HEAD_DIMS, 512, 768)}
        bf16 = {(1, 16), (1, 512), (1, 768)}
        assert sorted(asked) == sorted({(kernel, *row) for kernel in range(3)
                                        for row in f32 | bf16})
    else:
        with pytest.raises(RuntimeError, match=f"hd {drift[0]}"):
            fa._check_geometry(geometry)
