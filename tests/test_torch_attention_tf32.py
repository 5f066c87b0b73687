"""The float32 backward kernels' numerics (B2 dQ, B3 dK/dV on the tensor
cores as three-product TF32, ``csrc/flash_attention_tf32_{dq,dkv}.cu``), modelled
in float32 on the CPU, against the plain versions and against the JAX
package's gradients; and the rule that splits the kernels' loops.

The model: each operand x splits into hi = tf32(x) and lo = tf32(x - hi),
TF32 rounding as ``cvt.rna.tf32.f32`` does it (to nearest, ties away from
zero, at the 13 dropped mantissa bits, here on the int32 view), and every
product adds lo·hi, hi·lo and hi·hi 8 terms of the reduction at a time,
in the kernels' order (mma.sync m16n8k8). P and dS are split where the
kernels split them, as the left operand of the second products. From hd
256 B3's CTAs each own 128 of dK's and dV's columns, and above 256 B2's
256 of dQ's (``fa.col_parts``), and the model takes the columns in the
same parts. Above 256 each part sums its first products over slices of
256 columns, starting after the slice that holds its own columns
(``slice_order``), as the kernels load them. A one-product model (hi·hi
alone) shows why one TF32 product is not enough.

Run as a script, it prints the tolerance share (``atol_of_max``: the
largest |model - plain| past 1e-4 |plain|, over max|plain|) that the
three- and the one-product model need at the test shapes:

    JAX_PLATFORMS=cpu python -m tests.test_torch_attention_tf32
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa

# chip_smoke.py's tolerance for the float32 kernels, tf32x3 included:
# |got - plain| <= ATOL * max|plain| + RTOL * |plain|
ATOL, RTOL = 1e-4, 1e-4


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
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add half the weight of the 13 dropped mantissa
    bits to the magnitude and clear them (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def mma(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """``a @ b`` (float32, ``[..., M, K] @ [..., K, N]``) as the kernels'
    mma.sync computes it: 8 of K at a time, lo·hi, then hi·lo, then hi·hi
    into one float32 accumulator (3 products), or hi·hi alone (1)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ah, bh = a_hi[..., k0:k0 + 8], b_hi[..., k0:k0 + 8, :]
        if products == 3:
            acc = acc + a_lo[..., k0:k0 + 8] @ bh
            acc = acc + ah @ b_lo[..., k0:k0 + 8, :]
        acc = acc + ah @ bh
    return acc


def slice_order(hd: int, c0: int) -> torch.Tensor:
    """The order of the head dim's columns in the first products of the
    part whose columns start at ``c0``: as they lie up to hd 256; above it
    slices of 256, from the one after the slice that holds column ``c0``
    round to that slice itself (the kernels leave its tiles in shared
    memory for the second products)."""
    if hd <= 256:
        return torch.arange(hd)
    n, last = hd // 256, c0 // 256
    return torch.cat([torch.arange(256) + 256 * ((last + j) % n) for j in range(1, n + 1)])


def tf32_probs(q, k, v, do, lse, delta, causal, products, order=None):
    """(folded Q, folded dO, P, dS) as the kernels compute them: GQA folded
    into the row axis ([Bkv, G*Sq, hd], row g * Sq + position, as the plain
    versions fold it), S = Q K^T and dP = dO V^T by ``mma`` over the head
    dim's columns in ``order`` (``slice_order``), P and dS in float32."""
    bkv = k.shape[0]
    qf, qpos = fa._folded(q, bkv)
    dof, _ = fa._folded(do, bkv)
    order = torch.arange(q.shape[-1]) if order is None else order
    s = mma(qf[..., order], k[..., order].transpose(1, 2), products) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(torch.arange(k.shape[1])[None, :] > qpos[:, None], -math.inf)
    lse_f, delta_f = lse.reshape(bkv, -1, 1), delta.reshape(bkv, -1, 1)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse_f), torch.zeros_like(s))
    ds = p * (mma(dof[..., order], v[..., order].transpose(1, 2), products) - delta_f)
    return qf, dof, p, ds


def column_parts(name: str, hd: int) -> list[int]:
    """The first column of each part of ``name``'s output columns."""
    return list(range(0, hd, hd // fa.col_parts(name, hd)))


def tf32_dq(q, k, v, do, lse, delta, causal, products=3):
    """B2: dQ = scale · dS K, one column part at a time."""
    hd = q.shape[-1]
    cols = hd // fa.col_parts("flash_bwd_dq", hd)
    parts = []
    for c in column_parts("flash_bwd_dq", hd):
        _, _, _, ds = tf32_probs(q, k, v, do, lse, delta, causal, products, slice_order(hd, c))
        parts.append(mma(ds, k[..., c:c + cols], products) / math.sqrt(hd))
    return torch.cat(parts, dim=-1).reshape(q.shape)


def tf32_dkv(q, k, v, do, lse, delta, causal, products=3):
    """B3: dV = P^T dO and dK = scale · dS^T Q over each KV head's query
    group (the reduction runs g-major over the folded rows, as the kernel
    walks its (group member, q tile) pairs), one column part at a time."""
    hd = q.shape[-1]
    cols = hd // fa.col_parts("flash_bwd_dkv", hd)
    parts = []
    for c in column_parts("flash_bwd_dkv", hd):
        qf, dof, p, ds = tf32_probs(q, k, v, do, lse, delta, causal, products,
                                    slice_order(hd, c))
        parts.append((mma(ds.transpose(1, 2), qf[..., c:c + cols], products) / math.sqrt(hd),
                      mma(p.transpose(1, 2), dof[..., c:c + cols], products)))
    return tuple(torch.cat(out, dim=-1) for out in zip(*parts))


def needed(got: torch.Tensor, want: torch.Tensor) -> float:
    """The ATOL share of max|want| that ``got`` needs at RTOL."""
    err = (got - want).abs() - RTOL * want.abs()
    return max(0.0, err.max().item()) / want.abs().max().item()


def backward_inputs(bh, group, s, hd, causal, seed):
    q, k, v, do = arrays((bh, s, hd), (bh // group, s, hd), (bh // group, s, hd), (bh, s, hd),
                         seed=seed)
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    return q, k, v, do, lse, (do * o).sum(-1, keepdim=True)


def errors(hd, group, causal, products, s=70):
    """{output: atol_of_max needed} of the ``products`` model against the
    plain versions at one test shape (BH 8, a ragged S)."""
    args = (*backward_inputs(8, group, s, hd, causal, seed=11), causal)
    got = {"dq": tf32_dq(*args, products), **dict(zip(("dk", "dv"), tf32_dkv(*args, products)))}
    want = {"dq": fa.flash_bwd_dq_plain(*args),
            **dict(zip(("dk", "dv"), fa.flash_bwd_dkv_plain(*args)))}
    return {name: needed(got[name], want[name]) for name in got}, got, want


def test_round_tf32_is_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero, for either sign;
    hi + lo is x to within 2^-22 of |x|."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4, -(one + ulp / 2),
                      one + ulp * 1.5, 0.0, -0.0, 3.0])
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), one + 2 * ulp, 0.0, -0.0, 3.0])
    assert torch.equal(round_tf32(x), want)
    y = arrays((1000,), seed=3)[0]
    hi, lo = split_tf32(y)
    assert torch.equal(round_tf32(hi), hi) and torch.equal(round_tf32(lo), lo)
    assert ((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all()
    assert ((hi - y).abs() > 2.0 ** -14 * y.abs()).any()  # one part alone is TF32's 2^-11


@pytest.mark.parametrize("hd", [768, 512, 256, 128, 64, 32, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_three_product_model_within_f32_tolerance(hd, causal, group):
    """The tf32x3 kernels' numerics hold chip_smoke.py's float32 tolerance
    (1e-4 of max|plain| + 1e-4 relative) against flash_bwd_dq_plain and
    flash_bwd_dkv_plain, MHA and GQA 4, causal and not, at a ragged S; and
    they are not the plain versions' bits, so the rounding is modelled."""
    need, got, want = errors(hd, group, causal, products=3)
    assert max(need.values()) <= ATOL, need
    for name in got:
        assert not torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("hd", [128, 32])
def test_one_product_misses_the_f32_tolerance(hd):
    """The reason for three products: hi·hi alone (one-pass TF32) needs more
    than the float32 tolerance on the same inputs."""
    need, _, _ = errors(hd, 4, True, products=1)
    assert max(need.values()) > ATOL, need


@pytest.mark.parametrize("hd", [512, 256, 128, 64, 32, 16])
@pytest.mark.parametrize("group, causal", [(2, True), (1, False)])
def test_three_product_model_matches_jax_gradients(hd, group, causal):
    """dQ, dK and dV of the tf32x3 model against jax.grad through the JAX
    dispatcher's scan path on the same float32 inputs, at the float32
    gradient tolerance of test_gradients_match_pallas (1e-4, 1e-4)."""
    b, s, h = 1, 64, 4
    hkv = h // group
    q, k, v, do = (x.numpy() for x in arrays((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                                             (b, s, h, hd), seed=12))

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_size=16, impl="scan")
        return jnp.sum(out * do)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    def flat(x):  # [1, S, heads, hd] -> [heads, S, hd]
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[0].transpose(1, 0, 2)))

    qf, kf, vf, dof = map(flat, (q, k, v, do))
    o, lse = fa.flash_fwd_plain(qf, kf, vf, causal)
    delta = (dof * o).sum(-1, keepdim=True)
    got = (tf32_dq(qf, kf, vf, dof, lse, delta, causal),
           *tf32_dkv(qf, kf, vf, dof, lse, delta, causal))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), flat(w).numpy(), rtol=1e-4, atol=1e-4)


# (B, H, Hkv, S, hd): chip_smoke.py's float32 shapes whose times PERF.md
# records, and the test shapes of tests/test_torch_cuda.py
@pytest.mark.parametrize("shape, dq_splits, dkv_splits", [
    ((8, 4, 4, 1024, 32), 1, 1),     # tiny_f32_hd32: 512 CTAs each, two waves already
    ((2, 4, 2, 200, 64), 4, 8),      # small_f32_hd64 (train_small): 32 and 16 CTAs
    ((1, 8, 2, 320, 128), 5, 20),    # gqa4_f32: 40 and 10 CTAs
    ((2, 4, 2, 200, 16), 4, 8),      # moe_small_f32_hd16
    ((1, 32, 32, 520, 64), 1, 1),    # 288 CTAs each
])
def test_split_rule(shape, dq_splits, dkv_splits):
    """The fewest parts that give two waves of 132 CTAs, never more parts
    than a CTA's loop has steps; 1 where the grid already has two waves."""
    b, h, hkv, s, hd = shape
    for causal in (True, False):
        got = (fa.bwd_splits("flash_bwd_dq", b * h, b * hkv, s, s, causal, hd),
               fa.bwd_splits("flash_bwd_dkv", b * h, b * hkv, s, s, causal, hd))
        assert got == (dq_splits, dkv_splits)


# (B, H, Hkv, S, hd): chip_smoke.py's wide rows and two more GQA shapes
@pytest.mark.parametrize("shape, dq_splits, dkv_splits", [
    ((1, 4, 2, 256, 512), 8, 9),     # wide_f32_hd512: 32 and 32 CTAs, 8 and 16 steps
    ((1, 4, 1, 333, 512), 6, 11),    # wide_bf16_hd512: 48 and 24 CTAs, 11 and 44 steps
    ((1, 2, 2, 77, 512), 3, 3),      # padded_f32_hd320 at 512: 8 and 16 CTAs, 3 steps
    ((2, 8, 2, 1024, 768), 1, 1),    # 768 and 384 CTAs: two waves already
    ((1, 4, 2, 200, 768), 6, 6),     # 48 and 48 CTAs, 7 and 14 steps
])
def test_split_rule_above_256(shape, dq_splits, dkv_splits):
    """Above hd 256 B2's grid has hd / 256 CTAs per (head, 64-row q tile)
    and B3's hd / 128 per (KV head, 64-key tile), each looping over 32-row
    tiles as at 256: the fewest parts that give two waves of 132 CTAs,
    never more than the loop's steps (the causal rows)."""
    b, h, hkv, s, hd = shape
    assert fa.col_parts("flash_bwd_dq", hd) == hd // 256
    assert fa.col_parts("flash_bwd_dkv", hd) == hd // 128
    assert fa.stream_rows(hd) == 32
    got = (fa.bwd_splits("flash_bwd_dq", b * h, b * hkv, s, s, True, hd),
           fa.bwd_splits("flash_bwd_dkv", b * h, b * hkv, s, s, True, hd))
    assert got == (dq_splits, dkv_splits)


@pytest.mark.parametrize("hd", [512, 768])
def test_column_parts_above_256_tile_the_head_dim(hd):
    """Above 256 B1 and B2 own 256 columns a part and B3 128; each part's
    first products take every slice once and end with the slice that
    holds its columns (whose tiles the second products read)."""
    assert [fa.col_parts(name, hd) for name in fa.KERNEL_NAMES] == [hd // 256, hd // 256,
                                                                   hd // 128]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        cols = hd // fa.col_parts(name, hd)
        for c in column_parts(name, hd):
            order = slice_order(hd, c)
            assert sorted(order.tolist()) == list(range(hd))
            assert order[-256] <= c and c + cols <= order[-256] + 256
    assert slice_order(768, 300).tolist()[:256:255] == [512, 767]


def test_split_rule_bounds():
    """Never more parts than steps, never fewer than one, and enough for two
    waves wherever the steps allow it."""
    for ctas in (1, 7, 40, 131, 132, 264, 1000):
        for pairs in (1, 3, 20, 300):
            n = fa._splits(ctas, pairs)
            assert 1 <= n <= pairs
            assert n == pairs or ctas * n >= 2 * fa.SMS
            assert n == 1 or ctas * (n - 1) < 2 * fa.SMS


if __name__ == "__main__":
    out = {}
    for hd in (768, 512, 256, 128, 64, 32, 16):
        for group in (1, 4):
            for causal in (True, False):
                key = f"hd{hd}/group{group}/{'causal' if causal else 'full'}"
                out[key] = {f"{n}_products": errors(hd, group, causal, n)[0] for n in (3, 1)}
    print(json.dumps({"shape": "BH 8, S 70", "tolerance_atol_of_max": ATOL, "rtol": RTOL,
                      "needed": out}, indent=1))
