"""The forward (B1) on the tensor cores as three-product TF32
(``csrc/flash_attention_tf32_fwd.cu``), modelled in float32 on the CPU against
the plain version and against the JAX package's forward; the bf16
instances of all three kernels (lo terms skipped: bf16 is exact in TF32);
and head dims the kernels do not take, zero-padded by the dispatcher (up
to the next of HEAD_DIMS, above 256 to the next multiple of 256), against
JAX.

The model: TF32 rounding and the hi/lo split as
``tests/test_torch_attention_tf32.py`` has them (``cvt.rna.tf32.f32``);
every product adds lo·hi, hi·lo and hi·hi 8 terms of the reduction at a
time (mma.sync m16n8k8), dropping the terms of an operand that has no lo
part. B1 walks 64-key tiles (32 from hd 256, ``fa.stream_rows``): S = Q K^T
times scale·log2 e, masked to -inf, the online softmax in exp2 (m in log2
units), P split as the left operand of O += P V, then O / max(l, 1e-30)
and lse = m ln 2 + ln l.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention

# chip_smoke.py's tolerances of the tf32x3 route: |got - plain| <= ATOL *
# max|plain| + RTOL * |plain|, in float32 and in bf16
F32_TOL = (1e-4, 1e-4)
BF16_TOL = (2e-3, 2.0 ** -7)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


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
    """``cvt.rna.tf32.f32``: to nearest at the 13 dropped mantissa bits,
    ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, lo_a=True, lo_b=True):
    """``a @ b`` as mma.sync computes it: 8 of K at a time, lo_a·hi_b (if
    A has a lo part), hi_a·lo_b (if B has one), then hi_a·hi_b, into one
    float32 accumulator."""
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    a_lo, b_lo = round_tf32(a - a_hi), round_tf32(b - b_hi)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ah, bh = a_hi[..., k0:k0 + 8], b_hi[..., k0:k0 + 8, :]
        if lo_a:
            acc = acc + a_lo[..., k0:k0 + 8] @ bh
        if lo_b:
            acc = acc + ah @ b_lo[..., k0:k0 + 8, :]
        acc = acc + ah @ bh
    return acc


class Kernel:
    """The products of a kernel instance: ``products`` 3 (three-product
    TF32) or 1 (hi·hi alone); ``exact`` skips the lo terms of the inputs
    (Q, K, V, dO), as the bf16 instances do. P and dS always have both
    parts."""

    def __init__(self, products=3, exact=False):
        self.full = products == 3
        self.input_lo = self.full and not exact

    def inputs(self, a, b):  # both operands inputs: Q K^T, dO V^T
        return product(a, b, self.input_lo, self.input_lo)

    def p_times(self, a, b):  # P or dS times an input
        return product(a, b, self.full, self.input_lo)


def tf32_fwd(q, k, v, causal, kernel=Kernel(), scale=None):
    """B1: (O [BH, Sq, hd], lse [BH, Sq, 1]), float32, GQA folded into the
    row axis as the plain versions fold it."""
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf, qpos = fa._folded(q, bkv)
    m = torch.full(qf.shape[:2], -math.inf)
    l = torch.zeros(qf.shape[:2])
    acc = torch.zeros(qf.shape)
    tile = fa.stream_rows(hd)
    for j0 in range(0, sk, tile):
        kj, vj = k[:, j0:j0 + tile].float(), v[:, j0:j0 + tile].float()
        s = kernel.inputs(qf, kj.transpose(1, 2)) * (scale * LOG2E)
        if causal:
            kpos = torch.arange(j0, j0 + kj.shape[1])
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - m_safe)
        p = torch.exp2(s - m_safe[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + kernel.p_times(p, vj)
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m * LN2 + torch.log(l), torch.full_like(l, -math.inf))
    return o.reshape(q.shape), lse.reshape(bh, sq, 1)


def tf32_bwd(q, k, v, do, lse, delta, causal, kernel=Kernel()):
    """B2 and B3: (dQ, dK, dV), float32, from the saved lse and delta."""
    bkv = k.shape[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, qpos = fa._folded(q, bkv)
    dof, _ = fa._folded(do, bkv)
    kf, vf = k.float(), v.float()
    s = kernel.inputs(qf, kf.transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(torch.arange(k.shape[1])[None, :] > qpos[:, None], -math.inf)
    lse_f, delta_f = lse.reshape(bkv, -1, 1), delta.reshape(bkv, -1, 1)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse_f), torch.zeros_like(s))
    ds = p * (kernel.inputs(dof, vf.transpose(1, 2)) - delta_f)
    dq = kernel.p_times(ds, kf) * scale
    dk = kernel.p_times(ds.transpose(1, 2), qf) * scale
    return dq.reshape(q.shape), dk, kernel.p_times(p.transpose(1, 2), dof)


def needed(got, want, rtol) -> float:
    """The ATOL share of max|want| that ``got`` needs at ``rtol``."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
    err = (got[fin] - want[fin]).abs() - rtol * want[fin].abs()
    return max(0.0, err.max().item()) / want[fin].abs().max().item()


def forward_needs(hd, group, causal, kernel, s=150):
    """(ATOL share O needs, lse needs) of the model against flash_fwd_plain
    at BH 8 and a ragged S over three 64-key tiles."""
    q, k, v = arrays((8, s, hd), (8 // group, s, hd), (8 // group, s, hd), seed=21)
    o, lse = tf32_fwd(q, k, v, causal, kernel)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    return needed(o, o_ref, F32_TOL[1]), needed(lse, lse_ref, F32_TOL[1]), (o, o_ref)


@pytest.mark.parametrize("hd", [512, 256, 128, 64, 32, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_three_product_forward_within_f32_tolerance(hd, causal, group):
    """The tf32x3 B1's numerics hold chip_smoke.py's float32 tolerance
    (1e-4 of max|plain| + 1e-4 relative) against flash_fwd_plain, for O and
    lse, MHA and GQA 4, causal and not, at a ragged S over three tiles; and
    they are not the plain version's bits, so the rounding is modelled."""
    need_o, need_lse, (o, o_ref) = forward_needs(hd, group, causal, Kernel())
    assert need_o <= F32_TOL[0] and need_lse <= F32_TOL[0], (need_o, need_lse)
    assert not torch.equal(o, o_ref)


@pytest.mark.parametrize("hd", [128, 32])
def test_one_product_forward_misses_the_f32_tolerance(hd):
    """The reason for three products in the forward too: hi·hi alone
    (one-pass TF32) needs more than the float32 tolerance on O."""
    need_o, _, _ = forward_needs(hd, 4, True, Kernel(products=1))
    assert need_o > F32_TOL[0], need_o


@pytest.mark.parametrize("hd", [256, 128, 64, 32, 16])
@pytest.mark.parametrize("group, causal", [(2, True), (1, False)])
def test_three_product_forward_matches_jax(hd, group, causal):
    """O of the tf32x3 model against the JAX dispatcher's forward (its scan
    path on the CPU) on the same float32 inputs made with numpy, at the
    float32 tolerance (1e-4, 1e-4)."""
    b, s, h = 1, 96, 4
    q, k, v = (x.numpy() for x in arrays((b, s, h, hd), (b, s, h // group, hd),
                                         (b, s, h // group, hd), seed=22))
    with jax.default_matmul_precision("highest"):
        want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, block_size=16,
                                   impl="scan")

    def flat(x):  # [1, S, heads, hd] -> [heads, S, hd]
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[0].transpose(1, 0, 2)))

    o, _ = tf32_fwd(flat(q), flat(k), flat(v), causal)
    np.testing.assert_allclose(o.numpy(), flat(want).numpy(), rtol=1e-4, atol=1e-4)


def bf16_inputs(group, causal, s=150, hd=16, seed=23):
    """bf16 q, k, v, dO and the plain forward's (O, lse) and delta."""
    q, k, v, do = (x.to(torch.bfloat16) for x in arrays(
        (8, s, hd), (8 // group, s, hd), (8 // group, s, hd), (8, s, hd), seed=seed))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1, keepdim=True)


@pytest.mark.parametrize("hd", [16, 256])
@pytest.mark.parametrize("group, causal", [(1, True), (2, False), (4, True)])
def test_bf16_skipping_lo_terms_is_the_three_product_result(group, causal, hd):
    """On bf16 inputs (exact in TF32: lo = 0) the instances that skip the
    inputs' lo terms (one product for Q K^T and dO V^T, two for P V, dS K,
    P^T dO and dS^T Q) give the three-product kernel's result on the same
    values in float32 bit for bit, for B1, B2 and B3; rounded to bf16 they
    stay within (2e-3, 2**-7) of the plain versions at hd 16 and 256."""
    q, k, v, do, lse, delta = bf16_inputs(group, causal, hd=hd)
    f32 = [x.float() for x in (q, k, v, do)]
    skip, full = Kernel(exact=True), Kernel()
    fwd = tf32_fwd(*f32[:3], causal, skip)
    assert all(torch.equal(a, b) for a, b in zip(fwd, tf32_fwd(*f32[:3], causal, full)))
    bwd = tf32_bwd(*f32, lse, delta, causal, skip)
    assert all(torch.equal(a, b)
               for a, b in zip(bwd, tf32_bwd(*f32, lse, delta, causal, full)))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    want = (o_ref, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal))
    for got, ref in zip((fwd[0], *bwd), want):
        assert needed(got.to(torch.bfloat16), ref, BF16_TOL[1]) <= BF16_TOL[0]
    assert needed(fwd[1], lse_ref, F32_TOL[1]) <= F32_TOL[0]


def jax_value_and_grads(q, k, v, ct, causal):
    """(O, (dQ, dK, dV)) of the JAX dispatcher's scan path on the CPU."""
    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_size=16, impl="scan")
        return jnp.sum(out * ct), out

    with jax.default_matmul_precision("highest"):
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    return out, grads


@pytest.mark.parametrize("hd, group, causal", [(8, 1, True), (24, 2, False), (48, 4, True),
                                               (112, 2, True)])
def test_head_dims_outside_the_six_match_jax(hd, group, causal):
    """ROADMAP C3: at head dims the kernels are not built for, the
    dispatcher pads q, k and v with zero columns up to the next of
    HEAD_DIMS and scales by 1/sqrt(hd): output and dQ, dK, dV match the
    JAX dispatcher's (which takes any head dim) at (2e-5, 2e-5) and
    (1e-4, 1e-4), and each has hd columns."""
    b, s, h = 1, 48, 4
    hkv = h // group
    q, k, v, ct = (x.numpy() for x in arrays((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                                             (b, s, h, hd), seed=24))
    want_out, want = jax_value_and_grads(q, k, v, ct, causal)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hd", [264, 320, 512])
def test_head_dims_above_128_raise_naming_c3(hd):
    """Head dims above 256 (which raised naming ROADMAP C3 until it was
    closed) run: 264 and 320 zero-padded to 512, 512 as it is, through the
    kernels that sum their first products over slices of 256 columns. The
    output and dQ, dK, dV match the JAX dispatcher's at (2e-5, 2e-5) and
    (1e-4, 1e-4), GQA and MHA, causal and not, and the padded width is
    ``fa.width``."""
    group, causal = {264: (2, True), 320: (1, False), 512: (4, True)}[hd]
    assert fa.width(hd) == 512 and fa.takes(hd) == (hd == 512)
    b, s, h = 1, 48, 4
    hkv = h // group
    q, k, v, ct = (x.numpy() for x in arrays((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                                             (b, s, h, hd), seed=25))
    want_out, want = jax_value_and_grads(q, k, v, ct, causal)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_tf32_forward_launch_failure_raises(monkeypatch):
    """A tf32x3 forward launcher's non-zero return code (-1: a dtype or
    head dim not instantiated) raises RuntimeError with the library's
    message; nothing falls back."""

    class Lib:
        @staticmethod
        def nd_tf32_error_string(rc):
            return b"dtype or head dim not instantiated"

    monkeypatch.setattr(fa, "_tf32_lib", lambda: Lib)
    fa._raise_on(0, "flash_fwd", "tf32x3")
    with pytest.raises(RuntimeError, match=r"flash_fwd \(tf32x3\).*not instantiated"):
        fa._raise_on(-1, "flash_fwd", "tf32x3")


def test_tf32_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the tf32x3 kernels (the only route of the float32
    forward now) raises when their library is first asked for."""
    from nanodiloco_tpu_torch.ops.cuda import build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    fa._tf32_lib.cache_clear()
    build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="kernel build failed"):
            fa._tf32_lib()
    finally:
        fa._tf32_lib.cache_clear()
        build.library.cache_clear()
