"""The port's flash attention (nanodiloco_tpu_torch.ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_attention.py runs them, with numpy inputs handed to both.

On the CPU the port's autograd Function runs each kernel's plain PyTorch
version (the CUDA kernels themselves run only on the card: see
tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: both sides accumulate in float32 and differ in summation order
(the Pallas kernel sums over 16-row K blocks, the plain version over 512)
and in exp: ~1e-6 relative; 2e-5 on outputs and 1e-4 on gradients, as
tests/test_attention.py holds the Pallas kernel against dense attention.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from nanodiloco_tpu.ops.pallas.flash_attention import _fwd_call, pallas_flash_attention
from nanodiloco_tpu_torch.models.llama import dense_attention
from nanodiloco_tpu_torch.ops.cuda import build
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention
from nanodiloco_tpu_torch.ops.online_softmax import block_update, finalize_grouped

CASES = [(g, causal) for g in (1, 2, 4) for causal in (True, False)]


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("group, causal", CASES)
def test_forward_o_and_lse_match_pallas(group, causal):
    bh, s, hd = 8, 64, 16
    q, k, v = arrays((bh, s, hd), (bh // group, s, hd), (bh // group, s, hd))
    with jax.default_matmul_precision("highest"):
        o_ref, lse_ref = _fwd_call(causal, 16, 16, True, *map(jnp.asarray, (q, k, v)))
    o, lse = fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    assert lse.shape == lse_ref.shape == (bh, s, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("group, causal", CASES)
def test_gradients_match_pallas(group, causal):
    """dQ/dK/dV through the Function's plain backward (B2, B3) against
    jax.grad through the Pallas custom VJP."""
    b, s, h, hd = 2, 32, 4, 8
    hkv = h // group
    q, k, v, ct = arrays((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd), seed=1)

    def jax_loss(q, k, v):
        out = pallas_flash_attention(q, k, v, causal=causal, block_q=8, block_k=8,
                                     interpret=True)
        return jnp.sum(out * ct)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hd", [16, 80, 96])
@pytest.mark.parametrize("group, causal", [(1, True), (2, False), (4, True)])
def test_more_head_dims_match_jax_flash_attention(hd, group, causal):
    """Head dims 16, 80 and 96 (taken since the first three): the Function's
    plain forward and backward on the CPU against the JAX dispatcher's scan
    path (what it runs off the TPU at any head dim), output and dQ/dK/dV,
    GQA and causal."""
    b, s, h = 1, 48, 4
    hkv = h // group
    q, k, v, ct = arrays((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd), seed=4)

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_size=16, impl="scan")
        return jnp.sum(out * ct), out

    with jax.default_matmul_precision("highest"):
        (_, want_out), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def dense_reference(q, k, v, causal):
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    s = q.shape[1]
    mask = None if causal else torch.zeros(1, 1, s, s)
    return dense_attention(q, k, v, mask)


@pytest.mark.parametrize("s", [37, 50])
@pytest.mark.parametrize("group, causal", [(1, True), (2, False), (2, True)])
def test_ragged_length_matches_dense(s, group, causal):
    """A sequence length with no common block size (the TPU kernel raised
    on it) against the port's dense attention, forward and gradients."""
    b, h, hd = 1, 4, 16
    q, k, v, ct = arrays((b, s, h, hd), (b, s, h // group, hd), (b, s, h // group, hd),
                         (b, s, h, hd), seed=2)
    grads = []
    for fn in (flash_attention, dense_reference):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
        out = fn(tq, tk, tv, causal)
        (out * torch.from_numpy(ct)).sum().backward()
        grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_fully_masked_row_gives_zeros_not_nan():
    """A row with every score at -inf keeps m = -inf, l = 0, o = 0 through
    the recurrence, and finalizes to zeros, never NaN."""
    o = torch.zeros(1, 1, 2, 4)
    l = torch.zeros(1, 1, 2)
    m = torch.full((1, 1, 2), -math.inf)
    scores = torch.tensor([[[[-math.inf] * 3, [0.5, -1.0, 2.0]]]])
    v = torch.randn(1, 1, 3, 4)
    o, l, m = block_update(o, l, m, scores, v)
    o, l, m = block_update(o, l, m, torch.full_like(scores, -math.inf), v)
    out = finalize_grouped(o, l, 1, torch.float32)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0, 0, 0], torch.zeros(4))
    torch.testing.assert_close(out[0, 1, 0], torch.softmax(scores[0, 0, 1], -1) @ v[0, 0])


def test_dispatcher_rejects_unknown_impl_and_bad_heads():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="unknown flash attention impl"):
        flash_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, q[:, :, :3], q[:, :, :3])


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda q, k, v: (q.double(), k.double(), v.double()), "not supported"),
        (lambda q, k, v: (q, k.to(torch.bfloat16), v), "share one dtype"),
        (lambda q, k, v: (q.transpose(0, 1), k, v), "contiguous"),
        (lambda q, k, v: (q[..., :24].contiguous(), k[..., :24].contiguous(),
                          v[..., :24].contiguous()), "head dim"),
        (lambda q, k, v: (q, torch.zeros(3, 64, 32), torch.zeros(3, 64, 32)), "must divide"),
        # contiguous, but 4 bytes past an aligned start: TMA cannot read it
        (lambda q, k, v: (torch.zeros(q.numel() + 1)[1:].view(q.shape), k, v), "16-byte"),
    ],
)
def test_wrapper_checks_raise_on_what_the_kernel_does_not_take(bad, match):
    q, k, v = torch.zeros(4, 64, 32), torch.zeros(2, 64, 32), torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match=match):
        fa._check("flash_fwd", *bad(q, k, v))


def test_cpu_tensors_never_launch():
    fa.reset_launch_counts()
    fa.reset_shape_counts()
    q = torch.randn(1, 16, 2, 32, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert fa.variant_counts() == {name: {"wgmma": 0, "tf32x3": 0}
                                   for name in fa.KERNEL_NAMES}
    assert fa.shape_counts() == {name: {} for name in fa.KERNEL_NAMES}


def test_shape_counts_key_each_launch_and_outlive_reset_launch_counts():
    """A launch is counted under its shape's key, which parses back; the
    shape counts survive ``reset_launch_counts`` (a run totals them across
    parts that reset the others) and clear only on ``reset_shape_counts``."""
    fa.reset_shape_counts()
    q = torch.zeros(8, 70, 64, dtype=torch.bfloat16)
    k = torch.zeros(4, 70, 64, dtype=torch.bfloat16)
    fa._counted(fa.flash_bwd_dkv, "wgmma", q, k, False)  # what a launch on the card records
    fa.reset_launch_counts()
    key = fa.shape_key(torch.bfloat16, 8, 4, 70, 70, 64, False)
    assert key == "bfloat16/8/4/70/70/64/0"
    assert fa.shape_counts() == {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {key: 1}}
    assert fa.parse_shape_key(key) == (torch.bfloat16, 8, 4, 70, 70, 64, False)
    fa.reset_shape_counts()
    assert fa.shape_counts() == {name: {} for name in fa.KERNEL_NAMES}


@pytest.mark.parametrize("name", fa.KERNEL_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_route_table(name, dtype, hd):
    """Two designs, both on the tensor cores: bf16 goes to the wgmma kernels
    at hd 256, 128, 96, 80, 64 and 32, all three kernels, and to
    three-product TF32 at hd 16; every float32 row goes to three-product
    TF32. ROUTES is route() row by row, and no FMA variant is left."""
    if dtype == torch.bfloat16:
        want = "wgmma" if hd in (256, 128, 96, 80, 64, 32) else "tf32x3"
    else:
        want = "tf32x3"
    assert fa.ROUTES[name, dtype, hd] == want == fa.route(name, dtype, hd)
    assert fa.VARIANTS == ("wgmma", "tf32x3")


def tensor_core_dq(q, k, v, do, lse, delta, causal):
    """The tensor-core B2's numerics in plain float32: S and dP from the bf16
    inputs with float32 sums, as the plain version has them, but dS rounded
    to bf16 before dQ = dS K (it is the register operand of that wgmma),
    then scaled and rounded to bf16 as the kernel's epilogue does."""
    g = q.shape[0] // k.shape[0]
    kf, vf = (x.float().repeat_interleave(g, dim=0) for x in (k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * scale
    p = torch.exp(s - lse)
    if causal:
        p = p.tril()
    ds = p * (torch.matmul(do.float(), vf.transpose(1, 2)) - delta)
    return (torch.matmul(ds.to(torch.bfloat16).float(), kf) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("hd", [128, 96, 80, 64, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group, s", [(1, 64), (4, 200)])
def test_tensor_core_dq_rounding_within_its_tolerance(group, s, causal, hd):
    """The tolerance chip_smoke.py holds the tensor-core B2 to, (atol 2**-8
    of max|ref|, rtol 2**-7), covers rounding dS to bf16 before the last
    product: the kernel's numerics, emulated on the CPU, stay within it of
    flash_bwd_dq_plain at hd 128, 96, 80, 64 and 32, causal and not, MHA
    and GQA 4."""
    bh = 8
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays(
        (bh, s, hd), (bh // group, s, hd), (bh // group, s, hd), (bh, s, hd), seed=3))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal).float()
    got = tensor_core_dq(q, k, v, do, lse, delta, causal).float()
    assert not torch.equal(got, want)  # the rounding of dS shows in dQ
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=2.0 ** -8 * want.abs().max().item())


@pytest.mark.parametrize("hd", [96, 80, 64, 32])
@pytest.mark.parametrize("group, causal", [(2, True), (1, False)])
def test_tensor_core_dq_matches_jax_flash_attention(hd, group, causal):
    """The tensor-core B2's numerics at hd 96, 80, 64 and 32, emulated on the
    CPU, against dQ from jax.grad through the JAX dispatcher's scan path, on
    the same bf16-representable inputs, at the tensor-core tolerance."""
    b, s, h = 1, 64, 4
    hkv = h // group
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays(
        (b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd), seed=5))

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_size=16, impl="scan")
        return jnp.sum(out * jnp.asarray(do.float().numpy()))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jax_loss)(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)))

    def flat(x):  # [1, S, heads, hd] -> [heads, S, hd]
        return x[0].transpose(0, 1).contiguous()

    qf, kf, vf, dof = map(flat, (q, k, v, do))
    o, lse = fa.flash_fwd_plain(qf.float(), kf.float(), vf.float(), causal)
    delta = (dof.float() * o).sum(-1, keepdim=True)
    got = tensor_core_dq(qf, kf, vf, dof, lse, delta, causal).float()
    want = torch.from_numpy(np.asarray(want)[0].transpose(1, 0, 2).copy())
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=2.0 ** -8 * want.abs().max().item())


# keys per K/V tile of the wgmma B1: 64 in the warp-specialised kernel of hd
# 256 (flash_fwd_ws_kernel), 128 below it (flash_fwd_tc_kernel)
def fwd_key_tile(hd):
    return 64 if hd == 256 else 128


def tensor_core_fwd(q, k, v, causal, keys=128):
    """The tensor-core B1's numerics in plain float32: S from the bf16 inputs
    with float32 sums, the online softmax over tiles of ``keys`` keys (the
    kernel's K/V tile, ``fwd_key_tile``), P rounded to bf16 before
    O += P V (it is the register operand of that wgmma) while the row sum l
    adds the float32 P, then O / l rounded to bf16 as the epilogue does.
    Returns (O, lse [BH, Sq, 1])."""
    g = q.shape[0] // k.shape[0]
    kf, vf = (x.float().repeat_interleave(g, dim=0) for x in (k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[1:], dtype=torch.bool).triu(1), -math.inf)
    m = torch.full(s.shape[:2], -math.inf)
    l = torch.zeros(s.shape[:2])
    acc = torch.zeros(q.shape)
    for j0 in range(0, s.shape[2], keys):
        sj = s[..., j0:j0 + keys]
        m_new = torch.maximum(m, sj.amax(-1))
        m_safe = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp(m - m_safe)
        p = torch.exp(sj - m_safe[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(torch.bfloat16).float(),
                                                   vf[:, j0:j0 + keys])
        m = m_new
    o = (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, -math.inf))
    return o, lse[..., None]


def tensor_core_dkv(q, k, v, do, lse, delta, causal):
    """The tensor-core B3's numerics in plain float32: S and dP from the
    bf16 inputs with float32 sums, P = exp(S scale - lse) and
    dS = P (dP - delta) in float32, then P and dS rounded to bf16 before
    dV += P^T dO and dK += dS^T Q (the register operands of those wgmmas),
    summed over each KV head's query group, scaled (dK) and rounded to bf16
    as the epilogue does."""
    g = q.shape[0] // k.shape[0]
    kf, vf = (x.float().repeat_interleave(g, dim=0) for x in (k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(q.float(), kf.transpose(1, 2)) * scale - lse)
    if causal:
        p = p.tril()
    ds = p * (torch.matmul(do.float(), vf.transpose(1, 2)) - delta)
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(torch.bfloat16).float().transpose(1, 2), q.float()) * scale

    def group_sum(x):
        return x.reshape(k.shape[0], g, *x.shape[1:]).sum(1).to(torch.bfloat16)

    return group_sum(dk), group_sum(dv)


def tensor_core_close(got, want):
    """The tensor-core tolerance: atol 2**-8 of max|want|, rtol 2**-7."""
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * want.abs().max().item())


@pytest.mark.parametrize("hd", [256, 128, 96, 80, 64, 32])
@pytest.mark.parametrize("group, s, causal", [(1, 64, True), (4, 200, True), (2, 200, False)])
def test_tensor_core_fwd_and_dkv_rounding_within_their_tolerance(group, s, causal, hd):
    """The tolerance chip_smoke.py holds the tensor-core B1 and B3 to
    (atol 2**-8 of max|ref|, rtol 2**-7) covers rounding P (B1), P and dS
    (B3) to bf16 before the last product: the kernels' numerics, emulated
    on the CPU, stay within it of flash_fwd_plain and flash_bwd_dkv_plain at
    every head dim they serve (hd 80 as hd 80: its tile's zero columns add
    exactly 0), over one and more key tiles (128 keys, 64 at hd 256), MHA
    and GQA, causal and not."""
    bh = 8
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays(
        (bh, s, hd), (bh // group, s, hd), (bh // group, s, hd), (bh, s, hd), seed=6))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    o, lse = tensor_core_fwd(q, k, v, causal, fwd_key_tile(hd))
    tensor_core_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    got = tensor_core_dkv(q, k, v, do, lse_ref, delta, causal)
    assert not torch.equal(got[1], want[1])  # the rounding of P shows in dV
    for g, w in zip(got, want):
        tensor_core_close(g, w)


def jax_flash_grads(q, k, v, do, causal):
    """(O, (dQ, dK, dV)) of the JAX dispatcher's scan path on the CPU, from
    [1, S, heads, hd] bf16-representable inputs, in float32."""
    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_size=16, impl="scan")
        return jnp.sum(out * jnp.asarray(do.float().numpy())), out

    with jax.default_matmul_precision("highest"):
        (_, out), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    return out, grads


def heads_first(x):
    """[1, S, heads, hd] (torch or a JAX array) -> [heads, S, hd]."""
    x = torch.from_numpy(np.asarray(x).copy()) if not isinstance(x, torch.Tensor) else x
    return x[0].transpose(0, 1).contiguous()


@pytest.mark.parametrize("hd", [96, 80, 256])
@pytest.mark.parametrize("group, causal", [(4, True), (1, False), (2, True)])
def test_tensor_core_fwd_and_dkv_match_jax_flash_attention(hd, group, causal):
    """The tensor-core B1's and B3's numerics at hd 96, 80 and 256, emulated
    on the CPU, against the output and dK/dV of jax.grad through the JAX
    dispatcher's scan path, on the same bf16-representable inputs, at the
    tensor-core tolerance; S 144 spans two of B1's 128-key tiles (three of
    its 64-key tiles at hd 256)."""
    b, s, h = 1, 144, 4
    hkv = h // group
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays(
        (b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd), seed=7))
    want_out, (_, want_dk, want_dv) = jax_flash_grads(q, k, v, do, causal)
    qf, kf, vf, dof = map(heads_first, (q, k, v, do))
    o, _ = tensor_core_fwd(qf, kf, vf, causal, fwd_key_tile(hd))
    tensor_core_close(o, heads_first(want_out))
    o_ref, lse = fa.flash_fwd_plain(qf.float(), kf.float(), vf.float(), causal)
    delta = (dof.float() * o_ref).sum(-1, keepdim=True)
    dk, dv = tensor_core_dkv(qf, kf, vf, dof, lse, delta, causal)
    tensor_core_close(dk, heads_first(want_dk))
    tensor_core_close(dv, heads_first(want_dv))


def test_tensor_core_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the wgmma kernels raises when their library is
    first asked for; nothing falls back to another variant."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    fa._tc_lib.cache_clear()
    build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="kernel build failed"):
            fa._tc_lib()
    finally:
        fa._tc_lib.cache_clear()
        build.library.cache_clear()


def test_tf32_launch_failure_raises(monkeypatch):
    """A tf32x3 launcher's non-zero return code raises with that library's
    message (a split count out of range: -2); nothing falls back."""

    class Lib:
        @staticmethod
        def nd_tf32_error_string(rc):
            return b"split count out of [1, 65535]"

    monkeypatch.setattr(fa, "_tf32_lib", lambda: Lib)
    fa._raise_on(0, "flash_bwd_dkv", "tf32x3")
    with pytest.raises(RuntimeError, match=r"flash_bwd_dkv \(tf32x3\).*split count"):
        fa._raise_on(-2, "flash_bwd_dkv", "tf32x3")


def test_tensor_core_launch_failure_raises(monkeypatch):
    """A launcher's non-zero return code raises with the tensor-core
    library's message; the wrapper counts a launch only after this check."""

    class Lib:
        @staticmethod
        def nd_tc_error_string(rc):
            return b"too many resources requested for launch"

    monkeypatch.setattr(fa, "_tc_lib", lambda: Lib)
    fa._raise_on(0, "flash_bwd_dq", "wgmma")
    with pytest.raises(RuntimeError, match=r"flash_bwd_dq \(wgmma\).*too many resources"):
        fa._raise_on(7, "flash_bwd_dq", "wgmma")
