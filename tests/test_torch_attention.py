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
    """The head dims the FMA kernels gained (16, 80, 96): the Function's
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
    assert fa.variant_counts() == {name: {"fma": 0, "wgmma": 0} for name in fa.KERNEL_NAMES}
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
    """bf16 goes to the tensor-core kernels for B1 and B3 at hd 128, 64 and
    32, and for B2 at hd 128; every float32 case, bf16 at hd 16, 80 and 96,
    and bf16 B2 at hd 64 and 32 go to the FMA kernels."""
    tensor_cores = dtype == torch.bfloat16 and (
        hd == 128 or (hd in (64, 32) and name != "flash_bwd_dq"))
    assert fa.ROUTES[name, dtype, hd] == ("wgmma" if tensor_cores else "fma")


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group, s", [(1, 64), (4, 200)])
def test_tensor_core_dq_rounding_within_its_tolerance(group, s, causal):
    """The tolerance chip_smoke.py holds the tensor-core B2 to, (atol 2**-8
    of max|ref|, rtol 2**-7), covers rounding dS to bf16 before the last
    product: the kernel's numerics, emulated on the CPU, stay within it of
    flash_bwd_dq_plain at hd 128, causal and not, MHA and GQA 4."""
    bh, hd = 8, 128
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays(
        (bh, s, hd), (bh // group, s, hd), (bh // group, s, hd), (bh, s, hd), seed=3))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal).float()
    got = tensor_core_dq(q, k, v, do, lse, delta, causal).float()
    assert not torch.equal(got, want)  # the rounding of dS shows in dQ
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=2.0 ** -8 * want.abs().max().item())


def test_tensor_core_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the tensor-core kernels raises when their library
    is first asked for; nothing falls back to the FMA kernels."""
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
