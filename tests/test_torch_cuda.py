"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided inside the test,
so every xdist worker collects the same tests). This file imports neither
jax nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the repo's JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerance, as in chip_smoke.py: ``atol * max|ref| + rtol * |ref|``. The
FMA kernels compute in float32 from the same inputs as the plain versions
and differ in summation order, ~1e-6 relative in float32, and bf16
outputs may land one bf16 ulp (2**-7 relative) apart: atol 2e-3, rtol
1e-4 (f32) or 2**-7 (bf16). The tensor-core kernels (bf16, hd 128) also
round P (B1), dS (B2), P and dS (B3) to bf16 before the last product,
where the plain versions keep float32: atol 2**-8.
"""

import pytest
import torch

from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention

RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
ATOL = {"fma": 2e-3, "wgmma": 2.0 ** -8}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def close(got, want, dtype, variant="fma"):
    want = want.float()
    atol = ATOL[variant] * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=RTOL[dtype], atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, hd", [(torch.float32, 64), (torch.bfloat16, 64),
                                       (torch.bfloat16, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(dtype, hd, causal):
    """B1, B2, B3 at GQA group 4 and a ragged S of 200; bf16 at hd 128 runs
    the tensor-core kernels for all three, and their variant counts say so."""
    gen = card()
    q, do = (torch.randn(8, 200, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(2, 200, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    variant = {name: fa.ROUTES[name, dtype, hd] for name in fa.KERNEL_NAMES}
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    close(o, o_ref, dtype, variant["flash_fwd"])
    close(lse, lse_ref, torch.float32)
    close(fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
          fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal), dtype,
          variant["flash_bwd_dq"])
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal),
                         fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)):
        close(got, want, dtype, variant["flash_bwd_dkv"])
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert fa.variant_counts() == {
        name: {v: int(v == variant[name]) for v in fa.VARIANTS} for name in fa.KERNEL_NAMES
    }
    if dtype == torch.bfloat16 and hd == 128:
        assert variant == {"flash_fwd": "wgmma", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}


@pytest.mark.cuda
def test_tensor_core_dq_is_bitwise_deterministic():
    """Each CTA of the tensor-core B2 owns its dQ rows and sums over the K
    tiles in one fixed order, without atomics: two launches at a ragged GQA
    shape (group 4, S 1000, causal) give dQ identical bit for bit."""
    gen = card()
    q, do = (torch.randn(8, 1000, 128, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, 1000, 128, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    fa.reset_launch_counts()
    first = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    second = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    assert fa.variant_counts()["flash_bwd_dq"] == {"fma": 0, "wgmma": 2}
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_autograd_on_the_card_matches_the_cpu():
    """The dispatcher's forward and gradients through the kernels on the
    card equal the plain versions on the CPU ([B, S, H, hd] layout)."""
    gen = card()
    shapes = [(2, 130, 8, 128), (2, 130, 2, 128), (2, 130, 2, 128), (2, 130, 8, 128)]
    q, k, v, ct = (torch.randn(*s, generator=gen, device="cuda") for s in shapes)
    results = []
    for device in ("cuda", "cpu"):
        leaves = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        (out * ct.to(device)).sum().backward()
        results.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for got, want in zip(*results):
        close(got, want, torch.float32)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take():
    card()
    q = torch.zeros(4, 64, 16, device="cuda")  # hd 16 is not instantiated
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, True)
    # a storage offset off the 16-byte grid: raised, never routed elsewhere
    x = torch.zeros(4 * 64 * 128 + 1, device="cuda", dtype=torch.bfloat16)[1:]
    q = x.view(4, 64, 128)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(q, q, q, True)
    assert fa.launch_counts()["flash_fwd"] == 0
