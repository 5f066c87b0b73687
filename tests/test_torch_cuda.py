"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided inside the test,
so every xdist worker collects the same tests). This file imports neither
jax nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the repo's JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerance, as in chip_smoke.py: kernel and plain version compute in
float32 from the same inputs and differ in summation order, ~1e-6
relative in float32; bf16 outputs may land one bf16 ulp (2**-8) apart,
so ``2e-3 * max|ref| + rtol * |ref|`` with rtol 1e-4 (f32) or 2**-7
(bf16).
"""

import pytest
import torch

from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention

RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def close(got, want, dtype):
    want = want.float()
    atol = 2e-3 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=RTOL[dtype], atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(dtype, causal):
    """B1, B2, B3 at GQA group 4, a ragged S of 200 and hd 64."""
    gen = card()
    q, do = (torch.randn(8, 200, 64, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(2, 200, 64, generator=gen, device="cuda").to(dtype) for _ in range(2))
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    close(o, o_ref, dtype)
    close(lse, lse_ref, torch.float32)
    close(fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
          fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal), dtype)
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal),
                         fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)):
        close(got, want, dtype)
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


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
