"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided inside the test,
so every xdist worker collects the same tests). This file imports neither
jax nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the repo's JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerance, as in chip_smoke.py: ``atol * max|ref| + rtol * |ref|``, rtol
1e-4 (f32) or 2**-7 (bf16: outputs may land one bf16 ulp apart). The
three-product TF32 kernels (tf32x3: every float32 row, bf16 at hd 16, both
dtypes above 256) keep float32's accuracy but for ~2**-22: atol 1e-4 in
float32; in bf16 the inputs are exact in TF32 and the float32-accurate
sums are rounded to bf16, atol 2e-3. The wgmma kernels (bf16: B1, B2, B3
at hd 256, 128, 96, 80, 64 and 32, hd 80 in the hd-96 tile, B1 at 256 the
warp-specialised forward) also round P (B1), dS (B2), P and dS (B3) to bf16
before the last product, where the plain versions keep float32: atol
2**-8. lse, and the dispatcher's float32 outputs and
gradients card against CPU, are held at atol 2e-3.
"""

import pytest
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params, tree_leaves, tree_map
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.evaluate import Evaluator, holdout_batches

RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
ATOL = {(torch.float32, "tf32x3"): 1e-4, (torch.bfloat16, "tf32x3"): 2e-3,
        (torch.bfloat16, "wgmma"): 2.0 ** -8}
LOOSE_ATOL = 2e-3  # lse; the dispatcher's float32 results, card against CPU


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def close(got, want, dtype, variant=None):
    want = want.float()
    atol = (ATOL[dtype, variant] if variant else LOOSE_ATOL) * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=RTOL[dtype], atol=atol)


def guarded_empty_like(bufs, guard=4096):
    """A torch.empty_like that hands out the head of a buffer whose
    ``guard`` elements after it hold a marker (7.0), recorded in ``bufs``."""

    def guarded_like(t, **kw):
        buf = torch.full((t.numel() + guard,), 7.0, device=t.device, dtype=t.dtype)
        bufs.append((buf, t.numel()))
        return buf[:t.numel()].view(t.shape)

    return guarded_like


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, hd", [(torch.float32, 64), (torch.bfloat16, 64),
                                       (torch.bfloat16, 128), (torch.float32, 16),
                                       (torch.bfloat16, 80), (torch.float32, 96)])
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
@pytest.mark.parametrize("hd", [64, 32])
@pytest.mark.parametrize("h, hkv, s, causal", [(8, 4, 1024, True), (4, 4, 200, True),
                                               (4, 2, 77, False)])
def test_tensor_core_kernels_at_hd_64_and_32(hd, h, hkv, s, causal):
    """bf16 at hd 64 and 32: B1, B2 and B3 launch the tensor-core kernels,
    and each matches its plain version (GQA and MHA, a ragged S, causal and
    not). B3 sums its query group in registers: two launches give dK and dV
    identical bit for bit."""
    gen = card()
    bf16 = torch.bfloat16
    q, do = (torch.randn(2 * h, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k, v = (torch.randn(2 * hkv, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal)
    close(o, o_ref, bf16, "wgmma")
    close(lse, lse_ref, torch.float32)
    close(fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
          fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal), bf16, "wgmma")
    first = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    second = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    for got, again, want in zip(first, second,
                                fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)):
        close(got, want, bf16, "wgmma")
        assert torch.equal(got, again)
    assert fa.variant_counts() == {"flash_fwd": {"wgmma": 1, "tf32x3": 0},
                                   "flash_bwd_dq": {"wgmma": 1, "tf32x3": 0},
                                   "flash_bwd_dkv": {"wgmma": 2, "tf32x3": 0}}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("h, hkv, s, causal", [(8, 2, 1000, True), (4, 4, 200, False),
                                               (8, 2, 77, False), (4, 4, 40, True)])
def test_tensor_core_kernels_at_hd_96_and_80(hd, h, hkv, s, causal):
    """bf16 at hd 96 and 80 (hd 80 read into the hd-96 tile, its stores
    kept to 80 columns): B1, B2 and B3 launch the tensor-core kernels, and
    each matches its plain version (GQA 4 and MHA, ragged S 1000, 200 and
    77, S 40 under one tile, causal and not). B3 sums its query group in
    registers: two launches give dK and dV identical bit for bit."""
    gen = card()
    bf16 = torch.bfloat16
    q, do = (torch.randn(2 * h, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k, v = (torch.randn(2 * hkv, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal)
    close(o, o_ref, bf16, "wgmma")
    close(lse, lse_ref, torch.float32)
    close(fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
          fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal), bf16, "wgmma")
    first = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    second = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    for got, again, want in zip(first, second,
                                fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)):
        close(got, want, bf16, "wgmma")
        assert torch.equal(got, again)
    assert fa.variant_counts() == {"flash_fwd": {"wgmma": 1, "tf32x3": 0},
                                   "flash_bwd_dq": {"wgmma": 1, "tf32x3": 0},
                                   "flash_bwd_dkv": {"wgmma": 2, "tf32x3": 0}}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 80])
def test_tensor_core_stores_stay_inside_their_tensors(hd, monkeypatch):
    """The epilogues of B1 (O), B2 (dQ) and B3 (dK, dV) write only inside
    their tensors: each output is the head of a larger buffer filled with a
    marker, and what follows it comes back unchanged. At hd 80 an epilogue
    that stored the tile's 96 columns, or strode rows by 96, would write
    past the last row."""
    gen = card()
    bf16 = torch.bfloat16
    q, do = (torch.randn(8, 77, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k, v = (torch.randn(2, 77, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, True)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    guard = 4096  # marker elements after each output
    bufs = []
    empty_like = torch.empty_like

    def guarded_like(t, **kw):
        if t.dtype != bf16:
            return empty_like(t, **kw)
        buf = torch.full((t.numel() + guard,), 7.0, device=t.device, dtype=bf16)
        bufs.append((buf, t.numel()))
        return buf[:t.numel()].view(t.shape)

    monkeypatch.setattr(torch, "empty_like", guarded_like)
    o, _ = fa.flash_fwd(q, k, v, True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, True)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert len(bufs) == 4
    for buf, n in bufs:
        assert torch.equal(buf[n:], torch.full((guard,), 7.0, device="cuda", dtype=bf16))
    close(o, o_ref, bf16, "wgmma")
    close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, True), bf16, "wgmma")
    for got, want in zip((dk, dv), fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, True)):
        close(got, want, bf16, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [256, 128, 96, 80, 64, 32])
def test_tensor_core_forward_fully_masked_row_gives_zeros_not_nan(hd):
    """A query row whose every score is -inf (its first column -inf, the
    rest 0, every key's first column positive) keeps m = -inf in the
    tensor-core B1: its O row is zeros and its lse -inf, never NaN, and the
    other rows match the plain version."""
    gen = card()
    bf16 = torch.bfloat16
    q = torch.randn(4, 200, hd, generator=gen, device="cuda").to(bf16)
    k, v = (torch.randn(2, 200, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k[..., 0] = k[..., 0].abs() + 0.5
    q[1, 150] = 0.0
    q[1, 150, 0] = -float("inf")
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, True)
    assert fa.variant_counts()["flash_fwd"] == {"wgmma": 1, "tf32x3": 0}
    assert not o.isnan().any() and not lse.isnan().any()
    assert torch.equal(o[1, 150], torch.zeros(hd, device="cuda", dtype=bf16))
    assert lse[1, 150, 0].item() == -float("inf")
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, True)
    keep = torch.ones(4, 200, dtype=torch.bool, device="cuda")
    keep[1, 150] = False
    close(o[keep], o_ref[keep], bf16, "wgmma")
    close(lse[keep], lse_ref[keep], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 96, 80, 64, 32])
def test_tensor_core_dq_is_bitwise_deterministic(hd):
    """Each CTA of the tensor-core B2 owns its dQ rows and sums over the K
    tiles in one fixed order, without atomics: two launches at a ragged GQA
    shape (group 4, S 1000, causal) give dQ identical bit for bit."""
    gen = card()
    q, do = (torch.randn(8, 1000, hd, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, 1000, hd, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    fa.reset_launch_counts()
    first = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    second = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    assert fa.variant_counts()["flash_bwd_dq"] == {"wgmma": 2, "tf32x3": 0}
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_dq_row_without_probability_gives_zeros_not_nan(causal):
    """B2 at hd 80 and a ragged S of 77 (one 128-row tile, rows 77-127 past
    Sq): the kernel gives rows past Sq lse = +inf, so their p = exp(s - lse)
    is 0. A row inside Sq handed lse = +inf takes that same path: its dQ
    row is exactly zero, never NaN, and the other rows match the plain
    version."""
    gen = card()
    bf16 = torch.bfloat16
    q, do = (torch.randn(4, 77, 80, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k, v = (torch.randn(2, 77, 80, generator=gen, device="cuda").to(bf16) for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    lse[1, 40] = float("inf")
    fa.reset_launch_counts()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    assert fa.variant_counts()["flash_bwd_dq"] == {"wgmma": 1, "tf32x3": 0}
    assert not dq.isnan().any()
    assert torch.equal(dq[1, 40], torch.zeros(80, device="cuda", dtype=bf16))
    want = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    assert torch.equal(want[1, 40], torch.zeros(80, device="cuda", dtype=bf16))
    close(dq, want, bf16, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [*fa.HEAD_DIMS, 512])
@pytest.mark.parametrize("bh, bh_kv, s, causal", [(32, 32, 520, False), (8, 2, 200, False),
                                                  (8, 2, 333, True)])
def test_tf32x3_backward_matches_plain(hd, bh, bh_kv, s, causal, monkeypatch):
    """float32 B2 and B3 on the tensor cores (three TF32 products) at every
    head dim (and at 512, over two slices of 256 columns and in column
    parts), ragged S, MHA and GQA 4, causal and not, with the loops
    unsplit (BH 32, S 520: 288 CTAs each) and split (BH 8: 4-6 parts for
    B2, 16-22 for B3, summed by a second pass): within (1e-4, 1e-4) of the
    plain versions; the first launch's outputs head marker-filled buffers
    whose tails come back unchanged; a second launch gives the same bits;
    a row handed lse = +inf gets a dQ row of exact zeros, never NaN, and
    adds nothing to dK and dV."""
    gen = card()
    q, do = (torch.randn(bh, s, hd, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(bh_kv, s, hd, generator=gen, device="cuda") for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do * o).sum(-1, keepdim=True)
    lse[1, s // 2] = float("inf")
    splits = [fa.bwd_splits(n, bh, bh_kv, s, s, causal, hd)
              for n in ("flash_bwd_dq", "flash_bwd_dkv")]
    assert (splits == [1, 1]) == (bh == 32), splits
    guard, bufs = 4096, []
    fa.reset_launch_counts()
    monkeypatch.setattr(torch, "empty_like", guarded_empty_like(bufs, guard))
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    monkeypatch.undo()
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    assert len(bufs) == 3
    for buf, n in bufs:
        assert torch.equal(buf[n:], torch.full((guard,), 7.0, device="cuda"))
    assert {n: c for n, c in fa.variant_counts().items() if n != "flash_fwd"} == {
        n: {"wgmma": 0, "tf32x3": 2} for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    for got, second in zip((dq, dk, dv), again):
        assert torch.equal(got, second)
        assert not got.isnan().any()
    assert torch.equal(dq[1, s // 2], torch.zeros(hd, device="cuda"))
    close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal), torch.float32, "tf32x3")
    for got, want in zip((dk, dv), fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)):
        close(got, want, torch.float32, "tf32x3")


# (dtype, hd) of every tf32x3 forward instance: float32 at every head dim,
# bf16 at hd 16, and both above 256 (at 512)
TF32X3_FWD = [(torch.float32, hd) for hd in fa.HEAD_DIMS] + [
    (torch.bfloat16, 16), (torch.float32, 512), (torch.bfloat16, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, hd", TF32X3_FWD)
@pytest.mark.parametrize("bh, bh_kv, s, causal", [(32, 32, 520, False), (8, 2, 200, False),
                                                  (8, 2, 333, True)])
def test_tf32x3_forward_matches_plain(dtype, hd, bh, bh_kv, s, causal, monkeypatch):
    """B1 on the tensor cores as three-product TF32 (bf16 at hd 16: one
    product for S, two for P V) at every float32 head dim, at bf16 hd 16,
    and at 512 in both (O's columns in two parts, S over two slices),
    ragged S, MHA and GQA 4, causal and not: O within the tf32x3
    tolerance of the plain version, lse within 1e-4; the first launch's O
    heads a marker-filled buffer whose tail comes back unchanged; a second
    launch gives the same bits."""
    gen = card()
    q = torch.randn(bh, s, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(bh_kv, s, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    bufs = []
    fa.reset_launch_counts()
    monkeypatch.setattr(torch, "empty_like", guarded_empty_like(bufs))
    o, lse = fa.flash_fwd(q, k, v, causal)
    monkeypatch.undo()
    again = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert len(bufs) == 1
    assert torch.equal(bufs[0][0][bufs[0][1]:], torch.full((4096,), 7.0, device="cuda",
                                                           dtype=dtype))
    assert fa.variant_counts()["flash_fwd"] == {"wgmma": 0, "tf32x3": 2}
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    close(o, o_ref, dtype, "tf32x3")
    close(lse, lse_ref, torch.float32, "tf32x3")


@pytest.mark.cuda
@pytest.mark.parametrize("bh, bh_kv, s, causal", [(32, 32, 520, False), (8, 2, 200, False),
                                                  (8, 2, 333, True), (16, 2, 2048, True),
                                                  (8, 1, 40, True)])
def test_wgmma_bf16_hd256_forward_matches_plain(bh, bh_kv, s, causal, monkeypatch):
    """bf16 B1 at hd 256 on the warp-specialised wgmma kernel (two consumer
    warpgroups of 64 q rows, 64-key K and V tiles, the softmax under the
    products), ragged S, S under one tile, MHA, GQA 4 and 8, causal and
    not: O within (2**-8, 2**-7) of the plain version, lse within 2e-3; the
    first launch's O heads a marker-filled buffer whose tail comes back
    unchanged; a second launch gives the same bits; both count on wgmma."""
    gen = card()
    bf16 = torch.bfloat16
    q = torch.randn(bh, s, 256, generator=gen, device="cuda").to(bf16)
    k, v = (torch.randn(bh_kv, s, 256, generator=gen, device="cuda").to(bf16) for _ in range(2))
    bufs = []
    fa.reset_launch_counts()
    monkeypatch.setattr(torch, "empty_like", guarded_empty_like(bufs))
    o, lse = fa.flash_fwd(q, k, v, causal)
    monkeypatch.undo()
    again = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert len(bufs) == 1
    assert torch.equal(bufs[0][0][bufs[0][1]:], torch.full((4096,), 7.0, device="cuda",
                                                           dtype=bf16))
    assert fa.variant_counts()["flash_fwd"] == {"wgmma": 2, "tf32x3": 0}
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    close(o, o_ref, bf16, "wgmma")
    close(lse, lse_ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, hd", TF32X3_FWD)
def test_tf32x3_forward_fully_masked_row_gives_zeros_not_nan(dtype, hd):
    """A query row whose every score is -inf (its first column -inf, the
    rest 0, every key's first column positive and, in float32, with a
    positive lo part, so that no product term is -inf times 0) keeps
    m = -inf in the tf32x3 B1: its O row is zeros and its lse -inf, never
    NaN, and the other rows match the plain version."""
    gen = card()
    q = torch.randn(4, 200, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(2, 200, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k[..., 0] = 1.0 + 2.0 ** -12 if dtype == torch.float32 else k[..., 0].abs() + 0.5
    q[1, 150] = 0.0
    q[1, 150, 0] = -float("inf")
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, True)
    assert fa.variant_counts()["flash_fwd"] == {"wgmma": 0, "tf32x3": 1}
    assert not o.isnan().any() and not lse.isnan().any()
    assert torch.equal(o[1, 150], torch.zeros(hd, device="cuda", dtype=dtype))
    assert lse[1, 150, 0].item() == -float("inf")
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, True)
    keep = torch.ones(4, 200, dtype=torch.bool, device="cuda")
    keep[1, 150] = False
    close(o[keep], o_ref[keep], dtype, "tf32x3")
    close(lse[keep], lse_ref[keep], torch.float32, "tf32x3")


@pytest.mark.cuda
@pytest.mark.parametrize("bh, bh_kv, s, causal", [(32, 32, 520, False), (8, 2, 200, False),
                                                  (8, 2, 333, True)])
def test_tf32x3_bf16_hd16_backward_matches_plain(bh, bh_kv, s, causal, monkeypatch):
    """bf16 B2 and B3 at hd 16 on the tf32x3 kernels (one product for
    S and dP, two for dS K, P^T dO and dS^T Q), unsplit and split: within
    (2e-3, 2**-7) of the plain versions; outputs inside their tensors; a
    second launch gives the same bits."""
    bf16_backward_matches_plain(16, bh, bh_kv, s, causal, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("bh, bh_kv, s, causal", [(32, 32, 520, False), (8, 2, 200, False),
                                                  (8, 1, 333, True)])
def test_wgmma_bf16_hd256_backward_matches_plain(bh, bh_kv, s, causal, monkeypatch):
    """bf16 B2 and B3 at hd 256 on the wgmma kernels (B2: one consumer
    warpgroup of 64 q rows a CTA, m64n256 dQ += dS K; B3: two CTAs a key
    tile, each owning 128 of dK's and dV's columns), MHA, GQA 4 and GQA 8,
    a ragged S, causal and not: within (2**-8, 2**-7) of the plain
    versions; outputs inside their tensors; a second launch gives the same
    bits."""
    bf16_backward_matches_plain(256, bh, bh_kv, s, causal, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("bh, bh_kv, s, causal", [(8, 2, 200, False), (4, 1, 333, True)])
def test_tf32x3_bf16_hd512_backward_matches_plain(bh, bh_kv, s, causal, monkeypatch):
    """bf16 B2 and B3 at hd 512 on the tf32x3 kernels that sum their first
    products over two slices of 256 columns (dQ in two parts of 256
    columns, dK and dV in four of 128), split: as at hd 16."""
    bf16_backward_matches_plain(512, bh, bh_kv, s, causal, monkeypatch)


def bf16_backward_matches_plain(hd, bh, bh_kv, s, causal, monkeypatch):
    gen = card()
    bf16 = torch.bfloat16
    q, do = (torch.randn(bh, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k, v = (torch.randn(bh_kv, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    bufs = []
    fa.reset_launch_counts()
    monkeypatch.setattr(torch, "empty_like", guarded_empty_like(bufs))
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    monkeypatch.undo()
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    assert len(bufs) == 3
    for buf, n in bufs:
        assert torch.equal(buf[n:], torch.full((4096,), 7.0, device="cuda", dtype=bf16))
    variant = {n: fa.route(n, bf16, hd) for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    assert {n: c for n, c in fa.variant_counts().items() if n != "flash_fwd"} == {
        n: {v: 2 * (v == variant[n]) for v in fa.VARIANTS} for n in variant}
    for got, second in zip((dq, dk, dv), again):
        assert torch.equal(got, second)
    close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal), bf16,
          variant["flash_bwd_dq"])
    for got, want in zip((dk, dv), fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)):
        close(got, want, bf16, variant["flash_bwd_dkv"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd, width", [(48, 64), (8, 16), (112, 128), (136, 256), (320, 512)])
def test_padded_head_dim_matches_plain_at_its_own_width(dtype, hd, width):
    """A head dim outside HEAD_DIMS (ROADMAP C3) runs through the kernels
    zero-padded to the next one: the dispatcher's output and dQ, dK, dV on
    the card have hd columns and match the plain versions at the true head
    dim (within the padded route's tolerance; the backward's on the
    kernel's own lse and delta, as autograd hands them over), and the
    launches are counted at the padded width."""
    gen = card()
    b, s, h, hkv = 2, 150, 4, 2
    q, ct = (torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launch_counts()
    fa.reset_shape_counts()
    out = flash_attention(*leaves, causal=True)
    out.backward(ct)
    assert out.shape == q.shape and all(x.grad.shape == x.shape for x in leaves)
    assert set(fa.shape_counts()["flash_fwd"]) == {
        fa.shape_key(dtype, b * h, b * hkv, s, s, width, True)}

    def flat(x):
        return x.transpose(1, 2).reshape(-1, s, hd).contiguous()

    qf, kf, vf, dof = map(flat, (q, k, v, ct))
    padded = (torch.nn.functional.pad(x, (0, width - hd)) for x in (qf, kf, vf))
    o_pad, lse = fa.flash_fwd(*padded, True, hd ** -0.5)
    delta = (dof.float() * o_pad[..., :hd].float()).sum(-1, keepdim=True)
    want = (fa.flash_fwd_plain(qf, kf, vf, True)[0],
            fa.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, True),
            *fa.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, True))
    variant = [fa.route(name, dtype, width) for name in fa.KERNEL_NAMES]
    for got, ref, v in zip((out, *(x.grad for x in leaves)), want, (*variant, variant[2])):
        close(flat(got), ref, dtype, v)


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
    q = torch.zeros(4, 64, 40, device="cuda")  # hd 40 is not instantiated
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, True)
    # a storage offset off the 16-byte grid: raised, never routed elsewhere
    x = torch.zeros(4 * 64 * 128 + 1, device="cuda", dtype=torch.bfloat16)[1:]
    q = x.view(4, 64, 128)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(q, q, q, True)
    assert fa.launch_counts()["flash_fwd"] == 0


SMALL = LlamaConfig(vocab_size=384, hidden_size=256, intermediate_size=512,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                    attention_impl="flash", remat=True, loss_chunk=128)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """One round on the card, saved, restored into a fresh state on the
    card: every leaf, AdamW's moments and step counts and the outer
    momentum come back bit for bit."""
    gen = card()
    dl = Diloco(SMALL, DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=1,
                                    total_steps=4, lr=1e-3, grad_accum=2), device="cuda")
    state = dl.init_state(gen)
    toks = torch.randint(0, SMALL.vocab_size, (2, 2, 2, 1, 200), generator=gen,
                         device="cuda")
    dl.round_step(state, toks, torch.ones_like(toks))
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(2, state)
    fresh = ck.restore(dl.init_state(torch.Generator(device="cuda").manual_seed(1)))
    for a, b in zip(tree_leaves(fresh.params) + tree_leaves(fresh.snapshot),
                    tree_leaves(state.params) + tree_leaves(state.snapshot)):
        assert a.is_cuda and torch.equal(a, b)
    for pa, pb in zip(tree_leaves(fresh.params), tree_leaves(state.params)):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fresh.inner_opt.state[pa][k], state.inner_opt.state[pb][k])
    for ma, mb in zip(tree_leaves(fresh.outer_opt_state), tree_leaves(state.outer_opt_state)):
        assert torch.equal(ma, mb)
    assert fresh.inner_step_count == 2


@pytest.mark.cuda
def test_evaluator_on_the_card_matches_the_cpu():
    """The snapshot's held-out loss through B1 on the card against the
    plain versions on the CPU, float32 with TF32 off: the two differ in
    summation order only, 1e-3 relative bounds it."""
    card()
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(torch.Generator().manual_seed(0), SMALL, device="cpu")
    rows = torch.randint(0, SMALL.vocab_size, (6, 200),
                         generator=torch.Generator().manual_seed(1)).numpy()
    batches = holdout_batches(rows, 2)
    fa.reset_launch_counts()
    got = Evaluator(SMALL, "cuda")(tree_map(lambda p: p.cuda(), params), batches)
    assert fa.launch_counts() == {"flash_fwd": 3 * SMALL.num_hidden_layers,
                                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    want = Evaluator(SMALL, "cpu")(params, batches)
    assert got["eval_tokens"] == want["eval_tokens"]
    assert abs(got["eval_loss"] - want["eval_loss"]) <= 1e-3 * want["eval_loss"]


@pytest.mark.cuda
def test_generate_and_engine_on_the_card_match_the_cpu():
    """Greedy generate() on the card against the CPU from one parameter
    tree, float32 with TF32 off: identical tokens. The weights are drawn
    at std 0.2 so that the logits' top-2 gaps (~1e-1) dwarf the summation
    order's ~1e-6: a near-tie cannot flip a token here. The engine on the
    card (2 slots, chunk 8) serves a greedy and a sampled request, each
    token-identical to the card's solo generate() with its seed."""
    from nanodiloco_tpu_torch.models.generate import generate, noise_uniforms
    from nanodiloco_tpu_torch.serve import GenRequest, InferenceEngine, Scheduler

    card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=384, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      initializer_range=0.2)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.randint(0, 384, (2, 11), generator=torch.Generator().manual_seed(1))
    cpu = generate(params, prompt, cfg, 16, device="cpu")
    gpu = generate(params, prompt, cfg, 16, device="cuda")
    assert torch.equal(gpu.cpu(), cpu)
    assert torch.equal(noise_uniforms([3, 4], [0, 0], [0, 5], 384, "cuda").cpu(),
                       noise_uniforms([3, 4], [0, 0], [0, 5], 384, "cpu"))
    eng = InferenceEngine(params, cfg, num_slots=2, max_len=64, chunk_size=8)
    sched = Scheduler(eng)
    reqs = [GenRequest(prompt=tuple(prompt[0].tolist()), max_new_tokens=12, seed=0),
            GenRequest(prompt=tuple(prompt[1].tolist()), max_new_tokens=12, temperature=0.9,
                       top_k=50, seed=5)]
    tickets = [sched.submit(r) for r in reqs]
    for _ in range(200):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            break
    for ticket, req in zip(tickets, reqs):
        want = generate(params, [list(req.prompt)], cfg, 12, temperature=req.temperature,
                        top_k=req.top_k, seed=req.seed, device="cuda")[0].tolist()
        assert ticket.result["tokens"] == want


@pytest.mark.cuda
def test_offload_snapshot_on_the_card_matches_device_resident():
    """With offload_snapshot the snapshot waits in pinned host memory
    between syncs and comes back to the card for each outer step: three
    rounds equal the device-resident run bit for bit."""
    card()
    tiny = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=32)
    params = init_params(torch.Generator().manual_seed(0), tiny, device="cpu")
    tok = torch.randint(0, tiny.vocab_size, (2, 2, 1, 2, 16),
                        generator=torch.Generator().manual_seed(1))
    runs = []
    for offload in (False, True):
        dl = Diloco(tiny, DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=2,
                                       total_steps=50, lr=1e-3, offload_snapshot=offload),
                    device="cuda")
        state = dl.init_state(params=params)
        losses = [dl.round_step(state, tok, torch.ones_like(tok))[1] for _ in range(3)]
        leaf = tree_leaves(state.snapshot)[0]
        assert (leaf.device.type == "cpu" and leaf.is_pinned()) == offload
        runs.append((torch.stack(losses).cpu(), [t.cpu() for t in tree_leaves(state.snapshot)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

