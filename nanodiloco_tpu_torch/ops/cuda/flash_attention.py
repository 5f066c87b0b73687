"""Flash attention on Hopper: hand-written CUDA kernels behind one
``torch.autograd.Function``.

Port of ``nanodiloco_tpu/ops/pallas/flash_attention.py``:

==  ==========================  ==============================================
B1  ``flash_fwd``               replaces ``_fwd_call`` / ``_fwd_kernel``
B2  ``flash_bwd_dq``            replaces ``_flash_bwd`` / ``_bwd_dq_kernel``
B3  ``flash_bwd_dkv``           replaces ``_flash_bwd`` / ``_bwd_dkv_kernel``
==  ==========================  ==============================================

Each kernel comes in up to two variants, and ``ROUTES`` names the one
that serves each (kernel, dtype, head dim):

- ``wgmma``: tensor-core kernels for bf16 at hd 128 (B1, B2, B3), wgmma
  fed by TMA (``nanodiloco_tpu_torch/csrc/flash_attention_tc.cu``);
- ``fma``: float32 FMA kernels from shared memory for every other case
  (``nanodiloco_tpu_torch/csrc/flash_attention.cu``). wgmma has no
  float32 path, and TF32 would not hold the float32 tolerance.

Each wrapper takes the TPU kernels' layout (q ``[BH, Sq, hd]``, k and v
``[BH / group, Sk, hd]``, lse and delta ``[BH, Sq, 1]`` float32). On a
CUDA tensor it launches the routed kernel, adds one to its ``launches``
count and to its variant's count, and raises if the launch fails; on a
CPU tensor it runs its plain version (same decomposition: forward
returns (O, lse); dQ and dK/dV are recomputed from lse and delta). There
is no other path and no fallback from one variant to another.

What bounds them on the H100: at the training shape (hd 128, S 2048,
causal) every kernel does 2-4 S x S x hd products per head on O(S x hd)
bytes, so operations bound all three (see the notes at the top of the
CUDA sources for the designs).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nanodiloco_tpu_torch.ops.cuda import build
from nanodiloco_tpu_torch.ops.online_softmax import NEG_INF, block_update

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
VARIANTS = ("fma", "wgmma")
# the variant that serves each (kernel, dtype, head dim): tensor cores for
# bf16 at hd 128, the FMA kernels everywhere else
ROUTES = {
    (name, dtype, hd): "wgmma" if (dtype, hd) == (torch.bfloat16, 128) else "fma"
    for name in KERNEL_NAMES for dtype in _DTYPE_CODE for hd in HEAD_DIMS
}
_MAX_GRID_Y = 65535
# K/V rows per step of the plain versions (their memory is O(S x block))
PLAIN_BLOCK = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nd_flash_fwd.argtypes = [I, I] + [P] * 5 + [I] * 5 + [F, P]
    lib.nd_flash_bwd_dq.argtypes = [I, I] + [P] * 7 + [I] * 5 + [F, P]
    lib.nd_flash_bwd_dkv.argtypes = [I, I] + [P] * 8 + [I] * 5 + [F, P]
    for fn in (lib.nd_flash_fwd, lib.nd_flash_bwd_dq, lib.nd_flash_bwd_dkv):
        fn.restype = I
    lib.nd_error_string.argtypes = [I]
    lib.nd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _tc_lib() -> ctypes.CDLL:
    lib = build.library("flash_attention_tc")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nd_flash_fwd_tc.argtypes = [I] + [P] * 5 + [I] * 5 + [F, P]
    lib.nd_flash_bwd_dq_tc.argtypes = [I] + [P] * 7 + [I] * 5 + [F, P]
    lib.nd_flash_bwd_dkv_tc.argtypes = [I] + [P] * 8 + [I] * 5 + [F, P]
    for fn in (lib.nd_flash_fwd_tc, lib.nd_flash_bwd_dq_tc, lib.nd_flash_bwd_dkv_tc):
        fn.restype = I
    lib.nd_tc_error_string.argtypes = [I]
    lib.nd_tc_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, name: str, variant: str = "fma") -> None:
    if rc != 0:
        if variant == "wgmma":
            msg = _tc_lib().nd_tc_error_string(rc).decode()
        else:
            msg = _lib().nd_error_string(rc).decode()
        raise RuntimeError(f"{name} ({variant}) kernel launch failed ({rc}): {msg}")


def _counted(fn, variant: str) -> None:
    fn.launches += 1
    fn.variant_launches[variant] += 1


def _check(name: str, q, k, v, *same_as_q, stats=()) -> None:
    """Raise on anything the kernels do not take."""
    tensors = (q, k, v, *same_as_q, *stats)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if any(t.dtype != q.dtype for t in (k, v, *same_as_q)):
        raise ValueError(f"{name}: q, k, v (and dO) must share one dtype")
    if any(t.dtype != torch.float32 for t in stats):
        raise ValueError(f"{name}: lse and delta must be float32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        # TMA reads from 16-byte aligned addresses only
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(
            f"{name}: want q [BH, Sq, hd], k = v [BH/group, Sk, hd]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, sq, hd = q.shape
    if k.shape[2] != hd or k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"{name}: k heads {k.shape[0]} must divide q heads {bh}, same hd")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.shape != q.shape for t in same_as_q):
        raise ValueError(f"{name}: dO must have q's shape")
    if any(t.shape != (bh, sq, 1) for t in stats):
        raise ValueError(f"{name}: lse and delta must be [BH, Sq, 1]")
    if sq == 0 or k.shape[1] == 0 or -(-max(sq, k.shape[1]) // 64) > _MAX_GRID_Y:
        raise ValueError(f"{name}: sequence lengths {sq}, {k.shape[1]} out of range")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# Plain versions (GQA folded into the row axis: [Bkv, G*Sq, hd], row
# g * Sq + position, so K/V are never expanded)
# ---------------------------------------------------------------------------

def _folded(q: torch.Tensor, bkv: int) -> tuple[torch.Tensor, torch.Tensor]:
    bh, sq, hd = q.shape
    g = bh // bkv
    pos = torch.arange(sq, device=q.device).repeat(g)  # [G*Sq]
    return q.reshape(bkv, g * sq, hd).float(), pos


def _scores(qf, kj, qpos, j0, causal, scale):
    """S * scale for K rows [j0, j0 + kj.shape[1]), masked to -inf."""
    s = torch.matmul(qf, kj.transpose(1, 2)) * scale
    if causal:
        kpos = torch.arange(j0, j0 + kj.shape[1], device=s.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    return s


def _probs(qf, kj, lse, qpos, j0, causal, scale):
    """P = exp(S * scale - lse), recomputed from the saved lse."""
    s = _scores(qf, kj, qpos, j0, causal, scale)
    return torch.where(
        torch.isfinite(s), torch.exp(s - lse[..., None]), torch.zeros_like(s)
    )


def flash_fwd_plain(q, k, v, causal: bool):
    """(O [BH, Sq, hd] in q's dtype, lse [BH, Sq, 1] float32), blockwise
    over K with the online-softmax recurrence."""
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
    qf, qpos = _folded(q, bkv)
    o = torch.zeros_like(qf)
    l = torch.zeros(qf.shape[:2], device=q.device)
    m = torch.full(qf.shape[:2], NEG_INF, device=q.device)
    for j0 in range(0, sk, PLAIN_BLOCK):
        s = _scores(qf, k[:, j0:j0 + PLAIN_BLOCK].float(), qpos, j0, causal, scale)
        o, l, m = block_update(o, l, m, s, v[:, j0:j0 + PLAIN_BLOCK].float())
    out = o / l.clamp_min(1e-30)[..., None]
    lse = torch.where(
        l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, NEG_INF)
    )
    return out.reshape(bh, sq, hd).to(q.dtype), lse.reshape(bh, sq, 1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool):
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
    qf, qpos = _folded(q, bkv)
    dof, _ = _folded(do, bkv)
    lse_f = lse.reshape(bkv, -1)
    delta_f = delta.reshape(bkv, -1)
    dq = torch.zeros_like(qf)
    for j0 in range(0, sk, PLAIN_BLOCK):
        kj = k[:, j0:j0 + PLAIN_BLOCK].float()
        p = _probs(qf, kj, lse_f, qpos, j0, causal, scale)
        dp = torch.matmul(dof, v[:, j0:j0 + PLAIN_BLOCK].float().transpose(1, 2))
        dq += torch.matmul(p * (dp - delta_f[..., None]), kj)
    return (dq * scale).reshape(bh, sq, hd).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool):
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
    qf, qpos = _folded(q, bkv)
    dof, _ = _folded(do, bkv)
    lse_f = lse.reshape(bkv, -1)
    delta_f = delta.reshape(bkv, -1)
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    for j0 in range(0, sk, PLAIN_BLOCK):
        kj = k[:, j0:j0 + PLAIN_BLOCK].float()
        p = _probs(qf, kj, lse_f, qpos, j0, causal, scale)
        dp = torch.matmul(dof, v[:, j0:j0 + PLAIN_BLOCK].float().transpose(1, 2))
        ds = p * (dp - delta_f[..., None])
        dv[:, j0:j0 + PLAIN_BLOCK] = torch.matmul(p.transpose(1, 2), dof)
        dk[:, j0:j0 + PLAIN_BLOCK] = torch.matmul(ds.transpose(1, 2), qf) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, causal: bool):
    """B1. Returns (O like q, lse [BH, Sq, 1] float32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    _check("flash_fwd", q, k, v)
    bh, sq, hd = q.shape
    variant = ROUTES["flash_fwd", q.dtype, hd]
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), device=q.device, dtype=torch.float32)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    shape = (bh, bh // k.shape[0], sq, k.shape[1], int(causal), 1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        if variant == "wgmma":
            rc = _tc_lib().nd_flash_fwd_tc(hd, *ptrs, *shape, _stream(q))
        else:
            rc = _lib().nd_flash_fwd(_DTYPE_CODE[q.dtype], hd, *ptrs, *shape, _stream(q))
    _raise_on(rc, "flash_fwd", variant)
    _counted(flash_fwd, variant)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """B2. Returns dQ like q."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    _check("flash_bwd_dq", q, k, v, do, stats=(lse, delta))
    bh, sq, hd = q.shape
    variant = ROUTES["flash_bwd_dq", q.dtype, hd]
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr())
    shape = (bh, bh // k.shape[0], sq, k.shape[1], int(causal), 1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        if variant == "wgmma":
            rc = _tc_lib().nd_flash_bwd_dq_tc(hd, *ptrs, *shape, _stream(q))
        else:
            rc = _lib().nd_flash_bwd_dq(_DTYPE_CODE[q.dtype], hd, *ptrs, *shape, _stream(q))
    _raise_on(rc, "flash_bwd_dq", variant)
    _counted(flash_bwd_dq, variant)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """B3. Returns (dK like k, dV like v), summed over each KV head's
    group of query heads."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    _check("flash_bwd_dkv", q, k, v, do, stats=(lse, delta))
    bh, sq, hd = q.shape
    variant = ROUTES["flash_bwd_dkv", q.dtype, hd]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (bh, bh // k.shape[0], sq, k.shape[1], int(causal), 1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        if variant == "wgmma":
            rc = _tc_lib().nd_flash_bwd_dkv_tc(hd, *ptrs, *shape, _stream(q))
        else:
            rc = _lib().nd_flash_bwd_dkv(_DTYPE_CODE[q.dtype], hd, *ptrs, *shape, _stream(q))
    _raise_on(rc, "flash_bwd_dkv", variant)
    _counted(flash_bwd_dkv, variant)
    return dk, dv


KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    """Zero both counts: ``launch_counts`` and ``variant_counts``."""
    for fn in KERNELS:
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(VARIANTS, 0)


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def variant_counts() -> dict[str, dict[str, int]]:
    """Launches of each kernel by variant, e.g.
    ``{"flash_fwd": {"fma": 0, "wgmma": 4}, ...}``."""
    return {fn.__name__: dict(fn.variant_launches) for fn in KERNELS}


class FlashAttention(torch.autograd.Function):
    """Replaces ``_flash`` / ``_flash_fwd`` / ``_flash_bwd`` (the custom
    VJP): forward launches B1; backward computes ``delta = rowsum(dO * O)``
    in float32 (outside any kernel, as the JAX package does) and launches
    B2 and B3. Inputs are ``[BH, S, hd]`` / ``[BH/group, S, hd]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def cuda_flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, S, Hkv, hd]`` with H % Hkv == 0
    (GQA, never expanded). Differentiable. The port of
    ``pallas_flash_attention``: same public layout."""
    b, s, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} must divide by kv heads {hkv}")

    def flat(x, sl, nh):
        return x.permute(0, 2, 1, 3).reshape(b * nh, sl, hd).contiguous()

    out = FlashAttention.apply(flat(q, s, h), flat(k, sk, hkv), flat(v, sk, hkv), causal)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)
