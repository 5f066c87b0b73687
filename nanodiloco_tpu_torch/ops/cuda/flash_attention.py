"""Flash attention on Hopper: hand-written CUDA kernels behind one
``torch.autograd.Function``.

Port of ``nanodiloco_tpu/ops/pallas/flash_attention.py``:

==  ==========================  ==============================================
B1  ``flash_fwd``               replaces ``_fwd_call`` / ``_fwd_kernel``
B2  ``flash_bwd_dq``            replaces ``_flash_bwd`` / ``_bwd_dq_kernel``
B3  ``flash_bwd_dkv``           replaces ``_flash_bwd`` / ``_bwd_dkv_kernel``
==  ==========================  ==============================================

Each kernel comes in two variants, both on the tensor cores, and
``route`` names the one that serves each (kernel, dtype, head dim). The
kernels take head dims 16, 32, 64, 80, 96, 128 and 256 (``HEAD_DIMS``)
and every multiple of 256 above it (``takes``); any other raises here,
and ``cuda_flash_attention`` pads it up to ``width(hd)``. ``ROUTES`` is
``route`` at every row of ``HEAD_DIMS``.

- ``wgmma``: wgmma fed by TMA
  (``nanodiloco_tpu_torch/csrc/flash_attention_tc.cu``), for bf16: all
  three kernels at hd 256, 128, 96, 80, 64 and 32 (hd 80 in the hd-96
  tile, its last 16 columns zeros; at hd 256 B1 is a warp-specialised
  kernel whose softmax runs under the products, B2 has one consumer
  warpgroup a CTA, and B3 two CTAs a key tile that split dK's and dV's
  columns: the source note);
- ``tf32x3``: three-product TF32 with mma.sync
  (``nanodiloco_tpu_torch/csrc/flash_attention_tf32_{fwd,dq,dkv}.cu`` on
  ``flash_attention_tf32.cuh``), for all three kernels in float32 at every
  head dim, in bf16 at hd 16, and both dtypes above 256. One TF32
  product keeps 10 mantissa bits and would not hold the float32
  tolerance; hi·hi + hi·lo + lo·hi of each operand's split keeps about
  2^-22. A bf16 value is exact in TF32 (lo = 0), so the bf16 instances
  take one product where both operands are inputs and two where one is P
  or dS: the three-product result on the inputs cast to float32, bit for
  bit. wgmma's tf32 takes K-major operands only, where O, dV, dK and dQ
  read V, dO, Q and K along their rows. The backward splits its loop into
  ``bwd_splits`` parts (CTAs) so that small shapes fill the card, and a
  second pass sums the parts in a fixed order (no atomics); the forward
  is one launch, unsplit (the header's note says why). From hd 256 every
  tile is split (or widened, bf16) as it is read and the streamed tiles
  have 32 rows (``stream_rows``); B3 splits dK's and dV's columns between
  CTAs of 128 (``col_parts``), so that each kernel's shared memory stays
  near 200 KB and its accumulators at 128 registers a thread. Above 256
  (hd = 256 n) B1 and B2 split their output columns too, 256 a CTA, and
  every kernel sums its first products over n slices of 256 columns
  loaded one after another into the hd-256 tiles: n passes over S for B1
  and B2, 2n for B3. No model has those head dims; they are exact, not
  fast.

Each wrapper takes the TPU kernels' layout (q ``[BH, Sq, hd]``, k and v
``[BH / group, Sk, hd]``, lse and delta ``[BH, Sq, 1]`` float32). On a
CUDA tensor it launches the routed kernel, adds one to its ``launches``
count and to its variant's and its shape's counts, and raises if the
launch fails; on a CPU tensor it runs its plain version (same
decomposition: forward returns (O, lse); dQ and dK/dV are recomputed from
lse and delta). There is no other path and no fallback from one variant
to another.

What bounds them on the H100: at the training shape (hd 128, S 2048,
causal) and at moe-8x-top2's (hd 64, S 1024) every kernel does 2-4
S x S x hd products per head on O(S x hd) bytes, so operations bound all
three (see the notes at the top of the CUDA sources for the designs).
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from nanodiloco_tpu_torch.ops.cuda import build
from nanodiloco_tpu_torch.ops.online_softmax import NEG_INF, block_update

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
VARIANTS = ("wgmma", "tf32x3")
# the head dims the wgmma kernels take, in bf16 only: all three kernels
_TENSOR_CORE_HEAD_DIMS = (32, 64, 80, 96, 128, 256)


def takes(hd: int) -> bool:
    """Whether the kernels take head dim ``hd``: one of HEAD_DIMS, or a
    multiple of 256 above it."""
    return hd in HEAD_DIMS or (hd > HEAD_DIMS[-1] and hd % 256 == 0)


def width(hd: int) -> int:
    """The head dim ``cuda_flash_attention`` runs ``hd`` at: the next of
    HEAD_DIMS, above 256 the next multiple of 256."""
    return next((d for d in HEAD_DIMS if d >= hd), -(-hd // 256) * 256)


def route(name: str, dtype, hd: int) -> str:
    """The variant that serves kernel ``name`` at (dtype, hd): wgmma for
    bf16 where it takes the head dim (32 to 256), three-product TF32 for
    the rest (every float32 row, bf16 at hd 16, and every head dim above
    256). All three kernels share the route."""
    if dtype == torch.bfloat16 and hd in _TENSOR_CORE_HEAD_DIMS:
        return "wgmma"
    return "tf32x3"


# route() at every (kernel, dtype, head dim) of HEAD_DIMS: the table that
# chip_smoke.py and the tests cover row by row
ROUTES = {(name, dtype, hd): route(name, dtype, hd)
          for name in KERNEL_NAMES for dtype in _DTYPE_CODE for hd in HEAD_DIMS}
# the H100's SMs: one wave of the tf32x3 kernels at one CTA an SM
SMS = 132
_MAX_GRID_Y = 65535


def stream_rows(hd: int) -> int:
    """Rows of a tf32x3 kernel's streamed tile at head dim ``hd`` (B1, B2:
    K and V; B3: Q and dO; the stationary tiles have 64): 32 from hd 256
    (Layout in flash_attention_tf32.cuh). This and ``col_parts`` are a copy,
    so that the split rule runs on the CPU too: _tf32_lib holds them against
    each library's nd_tf32_geometry when it loads them."""
    return 32 if hd >= 256 else 64


def col_parts(name: str, hd: int) -> int:
    """CTAs that split a tf32x3 kernel's output columns at head dim ``hd``:
    B3 at 256 takes 128 columns a CTA, and above 256 B1 and B2 take 256 and
    B3 128 (each part computes its own S over every column)."""
    if hd < 256:
        return 1
    return hd // 128 if name == "flash_bwd_dkv" else hd // 256
# K/V rows per step of the plain versions (their memory is O(S x block))
PLAIN_BLOCK = 512


@functools.cache
def _tc_lib() -> ctypes.CDLL:
    lib = build.library("flash_attention_tc")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nd_flash_fwd_tc.argtypes = [I] + [P] * 5 + [I] * 5 + [F, P]
    lib.nd_flash_bwd_dq_tc.argtypes = [I] + [P] * 7 + [I] * 5 + [F, P]
    lib.nd_flash_bwd_dkv_tc.argtypes = [I] + [P] * 9 + [I] * 5 + [F, I, P]
    for fn in (lib.nd_flash_fwd_tc, lib.nd_flash_bwd_dq_tc, lib.nd_flash_bwd_dkv_tc):
        fn.restype = I
    lib.nd_tc_error_string.argtypes = [I]
    lib.nd_tc_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _tf32_lib() -> types.SimpleNamespace:
    """The tf32x3 launchers: one library per kernel (one source each, so
    that they build in parallel), and the error string they share."""
    fwd, dq, dkv = (build.library(f"flash_attention_tf32_{name}") for name in ("fwd", "dq", "dkv"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd.nd_flash_fwd_tf32.argtypes = [I, I] + [P] * 5 + [I] * 5 + [F, P]
    dq.nd_flash_bwd_dq_tf32.argtypes = [I, I] + [P] * 8 + [I] * 5 + [F, I, P]
    dkv.nd_flash_bwd_dkv_tf32.argtypes = [I, I] + [P] * 9 + [I] * 5 + [F, I, P]
    for fn in (fwd.nd_flash_fwd_tf32, dq.nd_flash_bwd_dq_tf32, dkv.nd_flash_bwd_dkv_tf32):
        fn.restype = I
    dkv.nd_tf32_error_string.argtypes = [I]
    dkv.nd_tf32_error_string.restype = ctypes.c_char_p
    for lib in (fwd, dq, dkv):
        _check_geometry(lib.nd_tf32_geometry)
    return types.SimpleNamespace(
        nd_flash_fwd_tf32=fwd.nd_flash_fwd_tf32, nd_flash_bwd_dq_tf32=dq.nd_flash_bwd_dq_tf32,
        nd_flash_bwd_dkv_tf32=dkv.nd_flash_bwd_dkv_tf32,
        nd_tf32_error_string=dkv.nd_tf32_error_string)


# head dims above 256 whose geometry _check_geometry holds against the libraries
_WIDE_CHECKED = (512, 768)


def _check_geometry(geometry) -> None:
    """Raise unless a tf32x3 library's tiles are ``stream_rows`` and
    ``col_parts`` for every kernel at every (dtype, head dim) it serves (of
    HEAD_DIMS, and the wide head dims of _WIDE_CHECKED)."""
    geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    geometry.restype = ctypes.c_int
    rows, parts = ctypes.c_int(), ctypes.c_int()
    for kernel, name in enumerate(KERNEL_NAMES):
        for dtype in _DTYPE_CODE:
            for hd in (*HEAD_DIMS, *_WIDE_CHECKED):
                if route(name, dtype, hd) != "tf32x3":
                    continue
                rc = geometry(kernel, _DTYPE_CODE[dtype], hd, ctypes.byref(rows),
                              ctypes.byref(parts))
                want = (stream_rows(hd), col_parts(name, hd))
                if rc != 0 or (rows.value, parts.value) != want:
                    raise RuntimeError(
                        f"tf32x3 tiles of {name} at ({dtype}, hd {hd}): the library has (rows, "
                        f"column parts) {(rows.value, parts.value)} (rc {rc}), stream_rows/"
                        f"col_parts say {want}")


def _raise_on(rc: int, name: str, variant: str) -> None:
    if rc != 0:
        if variant == "wgmma":
            msg = _tc_lib().nd_tc_error_string(rc).decode()
        else:
            msg = _tf32_lib().nd_tf32_error_string(rc).decode()
        raise RuntimeError(f"{name} ({variant}) kernel launch failed ({rc}): {msg}")


def _splits(ctas: int, pairs: int) -> int:
    """Parts to split each CTA's loop of ``pairs`` steps into, one CTA
    each: the fewest that give at least two waves of ``SMS`` CTAs, and
    never more parts than steps. It depends on the shape alone, so two
    launches sum in the same order."""
    return max(1, min(pairs, -(-2 * SMS // max(ctas, 1))))


def bwd_splits(name: str, bh: int, bh_kv: int, sq: int, sk: int, causal: bool,
               hd: int, variant: str = "tf32x3") -> int:
    """The split count of a launch of ``name`` (``flash_bwd_dq`` or
    ``flash_bwd_dkv``) at head dim ``hd`` on ``variant``. tf32x3: B2 has
    one CTA per (head, 64-row q tile, column part), looping over up to
    ``nk`` K tiles of ``stream_rows`` keys (under the causal mask, the last
    q tile's); B3 one per (KV head, 64-key tile, column part), looping over
    ``group x nq`` (query head, q tile) pairs. wgmma: only B3 at hd 256
    splits, with two column parts per (KV head, 64-key tile) and 64-row q
    tiles, and only a grid under one wave of its one CTA an SM: at
    Gemma-2B's shape (128 CTAs) three parts ran 1.42x faster than one, at
    train_hd256's (256) two ran 3% slower (PERF.md section 6); every other
    wgmma launch is one part."""
    if variant == "wgmma":
        ctas = 2 * bh_kv * -(-sk // 64)
        if name != "flash_bwd_dkv" or hd != 256 or ctas >= SMS:
            return 1
        return _splits(ctas, (bh // bh_kv) * -(-sq // 64))
    rows = stream_rows(hd)
    parts = col_parts(name, hd)
    if name == "flash_bwd_dq":
        nk = -(-sk // rows)
        return _splits(parts * bh * -(-sq // 64), min(nk, -(-sq // rows)) if causal else nk)
    return _splits(parts * bh_kv * -(-sk // 64), (bh // bh_kv) * -(-sq // rows))


def shape_key(dtype, bh: int, bh_kv: int, sq: int, sk: int, hd: int, causal: bool) -> str:
    """The key of one launch's shape in ``shape_counts``:
    ``"<dtype>/<BH>/<BH_kv>/<Sq>/<Sk>/<hd>/<causal 0|1>"``, for example
    ``"bfloat16/128/64/1024/1024/64/1"``."""
    return f"{str(dtype).removeprefix('torch.')}/{bh}/{bh_kv}/{sq}/{sk}/{hd}/{int(causal)}"


def parse_shape_key(key: str) -> tuple:
    """(dtype, BH, BH_kv, Sq, Sk, hd, causal) of a ``shape_key``."""
    dtype, *dims, causal = key.split("/")
    return (getattr(torch, dtype), *map(int, dims), causal == "1")


def _counted(fn, variant: str, q, k, causal: bool) -> None:
    fn.launches += 1
    fn.variant_launches[variant] += 1
    key = shape_key(q.dtype, q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2], causal)
    fn.shape_launches[key] = fn.shape_launches.get(key, 0) + 1


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
    if not takes(hd):
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS} nor a multiple of 256")
    if any(t.shape != q.shape for t in same_as_q):
        raise ValueError(f"{name}: dO must have q's shape")
    if any(t.shape != (bh, sq, 1) for t in stats):
        raise ValueError(f"{name}: lse and delta must be [BH, Sq, 1]")
    if sq == 0 or k.shape[1] == 0 or -(-max(sq, k.shape[1]) // 64) > _MAX_GRID_Y:
        raise ValueError(f"{name}: sequence lengths {sq}, {k.shape[1]} out of range")


def _stream(t: torch.Tensor) -> int:
    # the raw handle, without building a torch.cuda.Stream (current_stream)
    # on every launch: at small shapes a call's host time sets the pace
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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


def _scale(scale, hd: int) -> float:
    return 1.0 / math.sqrt(hd) if scale is None else scale


def flash_fwd_plain(q, k, v, causal: bool, scale=None):
    """(O [BH, Sq, hd] in q's dtype, lse [BH, Sq, 1] float32), blockwise
    over K with the online-softmax recurrence; scores times ``scale``
    (default 1/sqrt(hd))."""
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = _scale(scale, hd)
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


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale=None):
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = _scale(scale, hd)
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


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale=None):
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    scale = _scale(scale, hd)
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

def flash_fwd(q, k, v, causal: bool, scale=None):
    """B1. Returns (O like q, lse [BH, Sq, 1] float32); scores times
    ``scale`` (default 1/sqrt(hd))."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    _check("flash_fwd", q, k, v)
    bh, sq, hd = q.shape
    variant = route("flash_fwd", q.dtype, hd)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), device=q.device, dtype=torch.float32)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    shape = (bh, bh // k.shape[0], sq, k.shape[1], int(causal), _scale(scale, hd))
    with torch.cuda.device(q.device):
        if variant == "tf32x3":
            rc = _tf32_lib().nd_flash_fwd_tf32(_DTYPE_CODE[q.dtype], hd, *ptrs, *shape, _stream(q))
        else:
            rc = _tc_lib().nd_flash_fwd_tc(hd, *ptrs, *shape, _stream(q))
    _raise_on(rc, "flash_fwd", variant)
    _counted(flash_fwd, variant, q, k, causal)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale=None):
    """B2. Returns dQ like q."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check("flash_bwd_dq", q, k, v, do, stats=(lse, delta))
    bh, sq, hd = q.shape
    variant = route("flash_bwd_dq", q.dtype, hd)
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr())
    shape = (bh, bh // k.shape[0], sq, k.shape[1], int(causal), _scale(scale, hd))
    with torch.cuda.device(q.device):
        if variant == "tf32x3":
            splits = bwd_splits("flash_bwd_dq", bh, k.shape[0], sq, k.shape[1], causal, hd)
            ws = (torch.empty((splits, bh, sq, hd), device=q.device, dtype=torch.float32)
                  if splits > 1 else None)
            rc = _tf32_lib().nd_flash_bwd_dq_tf32(
                _DTYPE_CODE[q.dtype], hd, *ptrs, None if ws is None else ws.data_ptr(), *shape,
                splits, _stream(q))
        else:
            rc = _tc_lib().nd_flash_bwd_dq_tc(hd, *ptrs, *shape, _stream(q))
    _raise_on(rc, "flash_bwd_dq", variant)
    _counted(flash_bwd_dq, variant, q, k, causal)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale=None):
    """B3. Returns (dK like k, dV like v), summed over each KV head's
    group of query heads."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check("flash_bwd_dkv", q, k, v, do, stats=(lse, delta))
    bh, sq, hd = q.shape
    variant = route("flash_bwd_dkv", q.dtype, hd)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (bh, bh // k.shape[0], sq, k.shape[1], int(causal), _scale(scale, hd))
    bh_kv, sk = k.shape[:2]
    splits = bwd_splits("flash_bwd_dkv", bh, bh_kv, sq, sk, causal, hd, variant)
    ws = (torch.empty((splits, 2, bh_kv, sk, hd), device=q.device, dtype=torch.float32)
          if splits > 1 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    with torch.cuda.device(q.device):
        if variant == "tf32x3":
            rc = _tf32_lib().nd_flash_bwd_dkv_tf32(_DTYPE_CODE[q.dtype], hd, *ptrs, ws_ptr, *shape,
                                                   splits, _stream(q))
        else:
            rc = _tc_lib().nd_flash_bwd_dkv_tc(hd, *ptrs, ws_ptr, *shape, splits, _stream(q))
    _raise_on(rc, "flash_bwd_dkv", variant)
    _counted(flash_bwd_dkv, variant, q, k, causal)
    return dk, dv


KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    """Zero ``launch_counts`` and ``variant_counts`` (not ``shape_counts``)."""
    for fn in KERNELS:
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(VARIANTS, 0)


def reset_shape_counts() -> None:
    """Zero ``shape_counts``. It has a reset of its own so that a caller can
    total the shapes of a run whose parts reset the other counts."""
    for fn in KERNELS:
        fn.shape_launches = {}


reset_launch_counts()
reset_shape_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def variant_counts() -> dict[str, dict[str, int]]:
    """Launches of each kernel by variant, e.g.
    ``{"flash_fwd": {"wgmma": 4, "tf32x3": 0}, ...}``."""
    return {fn.__name__: dict(fn.variant_launches) for fn in KERNELS}


def shape_counts() -> dict[str, dict[str, int]]:
    """Launches of each kernel by shape (``shape_key``), e.g.
    ``{"flash_fwd": {"bfloat16/64/16/2048/2048/128/1": 4}, ...}``."""
    return {fn.__name__: dict(fn.shape_launches) for fn in KERNELS}


class FlashAttention(torch.autograd.Function):
    """Replaces ``_flash`` / ``_flash_fwd`` / ``_flash_bwd`` (the custom
    VJP): forward launches B1; backward computes ``delta = rowsum(dO * O)``
    in float32 (outside any kernel, as the JAX package does) and launches
    B2 and B3. Inputs are ``[BH, S, hd]`` / ``[BH/group, S, hd]``; scores
    are taken times ``scale``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def cuda_flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, S, Hkv, hd]`` with H % Hkv == 0
    (GQA, never expanded). Differentiable. The port of
    ``pallas_flash_attention``: same public layout, and any head dim, as
    the JAX dispatcher takes any head dim off the TPU: a head dim the
    kernels do not take is zero-padded to ``width(hd)`` in the copy to
    ``[BH, S, hd]`` (129-255 to 256, 257-511 to 512, ...), with the scale
    of the true head dim, and the output sliced back. Zero columns change
    no score and give zero output and gradient columns, so the result is
    exact."""
    b, s, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} must divide by kv heads {hkv}")
    padded = width(hd)

    def flat(x, sl, nh):
        x = x.permute(0, 2, 1, 3).reshape(b * nh, sl, hd)
        return torch.nn.functional.pad(x, (0, padded - hd)) if padded > hd else x.contiguous()

    out = FlashAttention.apply(flat(q, s, h), flat(k, sk, hkv), flat(v, sk, hkv), causal,
                               1.0 / math.sqrt(hd))
    return out[..., :hd].reshape(b, h, s, hd).permute(0, 2, 1, 3)
