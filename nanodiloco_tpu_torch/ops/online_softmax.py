"""Online-softmax (flash-attention) block recurrence in plain PyTorch.

Port of ``nanodiloco_tpu/ops/online_softmax.py``: the one place that
holds the ``-inf`` handling, shared by the plain attention versions. All
accumulators are float32. Shapes are ``[..., Sq, ...]`` with any leading
batch dimensions.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def block_update(
    o: torch.Tensor,       # [..., Sq, hd] float32 accumulator (un-normalized)
    l: torch.Tensor,       # [..., Sq] float32 softmax denominator
    m: torch.Tensor,       # [..., Sq] float32 running max (may be -inf)
    scores: torch.Tensor,  # [..., Sq, Sk] float32, masked entries at -inf
    v: torch.Tensor,       # [..., Sk, hd] value block
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block of the recurrence; returns (o, l, m_new).

    A row masked so far stays at m = -inf with l = 0 and o = 0, so the
    final ``o / max(l, eps)`` gives zeros, never NaN."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.where(
        torch.isfinite(scores),
        torch.exp(scores - m_safe[..., None]),
        torch.zeros_like(scores),
    )
    corr = torch.where(
        torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m)
    )
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.matmul(p.to(v.dtype), v).float()
    return o, l, m_new


def finalize_grouped(
    o: torch.Tensor, l: torch.Tensor, g: int, out_dtype: torch.dtype
) -> torch.Tensor:
    """GQA accumulators ``[B, Hkv, G*S, hd]`` (the G query heads of a KV
    group folded into the rows, position fastest) -> ``[B, S, H, hd]``
    with head order ``H = hkv * G + g``."""
    bsz, hkv, gs, hd = o.shape
    s = gs // g
    out = o / l.clamp_min(1e-30)[..., None]
    out = out.reshape(bsz, hkv, g, s, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(bsz, s, hkv * g, hd).to(out_dtype)
