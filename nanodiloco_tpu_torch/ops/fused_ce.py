"""Chunked softmax cross-entropy: the vocabulary projection and the loss
computed in row chunks so the full ``[N, V]`` logits never exist.

Port of ``nanodiloco_tpu/ops/fused_ce.py``. Each chunk runs under
``torch.utils.checkpoint``: the forward keeps only the chunk's scalar
loss, the backward recomputes the chunk's logits. Peak memory is
O(chunk x V) instead of O(N x V), for one extra head product in the
backward. The head product itself is a plain ``torch.matmul``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_loss(head, hx, tg, w):
    logits = torch.matmul(hx, head).float()               # [..., C, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tg[..., None])[..., 0]
    return (w * (lse - gold)).sum(dim=-1)


def chunked_softmax_xent(
    hidden: torch.Tensor,   # [..., N, d] compute-dtype rows (label-aligned)
    head: torch.Tensor,     # [..., d, V]
    targets: torch.Tensor,  # [..., N] int
    weights: torch.Tensor,  # [..., N] float (0 = ignore row)
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_loss, sum_weights) over the rows, float32, one per
    leading index. Rows are padded to a multiple of ``chunk`` with zero
    weight."""
    n = hidden.shape[-2]
    n_pad = (-n) % chunk
    weights = weights.float()
    if n_pad:
        hidden = F.pad(hidden, (0, 0, 0, n_pad))
        targets = F.pad(targets, (0, n_pad))
        weights = F.pad(weights, (0, n_pad))
    sum_loss = None
    for c0 in range(0, n + n_pad, chunk):
        part = checkpoint(
            _chunk_loss, head, hidden[..., c0:c0 + chunk, :],
            targets[..., c0:c0 + chunk], weights[..., c0:c0 + chunk],
            use_reentrant=False,
        )
        sum_loss = part if sum_loss is None else sum_loss + part
    return sum_loss, weights.sum(dim=-1)
