"""Chunked softmax cross-entropy: the vocabulary projection and the loss
computed in row chunks so the full ``[N, V]`` logits never exist.

Port of ``nanodiloco_tpu/ops/fused_ce.py``. Each chunk runs under
``torch.utils.checkpoint``: the forward keeps only the chunk's scalar
loss, the backward recomputes the chunk's logits. Peak memory is
O(chunk x V) instead of O(N x V), for one extra head product in the
backward. The head product itself is a plain ``torch.matmul``.

Vocab-parallel (a ``WorkerMesh`` with tp > 1, the head this rank's
``V / tp`` columns, the rows the same on every tp rank): the row max, the
sum of exponentials and the target's logit are each reduced over the tp
group (``softmax_xent``), so no ``[rows, V]`` logits tensor is gathered;
every tp rank gets the same loss, and its gradient of its own columns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nanodiloco_tpu_torch.parallel.tensor import reduce_from_tp


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, mesh) -> torch.Tensor:
    """Per-row cross-entropy ``lse - logit[target]`` from this rank's
    float32 ``logits`` [..., V / tp] (columns ``[t V/tp, (t+1) V/tp)``)
    over ``mesh``'s tp group: the max (no gradient: it only shifts the
    exponentials) by a MAX all-reduce, the sum of exponentials and the
    target's logit (0 on every rank but its owner's) by Megatron's *g*."""
    v = logits.shape[-1]
    top = logits.detach().amax(dim=-1)
    mesh.all_reduce_(top, "max", tag="tp", group="tp")
    sum_exp = reduce_from_tp(torch.exp(logits - top[..., None]).sum(dim=-1), mesh)
    local = targets - mesh.tp_index * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = reduce_from_tp(torch.where(mine, gold, torch.zeros_like(gold)), mesh)
    return torch.log(sum_exp) + top - gold


def _chunk_loss(head, hx, tg, w, mesh=None):
    logits = torch.matmul(hx, head).float()               # [..., C, V]
    if mesh is not None:
        return (w * softmax_xent(logits, tg, mesh)).sum(dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tg[..., None])[..., 0]
    return (w * (lse - gold)).sum(dim=-1)


def chunked_softmax_xent(
    hidden: torch.Tensor,   # [..., N, d] compute-dtype rows (label-aligned)
    head: torch.Tensor,     # [..., d, V]
    targets: torch.Tensor,  # [..., N] int
    weights: torch.Tensor,  # [..., N] float (0 = ignore row)
    chunk: int = 1024,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_loss, sum_weights) over the rows, float32, one per
    leading index. Rows are padded to a multiple of ``chunk`` with zero
    weight. With ``mesh`` the loss is vocab-parallel over its tp group."""
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
            targets[..., c0:c0 + chunk], weights[..., c0:c0 + chunk], mesh,
            use_reentrant=False,
        )
        sum_loss = part if sum_loss is None else sum_loss + part
    return sum_loss, weights.sum(dim=-1)
