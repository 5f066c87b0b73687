"""The autograd pieces of tensor and fully sharded data parallelism: the
collectives the JAX package's GSPMD partitioner inserts around a sharded
product (``parallel/sharding.py``), issued here by hand over a
``WorkerMesh``'s groups.

- ``copy_to_tp`` (Megatron's *f*): the identity forward, a SUM all-reduce
  over the tp group backward; at the input of a column-parallel product,
  whose rank computes only its columns' share of the input's gradient.
- ``reduce_from_tp`` (Megatron's *g*): a SUM all-reduce over the tp group
  forward, the identity backward; at the output of a row-parallel product
  (``wo``, ``w_down``), whose ranks each hold a partial sum.
- ``gather_fsdp``: a weight's fsdp shards all-gathered along their dim
  forward, the whole weight's gradient reduce-scattered (a SUM) back to
  the rank's shard backward. Every user of a gathered weight casts it to
  the compute dtype first, so a bfloat16 model gathers bfloat16 (the cast
  commutes with the gather: the same bits, half the bytes and half the
  memory); its gradient arrives in bfloat16, as the one-process cast's
  does, and is scattered in the weight's float32.
- ``embed_lookup``: the token lookup in an embedding whose vocabulary is
  split over fsdp, never gathered (the JAX partitioner's mask-and-sum
  pattern for a vocab-sharded gather): the fsdp ranks' tokens are
  gathered, each rank looks up those in its vocabulary slice (zeros
  elsewhere) and a reduce-scatter hands each rank its own rows, every
  sum one value and zeros (exact). Backward, the rows' gradient is
  gathered and each rank adds the rows of its slice into its shard.

Each collective is recorded under ``record_collectives`` with tag
``"tp"`` or ``"fsdp"``.
"""

from __future__ import annotations

import torch

from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone(), "sum", tag="tp",
                                    group="tp"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous().clone(), "sum", tag="tp", group="tp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, dim, wire_dtype):
        ctx.mesh, ctx.dim, ctx.dtype = mesh, dim, w.dtype
        return mesh.all_gather(w.detach().to(wire_dtype), dim=dim, tag="fsdp", group="fsdp")

    @staticmethod
    def backward(ctx, grad):
        part = ctx.mesh.reduce_scatter(grad, dim=ctx.dim, tag="fsdp", group="fsdp",
                                       dtype=ctx.dtype)
        return part, None, None, None


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, tokens, mesh, dtype):
        rows = w.shape[1]
        local = tokens - mesh.fsdp_index * rows
        mine = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        worker = torch.arange(w.shape[0], device=w.device)[:, None, None]
        part = torch.where(mine[..., None], w.detach()[worker, local],
                           torch.zeros((), dtype=w.dtype, device=w.device)).to(dtype)
        ctx.mesh, ctx.shape, ctx.dtype = mesh, w.shape, w.dtype
        ctx.save_for_backward(local, mine)
        return mesh.reduce_scatter(part, dim=1, tag="fsdp", group="fsdp")

    @staticmethod
    def backward(ctx, grad):
        local, mine = ctx.saved_tensors
        grad = ctx.mesh.all_gather(grad.contiguous(), dim=1, tag="fsdp", group="fsdp")
        grad = torch.where(mine[..., None], grad.to(ctx.dtype),
                           torch.zeros((), dtype=ctx.dtype, device=grad.device))
        worker = torch.arange(ctx.shape[0], device=grad.device)[:, None, None]
        out = torch.zeros(ctx.shape, dtype=ctx.dtype, device=grad.device)
        out.index_put_((worker.expand_as(local), local), grad, accumulate=True)
        return out, None, None, None


def copy_to_tp(x: torch.Tensor, mesh: WorkerMesh | None) -> torch.Tensor:
    """Megatron's *f* over ``mesh``'s tp group (``x`` itself at tp 1 or
    without a mesh)."""
    return x if mesh is None or mesh.tp == 1 else _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: WorkerMesh | None) -> torch.Tensor:
    """Megatron's *g* over ``mesh``'s tp group (``x`` itself at tp 1 or
    without a mesh)."""
    return x if mesh is None or mesh.tp == 1 else _ReduceFromTP.apply(x, mesh)


def gather_fsdp(w: torch.Tensor, mesh: WorkerMesh | None, dim: int,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """The whole weight from ``w``'s fsdp shards along ``dim``, in
    ``compute_dtype`` when that is narrower than ``w``'s (``w`` itself at
    fsdp 1 or without a mesh). Only for weights every user casts to
    ``compute_dtype``."""
    if mesh is None or mesh.fsdp == 1:
        return w
    wire = compute_dtype if compute_dtype.itemsize < w.dtype.itemsize else w.dtype
    return _GatherFSDP.apply(w, mesh, dim, wire)


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor, mesh: WorkerMesh | None,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """``w[worker, tokens]`` in ``compute_dtype`` for this rank's ``tokens``
    [W, B / fsdp, S], from the vocabulary slices ``w`` [W, V / fsdp, d] of
    the fsdp ranks (plain indexing at fsdp 1 or without a mesh)."""
    if mesh is None or mesh.fsdp == 1:
        worker = torch.arange(w.shape[0], device=w.device)[:, None, None]
        return w[worker, tokens].to(compute_dtype)
    every = mesh.all_gather(tokens, dim=1, tag="fsdp", group="fsdp")
    return _EmbedLookup.apply(w, every, mesh, compute_dtype)
