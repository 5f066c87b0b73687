"""Sharding rules: which dimension of each weight a rank holds a slice
of. Port of ``nanodiloco_tpu/parallel/sharding.py``'s tables.

``param_specs`` is the JAX package's ``param_specs`` table, leaf for leaf,
as tuples of axis names (a ``PartitionSpec``'s entries): the stacked
layer axis first (never sharded: pipeline stages are not ported), then

- column-parallel producers (``wq``/``wk``/``wv``, ``w_gate``/``w_up``):
  the input dim over ``fsdp``, the output dim over ``tp``;
- row-parallel consumers (``wo``, ``w_down``): the transpose;
- ``embed``: the vocabulary over ``fsdp``, the features whole;
- an untied ``lm_head``: ``d`` over ``fsdp``, the vocabulary over ``tp``;
- norm scales whole;
- with ``worker_axis`` the DiLoCo worker axis ``"diloco"`` ahead of all.

A rank ``(g, f, t)`` of ``parallel/mesh.py::WorkerMesh`` holds slice f of
every ``fsdp`` dim, slice t of every ``tp`` dim and its group's workers
of the ``diloco`` dim (``local_box``): ``shard`` cuts whole weights to it
and ``unshard`` gathers them back over the ``fsdp`` and ``tp`` groups.
Shards must be even: JAX's GSPMD pads an uneven one, which the port does
not (``check_layout`` raises; ROADMAP).

JAX's ``named`` and ``constrain`` are GSPMD mechanisms (a sharding
annotation the XLA partitioner turns into collectives) with no
counterpart here: the port issues its collectives itself, in
``parallel/tensor.py`` (the tensor-parallel sums and the fsdp gathers of
the model), ``models/llama.py`` and ``parallel/diloco.py``.
"""

from __future__ import annotations

from typing import Any

import torch

from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh

Spec = tuple
_DENSE = {
    "embed": ("fsdp", None),
    "final_norm": (),
    "lm_head": ("fsdp", "tp"),
    "layers/attn_norm": (None, None),
    "layers/wq": (None, "fsdp", "tp"),
    "layers/wk": (None, "fsdp", "tp"),
    "layers/wv": (None, "fsdp", "tp"),
    "layers/wo": (None, "tp", "fsdp"),
    "layers/mlp_norm": (None, None),
    "layers/w_gate": (None, "fsdp", "tp"),
    "layers/w_up": (None, "fsdp", "tp"),
    "layers/w_down": (None, "tp", "fsdp"),
}
# MoE: the expert axis over ep, each expert's FFN dims over fsdp and tp
_MOE = {
    "layers/router": (None, None, None),
    "layers/w_gate": (None, "ep", "fsdp", "tp"),
    "layers/w_up": (None, "ep", "fsdp", "tp"),
    "layers/w_down": (None, "ep", "tp", "fsdp"),
}
_MOE_NOT_PORTED = ("a Mixture-of-Experts model under fsdp or tp is not ported yet "
                   "(ROADMAP.md, Queue A item 7e: the experts' FFN dims over fsdp and tp)")


def spec_of(name: str, moe: bool = False, worker_axis: bool = False) -> Spec:
    """The spec of leaf ``name`` ("embed", "layers/wq", ...)."""
    spec = (_MOE.get(name) if moe else None) or _DENSE[name]
    return (("diloco",) if worker_axis else ()) + spec


def param_specs(cfg, worker_axis: bool = False) -> dict[str, Any]:
    """The spec tree of ``cfg``'s parameters (``models/llama.py::init_params``'
    tree), JAX ``param_specs(cfg, worker_axis)`` entry for entry."""
    moe = bool(cfg.num_experts)
    layer_names = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
                   "w_down"] + (["router"] if moe else [])
    specs: dict[str, Any] = {
        "embed": spec_of("embed", moe, worker_axis),
        "final_norm": spec_of("final_norm", moe, worker_axis),
        "layers": {k: spec_of(f"layers/{k}", moe, worker_axis) for k in layer_names},
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = spec_of("lm_head", moe, worker_axis)
    return specs


# token batches [W, accum, B, S]: workers over diloco, a worker's batch
# rows over fsdp (JAX ``batch_spec`` without ``sp``)
BATCH_SPEC: Spec = ("diloco", None, "fsdp", None)


def named_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[("embed", t), ("final_norm", t), ("layers/attn_norm", t), ...]``
    in ``tree_leaves`` order (sorted keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _is_moe(params: dict) -> bool:
    return "router" in params.get("layers", {})


def check_layout(cfg, fsdp: int, tp: int) -> None:
    """Every dimension a shard splits must split evenly: raises
    ``ValueError`` naming the first that does not (and NotImplementedError
    for MoE under fsdp or tp)."""
    if fsdp == 1 and tp == 1:
        return
    if cfg.num_experts:
        raise NotImplementedError(_MOE_NOT_PORTED)
    dims = [("num_attention_heads", cfg.num_attention_heads, "tp", tp),
            ("num_key_value_heads", cfg.kv_heads, "tp", tp),
            ("intermediate_size", cfg.intermediate_size, "tp", tp)]
    if not cfg.tie_word_embeddings:
        dims.append(("vocab_size (the untied lm_head's columns)", cfg.vocab_size, "tp", tp))
    dims += [("hidden_size", cfg.hidden_size, "fsdp", fsdp),
             ("vocab_size (the embedding's rows)", cfg.vocab_size, "fsdp", fsdp)]
    for what, n, axis, k in dims:
        if n % k:
            raise ValueError(
                f"{what}={n} is not a multiple of {axis}={k}: the port's shards are even "
                "(an uneven shard is ROADMAP.md Queue A item 9)"
            )


def local_box(spec: Spec, shape, mesh: WorkerMesh) -> tuple[slice, ...]:
    """This rank's slice of each dimension of a tensor of ``shape`` laid
    out by ``spec``: its group's workers on ``diloco``, piece f of
    ``fsdp``, piece t of ``tp``, the whole of any other."""
    out = []
    for i, n in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        if axis == "diloco":
            out.append(slice(mesh.lo, mesh.hi))
        elif axis in ("fsdp", "tp"):
            k = mesh.size(axis)
            idx = mesh.fsdp_index if axis == "fsdp" else mesh.tp_index
            out.append(slice(idx * (n // k), (idx + 1) * (n // k)))
        else:
            out.append(slice(None))
    return tuple(out)


def whole_shape(shape, spec: Spec, mesh: WorkerMesh) -> tuple[int, ...]:
    """The whole tensor's shape from a shard's (the worker axis as is)."""
    return tuple(n * (mesh.size(spec[i]) if i < len(spec) and spec[i] in ("fsdp", "tp")
                      else 1) for i, n in enumerate(shape))


def counted(spec: Spec, mesh: WorkerMesh) -> bool:
    """Whether this rank counts the leaf in a sum over its worker group's
    ranks: a leaf whole along an axis is held alike by every rank of that
    axis, and only index 0 counts it."""
    return (("fsdp" in spec or mesh.fsdp_index == 0)
            and ("tp" in spec or mesh.tp_index == 0))


def map_leaves(params: dict, fn, prefix: str = "") -> dict:
    """``fn(name, leaf)`` over every leaf, the tree's structure kept."""
    return {k: map_leaves(v, fn, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in params.items()}


def shard_leaf(name: str, t: torch.Tensor, mesh: WorkerMesh, worker_axis: bool = False,
               moe: bool = False) -> torch.Tensor:
    """This rank's slice of the whole leaf ``name`` (a contiguous copy)."""
    return t[local_box(spec_of(name, moe, worker_axis), t.shape, mesh)].clone()


def shard(params: dict, mesh: WorkerMesh, worker_axis: bool = False) -> dict:
    """This rank's slices of whole ``params`` (contiguous copies; with
    ``worker_axis`` the leading [W] axis is cut to the rank's workers
    too). The tree itself when the mesh is not sharded and has no worker
    axis to cut."""
    moe = _is_moe(params)
    if moe and mesh.sharded:
        raise NotImplementedError(_MOE_NOT_PORTED)
    if not mesh.sharded and not (worker_axis and mesh.worker_groups > 1):
        return params
    return map_leaves(params, lambda name, t: shard_leaf(name, t, mesh, worker_axis, moe))


@torch.no_grad()
def unshard(params: dict, mesh: WorkerMesh, worker_axis: bool = False) -> dict:
    """Whole weights from this rank's shards, gathered over its ``fsdp``
    and ``tp`` groups (the worker axis stays the rank's own)."""
    if not mesh.sharded:
        return params
    moe = _is_moe(params)

    def gather(name, t):
        spec = spec_of(name, moe, worker_axis)
        for axis in ("fsdp", "tp"):
            if axis in spec and mesh.size(axis) > 1:
                t = mesh.all_gather(t, dim=spec.index(axis), tag="unshard", group=axis)
        return t

    return map_leaves(params, gather)


def inner_step_bytes(cfg, mesh: WorkerMesh, rows: int, seq: int, accum: int,
                     clip: bool = True) -> dict[tuple[str, str], int]:
    """What one inner step hands to the fsdp and tp collectives on one
    rank, by ``(op, tag)`` as ``record_collectives`` records them: the
    sharding's prediction, for a dense model at ``rows`` rows a
    microbatch on this rank (``B / fsdp``), ``seq`` tokens a row and
    ``accum`` microbatches, with ``remat`` off or ``remat_policy``
    "nothing".

    A microbatch gathers every sharded layer leaf once (again in the
    layer's recompute under ``remat``) and the head once (a tied head: the
    embedding), in the compute dtype where it is narrower, and
    reduce-scatters each one's whole-size gradient once in the parameter
    dtype. The embedding's lookup gathers the fsdp ranks' tokens and
    reduce-scatters their rows (compute dtype), and gathers the rows'
    gradient back. Each layer sums two partial outputs over tp (``wo``,
    ``w_down``) and two input gradients (*f*'s backward); the recompute
    stops at the last tensor the backward needs (torch's checkpoint early
    stop), so it re-runs the attention's sum and not the MLP's. An untied
    head adds *f* on the rows and, a chunk of ``loss_chunk`` rows (one of
    all rows without), a MAX and two SUMs of [W, rows] float32 values,
    again in a chunk's recompute."""
    if cfg.remat and cfg.remat_policy != "nothing":
        raise ValueError("inner_step_bytes predicts remat_policy 'nothing' only")
    c = 2 if cfg.dtype == "bfloat16" else 4
    pb = 2 if cfg.param_dtype == "bfloat16" else 4
    wire = min(c, pb)
    wl, d, L, fs = mesh.local_workers, cfg.hidden_size, cfg.num_hidden_layers, mesh.fsdp
    nh, nkv, hd, f, v = (cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim,
                         cfg.intermediate_size, cfg.vocab_size)
    n_shard = fs * mesh.tp
    layer = (d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * f) // n_shard
    head = v * d // fs if cfg.tie_word_embeddings else d * v // n_shard
    act = wl * rows * seq * d * c          # one [W, rows, S, d] activation
    out: dict[tuple[str, str], int] = {}

    def add(key, n):
        if n:
            out[key] = out.get(key, 0) + n

    if fs > 1:
        recompute = 2 if cfg.remat else 1
        add(("all_gather", "fsdp"), accum * (wl * wire * (recompute * L * layer + head)
                                             + wl * rows * seq * 8 + act))
        add(("reduce_scatter", "fsdp"), accum * (wl * pb * fs * (L * layer + head)
                                                 + fs * act))
        add(("all_reduce_sum", "fsdp"), wl * pb * (2 * L * d + d))
        add(("all_reduce_sum", "loss"), accum * 2 * wl * 4)
    if mesh.tp > 1:
        add(("all_reduce_sum", "tp"), accum * L * act * (2 + (3 if cfg.remat else 2)))
        if not cfg.tie_word_embeddings:
            n_rows = rows * (seq - 1)
            chunk = cfg.loss_chunk
            padded = -(-n_rows // chunk) * chunk if chunk else n_rows
            passes = 2 if chunk else 1
            add(("all_reduce_sum", "tp"), accum * (wl * n_rows * d * c
                                                   + passes * 2 * wl * padded * 4))
            add(("all_reduce_max", "tp"), accum * passes * wl * padded * 4)
    if clip and n_shard > 1:
        add(("all_reduce_sum", "clip"), wl * 4)
    return out
