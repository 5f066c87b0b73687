"""Llama-family decoder as plain functions over a parameter dict.

Port of ``nanodiloco_tpu/models/llama.py``, with its parameter layout:
``embed [V, d]``; ``layers/{wq, wk, wv, wo, w_gate, w_up, w_down}``
stacked ``[L, in, out]`` (``x @ W``); ``attn_norm`` / ``mlp_norm [L,
d]``; ``final_norm [d]``; ``lm_head [d, V]`` unless the head is tied to
the embedding. An MoE config (``num_experts = E > 0``) adds
``layers/router [L, d, E]`` and stacks the expert FFN per layer:
``w_gate`` / ``w_up [L, E, d, f]``, ``w_down [L, E, f, d]``
(``models/moe.py``).

Worker axis. Every function also takes the DiLoCo layout, where each
parameter carries a leading worker dimension ``[W, ...]`` and tokens are
``[W, B, S]``: the matmuls batch over W and the attention folds W into
its batch, so each op launches once for all workers. With ``[B, S]``
tokens and unstacked parameters the functions act as the JAX ones do.

Sharded layout. ``causal_lm_loss`` also takes a ``WorkerMesh`` whose
``fsdp`` or ``tp`` exceeds 1, with parameters sharded as
``parallel/sharding.py`` lays them out (a rank's slices, its worker group's
rows). Under tp a rank computes its heads (``nh / tp`` query and ``nkv /
tp`` KV heads: the flash kernels see ``[B·W, S, H/tp, hd]``) and its
``intermediate / tp`` MLP columns, between Megatron's *f* and *g*
(``parallel/tensor.py``); an untied head's cross-entropy is
vocab-parallel (``ops/fused_ce.py``), a tied one is the whole embedding on
every tp rank. Under fsdp each layer's leaves are gathered just before
the layer runs (again in its backward under ``remat``) and their
gradients reduce-scattered into the rank's shard; the embedding's lookup
runs on its vocabulary slices, never gathered (a tied head gathers it).
The tokens are the rank's ``B / fsdp`` rows.

Numerics follow the JAX package (and HF ``LlamaForCausalLM``):
rotate-half RoPE, RMSNorm accumulating in float32, SwiGLU, pre-norm
residuals, softmax in float32, compute dtype ``cfg.dtype`` over
``cfg.param_dtype`` master weights.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.moe import moe_mlp
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention
from nanodiloco_tpu_torch.ops.fused_ce import chunked_softmax_xent, softmax_xent
from nanodiloco_tpu_torch.parallel.sharding import spec_of
from nanodiloco_tpu_torch.parallel.tensor import (
    copy_to_tp,
    embed_lookup,
    gather_fsdp,
    reduce_from_tp,
)

Params = dict[str, Any]
LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
_NOT_PORTED = "not ported yet (ROADMAP.md, Queue A)"


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. Raises when a CUDA device is
    asked for and there is none: the CPU is used only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def layer_keys(cfg: LlamaConfig) -> tuple[str, ...]:
    """The per-layer leaves of ``cfg``'s tree: ``LAYER_KEYS``, and the
    router in an MoE config."""
    return LAYER_KEYS + (("router",) if cfg.num_experts else ())


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.attention_impl not in ("dense", "flash"):
        if cfg.attention_impl == "ring":
            raise NotImplementedError(f"ring attention (sequence parallelism) is {_NOT_PORTED}")
        raise ValueError(f"unknown attention_impl: {cfg.attention_impl!r}")


# ---------------------------------------------------------------------------
# Initialization and conversion
# ---------------------------------------------------------------------------

def init_params(
    generator: torch.Generator, cfg: LlamaConfig, device: str | torch.device = "cuda",
    leaf=None,
) -> Params:
    """N(0, initializer_range) everywhere, RMSNorm scales at 1, drawn
    from ``generator`` (on the generator's device) and placed on
    ``device`` in ``cfg.param_dtype``. ``leaf(name, tensor)``, if given,
    maps each whole leaf as it is drawn (a rank's shard of it: only one
    whole leaf exists at a time)."""
    _check_supported(cfg)
    device = resolve_device(device)
    std = cfg.initializer_range
    pdt = dtype_of(cfg.param_dtype)
    d, f, v, l = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    nh, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    keep = leaf or (lambda name, t: t)

    def normal(name, *shape):
        x = torch.randn(*shape, generator=generator, device=generator.device)
        return keep(name, (x * std).to(device=device, dtype=pdt))

    def ones(name, *shape):
        return keep(name, torch.ones(*shape, device=device, dtype=pdt))

    layers = {
        "attn_norm": ones("layers/attn_norm", l, d),
        "wq": normal("layers/wq", l, d, nh * hd),
        "wk": normal("layers/wk", l, d, nkv * hd),
        "wv": normal("layers/wv", l, d, nkv * hd),
        "wo": normal("layers/wo", l, nh * hd, d),
        "mlp_norm": ones("layers/mlp_norm", l, d),
    }
    e = cfg.num_experts
    ffn = (e,) if e else ()
    layers["w_gate"] = normal("layers/w_gate", l, *ffn, d, f)
    layers["w_up"] = normal("layers/w_up", l, *ffn, d, f)
    layers["w_down"] = normal("layers/w_down", l, *ffn, f, d)
    params: Params = {"embed": normal("embed", v, d), "layers": layers,
                      "final_norm": ones("final_norm", d)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal("lm_head", d, v)
    if e:
        layers["router"] = normal("layers/router", l, d, e)
    return params


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> Params:
    """The JAX package's parameter tree, as numpy arrays, to the port's
    (same names, same shapes)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_to_numpy(params: Params) -> dict:
    """The port's parameters to numpy arrays (bfloat16 widened to float32,
    which numpy lacks)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def tree_map(fn, params: Params) -> Params:
    if isinstance(params, dict):
        return {k: tree_map(fn, v) for k, v in params.items()}
    return fn(params)


def tree_leaves(params: Params) -> list[torch.Tensor]:
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in tree_leaves(params[k])]
    return [params]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 accumulation; ``scale`` broadcasts against x."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_tables(
    cfg: LlamaConfig, seq_len: int, offset: int = 0, device: str | torch.device = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [seq_len, head_dim] float32, HF rotate-half convention."""
    hd = cfg.head_dim
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, hd]; cos/sin: [S, hd]."""
    cos = cos[:, None, :].to(x.dtype)
    sin = sin[:, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


# Large-but-finite mask value: a fully masked score row softmaxes to
# uniform instead of NaN, so loss-masked padding rows cannot poison the
# batch loss through NaN * 0.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask(
    s: int, valid: torch.Tensor | None = None, device: str | torch.device = "cpu"
) -> torch.Tensor:
    """Additive [B|1, 1, S, S] float32 mask: causal, optionally restricted
    to ``valid`` [B, S] key positions (1 = real token)."""
    if valid is not None:
        device = valid.device
    pos = torch.arange(s, device=device)
    ok = (pos[:, None] >= pos[None, :])[None]             # [1, S, S]
    if valid is not None:
        ok = ok & (valid[:, None, :] > 0)                   # [B, S, S]
    zero = torch.zeros((), device=device)
    return torch.where(ok, zero, torch.full((), MASK_VALUE, device=device))[:, None]


def dense_attention(q, k, v, mask: torch.Tensor | None) -> torch.Tensor:
    """Reference attention: q, k, v [B, S, H, hd] (k/v already expanded),
    mask [B?, 1, S, S] additive or None (causal). Softmax in float32."""
    b, s, h, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(hd))
    if mask is None:
        mask = causal_mask(s, device=q.device)
    probs = torch.softmax(scores + mask.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention(cfg: LlamaConfig, q, k, v, mask):
    """Dispatch on cfg.attention_impl; k/v arrive at Hkv heads. Flash is
    GQA-native and takes packed sequences (it ignores the padding mask);
    dense expands K/V to the query heads."""
    if cfg.attention_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    if k.shape[2] != q.shape[2]:
        g = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return dense_attention(q, k, v, mask)


# the matmuls a "dots" recompute saves: JAX's dots_saveable keeps every
# dot_general's output; the flash forward is no dot there either
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
               torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: LlamaConfig):
    """``checkpoint``'s context_fn for ``cfg.remat_policy`` (JAX
    ``checkpoint_policy``): "dots" saves the matmul outputs and recomputes
    the rest of the layer; "nothing" recomputes the whole layer."""
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return None


# ---------------------------------------------------------------------------
# Decoder (worker-stacked layout: x [W, B, S, d], weights [W, ...])
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[W, B, S, in] @ [W, in, out] -> [W, B, S, out] in x's dtype."""
    wn, b, s, d = x.shape
    return torch.matmul(x.reshape(wn, b * s, d), w.to(x.dtype)).reshape(wn, b, s, -1)


def _norm(x, scale, eps):
    return rms_norm(x, scale[:, None, None, :], eps)


def mlp_block(cfg: LlamaConfig, x, layer: Params, valid=None, with_stats: bool = False,
              mesh=None):
    """The norm + (dense SwiGLU | MoE) residual half of a decoder layer.
    Returns (x, aux [W]): aux is the router's load-balance term, 0 for a
    dense layer. ``valid`` [W, B, S] marks the tokens that claim expert
    capacity. ``with_stats`` appends [W, 2] = [dropped_frac,
    router_entropy] (zeros for a dense layer), the diagnostics channel.
    Under a sharded ``mesh`` the layer's weights are whole along fsdp
    already and this rank's ``intermediate / tp`` columns."""
    h = _norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    if cfg.num_experts:
        out = moe_mlp(cfg, h, layer, valid=valid, with_stats=with_stats)
        return (x + out[0], *out[1:])
    h = copy_to_tp(h, mesh)
    gate = F.silu(_mm(h, layer["w_gate"]))
    x = x + reduce_from_tp(_mm(gate * _mm(h, layer["w_up"]), layer["w_down"]), mesh)
    zero = torch.zeros(x.shape[0], device=x.device)
    if with_stats:
        return x, zero, torch.zeros(x.shape[0], 2, device=x.device)
    return x, zero


def _gather_layer(cfg: LlamaConfig, layer: Params, mesh) -> Params:
    """One layer's leaves [W, ...] gathered whole along their fsdp dim (the
    spec's, the worker axis in the layer axis' place); the leaves
    themselves without fsdp."""
    if mesh is None or mesh.fsdp == 1:
        return layer
    cdt = dtype_of(cfg.dtype)
    out = {}
    for key, w in layer.items():
        spec = spec_of(f"layers/{key}")
        out[key] = gather_fsdp(w, mesh, spec.index("fsdp"), cdt) if "fsdp" in spec else w
    return out


def _decoder_layer(cfg: LlamaConfig, x, layer: Params, cos, sin, mask, valid=None,
                   with_stats: bool = False, mesh=None):
    wn, b, s, d = x.shape
    tp = 1 if mesh is None else mesh.tp
    nh, nkv, hd = cfg.num_attention_heads // tp, cfg.kv_heads // tp, cfg.head_dim
    layer = _gather_layer(cfg, layer, mesh)
    h = copy_to_tp(_norm(x, layer["attn_norm"], cfg.rms_norm_eps), mesh)
    q = apply_rope(_mm(h, layer["wq"]).reshape(wn * b, s, nh, hd), cos, sin)
    k = apply_rope(_mm(h, layer["wk"]).reshape(wn * b, s, nkv, hd), cos, sin)
    v = _mm(h, layer["wv"]).reshape(wn * b, s, nkv, hd)
    attn = _attention(cfg, q, k, v, mask).reshape(wn, b, s, nh * hd)
    out = reduce_from_tp(_mm(attn, layer["wo"]), mesh)
    return mlp_block(cfg, x + out, layer, valid, with_stats, mesh)


def _stacked(params: Params, tokens: torch.Tensor, extra=()):
    """Unstacked params + [B, S] tokens -> a worker axis of 1."""
    if tokens.ndim == 3:
        return params, tokens, extra, False
    if tokens.ndim != 2:
        raise ValueError(f"tokens must be [B, S] or [W, B, S]; got {tuple(tokens.shape)}")
    extra = tuple(None if e is None else e[None] for e in extra)
    return tree_map(lambda p: p[None], params), tokens[None], extra, True


def _hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, attn_mask,
            collect_stats: bool = False, mesh=None):
    """(final normed hidden states [W, B, S, d] in the compute dtype, the
    router aux summed over layers [W], with ``collect_stats`` the layer
    mean of the MoE stats [W, 2] (else None), and the head [W, d, V]: the
    untied ``lm_head`` (this rank's V / tp columns under tp, gathered
    over fsdp) or the embedding's transpose, whole). ``attn_mask`` also
    tells the MoE layers which tokens are real, under flash too."""
    _check_supported(cfg)
    wn, b, s = tokens.shape
    cdt = dtype_of(cfg.dtype)
    x = embed_lookup(params["embed"], tokens, mesh, cdt)
    # a tied head is the whole embedding (gathered over fsdp), on every tp rank
    head = (gather_fsdp(params["embed"], mesh, 1, cdt).transpose(-1, -2)
            if "lm_head" not in params else gather_fsdp(params["lm_head"], mesh, 1, cdt))
    cos, sin = rope_tables(cfg, s, device=tokens.device)
    # flash is a packed-sequence kernel: attn_mask only weights the loss
    mask = None
    if attn_mask is not None and cfg.attention_impl == "dense":
        mask = causal_mask(s, valid=attn_mask.reshape(wn * b, s))
    keys = layer_keys(cfg)
    aux, stats = torch.zeros(wn, device=tokens.device), []
    for i in range(cfg.num_hidden_layers):
        layer = {key: params["layers"][key][:, i] for key in keys}
        if cfg.remat:
            ctx = _remat_context(cfg)
            out = checkpoint(_decoder_layer, cfg, x, layer, cos, sin, mask, attn_mask,
                             collect_stats, mesh, use_reentrant=False,
                             **({"context_fn": ctx} if ctx is not None else {}))
        else:
            out = _decoder_layer(cfg, x, layer, cos, sin, mask, attn_mask, collect_stats,
                                 mesh)
        x, aux = out[0], aux + out[1]
        if collect_stats:
            stats.append(out[2])
    stats = torch.stack(stats).mean(0) if collect_stats else None
    return _norm(x, params["final_norm"], cfg.rms_norm_eps), aux, stats, head


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attn_mask: torch.Tensor | None = None,
    return_hidden: bool = False,
    with_aux: bool = False,
    collect_stats: bool = False,
):
    """tokens [B, S] (or [W, B, S] with worker-stacked params) -> logits
    [..., S, vocab] float32, or the final normed hidden states [..., S, d]
    in the compute dtype with ``return_hidden``. ``attn_mask`` [.., B, S]
    marks real tokens (dense attention honors it, flash does not; the MoE
    layers route only real tokens under both). ``with_aux`` returns
    ``(out, aux)``, aux the router load-balance term summed over layers
    (0 for a dense model); ``collect_stats`` appends the layer mean of
    the MoE router stats [dropped_frac, router_entropy] (diagnostics,
    ``moe.make_router_stats_fn``). aux and stats carry the worker axis
    [W] of stacked inputs."""
    params, tokens, (attn_mask,), squeeze = _stacked(params, tokens, (attn_mask,))
    x, aux, stats, head = _hidden(params, tokens, cfg, attn_mask, collect_stats)
    if not return_hidden:
        wn, b, s, d = x.shape
        x = torch.matmul(x.reshape(wn, b * s, d), head.to(x.dtype))
        x = x.float().reshape(wn, b, s, -1)
    if squeeze:
        x, aux = x[0], aux[0]
        stats = None if stats is None else stats[0]
    if collect_stats:
        return (x, aux, stats) if with_aux else (x, stats)
    return (x, aux) if with_aux else x


def causal_lm_loss(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    loss_mask: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy with an internal label shift, plus
    ``router_aux_coef`` times the router's load-balance term (MoE).

    ``loss_mask`` marks real tokens; a position whose TARGET is padding
    is excluded. Returns (loss, {"n_tokens", "sum_loss", "router_aux"}),
    per worker ([W]) for worker-stacked inputs, scalars otherwise. Under
    a sharded ``mesh`` (``params`` this rank's shards, ``tokens`` its rows)
    the sums are the rank's rows' (the caller sums them over fsdp); every
    tp rank returns the same."""
    params, tokens, (loss_mask,), squeeze = _stacked(params, tokens, (loss_mask,))
    wn, b, s = tokens.shape
    targets = tokens[..., 1:].reshape(wn, -1)
    m = (loss_mask[..., 1:] if loss_mask is not None
         else torch.ones_like(tokens[..., 1:])).reshape(wn, -1).float()
    h, router_aux, _, head = _hidden(params, tokens, cfg, loss_mask, mesh=mesh)
    head = head.to(h.dtype)
    rows = h[:, :, :-1].reshape(wn, b * (s - 1), -1)
    # an untied head's columns are split over tp: the vocab-parallel loss
    vocab_mesh = mesh if mesh is not None and mesh.tp > 1 and "lm_head" in params else None
    if vocab_mesh is not None:
        rows = copy_to_tp(rows, mesh)
    if cfg.loss_chunk:
        sum_loss, n_tok = chunked_softmax_xent(rows, head, targets, m, chunk=cfg.loss_chunk,
                                               mesh=vocab_mesh)
    elif vocab_mesh is not None:
        nll = softmax_xent(torch.matmul(rows, head).float(), targets, vocab_mesh)
        sum_loss, n_tok = (nll * m).sum(dim=-1), m.sum(dim=-1)
    else:
        logits = torch.matmul(rows, head).float()
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
        sum_loss, n_tok = (nll * m).sum(dim=-1), m.sum(dim=-1)
    loss = sum_loss / n_tok.clamp_min(1.0) + cfg.router_aux_coef * router_aux
    aux = {"n_tokens": n_tok, "sum_loss": sum_loss, "router_aux": router_aux}
    if squeeze:
        return loss[0], {k: v[0] for k, v in aux.items()}
    return loss, aux
