"""Llama-family decoder as plain functions over a parameter dict.

Port of the dense path of ``nanodiloco_tpu/models/llama.py``, with its
parameter layout: ``embed [V, d]``; ``layers/{wq, wk, wv, wo, w_gate,
w_up, w_down}`` stacked ``[L, in, out]`` (``x @ W``); ``attn_norm`` /
``mlp_norm [L, d]``; ``final_norm [d]``; ``lm_head [d, V]`` unless the
head is tied to the embedding.

Worker axis. Every function also takes the DiLoCo layout, where each
parameter carries a leading worker dimension ``[W, ...]`` and tokens are
``[W, B, S]``: the matmuls batch over W and the attention folds W into
its batch, so each op launches once for all workers. With ``[B, S]``
tokens and unstacked parameters the functions act as the JAX ones do.

Numerics follow the JAX package (and HF ``LlamaForCausalLM``):
rotate-half RoPE, RMSNorm accumulating in float32, SwiGLU, pre-norm
residuals, softmax in float32, compute dtype ``cfg.dtype`` over
``cfg.param_dtype`` master weights.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention
from nanodiloco_tpu_torch.ops.fused_ce import chunked_softmax_xent

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


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(f"MoE layers are {_NOT_PORTED}")
    if cfg.attention_impl not in ("dense", "flash"):
        if cfg.attention_impl == "ring":
            raise NotImplementedError(f"ring attention (sequence parallelism) is {_NOT_PORTED}")
        raise ValueError(f"unknown attention_impl: {cfg.attention_impl!r}")
    if cfg.remat and cfg.remat_policy != "nothing":
        raise NotImplementedError(f"remat_policy={cfg.remat_policy!r} is {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Initialization and conversion
# ---------------------------------------------------------------------------

def init_params(
    generator: torch.Generator, cfg: LlamaConfig, device: str | torch.device = "cuda"
) -> Params:
    """N(0, initializer_range) everywhere, RMSNorm scales at 1, drawn
    from ``generator`` (on the generator's device) and placed on
    ``device`` in ``cfg.param_dtype``."""
    _check_supported(cfg)
    device = resolve_device(device)
    std = cfg.initializer_range
    pdt = dtype_of(cfg.param_dtype)
    d, f, v, l = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    nh, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim

    def normal(*shape):
        x = torch.randn(*shape, generator=generator, device=generator.device)
        return (x * std).to(device=device, dtype=pdt)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=pdt)

    layers = {
        "attn_norm": ones(l, d),
        "wq": normal(l, d, nh * hd),
        "wk": normal(l, d, nkv * hd),
        "wv": normal(l, d, nkv * hd),
        "wo": normal(l, nh * hd, d),
        "mlp_norm": ones(l, d),
        "w_gate": normal(l, d, f),
        "w_up": normal(l, d, f),
        "w_down": normal(l, f, d),
    }
    params: Params = {"embed": normal(v, d), "layers": layers, "final_norm": ones(d)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(d, v)
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


# ---------------------------------------------------------------------------
# Decoder (worker-stacked layout: x [W, B, S, d], weights [W, ...])
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[W, B, S, in] @ [W, in, out] -> [W, B, S, out] in x's dtype."""
    wn, b, s, d = x.shape
    return torch.matmul(x.reshape(wn, b * s, d), w.to(x.dtype)).reshape(wn, b, s, -1)


def _norm(x, scale, eps):
    return rms_norm(x, scale[:, None, None, :], eps)


def mlp_block(cfg: LlamaConfig, x, layer: Params):
    """The norm + SwiGLU residual half of a decoder layer."""
    h = _norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    gate = F.silu(_mm(h, layer["w_gate"]))
    return x + _mm(gate * _mm(h, layer["w_up"]), layer["w_down"])


def _decoder_layer(cfg: LlamaConfig, x, layer: Params, cos, sin, mask):
    wn, b, s, d = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    h = _norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q = apply_rope(_mm(h, layer["wq"]).reshape(wn * b, s, nh, hd), cos, sin)
    k = apply_rope(_mm(h, layer["wk"]).reshape(wn * b, s, nkv, hd), cos, sin)
    v = _mm(h, layer["wv"]).reshape(wn * b, s, nkv, hd)
    attn = _attention(cfg, q, k, v, mask).reshape(wn, b, s, nh * hd)
    return mlp_block(cfg, x + _mm(attn, layer["wo"]), layer)


def _stacked(params: Params, tokens: torch.Tensor, extra=()):
    """Unstacked params + [B, S] tokens -> a worker axis of 1."""
    if tokens.ndim == 3:
        return params, tokens, extra, False
    if tokens.ndim != 2:
        raise ValueError(f"tokens must be [B, S] or [W, B, S]; got {tuple(tokens.shape)}")
    extra = tuple(None if e is None else e[None] for e in extra)
    return tree_map(lambda p: p[None], params), tokens[None], extra, True


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].transpose(-1, -2) if head is None else head


def _hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, attn_mask):
    """Final normed hidden states [W, B, S, d] in the compute dtype."""
    _check_supported(cfg)
    wn, b, s = tokens.shape
    cdt = dtype_of(cfg.dtype)
    worker = torch.arange(wn, device=tokens.device)[:, None, None]
    x = params["embed"][worker, tokens].to(cdt)
    cos, sin = rope_tables(cfg, s, device=tokens.device)
    # flash is a packed-sequence kernel: attn_mask only weights the loss
    mask = None
    if attn_mask is not None and cfg.attention_impl == "dense":
        mask = causal_mask(s, valid=attn_mask.reshape(wn * b, s))
    for i in range(cfg.num_hidden_layers):
        layer = {key: params["layers"][key][:, i] for key in LAYER_KEYS}
        if cfg.remat:
            x = checkpoint(_decoder_layer, cfg, x, layer, cos, sin, mask,
                           use_reentrant=False)
        else:
            x = _decoder_layer(cfg, x, layer, cos, sin, mask)
    return _norm(x, params["final_norm"], cfg.rms_norm_eps)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attn_mask: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """tokens [B, S] (or [W, B, S] with worker-stacked params) -> logits
    [..., S, vocab] float32, or the final normed hidden states [..., S, d]
    in the compute dtype with ``return_hidden``. ``attn_mask`` [.., B, S]
    marks real tokens (dense attention honors it; flash does not)."""
    params, tokens, (attn_mask,), squeeze = _stacked(params, tokens, (attn_mask,))
    x = _hidden(params, tokens, cfg, attn_mask)
    if not return_hidden:
        wn, b, s, d = x.shape
        x = torch.matmul(x.reshape(wn, b * s, d), _head(params).to(x.dtype))
        x = x.float().reshape(wn, b, s, -1)
    return x[0] if squeeze else x


def causal_lm_loss(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    loss_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy with an internal label shift.

    ``loss_mask`` marks real tokens; a position whose TARGET is padding
    is excluded. Returns (loss, {"n_tokens", "sum_loss"}), per worker
    ([W]) for worker-stacked inputs, scalars otherwise."""
    params, tokens, (loss_mask,), squeeze = _stacked(params, tokens, (loss_mask,))
    wn, b, s = tokens.shape
    targets = tokens[..., 1:].reshape(wn, -1)
    m = (loss_mask[..., 1:] if loss_mask is not None
         else torch.ones_like(tokens[..., 1:])).reshape(wn, -1).float()
    h = _hidden(params, tokens, cfg, loss_mask)
    head = _head(params).to(h.dtype)
    rows = h[:, :, :-1].reshape(wn, b * (s - 1), -1)
    if cfg.loss_chunk:
        sum_loss, n_tok = chunked_softmax_xent(rows, head, targets, m, chunk=cfg.loss_chunk)
    else:
        logits = torch.matmul(rows, head).float()
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
        sum_loss, n_tok = (nll * m).sum(dim=-1), m.sum(dim=-1)
    loss = sum_loss / n_tok.clamp_min(1.0)
    aux = {"n_tokens": n_tok, "sum_loss": sum_loss}
    if squeeze:
        return loss[0], {k: v[0] for k, v in aux.items()}
    return loss, aux
