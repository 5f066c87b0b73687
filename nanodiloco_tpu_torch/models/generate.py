"""Autoregressive generation over a preallocated KV cache: port of
``nanodiloco_tpu/models/generate.py``.

- ``generate``: one-shot sampling. The prompt prefills in one call of
  ``_cached_block`` and each new token is one more call at T = 1. The
  JAX package compiles prefill and the decode loop into one program; here
  each call is eager PyTorch, and the loop is Python.
- The cache is preallocated at ``[L, B, S_max, Hkv, hd]`` in the compute
  dtype and written in place at the call's offset. A write that would
  run past ``S_max`` raises (``dynamic_update_slice`` would clamp it
  backwards over real positions).
- Attention is GQA-native: query heads are grouped against the Hkv cache
  heads with einsums, the cached K/V never expanded. From 1024 positions
  of context the scores use the online-softmax recurrence
  (``ops/online_softmax.py``) over 512-key tiles bounded by the live
  prefix (``decode_block``). Neither form is a Pallas kernel in the JAX
  package, so plain PyTorch is the port of both.
- The slot programs of the serving engine (``prefill_chunk_fn``,
  ``decode_slots_fn``, ``verify_slots_fn``, ``extract_chunk_fn``,
  ``insert_chunk_fn`` and the paged twins over a block arena,
  ``prefill_chunk_paged_fn``, ``decode_slots_paged_fn`` and
  ``verify_slots_paged_fn``) are plain functions that close over the
  config; they share ``_cached_block`` and the verify blocks with
  ``generate`` so the paths cannot drift.

Weights are cast to the compute dtype once, when ``generate`` or the
engine takes them (``serving_params``), never per call: eager PyTorch
would otherwise re-cast every layer on every decode tick. Embedding rows
are gathered before they are cast. Both give the JAX package's bits.

Sampling takes its randomness as a tensor of Gumbel noise: the JAX
``categorical`` is ``argmax(logits + gumbel)``, so given the same noise
the two samplers pick the same tokens. The port's noise
(``gumbel_noise``) is a counter-based integer hash of (request seed,
stream, step, vocabulary index): a request's noise depends on nothing
else, step 0 is the prefill's sample, and the uniforms are the same bits
on the CPU and on the card. It replaces the JAX key schedule, whose bits
cannot be reproduced here.

Variable-length prompts are right-aligned: shorter prompts are padded on
the LEFT (``pad_prompts``) and ``prompt_valid`` masks the pads out of
attention.

MoE configs run the training forward's MLP (``models/moe.py``) on each
call's tokens, with the tokens that must claim no expert capacity masked:
a prompt's left pads, a final chunk's right pads, and the dead slots of
a B-slot tick (every slot row runs; capacity is sized from all B rows).
Known divergence from the training forward, as in the JAX package:
dense dispatch sizes capacity from the tokens of the CURRENT call (B·P
at prefill, B at a decode step) where training routes over B·S, so when
capacity binds, which tokens overflow differs and logits can diverge.
Ragged dispatch has no capacity and routes as training does. Expert-
choice routing is training-only (its top-C selection sees the whole
token set) and is refused here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    MASK_VALUE,
    Params,
    _check_supported,
    apply_rope,
    dtype_of,
    resolve_device,
    rms_norm,
    rope_tables,
)
from nanodiloco_tpu_torch.models.moe import moe_mlp
from nanodiloco_tpu_torch.ops.online_softmax import block_update, finalize_grouped

MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# cast to the compute dtype with them: the MoE router (the training forward
# casts it before its product too)
_CAST_KEYS = MATMUL_KEYS + ("router",)


def serving_params(params: Params, cfg: LlamaConfig,
                   device: str | torch.device | None = None) -> Params:
    """``params`` for the serving path: the matmul weights and the head in
    the compute dtype (cast once here), the embedding and the norm scales
    as they are (rows are gathered, then cast; norms scale in float32).
    A tied head becomes ``lm_head`` = the embedding's transpose. Moves
    every leaf to ``device`` when one is given. Leaves already in place
    are shared, not copied."""
    cdt = dtype_of(cfg.dtype)
    dev = None if device is None else torch.device(device)

    def put(t, dtype=None):
        return t.to(device=dev if dev is not None else t.device, dtype=dtype or t.dtype)

    layers = {k: put(v, cdt if k in _CAST_KEYS else None)
              for k, v in params["layers"].items()}
    head = params.get("lm_head")
    head = params["embed"].transpose(0, 1) if head is None else head
    return {"embed": put(params["embed"]), "layers": layers,
            "final_norm": put(params["final_norm"]), "lm_head": put(head, cdt)}


def init_kv_cache(cfg: LlamaConfig, batch: int, max_length: int,
                  device: str | torch.device = "cuda") -> dict:
    """Preallocated cache: k/v [L, B, S_max, Hkv, hd] in compute dtype."""
    shape = (cfg.num_hidden_layers, batch, max_length, cfg.kv_heads, cfg.head_dim)
    cdt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def init_kv_pool(cfg: LlamaConfig, num_blocks: int, block_size: int,
                 kv_dtype: str | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Preallocated block arena: k/v ``[L, num_blocks, block_size, Hkv,
    hd]``. ``kv_dtype="int8"`` stores int8 values plus per-(layer, block,
    row) float32 scales ``ks``/``vs`` ``[L, num_blocks, block_size]``;
    otherwise the compute dtype (paged-fp)."""
    shape = (cfg.num_hidden_layers, num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "vs": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    cdt = dtype_of(kv_dtype or cfg.dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def kv_bytes_per_token(cfg: LlamaConfig, kv_dtype: str | None = None) -> int:
    """Device bytes one cached token position costs: K+V rows across all
    layers, plus the per-row scales in int8 mode."""
    row = cfg.num_hidden_layers * cfg.kv_heads * cfg.head_dim
    if kv_dtype == "int8":
        return 2 * row + 2 * cfg.num_hidden_layers * 4  # int8 + f32 scales
    return 2 * row * dtype_of(kv_dtype or cfg.dtype).itemsize


def _quantize_rows(rows: torch.Tensor):
    """``[..., Hkv, hd]`` float rows -> (int8 rows, float32 scale
    ``[...]``): symmetric per-row quantization at amax/127, in float32.
    The amax floor keeps all-zero rows (never-written cache) at scale ~0
    without a divide-by-zero. ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the bits are the JAX package's."""
    f = rows.float()
    amax = f.abs().amax(dim=(-2, -1))
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale[..., None, None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor, cdt) -> torch.Tensor:
    return (q.float() * scale[..., None, None]).to(cdt)


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., in] @ w [in, out]``. On the CPU a product of one row goes
    to BLAS's matrix-vector routine, which sums in another order than the
    matrix-matrix one two or more rows take: a zero row is added there, so
    a row's bits do not depend on how many rows share the call (a solo
    ``generate()`` row and the engine's B-slot tick must agree)."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.shape[0] == 1 and x2.device.type == "cpu":
        out = torch.matmul(torch.cat([x2, torch.zeros_like(x2)]), w)[:1]
    else:
        out = torch.matmul(x2, w)
    return out.reshape(*lead, out.shape[-1])


def _mlp(cfg: LlamaConfig, x: torch.Tensor, layer: dict,
         valid: torch.Tensor | None = None) -> torch.Tensor:
    """The norm + (SwiGLU | MoE) residual half of a decoder layer: x [B,
    T, d]; ``valid`` [B, T] marks the tokens that claim expert capacity
    (None: all). The MoE half is the training forward's ``moe_mlp`` at a
    worker axis of 1."""
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    if cfg.num_experts:
        y = moe_mlp(cfg, h[None], {k: v[None] for k, v in layer.items()},
                    valid=None if valid is None else valid[None])[0]
        return x + y[0]
    gate = F.silu(_linear(h, layer["w_gate"]))
    return x + _linear(gate * _linear(h, layer["w_up"]), layer["w_down"])


def _layer(params: Params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _attend_dense(qg, ck, cv, mask, cdt):
    """Grouped GQA attention against a whole cache, softmax in float32:
    qg [B, T, Hkv, G, hd], ck/cv [B, S, Hkv, hd], mask [B, 1, T, S]
    additive. Returns [B, T, H*hd]."""
    b, t, nkv, g, hd = qg.shape
    scores = torch.einsum("btkgd,bskd->bkgts", qg, ck).float()
    scores = scores * (1.0 / math.sqrt(hd)) + mask[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(cdt)
    attn = torch.einsum("bkgts,bskd->btkgd", probs, cv)
    return attn.reshape(b, t, nkv * g * hd)


def _logits(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _linear(x, params["lm_head"]).float()


def _cached_block(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,      # [B, T] int: T = prompt length (prefill) or 1
    cache: dict,               # k/v [L, B, S_alloc, Hkv, hd], written in place
    pos: int,                  # write offset into the cache
    key_valid: torch.Tensor,   # [B, S_alloc] 1 = cache position holds a real token
    block: int = 0,            # 0 = dense scores over the full cache; >0 =
                               # online softmax over cache blocks
    last_index: int | None = None,  # row of [0, T) whose logits to return
                                    # (None = the last)
    token_valid: torch.Tensor | None = None,  # [B, T] 1 = a real input token
                                              # (MoE capacity; None = all)
):
    """Run the decoder over ``tokens``, writing their K/V into the cache
    at ``pos``. Returns (logits [B, V] float32 of one position, the
    cache). ``params`` come from ``serving_params``.

    With ``block > 0`` the scores exist one ``[*, block]`` tile at a time
    and the tile loop stops at the live prefix ``pos + T``."""
    cdt = dtype_of(cfg.dtype)
    b, t = tokens.shape
    s_max = cache["k"].shape[2]
    nh, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    g = nh // nkv
    if block and s_max % block:
        raise ValueError(f"cache length {s_max} not a multiple of block {block}")
    if not 0 <= pos <= s_max - t:
        raise ValueError(f"writing {t} positions at {pos} overruns the cache ({s_max})")
    dev = tokens.device

    x = params["embed"][tokens].to(cdt)
    cos, sin = rope_tables(cfg, t, offset=pos, device=dev)
    qi = pos + torch.arange(t, device=dev)  # [T] global query positions
    if not block:
        ki = torch.arange(s_max, device=dev)
        ok = (ki[None, None, :] <= qi[None, :, None]) & (key_valid[:, None, :] > 0)
        mask = torch.where(ok, 0.0, MASK_VALUE)[:, None]  # [B, 1, T, S]

    def attn_blockwise(qg, ck, cv):
        # query rows fold (G, T) position-fastest so finalize_grouped
        # restores the HF head order h = hkv * G + g
        qr = qg.permute(0, 2, 3, 1, 4).reshape(b, nkv, g * t, hd)
        o = torch.zeros((b, nkv, g * t, hd), dtype=torch.float32, device=dev)
        l = torch.zeros((b, nkv, g * t), dtype=torch.float32, device=dev)
        m = torch.full((b, nkv, g * t), -math.inf, dtype=torch.float32, device=dev)
        for j in range(-(-(pos + t) // block)):  # blocks meeting [0, pos + T)
            off = j * block
            kvj = key_valid[:, off:off + block]
            ki = off + torch.arange(block, device=dev)
            ok = (ki[None, None, :] <= qi[None, :, None]) & (kvj[:, None, :] > 0)
            s = torch.einsum("bhqd,bkhd->bhqk", qr, ck[:, off:off + block]).float()
            okr = ok[:, None, None].expand(b, 1, g, t, block).reshape(b, 1, g * t, block)
            s = torch.where(okr, s * (1.0 / math.sqrt(hd)), -math.inf)
            o, l, m = block_update(o, l, m, s, cv[:, off:off + block].permute(0, 2, 1, 3))
        return finalize_grouped(o, l, g, cdt).reshape(b, t, nh * hd)

    for i in range(cfg.num_hidden_layers):
        layer = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q = apply_rope(_linear(h, layer["wq"]).reshape(b, t, nh, hd), cos, sin)
        k = apply_rope(_linear(h, layer["wk"]).reshape(b, t, nkv, hd), cos, sin)
        ck[:, pos:pos + t] = k
        cv[:, pos:pos + t] = _linear(h, layer["wv"]).reshape(b, t, nkv, hd)
        qg = q.reshape(b, t, nkv, g, hd)
        attn = attn_blockwise(qg, ck, cv) if block else _attend_dense(qg, ck, cv, mask, cdt)
        x = _mlp(cfg, x + _linear(attn, layer["wo"]), layer, token_valid)
    xl = x[:, -1 if last_index is None else last_index]
    return _logits(params, cfg, xl), cache


def _auto_decode_block(context_len: int) -> int:
    """Dense scores below 1024 positions of context, 512-key
    online-softmax tiles from 1024 up."""
    return 512 if context_len >= 1024 else 0


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32), in 16-bit
    halves so that no product leaves int64: exact on every device."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise_uniforms(seeds, streams, steps, vocab: int,
                   device: str | torch.device) -> torch.Tensor:
    """[B, vocab] float32 uniforms in (0, 1): row b hashes (seeds[b],
    streams[b], steps[b], vocabulary index) with integer ops alone, so the
    bits are the same on the CPU and on the card, and depend on nothing
    but those four numbers."""
    cols = np.array([[int(s) & _M32 for s in seeds],
                     [(int(s) >> 32) & _M32 for s in seeds],
                     np.asarray(streams, np.int64) & _M32,
                     np.asarray(steps, np.int64) & _M32], dtype=np.int64)
    c = torch.as_tensor(cols, device=device)
    key = _fmix32(c[0] ^ 0x243F6A88)
    key = _fmix32(key ^ c[1])
    key = _fmix32(key ^ _mul32(c[2], 0x9E3779B1))
    key = _fmix32(key ^ _mul32(c[3], 0x7FEB352D))
    v = torch.arange(vocab, dtype=torch.int64, device=device)
    h = _fmix32(_fmix32(key[:, None] ^ _mul32(v, 0x846CA68B)[None, :]) ^ key[:, None])
    return ((h >> 8).float() + 0.5) * (2.0 ** -24)


def gumbel_noise(seeds, streams, steps, vocab: int,
                 device: str | torch.device) -> torch.Tensor:
    """[B, vocab] float32 Gumbel noise ``-log(-log(u))`` of
    ``noise_uniforms``; the logs run in float64, so the float32 noise is
    the same on the CPU and the card unless the two libm's float64 logs
    straddle a float32 rounding boundary."""
    u = noise_uniforms(seeds, streams, steps, vocab, device).double()
    return (-torch.log(-torch.log(u))).float()


def _sample_slots(logits, noise, temperature, top_k, top_p):
    """Per-row sampling: [B, V] logits with per-row ``temperature``,
    ``top_k`` and ``top_p`` (host numpy arrays) -> [B] int32. The JAX
    op sequence: divide by the temperature, cut below the k-th largest
    scaled logit, cut below the nucleus threshold over the top-k
    survivors (a sorted token is in the nucleus iff the mass strictly
    before it is < p), then ``argmax(logits + noise)``. Temperature 0 =
    greedy, top_k 0 = no cut, top_p >= 1 = no nucleus.

    The gates branch on the host arrays, never on a device value: an
    all-greedy batch runs argmax alone (``noise`` may then be None), and
    a batch without top-k or top-p skips both vocabulary sorts. Bit-exact
    by construction: a skipped filter is one whose threshold was -inf,
    and a skipped draw is one the final ``temperature > 0`` select would
    discard. Thresholds are values, not indices, and argmax returns the
    first maximal index, as ``jnp.argmax`` does."""
    temperature = np.asarray(temperature, np.float32).reshape(-1)
    top_k = np.asarray(top_k, np.int64).reshape(-1)
    top_p = np.asarray(top_p, np.float32).reshape(-1)
    greedy = logits.argmax(dim=-1).int()
    if not (temperature > 0).any():
        return greedy
    if noise is None:
        raise ValueError("sampling with temperature > 0 needs its noise")
    dev, v = logits.device, logits.shape[-1]
    t = torch.as_tensor(temperature, device=dev)[:, None]
    scaled = logits / torch.where(t > 0, t, torch.ones_like(t))
    if (top_k > 0).any() or (top_p < 1.0).any():
        sl = torch.sort(scaled, dim=-1, descending=True).values
        kidx = torch.as_tensor(np.clip(top_k - 1, 0, v - 1), device=dev)[:, None]
        kth = torch.gather(sl, -1, kidx)
        kth = torch.where(torch.as_tensor(top_k > 0, device=dev)[:, None], kth, -math.inf)
        filt = torch.where(scaled < kth, MASK_VALUE, scaled)
        sl2 = torch.sort(filt, dim=-1, descending=True).values
        probs = torch.softmax(sl2, dim=-1)
        p = torch.as_tensor(top_p, device=dev)[:, None]
        keep = (torch.cumsum(probs, dim=-1) - probs) < p
        thresh = torch.where(keep, sl2, math.inf).amin(dim=-1, keepdim=True)
        thresh = torch.where(p < 1.0, thresh, -math.inf)
        scaled = torch.where(filt < thresh, MASK_VALUE, filt)
    drawn = (scaled + noise).argmax(dim=-1).int()
    return torch.where(t[:, 0] > 0, drawn, greedy)


def _sample(logits, noise, temperature: float, top_k: int, top_p: float = 1.0):
    """[B, V] logits -> [B] int32 with one sampling setting for every row:
    temperature 0 = greedy (``noise`` unused); ``top_k`` keeps the k best
    logits; ``top_p`` < 1 keeps the smallest set whose mass reaches p
    (after top_k, both post-temperature). The same op sequence as
    ``_sample_slots``, which it runs with the setting on every row, so a
    solo ``generate()`` row and an engine slot sample alike."""
    b = logits.shape[0]
    return _sample_slots(logits, noise, np.full(b, temperature, np.float32),
                         np.full(b, top_k, np.int64), np.full(b, top_p, np.float32))


def _sample_one(logits, noise, temperature: float, top_k: int, top_p: float):
    """One row's sample: the prefill side of the engine."""
    return _sample_slots(logits, noise, [temperature], [top_k], [top_p])[0]


# ---------------------------------------------------------------------------
# One-shot generation
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate(
    params: Params,
    prompt,
    cfg: LlamaConfig,
    max_new_tokens: int,
    *,
    prompt_valid=None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int | None = None,
    stop_token: int | None = None,
    decode_block: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` [B, P].

    Returns the new tokens [B, max_new_tokens] int32 on ``device``.
    ``temperature=0`` is greedy; otherwise pass ``seed`` (and optionally
    ``top_k`` and/or nucleus ``top_p``). Row b's noise is
    ``gumbel_noise(seed, b, step)``, step 0 for the prefill's token, so
    a one-row call with seed s samples what an engine request with seed s
    does. ``prompt_valid`` [B, P] marks real tokens of left-padded prompts
    (default: all real). ``stop_token`` pins a row to that token once
    emitted (truncate at the first stop token). ``decode_block``: None
    picks dense scores below 1024 positions and 512-key online-softmax
    tiles from there; 0 forces dense. Runs on the card unless
    ``device="cpu"``; the parameters are moved and cast there once per
    call (``serving_params``)."""
    if cfg.num_experts and cfg.router_type == "experts_choose":
        raise ValueError(
            "expert-choice routing is training-only: expert top-C token "
            "selection sees the whole token set, so prefill and per-step "
            "decode route differently; use router_type='tokens_choose' for sampling"
        )
    _check_supported(cfg)
    prompt = torch.as_tensor(prompt)
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be [batch, prompt_len]; got {tuple(prompt.shape)}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1; got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0; got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0; got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
    top_k = min(int(top_k), cfg.vocab_size)  # top-k over everything == no cut
    if temperature > 0.0 and seed is None:
        raise ValueError("stochastic sampling (temperature > 0) requires a seed")
    if decode_block is None:
        decode_block = _auto_decode_block(prompt.shape[1] + max_new_tokens)
    elif decode_block < 0:
        raise ValueError(f"decode_block must be >= 0; got {decode_block}")
    device = resolve_device(device)
    params = serving_params(params, cfg, device)
    prompt = prompt.to(device=device, dtype=torch.long)
    b, p = prompt.shape
    n = int(max_new_tokens)
    if prompt_valid is None:
        prompt_valid = torch.ones((b, p), dtype=torch.int32, device=device)
    prompt_valid = torch.as_tensor(prompt_valid).to(device=device, dtype=torch.int32)
    s_max = p + n
    # blockwise attention needs a block-aligned cache; the extra slots are
    # causally unreachable (their index exceeds every query position)
    s_alloc = -(-s_max // decode_block) * decode_block if decode_block else s_max
    cache = init_kv_cache(cfg, b, s_alloc, device)
    key_valid = torch.cat([
        prompt_valid,
        torch.ones((b, n), dtype=torch.int32, device=device),
        torch.zeros((b, s_alloc - s_max), dtype=torch.int32, device=device),
    ], dim=1)
    rows = np.arange(b)

    def sample(logits, step):
        noise = (gumbel_noise([seed] * b, rows, [step] * b, cfg.vocab_size, device)
                 if temperature > 0 else None)
        return _sample(logits, noise, temperature, top_k, top_p)

    logits, cache = _cached_block(params, cfg, prompt, cache, 0, key_valid, block=decode_block,
                                  token_valid=prompt_valid)
    tok = sample(logits, 0)
    out = [tok]
    done = tok == stop_token if stop_token is not None else None
    for step in range(1, n):
        logits, cache = _cached_block(params, cfg, tok[:, None].long(), cache, p + step - 1,
                                      key_valid, block=decode_block)
        nxt = sample(logits, step)
        if stop_token is not None:
            # finished rows keep emitting the stop token
            nxt = torch.where(done, torch.full_like(nxt, stop_token), nxt)
            done = done | (nxt == stop_token)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def pad_prompts(prompts: list[list[int]], pad_id: int = 0):
    """Left-pad variable-length prompts to a common length; returns
    (tokens [B, P] int32, valid [B, P] int32) CPU tensors for
    ``generate``. An empty row is allowed (all pad, valid all zero); an
    empty list is not."""
    if not prompts:
        raise ValueError("pad_prompts needs at least one prompt")
    p = max(len(x) for x in prompts)
    toks = np.full((len(prompts), p), pad_id, np.int32)
    valid = np.zeros((len(prompts), p), np.int32)
    for i, x in enumerate(prompts):
        if len(x):
            toks[i, p - len(x):] = x
            valid[i, p - len(x):] = 1
    return torch.from_numpy(toks), torch.from_numpy(valid)


# ---------------------------------------------------------------------------
# Slot-addressed serving programs (serve/engine.py)
#
# The continuous-batching engine owns ONE dense cache [L, B, S_max, Hkv,
# hd] whose B rows are independent request slots. The programs of a
# request's life:
#   - prefill_chunk_fn: one CHUNK of a prompt into its slot at an offset,
#     through the same ``_cached_block`` the one-shot prefill runs, and
#     the token sampled from the chunk's last real position;
#   - decode_slots_fn: every slot one token at PER-SLOT positions and
#     sampling settings (``_verify_slots_block`` at T = 1);
#   - extract_chunk_fn / insert_chunk_fn: copy one chunk of a slot's K/V
#     rows out of / into the cache (the prefix cache's two halves);
#   - verify_slots_fn: the speculative tick, T = k + 1 positions per slot.
# The paged twins over a block arena follow below.
# ---------------------------------------------------------------------------


def _slot_rope(cfg: LlamaConfig, qpos: torch.Tensor, cdt):
    """cos/sin [B, T, 1, hd] in the compute dtype for per-(slot, position)
    query positions ``qpos`` [B, T]."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=qpos.device) / hd))
    freqs = qpos.float()[..., None] * inv_freq            # [B, T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)               # [B, T, hd]
    return torch.cos(emb)[:, :, None, :].to(cdt), torch.sin(emb)[:, :, None, :].to(cdt)


def _rope_rows(a, cos, sin):
    """Rotate-half RoPE of ``a`` [B, T, H, hd] with per-row phases."""
    half = a.shape[-1] // 2
    return a * cos + torch.cat([-a[..., half:], a[..., :half]], dim=-1) * sin


def _slot_valid(cfg: LlamaConfig, active, t: int, device) -> torch.Tensor | None:
    """[B, T]: a slot program's tokens that claim MoE capacity, the live
    slots' rows (``active`` [B] host ints broadcast over T); None for a
    dense model."""
    if not cfg.num_experts:
        return None
    live = torch.as_tensor(np.asarray(active).reshape(-1) > 0, device=device)
    return live[:, None].expand(-1, t).int()


def _verify_slots_block(params: Params, cfg: LlamaConfig, tokens, cache, pos, key_valid,
                        active):
    """The decoder over ``tokens`` [B, T] at PER-SLOT positions
    ``pos..pos+T-1``: per-row RoPE phases, the causal + ``key_valid``
    mask, and K/V written only for live slots (``active``), by index, so
    a dead slot's rows (a neighbour mid-prefill) stay as they are and no
    pass over the whole cache is made. Each query's attention is the
    reduction a T = 1 tick performs (later rows are causally masked), so
    a T-wide call verifies T positions at once. Positions at or past the
    row's end are not written. ``pos`` and ``active`` are host int
    arrays [B]. Returns (logits [B, T, V] float32, the cache)."""
    cdt = dtype_of(cfg.dtype)
    b, t = tokens.shape
    s_max = cache["k"].shape[2]
    nh, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    g = nh // nkv
    dev = tokens.device
    pos = np.asarray(pos, np.int64).reshape(-1)
    live = np.flatnonzero(np.asarray(active).reshape(-1) > 0)
    if live.size and (pos[live].min() < 0 or pos[live].max() >= s_max):
        raise ValueError(f"slot positions {pos[live].tolist()} lie outside the cache ({s_max})")

    x = params["embed"][tokens].to(cdt)  # [B, T, d]
    qpos_np = pos[:, None] + np.arange(t)[None, :]
    qpos = torch.as_tensor(qpos_np, device=dev)
    cos, sin = _slot_rope(cfg, qpos, cdt)
    ki = torch.arange(s_max, device=dev)
    ok = (ki[None, None, :] <= qpos[:, :, None]) & (key_valid[:, None, :] > 0)
    mask = torch.where(ok, 0.0, MASK_VALUE)[:, None]      # [B, 1, T, S]
    # the live slots' rows, one index pair per (slot, position); a verify
    # window's tail past the row is dropped, as the JAX program's masked
    # write drops it (those positions can never be emitted)
    wb_np, wj_np = np.nonzero((qpos_np < s_max) & (np.asarray(active).reshape(-1, 1) > 0))
    wb = torch.as_tensor(wb_np, device=dev)
    wj = torch.as_tensor(wj_np, device=dev)
    wp = torch.as_tensor(qpos_np[wb_np, wj_np], device=dev)
    token_valid = _slot_valid(cfg, active, t, dev)

    for i in range(cfg.num_hidden_layers):
        layer = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q = _rope_rows(_linear(h, layer["wq"]).reshape(b, t, nh, hd), cos, sin)
        k = _rope_rows(_linear(h, layer["wk"]).reshape(b, t, nkv, hd), cos, sin)
        v = _linear(h, layer["wv"]).reshape(b, t, nkv, hd)
        ck[wb, wp] = k[wb, wj]
        cv[wb, wp] = v[wb, wj]
        attn = _attend_dense(q.reshape(b, t, nkv, g, hd), ck, cv, mask, cdt)
        x = _mlp(cfg, x + _linear(attn, layer["wo"]), layer, token_valid)
    return _logits(params, cfg, x), cache


def _decode_slots_block(params, cfg: LlamaConfig, tokens, cache, pos, key_valid, active):
    """One decode step for B independent slots: ``tokens`` [B] at
    per-slot positions ``pos`` [B], the T = 1 case of
    ``_verify_slots_block``. Returns (logits [B, V] float32, the cache)."""
    logits, cache = _verify_slots_block(params, cfg, tokens[:, None], cache, pos, key_valid,
                                        active)
    return logits[:, 0], cache


def prefill_chunk_fn(cfg: LlamaConfig):
    """``(params, cache, chunk [1, C], slot, pos, last_idx, noise,
    temperature, top_k, top_p, chunk_valid=None) -> (token [] int32,
    logits [1, V] float32, cache)``: run ONE chunk of a prompt through
    the decoder, writing its K/V into slot ``slot`` at ``[pos, pos + C)``
    and attending causally over everything already written, and sample a
    token from the logits at ``last_idx`` (an interior chunk's sample is
    discarded by the caller). Every cache position reads as valid: a slot
    is never left-padded, and positions at or after the live prefix are
    causally masked. Pad tokens of a final chunk write past the prompt,
    where decode overwrites them before any query can see them;
    ``chunk_valid`` [1, C] marks them 0 so that they claim no MoE
    capacity."""

    @torch.no_grad()
    def run(params, cache, chunk, slot, pos, last_idx, noise, temperature, top_k, top_p,
            chunk_valid=None):
        sub = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1]}
        key_valid = torch.ones((1, sub["k"].shape[2]), dtype=torch.int32, device=chunk.device)
        logits, _ = _cached_block(params, cfg, chunk, sub, pos, key_valid, block=0,
                                  last_index=last_idx, token_valid=chunk_valid)
        tok = _sample_one(logits, noise, temperature, top_k, top_p)
        return tok, logits, cache

    return run


def extract_chunk_fn(cfg: LlamaConfig):
    """``(cache, slot, pos, size) -> (k, v)`` copies ``[L, size, Hkv,
    hd]`` of one slot's rows from ``pos``: the prefix cache's insert
    path."""

    def run(cache, slot, pos, size):
        if pos + size > cache["k"].shape[2]:
            raise ValueError(f"rows [{pos}, {pos + size}) overrun the cache")
        return (cache["k"][:, slot, pos:pos + size].clone(),
                cache["v"][:, slot, pos:pos + size].clone())

    return run


def insert_chunk_fn(cfg: LlamaConfig):
    """``(cache, k [L, n, Hkv, hd], v, slot, pos) -> cache``: write a
    cached prefix chunk's rows into a slot, the prefix cache's hit path.
    The rows came from the same chunk program over the same tokens at
    the same positions, so a hit gives the bits a re-prefill would."""

    def run(cache, k, v, slot, pos):
        n = k.shape[1]
        if pos + n > cache["k"].shape[2]:
            raise ValueError(f"rows [{pos}, {pos + n}) overrun the cache")
        cache["k"][:, slot, pos:pos + n] = k
        cache["v"][:, slot, pos:pos + n] = v
        return cache

    return run


def decode_slots_fn(cfg: LlamaConfig):
    """``(params, cache, tokens [B], pos [B], key_valid [B, S], noise,
    temperature [B], top_k [B], top_p [B], active [B]) -> (next tokens
    [B] int32, cache)``: one tick advancing every slot, sampling
    included. ``pos``, ``active`` and the sampling settings are host
    arrays; ``noise`` is None when every slot is greedy."""

    @torch.no_grad()
    def run(params, cache, tokens, pos, key_valid, noise, temperature, top_k, top_p, active):
        logits, cache = _decode_slots_block(params, cfg, tokens, cache, pos, key_valid, active)
        return _sample_slots(logits, noise, temperature, top_k, top_p), cache

    return run


# ---------------------------------------------------------------------------
# Speculative verification (serve/speculation.py proposes the drafts)
#
# One forward verifies up to k host-proposed drafts per slot: the inputs
# are [current token, d_0..d_{k-1}] at per-slot positions pos..pos+k, the
# logits come back for all k+1 positions, each position samples with the
# noise the plain tick would have drawn at that step, and the longest
# draft prefix equal to the sampled targets is accepted. For a
# deterministic proposal (prompt lookup is a point mass) this exact-match
# rule is rejection sampling, so a speculative stream is the plain stream
# token for token, greedy or sampled. A tick emits m + 1 tokens per slot
# (m accepted drafts and the verified target): never zero.
#
# Rollback is cursor arithmetic: K/V rows written for rejected or pad
# positions lie past the advanced cursor, inside the slot's own rows (or
# dropped), and every later tick rewrites its window before any query
# can reach them.
# ---------------------------------------------------------------------------


def _sample_slots_multi(logits, noise, temperature, top_k, top_p):
    """``_sample_slots`` over [B, T, V] logits: rows flatten to B*T
    (b-major) and run the same per-row op sequence, so position j of slot
    b samples what the plain tick would at that step given the same
    noise (``noise`` [B*T, V], or None when every slot is greedy).
    Returns [B, T] int32."""
    b, t, v = logits.shape
    rep = lambda a: np.repeat(np.asarray(a).reshape(-1), t)  # [B] -> [B*T]
    flat = _sample_slots(logits.reshape(b * t, v), noise, rep(temperature), rep(top_k),
                         rep(top_p))
    return flat.reshape(b, t)


def _accept_prefix(tokens, sampled, draft_len):
    """Emission counts [B]: drafts are ``tokens[:, 1:]``, targets
    ``sampled[:, :-1]``; ``m`` = leading positions where they agree
    (positions past ``draft_len`` never match), and the tick emits
    ``m + 1`` tokens: ``sampled[:, :m]`` (the accepted drafts) plus
    ``sampled[:, m]``."""
    k = tokens.shape[1] - 1
    draft_len = torch.as_tensor(np.asarray(draft_len), device=tokens.device)
    match = (tokens[:, 1:] == sampled[:, :-1]) & (
        torch.arange(k, device=tokens.device)[None, :] < draft_len[:, None])
    return torch.cumprod(match.int(), dim=1).sum(dim=1) + 1


def verify_slots_fn(cfg: LlamaConfig):
    """``(params, cache, tokens [B, T], pos [B], draft_len [B], key_valid
    [B, S], noise [B*T, V] | None, temperature [B], top_k [B], top_p [B],
    active [B]) -> (sampled [B, T] int32, counts [B], cache)``: one
    speculative tick. ``tokens`` = [current token, drafts...] per slot;
    ``counts[b]`` leading tokens of ``sampled[b]`` are the slot's
    emission. ``pos``, ``draft_len``, ``active`` and the settings are
    host arrays."""

    @torch.no_grad()
    def run(params, cache, tokens, pos, draft_len, key_valid, noise, temperature, top_k,
            top_p, active):
        logits, cache = _verify_slots_block(params, cfg, tokens, cache, pos, key_valid, active)
        sampled = _sample_slots_multi(logits, noise, temperature, top_k, top_p)
        return sampled, _accept_prefix(tokens, sampled, draft_len), cache

    return run


# ---------------------------------------------------------------------------
# The paged arena (serve/engine.py, kv_block_size > 0)
#
# K/V live in one arena [L, num_blocks, block_size, Hkv, hd]; a slot's
# rows are the blocks its table names, in order. Unused table entries
# hold the sentinel ``num_blocks``. The JAX programs lean on XLA's index
# rules: a gather clamps the sentinel (the rows read are causally dead),
# a scatter with mode="drop" discards writes to it. PyTorch raises on an
# out-of-range index on the CPU and trips a device-side assert on the
# card, so here the read index is clamped on purpose and the write set
# is filtered to real blocks on the host before it becomes an index.
#
# int8 (paged only): int8 K/V plus one float32 scale per (layer, block,
# row), quantized on write and dequantized in the attention read. Per-row
# scales mean an appended token never requantizes earlier rows.
# ---------------------------------------------------------------------------


def _read_index(tables, num_blocks: int, device) -> torch.Tensor:
    """Block tables (host ints, sentinel ``num_blocks``) -> the gather
    index on ``device``, sentinels clamped to the last block as XLA's
    gather clamps them: those rows are never causally reachable."""
    return torch.as_tensor(np.minimum(np.asarray(tables, np.int64), num_blocks - 1),
                           device=device)


def _gather_rows(rows: torch.Tensor, scales: torch.Tensor | None, idx: torch.Tensor,
                 cdt) -> torch.Tensor:
    """Arena rows ``[..., nb, bs, Hkv, hd]`` gathered on the block axis
    through ``idx``, in the compute dtype; int8 rows are dequantized with
    their ``scales`` ``[..., nb, bs]``."""
    lead = (slice(None),) * (rows.ndim - 4)
    if scales is None:
        return rows[lead + (idx,)].to(cdt)
    return _dequantize_rows(rows[lead + (idx,)], scales[lead + (idx,)], cdt)


def prefill_chunk_paged_fn(cfg: LlamaConfig, kv_dtype: str | None = None):
    """Paged twin of ``prefill_chunk_fn``: ``(params, pool, table
    [max_blocks] host ints, chunk [1, C], pos, last_idx, noise,
    temperature, top_k, top_p, chunk_valid=None) -> (token, logits [1,
    V], pool)``. Gathers the slot's dense view through its table, runs
    ``_cached_block`` unchanged (paged-fp logits are the dense path's
    bits) and scatters back only the touched blocks: ``C // block + 1``
    blocks from the one holding ``pos``, which covers an unaligned start
    (the bucket-overflow re-feed) and costs one identity rewrite of
    gathered rows when ``pos`` is aligned. Touched table entries that are
    sentinels (pad rows past the slot's allocation) are dropped. int8
    mode dequantizes the gather and quantizes the scattered rows per
    row."""
    quant = kv_dtype == "int8"
    cdt = dtype_of(cfg.dtype)

    @torch.no_grad()
    def run(params, pool, table, chunk, pos, last_idx, noise, temperature, top_k, top_p,
            chunk_valid=None):
        l, nb, bs, nkv, hd = pool["k"].shape
        table = np.asarray(table, np.int64).reshape(-1)
        mb = table.shape[0]
        dev = chunk.device
        idx = _read_index(table, nb, dev)
        sub = {n: _gather_rows(pool[n], pool.get(sn) if quant else None, idx, cdt).reshape(
                   l, 1, mb * bs, nkv, hd) for n, sn in (("k", "ks"), ("v", "vs"))}
        key_valid = torch.ones((1, mb * bs), dtype=torch.int32, device=dev)
        logits, sub = _cached_block(params, cfg, chunk, sub, pos, key_valid, block=0,
                                    last_index=last_idx, token_valid=chunk_valid)
        c = chunk.shape[1]
        n_touch = min(c // bs + 1, mb) if c >= bs else 1
        b0 = min(pos // bs, mb - n_touch)
        phys = table[b0:b0 + n_touch]
        keep = np.flatnonzero(phys < nb)
        if keep.size:
            wphys = torch.as_tensor(phys[keep], device=dev)
            wkeep = torch.as_tensor(keep, device=dev)
            for name, sname in (("k", "ks"), ("v", "vs")):
                w = sub[name][:, 0, b0 * bs:(b0 + n_touch) * bs].reshape(
                    l, n_touch, bs, nkv, hd)[:, wkeep]
                if quant:
                    q, sc = _quantize_rows(w)
                    pool[name][:, wphys] = q
                    pool[sname][:, wphys] = sc
                else:
                    pool[name][:, wphys] = w.to(pool[name].dtype)
        tok = _sample_one(logits, noise, temperature, top_k, top_p)
        return tok, logits, pool

    return run


def _verify_slots_paged_block(params: Params, cfg: LlamaConfig, tokens, pool, tables, pos,
                              active, quant: bool):
    """``_verify_slots_block`` over the block arena: each of the T new
    rows of a slot is written at its own physical (block, row) address,
    resolved per position (a verify window may cross a block boundary),
    before the gather, inside the layer loop. Inactive slots and
    positions past a slot's allocation (sentinel entries) are not
    written. ``tables`` [B, max_blocks], ``pos`` and ``active`` are host
    int arrays. Returns (logits [B, T, V] float32, pool)."""
    cdt = dtype_of(cfg.dtype)
    b, t = tokens.shape
    _l, nb, bs, nkv, hd = pool["k"].shape
    tables = np.asarray(tables, np.int64)
    mb = tables.shape[1]
    s_view = mb * bs
    nh = cfg.num_attention_heads
    g = nh // nkv
    dev = tokens.device
    read = _read_index(tables, nb, dev)
    pos = np.asarray(pos, np.int64).reshape(-1)

    x = params["embed"][tokens].to(cdt)  # [B, T, d]
    qpos_np = pos[:, None] + np.arange(t)[None, :]
    qpos = torch.as_tensor(qpos_np, device=dev)
    cos, sin = _slot_rope(cfg, qpos, cdt)
    ki = torch.arange(s_view, device=dev)
    mask = torch.where(ki[None, None, :] <= qpos[:, :, None], 0.0, MASK_VALUE)[:, None]
    # per-(slot, position) physical addresses, resolved on the host; the
    # write set keeps live slots' rows that land on a real block
    bi = np.clip(qpos_np // bs, 0, mb - 1)
    phys = np.take_along_axis(tables, bi, axis=1)
    phys = np.where(np.asarray(active).reshape(-1, 1) > 0, phys, nb)
    wb_np, wj_np = np.nonzero(phys < nb)
    wb = torch.as_tensor(wb_np, device=dev)
    wj = torch.as_tensor(wj_np, device=dev)
    wphys = torch.as_tensor(phys[wb_np, wj_np], device=dev)
    woff = torch.as_tensor(qpos_np[wb_np, wj_np] % bs, device=dev)
    token_valid = _slot_valid(cfg, active, t, dev)

    for i in range(cfg.num_hidden_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q = _rope_rows(_linear(h, layer["wq"]).reshape(b, t, nh, hd), cos, sin)
        k = _rope_rows(_linear(h, layer["wk"]).reshape(b, t, nkv, hd), cos, sin)
        v = _linear(h, layer["wv"]).reshape(b, t, nkv, hd)
        arena = {n: a[i] for n, a in pool.items()}  # views: writes land in the pool
        for name, sname, rows in (("k", "ks", k), ("v", "vs", v)):
            rows = rows[wb, wj]
            if quant:
                qr, sc = _quantize_rows(rows)
                arena[name][wphys, woff] = qr
                arena[sname][wphys, woff] = sc
            else:
                arena[name][wphys, woff] = rows.to(arena[name].dtype)
        ck, cv = (_gather_rows(arena[n], arena.get(sn) if quant else None, read, cdt).reshape(
            b, s_view, nkv, hd) for n, sn in (("k", "ks"), ("v", "vs")))
        attn = _attend_dense(q.reshape(b, t, nkv, g, hd), ck, cv, mask, cdt)
        x = _mlp(cfg, x + _linear(attn, layer["wo"]), layer, token_valid)
    return _logits(params, cfg, x), pool


def _decode_slots_paged_block(params, cfg: LlamaConfig, tokens, pool, tables, pos, active,
                              quant: bool):
    """One decode step through the block arena: the T = 1 case of
    ``_verify_slots_paged_block``. Returns (logits [B, V] float32, pool)."""
    logits, pool = _verify_slots_paged_block(params, cfg, tokens[:, None], pool, tables, pos,
                                             active, quant)
    return logits[:, 0], pool


def decode_slots_paged_fn(cfg: LlamaConfig, kv_dtype: str | None = None):
    """Paged twin of ``decode_slots_fn``: ``(params, pool, tables [B,
    max_blocks] host ints, tokens [B], pos [B], noise, temperature [B],
    top_k [B], top_p [B], active [B]) -> (next tokens [B] int32, pool)``."""
    quant = kv_dtype == "int8"

    @torch.no_grad()
    def run(params, pool, tables, tokens, pos, noise, temperature, top_k, top_p, active):
        logits, pool = _decode_slots_paged_block(params, cfg, tokens, pool, tables, pos, active,
                                                 quant)
        return _sample_slots(logits, noise, temperature, top_k, top_p), pool

    return run


def verify_slots_paged_fn(cfg: LlamaConfig, kv_dtype: str | None = None):
    """Paged twin of ``verify_slots_fn``: ``(params, pool, tables, tokens
    [B, T], pos [B], draft_len [B], noise [B*T, V] | None, temperature,
    top_k, top_p, active) -> (sampled [B, T], counts [B], pool)``."""
    quant = kv_dtype == "int8"

    @torch.no_grad()
    def run(params, pool, tables, tokens, pos, draft_len, noise, temperature, top_k, top_p,
            active):
        logits, pool = _verify_slots_paged_block(params, cfg, tokens, pool, tables, pos, active,
                                                 quant)
        sampled = _sample_slots_multi(logits, noise, temperature, top_k, top_p)
        return sampled, _accept_prefix(tokens, sampled, draft_len), pool

    return run
