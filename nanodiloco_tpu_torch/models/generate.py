"""Autoregressive generation over a preallocated KV cache: port of the
dense half of ``nanodiloco_tpu/models/generate.py``.

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
  ``decode_slots_fn``, ``extract_chunk_fn``, ``insert_chunk_fn``) are
  plain functions that close over the config; they share
  ``_cached_block`` and ``_verify_slots_block`` with ``generate`` so the
  two paths cannot drift.

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
from nanodiloco_tpu_torch.ops.online_softmax import block_update, finalize_grouped

MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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

    layers = {k: put(v, cdt if k in MATMUL_KEYS else None)
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


def _mlp(cfg: LlamaConfig, x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The norm + SwiGLU residual half of a decoder layer (dense)."""
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
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
        x = _mlp(cfg, x + _linear(attn, layer["wo"]), layer)
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

    logits, cache = _cached_block(params, cfg, prompt, cache, 0, key_valid, block=decode_block)
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
#     rows out of / into the cache (the prefix cache's two halves).
# The paged arena, int8 KV and the speculative verify programs are not
# ported yet (ROADMAP.md, Queue A).
# ---------------------------------------------------------------------------


def _verify_slots_block(params: Params, cfg: LlamaConfig, tokens, cache, pos, key_valid,
                        active):
    """The decoder over ``tokens`` [B, T] at PER-SLOT positions
    ``pos..pos+T-1``: per-row RoPE phases, the causal + ``key_valid``
    mask, and K/V written only for live slots (``active``), by index, so
    a dead slot's rows (a neighbour mid-prefill) stay as they are and no
    pass over the whole cache is made. ``pos`` and ``active`` are host
    int arrays [B]. Returns (logits [B, T, V] float32, the cache)."""
    cdt = dtype_of(cfg.dtype)
    b, t = tokens.shape
    s_max = cache["k"].shape[2]
    nh, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    g = nh // nkv
    dev = tokens.device
    pos = np.asarray(pos, np.int64).reshape(-1)
    live = np.flatnonzero(np.asarray(active).reshape(-1) > 0)
    if live.size and (pos[live].min() < 0 or pos[live].max() + t > s_max):
        raise ValueError(f"slot positions {pos[live].tolist()} + {t} overrun the cache ({s_max})")

    x = params["embed"][tokens].to(cdt)  # [B, T, d]
    qpos_np = pos[:, None] + np.arange(t)[None, :]
    qpos = torch.as_tensor(qpos_np, device=dev)
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd))
    freqs = qpos.float()[..., None] * inv_freq            # [B, T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)               # [B, T, hd]
    cos = torch.cos(emb)[:, :, None, :].to(cdt)           # [B, T, 1, hd]
    sin = torch.sin(emb)[:, :, None, :].to(cdt)

    def rope(a):  # [B, T, H, hd] rotate-half with per-(slot, position) phases
        half = a.shape[-1] // 2
        return a * cos + torch.cat([-a[..., half:], a[..., :half]], dim=-1) * sin

    ki = torch.arange(s_max, device=dev)
    ok = (ki[None, None, :] <= qpos[:, :, None]) & (key_valid[:, None, :] > 0)
    mask = torch.where(ok, 0.0, MASK_VALUE)[:, None]      # [B, 1, T, S]
    # the live slots' rows, one index pair per (slot, position)
    wb = torch.as_tensor(np.repeat(live, t), device=dev)
    wp = torch.as_tensor(qpos_np[live].reshape(-1), device=dev)
    wsrc = torch.as_tensor(live, device=dev)

    for i in range(cfg.num_hidden_layers):
        layer = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q = rope(_linear(h, layer["wq"]).reshape(b, t, nh, hd))
        k = rope(_linear(h, layer["wk"]).reshape(b, t, nkv, hd))
        v = _linear(h, layer["wv"]).reshape(b, t, nkv, hd)
        ck[wb, wp] = k[wsrc].reshape(-1, nkv, hd)
        cv[wb, wp] = v[wsrc].reshape(-1, nkv, hd)
        attn = _attend_dense(q.reshape(b, t, nkv, g, hd), ck, cv, mask, cdt)
        x = _mlp(cfg, x + _linear(attn, layer["wo"]), layer)
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
    temperature, top_k, top_p) -> (token [] int32, logits [1, V] float32,
    cache)``: run ONE chunk of a prompt through the decoder, writing its
    K/V into slot ``slot`` at ``[pos, pos + C)`` and attending causally
    over everything already written, and sample a token from the logits
    at ``last_idx`` (an interior chunk's sample is discarded by the
    caller). Every cache position reads as valid: a slot is never
    left-padded, and positions at or after the live prefix are causally
    masked. Pad tokens of a final chunk write past the prompt, where
    decode overwrites them before any query can see them."""

    @torch.no_grad()
    def run(params, cache, chunk, slot, pos, last_idx, noise, temperature, top_k, top_p):
        sub = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1]}
        key_valid = torch.ones((1, sub["k"].shape[2]), dtype=torch.int32, device=chunk.device)
        logits, _ = _cached_block(params, cfg, chunk, sub, pos, key_valid, block=0,
                                  last_index=last_idx)
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
