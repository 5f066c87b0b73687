"""Slot-based continuous-batching engine over the dense KV cache: port of
the dense mode (``kv_block_size=0``) of ``nanodiloco_tpu/serve/engine.py``.

The engine owns ONE preallocated ``[L, B, S_max, Hkv, hd]`` cache whose
B rows are independent request slots (Orca-style iteration-level
scheduling, Yu et al., OSDI'22). A request's life:

- ``start_prefill(slot, request)`` stages the request into a free slot
  and, when the prefix cache holds the prompt's leading chunks, copies
  their K/V rows in (``insert_chunk_fn``).
- ``prefill_step(slot)`` runs ONE prefill chunk (Sarathi-Serve,
  arXiv:2403.02310: a long prompt never freezes the live decode streams
  between two ticks). The final chunk returns the first token. Chunk
  lengths are bucketed to powers of two, so mixed-length traffic runs a
  bounded set of program shapes.
- every ``step()`` advances ALL decoding slots with one call of the
  decode program (per-slot positions and sampling settings) and returns
  per-slot token lists; admitting or retiring a request never stops the
  other streams.
- ``release(slot)`` frees the row. Nothing is zeroed: a retired slot's
  stale K/V is causally unreachable to the next occupant.

Chunking math (why it is exact): K/V at position i depend only on
``tokens[:i+1]``, so writing them chunk by chunk gives the rows one
whole-prompt call writes; each chunk's queries attend causally over
everything already written, the reduction the one-shot prefill performs
row by row. The final chunk right-pads to its bucket and passes its last
REAL index; pad K/V land past the prompt, causally unreachable, then
overwritten by decode. The top bucket is capped at the largest power of
two <= max_len, and a padded final bucket that would still run past
``max_len`` re-feeds the prompt's last ``bucket`` tokens instead (same
tokens, same positions: the rewrite leaves the rows as they were).

Determinism contract: a request's token stream is the stream
``generate()`` produces alone with the same seed and sampling settings,
through chunked admission and through a prefix-cache hit. The noise of a
request is ``gumbel_noise(seed, 0, step)`` (``models/generate.py``):
step 0 is the prefill's sample and step j the j-th decode tick's, so it
depends on nothing but the request. On the CPU in float32 the streams are
token-identical; on the card, cuBLAS may pick other kernels for B slots
than for one row, so bf16 logits can differ in their last bits and a
stream may part from ``generate()`` at a near-tie.

Not ported yet (ROADMAP.md, Queue A), each refused with
NotImplementedError and never served by the dense path in its place:
the paged arena (``kv_block_size > 0``), int8 KV, speculative decoding
(``spec_k > 0``), tensor parallelism (``tp > 1``), ``swap_weights`` and
KV shipping (``export_kv`` / ``import_kv``); MoE configs are refused by
the model's own check.

All calls come from one thread (the scheduler's tick loop); every tensor
the engine makes names its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.generate import (
    decode_slots_fn,
    extract_chunk_fn,
    gumbel_noise,
    init_kv_cache,
    insert_chunk_fn,
    prefill_chunk_fn,
    serving_params,
)
from nanodiloco_tpu_torch.models.llama import _check_supported, resolve_device
from nanodiloco_tpu_torch.obs.devtime import DispatchAccountant
from nanodiloco_tpu_torch.serve.block_pool import BlocksExhausted
from nanodiloco_tpu_torch.serve.prefix_cache import PrefixCache

__all__ = ["InferenceEngine", "BlocksExhausted"]

_QUEUE_A = "is not ported yet (ROADMAP.md, Queue A)"


def _floor_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _ceil_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


@dataclasses.dataclass
class _Prefill:
    """One slot's in-flight prefill: the staged request plus the cursor
    into its prompt (``done`` tokens already have their K/V written)."""

    request: object
    ids: list[int]
    done: int


class InferenceEngine:
    """The slot backend the scheduler drives. Not thread-safe: all calls
    must come from one thread (the scheduler's tick loop). Runs on the
    card unless ``device="cpu"``. The JAX engine's arguments are all
    taken; ``kv_pool_blocks`` and ``spec_ngram`` matter only in the
    paged and speculative modes, which raise."""

    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        *,
        num_slots: int = 4,
        max_len: int = 1024,
        chunk_size: int = 64,
        prefix_cache_tokens: int = 0,
        kv_block_size: int = 0,
        kv_dtype: str | None = None,
        kv_pool_blocks: int | None = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        tp: int = 1,
        device: str | torch.device = "cuda",
    ) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1; got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2; got {max_len}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1; got {chunk_size}")
        if cfg.num_experts and cfg.router_type == "experts_choose":
            raise ValueError(
                "expert-choice routing is training-only (see generate()); "
                "use router_type='tokens_choose' for serving"
            )
        if kv_dtype not in (None, "model", "int8"):
            raise ValueError(f"kv_dtype must be 'model' or 'int8'; got {kv_dtype!r}")
        if kv_block_size:
            raise NotImplementedError(f"the paged KV arena (kv_block_size > 0) {_QUEUE_A}")
        if kv_dtype == "int8":
            raise NotImplementedError(f"int8 KV storage {_QUEUE_A}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0; got {spec_k}")
        if spec_k:
            raise NotImplementedError(f"speculative decoding (spec_k > 0) {_QUEUE_A}")
        if int(tp) < 1:
            raise ValueError(f"tp must be >= 1; got {tp}")
        if int(tp) > 1:
            raise NotImplementedError(f"tensor-parallel serving (tp > 1) {_QUEUE_A}")
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        # cast once here: the programs never re-cast a weight per tick
        self.params = serving_params(params, cfg, self.device)
        self.tp = 1                   # read by the scheduler's stats
        self.deploy_generation = 0    # likewise: no weight swaps yet
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        # chunk lengths are bucketed to powers of two; capping the top
        # bucket at the largest power of two <= max_len keeps every
        # bucketed write inside the slot row
        self.chunk_size = _floor_pow2(min(int(chunk_size), self.max_len))
        self.vocab_size = cfg.vocab_size
        self.cache = init_kv_cache(cfg, self.num_slots, self.max_len, self.device)
        self._chunk = prefill_chunk_fn(cfg)
        self._decode = decode_slots_fn(cfg)
        self._extract = extract_chunk_fn(cfg)
        self._insert = insert_chunk_fn(cfg)
        self.prefix_cache = (
            PrefixCache(int(prefix_cache_tokens), self.chunk_size)
            if prefix_cache_tokens else None
        )
        self.decode_ticks = 0
        b, s = self.num_slots, self.max_len
        self._tokens = np.zeros(b, np.int64)       # next input token per slot
        self._pos = np.zeros(b, np.int64)          # next cache write position
        self._key_valid = np.zeros((b, s), np.int32)
        self._active = np.zeros(b, np.int32)
        self._temp = np.zeros(b, np.float32)
        self._topk = np.zeros(b, np.int64)
        self._topp = np.ones(b, np.float32)
        self._seed = [0] * b                       # request seed per slot
        self._n_new = np.zeros(b, np.int64)        # max_new_tokens per slot
        self._step_idx = np.zeros(b, np.int64)     # decode ticks run per slot
        self._prefills: list[_Prefill | None] = [None] * b
        # key_valid on the card, re-staged only at admit/release
        self._dev_key_valid: torch.Tensor | None = None
        # (kind -> bucket set) of every program shape dispatched
        self._buckets: dict[str, set[int]] = {}
        # device-time ledger: every dispatch runs inside a fenced section
        self.accountant = DispatchAccountant()
        # the unported engine calls, by name, for the server's 501s
        self.not_ported = {
            "swap_weights": f"hot weight swap (swap_weights) {_QUEUE_A}",
            "export_kv": f"KV shipping (export_kv) {_QUEUE_A}",
            "import_kv": f"KV shipping (import_kv) {_QUEUE_A}",
        }

    # -- unported engine calls ------------------------------------------------

    def swap_weights(self, params) -> int:
        raise NotImplementedError(self.not_ported["swap_weights"])

    def export_kv(self, slot: int) -> dict:
        raise NotImplementedError(self.not_ported["export_kv"])

    def import_kv(self, slot: int, request, shipped) -> None:
        raise NotImplementedError(self.not_ported["import_kv"])

    # -- request validation (shared with the server's 400 path) -------------

    def blocks_for(self, prompt_tokens: int, max_new_tokens: int) -> int:
        """KV blocks a request occupies for its whole life; the dense
        cache has none (a slot's rows are a fixed share, not a metered
        allocation)."""
        return 0

    def validate(self, prompt, max_new_tokens: int) -> None:
        """Raises ValueError when a request cannot be served by this
        engine's shapes."""
        if len(prompt) < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1; got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_len ({self.max_len})"
            )
        bad = [t for t in prompt if not 0 <= int(t) < self.vocab_size]
        if bad:
            raise ValueError(
                f"prompt tokens {bad[:4]} outside the model vocabulary ({self.vocab_size})"
            )

    # -- slot lifecycle ------------------------------------------------------

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_prefill(self, slot: int, request) -> int:
        """Stage ``request`` into free slot ``slot``: validate, copy any
        cached shared-prefix K/V in, and return the number of prefill
        chunks still to run (>= 1: the last prompt token always prefills
        for real, its logits seed the first sample)."""
        ids = [int(t) for t in request.prompt]
        self.validate(ids, request.max_new_tokens)
        done = 0
        if self.prefix_cache is not None and getattr(request, "prefix_cache", True):
            blocks = self.prefix_cache.match(ids)
            if blocks:
                self._buckets.setdefault("insert", set()).add(self.chunk_size)
                with self.accountant.section("insert", self.chunk_size, self.kv_layout):
                    for i, (k, v) in enumerate(blocks):
                        self._insert(self.cache, k, v, slot, i * self.chunk_size)
                    self._fence()
            done = len(blocks) * self.chunk_size
        self._prefills[slot] = _Prefill(request, ids, done)
        return -(-(len(ids) - done) // self.chunk_size)

    def _run_chunk(self, slot: int, chunk: list[int], pos: int, last: int,
                   noise, temp: float, top_k: int, top_p: float):
        """Dispatch one (bucketed) chunk; returns its sampled token."""
        self._buckets.setdefault("prefill_chunk", set()).add(len(chunk))
        with self.accountant.section("prefill_chunk", len(chunk), self.kv_layout):
            tok, _, self.cache = self._chunk(
                self.params, self.cache,
                torch.as_tensor([chunk], dtype=torch.long, device=self.device),
                slot, pos, last, noise, temp, top_k, top_p,
            )
            # fence INSIDE the section: an interior chunk has no host
            # consumer, and an unfenced dispatch would be timed as free
            self._fence()
        return tok

    def prefill_step(self, slot: int) -> int | None:
        """Run ONE prefill chunk for the staged request in ``slot``.
        Returns None while chunks remain; the final chunk samples and
        returns the first token, leaving the slot live for ``step()``."""
        pf = self._prefills[slot]
        if pf is None:
            raise ValueError(f"slot {slot} has no prefill in flight")
        ids, p = pf.ids, len(pf.ids)
        remaining = p - pf.done
        if remaining > self.chunk_size:
            # full interior chunk: exactly chunk_size real tokens
            lo = pf.done
            self._run_chunk(slot, ids[lo:lo + self.chunk_size], lo,
                            self.chunk_size - 1, None, 0.0, 0, 1.0)
            pf.done += self.chunk_size
            return None
        # final chunk, bucketed to a power of two and right-padded from the
        # cursor; when the padded bucket would run past max_len, re-feed the
        # prompt's last ``bucket`` tokens instead (overflow implies done >=
        # chunk_size >= bucket, so lo >= 0)
        bucket = _ceil_pow2(remaining)
        if pf.done + bucket <= self.max_len:
            lo = pf.done
            chunk = ids[lo:] + [0] * (bucket - remaining)
            last = remaining - 1
        else:
            lo = p - bucket
            chunk = ids[lo:]
            last = bucket - 1
        req = pf.request
        temp = float(req.temperature)
        top_k = min(int(req.top_k), self.vocab_size)
        top_p = float(req.top_p)
        seed = int(req.seed)
        noise = (gumbel_noise([seed], [0], [0], self.vocab_size, self.device)
                 if temp > 0 else None)
        tok = self._run_chunk(slot, chunk, lo, last, noise, temp, top_k, top_p)
        tok0 = int(tok)
        pf.done = p
        self._seed[slot] = seed
        self._n_new[slot] = int(req.max_new_tokens)
        self._step_idx[slot] = 0
        self._pos[slot] = p
        self._key_valid[slot] = 1
        self._tokens[slot] = tok0
        self._temp[slot] = temp
        self._topk[slot] = top_k
        self._topp[slot] = top_p
        self._active[slot] = 1
        self._dev_key_valid = None  # slot state changed: re-stage on the next step
        self._prefills[slot] = None
        if self.prefix_cache is not None and getattr(req, "prefix_cache", True):
            # every completed prefill offers its whole-chunk prefix; only
            # chunks not already cached are registered
            cs = self.chunk_size

            def extract(i: int):
                self._buckets.setdefault("extract", set()).add(cs)
                with self.accountant.section("extract", cs, self.kv_layout):
                    rows = self._extract(self.cache, slot, i * cs, cs)
                    self._fence()
                return rows

            self.prefix_cache.insert(ids, (p - 1) // cs, extract)
        return tok0

    def prefill(self, slot: int, request) -> int:
        """Whole-prompt convenience: stage and run every chunk in one call
        (the scheduler interleaves ``prefill_step`` with ticks instead)."""
        self.start_prefill(slot, request)
        while True:
            tok = self.prefill_step(slot)
            if tok is not None:
                return tok

    def step(self) -> list[list[int]]:
        """Advance every live slot one token (one decode tick, sampling
        included). Returns per-slot token lists (empty for free slots)."""
        self.decode_ticks += 1
        return self._step_plain()

    def _step_plain(self) -> list[list[int]]:
        b = self.num_slots
        self._buckets.setdefault("decode", set()).add(1)
        if self._dev_key_valid is None:
            self._dev_key_valid = torch.as_tensor(self._key_valid, device=self.device)
        live = np.flatnonzero(self._active)
        with self.accountant.section("decode", 1, self.kv_layout):
            tokens = torch.as_tensor(self._tokens, device=self.device)
            noise = None
            if (self._temp > 0).any():
                # decode tick j of a request is its noise step j + 1
                noise = gumbel_noise(self._seed, np.zeros(b, np.int64), self._step_idx + 1,
                                     self.vocab_size, self.device)
            nxt, self.cache = self._decode(
                self.params, self.cache, tokens, self._pos, self._dev_key_valid, noise,
                self._temp, self._topk, self._topp, self._active,
            )
            # the host read is the tick's natural fence
            nxt = nxt.cpu().numpy()
        out: list[list[int]] = [[] for _ in range(b)]
        for s in live:
            self._pos[s] += 1
            self._step_idx[s] += 1
            self._tokens[s] = nxt[s]
            out[s] = [int(nxt[s])]
        return out

    def release(self, slot: int) -> None:
        self._active[slot] = 0
        self._key_valid[slot] = 0
        self._pos[slot] = 0
        self._tokens[slot] = 0
        # reset the sampling settings too: the sampler's host gates test
        # the whole row set, and a retired sampled request's temperature
        # would pin later all-greedy ticks onto the sampling branch
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._prefills[slot] = None
        self._dev_key_valid = None

    # -- observability -------------------------------------------------------

    def prefix_stats(self) -> dict | None:
        """Prefix-cache counters (None when the cache is disabled)."""
        return None if self.prefix_cache is None else self.prefix_cache.stats()

    def kv_stats(self) -> dict | None:
        """Block-pool gauges: None in dense mode."""
        return None

    def devtime_stats(self) -> dict:
        """Per-program device/first-dispatch-second ledgers."""
        return self.accountant.snapshot()

    @property
    def kv_layout(self) -> str:
        """The program layout tag every ``compile_counts`` key carries."""
        return "dense"

    def kv_bytes(self) -> int:
        """Bytes of the dense cache on the device."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def compile_counts(self) -> dict:
        """Program shapes per program, keyed by ``kind:layout``. The
        programs are eager, so nothing compiles; what is bounded is the
        set of shapes they run at (the chunk buckets, one decode shape),
        which is what cuBLAS picks kernels by. ``buckets`` records the
        (kind -> shape) set actually dispatched."""
        buckets = {k: sorted(v) for k, v in sorted(self._buckets.items())}
        layout = self.kv_layout
        return {
            "layout": layout,
            "tp_degree": self.tp,
            "buckets": buckets,
            f"prefill_chunk:{layout}": len(buckets.get("prefill_chunk", ())),
            f"decode:{layout}": len(buckets.get("decode", ())),
            f"extract:{layout}": len(buckets.get("extract", ())),
            f"insert:{layout}": len(buckets.get("insert", ())),
        }
