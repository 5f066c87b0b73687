"""Slot-based continuous-batching engine: port of
``nanodiloco_tpu/serve/engine.py``.

The engine owns ONE preallocated cache whose rows are independent
request slots (Orca-style iteration-level scheduling, Yu et al.,
OSDI'22). Two storage modes share every scheduling surface:

- DENSE (``kv_block_size=0``): one ``[L, B, S_max, Hkv, hd]`` row per
  slot; a short request reserves a whole ``max_len`` row.
- PAGED (``kv_block_size>0``): one ``[L, num_blocks, block_size, Hkv,
  hd]`` arena and a block table per slot (vLLM's PagedAttention,
  arXiv:2309.06180). A request is admitted with exactly
  ``ceil((prompt + max_new) / block_size)`` blocks, all or nothing
  (``BlocksExhausted`` leaves it queued), and its blocks return to the
  free list when it retires. ``kv_dtype="int8"`` stores the arena
  quantized (per-row scales, quantize on write, dequantize in the
  read); the fp arena stays token-identical to solo ``generate()``.

A request's life:

- ``start_prefill(slot, request)`` stages the request into a free slot
  and reuses the prefix cache's leading chunks: dense mode copies their
  K/V rows in (``insert_chunk_fn``); paged mode maps the cached chunks'
  blocks into the slot's table copy-on-write (a refcount, no copy: a
  slot only writes past its prefix-hit boundary, into blocks it owns).
- ``prefill_step(slot)`` runs ONE prefill chunk (Sarathi-Serve,
  arXiv:2403.02310). The final chunk returns the first token. Chunk
  lengths are bucketed to powers of two.
- every ``step()`` advances ALL decoding slots with one call of the
  decode program (per-slot positions and sampling settings). With
  ``spec_k > 0`` host-proposed prompt-lookup drafts
  (``serve/speculation.py``) are verified by one forward over k+1
  positions per slot, and each slot emits its longest accepted prefix
  plus the verified token: 1..k+1 tokens, never zero.
- ``release(slot)`` frees the row; paged mode derefs every block the
  slot held (shared prefix blocks survive while the prefix cache holds
  them).

Chunking math (why it is exact): K/V at position i depend only on
``tokens[:i+1]``, so writing them chunk by chunk gives the rows one
whole-prompt call writes. The final chunk right-pads to its bucket and
passes its last REAL index; pad K/V land past the prompt, causally
unreachable, then overwritten by decode. Dense mode caps the top bucket
at the largest power of two <= max_len, and a padded final bucket that
would still run past ``max_len`` re-feeds the prompt's last ``bucket``
tokens instead (same tokens, same positions: the rewrite leaves the rows
as they were). The paged table is one chunk wider than any allocation,
so the paged path never re-feeds: a re-feed would rewrite rows below
the prefix-hit boundary, and in int8 mode not bit for bit.

Determinism contract: a request's token stream is the stream
``generate()`` produces alone with the same seed and sampling settings,
through chunked admission, a prefix-cache hit, the paged arena,
speculation and a KV ship. The noise of a request is
``gumbel_noise(seed, 0, step)`` (``models/generate.py``): step 0 is the
prefill's sample and step j the j-th decode step's, so it depends on
nothing but the request, and position j of a verify window draws the
noise of the step it stands for. On the CPU in float32 the streams are
token-identical; on the card, cuBLAS may pick other kernels for B slots
than for one row, so bf16 logits can differ in their last bits and a
stream may part from ``generate()`` at a near-tie. The int8 arena's
contract is a logit tolerance and greedy-token parity, not bits.

Hot weight swap (``swap_weights``): new params replace the serving
params between ticks; the KV arena and slot state are untouched. Slots
tag the weight generation they were admitted under, a stream in flight
keeps its generation's params (one extra masked dispatch per tick while
two generations are live), an old generation is dropped when its last
slot retires, and the prefix cache is cleared.

KV shipping (``export_kv`` / ``import_kv``, ``serve/kvship.py``): a
slot's written rows leave as ``[L, pos, Hkv, hd]`` host arrays and are
re-blocked into the importer's own geometry, across dense, paged, int8
and block sizes.

MoE configs serve through the training forward's MLP (``models/moe.py``):
a final chunk's right pads and the dead slots of a tick claim no expert
capacity, and a tick's capacity is sized from all B slot rows, as in the
JAX engine. Expert-choice routing is refused (ValueError), as there.

Known divergence (token-choice MoE with dense dispatch), carried from the
JAX engine: expert capacity is sized from the tokens of each dispatch (a
prefill chunk's C, a tick's B slots) while a solo ``generate()`` sizes it
from its own call's tokens and training from the whole B×S batch; when
capacity binds, which tokens overflow to the residual path differs, so a
stream can part from solo ``generate()``. Keep the capacity factor
generous for serving, or use ``moe_dispatch="ragged"``, which has no
capacity and serves exactly as ``generate()`` routes.

Still refused, with NotImplementedError naming ROADMAP.md: tensor
parallelism (``tp > 1``, Queue A item 7).

All calls come from one thread (the scheduler's tick loop); every tensor
the engine makes names its device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.generate import (
    _dequantize_rows,
    _quantize_rows,
    decode_slots_fn,
    decode_slots_paged_fn,
    extract_chunk_fn,
    gumbel_noise,
    init_kv_cache,
    init_kv_pool,
    insert_chunk_fn,
    kv_bytes_per_token,
    prefill_chunk_fn,
    prefill_chunk_paged_fn,
    serving_params,
    verify_slots_fn,
    verify_slots_paged_fn,
)
from nanodiloco_tpu_torch.models.llama import _check_supported, dtype_of, resolve_device
from nanodiloco_tpu_torch.obs.devtime import DispatchAccountant
from nanodiloco_tpu_torch.obs.telemetry import Histogram
from nanodiloco_tpu_torch.serve import kvship
from nanodiloco_tpu_torch.serve.block_pool import BlockPool, BlocksExhausted
from nanodiloco_tpu_torch.serve.prefix_cache import PrefixCache
from nanodiloco_tpu_torch.serve.speculation import PromptLookupProposer

__all__ = ["InferenceEngine", "BlocksExhausted"]

# blocks-held-per-request histogram bounds (blocks)
_BLOCK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# emitted-tokens-per-tick histogram bounds (a spec tick emits 1..spec_k+1)
_SPEC_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)


def _floor_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _ceil_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def _leaf_specs(tree, prefix: str = "") -> list[tuple[str, tuple, torch.dtype]]:
    """(path, shape, dtype) of every leaf of a parameter tree, in name
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_specs(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tuple(tree.shape), tree.dtype)]


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
    card unless ``device="cpu"``."""

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
        self.kv_dtype = None if kv_dtype == "model" else kv_dtype
        if self.kv_dtype == "int8" and not kv_block_size:
            raise ValueError("int8 KV storage requires the paged cache; pass kv_block_size > 0")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0; got {spec_k}")
        if int(tp) < 1:
            raise ValueError(f"tp must be >= 1; got {tp}")
        if int(tp) > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) is not ported yet (ROADMAP.md, Queue A "
                "item 7)")
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        # what a swap must match leaf for leaf: the masters' structure
        self._master_specs = _leaf_specs(params)
        # cast once here: the programs never re-cast a weight per tick
        self.params = serving_params(params, cfg, self.device)
        self.tp = 1                   # read by the scheduler's stats
        self.num_slots = b = int(num_slots)
        self.max_len = int(max_len)
        # chunk lengths are bucketed to powers of two; capping the top
        # bucket at the largest power of two <= max_len keeps every
        # bucketed write inside the slot row
        self.chunk_size = _floor_pow2(min(int(chunk_size), self.max_len))
        self.vocab_size = cfg.vocab_size
        self.paged = bool(kv_block_size)
        if self.paged:
            # a power of two no larger than the chunk: every chunk start
            # (a multiple of chunk_size) is block-aligned, and a shared
            # prefix chunk maps to whole blocks
            self.kv_block_size = bs = _floor_pow2(min(int(kv_block_size), self.chunk_size))
            self.max_blocks = -(-self.max_len // bs)
            # one chunk of sentinel entries wider than any allocation: a
            # right-padded final bucket always fits the gathered view, so
            # the paged path never re-feeds; pad writes land on the
            # sentinel and are dropped
            self.table_blocks = self.max_blocks + self.chunk_size // bs
            nb = int(kv_pool_blocks) if kv_pool_blocks else b * self.max_blocks
            self.block_pool = BlockPool(nb, bs)
            self.pool = init_kv_pool(cfg, nb, bs, self.kv_dtype, self.device)
            self.cache = None
            self._chunk = prefill_chunk_paged_fn(cfg, self.kv_dtype)
            self._decode = decode_slots_paged_fn(cfg, self.kv_dtype)
            self._tables = np.full((b, self.table_blocks), nb, np.int64)
            self._slot_blocks: list[list[int]] = [[] for _ in range(b)]
            self.kv_block_evictions = 0
            self.hist_blocks_per_request = Histogram(_BLOCK_BUCKETS)
        else:
            self.kv_block_size = 0
            self.block_pool = None
            self.pool = None
            self.cache = init_kv_cache(cfg, b, self.max_len, self.device)
            self._chunk = prefill_chunk_fn(cfg)
            self._decode = decode_slots_fn(cfg)
            self._extract = extract_chunk_fn(cfg)
            self._insert = insert_chunk_fn(cfg)
        self.prefix_cache = (
            PrefixCache(int(prefix_cache_tokens), self.chunk_size,
                        on_evict=self._evict_prefix_blocks if self.paged else None)
            if prefix_cache_tokens else None
        )
        # speculation: host-side prompt-lookup drafts verified by one
        # forward over k+1 positions per slot; draft widths bucket to
        # powers of two, and a tick with no drafts runs the plain program
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.speculator = (PromptLookupProposer(self.spec_k, max_ngram=self.spec_ngram)
                           if self.spec_k else None)
        self._verify = None
        if self.spec_k:
            self._verify = (verify_slots_paged_fn(cfg, self.kv_dtype) if self.paged
                            else verify_slots_fn(cfg))
        self._spec_ok = [False] * b                # per-slot opt-in state
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_ticks = 0                        # ticks that ran verify
        self.decode_ticks = 0                      # every decode tick
        self.hist_spec_tokens_per_tick = Histogram(_SPEC_BUCKETS)
        # hot-swap weight generations: slots tag the generation they were
        # admitted under, and a generation's params stay resident while a
        # slot still holds it
        self.deploy_generation = 0
        self._params_by_gen: dict[int, dict] = {0: self.params}
        self._slot_gen = [0] * b
        s = self.max_len
        self._tokens = np.zeros(b, np.int64)       # next input token per slot
        self._pos = np.zeros(b, np.int64)          # next cache write position
        self._key_valid = np.zeros((b, s), np.int32)
        self._active = np.zeros(b, np.int32)
        self._temp = np.zeros(b, np.float32)
        self._topk = np.zeros(b, np.int64)
        self._topp = np.ones(b, np.float32)
        self._seed = [0] * b                       # request seed per slot
        self._n_new = np.zeros(b, np.int64)        # max_new_tokens per slot
        self._step_idx = np.zeros(b, np.int64)     # decode steps emitted per slot
        self._prefills: list[_Prefill | None] = [None] * b
        # debug probe, off by default: each final chunk's logits land
        # here as numpy (the int8 tolerance tests read it)
        self.capture_prefill_logits = False
        self.last_prefill_logits: np.ndarray | None = None
        # key_valid on the device (dense), re-staged only at admit/release
        self._dev_key_valid: torch.Tensor | None = None
        # (kind -> bucket set) of every program shape dispatched
        self._buckets: dict[str, set[int]] = {}
        # device-time ledger: every dispatch runs inside a fenced section
        self.accountant = DispatchAccountant()
        # KV shipping meters: payload bytes, blocks and wall seconds
        self.kvship_counts = {
            "export_requests": 0, "import_requests": 0,
            "export_bytes": 0, "import_bytes": 0,
            "export_blocks": 0, "import_blocks": 0,
            "export_seconds": 0.0, "import_seconds": 0.0,
        }

    # -- hot weight swap -------------------------------------------------------

    def swap_weights(self, params) -> int:
        """Deploy new params without dropping in-flight requests. The new
        tree must match the masters the engine was built from leaf for
        leaf (structure, shapes, dtypes), checked here, before anything
        changes; it is then cast once (``serving_params``). The KV arena
        is untouched: live slots finish on the weights they were admitted
        under, whose params stay resident until the last such slot
        retires, and every later admission runs on the new ones. The
        prefix cache is cleared (its K/V came from the old weights). Call
        from the tick thread (``Scheduler.call_on_tick``). Returns the new
        generation."""
        with self.accountant.section("swap", 0, self.kv_layout, first_is_compile=False):
            new = _leaf_specs(params)
            if [p for p, _, _ in new] != [p for p, _, _ in self._master_specs]:
                raise ValueError("swap_weights: new params tree structure does not match the "
                                 "serving params (different architecture?)")
            for (name, shape, dt), (_, want_shape, want_dt) in zip(new, self._master_specs):
                if shape != want_shape or dt != want_dt:
                    raise ValueError(
                        f"swap_weights: leaf {name} is {shape}:{dt} but the serving engine "
                        f"holds {want_shape}:{want_dt}; the checkpoint does not fit this engine")
            sp = serving_params(params, self.cfg, self.device)
            self._fence()  # the section's seconds cover the upload
            self.deploy_generation += 1
            self._params_by_gen[self.deploy_generation] = sp
            self.params = sp
            if self.prefix_cache is not None:
                # paged mode derefs the cached blocks through on_evict
                self.prefix_cache.clear()
            self._prune_param_generations()
            return self.deploy_generation

    def _prune_param_generations(self) -> None:
        """Drop param generations no live (or mid-prefill) slot holds."""
        live = {self.deploy_generation}
        for s in range(self.num_slots):
            if self._active[s] or self._prefills[s] is not None:
                live.add(self._slot_gen[s])
        for g in [g for g in self._params_by_gen if g not in live]:
            del self._params_by_gen[g]

    def _gen_dispatches(self) -> list[tuple[dict, list[int], np.ndarray]]:
        """(params, slots, active mask) per weight generation with a live
        slot: one dispatch in the steady state, one masked dispatch per
        generation during a swap's transition window (a dispatch writes
        K/V only for the slots its mask holds)."""
        groups: dict[int, list[int]] = {}
        for s in np.flatnonzero(self._active):
            groups.setdefault(self._slot_gen[s], []).append(int(s))
        if len(groups) <= 1:
            gen = next(iter(groups), self.deploy_generation)
            return [(self._params_by_gen[gen], groups.get(gen, []), self._active)]
        out = []
        for gen in sorted(groups):
            act = np.zeros(self.num_slots, np.int32)
            act[groups[gen]] = 1
            out.append((self._params_by_gen[gen], groups[gen], act))
        return out

    # -- request validation (shared with the server's 400 path) -------------

    def blocks_for(self, prompt_tokens: int, max_new_tokens: int) -> int:
        """KV blocks a request occupies for its whole life (paged mode):
        prompt + completion rows, rounded up to whole blocks; 0 in dense
        mode, where a slot's row is a fixed share, not a metered
        allocation."""
        if not self.paged:
            return 0
        return -(-(prompt_tokens + max_new_tokens) // self.kv_block_size)

    def validate(self, prompt, max_new_tokens: int) -> None:
        """Raises ValueError when a request cannot be served by this
        engine's shapes (including a paged pool it could NEVER fit; a
        transient block shortage is ``BlocksExhausted`` at admission)."""
        if len(prompt) < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1; got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_len ({self.max_len})"
            )
        if self.paged:
            need = self.blocks_for(len(prompt), max_new_tokens)
            if need > self.block_pool.num_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only has "
                    f"{self.block_pool.num_blocks} in total; it can never be admitted")
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
        """Stage ``request`` into free slot ``slot``: validate, reuse any
        cached shared-prefix K/V, and return the number of prefill chunks
        still to run (>= 1: the last prompt token always prefills for
        real, its logits seed the first sample). Paged mode allocates the
        request's whole block budget here, all or nothing:
        ``BlocksExhausted`` (nothing mutated, nothing counted) keeps the
        request queued until blocks free up."""
        ids = [int(t) for t in request.prompt]
        self.validate(ids, request.max_new_tokens)
        done = 0
        use_cache = self.prefix_cache is not None and getattr(request, "prefix_cache", True)
        if self.paged:
            cs = self.chunk_size
            need = self.blocks_for(len(ids), request.max_new_tokens)
            # peek first, so a block-starved admission rolls back to
            # nothing; under pressure, evict LRU prefixes to reclaim
            # cache-only blocks (each eviction can cut the matched chain,
            # so the peek re-walks)
            while True:
                chains = self.prefix_cache.match(ids, record=False) if use_cache else []
                shared = [blk for chunk in chains for blk in chunk]
                own_need = need - len(shared)
                if own_need <= self.block_pool.free_blocks:
                    break
                if self.prefix_cache is None or not self.prefix_cache.evict_lru():
                    raise BlocksExhausted(
                        f"request needs {own_need} KV blocks ({need} total, {len(shared)} "
                        f"shared) but only {self.block_pool.free_blocks}/"
                        f"{self.block_pool.num_blocks} are free")
            if use_cache:
                chains = self.prefix_cache.match(ids)  # record the hit for real
            own = self.block_pool.alloc(own_need)
            self.block_pool.ref(shared)
            blocks = shared + own
            self._slot_blocks[slot] = blocks
            self._tables[slot] = self.block_pool.num_blocks
            self._tables[slot, :len(blocks)] = blocks
            done = len(chains) * cs
        elif use_cache:
            blocks = self.prefix_cache.match(ids)
            if blocks:
                self._buckets.setdefault("insert", set()).add(self.chunk_size)
                with self.accountant.section("insert", self.chunk_size, self.kv_layout):
                    for i, (k, v) in enumerate(blocks):
                        self._insert(self.cache, k, v, slot, i * self.chunk_size)
                    self._fence()
            done = len(blocks) * self.chunk_size
        # admitted under the CURRENT weights: every chunk and tick of its
        # life dispatches this generation's params
        self._slot_gen[slot] = self.deploy_generation
        self._prefills[slot] = _Prefill(request, ids, done)
        return -(-(len(ids) - done) // self.chunk_size)

    def _run_chunk(self, slot: int, chunk: list[int], pos: int, last: int,
                   noise, temp: float, top_k: int, top_p: float, n_real: int | None = None):
        """Dispatch one (bucketed) chunk whose first ``n_real`` tokens are
        real (None: all; right pads claim no MoE capacity); returns
        (token, logits [1, V])."""
        self._buckets.setdefault("prefill_chunk", set()).add(len(chunk))
        params = self._params_by_gen[self._slot_gen[slot]]
        toks = torch.as_tensor([chunk], dtype=torch.long, device=self.device)
        valid = None
        if self.cfg.num_experts and n_real is not None and n_real < len(chunk):
            valid = torch.zeros((1, len(chunk)), dtype=torch.int32, device=self.device)
            valid[0, :n_real] = 1
        with self.accountant.section("prefill_chunk", len(chunk), self.kv_layout):
            if self.paged:
                tok, logits, self.pool = self._chunk(params, self.pool, self._tables[slot], toks,
                                                     pos, last, noise, temp, top_k, top_p,
                                                     valid)
            else:
                tok, logits, self.cache = self._chunk(params, self.cache, toks, slot, pos, last,
                                                      noise, temp, top_k, top_p, valid)
            # fence INSIDE the section: an interior chunk has no host
            # consumer, and an unfenced dispatch would be timed as free
            self._fence()
        return tok, logits

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
        # cursor; in dense mode, when the padded bucket would run past
        # max_len, re-feed the prompt's last ``bucket`` tokens instead
        # (overflow implies done >= chunk_size >= bucket, so lo >= 0)
        bucket = _ceil_pow2(remaining)
        view = self.table_blocks * self.kv_block_size if self.paged else self.max_len
        if pf.done + bucket <= view:
            lo = pf.done
            chunk = ids[lo:] + [0] * (bucket - remaining)
            last = remaining - 1
        else:
            lo = p - bucket
            chunk = ids[lo:]
            last = bucket - 1
        n_real = last + 1
        req = pf.request
        temp = float(req.temperature)
        top_k = min(int(req.top_k), self.vocab_size)
        top_p = float(req.top_p)
        seed = int(req.seed)
        noise = (gumbel_noise([seed], [0], [0], self.vocab_size, self.device)
                 if temp > 0 else None)
        tok, logits = self._run_chunk(slot, chunk, lo, last, noise, temp, top_k, top_p, n_real)
        tok0 = int(tok)
        if self.capture_prefill_logits:
            self.last_prefill_logits = logits.cpu().numpy()
        pf.done = p
        self._activate(slot, req, pos=p, emitted=[tok0], prompt_ids=ids)
        self._prefills[slot] = None
        if (self.prefix_cache is not None and getattr(req, "prefix_cache", True)
                # a slot admitted before a swap computed its rows under the
                # OLD weights: they must not enter the cleared cache
                and self._slot_gen[slot] == self.deploy_generation):
            # every completed prefill offers its whole-chunk prefix; only
            # chunks not already cached are registered
            cs = self.chunk_size
            if self.paged:
                # zero-copy: the cache takes a reference to the slot's own
                # blocks for each new chunk
                cpb = cs // self.kv_block_size

                def extract(i: int):
                    blks = tuple(int(x) for x in self._tables[slot][i * cpb:(i + 1) * cpb])
                    self.block_pool.ref(blks)
                    return blks
            else:

                def extract(i: int):
                    self._buckets.setdefault("extract", set()).add(cs)
                    with self.accountant.section("extract", cs, self.kv_layout):
                        rows = self._extract(self.cache, slot, i * cs, cs)
                        self._fence()
                    return rows

            self.prefix_cache.insert(ids, (p - 1) // cs, extract)
        return tok0

    def _activate(self, slot: int, req, *, pos: int, emitted: list[int], prompt_ids) -> None:
        """Make ``slot`` live at cache cursor ``pos`` after ``emitted``
        tokens of ``req`` (the prefill's sample, or a shipped stream's
        prefix): the noise schedule comes from the request seed and the
        step cursor from the emission count."""
        self._seed[slot] = int(req.seed)
        self._n_new[slot] = int(req.max_new_tokens)
        self._step_idx[slot] = len(emitted) - 1
        self._pos[slot] = pos
        self._key_valid[slot] = 1
        self._tokens[slot] = emitted[-1]
        self._temp[slot] = float(req.temperature)
        self._topk[slot] = min(int(req.top_k), self.vocab_size)
        self._topp[slot] = float(req.top_p)
        self._active[slot] = 1
        # speculation is per-request opt-in (``GenRequest.speculate``)
        self._spec_ok[slot] = bool(self.spec_k) and bool(getattr(req, "speculate", True))
        if self._spec_ok[slot]:
            self.speculator.begin(slot, prompt_ids, emitted[0])
            if len(emitted) > 1:
                self.speculator.observe(slot, emitted[1:])
        self._dev_key_valid = None  # slot state changed: re-stage on the next step

    def prefill(self, slot: int, request) -> int:
        """Whole-prompt convenience: stage and run every chunk in one call
        (the scheduler interleaves ``prefill_step`` with ticks instead)."""
        self.start_prefill(slot, request)
        while True:
            tok = self.prefill_step(slot)
            if tok is not None:
                return tok

    def _stage_dev(self) -> torch.Tensor:
        """key_valid on the device (dense mode); it changes only at
        admit/release."""
        if self._dev_key_valid is None:
            self._dev_key_valid = torch.as_tensor(self._key_valid, device=self.device)
        return self._dev_key_valid

    def _collect_drafts(self) -> tuple[list[list[int]], int]:
        """The proposer's drafts for each live opted-in slot, capped so a
        tick never emits past the request's last step (emitted <= drafts
        + 1 <= decode steps left). Returns (per-slot drafts, the longest
        draft this tick)."""
        drafts: list[list[int]] = [[] for _ in range(self.num_slots)]
        k_tick = 0
        new_tick = getattr(self.speculator, "new_tick", None)
        if new_tick is not None:
            new_tick()
        for s in range(self.num_slots):
            if not self._active[s] or not self._spec_ok[s]:
                continue
            # decode steps left after this tick's verified token
            cap = min(self.spec_k, int(self._n_new[s] - 1 - self._step_idx[s]) - 1)
            if cap <= 0:
                continue
            d = list(self.speculator.propose(s, cap))[:cap]
            if d:
                drafts[s] = [int(t) for t in d]
                k_tick = max(k_tick, len(d))
        return drafts, k_tick

    def step(self) -> list[list[int]]:
        """Advance every live slot 1..spec_k+1 tokens (one tick, sampling
        included). Returns per-slot emitted-token lists (empty for free
        slots). Without speculation, or on a tick where no slot has a
        draft, every live slot emits one token through the plain decode
        program; otherwise ONE verify dispatch covers every slot."""
        b = self.num_slots
        drafts, k_tick = self._collect_drafts() if self.spec_k else ([[] for _ in range(b)], 0)
        self.decode_ticks += 1
        if k_tick == 0:
            return self._step_plain()
        return self._step_verify(drafts, k_tick)

    def _noise(self, steps: np.ndarray):
        """Gumbel noise for every slot at decode ``steps`` [B, T] (step j
        of a request is its noise step j + 1; step 0 was the prefill's),
        as [B*T, V]; None when every slot is greedy."""
        if not (self._temp > 0).any():
            return None
        t = steps.shape[1]
        return gumbel_noise(np.repeat(self._seed, t), np.zeros(steps.size, np.int64),
                            steps.reshape(-1) + 1, self.vocab_size, self.device)

    def _step_plain(self) -> list[list[int]]:
        b = self.num_slots
        self._buckets.setdefault("decode", set()).add(1)
        tokens = torch.as_tensor(self._tokens, device=self.device)
        noise = self._noise(self._step_idx[:, None])
        out: list[list[int]] = [[] for _ in range(b)]
        for params, slots, active in self._gen_dispatches():
            with self.accountant.section("decode", 1, self.kv_layout):
                if self.paged:
                    nxt, self.pool = self._decode(params, self.pool, self._tables, tokens,
                                                  self._pos, noise, self._temp, self._topk,
                                                  self._topp, active)
                else:
                    nxt, self.cache = self._decode(params, self.cache, tokens, self._pos,
                                                   self._stage_dev(), noise, self._temp,
                                                   self._topk, self._topp, active)
                # the host read is the tick's natural fence
                nxt = nxt.cpu().numpy()
            for s in slots:
                self._pos[s] += 1
                self._step_idx[s] += 1
                self._tokens[s] = nxt[s]
                tok = int(nxt[s])
                if self._spec_ok[s]:
                    self.speculator.observe(s, [tok])
                out[s] = [tok]
        return out

    def _step_verify(self, drafts: list[list[int]], k_tick: int) -> list[list[int]]:
        """One speculative tick: verify up to ``k_tick`` drafts per slot
        (the width bucketed to a power of two) in one forward over k+1
        positions, emit each slot's accepted prefix and the verified
        token, and advance the cursors by the emission. Rejected rows lie
        past the advanced cursor and are rewritten before any query can
        reach them: rollback frees nothing, so nothing can leak."""
        b = self.num_slots
        bucket = min(_ceil_pow2(k_tick), self.spec_k)
        t = bucket + 1
        tokens = np.zeros((b, t), np.int64)
        tokens[:, 0] = self._tokens
        dlen = np.zeros(b, np.int64)
        for s in range(b):
            d = drafts[s][:bucket]
            if d:
                tokens[s, 1:1 + len(d)] = d
                dlen[s] = len(d)
        self._buckets.setdefault("verify", set()).add(t)
        toks = torch.as_tensor(tokens, device=self.device)
        noise = self._noise(self._step_idx[:, None] + np.arange(t)[None, :])
        out: list[list[int]] = [[] for _ in range(b)]
        for params, slots, active in self._gen_dispatches():
            with self.accountant.section("verify", t, self.kv_layout):
                if self.paged:
                    sampled, counts, self.pool = self._verify(
                        params, self.pool, self._tables, toks, self._pos, dlen, noise,
                        self._temp, self._topk, self._topp, active)
                else:
                    sampled, counts, self.cache = self._verify(
                        params, self.cache, toks, self._pos, dlen, self._stage_dev(), noise,
                        self._temp, self._topk, self._topp, active)
                sampled = sampled.cpu().numpy()
                counts = counts.cpu().numpy()
            for s in slots:
                c = int(counts[s])
                emitted = [int(v) for v in sampled[s, :c]]
                self._pos[s] += c
                self._step_idx[s] += c
                self._tokens[s] = emitted[-1]
                proposed = int(dlen[s])
                accepted = c - 1
                self.spec_draft_tokens += proposed
                self.spec_accepted_tokens += accepted
                self.spec_rejected_tokens += proposed - accepted
                if proposed:
                    # drafting slots only: a no-draft neighbour emits 1 by
                    # construction and would measure batch composition
                    self.hist_spec_tokens_per_tick.observe(c)
                if self._spec_ok[s]:
                    if proposed:
                        self.speculator.feedback(s, proposed, accepted)
                    self.speculator.observe(s, emitted)
                out[s] = emitted
        self.spec_ticks += 1
        return out

    def warm_spec(self) -> int:
        """Run every verify width once before traffic arrives (the draft
        width buckets to powers of two; each bucket is one program shape
        for cuBLAS to pick kernels for). Drives a throwaway greedy request
        through slot 0 with a scripted proposer that walks the widths,
        then releases it and zeroes the counters, so nothing observable
        is left. Needs an idle engine. Returns the number of widths run;
        0 without speculation."""
        if not self.spec_k:
            return 0
        if any(self._active) or any(p is not None for p in self._prefills):
            raise RuntimeError("warm_spec needs an idle engine")
        # widest first: the cap shrinks as the throwaway stream advances
        widths = sorted({min(_ceil_pow2(k), self.spec_k) for k in range(1, self.spec_k + 1)},
                        reverse=True)

        class _Ramp:
            """Proposes exactly ``self.k`` junk drafts per tick."""

            def __init__(self, vocab: int) -> None:
                self.k = 0
                self.tok = vocab - 1

            def begin(self, *a):
                pass

            def release(self, *a):
                pass

            def propose(self, slot, cap):
                return [self.tok] * min(self.k, cap)

            def observe(self, *a):
                pass

            def feedback(self, *a):
                pass

        from nanodiloco_tpu_torch.serve.scheduler import GenRequest

        prompt_len = min(8, self.max_len // 2)
        req = GenRequest(prompt=(1,) * prompt_len,
                         max_new_tokens=max(2, min((self.spec_k + 2) * len(widths),
                                                   self.max_len - prompt_len)),
                         prefix_cache=False)
        saved = self.speculator
        ramp = _Ramp(self.vocab_size)
        self.speculator = ramp
        try:
            self.prefill(0, req)
            self._spec_ok[0] = True
            for w in widths:
                ramp.k = w
                self.step()
        finally:
            self.speculator = saved
            self.release(0)
            # warmup is not traffic: neither /metrics nor the device
            # ledger may report it
            self.reset_spec_stats()
            self.accountant.reset_device_seconds()
        return len(widths)

    def reset_spec_stats(self) -> None:
        """Zero the speculation counters and histogram."""
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_ticks = 0
        self.decode_ticks = 0
        self.hist_spec_tokens_per_tick = Histogram(_SPEC_BUCKETS)

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
        if self._spec_ok[slot]:
            self.speculator.release(slot)
        self._spec_ok[slot] = False
        if self.paged:
            blocks = self._slot_blocks[slot]
            if blocks:
                self.hist_blocks_per_request.observe(len(blocks))
                self.block_pool.deref(blocks)
            self._slot_blocks[slot] = []
            self._tables[slot] = self.block_pool.num_blocks
        self._dev_key_valid = None
        # a retiring slot may have held the last reference to a pre-swap
        # weight generation
        self._prune_param_generations()

    def _evict_prefix_blocks(self, blocks) -> None:
        """Prefix-cache eviction hook (paged): drop the cache's references;
        blocks still mapped into a live slot survive until it releases
        them."""
        self.block_pool.deref(blocks)
        self.kv_block_evictions += len(blocks)

    # -- KV shipping (serve/kvship.py) ---------------------------------------

    def export_kv(self, slot: int) -> dict:
        """``slot``'s written KV rows for shipping to another replica: a
        dict with ``k``/``v`` as ``[L, pos, Hkv, hd]`` host arrays in the
        arena's storage dtype (bfloat16 as its 16-bit pattern; an int8
        arena adds its ``ks``/``vs`` per-row float32 scales), the
        fingerprint fields, and the cache cursor ``pos``. A paged export
        gathers the used blocks on the device and moves those alone.
        Read-only: the slot stays live."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} has no live stream to export")
        t0 = time.perf_counter()
        pos = int(self._pos[slot])
        blocks_moved = 0
        ks = vs = None
        if self.paged:
            bs = self.kv_block_size
            nb = -(-pos // bs)
            idx = torch.as_tensor(self._slot_blocks[slot][:nb], device=self.device)

            def rows(name):
                a = self.pool[name][:, idx]
                return a.reshape(a.shape[0], nb * bs, *a.shape[3:])[:, :pos]

            k, v = kvship.to_host(rows("k")), kvship.to_host(rows("v"))
            if self.kv_dtype == "int8":
                ks, vs = kvship.to_host(rows("ks")), kvship.to_host(rows("vs"))
            blocks_moved = nb
            wire = kvship.wire_tag(self.pool["k"].dtype)
        else:
            k = kvship.to_host(self.cache["k"][:, slot, :pos])
            v = kvship.to_host(self.cache["v"][:, slot, :pos])
            wire = kvship.wire_tag(self.cache["k"].dtype)
        nbytes = k.nbytes + v.nbytes + (ks.nbytes + vs.nbytes if ks is not None else 0)
        c = self.kvship_counts
        c["export_requests"] += 1
        c["export_bytes"] += int(nbytes)
        c["export_blocks"] += blocks_moved
        c["export_seconds"] += time.perf_counter() - t0
        return {"config": kvship.config_fingerprint(self.cfg),
                "generation": int(self._slot_gen[slot]), "wire_dtype": wire, "pos": pos,
                "k": k, "v": v, "ks": ks, "vs": vs}

    def _convert_wire(self, shipped):
        """Wire rows -> this arena's storage form, as device tensors:
        verbatim where the bits can be kept, requantized (amax/127) into
        an int8 arena, dequantized out of an int8 wire; an fp wire into
        another fp arena dtype is a ``ShipMismatchError``, never a silent
        cast."""
        def put(a):
            return kvship.to_tensor(a, shipped.wire_dtype).to(self.device)

        arena_int8 = self.paged and self.kv_dtype == "int8"
        wire_int8 = shipped.wire_dtype == "int8"
        if arena_int8:
            if wire_int8:
                return put(shipped.k), put(shipped.v), put(shipped.ks), put(shipped.vs)
            qk, sk = _quantize_rows(put(shipped.k))
            qv, sv = _quantize_rows(put(shipped.v))
            return qk, qv, sk, sv
        cdt = dtype_of(self.cfg.dtype)
        if wire_int8:
            return (_dequantize_rows(put(shipped.k), put(shipped.ks), cdt),
                    _dequantize_rows(put(shipped.v), put(shipped.vs), cdt), None, None)
        if shipped.wire_dtype != kvship.wire_tag(cdt):
            raise kvship.ShipMismatchError(
                f"fp wire dtype {shipped.wire_dtype} does not match this arena's "
                f"{kvship.wire_tag(cdt)}; casting fp bits across dtypes would silently break "
                "the bit-parity contract")
        return put(shipped.k), put(shipped.v), None, None

    def _import_paged(self, slot: int, ids, request, pos: int, k, v, ks, vs) -> int:
        """Re-block shipped rows into this engine's pool: the request's
        whole block budget is allocated all or nothing (``release`` derefs
        it as it does a local admission), the written rows land in the
        leading blocks. Returns the blocks the payload filled."""
        bs = self.kv_block_size
        need = self.blocks_for(len(ids), request.max_new_tokens)
        own = self.block_pool.alloc(need)
        try:
            nb = -(-pos // bs)
            idx = torch.as_tensor(own[:nb], device=self.device)
            for name, rows in (("k", k), ("v", v), ("ks", ks), ("vs", vs)):
                if rows is None:
                    continue
                pad = torch.zeros((rows.shape[0], nb * bs, *rows.shape[2:]), dtype=rows.dtype,
                                  device=self.device)
                pad[:, :pos] = rows
                self.pool[name][:, idx] = pad.reshape(rows.shape[0], nb, bs, *rows.shape[2:])
            self._tables[slot] = self.block_pool.num_blocks
            self._tables[slot, :need] = own
            self._slot_blocks[slot] = own
            return nb
        except BaseException:
            # a failed scatter must not leak the allocation
            self.block_pool.deref(own)
            raise

    def import_kv(self, slot: int, request, shipped) -> None:
        """Import a shipped stream into free slot ``slot`` and resume it
        mid-request. The fingerprint is checked first
        (``ShipMismatchError``, the server's 409, on another architecture
        or weight generation), then the rows are converted and re-blocked
        into this engine's own geometry, and the slot is made live as
        ``prefill_step`` would leave it: the noise schedule from the
        request seed, the step cursor from the emitted-token count, so
        the next tick is the one the exporter would have run. Shipped
        rows never enter the prefix cache."""
        if self._active[slot] or self._prefills[slot] is not None:
            raise ValueError(f"slot {slot} is busy")
        t0 = time.perf_counter()
        fp = kvship.config_fingerprint(self.cfg)
        if shipped.config != fp:
            raise kvship.ShipMismatchError(
                f"config fingerprint {shipped.config} does not match this engine ({fp}): "
                "different architecture/config")
        if int(shipped.generation) != self.deploy_generation:
            raise kvship.ShipMismatchError(
                f"weight generation {shipped.generation} does not match this replica's deploy "
                f"generation {self.deploy_generation}: resuming across weight generations "
                "would mix caches from different params")
        ids = [int(t) for t in request.prompt]
        self.validate(ids, request.max_new_tokens)
        emitted = [int(t) for t in shipped.emitted]
        if len(ids) != shipped.prompt_len:
            raise kvship.ShipFormatError(
                f"request prompt has {len(ids)} tokens but the payload was exported for "
                f"prompt_len={shipped.prompt_len}")
        if len(emitted) > int(request.max_new_tokens):
            raise kvship.ShipFormatError(
                f"{len(emitted)} emitted tokens exceed the request's "
                f"max_new_tokens={request.max_new_tokens}")
        bad = [t for t in emitted if not 0 <= t < self.vocab_size]
        if bad:
            raise kvship.ShipFormatError(
                f"emitted tokens {bad[:4]} outside the model vocabulary ({self.vocab_size})")
        pos = int(shipped.pos)
        arena = self.pool["k"] if self.paged else self.cache["k"]
        layers, heads, hd = arena.shape[0], arena.shape[-2], arena.shape[-1]
        if tuple(shipped.k.shape) != (layers, pos, heads, hd):
            raise kvship.ShipMismatchError(
                f"payload rows are {tuple(shipped.k.shape)} but this engine expects "
                f"[{layers}, {pos}, {heads}, {hd}]")
        k, v, ks, vs = self._convert_wire(shipped)
        if self.paged:
            blocks_moved = self._import_paged(slot, ids, request, pos, k, v, ks, vs)
        else:
            blocks_moved = 0
            self.cache["k"][:, slot, :pos] = k
            self.cache["v"][:, slot, :pos] = v
        self._slot_gen[slot] = self.deploy_generation
        self._activate(slot, request, pos=pos, emitted=emitted, prompt_ids=ids)
        self._prefills[slot] = None
        c = self.kvship_counts
        c["import_requests"] += 1
        c["import_bytes"] += shipped.payload_bytes()
        c["import_blocks"] += blocks_moved
        c["import_seconds"] += time.perf_counter() - t0

    def kvship_stats(self) -> dict | None:
        """KV shipping meters for /metrics and the stats JSONL (None until
        the first ship touches this engine)."""
        c = self.kvship_counts
        if not (c["export_requests"] or c["import_requests"]):
            return None
        out = dict(c)
        out["export_seconds"] = round(out["export_seconds"], 6)
        out["import_seconds"] = round(out["import_seconds"], 6)
        return out

    # -- observability -------------------------------------------------------

    def prefix_stats(self) -> dict | None:
        """Prefix-cache counters (None when the cache is disabled)."""
        return None if self.prefix_cache is None else self.prefix_cache.stats()

    def kv_stats(self) -> dict | None:
        """Block-pool gauges for /metrics and the stats JSONL (None in
        dense mode). ``kv_bytes`` is the arena's device footprint;
        ``hist_blocks_per_request`` the blocks-held distribution observed
        at release."""
        if not self.paged:
            return None
        return {
            **self.block_pool.stats(),
            "kv_dtype": self.kv_dtype or str(self.cfg.dtype),
            "block_evictions": self.kv_block_evictions,
            "kv_bytes": int(self.block_pool.num_blocks * self.kv_block_size
                            * kv_bytes_per_token(self.cfg, self.kv_dtype)),
            "hist_blocks_per_request": self.hist_blocks_per_request.snapshot(),
        }

    def blocks_held(self, slot: int) -> int:
        """KV blocks mapped into ``slot`` (0 in dense mode)."""
        return len(self._slot_blocks[slot]) if self.paged else 0

    def spec_stats(self) -> dict | None:
        """Speculative-decoding counters (None with speculation off).
        ``acceptance_rate`` is accepted/drafted over the engine's life;
        ``tokens_per_tick_mean`` averages emitted tokens over speculative
        ticks of drafting slots."""
        if not self.spec_k:
            return None
        drafted = self.spec_draft_tokens
        hist = self.hist_spec_tokens_per_tick.snapshot()
        return {
            "spec_k": self.spec_k,
            "spec_ngram": self.spec_ngram,
            "draft_tokens": drafted,
            "accepted_tokens": self.spec_accepted_tokens,
            "rejected_tokens": self.spec_rejected_tokens,
            "acceptance_rate": (round(self.spec_accepted_tokens / drafted, 4)
                                if drafted else None),
            "spec_ticks": self.spec_ticks,
            "decode_ticks": self.decode_ticks,
            "tokens_per_tick_mean": (round(hist["sum"] / hist["count"], 4)
                                     if hist["count"] else None),
            "hist_tokens_per_tick": hist,
        }

    def devtime_stats(self) -> dict:
        """Per-program device/first-dispatch-second ledgers."""
        return self.accountant.snapshot()

    @property
    def kv_layout(self) -> str:
        """The program layout tag every ``compile_counts`` key carries."""
        if not self.paged:
            return "dense"
        return "paged-int8" if self.kv_dtype == "int8" else "paged"

    def kv_bytes(self) -> int:
        """Bytes of the cache (dense) or the arena (paged) on the device."""
        kv = self.pool if self.paged else self.cache
        return sum(t.numel() * t.element_size() for t in kv.values())

    def compile_counts(self) -> dict:
        """Program shapes per program, keyed by ``kind:layout``. The
        programs are eager, so nothing compiles; what is bounded is the
        set of shapes they run at (the chunk buckets, one decode shape,
        one verify shape per draft-width bucket), which is what cuBLAS
        picks kernels by. ``buckets`` records the (kind -> shape) set
        actually dispatched. Paged mode shares prefix blocks by reference
        and has no extract/insert programs."""
        buckets = {k: sorted(v) for k, v in sorted(self._buckets.items())}
        layout = self.kv_layout
        out = {
            "layout": layout,
            "tp_degree": self.tp,
            "buckets": buckets,
            f"prefill_chunk:{layout}": len(buckets.get("prefill_chunk", ())),
            f"decode:{layout}": len(buckets.get("decode", ())),
        }
        if self.spec_k:
            out[f"verify:{layout}"] = len(buckets.get("verify", ()))
        if not self.paged:
            out[f"extract:{layout}"] = len(buckets.get("extract", ()))
            out[f"insert:{layout}"] = len(buckets.get("insert", ()))
        return out
