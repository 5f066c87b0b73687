"""Shared-prefix KV cache: prefill a common prompt prefix once, reuse it.

A copy of ``nanodiloco_tpu/serve/prefix_cache.py`` (jax-free); the
port's dense engine fills it through ``extract_chunk_fn`` and reads
it through ``insert_chunk_fn``, and its paged engine stores block ids
(copy-on-write, dereferenced through ``on_evict``).

The system-prompt pattern (every request opens with the same instruction
block) makes whole-prompt prefill O(requests x prefix) for work that is
O(prefix): K/V at position i depend only on ``tokens[:i+1]`` and the
frozen params, so two prompts with the same token prefix have
bit-identical K/V rows over it (vLLM's PagedAttention observation,
arXiv:2309.06180, on this repo's dense-slot terms).

Granularity is the engine's prefill CHUNK: an entry is one whole chunk
of K/V rows ``[L, chunk_tokens, Hkv, hd]`` keyed by the token tuple of
the ENTIRE prefix through that chunk (a Python dict over token tuples IS
a content-hashed map, with collision resolution for free — no rolling
hash to get wrong). Corollary: a shared prefix shorter than one chunk
never caches, and sharing stops at the last whole-chunk boundary inside
the common prefix — size the chunk at or below the system prompt. Chunk entries chain: a request's lookup walks its
prompt chunk by chunk and stops at the first miss, so a prompt matching
2 of 3 cached chunks still reuses 2. A hit is capped at
``floor((P-1)/chunk)`` chunks — at least the prompt's last token must
prefill for real, because its logits seed the first sampled token.

Admission is explicit and observable: ``insert`` is called by the engine
once a request's prefill COMPLETES (never for requests that opted out),
capacity is bounded in cached tokens with LRU eviction, and every
hit/miss/insert/eviction increments a counter surfaced on the serve
``/metrics``. Single-threaded by design: only the engine's tick thread
calls ``match``/``insert``; ``stats`` reads plain ints and is safe from
the HTTP threads.
"""

from __future__ import annotations

import collections


class PrefixCache:
    """Chunk-granular LRU over token-prefix keys. ``blocks`` values are
    opaque to this class (the engine stores ``(k, v)`` device arrays),
    so every policy decision is testable without a model."""

    def __init__(self, capacity_tokens: int, chunk_tokens: int,
                 on_evict=None) -> None:
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1; got {chunk_tokens}")
        if capacity_tokens < chunk_tokens:
            raise ValueError(
                f"capacity_tokens ({capacity_tokens}) must hold at least "
                f"one chunk ({chunk_tokens} tokens)"
            )
        self.chunk_tokens = int(chunk_tokens)
        self.capacity_tokens = int(capacity_tokens)
        # eviction hook, called with the evicted block value: the paged
        # engine derefs the chunk's KV blocks here (dense mode needs
        # nothing — dropping the device arrays frees them)
        self.on_evict = on_evict
        # prefix token tuple (whole chunks) -> block; move_to_end = LRU
        self._blocks: collections.OrderedDict[tuple, object] = (
            collections.OrderedDict()
        )
        self.hits = 0            # lookups that reused >= 1 chunk
        self.misses = 0          # lookups that reused none
        self.hit_tokens = 0      # prompt tokens NOT re-prefilled
        self.insertions = 0      # chunks inserted
        self.evictions = 0       # chunks LRU-evicted
        # weight-generation tag: bumped by ``clear()`` (a serve-weight
        # hot swap invalidates every entry — cached K/V was computed
        # under the OLD params, and a post-swap hit would splice
        # old-weight rows into a new-weight stream, breaking the
        # bit-parity contract). The tag lets tests and gauges pin that
        # a post-swap lookup can never see pre-swap KV.
        self.generation = 0
        self.invalidations = 0   # chunks dropped by clear()

    @property
    def cached_tokens(self) -> int:
        return len(self._blocks) * self.chunk_tokens

    def match(self, prompt, record: bool = True) -> list:
        """Longest chain of cached whole-chunk prefixes of ``prompt``
        (capped so at least one prompt token is left to prefill).
        Returns the blocks in chunk order ([] = miss); bumps LRU on
        every chunk of the hit path. ``record=False`` is a pure PEEK —
        no counters, no LRU movement — for admission paths that must
        size an allocation BEFORE committing to the hit (a rolled-back
        admission must not look like cache traffic)."""
        cs = self.chunk_tokens
        prompt = tuple(prompt)
        max_chunks = (len(prompt) - 1) // cs
        blocks: list = []
        for i in range(max_chunks):
            key = prompt[: (i + 1) * cs]
            block = self._blocks.get(key)
            if block is None:
                break
            if record:
                self._blocks.move_to_end(key)
            blocks.append(block)
        if not record:
            return blocks
        if blocks:
            self.hits += 1
            self.hit_tokens += len(blocks) * cs
        else:
            self.misses += 1
        return blocks

    def insert(self, prompt, n_chunks: int, extract) -> int:
        """Cache the first ``n_chunks`` whole chunks of ``prompt``.
        ``extract(chunk_index)`` materializes the block for a chunk not
        yet cached (the engine copies it off the slot's K/V rows — paid
        only for genuinely new chunks). Returns how many chunks were
        newly inserted; evicts LRU entries past ``capacity_tokens``."""
        cs = self.chunk_tokens
        prompt = tuple(prompt)
        inserted = 0
        for i in range(n_chunks):
            if (i + 1) * cs > self.capacity_tokens:
                # a chain longer than the whole cache can never be
                # looked up intact; inserting its tail would only evict
                # useful entries to store unreachable ones
                break
            key = prompt[: (i + 1) * cs]
            if key in self._blocks:
                self._blocks.move_to_end(key)
                continue
            self._blocks[key] = extract(i)
            self.insertions += 1
            inserted += 1
            while self.cached_tokens > self.capacity_tokens:
                # LRU. A mid-chain eviction strands its longer suffixes
                # (lookup walks from chunk 0 and stops at the gap) until
                # LRU drains them too — bounded staleness, zero extra
                # bookkeeping, and never a wrong hit.
                _key, evicted = self._blocks.popitem(last=False)
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(evicted)
        return inserted

    def clear(self) -> int:
        """Invalidate EVERY cached chunk and bump ``generation`` — the
        weight hot-swap path (``InferenceEngine.swap_weights``): cached
        K/V rows were computed under the old params and are garbage
        under the new ones, so reuse across a swap would break the
        streams-bit-identical-to-solo-``generate()`` contract in the
        quietest possible way (a plausible-looking stream computed from
        stale keys). Runs ``on_evict`` per entry, so the paged engine's
        block references are released exactly as LRU eviction would.
        Returns the number of chunks dropped."""
        n = len(self._blocks)
        while self._blocks:
            _key, evicted = self._blocks.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(evicted)
        self.invalidations += n
        self.generation += 1
        return n

    def evict_lru(self) -> bool:
        """Evict exactly the LRU entry (False when empty) — the paged
        engine's reclaim-under-pressure path: cached blocks are a
        best-effort optimization, and admission starving behind them
        would be a livelock (the only other eviction trigger is
        ``insert``, which needs a prefill to COMPLETE first)."""
        if not self._blocks:
            return False
        _key, evicted = self._blocks.popitem(last=False)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(evicted)
        return True

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "generation": self.generation,
            "invalidations": self.invalidations,
            "cached_tokens": self.cached_tokens,
            "capacity_tokens": self.capacity_tokens,
            "chunk_tokens": self.chunk_tokens,
        }
