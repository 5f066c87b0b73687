"""Host-side KV block allocator: the policy half of the paged cache.

A copy of ``nanodiloco_tpu/serve/block_pool.py`` (jax-free): the
engine's paged arena allocates from it, and the scheduler keeps a
request queued on ``BlocksExhausted``.

The arena on device is ``[L, num_blocks, block_size, Hkv, hd]``; this
class owns WHICH physical blocks belong to WHOM. Blocks are fully
interchangeable (any block can hold any sequence's rows — the block
table, not adjacency, defines order), so a free list is
fragmentation-free by construction: an allocation succeeds iff enough
blocks are free, regardless of how past allocations interleaved.

Reference counting makes shared-prefix reuse copy-on-write for free:
a newly allocated block has refcount 1 (its slot); mapping it into
another slot's table or into the prefix cache's chunk registry bumps
the count; every holder ``deref``s on release, and the block returns
to the free list only at zero. Writers never touch a shared block —
the engine only writes at positions past its prefix-hit boundary, and
those always live in refcount-1 blocks — so "copy"-on-write never
actually copies: divergent suffixes were never shared to begin with.

``alloc`` is ALL-OR-NOTHING: it either returns the full set or raises
``BlocksExhausted`` having mutated nothing, so a failed admission can
never leak a partial allocation (the scheduler leaves the request
queued and retries when blocks free up). Single-threaded by design
(the engine tick thread); ``stats`` reads plain ints and is safe from
HTTP threads.
"""

from __future__ import annotations


class BlocksExhausted(RuntimeError):
    """Raised by ``alloc`` when the pool cannot currently supply the
    requested blocks — the retryable admission signal (distinct from a
    request that can NEVER fit, which is a ``ValueError`` at
    validation). The scheduler keeps the request queued."""


class BlockPool:
    """Free-list + refcount allocator over ``num_blocks`` interchangeable
    KV blocks of ``block_size`` token rows each."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1; got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1; got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list: ids are popped from the end, so recently freed
        # blocks are reused first (warm-ish HBM, and deterministic)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self.total_allocated = 0   # blocks ever handed out (counter)
        self.total_freed = 0       # blocks ever returned (counter)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """``n`` fresh blocks at refcount 1, or ``BlocksExhausted`` with
        the pool untouched (all-or-nothing — no partial allocation to
        roll back)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise BlocksExhausted(
                f"need {n} KV blocks but only {len(self._free)}/"
                f"{self.num_blocks} are free"
            )
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self.total_allocated += n
        return blocks

    def ref(self, blocks) -> None:
        """Add one reference to each live block (a second slot or the
        prefix cache mapping it). Refusing dead blocks loudly turns a
        table-bookkeeping bug into a test failure, not silent
        corruption."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"block {b} is not allocated")
            self._ref[b] += 1

    def deref(self, blocks) -> int:
        """Drop one reference per block; blocks reaching zero return to
        the free list. Returns how many were actually freed."""
        freed = 0
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"block {b} is not allocated")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed += 1
        self.total_freed += freed
        return freed

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_free": self.free_blocks,
            "blocks_used": self.used_blocks,
            "total_allocated": self.total_allocated,
            "total_freed": self.total_freed,
        }
