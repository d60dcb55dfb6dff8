"""Paged KV-cache bookkeeping: block allocator + per-request block tables
(a copy of ``repro.serving.kv_cache``).

The continuous serving loop (DESIGN.md §4b) used to reserve worst-case
contiguous KV capacity per live-batch slot — ``max_batch`` rows, each as
long as the *largest* queued request could ever need. This module replaces
that with block-granular allocation, the standard fix in modern serving
systems (vLLM-style PagedAttention):

- the physical cache is a shared pool of fixed-size **blocks**
  (``(L, num_blocks, block_size, Hkv, hd)`` device arrays, built by
  ``repro_torch.models.init_paged_cache``),
- each live request owns a **block table** mapping its logical token
  positions to physical block ids; blocks are allocated on demand as the
  request's position crosses block boundaries during decode and returned
  to the free list when the request retires,
- admission checks **free blocks**, not contiguous slot capacity
  (``ContinuousScheduler.next_fit_blocks``), so mixed short/long requests
  share one memory pool instead of each slot paying the worst case.

Blocks are **refcounted** (DESIGN.md §4d): the prefix cache
(``repro_torch.serving.prefix_cache``) lets several requests — and the cache
itself — hold references to one physical block holding a shared prompt
prefix. Allocation hands out blocks at refcount 1; ``share`` adds a
holder; ``free_block`` drops one and only returns the block to the free
list when the count reaches zero. Writes require exclusive ownership:
``BlockTable.ensure_writable`` forks (copy-on-write) any block in the
write range whose refcount exceeds one, so a shared prefix is never
clobbered by a diverging sequence or by the donor's own decode tail.

Block id 0 is the **trash block**: it is never handed out, every unused
block-table entry points at it, and drained/mid-prefill rows scatter
their dead writes into it. That keeps the decode step's gather/scatter
shapes constant (the jit-cache contract) without masking branches.

Deadlock safety: a request *reserves* its worst-case block count
(padded prompt + output budget + 1 tokens, minus blocks covered by
shared-prefix adoption) at admission but only materializes blocks
lazily. Reserved-but-unallocated blocks are excluded from ``can_admit``,
so concurrent requests can never strand each other mid-decode —
``OutOfBlocks`` is reachable only by allocating past a table's own
budget.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

TRASH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """Raised when an allocation exceeds the pool (or a table's budget)."""


class DoubleFree(RuntimeError):
    """Raised when a block with no outstanding references is freed again."""


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache rows (ceil division)."""
    return -(-max(int(n_tokens), 0) // block_size)


class BlockAllocator:
    """Refcounted free-list allocator over a fixed pool of KV blocks.

    ``num_blocks`` counts the whole pool *including* the trash block, so
    ``num_blocks - 1`` blocks are actually allocatable. The free list is
    a LIFO stack: freshly retired blocks are reused first, which keeps
    the working set of physical blocks small and makes reuse observable
    in tests.

    Every allocated block carries a reference count (1 at allocation).
    ``share`` registers an additional holder (another request's table
    adopting a shared prefix block, or the prefix cache pinning a
    registered run); ``free_block`` drops one reference and returns the
    block to the free list only when none remain. Freeing a block that is
    already at refcount zero raises ``DoubleFree`` — the free list never
    silently double-inserts.
    """

    def __init__(self, num_blocks: int, block_size: int, faults=None):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block + trash")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # stack: initially pops ascending ids (1, 2, ...); frees push on top
        self._free: List[int] = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._reserved = 0
        self._ref: List[int] = [0] * num_blocks
        # optional FaultInjector (site "kv_alloc"): lets tests force
        # OutOfBlocks at an exact allocation index (DESIGN.md §4f)
        self.faults = faults
        # live tables, insertion-ordered, for per-holder occupancy in
        # OutOfBlocks diagnostics (registered at construction, dropped
        # at free())
        self._holders: Dict[int, "BlockTable"] = {}
        self._next_holder = 0

    # -- accounting -------------------------------------------------------
    @property
    def num_free(self) -> int:
        """Blocks on the free list (some may be spoken for — see below)."""
        return len(self._free)

    @property
    def num_reserved(self) -> int:
        """Blocks promised to live block tables but not yet materialized."""
        return self._reserved

    @property
    def num_available(self) -> int:
        """Blocks admission may promise to a *new* request right now."""
        return len(self._free) - self._reserved

    def can_admit(self, n_blocks: int) -> bool:
        return n_blocks <= self.num_available

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def refcount(self, block: int) -> int:
        """Outstanding references on ``block`` (0 = on the free list)."""
        return self._ref[block]

    def describe(self) -> str:
        """Live pool occupancy + per-holder block counts, for actionable
        ``OutOfBlocks`` messages: who holds what, and which knob to turn."""
        total = self.num_blocks - 1
        in_tables: set = set()
        for t in self._holders.values():
            in_tables.update(t.blocks)
        # allocated blocks no live table references — e.g. prefix-cache-only
        cached = (total - len(self._free)) - len(in_tables)
        holders = ", ".join(
            f"{t.owner or 'table'}={len(t.blocks)}+{t._reserve_left}r"
            for t in self._holders.values()
        )
        return (
            f"pool {total} blocks x {self.block_size} tok "
            f"({self.num_free} free, {self._reserved} reserved, "
            f"{cached} cache-only); holders: {holders or 'none'}"
        )

    # -- refcounting ------------------------------------------------------
    def share(self, block: int) -> int:
        """Register one more holder of an allocated block; returns the
        new refcount. Only live (refcount > 0) blocks can be shared — a
        freed block id may already belong to someone else."""
        if block == TRASH_BLOCK:
            raise ValueError("the trash block is not sharable")
        if self._ref[block] < 1:
            raise ValueError(f"block {block} is not allocated (refcount 0)")
        self._ref[block] += 1
        return self._ref[block]

    def free_block(self, block: int) -> bool:
        """Drop one reference; returns True iff the block went back to
        the free list (last holder released it)."""
        if block == TRASH_BLOCK:
            raise DoubleFree("freed the trash block (id 0) — never allocated")
        if self._ref[block] < 1:
            raise DoubleFree(
                f"block {block} double-freed: refcount is already 0 (the block "
                f"is on the free list). Shared blocks must be released exactly "
                f"once per holder — via BlockTable.free() for a request's "
                f"reference or PrefixCache eviction for the cache's — never "
                f"freed directly twice."
            )
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            return True
        return False

    # -- alloc / free (BlockTable-facing) ---------------------------------
    _HINT = (
        "raise the pool (--kv-blocks / InferenceEngine(kv_blocks=...)) or "
        "let preemption reclaim it (kv_overcommit)"
    )

    def _reserve(self, n_blocks: int) -> None:
        if not self.can_admit(n_blocks):
            raise OutOfBlocks(
                f"cannot reserve {n_blocks} blocks "
                f"({self.num_available} available of {self.num_blocks - 1}); "
                f"{self.describe()}; {self._HINT}"
            )
        self._reserved += n_blocks

    def _release(self, n_blocks: int) -> None:
        self._reserved -= n_blocks
        assert self._reserved >= 0, "released more reservation than held"

    def _alloc_reserved(self) -> int:
        """Materialize one reserved block (reservation -> allocation)."""
        assert self._reserved > 0
        if self.faults is not None:
            self.faults.fire("kv_alloc")
        self._reserved -= 1
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def _alloc_extra(self) -> int:
        """Allocate past a table's reservation — only from truly spare
        blocks, never from another request's reservation."""
        if self.faults is not None:
            self.faults.fire("kv_alloc")
        if self.num_available < 1:
            raise OutOfBlocks(
                f"pool exhausted ({self.num_free} free, "
                f"{self._reserved} reserved); {self.describe()}; {self._HINT}"
            )
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def _free_blocks(self, blocks: List[int]) -> None:
        for b in blocks:
            self.free_block(b)


class BlockTable:
    """One request's logical-position -> physical-block mapping.

    Created at admission with a worst-case token ``budget`` (reserved in
    the allocator); blocks materialize lazily via ``ensure_tokens`` as
    prefill chunks land and decode advances. ``free()`` returns every
    block reference and any unused reservation to the pool; it is
    idempotent (a second call is a no-op).

    ``shared_blocks`` adopts a matched prompt-prefix run from the prefix
    cache: the table starts with those blocks (one extra reference each)
    covering its leading positions, and reserves only the *unshared*
    remainder of its budget — plus one spare when ``shared_partial`` is
    set, because a partially-covered tail block will be forked
    (copy-on-write) at the first write into it. ``n_shared`` counts the
    leading still-shared blocks (the prefix-group kernel contract:
    those entries are identical across every table in the group).
    """

    def __init__(
        self,
        allocator: BlockAllocator,
        budget_tokens: int,
        shared_blocks: Sequence[int] = (),
        shared_partial: bool = False,
        owner: str = "",
    ):
        self.allocator = allocator
        self.owner = owner  # diagnostic label (e.g. "uid=3") for describe()
        self.budget_blocks = allocator.blocks_for(budget_tokens)
        if len(shared_blocks) > self.budget_blocks:
            raise ValueError("adopted more shared blocks than the token budget")
        if shared_partial and not shared_blocks:
            raise ValueError("shared_partial without shared blocks")
        self._reserve_left = max(
            self.budget_blocks - len(shared_blocks) + (1 if shared_partial else 0), 0
        )
        allocator._reserve(self._reserve_left)
        for b in shared_blocks:
            allocator.share(b)
        self.blocks: List[int] = list(shared_blocks)
        self.n_shared = len(shared_blocks)
        self._freed = False
        self._holder_id = allocator._next_holder
        allocator._next_holder += 1
        allocator._holders[self._holder_id] = self

    def __len__(self) -> int:
        return len(self.blocks)

    @property
    def capacity_tokens(self) -> int:
        return len(self.blocks) * self.allocator.block_size

    def _alloc(self) -> int:
        if self._reserve_left > 0:
            self._reserve_left -= 1
            return self.allocator._alloc_reserved()
        return self.allocator._alloc_extra()

    def ensure_tokens(self, n_tokens: int) -> None:
        """Grow the table until it covers ``n_tokens`` cache rows."""
        while self.capacity_tokens < n_tokens:
            self.blocks.append(self._alloc())

    def ensure_writable(self, start_token: int) -> List[Tuple[int, int]]:
        """Copy-on-write fork of every block overlapping positions
        ``>= start_token`` that has other holders (refcount > 1).

        Returns the (src, dst) physical-block copy pairs the caller must
        apply to the device pages *before* writing. The table swaps in
        the private dst and drops its reference on src (the other
        holders — group members, the prefix cache — keep it). Only the
        block containing ``start_token`` can be shared in practice
        (writes are append-only and shared runs are prefixes), but the
        scan covers the whole tail for safety. Forked blocks leave the
        shared prefix, so ``n_shared`` shrinks accordingly.
        """
        bs = self.allocator.block_size
        copies: List[Tuple[int, int]] = []
        for idx in range(max(start_token, 0) // bs, len(self.blocks)):
            src = self.blocks[idx]
            if self.allocator.refcount(src) <= 1:
                continue
            dst = self._alloc()
            copies.append((src, dst))
            self.blocks[idx] = dst
            self.allocator.free_block(src)
            if idx < self.n_shared:
                self.n_shared = idx
        if self.n_shared * bs > max(start_token, 0):
            # exclusively-owned tail (e.g. its other holders retired and
            # were evicted): no copy needed, but it is no longer shared
            self.n_shared = max(start_token, 0) // bs
        return copies

    def free(self) -> None:
        """Drop this table's reference on every block (returning blocks
        whose last holder this was to the pool) and release any unused
        reservation. Idempotent: freeing an already-freed table is a
        no-op — only a direct double-release of a block's refcount
        raises (``DoubleFree``)."""
        if self._freed:
            return
        self._freed = True
        self.allocator._holders.pop(self._holder_id, None)
        self.allocator._free_blocks(self.blocks)
        self.allocator._release(self._reserve_left)
        self._reserve_left = 0
        self.blocks = []
        self.budget_blocks = 0
        self.n_shared = 0

    def padded(self, width: int) -> np.ndarray:
        """The table as a fixed-width int32 row; unused entries point at
        the trash block (id 0)."""
        row = np.full((width,), TRASH_BLOCK, np.int32)
        n = min(len(self.blocks), width)
        row[:n] = self.blocks[:n]
        return row
