"""Prefix cache: hash prompt-prefix runs to physical KV blocks (COW shared);
a copy of ``repro.serving.prefix_cache``.

Production serving workloads are dominated by requests sharing long
system/tool prompts. Without reuse, every admission re-prefills its full
prompt and stores it into private KV blocks — O(shared-prefix) compute
and memory paid per request. This subsystem (DESIGN.md §4d) makes the
paged pool (``repro_torch.serving.kv_cache``) content-addressable at block
granularity:

- **register**: when a request's prefill completes, its padded prompt is
  split into block-aligned *cumulative runs* (tokens ``[:k*bs]`` for
  each full block k); each run hashes to the physical block holding its
  k-th chunk. The cache takes its own reference on every registered
  block (``BlockAllocator.share``), so registered prefixes outlive their
  donor request. A prompt ending mid-block additionally registers a
  *tail* entry so a later prompt can share the partial last block.
- **match**: an incoming padded prompt walks its cumulative-run hashes
  front to back; every hit is verified by a **full token-run compare**
  (hash equality alone never shares a block — collision safety), and
  the walk stops at the first miss. After the full-block walk, tail
  entries are probed for a partial last-block match — including a
  *divergent* tail: the donor and the candidate may share only the
  first few tokens of that block, which is exactly the
  diverge-into-a-shared-tail case copy-on-write exists for.
- **adopt**: the engine builds the joiner's ``BlockTable`` with the
  matched blocks (one extra reference each), skips the covered prefill
  chunks, and reserves only the unmatched remainder — admission
  (``ContinuousScheduler.next_fit_blocks``) charges this *effective*
  need, so the same pool admits far more same-prefix users.
- **COW**: the first write into a shared block (a diverging prompt tail,
  or the donor's own decode continuing past its prompt) forks it via
  ``BlockTable.ensure_writable`` — the cache's copy is immutable.
- **evict**: when admission is short on blocks, cache-only references
  (refcount 1 — no live request holds the block) are dropped oldest
  first until the shortfall is covered; blocks a pending match relies on
  are protected via ``keep``.

Hashing is over the **padded** prompt: the continuous engine left-pads
every prompt to its bucket (``FifoScheduler.pad_batch``), so KV content
at a physical block only matches between requests whose *padded* token
runs agree — keying on raw prompts would alias rows whose pad offsets
differ. The hash function is injectable (tests force collisions to
prove the full-compare guard); the default is crc32 over the token
bytes, which is cheap and explicitly not collision-free — correctness
never rests on it.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from .kv_cache import BlockAllocator, blocks_for


def _crc32(data: bytes) -> int:
    return zlib.crc32(data)


@dataclasses.dataclass
class _ChunkEntry:
    """One cumulative block-aligned run -> the block holding its last chunk."""

    run: np.ndarray  # (k * block_size,) int32 — the full cumulative run
    block: int
    stamp: int  # LRU clock at last touch


@dataclasses.dataclass
class _TailEntry:
    """A donor prompt ending mid-block: its partial last block, keyed by
    the hash of the full-block prefix it extends."""

    run: np.ndarray  # the donor's whole padded prompt (S,), S % bs != 0
    start: int  # first token position stored in ``block`` (= S // bs * bs)
    block: int
    stamp: int


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """A verified shared prefix: ``blocks`` hold tokens ``[:n_tokens]``.

    ``n_tokens`` need not be block-aligned — the last entry of ``blocks``
    may be a partially-matched tail block (shared up to the divergence
    point; writing past it copy-on-writes the block).
    """

    n_tokens: int
    blocks: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """What admitting a prompt costs after prefix sharing.

    ``skip`` is the prefill positions the engine may jump past (always
    leaves >= 1 token to recompute so last-position logits exist for
    sampling); ``adopt`` the matched blocks the new table starts with;
    ``reserve_blocks`` the blocks admission must still find — the
    *effective* need ``next_fit_blocks`` charges instead of the raw
    ceil(kv_need / block_size).
    """

    match: PrefixMatch
    skip: int
    adopt: List[int]
    adopt_partial: bool  # last adopted block only partially covered (COW pending)
    raw_blocks: int
    reserve_blocks: int


class PrefixCache:
    """Block-aligned prompt-prefix index over one live batch's block pool.

    Lifetime is one live-batch *generation*: the physical pages and the
    allocator are rebuilt whenever the engine drains and resizes, and the
    cache goes with them. Entries hold their own block references, so a
    registered prefix survives its donor's retirement until evicted.
    """

    def __init__(
        self,
        allocator: BlockAllocator,
        hash_fn: Callable[[bytes], int] = _crc32,
    ):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self._hash = hash_fn
        self._chunks: Dict[int, List[_ChunkEntry]] = {}
        self._tails: Dict[int, List[_TailEntry]] = {}
        self._clock = 0
        # counters surfaced through EngineStats / serve.py logging
        self.hits = 0
        self.hit_blocks = 0
        self.hit_tokens = 0
        self.evicted_blocks = 0

    def __len__(self) -> int:
        return sum(len(v) for v in self._chunks.values()) + sum(
            len(v) for v in self._tails.values()
        )

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _key(self, tokens: np.ndarray, n: int) -> int:
        return self._hash(np.ascontiguousarray(tokens[:n], np.int32).tobytes())

    # -- match ------------------------------------------------------------
    def match(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest verified shared prefix of a padded prompt.

        Walks full-block cumulative runs first (hash lookup + full
        token-run compare per step), then probes tail entries for a
        partial match inside the next block. Never trusts a hash alone.
        """
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        S = len(tokens)
        blocks: List[int] = []
        m = 0
        while (m + 1) * bs <= S:
            n = (m + 1) * bs
            hit = None
            for e in self._chunks.get(self._key(tokens, n), []):
                if len(e.run) == n and np.array_equal(e.run, tokens[:n]):
                    hit = e
                    break
            if hit is None:
                break
            hit.stamp = self._tick()
            blocks.append(hit.block)
            m += 1
        n = m * bs
        if n < S:
            best_len, best = 0, None
            for t in self._tails.get(self._key(tokens, n), []):
                if t.start != n or not np.array_equal(t.run[:n], tokens[:n]):
                    continue
                cmp = min(S, len(t.run)) - n
                if cmp <= 0:
                    continue
                eq = t.run[n : n + cmp] == tokens[n : n + cmp]
                matched = int(cmp if eq.all() else np.argmin(eq))
                if matched > best_len:
                    best_len, best = matched, t
            if best is not None:
                best.stamp = self._tick()
                blocks.append(best.block)
                n += best_len
        if blocks:
            self.hits += 1
            self.hit_blocks += len(blocks)
            self.hit_tokens += n
        return PrefixMatch(n_tokens=n, blocks=blocks)

    # -- admission planning ----------------------------------------------
    def plan_admission(self, tokens: np.ndarray, need_tokens: int) -> AdmissionPlan:
        """Match a padded prompt and price its effective block need.

        ``skip = min(matched, S - 1)``: at least the last prompt token is
        always recomputed so the final chunk produces the logits sampling
        needs. The effective need subtracts fully-shared adopted blocks
        but still charges one block for a partially-adopted tail — its
        copy-on-write fork must never deadlock on an empty pool.
        """
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        match = self.match(tokens)
        skip = min(match.n_tokens, len(tokens) - 1)
        n_adopt = blocks_for(skip, bs)
        adopt = match.blocks[:n_adopt]
        partial = bool(adopt) and skip % bs != 0
        raw = blocks_for(need_tokens, bs)
        reserve = max(raw - len(adopt) + (1 if partial else 0), 0)
        return AdmissionPlan(
            match=match,
            skip=skip,
            adopt=adopt,
            adopt_partial=partial,
            raw_blocks=raw,
            reserve_blocks=reserve,
        )

    # -- register ---------------------------------------------------------
    def register(self, tokens: np.ndarray, blocks: Sequence[int]) -> int:
        """Index a completed prefill: ``blocks`` hold the padded prompt
        ``tokens``. Takes one cache-owned reference per newly-indexed
        block (first writer wins — an identical run already present is
        left alone, so re-registering a shared prefix never double-refs).
        Returns the number of blocks newly indexed."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        S = len(tokens)
        if len(blocks) < blocks_for(S, bs):
            raise ValueError("block list does not cover the prompt")
        added = 0
        m = S // bs
        for k in range(1, m + 1):
            n = k * bs
            key = self._key(tokens, n)
            bucket = self._chunks.setdefault(key, [])
            if any(
                len(e.run) == n and np.array_equal(e.run, tokens[:n]) for e in bucket
            ):
                continue
            self.allocator.share(blocks[k - 1])
            bucket.append(
                _ChunkEntry(
                    run=tokens[:n].copy(), block=blocks[k - 1], stamp=self._tick()
                )
            )
            added += 1
        if S % bs:
            key = self._key(tokens, m * bs)
            bucket = self._tails.setdefault(key, [])
            if not any(
                len(t.run) == S and np.array_equal(t.run, tokens) for t in bucket
            ):
                self.allocator.share(blocks[m])
                bucket.append(
                    _TailEntry(
                        run=tokens.copy(), start=m * bs, block=blocks[m],
                        stamp=self._tick(),
                    )
                )
                added += 1
        return added

    # -- evict ------------------------------------------------------------
    def evict(self, n_blocks: int, keep: Optional[Set[int]] = None) -> int:
        """Drop cache-only references, oldest entries first, until
        ``n_blocks`` blocks went back to the free list (or no candidates
        remain). An entry is evictable only when the cache holds the last
        reference (refcount 1 — no live request uses the block) and the
        block is not in ``keep`` (a pending match's blocks). Returns the
        number of blocks actually freed."""
        keep = keep or set()
        freed = 0
        entries = [
            (e.stamp, key, e, self._chunks)
            for key, lst in self._chunks.items()
            for e in lst
        ] + [
            (t.stamp, key, t, self._tails)
            for key, lst in self._tails.items()
            for t in lst
        ]
        for _, key, entry, table in sorted(entries, key=lambda x: x[0]):
            if freed >= n_blocks:
                break
            if entry.block in keep or self.allocator.refcount(entry.block) != 1:
                continue
            table[key].remove(entry)
            if not table[key]:
                del table[key]
            if self.allocator.free_block(entry.block):
                freed += 1
                self.evicted_blocks += 1
        return freed
