"""Request batching: FIFO with padding buckets (the port of
``repro.serving.scheduler``).

Static batching: requests queue up, the scheduler drains up to
``max_batch`` of them, left-pads the prompts to a shared bucket length, and
the engine runs prefill once and decodes the batch in lockstep until every
request stops. With ``coalesce_buckets=True`` (the adaptive-serving
default) a batch only holds requests of one prompt bucket, so every batch
maps onto one workload bucket of the session's plan cache.

``ContinuousScheduler`` adds decode-time admission (continuous batching,
DESIGN.md §4b): the engine asks for the queue head at step boundaries and
admits it when the paged pool can reserve its worst-case KV need
(``next_fit_blocks``), charged after prefix sharing when a prefix cache is
given. Admission is strict head-of-line FIFO. The optimistic charge of the
robustness layer (``expected_kv_need``, DESIGN.md §4f) is not copied yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

from repro_torch.core.session import round_up


@dataclasses.dataclass
class QueuedRequest:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int


class FifoScheduler:
    def __init__(self, max_batch: int = 8, bucket: int = 64, coalesce_buckets: bool = False):
        self.max_batch = max_batch
        self.bucket = max(1, bucket)
        self.coalesce_buckets = coalesce_buckets
        self._q: Deque[QueuedRequest] = deque()
        self._next_uid = 0

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self._q.append(QueuedRequest(uid, np.asarray(prompt, np.int32), max_new_tokens))
        return uid

    def __len__(self) -> int:
        return len(self._q)

    def prompt_bucket(self, r: QueuedRequest) -> int:
        """Padded length this request's prompt lands in (>= one bucket)."""
        return round_up(max(len(r.prompt), 1), self.bucket)

    def padded_len(self, r: QueuedRequest) -> int:
        """First decode position after prefill: the prompt's padding bucket
        (the reference adds preempted tokens, which the port has not yet)."""
        return self.prompt_bucket(r)

    def peek(self) -> Optional[QueuedRequest]:
        """The queue head, without removing it (None when empty)."""
        return self._q[0] if self._q else None

    def queued(self) -> List[QueuedRequest]:
        """Snapshot of the queue in submission order."""
        return list(self._q)

    def next_batch(self) -> Optional[List[QueuedRequest]]:
        """Drain up to ``max_batch`` requests from the queue head; with
        ``coalesce_buckets`` stop at the first request of another prompt
        bucket (peek-then-pop: the rest of the queue keeps its order)."""
        if not self._q:
            return None
        b0 = self.prompt_bucket(self._q[0])
        batch: List[QueuedRequest] = []
        while self._q and len(batch) < self.max_batch:
            if batch and self.coalesce_buckets and self.prompt_bucket(self._q[0]) != b0:
                break
            batch.append(self._q.popleft())
        return batch

    def pad_batch(self, batch: List[QueuedRequest], pad_id: int = 0):
        """Left-pad to a bucket multiple. Returns (tokens (B, S), lengths).

        S is always at least one bucket (empty prompts pad to a full bucket).
        """
        S = round_up(max(max(len(r.prompt) for r in batch), 1), self.bucket)
        toks = np.full((len(batch), S), pad_id, np.int32)
        lens = np.zeros((len(batch),), np.int32)
        for i, r in enumerate(batch):
            if len(r.prompt):
                toks[i, S - len(r.prompt) :] = r.prompt
            lens[i] = len(r.prompt)
        return toks, lens


class ContinuousScheduler(FifoScheduler):
    """FIFO queue with decode-time admission (continuous batching).

    The continuous engine calls ``next_fit_blocks`` at step boundaries: the
    queue head is admitted only when its worst-case KV need fits the
    block-table width and the pool's free blocks. A head that does not fit
    the width blocks the queue until the live batch drains and a fresh pool
    is sized for it; a head short only on blocks becomes admittable as
    retirements return blocks.
    """

    def kv_need(self, r: QueuedRequest) -> int:
        """Worst-case cache rows: padded prompt + gen budget + 1."""
        return self.padded_len(r) + max(r.max_new_tokens, 1) + 1

    def next_fit_blocks(self, allocator, max_tokens: int, prefix_cache=None) -> Optional[QueuedRequest]:
        """Pop the queue head iff its worst-case KV need fits the table
        width (``max_tokens``) AND the allocator can reserve its blocks.

        With a ``prefix_cache`` the head is charged its *effective*
        post-sharing need (adopted blocks are not allocated; a partially
        shared tail block charges one spare for its copy-on-write fork). A
        head short on blocks first evicts cache-only prefix entries (oldest
        first, never the blocks its own match relies on).
        """
        head = self.peek()
        if head is None:
            return None
        if self.kv_need(head) > max_tokens:
            return None
        need = self.kv_need(head)
        if prefix_cache is None:
            if not allocator.can_admit(allocator.blocks_for(need)):
                return None
            return self._q.popleft()
        toks, _ = self.pad_batch([head])
        plan = prefix_cache.plan_admission(toks[0], need)
        if not allocator.can_admit(plan.reserve_blocks):
            prefix_cache.evict(plan.reserve_blocks - allocator.num_available, keep=set(plan.match.blocks))
            if not allocator.can_admit(plan.reserve_blocks):
                return None
        return self._q.popleft()
