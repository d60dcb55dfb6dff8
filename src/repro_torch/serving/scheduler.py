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
admits it when the paged pool can reserve its KV need
(``next_fit_blocks``): the worst case by default, the expected need
(``expected_kv_need``) under optimistic admission (DESIGN.md §4f), charged
after prefix sharing when a prefix cache is given. Admission is strict
head-of-line FIFO; a preempted request goes back to the head (``requeue``)
and replays its generated tokens as extra prompt (``stashed``).
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
    max_new_tokens: int  # REMAINING output budget (preemption shrinks it)
    # -- request lifecycle (DESIGN.md §4f) --------------------------------
    deadline: Optional[float] = None  # absolute monotonic seconds, or None
    cancelled: bool = False  # user cancel; reaped at the next boundary
    # preemption-by-recompute state: tokens generated before this request
    # was preempted. A re-admission replays them as extra prompt (after the
    # original prompt's own padding bucket, so the RoPE positions, and so
    # the greedy outputs, match an unpreempted run), and the completion
    # re-attaches them ahead of the resumed tokens.
    stashed: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0  # times preempted (victim-eligibility cap)


class FifoScheduler:
    def __init__(self, max_batch: int = 8, bucket: int = 64, coalesce_buckets: bool = False):
        self.max_batch = max_batch
        self.bucket = max(1, bucket)
        self.coalesce_buckets = coalesce_buckets
        self._q: Deque[QueuedRequest] = deque()
        self._next_uid = 0

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32, deadline: Optional[float] = None) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self._q.append(QueuedRequest(uid, np.asarray(prompt, np.int32), max_new_tokens, deadline=deadline))
        return uid

    def __len__(self) -> int:
        return len(self._q)

    def requeue(self, r: QueuedRequest) -> None:
        """Push a preempted request back at the queue head: it resumes
        first, so admission order still tracks the original service order."""
        self._q.appendleft(r)

    def cancel(self, uid: int) -> bool:
        """Flag a queued request cancelled (reaped at the next boundary);
        False when ``uid`` is not in the queue."""
        for r in self._q:
            if r.uid == uid:
                r.cancelled = True
                return True
        return False

    def remove(self, r: QueuedRequest) -> None:
        self._q.remove(r)

    def prompt_bucket(self, r: QueuedRequest) -> int:
        """Padded length this request's prompt lands in (>= one bucket)."""
        return round_up(max(len(r.prompt), 1), self.bucket)

    def padded_len(self, r: QueuedRequest) -> int:
        """First decode position after prefill: the prompt's own padding
        bucket, plus any stashed (preempted) tokens appended after it. The
        padding stays what the first admission used, so the replayed RoPE
        positions match the unpreempted run."""
        return self.prompt_bucket(r) + len(r.stashed)

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
        A preempted request (``r.stashed`` non-empty; continuous
        re-admission, one at a time) pads its original prompt to its own
        bucket ``S0`` and appends the stashed tokens after it: the token
        row an unpreempted run saw at that depth.
        """
        if any(r.stashed for r in batch):
            if len(batch) != 1:
                raise ValueError("stashed (preempted) requests re-admit one at a time")
            r = batch[0]
            S0 = self.prompt_bucket(r)
            toks = np.full((1, S0 + len(r.stashed)), pad_id, np.int32)
            if len(r.prompt):
                toks[0, S0 - len(r.prompt) : S0] = r.prompt
            toks[0, S0:] = np.asarray(r.stashed, np.int32)
            return toks, np.asarray([len(r.prompt) + len(r.stashed)], np.int32)
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
    block-table width and its charge fits the pool's free blocks (the
    contiguous fallback's ``next_fit``: when it fits a slot's capacity). A head that does not fit
    the width blocks the queue until the live batch drains and a fresh pool
    is sized for it; a head short only on blocks becomes admittable as
    retirements return blocks.
    """

    def kv_need(self, r: QueuedRequest) -> int:
        """Worst-case cache rows: padded prompt (+ stashed replay) + the
        remaining gen budget + 1. Invariant under preemption: the replay
        grows ``padded_len`` by exactly what it took from the budget."""
        return self.padded_len(r) + max(r.max_new_tokens, 1) + 1

    def expected_kv_need(self, r: QueuedRequest, overcommit: float) -> int:
        """Optimistic admission charge: the prompt is certain, but only
        ``overcommit`` of the output budget is reserved up front; the
        engine's preemption-by-recompute covers the overflow. Never below
        one decode token, never above the worst case."""
        gen = max(r.max_new_tokens, 1)
        expect = int(np.ceil(overcommit * gen))
        return self.padded_len(r) + min(max(expect, 1), gen) + 1

    def next_fit(self, kv_capacity: int) -> Optional[QueuedRequest]:
        """Contiguous admission: pop the queue head iff its worst-case KV
        need fits the per-slot ``kv_capacity``, else None."""
        head = self.peek()
        if head is None or self.kv_need(head) > kv_capacity:
            return None
        return self._q.popleft()

    def next_fit_blocks(self, allocator, max_tokens: int, prefix_cache=None,
                        overcommit: Optional[float] = None) -> Optional[QueuedRequest]:
        """Pop the queue head iff its worst-case KV need fits the table
        width (``max_tokens``) AND the allocator can reserve its charge:
        the worst case, or with ``overcommit`` (0 < f <= 1) the expected
        need (``expected_kv_need``). The width check stays worst-case: a
        request must be able to run to its full budget in these tables.

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
        need = self.expected_kv_need(head, overcommit) if overcommit else self.kv_need(head)
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
