"""Request batching: FIFO with padding buckets (the port of
``repro.serving.scheduler``, static batching).

Requests queue up; the scheduler drains up to ``max_batch`` of them,
left-pads the prompts to a shared bucket length, and the engine runs
prefill once and decodes the batch in lockstep until every request stops. (Bucket
coalescing serves the planner-driven session, which the port has not
reached yet.)
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np


def round_up(x: int, q: int) -> int:
    """x rounded up to a multiple of q (>= 0), the bucketing rule (a copy of
    ``repro.core.session.round_up``)."""
    return q * -(-max(int(x), 0) // q)


@dataclasses.dataclass
class QueuedRequest:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int


class FifoScheduler:
    def __init__(self, max_batch: int = 8, bucket: int = 64):
        self.max_batch = max_batch
        self.bucket = max(1, bucket)
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

    def next_batch(self) -> Optional[List[QueuedRequest]]:
        """Drain up to ``max_batch`` requests from the queue head."""
        if not self._q:
            return None
        n = min(self.max_batch, len(self._q))
        return [self._q.popleft() for _ in range(n)]

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
