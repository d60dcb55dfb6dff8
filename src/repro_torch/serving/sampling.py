"""Token sampling strategies (the port of ``repro.serving.sampling``).

Greedy argmax is the exactness contract the tests hold against the JAX
engine. Temperature sampling draws from a seeded ``torch.Generator``; it
cannot replay ``jax.random``, so it is outside that contract.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filter
    seed: int = 0


def sample(logits: torch.Tensor, params: SamplingParams, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 next tokens."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        thresh = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= thresh, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
