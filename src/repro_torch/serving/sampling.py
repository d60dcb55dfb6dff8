"""Token sampling strategies (the port of ``repro.serving.sampling``).

Greedy argmax is the exactness contract the tests hold against the JAX
engine. Temperature sampling draws from a seeded ``torch.Generator``; it
cannot replay ``jax.random``, so it is outside that contract. It draws the
whole batch's randoms (Gumbel noise, one per row and token) at every step,
wherever its rows are computed, so a row's token does not depend on how a
mesh splits the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filter
    seed: int = 0


def sample(logits: torch.Tensor, params: SamplingParams, generator: Optional[torch.Generator] = None,
           rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """logits: (b, V) -> (b,) int64 next tokens. ``rows = (lo, hi, n)``:
    the logits are rows ``[lo, hi)`` of a batch of ``n`` (default: the whole
    batch). At a temperature the draws are the whole batch's, of which the
    rows keep theirs (the Gumbel-max trick: the argmax of the scaled logits
    plus Gumbel noise is a draw from their softmax)."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lo, hi, n = rows if rows is not None else (0, logits.shape[0], logits.shape[0])
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        thresh = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= thresh, logits, -1e30)
    # uniforms on [tiny, 1), as ``jax.random.gumbel`` draws them: at u = 0
    # the noise would be -inf and the token could never be drawn
    u = torch.rand((n, logits.shape[-1]), generator=generator, device=logits.device)[lo:hi]
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
