"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests it finished is drawn
from the seed, the longest of them always in it. For each, the sequence the
engine served is rebuilt: the prompt left-padded with token 0 to a multiple
of the traffic's ``prompt_bucket`` (the engine's definition of a served
prompt), then the served tokens but the last. The plain reference computes
the logits at the positions that produced each served token, and the number
compared is the mean, over the served tokens, of the gap by which a served
token's reference logit lies below the reference's best at that position.
Greedy decoding picks the program's own best, so a sound program's gap is
rounding, zero at most positions; a wrong token, a lost cache write or a
dropped row shows as gaps of the logits' own scale. The widest gap is
reported beside it: in bf16 it already reaches the logits' spread, so it
does not part a sound program from the float8 control (PERF.md).

The control puts the reference in the program's place in float8 (W8A8):
at each of the same positions its gap is that of the token it puts first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hapbench import traffic as traffic_mod
from hapbench.reference import model as reference


def sample(finished: Sequence[Tuple[np.ndarray, int, List[int]]], traffic: Dict, seed: int) -> List[int]:
    """Indices into ``finished`` ((prompt, new tokens, served tokens) of each
    request the window finished): the longest request, then others drawn
    from the seed, ``traffic["check"]["requests"]`` in all."""
    n = min(traffic["check"]["requests"], len(finished))
    if n == 0:
        return []
    longest = max(range(len(finished)), key=lambda i: (len(finished[i][0]) + finished[i][1], -i))
    rest = [i for i in traffic_mod.rng(seed, traffic_mod.SAMPLE).permutation(len(finished)) if i != longest]
    return [longest] + [int(i) for i in rest[: n - 1]]


def served_row(prompt: np.ndarray, served: List[int], bucket: int) -> Tuple[np.ndarray, int]:
    """(the token row the engine ran, the position whose logits gave the
    first served token)."""
    padded = -(-max(len(prompt), 1) // bucket) * bucket
    row = np.zeros(padded + max(len(served) - 1, 0), np.int64)
    row[padded - len(prompt) : padded] = prompt
    row[padded:] = served[:-1]
    return row, padded - 1


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best, under ``ref`` (n, V)."""
    return ref.max(dim=-1).values - ref.gather(-1, tokens[:, None].to(ref.device))[:, 0]


def served_gaps(ref: List[torch.Tensor], served: List[List[int]]) -> torch.Tensor:
    """Every served token's gap under the reference logits ``ref``, row after row."""
    return torch.cat([gaps(r, torch.as_tensor(s)) for r, s in zip(ref, served)]).cpu()


def stand_in_gaps(ref: List[torch.Tensor], params: Dict, cfg: Dict, rows: List[Tuple[np.ndarray, int]],
                  precision: str) -> torch.Tensor:
    """The reference in ``precision`` put in the program's place: at each
    served position, the gap under the float32 reference ``ref`` of the token
    it puts first."""
    other = reference.logits(params, cfg, rows, precision=precision)
    return torch.cat([gaps(r, o.argmax(dim=-1)) for r, o in zip(ref, other)]).cpu()


def verdict(gap: Optional[float], failed: int, limits: Dict) -> Tuple[Dict, bool]:
    """The rule that decides ``correct``, for the program and for each stand-in
    alike: the mean gap within the cell's limit and no request unfinished.
    Returns each number compared beside its limit, and the verdict."""
    limit = limits["mean_logit_gap"]
    checks = {"mean_logit_gap": {"value": gap, "limit": limit}, "failed_requests": {"value": failed, "limit": 0}}
    return checks, gap is not None and gap <= limit and failed == 0
