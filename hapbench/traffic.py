"""The one traffic generator: it reads a traffic file (``traffic/<name>.json``)
and makes the jobs of a run from ``--seed``.

A job is a list of requests submitted together. Its lengths are the same
for every seed: prompt and output lengths sit at the quantiles
``(i + 0.5) / n`` of their distributions, paired by a fixed permutation and
put in an order fixed for each job of a run (job k of every run has the
same order), so that every seed makes the engine run the same schedule of
steps. The seed draws the token ids, uniform over the vocabulary; each job
of a run draws its own.

Keys of a traffic file:

  why, source,       what the mix stands for, the public source of its
  derivation, pool   lengths, how its parameters follow from it, and why the
                     KV pool has its size (read by no code)
  requests_per_job   requests in one job
  prompt_tokens      a length distribution (below) of each request's own prompt
  new_tokens         a length distribution of the tokens each request generates
  shared_prefix      optional: {"groups": G, "tokens": distribution}; request i
                     of the pairing starts with group i % G's prefix, drawn once
                     a job, ahead of its own prompt
  serve              "continuous" (``submit`` + ``serve_continuous``) or
                     "static" (``submit`` + ``run``)
  engine             keyword arguments of ``InferenceEngine`` a deployment passes
  prompt_bucket      the length the engine pads a prompt to a multiple of
  warm_new_tokens    new tokens of each warm-up request
  check              {"requests": n}: the requests the correctness check samples
  trace_steps        {"first": i, "count": n}: the engine steps of the traced job
                     that the profiler records (``harness``)

A length distribution is {"dist": "lognormal", "median", "sigma", "min",
"max"}, {"dist": "uniform", "min", "max"} or {"dist": "fixed", "value"}.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

# seed streams: the timed jobs, the warm-up job, the correctness sample
TIMED, WARM, SAMPLE = 0, 1, 2
# the fixed pairing of prompt and output lengths, the same for every seed
_PAIRING_SEED = 20240106


@dataclasses.dataclass
class Req:
    prompt: np.ndarray  # (S,) int32 token ids
    new_tokens: int


def quantile_lengths(spec: Dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``spec``, ascending."""
    u = [(i + 0.5) / n for i in range(n)]
    kind = spec["dist"]
    if kind == "fixed":
        return [int(spec["value"])] * n
    if kind == "uniform":
        lo, hi = spec["min"], spec["max"]
        return [int(round(lo + q * (hi - lo))) for q in u]
    if kind == "lognormal":
        z = NormalDist()
        vals = [spec["median"] * math.exp(spec["sigma"] * z.inv_cdf(q)) for q in u]
        return [int(min(max(round(v), spec["min"]), spec["max"])) for v in vals]
    raise ValueError(f"unknown length distribution {kind!r}")


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream, index])


def job_shape(traffic: Dict) -> List[tuple]:
    """The (own prompt length, new tokens, prefix group) of every request of a
    job, in the fixed pairing; the same for every seed."""
    n = traffic["requests_per_job"]
    prompts = quantile_lengths(traffic["prompt_tokens"], n)
    news = quantile_lengths(traffic["new_tokens"], n)
    pair = np.random.default_rng(_PAIRING_SEED).permutation(n)
    groups = traffic.get("shared_prefix", {}).get("groups", 0)
    return [(prompts[i], news[pair[i]], i % groups if groups else -1) for i in range(n)]


def _prefixes(traffic: Dict, vocab: int, g: np.random.Generator) -> List[np.ndarray]:
    sp = traffic.get("shared_prefix")
    if not sp:
        return []
    lens = quantile_lengths(sp["tokens"], sp["groups"])
    return [g.integers(0, vocab, size=n, dtype=np.int32) for n in lens]


def _requests(shape: List[tuple], traffic: Dict, vocab: int, g: np.random.Generator) -> List[Req]:
    prefixes = _prefixes(traffic, vocab, g)
    out = []
    for own, new, group in shape:
        toks = g.integers(0, vocab, size=own, dtype=np.int32)
        if group >= 0:
            toks = np.concatenate([prefixes[group], toks])
        out.append(Req(toks, int(new)))
    return out


def job(traffic: Dict, vocab: int, seed: int, index: int) -> List[Req]:
    """Job ``index`` of a run with ``seed``: the fixed lengths in the job's
    fixed order, with token ids drawn from the seed."""
    shape = job_shape(traffic)
    order = np.random.default_rng([_PAIRING_SEED, index]).permutation(len(shape))
    return _requests([shape[i] for i in order], traffic, vocab, rng(seed, TIMED, index))


def final_chunk(length: int, traffic: Dict) -> int:
    """The size of a prompt's last prefill chunk after the engine pads it."""
    bucket = traffic["prompt_bucket"]
    chunk = traffic["engine"].get("prefill_chunk") or bucket
    padded = -(-max(length, 1) // bucket) * bucket
    return (padded - 1) % chunk + 1


def warm_job(traffic: Dict, vocab: int, seed: int) -> List[Req]:
    """A small job of the cell's own shapes: for each last-chunk size the
    traffic's prompts give, its shortest such prompt, with
    ``warm_new_tokens`` new tokens, longest prompt first."""
    by_class: Dict[int, tuple] = {}
    for own, _, group in job_shape(traffic):
        c = final_chunk(own, traffic)
        if c not in by_class or own < by_class[c][0]:
            by_class[c] = (own, traffic["warm_new_tokens"], group)
    shape = sorted(by_class.values(), reverse=True)
    return _requests(shape, traffic, vocab, rng(seed, WARM))
