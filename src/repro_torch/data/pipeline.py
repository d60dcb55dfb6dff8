"""Synthetic data pipelines (the port's copy of ``repro.data.pipeline``,
in numpy as there: the same seed gives bit-equal batches; the train loop
moves each batch to the device).

``synthetic_lm_data`` generates a deterministic, learnable token stream —
a k-th order Markov chain over a Zipf-distributed vocabulary — so training
loss measurably drops, which the end-to-end training example and tests
assert. The audio and vision variants emit the stub frontends' frame and
patch embeddings.

On a mesh (``plan``) every rank draws the same global batch from the seed
and keeps its data rows (``local_rows``).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


def _markov_tokens(rng: np.random.Generator, vocab: int, n: int,
                   order: int = 2, branch: int = 4) -> np.ndarray:
    """Zipf unigrams + sparse deterministic-ish transitions."""
    # transition table: each context hashes to `branch` candidates
    ctx = rng.integers(0, vocab, size=order)
    out = np.empty(n, np.int64)
    zipf_probs = 1.0 / np.arange(1, branch + 1)
    zipf_probs /= zipf_probs.sum()
    for i in range(n):
        h = (ctx[0] * 1000003 + ctx[-1] * 10007) % (2**31)
        cands = (h + np.arange(branch) * 2654435761) % vocab
        out[i] = cands[rng.choice(branch, p=zipf_probs)]
        ctx = np.roll(ctx, -1)
        ctx[-1] = out[i]
    return out


def local_rows(batch: Dict[str, np.ndarray], plan) -> Dict[str, np.ndarray]:
    """This rank's rows of a global ``batch`` under ``plan``: block
    ``dp_index`` of ``dp_size`` along the leading (batch) dimension of
    every array. The batch must divide the data-parallel axes
    (``sharding.specs.adapt_plan_for_batch`` drops them where it does not)."""
    from repro_torch.sharding.specs import dp_index, dp_size

    n = dp_size(plan)
    if n == 1:
        return batch
    B = len(next(iter(batch.values())))
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} data-parallel ranks")
    i, rows = dp_index(plan), B // n
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def synthetic_lm_data(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, plan=None) -> Iterator[Dict[str, np.ndarray]]:
    it = _synthetic_lm_data(cfg, batch, seq, seed)
    while True:
        yield local_rows(next(it), plan)


def _synthetic_lm_data(cfg: ModelConfig, batch: int, seq: int, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    while True:
        if cfg.frontend == "audio":
            feats = rng.standard_normal(
                (batch, seq, cfg.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
            yield {"features": feats, "labels": labels}
        elif cfg.frontend == "vision":
            n_text = max(seq - cfg.num_patches, 16)
            toks = _markov_tokens(rng, vocab, batch * (n_text + 1)).reshape(
                batch, n_text + 1)
            yield {
                "patches": rng.standard_normal(
                    (batch, cfg.num_patches,
                     cfg.frontend_dim)).astype(np.float32),
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
            }
        else:
            toks = _markov_tokens(rng, vocab, batch * (seq + 1)).reshape(
                batch, seq + 1)
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int,
                      steps: int, seed: int = 0):
    it = synthetic_lm_data(cfg, batch, seq, seed)
    for _ in range(steps):
        yield next(it)
