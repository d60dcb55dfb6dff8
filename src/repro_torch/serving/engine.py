"""Static-batching inference engine (the port of
``repro.serving.engine.InferenceEngine.run``, null plan, one device).

``submit`` queues requests; ``run`` drains the queue batch by batch: the
scheduler left-pads a batch to its prompt bucket, ``prefill`` primes a
contiguous KV cache, and a greedy ``decode_step`` loop decodes the batch
in lockstep until every request has its tokens. The planner, the Eq.-6
transitions and continuous batching come in later slices of the port.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no ``device`` it raises rather than fall back. The kernel
backend follows ``repro_torch.kernels.ops.resolve_backend``: ``hopper`` on
the card, ``ref`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, prefill

from .sampling import SamplingParams, sample
from .scheduler import FifoScheduler, QueuedRequest


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 32


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prefill_ms: float  # the request's batch: prefill, host clock after a sync
    decode_ms: float  # the request's batch: the whole decode loop


@dataclasses.dataclass
class EngineStats:
    batches: int = 0  # static batches run


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or CUDA when it is None; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                'pass device="cpu" to run on the CPU'
            )
        device = "cuda"
    return torch.device(device)


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8, eos_id: int = -1,
                 kernel_backend: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.eos_id = eos_id
        self.kernel_backend = kernel_backend
        self.scheduler = FifoScheduler(max_batch=max_batch, bucket=64)
        self.stats = EngineStats()

    def submit(self, req: Request) -> int:
        return self.scheduler.submit(req.prompt, req.max_new_tokens)

    def run(self, sampling: Optional[SamplingParams] = None) -> List[Completion]:
        """Drain the queue; returns completions in uid order."""
        sampling = sampling if sampling is not None else SamplingParams()
        out: List[Completion] = []
        while True:
            batch = self.scheduler.next_batch()
            if batch is None:
                break
            out.extend(self._run_batch(batch, sampling))
        return sorted(out, key=lambda c: c.uid)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_batch(self, batch: List[QueuedRequest], sampling: SamplingParams) -> List[Completion]:
        toks, _ = self.scheduler.pad_batch(batch)
        B, S = toks.shape
        max_new = max(r.max_new_tokens for r in batch)
        max_len = S + max_new + 1
        self.stats.batches += 1
        be = self.kernel_backend
        gen = None
        if sampling.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(sampling.seed)

        with torch.inference_mode():
            self._sync()
            t0 = time.perf_counter()
            tokens = torch.as_tensor(toks, dtype=torch.long).to(self.device)
            logits, cache = prefill(self.params, self.cfg, {"tokens": tokens}, max_len, backend=be)
            self._sync()
            prefill_ms = (time.perf_counter() - t0) * 1e3

            generated = np.zeros((B, max_new), np.int32)
            t1 = time.perf_counter()
            next_tok = sample(logits, sampling, gen)
            done = np.zeros((B,), bool)
            for step in range(max_new):
                host_tok = next_tok.cpu().numpy()
                generated[:, step] = np.where(done, self.eos_id, host_tok)
                if step == max_new - 1:
                    break
                logits, cache = decode_step(self.params, self.cfg, next_tok[:, None], cache, backend=be)
                next_tok = sample(logits, sampling, gen)
                if self.eos_id >= 0:
                    done |= next_tok.cpu().numpy() == self.eos_id
                    if done.all():
                        break
            self._sync()
            decode_ms = (time.perf_counter() - t1) * 1e3

        comps = []
        for i, r in enumerate(batch):
            n = min(r.max_new_tokens, max_new)
            toks_out = [int(t) for t in generated[i, :n] if t != self.eos_id or self.eos_id < 0]
            comps.append(Completion(r.uid, toks_out, prefill_ms, decode_ms))
        return comps
