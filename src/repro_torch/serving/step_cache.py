"""Captured serving steps: the port's counterpart of the JAX engine's
compiled-step cache (``repro.serving.engine.InferenceEngine._jit`` /
``_fn_cache`` with ``_prefill_fn``, ``_decode_fn``, ``_chunk_fn`` and
``_fused_fn``).

The reference never runs a step op by op: each step kind is one XLA
program, cached per (kind, plan), and jit keeps one trace per shape class.
Here each step kind of each shape class is one ``StepGraph``:

- static input buffers on the device (tokens, positions, block tables,
  prefix groups, a chunk row's own position and table), fed before each
  run by one ``copy_`` each from a pinned host twin (or from a device
  tensor);
- the step body, a plain function of those buffers that returns the
  step's logits. It is a pure function of the buffers and the tensors it
  reads (weights, KV pages): the KV it writes depends on its inputs alone,
  so running it again on the same buffers writes the same values;
- on the card, once captured, a ``torch.cuda.CUDAGraph`` replayed on the
  serving stream, its logits a static output buffer in the graph's own
  memory pool, and the launch, variant and dispatch counts its capture
  recorded.

``StepCache.run`` runs a step: a captured graph is replayed and adds its
recorded counts (a replay does not pass through the kernel wrappers, so
it counts as the launches it replays); otherwise the body runs eagerly,
counting as it launches. A key is captured on its second run, when capture
is on and the caller allows it (counting suspended on this thread only, see
``repro_torch.kernels._build.recording``), and that run is the graph's
first replay: a shape class that runs once is never captured. The first run
of a shape class is thus eager on the card too: it makes the split-KV
workspace, the launch plans and cuBLAS's state before any capture, as the
reference's first call compiles. A capture that fails raises; nothing
retries eagerly.

Keys are ``(kind, plan, *shape class)`` as in the reference, plus a
weights generation and the generation of the KV cache the step reads. The
plan carries the live replica set (hot-expert replication), and the
rebalance that changes it lays the expert leaves out anew: a new plan and
a new weights generation, so the old graphs are dropped and the new
plan's are captured again (the reference's re-trace).
``new_weights`` (the engine installs new expert leaves) and ``new_cache``
(a new live batch and its KV pool, or a new static cache) bump them and
drop the graphs that read the old tensors: a graph holds raw pointers, so
one captured before an install would read the old, maybe freed, leaves.
The static steps read the engine's contiguous cache and the continuous
steps its live pool; each has a generation of its own.

Every graph gets its own memory pool: graphs are replayed in no fixed
order, and one graph's intermediates must not overwrite another's logits
before they are sampled.

Python's cyclic garbage collector is paused while a step is captured: a
collection on the capturing thread could destroy a dropped graph (or
another CUDA object) there, which the capture's ``thread_local`` mode
forbids, and the capture would fail.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

Key = Tuple
Body = Callable[["StepGraph"], torch.Tensor]


@dataclasses.dataclass
class CaptureStats:
    """What the step cache did (zeros with capture off, apart from
    ``eager_runs``)."""

    captures: int = 0  # graphs captured
    capture_ms: float = 0.0  # host time of the captures, instantiation included
    replays: int = 0
    eager_runs: int = 0  # bodies run eagerly (first runs, capture off, or not capturable yet)
    dropped: int = 0  # graphs dropped by a new weights or cache generation


_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` with its own memory pool, captured on a
    side stream in ``thread_local`` error mode (the async INT4 restore's
    worker may allocate and launch on its own stream meanwhile) and
    replayed on the caller's stream.

    The capture is begun and ended directly, not through
    ``torch.cuda.graph``: that context synchronizes the whole device (it
    would wait out a background restore) and empties the allocator's cache
    before every capture (seconds of ``cudaFree`` after a large engine was
    released). The side stream first waits for the caller's stream."""

    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        caller = torch.cuda.current_stream()
        stream = _CAPTURE_STREAMS.get(caller.device.index)
        if stream is None:
            stream = _CAPTURE_STREAMS[caller.device.index] = torch.cuda.Stream(caller.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            self._graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                self._graph.capture_end()
        caller.wait_stream(stream)
        return out

    def replay(self) -> None:
        self._graph.replay()


class StepGraph:
    """One step kind of one shape class: its static buffers ``bufs``, its
    body, its eager runs and, once captured, its graph, static ``logits``
    and ``counts``."""

    def __init__(self, key: Key, bufs: Dict[str, torch.Tensor], body: Body):
        self.key = key
        self.bufs = bufs
        self.body = body
        self.eager_runs = 0
        self._host: Dict[str, torch.Tensor] = {}
        self.graph = None
        self.logits: Optional[torch.Tensor] = None
        self.counts: Optional[_build.Counts] = None

    def feed(self, name: str, value) -> None:
        """Copy ``value`` into buffer ``name`` on the buffer's stream order:
        a device tensor directly, host data (numpy or a number) through a
        pinned twin of the buffer. The copy is asynchronous; every step ends
        in a sync (its token read-back) before a twin is written again."""
        buf = self.bufs[name]
        if isinstance(value, torch.Tensor) and value.device == buf.device:
            buf.copy_(value)
            return
        host = self._host.get(name)
        if host is None:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=buf.device.type == "cuda")
            self._host[name] = host
        host.numpy()[...] = np.asarray(value)
        buf.copy_(host, non_blocking=True)

    def read_back(self, name: str) -> torch.Tensor:
        """Queue a copy of buffer ``name`` (a step's output, such as the
        router's top-k ids) into its pinned host twin and return the twin:
        it holds the values once the stream has passed the copy, after the
        step's token read-back, so reading it adds no sync."""
        buf = self.bufs[name]
        host = self._host.get(name)
        if host is None:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=buf.device.type == "cuda")
            self._host[name] = host
        host.copy_(buf, non_blocking=True)
        return host


@contextlib.contextmanager
def _collector_paused():
    """Pause the cyclic garbage collector for the block (restoring its
    state after)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepCache:
    """The engine's step graphs by key. ``capture`` False runs every step
    eagerly from the same static buffers (the CPU path, and the eager A/B on
    the card); ``graph_factory`` makes one graph (``CudaGraph``; tests pass
    a stand-in)."""

    def __init__(self, device, capture: bool, graph_factory: Callable[[], object] = CudaGraph):
        self.device = torch.device(device)
        self.capture = bool(capture)
        self.graph_factory = graph_factory
        self.weights_gen = 0
        self.cache_gen = {"static": 0, "live": 0}
        self.stats = CaptureStats()
        self._graphs: Dict[Key, StepGraph] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self):
        return list(self._graphs)

    def buffers(self, **specs) -> Dict[str, torch.Tensor]:
        """Zeroed device buffers from ``name=(shape, dtype)`` specs."""
        return {n: torch.zeros(shape, dtype=dt, device=self.device) for n, (shape, dt) in specs.items()}

    def graph(self, key: Key, make_bufs: Callable[[], Dict[str, torch.Tensor]], body: Body,
              cache: str) -> StepGraph:
        """The step of ``key`` under the current generations, made with
        ``make_bufs()`` and ``body`` on first use. ``cache``: the KV cache
        the step reads, ``"static"`` (the contiguous cache) or ``"live"``
        (the live batch's pool)."""
        full = key + (self.weights_gen, cache, self.cache_gen[cache])
        g = self._graphs.get(full)
        if g is None:
            g = self._graphs[full] = StepGraph(full, make_bufs(), body)
        return g

    def run(self, g: StepGraph, may_capture: bool = True) -> torch.Tensor:
        """Run step ``g`` on its fed buffers; returns its logits. Replays a
        captured graph. Else, with capture on, ``may_capture`` and an eager
        run of ``g`` behind it, captures it and replays it; else runs the
        body eagerly."""
        if g.graph is None and self.capture and may_capture and g.eager_runs:
            t0 = time.perf_counter()
            graph = self.graph_factory()
            with _build.recording() as counts, _collector_paused():
                logits = graph.capture(lambda: g.body(g))
            g.graph, g.logits, g.counts = graph, logits, counts
            self.stats.captures += 1
            self.stats.capture_ms += (time.perf_counter() - t0) * 1e3
        if g.graph is not None:
            g.graph.replay()
            g.counts.add_to_globals()
            self.stats.replays += 1
            return g.logits
        g.eager_runs += 1
        self.stats.eager_runs += 1
        return g.body(g)

    def _drop(self, stale: Callable[[Key], bool]) -> None:
        for k in [k for k in self._graphs if stale(k)]:
            del self._graphs[k]
            self.stats.dropped += 1

    def new_weights(self) -> None:
        """New weights were installed: drop every graph (each reads them)."""
        self.weights_gen += 1
        self._drop(lambda k: k[-3] != self.weights_gen)

    def new_cache(self, cache: str) -> None:
        """The ``cache`` KV cache (``"static"`` or ``"live"``) was replaced
        or released: drop the graphs that read it."""
        self.cache_gen[cache] += 1
        self._drop(lambda k: k[-2] == cache and k[-1] != self.cache_gen[cache])

    def clear(self) -> None:
        """Drop every graph (the engine is closed)."""
        self._drop(lambda k: True)
