# The port's own copy of repro.core.transition: the port imports nothing of the JAX package.
"""Dynamic parallelism transition (paper §III-D, Eq. 6).

Switching the Expert module's layout between prefill and decode costs

  C_ij = min{ T_reshard,
              max(0, T_upload + T_dequant - T_layer_overlap) }

where T_reshard moves weights between devices with collectives, and the
alternative uploads an INT4 per-group backup from host memory (pipelined
against prefill compute — hence the max(0, .) overlap term) and dequantizes
on-device (the ``int4_dequant`` kernel).

``TransitionExecutor`` performs the INT4 mechanism on torch tensors so the
serving engine can switch strategies mid-request (on one device the
reshard is the identity).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .flops import Workload, expert_weight_bytes
from .hardware import ChipSpec, GroundTruth
from .strategy import ExpertStrategy
from . import quantization as q

INT4_BYTES_PER_PARAM = 0.5 + 8.0 / 128.0   # nibbles + per-group scale/zero


@dataclasses.dataclass
class TransitionCosts:
    t_reshard: float
    t_upload: float
    t_dequant: float
    t_overlap: float

    @property
    def c_ij(self) -> float:
        via_host = max(0.0, self.t_upload + self.t_dequant - self.t_overlap)
        return min(self.t_reshard, via_host)

    @property
    def mechanism(self) -> str:
        via_host = max(0.0, self.t_upload + self.t_dequant - self.t_overlap)
        return "reshard" if self.t_reshard <= via_host else "int4_upload"


def layout_overlap(e_from: ExpertStrategy, e_to: ExpertStrategy) -> float:
    """Fraction of the target per-device shard already resident locally.

    Both layouts are partitions of the same (E, d, f) weights over N
    devices; a device keeps the intersection of its old and new shards.
    For EP<->TP style moves the intersection is ~1/max(spread) of the new
    shard.
    """
    if e_from == e_to:
        return 1.0
    spread = max(e_from.ep * e_from.tp // max(
        np.gcd(e_from.ep, e_to.ep) * np.gcd(e_from.tp, e_to.tp), 1), 1)
    return 1.0 / spread


def transition_costs(cfg: ModelConfig, w: Workload, chip: ChipSpec,
                     n_devices: int, e_from: ExpertStrategy,
                     e_to: ExpertStrategy, t_layer_prefill: float,
                     gt: Optional[GroundTruth] = None,
                     async_restore: bool = True) -> TransitionCosts:
    """All Eq.-6 terms for one layer's expert weights.

    ``async_restore`` models the executor the engine actually runs: the
    INT4 restore happens on a background thread kicked off at plan-switch
    decision time, so the upload/dequant pipelines against the next
    prefill and ``t_overlap`` is the layer's prefill window (Fig. 3).
    ``async_restore=False`` prices the blocking executor — the restore
    serializes with compute, so the overlap term is zero and ``c_ij``
    grows to the full upload+dequant cost.
    """
    gt = gt or GroundTruth(chip)
    t_overlap = t_layer_prefill if async_restore else 0.0
    if e_from == e_to:
        return TransitionCosts(0.0, 0.0, 0.0, t_overlap)
    wb = expert_weight_bytes(cfg, w.dtype_bytes)       # one layer, global
    shard = wb / n_devices
    missing = shard * (1.0 - layout_overlap(e_from, e_to))
    t_reshard = gt.comm_time(missing, hops=2, noisy=False)
    n_params_shard = (wb / w.dtype_bytes) / n_devices
    t_upload = gt.h2d_time(n_params_shard * INT4_BYTES_PER_PARAM)
    t_dequant = gt.dequant_time(n_params_shard)
    return TransitionCosts(t_reshard, t_upload, t_dequant, t_overlap)


def switching_matrix(cfg: ModelConfig, w: Workload, chip: ChipSpec,
                     n_devices: int, strategies, t_layer_prefill,
                     gt: Optional[GroundTruth] = None,
                     async_restore: bool = True) -> np.ndarray:
    """The paper's C matrix: C[i, j] = per-MODEL switching cost i -> j.

    t_layer_prefill may be a vector (per prefill strategy i) — the overlap
    window is the prefill compute of the layer being replaced.
    ``async_restore`` passes through to ``transition_costs``.
    """
    K = len(strategies)
    C = np.zeros((K, K))
    t_vec = np.broadcast_to(np.asarray(t_layer_prefill, float), (K,))
    for i, ei in enumerate(strategies):
        for j, ej in enumerate(strategies):
            if i == j:
                continue
            tc = transition_costs(cfg, w, chip, n_devices, ei, ej,
                                  float(t_vec[i]), gt,
                                  async_restore=async_restore)
            C[i, j] = tc.c_ij * cfg.num_layers
    return C


# ---------------------------------------------------------------------------
# executable transition on torch tensors (serving engine)
# ---------------------------------------------------------------------------
def _tensors(value) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    return [value.packed, value.scales, value.zeros]


@dataclasses.dataclass
class Restored:
    """The result of a background restore: the restored value (a tensor or
    a ``QuantizedExpert``) and the event that ends its work on the side
    stream (None off the card)."""

    value: Any
    event: Optional[torch.cuda.Event] = None

    def install(self):
        """The completion barrier on the caller's stream: make it wait for
        the side stream's work, and tie the restored tensors' memory to it,
        so the caching allocator cannot hand that memory out while work
        queued on this stream still reads it. Returns the value."""
        if self.event is not None:
            stream = torch.cuda.current_stream(_tensors(self.value)[0].device)
            stream.wait_event(self.event)
            for t in _tensors(self.value):
                t.record_stream(stream)
        return self.value


class TransitionExecutor:
    """Keeps INT4 per-group backups of expert weights in pinned host memory
    (the paper's Eq. 6) and materializes them on ``device``.

    ``restore`` uploads a backup's packed nibbles, scales and zeros and
    dequantizes on the device with ``int4_dequant`` (the reference
    dequantizes on the host; the values are the same bit for bit, and
    T_dequant is this kernel's time). ``restore_packed`` uploads the packed
    leaves of a structured backup as a resident ``QuantizedExpert``.

    ``restore_async``/``restore_packed_async`` run the same work on a
    single background worker thread and return a Future of ``Restored``.
    On the card the worker issues its copies and launches on a CUDA stream
    of its own and records an event after them; ``Restored.install`` is
    the barrier that makes the caller's stream wait on it. One worker on
    purpose: restores stay ordered. ``reshard`` is the identity on one
    device (multi-card layouts wait for ROADMAP A.3).
    """

    def __init__(self, device=None, group_size: int = 128):
        from repro_torch.device import resolve_device

        self.device = resolve_device(device)
        self.group_size = group_size
        self._backups: Dict[str, q.QuantizedTensor] = {}
        self._pool = None
        self._stream = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tx-restore")
        return self._pool

    def close(self) -> None:
        """Stop the background worker (after the work it holds)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _on_side_stream(self, fn, *args) -> Restored:
        if self.device.type != "cuda":
            return Restored(fn(*args))
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                value = fn(*args)
                event = torch.cuda.Event()
                event.record(self._stream)
        return Restored(value, event)

    def submit(self, fn, *args):
        """Run ``fn(*args)`` on the background worker (on its own stream on
        the card); returns a Future of ``Restored``."""
        return self._executor().submit(self._on_side_stream, fn, *args)

    def restore_async(self, name: str, dtype=None):
        """``restore`` on the background worker; a Future of ``Restored``."""
        return self.submit(self.restore, name, dtype)

    def restore_packed_async(self, name: str):
        """``restore_packed`` on the background worker; a Future of
        ``Restored``."""
        return self.submit(self.restore_packed, name)

    def _pin(self, w: torch.Tensor) -> bool:
        return w.device.type == "cuda"

    def backup(self, name: str, w: torch.Tensor) -> None:
        """Flat per-group backup (the transition wire format), quantized on
        ``w``'s device and kept in host memory (pinned when ``w`` lies on
        the card)."""
        self._backups[name] = q.quantize_int4_torch(
            w, self.group_size, out_device="cpu", pin=self._pin(w))

    def backup_packed(self, name: str, w: torch.Tensor, group_size=None) -> None:
        """Backup in the *structured* last-dim-grouped layout, the one
        resident-INT4 serving consumes directly (``restore_packed``)."""
        self._backups[name] = q.quantize_int4_lastdim_torch(
            w, group_size or self.group_size, out_device="cpu",
            pin=self._pin(w))

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True, copy=True)

    def restore(self, name: str, dtype=None) -> torch.Tensor:
        """The dense weight of backup ``name`` on the device: the packed
        leaves uploaded, then dequantized there into ``dtype`` (bf16)."""
        from repro_torch.kernels import ops

        qt = self._backups[name]
        half = qt.packed.shape[-1]
        packed, scales, zeros = (self._upload(t) for t in (qt.packed, qt.scales, qt.zeros))
        w = ops.int4_dequant(packed.view(-1, half), scales.view(-1, 1),
                             zeros.view(-1, 1),
                             out_dtype=dtype or torch.bfloat16)
        return w.view(qt.shape)

    def restore_packed(self, name: str):
        """Upload a structured backup as a resident ``QuantizedExpert`` on
        the device: the packed nibbles and the per-group scales and zeros,
        never the dense weight."""
        from repro_torch.kernels.ops import QuantizedExpert

        qt = self._backups[name]
        if qt.packed.ndim < 3:
            raise ValueError(
                f"backup {name!r} is flat; use backup_packed for residency")
        return QuantizedExpert(*(self._upload(t) for t in (qt.packed, qt.scales, qt.zeros)))

    @staticmethod
    def reshard(w, sharding=None):
        """The identity on one device; a layout on a mesh is ROADMAP A.3."""
        if sharding is not None:
            raise NotImplementedError(
                "resharding onto a multi-card layout is not ported to "
                "repro_torch yet (ROADMAP A.3)")
        return w
