# The port's own copy of repro.core.transition: the port imports nothing of the JAX package.
"""Dynamic parallelism transition (paper §III-D, Eq. 6).

Switching the Expert module's layout between prefill and decode costs

  C_ij = min{ T_reshard,
              max(0, T_upload + T_dequant - T_layer_overlap) }

where T_reshard moves weights between devices with collectives, and the
alternative uploads an INT4 per-group backup from host memory (pipelined
against prefill compute — hence the max(0, .) overlap term) and dequantizes
on-device (the ``int4_dequant`` kernel).

``TransitionExecutor`` performs both mechanisms on torch tensors so the
serving engine can switch strategies mid-request: ``reshard`` moves a
leaf's slices between the ranks of a mesh (one all-to-all per layer slice
for a TP <-> EP move; the identity on one device), and the INT4 restores
upload each rank's target shard from the host backup.
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
from repro_torch.sharding.specs import packed_spec_for, shard_slices, sharded_dim

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
    purpose: restores stay ordered.

    On a mesh a backup holds the whole leaf: ``backup``/``backup_packed``
    take a ``gather`` that returns one layer of the leaf whole (the rank's
    shard all-gathered), and quantize layer by layer. ``restore`` and
    ``restore_packed`` take ``shard=(spec, rank, sizes)`` and upload only
    the groups of the rank's shard under ``spec``. ``reshard`` moves a
    leaf between two specs across the ranks.
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

    def backup(self, name: str, w: torch.Tensor, gather=None) -> None:
        """Flat per-group backup (the transition wire format), quantized on
        ``w``'s device and kept in host memory (pinned when ``w`` lies on
        the card). ``gather(l)``, when given, is layer ``l`` of the whole
        leaf (``w`` then being this rank's shard of a stacked leaf)."""
        if gather is None:
            self._backups[name] = q.quantize_int4_torch(
                w, self.group_size, out_device="cpu", pin=self._pin(w))
        else:
            self._backups[name] = _quantize_layers(
                w.shape[0], gather, self.group_size, self._pin(w), lastdim=False)

    def backup_packed(self, name: str, w: torch.Tensor, group_size=None, gather=None) -> None:
        """Backup in the *structured* last-dim-grouped layout, the one
        resident-INT4 serving consumes directly (``restore_packed``);
        ``gather`` as in ``backup``."""
        if gather is None:
            self._backups[name] = q.quantize_int4_lastdim_torch(
                w, group_size or self.group_size, out_device="cpu",
                pin=self._pin(w))
        else:
            self._backups[name] = _quantize_layers(
                w.shape[0], gather, group_size or self.group_size, self._pin(w), lastdim=True)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().to(self.device, non_blocking=True, copy=True)

    def restore(self, name: str, dtype=None, shard=None) -> torch.Tensor:
        """The dense weight of backup ``name`` on the device: the packed
        leaves uploaded, then dequantized there into ``dtype`` (bf16).
        ``shard=(spec, rank, sizes)`` restores only ``rank``'s shard of the
        leaf under ``spec``: the groups that cover it are uploaded and
        dequantized, and cut to the shard where a group straddles it."""
        from repro_torch.kernels import ops

        qt = self._backups[name]
        half, gs, shape = qt.packed.shape[-1], qt.group_size, tuple(qt.shape)
        index = shard_slices(shard[0], shape, shard[1], shard[2]) if shard is not None else None
        cut = None
        if index is None or shape[-1] % gs:
            # the whole leaf (groups may cross rows of the last dim)
            leaves = (qt.packed, qt.scales, qt.zeros)
            out_shape = shape
            cut = index
        else:
            last = range(*index[-1].indices(shape[-1]))
            g0, g1 = last.start // gs, -(-last.stop // gs)
            part = index[:-1] + (slice(g0, g1),)
            lead = shape[:-1] + (shape[-1] // gs,)
            leaves = (qt.packed.view(*lead, half)[part], qt.scales.view(*lead, 1)[part],
                      qt.zeros.view(*lead, 1)[part])
            out_shape = tuple(len(range(*ix.indices(n))) for ix, n in zip(index[:-1], shape[:-1])) + (
                (g1 - g0) * gs,)
            if (last.start - g0 * gs, len(last)) != (0, out_shape[-1]):
                cut = (slice(None),) * (len(shape) - 1) + (slice(last.start - g0 * gs, last.stop - g0 * gs),)
        packed, scales, zeros = (self._upload(t) for t in leaves)
        w = ops.int4_dequant(packed.reshape(-1, half), scales.reshape(-1, 1),
                             zeros.reshape(-1, 1),
                             out_dtype=dtype or torch.bfloat16).view(out_shape)
        return w if cut is None else w[cut].contiguous()

    def restore_packed(self, name: str, shard=None):
        """Upload a structured backup as a resident ``QuantizedExpert`` on
        the device: the packed nibbles and the per-group scales and zeros,
        never the dense weight. ``shard=(spec, rank, sizes)`` (``spec`` the
        dense leaf's) uploads only ``rank``'s slice of the packed layout,
        the whole leaf where its group axis does not divide."""
        from repro_torch.kernels.ops import QuantizedExpert

        qt = self._backups[name]
        if qt.packed.ndim < 3:
            raise ValueError(
                f"backup {name!r} is flat; use backup_packed for residency")
        leaves = (qt.packed, qt.scales, qt.zeros)
        if shard is not None:
            spec, rank, sizes = shard
            qspec = packed_spec_for(spec, tuple(qt.packed.shape), sizes)
            leaves = tuple(t[shard_slices(qspec, t.shape, rank, sizes)] for t in leaves)
        return QuantizedExpert(*(self._upload(t) for t in leaves))

    @staticmethod
    def reshard(w, from_spec=None, to_spec=None, mesh=None, shape=None):
        """Move a leaf between two layouts across the ranks of ``mesh``.

        ``w`` is this rank's shard of a leaf under ``from_spec``: a dense
        tensor, or a resident ``QuantizedExpert`` (the specs are the dense
        leaf's, and ``shape`` its global dense shape, which decides the axes
        the packed layout keeps). Returns ``(its shard under to_spec, bytes
        received from other ranks)``. A dimension sharded in both layouts
        moves by one ``all_to_all_single`` per layer slice (TP <-> EP: the
        experts this rank keeps, each with every rank's d_ff columns); a
        dimension that becomes replicated is all-gathered, one that becomes
        sharded is cut. With no mesh, or equal specs, it is the identity."""
        if mesh is None or tuple(from_spec) == tuple(to_spec):
            return w, 0
        if hasattr(w, "packed"):
            from repro_torch.kernels.ops import QuantizedExpert

            sizes = dict(mesh.shape)
            glob = tuple(shape[:-1]) + (shape[-1] // w.group_size, w.group_size // 2)
            fs, ts = packed_spec_for(from_spec, glob, sizes), packed_spec_for(to_spec, glob, sizes)
            moved = [_relayout(t, fs, ts, mesh) for t in (w.packed, w.scales, w.zeros)]
            return QuantizedExpert(*(m[0] for m in moved)), sum(m[1] for m in moved)
        return _relayout(w, tuple(from_spec), tuple(to_spec), mesh)


def _relayout(t: torch.Tensor, from_spec, to_spec, mesh):
    """``t`` (this rank's shard under ``from_spec``) -> (its shard under
    ``to_spec``, bytes received). Dim 0 of a stacked leaf (the layers) is
    never sharded; a move goes one layer slice at a time, so a rank holds
    the old shard, the new one and one slice in flight, never a whole
    leaf."""
    a, b = sharded_dim(from_spec), sharded_dim(to_spec)
    n = mesh.size
    if a == b:
        return t, 0
    if a is None:
        step = t.shape[b] // n
        return t.narrow(b, mesh.rank * step, step).contiguous(), 0
    shape = list(t.shape)
    if b is None:
        shape[a] *= n
    else:
        shape[a] *= n
        shape[b] //= n
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    layers = t.shape[0] if min(x for x in (a, b) if x is not None) > 0 else None
    for l in range(layers) if layers is not None else (None,):
        src = t if l is None else t[l]
        off = 0 if l is None else 1
        if b is None:
            moved = mesh.all_gather(src, dim=a - off)
        else:
            moved = mesh.all_to_all(src, split=b - off, concat=a - off)
        if l is None:
            out.copy_(moved)
        else:
            out[l].copy_(moved)
    received = out.numel() * out.element_size() * (n - 1) // n if b is not None else t.numel() * t.element_size() * (n - 1)
    return out, received


def _quantize_layers(L: int, layer, group_size: int, pin: bool, lastdim: bool) -> q.QuantizedTensor:
    """Quantize a stacked leaf whose layer ``l`` is ``layer(l)`` (on the
    card, say, gathered from every rank's shard), one layer at a time, into
    host tensors (pinned when ``pin``): the flat layout, or the structured
    last-dim one with ``lastdim``. The bytes equal the whole leaf's
    quantization: every group lies within one layer."""
    first = layer(0)
    shape = (L,) + tuple(first.shape)
    gs = q.pick_group_size(shape[-1], group_size) if lastdim else group_size
    per = first.numel() // gs
    packed = torch.empty((L * per, gs // 2), dtype=torch.uint8, pin_memory=pin)
    scales = torch.empty((L * per, 1), dtype=torch.float32, pin_memory=pin)
    zeros = torch.empty((L * per, 1), dtype=torch.float32, pin_memory=pin)
    for l in range(L):
        w = first if l == 0 else layer(l)
        qt = q.quantize_int4_torch(w, gs)
        for dst, src in ((packed, qt.packed), (scales, qt.scales), (zeros, qt.zeros)):
            dst[l * per:(l + 1) * per].copy_(src)
        del w, qt
    first = None
    if lastdim:
        lead, ng = shape[:-1], shape[-1] // gs
        packed, scales, zeros = packed.view(*lead, ng, gs // 2), scales.view(*lead, ng, 1), zeros.view(*lead, ng, 1)
    return q.QuantizedTensor(packed=packed, scales=scales, zeros=zeros, shape=shape, group_size=gs)
