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
for a TP <-> EP move; the identity on one device), the INT4 restores
upload each rank's target shard from the host backup, and ``reslot`` lays
an expert leaf out in the slots of a replica set (hot-expert
replication). Predictive prefetch (DESIGN.md §5c) stages single
(layer, expert) rows of a backup on the device ahead of a restore
(``prefetch_row``), and ``restore_with_rows`` / ``restore_packed_with_rows``
then upload only the rows that were not staged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
class StagedRow:
    """One prefetched (layer, expert) row of an INT4 backup, on the device:
    its packed nibbles, scales and zeros as the backup holds them, and the
    event that ends their upload on the stream that made them (None off
    the card). The reference stages a dequantized host row; here the row
    stays packed and the restore dequantizes the assembled leaf."""

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    event: Optional[torch.cuda.Event] = None

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.scales.nbytes + self.zeros.nbytes

    def ready(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The three tensors, usable on the caller's stream: it waits for
        the upload, and their memory is tied to it (the stage may drop the
        row while work queued here still reads it)."""
        out = (self.packed, self.scales, self.zeros)
        if self.event is not None:
            stream = torch.cuda.current_stream(self.packed.device)
            stream.wait_event(self.event)
            for t in out:
                t.record_stream(stream)
        return out


def _runs(mask: np.ndarray):
    """The [start, stop) runs of True in a 1-D boolean mask."""
    edges = np.flatnonzero(np.diff(np.concatenate(([0], mask.astype(np.int8), [0]))))
    return zip(edges[::2].tolist(), edges[1::2].tolist())


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
        # optional FaultInjector (site "restore", DESIGN.md §4f)
        self.faults = None

    def _fire(self, site: str) -> None:
        if self.faults is not None:
            self.faults.fire(site)

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
        self._fire("restore")
        qt = self._backups[name]
        return self._dequant(qt, (qt.packed, qt.scales, qt.zeros), dtype, shard, upload=True)

    def _dequant(self, qt, leaves, dtype, shard, upload: bool) -> torch.Tensor:
        """``restore`` from ``leaves``, the flat packed, scales and zeros of
        backup ``qt`` (on the host, ``upload``ed first; or already on the
        device)."""
        from repro_torch.kernels import ops

        half, gs, shape = qt.packed.shape[-1], qt.group_size, tuple(qt.shape)
        index = shard_slices(shard[0], shape, shard[1], shard[2]) if shard is not None else None
        cut = None
        if index is None or shape[-1] % gs:
            # the whole leaf (groups may cross rows of the last dim)
            out_shape = shape
            cut = index
        else:
            last = range(*index[-1].indices(shape[-1]))
            g0, g1 = last.start // gs, -(-last.stop // gs)
            part = index[:-1] + (slice(g0, g1),)
            lead = shape[:-1] + (shape[-1] // gs,)
            leaves = (leaves[0].view(*lead, half)[part], leaves[1].view(*lead, 1)[part],
                      leaves[2].view(*lead, 1)[part])
            out_shape = tuple(len(range(*ix.indices(n))) for ix, n in zip(index[:-1], shape[:-1])) + (
                (g1 - g0) * gs,)
            if (last.start - g0 * gs, len(last)) != (0, out_shape[-1]):
                cut = (slice(None),) * (len(shape) - 1) + (slice(last.start - g0 * gs, last.stop - g0 * gs),)
        packed, scales, zeros = (self._upload(t) if upload else t.contiguous() for t in leaves)
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

        self._fire("restore")
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

    # -- predictive per-expert prefetch (DESIGN.md §5c) --------------------
    def prefetch_rows_of(self, name: str) -> Optional[int]:
        """Number of (layer, expert) prefetch rows backup ``name`` can be
        restored in, or None when per-row restore cannot reproduce the full
        restore bit-exactly.

        A "row" is one index of the flattened leading (L, E) dims. Flat
        backups group the whole leaf, so rows slice on group boundaries
        only when the per-row span is a whole number of quantization groups;
        structured (last-dim-grouped) backups keep the leading dims and
        always slice exactly."""
        qt = self._backups.get(name)
        if qt is None or len(qt.shape) < 3:
            return None
        n_rows = qt.shape[0] * qt.shape[1]
        if qt.packed.ndim >= 3:  # structured residency layout
            return n_rows
        span = int(np.prod(qt.shape[2:]))
        if span % qt.group_size:
            return None
        return n_rows

    @staticmethod
    def _rows(qt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A backup's packed, scales and zeros as (rows, ...) views, one row
        per (layer, expert)."""
        n_rows = qt.shape[0] * qt.shape[1]
        return tuple(t.view(n_rows, -1, t.shape[-1]) for t in (qt.packed, qt.scales, qt.zeros))

    def prefetch_row(self, name: str, row: int) -> StagedRow:
        """Stage ONE leading (layer*expert) row of backup ``name`` on the
        device, on the caller's thread and stream: the unit of work the
        engine's prefetch hides behind decode compute (the background
        pull). The barrier's missed rows take another path, so a failing
        pull only ever costs a miss (the "prefetch" fault site fires in the
        engine's pull, ``InferenceEngine._fire_prefetch``)."""
        return self._restore_row(name, row)

    def prefetch_rows(self, name: str, rows: Sequence[int]) -> Dict[int, StagedRow]:
        """``prefetch_row`` for each of ``rows`` at once, as the engine's
        pull stages a batch: each contiguous run of rows is one upload per
        tensor, and the rows of a run are views of its device buffers (a
        run's memory is freed when its last row is dropped)."""
        src = self._rows(self._backups[name])
        mask = np.zeros(src[0].shape[0], bool)
        mask[list(rows)] = True
        staged = {}
        for a, b in _runs(mask):
            bufs = [self._upload(t[a:b]) for t in src]
            staged.update((r, StagedRow(*(buf[r - a] for buf in bufs))) for r in range(a, b))
        if self.device.type == "cuda" and staged:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            for st in staged.values():
                st.event = event
        return staged

    def _restore_row(self, name: str, row: int) -> StagedRow:
        """Upload row ``row`` of backup ``name`` (packed, from pinned host
        memory on the card) into fresh device tensors, and record the event
        that ends the upload."""
        return self.prefetch_rows(name, (row,))[row]

    def _rows_needed(self, qt, spec, shard) -> Optional[np.ndarray]:
        """The rows a restore of ``shard`` reads (a boolean mask over the
        rows; None: all of them): those whose (layer, expert) lies in the
        shard's index of the leading two dims of a leaf laid out by
        ``spec``."""
        if shard is None:
            return None
        L, E = qt.shape[0], qt.shape[1]
        index = shard_slices(spec, (L, E) + tuple(qt.shape[2:]), shard[1], shard[2])
        mask = np.zeros((L, E), bool)
        mask[index[0], index[1]] = True
        return None if mask.all() else mask.reshape(-1)

    def _assemble(self, name: str, staged: Dict[int, StagedRow], need=None):
        """The packed, scales and zeros of backup ``name`` on the device, in
        the backup's own layout: staged rows copied on the device, every
        other row (of ``need``, a row mask; None: all) uploaded in
        contiguous runs. Byte for byte the backup."""
        qt = self._backups[name]
        rows = self._rows(qt)
        n_rows = rows[0].shape[0]
        out = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in rows]
        miss = np.ones(n_rows, bool) if need is None else need.copy()
        dst, src = [], []
        for r in sorted(staged):
            if r < n_rows and miss[r]:
                miss[r] = False
                for o, t in zip(out, staged[r].ready()):
                    dst.append(o[r])
                    src.append(t)
        if dst:
            torch._foreach_copy_(dst, src)
        for a, b in _runs(miss):
            for o, t in zip(out, rows):
                o[a:b].copy_(t[a:b], non_blocking=True)
        return tuple(o.view(full.shape) for o, full in zip(out, (qt.packed, qt.scales, qt.zeros)))

    def restore_with_rows(self, name: str, staged: Dict[int, StagedRow], dtype=None, shard=None) -> torch.Tensor:
        """``restore``, but the rows present in ``staged`` (from
        ``prefetch_row``) are not uploaded again: only the missed rows cross
        the host link at the barrier, and the assembled leaf is dequantized
        with one ``int4_dequant`` launch. Bit-identical to a plain
        ``restore`` whatever was staged: the kernel reads the same bytes.
        ``shard`` as in ``restore``; rows outside the shard are not
        uploaded."""
        if self.prefetch_rows_of(name) is None:
            return self.restore(name, dtype, shard)
        self._fire("restore")
        qt = self._backups[name]
        need = self._rows_needed(qt, shard[0], shard) if shard is not None else None
        return self._dequant(qt, self._assemble(name, staged, need), dtype, shard, upload=False)

    def restore_packed_with_rows(self, name: str, staged: Dict[int, StagedRow], shard=None):
        """``restore_packed`` from staged rows plus the missed rows, uploaded
        now: the same ``QuantizedExpert`` values as uploading the whole
        backup at once."""
        from repro_torch.kernels.ops import QuantizedExpert

        self._fire("restore")
        qt = self._backups[name]
        if qt.packed.ndim < 3:
            raise ValueError(
                f"backup {name!r} is flat; use backup_packed for residency")
        if shard is None:
            return QuantizedExpert(*self._assemble(name, staged))
        spec, rank, sizes = shard
        qspec = packed_spec_for(spec, tuple(qt.packed.shape), sizes)
        leaves = self._assemble(name, staged, self._rows_needed(qt, qspec, shard))
        return QuantizedExpert(*(t[shard_slices(qspec, t.shape, rank, sizes)].contiguous() for t in leaves))

    @staticmethod
    def reslot(w, src_map: Sequence[int], dst_map: Sequence[int], mesh=None):
        """Lay a stacked expert leaf (L, N, ...) out anew along its expert
        dim (dim 1): ``src_map[i]`` is the expert that row ``i`` of the
        current layout holds (the identity for expert layout, a replica
        set's ``slot_to_expert()`` for its slot layout) and ``dst_map[j]``
        the expert row ``j`` must hold. Each destination row copies a row
        that holds its expert. Dense tensors and ``QuantizedExpert``
        leaves alike. Returns (the new leaf, bytes received from other
        ranks).

        With ``mesh`` the rows are sharded over its ranks (EP: rank r holds
        rows [r*N/n, (r+1)*N/n) of each map): a rank copies the rows it
        holds (preferring its own copy of an expert) and receives each
        other row from the rank that holds its expert's first copy, all in
        one batched point-to-point exchange."""
        if hasattr(w, "packed"):
            from repro_torch.kernels.ops import QuantizedExpert

            moved = [TransitionExecutor.reslot(t, src_map, dst_map, mesh) for t in (w.packed, w.scales, w.zeros)]
            return QuantizedExpert(*(m[0] for m in moved)), sum(m[1] for m in moved)
        first: Dict[int, int] = {}
        for i, e in enumerate(src_map):
            first.setdefault(e, i)

        def index(rows) -> torch.Tensor:
            return torch.tensor(rows, dtype=torch.long, device=w.device)

        if mesh is None or mesh.size == 1:
            return w.index_select(1, index([first[e] for e in dst_map])), 0
        n, me = mesh.size, mesh.rank
        ns, nd = len(src_map) // n, len(dst_map) // n

        def source(rank: int, e: int) -> int:
            own = [i for i in range(rank * ns, (rank + 1) * ns) if src_map[i] == e]
            return own[0] if own else first[e]

        need = {q: [(j, source(q, dst_map[q * nd + j])) for j in range(nd)] for q in range(n)}
        out = torch.empty((w.shape[0], nd) + tuple(w.shape[2:]), dtype=w.dtype, device=w.device)
        local = [(j, s - me * ns) for j, s in need[me] if s // ns == me]
        if local:
            out.index_copy_(1, index([j for j, _ in local]), w.index_select(1, index([s for _, s in local])))
        sends, recvs = [], []
        for p in range(n):
            if p == me:
                continue
            mine = [s - me * ns for _, s in need[p] if s // ns == me]
            if mine:
                sends.append((w.index_select(1, index(mine)), p))
            theirs = [j for j, s in need[me] if s // ns == p]
            if theirs:
                recvs.append((torch.empty((w.shape[0], len(theirs)) + tuple(w.shape[2:]), dtype=w.dtype,
                                          device=w.device), p, theirs))
        mesh.exchange(sends, [(buf, p) for buf, p, _ in recvs]).wait()
        for buf, _, rows in recvs:
            out.index_copy_(1, index(rows), buf)
        return out, sum(buf.numel() * buf.element_size() for buf, _, _ in recvs)

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
