"""Roofline terms of one rank's traced step (the port of
``repro.launch.roofline``).

Per (arch x shape x mesh), for the rank the dry run traces:
  compute term    = traced FLOPs / peak FLOP/s
  memory term     = traced HBM bytes / HBM bytes/s
  collective term = collective wire bytes / link bytes/s

on a ``core.hardware.ChipSpec``: the ``h100`` entry, NVIDIA's H100 SXM data
sheet (989e12 bf16 FLOP/s dense, 3.35e12 B/s HBM3) and an effective NVLink
collective rate of 375e9 B/s derived there. These are data-sheet constants,
not measurements.

The counts come from the trace, not from a compiled program (there is no
HLO to parse):

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s table
  (``flop_registry``: matmuls, convolutions, attention) over every
  dispatched op, counted in the one dispatch mode that counts the bytes,
  plus the hand kernels' own tally (``kernels._build.TRACED_FLOPS``: on
  fake tensors each wrapper adds the FLOPs of the call it would launch).
- HBM bytes: the inputs plus the outputs of every dispatched aten op that
  moves data (views and allocations move none; a collective's bytes are its
  wire term's), plus the hand kernels' bytes.
  PyTorch's eager ops are not fused, so this is an upper bound on the HBM
  traffic of the step as traced: a fused kernel would keep some of it in
  registers or shared memory.
- Collective wire bytes: each ``RankMesh`` collective's payload (its
  result's bytes, ``RankMesh.payload``) through the ring factors of
  ``wire_bytes``, the reference's.

PyTorch runs every layer, so every layer is counted: no scan correction
(``launch.probes`` reports one layer's costs for the table, and checks the
count). There is no f32-as-bf16 correction either: the reference halves
f32 collective payloads because XLA's CPU backend upcasts bf16 programs to
f32, which torch on CUDA does not do: a bf16 collective is traced in bf16.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hardware import ChipSpec, get_chip

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# the reference's collective kinds of the ``RankMesh`` methods
KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
        "all_to_all": "all-to-all", "exchange": "collective-permute"}


def wire_bytes(kind: str, payload: float, group_size: int) -> float:
    """The bytes a rank puts on the wire for a collective of ``kind`` whose
    result is ``payload`` bytes, over ``group_size`` ranks, by the ring
    algorithm (the reference's factors): all-gather result x (g-1)/g,
    all-reduce 2 x result x (g-1)/g, reduce-scatter result x (g-1) (the
    operand is g results), all-to-all result x (g-1)/g,
    collective-permute the result. A group of one rank moves nothing."""
    g = group_size
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective kind {kind!r}; known: {COLLECTIVES}")
    if g <= 1:
        return 0.0
    if kind == "all-gather" or kind == "all-to-all":
        return payload * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * payload * (g - 1) / g
    if kind == "reduce-scatter":
        return payload * (g - 1)
    return float(payload)


def collective_wire(payload: Dict) -> Dict[str, float]:
    """Wire bytes by kind from ``RankMesh.payload`` counts ({(method,
    group size): bytes})."""
    out = {k: 0.0 for k in COLLECTIVES}
    for (name, g), nbytes in payload.items():
        out[KIND[name]] += wire_bytes(KIND[name], nbytes, g)
    return out


@dataclasses.dataclass
class Costs:
    """One rank's traced costs."""

    flops: float
    bytes_accessed: float
    coll: Dict[str, float]  # wire bytes by kind

    def __sub__(self, o: "Costs") -> "Costs":
        return Costs(self.flops - o.flops, self.bytes_accessed - o.bytes_accessed,
                     {k: self.coll.get(k, 0.0) - o.coll.get(k, 0.0) for k in COLLECTIVES})

    def __add__(self, o: "Costs") -> "Costs":
        return Costs(self.flops + o.flops, self.bytes_accessed + o.bytes_accessed,
                     {k: self.coll.get(k, 0.0) + o.coll.get(k, 0.0) for k in COLLECTIVES})

    def scale(self, a: float) -> "Costs":
        return Costs(self.flops * a, self.bytes_accessed * a, {k: v * a for k, v in self.coll.items()})

    def clamp(self) -> "Costs":
        return Costs(max(self.flops, 0.0), max(self.bytes_accessed, 0.0),
                     {k: max(v, 0.0) for k, v in self.coll.items()})


# -- tracing on fake tensors --------------------------------------------------
def _expand(t: torch.Tensor, idx) -> tuple:
    """``idx`` as a tuple, its ``...`` spelled out as full slices."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    idx = tuple(torch.as_tensor(i) if isinstance(i, list) else i for i in idx)
    used = sum(0 if i is None or i is Ellipsis else 1 for i in idx)
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        idx = idx[:k] + (slice(None),) * (t.ndim - used) + idx[k + 1:]
    return idx


def _basic_index(t: torch.Tensor, idx):
    """(``t`` viewed through the ints, slices and Nones of ``idx``, the
    tensor indices at the dimensions of that view), as
    ``torch::indexing`` applies them."""
    out, dim, tensors = t, 0, []
    for i in _expand(t, idx):
        if i is None:
            out, dim = out.unsqueeze(dim), dim + 1
        elif isinstance(i, slice):
            start = 0 if i.start is None else i.start
            stop = out.shape[dim] if i.stop is None else i.stop
            out = torch.ops.aten.slice.Tensor(out, dim, start, stop, 1 if i.step is None else i.step)
            dim += 1
        elif isinstance(i, torch.Tensor):
            if i.dtype == torch.bool:
                raise NotImplementedError("a boolean index depends on the data; a fake tensor has none")
            tensors += [None] * (dim - len(tensors)) + [i]
            dim += 1
        elif isinstance(i, bool):
            raise NotImplementedError("a boolean index adds a dimension; not taken here")
        else:
            out = out.select(dim, int(i))
    return out, tensors


class FakeIndexing(TorchFunctionMode):
    """Tensor indexing (``x[i]``, ``x[i] = v``), ``contiguous`` and ``copy_``
    as the aten ops they stand for. The Python bindings of these four
    methods open a device guard on the tensor's device first; a build of
    PyTorch without CUDA has none for a fake CUDA tensor and raises. The ops
    themselves take fake tensors; the results are the bindings'."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            out, tensors = _basic_index(*args)
            return torch.ops.aten.index.Tensor(out, tensors) if tensors else out
        if func is torch.Tensor.__setitem__:
            t, idx, value = args
            out, tensors = _basic_index(t, idx)
            if not isinstance(value, torch.Tensor):
                value = torch.full((), value, dtype=t.dtype, device=t.device)
            if tensors:
                torch.ops.aten.index_put_(out, tensors, value)
            else:
                torch.ops.aten.copy_(out, value)
            return None
        if func is torch.Tensor.contiguous:
            t = args[0]
            fmt = kwargs.get("memory_format", args[1] if len(args) > 1 else torch.contiguous_format)
            return t if t.is_contiguous(memory_format=fmt) else torch.ops.aten.clone(t, memory_format=fmt)
        if func is torch.Tensor.copy_:
            return torch.ops.aten.copy_(*args, **kwargs)
        return func(*args, **kwargs)


class fake_tensors:
    """Fake CUDA tensors for this block: a ``FakeTensorMode`` (every tensor
    made here is a shape and a dtype on ``cuda``, nothing allocated, no
    card needed) with ``FakeIndexing``."""

    def __enter__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self._modes = (FakeTensorMode(), FakeIndexing())
        for m in self._modes:
            m.__enter__()
        return self._modes[0]

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


# ops that move no data: views and allocations
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default, torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default,
               torch.ops.aten.lift_fresh.default, torch.ops.aten.detach.default}


def tensors(tree):
    """Every tensor of a tree of lists, tuples, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensors(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))


class _Traffic(TorchDispatchMode):
    """Counts every dispatched op: its FLOPs (``FlopCounterMode``'s table,
    ``torch.utils.flop_counter.flop_registry``), the bytes it reads and
    writes, and the storage the traced code holds live: a fresh output
    storage (of an op whose schema neither mutates nor aliases) adds its
    bytes until it is freed, keyed by the storage itself, so views and
    in-place results count once."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._kinds: Dict = {}

    def _kind(self, func):
        """(whether it moves data, whether its outputs are fresh storage)."""
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            aliasing = func.is_view or schema.is_mutable or any(r.alias_info is not None for r in schema.returns)
            kind = self._kinds[func] = (func.namespace == "aten" and func not in _NO_TRAFFIC and not func.is_view,
                                        not aliasing)
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        moves, fresh = self._kind(func)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not (moves or fresh):
            return out
        outs = list(tensors(out))
        if moves:
            self.nbytes += sum(t.nbytes for t in tensors((args, kwargs))) + (sum(t.nbytes for t in outs) if fresh
                                                                              else 0)
        if fresh:
            for t in outs:
                s = t.untyped_storage()
                key = id(s)
                if key in self._held:
                    continue
                self._held[key] = s.nbytes()
                self.live += s.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(s, self._free, key)
        return out

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)


class Meter:
    """Counts one traced step on fake tensors (inside ``fake_tensors``):
    ``costs`` (FLOPs, HBM bytes, collective wire bytes on ``mesh``),
    ``calls`` and ``payload`` (the mesh's collectives by name and by (name,
    group size)), ``kernels`` (the hand kernels' calls), and ``temps``, the
    high-water mark of the storage the step made (its outputs included)."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def __enter__(self):
        from repro_torch.kernels import _build

        self._before = self._snapshot(_build)
        self._traffic = _Traffic()
        self._traffic.__enter__()
        return self

    def _snapshot(self, build):
        mesh = self.mesh
        return (collections.Counter(mesh.calls) if mesh is not None else collections.Counter(),
                collections.Counter(mesh.payload) if mesh is not None else collections.Counter(),
                collections.Counter(build.TRACED_CALLS), collections.Counter(build.TRACED_FLOPS),
                collections.Counter(build.TRACED_BYTES))

    def __exit__(self, *exc):
        from repro_torch.kernels import _build

        self._traffic.__exit__(*exc)
        after = self._snapshot(_build)
        calls, payload, kcalls, kflops, kbytes = (a - b for a, b in zip(after, self._before))
        self.calls, self.payload, self.kernels = dict(calls), dict(payload), dict(kcalls)
        self.kernel_flops, self.kernel_bytes = sum(kflops.values()), sum(kbytes.values())
        self.costs = Costs(float(self._traffic.flops + self.kernel_flops),
                           float(self._traffic.nbytes + self.kernel_bytes), collective_wire(payload))
        self.temps = self._traffic.peak
        return False


# -- the report ---------------------------------------------------------------
@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    traced_flops: float  # the traced rank's FLOPs
    traced_bytes: float  # the traced rank's HBM bytes (an upper bound: see the module doc)
    coll_bytes: float  # the traced rank's collective wire bytes
    coll_breakdown: Dict[str, float]
    model_flops: float  # 6*N_active*D (training) / 2*N_active*D, the whole step's
    peak_mem_bytes: float  # args + temps of the traced rank
    chip: ChipSpec = dataclasses.field(default_factory=lambda: get_chip("h100"))

    @property
    def t_compute(self) -> float:
        return self.traced_flops / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.traced_bytes / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced FLOPs * N): the share of the traced compute
        that is 'useful'; catches remat, dispatch and causal-square waste
        (every rank taken to do the traced rank's work)."""
        total = self.traced_flops * self.n_devices
        return self.model_flops / total if total else 0.0

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},"
                f"{self.t_compute*1e3:.3f},{self.t_memory*1e3:.3f},"
                f"{self.t_collective*1e3:.3f},{self.bottleneck},"
                f"{self.flops_ratio:.3f},{self.peak_mem_bytes/2**30:.2f}")


def model_flops_for(cfg, shape_name: str) -> float:
    """6*N_active*D (train: fwd 2ND + bwd 4ND) or 2*N_active*D (inference;
    a decode step is one token a row) at one of ``models.io.INPUT_SHAPES``."""
    from repro_torch.models.io import INPUT_SHAPES

    seq, batch, kind = INPUT_SHAPES[shape_name]
    n_active = cfg.active_params_per_token()
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch


def build_report(*, arch: str, shape: str, mesh_name: str, n_devices: int, cfg, full: Costs,
                 peak_mem: float) -> RooflineReport:
    """The report of one traced step (``full``: every layer counted)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices, traced_flops=full.flops,
        traced_bytes=full.bytes_accessed, coll_bytes=sum(full.coll.values()), coll_breakdown=dict(full.coll),
        model_flops=model_flops_for(cfg, shape), peak_mem_bytes=peak_mem)
