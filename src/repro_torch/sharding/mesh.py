"""``RankMesh``: the port's counterpart of the JAX ``Mesh`` that
``repro.launch.mesh.make_host_mesh`` builds, over a ``torch.distributed``
process group.

The mesh is 2-D, axes ``("data", "model")``, as the reference's: a group
of ``n`` ranks with a data axis of ``d`` is ``d`` rows of ``m = n // d``
model ranks, the group rank of ``(data i, model j)`` being ``i * m + j``
(the row-major order of ``Mesh(devices.reshape(d, m))``). A group with no
data axis is ``(1, n)``. ``rank`` and ``size`` are the model axis's (the
serving code reads them as before); ``coords`` gives both coordinates.
The mesh never initialises a process group and never picks a backend:
the caller makes the group (``torch.distributed.init_process_group``, or
``repro_torch.sharding.launch``) and hands it over. Each model row and
each data column of a 2-D mesh is a subgroup of its own, which every rank
creates, in the same order, when the mesh is made.

The collectives are methods here, Megatron style, each over an ``axis``:
``"model"`` (the default), ``"data"``, or a tuple of axes (both: every rank
of the mesh, in group-rank order). ``all_reduce`` (partial sums),
``all_gather``, ``reduce_scatter``, ``all_to_all`` (the tiled exchange of
the EP dispatch and of the Eq.-6 reshard) and, on the model axis,
``exchange`` (batched point-to-point sends and receives, the ring hops of
``kernels.ops.a2a_ppermute``), and ``gather_rows``, which the serving
engine's host loop reads every rank's sampled rows through. These act outside autograd;
``repro_torch.sharding.autograd`` wraps them for training. On an axis of
one rank each is the identity. gloo carries CUDA tensors in its
collectives by staging them through the host itself; its point-to-point
ops take host tensors only, so ``exchange`` stages a CUDA tensor through
the host on a gloo group and hands it to the card again when the receive
completes. No collective changes a dtype. ``calls`` counts the collectives
issued, by name, and ``payload`` their bytes by (name, the size of the
group they span): what the rank receives, the result tensor's bytes (a
reduce-scatter's block, a gather's whole result, an exchange's receives),
as the reference's roofline reads a collective's result shape
(``repro_torch.launch.roofline.wire_bytes`` turns them into wire bytes).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axis = Union[str, Sequence[str]]

AXES = ("data", "model")


class RankMesh:
    """A ``(data, model)`` mesh of the ranks of ``group`` (None: the default
    group) with ``data`` rows. ``rank`` and ``size`` are this process's
    model-axis index and the model axis's size; ``shape[axis]`` and
    ``axis_size(axis)`` give the sizes as a JAX mesh would. A mesh with a
    data axis > 1 and a model axis > 1 makes its subgroups with
    ``dist.new_group``, which every rank of the default group must call:
    its ``group`` must be the default group."""

    axis_names = AXES
    name = ""  # a label for printed lines (``launch.mesh.make_production_mesh``)

    def __init__(self, group=None, data: int = 1):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("RankMesh takes an initialised process group; call "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.index = dist.get_rank(group)  # the rank in ``group`` (data-major)
        self.world = dist.get_world_size(group)
        if data < 1 or self.world % data:
            raise ValueError(f"a data axis of {data} does not divide the group's {self.world} ranks")
        d, m = data, self.world // data
        self.coords = {"data": self.index // m, "model": self.index % m}
        self.rank, self.size = self.coords["model"], m
        self._shape = {"data": d, "model": m}
        self._tag = 0
        self._scatter_ok = True  # whether the backend takes reduce_scatter_tensor
        self.calls: collections.Counter = collections.Counter()
        self.payload: collections.Counter = collections.Counter()  # bytes by (name, group size)
        # the group of each axis: the whole group where the axis spans it
        self._groups = {"data": group if m == 1 else None, "model": group if d == 1 else None}
        if d > 1 and m > 1:
            if group is not None:
                raise ValueError("a 2-D RankMesh is made over the default group (its subgroups need every rank)")
            for i in range(d):  # the model rows
                g = dist.new_group([i * m + j for j in range(m)])
                if i == self.coords["data"]:
                    self._groups["model"] = g
            for j in range(m):  # the data columns
                g = dist.new_group([i * m + j for i in range(d)])
                if j == self.coords["model"]:
                    self._groups["data"] = g

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    def axis_size(self, name: Optional[Axis]) -> int:
        if name is None:
            return 1
        n = 1
        for a in _axes(name):
            n *= self._shape[a]
        return n

    def axis_index(self, name: Axis) -> int:
        """This rank's index along ``name`` (a tuple: row-major over its
        axes, in the order given)."""
        i = 0
        for a in _axes(name):
            i = i * self._shape[a] + self.coords[a]
        return i

    @property
    def capturable(self) -> bool:
        """Whether its collectives can be captured in a CUDA graph: NCCL's
        can, gloo's (host-staged) cannot."""
        return self.backend == "nccl"

    def __repr__(self) -> str:
        return (f"RankMesh(data={self.coords['data']}/{self._shape['data']}, "
                f"model={self.rank}/{self.size}, backend={self.backend!r})")

    def _group(self, axis: Axis):
        """(the process group of ``axis``, its size); a tuple of both axes
        is the mesh's whole group."""
        axes = tuple(a for a in _axes(axis) if self._shape[a] > 1)
        if len(axes) == 2:
            return self.group, self.world
        if not axes:
            return None, 1
        return self._groups[axes[0]], self._shape[axes[0]]

    # -- collectives ------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, axis: Axis = "model", op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``x`` (a sum by default) over ``axis``, in place; returns it."""
        group, n = self._group(axis)
        if n > 1:
            self._count("all_reduce", n, x.nbytes)
            dist.all_reduce(x, op=op, group=group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: Axis = "model") -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        group, n = self._group(axis)
        if n == 1:
            return x
        self._count("all_gather", n, x.nbytes * n)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def gather_rows(self, x: torch.Tensor, axes: Axis = ()) -> torch.Tensor:
        """The whole batch, on the host, from every rank's block of rows
        ``x`` (dim 0): the blocks in their order along ``axes`` (the data
        axes the rows are split over; none: every rank holds every row).
        Raises unless every rank that holds a block holds the same values
        (the model row of a data rank, or every rank when no axis splits
        the rows). One all-gather over the whole mesh."""
        x = x.contiguous()
        if self.world == 1:
            return x.cpu()
        seen = self.all_gather(x[None], dim=0, axis=AXES).cpu()  # (world, rows, ...) in group-rank order
        m, blocks = self._shape["model"], {}
        for g in range(self.world):
            coords = {"data": g // m, "model": g % m}
            i = 0
            for a in _axes(axes):
                i = i * self._shape[a] + coords[a]
            if not torch.equal(blocks.setdefault(i, seen[g]), seen[g]):
                raise RuntimeError(f"rank {self.index}: the ranks holding rows block {i} disagree: {seen.tolist()}")
        return torch.cat([blocks[i] for i in range(len(blocks))], dim=0)

    def reduce_scatter(self, x: torch.Tensor, dim: int, axis: Axis = "model") -> torch.Tensor:
        """The sum of every rank's ``x`` over ``axis``, of which this rank
        keeps its block of ``dim``. One ``reduce_scatter_tensor``; a gloo
        group takes it on host tensors only, so a CUDA tensor is staged
        through the host there. Where the backend has none, an all-reduce
        of a copy."""
        group, n = self._group(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        self._count("reduce_scatter", n, x.nbytes // n)
        w = x.shape[dim] // n
        if self._scatter_ok:
            stage = self.backend == "gloo" and x.is_cuda
            send = x.movedim(dim, 0).contiguous()
            send = send.cpu() if stage else send
            out = torch.empty((w,) + tuple(send.shape[1:]), dtype=send.dtype, device=send.device)
            try:
                dist.reduce_scatter_tensor(out, send, group=group)
                return out.to(x.device).movedim(0, dim).contiguous()
            except (RuntimeError, NotImplementedError):  # refused before any exchange, alike on every rank
                self._scatter_ok = False
        s = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(s, group=group)
        return s.narrow(dim, self.axis_index(axis) * w, w).contiguous()

    def all_to_all(self, x: torch.Tensor, split: int, concat: int, axis: Axis = "model") -> torch.Tensor:
        """The tiled all-to-all (``lax.all_to_all(..., tiled=True)``): dim
        ``split`` is cut into ``n`` blocks, block ``j`` goes to rank ``j``,
        and the blocks received land on dim ``concat`` in source-rank
        order. One ``all_to_all_single``."""
        group, n = self._group(axis)
        if n == 1:
            return x
        split, concat = split % x.ndim, concat % x.ndim
        if x.shape[split] % n:
            raise ValueError(f"split dim {x.shape[split]} not divisible by the mesh size {n}")
        self._count("all_to_all", n, x.nbytes)
        rows = x.movedim(split, 0)
        send = rows.reshape(n, rows.shape[0] // n, *rows.shape[1:]).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return torch.cat([recv[j].movedim(0, split) for j in range(n)], dim=concat)

    def exchange(self, sends: List[Tuple[torch.Tensor, int]], recvs: List[Tuple[torch.Tensor, int]],
                 result=None) -> "Exchange":
        """Post point-to-point ``sends`` ((tensor, peer)) and ``recvs``
        ((destination, peer)) as one batch, the peers model-axis ranks of
        this rank's row; returns the pending exchange, whose ``wait()``
        completes it, copies every receive into its destination (any view)
        and returns ``result``. Every rank posts its exchanges in the same
        order (one tag per call)."""
        self._tag += 1
        if sends or recvs:
            self._count("exchange", self.size, sum(dest.nbytes for dest, _ in recvs))
        stage = self.backend == "gloo"
        ops, landing = [], []
        for t, peer in sends:
            t = t.contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if stage and t.is_cuda else t,
                                  self._peer(peer), self.group, self._tag))
        for dest, peer in recvs:
            # a receive takes a contiguous buffer, on the host for gloo
            if stage and dest.is_cuda:
                buf = torch.empty(dest.shape, dtype=dest.dtype)
            else:
                buf = dest if dest.is_contiguous() else torch.empty_like(dest, memory_format=torch.contiguous_format)
            landing.append((dest, buf))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(peer), self.group, self._tag))
        return Exchange(dist.batch_isend_irecv(ops) if ops else [], landing, ops, result)

    def _count(self, name: str, n: int, nbytes: int) -> None:
        self.calls[name] += 1
        self.payload[(name, n)] += nbytes

    def _peer(self, rank: int) -> int:
        """A model-axis rank of this row as the global rank the
        point-to-point ops take."""
        g = self.coords["data"] * self.size + rank
        return g if self.group is None else dist.get_global_rank(self.group, g)


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Exchange:
    """A posted batch of point-to-point ops; ``wait()`` completes it and
    returns its ``result``. It holds the ops (and so their tensors, a
    staged host copy among them) until then."""

    def __init__(self, works, landing, ops, result=None):
        self._works = works
        self._landing = landing
        self._ops = ops
        self.result = result

    def wait(self):
        for w in self._works:
            w.wait()
        for dest, buf in self._landing:
            if buf is not dest:
                dest.copy_(buf, non_blocking=True)
        self._works, self._landing, self._ops = [], [], []
        return self.result
