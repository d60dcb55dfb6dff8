"""``RankMesh``: the port's counterpart of the JAX ``Mesh`` that
``repro.launch.mesh.make_host_mesh`` builds, over a ``torch.distributed``
process group.

The mesh is 1-D: one axis, ``"model"``, whose size is the group's (the JAX
mesh ``(1, n)`` of ``('data', 'model')`` with a data axis of size 1). It
never initialises a process group and never picks a backend: the caller
makes the group (``torch.distributed.init_process_group``, or
``repro_torch.sharding.launch``) and hands it over.

The collectives the sharded model runs are methods here, Megatron style:
``all_reduce`` (row-parallel partial sums), ``all_gather`` (vocab-parallel
logits, EP token shards), ``all_to_all`` (the tiled exchange of the EP
dispatch and of the Eq.-6 reshard) and ``exchange`` (batched point-to-point
sends and receives, the ring hops of ``kernels.ops.a2a_ppermute``). gloo
carries CUDA tensors in its collectives by staging them through the host
itself; its point-to-point ops take host tensors only, so ``exchange``
stages a CUDA tensor through the host on a gloo group and hands it to the
card again when the receive completes. No collective changes a dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


class RankMesh:
    """A 1-D mesh of the ranks of ``group`` (None: the default group),
    axis ``"model"``. ``rank`` and ``size`` are this process's rank in the
    group and the group's size; ``shape[axis]`` and ``axis_size(axis)``
    give the size as a JAX mesh would."""

    axis_names = ("model",)

    def __init__(self, group=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("RankMesh takes an initialised process group; call "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self._tag = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": self.size}

    def axis_size(self, name: Optional[str]) -> int:
        return 1 if name is None else self.shape[name]

    @property
    def capturable(self) -> bool:
        """Whether its collectives can be captured in a CUDA graph: NCCL's
        can, gloo's (host-staged) cannot."""
        return self.backend == "nccl"

    def __repr__(self) -> str:
        return f"RankMesh(rank={self.rank}, size={self.size}, backend={self.backend!r})"

    # -- collectives ------------------------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns it."""
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
        """The tiled all-to-all (``lax.all_to_all(..., tiled=True)``): dim
        ``split`` is cut into ``size`` blocks, block ``j`` goes to rank
        ``j``, and the blocks received land on dim ``concat`` in source-rank
        order. One ``all_to_all_single``."""
        n = self.size
        split, concat = split % x.ndim, concat % x.ndim
        if x.shape[split] % n:
            raise ValueError(f"split dim {x.shape[split]} not divisible by the mesh size {n}")
        rows = x.movedim(split, 0)
        send = rows.reshape(n, rows.shape[0] // n, *rows.shape[1:]).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return torch.cat([recv[j].movedim(0, split) for j in range(n)], dim=concat)

    def exchange(self, sends: List[Tuple[torch.Tensor, int]], recvs: List[Tuple[torch.Tensor, int]],
                 result=None) -> "Exchange":
        """Post point-to-point ``sends`` ((tensor, peer)) and ``recvs``
        ((destination, peer)) as one batch; returns the pending exchange,
        whose ``wait()`` completes it, copies every receive into its
        destination (any view) and returns ``result``. Every rank posts its
        exchanges in the same order (one tag per call)."""
        self._tag += 1
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

    def _peer(self, rank: int) -> int:
        """A group rank as the global rank the point-to-point ops take."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


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
