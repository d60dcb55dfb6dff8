"""Collectives that autograd can differentiate: the Megatron pairs the
sharded model trains through.

Every rank computes the same replicated loss. Each function's backward is
the adjoint that keeps the gradients of that one loss, not of the sum of
the ranks' copies (``torch.distributed.nn.functional.all_reduce``
all-reduces the cotangent too, which multiplies the gradients by the
group size). A tensor has one of three layouts along an axis, and its
cotangent the matching one:

  replicated  the same value on every rank, its cotangent whole on every
              rank;
  sharded     each rank its block, its cotangent the block's;
  partial     each rank a part of a sum (a row-parallel product), or a
              replicated value inside a region whose cotangent is partial:
              the ranks' cotangents sum to the whole one.

The pairs (forward, backward):

  copy_in         identity, all-reduce     replicated -> into a region
                                           whose cotangent is partial
  reduce_out      all-reduce, identity     partial -> replicated
  gather_out      all-gather, slice        sharded -> replicated
  scatter_in      slice, all-gather        replicated -> sharded
  gather_in       all-gather,              sharded -> a partial region
                  reduce-scatter           (sequence parallelism, FSDP)
  reduce_scatter  reduce-scatter,          partial -> sharded
                  all-gather
  all_to_all      all-to-all, the inverse all-to-all
  shared_out      identity, cotangent / n  a value every rank of the axis
                                           computed alike in a partial
                                           region -> replicated

Where autograd records nothing (serving, ``torch.no_grad``, a tensor that
needs no gradient) each is the plain collective of ``RankMesh``
(``reduce_out`` in place, as the serving path always ran), or the
identity; on an axis of one rank each is the identity.
"""

from __future__ import annotations

import torch

from .mesh import Axis


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _own(x: torch.Tensor, dim: int, mesh, axis: Axis) -> torch.Tensor:
    """This rank's block of ``dim`` along ``axis``."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    w = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * w, w)


def _sum(g: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    return mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), axis)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.mesh, ctx.axis).contiguous(), None, None, None


class _ScatterIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return _own(x, dim, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.dim, ctx.axis), None, None, None


class _GatherIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.dim, ctx.axis), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.dim, ctx.axis), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split, concat, axis):
        ctx.mesh, ctx.split, ctx.concat, ctx.axis = mesh, split, concat, axis
        return mesh.all_to_all(x, split, concat, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.concat, ctx.split, ctx.axis), None, None, None, None


class _SharedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def copy_in(x: torch.Tensor, mesh, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1 or not _records(x):
        return x
    return _CopyIn.apply(x, mesh, axis)


def reduce_out(x: torch.Tensor, mesh, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    if not _records(x):
        return mesh.all_reduce(x, axis)
    return _ReduceOut.apply(x, mesh, axis)


def gather_out(x: torch.Tensor, mesh, dim: int, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    if not _records(x):
        return mesh.all_gather(x, dim, axis)
    return _GatherOut.apply(x, mesh, dim % x.ndim, axis)


def scatter_in(x: torch.Tensor, mesh, dim: int, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    if not _records(x):
        return _own(x, dim, mesh, axis)
    return _ScatterIn.apply(x, mesh, dim % x.ndim, axis)


def gather_in(x: torch.Tensor, mesh, dim: int, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    if not _records(x):
        return mesh.all_gather(x, dim, axis)
    return _GatherIn.apply(x, mesh, dim % x.ndim, axis)


def reduce_scatter(x: torch.Tensor, mesh, dim: int, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    if not _records(x):
        return mesh.reduce_scatter(x, dim, axis)
    return _ReduceScatter.apply(x, mesh, dim % x.ndim, axis)


def all_to_all(x: torch.Tensor, mesh, split: int, concat: int, axis: Axis = "model") -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    if not _records(x):
        return mesh.all_to_all(x, split, concat, axis)
    return _AllToAll.apply(x, mesh, split % x.ndim, concat % x.ndim, axis)


def shared_out(x: torch.Tensor, mesh, axis: Axis = "model") -> torch.Tensor:
    n = mesh.axis_size(axis)
    if n == 1 or not _records(x):
        return x
    return _SharedOut.apply(x, n)
