"""Mesh construction (the port of ``repro.launch.mesh``).

``make_host_mesh`` wraps the initialised ``torch.distributed`` group in a
``RankMesh`` of the reference's shape: ``(n // model_axis, model_axis)``
over ``("data", "model")``.

``make_production_mesh`` is the dry run's mesh (``repro_torch.launch.dryrun``):
one rank of the production mesh, 16x16 ``("data", "model")`` (256 ranks), or
2x16x16 with a leading ``"pod"`` axis (512 ranks), over a *fake* default
group of that size in this one process. The fake backend exchanges nothing:
each collective returns its output's shape at once, so one process traces
one rank's step. The reference forces 512 host devices for the same
purpose (``XLA_FLAGS``); this module makes its group itself, likewise.

The ``RankMesh`` is 2-D, so the multi-pod mesh folds ``"pod"`` into
``"data"``: a data axis of 32, pod-major (group rank ``(p * 16 + i) * 16 +
j`` for pod ``p``, data ``i``, model ``j``, which is ``jax.make_mesh((2,
16, 16))``'s device order). The fold is exact because the reference names
``"pod"`` only together with ``"data"``: its plans' ``dp_axes`` are
``("pod", "data")``, FSDP shards over every axis, and ``seq_all`` spreads
over every axis.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding.mesh import RankMesh

POD = (16, 16)  # (data, model) ranks of one pod


def make_host_mesh(model_axis: int = 2, group=None) -> RankMesh:
    """A ``RankMesh`` over ``group`` (None: the default group), which the
    caller initialised: the model axis takes ``min(model_axis, ranks)``
    ranks and the data axis the rest, as the reference's does. A group the
    model axis does not divide is refused, as ``jax.make_mesh`` refuses a
    shape whose product is not the device count."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_host_mesh takes an initialised process group; call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size(group)
    model_axis = min(model_axis, n)
    if n % model_axis:
        raise ValueError(f"a mesh of ({n // model_axis}, {model_axis}) does not cover {n} ranks")
    return RankMesh(group, data=n // model_axis)


def make_fake_mesh(data: int, model: int, rank: int = 0, name: str = "") -> RankMesh:
    """Rank ``rank`` of a ``(data, model)`` mesh over a fake default group of
    ``data * model`` ranks, made here. A fake default group left by an
    earlier mesh is torn down first; a real one is refused (the dry run
    owns its default group: run it in a process of its own)."""
    world = data * model
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not a rank of a {data}x{model} mesh")
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} default group exists; the dry run makes a fake one of "
                               "its own: run it in a process of its own")
        release_fake_mesh()
    # registers the "fake" backend on import (torch 2.1 and later; checked on 2.11 and 2.13)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    mesh = RankMesh(None, data=data)
    mesh.name = name or f"{data}x{model}"
    return mesh


def release_fake_mesh() -> None:
    """Tear down the fake default group (and its subgroups), if there is one."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> RankMesh:
    """Rank ``rank`` of the production mesh over a fake group: 16x16 = 256
    ranks (name ``"16x16"``), or two pods, 512 ranks with ``"pod"`` folded
    into a data axis of 32 (name ``"2x16x16"``)."""
    pods = 2 if multi_pod else 1
    return make_fake_mesh(pods * POD[0], POD[1], rank, "2x16x16" if multi_pod else "16x16")
