"""Host mesh construction (the port of ``repro.launch.mesh``).

``make_host_mesh`` wraps the initialised ``torch.distributed`` group in a
``RankMesh``: the reference's ``(data, model)`` mesh over the local devices
with a data axis of size 1. A group larger than ``model_axis``, where the
reference would build a data axis of size > 1, is not ported (ROADMAP
A.9); neither is ``make_production_mesh``, which waits for the dry-run
slice.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.models.transformer import not_ported
from repro_torch.sharding.mesh import RankMesh


def make_host_mesh(model_axis: int = 2, group=None) -> RankMesh:
    """A ``RankMesh`` over ``group`` (None: the default group), which the
    caller initialised; the model axis takes ``min(model_axis, ranks)``
    ranks, as the reference's does, and every rank must be on it."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_host_mesh takes an initialised process group; call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size(group)
    model_axis = min(model_axis, n)
    if n // model_axis > 1:
        raise not_ported(f"a host mesh of {n} ranks with a model axis of {model_axis} (a data axis of "
                         f"{n // model_axis})", "A.9")
    return RankMesh(group)
