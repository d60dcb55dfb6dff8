"""Host mesh construction (the port of ``repro.launch.mesh``).

``make_host_mesh`` wraps the initialised ``torch.distributed`` group in a
``RankMesh`` of the reference's shape: ``(n // model_axis, model_axis)``
over ``("data", "model")``. ``make_production_mesh`` waits for the dry-run
slice (ROADMAP A.9).
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding.mesh import RankMesh


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
