"""How a sublayer enters and leaves the model axis (Megatron style), with
and without sequence-parallel activations (``sp``: the plan's
``seq_shard_acts``, ``sharding.specs.sp_active``).

Without ``sp`` the residual stream is replicated over the model axis. A
sublayer whose products are sharded (column-parallel in, row-parallel out)
enters through ``tp_in`` (``copy_in``) and leaves through ``tp_out``
(``reduce_out``, the all-reduce of its partial sums); a sublayer computed
whole on every rank needs neither.

With ``sp`` the residual stream is sequence-sharded over the model axis
(dim 1 of (B, S, d)): ``tp_in`` all-gathers the sequence (its backward a
reduce-scatter) and ``tp_out`` reduce-scatters the partial sums in place of
the all-reduce (its backward an all-gather). A sublayer computed whole
enters through ``whole_in`` (an all-gather whose backward keeps the rank's
block) and leaves through ``whole_out`` (the rank's block, its backward an
all-gather). A norm of the sequence shard sees this rank's positions only,
so its weight's gradient is summed over the model axis (``norm_weight``).

Off a mesh every helper is the identity; where autograd records nothing
they are the serving path's collectives.
"""

from __future__ import annotations

import torch

from repro_torch.sharding import autograd as ad


def axis(plan) -> str:
    """The model (TP) axis."""
    return plan.attn_tp_axis or plan.ffn_tp_axis or "model"


def on_mesh(plan) -> bool:
    return plan is not None and not plan.is_null


def tp_in(h: torch.Tensor, plan, sp: bool) -> torch.Tensor:
    if sp:
        return ad.gather_in(h, plan.mesh, 1, axis(plan))
    return ad.copy_in(h, plan.mesh, axis(plan))


def tp_out(y: torch.Tensor, plan, sp: bool) -> torch.Tensor:
    if sp:
        return ad.reduce_scatter(y, plan.mesh, 1, axis(plan))
    return ad.reduce_out(y, plan.mesh, axis(plan))


def whole_in(h: torch.Tensor, plan, sp: bool) -> torch.Tensor:
    return ad.gather_out(h, plan.mesh, 1, axis(plan)) if sp else h


def whole_out(y: torch.Tensor, plan, sp: bool) -> torch.Tensor:
    return ad.scatter_in(y, plan.mesh, 1, axis(plan)) if sp else y


def norm_weight(w: torch.Tensor, plan, sp: bool) -> torch.Tensor:
    return ad.copy_in(w, plan.mesh, axis(plan)) if sp else w
