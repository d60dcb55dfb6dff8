"""Sharded execution over ``torch.distributed``: the rank mesh, the
sharding plans, and a launcher that runs a function on every rank."""
from .mesh import RankMesh  # noqa: F401
from .specs import (NULL_PLAN, KernelShardAxes, ShardingPlan,  # noqa: F401
                    adapt_plan_for_batch, make_plan, quantized_pspec,
                    strategy_sharding_plan)
