# The port's own copy of repro.sharding.specs: the port imports nothing of the JAX package.
"""Sharding plans: how a HAP strategy maps onto the ranks of a mesh.

A strategy becomes an assignment of tensor dimensions to mesh axes. A
``ShardingPlan`` carries that assignment; the model code reads it to know
which dimensions of its weights, activations and KV cache are this rank's
shard and where a collective completes a product. With a null plan (no
mesh) everything is unsharded single-device execution.

A spec is a tuple with one entry per tensor dimension: an axis name or
None (replicated), where the reference builds a ``PartitionSpec``.

Two attention modes (DESIGN.md §5):
  - ``tp_heads``   q/o weights sharded over heads on the TP axis; k/v
                   sharded too when ``num_kv_heads % tp == 0``, else
                   replicated. The decode KV cache is sharded over heads
                   when they divide, else kept whole on every rank.
  - ``replicated`` attention weights replicated (the head count does not
                   divide the axis, or HAP selects attention-DP); the
                   model axis parallelizes only the FFN / expert side.

Expert modes: ``tp`` (expert d_ff sharded on the TP axis, all-reduce
combine) or ``ep`` (expert dim sharded on the EP axis, all-to-all
dispatch and combine).

One layout differs from the reference by design: where its resolver
keeps the decode cache sequence-sharded (``seq``: replicated attention, or
kv heads that do not divide the axis), this one keeps the whole cache on
every rank (``none``, a layout the reference also names). The tokens are
the same; only the memory differs. The ``seq``/``seq_all`` layouts,
data-parallel axes of size > 1, ``seq_shard_acts`` and ``fsdp`` are not
ported yet (ROADMAP A.9).

Expert replication differs in one point: the reference gathers each slot's
weights from the expert-layout leaves inside every step; here the engine
lays the expert leaves out in slots once, when a replica set is installed,
and the model reads them as they are (``repro_torch.models.moe``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class KernelShardAxes:
    """Plan -> kernel-seam axis resolution (DESIGN.md §4c): the mesh and the
    axis the kernel-sharded dimension maps to (attention heads, expert
    d_ff). Each rank runs the kernel on its own shard. ``dim`` is that
    dimension's global extent (0 where the seam does not need it)."""

    mesh: Any
    axis: str
    dim: int = 0

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]


@dataclasses.dataclass(frozen=True)
class ExpertReplication:
    """Replica-aware expert placement (hot-expert replication).

    ``degrees[e]`` is the replica count of expert ``e`` (>= 1);
    ``order`` is a permutation of expert ids giving the slot layout —
    expert ``order[0]``'s replica block first, then ``order[1]``'s, and
    so on. The replication planner orders experts by inter-layer
    co-fire affinity so experts that fire together land in the same
    EP slot-axis shard (cutting all2all fan-out); dispatch maps token
    copy ``p`` of expert ``e`` to replica ``p % degrees[e]`` inside the
    expert's contiguous slot block, which both balances replica load
    deterministically and keeps the remap a cheap gather.

    Frozen + tuple-typed so a plan carrying one stays hashable (step-graph
    keys): a replica-set change is a NEW plan, so its steps are captured
    anew, the Eq.-6 transition semantics the engine's rebalance hook
    piggybacks on.
    """
    degrees: Tuple[int, ...]
    order: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.order:
            object.__setattr__(self, "order",
                               tuple(range(len(self.degrees))))
        if sorted(self.order) != list(range(len(self.degrees))):
            raise ValueError(f"order {self.order} is not a permutation")
        if any(d < 1 for d in self.degrees):
            raise ValueError(f"degrees must be >= 1, got {self.degrees}")

    @property
    def n_experts(self) -> int:
        return len(self.degrees)

    @property
    def total_slots(self) -> int:
        return sum(self.degrees)

    @property
    def is_identity(self) -> bool:
        return all(d == 1 for d in self.degrees) and \
            self.order == tuple(range(len(self.degrees)))

    def slot_to_expert(self) -> Tuple[int, ...]:
        out = []
        for e in self.order:
            out.extend([e] * self.degrees[e])
        return tuple(out)

    def expert_offsets(self) -> Tuple[int, ...]:
        """Slot index of each expert's first replica (indexed by expert id)."""
        offsets = [0] * len(self.degrees)
        pos = 0
        for e in self.order:
            offsets[e] = pos
            pos += self.degrees[e]
        return tuple(offsets)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any = None  # a RankMesh (or anything with axis_names and shape)
    dp_axes: Tuple[str, ...] = ()
    attn_mode: str = "tp_heads"  # tp_heads | replicated
    attn_tp_axis: Optional[str] = None
    kv_shard: str = "heads"  # heads | none | seq | seq_all (cache layout)
    ffn_mode: str = "tp"  # tp | ep (experts; dense FFN: tp)
    ffn_tp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    seq_axis: Optional[str] = None
    # Hot-expert replication: when set, MoE dispatch routes token copies
    # to replica *slots* (see ExpertReplication) instead of raw expert ids,
    # and the expert leaves are laid out in those slots. Part of the frozen
    # plan: a replica-set change is a plan change, so the engine's step
    # graphs and transition machinery treat a rebalance like any other
    # plan switch.
    replication: Optional[ExpertReplication] = None
    # EP micro-batch pipelining: the dispatch buffer is split into K
    # capacity slabs, each slab's all-to-all overlapping the previous
    # slab's expert FFN. 0 = auto, 1 = serial, K >= 2 forced.
    moe_pipeline: int = 0

    @property
    def is_null(self) -> bool:
        return self.mesh is None

    def axis_size(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None:
            return 1
        return self.mesh.shape[name]

    def divides(self, n: int, axis: Optional[str] = None) -> bool:
        """Whether a dimension of extent ``n`` shards over ``axis`` (the
        model axis by default): the rule ``param_pspecs`` applies to every
        weight."""
        return self.mesh is not None and n % self.axis_size(axis or self.ffn_tp_axis) == 0

    # -- kernel-seam axis resolution --------------------------------------
    def attn_kernel_axes(self, num_q_heads: int, num_kv_heads: int) -> Optional[KernelShardAxes]:
        """Axes for a heads-sharded attention kernel, or None when the plan
        cannot run it per shard: replicated attention, or a head count that
        does not divide the TP axis."""
        if self.is_null or self.attn_mode != "tp_heads" or self.attn_tp_axis is None:
            return None
        tp = self.axis_size(self.attn_tp_axis)
        if num_q_heads % tp or num_kv_heads % tp:
            return None
        return KernelShardAxes(self.mesh, self.attn_tp_axis, num_q_heads)

    def decode_kernel_axes(self, num_q_heads: int, num_kv_heads: int) -> Optional[KernelShardAxes]:
        """``attn_kernel_axes`` for the cache-appending decode step: the KV
        cache must be heads-sharded too, so each rank walks its own head
        shard of the page pool."""
        if self.kv_shard != "heads":
            return None
        return self.attn_kernel_axes(num_q_heads, num_kv_heads)

    def expert_kernel_axes(self, d_ff: int) -> Optional[KernelShardAxes]:
        """Axes for the TP grouped-expert matmuls (d_ff on the ffn TP axis),
        or None when d_ff does not divide (or the experts run EP)."""
        if self.is_null or self.ffn_mode != "tp" or self.ffn_tp_axis is None:
            return None
        if d_ff % self.axis_size(self.ffn_tp_axis):
            return None
        return KernelShardAxes(self.mesh, self.ffn_tp_axis, d_ff)


NULL_PLAN = ShardingPlan()


def quantized_pspec(spec: Spec) -> Spec:
    """Dense weight spec -> resident-INT4 packed-layout spec: a sharded last
    dim moves to the group axis (group spans tile last-dim spans), the
    nibble axis is never sharded, and the scales/zeros leaves (same rank,
    trailing dim 1) take the same spec."""
    return tuple(spec) + (None,)


def _resolve_plan(mesh, cfg, *, want_attn_tp: bool, want_ep: bool, attn_override: str = "",
                  expert_mode: str = "", kv_shard: str = "") -> ShardingPlan:
    """Shared mode-resolution core (DESIGN.md §5): legality-check the
    intent against the model axis's size and fall back to the replicated /
    TP modes when the dimensions do not divide. ``mesh`` needs only
    ``axis_names`` and ``shape``."""
    if mesh is None:
        return NULL_PLAN
    axis_names = mesh.axis_names
    model_ax = "model" if "model" in axis_names else axis_names[-1]
    dp_axes = tuple(a for a in axis_names if a != model_ax)
    tp = mesh.shape[model_ax]

    heads_ok = cfg.has_attention and cfg.num_heads % tp == 0
    attn_mode = attn_override or ("tp_heads" if (want_attn_tp and heads_ok) else "replicated")
    if attn_mode == "tp_heads" and not heads_ok:
        attn_mode = "replicated"

    # decode KV cache layout: the whole cache where the reference picks seq
    if not kv_shard:
        kv_shard = "heads" if attn_mode == "tp_heads" and cfg.num_kv_heads % tp == 0 else "none"

    ep_ok = cfg.is_moe and cfg.n_routed_experts % tp == 0
    if not expert_mode:
        expert_mode = "ep" if (want_ep and ep_ok) else "tp"
    if expert_mode == "ep" and not ep_ok:
        expert_mode = "tp"

    return ShardingPlan(
        mesh=mesh,
        dp_axes=dp_axes,
        attn_mode=attn_mode,
        attn_tp_axis=model_ax,
        kv_shard=kv_shard,
        ffn_mode=expert_mode,
        ffn_tp_axis=model_ax,
        ep_axis=model_ax if expert_mode == "ep" else None,
    )


def strategy_sharding_plan(mesh, cfg, attn, expert) -> ShardingPlan:
    """Map HAP strategy degrees onto mesh axes (the planner -> mesh
    bridge): attention-TP puts heads on the model axis, attention-DP keeps
    the attention weights replicated; expert-EP puts the expert dimension
    on the model axis, expert-TP the expert d_ff. Reach it through
    ``HAPPlan.to_sharding_plan``."""
    return _resolve_plan(mesh, cfg, want_attn_tp=attn.tp > 1, want_ep=expert.ep > 1)


def make_plan(mesh, cfg, *, attn_override: str = "", expert_mode: str = "", kv_shard: str = "") -> ShardingPlan:
    """Default (baseline) plan: TP-heads attention and EP experts wherever
    legal."""
    return _resolve_plan(mesh, cfg, want_attn_tp=True, want_ep=True, attn_override=attn_override,
                         expert_mode=expert_mode, kv_shard=kv_shard)


def adapt_plan_for_batch(plan: ShardingPlan, cfg, batch: int, kind: str) -> ShardingPlan:
    """Shape-aware fixup: a batch that does not divide the DP axes cannot
    be data-sharded; drop DP and spread a decode cache's sequence over
    every axis instead. (The reference also turns on ``seq_shard_acts``
    for prefill, which is not ported: ROADMAP A.9.)"""
    if plan.is_null:
        return plan
    dp_size = 1
    for a in plan.dp_axes:
        dp_size *= plan.axis_size(a)
    if batch % max(dp_size, 1) == 0:
        return plan
    kv = "seq_all" if (kind == "decode" and cfg.has_attention) else plan.kv_shard
    return dataclasses.replace(plan, dp_axes=(), kv_shard=kv)


def unported_layout(plan: Optional[ShardingPlan]) -> Optional[str]:
    """What of ``plan`` the port cannot execute yet (ROADMAP A.9), or None:
    a data-parallel axis of size > 1, or a sequence-sharded KV cache."""
    if plan is None or plan.is_null:
        return None
    big = [a for a in plan.dp_axes if plan.axis_size(a) > 1]
    if big:
        return f"data-parallel mesh axes {big} of size > 1"
    if plan.kv_shard in ("seq", "seq_all"):
        return f"the {plan.kv_shard!r} KV-cache layout"
    return None


def shard_slices(spec: Spec, shape, rank: int, sizes: Dict[str, int]) -> Tuple[slice, ...]:
    """The index of ``rank``'s shard of a tensor of global ``shape`` laid
    out by ``spec``: one slice per dimension (``sizes``: axis -> size)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(slice(None))
        else:
            step = dim // sizes[ax]
            out.append(slice(rank * step, (rank + 1) * step))
    return tuple(out)


def packed_spec_for(spec: Spec, packed_shape, sizes: Dict[str, int]) -> Spec:
    """A resident INT4 leaf's spec (its packed tensor, and its scales and
    zeros alike) from its dense ``spec``: ``quantized_pspec``, with any axis
    the global ``packed_shape`` does not divide dropped, as the reference's
    ``_quantized_shardings`` does (DeepSeek's ``wi`` under TP2: 11 groups of
    128 do not split in two, so it stays whole on every rank)."""
    return tuple(ax if ax is not None and dim % sizes[ax] == 0 else None
                 for dim, ax in zip(packed_shape, quantized_pspec(spec)))


def sharded_dim(spec: Spec) -> Optional[int]:
    """The dimension ``spec`` shards (a 1-D mesh shards at most one), or
    None."""
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    return dims[0] if dims else None
