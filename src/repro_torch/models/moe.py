"""Mixture-of-Experts: router, capacity-based dispatch, shared experts (the
port of ``repro.models.moe``). Three execution modes, selected by the
ShardingPlan (the HAP strategy of the Expert module):

  local  one device (null plan): dispatch + per-expert grouped matmuls.
  tp     the local path on each rank's d_ff shard: every rank runs every
         token of every expert on its d_ff columns (column-parallel wi,
         then row-parallel wo and one all-reduce).
  ep     experts sharded over the ranks: each rank routes its share of
         the tokens and exchanges the dispatch buffer with all-to-all
         (serial, or pipelined over capacity slabs).

Shared experts run TP on a mesh (their d_ff sharded, one all-reduce).

With a data axis (the plan's ``dp_axes``) each rank holds its data rows'
tokens. TP routes over the global token order, as the reference's
``_moe_tp`` does: the capacity is the global batch's, a data rank's
positions in an expert start after the tokens the data ranks before it
sent there (one all-gather of an (E,) count vector a layer), and the
Switch aux takes its means over every data rank's tokens (two (E,)
sums). EP splits the data rank's tokens over the EP axis when they divide
(the reference's dp x ep split), else keeps them whole on every EP rank
(its dp-only and replicated cases); the aux is the mean of every
(data, ep) shard's, whose gradient the reference's is too (it reports
data shard 0's: ROADMAP C). Where every data rank holds every row (a
batch the serving engine does not split, or a prefill chunk's one row),
EP splits the tokens over the data and EP axes as the reference's
``shard_map`` does on the global tokens (``ep_token_axes``), each block
with the capacity of its own tokens.

Under autograd the collectives are ``repro_torch.sharding.autograd``'s:
the router, replicated but fed each EP rank's own tokens, takes its
gradient summed over the EP axis.

Dispatch is GShard-style with a static capacity
``C = ceil(T * top_k / E * capacity_factor)`` per expert (rounded up to a
multiple of 8): tokens beyond an expert's capacity are dropped. Every
per-expert product goes through the grouped-matmul seam
(``repro_torch.kernels.ops.grouped_matmul``).

When the plan carries an ``ExpertReplication`` (hot-expert replication),
token copies go to replica *slots*, and the expert leaves must already be
laid out in those slots: (S, ...) per layer, or this rank's S/ep under EP.
The reference gathers ``w[slot_to_expert]`` inside every step; here the
engine builds the slot leaves once per replica set (``slot_weights`` is
that layout), so no step copies a weight.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sharding import autograd as ad
from repro_torch.sharding.specs import ExpertReplication, dp_axes, dp_index, dp_size

from .common import activation_fn, glu_ffn


class MoEOut(NamedTuple):
    y: torch.Tensor  # (B, S, d)
    aux_loss: torch.Tensor  # scalar load-balance loss
    route_idx: Optional[torch.Tensor] = None  # (B*S, top_k) router top-k ids


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(num_tokens * cfg.top_k / cfg.n_routed_experts * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def pipeline_chunks(C_loc: int, ep_size: int, knob: int = 0) -> int:
    """The EP pipeline depth K for a local capacity ``C_loc``. ``knob`` is
    ``ShardingPlan.moe_pipeline``: 1 pins the serial path, K >= 2 forces
    that many capacity slabs (clamped to C_loc so no slab is empty), 0
    picks the deepest K in {4, 2} whose slabs keep the 8-row capacity
    granule, serial when there is no all-to-all to overlap (ep_size 1)."""
    if knob == 1:
        return 1
    if knob >= 2:
        return min(knob, max(C_loc, 1))
    if ep_size <= 1:
        return 1
    for k in (4, 2):
        if C_loc >= 8 * k:
            return k
    return 1


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, plan=None):
    """Top-k routing. x_flat: (T, d) -> gates (T,k), idx (T,k), aux_loss.
    With ``plan``'s data axes the aux's means run over every data rank's
    tokens (the reference routes the global batch)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, and the lower expert index first among
    # equal probabilities (a stable sort); torch.topk breaks ties in no
    # stated order
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, : cfg.top_k], idx[:, : cfg.top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss: E * sum(frac_tokens * frac_probs)
    E = cfg.n_routed_experts
    top1 = F.one_hot(idx[:, 0], E).float()
    axes = dp_axes(plan)
    if not axes:
        return gates, idx, E * torch.sum(probs.mean(dim=0) * top1.mean(dim=0))
    n = x_flat.shape[0] * dp_size(plan)
    me = ad.reduce_out(probs.sum(dim=0), plan.mesh, axes) / n
    ce = plan.mesh.all_reduce(top1.sum(dim=0).detach(), axes) / n
    return gates, idx, E * torch.sum(me * ce)


def make_dispatch(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int):
    """Scatter coordinates with capacity dropping.

    Returns (flat_expert (T*k,), pos_in_expert (T*k,), keep (T*k,),
    flat_gates (T*k,)). Entries with pos_in_expert >= C are dropped.
    """
    flat_expert = idx.reshape(-1)
    onehot = F.one_hot(flat_expert, E)  # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_in_expert = (pos * onehot).sum(dim=-1)
    keep = pos_in_expert < C
    return flat_expert, pos_in_expert, keep, gates.reshape(-1)


def dispatch(x_flat: torch.Tensor, flat_expert, pos_in_expert, E: int, C: int):
    """Gather-based scatter of tokens into (E, C, d) expert buffers.

    Empty slots hold the sentinel token T, a zero row. Entries past
    capacity are dropped: they scatter into one spare slot past the map,
    which keeps the scatter free of a host sync.
    """
    T = x_flat.shape[0]
    k = flat_expert.shape[0] // T
    token_id = torch.arange(T * k, device=x_flat.device) // k
    target = torch.where(pos_in_expert < C, flat_expert * C + pos_in_expert, E * C)
    idx_map = torch.full((E * C + 1,), T, dtype=torch.long, device=x_flat.device)
    idx_map = idx_map.scatter(0, target, token_id)[: E * C].view(E, C)
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, x_flat.shape[-1]))], dim=0)
    return x_pad[idx_map], idx_map  # (E, C, d)


def combine(y_buf, flat_expert, pos_in_expert, keep, flat_gates, T: int):
    """Gather expert outputs back: y_buf (E, C, d) -> (T, d)."""
    k = flat_expert.shape[0] // T
    safe_pos = torch.where(keep, pos_in_expert, 0)
    gathered = y_buf[flat_expert, safe_pos]  # (T*k, d)
    gathered = gathered * (flat_gates * keep)[:, None].to(y_buf.dtype)
    return gathered.reshape(T, k, -1).sum(dim=1)


def _replica_tables(rep: ExpertReplication, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rep``'s degrees and first-replica offsets as device tensors, made
    once per device and kept on ``rep`` itself: a step captured in a CUDA
    graph reads them (a graph holds raw pointers) and must not copy from
    the host, and the plan a captured step was made under holds ``rep``,
    so the tables live as long as that step and go with the replica set.
    Each is E integers."""
    tables = rep.__dict__.setdefault("_device_tables", {})  # not a field: equality and hashing ignore it
    device = torch.device(device)
    if device not in tables:
        tables[device] = (torch.tensor(rep.degrees, dtype=torch.long, device=device),
                          torch.tensor(rep.expert_offsets(), dtype=torch.long, device=device))
    return tables[device]


def replica_coords(flat_expert, pos_in_expert, rep: ExpertReplication):
    """(expert id, pos within expert) -> (slot id, pos within replica).

    Token copy ``p`` of expert ``e`` lands on replica ``p % degree(e)``
    inside the expert's contiguous slot block: the deterministic
    round-robin choice (replica loads differ by at most one token), two
    table lookups."""
    degrees, offsets = _replica_tables(rep, flat_expert.device)
    deg = degrees[flat_expert]
    slot = offsets[flat_expert] + pos_in_expert % deg
    return slot, pos_in_expert // deg


def slot_weights(w, rep: ExpertReplication, dim: int = 0):
    """The slot layout of expert weights: dim ``dim`` (the expert dim; 1
    for a stacked (L, E, ...) leaf) goes from E experts to
    ``rep.total_slots`` slots, slot ``s`` holding expert
    ``slot_to_expert()[s]``. Dense tensors and resident ``QuantizedExpert``
    leaves alike (every leaf shares the expert dim)."""
    sl = torch.tensor(rep.slot_to_expert(), dtype=torch.long, device=w.device)
    if isinstance(w, kernel_ops.QuantizedExpert):
        return kernel_ops.QuantizedExpert(*(t.index_select(dim, sl) for t in (w.packed, w.scales, w.zeros)))
    return w.index_select(dim, sl)


def _active_replication(plan) -> Optional[ExpertReplication]:
    rep = getattr(plan, "replication", None) if plan is not None else None
    if rep is None or rep.is_identity:
        return None
    return rep


def _is_ep(plan) -> bool:
    return plan is not None and not plan.is_null and plan.ffn_mode == "ep" and plan.ep_axis is not None


def serving_replication(plan) -> Optional[ExpertReplication]:
    """The replica set the experts serve under ``plan``, or None: the plan's
    active replication, except under EP when its slot count does not divide
    the EP axis (the reference then serves unreplicated; a planner with
    ``align=ep`` never hits that). The expert leaves are in its slot
    layout."""
    rep = _active_replication(plan)
    if rep is not None and _is_ep(plan) and rep.total_slots % plan.axis_size(plan.ep_axis):
        return None
    return rep


def ep_token_axes(plan, num_tokens: int) -> Tuple[str, ...]:
    """The mesh axes EP under ``plan`` splits a rank's ``num_tokens`` over
    (each rank then routes, and reports the top-k of, its own block), by
    the reference's rule on the tokens the rank's data axes hold alike:
    its data rows' tokens (the data axes in the plan's ``dp_axes``), or
    every row's, replicated over a data axis the plan dropped. With ``r``
    ranks on such replicated axes: over them and the EP axis when the
    tokens divide ``r * ep``, over them alone when they divide ``r``,
    else not at all (every rank routes them all)."""
    if not _is_ep(plan):
        return ()
    ep, held = plan.ep_axis, dp_axes(plan)
    same = tuple(a for a in plan.mesh.axis_names if a != ep and a not in held and plan.axis_size(a) > 1)
    r = plan.axis_size(same) if same else 1
    if num_tokens % (r * plan.axis_size(ep)) == 0:
        return same + (ep,)
    if same and num_tokens % r == 0:
        return same
    return ()


def route_axes(plan, num_tokens: int) -> Tuple[str, ...]:
    """The mesh axes over which a step's ``num_tokens`` (a rank's) router
    choices are split, in mesh order: all-gathered over them, every rank
    holds the whole batch's, in the global token order."""
    if plan is None or plan.is_null:
        return ()
    axes = set(dp_axes(plan)) | set(ep_token_axes(plan, num_tokens))
    return tuple(a for a in plan.mesh.axis_names if a in axes)


def expert_ffn(buf, wi_gate, wi_up, wo, act_name: str, backend=None, axes=None) -> torch.Tensor:
    """(E, C, d) x (E, d, f)^2 x (E, f, d) -> (E, C, d), through the
    grouped-matmul seam. ``axes`` (a TP plan's ``expert_kernel_axes``)
    runs wi_gate/wi_up column-parallel and wo row-parallel, all-reduced."""
    act = activation_fn(act_name)
    if axes is not None:
        buf = ad.copy_in(buf, axes.mesh, axes.axis)
    gate = kernel_ops.grouped_matmul(buf, wi_gate, shard_axes=axes, sharded_dim="out", backend=backend)
    up = kernel_ops.grouped_matmul(buf, wi_up, shard_axes=axes, sharded_dim="out", backend=backend)
    return kernel_ops.grouped_matmul(act(gate) * up, wo, shard_axes=axes, sharded_dim="in", backend=backend)


def _global_positions(fe, pe, E: int, plan):
    """Each entry's position in its expert in the global token order: this
    data rank's ``pe`` after the tokens every data rank before it sent to
    the expert."""
    axes = dp_axes(plan)
    if not axes:
        return pe
    counts = torch.bincount(fe, minlength=E)[None]
    before = plan.mesh.all_gather(counts, dim=0, axis=axes)[:dp_index(plan)].sum(dim=0)
    return pe + before[fe]


def _moe_local(x_flat, moe_p, cfg: ModelConfig, backend=None, axes=None, rep=None, plan=None, want_aux=True):
    """One device (the reference's ``_moe_local``), or TP with ``axes`` (a
    TP plan's ``expert_kernel_axes``: column-parallel wi, row-parallel wo
    with one all-reduce; None where the d_ff does not divide the axis, the
    experts then whole on every rank; the reference's ``_moe_tp``): every
    token of every expert on this rank's d_ff columns. ``rep``: the replica
    set the slot-layout leaves hold. With ``plan``'s data axes the tokens
    are this data rank's, routed in the global order: the capacity is the
    global batch's, and the buffer holds this rank's tokens at their global
    positions. ``want_aux`` False: no aux (None), and none of its
    collectives."""
    T = x_flat.shape[0]
    E = cfg.n_routed_experts
    C = capacity(T * dp_size(plan), cfg)
    gates, idx, aux = route(x_flat, moe_p["router"], cfg, plan if want_aux else None)
    aux = aux if want_aux else None
    fe, pe, keep, fg = make_dispatch(idx, gates, E, C)
    pe = _global_positions(fe, pe, E, plan)
    keep = pe < C
    if rep is not None:
        fe, pe = replica_coords(fe, pe, rep)
        keep = pe < C  # per-SLOT capacity: hot experts hold degree*C
        E = rep.total_slots
    buf, _ = dispatch(x_flat, fe, pe, E, C)
    y_buf = expert_ffn(buf, moe_p["wi_gate"], moe_p["wi_up"], moe_p["wo"], cfg.activation, backend=backend, axes=axes)
    y = combine(y_buf, fe, pe, keep, fg, T)
    return y, aux, idx


def _moe_ep(x_flat, moe_p, cfg: ModelConfig, plan, backend=None, want_aux=True):
    """EP (the reference's ``_moe_ep_shardmap``): the experts sharded over
    the EP axis, tokens exchanged with all-to-all. A data rank's tokens
    are split over the EP axis when they divide (each rank routes T/ep of
    them, with the capacity of its own share) and whole on every EP rank
    otherwise; each rank's outputs are gathered back, and the aux loss is
    the mean over every (data, ep) shard's. ``route_idx`` holds this
    rank's tokens' choices.

    With a replica set (``serving_replication``) the slot axis is what the
    ranks shard: rank r holds slots [r*S/n, (r+1)*S/n), so a hot expert
    owns replica slots on several ranks."""
    mesh = plan.mesh
    ep = plan.ep_axis
    n = plan.axis_size(ep)
    E = cfg.n_routed_experts
    T = x_flat.shape[0]
    split = ep_token_axes(plan, T)
    whole = ep not in split  # every EP rank routes this block
    # the router sees this rank's tokens: its gradient is summed over the
    # axes they are split over and the EP axis
    router = ad.copy_in(moe_p["router"], mesh, split + (ep,) if whole else split)
    xl = ad.scatter_in(x_flat, mesh, 0, split) if split else x_flat
    if whole:
        xl = ad.copy_in(xl, mesh, ep)
    rep = serving_replication(plan)
    n_slots = rep.total_slots if rep is not None else E
    T_loc = xl.shape[0]
    C_loc = capacity(T_loc, cfg)
    gates, idx, aux = route(xl, router, cfg)
    fe, pe, keep, fg = make_dispatch(idx, gates, E, C_loc)
    if rep is not None:
        fe, pe = replica_coords(fe, pe, rep)
        keep = pe < C_loc
    buf, _ = dispatch(xl, fe, pe, n_slots, C_loc)  # (S, C_loc, d)
    K = pipeline_chunks(C_loc, n, plan.moe_pipeline)
    y_buf = kernel_ops.pipelined_ep_ffn(
        buf, lambda b: expert_ffn(b, moe_p["wi_gate"], moe_p["wi_up"], moe_p["wo"], cfg.activation, backend=backend),
        mesh=mesh, chunks=K)
    y = combine(y_buf, fe, pe, keep, fg, T_loc)
    shards = tuple(a for a in mesh.axis_names if a in set(dp_axes(plan)) | set(split) | {ep})
    if want_aux:
        aux = ad.reduce_out(aux.reshape(1), mesh, shards).reshape(()) / plan.axis_size(shards)
    if whole:
        y = ad.shared_out(y, mesh, ep)
    if split:
        y = ad.gather_out(y, mesh, 0, split)
    return y, aux, idx


def _shared_ffn(x_flat, moe_p, cfg: ModelConfig, plan):
    """The shared experts: one GLU FFN, its d_ff sharded on a mesh."""
    tp = plan is not None and plan.divides(cfg.shared_d_ff * cfg.n_shared_experts)
    if tp:
        x_flat = ad.copy_in(x_flat, plan.mesh, plan.ffn_tp_axis)
    y = glu_ffn(x_flat, moe_p["shared_wi_gate"], moe_p["shared_wi_up"], moe_p["shared_wo"], cfg.activation)
    return ad.reduce_out(y, plan.mesh, plan.ffn_tp_axis) if tp else y


def apply_moe(x: torch.Tensor, moe_p: Dict[str, Any], cfg: ModelConfig, backend=None, plan=None,
              want_aux: bool = True) -> MoEOut:
    """x: (B, S, d) -> MoEOut. Routed experts + optional shared experts,
    in the mode ``plan`` selects (None: local). ``want_aux`` False (prefill
    and decode, which drop it) leaves the aux loss None and skips its
    collectives on a mesh.

    When the plan carries an ``ExpertReplication``, token copies are routed
    to replica slots (round-robin over each expert's replicas): the same
    tokens as unreplicated serving whenever capacity drops do not bind,
    since gates never change and replicas share weights."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    if plan is None or plan.is_null:
        y, aux, idx = _moe_local(x_flat, moe_p, cfg, backend=backend, rep=_active_replication(plan),
                                 want_aux=want_aux)
    elif _is_ep(plan):
        y, aux, idx = _moe_ep(x_flat, moe_p, cfg, plan, backend=backend, want_aux=want_aux)
    else:
        y, aux, idx = _moe_local(x_flat, moe_p, cfg, backend=backend, axes=plan.expert_kernel_axes(cfg.moe_d_ff),
                                 rep=_active_replication(plan), plan=plan, want_aux=want_aux)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(x_flat, moe_p, cfg, plan if plan is not None and not plan.is_null else None)
    return MoEOut(y.reshape(B, S, d), aux * cfg.router_aux_loss_coef if want_aux else None, idx)
