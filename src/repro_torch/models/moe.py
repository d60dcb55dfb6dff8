"""Mixture-of-Experts: router, capacity-based dispatch, shared experts (the
port of ``repro.models.moe``, local mode: one device, null plan).

Dispatch is GShard-style with a static capacity
``C = ceil(T * top_k / E * capacity_factor)`` per expert (rounded up to a
multiple of 8): tokens beyond an expert's capacity are dropped. Every
per-expert product goes through the grouped-matmul seam
(``repro_torch.kernels.ops.grouped_matmul``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops

from .common import activation_fn, glu_ffn


class MoEOut(NamedTuple):
    y: torch.Tensor  # (B, S, d)
    aux_loss: torch.Tensor  # scalar load-balance loss
    route_idx: Optional[torch.Tensor] = None  # (B*S, top_k) router top-k ids


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(num_tokens * cfg.top_k / cfg.n_routed_experts * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Top-k routing. x_flat: (T, d) -> gates (T,k), idx (T,k), aux_loss."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss: E * sum(frac_tokens * frac_probs)
    E = cfg.n_routed_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


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


def expert_ffn(buf, wi_gate, wi_up, wo, act_name: str, backend=None) -> torch.Tensor:
    """(E, C, d) x (E, d, f)^2 x (E, f, d) -> (E, C, d), through the
    grouped-matmul seam."""
    act = activation_fn(act_name)
    gate = kernel_ops.grouped_matmul(buf, wi_gate, backend=backend)
    up = kernel_ops.grouped_matmul(buf, wi_up, backend=backend)
    return kernel_ops.grouped_matmul(act(gate) * up, wo, backend=backend)


def _moe_local(x_flat, moe_p, cfg: ModelConfig, backend=None):
    T = x_flat.shape[0]
    E = cfg.n_routed_experts
    C = capacity(T, cfg)
    gates, idx, aux = route(x_flat, moe_p["router"], cfg)
    fe, pe, keep, fg = make_dispatch(idx, gates, E, C)
    buf, _ = dispatch(x_flat, fe, pe, E, C)
    y_buf = expert_ffn(buf, moe_p["wi_gate"], moe_p["wi_up"], moe_p["wo"], cfg.activation, backend=backend)
    y = combine(y_buf, fe, pe, keep, fg, T)
    return y, aux, idx


def apply_moe(x: torch.Tensor, moe_p: Dict[str, Any], cfg: ModelConfig, backend=None) -> MoEOut:
    """x: (B, S, d) -> MoEOut. Routed experts + optional shared experts."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    y, aux, idx = _moe_local(x_flat, moe_p, cfg, backend=backend)
    if cfg.n_shared_experts:
        y = y + glu_ffn(x_flat, moe_p["shared_wi_gate"], moe_p["shared_wi_up"], moe_p["shared_wo"], cfg.activation)
    return MoEOut(y.reshape(B, S, d), aux * cfg.router_aux_loss_coef, idx)
