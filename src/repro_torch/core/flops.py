# The port's own copy of repro.core.flops: the port imports nothing of the JAX package.
"""Per-module FLOPs / bytes / memory models (paper §III-B).

These feed T_cal = (F_module / peak) * eta. All counts are PER LAYER and
GLOBAL unless suffixed _dev (per device under a strategy). ``phase`` is
"prefill" (T = B * s tokens, quadratic attention term over the prompt) or
"decode" (T = B tokens, attention over the KV cache of length s_ctx).

The decode-side EP load-imbalance penalty (paper §III-A2: "load imbalance
introduced by EP leads to inefficient computation ... compared to TP") is
modeled as a max/mean factor for multinomial token->expert assignment:
with mu = T*k/E tokens per expert on average, the busiest of E_e expert
groups sees roughly mu * (1 + c / sqrt(mu_group)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.configs.base import ModelConfig
from .strategy import AttnStrategy, ExpertStrategy

BYTES = {"bf16": 2, "fp16": 2, "f32": 4, "int4": 0.5}


@dataclasses.dataclass(frozen=True)
class Workload:
    batch: int          # sequences
    prompt: int         # prompt length s
    gen: int            # output length S_output
    dtype_bytes: int = 2

    def tokens(self, phase: str) -> int:
        return self.batch * self.prompt if phase == "prefill" else self.batch

    def ctx(self, phase: str) -> float:
        """Average attended context length."""
        if phase == "prefill":
            return self.prompt / 2.0          # causal average
        return self.prompt + self.gen / 2.0   # average cache length


# ---------------------------------------------------------------------------
# attention module
# ---------------------------------------------------------------------------
def attn_flops(cfg: ModelConfig, w: Workload, phase: str) -> float:
    """Global FLOPs of one Attention-module instance (one layer)."""
    T = w.tokens(phase)
    d = cfg.d_model
    f = 0.0
    if cfg.has_attention:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        proj = 2.0 * T * d * (2 * hq * hd + 2 * hkv * hd)
        ctx = w.ctx(phase)
        if cfg.sliding_window and cfg.layer_pattern:
            # average over the local:global pattern
            n_g = sum(1 for c in cfg.layer_pattern if c == "G")
            frac_g = n_g / len(cfg.layer_pattern)
            ctx = frac_g * ctx + (1 - frac_g) * min(ctx, cfg.sliding_window)
        sdpa = 2.0 * 2.0 * T * ctx * hq * hd
        f += proj + sdpa
    if cfg.has_mamba:
        di, n, r = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_dt_rank
        f += 2.0 * T * d * 2 * di            # in_proj
        f += 2.0 * T * di * (r + 2 * n)      # x_proj
        f += 2.0 * T * r * di                # dt_proj
        f += T * di * n * 9                  # scan update (exp, mul, add)
        f += 2.0 * T * di * n                # C readout
        f += 2.0 * T * di * d                # out_proj
    return f


def attn_weight_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    c = cfg.param_counts()
    return c["attn_per_layer"] * dtype_bytes


def kv_bytes_per_layer(cfg: ModelConfig, w: Workload, phase: str) -> float:
    """KV cache bytes touched per decode step (global, one layer)."""
    if not cfg.has_attention:
        # mamba state: d_inner * N float32 + conv window
        return w.batch * (cfg.ssm_d_inner * cfg.ssm_state * 4
                          + (cfg.ssm_conv - 1) * cfg.ssm_d_inner * 2)
    ctx = w.ctx(phase)
    if cfg.sliding_window and cfg.layer_pattern:
        n_g = sum(1 for c in cfg.layer_pattern if c == "G")
        frac_g = n_g / len(cfg.layer_pattern)
        ctx = frac_g * ctx + (1 - frac_g) * min(ctx, cfg.sliding_window)
    per_tok = 2 * cfg.num_kv_heads * cfg.head_dim * w.dtype_bytes
    extra = (cfg.ssm_d_inner * cfg.ssm_state * 4 * w.batch
             if cfg.has_mamba else 0.0)
    return w.batch * ctx * per_tok + extra


def attn_bytes(cfg: ModelConfig, w: Workload, phase: str,
               strat: AttnStrategy) -> float:
    """Per-DEVICE bytes moved by the Attention module (weights + KV)."""
    T = w.tokens(phase)
    wb = attn_weight_bytes(cfg, w.dtype_bytes) / strat.tp
    act = T / strat.dp * cfg.d_model * w.dtype_bytes * 4
    kv = kv_bytes_per_layer(cfg, w, phase) / (strat.dp * strat.tp)
    if phase == "decode":
        return wb + act + kv
    return max(wb, act) + kv  # prefill streams weights once per big tile


def attn_flops_dev(cfg: ModelConfig, w: Workload, phase: str,
                   strat: AttnStrategy) -> float:
    return attn_flops(cfg, w, phase) / (strat.dp * strat.tp)


# ---------------------------------------------------------------------------
# expert module
# ---------------------------------------------------------------------------
def expert_flops(cfg: ModelConfig, w: Workload, phase: str) -> float:
    """Global FLOPs of one Expert-module instance (one layer)."""
    T = w.tokens(phase)
    d = cfg.d_model
    glu_mult = 3 if cfg.activation in ("silu", "gelu") else 2
    if cfg.ffn_type == "dense":
        return 2.0 * T * d * cfg.d_ff * glu_mult
    if cfg.ffn_type == "none":
        return 0.0
    f = 2.0 * T * cfg.top_k * d * cfg.moe_d_ff * glu_mult
    f += 2.0 * T * cfg.n_shared_experts * d * cfg.shared_d_ff * glu_mult
    f += 2.0 * T * d * cfg.n_routed_experts      # router
    return f


def expert_weight_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    c = cfg.param_counts()
    return c["ffn_per_layer"] * dtype_bytes


def ep_imbalance(cfg: ModelConfig, w: Workload, phase: str,
                 ep: int, c_imb: float = 2.0) -> float:
    """Max/mean expert-group load factor for EP degree ``ep``."""
    if ep <= 1 or not cfg.is_moe:
        return 1.0
    T = w.tokens(phase)
    mu_group = T * cfg.top_k / ep    # expected token-copies per EP group
    if mu_group <= 0:
        return float(ep)
    return min(float(ep), 1.0 + c_imb / math.sqrt(mu_group))


def expert_flops_dev(cfg: ModelConfig, w: Workload, phase: str,
                     strat: ExpertStrategy) -> float:
    base = expert_flops(cfg, w, phase) / (strat.tp * strat.ep)
    return base * ep_imbalance(cfg, w, phase, strat.ep)


def expert_active_weight_bytes(cfg: ModelConfig, w: Workload,
                               strat: ExpertStrategy,
                               dtype_bytes: int = 2) -> float:
    """Decode-relevant: bytes of expert weights actually touched per step.

    With few tokens, only ~min(E, T*k) experts activate; under TP every
    device touches its slice of each active expert; under EP the busiest
    device still touches its local active experts.
    """
    if not cfg.is_moe:
        return expert_weight_bytes(cfg, dtype_bytes) / strat.tp
    T = w.tokens("decode")
    E = cfg.n_routed_experts
    active = min(E, T * cfg.top_k)
    glu_mult = 3 if cfg.activation in ("silu", "gelu") else 2
    per_exp = glu_mult * cfg.d_model * cfg.moe_d_ff * dtype_bytes
    shared = (cfg.n_shared_experts * glu_mult * cfg.d_model
              * cfg.shared_d_ff * dtype_bytes)
    active_per_group = min(E // strat.ep, active)
    return (active_per_group * per_exp) / strat.tp + shared / strat.tp


def expert_bytes(cfg: ModelConfig, w: Workload, phase: str,
                 strat: ExpertStrategy) -> float:
    """Per-DEVICE bytes moved by the Expert module."""
    T = w.tokens(phase)
    act = (T * cfg.top_k if cfg.is_moe else T) / strat.ep
    act_bytes = act * cfg.d_model * w.dtype_bytes * 4 / 1  # in+out+hidden
    if phase == "decode":
        wb = expert_active_weight_bytes(cfg, w, strat, w.dtype_bytes)
        return wb + act_bytes
    wb = expert_weight_bytes(cfg, w.dtype_bytes) / (strat.tp * strat.ep)
    return max(wb, act_bytes)


# ---------------------------------------------------------------------------
# memory constraint terms (Eq. 5)
# ---------------------------------------------------------------------------
def memory_terms(cfg: ModelConfig, w: Workload, dtype_bytes: int = 2
                 ) -> Dict[str, float]:
    c = cfg.param_counts()
    L = cfg.num_layers
    m_attn = L * c["attn_per_layer"] * dtype_bytes
    m_exp = L * c["ffn_per_layer"] * dtype_bytes
    m_embed = (c["embed"] + c["lm_head"]) * dtype_bytes
    total_len = w.prompt + w.gen
    if cfg.has_attention:
        m_kv = (L * w.batch * total_len * 2 * cfg.num_kv_heads
                * cfg.head_dim * dtype_bytes)
    else:
        m_kv = L * w.batch * cfg.ssm_d_inner * (cfg.ssm_state * 4 + 8)
    m_act = w.batch * w.prompt * cfg.d_model * dtype_bytes * 6
    return {"attn": m_attn + m_embed, "exp": m_exp, "kv": m_kv,
            "act": m_act}


def memory_feasible(cfg: ModelConfig, w: Workload, a: AttnStrategy,
                    e: ExpertStrategy, n_devices: int,
                    mem_capacity: float, dtype_bytes: int = 2) -> bool:
    """Paper Eq. 5: (M_KV + A_d*M_attn + M_exp)/N + 2*M_act < M_gpu."""
    m = memory_terms(cfg, w, dtype_bytes)
    per_dev = (m["kv"] + a.dp * m["attn"] + m["exp"]) / n_devices \
        + 2.0 * m["act"] / n_devices
    return per_dev < mem_capacity
