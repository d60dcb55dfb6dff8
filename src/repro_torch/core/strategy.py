# The port's own copy of repro.core.strategy: the port imports nothing of the JAX package.
"""Parallel-strategy search space (paper §III-C).

Attention module strategies: (A_d, A_t) with A_d * A_t = N — pure DP,
pure TP, and DP x TP hybrids; TP degrees are powers of two.

Expert module strategies: (E_t, E_e) with E_t * E_e = N (E_d = 1: the
paper excludes DP for experts on memory grounds and excludes DP+EP+TP
triples from prior experience) — pure EP, pure TP, and EP x TP hybrids.

Divisibility constraints (Eq. 5): Dim | A_t, N_kv | A_t, N_experts | E_e,
Dim_exp | E_t. For dense models the Expert module degenerates to a single
always-active expert => only TP strategies survive (E_e = 1); for
attention-free SSMs the Attention-module strategies govern the mamba mixer
(heads := d_inner channels). See DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List

from repro_torch.configs.base import ModelConfig


def _parse_degrees(spec: str) -> dict:
    """'DP2xTP2' / 'EP4' / 'TP4' -> {'dp': 2, 'tp': 2} etc. (degree >= 1)."""
    out = {}
    for part in spec.strip().split("x"):
        m = re.fullmatch(r"(DP|TP|EP)(\d+)", part.strip(), re.IGNORECASE)
        if not m:
            raise ValueError(f"bad strategy spec {spec!r} "
                             "(expected e.g. TP4, EP2xTP2, DP2xTP2)")
        key, deg = m.group(1).lower(), int(m.group(2))
        if deg < 1:
            raise ValueError(f"bad strategy spec {spec!r}: degree must "
                             "be >= 1")
        if key in out:
            raise ValueError(f"bad strategy spec {spec!r}: duplicate "
                             f"{key.upper()} axis")
        out[key] = deg
    return out


@dataclasses.dataclass(frozen=True)
class AttnStrategy:
    dp: int
    tp: int

    @property
    def name(self) -> str:
        if self.tp == 1:
            return f"DP{self.dp}"
        if self.dp == 1:
            return f"TP{self.tp}"
        return f"DP{self.dp}xTP{self.tp}"

    @classmethod
    def parse(cls, spec: str) -> "AttnStrategy":
        """Inverse of ``name``: 'DP2xTP2' -> AttnStrategy(dp=2, tp=2)."""
        d = _parse_degrees(spec)
        if "ep" in d:
            raise ValueError(f"attention strategy {spec!r} cannot use EP")
        return cls(dp=d.get("dp", 1), tp=d.get("tp", 1))


@dataclasses.dataclass(frozen=True)
class ExpertStrategy:
    tp: int
    ep: int

    @property
    def name(self) -> str:
        if self.ep == 1:
            return f"TP{self.tp}"
        if self.tp == 1:
            return f"EP{self.ep}"
        return f"EP{self.ep}xTP{self.tp}"

    @classmethod
    def parse(cls, spec: str) -> "ExpertStrategy":
        """Inverse of ``name``: 'EP2xTP2' -> ExpertStrategy(tp=2, ep=2)."""
        d = _parse_degrees(spec)
        if "dp" in d:
            raise ValueError(f"expert strategy {spec!r} cannot use DP "
                             "(excluded on memory grounds, §III-C)")
        return cls(tp=d.get("tp", 1), ep=d.get("ep", 1))


def _pow2_divisors(n: int) -> List[int]:
    out = []
    d = 1
    while d <= n:
        if n % d == 0:
            out.append(d)
        d *= 2
    return out


def attention_strategies(cfg: ModelConfig, n_devices: int
                         ) -> List[AttnStrategy]:
    """All legal (A_d, A_t) pairs for this model on n_devices."""
    out = []
    # effective "head count" constraint: attention heads, or d_inner
    # channel blocks for attention-free mamba mixers.
    if cfg.has_attention:
        dim, nkv = cfg.d_model, cfg.num_kv_heads
        heads = cfg.num_heads
    else:
        dim, nkv, heads = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_inner
    for tp in _pow2_divisors(n_devices):
        dp = n_devices // tp
        if dim % tp or heads % tp:
            continue
        if cfg.has_attention and nkv % tp and tp % nkv:
            continue  # neither shardable nor cleanly replicable
        out.append(AttnStrategy(dp=dp, tp=tp))
    if not out:
        out.append(AttnStrategy(dp=n_devices, tp=1))
    return out


def expert_strategies(cfg: ModelConfig, n_devices: int
                      ) -> List[ExpertStrategy]:
    """All legal (E_t, E_e) pairs. Dense models: only E_e = 1 (pure TP)."""
    out = []
    n_exp = cfg.n_routed_experts if cfg.is_moe else 0
    dim_exp = cfg.moe_d_ff if cfg.is_moe else (cfg.d_ff or cfg.d_model)
    eps = ([e for e in _pow2_divisors(n_devices) if n_exp % e == 0]
           if n_exp else [1])
    for ep in eps:
        tp = n_devices // ep
        if dim_exp and dim_exp % tp:
            continue
        out.append(ExpertStrategy(tp=tp, ep=ep))
    if not out:
        out.append(ExpertStrategy(tp=n_devices, ep=1))
    return out
