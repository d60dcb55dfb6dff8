"""Model configuration system (the port's own copy of ``repro.configs.base``).

The port imports nothing of the JAX package, so it keeps this copy; the
tests hold it equal, field for field, to the reference. Every
architecture is described by a single ``ModelConfig`` dataclass. One file
per ported architecture lives next to this module;
``repro_torch.configs.get_config(name)`` resolves them through the
registry.

Design notes
------------
- ``block_type`` selects the layer mixer family:
    * ``"attention"``  - standard (GQA) attention transformer layer
    * ``"mamba"``      - mamba1 SSM mixer (attention-free)
    * ``"hybrid"``     - parallel attention + mamba heads (hymba-style)
- ``ffn_type`` selects the feed-forward family:
    * ``"dense"``  - a single FFN (SwiGLU/GeGLU/GELU by ``activation``)
    * ``"moe"``    - routed experts (+ optional shared experts)
    * ``"none"``   - no FFN at all (mamba1 layers have none)
- All layer stacks are uniform in weight *shapes* so that parameters can be
  stacked along a leading layer axis (the port loops over it in Python).
  Per-layer heterogeneity (local vs global attention) is expressed via a
  static per-layer pattern (``layer_pattern``) that turns into one bool
  per layer driving mask selection, not into different weight shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""                 # citation (paper / model card)

    # -- core dimensions ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 512
    vocab_size: int = 32000
    num_heads: int = 8
    num_kv_heads: int = 8            # GQA: kv heads <= q heads
    head_dim: int = 0                # 0 => d_model // num_heads
    d_ff: int = 2048                 # dense FFN intermediate (or per-expert)

    # -- mixer selection ---------------------------------------------------
    block_type: str = "attention"    # attention | mamba | hybrid
    ffn_type: str = "dense"          # dense | moe | none
    causal: bool = True              # False => encoder-only (hubert)

    # -- attention variants -------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 => full attention
    # layer_pattern: string of 'L' (local/sliding) and 'G' (global), cycled
    # over layers; empty => all global.
    layer_pattern: str = ""
    attn_logit_softcap: float = 0.0  # gemma2-style, 0 => off
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: float = 0.0  # 0 => 1/sqrt(head_dim)

    # -- FFN variants --------------------------------------------------------
    activation: str = "silu"         # silu (SwiGLU) | gelu (GeGLU) | gelu_plain

    # -- MoE -----------------------------------------------------------------
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert intermediate; 0 => d_ff
    shared_d_ff: int = 0             # shared-expert intermediate; 0 => moe_d_ff
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # dense FFN layers interleaved with MoE layers (deepseek uses 1 dense
    # first layer; we keep stacks uniform => model it as shared experts).

    # -- SSM (mamba1) --------------------------------------------------------
    ssm_state: int = 0               # N (state size per channel)
    ssm_d_inner: int = 0             # 0 => 2 * d_model
    ssm_conv: int = 4
    ssm_dt_rank: int = 0             # 0 => ceil(d_model / 16)

    # -- modality frontend stubs --------------------------------------------
    # audio: inputs are precomputed frame embeddings (B, S, frontend_dim)
    # vlm:   text tokens + precomputed patch embeddings (B, n_patches, vision_dim)
    frontend: str = "none"           # none | audio | vision
    frontend_dim: int = 0            # embedding dim produced by the stub
    num_patches: int = 0             # vlm: patches per image (anyres tiles)

    # -- norms / misc --------------------------------------------------------
    norm_eps: float = 1e-6
    use_post_norm: bool = False      # gemma2/3 extra post-block norms
    scale_embeddings: bool = False   # gemma family: embed * sqrt(d_model)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # decode KV cache storage dtype; "float8_e4m3fn" halves the decode
    # memory roofline term (beyond-paper optimization, see EXPERIMENTS §Perf)
    kv_cache_dtype: str = ""         # "" => same as dtype

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.block_type in ("attention", "hybrid"):
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ffn_type == "moe":
            if self.moe_d_ff == 0:
                object.__setattr__(self, "moe_d_ff", self.d_ff)
            if self.shared_d_ff == 0:
                object.__setattr__(self, "shared_d_ff", self.moe_d_ff)
        if self.block_type in ("mamba", "hybrid"):
            if self.ssm_d_inner == 0:
                object.__setattr__(self, "ssm_d_inner", 2 * self.d_model)
            if self.ssm_dt_rank == 0:
                object.__setattr__(self, "ssm_dt_rank",
                                   max(1, math.ceil(self.d_model / 16)))

    # -- derived -------------------------------------------------------------
    @property
    def has_attention(self) -> bool:
        return self.block_type in ("attention", "hybrid")

    @property
    def has_mamba(self) -> bool:
        return self.block_type in ("mamba", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.ffn_type == "moe"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_is_global(self, layer_idx: int) -> bool:
        """Static local/global pattern lookup (compile-time known)."""
        if not self.layer_pattern or self.sliding_window == 0:
            return True
        pat = self.layer_pattern
        return pat[layer_idx % len(pat)] == "G"

    def global_layer_flags(self) -> Tuple[bool, ...]:
        return tuple(self.layer_is_global(i) for i in range(self.num_layers))

    # -- parameter counting (used by HAP memory/FLOPs models and tests) ------
    def param_counts(self) -> Dict[str, int]:
        """Exact per-component parameter counts (per layer where noted)."""
        d, hd = self.d_model, self.head_dim
        counts: Dict[str, int] = {}
        counts["embed"] = self.vocab_size * d
        counts["lm_head"] = 0 if self.tie_embeddings else self.vocab_size * d
        attn = 0
        if self.has_attention:
            attn += d * self.num_heads * hd          # q
            attn += 2 * d * self.num_kv_heads * hd   # k, v
            attn += self.num_heads * hd * d          # o
        mamba = 0
        if self.has_mamba:
            di, n, r = self.ssm_d_inner, self.ssm_state, self.ssm_dt_rank
            mamba += d * 2 * di                      # in_proj (x, z)
            mamba += self.ssm_conv * di              # depthwise conv
            mamba += di * (r + 2 * n)                # x_proj -> dt, B, C
            mamba += r * di + di                     # dt_proj
            mamba += di * n + di                     # A_log, D
            mamba += di * d                          # out_proj
        counts["attn_per_layer"] = attn + mamba
        glu = self.activation in ("silu", "gelu")
        mult = 3 if glu else 2
        if self.ffn_type == "dense":
            counts["ffn_per_layer"] = mult * d * self.d_ff
        elif self.ffn_type == "moe":
            routed = self.n_routed_experts * mult * d * self.moe_d_ff
            shared = self.n_shared_experts * mult * d * self.shared_d_ff
            router = d * self.n_routed_experts
            counts["ffn_per_layer"] = routed + shared + router
        else:
            counts["ffn_per_layer"] = 0
        counts["norms_per_layer"] = (4 if self.use_post_norm else 2) * d
        counts["per_layer"] = (counts["attn_per_layer"] + counts["ffn_per_layer"]
                               + counts["norms_per_layer"])
        counts["total"] = (counts["embed"] + counts["lm_head"] + d
                           + self.num_layers * counts["per_layer"])
        return counts

    def total_params(self) -> int:
        return self.param_counts()["total"]

    def active_params_per_token(self) -> int:
        """Activated parameters per token (MoE: only top-k + shared)."""
        c = self.param_counts()
        if not self.is_moe:
            return c["total"]
        d = self.d_model
        glu = self.activation in ("silu", "gelu")
        mult = 3 if glu else 2
        active_ffn = (self.top_k * mult * d * self.moe_d_ff
                      + self.n_shared_experts * mult * d * self.shared_d_ff
                      + d * self.n_routed_experts)
        per_layer = c["attn_per_layer"] + active_ffn + c["norms_per_layer"]
        return c["embed"] + c["lm_head"] + d + self.num_layers * per_layer

    # -- reduced variant for CPU smoke tests ---------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant: <=2 layers, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        hd = min(self.head_dim, 64) if self.head_dim else 0
        kw: Dict = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            vocab_size=min(self.vocab_size, 512),
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            ssm_d_inner=min(self.ssm_d_inner, 2 * d) if self.ssm_d_inner else 0,
            ssm_dt_rank=0,
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
        )
        if self.is_moe:
            kw.update(
                n_routed_experts=min(self.n_routed_experts, 4),
                n_shared_experts=min(self.n_shared_experts, 1),
                top_k=min(self.top_k, 2),
                moe_d_ff=min(self.moe_d_ff, 128),
                shared_d_ff=min(self.shared_d_ff, 128),
            )
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # noqa: F401 - populate registry lazily
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> Tuple[str, ...]:
    from . import _load_all
    _load_all()
    return tuple(sorted(_REGISTRY))
