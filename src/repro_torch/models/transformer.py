"""The stacked-layer decoder (the port of ``repro.models.transformer`` for
attention-only families, one device, contiguous KV cache).

JAX scans one layer body over the stacked parameters; here a Python loop
walks the leading L axis. Entry points:

  prefill      full forward over the prompt: last-position logits plus a
               primed decode cache
  decode_step  one cache-appending step
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn_mod
from . import moe as moe_mod
from .common import glu_ffn, rms_norm, softcap
from .params import layer_slice, torch_dtype


@dataclasses.dataclass
class DecodeCache:
    """Decode-time state of an attention-only model, contiguous layout."""

    k: torch.Tensor  # (L, B, Smax, Hkv, hd)
    v: torch.Tensor
    pos: int  # tokens written so far, the same for every row (lockstep batch)


def _check_family(cfg: ModelConfig) -> None:
    if not cfg.causal or cfg.block_type != "attention" or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the port serves causal attention-only text models so far"
        )
    glu = cfg.activation in ("silu", "gelu")
    if cfg.ffn_type not in ("moe", "dense") or (cfg.ffn_type == "dense" and not glu):
        raise NotImplementedError(f"{cfg.name}: ffn_type {cfg.ffn_type!r} with {cfg.activation!r} is not ported yet")


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def unembed(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["lm_head"]
    if cfg.final_logit_softcap > 0:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _ffn(x, lp, cfg: ModelConfig, backend=None) -> torch.Tensor:
    """FFN / MoE sublayer on the residual stream."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.ffn_type == "dense":
        out = glu_ffn(h, lp["ffn"]["wi_gate"], lp["ffn"]["wi_up"], lp["ffn"]["wo"], cfg.activation)
    else:
        out = moe_mod.apply_moe(h, lp["moe"], cfg, backend=backend).y
    if cfg.use_post_norm:
        out = rms_norm(out, lp["ln2_post"], cfg.norm_eps)
    return out


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> DecodeCache:
    kv_dt = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else dtype
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return DecodeCache(
        k=torch.zeros(shape, dtype=kv_dt, device=device),
        v=torch.zeros(shape, dtype=kv_dt, device=device),
        pos=0,
    )


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], max_len: int,
            backend=None) -> Tuple[torch.Tensor, DecodeCache]:
    """Process the prompt ``batch["tokens"]`` (B, S); return (last-position
    logits (B, V), a cache of ``max_len`` positions primed with the prompt).
    ``backend`` selects the kernel path of prefill attention and the expert
    FFNs ("ref" | "hopper" | None for the device's default)."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device)
    flags = cfg.global_layer_flags()
    for layer in range(cfg.num_layers):
        lp = layer_slice(params["layers"], layer)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, (k, v) = attn_mod.attention_block(
            h, attn_mod.AttnTemps(**lp["attn"]), cfg, flags[layer], return_kv=True, backend=backend
        )
        if cfg.use_post_norm:
            out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
        x = x + out
        x = x + _ffn(x, lp, cfg, backend)
        # in place, layer by layer: JAX wrote the stacked K/V in one update
        cache.k[layer, :, :S] = k.to(cache.k.dtype)
        cache.v[layer, :, :S] = v.to(cache.v.dtype)
    cache.pos = S
    logits = unembed(params, cfg, x[:, -1:, :])
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: DecodeCache,
                backend=None) -> Tuple[torch.Tensor, DecodeCache]:
    """One cache-appending step: token (B, C) -> (last-position logits
    (B, V), the cache advanced by C). C == 1 is plain decode; C > 1 appends
    a lockstep chunk. The cache tensors are updated in place (JAX returned
    new ones); the returned cache shares them with ``pos + C``."""
    _check_family(cfg)
    C = token.shape[1]
    x = embed_tokens(params, cfg, token)
    pos = torch.full((), cache.pos, dtype=torch.int32, device=x.device)
    flags = cfg.global_layer_flags()
    for layer in range(cfg.num_layers):
        lp = layer_slice(params["layers"], layer)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _, _ = attn_mod.decode_attention(
            h, attn_mod.AttnTemps(**lp["attn"]), cfg, flags[layer], cache.k[layer], cache.v[layer], pos,
            backend=backend,
        )
        if cfg.use_post_norm:
            out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
        x = x + out
        x = x + _ffn(x, lp, cfg, backend)
    logits = unembed(params, cfg, x[:, -1:, :])
    return logits[:, 0], DecodeCache(k=cache.k, v=cache.v, pos=cache.pos + C)

