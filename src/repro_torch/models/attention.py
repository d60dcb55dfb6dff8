"""Attention: GQA with RoPE, sliding-window / global masks, logit
softcapping, full-sequence prefill and cache-appending decode (the port of
``repro.models.attention``, null plan: one device).

Prefill under the ``hopper`` backend runs the flash kernel through
``repro_torch.kernels.ops.flash_attention``; under ``ref`` it runs the
chunked online-softmax path below, whose numerics the reference's greedy
equivalence pins. Decode projects q/k/v and hands the cache-appending step
to ``ops.decode_attention``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops

from .common import apply_rope, softcap

NEG_INF = -2.0e38  # f32-safe mask value


class AttnTemps(NamedTuple):
    """Per-layer attention weights, already unstacked (no leading L)."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor


def _scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar > 0:
        return cfg.query_pre_attn_scalar**-0.5
    return cfg.head_dim**-0.5


def qkv_project(x: torch.Tensor, w: AttnTemps, cfg: ModelConfig, positions: torch.Tensor):
    """x: (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), rope applied."""
    B, S, _ = x.shape
    q = (x @ w.wq).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ w.wk).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ w.wv).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos, k_pos, cfg: ModelConfig, is_global, kv_len=None) -> torch.Tensor:
    """Additive mask bias in f32: (Sq, Sk), or (B, Sq, Sk) per-row.

    Causal models: k_pos <= q_pos; a sliding window applies when the layer
    is not global; encoder-only configs attend bidirectionally; ``kv_len``
    (a scalar or (B,)) bounds the valid length.
    """
    qp = q_pos[..., :, None]  # (..., Sq, 1)
    ok = torch.ones(qp.shape[:-1] + k_pos.shape, dtype=torch.bool, device=k_pos.device)
    if cfg.causal:
        ok = k_pos <= qp
        if cfg.sliding_window > 0 and not bool(is_global):
            ok = ok & ((qp - k_pos) < cfg.sliding_window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=k_pos.device)
        if kl.ndim:
            kl = kl[:, None, None]  # (B, 1, 1)
        ok = ok & (k_pos < kl)
    zero = torch.zeros((), dtype=torch.float32, device=k_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _sdpa_chunk(q, k, v, bias, cfg: ModelConfig):
    """q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd), bias (Sq,Sk) or (B,Sq,Sk)
    -> (unnormalized out, row_max, row_sum) for an online-softmax combine."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * _scale(cfg)
    if cfg.attn_logit_softcap > 0:
        logits = softcap(logits, cfg.attn_logit_softcap)
    logits = logits + (bias[None, None, None, :, :] if bias.ndim == 2 else bias[:, None, None, :, :])
    m = logits.amax(dim=-1)  # (B,Hkv,G,Sq)
    p = torch.exp(logits - m[..., None])
    s = p.sum(dim=-1)
    # probabilities rounded to the value dtype for the AV product, which
    # accumulates in float32 (the reference's numerics)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return o, m, s


def full_attention(q, k, v, cfg: ModelConfig, is_global, q_positions, k_positions, kv_len=None,
                   kv_chunk: int = 1024) -> torch.Tensor:
    """Attention over KV chunks with an online softmax.

    q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd); score tiles are
    (Sq, kv_chunk), never (Sq, Sk).
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv

    def finish(o, s):
        out = o / torch.clamp(s[..., None], min=1e-30)
        return out.reshape(B, Hkv, G, Sq, hd).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)

    if Sk <= kv_chunk:
        bias = _mask_bias(q_positions, k_positions, cfg, is_global, kv_len)
        o, _, s = _sdpa_chunk(q, k, v, bias, cfg)
        return finish(o, s)
    if Sk % kv_chunk:
        raise ValueError(f"kv length {Sk} must be divisible by kv_chunk {kv_chunk}")
    o_acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    s_acc = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    for c in range(Sk // kv_chunk):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        bias = _mask_bias(q_positions, k_positions[sl], cfg, is_global, kv_len)
        o, m, s = _sdpa_chunk(q, k[:, sl], v[:, sl], bias, cfg)
        m_new = torch.maximum(m_acc, m)
        alpha, beta = torch.exp(m_acc - m_new), torch.exp(m - m_new)
        o_acc = o_acc * alpha[..., None] + o * beta[..., None]
        s_acc = s_acc * alpha + s * beta
        m_acc = m_new
    return finish(o_acc, s_acc)


def attention_block(x: torch.Tensor, w: AttnTemps, cfg: ModelConfig, is_global, q_chunk: int = 512,
                    return_kv: bool = False, backend=None):
    """Full-sequence attention (prefill): (B,S,d) -> (B,S,d).

    ``return_kv=True`` also returns the rope'd K/V to seed the decode cache.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = qkv_project(x, w, cfg, positions[None, :])
    kv_out = (k, v) if return_kv else None
    be = kernel_ops.resolve_backend(backend, x.device)
    if be is kernel_ops.KernelBackend.HOPPER and cfg.causal:
        out = kernel_ops.flash_attention(
            q, k, v, is_global=is_global, window=cfg.sliding_window,
            softcap=cfg.attn_logit_softcap, scale=_scale(cfg), backend=be,
        )
    else:
        kernel_ops.record("prefill.ref")
        if S > q_chunk and S % q_chunk == 0:
            out = torch.cat(
                [
                    full_attention(q[:, i : i + q_chunk], k, v, cfg, is_global, positions[i : i + q_chunk], positions)
                    for i in range(0, S, q_chunk)
                ],
                dim=1,
            )
        else:
            out = full_attention(q, k, v, cfg, is_global, positions, positions)
    o = out.reshape(B, S, -1).to(x.dtype) @ w.wo
    if return_kv:
        return o, kv_out
    return o


def decode_attention(x: torch.Tensor, w: AttnTemps, cfg: ModelConfig, is_global, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, backend=None) -> tuple:
    """Cache-appending attention over a contiguous cache: one decode token
    (C == 1) or a lockstep chunk written at ``pos .. pos+C-1``.

    x: (B, C, d); caches (B, Smax, Hkv, hd), updated in place; ``pos`` an
    int or an int32 tensor (a scalar, or (B,) per row with C == 1).
    Returns (out (B,C,d), k_cache, v_cache).
    """
    B, C = x.shape[0], x.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    base = pos[:, None] if pos.ndim else pos[None, None]
    q_pos = base + torch.arange(C, dtype=torch.int32, device=x.device)  # (B|1, C)
    q, k_new, v_new = qkv_project(x, w, cfg, q_pos)
    out, k_cache, v_cache = kernel_ops.decode_attention(
        q, k_cache, v_cache, k_new, v_new, pos, scale=_scale(cfg),
        softcap=cfg.attn_logit_softcap, window=cfg.sliding_window, is_global=is_global, backend=backend,
    )
    o = out.reshape(B, C, -1).to(x.dtype) @ w.wo
    return o, k_cache, v_cache
