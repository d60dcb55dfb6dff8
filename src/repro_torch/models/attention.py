"""Attention: GQA with RoPE, sliding-window / global masks, logit
softcapping, full-sequence prefill and cache-appending decode (the port of
``repro.models.attention``).

Prefill under the ``hopper`` backend runs the flash kernel through
``repro_torch.kernels.ops.flash_attention``; under ``ref`` it runs the
chunked online-softmax path below, whose numerics the reference's greedy
equivalence pins. Decode projects q/k/v and hands the cache-appending step
to ``ops.decode_attention``.

On a mesh (a ShardingPlan) attention in ``tp_heads`` mode runs on this
rank's heads: its columns of wq (and of wk/wv when the kv heads divide the
axis), the kernels on its head shard of the KV cache, then its rows of wo
and one all-reduce (Megatron style). Where the kv heads do not divide, k/v
stay whole on every rank: prefill repeats k/v up to the q heads
(``_maybe_repeat_kv``) and takes the rank's heads. ``replicated``
attention runs whole on every rank.

The decode cache follows the plan's ``kv_shard`` (``cache_layout``): a
heads-sharded cache holds the rank's kv heads; a ``seq`` cache, contiguous
only, holds the rank's share of the positions with every kv head, and
decode merges the ranks' partial softmaxes (``kernels.ops.
seq_decode_attention``; q heads sharded over the ranks are gathered
first); otherwise (a paged pool under ``seq``) the cache is whole on every
rank, and decode under sharded q heads runs the kernel over every q head,
the other ranks' heads zero, and keeps the rank's outputs.

Training runs the same prefill body under autograd: the sharded heads
enter through ``parallel.tp_in`` and their ``wo`` rows leave through
``parallel.tp_out`` (an all-reduce, or a reduce-scatter over the sequence
under ``seq_shard_acts``); replicated k/v beside sharded q heads take
their weights' gradient summed over the model axis, and replicated
attention runs whole on every rank (``parallel.whole_in``/``whole_out``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sharding import autograd as ad
from repro_torch.sharding.specs import seq_sharded, seq_shards

from . import parallel
from .common import apply_rope, softcap

NEG_INF = -2.0e38  # f32-safe mask value


def _repeat_kv_factor(cfg: ModelConfig, plan) -> int:
    """KV replication factor when q heads shard over TP but kv heads do not
    divide the axis: repeat kv up to the q head count (G=1) so that no GQA
    group splits across ranks."""
    if plan is None or plan.is_null or plan.attn_mode != "tp_heads":
        return 1
    tp = plan.axis_size(plan.attn_tp_axis)
    if cfg.num_kv_heads % tp == 0 or cfg.num_heads % tp != 0:
        return 1
    return cfg.num_heads // cfg.num_kv_heads


def _maybe_repeat_kv(k, v, cfg: ModelConfig, plan):
    """Apply ``_repeat_kv_factor`` to a (B, S, Hkv, hd) pair and keep this
    rank's heads of the result."""
    g = _repeat_kv_factor(cfg, plan)
    if g == 1:
        return k, v
    lo, hi = _q_heads(cfg, plan)
    return k.repeat_interleave(g, dim=2)[:, :, lo:hi], v.repeat_interleave(g, dim=2)[:, :, lo:hi]


def _tp(plan) -> bool:
    """Attention runs on this rank's heads."""
    return plan is not None and not plan.is_null and plan.attn_mode == "tp_heads"


def _q_heads(cfg: ModelConfig, plan):
    """This rank's q heads [lo, hi)."""
    if not _tp(plan):
        return 0, cfg.num_heads
    n = cfg.num_heads // plan.axis_size(plan.attn_tp_axis)
    return plan.mesh.rank * n, (plan.mesh.rank + 1) * n


def local_kv_heads(cfg: ModelConfig, plan) -> int:
    """The kv heads this rank's projections and KV cache hold."""
    if _tp(plan) and plan.kv_shard == "heads":
        return cfg.num_kv_heads // plan.axis_size(plan.attn_tp_axis)
    return cfg.num_kv_heads


def cache_layout(cfg: ModelConfig, plan, paged: bool) -> str:
    """What this rank's decode cache holds: ``"heads"`` (its kv heads),
    ``"seq"`` (its share of the positions; a contiguous cache only) or
    ``"none"`` (the whole cache)."""
    if plan is None or plan.is_null or not cfg.has_attention:
        return "none"
    if local_kv_heads(cfg, plan) != cfg.num_kv_heads:
        return "heads"
    return "seq" if seq_sharded(plan) and not paged else "none"


def _out_project(out, w, x, plan, sp: bool = False):
    """(B, S, H_local, hd) -> (B, S, d): this rank's rows of wo, summed
    over the ranks when the heads are sharded (reduce-scattered over the
    sequence under ``sp``)."""
    B, S = out.shape[0], out.shape[1]
    o = out.reshape(B, S, -1).to(x.dtype) @ w.wo
    if _tp(plan):
        return parallel.tp_out(o, plan, sp)
    if parallel.on_mesh(plan):
        return parallel.whole_out(o, plan, sp)
    return o


def _whole_kv(k, v, cfg: ModelConfig, plan):
    """k/v projected on this rank's kv heads, gathered to every kv head
    where the cache holds them all (heads-sharded weights beside a ``seq``
    cache)."""
    if _tp(plan) and k.shape[2] != local_kv_heads(cfg, plan):
        return ad.gather_out(k, plan.mesh, 2), ad.gather_out(v, plan.mesh, 2)
    return k, v


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
    """x: (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), rope applied; the
    head counts are the weights' (this rank's on a mesh)."""
    B, S, _ = x.shape
    q = (x @ w.wq).reshape(B, S, -1, cfg.head_dim)
    k = (x @ w.wk).reshape(B, S, -1, cfg.head_dim)
    v = (x @ w.wv).reshape(B, S, -1, cfg.head_dim)
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
    (Sq, kv_chunk), never (Sq, Sk). Where ``kv_chunk`` does not divide Sk
    the last chunk is shorter (the reference asserts that it divides; a
    vision prompt of 2,880 patches and its text is no multiple of 1024).
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
    o_acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    s_acc = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        sl = slice(c0, c0 + kv_chunk)
        bias = _mask_bias(q_positions, k_positions[sl], cfg, is_global, kv_len)
        o, m, s = _sdpa_chunk(q, k[:, sl], v[:, sl], bias, cfg)
        m_new = torch.maximum(m_acc, m)
        alpha, beta = torch.exp(m_acc - m_new), torch.exp(m - m_new)
        o_acc = o_acc * alpha[..., None] + o * beta[..., None]
        s_acc = s_acc * alpha + s * beta
        m_acc = m_new
    return finish(o_acc, s_acc)


def attention_block(x: torch.Tensor, w: AttnTemps, cfg: ModelConfig, is_global, q_chunk: int = 512,
                    return_kv: bool = False, backend=None, plan=None, sp: bool = False):
    """Full-sequence attention (prefill and training): (B,S,d) -> (B,S,d),
    each sequence-sharded over the model axis under ``sp``.

    ``return_kv=True`` also returns the rope'd K/V to seed the decode cache
    (before any kv repetition: the heads the cache holds).
    """
    if _tp(plan):
        x = parallel.tp_in(x, plan, sp)
        if w.wk.shape[-1] == cfg.num_kv_heads * cfg.head_dim and plan.axis_size(plan.attn_tp_axis) > 1:
            # whole k/v beside this rank's q heads: each rank's gradient is its heads' part
            w = w._replace(wk=ad.copy_in(w.wk, plan.mesh), wv=ad.copy_in(w.wv, plan.mesh))
    elif parallel.on_mesh(plan):
        x = parallel.whole_in(x, plan, sp)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = qkv_project(x, w, cfg, positions[None, :])
    kv_out = _whole_kv(k, v, cfg, plan) if return_kv else None
    k, v = _maybe_repeat_kv(k, v, cfg, plan)
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
    o = _out_project(out, w, x, plan, sp)
    if return_kv:
        return o, kv_out
    return o


def decode_attention(x: torch.Tensor, w: AttnTemps, cfg: ModelConfig, is_global, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, block_tables=None, prefix_groups=None, backend=None,
                     plan=None) -> tuple:
    """Cache-appending attention: one decode token (C == 1) or a chunk
    written at ``pos .. pos+C-1``.

    x: (B, C, d); ``pos`` an int or an int32 tensor, a scalar (lockstep) or
    (B,) per row. Caches are contiguous (B, Smax, Hkv, hd) when
    ``block_tables`` is None (per-row positions then take C == 1), else
    (N, bs, Hkv, hd) pages addressed through the (B, max_blocks) table;
    ``prefix_groups`` (2, B) routes shared prefix blocks through their
    group representative's table (paged only). The caches are updated in
    place. Returns (out (B,C,d), k_cache, v_cache).
    """
    B, C = x.shape[0], x.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    base = pos[:, None] if pos.ndim else pos[None, None]
    q_pos = base + torch.arange(C, dtype=torch.int32, device=x.device)  # (B|1, C)
    q, k_new, v_new = qkv_project(x, w, cfg, q_pos)
    if block_tables is None and seq_sharded(plan):
        # the rank's positions of every kv head: every q head attends them
        if _tp(plan):
            q = plan.mesh.all_gather(q, dim=2)
        k_new, v_new = _whole_kv(k_new, v_new, cfg, plan)
        out, k_cache, v_cache = kernel_ops.seq_decode_attention(
            q, k_cache, v_cache, k_new, v_new, pos, plan.mesh, scale=_scale(cfg), softcap=cfg.attn_logit_softcap,
            window=cfg.sliding_window, is_global=is_global, shard=seq_shards(plan),
        )
        if _tp(plan):
            lo, hi = _q_heads(cfg, plan)
            out = out[:, :, lo:hi]
        return _out_project(out, w, x, plan), k_cache, v_cache
    # heads sharded, but not the cache (its kv heads do not divide the axis)
    padded = _tp(plan) and plan.decode_kernel_axes(cfg.num_heads, cfg.num_kv_heads) is None
    if padded:
        # the whole cache: every q head through the kernel, the other ranks' zero
        lo, hi = _q_heads(cfg, plan)
        q = torch.nn.functional.pad(q, (0, 0, lo, cfg.num_heads - hi))
    out, k_cache, v_cache = kernel_ops.decode_attention(
        q, k_cache, v_cache, k_new, v_new, pos, block_tables=block_tables, prefix_groups=prefix_groups,
        scale=_scale(cfg), softcap=cfg.attn_logit_softcap, window=cfg.sliding_window, is_global=is_global,
        backend=backend,
    )
    if padded:
        out = out[:, :, lo:hi]
    return _out_project(out, w, x, plan), k_cache, v_cache
