"""The stacked-layer decoder (the port of ``repro.models.transformer`` for
the causal text families: attention-only, mamba and hybrid).

JAX scans one layer body over the stacked parameters; here a Python loop
walks the leading L axis. A layer's mixer is attention, the mamba1 SSM
(``mamba``), or both in parallel heads (hybrid), their outputs fused as
``0.5 * (rms_norm(attn) + rms_norm(mamba))``; then the FFN, MoE or nothing.
Entry points:

  prefill           full forward over the prompt: last-position logits plus
                    a primed contiguous decode cache (a new one, or the
                    caller's, filled in place)
  init_paged_cache  an empty block-pooled cache for continuous batching
                    (attention-only models)
  decode_step       one cache-appending step (a token or a prefill chunk),
                    over either layout
  merge_cache_rows  a prefilled request's rows into a live contiguous cache

Each entry point takes a ShardingPlan (``plan``; None is one device). On a
mesh every rank runs the same loop on its shards of the weights and of the
KV cache: the embedding is vocab-parallel (a masked lookup and one
all-reduce), attention and the FFN / MoE sublayers complete their products
with the collectives their mode needs (``attention``, ``moe``), and the
logits of the rank's vocabulary columns are all-gathered, so every rank
holds the whole logits. Mamba layers have no layout on a mesh yet
(ROADMAP A.9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .common import glu_ffn, rms_norm, softcap
from .params import layer_slice, torch_dtype


@dataclasses.dataclass
class DecodeCache:
    """Decode-time state; the fields a family does not use are None (k/v
    without attention, conv/ssm without mamba layers).

    Contiguous: k/v are (L, B, Smax, Hkv, hd) and ``pos`` an int32 tensor
    on the cache's device: 0-dim, the same for every row (a lockstep batch;
    the reference's ``DecodeCache.pos`` is a ``jax.Array`` too), or (B,)
    per row (the contiguous continuous batch). Paged (continuous batching,
    attention-only): k/v are (L, num_blocks, block_size, Hkv, hd) pages
    shared by all rows, ``block_tables`` (B, max_blocks) int32 maps each
    row's logical positions to pages (unused entries point at trash block
    0) and ``pos`` is a (B,) int32 tensor of per-row depths.
    ``prefix_groups`` (2, B) int32, paged only, is the prefix cache's
    grouping (row 0 each row's representative, row 1 its shared leading
    block count); None leaves the prefix kernel off. ``route_topk`` is an
    output only: ``decode_step(..., collect_routing=True)`` returns every
    layer's router top-k ids there, (L, B*C, k) int32. ``conv`` (L, B,
    cw - 1, d_inner) holds each mamba layer's trailing conv inputs and
    ``ssm`` (L, B, d_inner, N) its float32 state.
    """

    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    pos: Union[int, torch.Tensor]
    block_tables: Optional[torch.Tensor] = None
    prefix_groups: Optional[torch.Tensor] = None
    route_topk: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None


def _check_family(cfg: ModelConfig) -> None:
    if not cfg.causal or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-only and audio/vision-input models are not ported to repro_torch yet "
            "(ROADMAP A.7)"
        )
    if cfg.block_type not in ("attention", "mamba", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: block_type {cfg.block_type!r} is unknown")
    glu = cfg.activation in ("silu", "gelu")
    if cfg.ffn_type not in ("moe", "dense", "none") or (cfg.ffn_type == "dense" and not glu):
        raise NotImplementedError(f"{cfg.name}: ffn_type {cfg.ffn_type!r} with {cfg.activation!r} is not ported yet")


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, plan=None) -> torch.Tensor:
    if plan is not None and plan.divides(cfg.vocab_size):
        # vocab-parallel: each rank looks up the tokens of its rows
        rows = params["embed"].shape[0]
        local = tokens - plan.mesh.rank * rows
        mine = (local >= 0) & (local < rows)
        x = params["embed"][torch.where(mine, local, 0)] * mine[..., None].to(params["embed"].dtype)
        plan.mesh.all_reduce(x)
    else:
        x = params["embed"][tokens]
    if cfg.scale_embeddings:
        # the factor rounded to the activation dtype, as a host scalar: a
        # device tensor made here would be a host-to-device copy per step
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype).item()
    return x


def unembed(params, cfg: ModelConfig, hidden: torch.Tensor, plan=None) -> torch.Tensor:
    h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["lm_head"]
    if plan is not None and plan.divides(cfg.vocab_size):
        logits = plan.mesh.all_gather(logits, dim=-1)
    if cfg.final_logit_softcap > 0:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _ffn(x, lp, cfg: ModelConfig, backend=None, plan=None, routes=None) -> Optional[torch.Tensor]:
    """FFN / MoE sublayer on the residual stream, None for a model without
    one (``ffn_type="none"``, whose reference adds zeros); a dense FFN runs
    TP on a mesh (its d_ff sharded, one all-reduce). ``routes``, a list,
    collects the MoE router's top-k ids."""
    if cfg.ffn_type == "none":
        return None
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.ffn_type == "dense":
        out = glu_ffn(h, lp["ffn"]["wi_gate"], lp["ffn"]["wi_up"], lp["ffn"]["wo"], cfg.activation)
        if plan is not None and plan.divides(cfg.d_ff):
            plan.mesh.all_reduce(out)
    else:
        moe_out = moe_mod.apply_moe(h, lp["moe"], cfg, backend=backend, plan=plan)
        out = moe_out.y
        if routes is not None:
            routes.append(moe_out.route_idx)
    if cfg.use_post_norm:
        out = rms_norm(out, lp["ln2_post"], cfg.norm_eps)
    return out


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               plan=None) -> DecodeCache:
    """A contiguous decode cache; on a mesh with ``kv_shard="heads"`` it
    holds this rank's kv heads. Mamba state has no layout on a mesh yet."""
    k = v = conv = ssm = None
    if cfg.has_attention:
        kv_dt = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else dtype
        shape = (cfg.num_layers, batch, max_len, attn_mod.local_kv_heads(cfg, plan), cfg.head_dim)
        k = torch.zeros(shape, dtype=kv_dt, device=device)
        v = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.has_mamba:
        if plan is not None and not plan.is_null:
            raise NotImplementedError(f"{cfg.name}: mamba conv/ssm caches on a mesh are not ported to repro_torch "
                                      "yet (ROADMAP A.9)")
        L = cfg.num_layers
        conv = torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.ssm_d_inner), dtype=dtype, device=device)
        ssm = torch.zeros((L, batch, cfg.ssm_d_inner, cfg.ssm_state), dtype=torch.float32, device=device)
    return DecodeCache(k=k, v=v, conv=conv, ssm=ssm, pos=torch.zeros((), dtype=torch.int32, device=device))


def init_paged_cache(cfg: ModelConfig, nslots: int, num_blocks: int, block_size: int, max_blocks: int,
                     dtype=torch.bfloat16, device=None, plan=None) -> DecodeCache:
    """A block-pooled decode cache (DESIGN.md §4b): K/V pages shared by all
    ``nslots`` rows, addressed through per-row block tables. ``num_blocks``
    includes the reserved trash block 0 (``repro_torch.serving.kv_cache``).
    On a mesh with ``kv_shard="heads"`` the pages hold this rank's kv
    heads; every rank's tables are the same. Attention-only models: mamba
    state is not paged."""
    if not (cfg.has_attention and not cfg.has_mamba):
        raise ValueError(f"{cfg.name}: paged caches cover attention KV only (mamba state is unpaged)")
    kv_dt = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else dtype
    shape = (cfg.num_layers, num_blocks, block_size, attn_mod.local_kv_heads(cfg, plan), cfg.head_dim)
    return DecodeCache(
        k=torch.zeros(shape, dtype=kv_dt, device=device),
        v=torch.zeros(shape, dtype=kv_dt, device=device),
        pos=torch.zeros((nslots,), dtype=torch.int32, device=device),
        block_tables=torch.zeros((nslots, max_blocks), dtype=torch.int32, device=device),
    )


def _fuse(a_out, m_out, lp, cfg: ModelConfig) -> torch.Tensor:
    """A hybrid layer's parallel attention and mamba heads, each normed."""
    return 0.5 * (rms_norm(a_out, lp["fuse_norm_attn"], cfg.norm_eps)
                  + rms_norm(m_out, lp["fuse_norm_mamba"], cfg.norm_eps))


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], max_len: int,
            backend=None, cache: Optional[DecodeCache] = None, plan=None) -> Tuple[torch.Tensor, DecodeCache]:
    """Process the prompt ``batch["tokens"]`` (B, S); return (last-position
    logits (B, V), a cache of ``max_len`` positions primed with the prompt:
    its K/V, and each mamba layer's conv window and SSM state after it).
    ``backend`` selects the kernel path of prefill attention and the expert
    FFNs ("ref" | "hopper" | None for the device's default). ``cache``, a
    contiguous cache of B rows and ``max_len`` positions, is filled in place
    and returned (its tensors, ``pos`` included, keep their storage, so a
    captured step can read them); None makes a new one. Positions past S
    keep what they held: decode reads none of them before writing it."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, batch["tokens"], plan)
    B, S = x.shape[0], x.shape[1]
    if cache is None:
        cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device, plan=plan)
    else:
        shape = tuple((cache.k if cache.k is not None else cache.conv).shape)
        if cache.block_tables is not None or shape[1] != B or (cache.k is not None and shape[2] != max_len):
            raise ValueError(f"prefill fills a contiguous cache of {B} rows x {max_len} positions, got {shape}")
    flags = cfg.global_layer_flags()
    for layer in range(cfg.num_layers):
        lp = layer_slice(params["layers"], layer)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.has_attention:
            a_out, (k, v) = attn_mod.attention_block(
                h, attn_mod.AttnTemps(**lp["attn"]), cfg, flags[layer], return_kv=True, backend=backend, plan=plan
            )
            # in place, layer by layer: JAX wrote the stacked K/V in one update
            cache.k[layer, :, :S] = k.to(cache.k.dtype)
            cache.v[layer, :, :S] = v.to(cache.v.dtype)
        if cfg.has_mamba:
            m_out, state = mamba_mod.mamba_mixer(h, lp["mamba"], cfg)
            cache.conv[layer] = state.conv.to(cache.conv.dtype)
            cache.ssm[layer] = state.ssm
        out = _fuse(a_out, m_out, lp, cfg) if cfg.block_type == "hybrid" else a_out if cfg.has_attention else m_out
        if cfg.use_post_norm:
            out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
        x = x + out
        ffn = _ffn(x, lp, cfg, backend, plan)
        if ffn is not None:
            x = x + ffn
    cache.pos.fill_(S)
    logits = unembed(params, cfg, x[:, -1:, :], plan)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def merge_cache_rows(cache: DecodeCache, sub: DecodeCache, rows: Sequence[int]) -> DecodeCache:
    """Copy ``sub``'s batch rows into the contiguous ``cache`` at slot
    indices ``rows``, in place: the decode-time join (DESIGN.md §4b), where
    a freshly prefilled request's K/V and mamba conv/ssm state replace a
    freed slot's. ``sub`` must have been allocated at the cache's
    ``max_len``. A per-row ``pos`` vector takes ``sub.pos`` at the joined
    rows; a scalar ``pos`` (lockstep batch) is left to the caller. The
    cache's tensors keep their storage, so captured steps that read them
    stay valid. Paged caches take no merge: their rows join by prefill
    chunks through their block tables."""
    if cache.block_tables is not None:
        raise ValueError("merge_cache_rows merges into a contiguous cache; paged rows join by prefill chunks")
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=cache.pos.device)
    for name in ("k", "v", "conv", "ssm"):
        dst = getattr(cache, name)
        if dst is not None:
            dst[:, idx] = getattr(sub, name).to(dst.dtype)
    if cache.pos.ndim:
        cache.pos[idx] = torch.as_tensor(sub.pos, dtype=torch.int32, device=cache.pos.device).expand(idx.shape)
    return cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: DecodeCache,
                backend=None, plan=None, collect_routing: bool = False) -> Tuple[torch.Tensor, DecodeCache]:
    """One cache-appending step: token (B, C) -> (last-position logits
    (B, V), the cache advanced by C). C == 1 is plain decode; C > 1 appends
    a chunk: in lockstep on a contiguous cache, or at each row's own
    position on a paged one (chunked prefill), attention-only (a mamba
    layer steps one token). The cache tensors are updated in place (JAX
    returned new ones); the returned cache shares them, with ``pos + C``.
    Callers that freeze drained rows (the continuous engine) pin ``pos``
    again before the next step.

    ``collect_routing`` (MoE only) stacks every layer's router top-k ids
    and returns them on the new cache's ``route_topk``, (L, B*C, k) int32,
    for the engine's routing tracker. Under EP with the tokens split over
    the ranks, the ranks' shares are all-gathered (once per step), so every
    rank sees every token's choice."""
    _check_family(cfg)
    C = token.shape[1]
    if C != 1 and cfg.has_mamba:
        raise ValueError(f"{cfg.name}: chunked append is attention-only (a mamba layer steps one token), got C={C}")
    routes = [] if collect_routing and cfg.ffn_type == "moe" else None
    x = embed_tokens(params, cfg, token, plan)
    pos = torch.as_tensor(cache.pos, dtype=torch.int32, device=x.device)
    flags = cfg.global_layer_flags()
    for layer in range(cfg.num_layers):
        lp = layer_slice(params["layers"], layer)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.has_attention:
            a_out, _, _ = attn_mod.decode_attention(
                h, attn_mod.AttnTemps(**lp["attn"]), cfg, flags[layer], cache.k[layer], cache.v[layer], pos,
                block_tables=cache.block_tables, prefix_groups=cache.prefix_groups, backend=backend, plan=plan,
            )
        if cfg.has_mamba:
            m_out = mamba_mod.mamba_decode_step(
                h, lp["mamba"], cfg, mamba_mod.MambaCache(conv=cache.conv[layer], ssm=cache.ssm[layer]))
        out = _fuse(a_out, m_out, lp, cfg) if cfg.block_type == "hybrid" else a_out if cfg.has_attention else m_out
        if cfg.use_post_norm:
            out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
        x = x + out
        ffn = _ffn(x, lp, cfg, backend, plan, routes)
        if ffn is not None:
            x = x + ffn
    logits = unembed(params, cfg, x[:, -1:, :], plan)
    route = None
    if routes is not None:
        route = torch.stack(routes).to(torch.int32)
        if moe_mod.ep_token_split(plan, token.shape[0] * C):
            route = plan.mesh.all_gather(route, dim=1)
    return logits[:, 0], dataclasses.replace(cache, pos=cache.pos + C, route_topk=route)
