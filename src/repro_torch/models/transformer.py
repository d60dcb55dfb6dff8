"""The stacked-layer model (the port of ``repro.models.transformer``):
decoders (attention-only, mamba and hybrid), the encoder-only audio model
and the vision-language model.

JAX scans one layer body over the stacked parameters; here a Python loop
walks the leading L axis, and one layer body (``layer_full``) serves both
the prefill and the training forward, as the reference's does. A layer's
mixer is attention, the mamba1 SSM (``mamba``), or both in parallel heads
(hybrid), their outputs fused as ``0.5 * (rms_norm(attn) + rms_norm(mamba))``;
then the FFN (gated or plain), MoE or nothing. The inputs are token ids,
audio frame embeddings (``features``) or image patch embeddings
(``patches``) ahead of the text, each projected by ``frontend_proj``
(``embed_inputs``). Entry points:

  loss_and_aux      the training objective: next-token (or, encoder-only,
                    per-frame) cross entropy plus the MoE load-balance aux
  forward_hidden    the layer stack over a whole sequence, differentiable
  prefill           full forward over the prompt (decoders): last-position
                    logits plus a primed contiguous decode cache (a new
                    one, or the caller's, filled in place)
  init_paged_cache  an empty block-pooled cache for continuous batching
                    (attention-only models)
  decode_step       one cache-appending step (a token or a prefill chunk),
                    over either layout
  merge_cache_rows  a prefilled request's rows into a live contiguous cache

Each serving entry point takes a ShardingPlan (``plan``; None is one
device). On a mesh every rank runs the same loop on its shards of the
weights and of the KV cache: the embedding is vocab-parallel (a masked
lookup and one all-reduce), attention and the FFN / MoE sublayers complete
their products with the collectives their mode needs (``attention``,
``moe``), and the logits of the rank's vocabulary columns are all-gathered,
so every rank holds the whole logits. A mamba mixer runs tensor-parallel
over d_inner (``mamba``), its conv window and SSM state per rank. The
contiguous KV cache follows the plan's ``kv_shard``: a rank's kv heads,
or under ``seq`` its ``ceil(max_len / n)`` positions of every kv head
(``attention.cache_layout``). Training has no layout on a mesh yet
(ROADMAP A.9).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import seq_positions

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .common import cross_entropy_loss, glu_ffn, plain_ffn, rms_norm, softcap
from .params import layer_slice, layer_slices, torch_dtype


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


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_layers(cfg: ModelConfig) -> None:
    if cfg.block_type not in ("attention", "mamba", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: block_type {cfg.block_type!r} is unknown")
    if cfg.ffn_type not in ("moe", "dense", "none"):
        raise NotImplementedError(f"{cfg.name}: ffn_type {cfg.ffn_type!r} is unknown")
    if cfg.frontend not in ("none", "audio", "vision"):
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} is unknown")


def _check_decoder(cfg: ModelConfig) -> None:
    """prefill and decode_step: decoders only (the reference asserts
    ``cfg.causal`` there)."""
    _check_layers(cfg)
    if not cfg.causal:
        raise ValueError(f"{cfg.name}: prefill/decode only for decoder models (this one is encoder-only; "
                         "it runs through forward_hidden and loss_and_aux)")


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


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], plan=None) -> torch.Tensor:
    """The (B, S, d) input sequence of any modality: audio frames
    (``features`` @ ``frontend_proj``), image patches (``patches`` @
    ``frontend_proj``) ahead of the text's token embeddings, or tokens.
    Frame and patch inputs are cast to the embedding's dtype first."""
    dt = params["embed"].dtype
    if cfg.frontend == "audio":
        return batch["features"].to(dt) @ params["frontend_proj"]
    if cfg.frontend == "vision":
        patches = batch["patches"].to(dt) @ params["frontend_proj"]
        return torch.cat([patches, embed_tokens(params, cfg, batch["tokens"], plan)], dim=1)
    return embed_tokens(params, cfg, batch["tokens"], plan)


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


def _ffn(x, lp, cfg: ModelConfig, backend=None, plan=None, routes=None):
    """FFN / MoE sublayer on the residual stream: (out, MoE aux loss), out
    None for a model without one (``ffn_type="none"``, whose reference
    adds zeros) and aux None without MoE; a dense FFN runs TP on a mesh
    (its d_ff sharded, one all-reduce). ``routes``, a list, collects the
    MoE router's top-k ids."""
    if cfg.ffn_type == "none":
        return None, None
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    aux = None
    if cfg.ffn_type == "dense":
        if cfg.activation in ("silu", "gelu"):
            out = glu_ffn(h, lp["ffn"]["wi_gate"], lp["ffn"]["wi_up"], lp["ffn"]["wo"], cfg.activation)
        else:
            out = plain_ffn(h, lp["ffn"]["wi"], lp["ffn"]["wo"], cfg.activation)
        if plan is not None and plan.divides(cfg.d_ff):
            plan.mesh.all_reduce(out)
    else:
        moe_out = moe_mod.apply_moe(h, lp["moe"], cfg, backend=backend, plan=plan)
        out, aux = moe_out.y, moe_out.aux_loss
        if routes is not None:
            routes.append(moe_out.route_idx)
    if cfg.use_post_norm:
        out = rms_norm(out, lp["ln2_post"], cfg.norm_eps)
    return out, aux


def _fuse(a_out, m_out, lp, cfg: ModelConfig) -> torch.Tensor:
    """A hybrid layer's parallel attention and mamba heads, each normed."""
    return 0.5 * (rms_norm(a_out, lp["fuse_norm_attn"], cfg.norm_eps)
                  + rms_norm(m_out, lp["fuse_norm_mamba"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# one layer over the whole sequence (prefill and training)
# ---------------------------------------------------------------------------
def layer_full(x, lp, flag, cfg: ModelConfig, plan=None, collect_kv: bool = False, backend=None):
    """One layer over the whole sequence: (x, its cache entries or None,
    its MoE aux loss or None). With ``collect_kv`` the entries are a dict:
    the rope'd ``k``/``v`` of an attention mixer, the final ``conv``
    window and ``ssm`` state of a mamba one. Nothing is written in place,
    so autograd can differentiate it; prefill writes the entries into its
    cache."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    kv = {} if collect_kv else None
    if cfg.has_attention:
        a_out = attn_mod.attention_block(h, attn_mod.AttnTemps(**lp["attn"]), cfg, flag, return_kv=collect_kv,
                                         backend=backend, plan=plan)
        if collect_kv:
            a_out, (kv["k"], kv["v"]) = a_out
    if cfg.has_mamba:
        m_out, state = mamba_mod.mamba_mixer(h, lp["mamba"], cfg, plan=plan)
        if collect_kv:
            kv["conv"], kv["ssm"] = state.conv, state.ssm
    out = _fuse(a_out, m_out, lp, cfg) if cfg.block_type == "hybrid" else a_out if cfg.has_attention else m_out
    if cfg.use_post_norm:
        out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
    x = x + out
    ffn, aux = _ffn(x, lp, cfg, backend, plan)
    if ffn is not None:
        x = x + ffn
    return x, kv, aux


# the products ``remat="dots"`` keeps: the plain matmuls (a (B, S, d) @ (d,
# f) product reaches the dispatcher as ``mm``), not the batched ones
# (attention scores, the expert slabs), as
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps them
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def forward_hidden(params, cfg: ModelConfig, x: torch.Tensor, plan=None, collect_kv: bool = False,
                   remat: Union[bool, str] = False, backend="ref"):
    """The layer stack over the whole sequence ``x`` (B, S, d): (hidden,
    the stacked (k, v) of every layer (L, B, S, Hkv, hd) with
    ``collect_kv`` on an attention model, else None, the MoE aux loss
    summed over the layers, float32).

    ``backend`` pins the kernel seam to the plain PyTorch (``ref``) path
    by default, as the reference pins its jnp path: this entry is
    differentiated by training, and the hand-written kernels, like the
    reference's Pallas kernels, define no backward. On the card a training
    step therefore launches no hand kernel; that is the design, not a
    fallback. ``remat=True`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); ``remat="dots"`` keeps the plain matmuls'
    outputs and recomputes the rest, as the reference's
    ``dots_with_no_batch_dims_saveable`` policy does."""
    _check_layers(cfg)
    if plan is not None and not plan.is_null:
        raise not_ported("training on a mesh", "A.9")
    if remat == "dots":
        context = functools.partial(torch_checkpoint.create_selective_checkpoint_contexts, _dots_saveable)
        run = functools.partial(torch_checkpoint.checkpoint, layer_full, use_reentrant=False, context_fn=context)
    elif remat:
        run = functools.partial(torch_checkpoint.checkpoint, layer_full, use_reentrant=False)
    else:
        run = layer_full
    flags = cfg.global_layer_flags()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for layer, lp in enumerate(layer_slices(params["layers"], cfg.num_layers)):
        x, kv, layer_aux = run(x, lp, flags[layer], cfg, plan, collect_kv, backend)
        if layer_aux is not None:
            aux = aux + layer_aux
        if collect_kv and cfg.has_attention:
            ks.append(kv["k"])
            vs.append(kv["v"])
    kvs = (torch.stack(ks), torch.stack(vs)) if ks else None
    return x, kvs, aux


def loss_and_aux(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], plan=None, remat: Union[bool, str] = True):
    """The training objective: (cross entropy + MoE load-balance aux,
    {"ce", "aux"}). Decoders predict ``batch["labels"]`` (B, S); the
    encoder-only model (HuBERT) predicts a codebook label per frame; a
    vision batch's labels cover only the text, the patches being context.
    ``batch["loss_mask"]``, when present, weights the positions."""
    x = embed_inputs(params, cfg, batch, plan)
    h, _, aux = forward_hidden(params, cfg, x, plan, remat=remat)
    if cfg.frontend == "vision":
        h = h[:, -batch["tokens"].shape[1]:, :]
    ce = cross_entropy_loss(unembed(params, cfg, h), batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               plan=None) -> DecodeCache:
    """A contiguous decode cache of ``max_len`` positions. On a mesh it
    holds this rank's part (``attention.cache_layout``): its kv heads under
    ``kv_shard="heads"``, its ``ceil(max_len / n)`` positions of every kv
    head under ``seq``; the mamba conv window and state hold the rank's
    d_inner channels (the reference's ``conv_cache_spec`` /
    ``ssm_cache_spec``)."""
    k = v = conv = ssm = None
    if cfg.has_attention:
        kv_dt = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else dtype
        if attn_mod.cache_layout(cfg, plan, paged=False) == "seq":
            max_len = seq_positions(max_len, plan.mesh.size)
        shape = (cfg.num_layers, batch, max_len, attn_mod.local_kv_heads(cfg, plan), cfg.head_dim)
        k = torch.zeros(shape, dtype=kv_dt, device=device)
        v = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.has_mamba:
        L, di = cfg.num_layers, cfg.ssm_d_inner
        if plan is not None and not plan.is_null and plan.divides(di):
            di //= plan.axis_size(plan.ffn_tp_axis)
        conv = torch.zeros((L, batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device)
        ssm = torch.zeros((L, batch, di, cfg.ssm_state), dtype=torch.float32, device=device)
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


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], max_len: int,
            backend=None, cache: Optional[DecodeCache] = None, plan=None) -> Tuple[torch.Tensor, DecodeCache]:
    """Process the prompt (B, S): ``batch["tokens"]``, and for a vision
    model ``batch["patches"]`` ahead of them (positions 0..S-1 run over
    both); return (last-position logits (B, V), a cache of ``max_len``
    positions primed with the prompt: its K/V, and each mamba layer's conv
    window and SSM state after it). ``backend`` selects the kernel path of
    prefill attention and the expert FFNs ("ref" | "hopper" | None for the
    device's default). ``cache``, a contiguous cache of B rows and
    ``max_len`` positions, is filled in place and returned (its tensors,
    ``pos`` included, keep their storage, so a captured step can read
    them); None makes a new one. Positions past S keep what they held:
    decode reads none of them before writing it. Encoder-only models
    have no prefill."""
    _check_decoder(cfg)
    x = embed_inputs(params, cfg, batch, plan)
    B, S = x.shape[0], x.shape[1]
    seq = attn_mod.cache_layout(cfg, plan, paged=False) == "seq"
    if cache is None:
        cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device, plan=plan)
    else:
        shape = tuple((cache.k if cache.k is not None else cache.conv).shape)
        length = seq_positions(max_len, plan.mesh.size) if seq else max_len
        if cache.block_tables is not None or shape[1] != B or (cache.k is not None and shape[2] != length):
            raise ValueError(f"prefill fills a contiguous cache of {B} rows x {max_len} positions, got {shape}")
    # the prompt positions [lo, hi) this rank's cache holds, from its offset
    lo, hi, off = 0, S, 0
    if seq:
        off = plan.mesh.rank * seq_positions(max_len, plan.mesh.size)
        lo, hi = min(off, S), min(off + cache.k.shape[2], S)
    flags = cfg.global_layer_flags()
    for layer in range(cfg.num_layers):
        x, kv, _ = layer_full(x, layer_slice(params["layers"], layer), flags[layer], cfg, plan, True, backend)
        # in place, layer by layer: JAX wrote the stacked K/V in one update
        if cfg.has_attention:
            cache.k[layer, :, lo - off:hi - off] = kv["k"][:, lo:hi].to(cache.k.dtype)
            cache.v[layer, :, lo - off:hi - off] = kv["v"][:, lo:hi].to(cache.v.dtype)
        if cfg.has_mamba:
            cache.conv[layer] = kv["conv"].to(cache.conv.dtype)
            cache.ssm[layer] = kv["ssm"]
        del kv
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
    _check_decoder(cfg)
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
                h, lp["mamba"], cfg, mamba_mod.MambaCache(conv=cache.conv[layer], ssm=cache.ssm[layer]), plan)
        out = _fuse(a_out, m_out, lp, cfg) if cfg.block_type == "hybrid" else a_out if cfg.has_attention else m_out
        if cfg.use_post_norm:
            out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
        x = x + out
        ffn, _ = _ffn(x, lp, cfg, backend, plan, routes)
        if ffn is not None:
            x = x + ffn
    logits = unembed(params, cfg, x[:, -1:, :], plan)
    route = None
    if routes is not None:
        route = torch.stack(routes).to(torch.int32)
        if moe_mod.ep_token_split(plan, token.shape[0] * C):
            route = plan.mesh.all_gather(route, dim=1)
    return logits[:, 0], dataclasses.replace(cache, pos=cache.pos + C, route_topk=route)
