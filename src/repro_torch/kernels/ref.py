"""Plain PyTorch oracles for the kernel seam (the correctness ground truth).

Each function mirrors ``repro.kernels.ref`` with the same semantics: the
trash block of the paged append, causal-only validity, the ``is_global``
sliding-window switch and logit softcap. The tests hold every function
here against its JAX counterpart in float32. These are also the ``ref``
backend of ``repro_torch.kernels.ops``, which serves them on a CPU tensor
and, only when a caller asks for ``ref`` explicitly, on a CUDA tensor.

Where the JAX references returned new cache arrays, these update the
caller's cache tensors in place and return them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -2.0e38

IntLike = Union[int, torch.Tensor]


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive attention. q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd).

    GQA groups q heads over kv heads; queries align to the END of the kv
    sequence (q_pos = Sk - Sq + i); ``window`` > 0 restricts causal
    attention to a sliding window. Softmax and both products in float32.
    """
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = hd**-0.5
    qf = q.reshape(B, Hkv, G, Sq, hd).float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    if softcap > 0:
        logits = softcap_ref(logits, softcap)
    kpos = torch.arange(Sk, device=q.device)
    qpos = Sk - Sq + torch.arange(Sq, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = kpos[None, :] <= qpos[:, None]
        if window > 0:
            ok &= (qpos[:, None] - kpos[None, :]) < window
    logits = torch.where(ok, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)


def softcap_ref(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# decode attention (contiguous + paged cache-appending steps)
# ---------------------------------------------------------------------------
def _decode_mask_bias(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: int,
    is_global,
    kv_len: Optional[IntLike] = None,
) -> torch.Tensor:
    """Additive causal decode mask in f32: (Sq, Sk) or (B, Sq, Sk) per-row.

    ``q_pos`` is (Sq,) shared or (B, Sq) per-row; ``kv_len`` a scalar or
    (B,) valid-length bound; a true ``is_global`` disables the sliding
    window (global layers).
    """
    qp = q_pos[..., :, None]  # (..., Sq, 1)
    ok = k_pos <= qp
    if window > 0 and not bool(is_global):
        ok = ok & ((qp - k_pos) < window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=k_pos.device)
        if kl.ndim:
            kl = kl[:, None, None]  # (B, 1, 1)
        ok = ok & (k_pos < kl)
    zero = torch.zeros((), dtype=torch.float32, device=k_pos.device)
    return torch.where(ok, zero, NEG_INF)


def decode_attend_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
    is_global=True,
    kv_len: Optional[IntLike] = None,
) -> torch.Tensor:
    """Single-chunk masked attention over a full decode cache.

    q (B, Sq, Hq, hd), k/v (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd). The
    probabilities are rounded to the value dtype for the AV product,
    which accumulates in float32 (the reference's numerics).
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    bias = _decode_mask_bias(q_positions, k_positions, window, is_global, kv_len)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap_ref(logits, softcap)
    logits = logits + (
        bias[None, None, None, :, :] if bias.ndim == 2 else bias[:, None, None, :, :]
    )
    m = logits.amax(dim=-1)  # (B,Hkv,G,Sq)
    p = torch.exp(logits - m[..., None])
    s = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    out = o / torch.clamp(s[..., None], min=1e-30)
    out = out.reshape(B, Hkv, G, Sq, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def _chunk_positions(pos: torch.Tensor, C: int) -> torch.Tensor:
    """Write/query positions for a C-token append: (B, C) or (1, C)."""
    base = pos[:, None] if pos.ndim else pos[None, None]
    return base + torch.arange(C, dtype=torch.int32, device=pos.device)


def paged_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: torch.Tensor,
    is_global=True,
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: int = 0,
    trash_block: int = 0,
):
    """Fused paged append + decode attention (the paged kernel's oracle).

    Scatter the chunk's K/V through each row's block table (positions
    past the table width land in ``trash_block``, never in a live page),
    gather every row's logical view and attend with causality as the only
    validity mask (stale gathered positions always sit above the query
    position). The pages are updated in place; returns
    ``(out, k_pages, v_pages)``.
    """
    B, C = q.shape[0], q.shape[1]
    bs = k_pages.shape[1]
    max_blocks = block_tables.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tables = block_tables.long()
    q_pos = _chunk_positions(pos, C)
    tpos = q_pos.expand(B, C).long()  # write positions
    blk = tpos // bs
    off = tpos % bs
    phys = torch.gather(tables, 1, blk.clamp(0, max_blocks - 1))
    phys = torch.where(blk < max_blocks, phys, trash_block)  # (B, C)
    # in place: the JAX reference returns new page arrays instead
    k_pages[phys, off] = k_new.to(k_pages.dtype)
    v_pages[phys, off] = v_new.to(v_pages.dtype)
    # gather each row's logical view: (B, max_blocks*bs, Hkv, hd)
    k = k_pages[tables].reshape((B, max_blocks * bs) + k_pages.shape[2:])
    v = v_pages[tables].reshape((B, max_blocks * bs) + v_pages.shape[2:])
    k_positions = torch.arange(max_blocks * bs, dtype=torch.int32, device=q.device)
    out = decode_attend_ref(
        q,
        k.to(q.dtype),
        v.to(q.dtype),
        q_pos if pos.ndim else q_pos[0],
        k_positions,
        scale=scale,
        softcap=softcap,
        window=window,
        is_global=is_global,
    )
    return out, k_pages, v_pages


def prefix_paged_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: torch.Tensor,
    group_reps: torch.Tensor,
    shared_blocks: torch.Tensor,
    is_global=True,
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: int = 0,
    trash_block: int = 0,
):
    """Prefix-group paged attention (the prefix kernel's oracle).

    ``group_reps`` (B,) names each row's prefix-group representative (a
    row with no shared prefix is its own) and ``shared_blocks`` (B,) how
    many leading table entries the row shares with it. Under the engine's
    contract (DESIGN.md §4d) those entries hold the same physical ids as
    the representative's and every write lands past them, so routing them
    through the representative's table and deferring to
    ``paged_attention_ref`` gives exactly the unshared result.
    """
    j = torch.arange(block_tables.shape[1], device=block_tables.device)[None, :]
    eff = torch.where(
        j < shared_blocks[:, None], block_tables[group_reps.long()], block_tables
    )
    return paged_attention_ref(
        q, k_pages, v_pages, eff, k_new, v_new, pos, is_global,
        scale=scale, softcap=softcap, window=window, trash_block=trash_block,
    )


def append_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: torch.Tensor,
    is_global=True,
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: int = 0,
):
    """Contiguous-cache append + decode attention.

    k_cache/v_cache: (B, Smax, Hkv, hd). Scalar ``pos`` writes the chunk
    in lockstep at one offset (clamped so the chunk fits, as JAX's
    ``dynamic_update_slice`` does); a (B,) ``pos`` writes each row's
    single token at its own depth (rows whose pos is out of range write
    nowhere). Attention runs over the full cache with a ``pos + C``
    validity bound. The caches are updated in place; returns
    ``(out, k_cache, v_cache)``.
    """
    B, C = q.shape[0], q.shape[1]
    if C > 1 and pos.ndim:
        raise ValueError("contiguous multi-token append is lockstep-only")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    Smax = k_cache.shape[1]
    slots = torch.arange(Smax, dtype=torch.int32, device=q.device)
    # in place: the JAX reference returns new cache arrays instead
    if pos.ndim:
        write = (slots[None, :] == pos[:, None])[:, :, None, None]  # (B,Smax,1,1)
        k_cache.copy_(torch.where(write, k_new.to(k_cache.dtype), k_cache))
        v_cache.copy_(torch.where(write, v_new.to(v_cache.dtype), v_cache))
    else:
        start = pos.clamp(0, Smax - C)
        idx = (start + torch.arange(C, device=q.device)).long()
        k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    q_pos = _chunk_positions(pos, C)
    out = decode_attend_ref(
        q,
        k_cache.to(q.dtype),
        v_cache.to(q.dtype),
        q_pos if pos.ndim else q_pos[0],
        slots,
        scale=scale,
        softcap=softcap,
        window=window,
        is_global=is_global,
        kv_len=pos + C,
    )
    return out, k_cache, v_cache


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f), f32 accumulation, lhs dtype out."""
    return torch.bmm(lhs.float(), rhs.float()).to(lhs.dtype)


def int4_dequant_ref(
    packed: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """Unpack + dequantize per-group INT4.

    packed: (G, gs // 2) uint8, two nibbles per byte (low nibble first).
    scales/zeros: (G, 1) float32. Output: (G, gs) = scales * q + zeros, the
    product and the sum each rounded in float32, then cast to ``out_dtype``.
    """
    low = (packed & 0xF).float()
    high = (packed >> 4).float()
    vals = torch.stack([low, high], dim=-1).reshape(packed.shape[0], -1)
    return (vals * scales + zeros).to(out_dtype)
