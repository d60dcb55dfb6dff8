"""Fused paged append + decode attention: the decode kernel.

``paged_attention`` launches the hand-written Hopper kernel in
``csrc/paged_attention.cu`` (the port of
``repro/kernels/paged_attention.py::paged_attention``) on CUDA tensors, and
on CPU tensors, and only there, runs its plain PyTorch version
``paged_attention_plain``. The pages are updated in place (the TPU kernel
aliased its page outputs to its page inputs for the same effect).

The block-table ids are the caller's contract: each must name a page of
the pool. The serving path builds them itself (an identity table for a
contiguous cache), so the wrapper does not read them back from the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import NEG_INF, softcap_ref

HD_MAX = 128


def paged_attention_plain(
    q, k_pages, v_pages, block_tables, k_new, v_new, pos, is_global=True, *, scale=None, softcap=0.0, window=0
):
    """The kernel's contract in plain PyTorch, float32 throughout.

    Chunk token c of row b is written at logical position pos[b] + c
    through the row's table (positions past the table width are dropped),
    then every query attends causally over the row's logical view.
    """
    B, C, Hq, hd = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    n_blocks = block_tables.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = hd**-0.5
    tables = block_tables.long()
    tpos = pos.long()[:, None] + torch.arange(C, device=q.device)  # (B, C)
    live = (tpos >= 0) & (tpos < n_blocks * bs)
    phys = torch.gather(tables, 1, (tpos // bs).clamp(0, n_blocks - 1))
    rows, toks = live.nonzero(as_tuple=True)
    k_pages[phys[live], (tpos % bs)[live]] = k_new[rows, toks].to(k_pages.dtype)
    v_pages[phys[live], (tpos % bs)[live]] = v_new[rows, toks].to(v_pages.dtype)
    k = k_pages[tables].reshape(B, n_blocks * bs, Hkv, hd).float()
    v = v_pages[tables].reshape(B, n_blocks * bs, Hkv, hd).float()
    qg = q.reshape(B, C, Hkv, G, hd).float()
    logits = torch.einsum("bckgd,bskd->bkgcs", qg, k) * scale
    if softcap > 0:
        logits = softcap_ref(logits, softcap)
    kpos = torch.arange(n_blocks * bs, device=q.device)
    ok = kpos <= tpos[:, :, None]  # (B, C, S)
    if window > 0 and not bool(is_global):
        ok &= (tpos[:, :, None] - kpos) < window
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", p, v).reshape(B, C, Hq, hd)
    return out.to(q.dtype), k_pages, v_pages


def _check(q, k_pages, v_pages, block_tables, k_new, v_new, pos, window) -> None:
    if q.ndim != 4 or k_pages.ndim != 4:
        raise ValueError(
            f"paged_attention takes q (B, C, Hq, hd) and pages (N, bs, Hkv, hd); got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}"
        )
    B, C, Hq, hd = q.shape
    N, bs, Hkv, hd_p = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_p != hd:
        raise ValueError(f"page shapes {tuple(k_pages.shape)}, {tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if k_new.shape != (B, C, Hkv, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be {(B, C, Hkv, hd)}, got {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs q heads ({Hq}) to divide over kv heads ({Hkv})")
    if not 0 < hd <= HD_MAX:
        raise ValueError(f"paged_attention supports head_dim 1..{HD_MAX}, got {hd}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or block_tables.shape[1] == 0:
        raise ValueError(f"block_tables must be (B={B}, max_blocks >= 1), got {tuple(block_tables.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be a (B,) vector (broadcast scalars), got {tuple(pos.shape)}")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"block_tables and pos must be int32, got {block_tables.dtype}, {pos.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype == k_new.dtype == v_new.dtype):
        raise ValueError("paged_attention needs q, pages and new K/V in one dtype")
    _build.dtype_code(q.dtype)
    tensors = (q, k_pages, v_pages, block_tables, k_new, v_new, pos)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous operands")
    if max(t.numel() for t in tensors) > 2**31 - 1 or block_tables.shape[1] * bs > 2**31 - 1:
        raise ValueError("paged_attention operand too large for 32-bit sizes")
    if B > 65535:
        raise ValueError(f"paged_attention launches one block row per batch row: B={B} > 65535")


def paged_attention(
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
):
    """Fused paged append + decode attention.

    q: (B, C, Hq, hd) rope'd queries; k_pages/v_pages: (N, bs, Hkv, hd)
    shared physical pages; block_tables: (B, max_blocks) int32; k_new/v_new:
    (B, C, Hkv, hd) rope'd chunk K/V; pos: (B,) int32 write positions;
    ``is_global`` (a bool) switches the sliding window off. Returns
    ``(out (B, C, Hq, hd), k_pages, v_pages)``, the pages updated in place.
    """
    _check(q, k_pages, v_pages, block_tables, k_new, v_new, pos, window)
    B, C, Hq, hd = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    if scale is None:
        scale = hd**-0.5
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, k_new, v_new, pos, is_global,
            scale=scale, softcap=softcap, window=window,
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out, k_pages, v_pages
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(), out.data_ptr(), _build.dtype_code(q.dtype),
            B, C, Hq, Hkv, hd, bs, block_tables.shape[1], 0 if bool(is_global) else int(window),
            float(softcap), float(scale), stream,
        )
    _build.check(status, "paged_attention")
    _build.LAUNCH_COUNTS["paged_attention"] += 1
    return out, k_pages, v_pages
