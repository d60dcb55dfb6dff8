"""Prefix-group fused paged append + decode attention: the decode kernel of
the prefix cache.

``prefix_paged_attention`` launches the hand-written Hopper kernel in
``csrc/prefix_paged_attention.cu`` (the port of
``repro/kernels/paged_attention.py::prefix_paged_attention``) on CUDA
tensors, and on CPU tensors, and only there, runs its plain PyTorch version
``prefix_paged_attention_plain``. The pages are updated in place.

The grouping is the engine's contract (DESIGN.md §4d): ``group_reps[b]``
names row b's representative, ``shared_blocks[b]`` how many leading table
entries row b shares with it (the same physical ids), every write lands past
them, and a representative has ``shared_blocks`` 0. The wrapper does not
read the grouping back from the card.

The launch follows ``paged_attention.decode_plan(..., prefix=True)``: the
same variant, splits and workspace as the paged kernel on the same shapes,
plus shared blocks for the groups. Each call counts one launch in
``_build.LAUNCH_COUNTS["prefix_paged_attention"]`` and in
``_build.VARIANT_COUNTS[("prefix_paged_attention", variant)]``. On fake
tensors (the dry run) it tallies the paged kernel's ``work`` and launches
nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .paged_attention import _check as _check_paged
from .paged_attention import aligned, decode_plan, paged_attention_plain, work, workspace


def prefix_paged_attention_plain(
    q, k_pages, v_pages, block_tables, k_new, v_new, pos, group_reps, shared_blocks, is_global=True,
    *, scale=None, softcap=0.0, window=0,
):
    """The kernel's contract in plain PyTorch: route each row's shared
    leading entries through its representative's table, then run
    ``paged_attention_plain``. Under the contract the routed table equals
    the row's own, so the result is exactly the unshared one."""
    j = torch.arange(block_tables.shape[1], device=block_tables.device)[None, :]
    eff = torch.where(j < shared_blocks[:, None], block_tables[group_reps.long()], block_tables)
    return paged_attention_plain(
        q, k_pages, v_pages, eff.contiguous(), k_new, v_new, pos, is_global,
        scale=scale, softcap=softcap, window=window,
    )


def _check(q, k_pages, v_pages, block_tables, k_new, v_new, pos, group_reps, shared_blocks, window) -> None:
    _check_paged(q, k_pages, v_pages, block_tables, k_new, v_new, pos, window)
    B = q.shape[0]
    for name, t in (("group_reps", group_reps), ("shared_blocks", shared_blocks)):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a (B={B},) int32 vector, got {tuple(t.shape)} {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on the operands' device")


def prefix_paged_attention(
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
):
    """Prefix-group fused paged append + decode attention.

    The operands of ``paged_attention`` plus ``group_reps`` and
    ``shared_blocks``, (B,) int32. Returns ``(out (B, C, Hq, hd), k_pages,
    v_pages)``, the pages updated in place; ``out`` equals
    ``paged_attention`` on the rows' own tables.
    """
    _check(q, k_pages, v_pages, block_tables, k_new, v_new, pos, group_reps, shared_blocks, window)
    B, C, Hq, hd = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    if scale is None:
        scale = hd**-0.5
    if q.device.type == "cpu":
        return prefix_paged_attention_plain(
            q, k_pages, v_pages, block_tables, k_new, v_new, pos, group_reps, shared_blocks, is_global,
            scale=scale, softcap=softcap, window=window,
        )
    out = torch.empty_like(q)
    if _build.is_fake(q):  # the shared pages counted as the rows' own: a fake grouping holds no values
        _build.count_traced("prefix_paged_attention", (B, C, Hq, Hkv, hd),
                            *work(B, C, Hq, Hkv, hd, block_tables.shape[1] * bs, q.element_size(), window, is_global))
        return out, k_pages, v_pages
    if out.numel() == 0:
        return out, k_pages, v_pages
    plan = decode_plan(B, C, Hq, Hkv, hd, bs, block_tables.shape[1], q.dtype, True,
                       aligned(q, k_pages, v_pages, k_new, v_new))
    lib = _build.library()
    with torch.cuda.device(q.device):
        ws = workspace(q.device, plan.workspace_floats)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.prefix_paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(), group_reps.data_ptr(),
            shared_blocks.data_ptr(), out.data_ptr(), _build.dtype_code(q.dtype),
            B, C, Hq, Hkv, hd, bs, block_tables.shape[1], 0 if bool(is_global) else int(window),
            float(softcap), float(scale), int(plan.variant == "split"), plan.grid_x, plan.smem_bytes, ws,
            stream,
        )
    _build.check(status, "prefix_paged_attention")
    _build.count_launch("prefix_paged_attention", plan.variant, (B, C, Hq, Hkv, hd))
    return out, k_pages, v_pages
