"""Causal prefill attention (flash attention).

``flash_attention`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (the port of ``repro/kernels/flash_attention.py``)
on CUDA tensors, and on CPU tensors, and only there, runs its plain PyTorch
version ``flash_attention_plain``. The kernel takes strides, so callers may
pass transposed views of the model's (B, S, H, hd) layout without a copy;
the result is then a (B, Hq, Sq, hd) view of a (B, Sq, Hq, hd) buffer.

On the card the launch follows a ``FlashPlan`` made here, before the
launch, from the dtype, the head dim and the layout alone: variant
``wgmma`` (bfloat16, a head dim the kernel is built for (``WGMMA_HDS``:
the multiples of 16 up to 128, and 256), every pointer 16-byte aligned and
every stride a multiple of 8 elements, as TMA needs) or ``simt`` (float32,
and the other bfloat16 cases). Each launch adds one to
``_build.LAUNCH_COUNTS["flash_attention"]`` and one to
``_build.VARIANT_COUNTS[("flash_attention", variant)]``. On fake tensors
(the dry run) it returns the fake output and tallies ``work``; nothing is
built or launched.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Optional, Tuple

import torch

from . import _build
from .ref import flash_attention_ref

HD_MAX = 256  # the kernels keep query rows of up to 256 dims in shared memory
WGMMA_HDS = (16, 32, 48, 64, 80, 96, 112, 128, 256)  # the wgmma kernel's instances
BLOCK_Q = 64  # q rows per block, both variants
WGMMA_BLOCK_K, WGMMA_STAGES = 64, 2  # keys per tile, K/V ring depth
SIMT_BLOCK_K = 32


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How one flash-attention call launches: one block per (q tile of
    ``block_q`` rows, q head, batch row), grid (q tiles, Hq, B). The wgmma
    kernel maps block x to q tile ``q tiles - 1 - x``, so the causal tiles
    with the most keys start first; ``block_items`` mirrors both maps."""

    variant: str
    B: int
    Hq: int
    Sq: int
    hd: int
    block_q: int
    block_k: int  # keys per tile (the wgmma N of S = Q K^T)
    stages: int
    grid: Tuple[int, int, int]
    smem_bytes: int

    @property
    def items(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def block_items(self, block: int) -> Tuple[Tuple[int, int, int], ...]:
        """The (q tile, head, batch row) block ``block`` computes (x fastest)."""
        gx, gy, _ = self.grid
        x = block % gx
        return ((gx - 1 - x if self.variant == "wgmma" else x, (block // gx) % gy, block // (gx * gy)),)


def wgmma_smem_bytes(hd: int) -> int:
    """The q tile, two stages of K and V tiles (64 x hd bf16 each), the
    barriers, and 1 KB to align the tiles for the 128-byte swizzle."""
    return 1024 + (1 + 2 * WGMMA_STAGES) * BLOCK_Q * hd * 2 + 64


def simt_smem_bytes(hd: int) -> int:
    """``att_smem_bytes`` of ``csrc/common.cuh``: float32 q rows, K and V
    tiles, scores and row statistics, and the int query positions."""
    rows, tk = BLOCK_Q, SIMT_BLOCK_K
    return 4 * (rows * hd + tk * (hd + 1) + tk * hd + rows * (tk + 1) + 3 * rows) + 4 * rows


def check_plan(plan: FlashPlan) -> None:
    """Raise ValueError for a plan the kernel does not take."""
    _build.check_plan("flash_attention", plan.variant, plan.smem_bytes, plan.block_k)
    if plan.grid != (-(-plan.Sq // BLOCK_Q), plan.Hq, plan.B) or plan.block_q != BLOCK_Q:
        raise ValueError(f"flash_attention: grid {plan.grid} does not cover Sq={plan.Sq} x Hq={plan.Hq} x B={plan.B}")
    if max(plan.Hq, plan.B) > 65535:
        raise ValueError(f"flash_attention: grid {plan.grid} exceeds 65535 blocks in y or z")
    if plan.variant == "wgmma":
        if plan.hd not in WGMMA_HDS or (plan.block_k, plan.stages) != (WGMMA_BLOCK_K, WGMMA_STAGES):
            raise ValueError(f"flash_attention: no wgmma kernel for hd={plan.hd}, {plan.block_k} keys x {plan.stages}")
        if plan.smem_bytes != wgmma_smem_bytes(plan.hd):
            raise ValueError(f"flash_attention: wgmma plan gives {plan.smem_bytes} B, needs {wgmma_smem_bytes(plan.hd)}")
    elif plan.block_k != SIMT_BLOCK_K or plan.smem_bytes != simt_smem_bytes(plan.hd):
        raise ValueError(f"flash_attention: no simt kernel for {plan.block_k} keys, {plan.smem_bytes} B")


@functools.lru_cache(maxsize=1024)
def flash_plan(B: int, Hq: int, Sq: int, hd: int, dtype: torch.dtype, aligned: bool = True) -> FlashPlan:
    """The launch plan for Sq queries of Hq heads of ``hd`` dims over B batch
    rows in ``dtype``; ``aligned``: TMA can describe q, k and v (16-byte
    aligned pointers, strides a multiple of 8 elements)."""
    grid = (-(-Sq // BLOCK_Q), Hq, B)
    if dtype == torch.bfloat16 and aligned and hd in WGMMA_HDS:
        plan = FlashPlan("wgmma", B, Hq, Sq, hd, BLOCK_Q, WGMMA_BLOCK_K, WGMMA_STAGES, grid, wgmma_smem_bytes(hd))
    else:
        plan = FlashPlan("simt", B, Hq, Sq, hd, BLOCK_Q, SIMT_BLOCK_K, 1, grid, simt_smem_bytes(hd))
    check_plan(plan)
    return plan


def _aligned(ptrs, strides, element_size: int) -> bool:
    """Whether TMA can describe the operands: 16-byte aligned starts and
    batch, head and sequence strides that are 16-byte multiples (an OR of
    values that are all multiples of 16 is one too, and of any that is not,
    is not)."""
    bits = functools.reduce(operator.or_, ptrs) | functools.reduce(operator.or_, strides) * element_size
    return bits % 16 == 0


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """The kernel's arithmetic in plain PyTorch: float32 scores, softmax and
    products, output in the input dtype (``ref.flash_attention_ref``)."""
    return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def work(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, hd: int, element_size: int, causal: bool = True,
         window: int = 0) -> Tuple[int, int]:
    """(FLOPs, HBM bytes) of one call: q, k and v read once and o written
    once; 4 flops per (query, valid key, dim). Causal: the queries are the
    last ``Sq`` of ``Sk`` positions and query ``n`` (1-based) has ``n``
    valid keys, at most ``window``."""
    if causal:
        a, b = Sk - Sq + 1, Sk  # the valid keys of the first query and of the last
        if not window or window >= b:
            pairs = (a + b) * (b - a + 1) // 2
        elif window <= a:
            pairs = window * (b - a + 1)
        else:
            pairs = (a + window) * (window - a + 1) // 2 + window * (b - window)
    else:
        pairs = Sq * Sk
    return 4 * hd * B * Hq * pairs, element_size * B * hd * (2 * Sq * Hq + 2 * Sk * Hkv)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention takes q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"GQA needs q heads ({Hq}) to divide over kv heads ({k.shape[1]})")
    if not 0 < hd <= HD_MAX:
        raise ValueError(f"flash_attention supports head_dim 1..{HD_MAX}, got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention needs one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _build.dtype_code(q.dtype)
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands lie on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a dense head dim (stride 1)")
    if max(B, Hq) > 65535:
        raise ValueError(f"flash_attention launches one block row per (head, batch row): B={B}, Hq={Hq} > 65535")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, Hq, Sq, hd)."""
    _check(q, k, v, window)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = hd**-0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if _build.is_fake(q):
        _build.count_traced("flash_attention", (B, Sq, Hq, Hkv, hd, int(window), float(softcap)),
                            *work(B, Hq, Hkv, Sq, Sk, hd, q.element_size(), causal, window))
        return o
    if o.numel() == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    plan = flash_plan(B, Hq, Sq, hd, q.dtype, _aligned(ptrs[:3], strides[:9], q.element_size()))
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_attention_launch(
            *ptrs, _build.dtype_code(q.dtype),
            B, Hq, Hkv, Sq, Sk, hd, *strides, int(causal), int(window), float(softcap), float(scale),
            int(plan.variant == "wgmma"), plan.block_q, plan.block_k, plan.stages, plan.grid[0], plan.smem_bytes,
            stream,
        )
    _build.check(status, "flash_attention")
    _build.count_launch("flash_attention", plan.variant, (B, Sq, Hq, Hkv, hd, int(window), float(softcap)))
    return o
