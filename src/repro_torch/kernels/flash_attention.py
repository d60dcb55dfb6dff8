"""Causal prefill attention (flash attention).

``flash_attention`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (the port of ``repro/kernels/flash_attention.py``)
on CUDA tensors, and on CPU tensors, and only there, runs its plain PyTorch
version ``flash_attention_plain``. The kernel takes strides, so callers may
pass transposed views of the model's (B, S, H, hd) layout without a copy;
the result is then a (B, Hq, Sq, hd) view of a (B, Sq, Hq, hd) buffer.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

HD_MAX = 128  # the kernel keeps query rows of up to 128 dims in shared memory


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """The kernel's arithmetic in plain PyTorch: float32 scores, softmax and
    products, output in the input dtype (``ref.flash_attention_ref``)."""
    return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


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
    if o.numel() == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _build.dtype_code(q.dtype),
            B, Hq, Hkv, Sq, Sk, hd, *strides, int(causal), int(window), float(softcap), float(scale), stream,
        )
    _build.check(status, "flash_attention")
    _build.count_launch("flash_attention")
    return o
