"""Per-group INT4 dequantization: the resident-INT4 and Eq.-6 restore kernel.

``int4_dequant`` launches the hand-written Hopper kernel in
``csrc/int4_dequant.cu`` (the port of ``repro/kernels/int4_dequant.py``) on
CUDA tensors, and on CPU tensors, and only there, runs its plain PyTorch
version ``int4_dequant_plain``. Both give the numpy dequant of
``repro_torch.core.quantization`` bit for bit. On fake tensors (the dry
run) it returns a fake output and tallies ``work``; nothing is built or
launched.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import int4_dequant_ref


def int4_dequant_plain(packed, scales, zeros, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (``ref.int4_dequant_ref``)."""
    return int4_dequant_ref(packed, scales, zeros, out_dtype=out_dtype)


def work(G: int, gs: int, out_element_size: int) -> Tuple[int, int]:
    """(FLOPs, HBM bytes) of one call: packed bytes, scales and zeros read
    once, the output written once; a multiply and an add per element."""
    return 2 * G * gs, G * gs // 2 + 8 * G + out_element_size * G * gs


def _check(packed: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, out_dtype) -> None:
    if packed.ndim != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"int4_dequant takes packed (G, gs/2) uint8, got {tuple(packed.shape)} {packed.dtype}")
    G = packed.shape[0]
    for name, t in (("scales", scales), ("zeros", zeros)):
        if tuple(t.shape) != (G, 1) or t.dtype != torch.float32:
            raise ValueError(f"int4_dequant takes {name} ({G}, 1) float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != packed.device:
            raise ValueError(f"int4_dequant operands on {packed.device} and {t.device}")
    _build.dtype_code(out_dtype)
    if not (packed.is_contiguous() and scales.is_contiguous() and zeros.is_contiguous()):
        raise ValueError("int4_dequant needs contiguous operands")


def int4_dequant(packed, scales, zeros, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """packed (G, gs/2) uint8 + scales/zeros (G, 1) float32 -> (G, gs)."""
    _check(packed, scales, zeros, out_dtype)
    if packed.device.type == "cpu":
        return int4_dequant_plain(packed, scales, zeros, out_dtype)
    G, half = packed.shape
    out = torch.empty((G, 2 * half), dtype=out_dtype, device=packed.device)
    if _build.is_fake(packed):
        _build.count_traced("int4_dequant", (G, 2 * half, str(out_dtype).split(".")[1]),
                            *work(G, 2 * half, out.element_size()))
        return out
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        status = lib.int4_dequant_launch(
            packed.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
            _build.dtype_code(out_dtype), G, half, stream,
        )
    _build.check(status, "int4_dequant")
    _build.count_launch("int4_dequant", shape=(G, 2 * half, str(out_dtype).split(".")[1]))
    return out
