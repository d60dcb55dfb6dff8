"""Grouped (per-expert) matmul: the expert FFN kernel.

``grouped_matmul`` launches the hand-written Hopper kernel in
``csrc/grouped_matmul.cu`` (the port of ``repro/kernels/grouped_matmul.py``)
on a CUDA tensor, and on a CPU tensor, and only there, runs its plain
PyTorch version ``grouped_matmul_plain``.
"""

from __future__ import annotations

import torch

from . import _build

_INT_MAX = 2**31 - 1


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f): float32 products and sums, output
    in the lhs dtype (the kernel's arithmetic)."""
    return torch.bmm(lhs.float(), rhs.float()).to(lhs.dtype)


def _check(lhs: torch.Tensor, rhs: torch.Tensor) -> None:
    if lhs.ndim != 3 or rhs.ndim != 3:
        raise ValueError(f"grouped_matmul takes (E, C, d) x (E, d, f), got {tuple(lhs.shape)} x {tuple(rhs.shape)}")
    if lhs.shape[0] != rhs.shape[0] or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul shapes do not chain: {tuple(lhs.shape)} x {tuple(rhs.shape)}")
    if lhs.dtype != rhs.dtype:
        raise ValueError(f"grouped_matmul needs one dtype, got {lhs.dtype} and {rhs.dtype}")
    _build.dtype_code(lhs.dtype)
    if lhs.device != rhs.device:
        raise ValueError(f"grouped_matmul operands on {lhs.device} and {rhs.device}")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped_matmul needs contiguous operands")
    if max(lhs.numel(), rhs.numel(), lhs.shape[0] * lhs.shape[1] * rhs.shape[2]) > _INT_MAX:
        raise ValueError("grouped_matmul operand too large for 32-bit sizes")
    if lhs.shape[0] > 65535:
        raise ValueError(f"grouped_matmul launches one block row per expert: E={lhs.shape[0]} > 65535")


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f) with float32 accumulation."""
    _check(lhs, rhs)
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs)
    E, C, d = lhs.shape
    f = rhs.shape[2]
    out = torch.empty((E, C, f), dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        status = lib.grouped_matmul_launch(
            lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), _build.dtype_code(lhs.dtype), E, C, d, f, stream
        )
    _build.check(status, "grouped_matmul")
    _build.LAUNCH_COUNTS["grouped_matmul"] += 1
    return out
