# The port's own copy of repro.core.quantization: the port imports nothing of the JAX package.
"""INT4 weight quantization for the dynamic parallelism transition
(paper §III-D, Table I).

Schemes: per-tensor, per-channel, per-group (the paper adopts fine-grained
per-group after observing per-tensor degrades GSM8K). Asymmetric 4-bit:
q = round((w - zero) / scale) in [0, 15]; dequant w_hat = scale * q + zero.
Packing: two nibbles per uint8, low nibble first — the exact layout the
``int4_dequant`` kernel consumes.

The numpy functions are copies of ``repro.core.quantization``. The torch
ones below compute the same quantization on the weight's own device, a
slab of groups at a time (a numpy pass over a full-width stacked expert
leaf would need ~21 GB of float32 on the host per leaf), and give the
numpy code's packed bytes, scales and zeros bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class QuantizedTensor:
    packed: np.ndarray     # (G, gs // 2) uint8
    scales: np.ndarray     # (G, 1) float32
    zeros: np.ndarray      # (G, 1) float32
    shape: Tuple[int, ...]  # original shape
    group_size: int

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.scales.nbytes + self.zeros.nbytes


def _group_reshape(w: np.ndarray, scheme: str, group_size: int):
    flat = w.reshape(-1)
    if scheme == "per_tensor":
        gs = flat.size
    elif scheme == "per_channel":
        gs = w.shape[-1]
    elif scheme == "per_group":
        gs = group_size
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    if flat.size % gs:
        raise ValueError(f"size {flat.size} not divisible by group {gs}")
    if gs % 2:
        raise ValueError("group size must be even for nibble packing")
    return flat.reshape(-1, gs), gs


def quantize_int4(w: np.ndarray, scheme: str = "per_group",
                  group_size: int = 128) -> QuantizedTensor:
    orig_shape = w.shape
    grouped, gs = _group_reshape(np.asarray(w, np.float32), scheme,
                                 group_size)
    lo = grouped.min(axis=1, keepdims=True)
    hi = grouped.max(axis=1, keepdims=True)
    scale = np.maximum((hi - lo) / 15.0, 1e-8).astype(np.float32)
    zero = lo.astype(np.float32)
    q = np.clip(np.round((grouped - zero) / scale), 0, 15).astype(np.uint8)
    low = q[:, 0::2]
    high = q[:, 1::2]
    packed = (low | (high << 4)).astype(np.uint8)
    return QuantizedTensor(packed=packed, scales=scale, zeros=zero,
                           shape=tuple(orig_shape), group_size=gs)


def dequantize_int4(qt: QuantizedTensor, dtype=np.float32) -> np.ndarray:
    packed = qt.packed.reshape(-1, qt.packed.shape[-1])
    low = (packed & 0xF).astype(np.float32)
    high = (packed >> 4).astype(np.float32)
    vals = np.stack([low, high], axis=-1).reshape(packed.shape[0], -1)
    out = vals * qt.scales.reshape(-1, 1) + qt.zeros.reshape(-1, 1)
    return out.reshape(qt.shape).astype(dtype)


def pick_group_size(last_dim: int, preferred: int = 128) -> int:
    """Largest even divisor of ``last_dim`` not exceeding ``preferred``.

    Residency quantizes along the last weight dim, so every group must
    fit inside one last-dim row for group spans to align with the
    matmul's contraction/output layout (and with how sharded plans
    split that dim).
    """
    if last_dim % 2:
        raise ValueError(f"last dim {last_dim} must be even for packing")
    gs = min(preferred, last_dim)
    while gs > 2 and (last_dim % gs or gs % 2):
        gs -= 1
    if last_dim % gs or gs % 2:
        raise ValueError(f"no even divisor of {last_dim} under {preferred}")
    return gs


def quantize_int4_lastdim(w: np.ndarray,
                          group_size: int | None = None) -> QuantizedTensor:
    """Structured per-group quantization with groups tiling the LAST dim.

    Unlike the flat ``per_group`` layout above (one long (G, gs/2) slab
    for the transition wire format), the leaves here keep the leading
    weight dims so the result can live *resident* on device:

        packed (*lead, n_groups, gs // 2) uint8
        scales (*lead, n_groups, 1) float32
        zeros  (*lead, n_groups, 1) float32

    With ``gs`` dividing the last dim, row-major flat grouping lands
    every group inside one last-dim span, so this is numerically the
    same quantization as ``quantize_int4(w, "per_group", gs)`` — only
    the array layout differs.
    """
    w = np.asarray(w, np.float32)
    gs = pick_group_size(w.shape[-1], group_size or 128)
    qt = quantize_int4(w, "per_group", gs)
    lead = w.shape[:-1]
    n_groups = w.shape[-1] // gs
    return QuantizedTensor(
        packed=qt.packed.reshape(*lead, n_groups, gs // 2),
        scales=qt.scales.reshape(*lead, n_groups, 1),
        zeros=qt.zeros.reshape(*lead, n_groups, 1),
        shape=tuple(w.shape), group_size=gs)


# slab size of the torch quantizer: 2**20 groups of 128 are 512 MB of
# float32 per intermediate
_SLAB_GROUPS = 1 << 20


def quantize_groups_torch(grouped: torch.Tensor):
    """``quantize_int4``'s arithmetic on a (G, gs) tensor, on its device.

    Returns packed (G, gs // 2) uint8, scales and zeros (G, 1) float32,
    bit-equal to the numpy code: the same float32 min/max, the scale
    divided by a float32 tensor of 15 (a CUDA division by a scalar
    multiplies by its reciprocal, which can differ in the last bit),
    round half to even and the same clamp.
    """
    g = grouped.float()
    lo = g.amin(dim=1, keepdim=True)
    hi = g.amax(dim=1, keepdim=True)
    scale = torch.clamp_min((hi - lo) / torch.full_like(hi, 15.0), 1e-8)
    q = torch.clamp(torch.round((g - lo) / scale), 0, 15).to(torch.uint8)
    packed = q[:, 0::2] | (q[:, 1::2] << 4)
    return packed, scale, lo


def quantize_int4_torch(w: torch.Tensor, group_size: int, *,
                        out_device=None, pin: bool = False):
    """Flat per-group quantization (``quantize_int4(w, "per_group", gs)``)
    of a tensor, computed on ``w``'s device a slab of groups at a time and
    written into tensors on ``out_device`` (default ``w``'s), in pinned
    host memory when ``pin``. Returns ``QuantizedTensor`` with torch
    leaves: packed (G, gs // 2), scales and zeros (G, 1)."""
    if w.numel() % group_size:
        raise ValueError(f"size {w.numel()} not divisible by group {group_size}")
    if group_size % 2:
        raise ValueError("group size must be even for nibble packing")
    grouped = w.reshape(-1, group_size)
    G = grouped.shape[0]
    dev = torch.device(out_device) if out_device is not None else w.device
    packed = torch.empty((G, group_size // 2), dtype=torch.uint8, device=dev, pin_memory=pin)
    scales = torch.empty((G, 1), dtype=torch.float32, device=dev, pin_memory=pin)
    zeros = torch.empty((G, 1), dtype=torch.float32, device=dev, pin_memory=pin)
    for g0 in range(0, G, _SLAB_GROUPS):
        p, s, z = quantize_groups_torch(grouped[g0:g0 + _SLAB_GROUPS])
        packed[g0:g0 + len(p)].copy_(p)
        scales[g0:g0 + len(p)].copy_(s)
        zeros[g0:g0 + len(p)].copy_(z)
    return QuantizedTensor(packed=packed, scales=scales, zeros=zeros,
                           shape=tuple(w.shape), group_size=group_size)


def quantize_int4_lastdim_torch(w: torch.Tensor,
                                group_size: int | None = None, *,
                                out_device=None,
                                pin: bool = False) -> QuantizedTensor:
    """``quantize_int4_lastdim`` on ``w``'s device: the structured layout
    (packed (*lead, n_groups, gs // 2), scales/zeros (*lead, n_groups, 1)),
    the same bytes as the flat quantization with ``gs`` dividing the last
    dim."""
    gs = pick_group_size(w.shape[-1], group_size or 128)
    qt = quantize_int4_torch(w, gs, out_device=out_device, pin=pin)
    lead = tuple(w.shape[:-1])
    n_groups = w.shape[-1] // gs
    return QuantizedTensor(
        packed=qt.packed.view(*lead, n_groups, gs // 2),
        scales=qt.scales.view(*lead, n_groups, 1),
        zeros=qt.zeros.view(*lead, n_groups, 1),
        shape=tuple(w.shape), group_size=gs)
