"""Shared numerical building blocks (the port of ``repro.models.common``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the variance in float32, the normalize-multiply in the input
    dtype (the reference's precision order)."""
    dtype = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dtype)
    return x * inv * weight.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, shape (head_dim // 2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.

    x:         (..., S, H, D)
    positions: (..., S) integer, broadcastable against x's batch/seq dims.
    """
    if theta <= 0.0:
        return x
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)  # (D/2,)
    angles = positions[..., None].float() * inv_freq  # (..., S, D/2)
    angles = angles[..., None, :]  # head axis: (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation_fn(name: str):
    if name in ("silu", "swish"):
        return F.silu
    if name in ("gelu", "gelu_plain"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def glu_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, wo: torch.Tensor, act_name: str) -> torch.Tensor:
    """Gated FFN (SwiGLU / GeGLU), outputs in the input dtype."""
    act = activation_fn(act_name)
    return (act(x @ w_gate) * (x @ w_up)) @ wo
