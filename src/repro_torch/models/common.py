"""Shared numerical building blocks (the port of ``repro.models.common``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import autograd as ad
from repro_torch.sharding.specs import dp_axes


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


def plain_ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, act_name: str) -> torch.Tensor:
    """Ungated FFN (HuBERT's ``gelu_plain``): act(x @ wi) @ wo."""
    return activation_fn(act_name)(x @ wi) @ wo


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None, plan=None,
                       vocab_parallel: bool = False) -> torch.Tensor:
    """Mean token-level cross entropy in float32: logsumexp minus the gold
    logit; with ``mask``, the mean over the positions it weights.

    On a mesh (``plan``) the rows are this rank's data rows and the mean is
    the global one: the sums of the loss (and of the mask) are all-reduced
    over the plan's data axes, never a mean of the ranks' means. With
    ``vocab_parallel`` the logits hold this rank's block of the vocabulary
    (the model axis): the log-sum-exp (a max and a sum) and the gold logit
    are completed over the model axis (Megatron's vocab-parallel cross
    entropy)."""
    logits = logits.float()
    if plan is None or plan.is_null:
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - gold
        if mask is not None:
            mask = mask.float()
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()
    mesh = plan.mesh
    if vocab_parallel:
        V = logits.shape[-1]
        top = mesh.all_reduce(logits.detach().amax(dim=-1, keepdim=True), op=torch.distributed.ReduceOp.MAX)
        logz = top[..., 0] + torch.log(ad.reduce_out(torch.exp(logits - top).sum(dim=-1), mesh))
        local = labels.long() - mesh.rank * V
        mine = (local >= 0) & (local < V)
        gold = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0] * mine
        nll = logz - ad.reduce_out(gold, mesh)
    else:
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    axes = dp_axes(plan)
    if mask is None:
        total = nll.sum()
        count = torch.tensor(float(nll.numel() * plan.axis_size(axes)), device=nll.device)
    else:
        mask = mask.float()
        total = (nll * mask).sum()
        count = mesh.all_reduce(mask.sum(), axes) if axes else mask.sum()
    if axes:
        total = ad.reduce_out(total, mesh, axes)
    return total / torch.clamp(count, min=1.0)
