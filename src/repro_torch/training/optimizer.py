"""AdamW with global-norm clipping and a cosine schedule (the port of
``repro.training.optimizer``): plain functions on dicts of tensors.

The moments are float32 whatever the parameter dtype, and each update is
computed in float32 and cast back; weight decay applies to every leaf of
two or more dims (the stacked (L, d) norms included, as in the
reference). ``torch.optim.AdamW`` keeps its moments in the parameter's
dtype (bf16 moments at full width) and decays every parameter of a
group, so it is not used. The update runs under ``torch.no_grad`` and
writes the parameters and moments in place, a layer slice at a time, so
its float32 temporaries never exceed one slice of the largest leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from .tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim
    mu: Any  # first moment, the params' tree, float32
    nu: Any  # second moment


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def cosine_lr(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from ``base_lr``
    down to ``min_frac * base_lr`` at ``total``; float32, on the step's
    device."""
    step = torch.as_tensor(step)
    s = step.to(torch.float32)
    warm = base_lr * (s + 1) / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def _slices(t: torch.Tensor):
    """A stacked leaf's layer slices (views), or the leaf itself."""
    return t.unbind(0) if t.ndim >= 3 else (t,)


def global_norm(flat_g, mesh=None, shard_axes=None) -> torch.Tensor:
    """The global L2 norm of the gradient leaves ``flat_g``. On a mesh each
    leaf is this rank's shard, sharded over ``shard_axes[i]`` (a tuple of
    mesh axes, () where it is whole on every rank): each element counts
    once, the squares of the leaves sharded alike summed over their axes
    in one all-reduce."""
    if mesh is None:
        return torch.sqrt(sum(s.float().square().sum() for g in flat_g for s in _slices(g)))
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for i, g in enumerate(flat_g):
        axes = tuple(shard_axes[i])
        sq = sum(s.float().square().sum() for s in _slices(g))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = 0
    for axes, sq in groups.items():
        total = total + (mesh.all_reduce(sq, axes) if axes else sq)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0, mesh=None,
                 shard_axes=None) -> Tuple[Dict[str, Any], AdamWState, torch.Tensor]:
    """One AdamW step with global-norm clipping: (params, new state, the
    gradient's global norm before clipping). ``params`` and the moments
    are updated in place and returned; ``lr`` a float or a 0-dim tensor.
    On a mesh the leaves are this rank's shards and the clip reads the
    whole gradient's norm (``global_norm``, ``shard_axes`` in leaf order);
    the update itself is elementwise, per shard."""
    flat_g = tree_leaves(grads)
    gnorm = global_norm(flat_g, mesh, shard_axes)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    b1c = 1 - torch.pow(b1, step.float())
    b2c = 1 - torch.pow(b2, step.float())
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state.mu), tree_leaves(state.nu)):
        decay = p.ndim >= 2  # decay matrices (and stacked leaves), not 1-D norms
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            gf = gs.float() * scale
            ms.mul_(b1).add_((1 - b1) * gf)
            vs.mul_(b2).add_((1 - b2) * gf.square())
            delta = (ms / b1c) / (torch.sqrt(vs / b2c) + eps)
            del gf
            if decay:
                delta += weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
            del delta
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
