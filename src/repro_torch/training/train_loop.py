"""The training loop (the port of ``repro.training.train_loop``): a step
factory and a host-side loop.

``make_train_step`` differentiates ``loss_and_aux`` with autograd and
applies AdamW. The loss pins the kernel seam to its plain PyTorch path
(``forward_hidden``'s ``backend="ref"``), as the reference pins its jnp
path: the hand-written kernels define no backward. There is no
counterpart of ``jax.jit`` and no CUDA-graph capture here; the step cache
is for serving only.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_and_aux

from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from .tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (the data pipeline's) or tensors, on
    ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.as_tensor(v)).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, plan=None, *, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 1000, remat=True) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss``, ``grad_norm``, ``lr``, ``ce`` and ``aux`` (0-dim tensors).
    The state's parameters and moments are updated in place; the batch
    may be numpy arrays (moved to the parameters' device). Training on a
    mesh is not ported (ROADMAP A.9): ``forward_hidden`` refuses a plan."""

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_and_aux(state.params, cfg, batch_to(batch, leaves[0].device), plan, remat=remat)
        # a leaf the loss does not read (an audio model's token embedding)
        # takes a zero gradient, as jax.grad gives it
        grads = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))}
        lr = cosine_lr(state.opt.step, base_lr, warmup, total_steps)
        params, opt, gnorm = adamw_update(state.params, tree_map(lambda p: grads[id(p)], state.params), state.opt,
                                          lr=lr)
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr,
               **{k: v.detach() for k, v in metrics.items()}}
        return TrainState(params, opt), out

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator, device=None, dtype=None) -> TrainState:
    """Seeded random parameters (``init_params``) and a zero AdamW state,
    on ``device`` (the card when None)."""
    params = init_params(cfg, generator, device=device, dtype=dtype)
    return TrainState(params=params, opt=adamw_init(params))


def train_loop(cfg: ModelConfig, data_iter, steps: int, *, plan=None, state: Optional[TrainState] = None,
               log_every: int = 10, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0, seed: int = 0,
               remat=True, device=None, history: Optional[list] = None) -> TrainState:
    """The host-side loop: iterate the data pipeline, step, log, checkpoint. A new
    state is drawn from ``seed`` on ``device`` (the card when None); a
    given ``state`` trains where it lives. ``history``, a list, receives
    each step's metrics as floats with its wall seconds (reading them
    waits for the device)."""
    if state is None:
        device = resolve_device(device)
        state = init_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device)
    step_fn = make_train_step(cfg, plan, total_steps=steps, remat=remat)
    t0 = time.time()
    for i in range(steps):
        batch = next(data_iter)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if history is not None:
            vals = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **vals, "seconds": time.perf_counter() - t_step})
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d} loss={float(metrics['loss']):8.4f} "
                  f"gnorm={float(metrics['grad_norm']):7.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
        if checkpoint_dir and checkpoint_every and (i + 1) % checkpoint_every == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(checkpoint_dir, state, step=i + 1)
    return state
