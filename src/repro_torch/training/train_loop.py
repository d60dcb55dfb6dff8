"""The training loop (the port of ``repro.training.train_loop``): a step
factory and a host-side loop.

``make_train_step`` differentiates ``loss_and_aux`` with autograd and
applies AdamW. The loss pins the kernel seam to its plain PyTorch path
(``forward_hidden``'s ``backend="ref"``), as the reference pins its jnp
path: the hand-written kernels define no backward. There is no
counterpart of ``jax.jit`` and no CUDA-graph capture here; the step cache
is for serving only.

On a mesh (a plan over a ``RankMesh``) each rank holds its shard of the
state and its data rows of each batch (``data.pipeline.local_rows``); the
loss is the global one on every rank, and ``sync_grads`` makes each
gradient that of the global loss: a leaf replicated over a data axis sums
its gradient over that axis (the rank's rows gave it only their part).
The gradients summed over the model axis (the router under EP, the norms
under ``seq_shard_acts``) and the FSDP shards (reduce-scattered) come out
of the backward already whole. The clip reads the whole gradient's norm.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_and_aux
from repro_torch.models.params import leaf_specs
from repro_torch.sharding.specs import dp_axes, spec_axes

from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from .tree import tree_items, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (the data pipeline's) or tensors, on
    ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.as_tensor(v)).to(device)
            for k, v in batch.items()}


def _on_mesh(plan) -> bool:
    return plan is not None and not plan.is_null


def leaf_axes(params, cfg: ModelConfig, plan) -> Tuple[List[Tuple[str, ...]], List[Tuple[str, ...]]]:
    """Per leaf of ``params`` (leaf order): (the mesh axes of size > 1 its
    shard is sharded over, the data-parallel axes its gradient is summed
    over: those it is replicated over)."""
    specs = leaf_specs(cfg, plan)
    dp = dp_axes(plan)
    sharded, summed = [], []
    for name, _ in tree_items(params):
        axes = tuple(a for a in spec_axes(specs[name]) if plan.axis_size(a) > 1)
        sharded.append(axes)
        summed.append(tuple(a for a in dp if a not in axes))
    return sharded, summed


def sync_grads(grads: List[torch.Tensor], summed, mesh) -> List[torch.Tensor]:
    """Each gradient summed over its data-parallel axes (``leaf_axes``), in
    place: one all-reduce per leaf."""
    for g, axes in zip(grads, summed):
        if axes:
            mesh.all_reduce(g, axes)
    return grads


def leaf_grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for each leaf; a leaf the loss does not read (an
    audio model's token embedding) takes a zero gradient, as jax.grad
    gives it."""
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def make_train_step(cfg: ModelConfig, plan=None, *, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 1000, remat=True) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss``, ``grad_norm``, ``lr``, ``ce`` and ``aux`` (0-dim tensors).
    The state's parameters and moments are updated in place; the batch
    may be numpy arrays (moved to the parameters' device). On a mesh the
    state is this rank's shard and the batch its data rows."""
    axes = {}

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_and_aux(state.params, cfg, batch_to(batch, leaves[0].device), plan, remat=remat)
        grads = leaf_grads(loss, leaves)
        kw = {}
        if _on_mesh(plan):
            if not axes:
                axes["sharded"], axes["summed"] = leaf_axes(state.params, cfg, plan)
            grads = sync_grads(grads, axes["summed"], plan.mesh)
            kw = {"mesh": plan.mesh, "shard_axes": axes["sharded"]}
        by_id = {id(p): g for p, g in zip(leaves, grads)}
        lr = cosine_lr(state.opt.step, base_lr, warmup, total_steps)
        params, opt, gnorm = adamw_update(state.params, tree_map(lambda p: by_id[id(p)], state.params), state.opt,
                                          lr=lr, **kw)
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr,
               **{k: v.detach() for k, v in metrics.items()}}
        return TrainState(params, opt), out

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator, device=None, dtype=None, plan=None) -> TrainState:
    """Seeded random parameters (``init_params``) and a zero AdamW state,
    on ``device`` (the card when None); on a mesh this rank's shard of
    them, equal to the same cut of the one-rank state from the seed."""
    shard = (plan, plan.mesh.coords) if _on_mesh(plan) else None
    params = init_params(cfg, generator, device=device, dtype=dtype, shard=shard)
    return TrainState(params=params, opt=adamw_init(params))


def train_loop(cfg: ModelConfig, data_iter, steps: int, *, plan=None, state: Optional[TrainState] = None,
               log_every: int = 10, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0, seed: int = 0,
               remat=True, device=None, history: Optional[list] = None) -> TrainState:
    """The host-side loop: iterate the data pipeline, step, log, checkpoint. A new
    state is drawn from ``seed`` on ``device`` (the card when None); a
    given ``state`` trains where it lives. ``history``, a list, receives
    each step's metrics as floats with its wall seconds (reading them
    waits for the device). On a mesh (``plan``) each rank trains its shard
    on its data rows (``data_iter`` yields them), rank 0 alone logs, and
    every rank takes part in a checkpoint, which rank 0 writes whole."""
    if state is None:
        device = resolve_device(device)
        state = init_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device, plan=plan)
    if _on_mesh(plan) and plan.mesh.index != 0:
        log_every = 0
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

            save_checkpoint(checkpoint_dir, state, step=i + 1, cfg=cfg, plan=plan)
    return state
