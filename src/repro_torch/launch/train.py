"""Training launcher (the port of ``repro.launch.train``).

Without ``--full`` it trains the reduced config in float32, as the
reference does; ``--full`` trains the config at its own dtype. Runs on
the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge --full --steps 5 --seq 512

On more than one rank it trains on the reference's host mesh,
``(ranks // 2, 2)`` over ``(data, model)``, under ``make_plan``, and prints
the reference's ``mesh {...} plan: attn=... ffn=...`` line; rank 0 prints
the step lines. The ranks come from an initialised ``torch.distributed``
group, or from ``torchrun``'s environment, in which case the launcher
makes the group itself: NCCL when every rank has a card of its own, gloo
otherwise (four ranks sharing one card, or the CPU), and says which:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import synthetic_lm_data
from repro_torch.device import resolve_device
from repro_torch.training.train_loop import TrainState, train_loop


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="the full config at its own dtype")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def world_size() -> int:
    """The ranks this process trains among."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _join(device: Optional[str]):
    """Join ``torchrun``'s ranks: (this rank's device, whether this call
    made the group). NCCL when every local rank has a card of its own,
    else gloo, every rank on card 0."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    on_card = device != "cpu" and torch.cuda.is_available()
    own_cards = on_card and torch.cuda.device_count() >= local_world
    backend = "nccl" if own_cards else "gloo"
    if on_card:
        dev = torch.device("cuda", local if own_cards else 0)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    dist.init_process_group(backend, init_method="env://")
    return dev, backend


def main(argv: Optional[Sequence[str]] = None, history: Optional[list] = None, params=None) -> TrainState:
    """Parse ``argv`` (the command line when None) and train; returns the
    final state (this rank's shard on a mesh). ``history`` as in
    ``train_loop``. ``params``, a whole params tree (numpy arrays or
    tensors, the JAX package's bridged weights for instance), replaces
    the seeded initial weights: each rank takes its shard."""
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    made = False
    plan = None
    if world_size() > 1:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.sharding.specs import make_plan

        if dist.is_available() and dist.is_initialized():
            device, backend = resolve_device(args.device), str(dist.get_backend())
        else:
            (device, backend), made = _join(args.device), True
        mesh = make_host_mesh()
        plan = make_plan(mesh, cfg)
        if mesh.index == 0:
            print(f"process group: {backend}, {mesh.world} ranks", flush=True)
            print(f"mesh {dict(mesh.shape)} plan: attn={plan.attn_mode} ffn={plan.ffn_mode}", flush=True)
    else:
        device = resolve_device(args.device)
    try:
        if plan is None or plan.mesh.index == 0:
            print(f"{cfg.name}: {cfg.total_params() / 1e6:.1f}M params, {cfg.dtype}, on {device}", flush=True)
        state = None
        if params is not None:
            from repro_torch.models.params import params_from_numpy, shard_params
            from repro_torch.training.optimizer import adamw_init

            if plan is not None:
                params = shard_params(params, cfg, plan, plan.mesh.coords)
            p = params_from_numpy(params, device, torch.float32 if not args.full else None)
            state = TrainState(p, adamw_init(p))
        data = synthetic_lm_data(cfg, args.batch, args.seq, plan=plan)
        return train_loop(cfg, data, steps=args.steps, plan=plan, state=state, log_every=5,
                          checkpoint_dir=args.ckpt or None, checkpoint_every=args.steps if args.ckpt else 0,
                          device=device, history=history)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
