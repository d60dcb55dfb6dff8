"""Training launcher (the port of ``repro.launch.train``).

Without ``--full`` it trains the reduced config in float32, as the
reference does; ``--full`` trains the config at its own dtype. Runs on
the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge --full --steps 5 --seq 512

Training on more than one rank is not ported (ROADMAP A.9): where the
reference builds a mesh plan when it sees more than one device, this
launcher refuses a world of more than one rank (an initialised
``torch.distributed`` group, or ``WORLD_SIZE`` as ``torchrun`` sets it).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_lm_data
from repro_torch.device import resolve_device
from repro_torch.models.transformer import not_ported
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
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv: Optional[Sequence[str]] = None, history: Optional[list] = None) -> TrainState:
    """Parse ``argv`` (the command line when None) and train; returns the
    final state. ``history`` as in ``train_loop``."""
    args = parser().parse_args(argv)
    if world_size() > 1:
        raise not_ported("training on a mesh", "A.9")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    device = resolve_device(args.device)
    print(f"{cfg.name}: {cfg.total_params() / 1e6:.1f}M params, {cfg.dtype}, on {device}", flush=True)
    data = synthetic_lm_data(cfg, args.batch, args.seq)
    return train_loop(cfg, data, steps=args.steps, log_every=5, checkpoint_dir=args.ckpt or None,
                      checkpoint_every=args.steps if args.ckpt else 0, device=device, history=history)


if __name__ == "__main__":
    main()
