"""Where the port's entry points run: the card unless the caller asks for
the CPU, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or CUDA when it is None; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                'pass device="cpu" to run on the CPU'
            )
        device = "cuda"
    return torch.device(device)
