"""Checkpoints in the reference's layout (``repro.training.checkpoint``):
``<dir>/step_<N:08d>/arrays.npz`` holding the leaves as ``a0, a1, ...``
in the reference's leaf order (dict keys sorted, a NamedTuple's fields in
order: a ``TrainState`` is params, then opt = step, mu, nu), and
``meta.json`` with the step and the leaves' path names; ``<dir>/LATEST``
names the newest step.

numpy has no bfloat16 (the reference's comes from ``ml_dtypes``, which
ships with JAX), so a bfloat16 leaf is stored as its int16 bit pattern
and ``meta.json`` records every leaf's dtype: a bfloat16 state
round-trips bit for bit. A float32 state reads in either package from a
checkpoint the other wrote.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .tree import tree_items, tree_unflatten


def save_checkpoint(directory: str, tree, step: int) -> str:
    out = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    arrays, meta = {}, {"step": step, "names": [], "dtypes": []}
    for i, (name, leaf) in enumerate(tree_items(tree)):
        t = torch.as_tensor(leaf).detach().cpu()
        meta["names"].append(name)
        meta["dtypes"].append(str(t.dtype).removeprefix("torch."))
        arrays[f"a{i}"] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(os.path.join(out, "arrays.npz"), **arrays)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(os.path.basename(out))
    return out


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(f.read().strip().split("_")[-1])


def load_checkpoint(directory: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (shapes must match):
    each leaf takes the dtype and device of its counterpart there."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    data = np.load(os.path.join(src, "arrays.npz"))
    with open(os.path.join(src, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes")  # the reference's meta has none
    like = tree_items(tree_like)
    leaves = []
    for i, (_, ref) in enumerate(like):
        t = torch.from_numpy(np.array(data[f"a{i}"]))
        if dtypes is not None and dtypes[i] == "bfloat16":
            t = t.view(torch.bfloat16)
        ref = torch.as_tensor(ref)
        leaves.append(t.to(device=ref.device, dtype=ref.dtype).reshape(ref.shape))
    return tree_unflatten(tree_like, leaves)
