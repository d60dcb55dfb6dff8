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

On a mesh (``plan``; ``cfg`` names the specs) the layout is the same whole
tree: every rank takes part in gathering each leaf from its shards
(``models.params.gather_leaf``; the moments are laid out as their
parameters) and rank 0 writes it; each rank loads the whole tree and
keeps its shard. A checkpoint written on any mesh loads on any other, one
rank included.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .tree import tree_items, tree_unflatten


def _on_mesh(plan) -> bool:
    return plan is not None and not plan.is_null


def _leaf_spec(name: str, specs):
    """(the spec, the ``SPLIT_LEAVES`` parts) of a checkpoint leaf: a
    parameter's, or its moment's (the parameter's); None for a leaf that
    is whole on every rank (the step)."""
    from repro_torch.models.params import SPLIT_LEAVES

    for marker in (".params/", ".mu/", ".nu/"):
        if marker in name:
            name = name.split(marker, 1)[1]
            break
    spec = specs.get(name)
    return spec, SPLIT_LEAVES.get(name.rsplit("/", 1)[-1], 1)


def save_checkpoint(directory: str, tree, step: int, cfg=None, plan=None) -> str:
    """Write ``tree`` (a ``TrainState`` or a params dict) as step ``step``;
    on a mesh, a collective: every rank calls it with its shard."""
    out = os.path.join(directory, f"step_{step:08d}")
    items = tree_items(tree)
    if _on_mesh(plan):
        from repro_torch.models.params import gather_leaf, leaf_specs

        specs = leaf_specs(cfg, plan)
        whole = []
        for name, leaf in items:
            spec, parts = _leaf_spec(name, specs)
            t = torch.as_tensor(leaf).detach()
            whole.append((name, gather_leaf(t, spec, plan.mesh, parts) if spec is not None else t))
        if plan.mesh.index != 0:
            torch.distributed.barrier(group=plan.mesh.group)
            return out
        items = whole
    os.makedirs(out, exist_ok=True)
    arrays, meta = {}, {"step": step, "names": [], "dtypes": []}
    for i, (name, leaf) in enumerate(items):
        t = torch.as_tensor(leaf).detach().cpu()
        meta["names"].append(name)
        meta["dtypes"].append(str(t.dtype).removeprefix("torch."))
        arrays[f"a{i}"] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(os.path.join(out, "arrays.npz"), **arrays)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(os.path.basename(out))
    if _on_mesh(plan):
        torch.distributed.barrier(group=plan.mesh.group)
    return out


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(f.read().strip().split("_")[-1])


def load_checkpoint(directory: str, tree_like, step: Optional[int] = None, cfg=None, plan=None):
    """Restore into the structure of ``tree_like`` (shapes must match):
    each leaf takes the dtype and device of its counterpart there. On a
    mesh ``tree_like`` holds this rank's shards, and each leaf keeps its
    shard of the whole one read."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    data = np.load(os.path.join(src, "arrays.npz"))
    with open(os.path.join(src, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes")  # the reference's meta has none
    like = tree_items(tree_like)
    specs = None
    if _on_mesh(plan):
        from repro_torch.models.params import leaf_specs, take_shard

        specs = leaf_specs(cfg, plan)
    leaves = []
    for i, (name, ref) in enumerate(like):
        t = torch.from_numpy(np.array(data[f"a{i}"]))
        if dtypes is not None and dtypes[i] == "bfloat16":
            t = t.view(torch.bfloat16)
        if specs is not None:
            spec, parts = _leaf_spec(name, specs)
            if spec is not None:
                t = take_shard(t, spec, plan.mesh.coords, dict(plan.mesh.shape), parts)
        ref = torch.as_tensor(ref)
        leaves.append(t.to(device=ref.device, dtype=ref.dtype).reshape(ref.shape))
    return tree_unflatten(tree_like, leaves)
