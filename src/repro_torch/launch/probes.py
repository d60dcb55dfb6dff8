"""Per-layer cost probes (the port of ``repro.launch.probes``).

The reference compiles one layer body standalone because XLA's
``cost_analysis`` counts a ``lax.scan`` body once. PyTorch runs every
layer, so the dry run needs no such correction; the probe reports what
one layer costs on the traced rank, with the reference's probe functions:

  train   - a vjp through the checkpointed ``layer_full``: forward, the
            recompute and the backward of one layer of the remat'd step.
  prefill - ``layer_full`` with its cache entries collected (K/V, or the
            mamba conv window and state).
  decode  - ``decode_layer`` over a cache of ``seq`` positions.

The probe also checks the count: on a config whose layers are all alike,
a step's trace is the work outside the layers plus L probes, exactly, in
FLOPs and collective calls (``tests/test_torch_dryrun.py``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.models import transformer as T
from repro_torch.models.params import layer_slice
from repro_torch.sharding.specs import sp_active

from . import roofline


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it) for k, v in tree.items()}


def _positions(cfg, step) -> int:
    """The sequence a train or prefill layer sees on the rank: the frames,
    or the patches ahead of the text, or the tokens; this rank's block of
    it under ``seq_shard_acts``."""
    S = step.seq
    if cfg.frontend == "vision":
        S = cfg.num_patches + max(step.seq - cfg.num_patches, 16)
    return S // step.plan.axis_size(step.plan.attn_tp_axis) if sp_active(step.plan) else S


def probe_layer_costs(cfg, step, mesh, backend: str = "hopper") -> roofline.Meter:
    """Trace one layer on the traced rank of ``mesh`` for ``step`` (a
    ``dryrun.Step``, made inside ``roofline.fake_tensors``: its plan, its
    rows, its fake arguments) with layer 0's leaves and the global flag
    (the reference's probes take ``flag=True``). Returns the
    ``roofline.Meter`` that counted it: its ``costs``, ``calls`` and
    ``payload``."""
    plan, kind = step.plan, step.kind
    params = step.args[0].params if kind == "train" else step.args[0]
    layers = T._fsdp_outer({"layers": params["layers"]}, cfg, plan)["layers"]  # FSDP: leaves sharded along L whole
    lp = layer_slice(layers, 0)
    dt = lp["ln1"].dtype
    with roofline.Meter(mesh) as meter:
        if kind == "train":
            x = torch.empty((step.rows, _positions(cfg, step), cfg.d_model), dtype=dt, device=step.device,
                            requires_grad=True)
            leaves = [t.detach().requires_grad_(True) for t in _leaves(lp)]

            def body(h, *ws):
                y, _, aux = T._layer(h, _rebuild(lp, iter(ws)), True, cfg, plan, False, "ref")
                return (y,) if aux is None else (y, aux)

            outs = torch_checkpoint.checkpoint(body, x, *leaves, use_reentrant=False)
            torch.autograd.grad(outs, [x, *leaves], [torch.ones_like(o) for o in outs], allow_unused=True)
        elif kind == "prefill":
            x = torch.empty((step.rows, _positions(cfg, step), cfg.d_model), dtype=dt, device="cuda")
            with torch.no_grad():
                T._layer(x, lp, True, cfg, plan, True, backend, False)
        else:
            cache = step.args[2]
            x = torch.empty((step.rows, 1, cfg.d_model), dtype=dt, device="cuda")
            with torch.no_grad():
                T.decode_layer(x, lp, True, cfg, T.layer_cache(cache, 0), cache.pos, backend, plan)
    return meter
