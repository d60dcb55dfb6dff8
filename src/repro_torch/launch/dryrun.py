"""Multi-pod dry run: prove the distribution config is coherent (the port of
``repro.launch.dryrun``).

For every (architecture x input shape), trace one rank's step (the train
step, prefill (the encoder forward for an encoder-only model) or one decode
step) on the production mesh, 16x16 (256 ranks) and 2x16x16 (512 ranks,
``"pod"`` folded into the data axis: ``launch.mesh``), with no allocation
and no card: the step runs on fake CUDA tensors (``FakeTensorMode``) over a
fake process group of that many ranks in this one process, through the
card's path (the ``hopper`` kernel seam, whose wrappers launch nothing on
fake tensors and tally their work). The rank holds its shard of the
parameters, of the batch rows and of the cache, as the card would. It
prints the rank's memory (args exact from shapes; temps the high-water mark
of the storage the step makes; out its outputs), the plan's layout, and the
roofline terms on the H100's data-sheet constants with the collective wire
bytes by kind (``launch.roofline``).

Where the reference's numbers are XLA's (``hlo_flops``, ``hlo_bytes``) the
port's are the trace's (``traced_flops``, ``traced_bytes``): FLOPs of every
op and kernel, and an upper bound on HBM bytes (no fusion).

A ``--kv-dtype float8_e4m3fn`` cache takes ``--kernel-backend ref``: the
paged kernel takes bfloat16 or float32 caches, and its wrapper refuses a
float8 one on fake tensors as it would on the card.

Usage (no card, no nvcc):
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out runs.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import transformer as T
from repro_torch.models.io import INPUT_SHAPES, batch_specs, supported_shapes
from repro_torch.models.params import param_pspecs, param_shapes, torch_dtype
from repro_torch.sharding.specs import (ShardingPlan, adapt_plan_for_batch, dp_size, make_plan, serving_rows,
                                        shard_slices)

from . import roofline
from .mesh import make_production_mesh


@dataclasses.dataclass
class Step:
    """One rank's step, ready to trace: ``fn(*args)`` on fake tensors under
    ``plan`` (the plan its batch rows run under), ``rows`` of the batch on
    this rank, and the bytes of each of its arguments."""

    kind: str
    seq: int
    rows: int
    device: str
    plan: Any
    fn: Any
    args: Tuple
    arg_bytes: Dict[str, int]


def rank_rows(plan, batch: int, kind: str) -> Tuple[Any, int]:
    """(the plan the rank's rows run under, the rows it holds) of a global
    ``batch``: a training batch splits over the data axes and must divide
    them (``data.pipeline.local_rows``); a serving batch that does not divide
    them runs with them dropped (``specs.serving_rows``)."""
    if kind == "train":
        n = dp_size(plan)
        if batch % n:
            raise ValueError(f"a batch of {batch} rows does not split over {n} data-parallel ranks")
        return plan, batch // n
    plan_rows, lo, hi = serving_rows(plan, batch)
    return plan_rows, hi - lo


def fake_params(cfg, plan, dtype=None, device: str = "cuda") -> Dict[str, Any]:
    """The rank's shard of every parameter leaf (``param_pspecs``, the
    shapes ``init_params(..., shard=(plan, rank))`` draws), as fake tensors
    on ``device``."""
    dt = torch_dtype(dtype or cfg.dtype)
    mesh = plan.mesh
    sizes = dict(mesh.shape)

    def build(shape, spec):
        if isinstance(shape, dict):
            return {k: build(shape[k], spec[k]) for k in shape}
        index = shard_slices(spec, shape, mesh.coords, sizes)
        return torch.empty(tuple(len(range(*ix.indices(n))) for ix, n in zip(index, shape)), dtype=dt, device=device)

    return build(param_shapes(cfg), param_pspecs(cfg, plan))


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in roofline.tensors(tree))


def build_step(cfg, seq: int, batch: int, kind: str, plan, backend: str = "hopper") -> Step:
    """One rank's step (the counterpart of the reference's
    ``build_lowerable``), its arguments fake tensors: call inside
    ``roofline.fake_tensors``. ``train``: ``make_train_step`` (the ``ref``
    seam, as training pins it) on the rank's shard of the state and its
    rows; ``prefill``: ``prefill`` of the rank's rows (the whole sequence:
    ``seq_shard_acts`` splits it in ``embed_inputs``), or for an
    encoder-only model ``embed_inputs`` + ``forward_hidden`` + ``unembed``;
    ``decode``: one ``decode_step`` of the rank's rows over its shard of a
    cache of ``seq`` positions.

    The serving steps run on fake CUDA tensors. The train step runs on fake
    CPU tensors: training runs the ``ref`` seam, whose ops are the same on
    either device, and a build of PyTorch without CUDA cannot run autograd
    on fake CUDA tensors (its engine asks the CUDA device guard for a
    stream), where this dry run is meant to run."""
    plan, rows = rank_rows(plan, batch, kind)
    device = "cpu" if kind == "train" else "cuda"
    params = fake_params(cfg, plan, device=device)
    arg_bytes = {"params": _nbytes(params)}
    if kind in ("train", "prefill"):
        data = {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=device)
                for k, v in batch_specs(cfg, seq, rows, kind).items()}
        arg_bytes["batch"] = _nbytes(data)
    if kind == "train":
        from repro_torch.training.optimizer import adamw_init
        from repro_torch.training.train_loop import TrainState, make_train_step

        state = TrainState(params=params, opt=adamw_init(params))
        arg_bytes["opt"] = _nbytes(state.opt)
        return Step(kind, seq, rows, device, plan, make_train_step(cfg, plan, remat=True), (state, data), arg_bytes)
    if kind == "prefill":
        if cfg.is_encoder_only:
            def fn(params, batch):
                params = T._fsdp_outer(params, cfg, plan)
                x = T.embed_inputs(params, cfg, batch, plan)
                h, _, _ = T.forward_hidden(params, cfg, x, plan, backend=backend)
                return T.unembed(params, cfg, h, plan)
        else:
            def fn(params, batch):
                return T.prefill(params, cfg, batch, max_len=seq, backend=backend, plan=plan)
        return Step(kind, seq, rows, device, plan, fn, (params, data), arg_bytes)
    cache = T.init_cache(cfg, rows, seq, dtype=torch_dtype(cfg.dtype), device="cuda", plan=plan)
    token = torch.empty((rows, 1), dtype=torch.int32, device="cuda")
    arg_bytes.update(token=token.nbytes, cache=_nbytes(cache))

    def fn(params, token, cache):
        return T.decode_step(params, cfg, token, cache, backend=backend, plan=plan)

    return Step(kind, seq, rows, device, plan, fn, (params, token, cache), arg_bytes)


@dataclasses.dataclass
class Trace:
    """What tracing one rank's step gave: its costs, collectives and kernel
    calls (``roofline.Meter``), its memory, its outputs' shapes, and one
    layer's count (``probes.probe_layer_costs``) where probed."""

    step: Step
    costs: roofline.Costs
    calls: Dict[str, int]
    payload: Dict[Tuple[str, int], int]
    kernels: Dict[str, int]
    args: int
    temps: int
    out: int
    out_shapes: Any
    seconds: float
    layer: Optional[roofline.Meter] = None


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_shapes(v) for v in tree) if not hasattr(tree, "_fields") else \
            type(tree)(*(_shapes(v) for v in tree))
    if dataclasses.is_dataclass(tree):
        return {f.name: _shapes(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return tree


def _new_bytes(out, args) -> int:
    """The bytes of the storages of ``out`` that no argument holds."""
    held = {id(t.untyped_storage()) for t in roofline.tensors(args)}
    seen, total = set(), 0
    for t in roofline.tensors(out):
        s = t.untyped_storage()
        if id(s) not in held and id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def trace(cfg, seq: int, batch: int, kind: str, mesh, plan, *, backend: str = "hopper",
          probe: bool = False) -> Trace:
    """Trace one rank's step on ``mesh`` (its fake default group) under
    ``plan``: fake arguments, the step under ``roofline.Meter`` (serving
    steps under ``torch.no_grad``, as the engine runs them, so autograd
    saves nothing), and with ``probe`` one layer (``launch.probes``)."""
    with roofline.fake_tensors():
        step = build_step(cfg, seq, batch, kind, plan, backend)
        t0 = time.perf_counter()
        with roofline.Meter(mesh) as meter, torch.set_grad_enabled(kind == "train"):
            out = step.fn(*step.args)
        seconds = time.perf_counter() - t0
        res = Trace(step, meter.costs, meter.calls, meter.payload, meter.kernels, sum(step.arg_bytes.values()),
                    meter.temps, _new_bytes(out, step.args), _shapes(out), seconds)
        del out
        if probe:
            from .probes import probe_layer_costs

            res.layer = probe_layer_costs(cfg, step, mesh, backend=backend)
    return res


def fsdp_plan(mesh) -> ShardingPlan:
    """The reference dry run's ZeRO-3 plan (``--fsdp``): every axis data
    parallel, attention replicated, the cache whole, every parameter
    sharded over every axis."""
    return ShardingPlan(mesh=mesh, dp_axes=tuple(mesh.axis_names), attn_mode="replicated", kv_shard="none",
                        ffn_mode="tp", ffn_tp_axis=None, ep_axis=None, fsdp=True)


def _session_plan(cfg, mesh, seq: int, batch: int, kind: str, source: str, chip: str):
    """Strategy via a PlanSource (ILP planner or static baselines), bridged
    onto the mesh with ``HAPPlan.to_sharding_plan``: the adaptive path."""
    from repro_torch.core import HAPSession, Workload
    from repro_torch.core.latency import cached_latency_model

    session = HAPSession(cfg, chip, mesh.world, source=source, model=cached_latency_model(chip), mesh=mesh,
                         prompt_bucket=max(seq, 1))
    w = Workload(batch=batch, prompt=seq, gen=64)
    return session.sharding_plan(w, phase="decode" if kind == "decode" else "prefill")


def select_plan(cfg, shape_name: str, mesh, *, expert_mode: str = "", attn_mode: str = "", kv_shard: str = "",
                fsdp: bool = False, source: str = "baseline", chip: str = "a6000") -> ShardingPlan:
    """The reference's plan selection: FSDP's plan as it is; a strategy
    source for the inference shapes, else the mesh baseline; then the
    batch's fixups (``adapt_plan_for_batch``)."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    if fsdp:
        return fsdp_plan(mesh)
    if source != "baseline" and kind != "train":  # HAP is an inference planner
        plan = _session_plan(cfg, mesh, seq, batch, kind, source, chip)
    else:
        plan = make_plan(mesh, cfg, expert_mode=expert_mode, attn_override=attn_mode, kv_shard=kv_shard)
    return adapt_plan_for_batch(plan, cfg, batch, kind)


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False, expert_mode: str = "", attn_mode: str = "",
              kv_shard: str = "", probe: bool = True, verbose: bool = True, cfg_override=None, fsdp: bool = False,
              source: str = "baseline", chip: str = "a6000", rank: int = 0,
              backend: str = "hopper") -> Optional[roofline.RooflineReport]:
    """Trace rank ``rank``'s step of ``arch`` x ``shape_name`` on the
    production mesh and report it (None: a shape the arch skips)."""
    cfg = cfg_override or get_config(arch)
    status = supported_shapes(cfg)[shape_name]
    if status != "ok":
        if verbose:
            print(f"{arch} x {shape_name}: {status}", flush=True)
        return None
    seq, batch, kind = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
    plan = select_plan(cfg, shape_name, mesh, expert_mode=expert_mode, attn_mode=attn_mode, kv_shard=kv_shard,
                       fsdp=fsdp, source=source, chip=chip)
    t0 = time.time()
    res = trace(cfg, seq, batch, kind, mesh, plan, backend=backend, probe=probe)
    t_trace = res.seconds
    rep = roofline.build_report(arch=arch, shape=shape_name, mesh_name=mesh.name, n_devices=mesh.world, cfg=cfg,
                                full=res.costs, peak_mem=res.args + res.temps)
    if verbose:
        if probe:
            layer = res.layer.costs
            print(f"  probes: {time.time() - t0 - t_trace:.1f}s (one layer: {layer.flops:.4g} FLOPs, "
                  f"{layer.bytes_accessed / 2**30:.2f} GiB, {sum(layer.coll.values()) / 2**20:.1f} MiB wire)",
                  flush=True)
        print(f"{arch} x {shape_name} [{mesh.name}] trace={t_trace:.1f}s "
              f"plan=(attn={plan.attn_mode},kv={plan.kv_shard},ffn={plan.ffn_mode},sp={plan.seq_shard_acts})",
              flush=True)
        print(f"  memory/device: args={res.args/2**30:.2f}GiB temps={res.temps/2**30:.2f}GiB "
              f"out={res.out/2**30:.2f}GiB")
        print(f"  roofline: compute={rep.t_compute*1e3:.2f}ms memory={rep.t_memory*1e3:.2f}ms "
              f"collective={rep.t_collective*1e3:.2f}ms -> {rep.bottleneck}-bound "
              f"(useful-flops ratio {rep.flops_ratio:.3f})", flush=True)
        for kc, v in sorted(rep.coll_breakdown.items()):
            if v > 0:
                print(f"    {kc}: {v/2**20:.1f} MiB/device wire")
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="", choices=[""] + list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--expert-mode", default="", choices=["", "ep", "tp"])
    ap.add_argument("--attn-mode", default="", choices=["", "tp_heads", "replicated"])
    ap.add_argument("--kv-shard", default="", choices=["", "heads", "seq", "seq_all"])
    ap.add_argument("--fsdp", action="store_true", help="ZeRO-3 parameter sharding over all mesh axes")
    ap.add_argument("--kv-dtype", default="", help="KV cache dtype override, e.g. float8_e4m3fn "
                                                   "(with --kernel-backend ref: the paged kernel takes bf16/f32)")
    ap.add_argument("--source", default="baseline", choices=["baseline", "ilp", "tp", "ep"],
                    help="strategy source for inference shapes: mesh baseline, the HAP ILP planner, or static "
                         "TP/EP (bridged via HAPPlan.to_sharding_plan)")
    ap.add_argument("--chip", default="a6000", help="hardware model for --source ilp planning")
    ap.add_argument("--out", default="")
    ap.add_argument("--rank", type=int, default=0, help="the rank of the mesh to trace")
    ap.add_argument("--kernel-backend", default="hopper", choices=["hopper", "ref"],
                    help="the kernel seam traced: hopper (the card's path; its wrappers launch nothing on fake "
                         "tensors) or ref (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.source != "baseline" and (args.expert_mode or args.attn_mode or args.kv_shard):
        ap.error("--expert-mode/--attn-mode/--kv-shard only apply to "
                 "--source baseline (the strategy source decides layouts)")

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    rows, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                # probe (one layer's costs) only on the single-pod mesh;
                # the multi-pod pass proves the "pod" axis shards.
                do_probe = (not args.no_probe) and not mp
                cfg_override = None
                if args.kv_dtype:
                    cfg_override = dataclasses.replace(get_config(arch), kv_cache_dtype=args.kv_dtype)
                try:
                    rep = lower_one(arch, shape, multi_pod=mp, probe=do_probe, expert_mode=args.expert_mode,
                                    attn_mode=args.attn_mode, kv_shard=args.kv_shard, cfg_override=cfg_override,
                                    fsdp=args.fsdp, source=args.source, chip=args.chip, rank=args.rank,
                                    backend=args.kernel_backend)
                except Exception as e:  # noqa: BLE001 - a failed combination is reported, the sweep goes on
                    failures.append((arch, shape, mp))
                    print(f"FAIL {arch} x {shape} multi_pod={mp}: {e}")
                    traceback.print_exc()
                    continue
                if rep is None:
                    rows.append({"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                                 "status": "skip", "reason": supported_shapes(get_config(arch))[shape]})
                else:
                    rows.append({
                        "arch": arch, "shape": shape, "mesh": rep.mesh, "status": "ok",
                        "traced_flops": rep.traced_flops, "traced_bytes": rep.traced_bytes,
                        "coll_bytes": rep.coll_bytes, "coll_breakdown": rep.coll_breakdown,
                        "model_flops": rep.model_flops, "t_compute": rep.t_compute, "t_memory": rep.t_memory,
                        "t_collective": rep.t_collective, "bottleneck": rep.bottleneck,
                        "flops_ratio": rep.flops_ratio, "peak_mem_gib": rep.peak_mem_bytes / 2**30,
                    })
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rows[-1]) + "\n")
    print(f"\n{len([r for r in rows if r['status'] == 'ok'])} ok, "
          f"{len([r for r in rows if r['status'] == 'skip'])} skipped, "
          f"{len(failures)} failed")
    for f_ in failures:
        print("  FAIL:", *f_)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
