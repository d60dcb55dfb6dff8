#!/usr/bin/env python3
"""Where a serving step's time goes on the card: a torch.profiler trace of
the port's prefill and decode at a family's full width (``--arch``, by
default DeepSeekMoE-16B), at its full depth or the first ``--layers``
(Mixtral-8x7B needs ``--layers 16`` to fit one 80 GB card, as
``chip_smoke.py``'s ``families`` phase serves it).

Run from the root of a checkout on a machine with one CUDA sm_90 card:
``python3 tools/profile_decode.py``. It builds the kernels, makes seeded
random weights, prefills 4 prompts of 128 tokens (the chip smoke test's
batch) and then reports, as JSON lines:

- ``timing``: host wall ms per prefill and per decode step, each ending in
  a sync, without the profiler (the numbers the engine sees);
- ``profile``: for one traced prefill and ``--steps`` traced decode steps,
  the device busy ms (the sum of kernel and copy times on the card), the
  device idle share of the traced wall time, and the launches per step;
- ``top``: the operations with the most device time and the most host time,
  and the device time of each of the repo's own kernels.

With ``--continuous`` it profiles ``chip_smoke.py``'s continuous traffic
instead: 16 requests of 256 tokens sharing a 192-token system prompt through
``InferenceEngine(max_batch=8, kv_block_size=16, prefix_cache=True)
.serve_continuous()``. It reports ``timing`` (one
unprofiled run: wall s, decode steps, prefill chunks), ``profile`` (one traced
run: device busy s, idle share, device events) and ``top``.

With ``--resident`` the expert leaves are first quantized on the card into
resident INT4 ``QuantizedExpert``s (``ops.quantize_weight``), so every
expert matmul runs ``int4_dequant`` and then the grouped matmul; it combines
with ``--continuous`` (MoE families only).

For a vision family (``--arch llava-next-mistral-7b``) the default mode
prefills ``chip_smoke.py``'s image prompts instead (2 rows of the config's
patches and 64 text tokens).

With ``--train`` it profiles a training step of the family instead
(``make_train_step``, ``--batch`` x ``--seq`` of ``synthetic_lm_data``,
``remat=True``: ``chip_smoke.py``'s HuBERT-XLarge run is ``--arch
hubert-xlarge --train``): after two warm-up steps, ``timing`` lines for
three unprofiled whole steps and for two steps cut into the loss's
forward, the backward and the AdamW update (the device waited for after
each), then ``profile`` and ``top`` lines for one traced step, a window
for each of those three parts.

With ``--captured`` it drives the engine's own steps instead
(``InferenceEngine`` with ``capture_steps`` False and True) in three cells,
each in the order eager, captured, captured, eager: ``static`` (the same 4
prompts through the engine's prefill step and ``--steps`` lockstep decode
steps, after two warm-up passes: a step is captured on its second run),
``continuous`` (the continuous traffic above, prefix cache on; each run
captures its own graphs, as a new live batch does) and, for an MoE family,
``resident`` (the static cell on resident INT4 leaves). Each run prints ``timing`` (unprofiled) and
``profile`` (traced) lines with ``capture_steps`` and its place in the order,
and the static and resident runs a line of launches per kernel for one
prefill and the decode steps.

With ``--route`` it times only the MoE router's top-k selection at the
family's decode (4 tokens) and prefill (4 x 128 tokens) shapes: the stable
descending sort and slice that ``models.moe.route`` takes, ``torch.topk``
(which breaks ties in no stated order), and ``torch.topk`` on an exact
int64 key (the probability's bits, then the lower expert first), each as
device ms per call (CUDA events around a CUDA graph of 50 calls), with
whether their choices agree. It makes no model weights.

With ``--prefetch`` it serves ``chip_smoke.py``'s serve traffic from resident
INT4 experts through its switching session (``fixed_plan("TP1", "TP2",
"EP2", mechanism="int4_upload")``), with predictive prefetch on and off,
async and sync transitions, after a warm-up run: one ``timing`` line per
run (exposed restore ms, restore wait, the ``prefetch_*`` counters, decode
and prefill ms, and the host ms of the serving thread's routing reads and
of the worker's row uploads being issued), then
one traced prefetch-on async run, whose ``streams`` line gives each CUDA
stream's kernel and copy time, the host-to-device bytes and their device
rate, and how long the copies on the other streams overlapped the serving
stream's kernels.

The profiler adds host overhead of its own, so the idle share it shows is
an upper bound; ``timing`` is the undisturbed wall clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)  # chip_smoke's traffic


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="decode steps traced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="deepseek-moe-16b", help="a name of repro_torch.configs.list_configs()")
    ap.add_argument("--layers", type=int, default=0, help="keep the first N layers (0: all)")
    ap.add_argument("--route", action="store_true", help="time the router's top-k selection only")
    ap.add_argument("--continuous", action="store_true", help="profile the continuous traffic instead")
    ap.add_argument("--resident", action="store_true", help="serve the experts from resident INT4 leaves")
    ap.add_argument("--prefetch", action="store_true",
                    help="resident INT4 switching session, prefetch on and off, and one traced run")
    ap.add_argument("--captured", action="store_true",
                    help="eager against captured engine steps: static, continuous and resident cells")
    ap.add_argument("--train", action="store_true", help="profile a training step instead")
    ap.add_argument("--batch", type=int, default=4, help="--train: rows a step")
    ap.add_argument("--seq", type=int, default=512, help="--train: positions a row")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if (args.resident or args.route) and not cfg.is_moe:
        print(f"profile_decode: --resident and --route need an MoE family, {cfg.name} is dense", file=sys.stderr)
        return 1
    emit({"phase": "config", "arch": cfg.name, "num_layers": cfg.num_layers})
    if args.route:
        profile_route(cfg)
        print_card()
        return 0
    if args.train:
        profile_train(cfg, args)
        print_card()
        return 0
    if not cfg.causal:
        print(f"profile_decode: {cfg.name} is encoder-only; it has no decode (try --train)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    if args.captured:
        profile_captured(cfg, params, args)
        return 0
    if args.prefetch:
        profile_prefetch(cfg, params)
        return 0
    if args.resident:
        params = resident(params)
    if args.continuous:
        profile_continuous(cfg, params)
        return 0
    B, S, new = 4, 128, 16
    if cfg.frontend == "vision":
        from chip_smoke import vlm_batch

        batch = vlm_batch(cfg, 2, 64, args.seed)
        S = cfg.num_patches + batch["tokens"].shape[1]
    else:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(args.seed).integers(1, cfg.vocab_size, (B, S)))
                 .to(dev)}
    emit({"phase": "shape", "batch": len(batch["tokens"]), "prompt": S, "new": new})

    def run_prefill():
        logits, cache = prefill(params, cfg, batch, S + new + 1)
        return logits.argmax(-1).cpu(), cache  # the engine's host sync

    def run_steps(cache, tok, n):
        for _ in range(n):
            logits, cache = decode_step(params, cfg, tok.to(dev)[:, None], cache)
            tok = logits.argmax(-1).cpu()
        return cache, tok

    with torch.inference_mode():
        tok, cache = run_prefill()  # warm-up: builds the kernels, cuBLAS handles
        run_steps(cache, tok, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = run_prefill()
        t1 = time.perf_counter()
        cache, tok = run_steps(cache, tok, args.steps)
        t2 = time.perf_counter()
        emit({"phase": "timing", "prefill_ms": (t1 - t0) * 1e3, "decode_ms_per_step": (t2 - t1) * 1e3 / args.steps})

        for name, fn, n in (
            ("prefill", lambda: run_prefill(), 1),
            ("decode", lambda: run_steps(cache, tok, args.steps), args.steps),
        ):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            report(prof, name, wall, n)
    print_card()
    return 0


def profile_route(cfg) -> None:
    """The router's top-k selection, three ways, at decode and prefill."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    E, k, d = cfg.n_routed_experts, cfg.top_k, cfg.d_model
    w = torch.randn(d, E, generator=gen, device=dev).mul_(d**-0.5)
    lower_first = torch.arange(E - 1, -1, -1, device=dev)  # the tie-break: a lower expert is a larger key
    for T in (4, 4 * 128):
        probs = torch.softmax(torch.randn(T, d, generator=gen, device=dev) @ w, dim=-1)

        def sort_slice():
            gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            return gates[:, :k], idx[:, :k]

        def topk():
            return torch.topk(probs, k, dim=-1)

        def keyed_topk():
            idx = torch.topk(probs.view(torch.int32).long() * E + lower_first, k, dim=-1).indices
            return probs.gather(-1, idx), idx

        ways = {"sort_slice": sort_slice, "topk": topk, "keyed_topk": keyed_topk}
        picks = {n: fn()[1] for n, fn in ways.items()}
        emit({"phase": "route", "arch": cfg.name, "tokens": T, "experts": E, "top_k": k,
              **{f"{n}_ms": graph_ms(fn) for n, fn in ways.items()},
              "keyed_equals_sort": bool(torch.equal(picks["keyed_topk"], picks["sort_slice"])),
              "topk_equals_sort": bool(torch.equal(picks["topk"], picks["sort_slice"]))})


def graph_ms(fn, reps: int = 50, replays: int = 3) -> float:
    """Mean device ms per call of ``fn``, captured ``reps`` times into one
    CUDA graph, from CUDA events around ``replays`` replays."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * reps)


def resident(params):
    """``params`` with the expert leaves quantized on the card into resident
    INT4 ``QuantizedExpert``s (the dense leaves freed)."""
    import torch

    from repro_torch.kernels import ops

    moe = params["layers"]["moe"]
    packed = {n: ops.quantize_weight(moe[n]) for n in ("wi_gate", "wi_up", "wo")}
    params = dict(params, layers=dict(params["layers"], moe=dict(moe, **packed)))
    del moe
    torch.cuda.empty_cache()
    return params


AB_ORDER = (False, True, True, False)


def profile_captured(cfg, params, args) -> None:
    """The ``--captured`` cells: static, continuous (prefix cache on) and
    resident, each eager and captured in ``AB_ORDER``."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import CONT_BLOCK, CONT_MAX_BATCH, cont_requests
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import InferenceEngine, Request

    B, S, new = 4, 128, args.steps
    max_len = S + new + 1
    toks = np.random.default_rng(args.seed).integers(1, cfg.vocab_size, (B, S))

    def static_cell(what, params):
        for order, capture in enumerate(AB_ORDER):
            eng = InferenceEngine(cfg, params, max_batch=B, capture_steps=capture)
            tag = {"cell": what, "capture_steps": capture, "order": order}

            def prefill():
                tok = eng._prefill_step(toks, max_len).argmax(-1)
                tok.cpu()  # the engine's host sync
                return tok

            def decode(tok):
                for i in range(new):
                    tok = eng._decode_step_static(tok, S + i, max_len).argmax(-1)
                    tok.cpu()
                return tok

            with torch.inference_mode():
                for _ in range(2):  # warm-up: the first (eager) runs, then the captures
                    decode(prefill())
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_counts()
                t0 = time.perf_counter()
                tok = prefill()
                t1 = time.perf_counter()
                decode(tok)
                t2 = time.perf_counter()
                emit({"phase": "timing", **tag, "prefill_ms": (t1 - t0) * 1e3,
                      "decode_ms_per_step": (t2 - t1) * 1e3 / new,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": dict(_build.LAUNCH_COUNTS), "steps": dataclasses.asdict(eng.steps.stats)})
                for name, fn, n in (("prefill", prefill, 1), ("decode", lambda: decode(tok), new)):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t0) * 1e3
                    report(prof, f"{what}_{name}", wall, n, **tag)
            del eng
            gc.collect()
            torch.cuda.empty_cache()

    def serve(capture):
        eng = InferenceEngine(cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK, prefix_cache=True,
                              capture_steps=capture)
        for p, g in cont_requests(cfg):
            eng.submit(Request(prompt=p, max_new_tokens=g))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.serve_continuous()
        torch.cuda.synchronize()
        return eng, (time.perf_counter() - t0) * 1e3

    static_cell("static", params)
    with torch.inference_mode():
        serve(True)  # warm-up: cuBLAS, the kernels' plans and workspace
        for order, capture in enumerate(AB_ORDER):
            tag = {"cell": "continuous_prefix", "capture_steps": capture, "order": order}
            eng, wall = serve(capture)
            st = eng.stats
            emit({"phase": "timing", **tag, "wall_ms": wall, "decode_steps": st.decode_steps,
                  "prefill_chunks": st.prefill_chunks, "fused_steps": st.fused_steps,
                  "decode_step_ms_mean": st.decode_step_ms_sum / st.decode_steps,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "steps": dataclasses.asdict(eng.steps.stats)})
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                eng, wall = serve(capture)
            report(prof, "continuous_prefix", wall, 1, decode_steps=eng.stats.decode_steps,
                   prefill_chunks=eng.stats.prefill_chunks, **tag)
            del eng
    # the resident cell quantizes beside the dense leaves, which the cells
    # above still use: only where the packed copy (~0.28x) fits beside them
    experts = sum(params["layers"]["moe"][n].nbytes for n in ("wi_gate", "wi_up", "wo")) if cfg.is_moe else 0
    if experts and torch.cuda.mem_get_info()[0] > 0.3 * experts + 4e9:
        static_cell("resident", resident(params))
    elif experts:
        emit({"phase": "skipped", "cell": "resident", "why": "the INT4 copy does not fit beside the dense leaves"})
    print_card()


def _union(intervals):
    """The disjoint union of [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """The measure of the intersection of two disjoint sorted unions."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_summary(trace_path: str) -> dict:
    """Per CUDA stream of a chrome trace: kernels and copies, their device
    ms, host-to-device bytes and their device rate; and the ms in which
    copies on other streams ran while the serving stream (the one with the
    most kernels) ran a kernel."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    streams = {}
    for e in gpu:
        st = streams.setdefault(e.get("args", {}).get("stream"), {"kernels": 0, "kernel_ms": 0.0, "copies": 0,
                                                                  "copy_ms": 0.0, "htod_bytes": 0, "htod_ms": 0.0})
        if e["cat"] == "kernel":
            st["kernels"] += 1
            st["kernel_ms"] += e["dur"] / 1e3
        else:
            st["copies"] += 1
            st["copy_ms"] += e["dur"] / 1e3
            if "HtoD" in e["name"]:
                st["htod_bytes"] += int(e.get("args", {}).get("bytes", 0))
                st["htod_ms"] += e["dur"] / 1e3
    for st in streams.values():
        st["htod_gb_per_s"] = st["htod_bytes"] / st["htod_ms"] / 1e6 if st["htod_ms"] else None
    main = max(streams, key=lambda k: streams[k]["kernels"])
    kernels = _union((e["ts"], e["ts"] + e["dur"]) for e in gpu
                     if e["cat"] == "kernel" and e.get("args", {}).get("stream") == main)
    copies = _union((e["ts"], e["ts"] + e["dur"]) for e in gpu
                    if e["cat"] == "gpu_memcpy" and e.get("args", {}).get("stream") != main)
    return {"serving_stream": main, "streams": {str(k): v for k, v in streams.items()},
            "other_stream_copies_ms": sum(b - a for a, b in copies) / 1e3,
            "other_stream_copies_during_serving_kernels_ms": _overlap(copies, kernels) / 1e3}


def profile_prefetch(cfg, params) -> None:
    """The ``--prefetch`` runs: the resident switching session's serve
    traffic, async and sync transitions, prefetch off and on, then one
    traced run with prefetch on and async transitions."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MAX_BATCH, MAX_NEW, PREFETCH_TOP_P, _session, prompts
    from repro_torch.serving import Request

    def serve(asy, on, prof=None):
        eng = _session(cfg).engine(params, max_batch=MAX_BATCH, resident_int4=True, use_int4_transition=True,
                                   async_transitions=asy, prefetch=on, prefetch_top_p=PREFETCH_TOP_P)
        for p in prompts(cfg):
            eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
        # host ms of the serving thread's routing read (tracker, predictor,
        # pulls issued) and of the worker's row uploads being issued
        host = {"observe_ms": 0.0, "observes": 0, "upload_issue_ms": 0.0, "uploads": 0, "rows": 0, "runs": 0}
        observe, stage = eng._observe_routing, eng._tx.prefetch_rows

        def timed_observe(route):
            t0 = time.perf_counter()
            observe(route)
            host["observe_ms"] += (time.perf_counter() - t0) * 1e3
            host["observes"] += 1

        def timed_stage(name, rows):
            t0 = time.perf_counter()
            out = stage(name, rows)
            host["upload_issue_ms"] += (time.perf_counter() - t0) * 1e3
            host["uploads"] += 1
            host["rows"] += len(rows)
            host["runs"] += 1 + sum(b != a + 1 for a, b in zip(sorted(rows), sorted(rows)[1:]))
            return out

        eng._observe_routing, eng._tx.prefetch_rows = timed_observe, timed_stage
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        st, per_batch = eng.stats, comps[::MAX_BATCH]
        row = {"async_transitions": asy, "prefetch": on, "wall_s": wall,
               "prefill_ms": [c.prefill_ms for c in per_batch],
               "decode_ms_per_step": [c.decode_ms / (MAX_NEW - 1) for c in per_batch],
               "transition_ms": [c.transition_ms for c in per_batch], "transition_ms_total": st.transition_ms_total,
               "restore_wait_ms": st.restore_wait_ms,
               **{k: getattr(st, k) for k in ("prefetch_predicted", "prefetch_hits", "prefetch_misses",
                                              "prefetch_bytes", "prefetch_hidden_ms", "prefetch_exposed_ms",
                                              "prefetch_errors")}, "host": host}
        eng.close()
        return row, [c.tokens for c in comps]

    serve(True, False)  # warm-up: builds the kernels
    tokens = {}
    for asy in (True, False):
        for on in (False, True):
            row, tokens[asy, on] = serve(asy, on)
            emit({"phase": "timing", "what": "prefetch", **row, "tokens_equal_prefetch_off": tokens[asy, on]
                  == tokens[asy, False]})
    path = os.path.join(tempfile.mkdtemp(), "trace.json")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    row, _ = serve(True, True, prof)
    prof.export_chrome_trace(path)
    emit({"phase": "profile", "what": "prefetch traced (async, prefetch on)", **row, **stream_summary(path)})
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    print_card()


def profile_train(cfg, args) -> None:
    """The ``--train`` mode (see the module's docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic_lm_data
    from repro_torch.models import loss_and_aux
    from repro_torch.training.optimizer import adamw_update, cosine_lr
    from repro_torch.training.train_loop import TrainState, batch_to, init_train_state, make_train_step
    from repro_torch.training.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    data = synthetic_lm_data(cfg, args.batch, args.seq, seed=args.seed)
    step = make_train_step(cfg, total_steps=100)
    emit({"phase": "shape", "what": "train", "batch": args.batch, "seq": args.seq, "dtype": cfg.dtype,
          "params": sum(p.numel() for p in tree_leaves(state.params))})

    def since(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def parts(state):
        """One step in three parts, as ``train_step`` runs it: [(name, fn)]."""
        batch = batch_to(next(data), dev)
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        held = {}

        def forward():
            held["loss"], _ = loss_and_aux(state.params, cfg, batch, remat=True)

        def backward():
            grads = torch.autograd.grad(held.pop("loss"), leaves, allow_unused=True)
            held["grads"] = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}

        def update():
            grads = held.pop("grads")
            adamw_update(state.params, tree_map(lambda p: grads[id(p)], state.params), state.opt,
                         lr=cosine_lr(state.opt.step, 3e-4, 100, 100))

        return [("train_forward", forward), ("train_backward", backward), ("train_update", update)]

    for _ in range(2):
        state, _ = step(state, next(data))
    torch.cuda.synchronize()
    for i in range(3):
        t0 = time.perf_counter()
        state, m = step(state, next(data))
        emit({"phase": "timing", "what": "train_step", "step": i, "ms": since(t0), "loss": float(m["loss"])})
    for i in range(2):
        ms = {}
        for name, fn in parts(state):
            t0 = time.perf_counter()
            fn()
            ms[name] = since(t0)
        state = TrainState(state.params, state.opt._replace(step=state.opt.step + 1))
        emit({"phase": "timing", "what": "train_parts", "step": i, "ms": ms, "sum_ms": sum(ms.values())})
    for name, fn in parts(state):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall = since(t0)
        report(prof, name, wall, 1)


def print_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def report(prof, what: str, wall_ms: float, calls: int, **extra) -> None:
    """The ``profile`` and ``top`` lines of one traced window; ``top`` also
    gives every kernel of the repo's own library (``repro::``) by name."""
    device_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in device_events) / 1e3
    emit({
        "phase": "profile", "what": what, "calls": calls, "wall_ms_per_call": wall_ms / calls,
        "device_busy_ms_per_call": busy / calls, "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
        "device_events_per_call": len(device_events) / calls, **extra,
    })
    avg = prof.key_averages()
    by_dev_all = sorted(avg, key=lambda e: e.self_device_time_total, reverse=True)
    by_dev = by_dev_all[:12]
    by_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    emit({
        "phase": "top", "what": what,
        "device_ms_per_call": [[e.key[:60], e.self_device_time_total / 1e3 / calls, e.count / calls] for e in by_dev],
        "host_ms_per_call": [[e.key[:60], e.self_cpu_time_total / 1e3 / calls, e.count / calls] for e in by_cpu],
        "repro_kernels_ms_per_call": [[e.key[:60], e.self_device_time_total / 1e3 / calls, e.count / calls]
                                      for e in by_dev_all if "repro::" in e.key],
    })


def profile_continuous(cfg, params) -> None:
    """One unprofiled and one traced ``serve_continuous`` of the chip smoke
    test's continuous traffic with the prefix cache on; the traced window is
    the whole run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import CONT_BLOCK, CONT_MAX_BATCH, cont_requests
    from repro_torch.serving import InferenceEngine, Request

    def serve():
        eng = InferenceEngine(cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK,
                              prefix_cache=True)
        for p, g in cont_requests(cfg):
            eng.submit(Request(prompt=p, max_new_tokens=g))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve_continuous()
        torch.cuda.synchronize()
        return eng, (time.perf_counter() - t0) * 1e3

    what = "continuous_prefix"
    with torch.inference_mode():
        serve()  # warm-up
        eng, wall = serve()
        st = eng.stats
        emit({"phase": "timing", "what": what, "wall_ms": wall, "decode_steps": st.decode_steps,
              "prefill_chunks": st.prefill_chunks, "fused_steps": st.fused_steps,
              "decode_step_ms_mean": st.decode_step_ms_sum / st.decode_steps})
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng, wall = serve()
    report(prof, what, wall, 1, decode_steps=eng.stats.decode_steps, prefill_chunks=eng.stats.prefill_chunks)
    print_card()


if __name__ == "__main__":
    sys.exit(main())
