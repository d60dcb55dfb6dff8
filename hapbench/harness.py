"""One run of one cell: set-up, the timed window, the metrics, the check.

Set-up makes the weights on the device from the seed, builds
``repro_torch.serving.InferenceEngine`` with the traffic's engine options
(no session; on the card paged, captured steps, the hand kernels) and
serves one small warm job of the cell's own shapes, which also loads the
kernel library. The window then serves jobs back to back, each a queue of
requests ``submit``-ted at once and drained by ``serve_continuous`` (or
``run``), and starts a further job only while ``seconds`` remain: every
metric counts whole jobs, their fixed costs included. With ``trace`` one
more job follows the window, of which ``torch.profiler`` records a slice
of engine steps (``trace_steps`` of the traffic): the device metrics read
that slice, the host metrics the untraced window. After that, once the
window's memory peak is read and the engine is gone, the plain reference
checks a sample of what the window served (``check``).

The harness reads the engine's public counters (``stats``, ``steps.stats``)
and, of the program's private names, only the launch-shape counter
``repro_torch.kernels._build.SHAPE_COUNTS``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from hapbench import check, manifest, trace as trace_mod, traffic as traffic_mod, weights
from hapbench.reference import model as reference


@dataclasses.dataclass
class Record:
    """What a metric reads: the window's work, time and counters."""

    config: Dict
    traffic: Dict
    setup_s: float
    window_s: float  # host clock, first job's submit to last job's end
    jobs: int
    requests: List[Tuple[int, int]]  # (prompt tokens, new tokens) of each request of the window
    generated: int  # tokens the window's completions carry
    stats: Dict[str, float]  # ``engine.stats`` over the window
    capture: Dict[str, float]  # ``engine.steps.stats`` over the window
    prefill_ms: float  # the completions' ``prefill_ms``: their unfused chunk steps
    shapes: Dict[tuple, int]  # launches by (kernel, shape) in the traced steps
    memory_peak_bytes: Optional[int]
    trace: Optional[trace_mod.Trace] = None


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` from a configuration file's fields."""
    from repro_torch.configs import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in fields})


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(engine, reqs: List[traffic_mod.Req], mode: str) -> list:
    """One job: submit every request, drain the queue; each request's
    completion (None where none came)."""
    from repro_torch.serving import Request

    uids = [engine.submit(Request(prompt=r.prompt, max_new_tokens=r.new_tokens)) for r in reqs]
    comps = engine.serve_continuous() if mode == "continuous" else engine.run()
    by_uid = {c.uid: c for c in comps}
    return [by_uid.get(u) for u in uids]


def _counters(engine) -> Tuple[Dict, Dict, collections.Counter]:
    from repro_torch.kernels import _build

    return (dataclasses.asdict(engine.stats), dataclasses.asdict(engine.steps.stats),
            collections.Counter(_build.SHAPE_COUNTS))


def _delta(after: Dict, before: Dict) -> Dict:
    return {k: v - before[k] for k, v in after.items() if isinstance(v, (int, float))}


def _traced_job(engine, reqs: List[traffic_mod.Req], mode: str, steps: Dict, dev: torch.device,
                out: Optional[Path]) -> Tuple[Optional[trace_mod.Trace], Dict[tuple, int]]:
    """Serve one more job with ``torch.profiler`` recording the engine steps
    ``steps["first"]`` to ``steps["first"] + steps["count"] - 1`` (through the
    engine's public ``step``), inside the span ``trace.WINDOW``. Returns the
    trace and the kernel launches by shape of those steps."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    span = torch.profiler.record_function(trace_mod.WINDOW)
    first, last = steps["first"], steps["first"] + steps["count"]
    state = {"n": 0, "on": False, "shapes": None}
    real_step = engine.step

    def stop():
        _sync(dev)
        span.__exit__(None, None, None)
        prof.stop()
        state["on"] = False
        state["shapes"] = dict(_counters(engine)[2] - state["shapes"])

    def step(*args, **kwargs):
        if state["n"] == first:
            state["shapes"] = _counters(engine)[2]
            prof.start()
            span.__enter__()
            state["on"] = True
        ran = real_step(*args, **kwargs)
        state["n"] += 1
        if state["n"] == last and state["on"]:
            stop()
        return ran

    engine.step = step
    try:
        _serve(engine, reqs, mode)
    finally:
        del engine.step
        if state["on"]:  # a job shorter than the slice: the trace ends with it
            stop()
    if state["shapes"] is None:
        return None, {}
    return trace_mod.read(prof, out), state["shapes"]


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
             out_dir: Optional[Path] = None, control: bool = False) -> Dict:
    """One run: set-up, the window, the metrics, the check. Returns the
    result line's object, with ``checks`` last. ``control`` adds
    ``control``: for the program, the float8 control and the bf16 witness on
    the same sample, a summary of the gaps and the verdict of ``check.verdict``
    at the cell's limit (for the stand-ins with their ``checks``); the
    benchmark's own runs never ask for it."""
    from repro_torch.serving import InferenceEngine

    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    mode = traffic.get("serve", "continuous")
    opts = dict(traffic["engine"])
    if dev.type != "cuda":
        opts["kernel_backend"] = "ref"  # the hand kernels run on the card only
    marks = {"start": time.perf_counter()}
    params = weights.make(cfg, seed, dev)
    _sync(dev)
    marks["weights"] = time.perf_counter()
    engine = InferenceEngine(model_config(cfg), params, device=dev, **opts)
    if engine.scheduler.bucket != traffic["prompt_bucket"]:
        raise ValueError(f"the engine pads prompts to multiples of {engine.scheduler.bucket}, the traffic file says "
                         f"{traffic['prompt_bucket']}")
    marks["engine"] = time.perf_counter()
    _serve(engine, traffic_mod.warm_job(traffic, cfg["vocab_size"], seed), mode)
    _sync(dev)

    stats0, capture0, _ = _counters(engine)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    done: List[Tuple[traffic_mod.Req, object]] = []
    jobs = 0
    t_open = time.perf_counter()
    while True:
        reqs = traffic_mod.job(traffic, cfg["vocab_size"], seed, jobs)
        done.extend(zip(reqs, _serve(engine, reqs, mode)))
        jobs += 1
        if time.perf_counter() - t_open >= seconds:
            break
    _sync(dev)
    t_close = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    stats1, capture1, _ = _counters(engine)

    comps = [c for _, c in done if c is not None]
    rec = Record(
        config=cfg, traffic=traffic, setup_s=t_open - t0, window_s=t_close - t_open, jobs=jobs,
        requests=[(len(r.prompt), r.new_tokens) for r, _ in done],
        generated=sum(len(c.tokens) for c in comps),
        stats=_delta(stats1, stats0), capture=_delta(capture1, capture0),
        prefill_ms=sum(c.prefill_ms for c in comps), shapes={}, memory_peak_bytes=peak,
    )
    marks["window"] = time.perf_counter()
    if trace:
        out = out_dir / f"{cell.name}.{seed}.trace.npz" if out_dir is not None else None
        rec.trace, rec.shapes = _traced_job(engine, traffic_mod.job(traffic, cfg["vocab_size"], seed, jobs), mode,
                                            traffic["trace_steps"], dev, out)
    marks["trace_read"] = time.perf_counter()
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs beside the weights
    engine.close()
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    finished = [(r.prompt, r.new_tokens, list(c.tokens)) for r, c in done
                if c is not None and c.status == "ok" and len(c.tokens) == r.new_tokens]
    picked = check.sample(finished, traffic, seed)
    rows = [check.served_row(finished[i][0], finished[i][2], traffic["prompt_bucket"]) for i in picked]
    ref = reference.logits(params, cfg, rows) if picked else None  # float32, at the served positions
    served = check.served_gaps(ref, [finished[i][2] for i in picked]) if picked else None
    gap = float(served.mean()) if served is not None else None
    checks, correct = check.verdict(gap, len(done) - len(finished), cell.limits)
    marks["check"] = time.perf_counter()

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(done), "failed": len(done) - len(finished),
              "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        device_info.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        result["breakdown"] = trace_mod.breakdown(rec.trace)
    seconds = {"to_start": marks["start"] - t0, "weights": marks["weights"] - marks["start"],
               "engine": marks["engine"] - marks["weights"], "warm": t_open - marks["engine"],
               "traced_job": marks["trace_read"] - marks["window"], "check": marks["check"] - marks["trace_read"]}
    result["detail"] = {
        "max_logit_gap": float(served.max()) if served is not None else None,
        "checked_tokens": sum(len(finished[i][2]) for i in picked), "jobs": jobs, "window_s": rec.window_s,
        "setup_s": rec.setup_s, "generated": rec.generated, "requests": len(rec.requests),
        "prefill_ms": rec.prefill_ms,
        **{k: rec.stats[k] for k in ("decode_steps", "fused_steps", "prefill_chunks", "joins", "decode_step_ms_sum")},
        **{k: rec.capture[k] for k in ("captures", "capture_ms", "replays", "eager_runs")},
        "trace_events": rec.trace.events if rec.trace is not None else None, "seconds": seconds,
    }
    if control and picked:
        result["control"] = {"program": dict(_summary(served), correct=correct)}
        for p in ("fp8", "bf16"):
            g = check.stand_in_gaps(ref, params, cfg, rows, p)
            # the stand-in in the program's place, judged by the same rule at the
            # cell's own limit; it serves the same sample, every request whole
            judged, ok = check.verdict(float(g.mean()), 0, cell.limits)
            result["control"][p] = dict(_summary(g), checks=judged, correct=ok)
    result["checks"] = checks
    return result


def _summary(g) -> Dict[str, float]:
    """A set of gaps: their mean, widest, median, 99th percentile and the
    share that is not zero."""
    q = g.float().quantile(torch.tensor([0.5, 0.99]))
    return {"mean": float(g.mean()), "max": float(g.max()), "p50": float(q[0]), "p99": float(q[1]),
            "nonzero": float((g > 0).float().mean()), "n": int(g.numel())}


def as_lines(checks: Dict) -> List[str]:
    """Each number compared beside its limit, one line each."""
    return [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
