#!/usr/bin/env python3
"""Where a serving step's time goes on the card: a torch.profiler trace of
the port's prefill and decode at DeepSeekMoE-16B full width.

Run from the root of a checkout on a machine with one CUDA sm_90 card:
``python3 tools/profile_decode.py``. It builds the kernels, makes seeded
random weights, prefills 4 prompts of 128 tokens (the chip smoke test's
batch) and then reports, as JSON lines:

- ``timing``: host wall ms per prefill and per decode step, each ending in
  a sync, without the profiler (the numbers the engine sees);
- ``profile``: for one traced prefill and ``--steps`` traced decode steps,
  the device busy ms (the sum of kernel and copy times on the card), the
  device idle share of the traced wall time, and the launches per step;
- ``top``: the operations with the most device time and the most host time.

The profiler adds host overhead of its own, so the idle share it shows is
an upper bound; ``timing`` is the undisturbed wall clock.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="decode steps traced")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("deepseek-moe-16b")
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    B, S, new = 4, 128, 16
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(1, cfg.vocab_size, (B, S))).to(dev)

    def run_prefill():
        logits, cache = prefill(params, cfg, {"tokens": toks}, S + new + 1)
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
            device_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
            busy = sum(e.device_time_total for e in device_events) / 1e3
            emit({
                "phase": "profile", "what": name, "calls": n, "wall_ms_per_call": wall / n,
                "device_busy_ms_per_call": busy / n, "device_idle_share": 1 - busy / wall if wall else None,
                "device_events_per_call": len(device_events) / n,
            })
            avg = prof.key_averages()
            by_dev = sorted(avg, key=lambda e: e.self_device_time_total, reverse=True)[:10]
            by_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
            emit({
                "phase": "top", "what": name,
                "device_ms_per_call": [[e.key[:60], e.self_device_time_total / 1e3 / n, e.count / n] for e in by_dev],
                "host_ms_per_call": [[e.key[:60], e.self_cpu_time_total / 1e3 / n, e.count / n] for e in by_cpu],
            })
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
