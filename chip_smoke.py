#!/usr/bin/env python3
"""Chip smoke test of the repro_torch port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of compute capability 9.0 and ``nvcc``, imports nothing of JAX
or of the JAX package, and exits non-zero on any failure. Phases, each
printing one JSON line:

1. build   - compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
2. kernels - each kernel against its plain PyTorch version at the main
             path's full-width shapes, with times, bounds and yardsticks
3. serve   - DeepSeekMoE-16B at full width and depth (28 layers, bf16,
             seeded random weights): 8 requests through
             ``InferenceEngine.run()``, with the launch counts of that run
4. agree   - the first batch's prefill + 15 decode steps on the hopper and
             the ref backends, teacher-forced, logits compared

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

SEED = 0
N_REQUESTS = 8
MAX_BATCH = 4
MAX_NEW = 16

# agree phase: hopper vs ref logits, both in bfloat16 on the same weights
# and the same (teacher-forced) tokens. The two paths round differently:
# the attention kernels keep the softmax probabilities in float32 for P@V
# where the ref path rounds them to bfloat16, and the paths sum in other
# orders, each bf16 result rounding at 2^-8 relative. Through 28 layers of
# random weights such differences grow, and where the router's top-6 has a
# near-tie the two paths pick another expert for a token. The same kernels
# agree with ref to 1e-4 in float32 (tests/test_torch_gpu.py), so what is
# left is rounding. A wrong kernel gives unrelated logits: relative L2
# error near sqrt(2). The bounds sit above what the H100 showed (PERF.md).
AGREE_L2_TOL = 0.25  # ||hopper - ref|| / ||ref|| over each step's (B, V) logits
AGREE_MAX_TOL = 0.5  # max |hopper - ref| / max |ref| over each step's logits


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time per call from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, atol: float, rtol: float, what: str) -> dict:
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    ok = bool((err <= atol + rtol * want.abs()).all())
    res = {"max_abs_err": err.max().item(), "max_rel_err": err.max().item() / max(want.abs().max().item(), 1e-30),
           "atol": atol, "rtol": rtol}
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version: {res}")
    return res


# bf16 outputs: both sides sum in float32 and round once to bfloat16, so
# they may differ by one bf16 step (2^-8 relative) plus f32 order noise.
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 2e-2


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    # the compiler's report: registers per kernel and any spills
    report = path.with_suffix(".log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", report)]
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path, ROOT),
          "kernels_compiled": len(regs), "max_registers": max(regs), "spill_store_bytes": sum(spills)})


def phase_kernels(cfg) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    H, hd = cfg.num_heads, cfg.head_dim
    B, S = MAX_BATCH, 128
    Smax = S + MAX_NEW + 1

    def randn(*shape, std=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev, bf16)

    rows = []

    # flash attention at the prefill shape, on the model layout's views
    q, k, v = (randn(B, S, H, hd).transpose(1, 2) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    acc = compare(out, fa.flash_attention_plain(q, k, v), KERNEL_ATOL, KERNEL_RTOL, "flash_attention")
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(4 * B * S * H * hd * 2, 4 * hd * B * H * pairs)
    rows.append({
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105", "shape": f"B={B} S={S} H={H} hd={hd} bf16 causal",
        **acc,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 200),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 200),
        "library": "torch.nn.functional.scaled_dot_product_attention",
    })

    # paged attention at a decode step: identity table over the contiguous cache
    pos0 = S + MAX_NEW // 2 - 1
    qd, kn, vn = randn(B, 1, H, hd), randn(B, 1, H, hd), randn(B, 1, H, hd)
    kc, vc = randn(B, Smax, H, hd), randn(B, Smax, H, hd)
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    posv = torch.full((B,), pos0, dtype=torch.int32, device=dev)
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = pa.paged_attention(qd, kc, vc, tables, kn, vn, posv)
    torch.cuda.synchronize()
    want, kw, vw = pa.paged_attention_plain(qd, kc2, vc2, tables, kn, vn, posv)
    acc = compare(out, want, KERNEL_ATOL, KERNEL_RTOL, "paged_attention")
    if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
        raise AssertionError("paged_attention: appended pages differ from the plain version's")
    # q, k_new, v_new and out once; the cached K/V below pos0 read once;
    # the appended slot written once; 4 flops per (query, key, dim)
    nbytes = 2 * (4 * B * H * hd + 2 * B * pos0 * H * hd + 2 * B * H * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * B * H * (pos0 + 1))
    rows.append({
        "name": "paged_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:336",
        "shape": f"B={B} C=1 H={H} hd={hd} Smax={Smax} pos={pos0} identity table bf16", **acc,
        "ms": cuda_ms(lambda: pa.paged_attention(qd, kc, vc, tables, kn, vn, posv), 200),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_plain(qd, kc2, vc2, tables, kn, vn, posv), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library": None,
    })

    # grouped matmul: decode (C=8) and prefill (C=64) capacities, both layers
    E, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff
    gmm_rows = []
    for C, (k_in, n_out), which in ((8, (d, f), "wi"), (8, (f, d), "wo"), (64, (d, f), "wi"), (64, (f, d), "wo")):
        lhs = randn(E, C, k_in)
        lhs[:, -1] = 0  # an empty capacity slot
        rhs = randn(E, k_in, n_out, std=k_in**-0.5)
        out = gm.grouped_matmul(lhs, rhs)
        torch.cuda.synchronize()
        acc = compare(out, gm.grouped_matmul_plain(lhs, rhs), KERNEL_ATOL, KERNEL_RTOL, f"grouped_matmul C={C}")
        if torch.count_nonzero(out[:, -1]):
            raise AssertionError("grouped_matmul: an empty capacity slot came out non-zero")
        b_ms, b_by = bound(2 * (E * C * k_in + E * k_in * n_out + E * C * n_out), 2 * E * C * k_in * n_out)
        gmm_rows.append({
            "shape": f"E={E} C={C} {k_in}x{n_out} ({which}) bf16", **acc,
            "ms": cuda_ms(lambda: gm.grouped_matmul(lhs, rhs), 20),
            "plain_ms": cuda_ms(lambda: gm.grouped_matmul_plain(lhs, rhs), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.bmm(lhs, rhs), 20),
        })
        del lhs, rhs, out
    main, also = gmm_rows[0], gmm_rows[1:]
    rows.append({
        "name": "grouped_matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:45", **main, "library": "torch.bmm", "also": also,
    })
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": rows})
    return rows


def prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 129, N_REQUESTS)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def phase_serve(cfg, params) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine, Request

    eng = InferenceEngine(cfg, params, max_batch=MAX_BATCH)
    for p in prompts(cfg):
        eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    comps = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCH_COUNTS)
    dispatch = dict(ops.DISPATCH_COUNTS)

    if len(comps) != N_REQUESTS or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError(f"serve: expected {N_REQUESTS} completions of {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for c in comps for t in c.tokens):
        raise AssertionError("serve: a token outside the vocabulary")
    batches = math.ceil(N_REQUESTS / MAX_BATCH)
    L, steps = cfg.num_layers, MAX_NEW - 1
    expect = {
        "flash_attention": batches * L,
        "paged_attention": batches * steps * L,
        "grouped_matmul": batches * (1 + steps) * 3 * L,
    }
    if launches != expect:
        raise AssertionError(f"serve: launches {launches}, expected {expect}")
    refs = {k: n for k, n in dispatch.items() if "ref" in k}
    if refs:
        raise AssertionError(f"serve: ref ops ran on the main path: {refs}")
    per_batch = comps[::MAX_BATCH]  # one completion per batch: uids fill batches in order
    prefill_ms = [c.prefill_ms for c in per_batch]
    step_ms = [c.decode_ms / steps for c in per_batch]
    tokens = sum(len(c.tokens) for c in comps)
    res = {
        "phase": "serve", "model": cfg.name, "layers": L, "dtype": cfg.dtype, "requests": len(comps),
        "batches": eng.stats.batches, "tokens": tokens, "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
        "tokens_per_s": tokens / wall, "wall_s": wall, "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "dispatch": dispatch,
    }
    emit(res)
    res["first_batch_tokens"] = [c.tokens for c in comps[:MAX_BATCH]]
    return res


def phase_agree(cfg, params, serve) -> None:
    import torch

    from repro_torch.models import decode_step, prefill
    from repro_torch.serving.scheduler import FifoScheduler

    sched = FifoScheduler(max_batch=MAX_BATCH)
    for p in prompts(cfg)[:MAX_BATCH]:
        sched.submit(p, MAX_NEW)
    toks, _ = sched.pad_batch(sched.next_batch())
    tokens = torch.as_tensor(toks, dtype=torch.long, device="cuda")
    max_len = toks.shape[1] + MAX_NEW + 1

    with torch.inference_mode():
        logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len, backend="hopper")
        hop, forced = [logits.float()], [logits.argmax(-1)]
        for _ in range(MAX_NEW - 1):
            logits, cache = decode_step(params, cfg, forced[-1][:, None], cache, backend="hopper")
            hop.append(logits.float())
            forced.append(logits.argmax(-1))
        del cache
        greedy = torch.stack(forced, 1).tolist()
        if greedy != serve["first_batch_tokens"]:
            raise AssertionError("agree: direct hopper decode differs from the engine's tokens")
        logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len, backend="ref")
        max_err, l2_err, argmax_same = [], [], 0
        for step in range(MAX_NEW):
            if step:
                logits, cache = decode_step(params, cfg, forced[step - 1][:, None], cache, backend="ref")
            ref = logits.float()
            if not torch.isfinite(hop[step]).all():
                raise AssertionError(f"agree: non-finite hopper logits at step {step}")
            diff = hop[step] - ref
            max_err.append(diff.abs().max().item() / ref.abs().max().item())
            l2_err.append((diff.norm() / ref.norm()).item())
            argmax_same += int((hop[step].argmax(-1) == ref.argmax(-1)).sum())
        del cache
    res = {"phase": "agree", "steps": MAX_NEW, "rel_l2_err_per_step": l2_err, "rel_l2_tol": AGREE_L2_TOL,
           "max_rel_err_per_step": max_err, "max_rel_tol": AGREE_MAX_TOL,
           "argmax_agreement": argmax_same / (MAX_NEW * MAX_BATCH)}
    emit(res)
    if max(l2_err) > AGREE_L2_TOL or max(max_err) > AGREE_MAX_TOL:
        raise AssertionError(f"agree: hopper and ref logits differ beyond the bf16 tolerance: {res}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
    except ImportError as e:
        print(f"chip_smoke: run from the root of a repro checkout ({e})", file=sys.stderr)
        return 1

    cfg = get_config("deepseek-moe-16b")
    phase_build()
    rows = phase_kernels(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "params": sum(t.numel() for t in _leaves(params)), "bytes": torch.cuda.memory_allocated()})
    serve = phase_serve(cfg, params)
    phase_agree(cfg, params, serve)
    for r in rows:
        r["launches"] = serve["launches"].get(r["name"], 0)
    emit({"kernels": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    sys.exit(main())
