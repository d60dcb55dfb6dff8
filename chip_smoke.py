#!/usr/bin/env python3
"""Chip smoke test of the repro_torch port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of compute capability 9.0 and ``nvcc``, imports nothing of JAX
or of the JAX package, and exits non-zero on any failure. Phases, each
printing one JSON line:

1. build   - compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
2. kernels - each kernel against its plain PyTorch version at the main
             path's full-width shapes, with times, bounds and yardsticks;
             flash and the grouped matmul also at a 2048-token prompt and at
             the fused-step capacity, the paged kernel also at a 64-token
             prefill chunk; each row naming the variant its launch plan took
             (wgmma / split / simt), two calls bit-equal
3. serve   - DeepSeekMoE-16B at full width and depth (28 layers, bf16,
             seeded random weights): 8 requests through
             ``InferenceEngine.run()``, with the launch counts of that run
4. agree   - the first batch's prefill + 15 decode steps on the hopper and
             the ref backends, teacher-forced, logits compared
5. continuous - the same model and weights through
             ``InferenceEngine(max_batch=8, kv_block_size=16).serve_continuous()``:
             16 requests whose 256-token prompts share a 192-token system
             prompt, served with the prefix cache off, then on; the tokens
             must be equal and the launch counts exact
6. resident - the same model from resident INT4 experts through
             ``HAPSession(cfg, "h100", 1, source=fixed_plan("TP1", "TP2",
             "EP2", mechanism="int4_upload")).engine(params, max_batch=4,
             resident_int4=True, use_int4_transition=True)``: the serve
             phase's 8 requests through ``run()`` with async transitions on,
             then off (equal tokens; one int4_dequant launch per expert
             matmul); then the dense params' expert leaves are overwritten
             in place with the dequantized backup and a dense engine must
             give the resident tokens; then the continuous traffic with the
             prefix cache on, resident against dense round-trip
7. transitions - 4 layers at full width, dense expert leaves, the same
             pinned plan with ``use_int4_transition=True``: async and sync
             tokens equal, restored leaves bit-equal to the numpy dequant
             of the same backup, the restores' int4_dequant launches counted

Every engine runs its steps captured in CUDA graphs (``capture_steps``, the
default on the card; ``repro_torch.serving.step_cache``). The serve phase,
both continuous runs and the resident phase's async static run are each
served four times on fresh engines, eager (``capture_steps=False``), captured,
captured, eager: the tokens and the launch, variant and dispatch counts must
be equal across the four (a replay counts as the launches it replays); each
run prints its decode ms per step, prefill ms, tokens/s, peak memory, graphs
captured, capture ms and replays. The resident phase's other runs (sync, the
dense round trip, the continuous traffic) are captured, the resident
continuous run also eager.

Every serving phase also checks that each bfloat16 flash and grouped-matmul
launch on its path took the ``wgmma`` variant, and each paged and
prefix-paged launch the ``split`` variant (``_build.VARIANT_COUNTS``).

Times: ``ms`` and ``library_ms`` (and the prefix row's ``paged_ms``) are
device times per call from CUDA events around a CUDA graph of back-to-back
calls (the host's launch overhead left out, for the kernel and the library
call alike); ``eager_ms`` is the same calls issued one by one from Python,
and ``host_us`` the host's time to issue one call. Plain versions are timed
eagerly (``plain_ms``).

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
FP32_FLOPS = 67e12  # float32 outside the tensor cores

SEED = 0
N_REQUESTS = 8
MAX_BATCH = 4
MAX_NEW = 16

# continuous phase: a 192-token system prompt common to all requests, then 64
# tokens of each one's own. The shared run ends on a 64-token chunk boundary
# and a 16-token block boundary, so a follower's one remaining chunk has the
# shape it has without sharing: the MoE (capacity factor 1.25) drops tokens
# within a chunk, and other chunk boundaries would change the results.
CONT_REQUESTS = 16
CONT_MAX_BATCH = 8
CONT_BLOCK = 16
CONT_SYSTEM, CONT_OWN = 192, 64
CONT_MAX_NEW = (8, 16, 32)  # cycled over the requests

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


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device time per call of ``fn`` captured ``reps`` times into one
    CUDA graph: events around ``replays`` replays, after a warm-up call and
    a warm-up replay."""
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
    del g
    return start.elapsed_time(stop) / (replays * reps)


def host_us(fn, reps: int = 20) -> float:
    """Host microseconds to issue one call (the device is not waited for)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def timed_row(fn, library, reps: int) -> dict:
    """The kernel and its library yardstick, each by graph and eagerly."""
    return {
        "ms": graph_ms(fn, reps), "eager_ms": cuda_ms(fn, reps), "host_us": host_us(fn),
        "library_ms": graph_ms(library, reps), "library_eager_ms": cuda_ms(library, reps),
        "library_host_us": host_us(library),
    }


def kernel_times(fn, reps: int) -> dict:
    """A kernel with no library yardstick, by graph and eagerly."""
    return {"ms": graph_ms(fn, reps), "eager_ms": cuda_ms(fn, reps), "host_us": host_us(fn)}


def variant_counts() -> dict:
    """``_build.VARIANT_COUNTS`` as ``{"kernel/variant": n}``."""
    from repro_torch.kernels import _build

    return {f"{k}/{v}": n for (k, v), n in sorted(_build.VARIANT_COUNTS.items())}


# the variant every launch of a kernel on the bfloat16 serving path takes
PATH_VARIANTS = {"flash_attention": "wgmma", "grouped_matmul": "wgmma", "paged_attention": "split",
                 "prefix_paged_attention": "split"}


def check_variants(name: str, launches: dict) -> dict:
    """Every flash and grouped-matmul launch of the run just made took the
    wgmma variant, every paged and prefix-paged launch the split variant
    (the path is bfloat16 at widths TMA and 16-byte loads describe)."""
    got = variant_counts()
    for k, v in PATH_VARIANTS.items():
        if launches.get(k, 0) != got.get(f"{k}/{v}", 0):
            raise AssertionError(f"{name}: {k} launches {launches.get(k, 0)}, {v} variant {got}")
    return got


def bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
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


def ref_ops(dispatch: dict) -> dict:
    """The dispatch branches that served the plain ``ref`` backend: keys
    ``op.ref`` or ``op.ref_<layout>`` (``decode.hopper_prefix`` is not one)."""
    return {k: n for k, n in dispatch.items() if k.split(".", 1)[1].split("_")[0] == "ref"}


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
    # per entry function: the wgmma kernels must not spill
    entries = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                         report, re.S)
    wgmma = [(int(sp), int(rg)) for name, sp, rg in entries if "wgmma" in name]
    if not wgmma or any(sp for sp, _ in wgmma):
        raise AssertionError(f"build: wgmma kernels missing or spilling: {wgmma}")
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path, ROOT),
          "kernels_compiled": len(regs), "max_registers": max(regs), "spill_store_bytes": sum(spills),
          "wgmma_kernels": len(wgmma), "wgmma_max_registers": max(rg for _, rg in wgmma),
          "wgmma_spill_store_bytes": 0})


def phase_kernels(cfg) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
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

    # flash attention at the prefill shape, on the model layout's views, and
    # at one 2048-token prompt
    flash_rows = []
    for fb, fs in ((B, S), (1, 2048)):
        q, k, v = (randn(fb, fs, H, hd).transpose(1, 2) for _ in range(3))
        _build.VARIANT_COUNTS.clear()
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        variant = variant_counts()
        acc = compare(out, fa.flash_attention_plain(q, k, v), KERNEL_ATOL, KERNEL_RTOL, f"flash_attention S={fs}")
        if not torch.equal(out, fa.flash_attention(q, k, v)):
            raise AssertionError(f"flash_attention S={fs}: two calls differ")
        pairs = fs * (fs + 1) // 2
        b_ms, b_by = bound(4 * fb * fs * H * hd * 2, 4 * hd * fb * H * pairs)
        reps = 200 if fs <= 128 else 20
        flash_rows.append({
            "shape": f"B={fb} S={fs} H={H} hd={hd} bf16 causal", "variant": variant, **acc, "bit_equal_calls": True,
            **timed_row(lambda: fa.flash_attention(q, k, v),
                        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 20 if fs <= 128 else 3),
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del q, k, v, out
    rows.append({
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105", **flash_rows[0],
        "library": "torch.nn.functional.scaled_dot_product_attention", "also": flash_rows[1:],
    })

    # paged attention at a decode step: identity table over the contiguous cache
    pos0 = S + MAX_NEW // 2 - 1
    qd, kn, vn = randn(B, 1, H, hd), randn(B, 1, H, hd), randn(B, 1, H, hd)
    kc, vc = randn(B, Smax, H, hd), randn(B, Smax, H, hd)
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    posv = torch.full((B,), pos0, dtype=torch.int32, device=dev)
    kc2, vc2 = kc.clone(), vc.clone()
    _build.VARIANT_COUNTS.clear()
    out, _, _ = pa.paged_attention(qd, kc, vc, tables, kn, vn, posv)
    torch.cuda.synchronize()
    variant = variant_counts()
    want, kw, vw = pa.paged_attention_plain(qd, kc2, vc2, tables, kn, vn, posv)
    acc = compare(out, want, KERNEL_ATOL, KERNEL_RTOL, "paged_attention")
    if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
        raise AssertionError("paged_attention: appended pages differ from the plain version's")
    if not torch.equal(out, pa.paged_attention(qd, kc, vc, tables, kn, vn, posv)[0]):
        raise AssertionError("paged_attention: two calls differ")
    # q, k_new, v_new and out once; the cached K/V below pos0 read once;
    # the appended slot written once; 4 flops per (query, key, dim)
    nbytes = 2 * (4 * B * H * hd + 2 * B * pos0 * H * hd + 2 * B * H * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * B * H * (pos0 + 1))
    rows.append({
        "name": "paged_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:336",
        "shape": f"B={B} C=1 H={H} hd={hd} Smax={Smax} pos={pos0} identity table bf16", "variant": variant, **acc,
        "bit_equal_calls": True, **kernel_times(lambda: pa.paged_attention(qd, kc, vc, tables, kn, vn, posv), 200),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_plain(qd, kc2, vc2, tables, kn, vn, posv), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library": None,
        "also": [paged_chunk_row(cfg, rng, dev)],
    })
    rows.append(prefix_row(cfg, rng, dev))

    # grouped matmul: decode (C=8), fused chunk + decode (C=16) and prefill
    # (C=64) capacities, both layers
    E, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff
    gmm_rows = []
    for C in (8, 16, 64):
        for (k_in, n_out), which in (((d, f), "wi"), ((f, d), "wo")):
            lhs = randn(E, C, k_in)
            lhs[:, -1] = 0  # an empty capacity slot
            rhs = randn(E, k_in, n_out, std=k_in**-0.5)
            _build.VARIANT_COUNTS.clear()
            out = gm.grouped_matmul(lhs, rhs)
            torch.cuda.synchronize()
            variant = variant_counts()
            acc = compare(out, gm.grouped_matmul_plain(lhs, rhs), KERNEL_ATOL, KERNEL_RTOL, f"grouped_matmul C={C}")
            if torch.count_nonzero(out[:, -1]):
                raise AssertionError("grouped_matmul: an empty capacity slot came out non-zero")
            if not torch.equal(out, gm.grouped_matmul(lhs, rhs)):
                raise AssertionError(f"grouped_matmul C={C} {which}: two calls differ")
            b_ms, b_by = bound(2 * (E * C * k_in + E * k_in * n_out + E * C * n_out), 2 * E * C * k_in * n_out)
            row = {
                "shape": f"E={E} C={C} {k_in}x{n_out} ({which}) bf16", "variant": variant, **acc, "bit_equal_calls": True,
                **timed_row(lambda: gm.grouped_matmul(lhs, rhs), lambda: torch.bmm(lhs, rhs), 20),
                "plain_ms": cuda_ms(lambda: gm.grouped_matmul_plain(lhs, rhs), 5),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            row["share_of_bound"] = b_ms / row["ms"]
            if C == 8 and which == "wi":
                # the host cost of a tensor-map encode: new lhs buffers each call
                # (a map-cache miss) against the same buffer (a hit)
                fresh = [torch.empty_like(lhs) for _ in range(20)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for x in fresh:
                    gm.grouped_matmul(x, rhs)
                row["host_us_new_buffers"] = (time.perf_counter() - t0) / len(fresh) * 1e6
                torch.cuda.synchronize()
                del fresh
            gmm_rows.append(row)
            del lhs, rhs, out
    main, also = gmm_rows[0], gmm_rows[1:]
    rows.append({
        "name": "grouped_matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:45", **main, "library": "torch.bmm", "also": also,
    })
    rows.append(int4_row(cfg, rng, dev))
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": rows})
    return rows


def int4_row(cfg, rng, dev) -> dict:
    """The dequant kernel at the main path's shape, one layer's expert leaf
    in 128-wide groups, into bf16 (the serving type) and into float32; each
    bit-equal to the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import int4_dequant as dq

    gs = 128
    G = cfg.n_routed_experts * cfg.d_model * cfg.moe_d_ff // gs
    packed = torch.from_numpy(rng.integers(0, 256, (G, gs // 2), dtype=np.uint8)).to(dev)
    scales = torch.from_numpy(rng.uniform(1e-3, 0.1, (G, 1)).astype(np.float32)).to(dev)
    zeros = torch.from_numpy(rng.uniform(-1.0, 1.0, (G, 1)).astype(np.float32)).to(dev)
    out_rows = []
    for dt, nb in ((torch.bfloat16, 2), (torch.float32, 4)):
        out = dq.int4_dequant(packed, scales, zeros, out_dtype=dt)
        torch.cuda.synchronize()
        want = dq.int4_dequant_plain(packed, scales, zeros, dt)
        if not torch.equal(out, want):
            raise AssertionError(f"int4_dequant ({dt}): not bit-equal to its plain version")
        acc = compare(out, want, 0.0, 0.0, f"int4_dequant ({dt})")
        del out, want
        # packed bytes, scales and zeros read once, the output written once;
        # a multiply and an add per output element, in float32
        b_ms, b_by = bound(G * gs // 2 + 8 * G + nb * G * gs, 2 * G * gs, FP32_FLOPS)
        out_rows.append({
            "shape": f"G={G} gs={gs} -> {str(dt).split('.')[1]}", **acc, "bit_equal": True,
            "ms": cuda_ms(lambda: dq.int4_dequant(packed, scales, zeros, out_dtype=dt), 20),
            "plain_ms": cuda_ms(lambda: dq.int4_dequant_plain(packed, scales, zeros, dt), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    return {
        "name": "int4_dequant", "route": "cuda", "source": "src/repro_torch/kernels/csrc/int4_dequant.cu",
        "replaces": "src/repro/kernels/int4_dequant.py:39", **out_rows[0], "library": None, "also": out_rows[1:],
    }


def _pages(rng, n, bs, cfg, dev):
    import numpy as np
    import torch

    shape = (n, bs, cfg.num_kv_heads, cfg.head_dim)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16) for _ in range(2))


def _cont_table_width():
    """The block-table width the continuous phase's queue gives: its largest
    KV need, rounded up to the 64-token bucket, in blocks."""
    from repro_torch.serving.kv_cache import blocks_for
    from repro_torch.serving.scheduler import round_up

    return blocks_for(round_up(CONT_SYSTEM + CONT_OWN + max(CONT_MAX_NEW) + 1, 64), CONT_BLOCK)


def paged_chunk_row(cfg, rng, dev) -> dict:
    """The paged kernel at a continuous prefill chunk: one row, 64 tokens
    written at position 192 through a table of scattered real pages."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa

    H, hd, bs, nb, C, p0 = cfg.num_heads, cfg.head_dim, CONT_BLOCK, _cont_table_width(), 64, CONT_SYSTEM
    N = 8 * nb + 1
    kp, vp = _pages(rng, N, bs, cfg, dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:nb].astype(np.int32)[None]).to(dev)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((1, C, H, hd)).astype(np.float32)).to(dev, torch.bfloat16)
                 for _ in range(3))
    posv = torch.tensor([p0], dtype=torch.int32, device=dev)
    kp2, vp2 = kp.clone(), vp.clone()
    _build.VARIANT_COUNTS.clear()
    out, _, _ = pa.paged_attention(q, kp, vp, tables, kn, vn, posv)
    torch.cuda.synchronize()
    variant = variant_counts()
    want, kw, vw = pa.paged_attention_plain(q, kp2, vp2, tables, kn, vn, posv)
    acc = compare(out, want, KERNEL_ATOL, KERNEL_RTOL, "paged_attention (chunk)")
    if not (torch.equal(kp[1:], kw[1:]) and torch.equal(vp[1:], vw[1:])):
        raise AssertionError("paged_attention (chunk): appended pages differ from the plain version's")
    if not torch.equal(out, pa.paged_attention(q, kp, vp, tables, kn, vn, posv)[0]):
        raise AssertionError("paged_attention (chunk): two calls differ")
    # q, new K/V and out once, the p0 cached keys' K/V once, the chunk's K/V
    # written once; 4 flops per (query, valid key, dim)
    pairs = sum(p0 + c + 1 for c in range(C))
    b_ms, b_by = bound(2 * (4 * C * H * hd + 2 * p0 * H * hd + 2 * C * H * hd), 4 * hd * H * pairs)
    return {
        "shape": f"B=1 C={C} H={H} hd={hd} bs={bs} table {nb} scattered pages pos={p0} bf16", "variant": variant,
        **acc, "bit_equal_calls": True, **kernel_times(lambda: pa.paged_attention(q, kp, vp, tables, kn, vn, posv), 200),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_plain(q, kp2, vp2, tables, kn, vn, posv), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def prefix_row(cfg, rng, dev) -> dict:
    """The prefix kernel at the continuous decode shape: 8 rows; rows 1-7
    share 12 leading pages (the 192-token system prompt) with
    representative row 1; row 0 is on its own."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefix_paged_attention as ppa

    B, H, hd, bs, nb, shared = CONT_MAX_BATCH, cfg.num_heads, cfg.head_dim, CONT_BLOCK, _cont_table_width(), 12
    N = B * nb + 1
    kp, vp = _pages(rng, N, bs, cfg, dev)
    t = rng.permutation(np.arange(1, N)).astype(np.int32).reshape(B, nb)
    t[2:, :shared] = t[1, :shared]
    pos = np.array([262 + 2 * b for b in range(B)], np.int32)  # depths around 270
    reps = np.array([0] + [1] * (B - 1), np.int32)
    nsh = np.array([0, 0] + [shared] * (B - 2), np.int32)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32)).to(dev, torch.bfloat16)
                 for _ in range(3))
    tables, posv, reps_t, nsh_t = (torch.from_numpy(a).to(dev) for a in (t, pos, reps, nsh))
    pages = {k: (kp.clone(), vp.clone()) for k in ("kernel", "paged", "plain")}
    _build.VARIANT_COUNTS.clear()
    out, _, _ = ppa.prefix_paged_attention(q, *pages["kernel"], tables, kn, vn, posv, reps_t, nsh_t)
    torch.cuda.synchronize()
    variant = variant_counts()
    own, _, _ = pa.paged_attention(q, *pages["paged"], tables, kn, vn, posv)
    torch.cuda.synchronize()
    if not torch.equal(out, ppa.prefix_paged_attention(q, *pages["kernel"], tables, kn, vn, posv, reps_t, nsh_t)[0]):
        raise AssertionError("prefix_paged_attention: two calls differ")
    want, _, _ = ppa.prefix_paged_attention_plain(q, *pages["plain"], tables, kn, vn, posv, reps_t, nsh_t)
    acc = compare(out, want, KERNEL_ATOL, KERNEL_RTOL, "prefix_paged_attention")
    if not torch.equal(out, own):
        raise AssertionError("prefix_paged_attention: output differs from paged_attention on the rows' own tables")
    for i in (0, 1):
        if not (torch.equal(pages["kernel"][i][1:], pages["paged"][i][1:])
                and torch.equal(pages["kernel"][i][1:], pages["plain"][i][1:])):
            raise AssertionError("prefix_paged_attention: appended pages differ")
    # bytes: the shared run's K/V once for the group, each row's other keys
    # once, q, new K/V and out once, the appended slots written once
    shared_keys = shared * bs
    keys = shared_keys + sum(int(p) + 1 - (shared_keys if b >= 1 else 0) for b, p in enumerate(pos))
    nbytes = 2 * (2 * keys * H * hd + 4 * B * H * hd + 2 * B * H * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * H * int((pos + 1).sum()))
    kpk, vpk = pages["kernel"]
    kpp, vpp = pages["paged"]
    return {
        "name": "prefix_paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefix_paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:237",
        "shape": f"B={B} C=1 H={H} hd={hd} bs={bs} table {nb}, rows 1-7 share {shared} pages, pos {pos.min()}-"
                 f"{pos.max()} bf16",
        "variant": variant, **acc, "bit_equal_to_paged": True, "bit_equal_calls": True,
        **kernel_times(lambda: ppa.prefix_paged_attention(q, kpk, vpk, tables, kn, vn, posv, reps_t, nsh_t), 200),
        "plain_ms": cuda_ms(
            lambda: ppa.prefix_paged_attention_plain(q, kpp, vpp, tables, kn, vn, posv, reps_t, nsh_t), 20),
        "paged_ms": graph_ms(lambda: pa.paged_attention(q, kpp, vpp, tables, kn, vn, posv), 200),
        "paged_eager_ms": cuda_ms(lambda: pa.paged_attention(q, kpp, vpp, tables, kn, vn, posv), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library": None,
    }


def prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 129, N_REQUESTS)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


# the order of every eager/captured A/B: each mode first once and last once
AB_ORDER = (False, True, True, False)


def step_stats(eng) -> dict:
    """What the engine's step cache did: graphs captured, their capture
    time, replays, eager runs and graphs dropped by a new generation."""
    return dataclasses.asdict(eng.steps.stats)


def ab_runs(phase: str, name: str, make, serve, order=AB_ORDER) -> dict:
    """Serve one workload on fresh engines, eager (``capture_steps=False``)
    and captured, in ``order``; one JSON line per run. Every run must give
    the same tokens and the same launch, variant and dispatch counts. Where
    ``order`` has both modes, ``logits_ab`` then compares the logits in two
    more runs, outside the timed ones. Returns the first captured run's
    result (the main path) with ``ab`` = the per-run numbers."""
    import torch

    results = []
    for capture in order:
        eng = make(capture)
        res = serve(eng)
        res["capture_steps"] = capture
        res["steps"] = step_stats(eng)
        res["device"] = torch.cuda.get_device_name(0)
        if capture and (res["steps"]["captures"] == 0 or res["steps"]["replays"] == 0):
            raise AssertionError(f"{phase} ({name}): the captured run captured or replayed nothing: {res['steps']}")
        if not capture and res["steps"]["captures"]:
            raise AssertionError(f"{phase} ({name}): the eager run captured a step")
        emit({"phase": phase, "run": name, **{k: v for k, v in res.items() if k != "tokens"}})
        results.append(res)
        eng.close()
        del eng
        _free()
    main = next(r for r in results if r["capture_steps"])
    for r in results:
        if r["tokens"] != main["tokens"]:
            raise AssertionError(f"{phase} ({name}): captured and eager tokens differ")
        for k in ("launches", "variants", "dispatch"):
            if r[k] != main[k]:
                raise AssertionError(f"{phase} ({name}): {k} differ, captured {main[k]} against {r[k]}")
    keys = ("wall_s", "tokens_per_s", "decode_ms_per_step", "decode_step_ms_mean", "prefill_ms",
            "max_memory_allocated")
    main = dict(main, ab=[{"capture_steps": r["capture_steps"], **{k: r[k] for k in keys if k in r},
                           "captures": r["steps"]["captures"], "capture_ms": r["steps"]["capture_ms"],
                           "replays": r["steps"]["replays"]} for r in results])
    logits = logits_ab(phase, name, make, serve, main["tokens"]) if len(set(order)) == 2 else {}
    emit({"phase": phase, "run": name, "ab_order": ["captured" if c else "eager" for c in order],
          "tokens_equal": True, "counts_equal": True, **logits, "ab": main["ab"]})
    return main


def logits_ab(phase: str, name: str, make, serve, tokens) -> dict:
    """One eager and one captured run, untimed, that keep every logits
    tensor the engine samples from and compare them bit for bit (reported,
    not gated: the tokens are the gate, and must equal ``tokens``). The
    spy clones each step's logits on the card, so it stays out of the timed
    runs and their peak memory."""
    import torch

    from repro_torch.serving import engine as engine_mod

    sample, apply = engine_mod.sample, engine_mod.InferenceEngine._apply_sampled
    kept = {}
    for capture in (False, True):
        seen = []

        def keep(lg, params, generator=None, seen=seen):  # every logits tensor the engine samples from
            seen.append(lg.clone())
            return sample(lg, params, generator)

        def keep_rows(self, toks, active, step_ms, seen=seen):
            # a continuous step's rows whose tokens are used: an empty or
            # drained slot reads and writes the shared trash page, which
            # several such rows write in one launch, so its logits are not
            # defined
            seen[-1] = seen[-1][active]
            return apply(self, toks, active, step_ms)

        eng = make(capture)
        engine_mod.sample, engine_mod.InferenceEngine._apply_sampled = keep, keep_rows
        try:
            res = serve(eng)
        finally:
            engine_mod.sample, engine_mod.InferenceEngine._apply_sampled = sample, apply
        eng.close()
        del eng
        if res["tokens"] != tokens:
            raise AssertionError(f"{phase} ({name}): the logits pass (capture={capture}) gave other tokens")
        kept[capture] = seen
        _free()
    eager, captured = kept[False], kept[True]
    if len(eager) != len(captured):
        raise AssertionError(f"{phase} ({name}): {len(captured)} sampled steps against {len(eager)}")
    res = {"logits_steps": len(eager), "logits_bit_equal": all(torch.equal(a, b) for a, b in zip(eager, captured)),
           "logits_max_abs_diff": max((a.float() - b.float()).abs().max().item() for a, b in zip(eager, captured))}
    del kept, eager, captured
    _free()
    return res


def phase_serve(cfg, params) -> dict:
    """``run()`` of the 8 requests on a plain engine, eager and captured."""
    from repro_torch.serving import InferenceEngine

    batches = math.ceil(N_REQUESTS / MAX_BATCH)
    L, steps = cfg.num_layers, MAX_NEW - 1
    expect = {
        "flash_attention": batches * L,
        "paged_attention": batches * steps * L,
        "grouped_matmul": batches * (1 + steps) * 3 * L,
    }

    def serve(eng):
        res = _serve_static(eng, cfg, "serve")
        if res["launches"] != expect:
            raise AssertionError(f"serve: launches {res['launches']}, expected {expect}")
        return res

    res = ab_runs("serve", "static", lambda cap: InferenceEngine(cfg, params, max_batch=MAX_BATCH, capture_steps=cap),
                  serve)
    res["first_batch_tokens"] = res["tokens"][:MAX_BATCH]
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


def cont_requests(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    system = rng.integers(1, cfg.vocab_size, CONT_SYSTEM).tolist()
    return [
        (system + rng.integers(1, cfg.vocab_size, CONT_OWN).tolist(), CONT_MAX_NEW[i % len(CONT_MAX_NEW)])
        for i in range(CONT_REQUESTS)
    ]


def phase_continuous(cfg, params) -> dict:
    """Serve the continuous traffic with the prefix cache off, then on, each
    eager and captured; returns the captured prefix-cache run."""
    from repro_torch.serving import InferenceEngine

    L = cfg.num_layers
    runs = {}
    for pc in (False, True):
        name = "prefix" if pc else "plain"

        def serve(eng, pc=pc, name=name):
            res, toks = _serve_continuous(eng, cfg, f"continuous ({name})")
            st = res["stats"]
            expect = {
                "paged_attention": (st["prefill_chunks"] + (0 if pc else st["decode_steps"])) * L,
                "grouped_matmul": (st["prefill_chunks"] + st["decode_steps"]) * 3 * L,
            }
            if pc:
                expect["prefix_paged_attention"] = st["decode_steps"] * L
            if res["launches"] != expect:
                raise AssertionError(f"continuous ({name}): launches {res['launches']}, expected {expect}")
            if pc and st["prefix_hit_blocks"] <= 0:
                raise AssertionError("continuous (prefix): no prefix block was shared")
            if pc and st["prefix_grouped_steps"] <= 0:
                raise AssertionError("continuous (prefix): no decode step read a shared run through a group")
            return dict(res, prefix_cache=pc, tokens=toks)

        runs[pc] = ab_runs("continuous", name, lambda cap, pc=pc: InferenceEngine(
            cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK, prefix_cache=pc, capture_steps=cap), serve)
    if runs[True]["tokens"] != runs[False]["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(runs[True]["tokens"], runs[False]["tokens"])) if a != b]
        raise AssertionError(f"continuous: prefix-cache tokens differ from the plain run's for requests {diff}")
    return runs[True]


RESIDENT_PLAN = ("TP1", "TP2", "EP2")  # switching; both layouts are the identity on one card
TRANSITION_LAYERS = 4  # dense INT4 transitions: the async barrier holds a second set of dense leaves
CHECK_STRIDE = 7  # restored groups held against the numpy dequant: every 7th, over every layer


def _session(cfg):
    """The pinned switching INT4 plan; the 64-token prompt bucket gives the
    serve phase's shapes (prompts of 100-128 tokens pad to 128)."""
    from repro_torch.core import HAPSession, fixed_plan

    return HAPSession(cfg, "h100", 1, source=fixed_plan(*RESIDENT_PLAN, mechanism="int4_upload"), prompt_bucket=64)


def _serve_static(eng, cfg, name: str) -> dict:
    """``run()`` the serve phase's requests; the launch and dispatch counts
    and the transition accounting of that run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request

    for p in prompts(cfg):
        eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    comps = eng.run()
    wall = time.perf_counter() - t0
    launches, dispatch, st = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS), eng.stats
    variants = check_variants(name, launches)
    if len(comps) != N_REQUESTS or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError(f"{name}: expected {N_REQUESTS} completions of {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for c in comps for t in c.tokens):
        raise AssertionError(f"{name}: a token outside the vocabulary")
    refs = ref_ops(dispatch)
    if refs:
        raise AssertionError(f"{name}: ref ops ran on the main path: {refs}")
    if st.restore_errors or st.background_errors:
        raise AssertionError(f"{name}: a background restore failed: {dataclasses.asdict(st)}")
    per_batch = comps[::MAX_BATCH]  # one completion per batch: uids fill batches in order
    steps = MAX_NEW - 1
    tokens = sum(len(c.tokens) for c in comps)
    return {
        "model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "requests": len(comps), "batches": st.batches,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_ms": [c.prefill_ms for c in per_batch], "decode_ms_per_step": [c.decode_ms / steps for c in per_batch],
        "transition_ms": [c.transition_ms for c in per_batch], "transition_ms_total": st.transition_ms_total,
        "restore_wait_ms": st.restore_wait_ms, "restore_overlap_ms": st.restore_overlap_ms,
        "async_restores": st.async_restores, "resident_bytes_saved": st.resident_bytes_saved,
        "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches, "variants": variants,
        "dispatch": dispatch, "tokens": [c.tokens for c in comps],
    }


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _round_trip_in_place(params, backups) -> None:
    """Overwrite the dense expert leaves with the dequantized INT4 backup,
    layer by layer on the card (the bf16 values resident serving computes)."""
    import torch

    from repro_torch.kernels import ops

    moe = params["layers"]["moe"]
    for name in ("wi_gate", "wi_up", "wo"):
        qt = backups[f"moe/{name}"]
        for layer in range(qt.packed.shape[0]):
            w = ops.int4_dequant(*(t[layer].to(moe[name].device).reshape(-1, t.shape[-1]) for t in (qt.packed, qt.scales, qt.zeros)),
                                 out_dtype=moe[name].dtype)
            moe[name][layer].copy_(w.view(moe[name][layer].shape))
    torch.cuda.synchronize()


def phase_resident(cfg, params) -> dict:
    """Resident INT4 at full width and depth through a HAPSession."""
    from repro_torch.serving import InferenceEngine

    L = cfg.num_layers
    batches, steps = math.ceil(N_REQUESTS / MAX_BATCH), MAX_NEW - 1
    gmm = batches * (1 + steps) * 3 * L  # 84 per forward pass
    expect = {"flash_attention": batches * L, "paged_attention": batches * steps * L,
              "grouped_matmul": gmm, "int4_dequant": gmm}
    runs = {}
    backups = []
    for asy in (True, False):
        def make(capture, asy=asy):
            t0 = time.perf_counter()
            eng = _session(cfg).engine(params, max_batch=MAX_BATCH, resident_int4=True, use_int4_transition=True,
                                       async_transitions=asy, capture_steps=capture)
            eng.setup_s = time.perf_counter() - t0  # quantize on the card, pinned host backups, upload
            if asy and not backups:
                backups.append(eng._tx._backups)
            return eng

        def serve(eng, asy=asy):
            name = f"resident (async={asy})"
            res = _serve_static(eng, cfg, name)
            res["engine_setup_s"] = eng.setup_s
            if res["launches"] != expect:
                raise AssertionError(f"{name}: launches {res['launches']}, expected {expect}")
            if asy and res["async_restores"] != batches:
                raise AssertionError(f"resident: {res['async_restores']} async restores, expected {batches}")
            return res

        # async: the resident cell's eager/captured A/B; sync: captured only
        runs[asy] = ab_runs("resident", f"static_async={asy}", make, serve, AB_ORDER if asy else (True,))
    if runs[True]["tokens"] != runs[False]["tokens"]:
        raise AssertionError("resident: async-transition tokens differ from the sync ones")

    # the dense weights the resident leaves stand for, bit for bit
    _round_trip_in_place(params, backups.pop())
    dense = ab_runs("resident", "dense_round_trip", lambda cap: InferenceEngine(
        cfg, params, max_batch=MAX_BATCH, capture_steps=cap), lambda eng: _serve_static(
        eng, cfg, "resident (dense round trip)"), (True,))
    if dense["tokens"] != runs[True]["tokens"]:
        raise AssertionError("resident: the dense engine on the round-tripped weights gives other tokens")

    cont = {}
    for resident in (True, False):
        def make(capture, resident=resident):
            if resident:
                return _session(cfg).engine(params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK,
                                            prefix_cache=True, resident_int4=True, use_int4_transition=True,
                                            capture_steps=capture)
            return InferenceEngine(cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK, prefix_cache=True,
                                   capture_steps=capture)

        def serve(eng, resident=resident):
            res, toks = _serve_continuous(eng, cfg, f"resident continuous (resident={resident})")
            if resident and res["launches"]["int4_dequant"] != res["launches"]["grouped_matmul"]:
                raise AssertionError(f"resident continuous: launches {res['launches']}")
            return dict(res, resident_int4=resident, tokens=toks)

        cont[resident] = ab_runs("resident", f"continuous_resident={resident}", make, serve,
                                 (False, True) if resident else (True,))
    if cont[True]["tokens"] != cont[False]["tokens"]:
        raise AssertionError("resident continuous: tokens differ from the dense round-trip engine's")
    return runs[True]


def _serve_continuous(eng, cfg, name: str):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request

    reqs = cont_requests(cfg)
    for p, g in reqs:
        eng.submit(Request(prompt=p, max_new_tokens=g))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    comps = eng.serve_continuous()
    wall = time.perf_counter() - t0
    launches, dispatch, st = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS), eng.stats
    variants = check_variants(name, launches)
    if [len(c.tokens) for c in comps] != [g for _, g in reqs]:
        raise AssertionError(f"{name}: a request did not get its budget")
    refs = ref_ops(dispatch)
    if refs:
        raise AssertionError(f"{name}: ref ops ran on the main path: {refs}")
    if any(not 0 <= t < cfg.vocab_size for c in comps for t in c.tokens):
        raise AssertionError(f"{name}: a token outside the vocabulary")
    tokens = sum(len(c.tokens) for c in comps)
    return {
        "model": cfg.name, "layers": cfg.num_layers, "requests": len(comps), "max_batch": CONT_MAX_BATCH,
        "kv_block_size": CONT_BLOCK, "kv_pool_blocks": eng.kv_pool_blocks, "tokens_generated": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": st.decode_steps,
        "decode_step_ms_mean": st.decode_step_ms_sum / st.decode_steps, "decode_step_ms_max": st.decode_step_ms_max,
        "prefill_chunks": st.prefill_chunks, "prefill_ms": [c.prefill_ms for c in comps],
        "transition_ms_total": st.transition_ms_total, "resident_bytes_saved": st.resident_bytes_saved,
        "max_memory_allocated": torch.cuda.max_memory_allocated(), "stats": dataclasses.asdict(st),
        "launches": launches, "variants": variants, "dispatch": dispatch,
    }, [c.tokens for c in comps]


def _first_layers(tree, n: int):
    return {k: _first_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


def phase_transitions(cfg, params) -> dict:
    """Dense INT4 transitions at full width and TRANSITION_LAYERS layers."""
    import torch

    from repro_torch.core import quantization as q

    cfg4 = dataclasses.replace(cfg, num_layers=TRANSITION_LAYERS)
    params4 = dict(params, layers=_first_layers(params["layers"], TRANSITION_LAYERS))
    batches = math.ceil(N_REQUESTS / MAX_BATCH)
    restores = 2 * batches - 1  # into the decode layout each batch, back to prefill between batches
    runs, restored = {}, {}
    for asy in (True, False):
        eng = _session(cfg4).engine(params4, max_batch=MAX_BATCH, use_int4_transition=True, async_transitions=asy)
        res = _serve_static(eng, cfg4, f"transitions (async={asy})")
        if res["launches"].get("int4_dequant") != 3 * restores:
            raise AssertionError(f"transitions (async={asy}): {res['launches']}, expected {3 * restores} int4_dequant")
        leaves = {n: eng.params["layers"]["moe"][n] for n in ("wi_gate", "wi_up", "wo")}  # decode layout
        checked = 0
        if asy:
            # every CHECK_STRIDE-th group of each leaf, across all its layers,
            # against the numpy dequant of the same backup groups cast to
            # bf16 on the host (a full numpy pass costs ~2 s per layer leaf)
            for name, got in leaves.items():
                qt = eng._tx._backups[f"moe/{name}"]
                pick = slice(None, None, CHECK_STRIDE)
                packed, scales, zeros = (t[pick].contiguous().numpy() for t in (qt.packed, qt.scales, qt.zeros))
                host = q.dequantize_int4(q.QuantizedTensor(packed=packed, scales=scales, zeros=zeros,
                                                           shape=(len(packed), qt.group_size), group_size=qt.group_size))
                if not torch.equal(got.view(-1, qt.group_size)[pick].cpu(), torch.from_numpy(host).to(got.dtype)):
                    raise AssertionError(f"transitions: restored {name} differs from the numpy dequant")
                checked += len(packed)
            restored = leaves
        elif not all(torch.equal(leaves[n], restored[n]) for n in leaves):
            raise AssertionError("transitions: the sync restore's leaves differ from the async restore's")
        emit({"phase": "transitions", "async_transitions": asy, "model": cfg.name,
              "reduced": {"num_layers": TRANSITION_LAYERS}, "groups_checked_against_numpy": checked,
              **{k: v for k, v in res.items() if k != "tokens"}})
        runs[asy] = res
        eng.close()
        del eng, leaves
    del restored
    _free()
    if runs[True]["tokens"] != runs[False]["tokens"]:
        raise AssertionError("transitions: async tokens differ from the sync ones")
    return runs[True]


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
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "params": sum(t.numel() for t in _leaves(params)), "bytes": torch.cuda.memory_allocated()})
    serve = timed("serve", phase_serve, cfg, params)
    timed("agree", phase_agree, cfg, params, serve)
    cont = timed("continuous", phase_continuous, cfg, params)
    # the resident phase overwrites the expert leaves with their INT4 round trip
    resident = timed("resident", phase_resident, cfg, params)
    trans = timed("transitions", phase_transitions, cfg, params)
    emit({"phase_seconds": seconds})
    for r in rows:
        # launches on the path the kernel serves: the static serve phase for
        # the first slice's kernels, the prefix-cache continuous run for the
        # prefix kernel, the resident async run for the dequant; each row
        # also carries the other paths' counts
        r["launches"] = serve["launches"].get(r["name"], 0)
        r["launches_continuous"] = cont["launches"].get(r["name"], 0)
        r["launches_resident"] = resident["launches"].get(r["name"], 0)
        r["launches_transitions"] = trans["launches"].get(r["name"], 0)
        if r["name"] == "prefix_paged_attention":
            r["launches"] = r["launches_continuous"]
        if r["name"] == "int4_dequant":
            r["launches"] = r["launches_resident"]
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
