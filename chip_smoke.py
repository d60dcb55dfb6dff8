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
             (wgmma / split / simt), two calls bit-equal; and rows at the
             families' shapes (``also``, each naming its ``model``): flash,
             paged and prefix at head dim 256 (Gemma-2-9B), paged at
             Qwen3-30B-A3B's 8-query GQA group, the grouped matmul at
             Qwen3's 128 experts and Mixtral's 8; flash and paged at
             Hymba-1.5B's head dim 64 and GQA group of 5, and paged at the
             contiguous continuous decode step (8 rows, each at its own
             depth, on an (8, 320) cache through the identity table) of
             DeepSeek and Hymba
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
   contiguous - the same traffic through the contiguous fallback,
             ``InferenceEngine(..., paged=False).serve_continuous()``
             (each request prefilled whole at admission, B=1, its rows
             merged into its slot), eager and captured with exact launch
             counts; then against the paged path at capacity factor E / k
             (no drops): in float32 at full width (4 layers) each request's
             tokens equal or first parting at a near-tie (the gate), in
             bf16 at full depth reported
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
8. replication - the same model (the resident phase's INT4 round trip in
             its expert leaves): prefetch (``prefetch=True,
             prefetch_top_p=0.9``) on the resident session, sync and async,
             against prefetch off (equal tokens, rows hit), and dense INT4
             restores from staged rows at 4 layers against the transitions
             phase's tokens; free routing with ``replicate_experts=4,
             rebalance_interval=8`` (68 slots), hopper against ref on the
             slot layout and on the same experts; then the router doctored
             in place so that expert 0 is in every token's top-2, at
             capacity factor E / k (nothing drops): resident INT4 with
             replication against a dense engine on its round trip, and the
             replicated engine eager and captured against the unreplicated
             one (equal tokens, teacher-forced logits within rel L2 1e-3).
             Each run prints rebalances, degrees, peak memory, decode ms per
             step, prefill ms and the prefetch counters; every launch is
             recorded by shape, and phase ``replication_kernels`` holds gmm
             and dequant against their plain versions at the shapes the
             kernels phase has no row for (68 slots, the slot leaf, the
             barrier's assembled leaf)
9. robustness - the same weights (the router put back after the
             replication phase), their first 2 of 28 layers (the script's
             time limit; the schedule does not depend on the depth), at
             capacity factor E / k, so nothing drops
             and rows cannot couple: the continuous traffic at a pool of 51
             blocks (3 rows' expected need, 2 rows' worst case) with
             worst-case admission, then ``kv_overcommit=0.25`` eager and
             captured (>= 2 preemptions), then with the prefix cache at 38
             blocks (evictions under pressure and preemptions), then one
             ``FaultInjector().fail("kv_alloc", at=N)`` at the last counted
             allocation (exactly one more preemption): requests never
             preempted give the worst-case run's tokens exactly, a
             preempted one's stash is that run's prefix and its first
             differing token a near-tie (teacher-forced gap under 2% of the
             max |logit|); deadlines and cancels on an injected clock (one
             each expiring and cancelled queued and live, partial outputs
             the worst-case run's prefixes), eager and captured; every
             allocator conserved. Then the resident session's degraded
             modes on its first batch, each against its run with no fault:
             a failed async restore and one stalled past a small watchdog
             (sync failover), failed prefetch rows (``p=0.5``), and an
             ILP-sourced session whose solve fails (the static TP plan).
             Phase ``robustness_kernels`` adds paged rows at a replay's
             tail chunk and gmm rows at new capacities
10. families - DeepSeek's weights freed, then three more families, each at
             full width on seeded random weights, freed before the next:
             Qwen3-30B-A3B (4 of 48 layers, 128 experts top-8, GQA 32/4): the
             serve phase's ``run()`` eager and captured, the agree check,
             and the continuous traffic with the prefix cache off and on
             (equal tokens); Gemma-2-9B (6 of 42 layers, head dim 256, softcaps,
             alternating 4096-token window): ``run()``, agree, and the
             continuous traffic with the prefix cache on; Mixtral-8x7B at
             its first 4 of 32 layers (93.4 GB in bf16 does not fit the
             80 GB card, and 4 layers keep the whole run inside its time
             limit): ``run()`` and agree. Each prints its peak memory
    ssm     - the families with mamba layers at full width, each freed
             before the next: Falcon-Mamba-7B (16 of its 64 mamba1 layers, no
             attention, no FFN) and Hymba-1.5B (16 of its 32 layers of
             parallel attention and mamba heads, hd 64, GQA 25/5, window 1024
             on 14 of them, dense SwiGLU): ``run()`` and the continuous traffic
             through ``serve_continuous()`` (the contiguous fallback, their
             default), one eager and one captured run each; prefill against
             decode (gated in float32, bf16 reported beside the same path's
             rounding noise), Hymba's agree check (float32 gate, bf16
             bound), exact launch counts (Falcon-Mamba launches none), and
             the plain mamba mixer's and scan's device times
    vlm     - LLaVA-NeXT-Mistral-7B at full width and depth (32 layers, image
             patch embeddings ahead of the text) through ``prefill`` +
             ``decode_step``: two image prompts of 2,880 patches + 64 text
             tokens, then one of 37 (a partial last flash query tile), 16
             greedy tokens each, launches exact; hopper against ref in bf16
             within twice the ref path's batch noise in the same run, and at
             4 layers in float32 hopper = ref = one forward over the longer
             sequence (1e-3). The kernels phase has flash and paged rows at
             these shapes
    train   - training on the card (the loss pins the plain ``ref`` path, so
             no hand kernel launches): HuBERT-XLarge at full width and depth
             through ``repro_torch.launch.train --full`` (5 steps, B=4, 512
             frames, remat), DeepSeekMoE-16B at full width, 4 of 28 layers
             (5 steps, B=4 S=256, the router's aux loss); ms per step, peak
             memory, loss; then float32 parity with the port on the CPU (a
             HuBERT train step; DeepSeek's loss, aux and gradients)
   launcher - the serve launcher as a user starts it,
             ``repro_torch.launch.serve.main(["--full", "--chip", "h100",
             "--devices", "4", "--kernel-backend", "hopper"], params=...)``
             on DeepSeek's seeded weights drawn anew (late, so that the h100
             latency model, fitted in a background process from the
             script's start, has landed): the mixed short/long trace through
             ``run()``, then with ``--continuous --prefix-cache``; exact
             launches, no ``ref`` dispatch, tokens and launches equal to an
             engine built from the same session and flags; then ``python -m
             repro_torch.launch.serve`` at its reduced default in a
             subprocess, reading that fit from its cache
11. sharded - DeepSeekMoE-16B at full width on two ranks of a gloo group,
             both on the one card (NCCL refuses two ranks on one device),
             spawned by ``repro_torch.sharding.launch``; each rank draws
             only its shard of all 28 layers (``init_params(..., shard=...)``,
             the serve phase's seed) and serves the serve traffic's first
             batch (4 requests) at its first 7 layers (``SHARDED_CUT``)
             through ``HAPSession(cfg, "h100", 2, source=fixed_plan(...),
             mesh=RankMesh).engine(...).run()`` eagerly under TP2/TP2,
             TP2/EP2 (serial and K=2), and the switching TP2/EP2->TP2 plan by
             reshard, by INT4 upload and from resident INT4 (4 layers), then
             the continuous traffic with the prefix cache under TP2/EP2 (4
             layers). Each run prints per-rank peak memory, launches, ms per
             step and relayout ms and bytes; every rank must launch every
             kernel of its path. The teacher-forced logits of the agree
             phase's first batch under each TP2/EP2 layout, at 7 layers
             (``SHARDED_REF_LAYERS``), are held to the agree bound against
             one card at that depth with the expert flips counted, and one
             MoE layer sharded against the same layer whole (EP2: exact;
             TP2: the kernel tolerance). A last gloo run serves the 8
             requests from resident INT4 at 7 layers under the switching
             TP2 -> EP2 plan with replication and prefetch at the
             replication phase's capacity factor: the ranks' replica sets
             equal, each rank holding half of the slots, rows hit, and its
             teacher-forced logits within the same-expert bound of that
             phase's one-rank reference at 7 layers. DP2/EP2: attention
             whole on each rank, its contiguous cache sequence-sharded (each
             rank half the positions), decode on the plain path; the re-plan
             traffic (``REPLAN_TRAFFIC``, 7 layers, its tokens against one
             card at that depth), paged and contiguous, whose attention
             switches TP2 -> DP2 -> TP2 while a request is live, moving the
             live cache; and Falcon-Mamba-7B (4 of 64 layers) and Hymba-1.5B
             (16 of 32) on two ranks, the mixer tensor-parallel, against one
             card: logits within twice its batch noise, each rank half the
             conv/ssm state. Then one NCCL rank serves TP2/EP2 captured and
             eager: equal tokens
12. sharded_train - training on a (data, model) mesh: four gloo ranks on
             the card, each with its shard of the state and its data rows.
             DeepSeekMoE-16B at full width, 1 of 28 layers: float32 on (2, 2)
             (TP-heads, EP) against one rank (loss 1e-5, grad norm 1e-4,
             each gathered leaf 1e-4; 2 steps, the other ranks' first
             step taken meanwhile); bf16 2 steps each under TP2/EP2 on
             (1, 2), DP2 x EP2, DP2 x EP2 with sequence parallelism and FSDP
             on (2, 2) (ms a step, peak memory a rank, collectives a step);
             4 layers' ``prefill`` + 15 decode steps on (2, 2) through the
             hopper kernels, heads and seq caches, against one rank routing
             each quarter of the tokens alone (the sharded bounds), launches
             exact; the reduced train launcher on the four ranks against one
             rank. Then, in the same four ranks, ``sharded_data``: the
             serving engine on (2, 2), each data rank serving its rows or
             slots, DeepSeekMoE-16B at full width, 4 of 28 layers, bf16:
             ``run()`` under TP2/EP2 on the serve traffic's 8 requests
             (8 new, 2 rows a data rank) and a batch of 3 (the data axis
             dropped), the switching INT4 plan from resident experts, the
             prefix-cache continuous traffic (8 requests of 256 tokens
             sharing 192, 4 slots, 16-token blocks, 64-token chunks) and
             the TP2 -> DP2 -> TP2 re-plan with live requests; the four
             ranks' tokens equal, teacher-forced logits of each data rank's
             rows through the engine's own steps against one card's engine
             (the sharded bounds), float32 at 1 layer token for token
             against one card's engine, every rank's launches equal to the
             counts worked out from the traffic (``SD_LAUNCHES``); and the
             dry run (``repro_torch.launch.dryrun``) of one TP2/EP2 decode
             step of the static batch, traced for each rank on a fake (2, 2)
             group in a process of its own, held to what each rank holds and
             exchanges in that step: parameter and KV bytes, collective
             calls and payload bytes exact; the dry run's args + temps
             printed beside the rank's ``max_memory_allocated`` (a reading)

Every engine runs its steps captured in CUDA graphs (``capture_steps``, the
default on the card; ``repro_torch.serving.step_cache``). The serve phase is
served four times on fresh engines, eager (``capture_steps=False``), captured,
captured, eager; both continuous runs, the resident phase's async static run
and the other A/B runs once eager and once captured (the script's time
limit): the tokens and the launch, variant and dispatch counts must be equal
across them (a replay counts as the launches it replays); each run prints
its decode ms per step, prefill ms, tokens/s, peak memory, graphs captured,
capture ms and replays. The resident phase's other runs (sync, the dense
round trip, the continuous traffic) are captured, the resident continuous run
also eager. Each ``phase_done`` line carries the phase's seconds by step
(``steps_s``) where the phase marks them.

Every serving phase also checks that each bfloat16 flash and grouped-matmul
launch on its path took the ``wgmma`` variant, and each paged and
prefix-paged launch the ``split`` variant (``_build.VARIANT_COUNTS``), and
every run that injects no fault that the degraded paths' counters
(``FALLBACK_COUNTERS``) read 0.

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

import collections
import contextlib
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
# random weights such differences grow, and where the router's top-k has a
# near-tie the two paths pick another expert for a token. The same kernels
# agree with ref to 1e-4 in float32 (tests/test_torch_gpu.py), so what is
# left is rounding. A wrong kernel gives unrelated logits: relative L2
# error near sqrt(2). The bounds sit above what the H100 showed (PERF.md),
# where the rel L2 is ||hopper - ref|| / ||ref|| and the max relative error
# max |hopper - ref| / max |ref|, each over one step's (B, V) logits. With
# the ref path on the hopper path's experts the near-ties drop out: the
# H100 showed rel L2 0.010-0.020 on every step of DeepSeek, Qwen3 and
# Mixtral, where each path on its own experts read up to 0.16 on the steps
# with a flipped expert, so that reading is held to the tighter bound.
AGREE_TOL = (0.25, 0.5)  # rel L2, max rel: each path routing on its own
AGREE_SAME_EXPERTS_TOL = 0.05  # rel L2, the ref path on the hopper path's experts

# families phase: (name, layers kept or None for all, continuous runs as
# prefix-cache settings, agree bounds as AGREE_TOL). Mixtral-8x7B is
# 93.4 GB in bf16: its first 16 of 32 layers (47.0 GB) fit the 80 GB card.
# The first 8 of Mixtral, 12 of Qwen3-30B-A3B's 48 and 21 of Gemma-2-9B's
# 42 keep the whole script inside its time limit (the replication phase
# and the replicated two-rank run added ~2.5 min; one full run took 1068 s
# of the 1200 allowed). The contiguous and ssm phases added ~95 s and a
# run read ~990 s, so Qwen3 went from 24 layers to 12, not the mamba
# families, which serve at full depth. The vlm and train phases and their
# kernel rows took ~40 s on the H100, which the ~990 s runs had room for
# (phases <= 1,050 s), but one H100 run with them read 1,061 s:
# Gemma-2-9B went from 21 layers to 14, and the robustness phase to 7 of
# DeepSeek's 28 (ROBUST_LAYERS). The launcher phase and the sharded
# phase's seq, re-plan and mamba runs added ~300 s on the H100: Qwen3
# went to 4 layers, Gemma-2 to 6, Mixtral to 4, the robustness phase to 2,
# Falcon-Mamba's ssm phase to 32 of 64, and four sharded runs to 7 or 14
# of DeepSeek's 28 (SHARDED_CUT). The sharded_train phase added ~160 s, and
# a whole run on a slower host took 1,283 s: Falcon-Mamba's ssm phase went
# to 16 layers, the sharded switch runs to 4 and its continuous run to 7,
# the two-rank mamba runs to 4 (Falcon-Mamba) and 16 (Hymba) layers, and
# sharded_train's own runs to 1 (training) and 4 (serving) layers. Its
# sharded_data part (~20-30 s) took a whole run to 1,164 s on a slower
# host: the sharded phase's four static runs and its NCCL run went to 7 of
# 28 layers. The dry run's gate (~18 s) took a driver's run past 1,200 s,
# and one of 957 s showed hosts apart by up to ~1.4x: the dry run went
# beside the phases, every A/B but the serve phase's to one eager and one
# captured run and its logits pass to the static run() A/Bs, Hymba's ssm
# phase to 16 of 32 layers, the sharded phase's teacher-forced, replicated
# and re-plan runs to 7 layers against one card at 7, its plan runs to the
# first batch and its continuous run to 4, sharded_train to 2 steps, the
# other ranks' first step taken meanwhile, and the launcher phase after
# the train phase, when the latency model's fit has landed.
# The agree bounds with each path routing on its own sit 2-4x above what
# the H100 showed (rel L2 0.052, 0.023 and 0.157; max rel 0.067, 0.014 and
# 0.296, PERF.md), far below a wrong kernel's ~1.4: Mixtral's top-2 of 8
# flips an expert where the two paths' router scores near-tie, which moves
# its logits most (its steps without a flip read 0.018-0.019).
FAMILIES = (
    ("qwen3-moe-30b-a3b", 4, (False, True), (0.15, 0.2)),
    ("gemma2-9b", 6, (True,), (0.1, 0.1)),
    ("mixtral-8x7b", 4, (), (0.35, 0.6)),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# wall seconds by step within the running phase (or spawned rank), added by
# ``mark``: each mark books the time since the last one under its label
STEP_S: dict = {}
_LAST_MARK = [time.perf_counter()]


def mark(label: str) -> None:
    now = time.perf_counter()
    STEP_S[label] = STEP_S.get(label, 0.0) + now - _LAST_MARK[0]
    _LAST_MARK[0] = now


def reset_marks() -> None:
    STEP_S.clear()
    _LAST_MARK[0] = time.perf_counter()


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


def launch_shapes() -> dict:
    """``_build.SHAPE_COUNTS`` as ``{kernel: {shape: launches}}``: each
    wrapper's launches by the shape it gives (see ``_build``) since the
    counts were last set to 0, replays of captured steps included."""
    from repro_torch.kernels import _build

    out = {}
    for (kernel, shape), n in _build.SHAPE_COUNTS.items():
        out.setdefault(kernel, {})[shape] = n
    return out


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


# the counters of the degraded paths (DESIGN.md §4f): a run that injects no
# fault must read 0 on each, or a failure went into a fallback unseen
FALLBACK_COUNTERS = ("background_errors", "restore_errors", "prefetch_errors", "planner_fallbacks")


def no_fallback(name: str, counts: dict) -> None:
    got = {k: counts[k] for k in FALLBACK_COUNTERS}
    if any(got.values()):
        raise AssertionError(f"{name}: a degraded path ran in a run that injects no fault: {got}")


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

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    B, S = MAX_BATCH, 128

    def randn(*shape, std=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev, bf16)

    rows = []

    # flash attention at the prefill shape, on the model layout's views, and
    # at one 2048-token prompt; then at the families' prefill shapes:
    # Gemma-2-9B's head dim 256 (16 q heads over 8 KV heads, softcap 50,
    # scale 224^-0.5), also at an 8192-token prompt where its 4096-token
    # window bites, and Qwen3-30B-A3B's and Mixtral-8x7B's groups of 8 and 4
    g2, q3, mx = (get_config(n) for n in ("gemma2-9b", "qwen3-moe-30b-a3b", "mixtral-8x7b"))
    # and Hymba-1.5B's (ssm phase): head dim 64, 25 q heads over 5 KV heads,
    # on its global and its windowed (1024) layers
    hy = get_config("hymba-1.5b")
    # and LLaVA-NeXT-Mistral-7B's image prompts (vlm phase): 2,880 patches
    # ahead of 64 text tokens (B=2) and of 37 (B=1, a partial last q tile)
    lv = get_config(VLM_MODEL)
    vlm_seqs = [(rows, lv.num_patches + n_text) for rows, n_text in VLM_PROMPTS]
    flash_rows = [flash_case(dev, randn, model, fb, fs, attn, win) for model, fb, fs, attn, win in (
        (cfg.name, B, S, attn_of(cfg), 0),
        (cfg.name, 1, 2048, attn_of(cfg), 0),
        (g2.name, B, S, attn_of(g2), 0),
        (g2.name, 1, 8192, attn_of(g2), g2.sliding_window),
        (q3.name, B, S, attn_of(q3), 0),
        (mx.name, B, S, attn_of(mx), 0),
        (hy.name, B, S, attn_of(hy), 0),
        (hy.name, B, S, attn_of(hy), hy.sliding_window),
        *((lv.name, rows, seq, attn_of(lv), 0) for rows, seq in vlm_seqs),
    )]
    rows.append({
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105", **flash_rows[0],
        "library": "torch.nn.functional.scaled_dot_product_attention", "also": flash_rows[1:],
    })

    # paged attention at a decode step: identity table over the contiguous
    # cache; at a continuous prefill chunk; then at the families' shapes:
    # Gemma-2-9B (hd 256) at position ~6000, where its 4096-token window
    # bites, on a block pool, and each family's static decode step and
    # continuous chunk (Gemma-2's chunk on a local layer)
    rows.append({
        "name": "paged_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:336", **static_decode_case(rng, dev, cfg.name, attn_of(cfg), 0),
        "library": None,
        "also": [
            paged_chunk_row(rng, dev, cfg.name, attn_of(cfg)),
            pool_decode_row(rng, dev, g2.name, 4, 1, attn_of(g2), 16, 376, [6000, 5890, 5750, 5600], g2.sliding_window),
            static_decode_case(rng, dev, g2.name, attn_of(g2), 0),
            static_decode_case(rng, dev, q3.name, attn_of(q3), 0),
            static_decode_case(rng, dev, mx.name, attn_of(mx), 0),
            paged_chunk_row(rng, dev, g2.name, attn_of(g2), g2.sliding_window),
            paged_chunk_row(rng, dev, q3.name, attn_of(q3)),
            # the sharded phase's: a TP2 rank's 8 of DeepSeek's 16 heads at
            # the static decode step and at a continuous chunk
            static_decode_case(rng, dev, SHARDED_RANK, rank_attn(cfg), 0),
            paged_chunk_row(rng, dev, SHARDED_RANK, rank_attn(cfg)),
            # Hymba-1.5B's static decode (hd 64, G=5), and the contiguous
            # continuous decode step of DeepSeek and of Hymba: 8 rows, each
            # at its own depth, on the (8, 320) cache through the identity
            # table
            static_decode_case(rng, dev, hy.name, attn_of(hy), 0),
            static_decode_case(rng, dev, cfg.name, attn_of(cfg), 0, CONTIG_POS, _contig_capacity()),
            static_decode_case(rng, dev, hy.name, attn_of(hy), 0, CONTIG_POS, _contig_capacity()),
            # LLaVA's decode steps after each image prompt, at the middle
            # of the 15 (positions seq .. seq + 14 of a seq + 16 cache)
            *(static_decode_case(rng, dev, lv.name, attn_of(lv), 0, [seq + VLM_NEW // 2 - 1] * rows,
                                 seq + VLM_NEW) for rows, seq in vlm_seqs),
        ],
    })
    rows.append(prefix_row(cfg, rng, dev))
    rows[-1]["also"] = [prefix_case(rng, dev, c.name, attn_of(c)) for c in (g2, q3)]
    rows[-1]["also"].append(prefix_case(rng, dev, SHARDED_RANK, rank_attn(cfg)))

    # grouped matmul: decode (C=8), fused chunk + decode (C=16) and prefill
    # (C=64) capacities, both layers; then the families' expert grids:
    # Qwen3-30B-A3B's 128 experts of 768 at decode (the serve cell's 4 rows
    # give the minimum capacity, 8) and at a 128-token prefill of 4 rows
    # (C=40), Mixtral-8x7B's 8 experts of 14336 at C=2, at that decode
    # capacity and at its prefill (C=160). The sharded phase's per-rank
    # shapes (flash, gmm, dequant) are held after that phase, at each shape
    # its runs sent (``sharded_kernel_rows``)
    E, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff
    gmm_specs = [(cfg.name, E, C, d, f) for C in (8, 16, 64)]
    gmm_specs += [(q3.name, q3.n_routed_experts, C, q3.d_model, q3.moe_d_ff) for C in (8, 40)]
    gmm_specs += [(mx.name, mx.n_routed_experts, C, mx.d_model, mx.moe_d_ff) for C in (2, 8, 160)]
    gen = torch.Generator(device=dev).manual_seed(SEED)  # the families' large weights, made on the card

    def on_card(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16).mul_(std)

    gmm_rows = [gmm_case(randn if model == cfg.name else on_card, model, E, C, k_in, n_out, which,
                         plain_reps=5 if model == cfg.name else 2,
                         host_cost=model == cfg.name and C == 8 and which == "wi")
                for model, E, C, d, f in gmm_specs for (k_in, n_out), which in (((d, f), "wi"), ((f, d), "wo"))]
    main, also = gmm_rows[0], gmm_rows[1:]
    rows.append({
        "name": "grouped_matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:45", **main, "library": "torch.bmm", "also": also,
    })
    rows.append(int4_row(cfg, rng, dev))
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": rows})
    return rows


def flash_case(dev, randn, model, fb, fs, attn, win) -> dict:
    """The flash kernel at B=``fb`` S=``fs`` of ``model``'s attention
    ``attn`` (as ``attn_of`` gives it), on the model layout's views of
    ``randn`` inputs; ``win`` > 0 a sliding window."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    Hq, Hkv, fhd, cap, scale = attn
    q, k, v = (randn(fb, fs, nh, fhd).transpose(1, 2) for nh in (Hq, Hkv, Hkv))
    kw = dict(window=win, softcap=cap, scale=scale)
    _build.VARIANT_COUNTS.clear()
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    variant = variant_counts()
    acc = compare(out, fa.flash_attention_plain(q, k, v, **kw), KERNEL_ATOL, KERNEL_RTOL,
                  f"flash_attention ({model}) S={fs} hd={fhd}")
    if not torch.equal(out, fa.flash_attention(q, k, v, **kw)):
        raise AssertionError(f"flash_attention ({model}) S={fs} hd={fhd}: two calls differ")
    # q, k, v read once and o written once; 4 flops per (query, valid key, dim)
    pairs = sum(min(i + 1, win) for i in range(fs)) if win else fs * (fs + 1) // 2
    b_ms, b_by = bound(2 * fb * fs * (2 * Hq + 2 * Hkv) * fhd, 4 * fhd * fb * Hq * pairs)
    # the library yardstick: causal (and windowed) SDPA on the same
    # inputs; SDPA has no softcap, so at softcap rows it computes less
    mask = None
    if win:
        i = torch.arange(fs, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < win)
    reps = 200 if fs <= 128 else 20 if fs <= 2048 else 5
    return {
        "model": model, "key": [fb, fs, Hq, Hkv, fhd, int(win), float(cap)],
        "shape": (f"B={fb} S={fs} H={Hq} hd={fhd} bf16 causal" if Hq == Hkv and not (win or cap) else
                  f"B={fb} S={fs} Hq={Hq} Hkv={Hkv} hd={fhd} window={win} softcap={cap} bf16 causal"),
        "variant": variant, **acc, "bit_equal_calls": True,
        **timed_row(lambda: fa.flash_attention(q, k, v, **kw),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=mask is None,
                                                           scale=scale, enable_gqa=Hq != Hkv), reps),
        "library_same_function": not cap,
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 20 if fs <= 128 else 3 if fs <= 2048
                            else 1),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def gmm_case(make, model, E, C, k_in, n_out, which, plain_reps: int = 2, host_cost: bool = False) -> dict:
    """The grouped matmul at (E, C, k_in) x (E, k_in, n_out) (``which``:
    "wi" or "wo"), on inputs ``make(*shape, std=...)`` gives, the last
    capacity slot empty; ``host_cost`` also times the host's tensor-map
    encode on new buffers."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import grouped_matmul as gm

    lhs = make(E, C, k_in)
    rhs = make(E, k_in, n_out, std=k_in**-0.5)
    lhs[:, -1] = 0  # an empty capacity slot
    _build.VARIANT_COUNTS.clear()
    out = gm.grouped_matmul(lhs, rhs)
    torch.cuda.synchronize()
    variant = variant_counts()
    acc = compare(out, gm.grouped_matmul_plain(lhs, rhs), KERNEL_ATOL, KERNEL_RTOL, f"grouped_matmul ({model}) C={C}")
    if torch.count_nonzero(out[:, -1]):
        raise AssertionError("grouped_matmul: an empty capacity slot came out non-zero")
    if not torch.equal(out, gm.grouped_matmul(lhs, rhs)):
        raise AssertionError(f"grouped_matmul ({model}) C={C} {which}: two calls differ")
    b_ms, b_by = bound(2 * (E * C * k_in + E * k_in * n_out + E * C * n_out), 2 * E * C * k_in * n_out)
    row = {
        "model": model, "key": [E, C, k_in, n_out],
        "shape": f"E={E} C={C} {k_in}x{n_out} ({which}) bf16", "variant": variant, **acc, "bit_equal_calls": True,
        **timed_row(lambda: gm.grouped_matmul(lhs, rhs), lambda: torch.bmm(lhs, rhs), 20),
        "plain_ms": cuda_ms(lambda: gm.grouped_matmul_plain(lhs, rhs), plain_reps),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["share_of_bound"] = b_ms / row["ms"]
    if host_cost:
        # the host cost of a tensor-map encode: new lhs buffers each call
        # (a map-cache miss) against the same buffer (a hit)
        fresh = [torch.empty_like(lhs) for _ in range(20)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in fresh:
            gm.grouped_matmul(x, rhs)
        row["host_us_new_buffers"] = (time.perf_counter() - t0) / len(fresh) * 1e6
        torch.cuda.synchronize()
    return row


def int4_row(cfg, rng, dev) -> dict:
    """The dequant kernel at the main path's shape, one layer's expert leaf
    in 128-wide groups, into bf16 (the serving type) and into float32."""
    import torch

    gs = 128
    G = cfg.n_routed_experts * cfg.d_model * cfg.moe_d_ff // gs
    main, f32 = (dequant_case(rng, dev, G, gs, dt) for dt in (torch.bfloat16, torch.float32))
    return {
        "name": "int4_dequant", "route": "cuda", "source": "src/repro_torch/kernels/csrc/int4_dequant.cu",
        "replaces": "src/repro/kernels/int4_dequant.py:39", **main, "library": None, "also": [f32],
    }


def dequant_case(rng, dev, G, gs, dt, model=None) -> dict:
    """The dequant kernel on G groups of ``gs`` into ``dt``, bit-equal to
    the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import int4_dequant as dq

    packed = torch.from_numpy(rng.integers(0, 256, (G, gs // 2), dtype=np.uint8)).to(dev)
    scales = torch.from_numpy(rng.uniform(1e-3, 0.1, (G, 1)).astype(np.float32)).to(dev)
    zeros = torch.from_numpy(rng.uniform(-1.0, 1.0, (G, 1)).astype(np.float32)).to(dev)
    out = dq.int4_dequant(packed, scales, zeros, out_dtype=dt)
    torch.cuda.synchronize()
    want = dq.int4_dequant_plain(packed, scales, zeros, dt)
    if not torch.equal(out, want):
        raise AssertionError(f"int4_dequant G={G} ({dt}): not bit-equal to its plain version")
    acc = compare(out, want, 0.0, 0.0, f"int4_dequant ({dt})")
    del out, want
    # packed bytes, scales and zeros read once, the output written once;
    # a multiply and an add per output element, in float32
    nb = torch.empty((), dtype=dt).element_size()
    b_ms, b_by = bound(G * gs // 2 + 8 * G + nb * G * gs, 2 * G * gs, FP32_FLOPS)
    return {
        **({"model": model} if model else {}),
        "shape": f"G={G} gs={gs} -> {str(dt).split('.')[1]}", **acc, "bit_equal": True,
        "ms": cuda_ms(lambda: dq.int4_dequant(packed, scales, zeros, out_dtype=dt), 20),
        "plain_ms": cuda_ms(lambda: dq.int4_dequant_plain(packed, scales, zeros, dt), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def _pages(rng, n, bs, Hkv, hd, dev):
    import numpy as np
    import torch

    shape = (n, bs, Hkv, hd)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16) for _ in range(2))


def _cont_table_width():
    """The block-table width the continuous phase's queue gives: its largest
    KV need, rounded up to the 64-token bucket, in blocks."""
    from repro_torch.serving.kv_cache import blocks_for
    from repro_torch.serving.scheduler import round_up

    return blocks_for(round_up(CONT_SYSTEM + CONT_OWN + max(CONT_MAX_NEW) + 1, 64), CONT_BLOCK)


# the contiguous continuous decode row's depths: 8 rows between 40 and 300
CONTIG_POS = (40, 300, 77, 256, 129, 288, 191, 263)


def _contig_capacity():
    """A contiguous live batch's per-slot capacity for the continuous
    traffic: its largest KV need, rounded up to the 64-token bucket."""
    from repro_torch.serving.scheduler import round_up

    return round_up(CONT_SYSTEM + CONT_OWN + max(CONT_MAX_NEW) + 1, 64)


def attn_of(cfg) -> tuple:
    """A model's attention as the kernel rows take it: (q heads, KV heads,
    head dim, softcap, scale or None for head_dim^-0.5)."""
    scale = cfg.query_pre_attn_scalar**-0.5 if cfg.query_pre_attn_scalar else None
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.attn_logit_softcap, scale


def rank_attn(cfg, n: int = 2) -> tuple:
    """``attn_of`` for one rank's head shard under attention TP over ``n``
    ranks (DeepSeek's heads divide)."""
    Hq, Hkv, *rest = attn_of(cfg)
    return (Hq // n, Hkv // n, *rest)


def paged_chunk_row(rng, dev, model, attn, window: int = 0) -> dict:
    """The paged kernel at a continuous prefill chunk of ``model``, whose
    attention is ``attn`` (as ``attn_of`` gives it): one row, 64 tokens
    written at position 192 through a table of scattered real pages;
    ``window`` > 0 is a local layer's."""
    return pool_decode_row(rng, dev, model, 1, 64, attn, CONT_BLOCK, _cont_table_width(), [CONT_SYSTEM], window)


def static_decode_case(rng, dev, model, attn, window, pos=None, Smax=MAX_NEW + 129) -> dict:
    """The paged kernel at the serve phase's decode step of ``model``: B=4
    rows at position 135 through an identity table over the contiguous
    (B, 145) cache, as ``run()`` launches it; ``attn`` as ``attn_of`` gives
    it, ``window`` > 0 a local layer's. ``pos`` (one position per row) and
    ``Smax`` give another contiguous shape: the contiguous continuous
    batch's rows, each at its own depth."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa

    Hq, Hkv, hd, cap, scale = attn
    kw = dict(softcap=cap, scale=scale, window=window)
    is_global = window == 0
    pos = [128 + MAX_NEW // 2 - 1] * MAX_BATCH if pos is None else pos
    B = len(pos)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    qd, kn, vn = randn(B, 1, Hq, hd), randn(B, 1, Hkv, hd), randn(B, 1, Hkv, hd)
    kc, vc = randn(B, Smax, Hkv, hd), randn(B, Smax, Hkv, hd)
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    kc2, vc2 = kc.clone(), vc.clone()
    _build.VARIANT_COUNTS.clear()
    out, _, _ = pa.paged_attention(qd, kc, vc, tables, kn, vn, posv, is_global, **kw)
    torch.cuda.synchronize()
    variant = variant_counts()
    want, kw_, vw_ = pa.paged_attention_plain(qd, kc2, vc2, tables, kn, vn, posv, is_global, **kw)
    acc = compare(out, want, KERNEL_ATOL, KERNEL_RTOL, f"paged_attention static decode ({model})")
    if not (torch.equal(kc, kw_) and torch.equal(vc, vw_)):
        raise AssertionError(f"paged_attention ({model}): appended pages differ from the plain version's")
    if not torch.equal(out, pa.paged_attention(qd, kc, vc, tables, kn, vn, posv, is_global, **kw)[0]):
        raise AssertionError(f"paged_attention ({model}): two calls differ")
    # q, k_new, v_new and out once; each row's cached K/V below its
    # position (inside the window) read once; the appended slots written
    # once; 4 flops per (query, valid key, dim)
    cached = sum(min(p, window - 1) if window else p for p in pos)
    nbytes = 2 * (2 * B * Hq * hd + 2 * B * Hkv * hd + 2 * cached * Hkv * hd + 2 * B * Hkv * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * Hq * (cached + B))
    heads = f"H={Hq}" if Hq == Hkv else f"Hq={Hq} Hkv={Hkv}"
    at = f"pos={pos[0]}" if len(set(pos)) == 1 else f"per-row pos {min(pos)}-{max(pos)}"
    return {
        "model": model, "key": [B, 1, Hq, Hkv, hd],
        "shape": f"B={B} C=1 {heads} hd={hd} Smax={Smax} {at} identity table"
                 f"{f' window={window}' if window else ''}{f' softcap={cap}' if cap else ''} bf16",
        "variant": variant, **acc, "bit_equal_calls": True,
        **kernel_times(lambda: pa.paged_attention(qd, kc, vc, tables, kn, vn, posv, is_global, **kw), 200),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_plain(qd, kc2, vc2, tables, kn, vn, posv, is_global, **kw), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def prefix_row(cfg, rng, dev) -> dict:
    """The prefix kernel's entry: ``prefix_case`` at the main path's model."""
    return {
        "name": "prefix_paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefix_paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:237",
        **prefix_case(rng, dev, cfg.name, attn_of(cfg)),
        "library_ms": None, "library": None,
    }


def prefix_case(rng, dev, model, attn, B: int = CONT_MAX_BATCH) -> dict:
    """The prefix kernel at the continuous decode shape of ``model``, whose
    attention is ``attn`` = (q heads, KV heads, head dim, softcap, scale):
    ``B`` rows (8: the continuous phase's); rows 1.. share 12 leading pages
    (the 192-token system prompt) with representative row 1; row 0 is on
    its own."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefix_paged_attention as ppa

    Hq, Hkv, hd, cap, scale = attn
    kw = dict(softcap=cap, scale=scale)
    bs, nb, shared = CONT_BLOCK, _cont_table_width(), 12
    N = B * nb + 1
    kp, vp = _pages(rng, N, bs, Hkv, hd, dev)
    t = rng.permutation(np.arange(1, N)).astype(np.int32).reshape(B, nb)
    t[2:, :shared] = t[1, :shared]
    pos = np.array([262 + 2 * b for b in range(B)], np.int32)  # depths around 270
    reps = np.array([0] + [1] * (B - 1), np.int32)
    nsh = np.array([0, 0] + [shared] * (B - 2), np.int32)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((B, 1, nh, hd)).astype(np.float32)).to(dev, torch.bfloat16)
                 for nh in (Hq, Hkv, Hkv))
    tables, posv, reps_t, nsh_t = (torch.from_numpy(a).to(dev) for a in (t, pos, reps, nsh))
    pages = {k: (kp.clone(), vp.clone()) for k in ("kernel", "paged", "plain")}
    _build.VARIANT_COUNTS.clear()
    out, _, _ = ppa.prefix_paged_attention(q, *pages["kernel"], tables, kn, vn, posv, reps_t, nsh_t, **kw)
    torch.cuda.synchronize()
    variant = variant_counts()
    own, _, _ = pa.paged_attention(q, *pages["paged"], tables, kn, vn, posv, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, ppa.prefix_paged_attention(q, *pages["kernel"], tables, kn, vn, posv, reps_t, nsh_t,
                                                       **kw)[0]):
        raise AssertionError("prefix_paged_attention: two calls differ")
    want, _, _ = ppa.prefix_paged_attention_plain(q, *pages["plain"], tables, kn, vn, posv, reps_t, nsh_t, **kw)
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
    nbytes = 2 * (2 * keys * Hkv * hd + 2 * B * Hq * hd + 2 * B * Hkv * hd + 2 * B * Hkv * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * Hq * int((pos + 1).sum()))
    kpk, vpk = pages["kernel"]
    kpp, vpp = pages["paged"]
    heads = f"H={Hq}" if Hq == Hkv else f"Hq={Hq} Hkv={Hkv}"
    return {
        "model": model, "key": [B, 1, Hq, Hkv, hd],
        "shape": f"B={B} C=1 {heads} hd={hd} bs={bs} table {nb}, rows 1-{B - 1} share {shared} pages, pos {pos.min()}-"
                 f"{pos.max()}{f' softcap={cap}' if cap else ''} bf16",
        "variant": variant, **acc, "bit_equal_to_paged": True, "bit_equal_calls": True,
        **kernel_times(lambda: ppa.prefix_paged_attention(q, kpk, vpk, tables, kn, vn, posv, reps_t, nsh_t, **kw),
                       200),
        "plain_ms": cuda_ms(
            lambda: ppa.prefix_paged_attention_plain(q, kpp, vpp, tables, kn, vn, posv, reps_t, nsh_t, **kw), 20),
        "paged_ms": graph_ms(lambda: pa.paged_attention(q, kpp, vpp, tables, kn, vn, posv, **kw), 200),
        "paged_eager_ms": cuda_ms(lambda: pa.paged_attention(q, kpp, vpp, tables, kn, vn, posv, **kw), 200),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def pool_decode_row(rng, dev, model, B, C, attn, bs, nb, pos, window) -> dict:
    """The paged kernel on a block pool: B rows of C tokens written at
    positions ``pos``, each row through a table of ``nb`` scattered pages of
    ``bs`` slots; ``attn`` = (q heads, KV heads, head dim, softcap, scale);
    ``window`` > 0 is a local layer's sliding window."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa

    Hq, Hkv, hd, cap, scale = attn
    kw = dict(softcap=cap, scale=scale, window=window)
    is_global = window == 0
    N = B * nb + 1
    kp, vp = _pages(rng, N, bs, Hkv, hd, dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[: B * nb].astype(np.int32).reshape(B, nb)).to(dev)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((B, C, nh, hd)).astype(np.float32)).to(dev, torch.bfloat16)
                 for nh in (Hq, Hkv, Hkv))
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    kp2, vp2 = kp.clone(), vp.clone()
    _build.VARIANT_COUNTS.clear()
    out, _, _ = pa.paged_attention(q, kp, vp, tables, kn, vn, posv, is_global, **kw)
    torch.cuda.synchronize()
    variant = variant_counts()
    want, kw_, vw_ = pa.paged_attention_plain(q, kp2, vp2, tables, kn, vn, posv, is_global, **kw)
    acc = compare(out, want, KERNEL_ATOL, KERNEL_RTOL, f"paged_attention ({model})")
    if not (torch.equal(kp[1:], kw_[1:]) and torch.equal(vp[1:], vw_[1:])):
        raise AssertionError(f"paged_attention ({model}): appended pages differ from the plain version's")
    if not torch.equal(out, pa.paged_attention(q, kp, vp, tables, kn, vn, posv, is_global, **kw)[0]):
        raise AssertionError(f"paged_attention ({model}): two calls differ")
    del want, kw_, vw_
    # q, new K/V and out once, each row's cached keys inside its window
    # (or all of them) read once, the chunk's K/V written once; 4 flops per
    # (query, valid key, dim)
    cached = sum(min(p, window - 1) if window else p for p in pos)
    pairs = sum(min(p + c + 1, window) if window else p + c + 1 for p in pos for c in range(C))
    b_ms, b_by = bound(2 * (2 * B * C * Hq * hd + 2 * cached * Hkv * hd + 4 * B * C * Hkv * hd), 4 * hd * Hq * pairs)
    return {
        "model": model, "key": [B, C, Hq, Hkv, hd],
        "shape": f"B={B} C={C} Hq={Hq} Hkv={Hkv} hd={hd} bs={bs} table {nb} scattered pages pos={min(pos)}-{max(pos)}"
                 f" window={window}{f' softcap={cap}' if cap else ''} bf16",
        "variant": variant, **acc, "bit_equal_calls": True,
        **kernel_times(lambda: pa.paged_attention(q, kp, vp, tables, kn, vn, posv, is_global, **kw), 200),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_plain(q, kp2, vp2, tables, kn, vn, posv, is_global, **kw), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 129, N_REQUESTS)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


# the order of the serve phase's eager/captured A/B: each mode first once
# and last once; every other A/B serves one eager and one captured run (the
# script's time limit)
SERVE_AB_ORDER = (False, True, True, False)
AB_ORDER = (False, True)


def step_stats(eng) -> dict:
    """What the engine's step cache did: graphs captured, their capture
    time, replays, eager runs and graphs dropped by a new generation."""
    return dataclasses.asdict(eng.steps.stats)


def ab_runs(phase: str, name: str, make, serve, order=AB_ORDER, logits: bool = False, same=()) -> dict:
    """Serve one workload on fresh engines, eager (``capture_steps=False``)
    and captured, in ``order``; one JSON line per run. Every run must give
    the same tokens and the same launch, variant and dispatch counts (and
    the same values of the result's keys ``same``). Where
    ``order`` has both modes and ``logits`` (the static ``run()`` A/Bs of
    ``phase_serve``; elsewhere the tokens alone, the script's time limit),
    ``logits_ab`` then compares the logits in two more runs, outside the
    timed ones. Returns the first captured run's result (the main path)
    with ``ab`` = the per-run numbers."""
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
        emit({"phase": phase, "run": name, **{k: v for k, v in res.items() if k not in ("tokens", "shapes")}})
        results.append(res)
        eng.close()
        del eng
        _free()
    main = next(r for r in results if r["capture_steps"])
    for r in results:
        if r["tokens"] != main["tokens"]:
            raise AssertionError(f"{phase} ({name}): captured and eager tokens differ")
        for k in ("launches", "variants", "dispatch", "shapes") + tuple(same):
            if r.get(k) != main.get(k):
                raise AssertionError(f"{phase} ({name}): {k} differ, captured {main[k]} against {r[k]}")
    keys = ("wall_s", "tokens_per_s", "decode_ms_per_step", "decode_step_ms_mean", "prefill_ms",
            "max_memory_allocated")
    main = dict(main, ab=[{"capture_steps": r["capture_steps"], **{k: r[k] for k in keys if k in r},
                           "captures": r["steps"]["captures"], "capture_ms": r["steps"]["capture_ms"],
                           "replays": r["steps"]["replays"]} for r in results])
    logit = logits_ab(phase, name, make, serve, main["tokens"]) if logits and len(set(order)) == 2 else {}
    emit({"phase": phase, "run": name, "ab_order": ["captured" if c else "eager" for c in order],
          "tokens_equal": True, "counts_equal": True, **logit, "ab": main["ab"]})
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

        def keep(lg, params, generator=None, rows=None, seen=seen):
            seen.append(lg.clone())  # every logits tensor the engine samples from
            return sample(lg, params, generator, rows)

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


def phase_serve(cfg, params, phase: str = "serve", order=AB_ORDER) -> dict:
    """``run()`` of the 8 requests on a plain engine, eager and captured
    (in ``order``)."""
    from repro_torch.serving import InferenceEngine

    batches = math.ceil(N_REQUESTS / MAX_BATCH)
    L, steps = cfg.num_layers, MAX_NEW - 1
    # a model without attention (Falcon-Mamba) launches no kernel
    expect = {"flash_attention": batches * L, "paged_attention": batches * steps * L} if cfg.has_attention else {}
    if cfg.is_moe:  # a dense family's FFN is one plain matmul per projection
        expect["grouped_matmul"] = batches * (1 + steps) * 3 * L

    def serve(eng):
        res = _serve_static(eng, cfg, f"{phase} ({cfg.name})")
        if res["launches"] != expect:
            raise AssertionError(f"{phase} ({cfg.name}): launches {res['launches']}, expected {expect}")
        return res

    res = ab_runs(phase, f"{cfg.name} static",
                  lambda cap: InferenceEngine(cfg, params, max_batch=MAX_BATCH, capture_steps=cap), serve, order,
                  logits=True)
    res["first_batch_tokens"] = res["tokens"][:MAX_BATCH]
    return res


def _agree_runner(cfg, params):
    """The agree phase's first batch, padded as the engine pads it (host
    ids), and ``run(backend, forced)``: its prefill and MAX_NEW - 1 decode
    steps, each fed the argmax of ``forced``'s logits at that step (its own
    with None); every step's float32 logits on the card."""
    import torch

    from repro_torch.models import decode_step, prefill
    from repro_torch.serving.scheduler import FifoScheduler

    sched = FifoScheduler(max_batch=MAX_BATCH)
    for p in prompts(cfg)[:MAX_BATCH]:
        sched.submit(p, MAX_NEW)
    toks, _ = sched.pad_batch(sched.next_batch())
    tokens = torch.as_tensor(toks, dtype=torch.long, device="cuda")
    max_len = toks.shape[1] + MAX_NEW + 1

    def run(backend, forced):
        logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len, backend=backend)
        out = [logits.float()]
        for step in range(MAX_NEW - 1):
            logits, cache = decode_step(params, cfg, (forced or out)[step].argmax(-1)[:, None], cache,
                                        backend=backend)
            out.append(logits.float())
        return out

    return toks, run


def phase_agree(cfg, params, serve, phase: str = "agree", tol=AGREE_TOL,
                same_tol: float = AGREE_SAME_EXPERTS_TOL) -> dict:
    """Hopper against ref logits, teacher-forced on the hopper path's greedy
    tokens, twice: each path routing on its own, then the ref path taking
    the hopper path's expert choices (its gates still its own). Where the
    routers near-tie, the two paths pick other experts for a token; the
    second reading leaves that out and is held to
    ``same_tol`` (a dense family's one reading too)."""
    import torch

    _, run = _agree_runner(cfg, params)
    with torch.inference_mode():
        hop_experts = []
        with _routing(hop_experts):
            hop = run("hopper", None)
        greedy = torch.stack([h.argmax(-1) for h in hop], 1).tolist()
        if greedy != serve["first_batch_tokens"]:
            raise AssertionError("agree: direct hopper decode differs from the engine's tokens")
        for step, h in enumerate(hop):
            if not torch.isfinite(h).all():
                raise AssertionError(f"agree: non-finite hopper logits at step {step}")
        ref_experts = []
        with _routing(ref_experts):
            ref = run("ref", hop)
        readings = {"": _errors(hop, ref)}
        if hop_experts:
            # a flip: a token whose set of experts in one layer differs
            per_step = len(hop_experts) // MAX_NEW
            flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                     for a, b in zip(hop_experts, ref_experts)]
            readings[""]["expert_flips_per_step"] = [sum(flips[i:i + per_step])
                                                     for i in range(0, len(flips), per_step)]
            readings[""]["routed_token_layers_per_step"] = [sum(int(a.shape[0]) for a in hop_experts[i:i + per_step])
                                                      for i in range(0, len(flips), per_step)]
            del ref
            with _routing([], hop_experts):
                ref = run("ref", hop)
            readings["_same_experts"] = _errors(hop, ref)
        del hop, ref, hop_experts, ref_experts
    res = {"phase": phase, "model": cfg.name, "steps": MAX_NEW,
           **{k + suffix: v for suffix, r in readings.items() for k, v in r.items()},
           "rel_l2_tol": tol[0], "max_rel_tol": tol[1], "same_experts_rel_l2_tol": same_tol}
    emit(res)
    same = readings.get("_same_experts", readings[""])
    if (max(res["rel_l2_err_per_step"]) > tol[0] or max(res["max_rel_err_per_step"]) > tol[1]
            or max(same["rel_l2_err_per_step"]) > same_tol):
        raise AssertionError(f"{phase} ({cfg.name}): hopper and ref logits differ beyond the bf16 tolerance: {res}")
    return res


def sharded_reference(cfg, params) -> dict:
    """The sharded phase's teacher-forced reference, on one card at
    ``cfg``'s depth: the agree phase's first batch (padded tokens), the
    hopper path's greedy logits, expert choices and dropped token slots,
    and the same of one rank routing each half of the tokens with its own
    capacity (the function an EP2 plan computes) fed the same tokens; on
    the host."""
    import torch

    toks, run = _agree_runner(cfg, params)
    with torch.inference_mode():
        experts, drops = [], []
        with _routing(experts), _dropping(drops):
            hop = run("hopper", None)
        ep2_drops, ep2_experts = [], []
        with _dropping(ep2_drops), _routing(ep2_experts), _ep_halves(ep2_drops, ep2_experts):
            ep2 = run("hopper", hop)
    return dict(tokens=toks, logits=[h.cpu() for h in hop], experts=[e.cpu() for e in experts], drops=drops,
                logits_ep2=[h.cpu() for h in ep2], experts_ep2=[e.cpu() for e in ep2_experts], drops_ep2=ep2_drops)


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _errors(hop, ref) -> dict:
    """Per step: relative L2 error over the (B, V) logits, largest error
    relative to the largest ref logit; and the share of equal argmaxes."""
    l2 = [_rel_l2(h, r) for h, r in zip(hop, ref)]
    mx = [((h - r).abs().max() / r.abs().max()).item() for h, r in zip(hop, ref)]
    same = sum(int((h.argmax(-1) == r.argmax(-1)).sum()) for h, r in zip(hop, ref))
    return {"rel_l2_err_per_step": l2, "max_rel_err_per_step": mx, "argmax_agreement": same / (len(hop) * MAX_BATCH)}


@contextlib.contextmanager
def _routing(seen: list, forced=None):
    """Inside the block every MoE layer's routing appends its expert
    choices (T, k) to ``seen``; with ``forced`` (choices recorded so, in the
    same order of layers and steps) each layer takes those instead of its
    own, its gates its own router's probabilities at them, renormalised."""
    import torch

    from repro_torch.models import moe

    route, it = moe.route, iter(forced) if forced is not None else None

    def spy(x_flat, router_w, cfg, plan=None):
        gates, idx, aux = route(x_flat, router_w, cfg, plan)
        seen.append(idx)
        if it is not None:
            idx = next(it)
            gates = torch.softmax(x_flat.float() @ router_w.float(), dim=-1).gather(-1, idx)
            gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
        return gates, idx, aux

    moe.route = spy
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def _ep_halves(*records, n: int = 2):
    """Inside the block every MoE layer routes its tokens in ``n`` equal
    parts, each with the capacity of its part: on one rank, the function an
    EP plan over ``n`` ranks computes (``models.moe._moe_ep`` splits the
    tokens so). Each list of ``records`` (filled by ``_routing`` or
    ``_dropping`` spies inside the block) gets one entry per layer, its
    parts' entries joined."""
    import torch

    from repro_torch.models import moe

    local = moe._moe_local

    def parts(x_flat, moe_p, cfg, **kw):
        if x_flat.shape[0] % n:
            return local(x_flat, moe_p, cfg, **kw)
        outs = [local(x, moe_p, cfg, **kw) for x in x_flat.chunk(n)]
        for rec in records:
            rec[-n:] = [torch.cat(rec[-n:]) if isinstance(rec[-1], torch.Tensor) else sum(rec[-n:])]
        aux = None if outs[0][1] is None else sum(o[1] for o in outs) / n
        return torch.cat([o[0] for o in outs]), aux, torch.cat([o[2] for o in outs])

    moe._moe_local = parts
    try:
        yield
    finally:
        moe._moe_local = local


@contextlib.contextmanager
def _dropping(counts: list):
    """Inside the block every MoE dispatch appends the number of token
    slots its capacity dropped to ``counts``."""
    from repro_torch.models import moe

    make = moe.make_dispatch

    def spy(idx, gates, E, C):
        out = make(idx, gates, E, C)
        counts.append(int((~out[2]).sum()))
        return out

    moe.make_dispatch = spy
    try:
        yield
    finally:
        moe.make_dispatch = make


def cont_requests(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    system = rng.integers(1, cfg.vocab_size, CONT_SYSTEM).tolist()
    return [
        (system + rng.integers(1, cfg.vocab_size, CONT_OWN).tolist(), CONT_MAX_NEW[i % len(CONT_MAX_NEW)])
        for i in range(CONT_REQUESTS)
    ]


def phase_continuous(cfg, params, phase: str = "continuous", caches=(False, True)) -> dict:
    """Serve the continuous traffic with the prefix cache off, then on (or
    as ``caches`` says), each eager and captured; returns the captured
    prefix-cache run."""
    from repro_torch.serving import InferenceEngine

    L = cfg.num_layers
    runs = {}
    for pc in caches:
        name = f"{cfg.name} {'prefix' if pc else 'plain'}"
        what = f"{phase} ({name})"

        def serve(eng, pc=pc, what=what):
            res, toks = _serve_continuous(eng, cfg, what)
            st = res["stats"]
            expect = {"paged_attention": (st["prefill_chunks"] + (0 if pc else st["decode_steps"])) * L}
            if cfg.is_moe:
                expect["grouped_matmul"] = (st["prefill_chunks"] + st["decode_steps"]) * 3 * L
            if pc:
                expect["prefix_paged_attention"] = st["decode_steps"] * L
            if res["launches"] != expect:
                raise AssertionError(f"{what}: launches {res['launches']}, expected {expect}")
            if pc and st["prefix_hit_blocks"] <= 0:
                raise AssertionError(f"{what}: no prefix block was shared")
            if pc and st["prefix_grouped_steps"] <= 0:
                raise AssertionError(f"{what}: no decode step read a shared run through a group")
            return dict(res, prefix_cache=pc, tokens=toks)

        runs[pc] = ab_runs(phase, name, lambda cap, pc=pc: InferenceEngine(
            cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK, prefix_cache=pc, capture_steps=cap),
            serve)
        mark(name)
    if len(runs) == 2 and runs[True]["tokens"] != runs[False]["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(runs[True]["tokens"], runs[False]["tokens"])) if a != b]
        raise AssertionError(f"{phase} ({cfg.name}): prefix-cache tokens differ from the plain run's for requests "
                             f"{diff}")
    return dict(runs[caches[-1]], plain_tokens=runs[False]["tokens"] if False in runs else None)


def contiguous_expect(cfg, st) -> dict:
    """The launches of a contiguous ``serve_continuous`` run: each join's
    prefill (B=1) runs flash and the expert matmuls once per layer, each
    decode step the paged kernel (identity table) and the expert matmuls;
    none for a model without attention and experts."""
    L = cfg.num_layers
    expect = {"flash_attention": st["joins"] * L, "paged_attention": st["decode_steps"] * L} if cfg.has_attention \
        else {}
    if cfg.is_moe:
        expect["grouped_matmul"] = (st["joins"] + st["decode_steps"]) * 3 * L
    return expect


def serve_contiguous(cfg, params, phase: str, name: str, order=AB_ORDER) -> dict:
    """The continuous traffic through the contiguous fallback
    (``paged=False``), eager and captured (in ``order``), with exact launch
    counts and no paged-path step; returns the first captured run."""
    from repro_torch.serving import InferenceEngine

    def serve(eng):
        res, toks = _serve_continuous(eng, cfg, f"{phase} ({name})")
        st = res["stats"]
        if res["launches"] != contiguous_expect(cfg, st):
            raise AssertionError(f"{phase} ({name}): launches {res['launches']}, expected {contiguous_expect(cfg, st)}")
        if st["prefill_chunks"] or st["fused_steps"] or st["joins"] != CONT_REQUESTS or eng.paged:
            raise AssertionError(f"{phase} ({name}): not the contiguous path: {st}")
        return dict(res, tokens=toks)

    return ab_runs(phase, name, lambda cap: InferenceEngine(cfg, params, max_batch=CONT_MAX_BATCH, paged=False,
                                                            capture_steps=cap), serve, order)


def _logit_gap(cfg, params, prompt, want, got, bucket: int = 1, noise: bool = False) -> dict:
    """Where ``got`` first differs from ``want``: the two tokens' logit gap
    in a teacher-forced prefill of ``prompt`` (left-padded to a multiple of
    ``bucket`` as the engine pads it) and ``want`` up to there, as a share
    of the row's max |logit|. With ``noise``, also ``ref_noise``: the same
    prefill on the ref backend, its largest logit error against the hopper
    one there, on the same share. Where each logit of one computation lies
    within that of the other's, the two rank a pair of tokens otherwise
    only where the pair's gap is under twice it."""
    import torch

    from repro_torch.models import prefill
    from repro_torch.serving.scheduler import round_up

    p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    pad = [0] * (round_up(len(prompt), bucket) - len(prompt))
    toks = torch.tensor([pad + list(prompt) + want[:p]], dtype=torch.long, device=params["embed"].device)
    with torch.inference_mode():
        hop = prefill(params, cfg, {"tokens": toks}, toks.shape[1] + 1)[0][0].float()
        top = hop.abs().max().item()
        res = {"position": p, "gap": (hop[want[p]] - hop[got[p]]).abs().item() / top}
        if noise:
            ref = prefill(params, cfg, {"tokens": toks}, toks.shape[1] + 1, backend="ref")[0][0].float()
            res["ref_noise"] = (hop - ref).abs().max().item() / top
    return res


# contiguous phase: the float32 gate's depth (full width); its weights sit
# beside DeepSeek's bf16 ones (~9.5 GB more)
CONTIG_F32_LAYERS = 4


def _served_tokens(eng, cfg) -> list:
    """The continuous traffic's tokens from ``eng`` (any dtype, no variant
    or launch checks), the engine closed after."""
    from repro_torch.serving import Request

    for p, g in cont_requests(cfg):
        eng.submit(Request(prompt=p, max_new_tokens=g))
    toks = [c.tokens for c in eng.serve_continuous()]
    eng.close()
    return toks


def _paged_against_contiguous(cfg, params, noise: bool = False) -> list:
    """The continuous traffic through the paged (cache off) and the
    contiguous path on fresh engines; each request whose tokens differ,
    with ``_logit_gap`` (its ``noise`` too)."""
    from repro_torch.serving import InferenceEngine

    reqs = cont_requests(cfg)
    toks = {paged: _served_tokens(InferenceEngine(cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK,
                                                  paged=paged), cfg) for paged in (True, False)}
    _free()
    return [dict(uid=uid, **_logit_gap(cfg, params, reqs[uid][0], want, got, 64, noise))
            for uid, (got, want) in enumerate(zip(toks[False], toks[True])) if got != want]


def phase_contiguous(cfg, params, paged_tokens) -> dict:
    """DeepSeekMoE-16B's continuous traffic through the contiguous fallback,
    eager and captured (equal tokens and counts, launches exact), then the
    contiguous path against the paged one, where the first prefills each
    request whole through flash and the second in 64-token chunks through
    the paged kernel:

    - the gate, in float32 at full width (the first ``CONTIG_F32_LAYERS``
      layers, capacity factor E / k so no token drops): each request's
      tokens equal, or their first difference a near-tie (a gap under
      ``NEAR_TIE`` of the row's max |logit| in a teacher-forced prefill). A
      wrong merge, position or state hand-off diverges at once, by far more;
    - in bf16 at full depth, the same comparison at capacity factor E / k.
      There the two prefills round differently, a router near-tie picks
      another expert for a token, and a request's tokens part at gaps
      beyond a fixed near-tie (the H100 read up to 0.088 of the max
      |logit|). So each first difference is held to the noise measured at
      its own position in the same run: its gap under twice the ref
      backend's largest logit error against the hopper one there
      (``_logit_gap``'s ``ref_noise``), the gap that two computations of
      the same function part at. A wrong merge or position reads a gap of
      order the row's max |logit|;
    - reported: the share of equal requests at the model's own capacity
      factor (against ``paged_tokens``, the continuous phase's cache-off
      run), where the two paths' MoE capacities differ by design (a whole
      256-token prefill against 64-token chunks) and drop other tokens."""
    import torch

    from repro_torch.models import init_params

    main = serve_contiguous(cfg, params, "contiguous", f"{cfg.name} contiguous")
    same = sum(a == b for a, b in zip(main["tokens"], paged_tokens))
    nd = dataclasses.replace(cfg, capacity_factor=REPL_CAPACITY)
    bf16 = _paged_against_contiguous(nd, params, noise=True)
    f32 = dataclasses.replace(nd, dtype="float32", num_layers=CONTIG_F32_LAYERS)
    p32 = init_params(f32, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    ties = _paged_against_contiguous(f32, p32)
    del p32
    _free()
    res = {"phase": "contiguous", "run": f"{cfg.name} contiguous against paged", "requests": CONT_REQUESTS,
           "bf16_equal_at_own_capacity": same, "no_drop_capacity_factor": REPL_CAPACITY,
           "bf16_equal_no_drops": CONT_REQUESTS - len(bf16), "bf16_first_differences": bf16,
           "f32_layers": CONTIG_F32_LAYERS, "f32_equal_no_drops": CONT_REQUESTS - len(ties),
           "f32_first_differences": ties, "near_tie_bound": NEAR_TIE, "bf16_gap_bound": "2 x ref_noise"}
    emit(res)
    bad = [t for t in ties if t["gap"] >= NEAR_TIE]
    if bad:
        raise AssertionError(f"contiguous ({cfg.name}): float32 tokens differ from the paged run's beyond a near-tie: "
                             f"{bad}")
    bad = [t for t in bf16 if t["gap"] >= 2 * t["ref_noise"]]
    if bad:
        raise AssertionError(f"contiguous ({cfg.name}): bf16 tokens differ from the paged run's beyond twice the "
                             f"noise at that position: {bad}")
    return dict(main, comparison=res)


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
    shapes = launch_shapes()
    variants = check_variants(name, launches)
    if len(comps) != N_REQUESTS or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError(f"{name}: expected {N_REQUESTS} completions of {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for c in comps for t in c.tokens):
        raise AssertionError(f"{name}: a token outside the vocabulary")
    refs = ref_ops(dispatch)
    if refs:
        raise AssertionError(f"{name}: ref ops ran on the main path: {refs}")
    no_fallback(name, dataclasses.asdict(st))
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
        "dispatch": dispatch, "shapes": shapes, "tokens": [c.tokens for c in comps],
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
    shapes = launch_shapes()
    variants = check_variants(name, launches)
    if [len(c.tokens) for c in comps] != [g for _, g in reqs]:
        raise AssertionError(f"{name}: a request did not get its budget")
    refs = ref_ops(dispatch)
    if refs:
        raise AssertionError(f"{name}: ref ops ran on the main path: {refs}")
    if any(not 0 <= t < cfg.vocab_size for c in comps for t in c.tokens):
        raise AssertionError(f"{name}: a token outside the vocabulary")
    no_fallback(name, dataclasses.asdict(st))
    tokens = sum(len(c.tokens) for c in comps)
    return {
        "model": cfg.name, "layers": cfg.num_layers, "requests": len(comps), "max_batch": CONT_MAX_BATCH,
        "kv_block_size": CONT_BLOCK, "kv_pool_blocks": eng.kv_pool_blocks, "tokens_generated": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": st.decode_steps,
        "decode_step_ms_mean": st.decode_step_ms_sum / st.decode_steps, "decode_step_ms_max": st.decode_step_ms_max,
        "prefill_chunks": st.prefill_chunks, "prefill_ms": [c.prefill_ms for c in comps],
        "transition_ms_total": st.transition_ms_total, "resident_bytes_saved": st.resident_bytes_saved,
        "max_memory_allocated": torch.cuda.max_memory_allocated(), "stats": dataclasses.asdict(st),
        "launches": launches, "variants": variants, "dispatch": dispatch, "shapes": shapes,
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
              **{k: v for k, v in res.items() if k not in ("tokens", "shapes")}})
        runs[asy] = res
        eng.close()
        del eng, leaves
    del restored
    _free()
    if runs[True]["tokens"] != runs[False]["tokens"]:
        raise AssertionError("transitions: async tokens differ from the sync ones")
    return runs[True]


# replication phase: hot-expert replication and predictive prefetch on
# DeepSeekMoE-16B at full width and depth (ROADMAP A.4)
REPL_REPLICAS = 4  # extra replica slots: 64 experts -> 68 slots
REPL_INTERVAL = 8  # tracked decode steps between rebalances
# the doctored runs' capacity factor: E / top_k gives every expert the
# capacity of all the tokens, so nothing drops. (At 8.0, which drops nothing
# at the reduced config's 4 experts top-2, DeepSeek's capacity is 0.75 of
# the tokens, and experts 0 and 2-5 each receive every token.)
REPL_CAPACITY = 64 / 6
REPL_TOL = 1e-3  # rel L2, replicated against unreplicated teacher-forced logits (replicas are copies)
PREFETCH_TOP_P = 0.9
REPLICATED = "deepseek-moe-16b replicated"  # the model of a kernel row at a replicated (slot) shape


def _doctored_router(cfg):
    """The router of ``tests/test_replication.py`` at full width: expert 1
    projects onto +v and every other expert onto -v, so the experts other
    than 1 tie and the lowest ids win: expert 0 is in every token's top-2
    (and 0, 2-5 in every token's top-6), a guaranteed hot expert."""
    import numpy as np
    import torch

    L, d, E = cfg.num_layers, cfg.d_model, cfg.n_routed_experts
    v = torch.from_numpy(np.random.default_rng(SEED + 5).normal(size=d).astype(np.float32))
    r = (-v)[None, :, None].expand(L, d, E).clone()
    r[:, :, 1] = v
    return r.to("cuda", torch.bfloat16)


_SMI = []


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, read once."""
    if not _SMI:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        _SMI.append(smi.stdout.strip().splitlines()[0])
    return _SMI[0]


def _forced_logits(cfg, params, tokens, backend, feed=None, plan=None) -> list:
    """Prefill of ``tokens`` and MAX_NEW - 1 decode steps under ``plan``,
    each step fed the argmax of ``feed``'s logits at that step (its own
    with None); every step's float32 logits on the host."""
    import torch

    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        logits, cache = prefill(params, cfg, {"tokens": tokens}, tokens.shape[1] + MAX_NEW + 1, backend=backend,
                                plan=plan)
        out = [logits.float().cpu()]
        for step in range(MAX_NEW - 1):
            tok = (feed or out)[step].argmax(-1)[:, None].cuda()
            logits, cache = decode_step(params, cfg, tok, cache, backend=backend, plan=plan)
            out.append(logits.float().cpu())
    return out


def _first_batch(cfg):
    """The serve traffic's first batch, padded as the engine pads it."""
    import torch

    from repro_torch.serving.scheduler import FifoScheduler

    sched = FifoScheduler(max_batch=MAX_BATCH)
    for p in prompts(cfg)[:MAX_BATCH]:
        sched.submit(p, MAX_NEW)
    toks, _ = sched.pad_batch(sched.next_batch())
    return torch.as_tensor(toks, dtype=torch.long, device="cuda")


def _replication_stats(eng, res) -> dict:
    """A served run's replication and prefetch accounting."""
    st, rep = eng.stats, eng._replication
    return {
        "rebalances": st.replication_rebalances, "routing_steps": st.routing_steps,
        "degrees": list(rep.degrees) if rep is not None else None, "order": list(rep.order) if rep is not None else None,
        "slots": rep.total_slots if rep is not None else eng.cfg.n_routed_experts,
        "rebalance_ms_total": st.transition_ms_total if eng.session is None else None,
        "peak_gb": res["max_memory_allocated"] / 1e9, "decode_ms_per_step": res["decode_ms_per_step"],
        "prefill_ms": res["prefill_ms"], "transition_ms_total": st.transition_ms_total,
        "restore_wait_ms": st.restore_wait_ms,
        **{k: getattr(st, k) for k in ("prefetch_predicted", "prefetch_hits", "prefetch_misses", "prefetch_bytes",
                                       "prefetch_hidden_ms", "prefetch_exposed_ms", "prefetch_errors")},
        "card": card_line(),
    }


def _replication_reference(cfg, params, tokens) -> dict:
    """The teacher-forced logits and expert choices of ``tokens`` on one
    rank (the reference of the sharded phase's replicated run)."""
    seen = []
    with _routing(seen):
        logits = _forced_logits(cfg, params, tokens, "hopper")
    return dict(tokens=tokens.cpu().numpy(), logits=logits, experts=[e.cpu() for e in seen])


UNPRINTED = ("tokens", "dispatch", "variants", "shapes")  # a served run's keys its JSON line leaves out


def phase_replication(cfg, params, trans, shapes) -> dict:
    """Hot-expert replication and predictive prefetch at full width and
    depth. (d) prefetch on the resident phase's switching session, sync and
    async, against prefetch off, and dense INT4 restores from staged rows at
    the transitions phase's 4 layers; (b) free routing (capacity factor
    1.25) with replication, hopper against ref on the replicated layout;
    then, with the doctored router at capacity factor E / k (nothing drops):
    (c) resident INT4 with replication against a dense engine on the
    round-tripped weights, and (a) the replicated engine eager and captured
    against the unreplicated one, tokens and teacher-forced logits. Each
    run's kernel launches are recorded by shape in ``shapes`` (kernel ->
    shape -> run -> launches in that run alone, captured replays
    included). Returns the reference the sharded phase's replicated run is
    held to: the teacher-forced logits and expert choices of these weights'
    first ``SHARDED_REF_LAYERS`` layers (the INT4 round trip the resident
    phase left) with the model's own
    router at capacity factor E / k, where nothing drops, so that each half
    of the tokens routed with its own capacity (EP2's function) and any
    replica set compute the same function."""
    import torch

    from repro_torch.serving import InferenceEngine

    L = cfg.num_layers
    batches, steps = math.ceil(N_REQUESTS / MAX_BATCH), MAX_NEW - 1
    gmm = batches * (1 + steps) * 3 * L
    cfg_nd = dataclasses.replace(cfg, capacity_factor=REPL_CAPACITY)
    tokens = _first_batch(cfg)
    out = _replication_reference(dataclasses.replace(cfg_nd, num_layers=SHARDED_REF_LAYERS),
                                 _first_layers_of(params, SHARDED_REF_LAYERS), tokens)

    def record(run, res):
        for kernel, by_shape in res["shapes"].items():
            for key, n in by_shape.items():
                shapes.setdefault(kernel, {}).setdefault(key, {})[run] = n

    def check_rebalanced(name, eng):
        rep = eng._replication
        freqs = eng._tracker.frequencies()
        hot = int(freqs.argmax())
        if eng.stats.replication_rebalances < 1 or rep is None:
            raise AssertionError(f"replication ({name}): no rebalance in {eng.stats.routing_steps} tracked steps")
        if rep.degrees[hot] != max(rep.degrees) or rep.total_slots != cfg.n_routed_experts + REPL_REPLICAS:
            raise AssertionError(f"replication ({name}): hot expert {hot} holds degree {rep.degrees[hot]} of "
                                 f"{rep.degrees}")
        if eng.params["layers"]["moe"]["wi_gate"].shape[1] != rep.total_slots:
            raise AssertionError(f"replication ({name}): the expert leaves are not in the replica set's slots")

    # (d) prefetch on the resident session; the same path dense at 4 layers
    pf = {}
    for asy in (True, False):
        for on in (False, True):
            eng = _session(cfg).engine(params, max_batch=MAX_BATCH, resident_int4=True, use_int4_transition=True,
                                       async_transitions=asy, prefetch=on, prefetch_top_p=PREFETCH_TOP_P)
            name = f"prefetch resident (async={asy}, prefetch={on})"
            res = _serve_static(eng, cfg, name)
            record(name, res)
            if res["launches"].get("int4_dequant") != gmm:
                raise AssertionError(f"{name}: launches {res['launches']}")
            pf[asy, on] = dict(res, **_replication_stats(eng, res))
            emit({"phase": "replication", "run": name, **{k: v for k, v in pf[asy, on].items()
                                                          if k not in UNPRINTED}})
            eng.close()
            del eng
            _free()
        if pf[asy, True]["tokens"] != pf[asy, False]["tokens"]:
            raise AssertionError(f"replication: prefetch-on tokens differ from prefetch-off (async={asy})")
        if pf[asy, True]["prefetch_hits"] <= 0 or pf[asy, True]["prefetch_errors"]:
            raise AssertionError(f"replication: prefetch (async={asy}) hit nothing: {pf[asy, True]}")
    if pf[True, True]["tokens"] != pf[False, True]["tokens"]:
        raise AssertionError("replication: async prefetch tokens differ from the sync ones")
    cfg4 = dataclasses.replace(cfg, num_layers=TRANSITION_LAYERS)
    params4 = dict(params, layers=_first_layers(params["layers"], TRANSITION_LAYERS))
    for asy in (True, False):
        eng = _session(cfg4).engine(params4, max_batch=MAX_BATCH, use_int4_transition=True, async_transitions=asy,
                                    prefetch=True, prefetch_top_p=PREFETCH_TOP_P)
        name = f"prefetch dense 4 layers (async={asy})"
        res = _serve_static(eng, cfg4, name)
        record(name, res)
        row = dict(res, **_replication_stats(eng, res), reduced={"num_layers": TRANSITION_LAYERS},
                   prefetch_off_transition_ms_total=trans["transition_ms_total"])
        emit({"phase": "replication", "run": name, **{k: v for k, v in row.items()
                                                      if k not in UNPRINTED}})
        if res["tokens"] != trans["tokens"] or row["prefetch_hits"] <= 0:
            raise AssertionError(f"{name}: tokens differ from the transitions phase's, or nothing hit: {row}")
        eng.close()
        del eng
        _free()
    del params4

    # (b) free routing with replication: hopper against ref on the replicated layout
    eng = InferenceEngine(cfg, params, max_batch=MAX_BATCH, replicate_experts=REPL_REPLICAS,
                          rebalance_interval=REPL_INTERVAL)
    res = _serve_static(eng, cfg, "replication (free routing)")
    record("free routing", res)
    free = dict(res, **_replication_stats(eng, res))
    check_rebalanced("free routing", eng)
    slot_params, plan = eng.params, eng._sharding_for("decode")
    eng.close()
    del eng
    hop_experts, ref_experts = [], []
    with _routing(hop_experts):
        hop = _forced_logits(cfg, slot_params, tokens, "hopper", plan=plan)
    with _routing(ref_experts):
        ref = _forced_logits(cfg, slot_params, tokens, "ref", feed=hop, plan=plan)
    own = _errors(hop, ref)
    del ref, ref_experts
    with _routing([], hop_experts):
        ref = _forced_logits(cfg, slot_params, tokens, "ref", feed=hop, plan=plan)
    same = _errors(hop, ref)
    del slot_params, hop, ref, hop_experts
    _free()
    emit({"phase": "replication", "run": "free routing (capacity factor 1.25)",
          **{k: v for k, v in free.items() if k not in UNPRINTED},
          "agree": own, "agree_same_experts": same, "same_experts_rel_l2_tol": AGREE_SAME_EXPERTS_TOL})
    if max(same["rel_l2_err_per_step"]) > AGREE_SAME_EXPERTS_TOL:
        raise AssertionError(f"replication (free routing): hopper and ref differ on the same experts: {same}")

    # the doctored router, nothing dropped (the router leaf is overwritten
    # in place, and put back at the end of the phase)
    router = params["layers"]["moe"]["router"].clone()
    params["layers"]["moe"]["router"].copy_(_doctored_router(cfg))

    # (c) resident INT4 with replication, then a dense engine on the round-tripped weights
    def make_resident(capture):
        return InferenceEngine(cfg_nd, params, max_batch=MAX_BATCH, resident_int4=True,
                               replicate_experts=REPL_REPLICAS, rebalance_interval=REPL_INTERVAL,
                               capture_steps=capture)

    eng = make_resident(True)
    res = _serve_static(eng, cfg_nd, "replication (resident)")
    record("resident", res)
    resident = dict(res, **_replication_stats(eng, res))
    check_rebalanced("resident", eng)
    slots = eng._replication.total_slots
    want_g = slots * cfg.d_model * cfg.moe_d_ff // 128
    if res["launches"].get("int4_dequant") != gmm or not any(
            key[0] == want_g for key in res["shapes"].get("int4_dequant", {})):
        raise AssertionError(f"replication (resident): no dequant launch at the {slots}-slot leaf: {res['launches']}")
    backups = eng._tx._backups
    eng.close()
    del eng
    _round_trip_in_place(params, backups)
    del backups
    _free()
    emit({"phase": "replication", "run": "resident", **{k: v for k, v in resident.items()
                                                         if k not in UNPRINTED}})

    # (a) the unreplicated reference, then the replicated engine eager and captured
    eng = InferenceEngine(cfg_nd, params, max_batch=MAX_BATCH)
    base = _serve_static(eng, cfg_nd, "replication (unreplicated)")
    record("unreplicated", base)
    eng.close()
    del eng
    if base["tokens"] != resident["tokens"]:
        raise AssertionError("replication: the resident replicated engine's tokens differ from the dense engine's")
    base_experts = []
    with _routing(base_experts):
        base_logits = _forced_logits(cfg_nd, params, tokens, "hopper")
    emit({"phase": "replication", "run": "unreplicated (doctored router, no drops)",
          **{k: v for k, v in base.items() if k not in UNPRINTED}, "card": card_line()})

    sets = set()  # the replica set and decode plan each run ended in

    def serve(eng):
        res = _serve_static(eng, cfg_nd, "replication (doctored)")
        check_rebalanced("doctored", eng)
        sets.add((eng._replication, eng._sharding_for("decode")))
        return dict(res, **_replication_stats(eng, res))

    def make(capture):
        return InferenceEngine(cfg_nd, params, max_batch=MAX_BATCH, replicate_experts=REPL_REPLICAS,
                               rebalance_interval=REPL_INTERVAL, capture_steps=capture)

    main = ab_runs("replication", "doctored_replicated", make, serve)
    record("doctored replicated, captured", main)
    if main["tokens"] != base["tokens"]:
        raise AssertionError("replication: the replicated engine's greedy tokens differ from the unreplicated one's")
    if len(sets) != 1:
        raise AssertionError(f"replication: the doctored runs ended in different replica sets: {sets}")
    # the teacher-forced logits on the weights laid out in that set's slots
    from repro_torch.models.moe import slot_weights

    (rep, plan), = sets
    moe = params["layers"]["moe"]
    slot_params = dict(params, layers=dict(params["layers"], moe=dict(moe, **{
        n: slot_weights(moe[n], rep, dim=1) for n in ("wi_gate", "wi_up", "wo")})))
    got = _forced_logits(cfg_nd, slot_params, tokens, "hopper", feed=base_logits, plan=plan)
    del slot_params
    _free()
    l2 = [((g - w).norm() / w.norm()).item() for g, w in zip(got, base_logits)]
    dmax = max((g - w).abs().max().item() for g, w in zip(got, base_logits))
    decode = {"replicated": main["decode_ms_per_step"], "unreplicated": base["decode_ms_per_step"]}
    emit({"phase": "replication", "run": "doctored_replicated_vs_unreplicated", "tokens_equal": True,
          "teacher_forced_rel_l2_per_step": l2, "teacher_forced_max_abs_delta": dmax, "rel_l2_tol": REPL_TOL,
          "decode_ms_per_step": decode, "prefill_ms": {"replicated": main["prefill_ms"],
                                                       "unreplicated": base["prefill_ms"]},
          "rebalance_ms_total": main["rebalance_ms_total"], "degrees": main["degrees"], "card": card_line()})
    if max(l2) > REPL_TOL:
        raise AssertionError(f"replication: replicated logits differ from the unreplicated ones: {l2}")
    del got, base_logits, base_experts
    params["layers"]["moe"]["router"].copy_(router)
    return out


def replication_kernel_rows(cfg, rows, shapes) -> None:
    """The grouped matmul and the dequant against their plain versions at
    each shape the replication phase's runs sent them that the kernels
    phase has no row for (the slot counts, the slot leaves, the barrier's
    assembled leaf), each with its launches in each run that sent it
    (``launches_replication``: run -> launches)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    by_name = {r["name"]: r for r in rows}

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def randn(*shape, std=1.0):  # on the card: a weight of 68 slots is 196M values
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    added = []
    for key, per_run in sorted(shapes.get("grouped_matmul", {}).items()):
        E, C, K, N = key
        if E == cfg.n_routed_experts and C in (8, 16, 64):
            continue  # the kernels phase's rows
        row = gmm_case(randn, REPLICATED, E, C, K, N, "wi" if K == cfg.d_model else "wo")
        row["launches_replication"] = per_run
        by_name["grouped_matmul"]["also"].append(row)
        added.append(row)
        torch.cuda.empty_cache()
    one_layer = cfg.n_routed_experts * cfg.d_model * cfg.moe_d_ff // 128
    for key, per_run in sorted(shapes.get("int4_dequant", {}).items()):
        G, gs, dt = key
        if G == one_layer and gs == 128 and dt == "bfloat16":
            continue  # the kernels phase's main row
        row = dequant_case(rng, dev, G, gs, getattr(torch, dt), REPLICATED)
        row["launches_replication"] = per_run
        by_name["int4_dequant"]["also"].append(row)
        added.append(row)
        torch.cuda.empty_cache()
    emit({"phase": "replication_kernels", "rows": added})


# robustness phase (DESIGN.md §4f): the continuous traffic at the
# replication phase's capacity factor E / k (C = T: nothing drops, so rows
# cannot couple through an expert's capacity, and only a replay changes a
# row's arithmetic). The schedule (admissions, growth, preemptions) depends
# on the lengths alone, never on the weights or tokens, so the CPU tests'
# reduced model gives the same one (tests/test_torch_faults.py).
# The phase runs the first ROBUST_LAYERS of DeepSeek's 28 layers (views of
# the same weights): the schedule does not depend on the depth, and the
# later phases needed the time (one H100 run with the vlm and train phases
# read 1,061 s of phases at full depth, against the 1,050 s the script
# keeps to; the launcher and the sharded phase's new runs took it from 7
# layers to 2).
ROBUST_LAYERS = 2
ROBUST_OVERCOMMIT = 0.25
ROBUST_ROWS = 3  # the pool: this many rows' expected need (17 blocks each); worst case admits 2
ROBUST_CACHE_BLOCKS = 38  # with the prefix cache on, the pool that evicts and preempts under growth
NEAR_TIE = 0.02  # a replay's first differing token: logit gap below this share of the row's max |logit|
# lifecycle run, on the worst-case pool (2 rows live, the rest queued), the
# clock reading decode steps: uid -> deadline in decode steps (uid 15
# expires queued, uid 1 live), and (uid, after so many engine steps) cancels
# (uid 14 queued, uid 0 live)
ROBUST_DEADLINES = {1: 6, 15: 5}
ROBUST_CANCELS = ((14, 3), (0, 8))
# what every eager and captured run of one workload must agree on, beside the tokens and counts
ROBUST_SAME = ("done", "stash", "preemptions", "preempted_tokens", "prefix_evictions_on_pressure", "cancelled",
               "deadline_expired", "recomputed_tokens")
STALL_MARGIN = 10  # a restore stall outlasts the measured kick-to-barrier time this many times
STALL_TIMEOUT_S = 0.05


def robust_pool(cfg) -> tuple:
    """(the pool in blocks, each request's worst-case and expected blocks)
    of the continuous traffic: ``ROBUST_ROWS`` rows' expected need, which
    admits one row fewer at the worst case."""
    from repro_torch.serving.kv_cache import blocks_for
    from repro_torch.serving.scheduler import ContinuousScheduler

    sch = ContinuousScheduler(max_batch=CONT_MAX_BATCH, bucket=64)
    for p, g in cont_requests(cfg):
        sch.submit(p, g)
    worst = [blocks_for(sch.kv_need(r), CONT_BLOCK) for r in sch.queued()]
    expect = [blocks_for(sch.expected_kv_need(r, ROBUST_OVERCOMMIT), CONT_BLOCK) for r in sch.queued()]
    pool = ROBUST_ROWS * max(expect)
    if sum(worst[:ROBUST_ROWS]) <= pool:
        raise AssertionError(f"robustness: a pool of {pool} blocks admits {ROBUST_ROWS} rows at the worst case too")
    return pool, worst, expect


def _serve_robust(eng, cfg, name: str, cancels=(), deadlines=None) -> dict:
    """``serve_continuous`` of the continuous traffic, with ``deadlines``
    (uid -> decode steps, the engine's clock reading its decode steps) and
    ``cancels`` ((uid, after so many steps)); every completion, each
    preempted request's stash lengths, the replays' recomputed tokens, the
    launch counts of the run (set to 0 just before it), and the pool's
    conservation: every allocator ends with all blocks free and no
    reservation, once its prefix cache (if any) lets its entries go."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request

    stash, allocators, recomputed, steps = {}, [], [0], [0]
    preempt, begin, admit_one, step = eng._preempt, eng._begin_live_batch, eng._admit_one, eng.step

    def spy_preempt(j):
        r = eng._live.slots[j].req
        preempt(j)
        stash.setdefault(r.uid, []).append(len(r.stashed))

    def spy_begin():
        begin()
        allocators.append((eng._live.allocator, eng._live.prefix))

    def spy_admit(i, r):
        admit_one(i, r)
        if r.preemptions:
            recomputed[0] += sum(len(c) for c in eng._live.slots[i].pending)

    def spy_step(*a):
        steps[0] += 1
        for uid, after in cancels:
            if steps[0] == after and not eng.cancel(uid):
                raise AssertionError(f"{name}: uid {uid} was not there to cancel after {after} steps")
        return step(*a)

    eng._preempt, eng._begin_live_batch, eng._admit_one, eng.step = spy_preempt, spy_begin, spy_admit, spy_step
    eng.clock = lambda: float(eng.stats.decode_steps)
    reqs = cont_requests(cfg)
    for uid, (p, g) in enumerate(reqs):
        d = (deadlines or {}).get(uid)
        eng.submit(Request(prompt=p, max_new_tokens=g, deadline_ms=None if d is None else d * 1e3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    comps = eng.serve_continuous()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dispatch, st = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS), eng.stats
    shapes, variants = launch_shapes(), check_variants(name, launches)
    if [c.uid for c in comps] != list(range(len(reqs))):
        raise AssertionError(f"{name}: the completions are not every request once: {[c.uid for c in comps]}")
    for c, (_, g) in zip(comps, reqs):
        if c.status == "ok" and len(c.tokens) != g or c.status != "ok" and len(c.tokens) >= g:
            raise AssertionError(f"{name}: uid {c.uid} {c.status} with {len(c.tokens)} of {g} tokens")
        if any(not 0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"{name}: a token outside the vocabulary")
    if ref_ops(dispatch):
        raise AssertionError(f"{name}: ref ops ran on the main path: {ref_ops(dispatch)}")
    no_fallback(name, dataclasses.asdict(st))
    for a, prefix in allocators:
        if prefix is not None:
            prefix.evict(a.num_blocks)
        if a.num_reserved or a.num_free != a.num_blocks - 1 or any(a.refcount(b) for b in range(1, a.num_blocks)):
            raise AssertionError(f"{name}: the pool leaks: {a.describe()}")
    if eng._live is not None or not allocators:
        raise AssertionError(f"{name}: the live batch did not drain")
    tokens = sum(len(c.tokens) for c in comps)
    robust = ("preemptions", "preempted_tokens", "prefix_evictions_on_pressure", "cancelled", "deadline_expired")
    return {
        "model": cfg.name, "layers": cfg.num_layers, "capacity_factor": cfg.capacity_factor,
        "kv_pool_blocks": eng.kv_pool_blocks, "kv_overcommit": eng.kv_overcommit, "prefix_cache": eng.prefix_caching,
        **{k: getattr(st, k) for k in robust}, "recomputed_tokens": recomputed[0],
        "stash": {str(u): n for u, n in stash.items()}, "tokens_generated": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": st.decode_steps, "prefill_chunks": st.prefill_chunks,
        "decode_step_ms_mean": st.decode_step_ms_sum / max(st.decode_steps, 1),
        "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches, "variants": variants,
        "dispatch": dispatch, "shapes": shapes, "tokens": [c.tokens for c in comps],
        "done": [[c.uid, c.status, c.preemptions] for c in comps], "card": card_line(),
    }


@contextlib.contextmanager
def _quiet():
    """Keep the injected failures' logged tracebacks off stderr (the
    counters and the gates report them)."""
    import logging

    names = ("repro_torch.serving", "repro_torch.session")
    levels = [logging.getLogger(n).level for n in names]
    for n in names:
        logging.getLogger(n).setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        for n, lv in zip(names, levels):
            logging.getLogger(n).setLevel(lv)


def _replay_gate(cfg, params, name: str, run: dict, base: dict) -> dict:
    """A run that preempted, against the worst-case pool's run ``base``: a
    request never preempted gives exactly its tokens; a preempted one's
    tokens up to its first preemption too (the stash), and where its
    resumed tokens first differ (the replay re-prefilled the stash as a
    chunk, which rounds otherwise than the decode steps that wrote it), the
    two tokens near-tie in a teacher-forced prefill of the prompt and the
    base run's tokens: a gap under ``NEAR_TIE`` of the row's max |logit|.
    A stash at the wrong positions or RoPE offset differs at once, and by
    far more."""
    reqs = cont_requests(cfg)
    ties = []
    for uid, (got, want) in enumerate(zip(run["tokens"], base["tokens"])):
        first = run["stash"].get(str(uid), [None])[0]
        if first is None or got == want:
            if got != want:
                raise AssertionError(f"{name}: uid {uid}, never preempted, differs from the worst-case run")
            continue
        p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        if p < first:
            raise AssertionError(f"{name}: uid {uid}'s stash ({first} tokens) differs from the worst-case run at {p}")
        gap = _logit_gap(cfg, params, reqs[uid][0], want, got)["gap"]
        ties.append({"uid": uid, "position": p, "stash": run["stash"][str(uid)], "gap": gap})
        if gap >= NEAR_TIE:
            raise AssertionError(f"{name}: uid {uid} diverges at token {p} with a logit gap of {gap:.4f} of the "
                                 "row's max: not a near-tie")
    return {"near_tie_checks": len(ties), "near_ties": ties}


def phase_robustness(cfg, params, shapes) -> dict:
    """The §4f robustness layer at full width (the caller's depth) on the continuous
    traffic at capacity factor E / k: worst-case admission against
    ``kv_overcommit=0.25`` at the same pool (cache off, eager and captured;
    cache on at a smaller pool, where growth evicts prefix entries and
    preempts), one injected ``kv_alloc`` failure, deadlines and cancels
    (eager and captured), then the resident session's degraded modes (a
    failed and a stalled restore, failed prefetch rows) and the ILP
    session's static fallback, each against the same session's run with no
    fault. Records every run's launches by shape in ``shapes``; returns the
    overcommitted captured run (the phase's main path) with ``launches`` of
    each kernel on its path."""
    from repro_torch.core import HAPSession, latency
    from repro_torch.kernels import ops
    from repro_torch.core.hardware import get_chip
    from repro_torch.serving import FaultInjector, InferenceEngine, Request

    cfg = dataclasses.replace(cfg, capacity_factor=REPL_CAPACITY)
    pool, worst, expect = robust_pool(cfg)

    def record(run, res):
        for kernel, by_shape in res["shapes"].items():
            for key, n in by_shape.items():
                shapes.setdefault(kernel, {}).setdefault(key, {})[run] = n

    def make(capture, blocks=pool, **kw):
        return InferenceEngine(cfg, params, max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK, kv_blocks=blocks,
                               capture_steps=capture, **kw)

    def show(run, res, **extra):
        emit({"phase": "robustness", "run": run, **{k: v for k, v in res.items() if k not in UNPRINTED}, **extra})

    # the worst case, then kv_overcommit at the same pool (the counting
    # injector only counts the allocations, for the injected run below)
    base = _serve_robust(make(True), cfg, "robustness (worst case)")
    record("worst case", base)
    show("worst case", base, pool_blocks=pool, worst_blocks=worst[:3], expected_blocks=expect[:3])
    if base["preemptions"]:
        raise AssertionError("robustness: the worst-case pool preempted")
    counted = []

    def make_oc(capture):
        counted.append(FaultInjector())
        return make(capture, kv_overcommit=ROBUST_OVERCOMMIT, faults=counted[-1])

    oc = ab_runs("robustness", "overcommit", make_oc, lambda eng: _serve_robust(eng, cfg, "robustness (overcommit)"),
                 same=ROBUST_SAME)
    record("overcommit, captured", oc)
    if oc["preemptions"] < 2:
        raise AssertionError(f"robustness: the overcommitted pool preempted {oc['preemptions']} times, not >= 2")
    for k in ("paged_attention", "grouped_matmul"):
        if not oc["launches"].get(k):
            raise AssertionError(f"robustness (overcommit): {k} was not launched")
    calls = {f.calls.get("kv_alloc") for f in counted}
    if len(calls) != 1:
        raise AssertionError(f"robustness: the overcommitted runs allocated different block counts: {calls}")
    oc["replays"] = _replay_gate(cfg, params, "robustness (overcommit)", oc, base)
    emit({"phase": "robustness", "run": "overcommit against the worst case", "replays": oc["replays"],
          "tokens_per_s": {"overcommit": oc["tokens_per_s"], "worst case": base["tokens_per_s"]},
          "decode_step_ms_mean": {"overcommit": oc["decode_step_ms_mean"], "worst case": base["decode_step_ms_mean"]},
          "wall_s": {"overcommit": oc["wall_s"], "worst case": base["wall_s"]}, "card": card_line()})

    # the prefix cache on, at a pool where growth evicts cache-only entries
    pc = _serve_robust(make(True, ROBUST_CACHE_BLOCKS, kv_overcommit=ROBUST_OVERCOMMIT, prefix_cache=True), cfg,
                       "robustness (overcommit, prefix cache)")
    record("overcommit prefix cache", pc)
    if pc["prefix_evictions_on_pressure"] < 1 or pc["preemptions"] < 1 or not pc["launches"].get(
            "prefix_paged_attention"):
        raise AssertionError(f"robustness (prefix cache): no eviction under pressure, or no preemption: {pc['done']}")
    pc["replays"] = _replay_gate(cfg, params, "robustness (overcommit, prefix cache)", pc, base)
    show("overcommit prefix cache", pc, replays=pc["replays"])

    # one injected allocation failure, at the last allocation of the counted run
    fi = FaultInjector().fail("kv_alloc", at=calls.pop() - 1)
    inj = _serve_robust(make(True, kv_overcommit=ROBUST_OVERCOMMIT, faults=fi), cfg, "robustness (kv_alloc fault)")
    record("kv_alloc fault", inj)
    if fi.fired_at("kv_alloc") != 1 or inj["preemptions"] != oc["preemptions"] + 1:
        raise AssertionError(f"robustness: the kv_alloc fault fired {fi.fired_at('kv_alloc')} times and the run "
                             f"preempted {inj['preemptions']} times against {oc['preemptions']}")
    inj["replays"] = _replay_gate(cfg, params, "robustness (kv_alloc fault)", inj, base)
    show("kv_alloc fault", inj, fired=fi.fired, replays=inj["replays"])

    # deadlines and cancels on the worst-case pool: every token exact
    def serve_life(eng):
        res = _serve_robust(eng, cfg, "robustness (lifecycle)", ROBUST_CANCELS, ROBUST_DEADLINES)
        for (uid, status, _), got, want in zip(res["done"], res["tokens"], base["tokens"]):
            if got != want[:len(got)]:
                raise AssertionError(f"robustness (lifecycle): uid {uid} ({status}) is not the worst-case run's prefix")
        return res

    life = ab_runs("robustness", "lifecycle", make, serve_life, same=ROBUST_SAME)
    status = {uid: (st, len(toks)) for (uid, st, _), toks in zip(life["done"], life["tokens"])}
    want = {15: ("deadline", 0), 14: ("cancelled", 0)}
    if ({u: status[u] for u in want} != want or status[1][0] != "deadline" or status[0][0] != "cancelled"
            or not status[1][1] or not status[0][1] or (life["cancelled"], life["deadline_expired"]) != (2, 2)):
        raise AssertionError(f"robustness (lifecycle): {status}")
    record("lifecycle, captured", life)

    # the resident session's degraded modes, each against its run with no fault
    batch = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts(cfg)[:MAX_BATCH]]

    def resident(prefetch=False, faults=None):
        return _session(cfg).engine(params, max_batch=MAX_BATCH, resident_int4=True, use_int4_transition=True,
                                    prefetch=prefetch, prefetch_top_p=PREFETCH_TOP_P, faults=faults)

    def serve_batch(eng, name, clean=False, fi=None):
        """The first batch through ``run()``; the counters' changes in that
        run, which must all be 0 where ``clean`` (nothing injected). With
        ``fi`` the engine is closed first (its worker's queued pulls drained)
        and ``fired`` is that injector's count."""
        before = dataclasses.asdict(eng.stats)
        for r in batch:
            eng.submit(dataclasses.replace(r))
        ops.reset_counts()
        comps = eng.run()
        launches = dict(ops.LAUNCH_COUNTS)
        check_variants(f"robustness ({name})", launches)
        if fi is not None:
            eng.close()
        st = dataclasses.asdict(eng.stats)
        keys = FALLBACK_COUNTERS + ("async_restores", "restore_overlap_ms", "restore_wait_ms", "prefetch_hits")
        res = {"run": name, "tokens": [c.tokens for c in comps], "launches": launches,
               **{k: st[k] - before[k] for k in keys}, "card": card_line()}
        if fi is not None:
            res["fired"] = dict(fi.fired)
        if clean:
            no_fallback(f"robustness ({name})", res)
        show(name, res)
        return res

    fi = FaultInjector()
    eng = resident(faults=fi)
    degraded = [serve_batch(eng, "resident, no fault", clean=True)]
    ref = degraded[0]
    if not ref["launches"].get("int4_dequant") or ref["async_restores"] != 1:
        raise AssertionError(f"robustness (resident): {ref}")
    # a failed restore: the first async one (the three sync restores of
    # the prefill layout come first on a reused plan)
    fi.fail("restore", at=fi.calls["restore"] + 3)
    with _quiet():
        degraded.append(serve_batch(eng, "resident, restore fails"))
    # a stalled restore past a small watchdog
    kick_s = ref["restore_overlap_ms"] / 1e3
    stall_s = STALL_MARGIN * (kick_s + STALL_TIMEOUT_S)
    ended, gave_up = [], []
    fire, join = fi.fire, eng._join_async_restore
    stall_at = fi.calls["restore"] + 3

    def timed_fire(site):
        idx = fi.calls.get(site, 0)
        fire(site)
        if site == "restore" and idx == stall_at:
            ended.append(time.perf_counter())

    def timed_join(phase):
        res = join(phase)
        gave_up.append(time.perf_counter())
        return res

    fi.fire, eng._join_async_restore, eng.restore_timeout_s = timed_fire, timed_join, STALL_TIMEOUT_S
    fi.delay("restore", stall_s, at=stall_at)
    t_run = time.perf_counter()
    with _quiet():
        degraded.append(serve_batch(eng, "resident, restore stalls"))
    run_s = time.perf_counter() - t_run
    eng.close()  # drains the stalled worker
    del eng
    _free()
    stall_end = ended[0]
    stall = dict(stall_s=stall_s, kick_to_barrier_s=kick_s, barrier_before_stall_end_s=stall_end - gave_up[0],
                 watchdog_s=STALL_TIMEOUT_S, run_s=run_s)
    degraded[-1].update(stall)
    emit({"phase": "robustness", "run": "resident, restore stalls: the watchdog", **stall})
    if gave_up[0] >= stall_end:
        raise AssertionError(f"robustness: the barrier gave up after the stall ended: {degraded[-1]}")
    # failed prefetch rows, seeded
    fi_pf = FaultInjector(seed=SEED).fail("prefetch", p=0.5)
    eng = resident(prefetch=True, faults=fi_pf)
    with _quiet():
        degraded.append(serve_batch(eng, "resident prefetch, rows fail", fi=fi_pf))
    del eng
    _free()
    for res, want in zip(degraded[1:], ({"restore_errors": 1}, {"restore_errors": 1},
                                        {"prefetch_errors": degraded[3]["fired"].get("prefetch", 0)})):
        if res["tokens"] != ref["tokens"]:
            raise AssertionError(f"robustness ({res['run']}): the tokens differ from the run with no fault")
        got = {k: res[k] for k in want}
        if got != want or not max(want.values()) or res["background_errors"] != max(want.values()):
            raise AssertionError(f"robustness ({res['run']}): counters {res}, expected {want}")
    # the ILP session's static fallback (one card: the TP plan computes the same function)
    model = latency.LatencyModel(get_chip("h100"), n_samples=12)  # one card: every source gives the one plan
    for faults in (None, FaultInjector().fail("ilp", times=1)):
        sess = HAPSession(cfg, "h100", 1, source="ilp", model=model, prompt_bucket=64)
        eng = sess.engine(params, max_batch=MAX_BATCH, faults=faults)
        with _quiet():
            degraded.append(serve_batch(eng, "ilp " + ("fails" if faults else "no fault"), clean=faults is None))
        degraded[-1]["plan"] = eng.hap_plan.describe()
        eng.close()
        del eng
    if degraded[-1]["tokens"] != degraded[-2]["tokens"] or degraded[-1]["planner_fallbacks"] != 1:
        raise AssertionError(f"robustness (ilp): {degraded[-2:]}")
    # each kernel's launches in the run of this phase whose path holds it
    oc["launches_by_run"] = {"overcommit": oc["launches"], "overcommit prefix cache": pc["launches"],
                             "resident, no fault": ref["launches"]}
    return oc


def robustness_kernel_rows(cfg, rows, shapes) -> None:
    """The paged kernel and the grouped matmul against their plain versions
    at the shapes the robustness phase's runs sent them that no other row
    holds: a replay's tail chunk (the stash re-prefilled after its prompt's
    64-token chunks: B=1 and 1 < C < 64, at the first and the longest such
    C), and the grouped matmul at capacity C = T under capacity factor E / k
    where C is new; each with its launches in each run that sent it
    (``launches_robustness``: run -> launches)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 6)
    by_name = {r["name"]: r for r in rows}
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    model = f"{cfg.name} robustness"
    added = []
    tails = sorted(key for key in shapes.get("paged_attention", {}) if key[0] == 1 and 1 < key[1] < 64)
    for key in sorted({tails[0], tails[-1]}) if tails else ():
        B, C = key[:2]
        # the stash lands after the 256-token prompt: positions 256.. through the phase's table width
        row = pool_decode_row(rng, dev, model, B, C, attn_of(cfg), CONT_BLOCK, _cont_table_width(),
                              [CONT_SYSTEM + CONT_OWN], 0)
        row["launches_robustness"] = shapes["paged_attention"][key]
        by_name["paged_attention"]["also"].append(row)
        added.append(row)
    for key, per_run in sorted(shapes.get("grouped_matmul", {}).items()):
        E, C, K, N = key
        if C in (8, 16, 64, 512):
            continue  # the kernels and replication phases' rows
        row = gmm_case(randn, model, E, C, K, N, "wi" if K == cfg.d_model else "wo")
        row["launches_robustness"] = per_run
        by_name["grouped_matmul"]["also"].append(row)
        added.append(row)
        torch.cuda.empty_cache()
    emit({"phase": "robustness_kernels", "paged_tail_chunks": [list(k) for k in tails], "rows": added})


def attention_row(kernel: str, key, model: str, attn, rng, dev) -> dict:
    """A row of the paged or prefix kernel at a launch ``key`` (B, C, Hq,
    Hkv, hd) no row of the kernels phase holds: a decode step (C=1) or a
    chunk on scattered pages of the continuous phase's table width, rows
    at positions past the 192-token system prompt; the prefix kernel's
    rows share its 12 pages. ``attn`` = (softcap, scale) of ``model``."""
    B, C, Hq, Hkv, hd = key
    heads = (Hq, Hkv, hd, *attn)
    if kernel == "prefix_paged_attention":
        return prefix_case(rng, dev, model, heads, B)
    return pool_decode_row(rng, dev, model, B, C, heads, CONT_BLOCK, _cont_table_width(), [CONT_SYSTEM] * B, 0)


def path_kernel_rows(rows, runs) -> None:
    """Each launch of ``runs`` (field, run, model, ``launch_shapes()`` of
    that run) at the row of its kernel, model and shape (a row's ``key``):
    the row gets ``row[field][run]`` = launches. Where no flash or grouped
    matmul row holds that model and shape, a new one, held against its
    plain version, two calls bit-equal, with its bound and library time;
    where no paged or prefix row holds it, a new one (``attention_row``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    by_name = {r["name"]: r for r in rows}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    added = []
    for field, run, model, shapes in runs:
        for kernel, per_shape in sorted(shapes.items()):
            for key, n in sorted(per_shape.items()):
                row = next((r for r in [by_name[kernel]] + by_name[kernel]["also"]
                            if r.get("model") == model and tuple(r.get("key", ())) == key), None)
                if row is None:
                    if kernel == "flash_attention":
                        B, S, Hq, Hkv, hd, win, cap = key
                        row = flash_case(dev, randn, model, B, S, (Hq, Hkv, hd, cap, attn_of(get_config(model))[4]),
                                         win)
                    elif kernel == "grouped_matmul":
                        E, C, K, N = key
                        row = gmm_case(randn, model, E, C, K, N, "wi" if K == get_config(model).d_model else "wo")
                    elif kernel in ("paged_attention", "prefix_paged_attention"):
                        row = attention_row(kernel, key, model, attn_of(get_config(model))[3:], rng, dev)
                    else:
                        raise AssertionError(f"{run} ({model}): {kernel} launched at {key}, and no row holds it")
                    by_name[kernel]["also"].append(row)
                    added.append(row)
                    torch.cuda.empty_cache()
                row.setdefault(field, {})[run] = n
    emit({"phase": "path_kernels", "rows": added})


def phase_families() -> dict:
    """Each family of ``FAMILIES`` at full width on seeded random weights,
    freed before the next: ``run()`` eager and captured, the agree check,
    and its continuous runs; returns {name: {"static": launches of the
    first captured run(), "continuous": of the captured prefix-cache run}}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    out = {}
    for name, layers, caches, tol in FAMILIES:
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        _free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        torch.cuda.synchronize()
        emit({"phase": "families", "model": name, "step": "init", "seconds": time.perf_counter() - t0,
              "params": sum(t.numel() for t in _leaves(params)), "bytes": torch.cuda.memory_allocated(),
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "reduced": ({"num_layers": layers, "of": get_config(name).num_layers,
                           "why": "the script's time limit (Mixtral-8x7B's full depth does not fit one 80 GB "
                                  "card either)"} if layers else None)})
        serve = phase_serve(cfg, params, "families")
        agree = phase_agree(cfg, params, serve, "families_agree", tol)
        cont = phase_continuous(cfg, params, "families", caches) if caches else None
        out[name] = {"static": serve["launches"], "continuous": cont["launches"] if cont else {}}
        emit({"phase": "families", "model": name, "step": "summary", "num_layers": cfg.num_layers,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "static_decode_ms_per_step": serve["decode_ms_per_step"], "static_prefill_ms": serve["prefill_ms"],
              "static_tokens_per_s": serve["tokens_per_s"], "agree_max_rel_l2": max(agree["rel_l2_err_per_step"]),
              "agree_max_rel_l2_same_experts": max(agree.get("rel_l2_err_per_step_same_experts", [None])),
              "continuous_wall_s": cont["wall_s"] if cont else None,
              "continuous_decode_step_ms_mean": cont["decode_step_ms_mean"] if cont else None,
              "launches": out[name]})
        del params
    _free()
    return out


# ssm phase: the families with mamba layers, at full width and SSM_LAYERS'
# depth, on seeded random weights in bf16. Each bf16 check is held to the rounding
# noise measured in the same run at the same depth, which grows with depth
# (``tools/mamba_rounding.py`` reads it layer count by layer count): the
# same path at another batch size (each row alone, B=1, against the batch
# of 4) rounds otherwise and nothing else differs, and a wrong scan, state
# hand-off or kernel gives unrelated logits (rel L2 near 1.4). Beside each,
# a float32 gate on the same weights cast up, where rounding is ~1e-5.
# - Prefill against decode: a prefill of the first batch's prompts and 4
#   greedy tokens against the 4th of the decode steps that took them; bf16
#   within twice the batch noise of that prefill, float32 within 1e-3.
# - Hymba's agree check (hopper against ref, teacher-forced on the hopper
#   path's greedy tokens), where only the attention kernels differ (the
#   mamba heads and the dense FFN are the same plain PyTorch on both
#   backends): bf16 within twice the ref path's batch noise on the same
#   forced tokens (per step, rel L2 and max rel), float32 within 1e-3.
SSM_FAMILIES = ("falcon-mamba-7b", "hymba-1.5b")
# layers kept: Falcon-Mamba's plain scan is most of its prefill, and the
# later phases needed the time (16 of 64 layers); Hymba 16 of 32 (its first
# global, 14 windowed and its middle global layer) since the dry run's gate
# joined sharded_data (the script's time limit)
SSM_LAYERS = {"falcon-mamba-7b": 16, "hymba-1.5b": 16}
SSM_PVD_STEPS = 4
SSM_F32_TOL = 1e-3  # rel L2, float32: prefill against decode, and Hymba's hopper against ref
SSM_NOISE_FACTOR = 2  # bf16: a reading within this many times the same run's batch noise


def _prefill_vs_decode(cfg, params, tokens) -> dict:
    """``tokens`` prefilled, then ``SSM_PVD_STEPS`` greedy decode steps,
    against one prefill of ``tokens`` and those steps' tokens; and, for the
    same path's rounding noise, that prefill of each row alone."""
    import torch

    from repro_torch.models import decode_step, prefill

    S, n = tokens.shape[1], SSM_PVD_STEPS
    logits, cache = prefill(params, cfg, {"tokens": tokens}, S + n + 1)
    fed = []
    for _ in range(n):
        fed.append(logits.argmax(-1))
        logits, cache = decode_step(params, cfg, fed[-1][:, None], cache)
    del cache
    full = torch.cat([tokens, torch.stack(fed, 1)], 1)
    whole, _ = prefill(params, cfg, {"tokens": full}, S + n + 1)
    alone = torch.cat([prefill(params, cfg, {"tokens": full[i:i + 1]}, S + n + 1)[0] for i in range(len(full))])
    if not all(torch.isfinite(t).all() for t in (logits, whole, alone)):
        raise AssertionError(f"ssm ({cfg.name}, {cfg.dtype}): non-finite logits")
    return {"rel_l2_err": _rel_l2(logits, whole), "batch_noise_rel_l2": _rel_l2(alone, whole),
            "max_rel_err": ((logits.float() - whole.float()).abs().max() / whole.float().abs().max()).item(),
            "argmax_agreement": (logits.argmax(-1) == whole.argmax(-1)).float().mean().item()}


def prefill_vs_decode(cfg, params) -> dict:
    """``_prefill_vs_decode`` on the serve traffic's first batch
    (left-padded to 128), in bf16 (within ``SSM_NOISE_FACTOR`` times its
    batch noise) and in float32 on the same weights cast up (within
    ``SSM_F32_TOL``)."""
    import torch

    tokens = _first_batch(cfg)
    with torch.inference_mode():
        bf16 = _prefill_vs_decode(cfg, params, tokens)
        res = {"prompt_len": tokens.shape[1], "steps": SSM_PVD_STEPS,
               "bfloat16": dict(bf16, rel_l2_tol=SSM_NOISE_FACTOR * bf16["batch_noise_rel_l2"])}
        f32 = dataclasses.replace(cfg, dtype="float32")
        p32 = _cast(params, torch.float32)
        res["float32"] = dict(_prefill_vs_decode(f32, p32, tokens), rel_l2_tol=SSM_F32_TOL)
        del p32
    _free()
    if any(r["rel_l2_err"] > r["rel_l2_tol"] for r in (res["bfloat16"], res["float32"])):
        raise AssertionError(f"ssm ({cfg.name}): prefill and decode disagree beyond the bound: {res}")
    return res


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def agree_noise(cfg, params) -> tuple:
    """The bf16 agree check's bounds from this run's noise: the ref path
    teacher-forced on the hopper path's greedy tokens (as ``phase_agree``
    runs it), each row alone (B=1) against the batch. Returns ((rel L2,
    max rel) bounds, ``SSM_NOISE_FACTOR`` times the largest per-step
    reading of each; the reading)."""
    import torch

    tokens = _first_batch(cfg)
    hop = _forced_logits(cfg, params, tokens, "hopper")
    batch = _forced_logits(cfg, params, tokens, "ref", feed=hop)
    alone = [_forced_logits(cfg, params, tokens[i:i + 1], "ref", feed=[h[i:i + 1] for h in hop])
             for i in range(len(tokens))]
    noise = _errors([torch.cat(rows) for rows in zip(*alone)], batch)
    del hop, batch, alone
    _free()
    return (SSM_NOISE_FACTOR * max(noise["rel_l2_err_per_step"]),
            SSM_NOISE_FACTOR * max(noise["max_rel_err_per_step"])), noise


def agree_f32(cfg, params) -> dict:
    """Hymba's agree check in float32 on the weights cast up: the hopper
    path's first batch (prefill + 15 decode steps, greedy) and the ref path
    teacher-forced on its tokens, rel L2 per step, gated at
    ``SSM_F32_TOL``."""
    import torch

    f32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _cast(params, torch.float32)
    tokens = _first_batch(cfg)
    hop = _forced_logits(f32, p32, tokens, "hopper")
    ref = _forced_logits(f32, p32, tokens, "ref", feed=hop)
    del p32
    _free()
    res = {"rel_l2_err_per_step": [_rel_l2(h, r) for h, r in zip(hop, ref)], "rel_l2_tol": SSM_F32_TOL}
    if not all(torch.isfinite(h).all() for h in hop) or max(res["rel_l2_err_per_step"]) > SSM_F32_TOL:
        raise AssertionError(f"ssm_agree ({cfg.name}): float32 hopper and ref logits differ: {res}")
    return res


def mixer_times(cfg, params) -> dict:
    """The plain mamba mixer of layer 0 on the card at the static prefill's
    shape (B=4, S=128) and a contiguous admission's (B=1, S=256), the
    in-chunk scan alone at the first, and one decode step of the layer at
    B=8: device ms per call."""
    import torch

    from repro_torch.models import mamba
    from repro_torch.models.params import layer_slice

    mp = layer_slice(params["layers"], 0)["mamba"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    with torch.inference_mode():
        for B, S in ((MAX_BATCH, 128), (1, 256)):
            x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
            out[f"mixer_ms_B{B}_S{S}"] = cuda_ms(lambda: mamba.mamba_mixer(x, mp, cfg), 5)
        shape = (MAX_BATCH, 128, cfg.ssm_d_inner, cfg.ssm_state)
        a = torch.rand(shape, generator=gen, device="cuda")
        b = torch.randn(shape, generator=gen, device="cuda")
        h0 = torch.zeros((MAX_BATCH, cfg.ssm_d_inner, cfg.ssm_state), device="cuda")
        # each pass reads and writes both (B, cs, di, N) float32 operands in
        # place (the time does not depend on their values)
        out["scan_ms_B4_S128"] = cuda_ms(lambda: mamba._scan_chunk(a, b, h0), 5)
        out["scan_operand_bytes"] = 2 * a.numel() * 4
        out["scan_passes"] = math.ceil(math.log2(128))
        del a, b
        cache = mamba.init_cache(cfg, CONT_MAX_BATCH, torch.bfloat16, "cuda")
        x = torch.randn(CONT_MAX_BATCH, 1, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
        out["decode_step_ms_B8"] = cuda_ms(lambda: mamba.mamba_decode_step(x, mp, cfg, cache), 20)
    return out


def phase_ssm() -> dict:
    """Falcon-Mamba-7B and Hymba-1.5B at full width and ``SSM_LAYERS``' depth
    on seeded random weights, each freed before the next: ``run()`` eager and
    captured, then the continuous traffic through ``serve_continuous()``
    (the contiguous fallback, their default) eager and captured, Hymba's
    agree check, prefill against decode, and the plain mixer's times.
    Returns {name: {"static": launches by shape of the captured run(),
    "continuous": of the captured continuous run}} (``launch_shapes``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    out = {}
    for name in SSM_FAMILIES:
        cfg = get_config(name)
        if name in SSM_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=SSM_LAYERS[name])
        _free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        torch.cuda.synchronize()
        emit({"phase": "ssm", "model": name, "step": "init", "seconds": time.perf_counter() - t0,
              "params": sum(t.numel() for t in _leaves(params)), "bytes": torch.cuda.memory_allocated()})
        mark(f"{name} init")
        serve = phase_serve(cfg, params, "ssm")
        mark(f"{name} serve")
        agree, noise = None, None
        if cfg.has_attention:
            tol, noise = agree_noise(cfg, params)
            agree = phase_agree(cfg, params, serve, "ssm_agree", tol, same_tol=tol[0])
        agree32 = agree_f32(cfg, params) if cfg.has_attention else None
        mark(f"{name} agree")
        cont = serve_contiguous(cfg, params, "ssm", f"{name} contiguous")
        mark(f"{name} contiguous")
        pvd = prefill_vs_decode(cfg, params)
        mark(f"{name} prefill_vs_decode")
        times = mixer_times(cfg, params)
        mark(f"{name} mixer_times")
        out[name] = {"static": serve["shapes"], "continuous": cont["shapes"]}
        launches = {"static": serve["launches"], "continuous": cont["launches"]}
        emit({"phase": "ssm", "model": name, "step": "summary", "num_layers": cfg.num_layers,
              "kernels": launches if cfg.has_attention else "none: a pure mamba model runs no TPU kernel's port "
                                                              "(its mixer is plain PyTorch, as the reference's is "
                                                              "plain JAX)",
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "static_decode_ms_per_step": serve["decode_ms_per_step"], "static_prefill_ms": serve["prefill_ms"],
              "static_tokens_per_s": serve["tokens_per_s"], "continuous_wall_s": cont["wall_s"],
              "continuous_tokens_per_s": cont["tokens_per_s"], "continuous_decode_step_ms_mean":
                  cont["decode_step_ms_mean"], "continuous_prefill_ms_mean": sum(cont["prefill_ms"]) / CONT_REQUESTS,
              "continuous_max_memory_allocated": cont["max_memory_allocated"],
              "prefill_vs_decode": pvd, "mixer": times,
              "agree_max_rel_l2": max(agree["rel_l2_err_per_step"]) if agree else None,
              "agree_max_rel": max(agree["max_rel_err_per_step"]) if agree else None,
              "agree_tol": [agree["rel_l2_tol"], agree["max_rel_tol"]] if agree else None,
              "agree_batch_noise": noise, "agree_f32": agree32})
        del params
    _free()
    return out


# vlm phase: LLaVA-NeXT-Mistral-7B at full width and depth (32 layers, bf16,
# seeded random weights and inputs) through the model's own entry points,
# prefill + decode_step (the engine serves token prompts only, as the
# reference's does): a batch of two image prompts, each 2,880 patch
# embeddings of dim 1,024 ahead of 64 text tokens (S=2944), then one prompt
# of 37 text tokens (S=2917: the flash kernel's last query tile partial),
# each followed by 16 greedy tokens. The launches of those two runs are
# exact. Gates:
# - bf16, hopper against ref: the ref path teacher-forced on the hopper
#   path's tokens; the rel L2 of the prefill logits and of every decode
#   step's within VLM_NOISE_FACTOR times the ref path's own batch noise in
#   this run (each row of the batch alone, B=1, against the batch; its
#   largest step), the bound the B=1 prompt is held to as well. A wrong
#   kernel gives unrelated logits (rel L2 near 1.4).
# - float32 at the first VLM_F32_LAYERS layers (the weights cast up): hopper
#   against ref per step, and the hopper path's decode logits against one
#   forward_hidden + unembed over the prompt and the tokens it took (the
#   reference's prefill/decode consistency test), rel L2 within VLM_F32_TOL.
VLM_MODEL = "llava-next-mistral-7b"
VLM_PROMPTS = ((2, 64), (1, 37))  # (rows, text tokens) after each row's 2,880 patches
VLM_NEW = 16
VLM_NOISE_FACTOR = 2
VLM_F32_LAYERS = 4
VLM_F32_TOL = 1e-3  # rel L2


def vlm_batch(cfg, rows: int, n_text: int, seed: int) -> dict:
    """An image prompt: standard normal patch embeddings (bf16) and text ids."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    patches = torch.randn(rows, cfg.num_patches, cfg.frontend_dim, generator=gen, device="cuda")
    return {"patches": patches.to(torch.bfloat16),
            "tokens": torch.randint(1, cfg.vocab_size, (rows, n_text), generator=gen, device="cuda")}


def vlm_max_len(cfg, batch) -> int:
    return cfg.num_patches + batch["tokens"].shape[1] + VLM_NEW


def _vlm_logits(cfg, params, batch, backend, feed=None) -> tuple:
    """Prefill of ``batch`` and VLM_NEW - 1 decode steps on ``backend``,
    each step fed the argmax of ``feed``'s logits at that step (its own
    with None): (every step's float32 logits, on the card; prefill ms and
    mean decode ms per step, the device waited for at both ends)."""
    import torch

    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, batch, vlm_max_len(cfg, batch), backend=backend)
        out = [logits.float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for step in range(VLM_NEW - 1):
            logits, cache = decode_step(params, cfg, (feed or out)[step].argmax(-1)[:, None], cache, backend=backend)
            out.append(logits.float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    del cache
    return out, {"prefill_ms": (t1 - t0) * 1e3, "decode_ms_per_step": (t2 - t1) * 1e3 / (VLM_NEW - 1)}


def _per_step(got, want) -> dict:
    return {"rel_l2_err_per_step": [_rel_l2(g, w) for g, w in zip(got, want)],
            "max_rel_err_per_step": [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)],
            "argmax_agreement": sum(int((g.argmax(-1) == w.argmax(-1)).sum()) for g, w in zip(got, want))
            / sum(len(w) for w in want)}


def vlm_bf16_gate(cfg, params, batch, hop, bound=None) -> dict:
    """The ref path teacher-forced on the hopper path's tokens against the
    hopper path's logits ``hop``; with ``bound`` None, the bound is
    VLM_NOISE_FACTOR times the ref path's batch noise (each row alone
    against the batch, its largest step)."""
    import torch

    ref, _ = _vlm_logits(cfg, params, batch, "ref", feed=hop)
    res = {"hopper_vs_ref": _per_step(hop, ref)}
    if bound is None:
        rows = len(batch["tokens"])
        alone = [_vlm_logits(cfg, params, {k: v[i:i + 1] for k, v in batch.items()}, "ref",
                             feed=[h[i:i + 1] for h in hop])[0] for i in range(rows)]
        res["ref_batch_noise"] = _per_step([torch.cat(r) for r in zip(*alone)], ref)
        bound = VLM_NOISE_FACTOR * max(res["ref_batch_noise"]["rel_l2_err_per_step"])
        del alone
    del ref
    res["rel_l2_tol"] = bound
    if not max(res["hopper_vs_ref"]["rel_l2_err_per_step"]) <= bound:
        raise AssertionError(f"vlm ({cfg.name}): bf16 hopper and ref logits differ beyond the noise bound: {res}")
    return res


def vlm_f32_gate(cfg, params, batch) -> dict:
    """The first VLM_F32_LAYERS layers in float32: hopper against ref, and
    the hopper path's logits against one forward over the prompt and the
    tokens it took."""
    import torch

    from repro_torch.models import embed_inputs, forward_hidden, unembed

    f32 = dataclasses.replace(cfg, dtype="float32", num_layers=VLM_F32_LAYERS)
    p32 = _cast(_first_layers_of(params, VLM_F32_LAYERS), torch.float32)
    hop, _ = _vlm_logits(f32, p32, batch, "hopper")
    ref, _ = _vlm_logits(f32, p32, batch, "ref", feed=hop)
    taken = torch.cat([batch["tokens"]] + [h.argmax(-1)[:, None] for h in hop[:-1]], dim=1)
    with torch.inference_mode():
        x = embed_inputs(p32, f32, dict(batch, tokens=taken))
        h, _, _ = forward_hidden(p32, f32, x)
        whole = unembed(p32, f32, h[:, -VLM_NEW:]).float()
    res = {"layers": VLM_F32_LAYERS, "hopper_vs_ref": _per_step(hop, ref),
           "decode_vs_forward": _per_step(hop, [whole[:, i] for i in range(VLM_NEW)]), "rel_l2_tol": VLM_F32_TOL}
    del p32, hop, ref, whole, h, x
    _free()
    if not all(torch.isfinite(torch.tensor(r["rel_l2_err_per_step"])).all() and
               max(r["rel_l2_err_per_step"]) <= VLM_F32_TOL for r in (res["hopper_vs_ref"], res["decode_vs_forward"])):
        raise AssertionError(f"vlm ({cfg.name}): float32 logits differ: {res}")
    return res


def _first_layers_of(params, n: int):
    """``params`` with only the first ``n`` layers (views)."""
    return dict(params, layers=_first_layers(params["layers"], n))


def phase_vlm() -> dict:
    """LLaVA-NeXT-Mistral-7B at full width and depth: the two prompts on the
    hopper backend (the main path, launches exact), then the bf16 and
    float32 gates. Returns {"launches", "shapes"} of the main path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = get_config(VLM_MODEL)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "vlm", "model": VLM_MODEL, "step": "init", "seconds": time.perf_counter() - t0,
          "params": sum(t.numel() for t in _leaves(params)), "bytes": torch.cuda.memory_allocated()})
    batches = [vlm_batch(cfg, rows, n_text, SEED + i) for i, (rows, n_text) in enumerate(VLM_PROMPTS)]
    _vlm_logits(cfg, params, batches[1], "hopper")  # warm-up: the library handles, the kernels' first loads
    ops.reset_counts()
    runs = [_vlm_logits(cfg, params, b, "hopper") for b in batches]
    launches, dispatch, shapes = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS), launch_shapes()
    variants = check_variants("vlm", launches)
    L = cfg.num_layers
    expect = {"flash_attention": L * len(batches), "paged_attention": L * (VLM_NEW - 1) * len(batches)}
    if launches != expect or ref_ops(dispatch):
        raise AssertionError(f"vlm: launches {launches} (expected {expect}), dispatch {dispatch}")
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.isfinite(t).all() for hop, _ in runs for t in hop):
        raise AssertionError("vlm: non-finite logits")
    bf16 = [vlm_bf16_gate(cfg, params, batches[0], runs[0][0])]
    bf16.append(vlm_bf16_gate(cfg, params, batches[1], runs[1][0], bound=bf16[0]["rel_l2_tol"]))
    f32 = [vlm_f32_gate(cfg, params, b) for b in batches]
    for (rows, n_text), (hop, times), b16, b32 in zip(VLM_PROMPTS, runs, bf16, f32):
        emit({"phase": "vlm", "model": VLM_MODEL, "step": "prompt", "rows": rows, "text_tokens": n_text,
              "seq": cfg.num_patches + n_text, "max_len": cfg.num_patches + n_text + VLM_NEW, **times,
              "bfloat16": b16, "float32": b32})
    emit({"phase": "vlm", "model": VLM_MODEL, "step": "summary", "num_layers": L, "max_memory_allocated": peak,
          "prefill_ms": [t["prefill_ms"] for _, t in runs], "decode_ms_per_step": [t["decode_ms_per_step"]
                                                                                  for _, t in runs],
          "launches": launches, "variants": variants, "dispatch": dispatch})
    del params, runs, batches
    _free()
    return {"launches": launches, "shapes": shapes}


# train phase: training through the port's entry points on the card. The
# loss pins the kernel seam to its plain PyTorch path (the hand kernels
# define no backward, as the reference's Pallas kernels define none): a
# train step launches no hand kernel, and the phase counts its ref
# dispatches. TRAIN_RUNS, each TRAIN_STEPS steps on the data pipeline's
# batches with the launcher's schedule (warm-up 100 steps, so the rate is
# 3e-6 .. 1.5e-5 and only the small bf16 weights move):
# - HuBERT-XLarge at full width and depth (48 layers, bf16, remat on):
#   ``python -m repro_torch.launch.train --arch hubert-xlarge --full
#   --batch 4 --seq 512`` (``launch.train.main``) on audio frame batches;
# - DeepSeekMoE-16B at full width, its first 4 of 28 layers (2.56 B
#   parameters, ~31 GB with the float32 moments; all 28 layers' ~200 GB do
#   not fit the card): ``train_loop`` on the Markov data, B=4, S=256, the
#   router's aux loss in the objective.
# Each prints ms per step (the steps after the first), tokens or frames per
# second, peak memory, loss and grad norm; gated finite, parameters
# changed, no hand-kernel launch. Then float32 parity with the port on the
# CPU from one set of weights and one batch: HuBERT at full width, 2 layers,
# one whole train step (loss and grad norm at rel 1e-5, updated parameters
# at rel L2 1e-5: a wrong update moves them ~2e-4); DeepSeek at full width,
# 1 layer, B=1 S=64: loss and aux at rel 1e-5, the gradients of the router,
# the experts' wi_gate and wq at rel L2 1e-4 (gradients only, to keep the
# host near 10 GB).
TRAIN_STEPS = 5
TRAIN_RUNS = (("hubert-xlarge", None, 4, 512), ("deepseek-moe-16b", 4, 4, 256))  # (model, layers kept, B, S)
TRAIN_PARITY_TOL = 1e-5  # rel: loss, grad norm, aux; rel L2: updated parameters
TRAIN_GRAD_TOL = 1e-4  # rel L2: gradients


def _train_run(name, layers, B, S) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_data
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import train_loop
    from repro_torch.training.tree import tree_leaves

    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    _free()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    hist = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the loop's log lines; stdout carries JSON only
        if layers is None:
            state = launch_train.main(["--arch", name, "--full", "--steps", str(TRAIN_STEPS), "--batch", str(B),
                                       "--seq", str(S)], history=hist)
        else:
            state = train_loop(cfg, synthetic_lm_data(cfg, B, S), TRAIN_STEPS, log_every=1, seed=SEED,
                               device="cuda", history=hist)
    wall = time.perf_counter() - t0
    launches, dispatch = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    init = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")  # the loop's own draw
    changed = sum(int((a.detach() != b).sum()) for a, b in zip(tree_leaves(state.params), tree_leaves(init)))
    n = sum(t.numel() for t in tree_leaves(init))
    del init, state
    _free()
    step_s = sum(h["seconds"] for h in hist[1:]) / (len(hist) - 1)
    res = {"phase": "train", "model": name, "num_layers": cfg.num_layers, "of": get_config(name).num_layers,
           "dtype": cfg.dtype, "batch": B, "seq": S, "params": n, "steps": TRAIN_STEPS, "wall_s": wall,
           "first_step_ms": hist[0]["seconds"] * 1e3, "ms_per_step": step_s * 1e3,
           ("frames_per_s" if cfg.frontend == "audio" else "tokens_per_s"): B * S / step_s,
           "max_memory_allocated": peak,
           "loss": [h["loss"] for h in hist], "ce": [h["ce"] for h in hist], "aux": [h["aux"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist], "lr": [h["lr"] for h in hist],
           "params_changed": changed, "params_changed_share": changed / n, "launches": launches,
           "ref_dispatch": ref_ops(dispatch)}
    emit(res)
    finite = all(math.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm", "ce", "aux"))
    if not finite or not changed or sum(launches.values()) or set(dispatch) != set(ref_ops(dispatch)):
        raise AssertionError(f"train ({name}): finite {finite}, parameters changed {changed}, launches {launches}, "
                             f"dispatch {dispatch}")
    return res


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def train_parity() -> dict:
    """Float32 parity of the card's training with the port on the CPU (the
    weights drawn once on the host, copied to the card)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_data
    from repro_torch.models import init_params, loss_and_aux
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import TrainState, batch_to, make_train_step
    from repro_torch.training.tree import tree_leaves, tree_map

    out = {}
    cfg = dataclasses.replace(get_config("hubert-xlarge"), num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    batch = next(synthetic_lm_data(cfg, 2, 128, seed=SEED))
    step = make_train_step(cfg)  # the launcher's schedule: the first step's rate 3e-6
    got = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        got[dev] = step(TrainState(p, adamw_init(p)), batch)
    (gs, gm), (cs, cm) = got["cuda"], got["cpu"]
    new = [(a.detach().cpu(), b.detach()) for a, b in zip(tree_leaves(gs.params), tree_leaves(cs.params))]
    res = {"layers": 2, "batch": 2, "seq": 128, "loss_rel_err": _rel(gm["loss"], cm["loss"]),
           "grad_norm_rel_err": _rel(gm["grad_norm"], cm["grad_norm"]),
           "params_rel_l2_err": max(_rel_l2(a, b) for a, b in new),
           "update_rel_l2_err": max(_rel_l2(a - p, b - p) for (a, b), p in zip(new, tree_leaves(params))),
           "tol": TRAIN_PARITY_TOL}
    out["hubert-xlarge"] = res
    del got, gs, cs, new, params
    _free()
    if max(res["loss_rel_err"], res["grad_norm_rel_err"], res["params_rel_l2_err"]) > TRAIN_PARITY_TOL:
        raise AssertionError(f"train parity (hubert-xlarge): {res}")

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=1, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    batch = next(synthetic_lm_data(cfg, 1, 64, seed=SEED))
    picks = (("moe", "router"), ("moe", "wi_gate"), ("attn", "wq"))
    got = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev, copy=True), params) if dev == "cuda" else params
        leaves = [p["layers"][a][b].requires_grad_(True) for a, b in picks]
        loss, m = loss_and_aux(p, cfg, batch_to(batch, dev), remat=False)
        grads = torch.autograd.grad(loss, leaves)
        got[dev] = (float(loss.detach()), float(m["aux"].detach()), [g.cpu() for g in grads])
        del p, leaves, loss, m, grads
    (gl, ga, gg), (cl, ca, cg) = got["cuda"], got["cpu"]
    res = {"layers": 1, "batch": 1, "seq": 64, "loss_rel_err": _rel(gl, cl), "aux_rel_err": _rel(ga, ca),
           "grad_rel_l2_err": {f"{a}/{b}": _rel_l2(g, c) for (a, b), g, c in zip(picks, gg, cg)},
           "tol": TRAIN_PARITY_TOL, "grad_tol": TRAIN_GRAD_TOL}
    out["deepseek-moe-16b"] = res
    del got, gg, cg, params
    _free()
    if max(res["loss_rel_err"], res["aux_rel_err"]) > TRAIN_PARITY_TOL or \
            max(res["grad_rel_l2_err"].values()) > TRAIN_GRAD_TOL:
        raise AssertionError(f"train parity (deepseek-moe-16b): {res}")
    return out


def phase_train() -> dict:
    """TRAIN_RUNS on the card, then float32 parity with the CPU. Returns the
    hand-kernel launches of the runs (none)."""
    runs = [_train_run(*r) for r in TRAIN_RUNS]
    parity = train_parity()
    emit({"phase": "train", "step": "parity", **parity})
    launches = collections.Counter()
    for r in runs:
        launches.update(r["launches"])
    return {"launches": dict(launches), "runs": runs, "parity": parity}


# launcher phase: the port's serve launcher (``repro_torch.launch.serve``) in
# process, as a user starts the system, on the serve phase's DeepSeek weights
# (full width and depth, bf16): the default mixed trace through run(), then
# with --continuous --prefix-cache. HAP plans for four H100s on the latency
# model of the h100 entry; the plans execute on the one card. The model's fit
# (~1 min on one host core) runs in a background process from the start of
# the script, into a cache directory of its own, which the launcher reads
# (``REPRO_CACHE_DIR``).
LAUNCHER_ARGV = ("--full", "--chip", "h100", "--devices", "4", "--kernel-backend", "hopper")
LAUNCHER_RUNS = {"run": (), "continuous_prefix": ("--continuous", "--prefix-cache")}
LAUNCHER_CLI_TIMEOUT_S = 300
# the re-plan traffic of the sharded phase's live relayout (prompt length,
# new tokens) at a 64-token bucket and two slots: r1 retires early and r2 (a
# 128-token bucket) joins while r0 is live, so the attention moves TP2 ->
# DP2; r2 retires and r3 joins while r0 is live, DP2 -> TP2
REPLAN_TRAFFIC = ((50, 12), (60, 2), (100, 2), (40, 4))
REPLAN_MAX_BATCH = 2


def start_latency_fit():
    """Fit the h100 latency model in a background process into a new cache
    directory; returns (the process, the directory). Its seconds land in
    ``fit.json`` there."""
    import tempfile

    cache = tempfile.mkdtemp(prefix="latency_")
    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            "from repro_torch.core.latency import cached_latency_model\n"
            "cached_latency_model('h100', disk_dir=sys.argv[1])\n"
            "json.dump({'seconds': time.perf_counter() - t0}, open(sys.argv[1] + '/fit.json', 'w'))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code, cache], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cache


class ReplanSource:
    """TP2/EP2 while every live prompt fits one 64-token bucket, DP2/EP2
    once a longer one is live: the attention layout alone switches."""

    def plan_for(self, w):
        from repro_torch.core import fixed_plan

        return fixed_plan("TP2" if w.prompt <= 64 else "DP2", "EP2")


def replan_requests(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    return [(rng.integers(1, cfg.vocab_size, n).tolist(), g) for n, g in REPLAN_TRAFFIC]


def _launcher_expect(cfg, st, args) -> dict:
    """The exact launches of a launcher run: run() launches flash once a
    layer a batch, the paged kernel once a layer a decode step and the
    expert matmuls three times a layer a step; the paged prefix-cache run
    the paged kernel once a layer a chunk, the prefix kernel once a layer a
    decode step (fused ones included) and the expert matmuls three times a
    layer a chunk or decode step."""
    L = cfg.num_layers
    if not args.continuous:
        return {"flash_attention": st.batches * L, "paged_attention": st.batches * (args.gen - 1) * L,
                "grouped_matmul": st.batches * args.gen * 3 * L}
    return {"paged_attention": st.prefill_chunks * L, "prefix_paged_attention": st.decode_steps * L,
            "grouped_matmul": (st.prefill_chunks + st.decode_steps) * 3 * L}


def phase_launcher(cfg, params, fit) -> dict:
    """The serve launcher twice (``LAUNCHER_RUNS``), each against an engine
    built directly from the same session and flags on the same trace
    (tokens and launches equal); then ``python -m
    repro_torch.launch.serve`` at its reduced default on the card in a
    subprocess, reading the in-process run's latency cache. Returns
    {"shapes": launches by shape per run, "launches": per run}."""
    import io
    import logging

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher

    proc, cache = fit
    t0 = time.perf_counter()
    fit_out, _ = proc.communicate(timeout=600)
    if proc.returncode:
        raise AssertionError(f"launcher: the latency-model fit failed:\n{fit_out[-3000:]}")
    with open(os.path.join(cache, "fit.json")) as f:
        fit_s = json.load(f)["seconds"]
    emit({"phase": "launcher", "step": "latency_fit", "chip": "h100", "fit_s": fit_s,
          "waited_s": time.perf_counter() - t0, "background": True})
    root = logging.getLogger()
    saved = (root.level, list(root.handlers), os.environ.get("REPRO_CACHE_DIR"))
    os.environ["REPRO_CACHE_DIR"] = cache
    out = {"shapes": {}, "launches": {}}
    try:
        for name, extra in LAUNCHER_RUNS.items():
            argv = [*LAUNCHER_ARGV, *extra]
            args = launcher.parser().parse_args(argv)
            what = f"launcher ({name})"
            runs = []
            for direct in (False, True):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_counts()
                lines = io.StringIO()
                t0 = time.perf_counter()
                if direct:  # an engine built from the launcher's session and flags, on its trace
                    eng = launcher.build_engine(session, params, cfg, args, torch.device("cuda"))
                    for r in launcher.trace(args, cfg.vocab_size):
                        eng.submit(r)
                    done = eng.serve_continuous() if args.continuous else eng.run()
                else:
                    with contextlib.redirect_stdout(lines):
                        done, eng = launcher.main(argv, params=params)
                    session = eng.session
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = eng.stats
                launches, dispatch = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS)
                expect = _launcher_expect(cfg, st, args)
                if {k: launches.get(k, 0) for k in expect} != expect:
                    raise AssertionError(f"{what}: launches {launches}, expected {expect}")
                if ref_ops(dispatch):
                    raise AssertionError(f"{what}: ref ops ran on the path: {ref_ops(dispatch)}")
                no_fallback(what, dataclasses.asdict(st))
                tokens = [c.tokens for c in done]
                if len(tokens) != args.requests or any(len(t) != args.gen for t in tokens):
                    raise AssertionError(f"{what}: a request did not get its {args.gen} tokens")
                steps = st.decode_steps if args.continuous else st.batches * (args.gen - 1)
                decode_ms = st.decode_step_ms_sum if args.continuous else sum(c.decode_ms for c in done[::args.batch])
                runs.append({"direct": direct, "wall_s": wall, "tokens_per_s": sum(map(len, tokens)) / wall,
                             "decode_ms_per_step": decode_ms / steps, "launches": launches,
                             "variants": check_variants(what, launches), "dispatch": dispatch,
                             "shapes": launch_shapes(), "tokens": tokens, "steps": step_stats(eng),
                             "max_memory_allocated": torch.cuda.max_memory_allocated(),
                             "plan": eng.hap_plan.describe(), "replans": st.replans,
                             "plan_switches": st.plan_switches, "transition_ms_total": st.transition_ms_total,
                             "lines": lines.getvalue().splitlines()})
                eng.close()
                del eng, done
                _free()
            main, direct = runs
            if direct["tokens"] != main["tokens"] or direct["launches"] != main["launches"]:
                raise AssertionError(f"{what}: the launcher and the engine built from its session differ: "
                                     f"launches {main['launches']} against {direct['launches']}")
            emit({"phase": "launcher", "run": name, "argv": argv,
                  **{k: v for k, v in main.items() if k not in ("tokens", "shapes", "direct")},
                  "direct_engine": {k: direct[k] for k in ("wall_s", "tokens_per_s", "decode_ms_per_step")},
                  "tokens_equal_direct_engine": True, "launches_equal_direct_engine": True})
            out["shapes"][name] = main["shapes"]
            out["launches"][name] = main["launches"]
        # the command line on its own: reduced, float32, the model from the cache
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_CACHE_DIR=cache)
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--chip", "h100", "--device", "cuda"],
                             capture_output=True, text=True, env=env, cwd=ROOT, timeout=LAUNCHER_CLI_TIMEOUT_S)
        cli_s = time.perf_counter() - t0
        emit({"phase": "launcher", "run": "cli", "command": "python -m repro_torch.launch.serve --chip h100 "
              "--device cuda", "returncode": cli.returncode, "seconds": cli_s, "lines": cli.stdout.splitlines(),
              "read_the_cache": "planned" in cli.stderr and not os.path.exists(os.path.join(ROOT, ".cache",
                                                                                         "latency_torch_h100_0.pkl"))})
        if cli.returncode:
            raise AssertionError(f"launcher (cli): exit {cli.returncode}:\n{cli.stdout[-2000:]}\n{cli.stderr[-3000:]}")
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
        if saved[2] is None:
            os.environ.pop("REPRO_CACHE_DIR", None)
        else:
            os.environ["REPRO_CACHE_DIR"] = saved[2]
    return out


def replan_references(cfg, params) -> dict:
    """The re-plan traffic on one card, paged and contiguous, at the
    two-rank relayout runs' depth (``SHARDED_REF_LAYERS``): their reference
    tokens."""
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.serving import Request

    out = {}
    for paged in (True, False):
        eng = HAPSession(cfg, "h100", 1, source=fixed_plan("TP1", "TP1"), prompt_bucket=64).engine(
            params, max_batch=REPLAN_MAX_BATCH, paged=paged)
        for p, g in replan_requests(cfg):
            eng.submit(Request(prompt=p, max_new_tokens=g))
        out["paged" if paged else "contiguous"] = [c.tokens for c in eng.serve_continuous()]
        eng.close()
        del eng
        _free()
    return out


# sharded phase: DeepSeekMoE-16B on two ranks of a gloo group, both on the
# one card (NCCL refuses two ranks on one device), then one NCCL rank
SHARDED_RANK = "deepseek-moe-16b rank of 2"  # the model of a kernel row at a sharded per-rank shape


SHARDED_TIMEOUT_S = 600.0
SHARDED_PLANS = {  # name -> (attn, expert prefill, expert decode, mechanism, engine keywords)
    "tp2_tp2": ("TP2", "TP2", "", "reshard", {}),
    "tp2_ep2_serial": ("TP2", "EP2", "", "reshard", {"moe_pipeline": 1}),
    "tp2_ep2_k2": ("TP2", "EP2", "", "reshard", {"moe_pipeline": 2}),
    "switch_reshard": ("TP2", "EP2", "TP2", "reshard", {}),
    "switch_int4": ("TP2", "EP2", "TP2", "int4_upload", {"use_int4_transition": True}),
    "switch_int4_resident": ("TP2", "EP2", "TP2", "int4_upload", {"use_int4_transition": True, "resident_int4": True}),
    # attention-DP: attention whole on each rank, the contiguous cache
    # sequence-sharded (each rank half the positions), decode merging the
    # ranks' partial softmaxes on the plain path, as the reference routes it
    "dp2_ep2": ("DP2", "EP2", "", "reshard", {}),
}
SHARDED_LOGITS = ("tp2_tp2", "tp2_ep2_serial", "tp2_ep2_k2", "dp2_ep2")  # teacher-forced against the one-rank run
# runs served at their first layers only (the script's time limit): the
# reshard moves every expert leaf between the ranks three times,
# ~30 s each at full depth over gloo, and the INT4 runs restore every leaf
# as often; their gates (bytes moved, dequant launches, budgets) hold at any
# depth. No one-rank run of these depths exists, so their tokens are not
# compared. The static runs of the four plans (and the NCCL rank's) serve 7
# layers since the sharded_data part joined sharded_train
SHARDED_CUT = {"tp2_tp2": 7, "tp2_ep2_serial": 7, "tp2_ep2_k2": 7, "dp2_ep2": 7, "switch_reshard": 4,
               "switch_int4": 4, "switch_int4_resident": 4, "continuous_tp2_ep2": 4}
# the plan runs above (and the NCCL rank's) serve the serve traffic's first
# batch: each plan's prefill, transition and decode steps (the script's time
# limit); the replicated run below serves all 8 requests (its prefetch
# learns from the first batch)
SHARDED_REQUESTS = MAX_BATCH
# the runs held to a one-card reference of the same depth, made in the main
# process on the same seeded weights: the teacher-forced logits of the four
# plans, the replicated run and the re-plan traffic, at their first 7 of 28
# layers since the dry run's gate joined sharded_data (the script's time
# limit); the ranks draw all 28 layers and keep views of the first 7
SHARDED_REF_LAYERS = 7
# the mamba families on two ranks (model, layers kept or None for all): the
# mixer tensor-parallel over d_inner; Hymba's 25 heads do not divide two, so
# its attention is replicated and its contiguous cache sequence-sharded.
# Falcon-Mamba keeps 4 of its 64 layers and Hymba 16 of its 32, and both
# serve the serve traffic's first batch (MAX_BATCH requests; the script's
# time limit)
SHARDED_SSM = (("falcon-mamba-7b", 4), ("hymba-1.5b", 16))
# replication and prefetch on two ranks: the switching INT4 plan (experts TP2
# in prefill, EP2 in decode) from resident INT4 experts (two dense ranks'
# restores with replication do not fit the one card together) at the
# replication phase's capacity factor (nothing drops), held to that phase's
# one-rank reference
SHARDED_REPLICATED = ("TP2", "TP2", "EP2", "int4_upload",
                      {"use_int4_transition": True, "resident_int4": True, "replicate_experts": REPL_REPLICAS,
                       "rebalance_interval": REPL_INTERVAL, "prefetch": True, "prefetch_top_p": PREFETCH_TOP_P})


def _hap(plan):
    from repro_torch.core import fixed_plan

    return fixed_plan(plan[0], plan[1], plan[2], mechanism=plan[3])


def _agreement(got, want) -> float:
    """The share of equal tokens, position by position, over the requests."""
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g, w)]
    return sum(a == b for a, b in pairs) / max(len(pairs), 1)


def _teacher_forced(cfg, params, plan, ref) -> dict:
    """Prefill and 15 decode steps of the agree phase's first batch under
    ``plan``, fed the one-rank hopper path's greedy tokens, twice: routing
    on its own, then on the reference's expert choices (this rank's tokens'
    under EP). Relative L2 of each step's logits against one rank computing
    the same function (the one-rank run for a TP expert layout; for EP, one
    rank routing each half of the tokens with its own capacity, as EP2
    does), the expert flips of the tokens this rank routed (a token whose
    expert set in a layer differs), and the token slots this rank's
    capacity dropped per step. Under EP also the relative L2 against the
    plain one-rank run, whose capacity is that of all the tokens."""
    import torch

    from repro_torch.models import decode_step, prefill

    ep = plan.ffn_mode == "ep"
    tokens = torch.as_tensor(ref["tokens"], dtype=torch.long, device="cuda")
    # under EP the function of one rank routing each half of the tokens
    # with its own capacity where the reference has it; else the one rank's
    hop, want = ref["logits"], ref.get("logits_ep2", ref["logits"]) if ep else ref["logits"]
    whole = ref.get("experts_ep2", ref["experts"]) if ep else ref["experts"]

    def run(seen, drops, forced=None):
        with torch.inference_mode(), _routing(seen, forced), _dropping(drops):
            logits, cache = prefill(params, cfg, {"tokens": tokens}, tokens.shape[1] + MAX_NEW + 1, plan=plan)
            out = [logits.float().cpu()]
            for step in range(MAX_NEW - 1):
                logits, cache = decode_step(params, cfg, hop[step].argmax(-1)[:, None].cuda(), cache, plan=plan)
                out.append(logits.float().cpu())
        return out

    def mine(e):
        """This rank's tokens' rows of a layer's choices: under EP each rank
        routes its share of the tokens where they divide (``_moe_ep``)."""
        n = plan.mesh.size
        if not ep or e.shape[0] % n:
            return e
        k = e.shape[0] // n
        return e[plan.mesh.rank * k:(plan.mesh.rank + 1) * k]

    seen, drops = [], []
    out = run(seen, drops)
    same = run([], [], [mine(e).cuda() for e in whole])
    flips = [int((a.cpu().sort(-1).values != mine(e).sort(-1).values).any(-1).sum()) for a, e in zip(seen, whole)]
    per_step = len(seen) // MAX_NEW

    def per(xs):
        return [sum(xs[i:i + per_step]) for i in range(0, len(xs), per_step)]

    def rel_l2(got, ref_):
        return [_rel_l2(h, r) for h, r in zip(got, ref_)]

    res = {"split_tokens": any(a.shape[0] != e.shape[0] for a, e in zip(seen, whole)),
           "rel_l2_err_per_step": rel_l2(out, want),
           "same_experts_rel_l2_err_per_step": rel_l2(same, want),
           "argmax_agreement": sum(int((h.argmax(-1) == r.argmax(-1)).sum()) for h, r in zip(out, want))
           / (len(want) * want[0].shape[0]),
           "finite": all(bool(torch.isfinite(h).all()) for h in out + same),
           "expert_flips_per_step": per(flips), "dropped_slots_per_step": per(drops)}
    if ep:
        res["rel_l2_err_per_step_vs_one_rank"] = rel_l2(out, hop)
    return res


def _one_layer(cfg, params, plan) -> dict:
    """Layer 0's routed experts, sharded under ``plan`` against the same
    layer whole on this rank (its leaves all-gathered), on one input with
    the same routing and a capacity that drops no token; max |delta|."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.params import layer_slice, param_pspecs
    from repro_torch.sharding.specs import sharded_dim

    mesh = plan.mesh
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_routed_experts / cfg.top_k)
    local = layer_slice(params["layers"], 0)["moe"]
    specs = param_pspecs(cfg, plan)["layers"]["moe"]
    whole = {}
    for k, w in local.items():
        a = sharded_dim(specs[k])
        whole[k] = w if a is None else mesh.all_gather(w, dim=a - 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(MAX_BATCH * 128, cfg.d_model, generator=gen, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        want, _, idx0 = moe._moe_local(x, whole, nodrop)
        if plan.ffn_mode == "ep":
            got, _, idx1 = moe._moe_ep(x, local, nodrop, plan)
        else:
            got, _, idx1 = moe._moe_local(x, local, nodrop, axes=plan.expert_kernel_axes(cfg.moe_d_ff))
        full_want = moe.apply_moe(x[None], whole, nodrop).y[0]
        full_got = moe.apply_moe(x[None], local, nodrop, plan=plan).y[0]
    torch.cuda.synchronize()
    if plan.ffn_mode == "ep":  # this rank routed its half of the tokens
        n = x.shape[0] // mesh.size
        idx0 = idx0[mesh.rank * n:(mesh.rank + 1) * n]
    return {"mode": plan.ffn_mode, "tokens": x.shape[0], "same_routing": torch.equal(idx0, idx1),
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_abs_ref": want.float().abs().max().item(),
            "with_shared_max_abs_err": (full_got.float() - full_want.float()).abs().max().item(),
            "finite": bool(torch.isfinite(got).all())}


def _serve_rank(eng, reqs, continuous: bool) -> dict:
    """Serve ``reqs`` on one rank's engine; tokens, per-step times, peak
    memory, launches, launches by shape and dispatch of that run (counts
    zeroed just before)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request

    for p, g in reqs:
        eng.submit(Request(prompt=p, max_new_tokens=g))
    caches = []
    end = eng._end_live_batch

    def end_live_batch():  # a live batch's cache, before the engine releases it
        if eng._live is not None:
            caches.append(_cache_bytes(eng._live.cache))
        end()

    eng._end_live_batch = end_live_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    comps = eng.serve_continuous() if continuous else eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dispatch, st = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS), eng.stats
    shapes = launch_shapes()
    variants = check_variants("sharded", launches)
    # a sequence-sharded cache decodes on the plain path by design (``decode.ref_seq``)
    refs = {k: n for k, n in ref_ops(dispatch).items() if k != "decode.ref_seq"}
    if refs:
        raise AssertionError(f"sharded: ref ops ran on the path: {refs}")
    no_fallback("sharded", dataclasses.asdict(st))
    res = {"wall_s": wall, "tokens_per_s": sum(len(c.tokens) for c in comps) / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches, "variants": variants,
           "dispatch": dispatch, "shapes": shapes, "tokens": [c.tokens for c in comps],
           "transition_ms_total": st.transition_ms_total, "reshard_bytes": st.reshard_bytes,
           "resident_bytes_saved": st.resident_bytes_saved, "async_restores": st.async_restores,
           "seq_decode": dispatch.get("decode.ref_seq", 0),
           "cache": _cache_bytes(eng._static[1]) if eng._static is not None else caches[-1] if caches else {}}
    if continuous:
        res.update(decode_steps=st.decode_steps, decode_step_ms_mean=st.decode_step_ms_sum / st.decode_steps,
                   prefill_chunks=st.prefill_chunks, prefix_hit_blocks=st.prefix_hit_blocks)
    else:
        per_batch = comps[::MAX_BATCH]
        res.update(prefill_ms=[c.prefill_ms for c in per_batch],
                   decode_ms_per_step=[c.decode_ms / (MAX_NEW - 1) for c in per_batch],
                   transition_ms=[c.transition_ms for c in per_batch])
    return res


def _cache_bytes(cache) -> dict:
    """A rank's decode cache: the bytes and shape of each field it holds."""
    return {k: {"bytes": t.nbytes, "shape": list(t.shape)} for k in ("k", "v", "conv", "ssm")
            if (t := getattr(cache, k)) is not None}


def sharded_rank(mesh, ref_path: str, captures=(False,), only=None, rep_ref_path=None, ssm_ref_path=None) -> dict:
    """One rank of the sharded phase (``repro_torch.sharding.launch``): the
    serve traffic through ``run()`` under each plan of ``SHARDED_PLANS`` (or
    ``only``), the teacher-forced logits, the one-layer checks and the
    continuous traffic under TP2/EP2, from this rank's shard of the weights
    drawn with the serve phase's seed. Each run is served once per value of
    ``captures`` (``capture_steps``), on fresh engines over the same
    params; with more than one, its results are keyed "<run>/captured" and
    "<run>/eager"."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession
    from repro_torch.models import init_params

    reset_marks()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path, weights_only=False)
    cfg = get_config("deepseek-moe-16b")
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend, "runs": {}, "logits": {}, "one_layer": {}}
    mark("start")
    params, layout = None, None
    for name, plan in SHARDED_PLANS.items():
        if only is not None and name not in only:
            continue
        hap = _hap(plan)
        splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
        if layout != splan:
            del params
            _free()
            t0 = time.perf_counter()
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda", shard=(splan, mesh.rank))
            torch.cuda.synchronize()
            out.setdefault("init_s", {})[name] = time.perf_counter() - t0
            layout = splan
            out["param_bytes"] = torch.cuda.memory_allocated()
            mark("init")
            if only is None and splan.ffn_mode not in out["one_layer"]:
                out["one_layer"][splan.ffn_mode] = _one_layer(cfg, params, splan)
                mark("one_layer")
        if name in SHARDED_LOGITS and only is None:
            dec = hap.to_sharding_plan(mesh, cfg, phase="decode")
            kw = plan[4]
            if kw.get("moe_pipeline"):
                dec = dataclasses.replace(dec, moe_pipeline=kw["moe_pipeline"])
            out["logits"][name] = _teacher_forced(dataclasses.replace(cfg, num_layers=SHARDED_REF_LAYERS),
                                                  _first_layers_of(params, SHARDED_REF_LAYERS), dec, ref)
            mark(f"teacher_forced {name}")
        for capture in captures:
            run_cfg, run_params = cfg, params
            if name in SHARDED_CUT:  # the first layers, views of the same shard
                run_cfg = dataclasses.replace(cfg, num_layers=SHARDED_CUT[name])
                run_params = _first_layers_of(params, SHARDED_CUT[name])
            eng = HAPSession(run_cfg, "h100", mesh.size, source=hap, mesh=mesh, prompt_bucket=64).engine(
                run_params, max_batch=MAX_BATCH, capture_steps=capture, **plan[4])
            del run_params
            if hap.switches and len(captures) == 1:
                # a switching plan moves the expert leaves: the engine alone
                # holds the params, so that the old leaves free as the new land
                params, layout = None, None
            key = name if len(captures) == 1 else f"{name}/{'captured' if capture else 'eager'}"
            out["runs"][key] = _serve_rank(eng, [(p, MAX_NEW) for p in prompts(cfg)[:SHARDED_REQUESTS]], False)
            out["runs"][key].update(steps=step_stats(eng), layers=run_cfg.num_layers)
            eng.close()
            del eng
            _free()
            mark(f"run {key}")
        if name == "tp2_ep2_serial" and only is None:
            # the re-plan traffic, paged then contiguous: the attention layout
            # switches TP2 -> DP2 -> TP2 while requests are live, the experts
            # stay EP2. The engine alone holds the params (its attention
            # leaves move); the first engine's params, back in the TP2/EP2
            # layout, serve the second. Both at the first SHARDED_REF_LAYERS
            # layers (views of the same shard), as their one-card reference
            replan_cfg = dataclasses.replace(cfg, num_layers=SHARDED_REF_LAYERS)
            params = _first_layers_of(params, SHARDED_REF_LAYERS)
            for paged in (True, False):
                session = HAPSession(replan_cfg, "h100", mesh.size, source=ReplanSource(), mesh=mesh,
                                     prompt_bucket=64)
                session.transition_between = lambda old, new, w: ("reshard", 0.0)  # Eq. 6 pinned: no model to fit
                eng = session.engine(params, max_batch=REPLAN_MAX_BATCH, paged=paged, params_plan=splan)
                params, layout = None, None
                run = _serve_rank(eng, replan_requests(replan_cfg), True)
                run.update(relayout_ms=list(eng.kv_relayout_ms), plan_switches=eng.stats.plan_switches,
                           end_layout=[eng._layout.attn_mode, eng._layout.ffn_mode], layers=SHARDED_REF_LAYERS)
                out["runs"][f"replan_{'paged' if paged else 'contiguous'}"] = run
                if run["end_layout"] != ["tp_heads", "ep"]:
                    raise AssertionError(f"sharded (replan): the run ended in {run['end_layout']}, not TP2/EP2")
                params = eng.params
                eng.close()
                del eng
                _free()
                mark(f"replan {'paged' if paged else 'contiguous'}")
            params = None
            _free()
        if name == "tp2_ep2_k2" and only is None:
            # the continuous traffic with the prefix cache, TP2/EP2 (K auto)
            L = SHARDED_CUT["continuous_tp2_ep2"]
            eng = HAPSession(dataclasses.replace(cfg, num_layers=L), "h100", mesh.size,
                             source=_hap(("TP2", "EP2", "", "reshard")), mesh=mesh, prompt_bucket=64).engine(
                _first_layers_of(params, L), max_batch=CONT_MAX_BATCH, kv_block_size=CONT_BLOCK, prefix_cache=True,
                capture_steps=captures[0])
            out["runs"]["continuous_tp2_ep2"] = dict(_serve_rank(eng, cont_requests(cfg), True), layers=L)
            eng.close()
            del eng
            _free()
            mark("run continuous_tp2_ep2")
    del params
    _free()
    if rep_ref_path is not None:
        out["runs"]["replicated_switch_int4"], out["replicated_logits"] = _replicated_rank(mesh, rep_ref_path)
        mark("replicated_switch_int4")
    if ssm_ref_path is not None:
        out["ssm"] = _ssm_rank(mesh, ssm_ref_path)
        mark("ssm")
    out["steps_s"] = dict(STEP_S)
    return out


def _ssm_config(name: str, layers):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def ssm_references() -> dict:
    """The one-card runs the two-rank mamba runs are held to, each model
    (``SHARDED_SSM``) at its depth there, on the serve phase's seed: the
    serve traffic's first batch through ``run()`` and through the
    contiguous fallback,
    and the first batch's teacher-forced logits (prefill + 15 decode steps,
    greedy), with the same path's batch noise per step (each row alone,
    B=1, fed the batch's tokens, against the batch)."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, Request

    refs = {}
    for name, layers in SHARDED_SSM:
        cfg = _ssm_config(name, layers)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        ref = {"layers": cfg.num_layers}
        for cont in (False, True):
            eng = InferenceEngine(cfg, params, max_batch=MAX_BATCH, paged=False)
            for p in prompts(cfg)[:MAX_BATCH]:
                eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
            ref["contiguous" if cont else "static"] = [c.tokens for c in (eng.serve_continuous() if cont
                                                                          else eng.run())]
            eng.close()
            del eng
        tokens = _first_batch(cfg)
        hop = _forced_logits(cfg, params, tokens, "hopper")
        alone = [_forced_logits(cfg, params, tokens[i:i + 1], "hopper", feed=[h[i:i + 1] for h in hop])
                 for i in range(len(tokens))]
        ref.update(logits=hop, noise=[_rel_l2(torch.cat(rows), h) for rows, h in zip(zip(*alone), hop)])
        refs[name] = ref
        del params, alone
        _free()
    return refs


def _ssm_rank(mesh, ref_path: str) -> dict:
    """One rank's two-rank mamba runs: each model of ``SHARDED_SSM`` from
    this rank's shard (TP2: the mixer's d_inner halved), the serve traffic's
    first batch through ``run()`` and the contiguous fallback, and its
    logits teacher-forced on the one-card run's tokens."""
    import torch

    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import init_params

    refs = torch.load(ref_path, weights_only=False)
    hap = fixed_plan("TP2", "TP2")
    out = {}
    for name, layers in SHARDED_SSM:
        cfg = _ssm_config(name, layers)
        splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda", shard=(splan, mesh.rank))
        res = {"layers": cfg.num_layers, "kv_shard": splan.kv_shard, "attn_mode": splan.attn_mode}
        for cont in (False, True):
            eng = HAPSession(cfg, "h100", mesh.size, source=hap, mesh=mesh, prompt_bucket=64).engine(
                params, max_batch=MAX_BATCH, paged=False)
            res["contiguous" if cont else "static"] = _serve_rank(eng, [(p, MAX_NEW) for p in prompts(cfg)[:MAX_BATCH]],
                                                                  cont)
            eng.close()
            del eng
            _free()
            mark(f"ssm {name} {'contiguous' if cont else 'static'}")
        got = _forced_logits(cfg, params, _first_batch(cfg), "hopper", feed=refs[name]["logits"],
                             plan=hap.to_sharding_plan(mesh, cfg, phase="decode"))
        res["rel_l2_err_per_step"] = [_rel_l2(a, b) for a, b in zip(got, refs[name]["logits"])]
        res["finite"] = all(bool(torch.isfinite(t).all()) for t in got)
        out[name] = res
        del params
        _free()
    return out


def _replicated_rank(mesh, rep_ref_path: str):
    """One rank of the replicated two-rank run: ``SHARDED_REPLICATED`` on
    this rank's shard at the replication phase's capacity factor; then the
    teacher-forced logits under the decode layout the run ended in (EP2,
    this rank's half of the slots of resident INT4 experts)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), capacity_factor=REPL_CAPACITY)
    ref = torch.load(rep_ref_path, weights_only=False)
    hap = _hap(SHARDED_REPLICATED)
    splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda", shard=(splan, mesh.rank))
    cfg = dataclasses.replace(cfg, num_layers=SHARDED_REF_LAYERS)
    params = _first_layers_of(params, SHARDED_REF_LAYERS)
    eng = HAPSession(cfg, "h100", mesh.size, source=hap, mesh=mesh, prompt_bucket=64).engine(
        params, max_batch=MAX_BATCH, capture_steps=False, **SHARDED_REPLICATED[4])
    del params  # the engine alone holds them: old leaves free as new ones land
    run = _serve_rank(eng, [(p, MAX_NEW) for p in prompts(cfg)], False)
    st, rep = eng.stats, eng._replication
    run.update(steps=step_stats(eng), layers=cfg.num_layers, rebalances=st.replication_rebalances,
               routing_steps=st.routing_steps,
               degrees=list(rep.degrees) if rep is not None else None,
               slots_on_rank=int(eng.params["layers"]["moe"]["wi_gate"].shape[1]),
               **{k: getattr(st, k) for k in ("prefetch_predicted", "prefetch_hits", "prefetch_misses",
                                              "prefetch_bytes", "prefetch_hidden_ms", "prefetch_exposed_ms",
                                              "prefetch_errors", "restore_wait_ms")})
    mark("replicated run")
    logits = _teacher_forced(cfg, eng.params, eng._sharding_for("decode"), ref)
    eng.close()
    del eng
    _free()
    return run, logits


def phase_sharded(serve, cont, agree_ref, repl, replan) -> dict:
    """DeepSeekMoE-16B at full width and depth on two ranks that share the
    card over a gloo group, each holding only its shard, and the mamba
    families (``SHARDED_SSM``); then one NCCL rank with its steps captured.
    Each run is held to its one-rank run (``replan``: the re-plan
    traffic's, ``replan_references``)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.sharding.launch import spawn

    work = tempfile.mkdtemp(prefix="sharded_")
    ref_path, rep_ref_path = os.path.join(work, "ref.pt"), os.path.join(work, "rep_ref.pt")
    ssm_ref_path = os.path.join(work, "ssm_ref.pt")
    torch.save(agree_ref, ref_path)
    torch.save(repl, rep_ref_path)
    t0 = time.perf_counter()
    ssm_refs = ssm_references()
    torch.save(ssm_refs, ssm_ref_path)
    ssm_ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:sharded_rank", 2, backend="gloo", args={"ref_path": ref_path,
                                                                      "rep_ref_path": rep_ref_path,
                                                                      "ssm_ref_path": ssm_ref_path},
                  timeout=SHARDED_TIMEOUT_S, pythonpath=(ROOT,))
    two_rank_s = time.perf_counter() - t0
    r0, r1 = ranks
    layers = len(agree_ref["experts"]) // MAX_NEW  # MoE layers per step

    def per_step(xs):
        return [sum(xs[i:i + layers]) for i in range(0, len(xs), layers)]
    summary = {"phase": "sharded", "ranks": 2, "backend": "gloo", "device": "cuda:0 (both ranks)",
               "seconds": two_rank_s, "ssm_reference_s": ssm_ref_s, "init_s": [r["init_s"] for r in ranks],
               "param_bytes_per_rank": [r["param_bytes"] for r in ranks], "rank0_steps_s": r0["steps_s"]}
    launches, shapes = {}, {}
    cfg = get_config("deepseek-moe-16b")
    for name, run in r0["runs"].items():
        other = r1["runs"][name]
        if run["tokens"] != other["tokens"]:
            raise AssertionError(f"sharded ({name}): the two ranks' tokens differ")
        continuous = name.startswith(("continuous", "replan"))
        if name.startswith("replan"):
            want = replan[name.split("_", 1)[1]]
        else:
            want = cont["tokens"] if continuous else serve["tokens"]
        # continuous: chunks through the paged kernel, decode steps through the prefix kernel;
        # attention-DP's static run decodes on the plain path (a seq-sharded cache)
        expect = {"paged_attention", "grouped_matmul"} | (
            {"prefix_paged_attention"} if continuous else {"flash_attention"})
        if name == "dp2_ep2":
            expect.discard("paged_attention")
        elif name == "replan_paged":
            expect.discard("prefix_paged_attention")
        elif name == "replan_contiguous":
            expect = {"flash_attention", "paged_attention", "grouped_matmul"}
        if "int4" in name:
            expect.add("int4_dequant")
        _check_seq_run(name, cfg, run, other)
        for r, rr in ((0, run), (1, other)):
            missing = [k for k in expect if not rr["launches"].get(k)]
            if missing:
                raise AssertionError(f"sharded ({name}): rank {r} launched no {missing}: {rr['launches']}")
        if any(len(t) != g for t, g in zip(run["tokens"], [len(w) for w in want])):
            raise AssertionError(f"sharded ({name}): a request did not get its budget")
        if name in SHARDED_CUT or name == "replicated_switch_int4":
            want = None  # its depth has no one-rank run of the serve traffic
        launches[name] = [run["launches"], other["launches"]]
        for r, rr in enumerate((run, other)):
            for kernel, by_shape in rr["shapes"].items():
                for key, n in by_shape.items():
                    shapes.setdefault(kernel, {}).setdefault(key, {}).setdefault(name, [0, 0])[r] = n
        plan = SHARDED_REPLICATED if name.startswith("replicated") else SHARDED_PLANS.get(
            name, ("TP2", "EP2", "", "reshard", {}))
        extra = {k: [run[k], other[k]] for k in ("rebalances", "routing_steps", "degrees", "slots_on_rank",
                                                 "prefetch_predicted", "prefetch_hits", "prefetch_misses",
                                                 "prefetch_bytes", "prefetch_hidden_ms", "prefetch_exposed_ms",
                                                 "restore_wait_ms") if k in run}
        if name.startswith("replan"):
            plan = ("TP2<->DP2", "EP2", "", "reshard")
            extra.update(relayout_ms_per_rank=[run["relayout_ms"], other["relayout_ms"]],
                         plan_switches=run["plan_switches"])
        if run["seq_decode"]:
            extra.update(seq_decode_per_rank=[run["seq_decode"], other["seq_decode"]])
        if "k" in run["cache"]:
            extra.update(kv_cache_per_rank=[run["cache"]["k"], other["cache"]["k"]])
        emit({"phase": "sharded", "run": name, "plan": list(plan[:4]), **extra,
              "two_ranks_one_card_gloo": True,
              "layers": run.get("layers", cfg.num_layers),
              "token_agreement_with_one_rank": None if want is None else _agreement(run["tokens"], want),
              "tokens_equal_one_rank": None if want is None else run["tokens"] == want,
              "max_memory_allocated_per_rank": [run["max_memory_allocated"], other["max_memory_allocated"]],
              "launches_per_rank": launches[name],
              "relayout_ms_total_per_rank": [run["transition_ms_total"], other["transition_ms_total"]],
              "reshard_bytes_per_rank": [run["reshard_bytes"], other["reshard_bytes"]],
              **{k: [run[k], other[k]] for k in ("wall_s", "tokens_per_s", "prefill_ms", "decode_ms_per_step",
                                                 "transition_ms", "decode_step_ms_mean", "resident_bytes_saved",
                                                 "async_restores") if k in run}})
    ssm_shapes = _check_ssm_ranks(ranks, ssm_refs)
    if r0["runs"]["switch_reshard"]["reshard_bytes"] <= 0:
        raise AssertionError("sharded (switch_reshard): the reshard moved nothing between the ranks")
    rr = [r["runs"]["replicated_switch_int4"] for r in ranks]
    if any(r["rebalances"] < 1 or r["prefetch_hits"] <= 0 or r["prefetch_errors"] for r in rr):
        raise AssertionError(f"sharded (replicated): no rebalance or no prefetch hit: {rr}")
    if rr[0]["degrees"] != rr[1]["degrees"] or rr[0]["slots_on_rank"] * 2 != sum(rr[0]["degrees"]):
        raise AssertionError(f"sharded (replicated): the ranks' replica sets differ, or a rank holds other than "
                             f"half the slots: {rr}")
    lg, lg1 = r0["replicated_logits"], r1["replicated_logits"]
    if (lg["rel_l2_err_per_step"], lg["same_experts_rel_l2_err_per_step"]) != (
            lg1["rel_l2_err_per_step"], lg1["same_experts_rel_l2_err_per_step"]):
        raise AssertionError("sharded (replicated): the two ranks' logits differ")
    res = {"phase": "sharded_agree", "run": "replicated_switch_int4", "steps": MAX_NEW,
           "layers": SHARDED_REF_LAYERS, **lg,
           "reference": "the replication phase's one-rank run (INT4 round-tripped weights, no drops)",
           "same_experts_rel_l2_tol": AGREE_SAME_EXPERTS_TOL, "two_ranks_one_card_gloo": True}
    emit(res)
    if not lg["finite"] or max(lg["same_experts_rel_l2_err_per_step"]) > AGREE_SAME_EXPERTS_TOL:
        raise AssertionError(f"sharded (replicated): logits beyond the same-experts bound: {res}")
    for mode, chk in r0["one_layer"].items():
        chk1 = r1["one_layer"][mode]
        tol = 0.0 if mode == "ep" else KERNEL_ATOL + KERNEL_RTOL * chk["max_abs_ref"]
        emit({"phase": "sharded_one_layer", "mode": mode, "rank0": chk, "rank1": chk1, "tolerance": tol})
        if not (chk["finite"] and chk1["finite"]) or max(chk["max_abs_err"], chk1["max_abs_err"]) > tol:
            raise AssertionError(f"sharded: one MoE layer under {mode} differs from the whole layer: {chk}, {chk1}")
    for name, lg in r0["logits"].items():
        lg1 = r1["logits"][name]
        if (lg["rel_l2_err_per_step"], lg["same_experts_rel_l2_err_per_step"]) != (
                lg1["rel_l2_err_per_step"], lg1["same_experts_rel_l2_err_per_step"]):
            raise AssertionError(f"sharded ({name}): the two ranks' logits differ")
        # EP: each rank routed its half of the tokens; TP: each rank all of them
        both = (lambda k: [a + b for a, b in zip(lg[k], lg1[k])]) if lg["split_tokens"] else (lambda k: lg[k])
        ep = lg["split_tokens"]
        res = {"phase": "sharded_agree", "run": name, "steps": MAX_NEW, "layers": SHARDED_REF_LAYERS, **lg,
               "reference": "one rank routing each half of the tokens with its own capacity" if ep else
               "the one-rank run", "expert_flips_per_step": both("expert_flips_per_step"),
               "dropped_slots_per_step": both("dropped_slots_per_step"),
               "reference_dropped_slots_per_step": per_step(agree_ref["drops_ep2" if ep else "drops"]),
               "one_rank_dropped_slots_per_step": per_step(agree_ref["drops"]),
               "rel_l2_tol": AGREE_TOL[0], "same_experts_rel_l2_tol": AGREE_SAME_EXPERTS_TOL,
               "two_ranks_one_card_gloo": True}
        emit(res)
        if (not lg["finite"] or max(lg["rel_l2_err_per_step"]) > AGREE_TOL[0]
                or max(lg["same_experts_rel_l2_err_per_step"]) > AGREE_SAME_EXPERTS_TOL):
            raise AssertionError(f"sharded ({name}): logits beyond the agree bounds: {res}")

    # one NCCL rank: the TP2/EP2 serial run captured, then eager
    t0 = time.perf_counter()
    nccl = spawn("chip_smoke:sharded_rank", 1, backend="nccl",
                 args={"ref_path": ref_path, "captures": (True, False), "only": ("tp2_ep2_serial",)},
                 timeout=SHARDED_TIMEOUT_S, pythonpath=(ROOT,))[0]["runs"]
    cap, eag = nccl["tp2_ep2_serial/captured"], nccl["tp2_ep2_serial/eager"]
    if cap["steps"]["captures"] == 0 or cap["steps"]["replays"] == 0 or eag["steps"]["captures"]:
        raise AssertionError(f"sharded (nccl): capture did not run as asked: {cap['steps']}, {eag['steps']}")
    if cap["tokens"] != eag["tokens"]:
        raise AssertionError("sharded (nccl): captured and eager tokens differ")
    if cap["launches"] != eag["launches"]:
        raise AssertionError(f"sharded (nccl): launches differ, captured {cap['launches']} against {eag['launches']}")
    emit({"phase": "sharded", "run": "nccl_one_rank_tp2_ep2_serial", "captured_equals_eager": True,
          # at SHARDED_CUT's depth no one-rank run exists
          "tokens_equal_one_rank": None if "tp2_ep2_serial" in SHARDED_CUT else cap["tokens"] == serve["tokens"],
          "token_agreement_with_one_rank": None if "tp2_ep2_serial" in SHARDED_CUT else _agreement(
              cap["tokens"], serve["tokens"]),
          "steps": cap["steps"], "launches": cap["launches"], "seconds": time.perf_counter() - t0,
          **{k: [cap[k], eag[k]] for k in ("wall_s", "decode_ms_per_step", "prefill_ms", "max_memory_allocated")}})
    for path in (ref_path, rep_ref_path, ssm_ref_path):
        os.remove(path)
    os.rmdir(work)
    summary["nccl_seconds"] = time.perf_counter() - t0
    emit(summary)
    return {"launches": launches, "shapes": shapes, "nccl": cap["launches"], "ssm_shapes": ssm_shapes}


def _check_seq_run(name: str, cfg, run, other) -> None:
    """A run's per-rank cache and plain-path decodes: attention-DP's static
    cache holds ceil(max_len / 2) of its max_len positions on each rank, and
    every decode step of it went through the seq decode; a heads-sharded
    run ran none; the re-plan runs moved their live cache twice."""
    L = run.get("layers", cfg.num_layers)
    if name == "dp2_ep2":
        k = run["cache"]["k"]["shape"]
        max_len = 128 + MAX_NEW + 1  # the serve traffic's bucket, its new tokens, one more
        if k[2] != math.ceil(max_len / 2) or k[3] != cfg.num_kv_heads:
            raise AssertionError(f"sharded ({name}): a rank's cache is {k}, not half the {max_len} positions")
        steps = math.ceil(SHARDED_REQUESTS / MAX_BATCH) * (MAX_NEW - 1)
        if run["seq_decode"] != steps * L or other["seq_decode"] != steps * L:
            raise AssertionError(f"sharded ({name}): {run['seq_decode']} seq decodes, expected {steps * L}")
    elif name.startswith("replan"):
        for r in (run, other):
            if len(r["relayout_ms"]) != 2 or r["plan_switches"] != 2:
                raise AssertionError(f"sharded ({name}): expected two plan switches, each moving the live cache: "
                                     f"{r['relayout_ms']}, {r['plan_switches']}")
    elif run["seq_decode"] or other["seq_decode"]:
        raise AssertionError(f"sharded ({name}): a heads-sharded run decoded on the plain path")


def _check_ssm_ranks(ranks, refs) -> list:
    """The two-rank mamba runs against their one-card runs: tokens equal on
    the two ranks, token agreement with one card reported, the conv window
    and state (and Hymba's seq cache) half of the whole on each rank, and
    the teacher-forced logits within ``SSM_NOISE_FACTOR`` times the one-card
    run's batch noise (the ssm phase's rule); launches exact: Hymba's joins
    and batches through flash, its decode steps on the plain seq path,
    Falcon-Mamba none. Returns the runs' launches by shape for
    ``path_kernel_rows``."""
    out = []
    for name, _ in SHARDED_SSM:
        a, b = ranks[0]["ssm"][name], ranks[1]["ssm"][name]
        ref = refs[name]
        cfg = _ssm_config(name, None)
        L = a["layers"]
        bound = SSM_NOISE_FACTOR * max(ref["noise"])
        res = {"phase": "sharded_ssm", "model": name, "layers": L, "kv_shard": a["kv_shard"],
               "attn_mode": a["attn_mode"], "rel_l2_err_per_step": a["rel_l2_err_per_step"],
               "batch_noise_per_step": ref["noise"], "rel_l2_tol": bound, "two_ranks_one_card_gloo": True}
        for kind in ("static", "contiguous"):
            x, y = a[kind], b[kind]
            if x["tokens"] != y["tokens"]:
                raise AssertionError(f"sharded_ssm ({name} {kind}): the two ranks' tokens differ")
            if any(len(t) != MAX_NEW for t in x["tokens"]):
                raise AssertionError(f"sharded_ssm ({name} {kind}): a request did not get its budget")
            prefills = MAX_BATCH if kind == "contiguous" else 1  # each join alone, or the one batch
            expect = {"flash_attention": prefills * L} if cfg.has_attention else {}
            for r in (x, y):
                if {k: v for k, v in r["launches"].items() if v} != expect:
                    raise AssertionError(f"sharded_ssm ({name} {kind}): launches {r['launches']}, expected {expect}")
                if cfg.has_attention and not r["seq_decode"]:
                    raise AssertionError(f"sharded_ssm ({name} {kind}): no decode step read the seq cache")
            whole_conv = L * x["cache"]["conv"]["shape"][1] * (cfg.ssm_conv - 1) * cfg.ssm_d_inner * 2
            whole_ssm = L * x["cache"]["ssm"]["shape"][1] * cfg.ssm_d_inner * cfg.ssm_state * 4
            half = [x["cache"]["conv"]["bytes"] / whole_conv, x["cache"]["ssm"]["bytes"] / whole_ssm]
            if half != [0.5, 0.5]:
                raise AssertionError(f"sharded_ssm ({name} {kind}): a rank's conv/ssm state is {half} of the whole")
            res[kind] = {"token_agreement_with_one_card": _agreement(x["tokens"], ref[kind]),
                         "tokens_equal_one_card": x["tokens"] == ref[kind], "launches": x["launches"],
                         "seq_decode": x["seq_decode"], "state_share_per_rank": half, "cache": x["cache"],
                         **{k: [x[k], y[k]] for k in ("wall_s", "tokens_per_s", "decode_ms_per_step", "prefill_ms",
                                                      "decode_step_ms_mean", "max_memory_allocated") if k in x}}
            out.append(("launches_sharded_ssm", f"{name} two ranks {kind}", name, x["shapes"]))
        emit(res)
        if not a["finite"] or max(a["rel_l2_err_per_step"]) > bound or a["rel_l2_err_per_step"] != b[
                "rel_l2_err_per_step"]:
            raise AssertionError(f"sharded_ssm ({name}): two-rank logits beyond {bound} of one card: {res}")
    return out


def sharded_kernel_rows(cfg, rows, shapes) -> None:
    """Each kernel against its plain version at the per-rank shapes the
    sharded phase's two-rank runs sent it (``shapes``: kernel -> shape ->
    run -> launches per rank). flash, gmm and dequant get a row at each
    such shape, with its launches, in their kernel's ``also``; a paged or
    prefix launch goes to the kernels phase's row at its shape (a rank's
    heads, or every head under attention-DP), or to a new row
    (``attention_row``)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    by_name = {r["name"]: r for r in rows}
    for kernel in ("paged_attention", "prefix_paged_attention"):
        by_name[kernel]["launches_sharded_by_shape"] = {
            f"B={k[0]} C={k[1]} Hq={k[2]} Hkv={k[3]} hd={k[4]}": v for k, v in shapes.get(kernel, {}).items()}
        for key, per_run in sorted(shapes.get(kernel, {}).items()):
            # a rank's heads (TP2) or every head (a whole pool or cache): the row at that shape, or a new one
            row = next((r for r in by_name[kernel]["also"] if r.get("model") in (SHARDED_RANK, cfg.name)
                        and tuple(r.get("key", ())) == key), None)
            if row is None:
                row = attention_row(kernel, key, SHARDED_RANK, attn_of(cfg)[3:], rng, dev)
                by_name[kernel]["also"].append(row)
            row["launches_sharded"] = per_run

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def randn(*shape, std=1.0):  # on the card: a weight of 68 slots is 196M values
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    scale = attn_of(cfg)[4]
    for kernel in ("flash_attention", "grouped_matmul", "int4_dequant"):
        for key, per_run in sorted(shapes.get(kernel, {}).items()):
            if kernel == "flash_attention":
                B, S, Hq, Hkv, hd, win, cap = key
                row = flash_case(dev, randn, SHARDED_RANK, B, S, (Hq, Hkv, hd, cap, scale), win)
            elif kernel == "grouped_matmul":
                E, C, K, N = key
                row = gmm_case(randn, SHARDED_RANK, E, C, K, N, "wi" if K == cfg.d_model else "wo")
            else:
                G, gs, dt = key
                row = dequant_case(rng, dev, G, gs, getattr(torch, dt), SHARDED_RANK)
            row["launches_sharded"] = per_run
            by_name[kernel]["also"].append(row)
            torch.cuda.empty_cache()
    emit({"phase": "sharded_kernels", "rows": [row for r in rows for row in r["also"]
                                              if row.get("model") == SHARDED_RANK]})


# sharded_train phase: training on a (data, model) mesh of four gloo ranks
# that share the card (NCCL refuses two ranks on one device), each holding
# its shard of the state and its data rows of the batch. DeepSeekMoE-16B at
# full width and ST_LAYERS of its 28 layers (the script's time limit: 2 took
# ~160 s, ~50 of it the FSDP steps' host-staged gathers):
# float32 against one rank, bf16 under four layouts, then the model-level
# prefill and decode on the (2, 2) mesh through the hopper seam, then the
# train launcher on the four ranks
ST_LAYERS = 1
ST_B, ST_S, ST_STEPS = 4, 256, 2
# the float32 run: capacity factor 11 (T k / E cf >= T on every EP shard, so
# nothing drops) and no aux term, so that the one-rank run computes the same
# function: EP with a data axis routes and averages the aux per shard
# (ROADMAP C); the CPU tests hold the aux's gradient to the reference
ST_F32 = {"capacity_factor": 11.0, "router_aux_loss_coef": 0.0}
ST_F32_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4}  # rel; rel L2 per leaf, gathered
# bf16 layouts: name -> (mesh, make_plan's expert mode, seq_shard_acts, fsdp)
ST_LAYOUTS = {"tp2_ep2_1x2": ("1x2", "", False, False), "dp2_ep2_2x2": ("2x2", "", False, False),
              "dp2_ep2_sp_2x2": ("2x2", "", True, False), "fsdp_2x2": ("2x2", "", False, True)}
ST_SERVE_LAYERS, ST_SERVE_B, ST_SERVE_S = 4, 4, 64  # prefill + MAX_NEW - 1 greedy decode steps
ST_CACHES = ("heads", "seq")
ST_LAUNCH_STEPS = 5
SHARDED_TRAIN_TIMEOUT_S = 900.0


def _st_config(layers: int, dtype: str, small: bool, **over):
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-moe-16b")
    if small:  # the CPU rehearsal
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, num_layers=layers, dtype=dtype, **over)


def _st_plan(mesh, cfg, expert: str = "", sp: bool = False, fsdp: bool = False, kv: str = ""):
    from repro_torch.sharding.specs import ShardingPlan, make_plan

    if fsdp:  # the reference dry run's ZeRO-3 plan
        return ShardingPlan(mesh=mesh, dp_axes=tuple(mesh.axis_names), attn_mode="replicated", kv_shard="none",
                            ffn_mode="tp", ffn_tp_axis=None, ep_axis=None, fsdp=True)
    return dataclasses.replace(make_plan(mesh, cfg, expert_mode=expert, kv_shard=kv), seq_shard_acts=sp)


def _st_train(cfg, plan, device, B, S, steps) -> tuple:
    """``steps`` steps of ``train_loop`` from the seeded state (this rank's
    shard of it): (state, history, peak bytes, collectives per step)."""
    import torch

    from repro_torch.data import synthetic_lm_data
    from repro_torch.training.train_loop import init_train_state, train_loop

    if device == "cuda":
        _free()
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(SEED), device, plan=plan)
    calls = dict(plan.mesh.calls) if plan is not None else {}
    hist = []
    state = train_loop(cfg, synthetic_lm_data(cfg, B, S, seed=SEED, plan=plan), steps, plan=plan, state=state,
                       log_every=0, history=hist)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    per_step = {k: (n - calls.get(k, 0)) / steps for k, n in plan.mesh.calls.items()} if plan is not None else {}
    return state, hist, peak, per_step


def _st_gathered_errors(state, cfg, plan, want, me) -> dict:
    """Rank 0's rel L2 of each leaf of ``state.params``, gathered from the
    ranks' shards, against ``want`` (one rank's), a leaf at a time."""
    from repro_torch.models.params import SPLIT_LEAVES, gather_leaf, leaf_specs
    from repro_torch.training.tree import tree_items

    specs, errs = leaf_specs(cfg, plan), {}
    for name, t in tree_items(state.params):
        whole = gather_leaf(t.detach(), specs[name], plan.mesh, SPLIT_LEAVES.get(name.rsplit("/", 1)[-1], 1))
        if me == 0:
            errs[name] = _rel_l2(whole, want[name])
        del whole
    return errs


def _st_serve(cfg, params, plan, tokens, fed, backend, forced=None, parts: int = 0) -> tuple:
    """Prefill of ``tokens`` and a decode step per column of ``fed`` under
    ``plan``: (logits per step on the host, the expert choices of each
    layer and step, the cache's shape). ``forced``: the choices to route
    on; ``parts``: one rank routing each of that many equal parts of the
    tokens with its own capacity (``_ep_halves``), the function EP over as
    many ranks computes."""
    import torch

    from repro_torch.models import decode_step, prefill

    seen = []
    split = _ep_halves(seen, n=parts) if parts else contextlib.nullcontext()
    with torch.inference_mode(), _routing(seen, forced), split:
        lg, cache = prefill(params, cfg, {"tokens": tokens}, tokens.shape[1] + MAX_NEW + 1, backend=backend,
                            plan=plan)
        out = [lg.float().cpu()]
        for step in range(fed.shape[1]):
            lg, cache = decode_step(params, cfg, fed[:, step:step + 1], cache, backend=backend, plan=plan)
            out.append(lg.float().cpu())
    return out, [e.cpu() for e in seen], tuple(cache.k.shape)


def sharded_train_rank(mesh, device: str = "cuda", small: bool = False, launcher: bool = True) -> dict:
    """One of the four ranks of the sharded_train phase
    (``repro_torch.sharding.launch``; ``mesh`` is the spawn's four ranks).
    ``small`` rehearses it on reduced widths (the CPU, the plain path)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.sharding.mesh import RankMesh
    from repro_torch.training.tree import tree_items

    reset_marks()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    backend = "hopper" if device == "cuda" else "ref"
    me = mesh.index
    grid = RankMesh(data=2)
    pair_group = dist.new_group([0, 1])
    meshes = {"2x2": grid, "1x2": RankMesh(pair_group) if me < 2 else None}
    B, S = (ST_B, 16) if small else (ST_B, ST_S)
    out = {"rank": me, "coords": grid.coords}

    # 1. float32: one rank (rank 0 alone), then the four ranks as (2, 2)
    cfg = _st_config(ST_LAYERS, "float32", small, **ST_F32)
    one = None
    if me == 0:
        t0 = time.perf_counter()
        state, hist, peak, _ = _st_train(cfg, None, device, B, S, ST_STEPS)
        one = {n: t.detach() for n, t in tree_items(state.params)}
        out["f32_one_rank"] = {"history": hist, "peak_bytes": peak, "seconds": time.perf_counter() - t0}
        del state
        _free()
    elif device == "cuda":
        # meanwhile the other ranks' first training step, on one rank each:
        # a rank process's first step pays ~8 s of one-time set-up on the
        # card (the H100 read 9.7 s for it, 0.24 s for the next), which the
        # (2, 2) run's first step would pay on three ranks at once
        _st_train(cfg, None, device, B, S, 1)
        _free()
    dist.barrier()
    mark("f32 one rank")
    plan = _st_plan(grid, cfg)
    t0 = time.perf_counter()
    state, hist, peak, calls = _st_train(cfg, plan, device, B, S, ST_STEPS)
    out["f32_2x2"] = {"history": hist, "peak_bytes": peak, "collectives_per_step": calls,
                      "seconds": time.perf_counter() - t0, "plan": [plan.attn_mode, plan.ffn_mode]}
    out["f32_2x2"]["params_rel_l2"] = _st_gathered_errors(state, cfg, plan, one, me)
    del state, one
    _free()
    mark("f32 2x2")

    # 2. bf16 under each layout
    cfg = _st_config(ST_LAYERS, "float32" if small else "bfloat16", small)
    out["bf16"] = {}
    for name, (where, expert, sp, fsdp) in ST_LAYOUTS.items():
        m = meshes[where]
        if m is not None:
            plan = _st_plan(m, cfg, expert, sp, fsdp)
            ops.reset_counts()
            state, hist, peak, calls = _st_train(cfg, plan, device, B, S, ST_STEPS)
            out["bf16"][name] = {"history": hist, "peak_bytes": peak, "collectives_per_step": calls,
                                 "launches": dict(ops.LAUNCH_COUNTS),
                                 "plan": [plan.attn_mode, plan.ffn_mode, plan.seq_shard_acts, plan.fsdp]}
            del state
            _free()
        dist.barrier()
        mark(f"bf16 {name}")

    # 3. prefill + decode on (2, 2) through the hopper seam: one rank first
    cfg = _st_config(ST_SERVE_LAYERS if not small else 2, "float32" if small else "bfloat16", small)
    gen = torch.Generator().manual_seed(SEED + 11)
    tokens = torch.randint(1, cfg.vocab_size, (ST_SERVE_B, ST_SERVE_S if not small else 16), generator=gen)
    ref = [None]
    if me == 0:  # the greedy tokens, then the logits and experts teacher-forced on them
        params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
        fed = torch.zeros((ST_SERVE_B, MAX_NEW - 1), dtype=torch.long)
        with _ep_halves(n=4):
            _greedy(cfg, params, tokens.to(device), fed, device, backend)
        logits, seen, _ = _st_serve(cfg, params, None, tokens.to(device), fed.to(device), backend, parts=4)
        ref[0] = {"logits": logits, "experts": seen, "fed": fed}
        del params
        _free()
    dist.broadcast_object_list(ref, src=0)
    ref = ref[0]
    mark("serve one rank")
    from repro_torch.data.pipeline import local_rows

    out["serve"] = {}
    for kv in ST_CACHES:
        plan = _st_plan(grid, cfg, kv=kv)
        params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device,
                             shard=(plan, grid.coords))
        rows = local_rows({"tokens": tokens.numpy(), "fed": ref["fed"].numpy()}, plan)
        lo = grid.coords["data"] * rows["tokens"].shape[0]
        mine_rows = slice(lo, lo + rows["tokens"].shape[0])

        def quarter(e):  # this rank's share of a layer's routed tokens (EP over data x model)
            k = e.shape[0] // 4
            return e[grid.index * k:(grid.index + 1) * k]

        ops.reset_counts()
        got, _, shape = _st_serve(cfg, params, plan, torch.from_numpy(rows["tokens"]).to(device),
                                  torch.from_numpy(rows["fed"]).to(device), backend)
        launches, shapes = dict(ops.LAUNCH_COUNTS), launch_shapes()
        same, _, _ = _st_serve(cfg, params, plan, torch.from_numpy(rows["tokens"]).to(device),
                               torch.from_numpy(rows["fed"]).to(device), backend,
                               forced=[quarter(e).to(device) for e in ref["experts"]])
        want = [w[mine_rows] for w in ref["logits"]]
        out["serve"][kv] = {"rel_l2_err_per_step": [_rel_l2(g, w) for g, w in zip(got, want)],
                            "same_experts_rel_l2_err_per_step": [_rel_l2(g, w) for g, w in zip(same, want)],
                            "finite": all(bool(torch.isfinite(g).all()) for g in got + same),
                            "launches": launches, "shapes": shapes, "cache": shape,
                            "plan": [plan.attn_mode, plan.ffn_mode, plan.kv_shard]}
        del params
        _free()
        mark(f"serve {kv}")

    # 5. the serving engine on the (2, 2) mesh
    out["sharded_data"] = sharded_data_rank(grid, device, small)

    # 4. the train launcher on the four ranks
    if launcher:
        from repro_torch.launch import train as launch_train

        hist = []
        with contextlib.redirect_stdout(sys.stderr):
            launch_train.main(["--steps", str(ST_LAUNCH_STEPS), "--device", device], history=hist)
        out["launcher"] = hist
        mark("launcher")
    out["steps_s"] = dict(STEP_S)
    return out


def _greedy(cfg, params, tokens, fed, device, backend):
    """Fill ``fed`` with the greedy tokens of ``params`` from ``tokens``
    (one rank): prefill, then each step fed the last step's argmax."""
    import torch

    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        lg, cache = prefill(params, cfg, {"tokens": tokens}, tokens.shape[1] + MAX_NEW + 1, backend=backend)
        for step in range(fed.shape[1]):
            fed[:, step] = lg.argmax(-1).cpu()
            lg, cache = decode_step(params, cfg, fed[:, step:step + 1].to(device), cache, backend=backend)
    return lg, cache


def _st_expect(cfg, kv: str, steps: int) -> dict:
    """A rank's exact launches in the 2-D serving run: flash once a layer
    in the prefill, the paged kernel once a layer a decode step over a
    heads-sharded cache (a seq cache decodes on the plain path, the
    reference's routing), the expert matmuls three times a layer a step."""
    L = cfg.num_layers
    out = {"flash_attention": L, "grouped_matmul": 3 * L * (1 + steps)}
    if kv == "heads":
        out["paged_attention"] = L * steps
    return out


SD_LAYERS = 4
SD_NEW = 8  # new tokens a request: 7 decode steps a batch
SD_ODD = 3  # the last static batch: three rows, which do not split over the data axis
SD_CONT = (8, 256, 192, 4, 16, 64)  # requests, prompt tokens, shared, slots, block, chunk
SD_RELAYOUTS = 2  # the re-plan traffic's two attention switches, each moving the live cache


def sd_requests(cfg):
    """The serve traffic's 8 requests (100-128 tokens, 2 rows a data rank
    in batches of 4), then its first 3 again: a batch of 3 rows."""
    p = prompts(cfg)
    return [(q, SD_NEW) for q in p + p[:SD_ODD]]


def sd_cont_requests(cfg):
    """The prefix-cache traffic: ``SD_CONT[0]`` prompts of ``SD_CONT[1]``
    tokens, the first ``SD_CONT[2]`` shared."""
    import numpy as np

    n, total, shared = SD_CONT[:3]
    rng = np.random.default_rng(SEED + 7)
    head = rng.integers(1, cfg.vocab_size, shared).tolist()
    return [(head + rng.integers(1, cfg.vocab_size, total - shared).tolist(), SD_NEW) for _ in range(n)]


def _sd_first_batch(cfg):
    """The engine's first static batch of ``sd_requests``, padded as its
    scheduler pads it (64-token bucket): (4, 128) token ids."""
    from repro_torch.serving.scheduler import ContinuousScheduler

    sch = ContinuousScheduler(max_batch=MAX_BATCH, bucket=64, coalesce_buckets=True)
    for q, g in sd_requests(cfg):
        sch.submit(q, g)
    return sch.pad_batch(sch.next_batch())[0]


# Each rank's launches in each sharded_data run, worked out from the traffic
# beforehand (L layers; a static batch is a prefill and SD_NEW - 1 = 7 decode
# steps; each MoE call launches the 3 expert matmuls once a capacity slab
# (``moe.pipeline_chunks``): 2 slabs in a bf16 EP prefill of a rank's 256
# tokens (2 rows of 128) or 96 (3 rows over data x ep), 4 at the float32
# run's capacity 11, 1 in a decode step, a 64-token chunk or under TP
# experts; resident experts add one dequant a matmul). On the CPU rehearsal
# (reduced widths, the plain path) they are not gated.
SD_LAUNCHES = {
    # batches of 4, 4, 3 rows at 1 layer: flash a prefill, paged a decode step
    "f32_tp2_ep2": {"flash_attention": 3, "paged_attention": 3 * 7, "grouped_matmul": 3 * 3 * (4 + 7)},
    "run_tp2_ep2": {"flash_attention": 3 * 4, "paged_attention": 3 * 7 * 4, "grouped_matmul": 3 * 3 * 4 * (2 + 7)},
    # 20 chunks (the first four prompts whole, 4 each; the last four after
    # their 192 shared tokens hit, 1 each) and 23 decode steps, 9 of them
    # fused with a chunk: paged a chunk, the prefix kernel a decode step
    "continuous_prefix": {"paged_attention": 20 * 4, "prefix_paged_attention": 23 * 4,
                          "grouped_matmul": 3 * 4 * (20 + 23)},
    # one batch of 4: an EP2 prefill, 7 TP2 decode steps, from INT4 experts
    "switch_int4_resident": {"flash_attention": 4, "paged_attention": 7 * 4, "grouped_matmul": 3 * 4 * (2 + 7),
                             "int4_dequant": 3 * 4 * (2 + 7)},
    # 5 chunks and 11 decode steps over the TP2 <-> DP2 re-plans
    "replan": {"paged_attention": (5 + 11) * 4, "grouped_matmul": 3 * 4 * (5 + 11)},
}


def _sd_steps(eng, toks, fed, forced=None, parts: int = 0, feed: bool = False) -> tuple:
    """The engine's own static steps, teacher-forced: the prefill of the
    padded batch ``toks`` (B, S) and a decode step per column of ``fed``
    (B, n), under the plan it activates for the batch as ``run()`` does:
    (this rank's rows' logits at every step on the host, the expert
    choices of each layer and step). ``feed``: fill ``fed`` with the greedy
    tokens as it goes (one card, every row); ``forced``, ``parts``: as
    ``_st_serve``'s."""
    import torch

    from repro_torch.core.flops import Workload

    B, S = toks.shape
    max_len = S + SD_NEW + 1
    seen = []
    split = _ep_halves(seen, n=parts) if parts else contextlib.nullcontext()
    with torch.inference_mode(), _routing(seen, forced), split:
        eng._activate_plan(Workload(batch=B, prompt=S, gen=SD_NEW))
        out = [eng._prefill_step(toks, max_len).float().cpu()]
        for step in range(fed.shape[1]):
            if feed:
                fed[:, step] = out[-1].argmax(-1).numpy()
            lg, _ = eng._decode_step_static(fed[:, step], S + step, max_len)
            out.append(lg.float().cpu())
    return out, [e.cpu() for e in seen]


# the plain path's dispatches of each kernel's seam (a CPU rehearsal's launches;
# its prefill attention is the model's own chunked path, which no seam counts)
SD_REF_SEAMS = {"paged_attention": ("decode.ref_paged", "decode.ref_append"),
                "prefix_paged_attention": ("decode.ref_prefix",), "int4_dequant": ("int4_dequant.ref",),
                "grouped_matmul": ("gmm.ref", "gmm.ref_shard_in", "gmm.ref_shard_out")}


def _sd_serve(eng, cfg, reqs, continuous: bool) -> dict:
    """Serve ``reqs`` on this rank's engine: tokens, times, the rank's
    launches (counts zeroed just before), launches by shape, collectives a
    step and the rank's KV bytes. On the card it raises if a ``ref`` op
    ran; on the CPU (the rehearsal, on the plain path) the launches are the
    dispatches of each kernel's seam."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request

    card = eng.device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    for q, g in reqs:
        eng.submit(Request(prompt=q, max_new_tokens=g))
    caches, end = [], eng._end_live_batch

    def end_live_batch():  # a live batch's cache, before the engine releases it
        if eng._live is not None:
            caches.append(_cache_bytes(eng._live.cache))
        end()

    eng._end_live_batch = end_live_batch
    calls = collections.Counter(eng.mesh.calls)
    sync()
    ops.reset_counts()
    t0 = time.perf_counter()
    comps = eng.serve_continuous() if continuous else eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches, dispatch, st = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS), eng.stats
    if card:
        refs = ref_ops(dispatch)
        if refs:
            raise AssertionError(f"sharded_data: ref ops ran on the path: {refs}")
        if cfg.dtype == "bfloat16":
            check_variants("sharded_data", launches)
    else:
        launches = {k: sum(dispatch.get(d, 0) for d in seams) for k, seams in SD_REF_SEAMS.items()}
    no_fallback("sharded_data", dataclasses.asdict(st))
    steps = st.decode_steps if continuous else st.batches * SD_NEW  # a static batch: a prefill, 7 decode steps
    done = collections.Counter(eng.mesh.calls)
    done.subtract(calls)
    res = {"wall_s": wall, "tokens_per_s": sum(len(c.tokens) for c in comps) / wall, "launches": launches,
           "shapes": launch_shapes(),
           "tokens": [c.tokens for c in comps], "transition_ms_total": st.transition_ms_total,
           "collectives_per_step": {k: n / steps for k, n in done.items() if n},
           "kv": _cache_bytes(eng._static[1]) if eng._static is not None else caches[-1] if caches else {}}
    if continuous:
        res.update(decode_steps=st.decode_steps, fused_steps=st.fused_steps, prefill_chunks=st.prefill_chunks,
                   decode_step_ms_mean=st.decode_step_ms_sum / max(st.decode_steps, 1),
                   prefix_hit_blocks=st.prefix_hit_blocks, plan_switches=st.plan_switches,
                   relayouts=len(eng.kv_relayout_ms), relayout_ms=list(eng.kv_relayout_ms))
    else:
        first = comps[::MAX_BATCH]
        res.update(batches=st.batches, prefill_ms=[c.prefill_ms for c in first],
                   decode_ms_per_step=[c.decode_ms / (SD_NEW - 1) for c in first])
    return res


SD_MAX_LEN = 128 + SD_NEW + 1  # the static cache of a batch of the serve traffic: 128-token bucket, 8 new
SD_DRYRUN_TIMEOUT_S = 300


def _payload_key(key) -> str:
    return f"{key[0]}/{key[1]}"


def _sd_decode_reading(grid, cfg, params, device: str, backend: str) -> dict:
    """One ``decode_step`` (the function the dry run traces) of this rank's
    rows of the static batch under the TP2/EP2 decode plan, on its shard of
    the weights and a fresh cache of ``SD_MAX_LEN`` positions: the bytes
    the rank holds, its collective calls and payload bytes in the step, and
    the card's peak allocation over it (``max_memory_allocated``, a reading:
    the caching allocator's pools make it a different quantity)."""
    import torch

    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.params import torch_dtype
    from repro_torch.sharding.specs import serving_rows
    from repro_torch.training.tree import tree_leaves

    plan, lo, hi = serving_rows(_hap(("TP2", "EP2", "", "reshard")).to_sharding_plan(grid, cfg, phase="decode"),
                                MAX_BATCH)
    cache = init_cache(cfg, hi - lo, SD_MAX_LEN, dtype=torch_dtype(cfg.dtype), device=device, plan=plan)
    token = torch.zeros((hi - lo, 1), dtype=torch.int32, device=device)
    card = device == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    calls, payload = collections.Counter(grid.calls), collections.Counter(grid.payload)
    with torch.inference_mode():
        decode_step(params, cfg, token, cache, backend=backend, plan=plan)
    if card:
        torch.cuda.synchronize()
    calls, payload = collections.Counter(grid.calls) - calls, collections.Counter(grid.payload) - payload
    return {"rows": hi - lo, "params_bytes": sum(t.nbytes for t in tree_leaves(params)),
            "kv_bytes": cache.k.nbytes + cache.v.nbytes, "calls": dict(calls),
            "payload": {_payload_key(k): v for k, v in payload.items()},
            "max_memory_allocated": torch.cuda.max_memory_allocated() if card else None}


def sd_dryrun_main(small: bool) -> None:
    """The dry run of ``_sd_decode_reading``'s step for each rank of a fake
    (2, 2) group, printed as one JSON line. It runs in a process of its own
    (the dry run makes its own default group), on fake tensors: no card."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh, release_fake_mesh

    cfg = _st_config(SD_LAYERS if not small else 2, "float32" if small else "bfloat16", small)
    out = []
    for rank in range(4):
        mesh = make_fake_mesh(2, 2, rank)
        plan = _hap(("TP2", "EP2", "", "reshard")).to_sharding_plan(mesh, cfg, phase="decode")
        res = dryrun.trace(cfg, SD_MAX_LEN, MAX_BATCH, "decode", mesh, plan)
        cache = res.step.args[2]
        out.append({"rows": res.step.rows, "params_bytes": res.step.arg_bytes["params"],
                    "kv_bytes": cache.k.nbytes + cache.v.nbytes, "calls": res.calls,
                    "payload": {_payload_key(k): v for k, v in res.payload.items()}, "args_bytes": res.args,
                    "temps_bytes": res.temps, "kernels": res.kernels, "trace_s": res.seconds})
    release_fake_mesh()
    print(json.dumps(out))


def start_sd_dryrun(small: bool):
    """Start ``sd_dryrun_main`` in a process of its own, with no card (the
    dry run needs none, and without one it starts no CUDA context) and one
    host thread; it needs nothing of the ranks, so it runs beside the
    phases before them."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH")])))
    return subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.sd_dryrun_main({small})"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _sd_dryrun_gate(ranks, card: str, dry) -> list:
    """The dry run (``dry``: the process ``start_sd_dryrun`` started)
    against each rank's ``decode_reading``: rows, parameter and KV bytes,
    collective calls and payload bytes exact. Returns the failures."""
    t0 = time.perf_counter()
    stdout, stderr = dry.communicate(timeout=SD_DRYRUN_TIMEOUT_S)
    if dry.returncode != 0:
        return [f"sharded_data dry run: exit {dry.returncode}: {stderr[-2000:]}"]
    traced = json.loads(stdout.strip().splitlines()[-1])
    fails = []
    keys = ("rows", "params_bytes", "kv_bytes", "calls", "payload")
    for rank, (r, t) in enumerate(zip((r["sharded_data"]["decode_reading"] for r in ranks), traced)):
        exact = {k: r[k] == t[k] for k in keys}
        emit({"phase": "sharded_data", "step": "dryrun", "card": card, "rank": rank, "exact": exact,
              **{f"measured_{k}": r[k] for k in keys}, **{f"traced_{k}": t[k] for k in keys},
              "traced_args_plus_temps_bytes": t["args_bytes"] + t["temps_bytes"],
              "measured_max_memory_allocated": r["max_memory_allocated"], "traced_kernels": t["kernels"],
              "trace_s": t["trace_s"]})
        if not all(exact.values()):
            fails.append(f"sharded_data dry run rank {rank}: {exact}")
    emit({"phase": "sharded_data", "step": "dryrun", "waited_s": time.perf_counter() - t0, "background": True})
    return fails


def sharded_data_rank(grid, device: str, small: bool) -> dict:
    """The sharded_data phase on one of the four ranks of
    ``sharded_train_rank`` (``grid`` the (2, 2) ``RankMesh``): float32 at 1
    layer against one card's engine, then the bf16 runs at ``SD_LAYERS``
    layers, each rank from its TP2/EP2 shard of the seeded weights."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import HAPSession
    from repro_torch.models import init_params

    me, t_start = grid.index, time.perf_counter()
    backend = "hopper" if device == "cuda" else "ref"
    out = {"runs": {}}

    def engine(cfg, params, plan, **kw):
        session = HAPSession(cfg, "h100", 4, source=plan if not isinstance(plan, tuple) else _hap(plan), mesh=grid,
                             prompt_bucket=64)
        session.transition_between = lambda old, new, w: ("reshard", 0.0)  # Eq. 6 pinned: no model to fit
        return session.engine(params, device=device, capture_steps=False, kernel_backend=backend, **kw)

    def draw(cfg, plan):
        splan = _hap(plan).to_sharding_plan(grid, cfg, phase="prefill")
        return init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device, shard=(splan, grid.coords))

    def one_card(cfg):  # rank 0 alone: one card's engine on the whole seeded weights
        from repro_torch.core import fixed_plan

        params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
        return HAPSession(cfg, "h100", 1, source=fixed_plan("TP1", "TP1"), prompt_bucket=64).engine(
            params, device=device, max_batch=MAX_BATCH, capture_steps=False, kernel_backend=backend)

    # 1. float32, 1 layer, nothing dropped, no aux: the one card's engine, then (2, 2)
    tp2_ep2 = ("TP2", "EP2", "", "reshard")
    cfg = _st_config(1, "float32", small, **ST_F32)
    one = [None]
    if me == 0:
        from repro_torch.serving import Request

        eng = one_card(cfg)
        for q, g in sd_requests(cfg):
            eng.submit(Request(prompt=q, max_new_tokens=g))
        one[0] = [c.tokens for c in eng.run()]
        eng.close()
        del eng
        _free()
    dist.broadcast_object_list(one, src=0)
    eng = engine(cfg, draw(cfg, tp2_ep2), tp2_ep2, max_batch=MAX_BATCH)
    run = _sd_serve(eng, cfg, sd_requests(cfg), False)
    run["one_card_tokens"] = one[0]
    out["runs"]["f32_tp2_ep2"] = run
    eng.close()
    del eng
    _free()
    mark("sd f32")

    # 2. bf16 at SD_LAYERS layers, teacher-forced on the first batch through
    # the engines' own steps: one card's, routing in quarters (the function
    # EP over data x ep computes), fed its greedy tokens; then each rank's
    # rows on (2, 2), with their own routing and with one card's choices
    cfg = _st_config(SD_LAYERS if not small else 2, "float32" if small else "bfloat16", small)
    toks = _sd_first_batch(cfg)
    ref = [None]
    if me == 0:
        eng = one_card(cfg)
        fed = np.zeros((toks.shape[0], SD_NEW - 1), dtype=np.int64)
        logits, seen = _sd_steps(eng, toks, fed, parts=4, feed=True)
        ref[0] = {"logits": logits, "experts": seen, "fed": fed}
        eng.close()
        del eng
        _free()
    dist.broadcast_object_list(ref, src=0)
    ref = ref[0]
    params = draw(cfg, tp2_ep2)

    def quarter(e):  # this rank's share of a layer's routed tokens (EP over data x model)
        k = e.shape[0] // 4
        return e[grid.index * k:(grid.index + 1) * k]

    eng = engine(cfg, params, tp2_ep2, max_batch=MAX_BATCH)
    got, _ = _sd_steps(eng, toks, ref["fed"])
    _, lo, hi = eng._rows("decode", toks.shape[0])
    cache_rows = eng._static[1].k.shape[1]
    same, _ = _sd_steps(eng, toks, ref["fed"], forced=[quarter(e).to(device) for e in ref["experts"]])
    eng.close()
    del eng
    want = [w[lo:hi] for w in ref["logits"]]
    out["teacher_forced"] = {"rows": [lo, hi], "cache_rows": cache_rows,
                             "rel_l2_err_per_step": [_rel_l2(g, w) for g, w in zip(got, want)],
                             "same_experts_rel_l2_err_per_step": [_rel_l2(g, w) for g, w in zip(same, want)],
                             "finite": all(bool(torch.isfinite(g).all()) for g in got + same)}
    del got, same
    _free()
    mark("sd teacher_forced")

    out["decode_reading"] = _sd_decode_reading(grid, cfg, params, device, backend)

    # the engine runs: run() TP2/EP2, the prefix-cache continuous traffic,
    # the switching INT4 plan from resident experts, then the re-plan
    # traffic, whose engine takes the weights (its attention leaves move)
    eng = engine(cfg, params, tp2_ep2, max_batch=MAX_BATCH)
    out["runs"]["run_tp2_ep2"] = _sd_serve(eng, cfg, sd_requests(cfg), False)
    eng.close()
    del eng
    _free()
    mark("sd run_tp2_ep2")
    n, _, _, slots, block, chunk = SD_CONT
    eng = engine(cfg, params, tp2_ep2, max_batch=slots, kv_block_size=block, prefill_chunk=chunk, prefix_cache=True)
    out["runs"]["continuous_prefix"] = _sd_serve(eng, cfg, sd_cont_requests(cfg), True)
    eng.close()
    del eng
    _free()
    mark("sd continuous_prefix")
    switch = ("TP2", "EP2", "TP2", "int4_upload")
    eng = engine(cfg, params, switch, max_batch=MAX_BATCH, use_int4_transition=True, resident_int4=True,
                 params_plan=_hap(tp2_ep2).to_sharding_plan(grid, cfg, phase="prefill"))
    out["runs"]["switch_int4_resident"] = _sd_serve(eng, cfg, sd_requests(cfg)[:MAX_BATCH], False)
    eng.close()
    del eng
    _free()
    mark("sd switch_int4_resident")
    eng = engine(cfg, params, ReplanSource(), max_batch=REPLAN_MAX_BATCH,
                 params_plan=_hap(tp2_ep2).to_sharding_plan(grid, cfg, phase="prefill"))
    del params
    out["runs"]["replan"] = _sd_serve(eng, cfg, replan_requests(cfg), True)
    eng.close()
    del eng
    _free()
    mark("sd replan")
    out["seconds"] = time.perf_counter() - t_start
    return out


def _sd_gates(ranks, card: str, small: bool) -> tuple:
    """The sharded_data phase's lines and failures from the four ranks'
    results: tokens equal on every rank (and in float32 to one card's),
    teacher-forced rows and logits within the sharded bounds, every rank's
    launches equal to ``SD_LAUNCHES`` (on the card). Returns (failures,
    {run: per-rank launches}, {kernel: {shape: {run: per-rank launches}}})."""
    fails, launches, shapes = [], {}, {}
    per = [r["sharded_data"] for r in ranks]
    for name, run in per[0]["runs"].items():
        runs = [p["runs"][name] for p in per]
        key = f"sharded_data_{name}"
        launches[key] = [r["launches"] for r in runs]
        for r in runs:
            for kernel, by_shape in r["shapes"].items():
                for shape, k in by_shape.items():
                    shapes.setdefault(kernel, {}).setdefault(shape, {}).setdefault(key, []).append(k)
        equal = all(r["tokens"] == run["tokens"] for r in runs)
        exact = None if small else all({k: v for k, v in r["launches"].items() if v} == SD_LAUNCHES[name] for r in runs)
        res = {"phase": "sharded_data", "run": name, "card": card, "ranks_tokens_equal": equal,
               "launches_exact": exact, "launches_per_rank": [r["launches"] for r in runs],
               "expect": SD_LAUNCHES[name],
               **{k: v for k, v in run.items() if k not in ("tokens", "launches", "shapes", "one_card_tokens")},
               "wall_s_per_rank": [r["wall_s"] for r in runs]}
        if "one_card_tokens" in run:
            res["one_card_tokens_equal"] = run["tokens"] == run["one_card_tokens"]
            equal = equal and res["one_card_tokens_equal"]
        emit(res)
        if not equal or exact is False:
            fails.append(f"sharded_data {name}: tokens equal {equal}, launches exact {exact}")
        if name == "replan" and (run["plan_switches"] != SD_RELAYOUTS or run["relayouts"] != SD_RELAYOUTS):
            fails.append(f"sharded_data replan: {run['plan_switches']} switches, {run['relayouts']} relayouts")
    tf = [p["teacher_forced"] for p in per]
    worst = max(max(t["rel_l2_err_per_step"]) for t in tf)
    worst_same = max(max(t["same_experts_rel_l2_err_per_step"]) for t in tf)
    rows = [t["rows"] for t in tf]
    cache_rows = [t["cache_rows"] for t in tf]
    emit({"phase": "sharded_data", "step": "teacher_forced", "card": card, "rows_per_rank": rows,
          "cache_rows_per_rank": cache_rows, "rel_l2_err_worst": worst, "same_experts_rel_l2_err_worst": worst_same,
          "tol": [AGREE_TOL[0], AGREE_SAME_EXPERTS_TOL]})
    # the (2, 2) ranks in group order: data rank 0 holds rows [0, 2) of the batch of 4, data rank 1 [2, 4)
    if rows != [[0, 2], [0, 2], [2, 4], [2, 4]] or cache_rows != [2] * 4:
        fails.append(f"sharded_data teacher-forced: rows {rows}, cache rows {cache_rows}")
    if not small and (not all(t["finite"] for t in tf) or worst > AGREE_TOL[0] or worst_same > AGREE_SAME_EXPERTS_TOL):
        fails.append(f"sharded_data teacher-forced: {worst}, same experts {worst_same}")
    emit({"phase": "sharded_data", "seconds": per[0]["seconds"]})
    return fails, launches, shapes


def phase_sharded_train(small: bool = False, dry=None) -> dict:
    """Training on a (data, model) mesh of four gloo ranks on the card
    (``sharded_train_rank``): float32 against one rank, the bf16 layouts'
    step times, memory and collectives, the 2-D prefill and decode against
    one rank with exact launches, the train launcher against one rank; the
    sharded_data dry run read from ``dry`` (``start_sd_dryrun``; started
    here if None). Returns {"launches": {run: per-rank launches}, "shapes":
    {kernel: {shape: {run: per-rank launches}}}}."""
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.sharding.launch import spawn

    if dry is None:
        dry = start_sd_dryrun(small)
    device = "cpu" if small else "cuda"
    card = card_line() if not small else "cpu"
    one = []
    with contextlib.redirect_stdout(sys.stderr):  # the one-rank launcher, before the ranks start
        launch_train.main(["--steps", str(ST_LAUNCH_STEPS), "--device", device], history=one)
    _free()
    mark("launcher one rank")
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:sharded_train_rank", 4, backend="gloo", args={"device": device, "small": small},
                  timeout=SHARDED_TRAIN_TIMEOUT_S, pythonpath=(ROOT,),
                  env={"OMP_NUM_THREADS": "1"} if small else None)
    seconds = time.perf_counter() - t0
    mark("four ranks")
    r0 = ranks[0]
    fails = []

    # 1. float32 against one rank
    o, f = r0["f32_one_rank"], r0["f32_2x2"]
    loss = [_rel(a["loss"], b["loss"]) for a, b in zip(f["history"], o["history"])]
    gnorm = [_rel(a["grad_norm"], b["grad_norm"]) for a, b in zip(f["history"], o["history"])]
    worst = max(f["params_rel_l2"].items(), key=lambda kv: kv[1])
    res = {"phase": "sharded_train", "step": "float32", "card": card, "layers": ST_LAYERS, "batch": ST_B,
           "seq": 16 if small else ST_S, "steps": ST_STEPS, "plan": f["plan"], "config": ST_F32, "loss_rel_err": loss,
           "grad_norm_rel_err": gnorm, "params_worst_rel_l2": worst, "tol": ST_F32_TOL,
           "one_rank_peak_bytes": o["peak_bytes"], "peak_bytes_per_rank": [r["f32_2x2"]["peak_bytes"] for r in ranks],
           "one_rank_ms_per_step": [h["seconds"] * 1e3 for h in o["history"]],
           "ms_per_step": [h["seconds"] * 1e3 for h in f["history"]], "collectives_per_step": f["collectives_per_step"]}
    emit(res)
    if max(loss) > ST_F32_TOL["loss"] or max(gnorm) > ST_F32_TOL["grad_norm"] or worst[1] > ST_F32_TOL["params"]:
        fails.append(f"float32: {res}")

    # 2. bf16 layouts
    for name in ST_LAYOUTS:
        per = [r["bf16"].get(name) for r in ranks]
        got = [p for p in per if p is not None]
        hist = got[0]["history"]
        res = {"phase": "sharded_train", "step": "bf16", "layout": name, "card": card, "ranks": len(got),
               "plan": got[0]["plan"], "loss": [h["loss"] for h in hist],
               "ms_per_step_after_first": sum(h["seconds"] for h in hist[1:]) / (len(hist) - 1) * 1e3,
               "first_step_ms": hist[0]["seconds"] * 1e3, "peak_bytes_per_rank": [p["peak_bytes"] for p in got],
               "collectives_per_step": got[0]["collectives_per_step"], "launches": got[0]["launches"]}
        emit(res)
        finite = all(math.isfinite(h[k]) for p in got for h in p["history"] for k in ("loss", "grad_norm"))
        same = all(p["history"][i]["loss"] == hist[i]["loss"] for p in got for i in range(len(hist)))
        if not finite or not same or sum(got[0]["launches"].values()):
            fails.append(f"bf16 {name}: finite {finite}, ranks agree {same}, launches {got[0]['launches']}")

    # 3. the 2-D prefill + decode
    cfg = _st_config(ST_SERVE_LAYERS if not small else 2, "bfloat16", small)
    launches, shapes = {}, {}
    for kv in ST_CACHES:
        per = [r["serve"][kv] for r in ranks]
        run = f"sharded_train_{kv}"
        launches[run] = [p["launches"] for p in per]
        for p in per:
            for kernel, by_shape in p["shapes"].items():
                for shape, n in by_shape.items():
                    shapes.setdefault(kernel, {}).setdefault(shape, {}).setdefault(run, []).append(n)
        worst = max(max(p["rel_l2_err_per_step"]) for p in per)
        worst_same = max(max(p["same_experts_rel_l2_err_per_step"]) for p in per)
        expect = _st_expect(cfg, kv, MAX_NEW - 1)
        res = {"phase": "sharded_train", "step": "serve", "cache": kv, "card": card, "layers": cfg.num_layers,
               "batch": ST_SERVE_B, "prompt": ST_SERVE_S, "decode_steps": MAX_NEW - 1, "plan": per[0]["plan"],
               "cache_shape_per_rank": per[0]["cache"], "rel_l2_err_worst": worst,
               "same_experts_rel_l2_err_worst": worst_same, "tol": [AGREE_TOL[0], AGREE_SAME_EXPERTS_TOL],
               "launches_per_rank": [{k: p["launches"].get(k, 0) for k in expect} for p in per], "expect": expect}
        emit(res)
        if small:
            continue
        exact = all({k: p["launches"].get(k, 0) for k in set(expect) | set(p["launches"])} ==
                    {**{k: 0 for k in p["launches"]}, **expect} for p in per)
        if not all(p["finite"] for p in per) or worst > AGREE_TOL[0] or worst_same > AGREE_SAME_EXPERTS_TOL \
                or not exact:
            fails.append(f"serve {kv}: {res}")

    # 5. the serving engine on (2, 2)
    sd_fails, sd_launches, sd_shapes = _sd_gates(ranks, card, small)
    fails += sd_fails + _sd_dryrun_gate(ranks, card, dry)
    launches.update(sd_launches)
    for kernel, by_shape in sd_shapes.items():
        for shape, per_run in by_shape.items():
            shapes.setdefault(kernel, {}).setdefault(shape, {}).update(per_run)

    # 4. the launcher on four ranks against one
    four = r0["launcher"]
    err = max(_rel(a["loss"], b["loss"]) for a, b in zip(four, one))
    res = {"phase": "sharded_train", "step": "launcher", "card": card, "steps": ST_LAUNCH_STEPS,
           "loss_one_rank": [h["loss"] for h in one], "loss_four_ranks": [h["loss"] for h in four],
           "loss_rel_err": err, "tol": ST_F32_TOL["loss"]}
    emit(res)
    if err > ST_F32_TOL["loss"] or len(four) != ST_LAUNCH_STEPS:
        fails.append(f"launcher: {res}")
    emit({"phase": "sharded_train", "seconds": seconds, "rank0_steps_s": r0["steps_s"]})
    if fails:
        raise AssertionError("sharded_train: " + "; ".join(fails))
    _free()
    return {"launches": launches, "shapes": shapes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from repro_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: run from the root of a repro checkout ({e})", file=sys.stderr)
        return 1

    cfg = get_config("deepseek-moe-16b")
    seconds = {}

    start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        reset_marks()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase_done": name, "seconds": seconds[name], "elapsed_s": time.perf_counter() - start,
              **({"steps_s": dict(STEP_S)} if STEP_S else {})})
        return out

    fit = start_latency_fit()  # the launcher phase's latency model, fitted meanwhile on a host core
    dry = start_sd_dryrun(False)  # the sharded_data part's dry run, traced meanwhile on a host core
    try:
        return _phases(cfg, seconds, timed, fit, dry)
    finally:
        for proc in (fit[0], dry):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _phases(cfg, seconds, timed, fit, dry) -> int:
    import torch

    from repro_torch.models import init_params

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "params": sum(t.numel() for t in _leaves(params)), "bytes": torch.cuda.memory_allocated()})
    serve = timed("serve", phase_serve, cfg, params, "serve", SERVE_AB_ORDER)
    timed("agree", phase_agree, cfg, params, serve)
    cont = timed("continuous", phase_continuous, cfg, params)
    contig = timed("contiguous", phase_contiguous, cfg, params, cont["plain_tokens"])
    # the sharded phase's one-card references at its depth, before the
    # resident phase rewrites the expert leaves (the ranks draw pristine ones)
    cut = dataclasses.replace(cfg, num_layers=SHARDED_REF_LAYERS)
    agree_ref = timed("sharded_reference", sharded_reference, cut, _first_layers_of(params, SHARDED_REF_LAYERS))
    replan = timed("replan_reference", replan_references, cut, _first_layers_of(params, SHARDED_REF_LAYERS))
    # the resident phase overwrites the expert leaves with their INT4 round trip
    resident = timed("resident", phase_resident, cfg, params)
    trans = timed("transitions", phase_transitions, cfg, params)
    # the replication phase doctors the router of these weights in place, and puts it back
    repl_shapes = {}
    repl = timed("replication", phase_replication, cfg, params, trans, repl_shapes)
    robust_shapes = {}
    robust = timed("robustness", phase_robustness, dataclasses.replace(cfg, num_layers=ROBUST_LAYERS),
                   _first_layers_of(params, ROBUST_LAYERS), robust_shapes)
    del params  # DeepSeek's weights, before the families' own
    families = timed("families", phase_families)
    ssm = timed("ssm", phase_ssm)
    vlm = timed("vlm", phase_vlm)
    train = timed("train", phase_train)
    # late enough that the latency model's fit, started first, has landed
    # (~250-320 s on one host core); DeepSeek's seeded weights drawn anew
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    launcher = timed("launcher", phase_launcher, cfg, params, fit)
    del params
    _free()
    sharded = timed("sharded", phase_sharded, serve, cont, agree_ref, repl, replan)
    strain = timed("sharded_train", phase_sharded_train, False, dry)
    for kernel, by_shape in strain["shapes"].items():  # its 2-D runs' shapes get kernel rows too
        for shape, per_run in by_shape.items():
            sharded["shapes"].setdefault(kernel, {}).setdefault(shape, {}).update(per_run)
    timed("sharded_kernels", sharded_kernel_rows, cfg, rows, sharded["shapes"])
    timed("replication_kernels", replication_kernel_rows, cfg, rows, repl_shapes)
    timed("robustness_kernels", robustness_kernel_rows, cfg, rows, robust_shapes)
    # the contiguous fallback's captured run (DeepSeek), the mamba
    # families' captured run() and contiguous continuous run, and LLaVA's
    # two image prompts, by shape
    timed("path_kernels", path_kernel_rows, rows,
          [("launches_contiguous", f"{cfg.name} contiguous", cfg.name, contig["shapes"])]
          + [("launches_ssm", run, m, sh) for m, fam in ssm.items() for run, sh in fam.items()]
          + [("launches_vlm", f"{VLM_MODEL} image prompts", VLM_MODEL, vlm["shapes"])]
          + [("launches_launcher", f"{cfg.name} launcher {run}", cfg.name, sh)
             for run, sh in launcher["shapes"].items()]
          + sharded["ssm_shapes"])
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
        # the robustness phase: its overcommitted captured run, the prefix
        # cache's run, the resident session's run with no fault
        r["launches_robustness"] = {run: n.get(r["name"], 0) for run, n in robust["launches_by_run"].items()}
        if r["name"] == "prefix_paged_attention":
            r["launches"] = r["launches_continuous"]
        if r["name"] == "int4_dequant":
            r["launches"] = r["launches_resident"]
        # the families' paths: each model's captured run() and prefix-cache
        # continuous run; a row at a family's shape names its model
        r["launches_families"] = {m: {k: n.get(r["name"], 0) for k, n in fam.items()} for m, fam in families.items()}
        # the sharded phase's runs, per rank, and the one NCCL rank's captured run
        r["launches_sharded"] = {run: [n.get(r["name"], 0) for n in per_rank]
                                 for run, per_rank in sharded["launches"].items()}
        r["launches_sharded_nccl"] = sharded["nccl"].get(r["name"], 0)
        # the (2, 2) mesh's model-level prefill and decode, per rank, by cache layout
        r["launches_sharded_train"] = {run: [n.get(r["name"], 0) for n in per_rank]
                                       for run, per_rank in strain["launches"].items()}
        # LLaVA's image prompts (their rows carry them by shape), and the
        # train phase's runs, which launch no hand kernel (training pins ref)
        r["launches_vlm"] = vlm["launches"].get(r["name"], 0)
        # the serve launcher's two runs (``python -m repro_torch.launch.serve --full``)
        r["launches_launcher"] = {run: n.get(r["name"], 0) for run, n in launcher["launches"].items()}
        r["launches_train"] = train["launches"].get(r["name"], 0)
        for row in r.get("also", []):
            if row.get("model") in families:
                row["launches_families"] = r["launches_families"][row["model"]]
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    sys.exit(main())
