"""Serving launcher: adaptive HAP-planned inference over the scheduler (the
port of ``repro.launch.serve``).

Demonstrates the ``HAPSession`` loop end to end: requests from two
workload buckets (short-prompt and long-prompt) drain as separate
batches; the engine re-plans per batch through the session's plan cache
and logs the Eq.-6 transition at the bucket boundary.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 6 --batch 3 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --full --chip h100 --kernel-backend hopper

``--source`` swaps the strategy source: the ILP planner (default), the
static TP/EP baselines, or a pinned plan via --plan
"attn=TP4,prefill=EP4,decode=TP4". ``--continuous`` serves the same trace
through the continuous-batching loop (decode-time joins, DESIGN.md §4b),
re-planning at admission on the live workload bucket; ``--prefix-cache``
(continuous only) shares prompt-prefix KV blocks (DESIGN.md §4d). The
plan, the predicted speedup and the counters print as the reference's do;
plan decisions log on the ``repro_torch.session`` and
``repro_torch.serving`` loggers.

Four differences from the reference:

- ``--kernel-backend auto|ref|hopper``: ``hopper`` launches the
  hand-written sm_90a kernels, ``ref`` the plain PyTorch versions, ``auto``
  follows the device (``repro_torch.kernels.ops.resolve_backend``);
- ``--device``: the card unless ``--device cpu`` (no silent fallback);
- ``--full`` executes the full config at its own dtype; without it the
  reduced config runs in float32, as the reference runs it;
- ``main(argv=None, params=None)`` returns ``(completions, engine)``, and
  ``params`` serves the caller's weights (on the device, of the executed
  config) in place of ``init_params`` from seed 0.

As in the reference, the session has no mesh: every plan executes on one
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import HAPSession, Workload
from repro_torch.core.latency import cached_latency_model
from repro_torch.core.session import round_up
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import Request


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--chip", default="a6000")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--source", default="ilp", choices=["ilp", "tp", "ep", "fixed"])
    ap.add_argument("--plan", default="",
                    help='pinned plan, e.g. "attn=TP4,prefill=EP4,decode=TP4" (implies --source fixed)')
    ap.add_argument("--prompt-bucket", type=int, default=64, help="padding/planning bucket for prompt lengths")
    ap.add_argument("--uniform", action="store_true",
                    help="single workload bucket (disable the mixed short/long demo)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (decode-time joins) instead of lockstep static batches")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous: chunked-prefill size in tokens (0 = one chunk per prompt bucket)")
    ap.add_argument("--kv-block-size", type=int, default=16, help="continuous: paged KV block size in tokens")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="continuous: paged KV pool size in blocks (0 = worst-case auto-size). Undersized "
                         "pools raise actionable OutOfBlocks naming this flag")
    ap.add_argument("--kv-overcommit", type=float, default=0.0,
                    help="continuous: optimistic admission — charge only this fraction of the output budget "
                         "at admission (0 = off, worst-case reservation). Overflow is covered by "
                         "preemption-by-recompute (DESIGN.md §4f); outputs stay token-exact under greedy")
    ap.add_argument("--max-preemptions", type=int, default=3,
                    help="continuous: per-request preemption cap before a request stops being victim-eligible")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline in ms from submission (0 = none); expired requests retire "
                         "with status='deadline' at the next step boundary")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous: share prompt-prefix KV blocks across requests (refcounted, "
                         "copy-on-write; admission charges the post-sharing block need — DESIGN.md §4d)")
    ap.add_argument("--kernel-backend", default="auto", choices=["auto", "ref", "hopper"],
                    help="serving kernel backend: prefill flash, decode attention, grouped expert matmuls "
                         "and INT4 dequant (hopper: the hand-written sm_90a kernels; ref: the plain "
                         "PyTorch versions; auto follows the device: hopper on CUDA, ref on the CPU)")
    ap.add_argument("--resident-int4", action="store_true",
                    help="serve the expert FFN weights as resident INT4 (packed nibbles + per-group "
                         "scales stay on the device; every expert matmul dequantizes first — DESIGN.md §5b)")
    ap.add_argument("--replicate-experts", type=int, default=0,
                    help="extra hot-expert replica budget for online replication (0 = off); replicas are "
                         "granted by routing frequency and rebalanced through the Eq.-6 transition path")
    ap.add_argument("--rebalance-interval", type=int, default=32, help="decode steps between replication re-plans")
    ap.add_argument("--prefetch", action="store_true",
                    help="predictive expert prefetch: pull the predicted next batch of expert weights "
                         "(per-(layer,expert) INT4 restore rows) on the background worker during decode "
                         "windows, so restore barriers consume staged rows (DESIGN.md §5c)")
    ap.add_argument("--prefetch-top-p", type=float, default=0.5,
                    help="predictor mass: per layer, prefetch the smallest set of experts covering this "
                         "predicted routing probability")
    ap.add_argument("--moe-pipeline", type=int, default=0,
                    help="EP micro-batch pipeline depth K (0 = auto from capacity, 1 = serial)")
    ap.add_argument("--no-async-transitions", action="store_true",
                    help="block on INT4 expert restores instead of running them on the background worker "
                         "overlapped with prefill")
    ap.add_argument("--full", action="store_true",
                    help="execute the full config at its own dtype (default: the reduced config in float32)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None, params=None):
    """Parse ``argv`` (the command line when None), plan, serve the mixed
    trace and print the report; returns ``(completions, engine)``."""
    ap = parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    full_cfg = get_config(args.arch)
    if args.source == "fixed" and not args.plan:
        ap.error("--source fixed requires --plan")
    source = args.plan if args.plan else (None if args.source == "ilp" else args.source)
    session = HAPSession(full_cfg, args.chip, args.devices, source=source, model=cached_latency_model(args.chip),
                         prompt_bucket=args.prompt_bucket, gen_bucket=max(args.gen, 1))

    # headline prediction for the long-bucket workload actually served
    w = Workload(batch=max(args.batch, 1), prompt=round_up(long_hi(args), args.prompt_bucket), gen=args.gen)
    plan = session.plan_for(w)
    print(f"HAP: {plan.describe()}")
    t_tp = session.planner.evaluate(session.planner.tp_plan(), w)
    t_hap = session.planner.evaluate(plan, w)
    print(f"predicted speedup vs static TP: {t_tp / t_hap:.2f}x (ILP {plan.ilp_time*1e3:.0f} ms)")

    cfg = full_cfg if args.full else dataclasses.replace(full_cfg.reduced(), dtype="float32")
    device = resolve_device(args.device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    if args.prefix_cache and not args.continuous:
        ap.error("--prefix-cache requires --continuous (paged serving)")
    if args.kv_overcommit and not args.continuous:
        ap.error("--kv-overcommit requires --continuous (paged serving)")
    engine = build_engine(session, params, cfg, args, device)
    for req in trace(args, cfg.vocab_size):
        engine.submit(req)
    done = engine.serve_continuous() if args.continuous else engine.run()
    report(engine, done, args)
    return done, engine


def build_engine(session, params, cfg, args, device):
    """The session's engine with the flags' options."""
    return session.engine(params, cfg=cfg, max_batch=args.batch, device=device,
                          kv_block_size=args.kv_block_size,
                          kv_blocks=args.kv_blocks or None,
                          kv_overcommit=args.kv_overcommit or None,
                          max_preemptions=args.max_preemptions,
                          prefill_chunk=args.prefill_chunk or None,
                          prefix_cache=args.prefix_cache,
                          resident_int4=args.resident_int4,
                          replicate_experts=args.replicate_experts,
                          rebalance_interval=args.rebalance_interval,
                          prefetch=args.prefetch,
                          prefetch_top_p=args.prefetch_top_p,
                          moe_pipeline=args.moe_pipeline,
                          async_transitions=not args.no_async_transitions,
                          kernel_backend=None if args.kernel_backend == "auto" else args.kernel_backend)


def long_hi(args) -> int:
    """The long prompts' upper length: capped at --prompt-len, floored at
    one bucket + 1 so that a second bucket always exists."""
    return min(args.prompt_bucket * 4, max(args.prompt_bucket + 1, args.prompt_len))


def trace(args, vocab_size: int) -> List[Request]:
    """The mixed trace: the first half of the requests short prompts, the
    second half long ones, two buckets, so the engine re-plans at the
    boundary (``--uniform``: all short). Long lengths are drawn from
    ``long_hi``'s own bucket only (no straddle when --prompt-len is not a
    bucket multiple), from ``np.random.default_rng(0)`` as the reference
    draws them."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(args.requests):
        long_req = (not args.uniform) and i >= args.requests // 2
        hi = long_hi(args) if long_req else args.prompt_bucket
        lo = max(1, (hi - 1) // args.prompt_bucket * args.prompt_bucket + 1)
        n = int(rng.integers(lo, hi + 1))
        out.append(Request(prompt=rng.integers(1, vocab_size, n).tolist(), max_new_tokens=args.gen,
                           deadline_ms=args.deadline_ms or None))
    return out


def report(engine, done, args) -> None:
    """The reference launcher's lines, in its order."""
    total_tok = sum(len(c.tokens) for c in done)
    st = engine.stats
    if args.continuous:
        print(f"served {len(done)} requests, {total_tok} tokens: "
              f"{st.joins} joins over {st.decode_steps} decode steps, "
              f"{st.prefill_chunks} prefill chunks ({st.fused_steps} "
              f"fused; {st.batches} live-batch generations)")
        if args.prefix_cache:
            print(f"prefix cache: {st.prefix_hit_blocks} blocks / "
                  f"{st.prefix_hit_tokens} tokens adopted, "
                  f"{st.cow_copies} COW forks, effective block need "
                  f"{st.effective_block_need} vs raw {st.raw_block_need}")
    else:
        print(f"served {len(done)} requests, {total_tok} tokens in {st.batches} batches")
    if args.kv_overcommit:
        print(f"optimistic admission: {st.preemptions} preemptions "
              f"({st.preempted_tokens} tokens recomputed, "
              f"{st.prefix_evictions_on_pressure} prefix evictions under "
              f"pressure)")
    terminal = st.cancelled + st.deadline_expired
    if terminal:
        print(f"lifecycle: {st.cancelled} cancelled, {st.deadline_expired} deadline-expired")
    if st.background_errors or st.planner_fallbacks:
        print(f"degraded paths: {st.background_errors} background errors "
              f"({st.prefetch_errors} prefetch, {st.restore_errors} "
              f"restore, {st.replication_search_errors} replication "
              f"search), {st.planner_fallbacks} planner fallbacks")
    print(f"plan changes: {st.replans} (strategy switches "
          f"{st.plan_switches}, cache hits {st.cache_hits}), "
          f"transition total {st.transition_ms_total:.1f} ms")
    if st.async_restores:
        print(f"async restore: {st.async_restores} kicked, "
              f"{st.restore_overlap_ms:.1f} ms overlapped prefill, "
              f"{st.restore_wait_ms:.1f} ms exposed at the barrier")
    if args.resident_int4:
        print(f"resident INT4 experts: {st.resident_bytes_saved / 2**20:.2f} MiB residency freed")
    if args.prefetch:
        print(f"expert prefetch: {st.prefetch_predicted} rows predicted, "
              f"{st.prefetch_hits} hit / {st.prefetch_misses} missed at "
              f"restore barriers, {st.prefetch_bytes / 2**20:.2f} MiB "
              f"pulled ({st.prefetch_hidden_ms:.1f} ms hidden, "
              f"{st.prefetch_exposed_ms:.1f} ms exposed)")
    if args.replicate_experts:
        rep = engine._replication
        print(f"expert replication: {st.replication_rebalances} rebalances "
              f"over {st.routing_steps} tracked steps, degrees "
              f"{rep.degrees if rep is not None else 'uniform'}")


if __name__ == "__main__":
    main()
