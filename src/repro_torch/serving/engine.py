"""Inference engine (the port of ``repro.serving.engine.InferenceEngine``).
Two serving loops share it (DESIGN.md §4/§4b):

  ``run()``              static batching: the scheduler left-pads a batch to
                         its prompt bucket, ``prefill`` primes a contiguous
                         KV cache and a greedy ``decode_step`` loop decodes
                         the batch in lockstep until every request stops.
  ``serve_continuous()`` continuous batching over a paged KV pool: queued
                         requests join at step boundaries (``admit``), each
                         iteration runs one step (``step``: the head
                         joiner's next prefill chunk, fused with a decode
                         step over the full slot set when rows are live),
                         and finished rows free their blocks (``retire``).
                         With ``paged=False`` (the default for models with
                         mamba layers, whose state has no paged layout) it
                         is the contiguous fallback: every slot holds a
                         KV capacity of its own, a joiner is prefilled
                         whole at admission (B=1, at its own prompt
                         bucket) and its cache rows, K/V and mamba state,
                         are merged into its slot of the live cache; each
                         step is then a decode step over every slot.

Continuous KV memory is a shared block pool (``kv_cache``): admission
reserves each request's worst-case block need, blocks materialise as chunks
land and decode advances, and go back at retirement. Prompts are prefilled
in ``prefill_chunk``-token chunks through ``decode_step``. With
``prefix_cache=True`` a joiner adopts the blocks of a registered prompt
prefix (``prefix_cache``), skips their chunks, forks a shared block
copy-on-write before its first write into it, and every decode step runs
the prefix kernel, which reads each shared page once per group.

Each step kind runs through the step cache (``step_cache``, the
counterpart of the reference's compiled-step cache): one ``StepGraph`` per
(kind, plan, shape class), whose body reads static device buffers. Host
state (tokens, positions, block tables, the prefix grouping) lives in
numpy and is fed into those buffers by one copy each from pinned host
memory before the step; the only sync of a step reads back the sampled
tokens. On the card (``capture_steps``, the default there) each step is
captured into a CUDA graph after its first, eager run and replayed from
then on; the graph ends at the logits and sampling runs after it. On the
CPU the same bodies run eagerly from the same buffers.

Bound to a ``HAPSession`` (or given a pinned ``hap_plan``) the engine
follows the plan: each static batch, and each continuous admission,
re-buckets its workload through the session, and where the plan's expert
layouts differ the Eq.-6 transition moves the expert weights, by the
INT4 restore from pinned host backups (``TransitionExecutor``) when the
mechanism is ``int4_upload``, else by a reshard. On one device every layout
is the identity, so a switching plan exercises the INT4 round trip alone.
With
``async_transitions`` the decode-layout restore is kicked onto a
background worker (its own CUDA stream) when the plan is decided, and
``transition_expert_layout`` is the barrier. ``resident_int4`` makes INT4
the serving format: the expert leaves stay packed on the card and every
expert matmul dequantizes its weight with ``int4_dequant`` first.

On a mesh (a ``HAPSession`` whose ``mesh`` is a ``RankMesh``) every rank
runs one engine over its shards of the weights (``params``, laid out by
``params_plan``: the pinned plan's prefill layout by default) and of the
KV cache, each step under the plan's ``ShardingPlan`` for its phase. Every
rank runs the same schedule, which is a deterministic function of the
requests; after each step the ranks all-gather their sampled tokens and
the engine raises if they differ. A plan switch moves the leaves whose
layout changes: the expert leaves by the Eq.-6 mechanism (a reshard moves
slices between the ranks, an INT4 restore uploads each rank's target shard
from the whole-leaf host backup), the attention leaves by a reshard, and
a live KV cache whose layout changes (heads, seq or whole) moves with the
mesh's collectives (``_relayout_live``). A static ``plan`` (a
``ShardingPlan`` over a ``RankMesh``) is served with no session. Mamba and
hybrid models run their mixer tensor-parallel over d_inner. Data-parallel
mesh axes of size > 1 raise (ROADMAP A.9).

With ``replicate_experts`` or ``prefetch`` a routing tracker follows the
router's top-k ids, which every decode step returns through a static
buffer read back with the step's tokens (``serving.replication``).
Replication: every ``rebalance_interval`` tracked steps the hot experts get
replica slots, a new replica set and so a new plan; the expert leaves are
laid out in its slots then, once (``TransitionExecutor.reslot``; an EP rank
fetches each slot's expert from the rank that holds it), and every step
graph is captured anew. The INT4 backups stay in expert layout: a restore
lands expert rows, which are then laid out in slots. Prefetch: the
predicted experts' (layer, expert) rows of the INT4 backups are staged on
the device by the executor's worker while decode runs, and a restore
barrier uploads only the rows that missed (DESIGN.md §5b/§5c).

Robustness (DESIGN.md §4f): with ``kv_overcommit`` admission charges a
request's expected KV need, not its worst case, and when growth then runs
the pool dry the engine evicts a cache-only prefix entry or preempts a
victim row, whose generated tokens are stashed and replayed as extra
prompt when it is admitted again (preemption-by-recompute). A request's
``deadline_ms`` and ``cancel(uid)`` retire it at the next step boundary
with its partial output. ``faults`` threads a ``FaultInjector`` through
the allocator, the transition executor and the session, so each
degraded path (preemption, the sync restore failover, the restore
watchdog, a failed prefetch row, the static-plan fallback) can be forced
and is counted. On a mesh rank 0 decides which requests expire or are
cancelled and whether the restore watchdog tripped, and every rank
follows it, so the ranks never part ways at a collective.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no ``device`` it raises rather than fall back. The kernel
backend follows ``repro_torch.kernels.ops.resolve_backend``: ``hopper`` on
the card, ``ref`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.flops import Workload
from repro_torch.core.hap import HAPPlan
from repro_torch.core.quantization import pick_group_size
from repro_torch.core.transition import TransitionExecutor
from repro_torch.device import resolve_device
from repro_torch.models import DecodeCache, decode_step, init_cache, init_paged_cache, merge_cache_rows, prefill
from repro_torch.models.attention import cache_layout
from repro_torch.models.moe import serving_replication
from repro_torch.models.params import param_pspecs, param_shapes
from repro_torch.models.transformer import not_ported as _not_ported
from repro_torch.sharding.specs import NULL_PLAN, ExpertReplication, seq_positions, sharded_dim, unported_layout

from .faults import FaultInjector
from .kv_cache import TRASH_BLOCK, BlockAllocator, BlockTable, OutOfBlocks, blocks_for
from .prefix_cache import PrefixCache
from .replication import NextLayerPredictor, RoutingTracker, plan_replication, replication_summary
from .sampling import SamplingParams, sample
from .scheduler import ContinuousScheduler, QueuedRequest, round_up
from .step_cache import StepCache, StepGraph

log = logging.getLogger("repro_torch.serving")

_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def relayout_kv(t: torch.Tensor, src: str, dst: str, cfg: ModelConfig, mesh, total: Optional[int] = None
                ) -> torch.Tensor:
    """A rank's K or V cache, (L, B|N, S, H, hd), from layout ``src`` to
    ``dst`` (``attention.cache_layout``: "heads", "seq" or "none"), with
    the mesh's collectives. ``total`` is a contiguous cache's whole length
    (``seq`` holds ``ceil(total / n)`` positions a rank). heads <-> seq is
    one all-to-all; to "none" an all-gather; from "none" a narrow."""
    if src == dst:
        return t
    n, r = mesh.size, mesh.rank
    if src == "heads" and dst == "seq":
        P = seq_positions(total, n)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n * P - t.shape[2]))
        return mesh.all_to_all(t, split=2, concat=3)
    if src == "seq" and dst == "heads":
        return mesh.all_to_all(t, split=3, concat=2)[:, :, :total].contiguous()
    if src == "heads":
        return mesh.all_gather(t, dim=3)
    if src == "seq":
        return mesh.all_gather(t, dim=2)[:, :, :total].contiguous()
    if dst == "heads":
        h = cfg.num_kv_heads // n
        return t[:, :, :, r * h:(r + 1) * h].contiguous()
    P = seq_positions(total, n)
    t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n * P - t.shape[2]))
    return t[:, :, r * P:(r + 1) * P].contiguous()


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 32
    # wall-clock budget (ms from submission) for the continuous loop: an
    # expired request retires with status "deadline" at the next step
    # boundary. None = no deadline.
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    # static: the request's batch, host clock after a sync; continuous: the
    # request's own unfused prefill chunks, and the decode steps it took
    prefill_ms: float
    decode_ms: float
    transition_ms: float  # Eq.-6 expert moves booked to this request's batch or admission
    # terminal status: "ok" (EOS / budget), "cancelled" (engine.cancel),
    # "deadline" (deadline_ms expired); a non-ok completion carries the
    # tokens generated before the request was retired
    status: str = "ok"
    preemptions: int = 0  # times this request was preempted and recomputed


@dataclasses.dataclass
class EngineStats:
    batches: int = 0  # static batches / continuous live-batch generations
    replans: int = 0  # batches whose active plan changed (the source ran only on cache misses)
    plan_switches: int = 0  # plan changes whose strategies differed
    cache_hits: int = 0
    transition_ms_total: float = 0.0
    last_transition_ms: float = 0.0
    joins: int = 0  # continuous: requests admitted mid-stream
    decode_steps: int = 0  # continuous: decode steps executed
    prefill_chunks: int = 0  # continuous: prefill chunks processed
    fused_steps: int = 0  # continuous: chunk+decode fused iterations
    # prefix-cache accounting (DESIGN.md §4d; zeros with the cache off):
    prefix_hit_blocks: int = 0  # KV blocks adopted instead of recomputed
    prefix_hit_tokens: int = 0  # prefill positions skipped via sharing
    cow_copies: int = 0  # shared blocks forked at first write
    raw_block_need: int = 0  # sum of unshared worst-case admission needs
    effective_block_need: int = 0  # sum of post-sharing admission charges
    # resident-INT4 + online replication (DESIGN.md §5b):
    resident_bytes_saved: int = 0  # dense-minus-packed expert residency delta
    routing_steps: int = 0  # decode steps whose router top-k fed the tracker
    replication_rebalances: int = 0  # replica-set changes applied online
    # async INT4 restore (overlap accounting; zeros with it off):
    async_restores: int = 0  # background restores kicked at decision time
    restore_wait_ms: float = 0.0  # residual barrier wait (the exposed cost)
    restore_overlap_ms: float = 0.0  # kick->barrier window hidden by prefill
    # predictive expert prefetch (DESIGN.md §5c; zeros with it off):
    prefetch_predicted: int = 0  # (layer, expert) rows submitted for pull
    prefetch_hits: int = 0  # staged rows consumed at a restore barrier
    prefetch_misses: int = 0  # rows a barrier restored synchronously
    prefetch_bytes: int = 0  # host bytes pulled by background tasks
    prefetch_hidden_ms: float = 0.0  # pull time spent off the critical path
    prefetch_exposed_ms: float = 0.0  # consume-side restore time still paid
    # request lifecycle + robustness (DESIGN.md §4f; zeros when idle):
    preemptions: int = 0  # victims preempted to reclaim KV blocks
    preempted_tokens: int = 0  # generated tokens stashed for replay
    prefix_evictions_on_pressure: int = 0  # cache blocks evicted mid-stream
    cancelled: int = 0  # requests retired via cancel()
    deadline_expired: int = 0  # requests retired past deadline_ms
    planner_fallbacks: int = 0  # solves degraded to the static plan
    background_errors: int = 0  # background failures, all sites
    prefetch_errors: int = 0  # _prefetch_pull rows that failed
    restore_errors: int = 0  # async restores failed or timed out
    replication_search_errors: int = 0  # searched-degree solves that failed
    # the port's own (the JAX engine has no such counters):
    prefix_grouped_steps: int = 0  # decode steps where a row read its shared run through another's table
    decode_step_ms_sum: float = 0.0  # host clock of the decode steps, fused ones included
    decode_step_ms_max: float = 0.0
    reshard_bytes: int = 0  # weight bytes a reshard received from other ranks (a mesh only)


@dataclasses.dataclass
class _Slot:
    """Per-request in-flight state (one live batch row)."""

    req: QueuedRequest
    start: int  # padded prompt length = first decode position
    table: Optional[BlockTable] = None  # paged only
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False  # decode-sampled EOS seen
    prefill_ms: float = 0.0
    transition_ms: float = 0.0
    decode_ms: float = 0.0
    pending: List[np.ndarray] = dataclasses.field(default_factory=list)
    filled: int = 0  # prompt tokens in the cache (starts past an adopted prefix)
    # the host table mirror holds this row's blocks: False until its first
    # chunk, so that until then the row joins no prefix group and the fused
    # decode half's dead writes land in the trash block, never a shared page
    mirrored: bool = False

    @property
    def prefilling(self) -> bool:
        return bool(self.pending)


@dataclasses.dataclass
class _LiveBatch:
    """The in-flight set: per-slot state, the KV cache and its host mirrors
    (``pos`` per row, ``tables`` trash-padded), fed into the step's buffers
    before every step so drained rows stay frozen. Paged: the block pool,
    its allocator and tables. Contiguous: a (nslots, kv_capacity) cache and
    ``sub``, the B=1 cache a joiner is prefilled into before its rows are
    merged into its slot."""

    kv_capacity: int  # logical per-row KV length (tokens)
    slots: List[Optional[_Slot]]
    cache: DecodeCache
    pos: np.ndarray  # (nslots,) int32
    next_tok: np.ndarray  # (nslots,) int32
    allocator: Optional[BlockAllocator] = None
    max_blocks: int = 0  # block-table width
    tables: Optional[np.ndarray] = None  # (nslots, max_blocks) int32
    prefix: Optional[PrefixCache] = None  # prompt-prefix index over the pool
    sub: Optional[DecodeCache] = None  # contiguous only
    layout: str = "none"  # what this rank's cache holds (``attention.cache_layout``)

    def active(self) -> List[int]:
        """Rows decoding this step: admitted, prefill complete, not done."""
        return [i for i, s in enumerate(self.slots) if s is not None and not s.done and not s.prefilling]

    def prefilling(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None and s.prefilling]


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        plan=None,
        session=None,
        hap_plan: Optional[HAPPlan] = None,
        max_batch: int = 8,
        use_int4_transition: Optional[bool] = None,
        eos_id: int = -1,
        paged: Optional[bool] = None,
        kv_block_size: int = 16,
        kv_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        kernel_backend: Optional[str] = None,
        resident_int4: bool = False,
        int4_group_size: Optional[int] = None,
        async_transitions: bool = True,
        restore_timeout_s: float = 30.0,
        device=None,
        kv_overcommit: Optional[float] = None,
        max_preemptions: int = 3,
        faults: Optional[FaultInjector] = None,
        replicate_experts: int = 0,
        rebalance_interval: int = 32,
        routing_ema: float = 0.9,
        prefetch: bool = False,
        prefetch_top_p: float = 0.5,
        capture_steps: Optional[bool] = None,
        moe_pipeline: int = 0,
        params_plan=None,
    ):
        if cfg.is_encoder_only or cfg.frontend != "none":
            # the reference's engine prefills {"tokens": ...} only: a vision
            # prompt fails there on its missing patches, an encoder-only
            # model at prefill's assert
            kind = "an encoder-only model" if cfg.is_encoder_only else f"a model with {cfg.frontend} inputs"
            raise ValueError(f"{cfg.name}: the engine serves token prompts of decoder models, not {kind}; run it "
                             "through repro_torch.models (prefill + decode_step, or loss_and_aux)")
        # a static ShardingPlan (the mesh layout) served with no session
        self.plan = plan
        if session is not None and session.mesh is not None:
            self.mesh = session.mesh
        else:
            self.mesh = plan.mesh if plan is not None else None
        if self.mesh is not None:
            big = [a for a in self.mesh.axis_names if a != "model" and self.mesh.shape[a] > 1]
            if big:
                raise _not_ported(f"a mesh with data-parallel axes {big} of size > 1", "A.9")
            if not hasattr(self.mesh, "rank"):
                raise TypeError(f"the port serves on a repro_torch.sharding.RankMesh, got {type(self.mesh).__name__}")
        self.device = resolve_device(device)
        # step capture: None means on for the card, off for the CPU; False on
        # the card is the eager A/B (the same bodies and buffers, op by op)
        capturable = self.mesh is None or self.mesh.capturable
        if capture_steps is None:
            capture_steps = self.device.type == "cuda" and capturable
        if capture_steps and self.device.type != "cuda":
            raise ValueError(f"capture_steps=True captures CUDA graphs; the engine runs on {self.device}")
        if capture_steps and not capturable:
            raise ValueError(f"capture_steps=True captures CUDA graphs, and the mesh's {self.mesh.backend} group's "
                             "collectives (staged through the host) cannot be captured; serve on an NCCL group, "
                             "or pass capture_steps=False")
        self.steps = StepCache(self.device, capture_steps)
        self._static: Optional[Tuple[tuple, DecodeCache, str]] = None  # ((B, max_len), its contiguous cache, its layout)
        self.cfg = cfg
        self.params = params
        self.session = session  # HAPSession (adaptive mode) or None
        self.hap_plan = hap_plan  # active HAPPlan (pinned, or per-batch)
        self.moe_pipeline = int(moe_pipeline)
        self._specs: Dict[Any, Dict[str, Any]] = {}
        # the layout the params are in (None: one device)
        self._layout = None
        if self.mesh is not None:
            if params_plan is None and session is None:
                params_plan = plan
            if params_plan is None:
                pinned = hap_plan or getattr(session.source, "plan", None)
                if pinned is None:
                    raise ValueError("on a mesh, pass params_plan: the ShardingPlan the params are laid out in")
                params_plan = pinned.to_sharding_plan(self.mesh, cfg, phase="prefill")
            self._layout = self._checked(params_plan)
        self.eos_id = eos_id
        self.kernel_backend = kernel_backend
        bucket = session.prompt_bucket if session is not None else 64
        self.scheduler = ContinuousScheduler(max_batch=max_batch, bucket=bucket, coalesce_buckets=session is not None)
        self.stats = EngineStats()
        # paged KV + chunked prefill for serve_continuous: attention-only
        # families (mamba state has no paged layout or chunked append); the
        # others serve through the contiguous fallback
        can_page = cfg.has_attention and not cfg.has_mamba
        self.paged = can_page if paged is None else bool(paged)
        if self.paged and not can_page:
            raise ValueError("paged KV serving requires an attention-only model")
        if kv_block_size < 1:
            raise ValueError("kv_block_size must be positive")
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires the paged KV path")
        self.kv_block_size = kv_block_size
        self.kv_blocks = kv_blocks  # pool size override (blocks, sans trash)
        self.prefill_chunk = prefill_chunk  # None => one chunk per bucket
        self.prefix_caching = bool(prefix_cache)
        self._live: Optional[_LiveBatch] = None
        self.kv_relayout_ms: List[float] = []  # each live-cache relayout's ms (a mesh only)
        self.kv_pool_blocks = 0  # the newest generation's pool, trash block excluded
        # False until a batch has executed under hap_plan: a pre-seeded plan
        # counts as the *initial* plan, not as a previous batch's layout
        self._plan_ran = False
        self.use_int4_transition = use_int4_transition
        self._tx = TransitionExecutor(self.device)
        # optimistic admission: the fraction of the output budget charged at
        # admission (None = the worst case); preemption-by-recompute covers
        # the overflow, so it needs the paged path (DESIGN.md §4f)
        if kv_overcommit is not None and not 0.0 < kv_overcommit <= 1.0:
            raise ValueError("kv_overcommit must be in (0, 1] or None")
        if kv_overcommit is not None and not self.paged:
            raise ValueError("kv_overcommit requires the paged KV path")
        self.kv_overcommit = kv_overcommit
        self.max_preemptions = max(int(max_preemptions), 1)
        # deterministic fault injection through every degradation surface
        # (allocator, restore worker, prefetch pull, planner)
        self.faults = faults
        self._tx.faults = faults
        if session is not None and faults is not None:
            session.faults = faults
        # injectable monotonic clock (tests drive deadlines synthetically)
        self.clock = time.monotonic
        # terminal completions (cancelled, expired, or preempted with no
        # budget left) buffered between lifecycle sweeps; retire() drains them
        self._finished: List[Completion] = []
        # async INT4 restore: kicked onto the executor's worker (and its own
        # CUDA stream) when the plan is decided, so it overlaps the batch's
        # prefill; transition_expert_layout() is the barrier
        self.async_transitions = bool(async_transitions)
        self.restore_timeout_s = float(restore_timeout_s)
        self._pending_restore: Optional[tuple] = None
        self.resident_int4 = bool(resident_int4)
        self.int4_group_size = int4_group_size
        if self.resident_int4 and not cfg.is_moe:
            raise ValueError("resident_int4 requires an MoE config")
        # online hot-expert replication: track router frequencies and grant
        # up to `replicate_experts` extra replicas to the hot experts every
        # `rebalance_interval` tracked decode steps
        self.replicate_experts = int(replicate_experts)
        if self.replicate_experts < 0:
            raise ValueError("replicate_experts must be >= 0")
        if self.replicate_experts and not cfg.is_moe:
            raise ValueError("expert replication requires an MoE config")
        self.rebalance_interval = max(int(rebalance_interval), 1)
        # predictive expert prefetch (DESIGN.md §5c): stage the predicted
        # experts' INT4 restore rows on the device from the background
        # worker while decode steps run, so restore barriers only pay for
        # the missed rows. Needs the routing tracker even without replication.
        self.prefetch = bool(prefetch)
        if self.prefetch and not cfg.is_moe:
            raise ValueError("prefetch requires an MoE config")
        self.prefetch_top_p = float(prefetch_top_p)
        self._tracker: Optional[RoutingTracker] = (
            RoutingTracker(cfg.num_layers, cfg.n_routed_experts, ema=routing_ema)
            if self.replicate_experts or self.prefetch else None
        )
        self._predictor: Optional[NextLayerPredictor] = (
            NextLayerPredictor(cfg.num_layers, cfg.n_routed_experts, top_p=self.prefetch_top_p)
            if self.prefetch else None
        )
        # staging: (layer*E) row -> {leaf: StagedRow on the device}, filled
        # by the background worker, consumed (whole rows only, never torn)
        # at the next restore barrier; rows not in the current predicted
        # window are evicted at issue time
        self._prefetch_stage: Dict[int, Dict[str, Any]] = {}
        self._prefetch_live: set = set()
        self._prefetch_lock = threading.Lock()
        # rebalance cadence is steps-since-last-rebalance, not an exact
        # multiple of the tracker's step count
        self._last_rebalance_step = 0
        self._last_workload: Optional[Workload] = None
        self._replication: Optional[ExpertReplication] = None  # the live replica set
        self._slots: Optional[ExpertReplication] = None  # the replica set the expert leaves are laid out in
        if self.resident_int4 and self._expert_leaves():
            # the structured backups double as the transition backups (the
            # reference first makes flat ones, which these then replace)
            self._make_experts_resident()
        elif use_int4_transition and cfg.is_moe:
            self._backup_experts()

    # -- transition machinery ---------------------------------------------
    def _expert_leaves(self) -> Dict[str, Any]:
        moe = self.params["layers"].get("moe")
        if moe is None:
            return {}
        return {k: moe[k] for k in _EXPERT_LEAVES}

    def _set_expert_leaves(self, leaves: Dict[str, Any]) -> None:
        """Install new expert leaves in a shallow copy of the params tree
        (the caller's dict is left as it was). The leaves are new tensors,
        so every step graph, which reads the old ones, is dropped."""
        moe = dict(self.params["layers"]["moe"], **leaves)
        self.params = dict(self.params, layers=dict(self.params["layers"], moe=moe))
        self.steps.new_weights()

    # -- layouts on a mesh ---------------------------------------------------
    def _checked(self, plan):
        """``plan`` with the engine's EP pipeline knob, or a named error for
        what the port cannot execute yet."""
        if plan is None:
            return None
        why = unported_layout(plan)
        if why is not None:
            raise _not_ported(f"serving {why}", "A.9")
        if self.moe_pipeline and plan.moe_pipeline != self.moe_pipeline:
            plan = dataclasses.replace(plan, moe_pipeline=self.moe_pipeline)
        return plan

    def _sharding_for(self, phase: str):
        """The execution layout of ``phase``: the active HAP plan's on a
        session's mesh, else the static ``plan`` (None on one device; the
        params' layout on a mesh before a plan is active), with the live
        replica set folded in: a replica set is part of the plan, so
        changing it is a plan change (on one device a null plan then
        carries it)."""
        if self.mesh is None:
            return self._with_replication(None)
        if self.hap_plan is not None and self.session is not None:
            return self._with_replication(
                self._checked(self.hap_plan.to_sharding_plan(self.mesh, self.cfg, phase=phase)))
        return self._with_replication(self._checked(self.plan) if self.plan is not None else self._layout)

    def _with_replication(self, plan):
        base = plan if plan is not None else NULL_PLAN
        if base.replication == self._replication:
            return plan
        return dataclasses.replace(base, replication=self._replication)

    def _leaf_specs(self, plan) -> Dict[str, Any]:
        """The specs of the leaves that plans move: ``attn/*`` and
        ``moe/*`` (the expert leaves) under ``plan``."""
        key = dataclasses.replace(plan, moe_pipeline=0)
        if key not in self._specs:
            layers = param_pspecs(self.cfg, plan)["layers"]
            self._specs[key] = {f"{g}/{k}": v for g in ("attn", "moe") for k, v in layers.get(g, {}).items()}
        return self._specs[key]

    def _shard_of(self, plan, key: str):
        """``(spec, rank, sizes)``: this rank's shard of leaf ``key`` under
        ``plan`` (None on one device)."""
        if plan is None or self.mesh is None:
            return None
        return self._leaf_specs(plan)[key], self.mesh.rank, dict(self.mesh.shape)

    def _gather(self, key: str, w):
        """The whole layer ``l`` of leaf ``key`` from every rank's shard
        under the current layout (None on one device, or when it is whole)."""
        if self._layout is None:
            return None
        a = sharded_dim(self._leaf_specs(self._layout)[key])
        if a is None:
            return None
        return lambda layer: self.mesh.all_gather(w[layer], dim=a - 1)

    def _same_layout(self, a, b) -> bool:
        return a is None or b is None or self._leaf_specs(a) == self._leaf_specs(b)

    def _backup_experts(self) -> None:
        for name in _EXPERT_LEAVES:
            self._backup_leaf(name)

    def _backup_leaf(self, name: str) -> None:
        """The flat INT4 backup of expert leaf ``name``, taken in expert
        layout: from a slot layout, each expert from its first replica."""
        key = f"moe/{name}"
        w = self._reslot(self.params["layers"]["moe"][name], self._slots, None, self._layout)
        self._tx.backup(key, w, gather=self._gather(key, w))

    # -- slot layouts (hot-expert replication) ------------------------------
    def _reslot(self, w, src: Optional[ExpertReplication], dst: Optional[ExpertReplication], plan):
        """Expert leaf ``w`` from the slot layout of ``src`` to that of
        ``dst`` (None: expert layout) under ``plan``'s sharding; the bytes
        received from other ranks count as reshard bytes."""
        if src == dst:
            return w
        E = self.cfg.n_routed_experts
        src_map = src.slot_to_expert() if src is not None else tuple(range(E))
        dst_map = dst.slot_to_expert() if dst is not None else tuple(range(E))
        sharded = self.mesh is not None and plan is not None and sharded_dim(
            self._leaf_specs(plan)["moe/wi_gate"]) == 1
        out, nbytes = self._tx.reslot(w, src_map, dst_map, self.mesh if sharded else None)
        self.stats.reshard_bytes += nbytes
        return out

    def _install_slots(self, rep: Optional[ExpertReplication], plan) -> None:
        """Lay every expert leaf out in ``rep``'s slots (None: expert
        layout) under ``plan``'s sharding, one leaf at a time."""
        if rep == self._slots:
            return
        for name in _EXPERT_LEAVES:
            new = self._reslot(self.params["layers"]["moe"][name], self._slots, rep, plan)
            self._set_expert_leaves({name: new})
            del new
        self._slots = rep

    def _make_experts_resident(self) -> None:
        """Flip the expert FFN leaves to resident ``QuantizedExpert``s: the
        dense weights are quantized once into structured host backups (which
        the transitions re-upload; on a mesh, of the whole leaf), the packed
        leaves of this rank's shard replace the dense ones on the device, and
        every expert matmul dequantizes its weight."""
        saved = 0
        leaves = {}
        for name, w in self._expert_leaves().items():
            key = f"moe/{name}"
            full = param_shapes(self.cfg)["layers"]["moe"][name]
            gs = pick_group_size(int(full[-1]), self.int4_group_size or 128)
            self._tx.backup_packed(key, w, gs, gather=self._gather(key, w))
            leaves[name] = self._tx.restore_packed(key, shard=self._shard_of(self._layout, key))
            saved += w.nbytes - leaves[name].nbytes
        self._set_expert_leaves(leaves)
        self.stats.resident_bytes_saved = int(saved)
        log.info("resident INT4 experts: %.2f MiB dense -> packed residency freed", saved / 2**20)

    def _restore_leaf_with_stage(self, name: str, dtype=None, target=None):
        """One expert leaf from its INT4 backup, this rank's shard under
        ``target`` in expert layout: packed under residency, else
        dequantized into ``dtype``. With prefetch on it consumes the staged
        rows, and only the rows the predictor missed are uploaded; the
        values are the plain restore's either way."""
        key = f"moe/{name}"
        shard = self._shard_of(target, key)
        n_rows = self._tx.prefetch_rows_of(key) if self.prefetch else None
        if n_rows is None:
            kw = {} if shard is None else {"shard": shard}
            if self.resident_int4:
                return self._tx.restore_packed(key, **kw)
            return self._tx.restore(key, dtype=dtype, **kw)
        staged = self._prefetch_snapshot(name, n_rows)
        if self.resident_int4:
            return self._tx.restore_packed_with_rows(key, staged, shard=shard)
        return self._tx.restore_with_rows(key, staged, dtype=dtype, shard=shard)

    def _sync_restore_leaf(self, name: str, dtype=None, target=None):
        """Barrier-path leaf restore: the time spent here is prefetch's
        exposed cost (what the hidden pulls failed to cover)."""
        t0 = time.perf_counter()
        out = self._restore_leaf_with_stage(name, dtype, target)
        self._sync()  # the leaf has landed, with prefetch on and off alike
        if self.prefetch:
            self.stats.prefetch_exposed_ms += (time.perf_counter() - t0) * 1e3
        return out

    def _relayout_experts(self, mechanism: str, target=None) -> float:
        """Move the weights to ``target``'s layout; returns ms. The expert
        leaves move by ``mechanism``: ``int4_upload`` restores the INT4
        backups (resident leaves stay packed through it), ``reshard`` moves
        slices between the ranks (the identity on one device). On a mesh the
        attention leaves whose layout changes move by a reshard. The expert
        leaves end in the slot layout of ``target``'s replica set (a
        reshard moves them in expert layout). Each leaf is installed as it
        lands, so the old and the new layout are resident together for one
        leaf at a time."""
        moe = self.cfg.is_moe and bool(self._expert_leaves())
        moves = self.mesh is not None and not self._same_layout(self._layout, target)
        if not moe and not moves:
            return 0.0
        # a sync relayout supersedes an in-flight background restore: drain
        # it (never install) so leaves cannot tear across layouts
        self._drop_pending_restore()
        t0 = time.perf_counter()
        if moves:
            self._reshard_group("attn", target)
        slots = serving_replication(target)
        if moe and mechanism == "int4_upload":
            for name in _EXPERT_LEAVES:
                if not self.resident_int4 and f"moe/{name}" not in self._tx._backups:
                    self._backup_leaf(name)
                dtype = None if self.resident_int4 else self.params["layers"]["moe"][name].dtype
                restored = self._sync_restore_leaf(name, dtype, target)
                self._set_expert_leaves({name: self._reslot(restored, None, slots, target)})
                del restored
            self._slots = slots
        elif moe and moves:
            self._install_slots(None, self._layout)
            self._reshard_group("moe", target)
            self._install_slots(slots, target)
        elif moe:
            self._install_slots(slots, target)
        if self.mesh is not None:
            self._layout = target
        self._sync()
        return (time.perf_counter() - t0) * 1e3

    def _reshard_group(self, group: str, target) -> None:
        """Reshard every leaf of ``layers[group]`` whose spec differs
        between the current layout and ``target``, installing each as it
        lands; counts the bytes received."""
        old, new = self._leaf_specs(self._layout), self._leaf_specs(target)
        shapes = param_shapes(self.cfg)["layers"][group]
        for name in list(self.params["layers"][group]):
            key = f"{group}/{name}"
            if key not in old or old[key] == new[key]:
                continue
            moved, nbytes = self._tx.reshard(self.params["layers"][group][name], old[key], new[key], self.mesh,
                                             shape=shapes[name])
            self.stats.reshard_bytes += nbytes
            if group == "moe":
                self._set_expert_leaves({name: moved})
            else:
                tree = dict(self.params["layers"][group], **{name: moved})
                self.params = dict(self.params, layers=dict(self.params["layers"], **{group: tree}))
                self.steps.new_weights()
            del moved

    def _plan_mechanism(self) -> str:
        """INT4 vs reshard for the active plan's phase switch.
        ``use_int4_transition`` None follows the plan's Eq.-6 choice;
        True/False force the mechanism (False: no lossy INT4 round trip)."""
        if self.use_int4_transition is None:
            return "int4_upload" if self.hap_plan.mechanism == "int4_upload" else "reshard"
        return "int4_upload" if self.use_int4_transition else "reshard"

    # -- async INT4 restore (overlap with prefill) ------------------------
    def _drop_pending_restore(self) -> None:
        """Drain an in-flight background restore without installing it; a
        future that failed or stalls past the watchdog is counted and
        abandoned."""
        if self._pending_restore is None:
            return
        futures = self._pending_restore[2]
        self._pending_restore = None
        for f in futures.values():
            try:
                f.result(timeout=self.restore_timeout_s)
            except Exception:
                log.exception("dropped background restore failed")
                self.stats.restore_errors += 1
                self.stats.background_errors += 1

    def _begin_async_restore(self, phase: str = "decode") -> None:
        """Kick the INT4 expert restore for ``phase`` onto the background
        worker when the active plan switches expert layouts by
        ``int4_upload``; ``transition_expert_layout`` joins it."""
        if not self.async_transitions:
            return
        if self.hap_plan is None or not self.hap_plan.switches:
            return
        if self._plan_mechanism() != "int4_upload":
            return
        if not self.cfg.is_moe or not self._expert_leaves():
            return
        target = self._sharding_for(phase)
        if self._pending_restore is not None:
            if self._pending_restore[:2] == (phase, target):
                return  # the right restore is already in flight
            self._drop_pending_restore()
        futures = {}
        for name, w in self._expert_leaves().items():
            if not self.resident_int4 and f"moe/{name}" not in self._tx._backups:
                # on the serving thread: a mesh gathers the leaf with collectives
                self._backup_leaf(name)
            futures[name] = self._tx.submit(self._restore_leaf_with_stage, name,
                                            None if self.resident_int4 else w.dtype, target)
        self._pending_restore = (phase, target, futures, time.perf_counter())
        self.stats.async_restores += 1

    def _join_async_restore(self, phase: str) -> Optional[float]:
        """Completion barrier for a kicked restore: wait out the futures
        (bounded by the watchdog), install every leaf at once behind the
        side stream's event, and return the exposed wait in ms. None when
        nothing usable is pending: a failure or timeout (counted), or a
        restore for another phase; the caller then relayouts in sync."""
        pending = self._pending_restore
        if pending is None:
            return None
        self._pending_restore = None
        p_phase, p_target, futures, t_kick = pending
        t0 = time.perf_counter()
        status, results = 0, None  # 0: landed, 1: timed out, 2: failed
        try:
            deadline = t0 + self.restore_timeout_s
            results = {n: f.result(timeout=max(deadline - time.perf_counter(), 0.0)) for n, f in futures.items()}
        except TimeoutError:
            log.exception("async restore timed out at the barrier")
            status = 1
        except Exception:
            log.exception("async restore failed at the barrier")
            status = 2
        # the watchdog is rank 0's; a failure on any rank fails them all
        seen = [v[0] for v in self._all_ranks([status])]
        failed = seen[0] != 0 or 2 in seen
        if not failed and status == 1:  # rank 0's restore landed in time: wait for ours
            results = {n: f.result() for n, f in futures.items()}
        if failed:
            log.warning("async restore failed/timed out; falling back to the sync relayout")
            self.stats.restore_errors += 1
            self.stats.background_errors += 1
            return None
        if p_phase != phase or p_target != self._sharding_for(phase):
            log.info("async restore discarded: target layout changed in flight")
            return None
        self._set_expert_leaves({n: r.install() for n, r in results.items()})
        if self.mesh is not None:
            self._layout = p_target
        for r in results.values():
            if r.event is not None:
                r.event.synchronize()  # the wait the decode would otherwise absorb
        # the restored leaves are in expert layout: lay them out in slots
        self._slots = None
        self._install_slots(serving_replication(p_target), p_target)
        wait_ms = (time.perf_counter() - t0) * 1e3
        self.stats.restore_wait_ms += wait_ms
        self.stats.restore_overlap_ms += (t0 - t_kick) * 1e3
        return wait_ms

    def transition_expert_layout(self) -> float:
        """Execute the prefill->decode expert-layout switch; returns ms. The
        barrier of an async restore in flight (the residual wait), else a
        sync relayout."""
        if self.hap_plan is None or not self.hap_plan.switches:
            return 0.0
        ms = self._join_async_restore("decode")
        if ms is not None:
            return ms
        return self._relayout_experts(self._plan_mechanism(), self._sharding_for("decode"))

    def _restore_prefill_layout(self) -> float:
        """Undo the previous batch's prefill->decode switch so a reused
        switching plan prefills under its prefill layout again; returns ms."""
        if self.hap_plan is None or not self.hap_plan.switches:
            return 0.0
        return self._relayout_experts(self._plan_mechanism(), self._sharding_for("prefill"))

    def _match_layout(self, phase: str) -> float:
        """On a mesh, reshard whatever of the params is not yet in the
        active plan's ``phase`` layout (the params' own layout at the first
        plan, or attention after a plan switch); returns ms."""
        target = self._sharding_for(phase)
        if self.mesh is None or self._same_layout(self._layout, target):
            return 0.0
        return self._relayout_experts("reshard", target)

    # -- online hot-expert replication ------------------------------------
    def _ep_size(self) -> int:
        """EP axis extent of the decode layout (replica totals must pad to
        a multiple of it so the slot axis still shards)."""
        plan = self._sharding_for("decode")
        if plan is None or plan.is_null or plan.ffn_mode != "ep" or plan.ep_axis is None:
            return 1
        return plan.axis_size(plan.ep_axis)

    def _observe_routing(self, route: Optional[torch.Tensor]) -> None:
        """Feed a decode step's router top-k block (read back with its
        tokens) into the frequency tracker. With prefetch on, this is also
        where the predicted rows' pulls are issued: the worker stages them
        while the next decode steps run."""
        if self._tracker is None or route is None:
            return
        self._tracker.update(route.numpy())
        self.stats.routing_steps += 1
        self._maybe_prefetch()

    # -- predictive expert prefetch (DESIGN.md §5c) -----------------------
    def _prefetch_backup_key(self) -> Optional[str]:
        """The backup leaf prefetch slices, when per-row restore is exact for
        every expert leaf (row spans must land on INT4 group boundaries);
        None disables prefetch for this engine."""
        keys = [f"moe/{n}" for n in _EXPERT_LEAVES]
        if any(self._tx.prefetch_rows_of(k) is None for k in keys):
            return None
        return keys[0]

    def _maybe_prefetch(self) -> None:
        """Issue background pulls for the predicted experts' restore rows.
        The pulls run on the executor's single worker, on its own stream,
        the worker the async restore uses, so pulls and restores stay
        ordered and a barrier sees every pull queued before it. Mispredicted
        or unpredicted rows stay unstaged: the barrier uploads them, with
        the same bytes (the stage only ever holds exact backup rows)."""
        if self._predictor is None or self._tracker is None:
            return
        if self._prefetch_backup_key() is None:
            return
        self._predictor.observe(self._tracker)
        pred = self._predictor.predict()
        E = self.cfg.n_routed_experts
        rows = {layer * E + e for layer, experts in enumerate(pred) for e in experts}
        n_rows = self._tx.prefetch_rows_of(f"moe/{_EXPERT_LEAVES[0]}")
        rows = {r for r in rows if r < n_rows}
        with self._prefetch_lock:
            # bounded window: evict stale rows the predictor dropped
            for r in [r for r in self._prefetch_stage if r not in rows]:
                del self._prefetch_stage[r]
            fresh = sorted(rows - set(self._prefetch_stage) - self._prefetch_live)
            self._prefetch_live.update(fresh)
        if not fresh:
            return
        self.stats.prefetch_predicted += len(fresh)
        self._tx.submit(self._prefetch_pull, tuple(fresh))

    def _prefetch_pull(self, rows) -> None:
        """Background worker task: stage each predicted row's three leaves
        on the device. Each leaf's rows are uploaded as contiguous runs on
        the worker's stream (``prefetch_rows``), the worker waits for them,
        and only then do the rows land in the stage: a row lands atomically
        (all three leaves, uploaded, or nothing), so a barrier's snapshot
        can never tear an expert. ``prefetch_hidden_ms`` is the batch's time
        on the worker, off the serving thread (the uploads still share the
        card with the decode steps they overlap)."""
        t0 = time.perf_counter()
        if self.faults is not None:
            rows = self._fire_prefetch(rows)
        try:
            leaves = {name: self._tx.prefetch_rows(f"moe/{name}", rows) for name in _EXPERT_LEAVES}
            staged = {row: {name: leaves[name][row] for name in _EXPERT_LEAVES} for row in rows}
        except Exception:
            log.exception("prefetch pull failed for rows %s", rows)
            self.stats.prefetch_errors += len(rows)
            self.stats.background_errors += len(rows)
            with self._prefetch_lock:
                self._prefetch_live.difference_update(rows)
            staged = {}
        for st in {id(st.event): st for v in staged.values() for st in v.values()}.values():
            if st.event is not None:
                st.event.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with self._prefetch_lock:
            for row, v in staged.items():
                if row in self._prefetch_live:
                    self._prefetch_live.discard(row)
                    self._prefetch_stage[row] = v
                    self.stats.prefetch_bytes += int(sum(st.nbytes for st in v.values()))
            self.stats.prefetch_hidden_ms += ms

    def _fire_prefetch(self, rows) -> Tuple[int, ...]:
        """The "prefetch" fault site, fired as the reference's per-row pull
        fires it: once per (row, leaf), row by row, a row's remaining leaves
        skipped once one fails. A failed row costs one prefetch error and
        stays unstaged (its barrier uploads it); the rows that pass are
        returned for the batched upload."""
        ok = []
        for row in rows:
            try:
                for name in _EXPERT_LEAVES:
                    self.faults.fire("prefetch")
            except Exception:
                log.exception("prefetch pull failed for row %d", row)
                self.stats.prefetch_errors += 1
                self.stats.background_errors += 1
                with self._prefetch_lock:
                    self._prefetch_live.discard(row)
                continue
            ok.append(row)
        return tuple(ok)

    def _prefetch_snapshot(self, name: str, n_rows: int) -> Dict[int, Any]:
        """Staged rows of one leaf, and the hit/miss accounting of a
        barrier: counted once per restore (on the first leaf), so hits and
        misses tally (layer, expert) rows, not row x leaf."""
        with self._prefetch_lock:
            snap = {r: v[name] for r, v in self._prefetch_stage.items()}
        if name == _EXPERT_LEAVES[0]:
            self.stats.prefetch_hits += len(snap)
            self.stats.prefetch_misses += n_rows - len(snap)
        return snap

    def _maybe_rebalance(self) -> bool:
        """Every ``rebalance_interval`` tracked steps since the last
        rebalance, re-plan the replica set from the live routing
        frequencies. A changed set is a changed ``ShardingPlan`` (new step
        graphs), and the expert leaves move into its slots through the same
        relayout path as any plan switch. Returns True when a rebalance was
        applied."""
        if self._tracker is None or self._tracker.steps == 0:
            return False
        if not self.replicate_experts:
            return False
        if self._tracker.steps - self._last_rebalance_step < self.rebalance_interval:
            return False
        self._last_rebalance_step = self._tracker.steps
        new = plan_replication(self._tracker, self.replicate_experts, align=self._ep_size(),
                               degrees=self._searched_degrees())
        if new.is_identity:
            new = None
        if new == self._replication:
            return False
        old = self._replication
        self._replication = new
        ms = self._relayout_experts("reshard", self._sharding_for("decode"))
        self.stats.replication_rebalances += 1
        self.stats.transition_ms_total += ms
        self.stats.last_transition_ms = ms
        log.info(
            "replication rebalance: %s -> %s (%.1f ms, %s)",
            old.degrees if old is not None else "uniform",
            new.degrees if new is not None else "uniform",
            ms,
            replication_summary(new, self._tracker.frequencies()) if new is not None else {},
        )
        return True

    def _searched_degrees(self) -> Optional[tuple]:
        """Planner-searched per-expert replica degrees: the latency model
        trades each grant's bottleneck-load gain against the prefetch
        bandwidth of keeping the slot fresh
        (``HAPPlanner.searched_replication``), demoting
        ``replicate_experts`` from fixed budget to cap. None (fixed
        water-filling) when the session's planner was never built: fitting
        the latency forests costs ~1 min, which a rebalance in a fixed-plan
        engine must not trigger."""
        sess = self.session
        if sess is None or sess._planner is None or self.hap_plan is None or self._last_workload is None:
            return None
        try:
            return sess.planner.searched_replication(
                self._last_workload, self.hap_plan.expert_decode, self._tracker.frequencies(),
                max_extra=self.replicate_experts, window_steps=self.rebalance_interval,
            )
        except Exception:
            log.exception("replication degree search failed; water-filling")
            self.stats.replication_search_errors += 1
            self.stats.background_errors += 1
            return None

    # -- adaptive re-planning ---------------------------------------------
    def _activate_plan(self, batch_workload: Workload, phase: str = "prefill") -> float:
        """Fetch/reuse the bucketed plan for this batch; run the Eq.-6
        inter-batch transition when the active plan changes. Returns ms.

        ``phase`` is the layout the caller is about to serve under: static
        batches enter through their prefill layout, the paged continuous
        path straight into the decode layout (fused chunk+decode steps run
        there), so a reused plan whose experts sit in the decode layout
        moves nothing."""
        hits0 = self.session.hits
        fb0 = self.session.fallbacks
        self._last_workload = batch_workload
        new = self.session.plan_for(batch_workload)
        self.stats.cache_hits += self.session.hits - hits0
        self.stats.planner_fallbacks += self.session.fallbacks - fb0
        old = self.hap_plan
        bucket = self.session.bucket_of(batch_workload).describe()
        if old is None or not self._plan_ran:
            self.hap_plan = new
            log.info("initial plan [%s]: %s", bucket, new.describe())
            ms = self._match_layout("prefill")
            return ms + (self.transition_expert_layout() if phase == "decode" else 0.0)
        if new is old:
            # a switching plan left the experts in the decode layout after
            # the previous batch: a prefill-phase entry restores its layout
            return self._restore_prefill_layout() if phase == "prefill" else 0.0
        self.hap_plan = new
        self.stats.replans += 1
        if (new.attn, new.expert_prefill, new.expert_decode) == (old.attn, old.expert_prefill, old.expert_decode):
            log.info("re-planned [%s]: strategies unchanged (%s)", bucket, new.describe())
            return self._restore_prefill_layout() if phase == "prefill" else 0.0
        mech, predicted = self.session.transition_between(old, new, batch_workload)
        ms = 0.0
        if mech != "none":
            ms = self._relayout_experts(mech, self._sharding_for(phase))
        elif phase == "decode" and new.switches:
            # Eq. 6 judged old-decode -> new-prefill free, but a decode-phase
            # entry must land in the new plan's decode layout
            ms = self.transition_expert_layout()
        ms += self._match_layout(phase)
        self.stats.plan_switches += 1
        log.info(
            "plan switch [%s]: %s -> %s via %s (%.1f ms, predicted %.1f ms)",
            bucket, old.describe(), new.describe(), mech, ms, predicted * 1e3,
        )
        return ms

    def _book_transition(self, ms: float) -> float:
        self.stats.transition_ms_total += ms
        self.stats.last_transition_ms = ms
        return ms

    def close(self) -> None:
        """Drain an in-flight background restore and stop the executor's
        worker thread (after its queued pulls); release the step graphs, the
        static cache and the prefetch stage."""
        self._drop_pending_restore()
        self._tx.close()
        self.steps.clear()
        self._static = None
        with self._prefetch_lock:
            self._prefetch_stage.clear()
            self._prefetch_live.clear()

    def submit(self, req: Request) -> int:
        deadline = None if req.deadline_ms is None else self.clock() + req.deadline_ms / 1e3
        return self.scheduler.submit(req.prompt, req.max_new_tokens, deadline=deadline)

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid, queued or live: it retires with status
        "cancelled" (and the tokens generated so far) at the next lifecycle
        sweep. False when the uid is unknown or finished. On a mesh rank
        0's cancels decide."""
        if self.scheduler.cancel(uid):
            return True
        if self._live is not None:
            for s in self._live.slots:
                if s is not None and s.req.uid == uid:
                    s.req.cancelled = True
                    return True
        return False

    def _all_ranks(self, values: List[int]) -> List[List[int]]:
        """Every rank's ``values`` in rank order (``[values]`` on one
        device). The decisions a rank's own clock or thread could make
        differently (a deadline, a cancel, the restore watchdog) are taken
        from rank 0's, so every rank follows the same schedule. ``values``
        has the same length on every rank."""
        if self.mesh is None or self.mesh.size == 1 or not values:
            return [values]
        mine = torch.tensor(values, dtype=torch.int64, device=self.device).reshape(1, -1)
        return self.mesh.all_gather(mine, dim=0).tolist()

    def _sync(self) -> None:
        """Wait for the serving stream (the timers' end point). Not the whole
        device: a background restore on the executor's stream must not be
        booked to the prefill it overlaps."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _sample(self, logits: torch.Tensor, sampling: SamplingParams, gen) -> torch.Tensor:
        """Sample the step's tokens; on a mesh, all-gather every rank's and
        raise unless they are equal (every rank runs the same schedule)."""
        toks = sample(logits, sampling, gen)
        if self.mesh is not None and self.mesh.size > 1:
            seen = self.mesh.all_gather(toks.reshape(1, -1), dim=0)
            if not bool((seen == seen[:1]).all()):
                raise RuntimeError(f"rank {self.mesh.rank}: the ranks sampled different tokens: {seen.tolist()}")
        return toks

    def _generator(self, sampling: SamplingParams) -> Optional[torch.Generator]:
        """One explicit generator per serving call (temperature > 0 only)."""
        if sampling.temperature <= 0:
            return None
        return torch.Generator(device=self.device).manual_seed(sampling.seed)

    # -- captured steps (the reference's _jit / _fn_cache) ---------------
    # Every key carries the step's ShardingPlan (None on one card, where every
    # plan runs the same layout, so a replan reuses the graphs as it reuses
    # the reference's jit entries); on a mesh each (kind, plan, shape class)
    # is a graph of its own, its body running under that plan.
    def _route_spec(self, rows: int) -> Dict[str, Any]:
        """The static buffer a tracked decode step writes its router top-k
        ids into (none with the tracker off)."""
        if self._tracker is None:
            return {}
        return {"route": ((self.cfg.num_layers, rows, self.cfg.top_k), torch.int32)}

    def _read_route(self, g: StepGraph) -> Optional[torch.Tensor]:
        """Queue the read-back of a tracked step's top-k ids; the host tensor
        holds them once the step's token read-back has synced (no second
        sync)."""
        return g.read_back("route") if self._tracker is not None else None

    def _run_step(self, g: StepGraph) -> torch.Tensor:
        """Run a fed step. No capture while a background restore is in
        flight: the joined leaves are installed at the barrier, which drops
        every graph that reads the old ones."""
        return self.steps.run(g, may_capture=self._pending_restore is None)

    def _static_cache(self, B: int, max_len: int) -> DecodeCache:
        """The contiguous cache of (B, max_len), kept across batches of that
        shape: the static steps' graphs read its tensors. Only one is kept: a
        batch of another shape releases it and drops its graphs first, so
        varied output budgets do not pile up caches and graph pools."""
        plan = self._sharding_for("decode")
        # a plan of another cache layout needs another cache
        layout = cache_layout(self.cfg, plan, paged=False)
        if self._static is None or self._static[0] != (B, max_len) or self._static[2] != layout:
            self._static = None
            self.steps.new_cache("static")
            cache = init_cache(self.cfg, B, max_len, dtype=self.params["embed"].dtype, device=self.device, plan=plan)
            self._static = ((B, max_len), cache, layout)
        return self._static[1]

    def _prefill_step(self, toks: np.ndarray, max_len: int) -> torch.Tensor:
        """Prefill the padded prompts ``toks`` (B, S) into the (B, max_len)
        cache; returns the last position's logits (B, V)."""
        B, S = toks.shape
        cache = self._static_cache(B, max_len)
        plan = self._sharding_for("prefill")

        def body(g: StepGraph) -> torch.Tensor:
            logits, _ = prefill(self.params, self.cfg, {"tokens": g.bufs["tokens"]}, max_len,
                                backend=self.kernel_backend, cache=cache, plan=plan)
            return logits

        g = self.steps.graph(("prefill", plan, B, S, max_len),
                             lambda: self.steps.buffers(tokens=((B, S), torch.long)), body, "static")
        g.feed("tokens", toks)
        return self._run_step(g)

    def _decode_step_static(self, tok: torch.Tensor, pos: int, max_len: int):
        """One lockstep decode step of the (B, max_len) cache: ``tok`` (B,)
        written at ``pos``; returns the logits (B, V) and the read-back of
        the router top-k ids (None with the tracker off). The position is
        fed, not advanced inside the step, so the body stays a function of
        its buffers."""
        B = tok.shape[0]
        cache = self._static_cache(B, max_len)
        plan = self._sharding_for("decode")

        def body(g: StepGraph) -> torch.Tensor:
            logits, new = decode_step(self.params, self.cfg, g.bufs["tokens"], cache, backend=self.kernel_backend,
                                      plan=plan, collect_routing="route" in g.bufs)
            if "route" in g.bufs:
                g.bufs["route"].copy_(new.route_topk)
            return logits

        g = self.steps.graph(("decode", plan, B, max_len),
                             lambda: dict(self.steps.buffers(tokens=((B, 1), torch.long), **self._route_spec(B)),
                                          pos=cache.pos), body, "static")
        g.feed("tokens", tok[:, None])
        g.feed("pos", pos)
        return self._run_step(g), self._read_route(g)

    # -- static batching ----------------------------------------------------
    def run(self, sampling: Optional[SamplingParams] = None) -> List[Completion]:
        """Drain the queue; returns completions in uid order."""
        sampling = sampling if sampling is not None else SamplingParams()
        out: List[Completion] = []
        while True:
            batch = self.scheduler.next_batch()
            if batch is None:
                break
            out.extend(self._run_batch(batch, sampling))
        return sorted(out, key=lambda c: c.uid)

    def _run_batch(self, batch: List[QueuedRequest], sampling: SamplingParams) -> List[Completion]:
        toks, _ = self.scheduler.pad_batch(batch)
        B, S = toks.shape
        max_new = max(r.max_new_tokens for r in batch)
        max_len = S + max_new + 1
        self.stats.batches += 1
        gen = self._generator(sampling)

        with torch.inference_mode():
            inter_ms = 0.0
            if self.session is not None:
                inter_ms = self._activate_plan(Workload(batch=B, prompt=S, gen=max_new))
            self._plan_ran = True
            # plan decided: kick the decode-layout INT4 restore onto the
            # background worker so it overlaps this batch's prefill
            self._begin_async_restore("decode")
            self._sync()
            t0 = time.perf_counter()
            logits = self._prefill_step(toks, max_len)
            self._sync()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            transition_ms = self._book_transition(inter_ms + self.transition_expert_layout())

            generated = np.zeros((B, max_new), np.int32)
            t1 = time.perf_counter()
            next_tok = self._sample(logits, sampling, gen)
            host_tok = next_tok.cpu().numpy()
            done = np.zeros((B,), bool)
            for step in range(max_new):
                generated[:, step] = np.where(done, self.eos_id, host_tok)
                if step == max_new - 1:
                    break
                logits, route = self._decode_step_static(next_tok, S + step, max_len)
                next_tok = self._sample(logits, sampling, gen)
                host_tok = next_tok.cpu().numpy()  # the step's one sync
                self._observe_routing(route)
                self._maybe_rebalance()
                if self.eos_id >= 0:
                    done |= host_tok == self.eos_id
                    if done.all():
                        break
            self._sync()
            decode_ms = (time.perf_counter() - t1) * 1e3

        comps = []
        for i, r in enumerate(batch):
            n = min(r.max_new_tokens, max_new)
            toks_out = [int(t) for t in generated[i, :n] if t != self.eos_id or self.eos_id < 0]
            comps.append(Completion(r.uid, toks_out, prefill_ms, decode_ms, transition_ms))
        return comps

    # -- continuous batching --------------------------------------------------
    def serve_continuous(self, sampling: Optional[SamplingParams] = None) -> List[Completion]:
        """Drain the queue with continuous batching; uid-ordered completions.

        Each iteration first retires cancelled and expired requests, then
        admits whatever fits the pool (or, contiguous, a free slot's
        capacity), runs one step and retires finished rows. Greedy outputs
        equal the JAX engine's: every request is prefilled at its own prompt
        bucket and chunk boundaries only re-tile the same causal attention.
        """
        sampling = sampling if sampling is not None else SamplingParams()
        gen = self._generator(sampling)
        out: List[Completion] = []
        with torch.inference_mode():
            while len(self.scheduler) or self._live is not None:
                self._reap_lifecycle()
                out.extend(self.retire())
                if self._live is None:
                    if not len(self.scheduler):
                        break
                    self._begin_live_batch()
                self.admit(sampling, gen)
                out.extend(self.retire())  # zero-token budgets end here
                if not self.step(sampling, gen):
                    # nothing runnable: the queue head outgrows this
                    # generation's tables; drain and resize
                    self._end_live_batch()
                    continue
                out.extend(self.retire())
        out.extend(self.retire())  # any last terminal completions
        return sorted(out, key=lambda c: c.uid)

    def _begin_live_batch(self) -> None:
        """Size a fresh live batch from the queue. Paged: tables as wide as
        the largest queued need, a pool holding the sum of queued needs
        (capped at every slot full-length, never below the head's own
        need). Contiguous: every slot holds the largest queued need, rounded
        up to the prompt bucket so repeated capacities reuse the same step
        graphs, and a B=1 cache of that capacity takes each joiner's
        prefill."""
        sch = self.scheduler
        queued = sch.queued()
        cap = round_up(max(sch.kv_need(r) for r in queued), sch.bucket)
        nslots = sch.max_batch
        if not self.paged:
            self._end_live_batch()
            dt, plan = self.params["embed"].dtype, self._sharding_for("decode")
            cache = init_cache(self.cfg, nslots, cap, dtype=dt, device=self.device, plan=plan)
            cache.pos = torch.zeros((nslots,), dtype=torch.int32, device=self.device)
            self._live = _LiveBatch(
                kv_capacity=cap, slots=[None] * nslots, cache=cache, pos=np.zeros((nslots,), np.int32),
                next_tok=np.zeros((nslots,), np.int32),
                sub=init_cache(self.cfg, 1, cap, dtype=dt, device=self.device, plan=plan),
                layout=cache_layout(self.cfg, plan, paged=False),
            )
            log.info("live batch: %d slots, KV capacity %d tokens", nslots, cap)
            self.stats.batches += 1
            return
        bs = self.kv_block_size
        max_blocks = blocks_for(cap, bs)
        needs = [blocks_for(sch.kv_need(r), bs) for r in queued]
        pool = self.kv_blocks if self.kv_blocks is not None else min(sum(needs), nslots * max_blocks)
        pool = max(pool, max(needs))  # the head must stay admittable
        allocator = BlockAllocator(pool + 1, bs, faults=self.faults)
        self.kv_pool_blocks = pool
        self._end_live_batch()
        plan = self._sharding_for("decode")
        self._live = _LiveBatch(
            kv_capacity=max_blocks * bs,
            slots=[None] * nslots,
            cache=init_paged_cache(
                self.cfg, nslots, pool + 1, bs, max_blocks, dtype=self.params["embed"].dtype, device=self.device,
                plan=plan,
            ),
            pos=np.zeros((nslots,), np.int32),
            next_tok=np.zeros((nslots,), np.int32),
            allocator=allocator,
            max_blocks=max_blocks,
            tables=np.full((nslots, max_blocks), TRASH_BLOCK, np.int32),
            prefix=PrefixCache(allocator) if self.prefix_caching else None,
            layout=cache_layout(self.cfg, plan, paged=True),
        )
        self.stats.batches += 1

    def _end_live_batch(self) -> None:
        """Release the live batch and drop the step graphs that read its
        pool and tables (their memory goes back to the allocator)."""
        self._live = None
        self.steps.new_cache("live")

    def admit(self, sampling: Optional[SamplingParams] = None, gen=None) -> List[int]:
        """Admit queue-head requests into free slots (strict FIFO). Paged:
        while the pool can reserve their charge; their prompts queue as
        chunks. Contiguous: while the head fits a slot's capacity; each is
        prefilled here and its first token sampled with ``sampling``.
        Returns the joined slot indices."""
        sampling = sampling if sampling is not None else SamplingParams()
        live = self._live
        joined: List[int] = []
        while True:
            free = [i for i, s in enumerate(live.slots) if s is None]
            if not free:
                break
            if self.paged:
                r = self.scheduler.next_fit_blocks(live.allocator, live.kv_capacity, prefix_cache=live.prefix,
                                                   overcommit=self.kv_overcommit)
            else:
                r = self.scheduler.next_fit(live.kv_capacity)
            if r is None:
                break
            if self.paged:
                self._admit_one(free[0], r)
            else:
                self._admit_whole(free[0], r, sampling, gen)
            joined.append(free[0])
        return joined

    def _admit_whole(self, i: int, r: QueuedRequest, sampling: SamplingParams, gen) -> None:
        """Contiguous admission of ``r`` into slot ``i``: re-plan on the join
        (its prefill layout; the decode-layout restore is kicked to overlap
        the prefill), prefill it alone at its own bucket, run the
        expert-layout transition, merge its cache rows into the slot and
        take its first token."""
        live = self._live
        slot = _Slot(req=r, start=self.scheduler.padded_len(r))
        live.slots[i] = slot
        self.stats.joins += 1
        inter_ms = self._replan_on_join()
        self._relayout_live(self._sharding_for("decode"))
        self._begin_async_restore("decode")
        toks, _ = self.scheduler.pad_batch([r])
        self._sync()
        t0 = time.perf_counter()
        logits = self._admit_prefill(toks)
        tok0 = int(self._sample(logits, sampling, gen).cpu()[0])
        slot.prefill_ms = (time.perf_counter() - t0) * 1e3
        slot.transition_ms = self._book_transition(inter_ms + self.transition_expert_layout())
        merge_cache_rows(live.cache, live.sub, [i])
        live.pos[i] = slot.start
        live.next_tok[i] = tok0
        if r.max_new_tokens >= 1:
            slot.tokens.append(tok0)
        log.info("join uid=%d slot=%d start=%d (queued %d)", r.uid, i, slot.start, len(self.scheduler))

    def _admit_prefill(self, toks: np.ndarray) -> torch.Tensor:
        """Prefill one joiner's padded prompt ``toks`` (1, S) into the live
        batch's B=1 cache under the prefill layout; returns its logits
        (1, V). One step per prompt bucket; the merge into the live cache
        runs after it, in place, so a join drops no graph."""
        live = self._live
        S, cap = toks.shape[1], live.kv_capacity
        plan = self._sharding_for("prefill")

        def body(g: StepGraph) -> torch.Tensor:
            logits, _ = prefill(self.params, self.cfg, {"tokens": g.bufs["tokens"]}, cap,
                                backend=self.kernel_backend, cache=live.sub, plan=plan)
            return logits

        g = self.steps.graph(("admit_prefill", plan, S, cap), lambda: self.steps.buffers(tokens=((1, S), torch.long)),
                             body, "live")
        g.feed("tokens", toks)
        return self._run_step(g)

    def _admit_one(self, i: int, r: QueuedRequest) -> None:
        """Paged admission of ``r`` into slot ``i``: reserve its charge and
        queue its prompt as chunks."""
        live = self._live
        # the worst case (growth cannot run the pool dry), or under
        # kv_overcommit the expected need: growth past it takes spare blocks,
        # and an OutOfBlocks there preempts a row (DESIGN.md §4f)
        charge = (self.scheduler.expected_kv_need(r, self.kv_overcommit) if self.kv_overcommit
                  else self.scheduler.kv_need(r))
        toks, _ = self.scheduler.pad_batch([r])
        skip = 0
        if live.prefix is not None:
            # the plan matches the admission check's (nothing registers or
            # evicts in between); the table starts with the adopted blocks
            ap = live.prefix.plan_admission(toks[0], charge)
            skip = ap.skip
            table = BlockTable(
                live.allocator, charge, shared_blocks=ap.adopt, shared_partial=ap.adopt_partial,
                owner=f"uid={r.uid}",
            )
            self.stats.prefix_hit_blocks += len(ap.adopt)
            self.stats.prefix_hit_tokens += skip
            self.stats.raw_block_need += ap.raw_blocks
            self.stats.effective_block_need += ap.reserve_blocks
        else:
            table = BlockTable(live.allocator, charge, owner=f"uid={r.uid}")
        slot = _Slot(req=r, start=self.scheduler.padded_len(r), table=table)
        chunk = self.prefill_chunk or self.scheduler.bucket
        slot.pending = [toks[0, o : o + chunk] for o in range(skip, toks.shape[1], chunk)]
        slot.filled = skip
        live.slots[i] = slot
        live.tables[i, :] = TRASH_BLOCK  # until the first chunk lands
        live.pos[i] = skip
        live.next_tok[i] = 0
        self.stats.joins += 1
        # decode-phase activation: a switching plan serves fused chunk+decode
        # steps under its decode layout, and a reused plan's experts are
        # already there
        first = not self._plan_ran
        slot.transition_ms = self._replan_on_join(phase="decode")
        if self.session is None and first:
            # sessionless engine with a pinned switching plan: enter the
            # decode layout once, at the first admission
            slot.transition_ms += self.transition_expert_layout()
        self._book_transition(slot.transition_ms)

    def _replan_on_join(self, phase: str = "prefill") -> float:
        """Re-bucket the live workload through the session at admission time
        (Eq.-6 transitions fire mid-stream); returns transition ms."""
        inter_ms = 0.0
        if self.session is not None:
            rows = [s for s in self._live.slots if s is not None]
            inter_ms = self._activate_plan(
                Workload(
                    batch=len(rows),
                    prompt=max(s.start for s in rows),
                    gen=max(s.req.max_new_tokens for s in rows),
                ),
                phase=phase,
            )
        self._plan_ran = True
        return inter_ms

    def step(self, sampling: SamplingParams, gen=None) -> bool:
        """One iteration: the FIFO-first joiner's next prefill chunk, fused
        with a decode step when live rows exist, else (and always on the
        contiguous path, whose joiners were prefilled at admission) a decode
        step. Returns False when nothing is runnable (drain-and-resize)."""
        live = self._live
        pending = live.prefilling()
        active = live.active()
        if not pending and not active:
            return False
        if pending:
            i = min(pending, key=lambda j: live.slots[j].req.uid)
            self._prefill_chunk_step(i, active, sampling, gen)
        else:
            self.step_decode(sampling, gen)
        return True

    def _ensure_blocks(self, i: int, n_tokens: int, write_from: Optional[int] = None) -> None:
        """Grow row ``i``'s table to cover ``n_tokens`` and refresh the host
        mirror. ``write_from`` is the first position the caller is about to
        write: any shared block at or past it is forked first, and the page
        copies are queued on the card before that write."""
        live = self._live
        s = live.slots[i]
        if s is None or s.table is None:
            return
        dirty = not s.mirrored
        if write_from is not None:
            copies = s.table.ensure_writable(write_from)
            if copies:
                src = torch.tensor([c[0] for c in copies], dtype=torch.long, device=self.device)
                dst = torch.tensor([c[1] for c in copies], dtype=torch.long, device=self.device)
                # in place, every layer in one indexed copy (JAX returned new
                # page arrays); source and destination pages never overlap
                live.cache.k[:, dst] = live.cache.k[:, src]
                live.cache.v[:, dst] = live.cache.v[:, src]
                self.stats.cow_copies += len(copies)
                dirty = True
        if s.table.capacity_tokens < n_tokens:
            s.table.ensure_tokens(n_tokens)
            dirty = True
        if dirty:
            live.tables[i] = s.table.padded(live.max_blocks)
            s.mirrored = True

    # -- preemption-by-recompute (DESIGN.md §4f) --------------------------
    def _grow_blocks(self, i: int, n_tokens: int, write_from: Optional[int] = None) -> bool:
        """``_ensure_blocks`` under the overcommit contract: an
        ``OutOfBlocks`` mid-growth reclaims pool space (a prefix-cache
        eviction, else a preemption) and retries. Returns False when row
        ``i`` itself was preempted (the caller skips its step); raises the
        "wedged" ``OutOfBlocks`` when nothing can be reclaimed. All of it
        runs on the host, between steps."""
        while True:
            try:
                self._ensure_blocks(i, n_tokens, write_from)
                return True
            except OutOfBlocks as e:
                self._reclaim_blocks(i, e)
                if self._live.slots[i] is None:
                    return False

    def _reclaim_blocks(self, i: int, err: OutOfBlocks) -> None:
        """Free at least one pool block for row ``i``'s growth: evict one
        cache-only prefix entry when there is one, else preempt a victim
        (any row before ``i`` itself, then the fewest generated tokens, then
        the newest uid; rows at ``max_preemptions`` are not eligible)."""
        live = self._live
        if live.prefix is not None and live.prefix.evict(1) > 0:
            self.stats.prefix_evictions_on_pressure += 1
            return
        victims = [(j, s) for j, s in enumerate(live.slots)
                   if s is not None and not s.done and s.req.preemptions < self.max_preemptions]
        if not victims:
            raise OutOfBlocks(
                f"wedged: no preemptable victim (every live request is at the retry cap of "
                f"{self.max_preemptions}); {live.allocator.describe()}"
            ) from err
        j, _ = min(victims, key=lambda t: (t[0] == i, len(t[1].tokens), -t[1].req.uid))
        self._preempt(j)

    def _preempt(self, j: int) -> None:
        """Preempt row ``j``: free its blocks (its mirror row to the trash
        block), stash its generated tokens and requeue prompt + stash at
        the queue head as a fresh prefill. A victim with no budget left
        completes instead."""
        s = self._free_slot(j)
        r = s.req
        r.preemptions += 1
        self.stats.preemptions += 1
        self.stats.preempted_tokens += len(s.tokens)
        remaining = r.max_new_tokens - len(s.tokens)
        if s.done or remaining <= 0:
            toks = list(r.stashed) + [t for t in s.tokens if t != self.eos_id or self.eos_id < 0]
            self._finished.append(Completion(r.uid, toks, s.prefill_ms, s.decode_ms, s.transition_ms,
                                             preemptions=r.preemptions))
            return
        r.stashed = list(r.stashed) + list(s.tokens)
        r.max_new_tokens = remaining
        self.scheduler.requeue(r)
        log.info("preempt uid=%d slot=%d (%d tokens stashed, %d budget left, preemption %d/%d)",
                 r.uid, j, len(r.stashed), remaining, r.preemptions, self.max_preemptions)

    def _prefix_group_arrays(self) -> np.ndarray:
        """The (2, nslots) prefix-group operand of the decode kernel: row 0
        maps every slot to its group representative (itself when unshared),
        row 1 holds the leading shared-block count. Rows whose first
        ``n_shared`` blocks are identical form one group. Only mirrored
        slots take part: before its first chunk a row's mirror is all-trash
        and must not anchor or join a group."""
        live = self._live
        n = len(live.slots)
        reps = np.arange(n, dtype=np.int32)
        nsh = np.zeros((n,), np.int32)
        first: Dict[tuple, int] = {}
        for i, s in enumerate(live.slots):
            if s is None or not s.mirrored or s.table.n_shared == 0:
                continue
            key = tuple(s.table.blocks[: s.table.n_shared])
            rep = first.setdefault(key, i)
            if rep != i:
                reps[i] = rep
                nsh[i] = s.table.n_shared
        return np.stack([reps, nsh])

    def _groups(self, decode: bool) -> Optional[np.ndarray]:
        """The prefix-group operand to feed (None with the prefix cache off);
        ``decode``: a decode step reads it (a lone chunk does not), and one
        that reads a shared run through another row's table is counted."""
        if self._live.prefix is None:
            return None
        arrays = self._prefix_group_arrays()
        if decode and (arrays[0] != np.arange(arrays.shape[1])).any():
            self.stats.prefix_grouped_steps += 1
        return arrays

    def _chunk_half(self, g: StepGraph) -> torch.Tensor:
        """Append the (1, C) prompt chunk through the chunk row's own
        position and table buffers; returns its last position's logits
        (1, V). The row's table already holds any adopted blocks, so the
        chunk takes no group indirection."""
        sub = DecodeCache(k=self._live.cache.k, v=self._live.cache.v, pos=g.bufs["chunk_pos"],
                          block_tables=g.bufs["chunk_table"])
        logits, _ = decode_step(self.params, self.cfg, g.bufs["chunk"], sub, backend=self.kernel_backend,
                                plan=g.key[1])
        return logits

    def _decode_half(self, g: StepGraph) -> torch.Tensor:
        """A decode step over every slot through the step's position, table
        and group buffers; returns the logits (nslots, V)."""
        cache = DecodeCache(k=self._live.cache.k, v=self._live.cache.v, pos=g.bufs["pos"],
                            block_tables=g.bufs["tables"], prefix_groups=g.bufs.get("groups"))
        logits, new = decode_step(self.params, self.cfg, g.bufs["tokens"], cache, backend=self.kernel_backend,
                                  plan=g.key[1], collect_routing="route" in g.bufs)
        if "route" in g.bufs:
            g.bufs["route"].copy_(new.route_topk)
        return logits

    def _contiguous_decode(self, g: StepGraph) -> torch.Tensor:
        """A decode step over every slot of the contiguous live cache (K/V,
        and each mamba layer's conv window and state) at the step's
        position buffer; returns the logits (nslots, V)."""
        cache = dataclasses.replace(self._live.cache, pos=g.bufs["pos"])
        logits, new = decode_step(self.params, self.cfg, g.bufs["tokens"], cache, backend=self.kernel_backend,
                                  plan=g.key[1], collect_routing="route" in g.bufs)
        if "route" in g.bufs:
            g.bufs["route"].copy_(new.route_topk)
        return logits

    def _fused_body(self, g: StepGraph) -> torch.Tensor:
        """The chunk half, then the decode half, as one step (the
        reference's ``_fused_fn`` is one jit). The two halves read two
        position buffers: the chunk row's own, and every slot's with the
        joiner already past its chunk."""
        self._chunk_half(g)
        return self._decode_half(g)

    def _relayout_live(self, plan) -> float:
        """Move the live cache into ``plan``'s layout when a re-plan changed
        what this rank holds (DESIGN.md §5); returns ms. A paged pool goes
        between heads-sharded and whole; a contiguous cache between heads,
        seq and whole (its B=1 joiner cache is made anew). Slot contents,
        positions and block tables are unchanged; the step graphs that read
        the old cache are dropped."""
        live = self._live
        want = cache_layout(self.cfg, plan, paged=self.paged)
        if live is None or live.layout == want:
            return 0.0
        t0 = time.perf_counter()
        cache = live.cache
        total = live.kv_capacity if not self.paged else None
        for name in ("k", "v"):
            t = getattr(cache, name)
            setattr(cache, name, None)  # the old layout frees as the new one lands
            setattr(cache, name, relayout_kv(t, live.layout, want, self.cfg, self.mesh, total))
            del t
        if live.sub is not None:
            live.sub = init_cache(self.cfg, 1, live.kv_capacity, dtype=self.params["embed"].dtype,
                                  device=self.device, plan=plan)
        log.info("live cache relayout: %s -> %s", live.layout, want)
        live.layout = want
        self.steps.new_cache("live")
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        self.kv_relayout_ms.append(ms)
        return ms

    def _live_step(self, kind: str, C: int = 0) -> StepGraph:
        """The live batch's step of ``kind`` ("chunk", "paged_decode" or
        "fused" on the paged pool; "decode" on the contiguous cache) for a
        C-token chunk, keyed as the reference's jit entries plus the shape
        class."""
        live = self._live
        n, mb, pfx = len(live.slots), live.max_blocks, live.prefix is not None
        plan = self._sharding_for("decode")
        self._relayout_live(plan)
        if kind == "decode":
            specs = dict(tokens=((n, 1), torch.long), pos=((n,), torch.int32), **self._route_spec(n))
            return self.steps.graph(("decode", plan, n, live.kv_capacity), lambda: self.steps.buffers(**specs),
                                    self._contiguous_decode, "live")
        specs = {}
        if kind in ("chunk", "fused"):
            specs.update(chunk=((1, C), torch.long), chunk_pos=((1,), torch.int32),
                         chunk_table=((1, mb), torch.int32))
        if kind in ("paged_decode", "fused"):
            specs.update(tokens=((n, 1), torch.long), pos=((n,), torch.int32), tables=((n, mb), torch.int32),
                         **self._route_spec(n))
            if pfx:
                specs["groups"] = ((2, n), torch.int32)
        if kind == "chunk":
            key, body = ("chunk", plan, C, n, mb), self._chunk_half
        elif kind == "paged_decode":
            key, body = ("paged_decode", plan, n, mb, pfx), self._decode_half
        else:
            key, body = ("fused", plan, C, n, mb, pfx), self._fused_body
        return self.steps.graph(key, lambda: self.steps.buffers(**specs), body, "live")

    def _prefill_chunk_step(self, i: int, active: List[int], sampling: SamplingParams, gen) -> None:
        """Process joiner ``i``'s next prompt chunk; fuse it with a decode
        step over the live rows when there are any and the chunk is not the
        last (the last chunk's logits feed the joiner's first token). Block
        growth goes through ``_grow_blocks``, which may preempt rows."""
        live = self._live
        s = live.slots[i]
        chunk = s.pending[0]
        C = len(chunk)
        final = len(s.pending) == 1
        # growth may preempt any row, the joiner too: what is still live is
        # checked again before the step
        if not self._grow_blocks(i, s.filled + C, write_from=s.filled):
            return  # the joiner itself was preempted to cover the pool
        if active and not final:
            for j in active:
                if live.slots[j] is not None:
                    self._grow_blocks(j, int(live.pos[j]) + 1, write_from=int(live.pos[j]))
            active = [j for j in active if live.slots[j] is not None]
        if live.slots[i] is None:
            return  # growing the decode rows preempted the joiner
        fused = bool(active) and not final
        s.pending.pop(0)
        self.stats.prefill_chunks += 1
        g = self._live_step("fused" if fused else "chunk", C)
        g.feed("chunk", chunk[None, :])
        g.feed("chunk_pos", live.pos[i : i + 1])
        g.feed("chunk_table", live.tables[i : i + 1])
        s.filled += C
        live.pos[i] = s.filled
        if fused:
            # the decode half sees the joiner past its chunk, as the
            # reference's fused step does; tables and groups are the chunk's
            g.feed("tokens", live.next_tok[:, None])
            g.feed("pos", live.pos)
            g.feed("tables", live.tables)
            groups = self._groups(decode=True)
            if groups is not None:
                g.feed("groups", groups)
        t0 = time.perf_counter()
        if fused:
            logits = self._run_step(g)
            route = self._read_route(g)
            toks = self._sample(logits, sampling, gen).cpu().numpy()
            step_ms = (time.perf_counter() - t0) * 1e3
            # booked once, as the live rows' decode step; the joiner's
            # prefill_ms counts only its unfused chunks
            self.stats.decode_steps += 1
            self.stats.fused_steps += 1
            self._observe_routing(route)
            self._apply_sampled(toks, active, step_ms)
            self._maybe_rebalance()
            return
        logits = self._run_step(g)
        if final:
            tok0 = int(self._sample(logits, sampling, gen).cpu()[0])
        else:
            self._sync()
        s.prefill_ms += (time.perf_counter() - t0) * 1e3
        if final:
            live.next_tok[i] = tok0
            if s.req.max_new_tokens >= 1:
                s.tokens.append(tok0)
            if live.prefix is not None:
                # index the completed prompt; the cache takes its own block
                # references, so the run outlives this request until evicted
                live.prefix.register(self.scheduler.pad_batch([s.req])[0][0], s.table.blocks)

    def _apply_sampled(self, toks: np.ndarray, active: List[int], step_ms: float) -> None:
        live = self._live
        self.stats.decode_step_ms_sum += step_ms
        self.stats.decode_step_ms_max = max(self.stats.decode_step_ms_max, step_ms)
        for i in active:
            s = live.slots[i]
            live.pos[i] += 1
            s.decode_ms += step_ms
            t = int(toks[i])
            live.next_tok[i] = t
            if self.eos_id >= 0 and t == self.eos_id:
                s.done = True  # stop; EOS is never emitted
                continue
            s.tokens.append(t)

    def step_decode(self, sampling: SamplingParams, gen=None) -> None:
        """One decode step over the full slot set, drained rows frozen on
        the host (paged: writing to the trash block; contiguous: at their
        own frozen position, their mamba state running on until a join
        overwrites it): constant shapes per slot count."""
        live = self._live
        active = live.active()
        if self.paged:
            for j in active:
                if live.slots[j] is not None:
                    self._grow_blocks(j, int(live.pos[j]) + 1, write_from=int(live.pos[j]))
            active = [j for j in active if live.slots[j] is not None]
            if not active:
                return  # every decode row was preempted to cover the pool
        g = self._live_step("paged_decode" if self.paged else "decode")
        g.feed("tokens", live.next_tok[:, None])
        g.feed("pos", live.pos)
        if self.paged:
            g.feed("tables", live.tables)
            groups = self._groups(decode=True)
            if groups is not None:
                g.feed("groups", groups)
        t0 = time.perf_counter()
        logits = self._run_step(g)
        route = self._read_route(g)
        toks = self._sample(logits, sampling, gen).cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.stats.decode_steps += 1
        self._observe_routing(route)
        self._apply_sampled(toks, active, step_ms)
        self._maybe_rebalance()

    def _free_slot(self, i: int) -> _Slot:
        """Release row ``i``'s blocks and point its mirror at the trash block
        (paged), and empty the slot; returns the old slot state."""
        live = self._live
        s = live.slots[i]
        if s.table is not None:
            s.table.free()
            live.tables[i, :] = TRASH_BLOCK
        s.pending = []
        live.slots[i] = None
        live.next_tok[i] = 0
        return s

    # -- request lifecycle (DESIGN.md §4f) --------------------------------
    def _expired(self, r: QueuedRequest) -> bool:
        return r.deadline is not None and self.clock() >= r.deadline

    def _terminal(self, r: QueuedRequest) -> int:
        """0: keep serving ``r``; 1: cancelled; 2: past its deadline."""
        return 1 if r.cancelled else 2 if self._expired(r) else 0

    def _reap_lifecycle(self) -> None:
        """Retire cancelled and expired requests, queued or live, with a
        terminal status and their partial output (stash + generated so
        far); the completions wait in ``_finished`` for ``retire``. Runs at
        every step boundary; on a mesh rank 0's verdicts decide."""
        queued = self.scheduler.queued()
        live = [(i, s) for i, s in enumerate(self._live.slots) if s is not None] if self._live is not None else []
        verdicts = self._all_ranks([self._terminal(r) for r in queued] + [self._terminal(s.req) for _, s in live])[0]
        for r, v in zip(queued, verdicts):
            if not v:
                continue
            self.scheduler.remove(r)
            status = "cancelled" if v == 1 else "deadline"
            self._count_terminal(status)
            self._finished.append(Completion(r.uid, list(r.stashed), 0.0, 0.0, 0.0, status=status,
                                             preemptions=r.preemptions))
            log.info("reap queued uid=%d (%s)", r.uid, status)
        for (i, s), v in zip(live, verdicts[len(queued):]):
            if not v:
                continue
            status = "cancelled" if v == 1 else "deadline"
            self._count_terminal(status)
            self._free_slot(i)
            toks = list(s.req.stashed) + [t for t in s.tokens if t != self.eos_id or self.eos_id < 0]
            self._finished.append(Completion(s.req.uid, toks, s.prefill_ms, s.decode_ms, s.transition_ms,
                                             status=status, preemptions=s.req.preemptions))
            log.info("reap live uid=%d slot=%d (%s, %d tokens)", s.req.uid, i, status, len(toks))

    def _count_terminal(self, status: str) -> None:
        if status == "cancelled":
            self.stats.cancelled += 1
        elif status == "deadline":
            self.stats.deadline_expired += 1

    def retire(self) -> List[Completion]:
        """Free slots whose request hit EOS or its output budget; returns
        their completions, after the buffered terminal ones (cancelled,
        expired, preempted with no budget left). Their blocks go back to
        the pool."""
        comps: List[Completion] = list(self._finished)
        self._finished.clear()
        live = self._live
        if live is None:
            return comps
        for i, s in enumerate(live.slots):
            if s is None or not (s.done or len(s.tokens) >= s.req.max_new_tokens):
                continue
            toks = list(s.req.stashed) + [t for t in s.tokens if t != self.eos_id or self.eos_id < 0]
            comps.append(Completion(s.req.uid, toks, s.prefill_ms, s.decode_ms, s.transition_ms,
                                    preemptions=s.req.preemptions))
            self._free_slot(i)
        return comps
