# The port's own copy of repro.core.session: the port imports nothing of the JAX package.
"""HAPSession — the unified planning→execution surface (DESIGN.md §3).

The paper's core claim is *adaptivity*: strategy selection should track
the inference scenario (batch, prompt length, output length) instead of
being frozen at engine construction. ``HAPSession`` makes that a runtime
API:

  - it owns a ``HAPPlanner`` (built lazily — fitting the latency model
    costs ~1 min/chip) and an optional execution mesh,
  - ``plan_for(workload)`` returns a ``HAPPlan`` through a **plan cache
    keyed by workload bucket** (batch, prompt bucket, gen bucket), so the
    ILP is solved once per scenario class and re-used across batches,
  - ``sharding_plan(workload, phase)`` bridges the chosen plan onto the
    mesh via ``HAPPlan.to_sharding_plan``,
  - ``engine(params, ...)`` builds an ``InferenceEngine`` that re-plans
    per scheduler batch and runs the Eq.-6 transition between batches —
    or, through ``engine.serve_continuous()``, re-plans at decode-time
    *admission* on the live workload bucket (active batch size × max
    padded prompt × max output budget), so transitions also fire
    mid-stream (DESIGN.md §4b).

Strategy *sources* are pluggable via the ``PlanSource`` protocol: the ILP
planner, the static TP/EP baselines, and user-pinned plans are one-liner
interchangeable (``HAPSession(cfg, chip, n, source="tp")``), mirroring how
EPS-MoE / HD-MoE treat strategy selection as a first-class runtime input.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Protocol, Union, runtime_checkable

from repro_torch.configs.base import ModelConfig
from .flops import Workload
from .hap import HAPPlan, HAPPlanner, fixed_plan
from .latency import LatencyModel

log = logging.getLogger("repro_torch.session")


# ---------------------------------------------------------------------------
# workload bucketing
# ---------------------------------------------------------------------------
def round_up(x: int, q: int) -> int:
    """x rounded up to a multiple of q (>= 0). The single bucketing rule:
    the scheduler's padding and the session's plan-cache keys both use it,
    so padded batch shapes always land exactly on cache-key edges."""
    return q * -(-max(int(x), 0) // q)


@dataclasses.dataclass(frozen=True)
class WorkloadBucket:
    """Cache key for plan reuse: exact batch (Eq. 5 divisibility depends on
    it) plus prompt/gen lengths rounded up to bucket edges."""
    batch: int
    prompt: int      # bucketed prompt length (upper edge)
    gen: int         # bucketed output length (upper edge)

    def workload(self, dtype_bytes: int = 2) -> Workload:
        return Workload(batch=self.batch, prompt=self.prompt, gen=self.gen,
                        dtype_bytes=dtype_bytes)

    def describe(self) -> str:
        return f"B={self.batch},S<={self.prompt},gen<={self.gen}"


# ---------------------------------------------------------------------------
# plan sources
# ---------------------------------------------------------------------------
@runtime_checkable
class PlanSource(Protocol):
    """Anything that can hand out a HAPPlan for a workload."""

    def plan_for(self, w: Workload) -> HAPPlan:
        ...


class IlpPlanSource:
    """The paper's planner: simulate → prune → ILP (Eq. 4)."""

    def __init__(self, planner: HAPPlanner):
        self.planner = planner

    def plan_for(self, w: Workload) -> HAPPlan:
        return self.planner.plan(w)


class StaticPlanSource:
    """Static baselines (TP everywhere / DeepSpeed-style EP): one plan for
    every workload — what mainstream engines do, and what HAP beats."""

    def __init__(self, planner: HAPPlanner, kind: str = "tp"):
        if kind not in ("tp", "ep"):
            raise ValueError(f"static plan kind must be tp|ep, got {kind!r}")
        self.planner = planner
        self.kind = kind

    def plan_for(self, w: Workload) -> HAPPlan:
        return (self.planner.tp_plan() if self.kind == "tp"
                else self.planner.ep_plan())


class FixedPlanSource:
    """A user-pinned plan (e.g. from ``fixed_plan("TP4", "EP4", "TP4")``)."""

    def __init__(self, plan: HAPPlan):
        self.plan = plan

    def plan_for(self, w: Workload) -> HAPPlan:
        return self.plan


SourceSpec = Union[None, str, HAPPlan, PlanSource]


# ---------------------------------------------------------------------------
# the session facade
# ---------------------------------------------------------------------------
class HAPSession:
    """Owns planner + mesh + bucketed plan cache; builds adaptive engines.

    ``source`` accepts ``"ilp"`` (default), ``"tp"``/``"ep"`` static
    baselines, a concrete ``HAPPlan`` (pinned), a ``"attn=...,prefill=...,
    decode=..."`` spec string, or any ``PlanSource`` object.
    """

    def __init__(self, cfg: ModelConfig, chip: str, n_devices: int, *,
                 source: SourceSpec = None,
                 model: Optional[LatencyModel] = None,
                 mesh=None, prompt_bucket: int = 512, gen_bucket: int = 64,
                 seed: int = 0, fallback: str = "tp"):
        self.cfg = cfg
        self.chip = chip
        self.n_devices = n_devices
        self.mesh = mesh
        self.prompt_bucket = max(1, prompt_bucket)
        self.gen_bucket = max(1, gen_bucket)
        self.fallback = fallback
        self._model = model
        self._seed = seed
        self._planner: Optional[HAPPlanner] = None
        self._source_spec = source
        self._source: Optional[PlanSource] = None
        self._cache: Dict[WorkloadBucket, HAPPlan] = {}
        self.hits = 0
        self.misses = 0
        self.fallbacks = 0   # solves degraded to the static fallback plan
        self.faults = None   # optional FaultInjector (site "ilp")

    # -- lazy planner / source -------------------------------------------
    @property
    def planner(self) -> HAPPlanner:
        if self._planner is None:
            self._planner = HAPPlanner(self.cfg, self.chip, self.n_devices,
                                       model=self._model, seed=self._seed)
        return self._planner

    @property
    def source(self) -> PlanSource:
        if self._source is None:
            self._source = self._resolve_source(self._source_spec)
        return self._source

    def _resolve_source(self, spec: SourceSpec) -> PlanSource:
        if spec is None or spec == "ilp":
            return IlpPlanSource(self.planner)
        if spec in ("tp", "ep"):
            return StaticPlanSource(self.planner, spec)
        if isinstance(spec, str):
            parts = [p.split("=", 1) for p in spec.split(",")]
            if any(len(p) != 2 for p in parts):
                raise ValueError(
                    f"bad plan spec {spec!r} (expected "
                    "'attn=...,prefill=...[,decode=...]')")
            kv = dict(parts)
            unknown = set(kv) - {"attn", "prefill", "decode"}
            if unknown:
                raise ValueError(f"bad plan spec {spec!r}: unknown "
                                 f"key(s) {sorted(unknown)}")
            return FixedPlanSource(fixed_plan(
                kv.get("attn", "TP1"), kv.get("prefill", "TP1"),
                kv.get("decode", "")))
        if isinstance(spec, HAPPlan):
            return FixedPlanSource(spec)
        if isinstance(spec, PlanSource):
            return spec
        raise TypeError(f"cannot build a PlanSource from {spec!r}")

    # -- bucketed planning -----------------------------------------------
    def bucket_of(self, w: Workload) -> WorkloadBucket:
        return WorkloadBucket(
            batch=w.batch,
            prompt=max(round_up(w.prompt, self.prompt_bucket),
                       self.prompt_bucket),
            gen=round_up(w.gen, self.gen_bucket))

    def plan_for(self, w: Workload) -> HAPPlan:
        """Bucketed plan lookup: solve once per (batch, prompt, gen) class."""
        b = self.bucket_of(w)
        plan = self._cache.get(b)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        source = self.source   # resolve OUTSIDE the try: a malformed
        # source spec must raise, not masquerade as ILP infeasibility
        try:
            if self.faults is not None:
                self.faults.fire("ilp")   # injectable solve failure (§4f)
            plan = source.plan_for(b.workload(w.dtype_bytes))
        except Exception as e:   # infeasible OR solver crash: both degrade
            if not self.fallback:
                raise
            self.fallbacks += 1
            log.warning("planner failed for %s (%s: %s); degrading to "
                        "static %s", b.describe(), type(e).__name__, e,
                        self.fallback)
            plan = (self.planner.tp_plan() if self.fallback == "tp"
                    else self.planner.ep_plan())
        self._cache[b] = plan
        log.info("planned %s -> %s", b.describe(), plan.describe())
        return plan

    @property
    def cached_plans(self) -> Dict[WorkloadBucket, HAPPlan]:
        return dict(self._cache)

    # -- bridges -----------------------------------------------------------
    def sharding_plan(self, w: Workload, *, phase: str = "decode"):
        """ShardingPlan for the bucketed plan of ``w`` on the session mesh."""
        return self.plan_for(w).to_sharding_plan(self.mesh, self.cfg,
                                                 phase=phase)

    def transition_between(self, old: HAPPlan, new: HAPPlan, w: Workload):
        """Eq.-6 mechanism + predicted cost for an inter-batch plan switch
        (old plan's decode layout → new plan's prefill layout). Returns
        ``(mechanism, seconds)``; ``("none", 0.0)`` when layouts agree."""
        if old.expert_decode == new.expert_prefill:
            return "none", 0.0
        tc = self.planner.transition_between(w, old.expert_decode,
                                             new.expert_prefill)
        return tc.mechanism, tc.c_ij * self.cfg.num_layers

    def engine(self, params, *, cfg: Optional[ModelConfig] = None,
               max_batch: int = 8, eos_id: int = -1,
               kernel_backend: Optional[str] = None, device=None,
               **engine_kw):
        """Build an adaptive ``InferenceEngine`` bound to this session.

        ``cfg`` overrides the *execution* config (e.g. the reduced variant
        of the tests) while planning stays at the session's full-scale
        config. The engine runs on the card unless ``device="cpu"``;
        ``kernel_backend`` pins the kernel backend ("hopper" | "ref"; None
        follows the device). Extra keywords (``resident_int4``,
        ``use_int4_transition``, ``async_transitions``, ``prefix_cache``,
        ``kv_block_size``, ...) pass through to ``InferenceEngine``.
        """
        from repro_torch.serving.engine import InferenceEngine
        return InferenceEngine(cfg or self.cfg, params, session=self,
                               max_batch=max_batch, eos_id=eos_id,
                               kernel_backend=kernel_backend, device=device,
                               **engine_kw)
