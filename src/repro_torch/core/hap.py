# The port's own copy of repro.core.hap: the port imports nothing of the JAX package.
"""HAP planner: search space -> simulated costs -> ILP -> plan.

This is the paper's top-level algorithm (§III). Given a model config, a
hardware platform, a device count and a workload (context length, output
length, batch), it:

 1. enumerates legal Attention strategies {DP, TP, DPxTP} and Expert
    strategies {EP, TP, EPxTP} (strategy.py),
 2. prices every module under every strategy with the fitted eta/rho
    simulation models (latency.py), plus the pairwise comm matrices and
    the Eq.-6 switching-cost matrix C (transition.py),
 3. prunes by the Eq.-5 memory constraint,
 4. solves the ILP (ilp.py) for (attention k, expert-prefill i,
    expert-decode j) minimizing Eq. 4,
 5. returns a HAPPlan; ``to_sharding_plan`` maps it onto a mesh of ranks
    (the null plan on one device).

The ILP solver runtime is recorded and — as in the paper's methodology —
included in the end-to-end latency the benchmarks report.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from .flops import Workload, memory_feasible
from .hardware import get_chip
from .ilp import HapIlp
from .latency import InferenceSimulator, LatencyModel
from .strategy import (AttnStrategy, ExpertStrategy, attention_strategies,
                       expert_strategies)
from .transition import switching_matrix


@dataclasses.dataclass
class HAPPlan:
    attn: AttnStrategy
    expert_prefill: ExpertStrategy
    expert_decode: ExpertStrategy
    predicted_latency: float
    ilp_time: float
    switch_cost: float
    mechanism: str

    @property
    def switches(self) -> bool:
        return self.expert_prefill != self.expert_decode

    def describe(self) -> str:
        s = (f"attn={self.attn.name} expert_prefill="
             f"{self.expert_prefill.name} expert_decode="
             f"{self.expert_decode.name}")
        if self.switches:
            s += f" (transition via {self.mechanism})"
        return s

    def to_sharding_plan(self, mesh, cfg, *, phase: str = "decode"):
        """The execution layout of ``phase`` on ``mesh`` (a ``RankMesh``):
        the strategy degrees become axis assignments (DESIGN.md §5), and
        ``phase`` picks the expert layout, which may switch between
        prefill and decode (Eq. 6). With ``mesh=None`` this is None, the
        null plan (unsharded single-device execution)."""
        from repro_torch.sharding.specs import strategy_sharding_plan
        if phase not in ("prefill", "decode"):
            raise ValueError(f"phase must be prefill|decode, got {phase!r}")
        if mesh is None:
            return None
        expert = (self.expert_prefill if phase == "prefill"
                  else self.expert_decode)
        return strategy_sharding_plan(mesh, cfg, self.attn, expert)


def fixed_plan(attn: str, expert_prefill: str,
               expert_decode: str = "", mechanism: str = "reshard"
               ) -> HAPPlan:
    """A user-pinned plan from strategy names, e.g.
    ``fixed_plan("DP2xTP2", "EP4", "TP4")`` — for CLI overrides and tests.
    """
    ep = ExpertStrategy.parse(expert_prefill)
    ed = ExpertStrategy.parse(expert_decode) if expert_decode else ep
    return HAPPlan(attn=AttnStrategy.parse(attn), expert_prefill=ep,
                   expert_decode=ed, predicted_latency=float("nan"),
                   ilp_time=0.0, switch_cost=0.0,
                   mechanism=mechanism if ep != ed else "none")


class HAPPlanner:
    def __init__(self, cfg: ModelConfig, chip: str, n_devices: int,
                 model: Optional[LatencyModel] = None, seed: int = 0,
                 moe_pipeline: int = 0, async_transitions: bool = True):
        self.cfg = cfg
        self.chip = get_chip(chip)
        self.n = n_devices
        # Overlap knobs mirroring the serving engine: ``moe_pipeline`` is
        # the EP micro-batch pipeline depth (0 = auto) priced through
        # ``latency.overlapped_comm``; ``async_transitions`` selects the
        # background-thread restore executor, which keeps Eq. 6's overlap
        # term (False prices the blocking restore: t_overlap = 0).
        self.moe_pipeline = moe_pipeline
        self.async_transitions = async_transitions
        self.sim = InferenceSimulator(cfg, chip, n_devices, model=model,
                                      seed=seed)
        self.attn_space: List[AttnStrategy] = attention_strategies(
            cfg, n_devices)
        self.expert_space: List[ExpertStrategy] = expert_strategies(
            cfg, n_devices)

    # ------------------------------------------------------------------
    def _cost_tensors(self, w: Workload):
        L = self.cfg.num_layers
        S_out = max(w.gen, 0)
        Ka, Ke = len(self.attn_space), len(self.expert_space)

        a = np.zeros(Ka)
        for k, s in enumerate(self.attn_space):
            a[k] = L * (self.sim.attn_time(w, "prefill", s)
                        + S_out * self.sim.attn_time(w, "decode", s))
        p = np.array([L * self.sim.expert_time(w, "prefill", e)
                      for e in self.expert_space])
        d = np.array([L * S_out * self.sim.expert_time(w, "decode", e)
                      for e in self.expert_space])
        P = np.zeros((Ka, Ke))
        D = np.zeros((Ka, Ke))
        from .latency import ep_pipeline_chunks
        for k, s in enumerate(self.attn_space):
            for i, e in enumerate(self.expert_space):
                kp = ep_pipeline_chunks(self.cfg, w, "prefill", e, self.n,
                                        self.moe_pipeline)
                kd = ep_pipeline_chunks(self.cfg, w, "decode", e, self.n,
                                        self.moe_pipeline)
                P[k, i] = L * self.sim.comm_time(w, "prefill", s, e,
                                                 pipeline_chunks=kp)
                D[k, i] = L * S_out * self.sim.comm_time(
                    w, "decode", s, e, pipeline_chunks=kd)

        # Eq. 6 overlap window: one layer's prefill time under strategy i
        # (attention term approximated with the cheapest attention strategy,
        # as the paper's C is indexed by expert strategies only).
        t_attn_pre = min(self.sim.attn_time(w, "prefill", s)
                         for s in self.attn_space)
        t_layer = np.array([t_attn_pre
                            + self.sim.expert_time(w, "prefill", e)
                            for e in self.expert_space])
        C = switching_matrix(self.cfg, w, self.chip, self.n,
                             self.expert_space, t_layer, gt=self.sim.gt,
                             async_restore=self.async_transitions)

        feas = np.zeros((Ka, Ke), bool)
        for k, s in enumerate(self.attn_space):
            # paper Eq. 5: B = b * A_d with b a positive integer — the
            # attention-DP degree must divide the request batch.
            if w.batch % s.dp:
                continue
            for i, e in enumerate(self.expert_space):
                feas[k, i] = memory_feasible(self.cfg, w, s, e, self.n,
                                             self.chip.mem_capacity,
                                             w.dtype_bytes)
        return a, p, d, P, D, C, feas

    # ------------------------------------------------------------------
    def plan(self, w: Workload) -> HAPPlan:
        t0 = time.perf_counter()
        a, p, d, P, D, C, feas = self._cost_tensors(w)
        ilp = HapIlp(a=a, p=p, d=d, P=P, D=D, C=C,
                     feasible_prefill=feas, feasible_decode=feas)
        k, i, j, val = ilp.solve()
        dt = time.perf_counter() - t0
        return HAPPlan(
            attn=self.attn_space[k],
            expert_prefill=self.expert_space[i],
            expert_decode=self.expert_space[j],
            predicted_latency=val,
            ilp_time=dt,
            switch_cost=float(C[i, j]),
            mechanism=self._mechanism(w, i, j),
        )

    def searched_replication(self, w: Workload, e_decode: ExpertStrategy,
                             freqs, *, max_extra: int,
                             max_degree: Optional[int] = None,
                             window_steps: int = 64) -> tuple:
        """Per-expert replica degrees as part of the strategy search.

        ``replicate_experts`` stops being a fixed operator knob here: it
        is only the CAP on extra slots, and the latency model decides how
        many actually pay — each water-filled grant's bottleneck-load
        gain (priced by ``expert_time``) is weighed against the
        prefetch-bandwidth cost of keeping one more slot fresh
        (``InferenceSimulator.prefetch_time``, amortized over the
        ``window_steps`` rebalance window). Uniform routing grants
        nothing; skewed routing concentrates degrees on the hot experts.
        The engine's ``_maybe_rebalance`` consumes these degrees through
        ``plan_replication(degrees=...)``.
        """
        return self.sim.replication_search(
            w, e_decode, freqs, max_extra=max_extra,
            max_degree=max_degree, window_steps=window_steps)

    def transition_between(self, w: Workload, e_from: ExpertStrategy,
                           e_to: ExpertStrategy):
        """Eq.-6 cost terms for switching the expert layout e_from→e_to
        under workload ``w`` (used both for the in-plan prefill→decode
        switch and for inter-batch plan switches in the serving engine)."""
        from .transition import transition_costs
        t_layer = (self.sim.attn_time(w, "prefill", self.attn_space[0])
                   + self.sim.expert_time(w, "prefill", e_from))
        return transition_costs(self.cfg, w, self.chip, self.n, e_from,
                                e_to, t_layer, gt=self.sim.gt,
                                async_restore=self.async_transitions)

    def _mechanism(self, w: Workload, i: int, j: int) -> str:
        ei, ej = self.expert_space[i], self.expert_space[j]
        if ei == ej:
            return "none"
        return self.transition_between(w, ei, ej).mechanism

    # -- static baselines ----------------------------------------------------
    def tp_plan(self) -> HAPPlan:
        """Mainstream static TP everywhere (the paper's baseline)."""
        a = next(s for s in self.attn_space
                 if s.tp == max(x.tp for x in self.attn_space))
        e = next(s for s in self.expert_space
                 if s.ep == 1 and s.tp == max(
                     x.tp for x in self.expert_space if x.ep == 1))
        return HAPPlan(a, e, e, float("nan"), 0.0, 0.0, "none")

    def ep_plan(self) -> HAPPlan:
        """Static EP for experts (DeepSpeed-MoE style)."""
        a = self.tp_plan().attn
        cand = [s for s in self.expert_space if s.ep > 1]
        e = max(cand, key=lambda s: s.ep) if cand else self.tp_plan().expert_prefill
        return HAPPlan(a, e, e, float("nan"), 0.0, 0.0, "none")

    # -- evaluation under ground truth ----------------------------------------
    def evaluate(self, plan: HAPPlan, w: Workload, noisy: bool = False,
                 include_ilp_time: bool = True) -> float:
        """End-to-end latency of a plan under the ground-truth simulator."""
        L = self.cfg.num_layers
        t = L * self.sim.true_layer_time(w, "prefill", plan.attn,
                                         plan.expert_prefill, noisy)
        t += w.gen * L * self.sim.true_layer_time(w, "decode", plan.attn,
                                                  plan.expert_decode, noisy)
        t += plan.switch_cost
        if include_ilp_time:
            t += plan.ilp_time
        return t
