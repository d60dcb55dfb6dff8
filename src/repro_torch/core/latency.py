# The port's own copy of repro.core.latency: the port imports nothing of the JAX package.
"""Inference-latency simulation models (paper §III-B).

  T_cal  = (F_module / peak_FLOPs) * eta,   eta = RF(poly(b, s, h, F, bytes))
  T_comm = (V_data / bandwidth)    * rho,   rho = RF(V, bw)

The random forests are fitted on "measured" operator latencies — here the
synthetic ground-truth surfaces of ``hardware.GroundTruth`` (DESIGN.md §8).
``LatencyModel`` is what the HAP planner queries; ``GroundTruth`` is what
the scenario benchmarks use to score the chosen strategies, so the planner
never sees the evaluation noise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from . import comm as comm_mod
from . import flops as flops_mod
from .flops import Workload
from .hardware import ChipSpec, GroundTruth, get_chip
from .regression import RandomForestRegressor, polynomial_features
from .strategy import AttnStrategy, ExpertStrategy


def _compute_features(b, s, h, f, by, md) -> np.ndarray:
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    lf = np.log(np.maximum(f64(f), 1.0))
    lby = np.log(np.maximum(f64(by), 1.0))
    mdv = f64(md)
    base = np.stack([
        np.log1p(f64(b)),
        np.log1p(f64(s)),
        np.log1p(f64(h)),
        lf,
        lby,
        np.log1p(mdv),
        lf - lby,                          # arithmetic intensity (log)
        np.log(mdv / (mdv + 256.0)),       # tile-quantization factor
    ], axis=-1)
    return polynomial_features(base, degree=2, log_augment=False)


def _comm_features(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    base = np.stack([np.log(np.maximum(v, 1.0))], axis=-1)
    return polynomial_features(base, degree=2, log_augment=False)


class LatencyModel:
    """Fitted eta/rho simulation models for one chip."""

    def __init__(self, chip: ChipSpec, seed: int = 0,
                 n_samples: int = 2500):
        self.chip = chip
        self.gt = GroundTruth(chip, seed=seed)
        self._fit(seed, n_samples)

    # -- calibration (the paper's "systematic benchmarking protocol") -------
    def _sample_op_space(self, rng, n) -> Tuple[np.ndarray, ...]:
        """Operator micro-benchmark space.

        Two op families, mirroring what real inference profiling sweeps:
        - GEMM-like (prefill): flops = 2*b*s*h*h2, bytes = weights + acts.
        - weight-streaming (decode): tiny token count, bytes >> flops —
          low-arithmetic-intensity coverage is essential or eta
          extrapolates badly exactly where the paper's decode analysis
          lives (memory-bound expert reads).
        """
        b = np.exp(rng.uniform(np.log(1), np.log(512), n)).astype(int)
        s = np.exp(rng.uniform(np.log(1), np.log(32768), n)).astype(int)
        h = np.exp(rng.uniform(np.log(512), np.log(16384), n)).astype(int)
        h2 = np.exp(rng.uniform(np.log(512), np.log(32768), n)).astype(int)
        f = 2.0 * b * s * h * h2
        by = (h * h2 * 2.0) + (b * s * (h + h2) * 2.0)
        # decode-style: override half the samples with s=1 and an explicit
        # arithmetic-intensity sweep (AI in [0.25, 2000])
        half = n // 2
        s[:half] = 1
        ai = np.exp(rng.uniform(np.log(0.25), np.log(2000.0), half))
        f[:half] = 2.0 * b[:half] * h[:half] * h2[:half]
        by[:half] = np.maximum(f[:half] / ai, 2.0 * h[:half])
        # narrow-GEMM-dim sweep (tile quantization coverage)
        md = np.exp(rng.uniform(np.log(32), np.log(8192), n)).astype(int)
        return b, s, h, f, by, md

    def _fit(self, seed: int, n: int) -> None:
        rng = np.random.default_rng(seed + 17)
        b, s, h, f, by, md = self._sample_op_space(rng, n)
        eta = np.array([self.gt.eta(fi, bi, mi, noisy=True)
                        for fi, bi, mi in zip(f, by, md)])
        X = _compute_features(b, s, h, f, by, md)
        self.eta_model = RandomForestRegressor(seed=seed).fit(X, eta)

        v = np.exp(rng.uniform(np.log(1e3), np.log(2e10), n))
        rho = np.array([self.gt.rho(vi, noisy=True) for vi in v])
        Xc = _comm_features(v)
        self.rho_model = RandomForestRegressor(seed=seed + 1).fit(Xc, rho)

        # held-out accuracy (Fig. 5 protocol)
        b2, s2, h2, f2, by2, md2 = self._sample_op_space(
            np.random.default_rng(seed + 999), 400)
        eta2 = np.array([self.gt.eta(fi, bi, mi, noisy=False)
                         for fi, bi, mi in zip(f2, by2, md2)])
        t_true = f2 / self.chip.peak_flops * eta2
        t_pred = self.predict_compute(f2, by2, b2, s2, h2, md2)
        self.compute_err = float(np.mean(np.abs(t_pred - t_true) / t_true))
        v2 = np.exp(np.random.default_rng(seed + 998).uniform(
            np.log(1e3), np.log(2e10), 400))
        tc_true = np.array([self.gt.comm_time(vi, noisy=False) for vi in v2])
        tc_pred = self.predict_comm(v2)
        self.comm_err = float(np.mean(np.abs(tc_pred - tc_true) / tc_true))

    # -- prediction ----------------------------------------------------------
    def predict_compute(self, f, by, b, s, h, md=4096.0) -> np.ndarray:
        md = np.broadcast_to(np.asarray(md, np.float64),
                             np.asarray(f, np.float64).shape)
        X = _compute_features(b, s, h, f, by, md)
        eta = self.eta_model.predict(X)
        return np.asarray(f, np.float64) / self.chip.peak_flops * eta

    def predict_comm(self, v) -> np.ndarray:
        v = np.asarray(v, np.float64)
        rho = self.rho_model.predict(_comm_features(v))
        return v / self.chip.link_bw * rho


_MODEL_CACHE: dict = {}


def cached_latency_model(chip_name: str, seed: int = 0,
                         disk_dir: Optional[str] = None) -> "LatencyModel":
    """Memoized (and optionally disk-cached) fitted LatencyModel.

    Fitting the forests takes ~1 min on a single CPU core; benchmarks and
    tests share fitted models through this helper. The disk cache
    (``REPRO_CACHE_DIR``, else ``./.cache``) holds
    ``latency_torch_{chip}_{seed}.pkl``: a name of its own, because the JAX
    package writes ``latency_{chip}_{seed}.pkl`` into the same directory,
    and unpickling that file would import the JAX package's classes.
    """
    import os
    import pickle

    key = (chip_name, seed)
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    path = None
    if disk_dir is None:
        disk_dir = os.environ.get("REPRO_CACHE_DIR",
                                  os.path.join(os.getcwd(), ".cache"))
    if disk_dir:
        os.makedirs(disk_dir, exist_ok=True)
        path = os.path.join(disk_dir, f"latency_torch_{chip_name}_{seed}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                model = pickle.load(f)
            _MODEL_CACHE[key] = model
            return model
    model = LatencyModel(get_chip(chip_name), seed=seed)
    _MODEL_CACHE[key] = model
    if path:
        with open(path, "wb") as f:
            pickle.dump(model, f)
    return model


# ---------------------------------------------------------------------------
# module-level estimators (planner-facing)
# ---------------------------------------------------------------------------
def overlapped_comm(t_comm: float, t_compute: float, chunks: int) -> float:
    """Exposed comm time under the EP micro-batch pipeline (DESIGN.md §4e).

    With K capacity slabs in flight, each slab's all_to_all overlaps a
    neighbouring slab's expert FFN, so only the pipeline fill/drain
    (t_comm / K) plus whatever comm exceeds the compute it hides behind
    stays on the critical path:

        t_exposed = t_comm/K + max(0, t_comm - t_compute) * (K-1)/K

    Compute-bound layers (t_comm << t_compute) expose ~t_comm/K; comm-
    bound layers degrade gracefully to t_comm - t_compute*(K-1)/K — the
    compute is the only thing available to hide behind.
    """
    if chunks <= 1 or t_comm <= 0.0:
        return t_comm
    k = float(chunks)
    return t_comm / k + max(0.0, t_comm - t_compute) * (k - 1.0) / k


def ep_pipeline_chunks(cfg: ModelConfig, w: Workload, phase: str, e,
                       n_devices: int, knob: int = 0) -> int:
    """Model-side mirror of ``models.moe.pipeline_chunks``: the K the
    runtime will pick for this workload, from the per-device dispatch
    capacity (same ceil-to-8 rule as ``moe.capacity``)."""
    if knob == 1 or not cfg.is_moe:
        return 1
    t_loc = max(w.tokens(phase) // max(n_devices // e.tp, 1), 1)
    c = np.ceil(t_loc * cfg.top_k / cfg.n_routed_experts
                * cfg.capacity_factor)
    c_loc = max(8, int(np.ceil(c / 8) * 8))
    if knob >= 2:
        return min(knob, c_loc)
    if e.ep <= 1:
        return 1
    for k in (4, 2):
        if c_loc >= 8 * k:
            return k
    return 1


@dataclasses.dataclass
class ModuleCosts:
    """Per-layer latencies for one (attention, expert) strategy pair."""
    t_attn: float
    t_expert: float
    t_comm: float

    @property
    def total(self) -> float:
        return self.t_attn + self.t_expert + self.t_comm


class InferenceSimulator:
    """Glues the cost models to a LatencyModel (or the ground truth)."""

    def __init__(self, cfg: ModelConfig, chip_name: str, n_devices: int,
                 model: Optional[LatencyModel] = None, seed: int = 0):
        self.cfg = cfg
        self.chip = get_chip(chip_name)
        self.n = n_devices
        self.model = model or LatencyModel(self.chip, seed=seed)
        self.gt = GroundTruth(self.chip, seed=seed + 7)

    # -- planner-facing (fitted models) --------------------------------------
    def attn_time(self, w: Workload, phase: str, a: AttnStrategy) -> float:
        f = flops_mod.attn_flops_dev(self.cfg, w, phase, a)
        by = flops_mod.attn_bytes(self.cfg, w, phase, a)
        t = self.model.predict_compute(
            [f], [by], [w.tokens(phase) / a.dp], [w.ctx(phase)],
            [self.cfg.d_model], [self._attn_min_dim(a)])
        return float(t[0])

    def _attn_min_dim(self, a: AttnStrategy) -> float:
        if self.cfg.has_attention:
            per_dev = self.cfg.q_dim / a.tp
        else:
            per_dev = self.cfg.ssm_d_inner / a.tp
        return min(self.cfg.d_model, per_dev)

    def _expert_min_dim(self, e: ExpertStrategy) -> float:
        f = (self.cfg.moe_d_ff if self.cfg.is_moe
             else (self.cfg.d_ff or self.cfg.d_model))
        return min(self.cfg.d_model, f / e.tp)

    def expert_time(self, w: Workload, phase: str, e: ExpertStrategy,
                    resident_int4: bool = False,
                    replication=None) -> float:
        """Per-layer expert-module time under strategy ``e``.

        ``resident_int4`` models INT4-resident serving: weight reads
        shrink to INT4_BYTES_PER_PARAM per param but every invocation
        pays the fused dequant of the weights it touches (HBM-bound:
        nibble read + fp write — ``GroundTruth.dequant_time``).

        ``replication`` (an ``ExpertReplication`` or per-expert degree
        sequence) models hot-expert replication under EP: the busiest
        device's load drops from max_e f_e to max_e f_e/r_e, which
        scales the imbalance-inflated compute term down by that ratio.
        """
        f = flops_mod.expert_flops_dev(self.cfg, w, phase, e)
        if f <= 0:
            return 0.0
        f *= self._replication_factor(e, replication)
        by = flops_mod.expert_bytes(self.cfg, w, phase, e)
        dequant = 0.0
        if resident_int4 and self.cfg.is_moe:
            from .transition import INT4_BYTES_PER_PARAM
            wb = flops_mod.expert_weight_bytes(self.cfg, w.dtype_bytes) \
                / (e.tp * e.ep)
            w_params = wb / w.dtype_bytes
            by = max(by - wb * (1 - INT4_BYTES_PER_PARAM / w.dtype_bytes),
                     0.0)
            dequant = self.gt.dequant_time(w_params)
        t = self.model.predict_compute(
            [f], [by], [w.tokens(phase) / max(self.n // (e.tp * e.ep), 1)],
            [w.ctx(phase)], [self.cfg.d_model], [self._expert_min_dim(e)])
        return float(t[0]) + dequant

    def _replication_factor(self, e: ExpertStrategy, replication) -> float:
        """Hot-load reduction from replica degrees, in [1/max_deg, 1]."""
        if replication is None or e.ep <= 1 or not self.cfg.is_moe:
            return 1.0
        degrees = getattr(replication, "degrees", replication)
        degrees = [max(int(d), 1) for d in degrees]
        if not degrees or all(d == 1 for d in degrees):
            return 1.0
        # Ideal water-filled case (the planner grants replicas to the
        # actually-hot experts until per-replica loads equalize): the
        # busiest slot's load drops by the slot-count ratio. A lower
        # bound on the real skew, but monotone in the replica budget —
        # which is what the ILP's relative comparisons need.
        return len(degrees) / float(sum(degrees))

    def prefetch_time(self, w: Workload, *, window_steps: int = 1) -> float:
        """Amortized per-decode-step bandwidth cost of keeping ONE extra
        replica slot fresh through predictive prefetch (DESIGN.md §5c).

        A granted replica slot is one more expert whose weights the
        engine re-pulls (INT4 wire format — nibbles plus per-group
        scale/zero) every rebalance window; the pull shares the
        host-device link with the predictive prefetch of next-layer
        experts, so its bandwidth is the price replication pays. The
        one-expert pull time (rho comm model over the INT4 bytes)
        divided by the ``window_steps`` decode steps it amortizes over
        is the per-step term the degree search weighs against the
        bottleneck-load gain.
        """
        if not self.cfg.is_moe:
            return 0.0
        from .transition import INT4_BYTES_PER_PARAM
        wb = flops_mod.expert_weight_bytes(self.cfg, w.dtype_bytes)
        per_expert_params = (wb / w.dtype_bytes) / self.cfg.n_routed_experts
        v = per_expert_params * INT4_BYTES_PER_PARAM
        if v <= 0:
            return 0.0
        t = float(self.model.predict_comm([v])[0])
        return t / max(int(window_steps), 1)

    def replication_search(self, w: Workload, e: ExpertStrategy,
                           freqs, *, max_extra: int,
                           max_degree: Optional[int] = None,
                           window_steps: int = 64) -> tuple:
        """Search per-expert replica degrees: decode-time gain priced by
        ``expert_time`` against the prefetch-bandwidth cost of each
        extra slot (``prefetch_time``). ``max_extra`` is the operator
        knob demoted to a CAP — the search decides how much of it
        actually pays on this workload (uniform routing grants zero).
        """
        from .ilp import searched_replication_degrees
        t_exp = self.expert_time(w, "decode", e)
        return searched_replication_degrees(
            freqs,
            gain_scale=t_exp * self.cfg.n_routed_experts,
            cost_per_replica=self.prefetch_time(w, window_steps=window_steps),
            max_extra=max_extra,
            max_degree=max_degree,
        )

    def comm_time(self, w: Workload, phase: str, a: AttnStrategy,
                  e: ExpertStrategy, pipeline_chunks: int = 1) -> float:
        """Per-layer comm time; ``pipeline_chunks`` > 1 applies the EP
        micro-batch overlap model (``overlapped_comm``) — the all2all
        hides behind the expert FFN it pipelines against, so only the
        exposed remainder reaches the ILP's comm term."""
        v = comm_mod.layer_comm_bytes(self.cfg, w, phase, a, e, self.n)
        if v <= 0:
            return 0.0
        t = float(self.model.predict_comm([v])[0])
        if pipeline_chunks > 1 and e.ep > 1:
            t = overlapped_comm(t, self.expert_time(w, phase, e),
                                pipeline_chunks)
        return t

    def layer_costs(self, w: Workload, phase: str, a: AttnStrategy,
                    e: ExpertStrategy,
                    pipeline_chunks: int = 1) -> ModuleCosts:
        return ModuleCosts(self.attn_time(w, phase, a),
                           self.expert_time(w, phase, e),
                           self.comm_time(w, phase, a, e,
                                          pipeline_chunks=pipeline_chunks))

    # -- evaluation-facing (ground truth, with noise) -------------------------
    def true_layer_time(self, w: Workload, phase: str, a: AttnStrategy,
                        e: ExpertStrategy, noisy: bool = False) -> float:
        fa = flops_mod.attn_flops_dev(self.cfg, w, phase, a)
        ba = flops_mod.attn_bytes(self.cfg, w, phase, a)
        t = self.gt.compute_time(fa, ba, self._attn_min_dim(a), noisy=noisy)
        fe = flops_mod.expert_flops_dev(self.cfg, w, phase, e)
        if fe > 0:
            be = flops_mod.expert_bytes(self.cfg, w, phase, e)
            t += self.gt.compute_time(fe, be, self._expert_min_dim(e),
                                      noisy=noisy)
        v = comm_mod.layer_comm_bytes(self.cfg, w, phase, a, e, self.n)
        if v > 0:
            t += self.gt.comm_time(v, hops=comm_mod.comm_events(a, e),
                                   noisy=noisy)
        return t
