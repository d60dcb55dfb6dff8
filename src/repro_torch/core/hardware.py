# The port's own copy of repro.core.hardware: the port imports nothing of the JAX package.
"""Hardware models: chip specs + synthetic operator-latency ground truth.

The paper calibrates its simulation models (eta for compute, rho for
communication) against *measured* operator latencies on A100/A6000/V100
nodes. This dev container has no accelerator, so measurements are replaced
by a physically-grounded synthetic surface (documented in DESIGN.md §8):

  T_compute(F, bytes) = max(F / (peak * mfu(AI)), bytes / (hbm * util(sz)))
                        + kernel launch floor, * (1 + noise)
  T_comm(V)           = alpha * hops + V_wire / bw_eff(V), * (1 + noise)

mfu rises with arithmetic intensity (roofline knee) and saturates below 1;
bw_eff follows the classic half-bandwidth-point curve (small messages are
latency-bound — the paper's PCIe-vs-NVLink sensitivity lives here).

The SAME surfaces play two roles:
 1. "measurement" source for fitting the eta/rho random forests (Fig. 5),
 2. ground-truth evaluator for HAP-vs-TP scenario benchmarks (Figs. 4–9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float          # bf16/fp16 tensor FLOP/s
    hbm_bw: float              # bytes/s
    mem_capacity: float        # bytes
    link_bw: float             # bytes/s per direction, intra-node interconnect
    link_latency: float        # s per collective hop (alpha)
    interconnect: str          # "nvlink" | "pcie" | "ici"
    h2d_bw: float = 25e9       # host->device bytes/s (PCIe upload path)
    # efficiency-surface shape parameters
    mfu_max: float = 0.85
    ai_knee: float = 180.0     # arithmetic intensity at the roofline knee
    mem_util: float = 0.85
    launch_floor: float = 6e-6
    bw_half_point: float = 4e6  # message bytes at half effective bandwidth


# Paper platforms + our TPU target. Link bandwidths are effective
# per-device collective bandwidths (not marketing aggregates).
CHIPS: Dict[str, ChipSpec] = {
    "a100": ChipSpec("a100", peak_flops=312e12, hbm_bw=2039e9,
                     mem_capacity=80e9, link_bw=250e9, link_latency=4e-6,
                     interconnect="nvlink", bw_half_point=8e6),
    # PCIe link_bw values are measured ring-collective bus bandwidths
    # (root-complex contention), not marketing p2p rates: PCIe gen4 x16
    # multi-GPU allreduce sustains ~10-13 GB/s/device, gen3 ~6-8 GB/s.
    "a6000": ChipSpec("a6000", peak_flops=155e12, hbm_bw=768e9,
                      mem_capacity=48e9, link_bw=12e9, link_latency=8e-6,
                      interconnect="pcie", bw_half_point=2e6),
    "v100": ChipSpec("v100", peak_flops=112e12, hbm_bw=900e9,
                     mem_capacity=32e9, link_bw=7e9, link_latency=10e-6,
                     interconnect="pcie", bw_half_point=2e6),
    # NVIDIA H100 SXM5 (data sheet): 989 TFLOP/s dense bf16, 3.35 TB/s
    # HBM3, 80 GB. NVLink 4 carries 450 GB/s per direction; derated to an
    # effective collective bandwidth by the a100 entry's ratio (250 of
    # NVLink 3's 300 GB/s per direction): 450 * 250 / 300 = 375 GB/s.
    # h2d_bw is PCIe Gen5 x16 (64 GB/s per direction) derated by the
    # default's ratio for Gen4 (25 of 32 GB/s): 50 GB/s.
    "h100": ChipSpec("h100", peak_flops=989e12, hbm_bw=3.35e12,
                     mem_capacity=80e9, link_bw=375e9, link_latency=4e-6,
                     interconnect="nvlink", h2d_bw=50e9, bw_half_point=8e6),
    # TPU v5e: brief-mandated roofline constants
    "tpu_v5e": ChipSpec("tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                        mem_capacity=16e9, link_bw=50e9, link_latency=2e-6,
                        interconnect="ici", bw_half_point=4e6),
}


def get_chip(name: str) -> ChipSpec:
    return CHIPS[name.lower().replace("-", "_")]


# ---------------------------------------------------------------------------
# synthetic ground-truth surfaces
# ---------------------------------------------------------------------------
class GroundTruth:
    """Deterministic-noise synthetic operator latency 'measurements'."""

    def __init__(self, chip: ChipSpec, noise: float = 0.03, seed: int = 0):
        self.chip = chip
        self.noise = noise
        self._rng = np.random.default_rng(seed)

    # -- compute -----------------------------------------------------------
    def mfu(self, flops: float, bytes_moved: float,
            min_dim: float = 4096.0) -> float:
        """Achievable FLOP utilization.

        Two physical effects: the roofline knee in arithmetic intensity,
        and tile quantization — GEMMs whose narrowest dim is small (e.g.
        a fine-grained expert's d_ff sliced by TP: 1408/4 = 352) underfill
        the MXU / tensor cores. The latter is the paper's challenge #1
        ("fixed tensor partition fails to fully leverage the computational
        capabilities of the hardware for specific operators").
        """
        ai = flops / max(bytes_moved, 1.0)
        c = self.chip
        quant = min_dim / (min_dim + 256.0)
        return c.mfu_max * (1.0 - np.exp(-ai / c.ai_knee)) * quant

    def compute_time(self, flops: float, bytes_moved: float,
                     min_dim: float = 4096.0, noisy: bool = True) -> float:
        c = self.chip
        t_flop = flops / (c.peak_flops * max(
            self.mfu(flops, bytes_moved, min_dim), 1e-3))
        t_mem = bytes_moved / (c.hbm_bw * c.mem_util)
        t = max(t_flop, t_mem) + c.launch_floor
        if noisy:
            t *= 1.0 + self.noise * self._rng.standard_normal()
        return max(t, c.launch_floor)

    def eta(self, flops: float, bytes_moved: float,
            min_dim: float = 4096.0, noisy: bool = False) -> float:
        """The paper's eta: T_measured * peak / F (>= 1 in practice)."""
        t = self.compute_time(flops, bytes_moved, min_dim, noisy=noisy)
        return t * self.chip.peak_flops / max(flops, 1.0)

    # -- communication -------------------------------------------------------
    def bw_eff(self, volume: float) -> float:
        c = self.chip
        return c.link_bw * volume / (volume + c.bw_half_point)

    def comm_time(self, volume: float, hops: int = 1,
                  noisy: bool = True) -> float:
        """volume: per-device wire bytes for the whole collective."""
        c = self.chip
        t = c.link_latency * max(hops, 1) + volume / max(
            self.bw_eff(max(volume, 1.0)), 1.0)
        if noisy:
            t *= 1.0 + self.noise * self._rng.standard_normal()
        return t

    def rho(self, volume: float, noisy: bool = False) -> float:
        """The paper's rho: T_measured * bw / V."""
        t = self.comm_time(volume, noisy=noisy)
        return t * self.chip.link_bw / max(volume, 1.0)

    # -- transition helpers ----------------------------------------------------
    def h2d_time(self, volume: float) -> float:
        return volume / self.chip.h2d_bw + 20e-6

    def dequant_time(self, n_params: float) -> float:
        # int4 read + bf16 write, HBM-bound
        return n_params * 2.5625 / (self.chip.hbm_bw * self.chip.mem_util)
