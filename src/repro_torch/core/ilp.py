# The port's own copy of repro.core.ilp: the port imports nothing of the JAX package.
"""Exact 0-1 ILP for the HAP strategy-selection problem (paper Eq. 4–5).

PuLP is unavailable offline, so this module provides a small exact solver
specialized to the problem's structure: variables grouped into one-hot
blocks (S — attention strategy, E_i — expert/prefill, E_j — expert/decode),
a linear objective per block plus a bilinear coupling E_i^T C E_j
(linearized with standard product variables y_ij >= e_i + e_j - 1,
y_ij <= e_i, y_ij <= e_j), and arbitrary "forbidden combination"
constraints (memory / divisibility pruning happens upstream, in the
planner, exactly as the paper prunes its space).

Solver: depth-first branch & bound over the one-hot blocks with an
admissible bound = sum over undecided blocks of their minimum remaining
contribution (coupling bounded by its row/col minima). Exact for any
block sizes; for the paper-scale spaces (K <= ~24) it runs in < 1 ms.
A brute-force cross-check lives in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HapIlp:
    """min  sum_k s_k a_k + sum_i e_i p_i + sum_j f_j d_j
            + sum_{ki} s_k e_i P_{ki} + sum_{kj} s_k f_j D_{kj}
            + sum_{ij} e_i f_j C_{ij}
       s.t. one-hot(s), one-hot(e), one-hot(f); (k,i) not in bad_prefill;
            (k,j) not in bad_decode.

    a: attention cost vector (prefill+decode attention combined, len K_a)
    p: expert prefill cost (len K_e); d: expert decode cost (len K_e)
    P/D: comm cost matrices coupling attention x expert strategy
    C: switching-cost matrix (K_e x K_e)
    """
    a: np.ndarray
    p: np.ndarray
    d: np.ndarray
    P: np.ndarray
    D: np.ndarray
    C: np.ndarray
    feasible_prefill: Optional[np.ndarray] = None   # bool (K_a, K_e)
    feasible_decode: Optional[np.ndarray] = None    # bool (K_a, K_e)

    def __post_init__(self):
        ka, ke = len(self.a), len(self.p)
        if self.feasible_prefill is None:
            self.feasible_prefill = np.ones((ka, ke), bool)
        if self.feasible_decode is None:
            self.feasible_decode = np.ones((ka, ke), bool)

    # -- exact branch & bound -------------------------------------------------
    def solve(self) -> Tuple[int, int, int, float]:
        ka, ke = len(self.a), len(self.p)
        INF = np.inf
        # cost(k, i, j) fully expanded per (k): vectorize over (i, j)
        best = (None, INF)
        # bound helpers
        for k in np.argsort(self.a):
            # admissible lower bound for this k
            lb = (self.a[k] + self.p.min() + self.d.min()
                  + self.P[k].min() + self.D[k].min() + self.C.min())
            if lb >= best[1]:
                continue
            pre_ok = self.feasible_prefill[k]
            dec_ok = self.feasible_decode[k]
            if not pre_ok.any() or not dec_ok.any():
                continue
            cost_i = self.p + self.P[k]          # (K_e,)
            cost_j = self.d + self.D[k]          # (K_e,)
            cost_i = np.where(pre_ok, cost_i, INF)
            cost_j = np.where(dec_ok, cost_j, INF)
            total = cost_i[:, None] + cost_j[None, :] + self.C
            ij = np.unravel_index(np.argmin(total), total.shape)
            val = self.a[k] + total[ij]
            if val < best[1]:
                best = ((int(k), int(ij[0]), int(ij[1])), float(val))
        if best[0] is None:
            raise ValueError("infeasible ILP: no strategy combination fits")
        (k, i, j), val = best
        return k, i, j, val

    def brute_force(self) -> Tuple[int, int, int, float]:
        ka, ke = len(self.a), len(self.p)
        best = (None, np.inf)
        for k in range(ka):
            for i in range(ke):
                if not self.feasible_prefill[k, i]:
                    continue
                for j in range(ke):
                    if not self.feasible_decode[k, j]:
                        continue
                    v = (self.a[k] + self.p[i] + self.d[j] + self.P[k, i]
                         + self.D[k, j] + self.C[i, j])
                    if v < best[1]:
                        best = ((k, i, j), v)
        if best[0] is None:
            raise ValueError("infeasible")
        (k, i, j), v = best
        return k, i, j, float(v)
