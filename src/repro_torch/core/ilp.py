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
from typing import List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# generic 0-1 ILP with one-hot blocks (used for tests & extensions)
# ---------------------------------------------------------------------------
class OneHotIlp:
    """min c^T x + x^T Q x over one-hot blocks; exact DFS branch & bound.

    blocks: list of index lists; exactly one variable per block is 1.
    Q may couple variables across blocks (bilinear terms are handled by
    direct evaluation during search — equivalent to the y_ij linearization
    since blocks are one-hot).
    """

    def __init__(self, c: np.ndarray, Q: Optional[np.ndarray],
                 blocks: Sequence[Sequence[int]],
                 forbidden: Sequence[Tuple[int, int]] = ()):
        self.c = np.asarray(c, float)
        n = len(self.c)
        self.Q = np.zeros((n, n)) if Q is None else np.asarray(Q, float)
        self.blocks = [list(b) for b in blocks]
        self.forbidden = set(tuple(sorted(f)) for f in forbidden)

    def solve(self) -> Tuple[List[int], float]:
        order = sorted(range(len(self.blocks)),
                       key=lambda b: -len(self.blocks[b]))
        best: Tuple[Optional[List[int]], float] = (None, np.inf)
        chosen: List[int] = []

        def lower_bound(next_pos: int, cur: float) -> float:
            lb = cur
            for bpos in range(next_pos, len(order)):
                blk = self.blocks[order[bpos]]
                lb += min(self.c[v] + min(0.0, self.Q[v].min()
                                          + self.Q[:, v].min())
                          for v in blk)
            return lb

        def value_with(v: int) -> float:
            val = self.c[v]
            for u in chosen:
                val += self.Q[u, v] + self.Q[v, u]
            val += self.Q[v, v]
            return val

        def dfs(pos: int, cur: float):
            nonlocal best
            if pos == len(order):
                if cur < best[1]:
                    best = (list(chosen), cur)
                return
            if lower_bound(pos, cur) >= best[1]:
                return
            blk = self.blocks[order[pos]]
            cand = sorted(blk, key=lambda v: self.c[v])
            for v in cand:
                if any(tuple(sorted((u, v))) in self.forbidden
                       for u in chosen):
                    continue
                chosen.append(v)
                dfs(pos + 1, cur + value_with(v))
                chosen.pop()

        dfs(0, 0.0)
        if best[0] is None:
            raise ValueError("infeasible")
        return sorted(best[0]), best[1]


def replication_degrees(freqs: Sequence[float], extra_replicas: int,
                        max_degree: Optional[int] = None) -> Tuple[int, ...]:
    """Water-filling replica assignment for hot-expert replication.

    Greedy: every expert starts at one replica; each of the
    ``extra_replicas`` grants goes to the expert with the highest
    per-replica load ``f_e / r_e``. For the minimize-the-max-load
    objective the greedy exchange argument makes this exact (each grant
    is the unique step that lowers the current maximum the most), so no
    ILP extension is needed — the planner treats replication as a
    post-pass on the selected expert strategy.

    Ties break toward the lower expert id, keeping the plan
    deterministic under identical frequency snapshots.
    """
    f = np.maximum(np.asarray(freqs, np.float64), 0.0)
    n = f.size
    if n == 0:
        return ()
    if f.sum() <= 0:
        f = np.ones(n)
    degrees = np.ones(n, dtype=np.int64)
    for _ in range(max(int(extra_replicas), 0)):
        load = f / degrees
        if max_degree is not None:
            load[degrees >= max_degree] = -1.0
        e = int(np.argmax(load))
        if load[e] < 0:
            break
        degrees[e] += 1
    return tuple(int(d) for d in degrees)


def searched_replication_degrees(
    freqs: Sequence[float],
    *,
    gain_scale: float,
    cost_per_replica: float,
    max_extra: int,
    max_degree: Optional[int] = None,
) -> Tuple[int, ...]:
    """Per-expert replica degrees SEARCHED against prefetch bandwidth.

    Extends the water-filling above from "spend a fixed operator budget"
    to "spend while it pays": each candidate grant still goes to the
    bottleneck expert (highest per-replica load f_e / r_e), but it is
    only accepted while the decode-time gain it buys exceeds the
    bandwidth cost of keeping one more replica slot fresh.

    ``gain_scale`` prices bottleneck load in seconds: the busiest EP
    device's expert time is ~ t_expert_uniform * E * max_e(f_e / r_e),
    so a grant that drops the max load by Δ is worth gain_scale * Δ
    seconds per decode step (gain_scale = t_expert * n_experts, from
    ``latency.InferenceSimulator``). ``cost_per_replica`` is the
    amortized per-step prefetch-bandwidth seconds of re-pulling one
    extra expert's weights every rebalance window
    (``InferenceSimulator.prefetch_time``).

    Under uniform routing the first grant lowers nothing (every other
    expert still carries the old max) so the search grants zero replicas
    — degrees deviate from all-ones only on genuinely skewed workloads,
    which is exactly the "searched, not operator default" behavior the
    planner needs. Marginal gains are non-increasing along the
    water-filling path, so the greedy stop rule is optimal.
    """
    f = np.maximum(np.asarray(freqs, np.float64), 0.0)
    n = f.size
    if n == 0:
        return ()
    if f.sum() <= 0:
        f = np.ones(n)
    f = f / f.sum()
    degrees = np.ones(n, dtype=np.int64)
    for _ in range(max(int(max_extra), 0)):
        load = f / degrees
        grantable = load.copy()
        if max_degree is not None:
            grantable[degrees >= max_degree] = -1.0
        e = int(np.argmax(grantable))
        if grantable[e] < 0:
            break
        # the true bottleneck after this grant (a capped hotter expert
        # keeps the max where it is — the grant then buys nothing)
        new_max = max(
            float(np.max(np.delete(load, e))) if n > 1 else 0.0,
            f[e] / (degrees[e] + 1),
        )
        gain = gain_scale * (float(load.max()) - new_max)
        if gain <= cost_per_replica:
            break
        degrees[e] += 1
    return tuple(int(d) for d in degrees)
