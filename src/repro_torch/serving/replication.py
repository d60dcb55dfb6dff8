# The port's own copy of repro.serving.replication: the port imports nothing of the JAX package.
"""Online hot-expert replication: routing-frequency tracking + planning.

MoE routing is skewed in practice — a few hot experts absorb most token
copies, and under EP the hottest device bounds the step time. With
resident-INT4 experts (~4x residency, DESIGN.md §5b) the freed capacity
can hold *replicas* of the hot experts. This module is the host side of
that loop:

- ``RoutingTracker`` — EMA counters over the router's top-k output
  (collected from the decode step, one (L, T, k) index block per engine
  step) plus an inter-layer co-fire affinity matrix built from
  adjacent-layer top-1 pairs ("Exploiting Inter-Layer Expert Affinity",
  PAPERS.md).
- ``plan_replication`` — turns a frequency snapshot into an
  ``ExpertReplication``: water-filling replica degrees
  (``repro_torch.core.ilp.replication_degrees``) and an affinity-greedy
  expert ordering so co-firing experts land in the same EP slot-axis
  shard, which is what cuts all2all fan-out.

The engine consumes the plan through its normal Eq.-6 transition path:
a changed replica set is a changed ``ShardingPlan`` (new step graphs +
expert relayout into the new slots), not a bespoke side channel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.ilp import replication_degrees
from repro_torch.sharding.specs import ExpertReplication


class RoutingTracker:
    """Per-layer EMA routing-frequency counters + co-fire affinity.

    ``update`` takes the stacked top-k expert indices of one decode
    step, shape (L, T, k). Counts decay by ``ema`` per step, so the
    tracker follows workload drift at a 1/(1-ema)-step horizon; every
    top-k entry counts equally (a tie between experts in the same top-k
    increments both — gates are renormalized downstream, load is what
    matters here).
    """

    def __init__(self, n_layers: int, n_experts: int, ema: float = 0.9):
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.ema = ema
        self.counts = np.zeros((n_layers, n_experts), np.float64)
        self.affinity = np.zeros((n_experts, n_experts), np.float64)
        self.steps = 0

    def update(self, topk) -> None:
        topk = np.asarray(topk)
        if topk.ndim == 2:  # single layer (T, k)
            topk = topk[None]
        L, _, _ = topk.shape
        fresh = np.zeros_like(self.counts)
        for layer in range(min(L, self.n_layers)):
            fresh[layer] = np.bincount(
                topk[layer].reshape(-1), minlength=self.n_experts
            )[: self.n_experts]
        self.counts = self.ema * self.counts + (1.0 - self.ema) * fresh
        if L > 1:
            top1 = topk[:, :, 0]
            pair = np.zeros_like(self.affinity)
            for layer in range(min(L, self.n_layers) - 1):
                np.add.at(pair, (top1[layer], top1[layer + 1]), 1.0)
            pair = pair + pair.T  # co-fire is direction-agnostic
            self.affinity = self.ema * self.affinity + (1.0 - self.ema) * pair
        self.steps += 1

    def frequencies(self) -> np.ndarray:
        """Aggregate per-expert routing frequency, normalized to sum 1
        (uniform before any update)."""
        agg = self.counts.sum(axis=0)
        total = agg.sum()
        if total <= 0:
            return np.full(self.n_experts, 1.0 / max(self.n_experts, 1))
        return agg / total

    def layer_frequencies(self) -> np.ndarray:
        """(L, E) per-layer normalized frequencies."""
        totals = self.counts.sum(axis=1, keepdims=True)
        out = np.where(totals > 0, self.counts / np.maximum(totals, 1e-30),
                       1.0 / max(self.n_experts, 1))
        return out


class NextLayerPredictor:
    """Predict each layer's hot experts from the PREVIOUS layer's
    routing distribution pushed through the co-fire affinity matrix
    ("Fast MoE Inference via Predictive Prefetching", PAPERS.md).

    ``observe(tracker)`` refreshes an EMA-smoothed (L, E) score matrix:
    layer 0 scores from its own frequency EMA, layer l >= 1 from
    ``layer_frequencies()[l-1] @ row_normalized(affinity)`` — the
    transition-probability estimate of which experts fire next given
    what just fired. ``predict()`` returns per-layer tuples: the
    smallest prefix of experts (score-descending, lower id breaks ties)
    whose cumulative score reaches ``top_p``, dropping members below
    ``min_confidence``. Cold start (no observed routing) predicts
    nothing, so the engine issues no pulls until signal accumulates.
    """

    def __init__(self, n_layers: int, n_experts: int, *,
                 top_p: float = 0.5, min_confidence: float = 0.02,
                 ema: float = 0.5):
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.top_p = top_p
        self.min_confidence = min_confidence
        self.ema = ema
        self.scores = np.zeros((n_layers, n_experts), np.float64)
        self._warm = False

    def observe(self, tracker: RoutingTracker) -> None:
        """Fold the tracker's current state into the score EMA."""
        if tracker.steps == 0:
            return
        lf = tracker.layer_frequencies()
        raw = np.array(lf, np.float64)
        row_mass = tracker.affinity.sum(axis=1, keepdims=True)
        # zero-mass rows stay zero: no co-fire evidence, no confidence
        trans = np.divide(tracker.affinity, np.maximum(row_mass, 1e-30),
                          where=row_mass > 0,
                          out=np.zeros_like(tracker.affinity))
        for layer in range(1, self.n_layers):
            pushed = lf[layer - 1] @ trans
            mass = pushed.sum()
            if mass > 0:
                raw[layer] = pushed / mass
        if self._warm:
            self.scores = self.ema * self.scores + (1.0 - self.ema) * raw
        else:
            self.scores = raw
            self._warm = True

    def predict(self) -> tuple:
        """Per-layer predicted expert tuples, highest confidence first.

        Empty tuples until the first ``observe`` of a stepped tracker.
        """
        if not self._warm:
            return tuple(() for _ in range(self.n_layers))
        out = []
        ids = np.arange(self.n_experts)
        for layer in range(self.n_layers):
            s = self.scores[layer]
            order = np.lexsort((ids, -s))
            picked, mass = [], 0.0
            for e in order:
                if s[e] < self.min_confidence:
                    break  # score-sorted: everything after is colder
                picked.append(int(e))
                mass += float(s[e])
                if mass >= self.top_p:
                    break
            out.append(tuple(picked))
        return tuple(out)


def affinity_order(tracker: RoutingTracker) -> tuple:
    """Greedy co-fire chain: start at the hottest expert, repeatedly
    append the unplaced expert with the strongest affinity to the last
    placed one (frequency as tie-break / cold-start). Deterministic for
    a given tracker state; identity-adjacent orders fall out naturally
    when no affinity signal has accumulated."""
    freqs = tracker.frequencies()
    n = tracker.n_experts
    if n == 0:
        return ()
    order = [int(np.argmax(freqs))]
    placed = {order[0]}
    while len(order) < n:
        last = order[-1]
        best, best_key = None, None
        for e in range(n):
            if e in placed:
                continue
            key = (tracker.affinity[last, e], freqs[e], -e)
            if best_key is None or key > best_key:
                best, best_key = e, key
        order.append(best)
        placed.add(best)
    return tuple(order)


def plan_replication(
    tracker: RoutingTracker,
    extra_replicas: int,
    *,
    align: int = 1,
    max_degree: Optional[int] = None,
    degrees: Optional[Sequence[int]] = None,
) -> ExpertReplication:
    """Frequency snapshot -> replica-aware placement.

    ``align`` pads the total slot count to a multiple of the EP axis
    size (extra grants keep water-filling) so the slot axis still
    shards; ``max_degree`` caps any one expert's replicas. When the
    planner searched per-expert ``degrees`` (latency-model trade of
    degree vs prefetch bandwidth, ``core.ilp.searched_replication_degrees``),
    they override the fixed-budget water-filling — the affinity ordering
    and align padding still apply.
    """
    freqs = tracker.frequencies()
    if degrees is not None:
        degrees = list(int(d) for d in degrees)
        if len(degrees) != tracker.n_experts or any(d < 1 for d in degrees):
            raise ValueError(f"bad searched degrees {degrees!r}")
    else:
        degrees = list(replication_degrees(freqs, extra_replicas, max_degree))
    while align > 1 and sum(degrees) % align:
        loads = [freqs[e] / degrees[e] for e in range(len(degrees))]
        degrees[int(np.argmax(loads))] += 1
    return ExpertReplication(tuple(degrees), affinity_order(tracker))


def replication_summary(rep: ExpertReplication,
                        freqs: Sequence[float]) -> dict:
    """Load-balance accounting for logs/stats: max per-replica load
    before vs after replication."""
    f = np.asarray(freqs, np.float64)
    d = np.asarray(rep.degrees, np.float64)
    return {
        "total_slots": rep.total_slots,
        "max_load_unreplicated": float(f.max()) if f.size else 0.0,
        "max_load_replicated": float((f / d).max()) if f.size else 0.0,
    }
