# The port's own copy of repro.core.regression: the port imports nothing of the JAX package.
"""Random-forest regression + polynomial feature expansion (numpy only).

The paper fits the eta / rho correction factors with "an efficient random
forest regression model" over polynomial-expanded features of
(b, s, h, ...). PuLP/sklearn are unavailable offline, so this is a small
CART/bagging implementation: variance-reduction splits, bootstrap
sampling, feature subsampling — enough to reproduce the <10%/<5% error
budget of Fig. 5 on the synthetic measurement surfaces.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def polynomial_features(X: np.ndarray, degree: int = 2,
                        log_augment: bool = True) -> np.ndarray:
    """[x_i] -> [x_i, x_i*x_j (i<=j), log1p(x_i)]."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    feats = [X]
    if degree >= 2:
        n = X.shape[1]
        cross = [X[:, i:i + 1] * X[:, j:j + 1]
                 for i in range(n) for j in range(i, n)]
        feats.append(np.concatenate(cross, axis=1))
    if log_augment:
        feats.append(np.log1p(np.abs(X)))
    return np.concatenate(feats, axis=1)


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.left is None


class RegressionTree:
    def __init__(self, max_depth: int = 12, min_samples_leaf: int = 2,
                 n_thresholds: int = 16, feature_frac: float = 0.8,
                 rng: Optional[np.random.Generator] = None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.n_thresholds = n_thresholds
        self.feature_frac = feature_frac
        self.rng = rng or np.random.default_rng(0)
        self.root: Optional[_Node] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        self.root = self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> _Node:
        node = _Node(value=float(np.mean(y)))
        if (depth >= self.max_depth or len(y) < 2 * self.min_samples_leaf
                or np.ptp(y) < 1e-12):
            return node
        n_feat = X.shape[1]
        k = max(1, int(self.feature_frac * n_feat))
        feats = self.rng.choice(n_feat, size=k, replace=False)
        best = (None, None, np.inf)
        base_sse = np.sum((y - y.mean()) ** 2)
        for f in feats:
            col = X[:, f]
            lo, hi = col.min(), col.max()
            if hi <= lo:
                continue
            qs = np.quantile(col, np.linspace(0.1, 0.9, self.n_thresholds))
            for t in np.unique(qs):
                mask = col <= t
                nl = int(mask.sum())
                if nl < self.min_samples_leaf or len(y) - nl < \
                        self.min_samples_leaf:
                    continue
                yl, yr = y[mask], y[~mask]
                sse = (np.sum((yl - yl.mean()) ** 2)
                       + np.sum((yr - yr.mean()) ** 2))
                if sse < best[2]:
                    best = (f, t, sse)
        f, t, sse = best
        if f is None or sse >= base_sse - 1e-15:
            return node
        mask = X[:, f] <= t
        node.feature, node.threshold = int(f), float(t)
        node.left = self._build(X[mask], y[mask], depth + 1)
        node.right = self._build(X[~mask], y[~mask], depth + 1)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(len(X))
        for i, row in enumerate(X):
            node = self.root
            while not node.is_leaf:
                node = node.left if row[node.feature] <= node.threshold \
                    else node.right
            out[i] = node.value
        return out


class RandomForestRegressor:
    """Bagged regression trees; targets are fit in log-space by default
    (latencies span orders of magnitude)."""

    def __init__(self, n_trees: int = 24, max_depth: int = 12,
                 min_samples_leaf: int = 2, log_target: bool = True,
                 seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.log_target = log_target
        self.seed = seed
        self.trees: List[RegressionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        t = np.log(np.maximum(y, 1e-30)) if self.log_target else y
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for i in range(self.n_trees):
            idx = rng.integers(0, len(X), size=len(X))
            tree = RegressionTree(self.max_depth, self.min_samples_leaf,
                                  rng=np.random.default_rng(self.seed + i))
            tree.fit(X[idx], t[idx])
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        pred = np.mean([tr.predict(X) for tr in self.trees], axis=0)
        return np.exp(pred) if self.log_target else pred

    def relative_error(self, X: np.ndarray, y: np.ndarray) -> float:
        p = self.predict(X)
        return float(np.mean(np.abs(p - y) / np.maximum(np.abs(y), 1e-30)))
