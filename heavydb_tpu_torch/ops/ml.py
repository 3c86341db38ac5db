"""Tree-model regression for the ML table functions.

A copy of heavydb_tpu/ops/ml.py (numpy only, on the host).

Reference surface: TableFunctions/SystemFunctions/os/ML*.hpp
(DECISION_TREE_REG_FIT, RANDOM_FOREST_REG_FIT, GBT_REG_FIT,
ML_REG_PREDICT; models fitted via oneDAL and consumed by
MLPredictCodegen.cpp / TreeModelPredictionMgr).

Fitting is host-side (model sizes are tiny and the reference also fits
on CPU via oneDAL), and the fitted model is stored as a FLAT
STRUCT-OF-ARRAYS (feature/threshold/left/right/value), so prediction is a
fixed-trip gather ladder over the node arrays — data-parallel over rows,
no pointer chasing.  Leaves self-loop
(left == right == self), so the ladder needs no per-row early exit:
exactly `depth` iterations of `node = where(x[f] <= t, L, R)`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "fit_tree",
    "fit_forest",
    "fit_gbt",
    "predict_trees",
    "TreeModel",
]

_MAX_SPLIT_CANDIDATES = 32  # quantile candidates per feature per node


class TreeModel:
    """A fitted regression ensemble: list of flat trees + combine rule."""

    def __init__(self, kind: str, trees: List[dict], base: float,
                 scale: float, n_features: int, depth: int):
        self.kind = kind          # 'tree' | 'forest' | 'gbt'
        self.trees = trees        # each: feature,i32 thr,f64 left,right,i32 value,f64
        self.base = base          # additive offset (gbt: mean of y)
        self.scale = scale        # per-tree weight (forest: 1/n, gbt: lr)
        self.n_features = n_features
        self.depth = depth

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.base + self.scale * predict_trees(self.trees, X,
                                                      self.depth)


def _best_split(X: np.ndarray, y: np.ndarray, feats: np.ndarray):
    """(feature, threshold, gain) minimizing child SSE over quantile
    candidates.  Returns None when no split reduces SSE."""
    n = len(y)
    sse_parent = float(((y - y.mean()) ** 2).sum())
    best = None
    for f in feats:
        col = X[:, f]
        qs = np.unique(np.quantile(
            col, np.linspace(0.02, 0.98, _MAX_SPLIT_CANDIDATES)))
        # vectorize over candidates: sort once, candidates become prefix
        # boundaries in the sorted order
        order = np.argsort(col, kind="stable")
        cs, ys = col[order], y[order]
        pre_s = np.concatenate([[0.0], np.cumsum(ys)])
        pre_q = np.concatenate([[0.0], np.cumsum(ys * ys)])
        idx = np.searchsorted(cs, qs, side="right")
        idx = idx[(idx > 0) & (idx < n)]
        if not len(idx):
            continue
        nl = idx.astype(np.float64)
        nr = n - nl
        sl, sr = pre_s[idx], pre_s[n] - pre_s[idx]
        ql, qr = pre_q[idx], pre_q[n] - pre_q[idx]
        sse = (ql - sl * sl / nl) + (qr - sr * sr / nr)
        j = int(np.argmin(sse))
        gain = sse_parent - float(sse[j])
        if gain > 1e-12 and (best is None or gain > best[2]):
            best = (int(f), float(cs[idx[j] - 1]), gain)
    return best


def fit_tree(X: np.ndarray, y: np.ndarray, max_depth: int = 6,
             min_leaf: int = 4, feature_frac: float = 1.0,
             rng: Optional[np.random.Generator] = None) -> dict:
    """CART regression tree → flat struct-of-arrays.

    feature[i] < 0 marks a leaf; left/right of a leaf point at i itself
    so the prediction gather ladder is branch-free."""
    rng = rng or np.random.default_rng(0)
    n_feat = X.shape[1]
    k = max(1, int(round(feature_frac * n_feat)))
    feature: List[int] = []
    thr: List[float] = []
    left: List[int] = []
    right: List[int] = []
    value: List[float] = []

    def new_node():
        i = len(feature)
        feature.append(-1)
        thr.append(0.0)
        left.append(i)
        right.append(i)
        value.append(0.0)
        return i

    def build(idx: np.ndarray, depth: int) -> int:
        i = new_node()
        yv = y[idx]
        value[i] = float(yv.mean()) if len(yv) else 0.0
        if depth >= max_depth or len(idx) < 2 * min_leaf or yv.std() == 0:
            return i
        feats = (np.arange(n_feat) if k == n_feat
                 else rng.choice(n_feat, k, replace=False))
        s = _best_split(X[idx], yv, feats)
        if s is None:
            return i
        f, t, _ = s
        mask = X[idx, f] <= t
        if mask.sum() < min_leaf or (~mask).sum() < min_leaf:
            return i
        feature[i] = f
        thr[i] = t
        left[i] = build(idx[mask], depth + 1)
        right[i] = build(idx[~mask], depth + 1)
        # leaves self-loop; internal nodes keep value for truncated walks
        return i

    build(np.arange(len(y)), 0)
    return {
        "feature": np.asarray(feature, np.int32),
        "thr": np.asarray(thr, np.float64),
        "left": np.asarray(left, np.int32),
        "right": np.asarray(right, np.int32),
        "value": np.asarray(value, np.float64),
    }


def predict_trees(trees: List[dict], X: np.ndarray, depth: int) -> np.ndarray:
    """Sum of per-tree predictions via the branch-free gather ladder."""
    X = np.asarray(X, np.float64)
    out = np.zeros(len(X), np.float64)
    for t in trees:
        feat, thr = t["feature"], t["thr"]
        lf, rt, val = t["left"], t["right"], t["value"]
        node = np.zeros(len(X), np.int64)
        for _ in range(depth):
            f = feat[node]
            xv = X[np.arange(len(X)), np.maximum(f, 0)]
            go_left = xv <= thr[node]
            node = np.where(f < 0, node,
                            np.where(go_left, lf[node], rt[node]))
        out += val[node]
    return out


def fit_forest(X: np.ndarray, y: np.ndarray, n_trees: int = 16,
               max_depth: int = 8, min_leaf: int = 4,
               feature_frac: float = 0.7, seed: int = 0) -> TreeModel:
    rng = np.random.default_rng(seed)
    n = len(y)
    trees = []
    for _ in range(n_trees):
        bag = rng.integers(0, n, n)
        trees.append(fit_tree(X[bag], y[bag], max_depth, min_leaf,
                              feature_frac, rng))
    return TreeModel("forest", trees, 0.0, 1.0 / n_trees, X.shape[1],
                     max_depth)


def fit_gbt(X: np.ndarray, y: np.ndarray, n_trees: int = 32,
            max_depth: int = 3, min_leaf: int = 4,
            learning_rate: float = 0.2, seed: int = 0) -> TreeModel:
    rng = np.random.default_rng(seed)
    base = float(y.mean())
    resid = y - base
    trees = []
    for _ in range(n_trees):
        t = fit_tree(X, resid, max_depth, min_leaf, 1.0, rng)
        resid = resid - learning_rate * predict_trees([t], X, max_depth)
        trees.append(t)
    return TreeModel("gbt", trees, base, learning_rate, X.shape[1],
                     max_depth)


def fit_single(X: np.ndarray, y: np.ndarray, max_depth: int = 8,
               min_leaf: int = 4) -> TreeModel:
    t = fit_tree(X, y, max_depth, min_leaf, 1.0)
    return TreeModel("tree", [t], 0.0, 1.0, X.shape[1], max_depth)
