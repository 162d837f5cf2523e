"""Batched on-device permutation feature importance.

The reference calls ``sklearn.inspection.permutation_importance`` with
``n_repeats=10, random_state=42, n_jobs=-1`` — a joblib *process pool* that
shuffles one column at a time and re-predicts on host (ipynb:495-496,
SURVEY.md §3.4). Here the whole (feature x repeat) sweep is one jitted device
computation: a ``lax.map`` over features of a vmap over repeats, where each
instance rebuilds the permuted matrix with a one-hot column blend (no
(F, R, N, F) materialisation).

Semantics match sklearn: ``importance[j, r] = baseline_score -
score(X with column j shuffled by permutation r)``; scores are mean accuracy.
Randomness is explicit (`seed` -> jax PRNG), so results are reproducible —
rankings (not values) are the cross-implementation contract with the
reference (SURVEY.md §7).

``permutation_importance_host`` wraps sklearn's own implementation for
host-only heads / compat checks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def labels_to_class_idx(labels, classes) -> np.ndarray:
    """Labels -> class indices with the unseen-label sentinel -1.

    A test label never seen at training time cannot be predicted; argmax is
    always in [0, k), so sentinel rows score as mispredictions — the same
    semantics as comparing ``head.predict`` output against raw labels. All
    three sweep variants (unfused / fused / sharded) share this mapping, so
    they agree on inputs with train-unseen test classes instead of two of
    them raising KeyError."""
    mapping = {c: i for i, c in enumerate(np.asarray(classes).tolist())}
    return np.array(
        [mapping.get(v, -1) for v in np.asarray(labels).tolist()], np.int32
    )


def group_masks(groups, num_features: int) -> np.ndarray:
    """(G, F) f32 joint-shuffle masks from per-group column lists
    (``None`` -> identity = the per-feature sweep). Shared by the unfused,
    fused, and sharded sweep variants."""
    if groups is None:
        return np.eye(num_features, dtype=np.float32)
    masks = np.zeros((len(groups), num_features), np.float32)
    for g, cols in enumerate(groups):
        masks[g, cols] = 1.0
    return masks


@dataclass
class PermutationResult:
    importances: np.ndarray  # (F, R) score drops
    importances_mean: np.ndarray  # (F,)
    importances_std: np.ndarray  # (F,)
    baseline_score: float

    def ranking(self) -> np.ndarray:
        """Feature indices sorted by mean importance, descending."""
        return np.argsort(self.importances_mean)[::-1]


def _scaled_logistic_apply(params, dmin, dscale, X):
    # DEFAULT matmul precision (TF32 on a GPU): the sweep compares argmax
    # accuracies, and chip_smoke.py checks the resulting channel ranking
    # against a HIGHEST-precision run
    return (X - dmin) * dscale @ params["w"] + params["b"]


def _scaled_mlp_apply(params, dmin, dscale, X):
    from tpumcia.models.heads import mlp_predict_logits

    return mlp_predict_logits(params, (X - dmin) * dscale)


def _scaled_forest_apply(feature, threshold, left, right, leaf_proba, dmin,
                         dscale, depth, X):
    from tpumcia.models.forest_device import _forest_proba_impl

    return _forest_proba_impl(
        (X - dmin) * dscale, feature, threshold, left, right, leaf_proba, depth
    )


def _scaled_forest_apply_gemm(g_feature, g_threshold, A, target, g_leaf_proba,
                              dmin, dscale, X):
    from tpumcia.models.forest_device import _forest_proba_gemm_impl

    return _forest_proba_gemm_impl(
        (X - dmin) * dscale, g_feature, g_threshold, A, target, g_leaf_proba
    )


def _device_score_parts(head):
    """(apply_fn, classes) for device-capable heads. ``apply_fn`` is a
    ``jax.tree_util.Partial`` over module-level functions with array leaves,
    so jits keyed on it cache across calls (a plain closure would retrace
    every sweep)."""
    from jax.tree_util import Partial

    from tpumcia.models.forest_device import DeviceForest
    from tpumcia.models.heads import LogisticHead, MLPHead, RandomForestHead

    if isinstance(head, RandomForestHead):
        head = head.to_device()

    def scale_args(scaler, width):
        if scaler is None:
            return jnp.zeros((width,), jnp.float32), jnp.ones((width,), jnp.float32)
        return jnp.asarray(scaler.data_min, jnp.float32), jnp.asarray(
            scaler.scale, jnp.float32
        )

    if isinstance(head, LogisticHead):
        dmin, dscale = scale_args(head.scaler, head.params["w"].shape[0])
        return (
            Partial(_scaled_logistic_apply, head.params, dmin, dscale),
            head.classes,
        )
    if isinstance(head, MLPHead):
        dmin, dscale = scale_args(head.scaler, 1)
        return (
            Partial(_scaled_mlp_apply, head.params, dmin, dscale),
            head.classes,
        )
    if isinstance(head, DeviceForest):
        dmin, dscale = scale_args(head.scaler, 1)
        if head.gemm is not None:
            return (
                Partial(
                    _scaled_forest_apply_gemm, *head.gemm, dmin, dscale
                ),
                head.classes,
            )
        return (
            Partial(
                _scaled_forest_apply,
                head.feature, head.threshold, head.left, head.right,
                head.leaf_proba, dmin, dscale, head.depth,
            ),
            head.classes,
        )
    raise TypeError(
        f"head {type(head).__name__} has no device scoring path; use "
        "permutation_importance_host"
    )


def check_n_repeats(n_repeats) -> int:
    """Shared sweep-entry guard: n_repeats=0 would silently mean-reduce an
    empty axis into all-NaN importances (numpy RuntimeWarnings, no error)."""
    n = int(n_repeats)
    if n < 1:
        raise ValueError(f"n_repeats must be >= 1; got {n_repeats!r}")
    return n


@functools.partial(jax.jit, static_argnames=("n_repeats",))
def _perm_sweep(X, y_idx, masks, key, apply_fn, *, n_repeats):
    """masks: (G, F) 0/1 — columns permuted *jointly* (with one permutation)
    per group. Per-feature importance is the identity-mask special case."""
    N, F = X.shape
    G = masks.shape[0]

    def accuracy(Xp):
        pred = jnp.argmax(apply_fn(Xp), axis=-1)
        return jnp.mean((pred == y_idx).astype(jnp.float32))

    baseline = accuracy(X)
    keys = jax.random.split(key, G * n_repeats).reshape(G, n_repeats)

    def one_group(args):
        mask, keys_g = args  # (F,), (R,)

        def one_repeat(k):
            perm = jax.random.permutation(k, N)
            X_perm = X * (1 - mask) + jnp.take(X, perm, axis=0) * mask
            return accuracy(X_perm)

        return jax.vmap(one_repeat)(keys_g)

    drops = jax.lax.map(one_group, (masks, keys))  # (G, R) scores
    return baseline, baseline - drops


def _run_sweep(head, X, y, masks, *, n_repeats, seed):
    n_repeats = check_n_repeats(n_repeats)
    apply_fn, classes = _device_score_parts(head)
    y_idx = jnp.asarray(labels_to_class_idx(y, classes))
    X = jnp.asarray(X, jnp.float32)
    baseline, importances = _perm_sweep(
        X,
        y_idx,
        jnp.asarray(masks, jnp.float32),
        jax.random.key(seed),
        apply_fn,
        n_repeats=n_repeats,
    )
    imp = np.asarray(importances, dtype=np.float64)
    return PermutationResult(
        importances=imp,
        importances_mean=imp.mean(axis=1),
        importances_std=imp.std(axis=1),
        baseline_score=float(baseline),
    )


def permutation_importance(
    head,
    X,
    y,
    *,
    n_repeats: int = 10,
    seed: int = 42,
    groups: list[list[int]] | None = None,
) -> PermutationResult:
    """sklearn-shaped permutation importance, computed on device.

    Defaults mirror the reference call (n_repeats=10, random_state=42,
    ipynb:495-496). With ``groups`` (lists of column indices), each group's
    columns are shuffled *jointly* — the channel-level variant that stays
    informative when features within a channel are redundant (permuting one
    of many correlated columns shows no score drop; permuting the whole
    channel does).
    """
    X = X if isinstance(X, jax.Array) else np.asarray(X)  # keep device-resident
    masks = group_masks(groups, X.shape[1])
    return _run_sweep(head, X, y, masks, n_repeats=n_repeats, seed=seed)


def permutation_importance_host(
    head,
    X,
    y,
    *,
    n_repeats: int = 10,
    seed: int = 42,
) -> PermutationResult:
    """sklearn's own implementation (host, joblib) — compat path for
    host-only heads and cross-checking the device sweep."""
    n_repeats = check_n_repeats(n_repeats)
    from sklearn.inspection import permutation_importance as sk_perm

    X = np.asarray(X)
    y = np.asarray(y)

    class _Wrapper:
        def __init__(self, head):
            self._head = head
            self.classes_ = getattr(head, "classes", None)

        def fit(self, *a, **k):  # pragma: no cover - never called
            return self

        def predict(self, X):
            return self._head.predict(X)

        def score(self, X, y):
            return self._head.score(X, y)

    res = sk_perm(
        _Wrapper(head), X, y, n_repeats=n_repeats, random_state=seed, n_jobs=-1
    )
    return PermutationResult(
        importances=np.asarray(res.importances),
        importances_mean=np.asarray(res.importances_mean),
        importances_std=np.asarray(res.importances_std),
        baseline_score=float(head.score(X, y)),
    )
