"""One-dispatch logistic head fit + permutation importance sweeps.

Fuses take -> MinMax fit/transform -> logistic fit -> both permutation
sweeps into ONE device dispatch riding the device-resident feature matrix,
with one packed fetch of the results. The public fast path of
``run_pipeline`` (and the benchmark itself) uses it, so the recorded
number IS the public API's number.

The sweep PRNG streams are identical to the unfused
``importance.permutation.permutation_importance`` calls (same key, same
in-sweep splitting), so fused and unfused importances agree bit-for-bit
on identical inputs — pinned by tests.

Reference mapping: cells 19-20 (split/scale/fit, ipynb:381-417) + cell 28
(permutation importance, ipynb:493-505), collapsed into one jitted program.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import Partial

from tpumcia.config import HeadConfig, ImportanceConfig
from tpumcia.importance.channels import (
    ChannelImportanceResult,
    aggregate_channel_importance,
)
from tpumcia.importance.permutation import (
    PermutationResult,
    _perm_sweep,
    _scaled_logistic_apply,
)
from tpumcia.models.heads import LogisticHead, _fit_logistic
from tpumcia.models.scaler import MinMaxScaler


@functools.partial(
    jax.jit, static_argnames=("n_repeats", "num_steps", "lr", "l2")
)
def _fused_fit_sweeps(
    X, tr_idx, te_idx, y_tr_onehot, y_te_idx, group_masks, w0, b0, key,
    *, n_repeats, num_steps, lr, l2,
):
    """take -> MinMax -> logistic fit -> grouped + per-feature sweeps ->
    test predictions, one jitted program. Returns (packed, params): the
    host-bound scalars ride ONE packed f32 fetch; params stay on device.

    Matmuls run at DEFAULT precision (TF32 on a GPU), as in the unfused head
    and sweep: the outputs are argmax accuracies, and chip_smoke.py checks
    the channel ranking against a HIGHEST-precision run."""
    F = X.shape[1]
    X_tr = jnp.take(X, tr_idx, axis=0)
    X_te = jnp.take(X, te_idx, axis=0)
    dmin = jnp.min(X_tr, axis=0)
    dmax = jnp.max(X_tr, axis=0)
    rng = dmax - dmin
    # sklearn zero-range handling, same formula as MinMaxScaler.scale
    dscale = jnp.where(rng != 0, 1.0 / jnp.where(rng != 0, rng, 1.0), 1.0)
    params = _fit_logistic(
        (X_tr - dmin) * dscale, y_tr_onehot, w0, b0,
        num_steps=num_steps, lr=lr, l2=l2,
    )
    apply_fn = Partial(_scaled_logistic_apply, params, dmin, dscale)
    # both sweeps reuse the SAME key — exactly the PRNG stream each separate
    # permutation_importance(seed) call would draw
    baseline, imp_g = _perm_sweep(
        X_te, y_te_idx, group_masks, key, apply_fn, n_repeats=n_repeats
    )
    eye = jnp.eye(F, dtype=jnp.float32)
    _, imp_f = _perm_sweep(
        X_te, y_te_idx, eye, key, apply_fn, n_repeats=n_repeats
    )
    y_pred = jnp.argmax(apply_fn(X_te), axis=-1)
    packed = jnp.concatenate([
        baseline.reshape(1),
        imp_g.reshape(-1),
        imp_f.reshape(-1),
        dmin,
        dmax,
        y_pred.astype(jnp.float32),
    ])
    return packed, params


@dataclass
class FusedFitResult:
    head: LogisticHead
    channel_result: ChannelImportanceResult
    feature_result: ChannelImportanceResult
    y_pred: np.ndarray  # predicted class labels on the test rows
    baseline_score: float


@dataclass
class PendingFusedFit:
    """Enqueued fused fit+sweeps: the dispatch is in flight, the packed
    scalar fetch deferred — call :meth:`result` after enqueueing/fetching
    whatever should overlap with it (e.g. the feature-matrix wires)."""

    _finish: callable

    def result(self) -> FusedFitResult:
        return self._finish()


def fit_logistic_with_importance(
    X,
    labels,
    *,
    train_idx,
    test_idx,
    groups: list[list[int]],
    names: list[str],
    head_config: HeadConfig | None = None,
    importance_config: ImportanceConfig | None = None,
    channel_names: list[str] | None = None,
    defer: bool = False,
):
    """Fit the logistic head and compute both importance views in one device
    dispatch + one packed fetch.

    ``X``: (N, F) feature matrix — pass a device-resident array
    (``FeatureMatrix.device_values``) to avoid re-uploading it.
    ``groups``: per-channel column index lists
    (``FeatureMatrix.channel_columns()``).
    ``defer=True`` returns a :class:`PendingFusedFit` right after enqueueing
    the dispatch (no fetch yet) so other transfers can overlap its
    compute.
    """
    head_cfg = head_config or HeadConfig()
    imp_cfg = importance_config or ImportanceConfig()
    if head_cfg.kind != "logistic":
        raise ValueError("fused fit supports the logistic head")
    from tpumcia.importance.permutation import check_n_repeats

    check_n_repeats(imp_cfg.n_repeats)
    labels = np.asarray(labels)
    train_idx = np.asarray(train_idx)
    test_idx = np.asarray(test_idx)

    y_tr = labels[train_idx]
    classes, y_tr_idx = np.unique(y_tr, return_inverse=True)
    k = len(classes)
    # test labels never seen in training can't be predicted: the shared
    # mapping gives them the sentinel index -1 (argmax is always in
    # [0, k), so they score as mispredictions — same as the classic
    # path's head.predict comparison)
    from tpumcia.importance.permutation import (
        group_masks as build_group_masks,
        labels_to_class_idx,
    )

    y_te_idx = labels_to_class_idx(labels[test_idx], classes)
    F = X.shape[1]
    C = len(groups)

    group_masks = build_group_masks(groups, F)

    w0 = (
        jax.random.normal(jax.random.key(head_cfg.seed), (F, k), jnp.float32)
        * 0.01
    )
    X_dev = X if isinstance(X, jax.Array) else jnp.asarray(X, jnp.float32)
    packed, params = _fused_fit_sweeps(
        X_dev,
        jnp.asarray(train_idx),
        jnp.asarray(test_idx),
        jax.nn.one_hot(jnp.asarray(y_tr_idx), k),
        jnp.asarray(y_te_idx, jnp.int32),
        jnp.asarray(group_masks),
        w0,
        jnp.zeros((k,), jnp.float32),
        jax.random.key(imp_cfg.seed),
        n_repeats=imp_cfg.n_repeats,
        num_steps=head_cfg.num_steps,
        lr=head_cfg.learning_rate,
        l2=head_cfg.l2,
    )

    def finish() -> FusedFitResult:
        R = imp_cfg.n_repeats
        p = np.asarray(packed, np.float64)  # the one packed fetch
        baseline = float(p[0])
        off = 1
        imp_g = p[off : off + C * R].reshape(C, R)
        off += C * R
        imp_f = p[off : off + F * R].reshape(F, R)
        off += F * R
        dmin = p[off : off + F].astype(np.float32)
        off += F
        dmax = p[off : off + F].astype(np.float32)
        off += F
        y_pred_idx = p[off:].astype(np.int64)
        y_pred = classes[y_pred_idx]

        head = LogisticHead(
            params=params,
            classes=classes,
            scaler=MinMaxScaler.from_stats(dmin, dmax),
            config=head_cfg,
        )

        def perm_result(imp):
            return PermutationResult(
                importances=imp,
                importances_mean=imp.mean(axis=1),
                importances_std=imp.std(axis=1),
                baseline_score=baseline,
            )

        res_g = perm_result(imp_g)
        total = res_g.importances_mean.copy()
        feat_imp = np.zeros(F)
        for c, cols in enumerate(groups):
            feat_imp[cols] = total[c]
        channel_result = ChannelImportanceResult(
            per_channel=[imp_g[c] for c in range(C)],
            mean=total,
            total=total,
            ranking=np.argsort(total)[::-1],
            feature_importances=feat_imp,
            feature_names=list(names),
            method="permutation",
            channel_names=channel_names,
        )
        channel_result.extras["permutation"] = res_g

        res_f = perm_result(imp_f)
        feature_result = aggregate_channel_importance(
            res_f.importances_mean, list(names), C, threshold=None,
            match="exact", method="permutation_features", groups=groups,
        )
        feature_result.channel_names = channel_names
        feature_result.extras["permutation"] = res_f

        return FusedFitResult(
            head=head,
            channel_result=channel_result,
            feature_result=feature_result,
            y_pred=y_pred,
            baseline_score=baseline,
        )

    if defer:
        return PendingFusedFit(_finish=finish)
    return finish()
