"""Device-resident random-forest inference.

Tree *fitting* stays on host (sklearn, Cython — building trees does not map
to matrix units), but a fitted forest compiles into dense arrays so
*inference* runs on the device. This is what lets the permutation importance sweep over a
RandomForest head run as a single batched device computation instead of the
reference's per-feature joblib fan-out (ipynb:495-496).

Two formulations:

* **GEMM** (default for compact forests): evaluate every internal node's
  comparison at once, then select each sample's leaf with one batched
  matmul per tree — the public "forest inference as GEMM" trick (e.g.
  Hummingbird). Leaf ``l`` is reached iff
  ``sum_(i on path) [left-branch ? cmp_i : 1-cmp_i] == path_len_l``, i.e.
  ``A_l . cmp == target_l`` with ``A`` in {-1, 0, +1}. All the per-sample
  work is matrix contractions (bf16 products, exact f32 accumulation)
  instead of serial gathers.
* **Lock-step descent** (fallback for deep/huge trees, where the padded
  (leaves x nodes) path matrix would blow up): every (sample, tree) pair
  descends in lock-step inside one jitted ``fori_loop`` of gathers. Trees
  are padded to the forest's max node count; leaves self-loop
  (left == right == node), so after ``max_depth`` steps every lane sits on
  its leaf.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from tpumcia.models.scaler import MinMaxScaler


def _thr_f32_floor(thr_f64: np.ndarray) -> np.ndarray:
    """f64 split thresholds -> the LARGEST f32 <= threshold.

    A plain f32 cast rounds to nearest and can land ABOVE sklearn's f64
    threshold ((a+b)/2 of adjacent f32 feature values), flipping
    ``x <= thr`` for a sample exactly at the adjacent training value. With
    the floored cast, ``x <= t32`` == ``x <= thr_f64`` for EVERY f32 x, so
    device descent takes sklearn's branch bit-for-bit."""
    t32 = np.asarray(thr_f64).astype(np.float32)
    up = t32.astype(np.float64) > np.asarray(thr_f64)
    return np.where(up, np.nextafter(t32, np.float32(-np.inf)), t32)


def _forest_proba_impl(X, feature, threshold, left, right, leaf_proba, depth):
    """X: (S, F); tree arrays: (T, N); leaf_proba: (T, N, K) -> (S, K).
    ``depth`` may be a traced scalar (dynamic fori bound) — leaves self-loop,
    so any bound >= true depth is correct."""
    S = X.shape[0]
    T = feature.shape[0]

    def descend_tree(feat_t, thr_t, left_t, right_t):
        # one tree, all samples
        def step(_, node):
            f = jnp.take(feat_t, node)  # (S,)
            thr = jnp.take(thr_t, node)
            x = jnp.take_along_axis(X, jnp.clip(f, 0, X.shape[1] - 1)[:, None], axis=1)[
                :, 0
            ]
            go_left = x <= thr
            return jnp.where(
                f < 0, node, jnp.where(go_left, jnp.take(left_t, node), jnp.take(right_t, node))
            )

        return jax.lax.fori_loop(0, depth, step, jnp.zeros((S,), jnp.int32))

    nodes = jax.vmap(descend_tree)(feature, threshold, left, right)  # (T, S)
    probas = jax.vmap(lambda lp, nd: jnp.take(lp, nd, axis=0))(leaf_proba, nodes)
    return jnp.mean(probas, axis=0)  # (S, K)


@functools.partial(jax.jit, static_argnames=("depth",))
def _forest_proba(X, feature, threshold, left, right, leaf_proba, *, depth: int):
    return _forest_proba_impl(X, feature, threshold, left, right, leaf_proba, depth)


def _apply_lockstep(feature, threshold, left, right, leaf_proba, depth, X):
    """Partial-friendly argument order (head arrays first, X last) for the
    lock-step descent — same shape as permutation._scaled_forest_apply."""
    return _forest_proba_impl(X, feature, threshold, left, right, leaf_proba, depth)


def _apply_gemm(g_feature, g_threshold, A, target, g_leaf_proba, X):
    return _forest_proba_gemm_impl(X, g_feature, g_threshold, A, target, g_leaf_proba)


# maximum padded (leaves x internal-nodes) per tree for the GEMM path; above
# this the dense path matrix costs more than the lock-step gathers
_GEMM_MAX_CELLS = 1 << 20


_GEMM_TREE_BLOCK = 8


def _forest_proba_gemm_impl(X, g_feature, g_threshold, A, target, g_leaf_proba):
    """GEMM forest inference. X: (S, F); g_feature/g_threshold: (T, N)
    internal nodes; A: (T, L, N) i8 path matrix; target: (T, L) i32;
    g_leaf_proba: (T, L, K). -> (S, K) mean class probabilities.

    Trees are processed in blocks of ``_GEMM_TREE_BLOCK`` under a lax.map
    so the (trees, samples, leaves) reached tensor never materialises for
    the whole forest at once (it would multiply again under the vmapped
    permutation sweep). Padded trees have all-zero path rows and target -1,
    so they reach no leaf and contribute nothing."""
    f32 = jnp.float32
    T = A.shape[0]
    B = min(_GEMM_TREE_BLOCK, T)
    nb = -(-T // B)
    pad = nb * B - T

    def pad_t(arr, fill):
        if not pad:
            return arr
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        return jnp.pad(arr, widths, constant_values=fill)

    fb = pad_t(g_feature, 0).reshape(nb, B, -1)
    tb = pad_t(g_threshold, -jnp.inf).reshape(nb, B, -1)
    Ab = pad_t(A, 0).reshape(nb, B, *A.shape[1:])
    gb = pad_t(target, -1).reshape(nb, B, -1)
    pb = pad_t(g_leaf_proba, 0.0).reshape(nb, B, *g_leaf_proba.shape[1:])

    def one_block(args):
        f, thr, a, tgt, lp = args
        # cmp[t, s, n] = [x[s, f_tn] <= thr_tn]  (sklearn's left-branch test)
        xg = jnp.take(X, f, axis=1)  # (S, B, N)
        cmp = (xg <= thr[None]).astype(f32)
        # s[t, s, l] = A_l . cmp — exact (+-1 products, f32 accumulation;
        # f32 operands because CPU XLA lacks bf16xbf16->f32 dots)
        s = jnp.einsum(
            "stn,tln->tsl", cmp, a.astype(f32), preferred_element_type=f32,
        )
        reached = (s.astype(jnp.int32) == tgt[:, None, :]).astype(f32)
        # HIGHEST: leaf probabilities are arbitrary f32 fractions — DEFAULT
        # precision may round them (bf16 or TF32 operands)
        return jnp.einsum(
            "tsl,tlk->sk", reached, lp, preferred_element_type=f32,
            precision=jax.lax.Precision.HIGHEST,
        )

    probas = jax.lax.map(one_block, (fb, tb, Ab, gb, pb))  # (nb, S, K)
    return jnp.sum(probas, axis=0) / T


@jax.jit
def _forest_proba_gemm(X, g_feature, g_threshold, A, target, g_leaf_proba):
    return _forest_proba_gemm_impl(
        X, g_feature, g_threshold, A, target, g_leaf_proba
    )


def _gemm_arrays(trees, K):
    """Padded GEMM-form arrays, or None when the dense path matrix would be
    too large (deep forests fall back to lock-step descent)."""
    per_tree = []
    max_n, max_l = 1, 1
    for tree in trees:
        f = tree.feature.astype(np.int32)  # -2 at leaves
        internal = np.flatnonzero(f >= 0)
        leaves = np.flatnonzero(f < 0)
        max_n = max(max_n, len(internal))
        max_l = max(max_l, len(leaves))
        per_tree.append((tree, internal, leaves))
    if max_n * max_l > _GEMM_MAX_CELLS:
        return None

    T = len(trees)
    g_feature = np.zeros((T, max_n), np.int32)
    g_threshold = np.full((T, max_n), -np.inf, np.float32)
    A = np.zeros((T, max_l, max_n), np.int8)
    target = np.full((T, max_l), -1, np.int32)  # pad rows never match
    g_leaf_proba = np.zeros((T, max_l, K), np.float32)

    for t, (tree, internal, leaves) in enumerate(per_tree):
        node_to_int = {int(n): i for i, n in enumerate(internal)}
        g_feature[t, : len(internal)] = tree.feature[internal]
        g_threshold[t, : len(internal)] = _thr_f32_floor(tree.threshold[internal])
        vals = tree.value[:, 0, :]
        sums = vals.sum(axis=1, keepdims=True)
        sums[sums == 0] = 1
        probs = vals / sums
        # DFS from the root, carrying the (internal idx, went-left) path
        cl = tree.children_left
        cr = tree.children_right
        leaf_idx = {int(n): i for i, n in enumerate(leaves)}
        stack = [(0, [])]
        while stack:
            node, path = stack.pop()
            if tree.feature[node] < 0:
                li = leaf_idx[int(node)]
                n_left = 0
                for ii, went_left in path:
                    A[t, li, ii] = 1 if went_left else -1
                    n_left += int(went_left)
                target[t, li] = n_left  # A.cmp == #left-branches on path
                g_leaf_proba[t, li] = probs[node].astype(np.float32)
            else:
                ii = node_to_int[int(node)]
                stack.append((int(cl[node]), path + [(ii, True)]))
                stack.append((int(cr[node]), path + [(ii, False)]))
    return (
        jnp.asarray(g_feature),
        jnp.asarray(g_threshold),
        jnp.asarray(A),
        jnp.asarray(target),
        jnp.asarray(g_leaf_proba),
    )


@dataclass
class DeviceForest:
    feature: jax.Array  # (T, N) i32, -1 at leaves
    threshold: jax.Array  # (T, N) f32
    left: jax.Array  # (T, N) i32 (self at leaves)
    right: jax.Array  # (T, N) i32
    leaf_proba: jax.Array  # (T, N, K) f32
    depth: int
    classes: np.ndarray
    scaler: MinMaxScaler | None = None
    # GEMM-form arrays (None for forests too deep for the dense path matrix)
    gemm: tuple | None = None

    is_device: bool = True

    @classmethod
    def from_sklearn(cls, model, classes=None, scaler=None) -> "DeviceForest":
        trees = [est.tree_ for est in model.estimators_]
        T = len(trees)
        N = max(t.node_count for t in trees)
        K = model.n_classes_
        feature = np.full((T, N), -1, np.int32)
        threshold = np.zeros((T, N), np.float32)
        left = np.zeros((T, N), np.int32)
        right = np.zeros((T, N), np.int32)
        proba = np.zeros((T, N, K), np.float32)
        depth = 0
        for t, tree in enumerate(trees):
            n = tree.node_count
            f = tree.feature.astype(np.int32)  # -2 at leaves in sklearn
            leaf = f < 0
            feature[t, :n] = np.where(leaf, -1, f)
            threshold[t, :n] = _thr_f32_floor(tree.threshold)
            idx = np.arange(n, dtype=np.int32)
            left[t, :n] = np.where(leaf, idx, tree.children_left.astype(np.int32))
            right[t, :n] = np.where(leaf, idx, tree.children_right.astype(np.int32))
            vals = tree.value[:, 0, :]  # (n, K); sklearn >=1.4 stores fractions
            sums = vals.sum(axis=1, keepdims=True)
            sums[sums == 0] = 1
            proba[t, :n] = (vals / sums).astype(np.float32)
            depth = max(depth, int(tree.max_depth))
        return cls(
            feature=jnp.asarray(feature),
            threshold=jnp.asarray(threshold),
            left=jnp.asarray(left),
            right=jnp.asarray(right),
            leaf_proba=jnp.asarray(proba),
            depth=depth,
            classes=np.asarray(classes if classes is not None else model.classes_),
            scaler=scaler,
            gemm=_gemm_arrays(trees, K),
        )

    # -- pure scoring parts (for vmapped importance sweeps) -----------------
    def apply_fn(self):
        """Returns a pure ``f(X_scaled) -> (S, K) proba`` as a
        ``jax.tree_util.Partial`` over module-level functions (array leaves
        only), so jits keyed on it cache across calls — the same
        stable-identity convention as every other head's apply path."""
        from jax.tree_util import Partial

        if self.gemm is not None:
            return Partial(_apply_gemm, *self.gemm)
        return Partial(
            _apply_lockstep,
            self.feature, self.threshold, self.left, self.right,
            self.leaf_proba, self.depth,
        )

    def _prep(self, X):
        X = jnp.asarray(X, jnp.float32)
        return self.scaler.transform(X) if self.scaler is not None else X

    def predict_proba(self, X) -> jax.Array:
        # one jitted dispatch (the eager graph enqueued pad/reshape/map/sum
        # as separate dispatches)
        return _forest_apply_jit(self.apply_fn(), self._prep(X))

    def predict(self, X) -> np.ndarray:
        idx = np.asarray(jnp.argmax(self.predict_proba(X), axis=-1))
        return self.classes[idx]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


@jax.jit
def _forest_apply_jit(apply_fn, X):
    """Stable-identity jit over the forest's ``Partial`` apply function
    (caches per pytree structure, like every sweep path)."""
    return apply_fn(X)
