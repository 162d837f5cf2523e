"""Occlusion and pixel-space channel importance for the CNN path.

BASELINE.json config 3: occlusion/permutation channel importance.
Three probes over a trained image classifier:

* ``channel_occlusion_importance`` — zero out one channel entirely; accuracy
  drop = channel importance (vectorised over channels on device).
* ``channel_permutation_importance_images`` — shuffle one channel *across the
  batch* (breaks channel-label alignment while keeping the channel's marginal
  distribution); the pixel-space analogue of the feature permutation sweep.
* ``occlusion_map`` — slide a zero window over the image; per-position drop
  in the true-class probability gives a spatial saliency map per image.

All sweeps are module-level jits taking the head's ``apply_fn`` (a
``jax.tree_util.Partial`` with stable function identity) as an argument, so
repeated calls — and warm-up/timed benchmark splits — reuse one trace
instead of retracing the CNN per call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _labels_to_idx(classes, y):
    # shared sentinel mapping: labels unseen at training time become -1
    # instead of KeyError, matching the feature-space sweep variants. In
    # the accuracy probes (pred == y_idx) the sentinel scores as a
    # misprediction; in occlusion_map's take_along_axis the -1 wraps to
    # the last class, which is CONSISTENT between the base and occluded
    # probabilities (the drop for such rows is near-zero signal, not a
    # crash).
    from tpumcia.importance.permutation import labels_to_class_idx

    return jnp.asarray(labels_to_class_idx(y, classes))


def _replicate_for(head, *arrays):
    """Re-place sweep inputs over the head's mesh when the runtime spans
    processes (a cross-process jit rejects locally-committed arrays; sweep
    inputs are identical on every process). No-op otherwise."""
    mesh = getattr(head, "mesh", None)
    if mesh is None or jax.process_count() == 1:
        return arrays
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpumcia.parallel.sharding import _replicate_over_mesh

    rep = NamedSharding(mesh, P())

    def put(a):
        if isinstance(a, jax.Array) and jnp.issubdtype(
            a.dtype, jax.dtypes.prng_key
        ):
            # typed PRNG keys can't round-trip through numpy: ship the key
            # data and re-wrap (same stream) as a global op
            data = jax.device_put(np.asarray(jax.random.key_data(a)), rep)
            return jax.random.wrap_key_data(data)
        # bulk inputs (image batches) replicate device-to-device instead of
        # a host round trip
        return _replicate_over_mesh(a, mesh)

    return tuple(put(a) for a in arrays)


@jax.jit
def _occlusion_sweep(apply_fn, x, y_idx, fill):
    C = x.shape[-1]

    def acc(xp):
        pred = jnp.argmax(apply_fn(xp), axis=-1)
        return jnp.mean((pred == y_idx).astype(jnp.float32))

    baseline = acc(x)

    def occlude(c):
        mask = (jnp.arange(C) == c).astype(x.dtype)
        return acc(x * (1 - mask) + fill * mask)

    drops = jax.lax.map(occlude, jnp.arange(C))
    return baseline, baseline - drops


def channel_occlusion_importance(head, images, y, *, fill: float = 0.0) -> np.ndarray:
    """(C,) accuracy drops when each channel is replaced by ``fill``."""
    x = jnp.asarray(images, jnp.float32)
    y_idx = _labels_to_idx(head.classes, y)
    x, y_idx = _replicate_for(head, x, y_idx)
    baseline, drops = _occlusion_sweep(
        head.apply_fn(), x, y_idx, jnp.float32(fill)
    )
    return np.asarray(drops, np.float64)


@functools.partial(jax.jit, static_argnames=("n_repeats",))
def _channel_perm_sweep(apply_fn, x, y_idx, key, *, n_repeats):
    B = x.shape[0]
    C = x.shape[-1]

    def acc(xp):
        pred = jnp.argmax(apply_fn(xp), axis=-1)
        return jnp.mean((pred == y_idx).astype(jnp.float32))

    baseline = acc(x)
    keys = jax.random.split(key, C * n_repeats).reshape(C, n_repeats)

    def one_channel(args):
        c, kc = args
        mask = (jnp.arange(C) == c).astype(x.dtype)

        def one_repeat(k):
            perm = jax.random.permutation(k, B)
            xp = x * (1 - mask) + jnp.take(x, perm, axis=0) * mask
            return acc(xp)

        return jax.lax.map(one_repeat, kc)

    drops = jax.lax.map(one_channel, (jnp.arange(C), keys))
    return baseline, baseline - drops


def channel_permutation_importance_images(
    head, images, y, *, n_repeats: int = 5, seed: int = 42
) -> np.ndarray:
    """(C, R) accuracy drops when channel c's planes are shuffled across the
    batch (each repeat a fresh permutation)."""
    x = jnp.asarray(images, jnp.float32)
    y_idx = _labels_to_idx(head.classes, y)
    x, y_idx, key = _replicate_for(head, x, y_idx, jax.random.key(seed))
    baseline, drops = _channel_perm_sweep(
        head.apply_fn(), x, y_idx, key, n_repeats=n_repeats
    )
    return np.asarray(drops, np.float64)


@functools.partial(jax.jit, static_argnames=("window",))
def _occlusion_map_sweep(apply_fn, x, y_idx, positions, fill, *, window):
    H, W = x.shape[1], x.shape[2]
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    probs = jax.nn.softmax(apply_fn(x), axis=-1)
    base = jnp.take_along_axis(probs, y_idx[:, None], axis=1)[:, 0]  # (B,)

    def occlude(pos):
        r, c = pos[0], pos[1]
        m = (yy >= r) & (yy < r + window) & (xx >= c) & (xx < c + window)
        m = m[None, :, :, None].astype(x.dtype)
        xp = x * (1 - m) + fill * m
        p = jax.nn.softmax(apply_fn(xp), axis=-1)
        return base - jnp.take_along_axis(p, y_idx[:, None], axis=1)[:, 0]

    return jax.lax.map(occlude, positions)  # (P, B)


def occlusion_map(
    head, images, y, *, window: int = 8, stride: int = 8, fill: float = 0.0
) -> np.ndarray:
    """(B, R, C) map of true-class probability drops when a ``window`` x
    ``window`` patch (all channels) is filled at each grid position, where
    R = len(range(0, H-window+1, stride)) (min 1) and likewise C over W —
    windows are kept fully inside the image, so for window > stride the
    grid is smaller than ceil(H/stride)."""
    x = jnp.asarray(images, jnp.float32)
    y_idx = _labels_to_idx(head.classes, y)
    B, H, W, C = x.shape
    rows = list(range(0, H - window + 1, stride)) or [0]
    cols = list(range(0, W - window + 1, stride)) or [0]
    positions = jnp.asarray([(r, c) for r in rows for c in cols], jnp.int32)
    x, y_idx, positions = _replicate_for(head, x, y_idx, positions)

    drops = np.asarray(
        _occlusion_map_sweep(
            head.apply_fn(), x, y_idx, positions, jnp.float32(fill),
            window=window,
        )
    )  # (P, B)
    return drops.T.reshape(B, len(rows), len(cols))
