"""Multi-device (SPMD) execution of the feature/importance pipeline.

The reference's only concurrency is a joblib process pool inside
``permutation_importance`` (ipynb:495-496). Here the multi-device
equivalents:

* ``extract_features_sharded`` — objects sharded over the ``data`` mesh axis
  with ``shard_map``; each device reduces its local shard with the same
  sufficient-statistics kernel, no cross-device traffic (embarrassingly
  parallel per SURVEY.md §2.4).
* ``fit_scaler_sharded`` — per-shard min/max combined with
  ``lax.pmin/pmax`` across devices — the psum-style global reduction the
  MinMaxScaler needs (SURVEY.md §5 "distributed communication").
* ``permutation_importance_sharded`` — the (group, repeat) sweep sharded
  over devices: X replicated, group masks split over ``data``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tpumcia.features import registry
from tpumcia.features.extract import FeatureMatrix
from tpumcia.features.finalize import finalize_features
from tpumcia.features.stats import SuffStats, _single_image_stats, rescale_lut, _prep_inputs
from tpumcia.models.scaler import MinMaxScaler


@functools.lru_cache(maxsize=16)
def _lut_for_mesh(levels: int, mesh: Mesh):
    """Rescale LUT placed REPLICATED over the mesh (cached per (levels,
    mesh)). A plain ``jnp.asarray`` would commit the table to one local
    device — fine single-process, but a jit over a cross-process mesh
    rejects inputs committed to a device subset, so multi-host extraction
    needs the replicated placement (and the cache keeps the 256 KB table
    from being re-uploaded every call)."""
    from jax.sharding import NamedSharding

    return jax.device_put(rescale_lut(levels), NamedSharding(mesh, P()))


def local_to_global(arr, sharding):
    """Turn a committed local device array (identical on every process)
    into a global array with the given (cross-process) sharding by handing
    each local device its shard directly — ``device_put`` to a
    cross-process sharding is rejected for committed arrays, and a host
    round trip would copy the bulk data twice."""
    shards = [
        jax.device_put(arr[idx], d)
        for d, idx in sharding.addressable_devices_indices_map(
            arr.shape
        ).items()
    ]
    return jax.make_array_from_single_device_arrays(
        arr.shape, sharding, shards
    )


def _local_to_global_rows(arr, mesh):
    from jax.sharding import NamedSharding

    return local_to_global(arr, NamedSharding(mesh, P("data")))


def _place_raw_over_mesh(arr, mesh, n_data: int):
    """Pad a raw per-object array to the ``data``-axis multiple and make it
    a global array row-sharded over the (possibly cross-process) mesh.
    Returns ``(global_padded, orig_b)``. Images and masks are placed
    independently, so any mix of host / local-device / already-global
    inputs works. The RAW dtype is uploaded (1 B/px uint8, not the
    4 B/px int32 the prep produces) and the transpose/cast prep runs
    afterwards as sharded device ops."""
    from jax.sharding import NamedSharding

    row = NamedSharding(mesh, P("data"))
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        # already global — just pad (eager concat preserves the sharding)
        return _pad_to_multiple(arr, n_data)
    if isinstance(arr, jax.Array):
        # committed local device array (e.g. device-synthesized channels):
        # pad on device, then redistribute device-to-device
        arr, orig_b = _pad_to_multiple(arr, n_data)
        return _local_to_global_rows(arr, mesh), orig_b
    a = np.asarray(arr)
    orig_b = a.shape[0]
    pad = (-orig_b) % n_data
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return jax.device_put(a, row), orig_b


def place_global(arr, sharding):
    """Host / committed-local / already-global input -> a global array with
    ``sharding``. Device inputs are copied device-to-device (no host round
    trip); already-global arrays pass through untouched (the consuming jit
    reshards if needed)."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        return arr
    if isinstance(arr, jax.Array):
        return local_to_global(arr, sharding)
    return jax.device_put(np.asarray(arr), sharding)


def _replicate_over_mesh(arr, mesh):
    from jax.sharding import NamedSharding

    return place_global(arr, NamedSharding(mesh, P()))


def _place_inputs_over_mesh(images, mask, mesh, n_data: int):
    """Multi-process twin of ``_prep_inputs`` + ``_pad_to_multiple``:
    places the raw (B, H, W, C) images (and optional mask) over the
    cross-process ``data`` axis, then runs the same transpose/cast prep as
    sharded device ops. -> (img (B', C, H, W) i32, w or None, orig_b)."""
    raw, orig_b = _place_raw_over_mesh(images, mesh, n_data)
    if raw.ndim != 4:
        raise ValueError(
            f"expected (B, H, W, C) images, got shape {raw.shape}"
        )
    img = jnp.transpose(raw, (0, 3, 1, 2)).astype(jnp.int32)
    w = None
    if mask is not None:
        m, _ = _place_raw_over_mesh(mask, mesh, n_data)
        if m.ndim == 3:  # (B, H, W) shared across channels
            m = m[..., None]
        w = (jnp.transpose(m, (0, 3, 1, 2)) > 0).astype(jnp.float32)
        if w.shape[1] != img.shape[1]:  # shared mask -> every channel
            w = jnp.broadcast_to(w, img.shape)
    return img, w, orig_b


def _pad_to_multiple(arr, m: int):
    b = arr.shape[0]
    pad = (-b) % m
    if pad == 0:
        return arr, b
    pad_block = jnp.zeros((pad,) + arr.shape[1:], arr.dtype)
    return jnp.concatenate([arr, pad_block], axis=0), b


def _trim_stats(stats: SuffStats, orig_b: int) -> SuffStats:
    return SuffStats(*(s[:orig_b] for s in stats))


def _data_out_specs(local, example_args):
    """Out-specs matching the local function's output pytree, every array
    sharded over 'data'."""
    shapes = jax.eval_shape(local, *example_args)
    return jax.tree.map(lambda _: P("data"), shapes)


@functools.lru_cache(maxsize=64)
def _sharded_stats_fn(
    mesh, levels, offset, chunk_size, onehot_dtype, with_intensity,
    with_glcm, has_mask, shapes,
):
    """Jitted (img[, w], lut) -> sharded SuffStats, cached per (mesh, config)
    so repeated calls reuse one trace (a per-call shard_map closure would
    retrace every time). With ``has_mask=False`` the weight array is never
    materialised: ones are broadcast inside the jit (fused, never an HBM
    array)."""

    def local(img_l, *rest):
        if has_mask:
            w_l, lut = rest
        else:
            (lut,) = rest
            w_l = jnp.ones(img_l.shape, jnp.float32)
        one = functools.partial(
            _single_image_stats,
            lut=lut,
            levels=levels,
            offset=offset,
            onehot_dtype=jnp.dtype(onehot_dtype),
            with_intensity=with_intensity,
            with_glcm=with_glcm,
        )
        bs = min(chunk_size, img_l.shape[0])
        return jax.lax.map(
            lambda xw: one(xw[0], xw[1]), (img_l, w_l), batch_size=bs
        )

    n_in = 2 if has_mask else 1
    example = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=tuple([P("data")] * n_in + [P()]),
        out_specs=_data_out_specs(local, example),
    )
    return jax.jit(fn)


def sufficient_stats_sharded(
    images,
    mask=None,
    *,
    mesh: Mesh,
    levels: int = 256,
    offset: tuple[int, int] = (0, 5),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    with_intensity: bool = True,
    with_glcm: bool = True,
) -> SuffStats:
    """Per-(image, channel) sufficient statistics with the batch sharded over
    the mesh's ``data`` axis. Output stats stay sharded the same way."""
    has_mask = mask is not None
    n_data = mesh.shape["data"]

    if jax.process_count() > 1:
        # cross-process mesh: images/mask placed independently over the
        # data axis (host, local-device, and already-global inputs all
        # handled) — eager jnp prep on a host input would commit it to one
        # local device, which the cross-process jit rejects
        img, w, orig_b = _place_inputs_over_mesh(images, mask, mesh, n_data)
    else:
        if has_mask:
            img, w = _prep_inputs(images, mask)
        else:
            img = jnp.transpose(
                jnp.asarray(images), (0, 3, 1, 2)
            ).astype(jnp.int32)
            w = None
        img, orig_b = _pad_to_multiple(img, n_data)
        if has_mask:
            w, _ = _pad_to_multiple(w, n_data)
    lut = _lut_for_mesh(levels, mesh)

    args = (img, w, lut) if has_mask else (img, lut)
    shapes = tuple((tuple(a.shape), jnp.dtype(a.dtype).name) for a in args)
    fn = _sharded_stats_fn(
        mesh, levels, tuple(offset), chunk_size, onehot_dtype,
        with_intensity, with_glcm, has_mask, shapes,
    )
    return _trim_stats(fn(*args), orig_b)


@functools.lru_cache(maxsize=64)
def _sharded_stats_multi_fn(
    mesh, levels, offsets, chunk_size, onehot_dtype, with_intensity,
    has_mask, shapes,
):
    """Jitted (img[, w], lut) -> per-offset sharded SuffStats tuple — the
    multi-offset sibling of :func:`_sharded_stats_fn` (one fused local pass
    per device sharing the raw/histogram/rescale work across offsets)."""
    from tpumcia.features.stats import _sufficient_stats_multi_jit

    def local(img_l, *rest):
        if has_mask:
            w_l, lut = rest
        else:
            (lut,) = rest
            w_l = jnp.ones(img_l.shape, jnp.float32)
        return _sufficient_stats_multi_jit(
            img_l, w_l, lut, levels=levels, offsets=offsets,
            chunk_size=chunk_size, onehot_dtype=onehot_dtype,
            with_intensity=with_intensity,
        )

    n_in = 2 if has_mask else 1
    example = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=tuple([P("data")] * n_in + [P()]),
        out_specs=_data_out_specs(local, example),
    )
    return jax.jit(fn)


def sufficient_stats_sharded_multi(
    images,
    mask=None,
    *,
    mesh: Mesh,
    levels: int = 256,
    offsets: tuple[tuple[int, int], ...] = ((0, 5),),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    with_intensity: bool = True,
) -> tuple[SuffStats, ...]:
    """Fused multi-offset sufficient statistics, batch sharded over the
    mesh's ``data`` axis (skimage list API x SPMD)."""
    has_mask = mask is not None
    n_data = mesh.shape["data"]

    if jax.process_count() > 1:
        # cross-process mesh: images/mask placed independently over the
        # data axis (host, local-device, and already-global inputs all
        # handled) — eager jnp prep on a host input would commit it to one
        # local device, which the cross-process jit rejects
        img, w, orig_b = _place_inputs_over_mesh(images, mask, mesh, n_data)
    else:
        if has_mask:
            img, w = _prep_inputs(images, mask)
        else:
            img = jnp.transpose(
                jnp.asarray(images), (0, 3, 1, 2)
            ).astype(jnp.int32)
            w = None
        img, orig_b = _pad_to_multiple(img, n_data)
        if has_mask:
            w, _ = _pad_to_multiple(w, n_data)
    lut = _lut_for_mesh(levels, mesh)

    args = (img, w, lut) if has_mask else (img, lut)
    shapes = tuple((tuple(a.shape), jnp.dtype(a.dtype).name) for a in args)
    fn = _sharded_stats_multi_fn(
        mesh, levels, tuple(tuple(o) for o in offsets), chunk_size,
        onehot_dtype, with_intensity, has_mask, shapes,
    )
    all_stats = fn(*args)
    return tuple(_trim_stats(st, orig_b) for st in all_stats)


def extract_features_sharded(
    images,
    mask=None,
    *,
    mesh: Mesh,
    levels: int = 256,
    offset: tuple[int, int] = (0, 5),
    chunk_size: int = 32,
    precision: str = "exact",
    channel_names: list[str] | None = None,
) -> FeatureMatrix:
    stats = sufficient_stats_sharded(
        images, mask, mesh=mesh, levels=levels, offset=offset, chunk_size=chunk_size
    )
    backend = {"exact": "host", "hybrid": "hybrid", "device": "device"}[precision]
    if backend == "hybrid" and images.shape[1] * images.shape[2] >= 65536:
        backend = "host"
    done = finalize_features(stats, backend=backend)
    C = images.shape[-1]
    return FeatureMatrix(
        values=done.values,
        names=registry.feature_names(C, channel_names=channel_names),
        num_channels=C,
        degenerate=done.degenerate,
    )


@functools.lru_cache(maxsize=16)
def _sharded_minmax_fn(mesh):
    def local(xs):
        lo = jnp.min(xs, axis=0, keepdims=True)
        hi = jnp.max(xs, axis=0, keepdims=True)
        lo = jax.lax.pmin(lo, "data")
        hi = jax.lax.pmax(hi, "data")
        return lo, hi

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=(P("data"),), out_specs=(P(), P()))
    )


def fit_scaler_sharded(X, *, mesh: Mesh) -> MinMaxScaler:
    """Global per-feature min/max over a data-sharded matrix, reduced with
    collectives over the mesh (the multi-device MinMaxScaler fit).

    Multi-process meshes: pass either a global data-sharded array (from
    ``parallel.distributed.shard_across_processes``) or a host array that is
    identical on every process (it is then sharded over the mesh here)."""
    n_data = mesh.shape["data"]
    multi = jax.process_count() > 1
    if multi and not isinstance(X, jax.Array):
        from jax.sharding import NamedSharding

        Xh = np.asarray(X, np.float32)
        pad = (-Xh.shape[0]) % n_data
        if pad:  # pad rows must not perturb min/max: replicate row 0
            Xh = np.concatenate([Xh, np.tile(Xh[:1], (pad, 1))])
        Xp = jax.device_put(Xh, NamedSharding(mesh, P("data")))
    else:
        Xp, orig = _pad_to_multiple(jnp.asarray(X, jnp.float32), n_data)
        # pad rows must not perturb min/max: replicate row 0
        if Xp.shape[0] != orig:
            Xp = Xp.at[orig:].set(Xp[0])
        if multi and Xp.is_fully_addressable:
            # the cross-process jit rejects locally-committed inputs:
            # redistribute device-to-device (already-global X passes as-is)
            Xp = _local_to_global_rows(Xp, mesh)
    lo, hi = _sharded_minmax_fn(mesh)(Xp)
    return MinMaxScaler.from_stats(lo[0], hi[0])


def permutation_importance_sharded(
    head,
    X,
    y,
    *,
    mesh: Mesh,
    n_repeats: int = 10,
    seed: int = 42,
    groups: list[list[int]] | None = None,
):
    """The device permutation sweep with groups sharded over the mesh's
    ``data`` axis (X and the head replicated on every device)."""
    from tpumcia.importance.permutation import (
        PermutationResult,
        _device_score_parts,
        check_n_repeats,
    )

    n_repeats = check_n_repeats(n_repeats)

    apply_fn, classes = _device_score_parts(head)
    from tpumcia.importance.permutation import group_masks, labels_to_class_idx

    y_idx = jnp.asarray(labels_to_class_idx(y, classes))
    # keep a host X on host until the placement decision: an eager jnp cast
    # here would commit it to one local device, which the multi-process
    # branch would then have to fetch back and re-upload
    if isinstance(X, jax.Array):
        if X.dtype != jnp.float32:
            X = X.astype(jnp.float32)  # on-device cast
    else:
        X = np.asarray(X, np.float32)
    F = X.shape[1]

    masks = group_masks(groups, F)
    G = masks.shape[0]
    n_data = mesh.shape["data"]
    # pad on HOST: committing the masks to a local device first would force
    # the multi-process branch to fetch them back
    Gp = -(-G // n_data) * n_data
    masks_np = (
        np.concatenate([masks, np.zeros((Gp - G, F), np.float32)])
        if Gp > G
        else masks
    )

    if jax.process_count() > 1:
        # a cross-process jit rejects inputs committed to one local device:
        # place the (identical-on-every-process) sweep inputs over the
        # mesh — masks data-sharded straight from host, the key split
        # computed ON the mesh from the scalar seed (no device->host->device
        # round trip of the key array), X / labels / head replicated
        # (device inputs copied device-to-device, never through the host).
        # Single-process calls skip this entirely (no extra transfers).
        from jax.sharding import NamedSharding

        row = NamedSharding(mesh, P("data"))
        masks_p = jax.device_put(masks_np, row)
        keys = _keys_jit(mesh, Gp, n_repeats)(seed)
        X = _replicate_over_mesh(X, mesh)
        y_idx = _replicate_over_mesh(y_idx, mesh)
        apply_fn = jax.tree.map(
            lambda l: _replicate_over_mesh(l, mesh), apply_fn
        )
    else:
        masks_p = jnp.asarray(masks_np)
        keys = _split_keys(seed, num=Gp, n_repeats=n_repeats)

    # baseline comes out of the SAME sharded dispatch as the scores (no
    # separate accuracy jit + scalar fetch)
    baseline_dev, scores = _sharded_sweep_fn(mesh)(
        masks_p, keys, X, y_idx, apply_fn
    )
    scores = scores[:G]
    baseline = float(np.asarray(baseline_dev))
    imp = baseline - np.asarray(scores, np.float64)
    return PermutationResult(
        importances=imp,
        importances_mean=imp.mean(axis=1),
        importances_std=imp.std(axis=1),
        baseline_score=baseline,
    )


def _split_keys(seed, *, num, n_repeats):
    """(num, n_repeats) key grid — the same ``split(key(seed), num * R)``
    stream every sweep variant draws (PRNG equality pinned by tests)."""
    return jax.random.split(
        jax.random.key(seed), num * n_repeats
    ).reshape(num, n_repeats)


@functools.lru_cache(maxsize=32)
def _keys_jit(mesh, num, n_repeats):
    """Stable-identity jit computing the sweep key grid ON the cross-process
    mesh from the scalar seed (row-sharded output): the keys never exist on
    one local device, so nothing is fetched back."""
    from jax.sharding import NamedSharding

    row = NamedSharding(mesh, P("data"))
    return jax.jit(
        functools.partial(_split_keys, num=num, n_repeats=n_repeats),
        out_shardings=row,
    )


@functools.lru_cache(maxsize=32)
def _sharded_sweep_fn(mesh):
    """Jitted sharded (group, repeat) sweep, cached per mesh; X / labels /
    the head's ``Partial`` apply function are replicated shard_map inputs,
    so one trace serves every head with the same pytree structure."""

    def local(masks_l, keys_l, X, y_idx, apply_fn):
        def accuracy(Xp):
            pred = jnp.argmax(apply_fn(Xp), axis=-1)
            return jnp.mean((pred == y_idx).astype(jnp.float32))

        def one_group(args):
            mask, kg = args

            def one_repeat(k):
                perm = jax.random.permutation(k, X.shape[0])
                Xp = X * (1 - mask) + jnp.take(X, perm, axis=0) * mask
                return accuracy(Xp)

            return jax.vmap(one_repeat)(kg)

        # baseline rides the same program (replicated inputs -> identical
        # value on every shard) instead of a separate dispatch
        return accuracy(X), jax.lax.map(one_group, (masks_l, keys_l))

    def wrapped(masks_p, keys, X, y_idx, apply_fn):
        apply_specs = jax.tree.map(lambda _: P(), apply_fn)
        fn = shard_map(
            local,
            mesh=mesh,
            in_specs=(P("data"), P("data"), P(), P(), apply_specs),
            out_specs=(P(), P("data")),
        )
        return fn(masks_p, keys, X, y_idx, apply_fn)

    return jax.jit(wrapped)
