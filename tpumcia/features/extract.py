"""End-to-end batched feature extraction: (B, H, W, C) images -> (B, 23*C).

The reference extracts features in a sequential Python loop at 53.46 images/s
(ipynb:358-364); here the whole batch is one jitted device computation whose
scalar reduction is assembled in float64 on host (``precision='hybrid'``,
the default), with a full-histogram host path (``'exact'``) and a fully
device-resident float32 path (``'device'``) as alternatives.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import jax
import numpy as np

from tpumcia.config import FeatureConfig
from tpumcia.features import registry
from tpumcia.features.finalize import finalize_features
from tpumcia.features.stats import sufficient_stats, sufficient_stats_multi


@dataclass
class FeatureMatrix:
    """Feature values plus column metadata (the framework's DataFrame-free
    equivalent of the reference's ``df_features``, ipynb:327-334)."""

    values: Any  # (B, F) np.ndarray (exact mode) or jax.Array (device mode)
    names: list[str]
    num_channels: int
    degenerate: Any = None  # (B, C) bool flags
    config: FeatureConfig = field(default_factory=FeatureConfig)
    channel_names: list[str] | None = None  # display names (h5 contract)
    # optional device-resident float32 copy of the matrix (NaN-cleaned),
    # computed inside the extraction dispatches so heads/importance sweeps
    # can ride it without re-uploading the matrix
    device_values: Any = None

    @property
    def shape(self):
        return tuple(self.values.shape)

    def __len__(self):
        return self.values.shape[0]

    def column(self, name: str):
        return self.values[:, self.names.index(name)]

    def channel_columns(self) -> list[list[int]]:
        """Exact-index per-channel column groups (fixes the reference's
        substring matching, SURVEY.md §3.3). Uses the deterministic block
        layout, so custom h5 channel names group correctly too."""
        labels = self.config.glcm.pair_labels if self.config else None
        return registry.columns_by_channel_positional(
            self.num_channels,
            include_intensity=self.config.include_intensity if self.config else True,
            include_glcm=self.config.include_glcm if self.config else True,
            num_glcm_blocks=len(labels) if labels else 1,
            include_morphology=(
                self.config.include_morphology if self.config else False
            ),
        )

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_numpy(), columns=self.names)

    def to_numpy(self) -> np.ndarray:
        # fetch_to_host: device-backend values on a cross-process mesh are
        # replicated before the local fetch (np.asarray alone would raise)
        from tpumcia.features.finalize import fetch_to_host

        return fetch_to_host(self.values)

    def save(self, path) -> None:
        """Persist to .npz (values + names + flags + config + channel
        names — without the config, a loaded multi-offset/morphology
        matrix would misgroup ``channel_columns()`` and silently
        under-permute every channel in the importance sweeps)."""
        import dataclasses
        import json

        from tpumcia.features.finalize import fetch_to_host

        payload = dict(
            values=self.to_numpy(),
            names=np.array(self.names),
            num_channels=self.num_channels,
            degenerate=(
                fetch_to_host(self.degenerate)
                if self.degenerate is not None
                else np.zeros((len(self), self.num_channels), bool)
            ),
            config_json=np.asarray(json.dumps(dataclasses.asdict(self.config))),
        )
        if self.channel_names is not None:
            payload["channel_names"] = np.array(self.channel_names)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path) -> "FeatureMatrix":
        import json

        from tpumcia.config import build_config

        with np.load(path, allow_pickle=False) as z:
            cfg = (
                build_config(FeatureConfig, json.loads(str(z["config_json"])))
                if "config_json" in z
                else FeatureConfig()  # pre-r4 checkpoint
            )
            return cls(
                values=z["values"],
                names=[str(n) for n in z["names"]],
                num_channels=int(z["num_channels"]),
                degenerate=z["degenerate"],
                config=cfg,
                channel_names=(
                    [str(c) for c in z["channel_names"]]
                    if "channel_names" in z
                    else None
                ),
            )


def extract_features(
    images,
    mask=None,
    *,
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
    mesh=None,
) -> FeatureMatrix:
    """Extract the hand-crafted feature set from a batch of level-quantised
    images.

    Parameters
    ----------
    images : (B, H, W, C) uint8/int array of raw levels (the reference
        operates on the /255 float image; level-space is equivalent and exact,
        SURVEY.md §2.3). For 16-bit data use
        ``preprocess.quantize_to_levels`` first.
    mask : optional (B, H, W, C) or (B, H, W) nonzero-selects-pixels mask
        (h5 contract, README.md:9).
    config : FeatureConfig; defaults mirror the notebook (GLCM distance 5,
        angle 0, 256 levels).
    mesh : optional jax.sharding.Mesh — shard the batch over its ``data``
        axis (shard_map SPMD; SURVEY.md §2.4). Integer-derived statistics
        match the single-device path exactly; f32-summed fields (central
        moments, entropy, homogeneity) agree to ~1e-4 relative (different
        reduction order).
    """
    cfg = config or FeatureConfig()
    if not (cfg.include_intensity or cfg.include_glcm):
        raise ValueError("at least one feature family must be enabled")

    images = _as_level_array(images, cfg.glcm.levels)
    if mask is not None:
        mshape = tuple(mask.shape)
        if mshape not in (tuple(images.shape), tuple(images.shape[:3])):
            raise ValueError(
                f"mask shape {mshape} must equal the images' "
                f"{tuple(images.shape)} or per-object {tuple(images.shape[:3])}"
            )
    backend = {"exact": "host", "hybrid": "hybrid", "device": "device"}[
        cfg.precision
    ]
    if backend == "hybrid" and images.shape[1] * images.shape[2] >= 65536:
        backend = "host"  # hybrid's exact-integer bounds need < 2^16 pixels

    def run_stats(offset, with_intensity, with_glcm):
        if mesh is not None:
            from tpumcia.parallel.sharding import sufficient_stats_sharded

            return sufficient_stats_sharded(
                images, mask, mesh=mesh, levels=cfg.glcm.levels, offset=offset,
                chunk_size=cfg.chunk_size, onehot_dtype=cfg.onehot_dtype,
                with_intensity=with_intensity, with_glcm=with_glcm,
            )
        return sufficient_stats(
            images, mask, levels=cfg.glcm.levels, offset=offset,
            chunk_size=cfg.chunk_size, onehot_dtype=cfg.onehot_dtype,
            with_intensity=with_intensity, with_glcm=with_glcm,
        )

    offsets = cfg.glcm.offsets if cfg.include_glcm else [cfg.glcm.offset]
    value_blocks = []
    degenerate = None

    def add_block(stats, with_int):
        nonlocal degenerate
        done = finalize_features(
            stats,
            include_intensity=with_int,
            include_glcm=cfg.include_glcm,
            backend=backend,
        )
        value_blocks.append(done.values)
        if degenerate is None:
            degenerate = done.degenerate
        else:
            from tpumcia.features.finalize import fetch_to_host

            degenerate = degenerate | fetch_to_host(done.degenerate)

    # backend == "hybrid" already folds in the < 2^16 pixel bound (the
    # hybrid->host demotion above); hybrid_wire_ok carries the structural
    # conditions so all fast-path routers share one predicate. Morphology is
    # appended after this block, so it does not gate the fused dispatch.
    single_dispatch = (
        mesh is None and backend == "hybrid" and hybrid_wire_ok(cfg)
    )
    if single_dispatch:
        # stats -> u32 wire fused into ONE dispatch + one wire fetch;
        # identical values to the split path
        from tpumcia.features.hybrid import (
            _fetch_concurrent,
            assemble_reduced,
            unpack_wire,
        )
        from tpumcia.features.stats import rescale_lut_device

        wire, _ = _batch_fused_dispatch(
            images, mask, None, rescale_lut_device(cfg.glcm.levels),
            levels=cfg.glcm.levels, offset=tuple(offsets[0]),
            keep_device=False,
            chunk_size=cfg.chunk_size, onehot_dtype=cfg.onehot_dtype,
        )
        done = assemble_reduced(
            unpack_wire(_fetch_concurrent(wire)), levels=cfg.glcm.levels
        )
        value_blocks.append(done.values)
        degenerate = np.asarray(done.degenerate)
    elif len(offsets) > 1 and cfg.include_glcm:
        # fused multi-offset pass: the raw one-hot / histogram / rescale work
        # is shared across all offsets (skimage list API, ipynb:298)
        if mesh is not None:
            from tpumcia.parallel.sharding import sufficient_stats_sharded_multi

            all_stats = sufficient_stats_sharded_multi(
                images, mask, mesh=mesh, levels=cfg.glcm.levels,
                offsets=tuple(offsets), chunk_size=cfg.chunk_size,
                onehot_dtype=cfg.onehot_dtype,
                with_intensity=cfg.include_intensity,
            )
        else:
            all_stats = sufficient_stats_multi(
                images, mask, levels=cfg.glcm.levels,
                offsets=tuple(offsets), chunk_size=cfg.chunk_size,
                onehot_dtype=cfg.onehot_dtype,
                with_intensity=cfg.include_intensity,
            )
        if (
            mesh is None
            and backend == "hybrid"
            and hybrid_wire_ok(cfg, images.shape, multi_offset=True)
        ):
            # ONE fetch for the whole offset list: shared intensity words +
            # 9 GLCM words per offset (hybrid.py multi wire) instead of one
            # finalize fetch per offset
            from tpumcia.features.hybrid import (
                _device_reduce_wire_multi,
                _fetch_concurrent,
                assemble_reduced,
                unpack_wire_multi,
            )

            reduced = unpack_wire_multi(
                _fetch_concurrent(_device_reduce_wire_multi(tuple(all_stats))),
                len(all_stats),
            )
            if np.any(reduced[0]["count_overflow"]):
                raise ValueError(
                    "hybrid finalize requires per-channel pixel counts < "
                    "65536 (images this large should use precision='exact')"
                )
            for i, r in enumerate(reduced):
                done = assemble_reduced(
                    r,
                    levels=cfg.glcm.levels,
                    include_intensity=cfg.include_intensity and i == 0,
                    include_glcm=True,
                )
                value_blocks.append(done.values)
                if degenerate is None:
                    # n/vmax are shared across offsets: one flag set
                    degenerate = np.asarray(done.degenerate)
        else:
            for i, stats in enumerate(all_stats):
                add_block(stats, cfg.include_intensity and i == 0)
    else:
        # single-offset (or intensity-only) stats pass
        for i, offset in enumerate(offsets):
            with_int = cfg.include_intensity and i == 0
            add_block(run_stats(offset, with_int, cfg.include_glcm), with_int)
            if not cfg.include_glcm:
                break

    num_channels = images.shape[-1]
    # ONE name-layout source (morphology appended last inside the registry,
    # matching columns_by_channel_positional / num_features)
    names = registry.feature_names(
        num_channels,
        include_intensity=cfg.include_intensity,
        include_glcm=cfg.include_glcm,
        channel_names=channel_names,
        glcm_pair_labels=cfg.glcm.pair_labels,
        include_morphology=cfg.include_morphology,
    )

    if cfg.include_morphology:
        if mask is None:
            raise ValueError("include_morphology requires a mask")
        from tpumcia.features.morphology import morphology_features

        morph = morphology_features(mask)  # (B, C, 8)
        morph = morph.reshape(morph.shape[0], -1)
        if isinstance(value_blocks[0], np.ndarray):
            morph = np.asarray(morph, dtype=value_blocks[0].dtype)
        value_blocks.append(morph)

    if len(value_blocks) == 1:
        values = value_blocks[0]
    elif isinstance(value_blocks[0], np.ndarray):
        values = np.concatenate(
            [np.asarray(v) for v in value_blocks], axis=1
        )
    else:
        import jax.numpy as jnp

        values = jnp.concatenate(value_blocks, axis=1)
    return FeatureMatrix(
        values=values,
        names=names,
        num_channels=num_channels,
        degenerate=degenerate,
        config=cfg,
        channel_names=list(channel_names) if channel_names else None,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "levels", "offset", "keep_device", "chunk_size", "onehot_dtype",
        "synth_noise", "synth_var",
    ),
)
def _batch_fused_dispatch(
    imgs, mask, key, lut, *, levels, offset, keep_device, chunk_size,
    onehot_dtype, synth_noise=0, synth_var=0.01,
):
    """ONE device dispatch per batch: (optional noise synth) -> sufficient
    statistics -> hybrid u32 wire (+ optionally the NaN-cleaned f32 feature
    block, which never leaves the device)."""
    import jax.numpy as jnp

    from tpumcia.features.finalize import _finalize
    from tpumcia.features.hybrid import _device_reduce_wire

    if synth_noise and mask is None:
        from tpumcia.preprocess.synth import noise_channels_chw

        # channel-major synthesis: bit-identical values, but no
        # interleaved->planar transpose of the stacked batch (the noise
        # relayout fuses into the generator; the gray plane is a reshape)
        img = noise_channels_chw(
            imgs, key, num_noise=synth_noise, var=synth_var
        )
        w = None
    else:
        if synth_noise:
            from tpumcia.preprocess.synth import add_noise_channels

            imgs = add_noise_channels(
                imgs, key, num_noise=synth_noise, var=synth_var
            )
        if mask is None:
            img = jnp.transpose(
                jnp.asarray(imgs), (0, 3, 1, 2)
            ).astype(jnp.int32)
            w = None
        else:
            from tpumcia.features.stats import _prep_inputs

            img, w = _prep_inputs(imgs, mask)
    from tpumcia.features.stats import _sufficient_stats_jit

    st = _sufficient_stats_jit(
        img, w, lut, levels=levels, offset=offset,
        chunk_size=chunk_size, onehot_dtype=onehot_dtype,
        with_intensity=True, with_glcm=True,
    )
    wire = _device_reduce_wire(st)
    feats = (
        jnp.nan_to_num(_finalize(st, jnp, jnp.float32, True, True).values)
        if keep_device
        else None
    )
    return wire, feats


@dataclass
class PendingFeatureMatrix:
    """In-flight batched extraction: dispatches are enqueued, wires not yet
    fetched. ``device_values`` (if requested) is available immediately for
    enqueueing downstream device work (head fits, sweeps) BEFORE the wire
    fetches — the downstream dispatch's compute then overlaps the
    feature-matrix D2H."""

    wires: list
    slices: list
    n: int
    names: list[str]
    num_channels: int
    config: FeatureConfig
    channel_names: list[str] | None
    device_values: Any = None  # (n, F) jax.Array, trimmed, or None

    def result(self) -> FeatureMatrix:
        """Fetch the per-batch wires concurrently and assemble the exact
        float64 matrix on worker threads."""
        from tpumcia.features.hybrid import (
            _fetch_pool,
            assemble_reduced,
            unpack_wire,
        )

        levels = self.config.glcm.levels

        def one(args):
            w, sl = args
            done = assemble_reduced(unpack_wire(np.asarray(w)), levels=levels)
            keep = sl.stop - sl.start
            return done.values[:keep], np.asarray(done.degenerate)[:keep]

        # the shared module-level pool (no thread spawn per call)
        results = list(_fetch_pool().map(one, zip(self.wires, self.slices)))

        return FeatureMatrix(
            values=np.concatenate([v for v, _ in results]),
            names=self.names,
            num_channels=self.num_channels,
            degenerate=np.concatenate([d for _, d in results]),
            config=self.config,
            channel_names=self.channel_names,
            device_values=self.device_values,
        )


def extract_features_pending(
    images,
    mask=None,
    *,
    batch_size: int = 2048,
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
    keep_device_values: bool = False,
    synth_noise: int = 0,
    synth_var: float = 0.01,
    synth_seed: int = 0,
    in_flight: int = 8,
) -> PendingFeatureMatrix:
    """Enqueue the batched hybrid extraction and return without fetching.

    Requires the hybrid fast path (single offset, intensity+GLCM, < 2^16
    pixels/channel) — :func:`extract_features_batched` falls back to
    sequential per-batch extraction otherwise. With ``synth_noise > 0``,
    ``images`` is a (N, H, W) grayscale batch and the noise channels are
    synthesized on device inside each batch's dispatch (seeded per batch).

    ``in_flight`` bounds how many batch dispatches are enqueued before the
    earliest wires must be fetched (device-memory bound for very large
    in-memory collections); within a window everything overlaps.
    """
    import jax.numpy as jnp

    from tpumcia.features.stats import rescale_lut_device

    cfg = config or FeatureConfig()
    images = _as_level_array(images, cfg.glcm.levels)
    n = len(images)
    num_channels = (
        images.shape[-1] if synth_noise == 0 else 1 + synth_noise
    )
    if synth_noise and images.ndim != 3:
        raise ValueError("synth_noise expects (N, H, W) grayscale input")
    if synth_noise and mask is not None:
        raise ValueError("synth_noise does not compose with masks")
    if not batched_fast_path_ok(images.shape, cfg):
        # the pending path IS the hybrid u32-wire pipeline; silently running
        # an 'exact'/'device'/multi-offset/morphology config (or >= 2^16
        # pixels, past the wire's exact-integer bounds) would return wrong
        # or mislabeled values — use extract_features(_batched) instead
        raise ValueError(
            "extract_features_pending requires the hybrid fast path "
            f"{FAST_PATH_REQS}; got "
            f"precision={cfg.precision!r}, offsets={cfg.glcm.offsets}, "
            f"image shape {tuple(images.shape)}"
        )

    import math

    batch_size = min(batch_size, n)
    num_batches = math.ceil(n / batch_size)
    slices = [
        slice(i * batch_size, min((i + 1) * batch_size, n))
        for i in range(num_batches)
    ]
    offsets = cfg.glcm.offsets if cfg.include_glcm else [cfg.glcm.offset]
    offset = tuple(offsets[0])
    lut = rescale_lut_device(cfg.glcm.levels)
    if synth_noise:
        from tpumcia.preprocess.synth import synth_batch_keys

        keys = synth_batch_keys(synth_seed, num_batches)
    else:
        keys = [None] * num_batches

    def pad_batch(arr, sl):
        # wrap-around pad keeps one compiled batch shape; stays on device
        b = arr[sl]
        short = batch_size - (sl.stop - sl.start)
        if short:
            b = jnp.concatenate([jnp.asarray(b), jnp.asarray(arr[:short])])
        return b

    wires, feats = [], []
    for i, sl in enumerate(slices):
        if i >= in_flight and not (i - in_flight) % in_flight:
            # bound device residency: wait for the oldest outstanding window
            # before enqueueing more (values stay on device; this only gates
            # the enqueue pace for very large collections)
            wires[i - in_flight].block_until_ready()
        imgs_b = pad_batch(images, sl)
        mask_b = pad_batch(mask, sl) if mask is not None else None
        wire, f = _batch_fused_dispatch(
            imgs_b, mask_b, keys[i], lut,
            levels=cfg.glcm.levels, offset=offset,
            keep_device=keep_device_values, chunk_size=cfg.chunk_size,
            onehot_dtype=cfg.onehot_dtype, synth_noise=synth_noise,
            synth_var=synth_var,
        )
        wires.append(wire)
        if keep_device_values:
            feats.append(f)

    device_values = None
    if keep_device_values:
        device_values = (
            jnp.concatenate(feats)[:n] if len(feats) > 1 else feats[0][:n]
        )

    names = registry.feature_names(num_channels, channel_names=channel_names)
    return PendingFeatureMatrix(
        wires=wires,
        slices=slices,
        n=n,
        names=names,
        num_channels=num_channels,
        config=cfg,
        channel_names=list(channel_names) if channel_names else None,
        device_values=device_values,
    )


# the one statement of the eligibility rules for error messages — edit it
# together with hybrid_wire_ok below
FAST_PATH_REQS = (
    "(precision='hybrid', single GLCM offset, intensity+GLCM, no "
    "morphology, < 2^16 pixels/channel, levels <= 256)"
)


def hybrid_wire_ok(
    cfg: FeatureConfig, images_shape=None, *, multi_offset: bool = False
) -> bool:
    """Single source of truth for the fused u32-wire eligibility: hybrid
    precision, single GLCM offset, intensity+GLCM, <= 256 levels, and (when
    the shape is known) < 2^16 pixels/channel — the wire's exact-integer
    bounds (hybrid.py). Every fast-path router (``extract_features``'s
    single-dispatch branch, the batched/pending APIs, the streaming wire
    mode) must consult this predicate so the eligibility rules can never
    drift apart. ``multi_offset=True`` relaxes only the offset-count
    condition (the multi-offset wire ships shared intensity words + 9 GLCM
    words per offset in ONE fetch — hybrid.py ``_device_reduce_wire_multi``)."""
    offsets = cfg.glcm.offsets if cfg.include_glcm else [cfg.glcm.offset]
    return (
        cfg.precision == "hybrid"
        and cfg.glcm.levels <= 256
        and cfg.include_intensity
        and cfg.include_glcm
        and (multi_offset or len(offsets) == 1)
        and (
            images_shape is None
            or images_shape[1] * images_shape[2] < 65536
        )
    )


def batched_fast_path_ok(images_shape, cfg: FeatureConfig) -> bool:
    """True when the fused batched hybrid wire path applies (the batched
    pipeline additionally excludes morphology — it has no wire encoding)."""
    return hybrid_wire_ok(cfg, images_shape) and not cfg.include_morphology


def extract_features_batched(
    images,
    mask=None,
    *,
    batch_size: int = 2048,
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
    keep_device_values: bool = False,
    in_flight: int = 8,
) -> FeatureMatrix:
    """Large-collection extraction as a pipeline of fixed-size batches.

    One fused device dispatch per batch (up to ``in_flight`` windows
    enqueued ahead), then the per-batch exact-scalar wires are fetched
    concurrently and assembled to float64 on worker threads — the same
    overlap discipline as the headline benchmark, exposed as a library
    call. A single fixed batch shape also avoids one giant (or many
    diverse) XLA compiles. ``keep_device_values=True`` additionally
    returns a device-resident NaN-cleaned f32 copy of the matrix
    (``FeatureMatrix.device_values``) computed inside the same dispatches;
    it requires the fast path (a ValueError is raised otherwise — the
    fallback paths have no device-resident copy to return).

    Integer-derived statistics match :func:`extract_features` exactly; the
    f32-summed fields (central moments, entropy, homogeneity) agree to
    ~1e-4 relative (the fused wire dispatch sums them in a different
    order). Falls back to sequential per-batch extraction for
    configurations outside the hybrid fast path (multi-offset, morphology,
    'exact'/'device' precision, >=2^16 pixels).
    """
    cfg = config or FeatureConfig()
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1; got {batch_size}")
    images = _as_level_array(images, cfg.glcm.levels)
    n = len(images)
    fast = batched_fast_path_ok(images.shape, cfg)
    if keep_device_values and not fast:
        raise ValueError(
            "keep_device_values=True requires the hybrid fast path "
            f"{FAST_PATH_REQS} — the "
            "fallback paths have no device-resident feature copy; got "
            f"precision={cfg.precision!r}, offsets={cfg.glcm.offsets}, "
            f"morphology={cfg.include_morphology}, "
            f"image shape {tuple(images.shape)}"
        )
    if n <= batch_size and not (fast and keep_device_values):
        return extract_features(
            images, mask=mask, config=cfg, channel_names=channel_names
        )

    if not fast:
        import math

        num_batches = math.ceil(n / batch_size)
        slices = [
            slice(i * batch_size, min((i + 1) * batch_size, n))
            for i in range(num_batches)
        ]
        fms = [
            extract_features(
                images[sl],
                mask=mask[sl] if mask is not None else None,
                config=cfg,
                channel_names=channel_names,
            )
            for sl in slices
        ]
        out = fms[0]
        values = [np.asarray(f.values) for f in fms]
        degenerate = [np.asarray(f.degenerate) for f in fms]
        return FeatureMatrix(
            values=np.concatenate(values),
            names=out.names,
            num_channels=out.num_channels,
            degenerate=np.concatenate(degenerate),
            config=cfg,
            channel_names=out.channel_names,
        )

    return extract_features_pending(
        images, mask,
        batch_size=batch_size, config=cfg, channel_names=channel_names,
        keep_device_values=keep_device_values, in_flight=in_flight,
    ).result()


# bounded best-effort scan: raw 16-bit data violates the level contract
# densely, so a small prefix sample catches the realistic mistake without
# a full host scan of every batch
_LEVEL_CHECK_SAMPLE = 1_000_000


def _as_level_array(images, levels: int = 256, sample: int = _LEVEL_CHECK_SAMPLE):
    """Validate the level-image contract: integer values in [0, levels).

    Float input is always rejected. For host arrays whose integer dtype can
    represent out-of-contract values — too wide (the classic mistake: the h5
    contract's raw uint16 straight into a 256-level extraction — every pixel
    >= levels silently falls out of the rescale LUT's one-hot and the
    features come back NaN/garbage) or signed (negative levels index the
    one-hots out of contract) — a bounded prefix sample is value-checked;
    legitimate wide-dtype level images (e.g. quantize_to_levels' int32
    output) pass untouched. Device arrays are trusted (a value check would
    force a device-to-host sync on the fast path).  ``sample`` bounds the
    scanned prefix: repeat callers on one stream (pipeline/streaming.py)
    full-check the first batch and pass a small sample for the rest, since
    the realistic violation (raw 16-bit data) is dense.
    """
    arr = images if isinstance(images, jax.Array) else np.asarray(images)
    if arr.dtype.kind == "f":
        raise TypeError(
            "extract_features expects integer level images; for float/16-bit "
            "data apply preprocess.quantize_to_levels first"
        )
    if arr.ndim == 0:
        raise TypeError(
            "extract_features expects a batched image array, got a 0-d scalar"
        )
    if (
        isinstance(arr, np.ndarray)
        and arr.dtype.kind in "iu"
        and (np.iinfo(arr.dtype).max >= levels or np.iinfo(arr.dtype).min < 0)
    ):
        # bound along axis 0 FIRST: ravel() on a non-contiguous array would
        # copy the whole thing, not just the sampled prefix
        per_row = max(1, int(np.prod(arr.shape[1:], dtype=np.int64)))
        rows = max(1, sample // per_row)
        sampled = np.ravel(arr[:rows])[:sample]
        if sampled.size and (int(sampled.max()) >= levels or int(sampled.min()) < 0):
            raise TypeError(
                f"extract_features got {arr.dtype} images with values outside "
                f"[0, glcm.levels={levels}). Apply "
                "preprocess.quantize_to_levels (16-bit aware) first, or use "
                "api.analyze_objects which quantizes uint16 automatically"
            )
    return arr

