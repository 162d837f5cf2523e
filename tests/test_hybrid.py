"""Hybrid (device-reduce + host-assemble) finalisation vs oracle and host path."""

import numpy as np
import pytest

from tpumcia.config import FeatureConfig
from tpumcia.features.extract import extract_features
from tpumcia.reference_impl import oracle


def test_fetch_concurrent_matches_plain():
    """Chunked concurrent D2H must preserve content and order, and fall
    back to a plain fetch for small arrays."""
    import jax.numpy as jnp

    from tpumcia.features.hybrid import _fetch_concurrent

    big = jnp.arange(7 * 191 * 20, dtype=jnp.uint32).reshape(7 * 191, 20)
    np.testing.assert_array_equal(
        _fetch_concurrent(big, min_bytes=0), np.asarray(big)
    )
    small = jnp.arange(12, dtype=jnp.uint32).reshape(3, 4)
    np.testing.assert_array_equal(_fetch_concurrent(small), np.asarray(small))
    # small leading axis, wide second axis -> splits on axis 1
    wide = jnp.arange(3 * 100000, dtype=jnp.uint32).reshape(3, 100000)
    np.testing.assert_array_equal(
        _fetch_concurrent(wide, min_bytes=0), np.asarray(wide)
    )

HYBRID = FeatureConfig(precision="hybrid")
EXACT = FeatureConfig(precision="exact")


def test_hybrid_golden(small_batch):
    ref = np.stack([oracle.feature_vector(im / 255.0) for im in small_batch])
    fm = extract_features(small_batch, config=HYBRID)
    err = np.abs(fm.values - ref)
    assert np.nanmax(err) < 1e-5  # BASELINE.md target
    assert np.nanmean(err) < 1e-6
    # the exact-integer features are bit-tight even in hybrid mode
    exact_cols = [
        i for i, n in enumerate(fm.names)
        if n.split("_Ch")[0] in (
            "min_intensity", "max_intensity", "total_intensity",
            "mean_intensity", "contrast", "dissimilarity", "ASM", "energy",
            "correlation",
        ) or n.startswith("percentile")
    ]
    assert np.nanmax(err[:, exact_cols]) < 1e-9


def test_hybrid_matches_host_on_edges(rng):
    imgs = np.zeros((4, 32, 32, 2), dtype=np.uint8)
    imgs[0, :, :, 0] = 7  # constant channel
    imgs[1] = (rng.random((32, 32, 2)) * 256).astype(np.uint8)
    imgs[2, :, :, :] = 255
    imgs[3, :16] = 3
    imgs[3, 16:] = 250
    a = extract_features(imgs, config=HYBRID)
    b = extract_features(imgs, config=EXACT)
    assert np.array_equal(np.isnan(a.values), np.isnan(b.values))
    err = np.abs(np.nan_to_num(a.values) - np.nan_to_num(b.values))
    assert err.max() < 1e-5
    np.testing.assert_array_equal(
        np.asarray(a.degenerate), np.asarray(b.degenerate)
    )


def test_hybrid_masked(rng):
    img = (rng.random((2, 32, 32, 1)) * 256).astype(np.uint8)
    mask = rng.random((2, 32, 32, 1)) > 0.3
    a = extract_features(img, mask=mask, config=HYBRID)
    b = extract_features(img, mask=mask, config=EXACT)
    err = np.abs(np.nan_to_num(a.values) - np.nan_to_num(b.values))
    assert err.max() < 1e-5


def test_hybrid_falls_back_for_large_images(rng):
    # 256x256 = 65536 pixels: hybrid's exact-integer bounds don't hold
    img = (rng.random((1, 256, 256, 1)) * 256).astype(np.uint8)
    a = extract_features(img, config=HYBRID)
    b = extract_features(img, config=EXACT)
    np.testing.assert_array_equal(a.values, b.values)  # same (host) backend


def test_wire_format_matches_packed(rng):
    """The 20-word u32 wire decodes to exactly the same reduction dict as the
    51-f32 packed layout (including fully-masked and constant channels)."""
    from tpumcia.features.hybrid import (
        _device_reduce_packed,
        _device_reduce_wire,
        unpack_reduced,
        unpack_wire,
    )
    from tpumcia.features.stats import sufficient_stats

    imgs = (rng.random((4, 24, 24, 2)) * 256).astype(np.uint8)
    imgs[0, :, :, 0] = 9  # constant channel
    mask = np.ones((4, 24, 24, 2), bool)
    mask[1, :, :, 1] = False  # fully masked channel (n = 0)
    stats = sufficient_stats(imgs, mask=mask)
    a = unpack_reduced(np.asarray(_device_reduce_packed(stats)))
    b = unpack_wire(np.asarray(_device_reduce_wire(stats)))
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(
            np.asarray(a[key], np.float64),
            np.asarray(b[key], np.float64),
            err_msg=key,
        )


@pytest.mark.slow
def test_hybrid_fuzz_vs_exact(rng):
    """Randomized images + masks: hybrid stays within the MAE target of the
    exact path across many draws (regression net for the exact-integer
    bounds and mask interactions)."""
    for trial in range(8):
        B = int(rng.integers(1, 4))
        H = int(rng.integers(8, 48))
        W = int(rng.integers(8, 48))
        C = int(rng.integers(1, 4))
        img = (rng.random((B, H, W, C)) * 256).astype(np.uint8)
        if trial % 3 == 0:
            mask = rng.random((B, H, W, C)) > rng.uniform(0.1, 0.7)
        else:
            mask = None
        a = extract_features(img, mask=mask, config=HYBRID)
        b = extract_features(img, mask=mask, config=EXACT)
        av = np.nan_to_num(np.asarray(a.values, np.float64))
        bv = np.nan_to_num(np.asarray(b.values, np.float64))
        err = np.abs(av - bv)
        assert err.max() < 1e-5, (trial, B, H, W, C, err.max())
        np.testing.assert_array_equal(
            np.asarray(a.degenerate), np.asarray(b.degenerate)
        )


def test_hybrid_std_correct_for_nondefault_levels(rng):
    """r4 regression: _device_reduce hard-coded 255 as the level-value
    divisor, making std wrong by (L-1)/255 for any levels != 256 on the
    hybrid backend (measured 17x at levels=16). Host backend (independent
    f64 path) is the reference here."""
    imgs = (rng.random((3, 20, 20, 2)) * 16).astype(np.uint8)
    for levels in (16, 64):
        from tpumcia.config import GLCMConfig

        cfg_h = FeatureConfig(
            precision="hybrid",
            glcm=GLCMConfig(levels=levels),
        )
        cfg_e = FeatureConfig(
            precision="exact",
            glcm=GLCMConfig(levels=levels),
        )
        got = extract_features(imgs, config=cfg_h)
        ref = extract_features(imgs, config=cfg_e)
        std_cols = [i for i, n in enumerate(ref.names) if n.startswith("std")]
        np.testing.assert_allclose(
            np.asarray(got.values)[:, std_cols],
            np.asarray(ref.values)[:, std_cols],
            rtol=1e-5, atol=1e-7,
        )


def test_hybrid_levels_gt_256_exact_transport(rng):
    """r4 regression: the packed-f32 transport (levels > 256) cast integer
    sums past 2^24 to f32, breaking the documented exactness (correlation
    drifted 0.5% relative on large high-level channels). Wide sums now ship
    as exact 16-bit halves; the whole feature row must match the host
    backend to f64 assembly tolerance."""
    # values concentrated high so s_i/s_i2 sums are large
    imgs = (384 + rng.random((2, 100, 100, 1)) * 128).astype(np.uint16)
    from tpumcia.config import GLCMConfig

    cfg_h = FeatureConfig(
        precision="hybrid", glcm=GLCMConfig(levels=512)
    )
    cfg_e = FeatureConfig(
        precision="exact", glcm=GLCMConfig(levels=512)
    )
    got = extract_features(imgs, config=cfg_h)
    ref = extract_features(imgs, config=cfg_e)
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(got.values)),
        np.nan_to_num(np.asarray(ref.values)),
        rtol=1e-5, atol=1e-6,
    )


def test_constant_channel_nan_contract_all_backends():
    """r4 regression: the host backend detected zero variance via the
    ROUNDED m2 == 0, so a constant nonzero channel could return kurt=-2/
    skew=+-1 (n=100, level=200 reproduced it) instead of the scipy NaN the
    module contract documents; hybrid (exact integer numerators) was right
    and the backends disagreed. All backends must now agree: NaN."""
    imgs = np.full((1, 10, 10, 1), 200, np.uint8)
    for precision in ("exact", "hybrid"):
        cfg = FeatureConfig(precision=precision)
        fm = extract_features(imgs, config=cfg)
        vals = dict(zip(fm.names, np.asarray(fm.values)[0]))
        assert np.isnan(vals["kurtosis_intensity_Ch1"]), (precision, vals)
        assert np.isnan(vals["skew_intensity_Ch1"]), (precision, vals)
    cfg = FeatureConfig(precision="device")
    fm = extract_features(imgs, config=cfg)
    vals = dict(zip(fm.names, np.asarray(fm.to_numpy())[0]))
    assert np.isnan(vals["kurtosis_intensity_Ch1"]), vals
    assert np.isnan(vals["skew_intensity_Ch1"]), vals


def test_finalize_hybrid_rejects_oversized_counts(rng):
    """Direct finalize_features(backend='hybrid') on large-image stats must
    refuse loudly (16-bit wire fields would silently wrap) — only
    extract_features demotes automatically."""
    from tpumcia.features.finalize import finalize_features
    from tpumcia.features.stats import sufficient_stats

    imgs = (rng.random((1, 300, 300, 1)) * 256).astype(np.uint8)
    stats = sufficient_stats(imgs)
    with pytest.raises(ValueError, match="65536"):
        finalize_features(stats, backend="hybrid")
