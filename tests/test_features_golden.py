"""Golden-value tests: the device (XLA) feature path vs the CPU oracle.

BASELINE.md target: feature MAE < 1e-5 vs the reference formulas. The exact
path lands around 1e-12 because the device reduces to integer sufficient
statistics and the finalisation replays the reference's float64 arithmetic.
"""

import numpy as np
import pytest

from tpumcia.config import FeatureConfig, GLCMConfig
from tpumcia.features.extract import extract_features
from tpumcia.features.stats import rescale_lut, sufficient_stats, glcm_matrix
from tpumcia.reference_impl import oracle

XLA_CFG = FeatureConfig(precision="exact")


def _oracle_matrix(imgs):
    return np.stack([oracle.feature_vector(im / 255.0) for im in imgs])


def test_golden_full_pipeline(small_batch):
    ref = _oracle_matrix(small_batch)
    fm = extract_features(small_batch, config=XLA_CFG)
    assert fm.shape == ref.shape == (len(small_batch), 69)
    err = np.abs(fm.values - ref)
    assert np.nanmax(err) < 1e-9
    assert not fm.degenerate.any()


def test_golden_structured_and_edge_values(rng):
    """Constant channels, two-valued channels, full-range ramps."""
    imgs = np.zeros((4, 32, 32, 3), dtype=np.uint8)
    imgs[0, :, :, 0] = 7  # constant nonzero channel (zero variance)
    imgs[0, :, :, 1] = np.tile(np.arange(32, dtype=np.uint8) * 8, (32, 1))
    imgs[0, 0, 0, 2] = 255
    imgs[1] = (rng.random((32, 32, 3)) * 256).astype(np.uint8)
    imgs[2, :, :, :] = 255
    imgs[3, :16] = 3
    imgs[3, 16:] = 250

    ref = []
    for im in imgs:
        # oracle raises only for all-zero channels; none here
        ref.append(oracle.feature_vector(im / 255.0))
    ref = np.stack(ref)

    fm = extract_features(imgs, config=XLA_CFG)
    err = np.abs(fm.values - ref)

    # Documented divergence (finalize.py): for an *exactly constant* channel,
    # scipy's skew/kurtosis return float-rounding dust (-1.0/-2.0) from its
    # _demean cancellation path; this framework returns NaN. Exclude those
    # two columns for constant channels from the golden comparison.
    constant = imgs.reshape(len(imgs), -1, imgs.shape[-1]).std(axis=1) == 0  # (B, C)
    excluded = np.zeros_like(err, dtype=bool)
    for c in range(imgs.shape[-1]):
        for fname in ("kurtosis_intensity", "skew_intensity"):
            col = fm.names.index(f"{fname}_Ch{c + 1}")
            excluded[constant[:, c], col] = True
            assert np.isnan(fm.values[constant[:, c], col]).all()
    err = np.where(excluded, 0.0, err)
    assert np.nanmax(err) < 1e-9
    assert np.array_equal(
        np.isnan(np.where(excluded, 0.0, fm.values)),
        np.isnan(np.where(excluded, 0.0, ref)),
    )


def test_rescale_lut_matches_reference_arithmetic():
    lut = rescale_lut(256)
    for m in (1, 3, 85, 128, 200, 255):
        vals = np.arange(m + 1, dtype=np.float64)
        image = vals / 255.0
        expected = ((image / image.max()) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(lut[m, : m + 1], expected, err_msg=f"max={m}")


def test_all_zero_channel_is_flagged_and_finite():
    imgs = np.zeros((2, 16, 16, 2), dtype=np.uint8)
    imgs[:, :, :, 1] = 9
    fm = extract_features(imgs, config=XLA_CFG)
    assert fm.degenerate[:, 0].all()
    assert not fm.degenerate[:, 1].any()
    glcm_ch1 = [fm.column(f"{p}_Ch1") for p in ("contrast", "homogeneity", "energy")]
    assert np.isfinite(glcm_ch1).all()


def test_masked_features(rng):
    """Masked extraction equals cropping to the masked region for a
    rectangular mask covering full GLCM pairs."""
    img = (rng.random((1, 32, 32, 1)) * 256).astype(np.uint8)
    mask = np.zeros((1, 32, 32, 1), dtype=bool)
    mask[:, 4:28, 2:30, :] = True

    fm_masked = extract_features(img, mask=mask, config=XLA_CFG)
    fm_crop = extract_features(img[:, 4:28, 2:30, :], config=XLA_CFG)

    names = fm_masked.names
    # intensity features agree exactly with the crop
    for i, n in enumerate(names[:17]):
        assert fm_masked.values[0, i] == pytest.approx(
            fm_crop.values[0, i], abs=1e-9
        ), n
    # GLCM: masked pairs are those fully inside the mask == crop's pairs,
    # and the rescale max over the mask == crop max
    for i in range(17, 23):
        assert fm_masked.values[0, i] == pytest.approx(
            fm_crop.values[0, i], abs=1e-9
        ), names[i]


def test_feature_matrix_to_pandas(rng):
    """to_pandas mirrors the reference's df_features (ipynb:327-334):
    named 69-column DataFrame in the notebook's dict-insertion order."""
    pytest.importorskip("pandas")  # optional dep (lazy import in to_pandas)
    img = (rng.random((3, 16, 16, 3)) * 256).astype(np.uint8)
    fm = extract_features(img, config=XLA_CFG)
    df = fm.to_pandas()
    assert list(df.columns) == fm.names
    np.testing.assert_array_equal(df.to_numpy(), np.asarray(fm.values))


def test_shared_mask_broadcasts_across_channels(rng):
    """A (B, H, W) mask is shared across channels: identical to repeating
    it per channel (the documented contract — a regression guard for the
    broadcast `_prep_inputs` promises)."""
    img = (rng.random((2, 16, 16, 3)) * 256).astype(np.uint8)
    shared = rng.random((2, 16, 16)) > 0.3
    per_ch = np.repeat(shared[..., None], 3, axis=-1)

    fm_shared = extract_features(img, mask=shared, config=XLA_CFG)
    fm_per_ch = extract_features(img, mask=per_ch, config=XLA_CFG)
    np.testing.assert_array_equal(fm_shared.values, fm_per_ch.values)


def test_mask_shape_mismatch_named_error(rng):
    """A wrong-shaped mask raises a named error at the entry point, not an
    opaque reshape failure downstream (r5-close probe finding)."""
    img = (rng.random((2, 16, 16, 3)) * 256).astype(np.uint8)
    with pytest.raises(ValueError, match="mask shape .* must equal"):
        extract_features(img, mask=np.ones((2, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="mask shape .* must equal"):
        extract_features(img, mask=np.ones((2, 16, 16, 2), np.uint8))


def test_empty_mask_flagged():
    img = np.full((1, 8, 8, 1), 50, dtype=np.uint8)
    mask = np.zeros((1, 8, 8, 1), dtype=bool)
    fm = extract_features(img, mask=mask, config=XLA_CFG)
    assert fm.degenerate.all()
    assert np.isfinite(np.asarray(fm.values, dtype=np.float64)).all()


def test_glcm_offset_configs(rng):
    """Non-default distance/angle must match the oracle too."""
    img = (rng.random((2, 24, 24, 1)) * 256).astype(np.uint8)
    img[:, 0, 0, 0] = 255
    for distance, angle in [(1, 0.0), (3, np.pi / 2), (2, np.pi / 4)]:
        cfg = FeatureConfig(
            glcm=GLCMConfig(distance=distance, angle=angle),
            precision="exact",
        )
        fm = extract_features(img, config=cfg)
        for b in range(2):
            feats = oracle.glcm_features(img[b] / 255.0, distance=distance, angle=angle)
            got = fm.values[b, 17:]
            want = np.array([feats[f"{p}_Ch1"] for p in oracle.GLCM_FEATURES])
            np.testing.assert_allclose(got, want, atol=1e-9)


def test_glcm_matrix_matches_oracle(rng):
    img = (rng.random((2, 16, 16, 2)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    mats = np.asarray(glcm_matrix(img, levels=256, offset=(0, 5)))
    for b in range(2):
        for c in range(2):
            plane = img[b, :, :, c] / 255.0
            scaled = ((plane / plane.max()) * 255.0).astype(np.uint8)
            ref = oracle.graycomatrix(scaled, [5], [0.0], levels=256)[:, :, 0, 0]
            np.testing.assert_array_equal(mats[b, c], ref)


def test_glcm_matrix_symmetric_normed(rng):
    """skimage graycomatrix API parity for the symmetric/normed options."""
    img = (rng.random((1, 12, 12, 1)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    plane = img[0, :, :, 0] / 255.0
    scaled = ((plane / plane.max()) * 255.0).astype(np.uint8)
    for symmetric in (False, True):
        for normed in (False, True):
            got = np.asarray(
                glcm_matrix(
                    img, levels=256, offset=(0, 3),
                    symmetric=symmetric, normed=normed,
                )
            )[0, 0]
            want = oracle.graycomatrix(
                scaled, [3], [0.0], levels=256,
                symmetric=symmetric, normed=normed,
            )[:, :, 0, 0]
            np.testing.assert_allclose(got, want, atol=1e-7)


def test_intensity_only_and_glcm_only(small_batch):
    fi = extract_features(
        small_batch, config=FeatureConfig(include_glcm=False, precision="exact")
    )
    fg = extract_features(
        small_batch, config=FeatureConfig(include_intensity=False, precision="exact")
    )
    assert fi.shape[1] == 51 and fg.shape[1] == 18
    full = extract_features(small_batch, config=XLA_CFG)
    np.testing.assert_allclose(fi.values, full.values[:, :51], atol=1e-12)
    np.testing.assert_allclose(fg.values, full.values[:, 51:], atol=1e-12)


def test_device_precision_mode(small_batch):
    """float32 device finalisation stays within ~1e-3 relative of exact."""
    exact = extract_features(small_batch, config=XLA_CFG)
    dev = extract_features(
        small_batch,
        config=FeatureConfig(precision="device"),
    )
    a = np.asarray(dev.values, dtype=np.float64)
    b = exact.values
    rel = np.abs(a - b) / (1.0 + np.abs(b))
    assert np.nanmax(rel) < 1e-3
    assert np.array_equal(np.isnan(a), np.isnan(b))


def test_sufficient_stats_shapes(small_batch):
    stats = sufficient_stats(small_batch[:2])
    B, C, L = 2, 3, 256
    assert stats.hist.shape == (B, C, L)
    assert stats.diff_hist.shape == (B, C, 2 * L - 1)
    assert stats.marg_l.shape == (B, C, L)
    assert stats.glcm_sumsq.shape == (B, C, 4)  # exact int32 limbs
    # histogram counts the pixels
    np.testing.assert_allclose(np.asarray(stats.count), 64 * 64)
    np.testing.assert_allclose(np.asarray(stats.hist).sum(-1), 64 * 64)
    np.testing.assert_allclose(np.asarray(stats.pair_count), 64 * 59)


def test_glcm_properties_public_api(rng):
    """features.props.glcm_properties matches the oracle's graycoprops."""
    from tpumcia.features.props import glcm_properties

    img = (rng.random((1, 16, 16, 2)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    mats = np.asarray(glcm_matrix(img, levels=256, offset=(0, 3)))
    props = {k: np.asarray(v) for k, v in glcm_properties(mats).items()}
    for b in range(1):
        for c in range(2):
            raw = mats[b, c].astype(np.uint32)[:, :, None, None]
            for prop in oracle.GLCM_FEATURES:
                want = oracle.graycoprops(raw, prop)[0, 0]
                assert props[prop][b, c] == pytest.approx(want, rel=2e-5), prop


def test_batched_extraction_matches_single(small_batch, rng):
    """extract_features_batched (pipelined fast path) must match per-call
    extraction — exactly on the integer-exact wire fields, to the hybrid
    f32 tolerance on the f32-summed ones (the fused per-batch dispatch
    compiles with a different fusion layout) — including partial final
    batches, masks, and the sequential fallback for unsupported configs."""
    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import extract_features_batched

    imgs = np.concatenate([small_batch, small_batch[:3]])  # 3-image tail
    ref = extract_features(imgs)
    got = extract_features_batched(imgs, batch_size=4)
    assert got.names == ref.names
    np.testing.assert_allclose(
        np.asarray(got.values), np.asarray(ref.values), rtol=1e-5, atol=1e-5,
        equal_nan=True,
    )
    np.testing.assert_array_equal(got.degenerate, ref.degenerate)

    mask = rng.random(imgs.shape) > 0.3
    ref_m = extract_features(imgs, mask=mask)
    got_m = extract_features_batched(imgs, mask=mask, batch_size=4)
    np.testing.assert_allclose(
        np.asarray(got_m.values), np.asarray(ref_m.values), rtol=1e-5,
        atol=1e-5, equal_nan=True,
    )

    # multi-offset -> sequential fallback, still identical
    cfg = FeatureConfig(glcm=GLCMConfig(distance=(5, 2)))
    ref2 = extract_features(imgs, config=cfg)
    got2 = extract_features_batched(imgs, batch_size=4, config=cfg)
    np.testing.assert_allclose(
        np.asarray(got2.values), np.asarray(ref2.values), atol=1e-9,
        equal_nan=True,
    )


def test_glcm_matrix_list_api_matches_oracle(rng):
    """skimage list API (the reference call form, ipynb:298): a 2x2
    distance/angle grid returns (B, C, L, L, D, A) with each plane equal to
    the oracle's graycomatrix."""
    import math

    img = (rng.random((2, 16, 16, 2)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    distances, angles = [1, 5], [0.0, math.pi / 2]
    mats = np.asarray(
        glcm_matrix(img, levels=256, distances=distances, angles=angles)
    )
    assert mats.shape == (2, 2, 256, 256, 2, 2)
    for b in range(2):
        for c in range(2):
            plane = img[b, :, :, c] / 255.0
            scaled = ((plane / plane.max()) * 255.0).astype(np.uint8)
            ref = oracle.graycomatrix(scaled, distances, angles, levels=256)
            np.testing.assert_array_equal(
                mats[b, c], ref, err_msg=f"b={b} c={c}"
            )


def test_glcm_matrix_list_api_degenerate_offset(rng):
    """A (distance, angle) pair whose offset exceeds the image yields a zero
    matrix (skimage semantics), not an error."""
    img = (rng.random((1, 8, 8, 1)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    mats = np.asarray(
        glcm_matrix(img, levels=256, distances=[3, 64], angles=[0.0])
    )
    assert mats[0, 0, :, :, 1, 0].sum() == 0
    assert mats[0, 0, :, :, 0, 0].sum() > 0


def test_graycoprops_list_api(rng):
    """props.graycoprops over (B, C, L, L, D, A) matrices matches the
    oracle's skimage-shaped graycoprops for every property."""
    import math

    from tpumcia.features.props import graycoprops

    img = (rng.random((1, 16, 16, 1)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    distances, angles = [2, 5], [0.0, math.pi / 2]
    mats = glcm_matrix(img, levels=256, distances=distances, angles=angles)
    plane = img[0, :, :, 0] / 255.0
    scaled = ((plane / plane.max()) * 255.0).astype(np.uint8)
    ref_g = oracle.graycomatrix(scaled, distances, angles, levels=256)
    for prop in ("contrast", "dissimilarity", "homogeneity", "ASM",
                 "energy", "correlation"):
        got = np.asarray(graycoprops(mats, prop))[0, 0]  # (D, A)
        want = oracle.graycoprops(ref_g, prop)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=prop)


def test_extract_rejects_wide_dtypes_that_overflow_levels():
    """Raw uint16 (the h5 contract dtype) into a <=256-level extraction is
    always a contract violation — every pixel >= levels silently falls out
    of the rescale LUT's one-hot and features come back NaN/garbage — so it
    raises with a pointer to quantize_to_levels. uint16 stays legal when
    the level count actually covers it."""
    import pytest

    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import (
        extract_features,
        extract_features_batched,
    )

    rng = np.random.default_rng(0)
    imgs16 = rng.integers(0, 65536, (3, 12, 12, 2)).astype(np.uint16)
    for fn in (extract_features, extract_features_batched):
        with pytest.raises(TypeError, match="quantize_to_levels"):
            fn(imgs16, config=FeatureConfig())
    # a level count that covers the dtype keeps uint16 legal
    small16 = (imgs16 >> 8).astype(np.uint16)  # values < 256 but wide dtype
    fm = extract_features(
        small16,
        config=FeatureConfig(
            precision="exact", glcm=GLCMConfig(levels=512)
        ),
    )
    assert fm.shape[0] == 3


def test_extract_rejects_negative_levels_in_narrow_signed_dtypes():
    """int8 under levels=256 has iinfo.max < levels, but NEGATIVE values
    still index the rescale LUT/one-hots out of contract — the value check
    must run for signed dtypes too (ADVICE r4). 0-d input gets the
    documented TypeError, not an IndexError from the prefix slice."""
    import pytest

    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import _as_level_array, extract_features

    rng = np.random.default_rng(0)
    neg = rng.integers(-5, 5, (2, 8, 8, 1)).astype(np.int8)
    with pytest.raises(TypeError, match="quantize_to_levels"):
        extract_features(neg, config=FeatureConfig())
    # non-negative int8 stays legal (values < 256 by construction)
    ok = np.abs(neg)
    fm = extract_features(ok, config=FeatureConfig())
    assert fm.shape[0] == 2
    with pytest.raises(TypeError, match="0-d"):
        _as_level_array(np.int32(3), 256)
