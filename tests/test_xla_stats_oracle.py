"""The XLA statistics path against the numpy oracle and against itself.

The cases are the inputs the removed fused-kernel parity tests used
(unmasked and masked batches, degenerate channels, a non-default offset,
multi-offset passes, 512 levels); here they pin the XLA path that every
device now runs, against the float64 reference formulas.
"""

import numpy as np
import pytest

from tpumcia.config import FeatureConfig, GLCMConfig
from tpumcia.features.extract import extract_features
from tpumcia.features.stats import sufficient_stats, sufficient_stats_multi
from tpumcia.reference_impl import oracle

OFFSETS = ((0, 5), (5, 0), (1, 1), (0, 1))
F32_FIELDS = (
    "std_intensity", "kurtosis_intensity", "skew_intensity",
    "shannon_entropy", "homogeneity",
)


def _oracle(imgs, distance=5, angle=0.0):
    return np.stack(
        [oracle.feature_vector(im / 255.0, distance, angle) for im in imgs]
    )


def _assert_hybrid_close(got, ref):
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert np.nanmax(err) < 1e-5
    assert np.nanmean(err) < 1e-6
    assert np.array_equal(np.isnan(got), np.isnan(ref))


def _assert_stats_equal(a, b):
    for name in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name), np.float64),
            np.asarray(getattr(b, name), np.float64),
            err_msg=name,
        )


def case_unmasked(small_batch, rng):
    fm = extract_features(small_batch[:2])
    _assert_hybrid_close(fm.values, _oracle(small_batch[:2]))


def case_masked(small_batch, rng):
    # a box mask selects exactly the crop's pixels and GLCM pairs, so the
    # oracle on the crop is the masked reference
    img = (rng.random((2, 32, 32, 2)) * 256).astype(np.uint8)
    mask = np.zeros(img.shape, bool)
    mask[:, 3:29, 2:27, :] = True
    fm = extract_features(img, mask)
    _assert_hybrid_close(fm.values, _oracle(img[:, 3:29, 2:27]))


def case_degenerate_channels(small_batch, rng):
    img = np.zeros((1, 16, 16, 2), dtype=np.uint8)
    img[:, :, :, 1] = 4
    img[:, ::3, ::2, 1] = 9
    fm = extract_features(img)
    assert fm.degenerate[0].tolist() == [True, False]
    ch1 = [i for i, n in enumerate(fm.names) if n.endswith("_Ch1")]
    assert np.isfinite(fm.values[0, ch1[17:]]).all()  # GLCM block defined
    # the oracle raises on the all-zero channel (0/0 rescale): compare the
    # other channel against a one-channel oracle run
    ref = oracle.feature_vector(img[0, :, :, 1:] / 255.0)
    ch2 = [i for i, n in enumerate(fm.names) if n.endswith("_Ch2")]
    _assert_hybrid_close(fm.values[:, ch2], ref[None])


def case_nondefault_offset(small_batch, rng):
    img = (rng.random((2, 24, 24, 1)) * 256).astype(np.uint8)
    for distance, angle in ((1, 0.0), (3, np.pi / 2), (2.83, np.pi / 4)):
        cfg = FeatureConfig(glcm=GLCMConfig(distance=distance, angle=angle))
        fm = extract_features(img, config=cfg)
        _assert_hybrid_close(fm.values, _oracle(img, distance, angle))


def case_multi_offset_equals_single(small_batch, rng):
    got = sufficient_stats_multi(small_batch[:2], offsets=OFFSETS[:2])
    assert len(got) == 2
    for i, (offset, st) in enumerate(zip(OFFSETS, got)):
        ref = sufficient_stats(small_batch[:2], offset=offset,
                               with_intensity=i == 0)
        _assert_stats_equal(ref, st)


def case_multi_offset_masked(small_batch, rng):
    img = (rng.random((2, 32, 32, 2)) * 256).astype(np.uint8)
    mask = rng.random((2, 32, 32, 2)) > 0.3
    got = sufficient_stats_multi(img, mask, offsets=OFFSETS)
    for i, (offset, st) in enumerate(zip(OFFSETS, got)):
        ref = sufficient_stats(img, mask, offset=offset,
                               with_intensity=i == 0)
        _assert_stats_equal(ref, st)


def case_levels_512(small_batch, rng):
    # the oracle is the 256-level reference; at 512 levels the float64 host
    # finalisation of the same integer statistics is the reference
    img = (rng.random((2, 40, 40, 2)) * 512).astype(np.uint16)
    glcm = GLCMConfig(levels=512)
    got = extract_features(img, config=FeatureConfig(glcm=glcm))
    ref = extract_features(
        img, config=FeatureConfig(glcm=glcm, precision="exact")
    )
    _assert_hybrid_close(got.values, np.asarray(ref.values))


def case_fused_dispatch_vs_classic(small_batch, rng):
    """The fused per-batch dispatch (stats -> wire, plus the device f32
    feature block) against the unfused stats -> hybrid finalize path."""
    from tpumcia.features.extract import _batch_fused_dispatch
    from tpumcia.features.finalize import finalize_features
    from tpumcia.features.hybrid import assemble_reduced, unpack_wire
    from tpumcia.features.stats import rescale_lut_device

    cfg = FeatureConfig()
    wire, feats = _batch_fused_dispatch(
        small_batch, None, None, rescale_lut_device(256), levels=256,
        offset=(0, 5), keep_device=True, chunk_size=cfg.chunk_size,
        onehot_dtype=cfg.onehot_dtype,
    )
    fused = assemble_reduced(unpack_wire(np.asarray(wire))).values
    classic = finalize_features(
        sufficient_stats(small_batch), backend="hybrid"
    ).values
    # integer-derived columns are bit-identical; the float32-summed ones
    # (moments, entropy, homogeneity) are reduced in another order
    names = extract_features(small_batch[:1]).names
    f32 = np.array([n.startswith(F32_FIELDS) for n in names])
    np.testing.assert_array_equal(fused[:, ~f32], classic[:, ~f32])
    np.testing.assert_allclose(fused[:, f32], classic[:, f32], rtol=1e-5)
    ref = _oracle(small_batch)
    np.testing.assert_allclose(
        np.asarray(feats), np.nan_to_num(ref), rtol=1e-4, atol=1e-5
    )


CASES = {
    f.__name__[len("case_"):]: f
    for f in (
        case_unmasked, case_masked, case_degenerate_channels,
        case_nondefault_offset, case_multi_offset_equals_single,
        case_multi_offset_masked, case_levels_512,
        case_fused_dispatch_vs_classic,
    )
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_statistics(case, small_batch, rng):
    CASES[case](small_batch, rng)
