"""Multi-offset GLCM (skimage's distances=[..], angles=[..] list API)."""

import numpy as np
import pytest

from tpumcia.config import FeatureConfig, GLCMConfig
from tpumcia.features.extract import extract_features
from tpumcia.reference_impl import oracle


def test_multi_offset_names_and_values(rng):
    img = (rng.random((2, 24, 24, 2)) * 256).astype(np.uint8)
    img[:, 0, 0, :] = 255
    cfg = FeatureConfig(
        glcm=GLCMConfig(distance=(1, 5), angle=(0.0, np.pi / 2)),
        precision="exact",
    )
    fm = extract_features(img, config=cfg)
    # 2 channels x (17 intensity + 6 glcm x 4 offsets)
    assert fm.shape == (2, 2 * 17 + 2 * 6 * 4)
    assert "contrast_d1a0_Ch1" in fm.names
    assert "correlation_d5a90_Ch2" in fm.names

    # each offset block matches the single-offset oracle
    for d, a in [(1, 0.0), (1, np.pi / 2), (5, 0.0), (5, np.pi / 2)]:
        deg = int(round(np.degrees(a)))
        for b in range(2):
            feats = oracle.glcm_features(img[b] / 255.0, distance=d, angle=a)
            for prop in oracle.GLCM_FEATURES:
                got = fm.column(f"{prop}_d{d}a{deg}_Ch1")[b]
                assert got == pytest.approx(feats[f"{prop}_Ch1"], abs=1e-9)


def test_multi_offset_channel_grouping(rng):
    img = (rng.random((1, 16, 16, 3)) * 250 + 5).astype(np.uint8)
    cfg = FeatureConfig(
        glcm=GLCMConfig(distance=(1, 2)), precision="exact"
    )
    fm = extract_features(img, config=cfg)
    groups = fm.channel_columns()
    assert [len(g) for g in groups] == [17 + 12] * 3
    # groups partition all columns
    flat = sorted(i for g in groups for i in g)
    assert flat == list(range(fm.shape[1]))
    # name-parsed grouping agrees with the positional layout
    for c, g in enumerate(groups):
        for i in g:
            assert fm.names[i].endswith(f"_Ch{c + 1}")


def test_single_offset_keeps_reference_names(small_batch):
    fm = extract_features(
        small_batch,
        config=FeatureConfig(precision="exact"),
    )
    assert "contrast_Ch1" in fm.names  # no offset tag for the legacy config
    assert fm.shape[1] == 69


def test_custom_channel_names_group_positionally(rng):
    img = (rng.random((1, 16, 16, 2)) * 250 + 5).astype(np.uint8)
    fm = extract_features(
        img,
        config=FeatureConfig(precision="exact"),
        channel_names=["BF", "GFP"],
    )
    assert fm.names[0] == "min_intensity_BF"
    groups = fm.channel_columns()
    assert [len(g) for g in groups] == [23, 23]
    assert all(fm.names[i].endswith("_GFP") for i in groups[1])


def test_morphology_features_known_shapes():
    from tpumcia.features.morphology import morphology_features

    mask = np.zeros((2, 40, 40, 2), bool)
    # rectangle 10x20 at rows 5..14, cols 10..29 in (0, ch0)
    mask[0, 5:15, 10:30, 0] = True
    # centered disk radius 8 in (1, ch1)
    yy, xx = np.mgrid[:40, :40]
    mask[1, :, :, 1] = np.hypot(yy - 20, xx - 20) <= 8

    f = np.asarray(morphology_features(mask))  # (2, 2, 8)
    area, cr, cc, major, minor, ecc, orient, extent = f[0, 0]
    assert area == 200
    assert cr == pytest.approx(9.5) and cc == pytest.approx(19.5)
    assert extent == pytest.approx(1.0)
    assert major > minor > 0
    # rectangle aligned with columns: orientation ~ +-pi/2
    assert abs(abs(orient) - np.pi / 2) < 1e-3

    darea, dcr, dcc, dmaj, dmin, decc, _, dext = f[1, 1]
    assert dcr == pytest.approx(20, abs=0.1) and dcc == pytest.approx(20, abs=0.1)
    assert decc < 0.1  # disk: near-zero eccentricity
    assert 0.6 < dext < 0.9  # ~pi/4 bbox fill (discrete disk runs lower)

    # empty channels -> zeros
    assert np.all(f[0, 1] == 0) and np.all(f[1, 0] == 0)


def test_extract_with_morphology(rng):
    from tpumcia.config import FeatureConfig

    img = (rng.random((3, 24, 24, 2)) * 250 + 5).astype(np.uint8)
    mask = np.zeros((3, 24, 24, 2), bool)
    mask[:, 4:20, 6:18, :] = True
    cfg = FeatureConfig(include_morphology=True, precision="exact")
    fm = extract_features(img, mask=mask, config=cfg)
    assert fm.shape == (3, 2 * (17 + 6 + 8))
    assert "area_Ch1" in fm.names and "eccentricity_Ch2" in fm.names
    assert fm.column("area_Ch1")[0] == 16 * 12
    groups = fm.channel_columns()
    assert [len(g) for g in groups] == [31, 31]
    flat = sorted(i for g in groups for i in g)
    assert flat == list(range(fm.shape[1]))

    with pytest.raises(ValueError, match="mask"):
        extract_features(img, config=cfg)


def test_multi_offset_hybrid_wire_one_fetch_matches_split(rng, monkeypatch):
    """The multi-offset hybrid path must ship ALL offsets in ONE wire fetch
    (VERDICT r4 #3) and produce bit-identical values to the per-offset
    split finalize it replaces; values also golden-match the exact backend
    within the hybrid contract (<1e-5 max)."""
    import tpumcia.features.extract as ex
    import tpumcia.features.hybrid as hybrid

    img = (rng.random((3, 20, 20, 2)) * 256).astype(np.uint8)
    mask = (rng.random((3, 20, 20)) > 0.2).astype(np.uint8)
    glcm = GLCMConfig(distance=(1, 5), angle=(0.0, np.pi / 2))
    cfg_h = FeatureConfig(glcm=glcm, precision="hybrid")
    cfg_e = FeatureConfig(glcm=glcm, precision="exact")

    fetches = []
    real_fetch = hybrid._fetch_concurrent
    monkeypatch.setattr(
        hybrid, "_fetch_concurrent",
        lambda arr, **k: (fetches.append(arr.shape), real_fetch(arr, **k))[1],
    )
    for m in (None, mask):
        fetches.clear()
        fm_wire = extract_features(img, mask=m, config=cfg_h)
        assert len(fetches) == 1, fetches  # one fetch for 4 offsets
        assert fetches[0][-1] == 12 + 9 * 4  # multi-wire word count

        # split path (per-offset finalize_hybrid): force the old route
        real_ok = ex.hybrid_wire_ok
        monkeypatch.setattr(
            ex, "hybrid_wire_ok",
            lambda cfg, shape=None, *, multi_offset=False: (
                False if multi_offset else real_ok(cfg, shape)
            ),
        )
        fm_split = extract_features(img, mask=m, config=cfg_h)
        monkeypatch.setattr(ex, "hybrid_wire_ok", real_ok)
        assert fm_wire.names == fm_split.names
        np.testing.assert_array_equal(
            np.asarray(fm_wire.values), np.asarray(fm_split.values)
        )
        np.testing.assert_array_equal(
            np.asarray(fm_wire.degenerate), np.asarray(fm_split.degenerate)
        )

        fm_exact = extract_features(img, mask=m, config=cfg_e)
        ve = np.asarray(fm_exact.values)
        vw = np.asarray(fm_wire.values)
        nan_ok = np.isnan(ve) == np.isnan(vw)
        assert nan_ok.all()
        d = np.nan_to_num(ve) - np.nan_to_num(vw)
        assert np.abs(d).max() < 1e-5
