"""BASELINE.json config 4: 12-channel imaging-flow-cytometry-style stacks —
16-bit h5 objects with masks, per-donor grouped splits, and channel
importance with >= 10 channels (where the reference's substring matching
breaks)."""

import numpy as np
import pytest

from tpumcia.config import (
    FeatureConfig,
    HeadConfig,
    ImportanceConfig,
    PipelineConfig,
    SplitConfig,
)
from tpumcia.io.h5 import load_objects, write_object

NUM_CH = 12
SIGNAL_CH = 4  # 0-based; "Ch5" in reference naming


@pytest.fixture(scope="module")
def cytometry_dir(tmp_path_factory):
    """60 synthetic 12-channel uint16 cell objects across 6 donors; only
    channel 5 (1-based) carries class signal."""
    rng = np.random.default_rng(77)
    root = tmp_path_factory.mktemp("cyto")
    yy, xx = np.mgrid[:48, :48]
    for i in range(60):
        label = ["activated", "resting"][i % 2]
        donor = f"D{i % 6}"
        img = rng.integers(200, 1200, size=(48, 48, NUM_CH)).astype(np.uint16)
        cy, cx = rng.uniform(18, 30, 2)
        r = np.hypot(yy - cy, xx - cx)
        cell = r < rng.uniform(10, 16)
        if label == "activated":
            sig = (np.exp(-r / 8.0) * 40000).astype(np.uint16)
        else:
            sig = (cell * 6000).astype(np.uint16)
        img[:, :, SIGNAL_CH] = np.clip(
            img[:, :, SIGNAL_CH].astype(np.int64) + sig, 0, 65535
        ).astype(np.uint16)
        mask = np.repeat(cell[:, :, None], NUM_CH, axis=2).astype(np.uint8)
        write_object(
            root / f"{i:05d}.h5",
            img,
            mask=mask,
            label=label,
            donor=donor,
            experiment="exp0",
            channels=[f"Ch{c + 1}" for c in range(NUM_CH)],
        )
    return root


@pytest.mark.slow
def test_twelve_channel_pipeline_with_donor_split(cytometry_dir):
    from tpumcia.api import analyze_objects

    objs = load_objects(cytometry_dir)
    assert objs.images.shape == (60, 48, 48, NUM_CH)
    assert objs.images.dtype == np.uint16
    assert len(set(objs.donors)) == 6

    cfg = PipelineConfig(
        features=FeatureConfig(),
        head=HeadConfig(kind="logistic", num_steps=300),
        importance=ImportanceConfig(n_repeats=4),
        split=SplitConfig(test_size=0.3, group_by="donor"),
    )
    res = analyze_objects(objs, config=cfg)

    # donors must not straddle the split
    train_donors = set(objs.donors[res.train_idx])
    test_donors = set(objs.donors[res.test_idx])
    assert not train_donors & test_donors

    assert res.features.shape == (60, 23 * NUM_CH)
    assert res.test_accuracy > 0.7
    assert res.channel_result.top_channel() == SIGNAL_CH


def test_twelve_channel_exact_grouping_vs_substring(cytometry_dir):
    """With 12 channels the reference's substring match pollutes Ch1 with
    Ch10-12 columns; exact-index grouping does not."""
    from tpumcia.importance.channels import aggregate_channel_importance

    names = [
        f"{f}_Ch{c + 1}"
        for c in range(NUM_CH)
        for f in ("mean_intensity", "contrast")
    ]
    imp = np.ones(len(names)) * 0.1
    exact = aggregate_channel_importance(imp, names, NUM_CH, threshold=0.0)
    sub = aggregate_channel_importance(
        imp, names, NUM_CH, threshold=0.0, match="substring"
    )
    assert all(len(v) == 2 for v in exact.per_channel)
    assert len(sub.per_channel[0]) == 8  # Ch1 also matches Ch10, Ch11, Ch12
    assert len(sub.per_channel[1]) == 2  # Ch2 is unaffected below 20 channels


def test_load_objects_with_2d_masks(tmp_path):
    """The contract's plain (h, w) masks (no channel dim) must load and
    drive a masked analysis — both the uint8 packer path and the bool
    fallback path were rank-3-only (found live via the verify runbook)."""
    from tpumcia.api import analyze_objects

    rng = np.random.default_rng(3)
    for i in range(24):
        label = ["a", "b"][i % 2]
        img = rng.integers(0, 800, size=(20, 24, 3)).astype(np.uint16)
        if label == "a":
            img[..., 0] += rng.integers(3000, 9000, (20, 24)).astype(np.uint16)
        mask = np.zeros((20, 24), np.uint8 if i % 2 else bool)
        mask[2:18, 3:21] = 1
        write_object(tmp_path / f"{i:03d}.h5", img, mask=mask, label=label)

    objs = load_objects(tmp_path)
    assert objs.masks.shape == (24, 20, 24)
    res = analyze_objects(
        objs,
        config=PipelineConfig(
            features=FeatureConfig(),
            head=HeadConfig(kind="logistic", num_steps=150),
            importance=ImportanceConfig(n_repeats=2),
            split=SplitConfig(test_size=0.25, seed=0),
        ),
    )
    assert res.channel_result.top_channel() == 0


def test_analyze_objects_accepts_dict_config(tmp_path):
    """Entry points coerce a plain dict through PipelineConfig.from_dict
    (unknown keys still rejected); non-config types raise TypeError."""
    from tpumcia.api import analyze_objects
    from tpumcia.config import coerce_config

    rng = np.random.default_rng(5)
    for i in range(16):
        img = rng.integers(0, 60, size=(16, 16, 2)).astype(np.uint8)
        if i % 2:
            img[..., 1] += 180  # class "y": bright second channel
        write_object(tmp_path / f"{i:03d}.h5", img, label=["x", "y"][i % 2])

    objs = load_objects(tmp_path)
    res = analyze_objects(
        objs,
        config={
            "head": {"kind": "logistic", "num_steps": 100},
            "importance": {"n_repeats": 2},
        },
    )
    assert res.test_accuracy >= 0.75

    with pytest.raises(TypeError):
        coerce_config(42)
    with pytest.raises((KeyError, TypeError, ValueError)):
        coerce_config({"no_such_section": {}})
