"""Determinism guarantees (fixing the reference's unseeded nondeterminism)
and config round-trips."""

import jax
import numpy as np
import pytest

from tpumcia.config import (
    FeatureConfig,
    GLCMConfig,
    HeadConfig,
    PipelineConfig,
)


def test_synth_deterministic():
    from tpumcia.preprocess.synth import add_noise_channels

    gray = (np.arange(2 * 16 * 16) % 256).reshape(2, 16, 16).astype(np.uint8)
    a = np.asarray(add_noise_channels(gray, jax.random.key(3)))
    b = np.asarray(add_noise_channels(gray, jax.random.key(3)))
    c = np.asarray(add_noise_channels(gray, jax.random.key(4)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a[..., 0], gray)  # signal channel untouched


def test_reference_roundtrip_is_exact_in_f64():
    """The reference's /255. -> *255. -> uint8 float64 round trip is exact for
    every uint8 value — what justifies the identity copy in synth.py."""
    v = np.arange(256, dtype=np.float64)
    out = ((v / 255.0) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(out, np.arange(256, dtype=np.uint8))


def test_feature_extraction_deterministic(small_batch):
    from tpumcia.features.extract import extract_features

    cfg = FeatureConfig()
    a = extract_features(small_batch, config=cfg)
    b = extract_features(small_batch, config=cfg)
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))


@pytest.mark.slow
def test_pipeline_deterministic():
    from tpumcia.config import ImportanceConfig
    from tpumcia.io.synthetic import synthetic_multichannel
    from tpumcia.pipeline.run import run_pipeline

    images, labels, _ = synthetic_multichannel(8, num_classes=3, seed=1)
    cfg = PipelineConfig(
        features=FeatureConfig(),
        head=HeadConfig(kind="logistic", num_steps=100),
        importance=ImportanceConfig(n_repeats=3),
    )
    r1 = run_pipeline(images, labels, config=cfg)
    r2 = run_pipeline(images, labels, config=cfg)
    assert r1.test_accuracy == r2.test_accuracy
    np.testing.assert_array_equal(
        r1.channel_result.ranking, r2.channel_result.ranking
    )
    np.testing.assert_array_equal(r1.test_idx, r2.test_idx)


def test_config_json_roundtrip(tmp_path):
    cfg = PipelineConfig(
        features=FeatureConfig(
            glcm=GLCMConfig(distance=3, angle=np.pi / 2), chunk_size=16
        ),
        head=HeadConfig(kind="random_forest", n_estimators=42),
    )
    path = tmp_path / "config.json"
    cfg.to_json(path)
    loaded = PipelineConfig.from_json(path)
    assert loaded.features.glcm.distance == 3
    assert loaded.features.glcm.offset == cfg.features.glcm.offset
    assert loaded.head.n_estimators == 42
    assert loaded == cfg


def test_config_rejects_unknown_keys():
    import pytest

    with pytest.raises(ValueError, match="unknown config key"):
        PipelineConfig.from_dict({"nonexistent_field": 3})
    with pytest.raises(ValueError, match="config.features"):
        PipelineConfig.from_dict({"features": {"precison": "hybrid"}})


def test_config_defaults_mirror_notebook():
    """The defaults are the notebook's literals (SURVEY.md §5)."""
    cfg = PipelineConfig()
    assert cfg.features.glcm.distance == 5
    assert cfg.features.glcm.angle == 0.0
    assert cfg.features.glcm.levels == 256
    assert cfg.features.glcm.offset == (0, 5)
    assert cfg.split.test_size == 0.25
    assert cfg.importance.n_repeats == 10
    assert cfg.importance.seed == 42
    assert cfg.importance.mdi_threshold == 0.01
    assert cfg.head.n_estimators == 100


def test_reports_render(tmp_path, small_batch):
    """The three reference figures render without error."""
    import matplotlib

    matplotlib.use("Agg")
    from tpumcia.importance.channels import aggregate_channel_importance
    from tpumcia.importance.permutation import PermutationResult
    from tpumcia.reports.plots import (
        plot_channel_importance,
        plot_permutation_importance,
        plot_sample_grid,
        plot_top_features,
    )

    rng = np.random.default_rng(0)
    names = [f"f{i}_Ch{(i % 3) + 1}" for i in range(30)]
    imp = rng.random(30)
    fig1 = plot_top_features(imp, names, top_k=10)
    fig1.savefig(tmp_path / "top.png")
    # compat mode drops the top-1 feature (reference quirk, ipynb:436)
    fig1b = plot_top_features(imp, names, top_k=10, compat_drop_top=True)

    agg = aggregate_channel_importance(imp, names, 3, threshold=0.0)
    fig2 = plot_channel_importance(agg)
    fig2.savefig(tmp_path / "channels.png")

    perm = PermutationResult(
        importances=rng.random((30, 5)),
        importances_mean=rng.random(30),
        importances_std=rng.random(30),
        baseline_score=0.9,
    )
    fig3 = plot_permutation_importance(perm, names, top_k=10)
    fig3.savefig(tmp_path / "perm.png")

    fig4 = plot_sample_grid(small_batch, labels=np.zeros(len(small_batch), int))
    fig4.savefig(tmp_path / "grid.png")

    from tpumcia.reports.plots import plot_occlusion_maps

    occ = rng.random((4, 8, 8))
    fig5 = plot_occlusion_maps(np.asarray(small_batch)[:4], occ, n=4)
    fig5.savefig(tmp_path / "occ.png")
    assert (tmp_path / "top.png").exists()
    assert (tmp_path / "occ.png").exists()
