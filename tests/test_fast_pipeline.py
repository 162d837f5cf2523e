"""The fused fast path (device-resident features + one-dispatch head/sweeps)
must agree with the classic pipeline — the round-2 verdict's "the public API
is the fast path" requirement."""

import numpy as np
import pytest

from tpumcia.config import (
    FeatureConfig,
    HeadConfig,
    ImportanceConfig,
    MeshConfig,
    PipelineConfig,
    SplitConfig,
    SynthConfig,
)

# the suite runs on an 8-device CPU mesh; the fused fast path is
# single-device by design, so every fast-path config pins mesh data=1
# (without this the default data=-1 resolves a mesh and the classic SPMD
# path runs instead — the tests would compare classic vs classic)
_ONE_DEV = MeshConfig(data=1, model=1)


@pytest.fixture(scope="module")
def workload():
    from tpumcia.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(30, num_classes=6, seed=3)
    return gray, labels


def _cfg(fast, **kw):
    return PipelineConfig(
        synth=SynthConfig(noise_channels=2, seed=0),
        head=HeadConfig(kind="logistic", num_steps=60),
        split=SplitConfig(test_size=0.25, seed=0, stratify=True),
        fast_path=fast,
        batch_size=64,
        mesh=_ONE_DEV,
        **kw,
    )


def test_fast_path_actually_taken(workload):
    """Guard against the vacuous-test failure mode: the fused path must
    really be selected under this suite's environment."""
    from tpumcia.parallel.mesh import mesh_from_config
    from tpumcia.pipeline.run import _fast_path_ok

    gray, labels = workload
    cfg = _cfg("always")
    assert mesh_from_config(cfg.mesh) is None
    assert _fast_path_ok(cfg, gray, None, None)


def test_fast_path_always_with_mesh_raises(workload):
    from tpumcia.pipeline.run import run_pipeline

    gray, labels = workload
    cfg = PipelineConfig(
        synth=SynthConfig(noise_channels=2, seed=0),
        fast_path="always",
        mesh=MeshConfig(data=-1, model=1),
    )
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    with pytest.raises(ValueError, match="single-device"):
        run_pipeline(gray, labels, config=cfg)


def test_fast_path_matches_classic(workload):
    from tpumcia.pipeline.run import run_pipeline

    gray, labels = workload
    fast = run_pipeline(gray, labels, config=_cfg("always"))
    classic = run_pipeline(gray, labels, config=_cfg("never"))

    # feature values are exact on both paths (same hybrid wire math)
    np.testing.assert_allclose(
        np.asarray(fast.features.values),
        np.asarray(classic.features.values),
        rtol=1e-12, atol=1e-12,
    )
    assert fast.features.names == classic.features.names
    # head/sweeps ride device f32 features on the fast path vs host-f64->f32
    # on the classic one — rankings and accuracy must agree
    assert list(fast.channel_result.ranking) == list(
        classic.channel_result.ranking
    )
    assert fast.channel_result.ranking[0] == 0
    assert abs(fast.test_accuracy - classic.test_accuracy) < 0.06
    assert fast.feature_result is not None
    assert fast.channel_result.extras["permutation"].importances.shape[1] == 10


def test_fast_path_sweep_matches_unfused_on_same_head(workload):
    """The fused sweep must reproduce the standalone permutation sweep
    bit-for-bit given the same head, features, and seed (same PRNG stream)."""
    from tpumcia.importance.permutation import permutation_importance
    from tpumcia.pipeline.run import run_pipeline

    gray, labels = workload
    res = run_pipeline(gray, labels, config=_cfg("always"))
    X = np.nan_to_num(np.asarray(res.features.values, np.float32))
    y_te = np.asarray(labels)[res.test_idx]
    groups = res.features.channel_columns()
    unfused = permutation_importance(
        res.head, X[res.test_idx], y_te, n_repeats=10, seed=42, groups=groups
    )
    fused = res.channel_result.extras["permutation"]
    np.testing.assert_allclose(
        fused.importances, unfused.importances, atol=1e-6
    )


def test_keep_device_values(workload):
    import jax

    from tpumcia.features.extract import extract_features_batched
    from tpumcia.preprocess.synth import add_noise_channels

    gray, labels = workload
    imgs = np.asarray(add_noise_channels(gray[:96], jax.random.key(0)))
    fm = extract_features_batched(
        imgs, batch_size=40, keep_device_values=True
    )
    assert fm.device_values is not None
    assert isinstance(fm.device_values, jax.Array)
    assert fm.device_values.shape == fm.values.shape
    np.testing.assert_allclose(
        np.asarray(fm.device_values),
        np.nan_to_num(np.asarray(fm.values, np.float32)),
        rtol=2e-4, atol=1e-3,
    )


def test_pending_matches_direct(workload):
    import jax

    from tpumcia.features.extract import (
        extract_features,
        extract_features_pending,
    )
    from tpumcia.preprocess.synth import add_noise_channels

    gray, labels = workload
    imgs = np.asarray(add_noise_channels(gray[:50], jax.random.key(1)))
    pend = extract_features_pending(imgs, batch_size=24).result()
    direct = extract_features(imgs, config=FeatureConfig())
    # integer-exact wire fields are bit-equal; the f32-summed fields
    # (moments, entropy, homogeneity) vary ~1e-6 with batch shape/fusion
    np.testing.assert_allclose(
        np.asarray(pend.values), np.asarray(direct.values),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(pend.degenerate), np.asarray(direct.degenerate)
    )


def test_synth_classic_path(workload):
    """synth config on the classic (non-fast) path synthesizes up front."""
    from tpumcia.pipeline.run import run_pipeline

    gray, labels = workload
    res = run_pipeline(gray[:60], labels[:60], config=_cfg("never"))
    assert res.features.num_channels == 3
    assert res.channel_result.ranking[0] == 0


def test_fused_fit_importance_channel_names():
    """Custom channel names flow through the fused results."""
    import jax

    from tpumcia.models.fused import fit_logistic_with_importance

    rng = np.random.default_rng(0)
    N, F = 120, 6
    X = rng.random((N, F)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.int64)
    X[:, 0] += y  # make column 0 informative
    names = [f"f{i}_Ch{1 + i // 3}" for i in range(F)]
    res = fit_logistic_with_importance(
        jax.numpy.asarray(X), y,
        train_idx=np.arange(0, 90), test_idx=np.arange(90, N),
        groups=[[0, 1, 2], [3, 4, 5]], names=names,
        head_config=HeadConfig(kind="logistic", num_steps=80),
        importance_config=ImportanceConfig(n_repeats=4),
        channel_names=["alpha", "beta"],
    )
    assert res.channel_result.channel_names == ["alpha", "beta"]
    assert res.channel_result.top_channel() == 0
    assert res.head.score(X[90:], y[90:]) >= 0.7
    assert len(res.y_pred) == N - 90


def test_fast_path_with_mask(workload):
    """Masked inputs ride the fused fast path (no synth) and agree with the
    classic pipeline."""
    import jax

    from tpumcia.pipeline.run import run_pipeline
    from tpumcia.preprocess.synth import add_noise_channels

    gray, labels = workload
    imgs = np.asarray(add_noise_channels(gray[:120], jax.random.key(2)))
    rng = np.random.default_rng(7)
    mask = rng.random(imgs.shape) > 0.25

    def cfg(fast):
        return PipelineConfig(
            head=HeadConfig(kind="logistic", num_steps=60),
            split=SplitConfig(test_size=0.25, seed=0, stratify=True),
            fast_path=fast,
            batch_size=48,
            mesh=_ONE_DEV,
        )

    fast = run_pipeline(imgs, labels[:120], mask=mask, config=cfg("always"))
    classic = run_pipeline(imgs, labels[:120], mask=mask, config=cfg("never"))
    np.testing.assert_allclose(
        np.asarray(fast.features.values),
        np.asarray(classic.features.values),
        rtol=1e-4, atol=1e-5,
    )
    assert list(fast.channel_result.ranking) == list(
        classic.channel_result.ranking
    )
    assert fast.channel_result.ranking[0] == 0


def test_pending_rejects_non_fast_configs(workload):
    from tpumcia.features.extract import extract_features_pending

    gray, labels = workload
    with pytest.raises(ValueError, match="hybrid fast path"):
        extract_features_pending(
            np.zeros((8, 16, 16, 2), np.uint8),
            config=FeatureConfig(precision="exact"),
        )
    with pytest.raises(ValueError, match="hybrid fast path"):
        extract_features_pending(
            np.zeros((8, 256, 256, 1), np.uint8)  # >= 2^16 pixels
        )


def test_fused_unseen_test_class_scores_as_miss():
    """A test label absent from training must count as a misprediction,
    not alias onto a neighbouring class (classic-path semantics)."""
    import jax

    from tpumcia.models.fused import fit_logistic_with_importance

    rng = np.random.default_rng(0)
    N, F = 90, 4
    X = rng.random((N, F)).astype(np.float32)
    y = np.where(np.arange(N) % 2 == 0, 0, 2)
    X[:, 0] += y  # separable on classes {0, 2}
    y = y.copy()
    y[80:] = 1  # class 1 exists ONLY in the test rows
    res = fit_logistic_with_importance(
        jax.numpy.asarray(X), y,
        train_idx=np.arange(0, 80), test_idx=np.arange(80, N),
        groups=[[0, 1], [2, 3]], names=[f"f{i}_Ch{1 + i // 2}" for i in range(F)],
        head_config=HeadConfig(kind="logistic", num_steps=60),
        importance_config=ImportanceConfig(n_repeats=2),
    )
    assert res.baseline_score == 0.0  # nothing predictable as class 1
    # predictions still come from the trained classes
    assert set(res.y_pred) <= {0, 2}


def test_synth_identical_across_paths(workload):
    """The batched synth helper must reproduce the fast path's per-batch
    draws exactly (one canonical PRNG stream)."""
    import jax

    from tpumcia.preprocess.synth import (
        add_noise_channels,
        add_noise_channels_batched,
        synth_batch_keys,
    )

    gray, labels = workload
    gray = gray[:100]
    out = np.asarray(
        add_noise_channels_batched(gray, seed=0, batch_size=48)
    )
    keys = synth_batch_keys(0, 3)
    # manual per-batch draws with wrap padding, as the fused dispatch does
    manual = []
    for i, (lo, hi) in enumerate([(0, 48), (48, 96), (96, 100)]):
        b = gray[lo:hi]
        if hi - lo < 48:
            b = np.concatenate([b, gray[: 48 - (hi - lo)]])
        manual.append(np.asarray(add_noise_channels(b, keys[i]))[: hi - lo])
    np.testing.assert_array_equal(out, np.concatenate(manual))


def test_keep_device_values_requires_fast_path(workload):
    """keep_device_values=True outside the hybrid fast path must raise (the
    fallback paths have no device-resident copy; silently returning
    device_values=None would break downstream fused-head callers)."""
    import pytest

    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features_batched

    gray, _ = workload
    imgs = np.stack([gray[:8]] * 3, axis=-1)
    with pytest.raises(ValueError, match="keep_device_values"):
        extract_features_batched(
            imgs, config=FeatureConfig(precision="exact"),
            keep_device_values=True,
        )


def test_fast_path_predicates_shared():
    """extract_features' single-dispatch branch, the batched API, and the
    streaming wire mode must all consult hybrid_wire_ok — eligibility rules
    drifting apart would route configs through the u32 wire whose
    exact-integer bounds they violate."""
    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import batched_fast_path_ok, hybrid_wire_ok

    ok = FeatureConfig()
    assert hybrid_wire_ok(ok) and batched_fast_path_ok(None, ok)
    # each disqualifier flips both predicates
    for cfg in (
        FeatureConfig(precision="exact"),
        FeatureConfig(glcm=GLCMConfig(levels=512)),
        FeatureConfig(include_intensity=False),
        FeatureConfig(include_glcm=False),
        FeatureConfig(glcm=GLCMConfig(distance=(5, 10))),
    ):
        assert not hybrid_wire_ok(cfg)
        assert not batched_fast_path_ok(None, cfg)
    # the pixel bound only applies when the shape is known
    assert hybrid_wire_ok(ok, (4, 64, 64, 3))
    assert not hybrid_wire_ok(ok, (4, 256, 256, 3))
    # morphology only disqualifies the batched/streaming wire pipelines
    morph = FeatureConfig(include_morphology=True)
    assert hybrid_wire_ok(morph)
    assert not batched_fast_path_ok(None, morph)


def test_pending_in_flight_pacing(workload):
    """With in_flight smaller than the batch count the enqueue loop paces
    itself by waiting for the oldest outstanding wire. Values must be
    unaffected by the window size."""
    import jax

    from tpumcia.features.extract import extract_features_pending

    gray, _ = workload
    from tpumcia.preprocess.synth import add_noise_channels

    imgs = np.asarray(add_noise_channels(gray[:96], jax.random.key(3)))
    wide = extract_features_pending(imgs, batch_size=16, in_flight=8).result()
    paced = extract_features_pending(imgs, batch_size=16, in_flight=2).result()
    np.testing.assert_array_equal(wide.values, paced.values)
    np.testing.assert_array_equal(wide.degenerate, paced.degenerate)


def test_noise_channels_chw_bit_identical():
    """The fused dispatch's channel-major synthesis must be bit-identical
    to transpose(add_noise_channels(...)): same PRNG draw shape, same
    truncation — only the relayout strategy differs."""
    import jax
    import jax.numpy as jnp

    from tpumcia.preprocess.synth import add_noise_channels, noise_channels_chw

    rng = np.random.RandomState(0)
    gray = rng.randint(0, 256, size=(5, 17, 23), dtype=np.uint8)
    key = jax.random.key(7)
    hwc = add_noise_channels(gray, key, num_noise=3, var=0.01)
    chw = noise_channels_chw(gray, key, num_noise=3, var=0.01)
    np.testing.assert_array_equal(
        np.asarray(chw),
        np.transpose(np.asarray(hwc), (0, 3, 1, 2)).astype(np.int32),
    )


def test_feature_matrix_save_load_round_trips_config():
    """r4 regression: save/load dropped config + channel_names, so a loaded
    multi-offset matrix misgrouped channel_columns() and the importance
    sweep silently permuted only a subset of each channel's columns."""
    import tempfile
    from pathlib import Path

    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import FeatureMatrix, extract_features

    rng = np.random.RandomState(0)
    imgs = (rng.random((3, 16, 16, 2)) * 256).astype(np.uint8)
    cfg = FeatureConfig(
        glcm=GLCMConfig(distance=(3, 5), angle=0.0)
    )
    fm = extract_features(imgs, config=cfg, channel_names=["BF", "GFP"])
    p = Path(tempfile.mkdtemp()) / "fm.npz"
    fm.save(p)
    fm2 = FeatureMatrix.load(p)
    assert fm2.config == cfg
    assert fm2.channel_names == ["BF", "GFP"]
    assert [list(c) for c in fm2.channel_columns()] == [
        list(c) for c in fm.channel_columns()
    ]


def test_run_pipeline_rejects_groupby_without_groups_and_synth_with_mask():
    """r4 regressions: group_by without groups silently leaked donors
    across the split; synth+mask silently masked the synthesized noise
    channels on the classic path while the fused path forbids it."""
    from tpumcia.config import PipelineConfig, SplitConfig, SynthConfig
    from tpumcia.io.synthetic import synthetic_mednist, synthetic_multichannel
    from tpumcia.pipeline.run import run_pipeline

    images, labels, _ = synthetic_multichannel(3, num_classes=2, seed=0)
    with pytest.raises(ValueError, match="group_by"):
        run_pipeline(
            images, labels,
            config=PipelineConfig(split=SplitConfig(group_by="donor")),
        )
    gray, glabels, _ = synthetic_mednist(3, num_classes=2, seed=0)
    with pytest.raises(ValueError, match="mask"):
        run_pipeline(
            gray, glabels,
            mask=np.ones(gray.shape, np.uint8),
            config=PipelineConfig(synth=SynthConfig(noise_channels=2)),
        )


def test_pipeline_survives_degenerate_channels():
    """All-zero channels/images produce scipy-faithful NaN skew/kurtosis at
    the extraction layer (golden-pinned); the pipeline must nan-clean them
    before the head and finish with finite importances."""
    import numpy as np

    from tpumcia.config import (
        FeatureConfig,
        HeadConfig,
        ImportanceConfig,
        PipelineConfig,
    )
    from tpumcia.pipeline.run import run_pipeline

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (24, 24, 24, 3)).astype(np.uint8)
    imgs[..., 1] = 0  # dead channel
    imgs[5] = 0  # dead image
    labels = np.array(["a", "b"] * 12)
    imgs[labels == "a", :, :, 0] //= 4  # separable signal on channel 0
    res = run_pipeline(
        imgs,
        labels,
        config=PipelineConfig(
            features=FeatureConfig(),
            head=HeadConfig(kind="logistic", num_steps=100),
            importance=ImportanceConfig(n_repeats=2),
        ),
    )
    total = np.asarray(res.channel_result.total)
    assert np.isfinite(total).all()
    assert res.test_accuracy >= 0.75
    assert int(np.argmax(total)) == 0
