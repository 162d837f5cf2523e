"""GPU coverage of the device paths: the batched extraction API, the
streaming wire mode, the multi-offset wire, the CNN train/occlusion path and
the GEMM forest sweep, each compiled by XLA for the card. Each test is
bounded to seconds once the compilation cache is warm
(``enable_compilation_cache`` first, like the bench). They skip on any
other backend (the ``gpu`` marker, decided in ``conftest._gpu_only``).

Run on the card: ``TPUMCIA_TEST_BACKEND=native python -m pytest -m gpu
tests/`` (``make test-gpu``); ``chip_smoke.py`` runs them as its last phase.
"""

import numpy as np
import pytest

F32_FIELDS = (
    "std_intensity", "kurtosis_intensity", "skew_intensity",
    "shannon_entropy", "homogeneity",
)


@pytest.fixture(autouse=True)
def _warm_cache():
    from tpumcia.utils.cache import enable_compilation_cache

    enable_compilation_cache()


@pytest.fixture
def batch96(rng):
    # one shape shared by every test in this file (one compile per stage)
    img = (rng.random((96, 64, 64, 3)) * 256).astype(np.uint8)
    img[:, :, :, 0] = (img[:, :, :, 0] // 2) + (
        np.arange(96, dtype=np.uint8)[:, None, None] % 2
    ) * 100  # channel 0 carries a class signal
    labels = np.array(["a", "b"] * 48)
    return img, labels


@pytest.mark.gpu
def test_batched_extraction_matches_one_shot_on_gpu(batch96):
    """extract_features_batched over >= 2 fused per-batch dispatches against
    the one-shot call: the integer-derived features are bit-identical; the
    float32-summed ones (std, kurtosis, skew, entropy, homogeneity) may be
    reduced in another order at another batch shape, and agree to 1e-4 of
    their column's scale — the contract extract_features_batched states."""
    from tpumcia.features.extract import (
        extract_features,
        extract_features_batched,
    )

    img, _ = batch96
    one = extract_features(img)
    batched = extract_features_batched(
        img, batch_size=48, keep_device_values=True
    )
    assert batched.shape == one.shape
    b, o = np.asarray(batched.values), np.asarray(one.values)
    f32 = np.array([n.startswith(F32_FIELDS) for n in one.names])
    np.testing.assert_array_equal(b[:, ~f32], o[:, ~f32])
    np.testing.assert_array_equal(np.isnan(b), np.isnan(o))
    scale = np.nanmax(np.abs(o[:, f32]), axis=0)
    assert (np.nan_to_num(np.abs(b[:, f32] - o[:, f32])) <= 1e-4 * scale).all()
    np.testing.assert_array_equal(
        np.asarray(batched.degenerate), np.asarray(one.degenerate)
    )
    dv = np.asarray(batched.device_values)
    assert dv.shape == one.shape and np.isfinite(dv).all()


@pytest.mark.gpu
def test_streaming_wire_mode_and_resume_on_gpu(tmp_path, batch96):
    """The streaming wire mode (fused dispatch + deferred wire fetch per
    shard, wrap-padded shard shapes) on hardware, plus a resume pass."""
    from tpumcia.pipeline.streaming import stream_extract

    img, labels = batch96

    def fetch(idx):
        return img[idx], None, labels[idx]

    out = tmp_path / "shards"
    res = stream_extract(fetch, len(img), out, shard_size=48)
    assert res.shards_computed == 2
    assert res.features.shape[0] == 96
    assert np.isfinite(np.nan_to_num(res.features.to_numpy())).all()

    res2 = stream_extract(fetch, len(img), out, shard_size=48)
    assert res2.shards_computed == 0 and res2.shards_skipped == 2
    np.testing.assert_array_equal(
        np.asarray(res2.features.values), np.asarray(res.features.values)
    )


@pytest.mark.gpu
def test_multi_offset_one_fetch_wire_on_gpu(batch96):
    """The round-5 multi-offset u32 wire (one fetch for the whole offset
    list) against the exact backend on hardware."""
    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import extract_features

    img, _ = batch96
    glcm = GLCMConfig(distance=(1, 5), angle=(0.0, np.pi / 2))
    fm = extract_features(img, config=FeatureConfig(glcm=glcm))
    assert fm.shape == (96, 3 * (17 + 6 * 4))
    exact = extract_features(
        img, config=FeatureConfig(glcm=glcm, precision="exact")
    )
    ve, vw = np.asarray(exact.values), np.asarray(fm.values)
    assert (np.isnan(ve) == np.isnan(vw)).all()
    err = np.abs(np.nan_to_num(ve) - np.nan_to_num(vw))
    # hybrid-vs-exact on hardware: the f32 homogeneity sums reduce in the
    # device's order, which may be slightly looser than the CPU golden
    # bound; the mean must stay at the golden contract
    assert err.max() < 5e-5
    assert err.mean() < 1e-6


@pytest.mark.gpu
def test_cnn_train_and_occlusion_on_gpu(batch96):
    """One tiny CNN fit (width 16, 8 epochs) + the occlusion sweep on the
    card — the bf16 conv/GroupNorm train path and the vectorised occlusion
    jit."""
    pytest.importorskip("flax")
    import jax

    from tpumcia.importance.occlusion import channel_occlusion_importance
    from tpumcia.models.train import CNNConfig, fit_cnn

    img, labels = batch96
    x = jax.device_put((img / 255.0).astype(np.float32))
    head = fit_cnn(
        x, labels,
        config=CNNConfig(
            num_classes=2, width=16, depth="10", epochs=8, batch_size=32,
        ),
    )
    assert len(head.history) == 8
    assert head.history[-1]["loss"] < head.history[0]["loss"]
    assert head.score(x, labels) > 0.8  # learnable signal in channel 0
    occ = np.asarray(channel_occlusion_importance(head, x, labels))
    assert occ.shape == (3,)
    assert np.isfinite(occ).all()
    assert int(np.argmax(occ)) == 0  # zeroing the signal channel hurts most


@pytest.mark.gpu
def test_gemm_forest_permutation_sweep_on_gpu(batch96):
    """RF head scored through the GEMM forest (path-matrix matmul leaf
    selection) driving the one-jit permutation sweep on the card."""
    pytest.importorskip("sklearn")
    from tpumcia.config import HeadConfig, ImportanceConfig
    from tpumcia.features.extract import extract_features
    from tpumcia.importance.channels import channel_importance
    from tpumcia.models.heads import fit_head

    img, labels = batch96
    fm = extract_features(img)
    X = np.nan_to_num(np.asarray(fm.values, np.float32))
    head = fit_head(
        X, labels, config=HeadConfig(kind="random_forest", n_estimators=20)
    )
    res = channel_importance(
        head, fm, labels, method="permutation",
        config=ImportanceConfig(n_repeats=3),
        eval_features=X, eval_labels=labels,
    )
    total = np.asarray(res.total)
    assert total.shape == (3,) and np.isfinite(total).all()
    assert int(np.argmax(total)) == 0
