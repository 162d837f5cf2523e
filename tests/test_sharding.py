"""Multi-device (8-device CPU mesh) tests for the sharded pipeline paths."""

import jax
import numpy as np
import pytest

from tpumcia.config import FeatureConfig, HeadConfig
from tpumcia.features.extract import extract_features
from tpumcia.models import MinMaxScaler, fit_head
from tpumcia.parallel import (
    extract_features_sharded,
    fit_scaler_sharded,
    make_mesh,
    permutation_importance_sharded,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device mesh"
)


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape["data"] == len(jax.devices())
    mesh2 = make_mesh(data=4, model=2)
    assert mesh2.shape == {"data": 4, "model": 2}


def test_sharded_features_match_single_device(small_batch):
    mesh = make_mesh()
    fm_ref = extract_features(
        small_batch, config=FeatureConfig(precision="exact")
    )
    fm_sh = extract_features_sharded(small_batch, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(fm_sh.values), np.asarray(fm_ref.values))


def test_sharded_features_nondivisible_batch(small_batch):
    mesh = make_mesh()
    batch = small_batch[:5]  # 5 images over 8 devices -> padding path
    fm_ref = extract_features(
        batch, config=FeatureConfig(precision="exact")
    )
    fm_sh = extract_features_sharded(batch, mesh=mesh)
    assert fm_sh.values.shape == fm_ref.values.shape
    np.testing.assert_array_equal(np.asarray(fm_sh.values), np.asarray(fm_ref.values))


def test_sharded_multi_offset_matches_single_device(small_batch):
    """Mesh + multi-offset GLCM routes through the fused sharded pass and
    must equal the single-device multi-offset extraction exactly."""
    from tpumcia.config import GLCMConfig

    mesh = make_mesh()
    cfg = FeatureConfig(glcm=GLCMConfig(distance=(5, 2)))
    fm_ref = extract_features(small_batch, config=cfg)
    fm_sh = extract_features(small_batch, config=cfg, mesh=mesh)
    assert fm_sh.names == fm_ref.names
    np.testing.assert_allclose(
        np.asarray(fm_sh.values), np.asarray(fm_ref.values),
        rtol=0, atol=1e-5, equal_nan=True,
    )


def test_sharded_scaler_matches_local(rng):
    mesh = make_mesh()
    X = rng.normal(0, 5, size=(37, 12)).astype(np.float32)
    local = MinMaxScaler.fit(X)
    sharded = fit_scaler_sharded(X, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(sharded.data_min), np.asarray(local.data_min), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(sharded.data_max), np.asarray(local.data_max), atol=1e-6
    )


def test_sharded_permutation_matches_single_device(rng):
    from tpumcia.importance import permutation_importance

    mesh = make_mesh()
    n = 200
    y = rng.integers(0, 3, n)
    X = rng.normal(0, 1, size=(n, 10)).astype(np.float32)
    X[:, 0] += y * 2.0
    X[:, 5] -= y * 1.5
    head = fit_head(X, y, config=HeadConfig(kind="logistic", num_steps=300))

    single = permutation_importance(head, X, y, n_repeats=4, seed=42)
    sharded = permutation_importance_sharded(head, X, y, mesh=mesh, n_repeats=4, seed=42)
    # identical PRNG stream -> identical importances
    np.testing.assert_allclose(sharded.importances, single.importances, atol=1e-6)
    assert set(sharded.ranking()[:2]) == {0, 5}


def test_sharded_grouped_permutation(rng):
    mesh = make_mesh()
    n = 150
    y = rng.integers(0, 2, n)
    X = rng.normal(0, 1, size=(n, 8)).astype(np.float32)
    X[:, 2] += y * 3.0
    head = fit_head(X, y, config=HeadConfig(kind="logistic", num_steps=300))
    groups = [[0, 1], [2, 3], [4, 5, 6, 7]]
    res = permutation_importance_sharded(
        head, X, y, mesh=mesh, n_repeats=3, seed=1, groups=groups
    )
    assert res.importances.shape == (3, 3)
    assert res.ranking()[0] == 1


def test_stream_extract_with_mesh(tmp_path, rng):
    from tpumcia.config import FeatureConfig
    from tpumcia.pipeline.streaming import stream_extract
    from tpumcia.features.extract import extract_features

    images = (rng.random((10, 32, 32, 2)) * 256).astype(np.uint8)

    def fetch(idx):
        return images[idx], None, None

    mesh = make_mesh()
    res = stream_extract(
        fetch, len(images), tmp_path / "mesh_stream", shard_size=4,
        config=FeatureConfig(precision="exact"), mesh=mesh,
    )
    ref = extract_features(
        images, config=FeatureConfig(precision="exact")
    )
    np.testing.assert_array_equal(
        np.asarray(res.features.values), np.asarray(ref.values)
    )
