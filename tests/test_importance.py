"""Importance subsystem: device permutation sweep, channel aggregation,
ablation, and the end-to-end 'Ch1 ranked first' integration contract."""

import numpy as np
import pytest

from tpumcia.config import HeadConfig, ImportanceConfig
from tpumcia.importance import (
    aggregate_channel_importance,
    channel_ablation_importance,
    channel_importance,
    permutation_importance,
)
from tpumcia.models import fit_head


@pytest.fixture(scope="module")
def informative_data():
    """10 features; only features 0 and 3 carry label signal."""
    rng = np.random.default_rng(11)
    n = 400
    y = rng.integers(0, 3, n)
    X = rng.normal(0, 1, size=(n, 10)).astype(np.float32)
    X[:, 0] += y * 2.0
    X[:, 3] -= y * 1.5
    return X, y


def test_device_permutation_finds_informative_features(informative_data):
    X, y = informative_data
    head = fit_head(X, y, config=HeadConfig(kind="logistic", num_steps=400))
    res = permutation_importance(head, X, y, n_repeats=5, seed=42)
    assert res.importances.shape == (10, 5)
    assert res.baseline_score > 0.8
    top2 = set(res.ranking()[:2])
    assert top2 == {0, 3}
    # uninformative features have ~zero importance
    assert np.all(np.abs(res.importances_mean[[1, 2, 4, 5]]) < 0.05)


def test_device_permutation_matches_host_semantics(informative_data):
    """Device sweep and sklearn's host implementation agree on rankings AND
    values: mean score drops use the same definition (baseline - permuted
    accuracy), so with enough repeats the means coincide up to shuffle noise
    (different PRNGs -> different permutations, not different semantics)."""
    from tpumcia.importance.permutation import permutation_importance_host

    X, y = informative_data
    head = fit_head(X, y, config=HeadConfig(kind="random_forest", n_estimators=15))
    dev = permutation_importance(head, X, y, n_repeats=10, seed=42)
    host = permutation_importance_host(head, X, y, n_repeats=10, seed=42)
    assert set(dev.ranking()[:2]) == set(host.ranking()[:2]) == {0, 3}
    assert dev.baseline_score == pytest.approx(host.baseline_score)
    np.testing.assert_allclose(
        dev.importances_mean, host.importances_mean, atol=0.04
    )
    # informative-feature drops are large and must agree tightly in relative
    # terms; near-zero features are pure shuffle noise (covered by atol)
    for j in (0, 3):
        assert dev.importances_mean[j] == pytest.approx(
            host.importances_mean[j], rel=0.25
        )


def test_permutation_deterministic(informative_data):
    X, y = informative_data
    head = fit_head(X, y, config=HeadConfig(kind="logistic", num_steps=200))
    r1 = permutation_importance(head, X, y, n_repeats=3, seed=7)
    r2 = permutation_importance(head, X, y, n_repeats=3, seed=7)
    np.testing.assert_array_equal(r1.importances, r2.importances)


def test_aggregate_exact_vs_substring():
    # 12 channels x 1 feature: substring matching corrupts Ch1 with Ch10-12
    names = [f"mean_intensity_Ch{c + 1}" for c in range(12)]
    imp = np.linspace(0.2, 0.9, 12)
    exact = aggregate_channel_importance(imp, names, 12, threshold=0.0, match="exact")
    sub = aggregate_channel_importance(imp, names, 12, threshold=0.0, match="substring")
    assert len(exact.per_channel[0]) == 1
    assert len(sub.per_channel[0]) == 4  # Ch1 also matches Ch10, Ch11, Ch12
    np.testing.assert_allclose(exact.total, imp)


def test_aggregate_threshold():
    names = ["a_Ch1", "b_Ch1", "a_Ch2", "b_Ch2"]
    imp = np.array([0.5, 0.005, 0.3, 0.02])
    res = aggregate_channel_importance(imp, names, 2, threshold=0.01)
    assert len(res.per_channel[0]) == 1  # 0.005 filtered out
    assert len(res.per_channel[1]) == 2
    assert res.top_channel() == 0


def test_ablation(informative_data):
    X, y = informative_data
    head = fit_head(X, y, config=HeadConfig(kind="logistic", num_steps=400))
    groups = [[0, 3], [1, 2], [4, 5, 6]]
    drops = channel_ablation_importance(head, X, y, groups)
    assert drops.shape == (3,)
    assert drops[0] > 0.2  # ablating informative features hurts
    assert np.all(np.abs(drops[1:]) < 0.08)
    with pytest.raises(ValueError, match="fill must be"):
        channel_ablation_importance(head, X, y, groups, fill="median")


def test_sweep_rejects_zero_repeats(informative_data):
    """n_repeats=0 used to mean-reduce an empty axis into silent all-NaN
    importances; every sweep entry must raise the shared named error."""
    from tpumcia.importance.permutation import permutation_importance

    X, y = informative_data
    head = fit_head(X, y, config=HeadConfig(kind="logistic", num_steps=50))
    with pytest.raises(ValueError, match="n_repeats must be >= 1"):
        permutation_importance(head, X, y, n_repeats=0)


def test_mdi_channel_importance_one_call(rng):
    """The notebook cells 23+25 convenience wrapper: MDI + per-channel
    aggregation in one call, signal channel first (ipynb:432-443, 456-462)."""
    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features
    from tpumcia.importance.mdi import mdi_channel_importance
    from tpumcia.io.synthetic import synthetic_multichannel

    images, labels, _ = synthetic_multichannel(20, num_classes=3, seed=3)
    fm = extract_features(images, config=FeatureConfig())
    X = np.nan_to_num(np.asarray(fm.values, dtype=np.float32))
    head = fit_head(X, labels, config=HeadConfig(kind="random_forest", n_estimators=30))

    res = mdi_channel_importance(head, fm, threshold=None)
    assert res.method == "mdi"
    assert len(res.total) == fm.num_channels
    assert int(np.argmax(res.total)) == 0


@pytest.mark.slow
def test_end_to_end_channel_ranking(rng):
    """The reference's headline result: Ch1 (signal) ranked above the noise
    channels by both importance methods (notebook markdown cells 24/27)."""
    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features
    from tpumcia.io.synthetic import synthetic_multichannel
    from tpumcia.utils.split import train_test_split_indices

    images, labels, _ = synthetic_multichannel(30, num_classes=4, seed=5)
    fm = extract_features(images, config=FeatureConfig())
    X = np.nan_to_num(np.asarray(fm.values, dtype=np.float32))
    split = train_test_split_indices(len(X), test_size=0.25, seed=0, stratify=labels)

    for kind in ("logistic", "random_forest"):
        head = fit_head(
            X[split.train_idx],
            labels[split.train_idx],
            config=HeadConfig(kind=kind, num_steps=400, n_estimators=30),
        )
        assert head.score(X[split.test_idx], labels[split.test_idx]) > 0.7

        fm_test = type(fm)(
            values=X[split.test_idx],
            names=fm.names,
            num_channels=fm.num_channels,
        )
        for method in ("permutation", "auto"):
            res = channel_importance(
                head,
                fm_test,
                labels[split.test_idx],
                method=method,
                config=ImportanceConfig(n_repeats=5),
            )
            assert res.top_channel() == 0, (kind, method, res.summary())


def test_unseen_test_labels_agree_across_sweep_variants():
    """r4 regression: test labels unseen at training time crashed the
    unfused/sharded sweeps (KeyError) while the fused variant mapped them
    to the -1 sentinel. All variants now share labels_to_class_idx and
    must score such rows as mispredictions, not raise."""
    import jax

    from tpumcia.config import HeadConfig
    from tpumcia.models import fit_head
    from tpumcia.importance.permutation import (
        labels_to_class_idx,
        permutation_importance,
    )
    from tpumcia.parallel.mesh import make_mesh
    from tpumcia.parallel.sharding import permutation_importance_sharded

    rng = np.random.RandomState(0)
    X_tr = rng.random((40, 6)).astype(np.float32)
    y_tr = (X_tr[:, 0] > 0.5).astype(np.int64)  # classes {0, 1}
    head = fit_head(X_tr, y_tr, config=HeadConfig(kind="logistic", num_steps=30))

    X_te = rng.random((12, 6)).astype(np.float32)
    y_te = (X_te[:, 0] > 0.5).astype(np.int64)
    y_te[:3] = 7  # a class the head never saw

    idx = labels_to_class_idx(y_te, head.classes)
    assert (idx[:3] == -1).all() and (idx[3:] >= 0).all()

    single = permutation_importance(head, X_te, y_te, n_repeats=2, seed=0)
    sharded = permutation_importance_sharded(
        head, X_te, y_te, mesh=make_mesh(), n_repeats=2, seed=0
    )
    # identical PRNG stream + identical sentinel scoring -> identical drops
    np.testing.assert_allclose(
        sharded.importances, single.importances, atol=1e-6
    )
    assert sharded.baseline_score == pytest.approx(single.baseline_score)
    # baseline reflects the unpredictable rows as mispredictions
    assert single.baseline_score <= 9 / 12 + 1e-6


def test_report_and_scaler_edge_semantics():
    """r4 regressions: classification_report must raise on a target_names
    length mismatch (sklearn parity; zip silently dropped class rows);
    MinMaxScaler.fit ignores NaNs like sklearn; single-pixel masks get
    regionprops' eccentricity 0."""
    import jax.numpy as jnp

    from tpumcia.models.scaler import MinMaxScaler
    from tpumcia.utils.metrics import classification_report
    from tpumcia.features.morphology import morphology_features

    y = np.array([0, 0, 1, 1, 2])
    with pytest.raises(ValueError, match="target_names"):
        classification_report(y, y, target_names=["a", "b"])

    X = np.array([[1.0, np.nan], [3.0, 2.0], [2.0, 4.0]], np.float32)
    sc = MinMaxScaler.fit(X)
    np.testing.assert_allclose(np.asarray(sc.data_min), [1.0, 2.0])
    np.testing.assert_allclose(np.asarray(sc.data_max), [3.0, 4.0])

    mask = np.zeros((1, 8, 8, 1), np.uint8)
    mask[0, 3, 4, 0] = 1  # single pixel
    feats = np.asarray(morphology_features(mask))  # (1, 1, 8)
    from tpumcia.features.morphology import morphology_feature_names

    names = morphology_feature_names(1, None)
    ecc_i = [i for i, n in enumerate(names) if "ecc" in n][0]
    assert feats[0, 0, ecc_i] == 0.0, feats[0, 0]
