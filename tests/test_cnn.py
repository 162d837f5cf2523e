"""CNN path: ResNet forward/train, mesh-sharded training, occlusion
importance, checkpoint round-trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the CNN is an optional extra (pip install .[cnn]): without flax this
# module skips as a whole, on every worker alike
pytest.importorskip("flax")

from tpumcia.io.synthetic import synthetic_multichannel  # noqa: E402
from tpumcia.models.cnn import make_resnet  # noqa: E402
from tpumcia.models.train import CNNConfig, CNNHead, fit_cnn  # noqa: E402

pytestmark = pytest.mark.slow  # heavy: compile/train-bound (use `make test-fast` to skip)


@pytest.fixture(scope="module")
def tiny_dataset():
    images, labels, _ = synthetic_multichannel(16, num_classes=3, hw=32, seed=9)
    return images.astype(np.float32) / 255.0, labels


@pytest.fixture(scope="module")
def trained_head(tiny_dataset):
    images, labels = tiny_dataset
    cfg = CNNConfig(
        num_classes=3, width=8, depth="10", epochs=6, batch_size=16,
        learning_rate=3e-3,
    )
    return fit_cnn(images, labels, config=cfg)


def test_resnet_forward_shapes():
    model = make_resnet(5, width=8, depth="10")
    x = jnp.zeros((2, 32, 32, 7))  # 7-channel stem
    params = model.init(jax.random.key(0), x)["params"]
    logits = model.apply({"params": params}, x)
    assert logits.shape == (2, 5)
    assert logits.dtype == jnp.float32


def test_cnn_learns(trained_head, tiny_dataset):
    images, labels = tiny_dataset
    assert trained_head.history[-1]["loss"] < trained_head.history[0]["loss"]
    assert trained_head.score(images, labels) > 0.6


def test_cnn_history_deferred_matches_eager(tiny_dataset, capsys):
    """fit_cnn defers the per-epoch loss fetch when nothing consumes it
    mid-train (one stacked fetch at the end instead of a blocking link
    round trip per epoch); the recorded history must be identical to the
    eager (verbose) path — same seed, same f32 epoch-mean losses."""
    images, labels = tiny_dataset
    cfg = CNNConfig(
        num_classes=3, width=8, depth="10", epochs=3, batch_size=16,
        learning_rate=3e-3, seed=11,
    )
    deferred = fit_cnn(images, labels, config=cfg)  # not verbose, no eval
    eager = fit_cnn(images, labels, config=cfg, verbose=True)
    assert capsys.readouterr().out.count("loss") == 3  # eager printed epochs
    assert len(deferred.history) == len(eager.history) == 3
    for d, e in zip(deferred.history, eager.history):
        assert d["epoch"] == e["epoch"]
        assert d["loss"] == e["loss"]  # bit-equal: same jits, same seed


def test_cnn_trains_with_remainder_and_tiny_datasets(tiny_dataset):
    """The tail batch must train (padded wrap-around order), including the
    extreme n < batch_size case that used to train on nothing."""
    images, labels = tiny_dataset
    cfg = CNNConfig(num_classes=3, width=8, depth="10", epochs=2, batch_size=64)
    head = fit_cnn(images, labels, config=cfg)  # n=16 < batch 64
    assert len(head.history) == 2
    assert np.isfinite(head.history[-1]["loss"])
    assert head.history[-1]["loss"] != head.history[0]["loss"]  # stepped

    # remainder case: n=16, batch 12 -> both steps run, all samples seen
    cfg2 = CNNConfig(num_classes=3, width=8, depth="10", epochs=1, batch_size=12)
    head2 = fit_cnn(images, labels, config=cfg2)
    assert np.isfinite(head2.history[0]["loss"])


def test_fit_cnn_validates_inputs(tiny_dataset):
    """3-D images or mismatched label counts must raise named errors at the
    entry — flax Conv would otherwise silently compute on a misread layout
    (r5-close probe finding)."""
    images, labels = tiny_dataset
    cfg = CNNConfig(num_classes=3, width=8, depth="10", epochs=1, batch_size=8)
    with pytest.raises(ValueError, match=r"expects \(B, H, W, C\)"):
        fit_cnn(images[..., 0], labels, config=cfg)
    with pytest.raises(ValueError, match="does not match"):
        fit_cnn(images, labels[:-2], config=cfg)


def test_cnn_sharded_training(tiny_dataset):
    from tpumcia.parallel import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device")
    images, labels, _ = synthetic_multichannel(12, num_classes=4, hw=32, seed=3)
    images = images.astype(np.float32) / 255.0
    mesh = make_mesh(data=4, model=2)
    cfg = CNNConfig(num_classes=4, width=8, depth="10", epochs=2, batch_size=16)
    head = fit_cnn(images, labels, config=cfg, mesh=mesh)
    assert head.score(images, labels) >= 0.3  # trained at all
    # classifier kernel is sharded over the model axis
    spec = head.params["classifier"]["kernel"].sharding.spec
    assert "model" in str(spec)


def test_channel_occlusion_ranks_signal_channel(trained_head, tiny_dataset):
    from tpumcia.importance.occlusion import (
        channel_occlusion_importance,
        channel_permutation_importance_images,
    )

    images, labels = tiny_dataset
    occ = channel_occlusion_importance(trained_head, images, labels)
    assert occ.shape == (3,)
    assert occ[0] == occ.max()  # channel 1 carries the signal

    perm = channel_permutation_importance_images(
        trained_head, images, labels, n_repeats=3
    )
    assert perm.shape == (3, 3)
    assert perm.mean(axis=1)[0] == perm.mean(axis=1).max()


def test_occlusion_map_shape(trained_head, tiny_dataset):
    from tpumcia.importance.occlusion import occlusion_map

    images, labels = tiny_dataset
    maps = occlusion_map(trained_head, images[:4], labels[:4], window=8, stride=8)
    assert maps.shape == (4, 4, 4)
    assert np.isfinite(maps).all()


def test_cnn_checkpoint_roundtrip(trained_head, tiny_dataset, tmp_path):
    images, labels = tiny_dataset
    path = str(tmp_path / "ckpt")
    trained_head.save(path)
    restored = CNNHead.load(path, config=trained_head.config)
    np.testing.assert_array_equal(
        restored.predict(images[:8]), trained_head.predict(images[:8])
    )


def test_run_cnn_pipeline(tiny_dataset):
    from tpumcia.pipeline.run_cnn import run_cnn_pipeline

    images, labels = tiny_dataset
    cfg = CNNConfig(num_classes=3, width=8, depth="10", epochs=5,
                    batch_size=16, learning_rate=3e-3)
    res = run_cnn_pipeline(images, labels, config=cfg, n_repeats=2)
    assert 0.0 <= res.test_accuracy <= 1.0
    assert res.occlusion.num_channels == 3
    assert res.permutation.num_channels == 3
    # channel 1 carries the class signal
    assert res.occlusion.top_channel() == 0
    assert "precision" in res.report


def test_resnet_arbitrary_width_initializes():
    """r4 regression: GroupNorm num_groups=min(32, width) crashed init for
    widths like 48 (not divisible by 32); the divisor is now adapted."""
    import jax
    import jax.numpy as jnp

    from tpumcia.models.cnn import make_resnet

    model = make_resnet(4, width=48, depth="10")
    params = model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    out = model.apply(params, jnp.zeros((2, 32, 32, 3)))
    assert out.shape == (2, 4)
