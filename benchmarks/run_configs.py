"""Per-config benchmarks for the five BASELINE.json workloads.

Prints one JSON line per config; ``python benchmarks/run_configs.py`` runs
all, ``--config N`` runs one. These lines are not recorded anywhere yet: the
benchmark the project records is ``bench.py``.

Timing discipline: every timed section ends in a device->host fetch, so it
measures the device work and not just its enqueue.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rate(n, elapsed):
    return round(n / elapsed, 1)


def config1_masked_extraction(batch=2048, reps=8):
    """Config 1: hand-crafted per-channel features on 3-channel 64x64 cell
    crops WITH masks (the notebook's CPU path, batched; ipynb:206-311)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpumcia.features.extract import extract_features

    rng = np.random.default_rng(0)
    imgs = (rng.random((batch, 64, 64, 3)) * 256).astype(np.uint8)
    mask = rng.random((batch, 64, 64, 3)) > 0.2
    imgs_d, mask_d = jax.device_put(imgs), jax.device_put(mask)

    fm = extract_features(imgs_d, mask=mask_d)  # warm/compile
    t0 = time.perf_counter()
    for _ in range(reps):
        fm = extract_features(imgs_d, mask=mask_d)
    np.asarray(fm.values)
    elapsed = time.perf_counter() - t0

    # collection-scale: the pipelined batched API over reps*batch images
    # (one compiled shape, concurrent wire fetches)
    from tpumcia.features.extract import extract_features_batched

    big = jnp.concatenate([imgs_d] * reps)
    big_mask = jnp.concatenate([mask_d] * reps)
    fmb = extract_features_batched(big, mask=big_mask, batch_size=batch)
    t0 = time.perf_counter()
    fmb = extract_features_batched(big, mask=big_mask, batch_size=batch)
    batched_elapsed = time.perf_counter() - t0
    assert fmb.shape == (batch * reps, fm.values.shape[1])
    return {
        "config": 1,
        "name": "masked_feature_extraction",
        "images_per_sec": _rate(batch * reps, elapsed),
        "images_per_sec_batched_api": _rate(batch * reps, batched_elapsed),
        "batch": batch,
        "masked": True,
        "features": int(fm.values.shape[1]),
    }


def config2_importance(n=12000, n_repeats=10):
    """Config 2: channel-permutation importance with logistic AND RF heads
    over the hand-crafted feature matrix (notebook rankings, ipynb:493-505).
    The device sweep replaces the reference's joblib process pool."""
    import jax
    import numpy as np

    from tpumcia.config import HeadConfig, ImportanceConfig
    from tpumcia.features.extract import extract_features
    from tpumcia.importance.channels import channel_importance
    from tpumcia.io.synthetic import synthetic_mednist
    from tpumcia.models.heads import fit_head
    from tpumcia.preprocess.synth import add_noise_channels
    from tpumcia.utils.split import train_test_split_indices

    gray, labels, _ = synthetic_mednist(n // 6, num_classes=6, seed=0)
    imgs = np.asarray(
        add_noise_channels(jax.device_put(gray), jax.random.key(0))
    )
    # batch the (untimed) extraction at the bench batch size to reuse the
    # cached kernel shape; the timed section is the importance sweep
    B = 2048
    pad = (-len(imgs)) % B
    padded = np.concatenate([imgs, imgs[:pad]]) if pad else imgs
    fms = [
        extract_features(padded[s : s + B]) for s in range(0, len(padded), B)
    ]
    fm = fms[0]
    fm.values = np.concatenate([np.asarray(f.values) for f in fms])[: len(imgs)]
    X = np.nan_to_num(np.asarray(fm.values, np.float32))
    split = train_test_split_indices(len(X), test_size=0.25, seed=0,
                                     stratify=labels)
    X_te, y_te = X[split.test_idx], labels[split.test_idx]

    out = {"config": 2, "name": "channel_permutation_importance",
           "n_test": int(len(X_te)), "n_repeats": n_repeats}
    for kind in ("logistic", "random_forest"):
        head = fit_head(X[split.train_idx], labels[split.train_idx],
                        config=HeadConfig(kind=kind))
        icfg = ImportanceConfig(n_repeats=n_repeats)
        res = channel_importance(
            head, fm, labels, method="permutation", config=icfg,
            eval_features=X_te, eval_labels=y_te,
        )  # warm
        t0 = time.perf_counter()
        res = channel_importance(
            head, fm, labels, method="permutation", config=icfg,
            eval_features=X_te, eval_labels=y_te,
        )
        sweep_s = time.perf_counter() - t0
        out[f"{kind}_sweep_seconds"] = round(sweep_s, 3)
        out[f"{kind}_signal_channel_first"] = bool(
            int(np.argmax(res.total)) == 0
        )
    return out


def config3_cnn(n=2048, epochs=8):
    """Config 3: ResNet-18-style CNN (C-channel stem) + occlusion channel
    importance."""
    import numpy as np

    from tpumcia.importance.occlusion import channel_occlusion_importance
    from tpumcia.io.synthetic import synthetic_mednist
    from tpumcia.models.train import CNNConfig, fit_cnn
    from tpumcia.preprocess.synth import add_noise_channels
    import jax

    import jax.numpy as jnp

    gray, labels, _ = synthetic_mednist(n // 6 + 1, num_classes=6, seed=0)
    gray = gray[:n]
    labels = labels[:n]
    # stage once on device: the timed sections measure train/occlusion
    # compute, not the 100 MB H2D upload
    x = add_noise_channels(jax.device_put(gray), jax.random.key(0)).astype(
        jnp.float32
    ) / 255.0
    # occlusion probe over the full batch: the sweep is ONE dispatch + one
    # scalar fetch, so a small probe would report dispatch latency, not
    # sweep throughput
    x_occ = x

    cfg = CNNConfig(
        num_classes=6, depth="18", width=32, epochs=epochs, batch_size=256
    )
    # warm-up: traces + compiles at the exact shapes (jits in the train and
    # occlusion paths are cache-stable across calls)
    warm = fit_cnn(x, labels, config=CNNConfig(
        num_classes=6, depth="18", width=32, epochs=1, batch_size=256
    ))
    channel_occlusion_importance(warm, x_occ, labels)

    t0 = time.perf_counter()
    head = fit_cnn(x, labels, config=cfg)
    train_s = time.perf_counter() - t0
    acc = head.score(x, labels)
    t0 = time.perf_counter()
    occ_vals = np.asarray(channel_occlusion_importance(head, x_occ, labels))
    occ_s = time.perf_counter() - t0
    return {
        "config": 3,
        "name": "cnn_train_plus_occlusion",
        "train_images_per_sec": _rate(n * epochs, train_s),
        "occlusion_images_per_sec": _rate(len(labels), occ_s),
        "train_accuracy": round(float(acc), 4),
        "signal_channel_first": bool(int(np.argmax(occ_vals)) == 0),
    }


def config4_cytometry(n=2048, reps=4):
    """Config 4: 12-channel 16-bit stacks with masks + donor-grouped split."""
    import jax
    import numpy as np

    from tpumcia.config import FeatureConfig, PipelineConfig, SplitConfig
    from tpumcia.pipeline.run import run_pipeline

    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 65536, (n, 32, 32, 12), dtype=np.uint16)
    labels = (np.arange(n) % 3).astype(np.int32)
    # class signal on channel 4
    imgs[..., 4] = (imgs[..., 4] // 4 + labels[:, None, None] * 15000).astype(
        np.uint16
    )
    mask = rng.random((n, 32, 32, 12)) > 0.1
    donors = np.array([f"D{i % 8}" for i in range(n)])

    from tpumcia.preprocess.normalize import quantize_to_levels
    from tpumcia.features.extract import extract_features

    imgs_d = jax.device_put(imgs)
    mask_d = jax.device_put(mask)  # staged once; timed reps measure compute
    q = quantize_to_levels(imgs_d, levels=256, src_levels=65536)
    fm = extract_features(q, mask=mask_d)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        q = quantize_to_levels(imgs_d, levels=256, src_levels=65536)
        fm = extract_features(q, mask=mask_d)
    np.asarray(fm.values)
    extract_s = time.perf_counter() - t0

    cfg = PipelineConfig(split=SplitConfig(group_by="donor"))
    res = run_pipeline(
        np.asarray(q), labels, config=cfg, mask=mask, groups=donors
    )
    tr_donors = set(donors[res.train_idx])
    te_donors = set(donors[res.test_idx])
    return {
        "config": 4,
        "name": "cytometry_12ch_grouped",
        "images_per_sec_extraction": _rate(n * reps, extract_s),
        "channels": 12,
        "test_accuracy": round(res.test_accuracy, 4),
        "signal_channel_first": bool(
            int(np.argmax(res.channel_result.total)) == 4
        ),
        "donor_groups_disjoint": bool(not (tr_donors & te_donors)),
    }


def config5_streaming(n=16384, shard=2048):
    """Config 5: manifest-driven streaming extraction with resume."""
    import shutil
    import tempfile

    import numpy as np

    from tpumcia.io.synthetic import synthetic_multichannel
    from tpumcia.pipeline.streaming import stream_extract

    imgs, labels, _ = synthetic_multichannel(n // 6 + 1, seed=0)
    imgs = imgs[:n]

    def fetch(idx):
        # contiguous view, no copy — stream_extract always requests
        # contiguous index ranges
        idx = np.asarray(idx)
        return imgs[int(idx[0]) : int(idx[-1]) + 1], None, None

    # warm-up: compile the per-shard dispatch at the real shard shape
    # (standard JAX benchmark discipline, like configs 1-3)
    warm_dir = tempfile.mkdtemp()
    try:
        stream_extract(fetch, shard, warm_dir, shard_size=shard)
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)

    out = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        res = stream_extract(fetch, n, out, shard_size=shard)
        elapsed = time.perf_counter() - t0
        return {
            "config": 5,
            "name": "streaming_sharded",
            "images_per_sec": _rate(n, elapsed),
            "n_objects": n,
            "shards": res.shards_computed,
            "reported_rate": res.images_per_second,
            "profile": res.profile,
        }
    finally:
        shutil.rmtree(out, ignore_errors=True)


CONFIGS = {
    1: config1_masked_extraction,
    2: config2_importance,
    3: config3_cnn,
    4: config4_cytometry,
    5: config5_streaming,
}


def main():
    from tpumcia.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None)
    args = ap.parse_args()
    todo = [args.config] if args.config else sorted(CONFIGS)
    for c in todo:
        print(json.dumps(CONFIGS[c]()), flush=True)


if __name__ == "__main__":
    main()
