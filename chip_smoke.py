"""End-to-end check that the pipeline runs on an NVIDIA GPU.

    python chip_smoke.py           # one card: phases 0-7
    python chip_smoke.py --four    # four cards: the sharded path only

One process drives the public entry points at the reference's workload and
compares what comes out with the repo's own references: the numpy oracle
(``tpumcia/reference_impl/oracle.py``), the classic (unfused) pipeline, the
single-device path and the same seed's CPU run. Each phase prints one line:
what it checked, the measured error beside its tolerance, and its wall time
with the compile time inside it given separately. A failed check raises and
the script exits non-zero; nothing is caught. Without a GPU it exits
non-zero before any work and prints no result. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Every time printed here is a chip_smoke reading, not a benchmark cell.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Hybrid precision against the float64 oracle: the golden tests' bounds.
HYBRID_MAX_ABS = 1e-5
HYBRID_MAE = 1e-6
EXACT_MAX_ABS = 1e-9
# fused vs classic (and sharded vs single-device) feature parity: the
# integer-derived columns are bit-identical, the float32-summed ones agree
# to this error relative to their column's scale
F32_FIELD_RTOL = 1e-4
# channels whose importance totals differ by less than this (in accuracy)
# are a tie: the two noise channels sit near zero and swap freely
RANK_TIE = 5e-3
ACCURACY_TOL = 0.02

# Sizes. "full" is what the script runs; "tiny" is the CPU-test rehearsal
# of the same code. cpu_accuracy is phase 2's test accuracy from the same
# seed on the CPU backend at that size.
SIZES = {
    "full": dict(
        p1_objects=2048, p1_oracle=256,
        p2_images=12_000, cpu_accuracy=0.9703333333333334,
        p3_objects=4096, p3_oracle=128,
        p4_shards=8, p4_shard_size=1024,
        p5_images=2048, p5_width=32, p5_batch=256,
        rf_trees=100,
    ),
    "tiny": dict(
        p1_objects=16, p1_oracle=4,
        p2_images=240, cpu_accuracy=0.95,
        p3_objects=48, p3_oracle=4,
        p4_shards=3, p4_shard_size=8,
        p5_images=64, p5_width=8, p5_batch=32,
        rf_trees=10,
    ),
}

# columns whose values are float32 sums on the device (hybrid.py); every
# other column is assembled in float64 from exact integers
F32_PREFIXES = (
    "std_intensity", "kurtosis_intensity", "skew_intensity",
    "shannon_entropy", "homogeneity",
)


# --------------------------------------------------------------- helpers
class _CompileClock:
    """Sums jax's compile-time events (trace + lowering + backend compile)."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )
    total = 0.0
    _registered = False

    @classmethod
    def ensure(cls):
        if not cls._registered:
            import jax

            def listen(name, secs, **_):
                if name in cls.EVENTS:
                    cls.total += secs

            jax.monitoring.register_event_duration_secs_listener(listen)
            cls._registered = True


class Phase:
    """Times one phase and prints its one line."""

    def __init__(self, name):
        self.name = name
        self.checks = []
        self.notes = []

    def __enter__(self):
        _CompileClock.ensure()
        self.t0 = time.perf_counter()
        self.c0 = _CompileClock.total
        return self

    def check(self, what, err, tol):
        """Record ``err <= tol``; raise at once when it fails."""
        err = float(err)
        self.checks.append(f"{what} {err:.3g} (tol {tol:.3g})")
        if not err <= tol:
            raise AssertionError(
                f"phase {self.name}: {what} = {err!r} exceeds {tol!r}"
            )

    def require(self, what, ok):
        self.checks.append(f"{what} {'yes' if ok else 'NO'}")
        if not ok:
            raise AssertionError(f"phase {self.name}: {what} failed")

    def note(self, text):
        self.notes.append(text)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            wall = time.perf_counter() - self.t0
            comp = _CompileClock.total - self.c0
            print(
                f"[{self.name}] ok: " + "; ".join(self.checks + self.notes)
                + f" | wall {wall:.2f} s, of which compile {comp:.2f} s",
                flush=True,
            )
        return False


def _oracle_rows(images, names, cfg, boxes=None):
    """Oracle feature rows (float64) for integer level images, in ``names``
    order; ``boxes`` crops each object to its (r0, r1, c0, c1) mask box."""
    from tpumcia.reference_impl import oracle

    glcm = cfg.glcm
    pairs = [(d, a) for d in glcm.distances for a in glcm.angles]
    tags = glcm.pair_labels or [None]
    rows = []
    for i, img in enumerate(images):
        if boxes is not None:
            r0, r1, c0, c1 = boxes[i]
            img = img[r0:r1, c0:c1]
        f = np.asarray(img, np.float64) / (glcm.levels - 1)
        vals = oracle.basic_statistical_features(f)
        for (d, a), tag in zip(pairs, tags):
            g = oracle.glcm_features(f, distance=d, angle=a)
            if tag:
                g = {k.replace("_Ch", f"_{tag}_Ch"): v for k, v in g.items()}
            vals.update(g)
        rows.append([vals[n] for n in names])
    return np.asarray(rows, np.float64)


def _abs_errors(got, ref):
    """|got - ref| with matching NaNs (scipy's constant-channel skew and
    kurtosis) counted as equal and a one-sided NaN as an infinite error."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    both = np.isnan(got) & np.isnan(ref)
    err = np.abs(np.where(both, 0.0, got) - np.where(both, 0.0, ref))
    return np.where(np.isnan(err), np.inf, err)


def _feature_parity(a, b, names):
    """(max relative error over the float32-summed columns, number of
    differing entries in the integer-derived columns). The relative error
    is taken against each column's largest magnitude: a float32 sum errs
    relative to the terms summed, so a skew near zero (uniform data) has a
    large error relative to itself but not to its column."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    f32 = np.array([n.startswith(F32_PREFIXES) for n in names])
    both_nan = np.isnan(a) & np.isnan(b)
    same = both_nan | (a == b)
    int_diff = int(np.sum(~same[:, ~f32]))
    fa = np.where(both_nan, 0.0, a)[:, f32]
    fb = np.where(both_nan, 0.0, b)[:, f32]
    scale = np.maximum(np.abs(fa), np.abs(fb)).max(axis=0, initial=0.0)
    rel = np.abs(fa - fb) / np.where(scale > 0, scale, 1.0)
    rel = np.where(np.isnan(rel), np.inf, rel)
    return float(rel.max(initial=0.0)), int_diff


def _ranking_breaks(a, b):
    """Number of channel pairs that ``a`` orders by more than RANK_TIE and
    ``b`` orders the other way (0 = same ranking, ties aside)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = 0
    for i in range(len(a)):
        for j in range(len(a)):
            if a[i] - a[j] > RANK_TIE and b[i] < b[j]:
                n += 1
    return n


def _signal_images(n, seed, num_noise=2):
    """(n, 64, 64, 1 + num_noise) uint8: a synthetic MedNIST signal channel
    plus clipped-gaussian noise channels (the reference's layout)."""
    from tpumcia.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(-(-n // 6), num_classes=6, seed=seed)
    gray, labels = gray[:n], labels[:n]
    rng = np.random.default_rng(seed)
    noise = np.clip(rng.normal(0.0, 0.1, gray.shape + (num_noise,)), 0, 1)
    imgs = np.concatenate(
        [gray[..., None], (noise * 255.0).astype(np.uint8)], axis=-1
    )
    return imgs, labels


def _boxes(n, hw, seed, margin):
    """Per-object rectangular mask boxes (r0, r1, c0, c1) and their (n, hw,
    hw) bool masks: a box mask selects exactly the crop's pixels and pairs,
    so the oracle on the crop is the masked reference."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, margin, (n, 2))
    hi = hw - rng.integers(0, margin, (n, 2))
    boxes = np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], axis=1)
    mask = np.zeros((n, hw, hw), bool)
    for i, (r0, r1, c0, c1) in enumerate(boxes):
        mask[i, r0:r1, c0:c1] = True
    return boxes, mask


# ---------------------------------------------------------------- phases
def phase0_device(*, four=False):
    """Refuse anything but GPUs; print what the run is on. -> card line."""
    import jax

    devs = jax.devices()
    need = 4 if four else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(
            f"chip_smoke: needs {need} NVIDIA GPU(s); jax found "
            f"{len(devs)} {devs[0].platform} device(s)",
            file=sys.stderr,
        )
        sys.exit(2)
    from tpumcia.utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(
        f"[0] device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__} compile_cache={cache}",
        flush=True,
    )
    print(f"[0] nvidia-smi: {smi}", flush=True)
    return smi.splitlines()[0]


def phase1_statistics(size, card):
    """Extraction vs the oracle at the reference's shape, hybrid (masked and
    not, one offset and four) and exact; memory and warm time of the fused
    per-batch dispatch."""
    import jax

    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import _batch_fused_dispatch, extract_features
    from tpumcia.features.stats import rescale_lut_device

    n, k = size["p1_objects"], size["p1_oracle"]
    with Phase("1 statistics") as ph:
        imgs, _ = _signal_images(n, seed=1)
        boxes, mask = _boxes(n, 64, seed=1, margin=12)
        hybrid = FeatureConfig()
        cases = [
            ("hybrid", hybrid, None, None),
            ("hybrid masked", hybrid, mask, boxes),
            ("hybrid 4-offset", FeatureConfig(
                glcm=GLCMConfig(distance=(1, 5), angle=(0.0, np.pi / 2))
            ), None, None),
        ]
        for label, cfg, m, bx in cases:
            fm = extract_features(imgs, mask=m, config=cfg)
            if fm.shape != (n, len(fm.names)):
                raise AssertionError(f"{label}: shape {fm.shape}")
            ref = _oracle_rows(
                imgs[:k], fm.names, cfg, None if bx is None else bx[:k]
            )
            err = _abs_errors(fm.values[:k], ref)
            ph.check(f"{label} max", err.max(), HYBRID_MAX_ABS)
            ph.check(f"{label} mae", err.mean(), HYBRID_MAE)
        exact = FeatureConfig(precision="exact")
        fm = extract_features(imgs[:k], config=exact)
        err = _abs_errors(fm.values, _oracle_rows(imgs[:k], fm.names, exact))
        ph.check("exact max", err.max(), EXACT_MAX_ABS)

        # the fused per-batch dispatch at its production batch shape
        x = jax.device_put(imgs)
        lut = rescale_lut_device(256)
        kw = dict(levels=256, offset=(0, 5), keep_device=True,
                  chunk_size=hybrid.chunk_size,
                  onehot_dtype=hybrid.onehot_dtype)
        mem = _batch_fused_dispatch.lower(
            x, None, None, lut, **kw
        ).compile().memory_analysis()
        mb = lambda v: f"{v / 2**20:.1f} MB"
        ph.note(
            f"fused dispatch B={n} memory: args "
            f"{mb(mem.argument_size_in_bytes)}, out "
            f"{mb(mem.output_size_in_bytes)}, temp "
            f"{mb(mem.temp_size_in_bytes)}"
        )
        jax.block_until_ready(_batch_fused_dispatch(x, None, None, lut, **kw))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = _batch_fused_dispatch(x, None, None, lut, **kw)
        jax.block_until_ready(out)
        per = (time.perf_counter() - t0) / (reps * n)
        ph.note(
            f"fused dispatch warm {per * 1e6:.2f} us/object "
            f"(chip_smoke reading, {card})"
        )


def _phase2_config(fast_path, images):
    from tpumcia.config import (
        HeadConfig, MeshConfig, PipelineConfig, SplitConfig, SynthConfig,
    )

    # bench.py's workload: 12k 64x64 images, 2 synthesized noise channels
    # (69 features), the logistic head, permutation channel importance
    return PipelineConfig(
        mesh=MeshConfig(data=1, model=1),
        synth=SynthConfig(noise_channels=2, seed=0),
        head=HeadConfig(kind="logistic", num_steps=300),
        split=SplitConfig(test_size=0.25, seed=0, stratify=True),
        fast_path=fast_path,
        batch_size=min(2048, images),
    )


def phase2_data(size):
    from tpumcia.io.synthetic import synthetic_mednist

    n = size["p2_images"]
    gray, labels, _ = synthetic_mednist(max(n // 6, 1), num_classes=6, seed=0)
    return gray[:n], labels[:n]


def phase2_accuracy(size):
    """Test accuracy of phase 2's fused run (the number recorded as
    ``cpu_accuracy`` when run on the CPU backend)."""
    from tpumcia.pipeline.run import run_pipeline

    gray, labels = phase2_data(size)
    cfg = _phase2_config("always", len(gray))
    return run_pipeline(gray, labels, config=cfg).test_accuracy


def phase2_main_path(size):
    """run_pipeline from host numpy: fused vs classic path, ranking,
    accuracy against the CPU run, and a HIGHEST-precision rerun. -> result
    of the fused run (phase 6 reuses its features and split)."""
    import jax

    from tpumcia.pipeline.run import run_pipeline

    with Phase("2 main path") as ph:
        gray, labels = phase2_data(size)
        fused = run_pipeline(
            gray, labels, config=_phase2_config("always", len(gray))
        )
        chan = fused.channel_result.total
        feat = np.array([
            fused.feature_result.feature_importances[cols].sum()
            for cols in fused.features.channel_columns()
        ])
        ph.require("signal channel first by channel total",
                   int(np.argmax(chan)) == 0)
        ph.require("signal channel first by per-feature sum",
                   int(np.argmax(feat)) == 0)
        if fused.features.shape != (len(gray), 69):
            raise AssertionError(f"feature shape {fused.features.shape}")
        ph.note(f"accuracy {fused.test_accuracy:.4f}")
        ph.check("|accuracy - CPU run|",
                 abs(fused.test_accuracy - size["cpu_accuracy"]),
                 ACCURACY_TOL)

        classic = run_pipeline(
            gray, labels, config=_phase2_config("never", len(gray))
        )
        ph.check("classic vs fused ranking breaks",
                 _ranking_breaks(chan, classic.channel_result.total), 0)
        rel, int_diff = _feature_parity(
            fused.features.values, classic.features.values,
            fused.features.names,
        )
        ph.check("classic vs fused integer-derived diffs", int_diff, 0)
        ph.check("classic vs fused f32-field rel", rel, F32_FIELD_RTOL)

        with jax.default_matmul_precision("highest"):
            hi = run_pipeline(
                gray, labels, config=_phase2_config("always", len(gray))
            )
        ph.note(
            "max |channel importance(default) - (highest)| "
            f"{np.abs(hi.channel_result.total - chan).max():.4g}"
        )
        ph.check("highest-precision ranking breaks",
                 _ranking_breaks(chan, hi.channel_result.total), 0)
    return fused, labels


def phase3_cytometry(size):
    """12-channel uint16 masked objects with donors: quantize, run the
    pipeline with a donor-grouped split, compare objects with the oracle."""
    import jax

    from tpumcia.config import (
        HeadConfig, MeshConfig, PipelineConfig, SplitConfig,
    )
    from tpumcia.pipeline.run import run_pipeline
    from tpumcia.preprocess.normalize import quantize_to_levels

    n, k = size["p3_objects"], size["p3_oracle"]
    with Phase("3 cytometry") as ph:
        rng = np.random.default_rng(3)
        labels = (np.arange(n) % 3).astype(np.int32)
        donors = np.array([f"D{d}" for d in rng.integers(0, 8, n)])
        imgs = rng.integers(0, 4096, (n, 64, 64, 12), dtype=np.uint16)
        imgs[..., 4] = imgs[..., 4] // 4 + labels[:, None, None] * 15000
        boxes, mask = _boxes(n, 64, seed=3, margin=12)

        q = quantize_to_levels(
            jax.device_put(imgs), levels=256, src_levels=65536
        )
        cfg = PipelineConfig(
            mesh=MeshConfig(data=1, model=1),
            head=HeadConfig(kind="logistic", num_steps=300),
            split=SplitConfig(group_by="donor"),
        )
        res = run_pipeline(q, labels, mask=mask, groups=donors, config=cfg)
        tr, te = set(donors[res.train_idx]), set(donors[res.test_idx])
        ph.require("train/test donor sets disjoint", not (tr & te))
        fm = res.features
        ref = _oracle_rows(
            np.asarray(q[:k]), fm.names, fm.config, boxes[:k]
        )
        err = _abs_errors(fm.values[:k], ref)
        ph.check("oracle max", err.max(), HYBRID_MAX_ABS)
        ph.check("oracle mae", err.mean(), HYBRID_MAE)
        ph.note(
            f"accuracy {res.test_accuracy:.4f}, top channel "
            f"Ch{res.channel_result.top_channel() + 1} (signal on Ch5)"
        )


def phase4_streaming(size, out_dir):
    """stream_extract over an in-memory fetch: resume recomputes nothing and
    the matrix equals the batched API on the same objects."""
    from tpumcia.features.extract import extract_features_batched
    from tpumcia.pipeline.streaming import stream_extract

    shard = size["p4_shard_size"]
    n = size["p4_shards"] * shard
    with Phase("4 streaming") as ph:
        rng = np.random.default_rng(4)
        imgs = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
        labels = np.arange(n) % 4

        def fetch(idx):
            return imgs[idx], None, labels[idx]

        out = Path(out_dir) / "stream"
        shutil.rmtree(out, ignore_errors=True)
        first = stream_extract(fetch, n, out, shard_size=shard)
        again = stream_extract(fetch, n, out, shard_size=shard)
        ph.require(f"first call computed {first.shards_computed} shards",
                   first.shards_computed == size["p4_shards"])
        ph.require("second call recomputed none",
                   again.shards_computed == 0
                   and again.shards_skipped == size["p4_shards"])
        ref = extract_features_batched(imgs, batch_size=shard)
        diff = np.sum(_abs_errors(again.features.values, ref.values) > 0)
        ph.check("entries differing from extract_features_batched", diff, 0)
        ph.note(f"stream profile {first.profile}")


def _cross_entropy(head, x, labels):
    p = np.asarray(head.predict_proba(x), np.float64)
    idx = np.searchsorted(head.classes, labels)
    return float(-np.mean(np.log(np.maximum(p[np.arange(len(idx)), idx], 1e-30))))


def phase5_cnn(size):
    """fit_cnn for one epoch + occlusion channel ranking (needs flax)."""
    try:
        import flax  # noqa: F401
    except ImportError as e:
        print(f"[5 cnn] NOT RUN: flax is not installed ({e})", flush=True)
        return
    from tpumcia.importance.occlusion import channel_occlusion_importance
    from tpumcia.models.train import CNNConfig, fit_cnn

    n = size["p5_images"]
    with Phase("5 cnn") as ph:
        imgs, labels = _signal_images(n, seed=5)
        x = imgs.astype(np.float32) / 255.0
        cfg = dict(num_classes=6, depth="18", width=size["p5_width"],
                   batch_size=size["p5_batch"], seed=0)
        init = fit_cnn(x, labels, config=CNNConfig(epochs=0, **cfg))
        head = fit_cnn(x, labels, config=CNNConfig(epochs=1, **cfg))
        before = _cross_entropy(init, x, labels)
        after = _cross_entropy(head, x, labels)
        loss = head.history[0]["loss"]
        ph.require(f"epoch loss {loss:.4f} finite", math.isfinite(loss))
        ph.require(
            f"loss decreased {before:.4f} -> {after:.4f}", after < before
        )
        occ = channel_occlusion_importance(head, x, labels)
        ph.require(f"occlusion puts signal first {np.round(occ, 4)}",
                   int(np.argmax(occ)) == 0)


def phase6_forest(size, fused, labels):
    """RF head: device-forest predictions equal sklearn's; the permutation
    sweep runs through it (needs sklearn)."""
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        print(f"[6 forest] NOT RUN: scikit-learn is not installed ({e})",
              flush=True)
        return
    from tpumcia.config import HeadConfig, ImportanceConfig
    from tpumcia.importance.channels import channel_importance
    from tpumcia.models.heads import fit_head

    with Phase("6 forest") as ph:
        X = np.nan_to_num(np.asarray(fused.features.values, np.float32))
        tr, te = fused.train_idx, fused.test_idx
        head = fit_head(
            X[tr], labels[tr],
            config=HeadConfig(kind="random_forest",
                              n_estimators=size["rf_trees"]),
        )
        dev = head.to_device()
        diff = int(np.sum(dev.predict(X[te]) != head.predict(X[te])))
        ph.check("device-forest vs sklearn differing predictions", diff, 0)
        res = channel_importance(
            head, fused.features, labels, method="permutation",
            config=ImportanceConfig(n_repeats=10),
            eval_features=X[te], eval_labels=labels[te],
        )
        ph.require(f"signal channel first {np.round(res.total, 4)}",
                   int(np.argmax(res.total)) == 0)


def phase7_gpu_tests():
    """The repo's gpu-marked tests, in this process."""
    import pytest

    os.environ["TPUMCIA_TEST_BACKEND"] = "native"
    with Phase("7 gpu tests") as ph:
        rc = pytest.main([
            "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
            str(REPO / "tests"),
        ])
        ph.check("pytest -m gpu exit code", int(rc), 0)


def four_card(size, devices, out_dir):
    """The sharded path on four devices against the single-device path."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tpumcia.config import MeshConfig
    from tpumcia.features.extract import extract_features_batched
    from tpumcia.importance.permutation import permutation_importance
    from tpumcia.models.scaler import MinMaxScaler
    from tpumcia.parallel.mesh import make_mesh
    from tpumcia.parallel.sharding import (
        fit_scaler_sharded,
        permutation_importance_sharded,
    )
    from tpumcia.pipeline.run import run_pipeline
    from tpumcia.pipeline.streaming import stream_extract

    mesh = make_mesh(data=4, devices=devices)
    with Phase("four-card") as ph:
        gray, labels = phase2_data(size)
        one_cfg = _phase2_config("never", len(gray))
        one = run_pipeline(gray, labels, config=one_cfg)
        four = run_pipeline(gray, labels, config=dataclasses.replace(
            one_cfg, mesh=MeshConfig(data=4, model=1)
        ))
        rel, int_diff = _feature_parity(
            four.features.values, one.features.values, one.features.names
        )
        ph.check("pipeline data=4 vs 1 integer-derived diffs", int_diff, 0)
        ph.check("pipeline data=4 vs 1 f32-field rel", rel, F32_FIELD_RTOL)
        ph.check("pipeline data=4 vs 1 |accuracy diff|",
                 abs(four.test_accuracy - one.test_accuracy), ACCURACY_TOL)
        ph.check("pipeline data=4 vs 1 ranking breaks",
                 _ranking_breaks(one.channel_result.total,
                                 four.channel_result.total), 0)

        X = np.nan_to_num(np.asarray(one.features.values, np.float32))
        X_tr, X_te = X[one.train_idx], X[one.test_idx]
        y_te = labels[one.test_idx]
        sc = fit_scaler_sharded(X_tr, mesh=mesh)
        ref = MinMaxScaler.fit(X_tr)
        ph.check("fit_scaler_sharded vs MinMaxScaler max |diff|", max(
            float(np.abs(np.asarray(sc.data_min) - np.asarray(ref.data_min)).max()),
            float(np.abs(np.asarray(sc.data_max) - np.asarray(ref.data_max)).max()),
        ), 0.0)

        groups = one.features.channel_columns()
        p4 = permutation_importance_sharded(
            one.head, X_te, y_te, mesh=mesh, groups=groups
        )
        p1 = permutation_importance(one.head, X_te, y_te, groups=groups)
        ph.check(
            "permutation sharded vs single max |diff| (x test rows)",
            np.abs(p4.importances - p1.importances).max() * len(y_te), 1.0,
        )

        shard = size["p4_shard_size"]
        n = 4 * shard
        rng = np.random.default_rng(4)
        imgs = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)

        def fetch(idx):
            return imgs[idx], None, None

        out = Path(out_dir)
        shutil.rmtree(out / "stream4", ignore_errors=True)
        st = stream_extract(fetch, n, out / "stream4", shard_size=shard,
                            mesh=mesh)
        ref = extract_features_batched(imgs, batch_size=shard)
        rel, int_diff = _feature_parity(
            st.features.values, ref.values, ref.names
        )
        ph.check("stream_extract(mesh) integer-derived diffs", int_diff, 0)
        ph.check("stream_extract(mesh) f32-field rel", rel, F32_FIELD_RTOL)

        try:
            import flax  # noqa: F401
        except ImportError as e:
            ph.note(f"CNN step NOT RUN: flax is not installed ({e})")
        else:
            from tpumcia.models.train import CNNConfig, fit_cnn

            b = size["p5_batch"]
            cimgs, clabels = _signal_images(b, seed=5)
            x = jnp.asarray(cimgs, jnp.float32) / 255.0
            cfg = CNNConfig(num_classes=6, depth="18",
                            width=size["p5_width"], batch_size=b, epochs=1)
            h1 = fit_cnn(x, clabels, config=cfg)
            h4 = fit_cnn(x, clabels, config=cfg, mesh=mesh)
            l1, l4 = h1.history[0]["loss"], h4.history[0]["loss"]
            ph.check("CNN step loss rel diff data=4 vs 1",
                     abs(l4 - l1) / abs(l1), 1e-2)
            z1 = np.asarray(h1.predict_logits(x), np.float64)
            z4 = np.asarray(jax.device_get(h4.predict_logits(x)), np.float64)
            ph.check("CNN logits after the step rel (Frobenius)",
                     np.linalg.norm(z4 - z1) / np.linalg.norm(z1), 5e-2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded path on four GPUs, nothing else")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "chip_smoke"),
                    help="directory for the streaming shards")
    args = ap.parse_args(argv)

    card = phase0_device(four=args.four)
    import jax

    size = SIZES["full"]
    if args.four:
        four_card(size, jax.devices()[:4], args.out)
        count = 4
    else:
        phase1_statistics(size, card)
        fused, labels = phase2_main_path(size)
        phase3_cytometry(size)
        phase4_streaming(size, args.out)
        phase5_cnn(size)
        phase6_forest(size, fused, labels)
        phase7_gpu_tests()
        count = len(jax.devices())
    print(result_line(jax.devices()[0], count), flush=True)


def result_line(device, count):
    """The last line of a passing run: exactly one JSON object."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count,
    }})


if __name__ == "__main__":
    main()
