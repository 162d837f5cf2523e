"""IO (h5 contract, folder index, prefetch) and streaming-pipeline tests."""

import numpy as np
import pytest

from tpumcia.io.h5 import ObjectBatch, load_objects, read_object, write_object
from tpumcia.io.loader import PrefetchLoader, batched_indices
from tpumcia.io.synthetic import synthetic_mednist, synthetic_multichannel
from tpumcia.pipeline.streaming import load_feature_shards, stream_extract


@pytest.fixture
def h5_objects(tmp_path, rng):
    paths = []
    for i in range(6):
        h = int(rng.integers(20, 40))
        w = int(rng.integers(20, 40))
        img = (rng.random((h, w, 3)) * 65535).astype(np.uint16)
        msk = (rng.random((h, w, 3)) > 0.4).astype(np.uint8)
        p = tmp_path / f"{1000 + i}.h5"
        write_object(
            p,
            img,
            mask=msk,
            label=["tcell", "bcell"][i % 2],
            donor=f"D{i % 3}",
            experiment="exp1",
            channels=["BF", "GFP", "DAPI"],
        )
        paths.append(p)
    return tmp_path, paths


def test_h5_round_trip(h5_objects):
    root, paths = h5_objects
    obj = read_object(paths[0])
    assert obj["image"].dtype == np.uint16
    assert obj["label"] in ("tcell", "bcell")
    assert obj["channels"] == ["BF", "GFP", "DAPI"]
    assert obj["id"] == "1000"


def test_h5_unicode_metadata_round_trip(tmp_path, rng):
    """Non-ASCII labels/donors/channel names must round trip — np.bytes_(str)
    ascii-encodes and crashed write_object (r5-close probe finding)."""
    from tpumcia.io.h5 import write_object

    for i, label in enumerate(["santé", "müde"]):
        write_object(
            tmp_path / f"obj{i}.h5",
            rng.integers(0, 65535, size=(16, 16, 2)).astype(np.uint16),
            label=label,
            donor="dønor-1",
            channels=["DAPI-α", "CD45_β"],
        )
    batch = load_objects(tmp_path)
    assert set(batch.labels) == {"santé", "müde"}
    assert batch.donors[0] == "dønor-1"
    assert batch.channels == ["DAPI-α", "CD45_β"]


def test_load_objects_standardises_shapes(h5_objects):
    root, paths = h5_objects
    batch = load_objects(root)
    assert isinstance(batch, ObjectBatch)
    assert len(batch) == 6
    B, H, W, C = batch.images.shape
    assert C == 3 and batch.masks.shape == batch.images.shape
    assert set(batch.labels) == {"tcell", "bcell"}
    assert batch.channels == ["BF", "GFP", "DAPI"]
    assert batch.ids[0] == "1000"

    fixed = load_objects(root, target_hw=(48, 48))
    assert fixed.images.shape[1:3] == (48, 48)


def test_load_objects_mixed_rank_masks(tmp_path, rng):
    """A collection mixing plain (h, w) masks with (h, w, 1) ones must load
    (rank normalised PER object, ADVICE r4), and a genuine channel-count
    mismatch must raise a clear error, not an opaque packer crash."""
    for i, mshape in enumerate([(18, 18), (18, 18, 1), (20, 16)]):
        img = (rng.random((*mshape[:2], 3)) * 65535).astype(np.uint16)
        msk = (rng.random(mshape) > 0.5).astype(np.uint8)
        write_object(tmp_path / f"{i}.h5", img, mask=msk, label="x")
    batch = load_objects(tmp_path)
    assert batch.masks.shape == (3, 20, 18, 1)  # mixed ranks → (h, w, 1)

    bad = tmp_path / "bad"
    bad.mkdir()
    for i, c in enumerate([None, 3]):  # (h, w) vs (h, w, 3) masks
        img = (rng.random((18, 18, 3)) * 65535).astype(np.uint16)
        shape = (18, 18) if c is None else (18, 18, c)
        msk = (rng.random(shape) > 0.5).astype(np.uint8)
        write_object(bad / f"{i}.h5", img, mask=msk, label="x")
    with pytest.raises(ValueError, match="channel counts"):
        load_objects(bad)


def test_load_objects_missing_image_key(tmp_path):
    import h5py

    with h5py.File(tmp_path / "bad.h5", "w") as f:
        f.create_dataset("mask", data=np.zeros((4, 4, 1)))
    with pytest.raises(KeyError):
        load_objects(tmp_path)


def test_h5_to_features_end_to_end(h5_objects):
    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features
    from tpumcia.preprocess.normalize import quantize_to_levels

    root, _ = h5_objects
    batch = load_objects(root)
    levels = np.asarray(
        quantize_to_levels(batch.images, levels=256, src_levels=65536)
    )
    fm = extract_features(
        levels,
        mask=batch.masks,
        config=FeatureConfig(),
        channel_names=batch.channels,
    )
    assert fm.shape == (6, 69)
    assert fm.names[0] == "min_intensity_BF"
    assert np.isfinite(np.nan_to_num(np.asarray(fm.values))).all()


def test_folder_index(tmp_path, rng):
    import imageio.v3 as iio

    from tpumcia.io.mednist import index_image_folder, load_images

    for cls in ("abd", "cxr"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            arr = (rng.random((16, 16)) * 255).astype(np.uint8)
            iio.imwrite(tmp_path / cls / f"{i}.png", arr)
    idx = index_image_folder(tmp_path)
    assert idx.class_names == ["abd", "cxr"]
    assert len(idx) == 6
    np.testing.assert_array_equal(np.unique(idx.labels), [0, 1])
    imgs = load_images(idx.files)
    assert imgs.shape == (6, 16, 16)


def test_prefetch_loader_order_and_errors():
    fetched = []

    def fetch(idx):
        fetched.append(idx[0])
        return idx * 2

    out = list(PrefetchLoader(fetch, 10, 3))
    np.testing.assert_array_equal(np.concatenate(out), np.arange(10) * 2)
    assert len(out) == 4

    def bad_fetch(idx):
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(PrefetchLoader(bad_fetch, 4, 2))

    assert [len(c) for c in batched_indices(10, 4, drop_remainder=True)] == [4, 4]


def test_stream_extract_rejects_float_images(tmp_path):
    """The streaming WIRE mode must raise the same TypeError as
    extract_features on float batches — the fused dispatch would otherwise
    silently astype-truncate [0,1] floats to all-zero levels and persist
    garbage shards marked 'done'."""
    from tpumcia.config import FeatureConfig

    images, labels, _ = synthetic_multichannel(4, num_classes=3, seed=2)
    flo = images.astype(np.float32) / 255.0

    def fetch(idx):
        return flo[idx], None, labels[idx]

    with pytest.raises(TypeError, match="integer level"):
        stream_extract(
            fetch, len(flo), tmp_path / "f", shard_size=6,
            config=FeatureConfig(),  # hybrid default -> wire mode
        )


def test_stream_extract_resume(tmp_path):
    from tpumcia.config import FeatureConfig

    images, labels, _ = synthetic_multichannel(4, num_classes=3, seed=2)
    calls = []

    def fetch(idx):
        calls.append(tuple(idx))
        return images[idx], None, labels[idx]

    cfg = FeatureConfig()
    out = tmp_path / "features"
    res1 = stream_extract(fetch, len(images), out, shard_size=5, config=cfg)
    assert res1.shards_computed == 3 and res1.shards_skipped == 0
    assert res1.features.shape == (12, 69)
    np.testing.assert_array_equal(res1.labels, labels)

    # resume: nothing recomputed
    n_calls = len(calls)
    res2 = stream_extract(fetch, len(images), out, shard_size=5, config=cfg)
    assert res2.shards_computed == 0 and res2.shards_skipped == 3
    assert len(calls) == n_calls
    np.testing.assert_array_equal(
        np.asarray(res2.features.values), np.asarray(res1.features.values)
    )

    # partial failure: delete one shard -> only that one recomputed
    (out / "shard_000000005.npz").unlink()
    import json

    m = json.loads((out / "manifest.json").read_text())
    res3 = stream_extract(fetch, len(images), out, shard_size=5, config=cfg)
    assert res3.shards_computed == 1 and res3.shards_skipped == 2

    fm, lab = load_feature_shards(out)
    assert fm.shape == (12, 69)


def test_stream_manifest_o1_appends_and_compaction(tmp_path, monkeypatch):
    """Per-shard manifest updates must be O(1) appends (manifest.jsonl), with
    ONE full-JSON write per run (the completion compaction) — the per-shard
    full rewrite was O(S^2) cumulative host I/O at streaming scale
    (VERDICT r4 #6)."""
    import tpumcia.pipeline.streaming as streaming
    from tpumcia.config import FeatureConfig

    images, labels, _ = synthetic_multichannel(4, num_classes=3, seed=2)

    def fetch(idx):
        return images[idx], None, labels[idx]

    saves = []
    real_save = streaming._save_manifest
    monkeypatch.setattr(
        streaming, "_save_manifest",
        lambda *a, **k: (saves.append(1), real_save(*a, **k)),
    )
    out = tmp_path / "f"
    cfg = FeatureConfig()
    res = stream_extract(fetch, len(images), out, shard_size=5, config=cfg)
    assert res.shards_computed == 3
    assert len(saves) == 1  # compaction only — independent of shard count
    assert (out / "manifest.json").exists()
    assert not (out / "manifest.jsonl").exists()  # compacted away
    fm, _ = load_feature_shards(out)
    assert fm.shape == (12, 69)


def test_stream_resume_from_interrupted_jsonl_and_mixed_dirs(tmp_path):
    """An interrupted run leaves manifest.jsonl (no compaction); resume must
    honor it — including alongside a legacy manifest.json from an older run
    (mixed dir) and with a torn final line from a mid-append crash."""
    import json

    from tpumcia.config import FeatureConfig

    images, labels, _ = synthetic_multichannel(4, num_classes=3, seed=2)
    calls = []

    def fetch(idx):
        calls.append(tuple(idx))
        return images[idx], None, labels[idx]

    def fetch_crash_after_2(idx):
        if len(calls) >= 2:
            raise RuntimeError("simulated mid-run crash")
        return fetch(idx)

    cfg = FeatureConfig()
    out = tmp_path / "f"
    with pytest.raises(RuntimeError, match="simulated"):
        stream_extract(
            fetch_crash_after_2, len(images), out, shard_size=5, config=cfg,
            prefetch_depth=0, stage_on_device=False,
        )
    jl = out / "manifest.jsonl"
    assert jl.exists() and not (out / "manifest.json").exists()
    done_lines = [l for l in jl.read_text().splitlines() if '"sid"' in l]
    assert len(done_lines) >= 1

    # mixed dir: move the first completed shard's entry into a LEGACY json
    # (as if an old-format run produced it), leave the rest in the jsonl,
    # and append a torn partial line (crash mid-append)
    recs = [json.loads(l) for l in done_lines]
    legacy = {
        "version": 1,
        "config_tag": "default",
        "shards": {recs[0].pop("sid"): recs[0]},
    }
    (out / "manifest.json").write_text(json.dumps(legacy))
    lines = [
        l for l in jl.read_text().splitlines()
        if json.loads(l).get("sid") != list(legacy["shards"])[0]
        if l.strip()
    ]
    jl.write_text("\n".join(lines) + "\n" + '{"sid": "shard_0000')  # torn

    calls.clear()
    res = stream_extract(fetch, len(images), out, shard_size=5, config=cfg)
    assert res.shards_computed + res.shards_skipped == 3
    assert res.shards_skipped >= 1  # jsonl/legacy entries were honored
    assert res.features.shape == (12, 69)
    np.testing.assert_array_equal(res.labels, labels)
    # completion compacted everything into the legacy json
    assert not jl.exists()
    m = json.loads((out / "manifest.json").read_text())
    assert len(m["shards"]) == 3


def test_stream_extract_device_staging_parity(tmp_path):
    """stage_on_device moves the H2D upload onto the prefetch worker; results
    must be identical with it on (default) and off."""
    from tpumcia.config import FeatureConfig

    images, labels, _ = synthetic_multichannel(4, num_classes=3, seed=5)

    def fetch(idx):
        return images[idx], None, labels[idx]

    cfg = FeatureConfig()
    res_on = stream_extract(
        fetch, len(images), tmp_path / "on", shard_size=5, config=cfg
    )
    res_off = stream_extract(
        fetch, len(images), tmp_path / "off", shard_size=5, config=cfg,
        stage_on_device=False,
    )
    np.testing.assert_array_equal(
        np.asarray(res_on.features.values), np.asarray(res_off.features.values)
    )
    np.testing.assert_array_equal(res_on.labels, res_off.labels)


def test_stream_extract_h5_directory(h5_objects, tmp_path):
    """h5-dir -> streaming composition: prefetch-overlapped shards, resume,
    quantised uint16, labels and masks threaded through (VERDICT r1 next #5)."""
    from tpumcia.config import FeatureConfig
    from tpumcia.io.h5 import h5_stream_source
    from tpumcia.pipeline.streaming import stream_extract_h5

    root, paths = h5_objects
    cfg = FeatureConfig()
    out = tmp_path / "h5feats"
    res = stream_extract_h5(root, out, shard_size=4, config=cfg)
    assert res.shards_computed == 2
    assert res.features.shape == (6, 69)
    assert set(res.labels) == {"tcell", "bcell"}
    assert np.isfinite(np.nan_to_num(res.features.to_numpy())).all()

    # resume is free
    res2 = stream_extract_h5(root, out, shard_size=4, config=cfg)
    assert res2.shards_computed == 0 and res2.shards_skipped == 2

    # the adapter's batch matches load_objects + quantize (same packing)
    src = h5_stream_source(root)
    images, masks, labels = src.fetch(np.arange(6))
    batch = load_objects(root)
    from tpumcia.preprocess.normalize import quantize_to_levels

    expect = np.asarray(
        quantize_to_levels(batch.images, levels=256, src_levels=65536)
    )
    np.testing.assert_array_equal(images, expect)
    np.testing.assert_array_equal(masks, batch.masks)
    np.testing.assert_array_equal(labels, batch.labels)
    assert src.channels == ["BF", "GFP", "DAPI"]


def test_stream_config_tag_guard(tmp_path):
    images, labels, _ = synthetic_multichannel(2, num_classes=2, seed=0)

    def fetch(idx):
        return images[idx], None, labels[idx]

    from tpumcia.config import FeatureConfig

    cfg = FeatureConfig()
    stream_extract(fetch, 4, tmp_path / "f", shard_size=4, config=cfg, config_tag="a")
    with pytest.raises(ValueError, match="config_tag"):
        stream_extract(
            fetch, 4, tmp_path / "f", shard_size=4, config=cfg, config_tag="b"
        )


@pytest.mark.slow
def test_run_pipeline_smoke():
    from tpumcia.config import FeatureConfig, HeadConfig, ImportanceConfig, PipelineConfig
    from tpumcia.pipeline.run import run_pipeline

    images, labels, _ = synthetic_multichannel(12, num_classes=3, seed=4)
    cfg = PipelineConfig(
        features=FeatureConfig(),
        head=HeadConfig(kind="logistic", num_steps=300),
        importance=ImportanceConfig(n_repeats=4),
    )
    res = run_pipeline(images, labels, config=cfg)
    assert res.test_accuracy > 0.5
    assert res.channel_result.top_channel() == 0
    assert "precision" in res.report
    assert res.timings["features_s"] > 0


def test_size_parameters_validated_at_entries():
    """batch_size/shard_size/levels <= 0 used to surface as
    ZeroDivisionError / 'need at least one array to concatenate' /
    silent -1 levels (r5-close probe findings)."""
    import pytest

    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features_batched
    from tpumcia.preprocess.normalize import quantize_to_levels

    images, _, _ = synthetic_multichannel(4, num_classes=2, seed=1)
    for bs in (0, -4):
        with pytest.raises(ValueError, match="batch_size must be >= 1"):
            extract_features_batched(
                images, batch_size=bs, config=FeatureConfig()
            )
    with pytest.raises(ValueError, match="shard_size must be >= 1"):
        stream_extract(
            lambda idx: (images[idx], None, None), 4, "/tmp/unused",
            shard_size=0, config=FeatureConfig(),
        )
    with pytest.raises(ValueError, match="levels must be >= 1"):
        quantize_to_levels(np.zeros((2, 4, 4, 1), np.float32), levels=0)


def test_run_pipeline_channel_method_selectable():
    """ImportanceConfig.channel_method routes run_pipeline's channel scoring
    ('ablation' here; 'permutation' is the reference default, ipynb:458-462).
    Unknown methods surface channel_importance's named error."""
    import pytest

    from tpumcia.pipeline.run import run_pipeline

    images, labels, _ = synthetic_multichannel(12, num_classes=3, seed=4)
    cfg = {
        "head": {"kind": "logistic", "num_steps": 300},
        "importance": {"n_repeats": 2, "channel_method": "ablation"},
    }
    res = run_pipeline(images, labels, config=cfg)
    assert res.channel_result.method == "ablation"
    assert res.channel_result.top_channel() == 0

    bad = dict(cfg, importance={"channel_method": "shapley"})
    with pytest.raises(ValueError, match="unknown method 'shapley'"):
        run_pipeline(images, labels, config=bad)


def test_run_pipeline_validates_shapes_up_front():
    """Rank/length mismatches must raise named errors at the entry point,
    not opaque transpose/index errors deep in the sharded extraction or
    the split (r5-close probe findings)."""
    import pytest

    from tpumcia.pipeline.run import run_pipeline

    images, labels, _ = synthetic_multichannel(12, num_classes=2, seed=4)

    with pytest.raises(ValueError, match=r"expects \(B, H, W, C\)"):
        run_pipeline(images[..., 0], labels)  # 3-D without synth
    with pytest.raises(ValueError, match="at least one image"):
        run_pipeline(images[:0], labels[:0])
    with pytest.raises(ValueError, match="labels length 9 does not match"):
        run_pipeline(images, labels[:9])
    with pytest.raises(ValueError, match="groups length 5 does not match"):
        run_pipeline(
            images,
            labels,
            config={"split": {"group_by": "donor"}},
            groups=np.arange(5),
        )


def test_stream_extract_rejects_empty_collection(tmp_path):
    """n=0 must fail at the entry, not with FileNotFoundError at assembly
    (r5-close probe finding)."""

    def fetch(idx):  # pragma: no cover - must never be called
        raise AssertionError("fetch called for an empty collection")

    with pytest.raises(ValueError, match="n >= 1"):
        stream_extract(fetch, 0, tmp_path, shard_size=8)


def test_stream_partial_final_shard_matches_direct(tmp_path):
    """The wire mode pads a partial final shard to the fixed shard shape
    (one compiled dispatch shape) and trims the pad rows — values must
    match direct extraction exactly, including the last shard."""
    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features

    images, labels, _ = synthetic_multichannel(4, num_classes=3, seed=7)
    assert len(images) % 5 != 0  # 12 images -> shards of 5, 5, 2

    def fetch(idx):
        return images[idx], None, labels[idx]

    cfg = FeatureConfig()
    res = stream_extract(
        fetch, len(images), tmp_path / "s", shard_size=5, config=cfg
    )
    direct = extract_features(images, config=cfg)
    np.testing.assert_allclose(
        np.asarray(res.features.values), np.asarray(direct.values),
        rtol=1e-6, atol=1e-9,
    )
    np.testing.assert_array_equal(res.labels, labels)


def test_stream_extract_explicit_process_split(tmp_path):
    """Launcher-managed per-process feed without jax.distributed: two
    sequential calls with explicit (process_index, process_count) each own
    a disjoint round-robin half of the shards and fetch ONLY their own
    index ranges; the merged per-process manifests assemble to the full
    matrix and a later resume (any process count) recomputes nothing."""
    from tpumcia.config import FeatureConfig
    from tpumcia.features.extract import extract_features

    images, labels, _ = synthetic_multichannel(5, num_classes=3, seed=3)
    # 15 images, shard_size 4 -> shards [0:4][4:8][8:12][12:15]
    fetched: dict[int, list] = {0: [], 1: []}

    def fetch_for(pid):
        def fetch(idx):
            fetched[pid].extend(int(i) for i in idx)
            return images[idx], None, labels[idx]

        return fetch

    cfg = FeatureConfig()
    out = tmp_path / "split"
    # sequential driver: process 0 runs first, so it must opt out of the
    # all-shards barrier (its assembly is knowingly partial); process 1,
    # running last, keeps the default barrier and sees everything done
    res0 = stream_extract(
        fetch_for(0), len(images), out, shard_size=4, config=cfg,
        process_index=0, process_count=2, barrier_timeout_s=0,
    )
    res1 = stream_extract(
        fetch_for(1), len(images), out, shard_size=4, config=cfg,
        process_index=1, process_count=2,
    )
    assert res0.shards_computed == 2 and res1.shards_computed == 2
    assert res0.profile["process_count"] == 2
    # round-robin ownership: p0 owns shards 0,2; p1 owns 1,3
    assert sorted(fetched[0]) == list(range(0, 4)) + list(range(8, 12))
    assert sorted(fetched[1]) == list(range(4, 8)) + list(range(12, 15))

    fm, lab = load_feature_shards(out)
    direct = extract_features(images, config=cfg)
    assert fm.names == direct.names
    np.testing.assert_allclose(
        np.asarray(fm.values), np.asarray(direct.values), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_array_equal(lab, labels)
    # p1's own assembly (all shards present by then) is already complete
    np.testing.assert_allclose(
        np.asarray(res1.features.values), np.asarray(direct.values),
        rtol=1e-6, atol=1e-9,
    )

    # resume at a different process count: everything skipped, names intact
    res_resume = stream_extract(
        fetch_for(0), len(images), out, shard_size=4, config=cfg,
        process_index=0, process_count=1,
    )
    assert res_resume.shards_computed == 0 and res_resume.shards_skipped == 4
    assert res_resume.features.names == direct.names


def test_stream_extract_explicit_split_barrier_raises_on_missing_shards(
    tmp_path,
):
    """Under an explicit launcher split the default assembly barrier polls
    the shared manifest for the FULL shard space and raises on timeout —
    a process must never silently return a partial matrix because a
    sibling crashed or lagged."""
    from tpumcia.config import FeatureConfig

    images, labels, _ = synthetic_multichannel(3, num_classes=3, seed=1)

    def fetch(idx):
        return images[idx], None, labels[idx]

    cfg = FeatureConfig()
    with pytest.raises(RuntimeError, match="barrier timed out"):
        stream_extract(
            fetch, len(images), tmp_path / "lone", shard_size=4, config=cfg,
            process_index=0, process_count=2, barrier_timeout_s=0.2,
        )


def test_load_feature_shards_carries_config_grouping(tmp_path):
    """The reassembled FeatureMatrix must carry the extraction config:
    channel_columns() grouping depends on it, so a default config against
    multi-offset shards would silently misgroup the per-channel blocks
    (biased importance sweeps, no error)."""
    from tpumcia.config import FeatureConfig, GLCMConfig
    from tpumcia.features.extract import extract_features

    images, labels, _ = synthetic_multichannel(3, num_classes=2, seed=2)
    cfg = FeatureConfig(glcm=GLCMConfig(distance=(1, 5)))

    def fetch(idx):
        return images[idx], None, labels[idx]

    out = tmp_path / "multioffset"
    stream_extract(fetch, len(images), out, shard_size=4, config=cfg)
    fm, _lab = load_feature_shards(out, config=cfg)
    direct = extract_features(images, config=cfg)
    assert fm.names == direct.names
    assert fm.channel_columns() == direct.channel_columns()
    # the r4 defect: a default-config load misgroups multi-offset columns
    fm_default, _ = load_feature_shards(out)
    assert fm_default.channel_columns() != direct.channel_columns()


def test_stream_extract_rejects_inconsistent_process_topology(tmp_path):
    """Explicit process_count>1 without an index would make every process
    own index 0's shards (racing writes, missing rows); an explicit split
    under a cross-process mesh would issue collectives over different shard
    lists per process. Both must raise, as must an index without a count."""
    from tpumcia.config import FeatureConfig
    from tpumcia.parallel.mesh import make_mesh

    images, labels, _ = synthetic_multichannel(2, num_classes=2, seed=0)

    def fetch(idx):
        return images[idx], None, labels[idx]

    cfg = FeatureConfig()
    with pytest.raises(ValueError, match="process_index"):
        stream_extract(
            fetch, len(images), tmp_path / "a", config=cfg, process_count=2
        )
    with pytest.raises(ValueError, match="process_count"):
        stream_extract(
            fetch, len(images), tmp_path / "b", config=cfg, process_index=1
        )
    with pytest.raises(ValueError, match="mutually exclusive"):
        stream_extract(
            fetch, len(images), tmp_path / "c", config=cfg,
            process_index=0, process_count=2, mesh=make_mesh(),
        )


def test_h5_stream_uint8_quantize_and_mixed_mask_guard(tmp_path, rng):
    """r4 regressions: (a) uint8 h5 sources must be quantized to the target
    level count like uint16 ones (raw 0..255 values silently corrupted
    < 256-level configs); (b) collections mixing masked and mask-less
    objects must raise, not silently mix feature semantics."""
    from tpumcia.io.h5 import h5_stream_source, write_object

    d = tmp_path / "u8"
    d.mkdir()
    for i in range(4):
        img = (rng.random((12, 12, 2)) * 255).astype(np.uint8)
        write_object(d / f"{i}.h5", img, label="x")
    src = h5_stream_source(d, quantize_levels=64)
    images, masks, labels = src.fetch(np.arange(4))
    assert images.max() < 64, images.max()

    m = tmp_path / "mixed"
    m.mkdir()
    for i in range(4):
        img = (rng.random((12, 12, 2)) * 255).astype(np.uint8)
        msk = (rng.random((12, 12, 2)) > 0.5).astype(np.uint8) if i < 2 else None
        write_object(m / f"{i}.h5", img, mask=msk, label="x")
    src2 = h5_stream_source(m)
    with pytest.raises(ValueError, match="mix"):
        src2.fetch(np.arange(4))

    with pytest.raises(ValueError, match="no h5 object files"):
        h5_stream_source([])


def test_h5_stream_channel_names_reach_feature_columns(h5_objects, tmp_path):
    """The h5 contract's 'channels' key (README.md:13) must name the
    streamed feature columns, matching the non-streaming load_objects path."""
    from tpumcia.pipeline.streaming import stream_extract_h5
    from tpumcia.config import FeatureConfig

    paths, _tmp = h5_objects
    res = stream_extract_h5(
        paths, tmp_path / "feat", shard_size=4,
        config=FeatureConfig(),
    )
    assert any("BF" in n for n in res.features.names), res.features.names[:3]


def test_prefetch_loader_early_stop_releases_workers():
    """r4 regression: breaking out of a PrefetchLoader iteration left the
    worker threads blocked forever on the bounded queue (holding decoded
    batches); cancellation must let them drain."""
    import threading
    import time

    from tpumcia.io.loader import PrefetchLoader

    before = threading.active_count()

    def fetch(idx):
        return np.zeros((len(idx), 4), np.float32)

    for _ in range(5):
        it = iter(PrefetchLoader(fetch, 1000, 10, depth=2))
        next(it)
        it.close()  # consumer stops early

    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before + 1, threading.active_count()


def test_stratified_split_keeps_tiny_classes_in_train():
    """r4 regression: a 1-2 sample class could be assigned entirely to the
    test split, so training never saw the class at all."""
    from tpumcia.utils.split import train_test_split_indices

    y = np.array([0] * 10 + [1] * 2 + [2] * 1)
    s = train_test_split_indices(len(y), test_size=0.5, seed=0, stratify=y)
    for cls in (0, 1, 2):
        assert (y[s.train_idx] == cls).sum() >= 1, cls


def test_head_checkpoint_round_trips_config(tmp_path):
    """r4 regression: logistic/MLP npz checkpoints dropped the HeadConfig
    (load silently substituted defaults); the forest head kept its config —
    the three families must round-trip symmetrically."""
    from tpumcia.config import HeadConfig
    from tpumcia.models.heads import LogisticHead, MLPHead
    from tpumcia.models import fit_head

    rng = np.random.RandomState(0)
    X = rng.random((30, 5)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.int64)

    cfg = HeadConfig(kind="mlp", hidden=(8,), num_steps=40, learning_rate=0.02)
    head = fit_head(X, y, config=cfg)
    head.save(tmp_path / "mlp.npz")
    loaded = MLPHead.load(tmp_path / "mlp.npz")
    assert loaded.config == cfg

    cfg2 = HeadConfig(kind="logistic", num_steps=33, l2=0.01)
    head2 = fit_head(X, y, config=cfg2)
    head2.save(tmp_path / "log.npz")
    assert LogisticHead.load(tmp_path / "log.npz").config == cfg2
