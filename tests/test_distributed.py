"""Multi-process (multi-host analogue) initialization path.

Two CPU subprocesses form one JAX distributed runtime via a local
coordinator (`jax.distributed.initialize`), build a mesh spanning BOTH
processes' devices, assemble a global data-sharded array, and reduce
global per-feature min/max with collectives — the multi-host MinMaxScaler
fit (SURVEY.md §2.4/§5 "jax.distributed.initialize for multi-host").
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

from tpumcia.parallel.distributed import init_distributed, process_summary, shard_across_processes

multi = init_distributed(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
)
assert multi, "expected a 2-process runtime"

import jax
import jax.numpy as jnp

info = process_summary()
assert info["process_count"] == 2, info
assert info["global_devices"] == info["local_devices"] * 2, info

from tpumcia.parallel.mesh import make_mesh
mesh = make_mesh()  # spans the GLOBAL device list across both processes
assert mesh.shape["data"] == info["global_devices"], mesh.shape

# per-process local rows -> one global data-sharded matrix
rows_per_proc = mesh.shape["data"] // 2
local = (np.arange(rows_per_proc * 3, dtype=np.float32)
         .reshape(rows_per_proc, 3) + 100.0 * pid)
X = shard_across_processes(local, mesh)
assert X.shape == (rows_per_proc * 2, 3), X.shape

# global min/max via collectives over the cross-process mesh
from jax.sharding import PartitionSpec as P
from jax import shard_map

def local_minmax(xs):
    lo = jax.lax.pmin(jnp.min(xs, axis=0, keepdims=True), "data")
    hi = jax.lax.pmax(jnp.max(xs, axis=0, keepdims=True), "data")
    return lo, hi

lo, hi = jax.jit(shard_map(
    local_minmax, mesh=mesh, in_specs=(P("data"),), out_specs=(P(), P())
))(X)
# out_specs P() -> fully replicated: every process reads its local copy
lo = np.asarray(lo.addressable_shards[0].data)
hi = np.asarray(hi.addressable_shards[0].data)
expect_lo = np.array([0.0, 1.0, 2.0], np.float32)          # process 0 rows
expect_hi = expect_lo + 100.0 + 3.0 * (rows_per_proc - 1)  # process 1 rows
np.testing.assert_allclose(lo[0], expect_lo)
np.testing.assert_allclose(hi[0], expect_hi)
print(f"WORKER{pid}_OK")
"""


@pytest.mark.slow
def test_two_process_cpu_mesh(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["TPUMCIA_REEXECED"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER{pid}_OK" in out, out


def test_shard_across_processes_single_process():
    """Single-process fallback: device_put with a data sharding over the
    local mesh (covers the helper's non-distributed branch)."""
    import jax

    from tpumcia.parallel.distributed import (
        init_distributed,
        shard_across_processes,
    )
    from tpumcia.parallel.mesh import make_mesh

    assert init_distributed() is False  # no coordinator configured anywhere
    mesh = make_mesh()
    n = mesh.shape["data"]
    X = shard_across_processes(
        np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3), mesh
    )
    assert X.shape == (n * 4, 3)
    assert len(X.sharding.device_set) == n * mesh.shape["model"] or n == 1
    np.testing.assert_array_equal(
        np.asarray(X), np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3)
    )


def test_partial_topology_raises():
    """An explicit num_processes/process_id without a coordinator must raise
    instead of silently degrading to a single-process run (each worker would
    otherwise compute on 1/N of the data and report wrong results)."""
    from tpumcia.parallel.distributed import init_distributed

    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=4, process_id=0)
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(process_id=1)


_EXTRACT_WORKER = r"""
import sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

from tpumcia.parallel.distributed import init_distributed, shard_across_processes

assert init_distributed(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
)

import jax
from tpumcia.parallel.mesh import make_mesh

mesh = make_mesh()
n_data = mesh.shape["data"]

# both processes construct the identical full dataset deterministically;
# each contributes its half of the rows to the global sharded batch
rng = np.random.RandomState(0)
B = 2 * n_data  # divisible by the data axis: no cross-process padding
full = (rng.random((B, 16, 16, 3)) * 256).astype(np.uint8)
half = B // 2
X = shard_across_processes(full[pid * half:(pid + 1) * half], mesh)

from tpumcia.parallel.sharding import sufficient_stats_sharded

stats = sufficient_stats_sharded(X, mesh=mesh)

from jax.experimental.multihost_utils import process_allgather
from tpumcia.features.stats import SuffStats

gathered = SuffStats(*(
    None if s is None else np.asarray(process_allgather(s, tiled=True))
    for s in stats
))

from tpumcia.features.finalize import finalize_features

done = finalize_features(gathered, backend="host")

from tpumcia.reference_impl import oracle

ref = np.stack([oracle.feature_vector(im / 255.0) for im in full])
err = np.nanmax(np.abs(done.values - ref))
assert err < 1e-9, err
print(f"EXTRACT{pid}_OK")

# ---- scaler fit + permutation sweep SPMD across the same 2-process mesh ----
from tpumcia.parallel.sharding import (
    fit_scaler_sharded,
    permutation_importance_sharded,
)
from tpumcia.config import HeadConfig
from tpumcia.models import fit_head
from tpumcia.importance.permutation import permutation_importance

Xf = np.nan_to_num(done.values).astype(np.float32)
y = (np.arange(B) % 2).astype(np.int32)

scaler = fit_scaler_sharded(Xf, mesh=mesh)  # host input, identical per process
np.testing.assert_allclose(np.asarray(scaler.data_min), Xf.min(0), atol=1e-6)
np.testing.assert_allclose(np.asarray(scaler.data_max), Xf.max(0), atol=1e-6)

# committed LOCAL device input: must redistribute, not crash in the
# cross-process jit (and match the host-input fit exactly)
scaler_dev = fit_scaler_sharded(
    jax.device_put(Xf, jax.local_devices()[0]), mesh=mesh
)
np.testing.assert_array_equal(
    np.asarray(scaler_dev.data_min), np.asarray(scaler.data_min)
)
np.testing.assert_array_equal(
    np.asarray(scaler_dev.data_max), np.asarray(scaler.data_max)
)

Xs = np.asarray(scaler.transform(Xf))
head = fit_head(Xs, y, config=HeadConfig(kind="logistic", num_steps=50))
single = permutation_importance(head, Xs, y, n_repeats=3, seed=42)
sharded = permutation_importance_sharded(
    head, Xs, y, mesh=mesh, n_repeats=3, seed=42
)
np.testing.assert_allclose(sharded.importances, single.importances, atol=1e-6)
print(f"SWEEP{pid}_OK")

# ---- input-placement matrix: the images and mask are placed over the
# cross-process mesh INDEPENDENTLY, so any mix of host numpy /
# locally-committed device array / already-global array must work and
# agree with the host-input result ----------------------------------------
mask = (rng.random((B, 16, 16)) > 0.3).astype(np.uint8)

def finalized(stats):
    g = SuffStats(*(
        None if s is None else np.asarray(process_allgather(s, tiled=True))
        for s in stats
    ))
    return finalize_features(g, backend="host").values

base = finalized(sufficient_stats_sharded(full, mask, mesh=mesh))
mixed = finalized(sufficient_stats_sharded(X, mask, mesh=mesh))
np.testing.assert_array_equal(base, mixed)  # global images + host mask

local_dev = jax.device_put(full, jax.local_devices()[0])
from_dev = finalized(sufficient_stats_sharded(local_dev, mask, mesh=mesh))
np.testing.assert_array_equal(base, from_dev)  # committed local device array
print(f"PLACEMENT{pid}_OK")

# finalize_features on the still-global (non-addressable) stats directly:
# the one-dispatch replication path inside the host backend
direct = finalize_features(
    sufficient_stats_sharded(full, mask, mesh=mesh), backend="host"
).values
np.testing.assert_array_equal(base, direct)

# precision='device' over the cross-process mesh: values stay sharded on
# device; to_numpy() must replicate-and-fetch, not raise
from tpumcia.config import FeatureConfig
from tpumcia.features.extract import extract_features

fm_dev = extract_features(
    full, config=FeatureConfig(precision="device"), mesh=mesh
)
fm_host = extract_features(full, config=FeatureConfig(precision="device"))
np.testing.assert_allclose(
    fm_dev.to_numpy(), fm_host.to_numpy(), rtol=1e-5, atol=1e-5
)
print(f"DEVICEPREC{pid}_OK")
"""


@pytest.mark.slow
def test_two_process_feature_extraction(tmp_path):
    """The sharded feature-extraction pipeline itself (not just the scaler
    collectives) runs SPMD across PROCESS boundaries: two CPU processes form
    one runtime, assemble a cross-process data-sharded batch, run
    sufficient_stats_sharded over the global mesh, and the finalized
    features match the reference oracle to 1e-9."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["TPUMCIA_REEXECED"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    script = tmp_path / "extract_worker.py"
    script.write_text(_EXTRACT_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"EXTRACT{pid}_OK" in out, out
        assert f"SWEEP{pid}_OK" in out, out
        assert f"PLACEMENT{pid}_OK" in out, out
        assert f"DEVICEPREC{pid}_OK" in out, out


_CNN_WORKER = r"""
import sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

from tpumcia.parallel.distributed import init_distributed

assert init_distributed(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
)

import jax
from tpumcia.parallel.mesh import make_mesh
from tpumcia.models.train import CNNConfig, fit_cnn

mesh = make_mesh()

# identical dataset on both processes (fit_cnn's multi-process contract);
# a learnable signal in channel 0 so the loss actually falls
rng = np.random.RandomState(0)
n = 16
imgs = rng.random((n, 16, 16, 3)).astype(np.float32)
labels = (np.arange(n) % 2).astype(np.int32)
imgs[labels == 1, :, :, 0] += 1.0

head = fit_cnn(
    imgs, labels,
    config=CNNConfig(
        num_classes=2, width=8, epochs=2, batch_size=8, seed=0
    ),
    mesh=mesh,
)
losses = [h["loss"] for h in head.history]
assert len(losses) == 2 and all(np.isfinite(losses)), losses
acc = head.score(imgs, labels)  # predict path under the cross-process mesh
assert 0.0 <= acc <= 1.0

# the CNN importance probes over the cross-process mesh
from tpumcia.importance.occlusion import (
    channel_occlusion_importance,
    channel_permutation_importance_images,
)

occ = channel_occlusion_importance(head, imgs, labels)
perm = channel_permutation_importance_images(head, imgs, labels, n_repeats=2)
assert occ.shape == (3,) and np.isfinite(occ).all(), occ
assert perm.shape == (3, 2) and np.isfinite(perm).all(), perm
print(f"CNN{pid}_LOSSES={losses[0]:.6f},{losses[1]:.6f}")
print(f"CNN{pid}_OK")
"""


@pytest.mark.slow
def test_two_process_cnn_train(tmp_path):
    """fit_cnn trains data-parallel across PROCESS boundaries: the batch is
    sharded over a 2-process mesh (gradient psum over the process link) and
    both processes observe identical loss histories."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["TPUMCIA_REEXECED"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    script = tmp_path / "cnn_worker.py"
    script.write_text(_CNN_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    losses = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"CNN{pid}_OK" in out, out
        line = [l for l in out.splitlines() if f"CNN{pid}_LOSSES=" in l][0]
        losses.append(line.split("=", 1)[1])
    # the replicated computation must be identical on both processes
    assert losses[0] == losses[1], losses


_PIPELINE_WORKER = r"""
import sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

from tpumcia.parallel.distributed import init_distributed

assert init_distributed(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
)

from tpumcia.config import HeadConfig, MeshConfig, PipelineConfig, SplitConfig
from tpumcia.io.synthetic import synthetic_multichannel
from tpumcia.pipeline.run import run_pipeline

# identical dataset on every process; B=24 divides the 4-device data axis
images, labels, _ = synthetic_multichannel(4, hw=16, seed=2)
cfg = PipelineConfig(
    mesh=MeshConfig(data=-1, model=1),
    head=HeadConfig(kind="logistic", num_steps=50),
    split=SplitConfig(test_size=0.25, seed=0, stratify=False),
    fast_path="never",
)
res = run_pipeline(images, labels, config=cfg)
top_idx = int(res.channel_result.ranking[0])
top = f"Ch{top_idx + 1}"
print(f"PIPE{pid}_RESULT=acc:{res.test_accuracy:.6f},top:{top}")
assert top_idx == 0, (top_idx, res.channel_result.summary())
print(f"PIPE{pid}_OK")
"""


@pytest.mark.slow
def test_two_process_run_pipeline(tmp_path):
    """The PUBLIC pipeline entry point runs SPMD across process boundaries:
    run_pipeline with a cross-process mesh config extracts features over
    both processes' devices (host inputs placed over the global mesh,
    finalize allgathers the sharded stats), fits the head, and runs the
    sharded sweeps — identical results on every process, signal channel
    first."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["TPUMCIA_REEXECED"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    script = tmp_path / "pipeline_worker.py"
    script.write_text(_PIPELINE_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"PIPE{pid}_OK" in out, out
        line = [l for l in out.splitlines() if f"PIPE{pid}_RESULT=" in l][0]
        results.append(line.split("=", 1)[1])
    assert results[0] == results[1], results


_STREAM_WORKER = r"""
import sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
out_dir = sys.argv[3]

from tpumcia.parallel.distributed import init_distributed

assert init_distributed(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
)

import jax
assert jax.process_count() == 2

from tpumcia.config import FeatureConfig
from tpumcia.io.synthetic import synthetic_multichannel
from tpumcia.pipeline.streaming import stream_extract

# both processes can SEE the full dataset, but each must only FETCH its own
# shard range (the per-process feed: each host decodes/uploads through its
# own link)
images, labels, _ = synthetic_multichannel(5, num_classes=3, seed=3)
fetched = []

def fetch(idx):
    fetched.extend(int(i) for i in idx)
    return images[idx], None, labels[idx]

cfg = FeatureConfig()
res = stream_extract(
    fetch, len(images), out_dir, shard_size=4, config=cfg,
)
# 15 images / shard 4 -> shards at 0,4,8,12; round-robin by ordinal
own = {0: [0, 8], 1: [4, 12]}[pid]
expect = [i for s in own for i in range(s, min(s + 4, 15))]
assert sorted(fetched) == expect, (pid, sorted(fetched))
assert res.shards_computed == 2, res.shards_computed
assert res.profile["process_count"] == 2

# after the barrier every process assembles the FULL matrix
from tpumcia.features.extract import extract_features
direct = extract_features(images, config=cfg)
assert res.features.shape == direct.shape, res.features.shape
np.testing.assert_allclose(
    np.asarray(res.features.values), np.asarray(direct.values),
    rtol=1e-6, atol=1e-9,
)
np.testing.assert_array_equal(res.labels, labels)
assert res.features.names == direct.names
print(f"STREAM{pid}_OK")
"""


@pytest.mark.slow
def test_two_process_stream_extract(tmp_path):
    """Per-process-feed multi-host streaming (BASELINE config 5's pod
    answer): two CPU processes in one jax.distributed runtime split the
    shard space, each fetches/computes/writes only its own shards through
    its own feed, and after the completion barrier both assemble the full
    bit-identical feature matrix from the merged per-process manifests."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["TPUMCIA_REEXECED"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out_dir = tmp_path / "stream_out"
    script = tmp_path / "stream_worker.py"
    script.write_text(_STREAM_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port), str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"STREAM{pid}_OK" in out, out
    # both processes' manifests landed in the shared dir
    assert (out_dir / "manifest_p0000.json").exists()
    assert (out_dir / "manifest_p0001.json").exists()
