"""Multi-host (multi-process) pipeline walkthrough.

Demonstrates the cross-process SPMD pattern the 2-process tests pin
(`tests/test_distributed.py`): every process calls `init_distributed`,
builds ONE global mesh spanning all hosts, contributes its local rows to a
global data-sharded batch, and runs the same sharded entry points as a
single host — feature extraction, the collective MinMax fit, the
permutation sweep, and data-parallel CNN training.

Run it WITHOUT arguments to self-launch two local CPU worker processes
(the same simulation the test suite uses — no cluster required):

    python examples/multihost_pipeline.py

On real hosts, run one copy per host via `launch_eval.sh`-style env
(TPUMCIA_COORDINATOR / TPUMCIA_NUM_PROCESSES / TPUMCIA_PROCESS_ID) with
`--worker`.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def worker() -> None:
    import numpy as np

    from tpumcia.parallel.distributed import (
        init_distributed,
        process_summary,
        shard_across_processes,
    )

    # 1. one runtime spanning every process (env- or pod-configured)
    init_distributed()
    info = process_summary()
    pid = info["process_index"]
    print(f"[proc {pid}] topology: {info}")

    from tpumcia.parallel.mesh import make_mesh

    mesh = make_mesh()  # spans the GLOBAL device list

    # 2. per-process local rows -> one global data-sharded batch.
    #    (Here every process synthesizes its own slice of a deterministic
    #    dataset; in production each host loads its own h5 shard.)
    rng = np.random.RandomState(0)
    B = 4 * mesh.shape["data"]
    full = (rng.random((B, 16, 16, 3)) * 256).astype(np.uint8)
    half = B // info["process_count"]
    X = shard_across_processes(full[pid * half:(pid + 1) * half], mesh)

    # 3. the same sharded entry points as a single host
    from tpumcia.features.finalize import finalize_features
    from tpumcia.features.stats import SuffStats
    from tpumcia.parallel.sharding import (
        fit_scaler_sharded,
        permutation_importance_sharded,
        sufficient_stats_sharded,
    )

    stats = sufficient_stats_sharded(X, mesh=mesh)
    from jax.experimental.multihost_utils import process_allgather

    gathered = SuffStats(*(
        None if s is None else np.asarray(process_allgather(s, tiled=True))
        for s in stats
    ))
    done = finalize_features(gathered, backend="host")
    print(f"[proc {pid}] features: {done.values.shape}")

    Xf = np.nan_to_num(done.values).astype(np.float32)
    y = (np.arange(B) % 2).astype(np.int32)
    scaler = fit_scaler_sharded(Xf, mesh=mesh)  # pmin/pmax collectives

    from tpumcia.config import HeadConfig
    from tpumcia.models import fit_head

    Xs = np.asarray(scaler.transform(Xf))
    head = fit_head(Xs, y, config=HeadConfig(kind="logistic", num_steps=50))
    sweep = permutation_importance_sharded(
        head, Xs, y, mesh=mesh, n_repeats=3, seed=42
    )
    print(f"[proc {pid}] sweep importances shape: {sweep.importances.shape}")

    # 4. data-parallel CNN training over the same mesh (identical dataset
    #    on every process; batch sharded over 'data', gradient psum'd)
    from tpumcia.models.train import CNNConfig, fit_cnn

    imgs = full.astype(np.float32) / 255.0
    cnn = fit_cnn(
        imgs, y,
        config=CNNConfig(num_classes=2, width=8, epochs=1, batch_size=8),
        mesh=mesh,
    )
    print(f"[proc {pid}] cnn loss history: {cnn.history}")

    # 5. per-process-feed streaming: each process fetches/decodes/uploads
    #    ONLY its own round-robin share of the shards through its own host
    #    link (the aggregate-link answer to the single-link H2D floor);
    #    per-process manifests merge, and after the completion barrier
    #    every process assembles the full matrix.
    import shutil
    import tempfile

    from jax.experimental.multihost_utils import sync_global_devices

    from tpumcia.config import FeatureConfig
    from tpumcia.pipeline.streaming import stream_extract

    out_dir = Path(tempfile.gettempdir()) / "tpumcia_multihost_stream"
    # resume is keyed on (shard start, config_tag): a previous demo run's
    # shards in this fixed directory would be silently resumed (skipped)
    # and mixed into this run's matrix — clean once, then barrier so no
    # process starts streaming into a directory another is deleting
    if pid == 0 and out_dir.exists():
        shutil.rmtree(out_dir)
    sync_global_devices("tpumcia_demo_stream_dir_clean")

    def fetch(idx):
        return full[idx], None, y[idx]

    stream = stream_extract(
        fetch, len(full), out_dir, shard_size=max(4, len(full) // 4),
        config=FeatureConfig(),
        config_tag="multihost-demo",
    )
    print(
        f"[proc {pid}] streamed {stream.features.shape} "
        f"(computed {stream.shards_computed} shards locally, "
        f"profile {stream.profile})"
    )
    print(f"[proc {pid}] OK")


def launch_local_demo() -> None:
    """Two local CPU processes with a loopback coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["TPUMCIA_COORDINATOR"] = f"127.0.0.1:{port}"
    env["TPUMCIA_NUM_PROCESSES"] = "2"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker"],
            env={**env, "TPUMCIA_PROCESS_ID": str(pid)},
            cwd=REPO,
        )
        for pid in range(2)
    ]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")
    print("multihost demo finished: both workers OK")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if "--worker" in sys.argv:
        worker()
    else:
        launch_local_demo()
