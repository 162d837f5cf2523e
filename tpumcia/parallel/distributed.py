"""Multi-host (multi-process) initialization and helpers.

``jax.distributed.initialize`` is the multi-host entry point (SURVEY.md
§2.4/§5). The reference has no distributed code at all (its only
concurrency is a joblib pool, ipynb:495-496) — this is the beyond-reference
capability that lets the same mesh configs span several hosts:

* every process calls :func:`init_distributed` first with the coordinator
  address and process topology (arguments or the environment variables
  below — nothing is auto-detected),
* ``jax.devices()`` then returns the GLOBAL device list, so
  ``parallel.mesh.make_mesh`` / ``MeshConfig(data=-1)`` span all hosts
  unchanged,
* per-host data becomes one global sharded array via
  :func:`shard_across_processes`; the shard_map pipelines
  (``sufficient_stats_sharded``, ``fit_scaler_sharded``,
  ``permutation_importance_sharded``) run on it as on a single host, with
  XLA routing the collectives between devices and hosts.

Environment variables (used when arguments are omitted):
``TPUMCIA_COORDINATOR`` (host:port), ``TPUMCIA_NUM_PROCESSES``,
``TPUMCIA_PROCESS_ID`` — see ``launch_eval.sh`` for the per-host launcher.
"""

from __future__ import annotations

import os

_INITIALIZED = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Initialize the JAX distributed runtime (idempotent).

    Returns True when running multi-process after the call, False for a
    plain single-process run (no coordinator configured anywhere). Pass the
    coordinator address (``host:port``), process count and process id, or
    export ``TPUMCIA_COORDINATOR`` / ``TPUMCIA_NUM_PROCESSES`` /
    ``TPUMCIA_PROCESS_ID``.
    """
    global _INITIALIZED
    import jax

    if _INITIALIZED:
        return jax.process_count() > 1
    # a framework launcher may have initialized jax.distributed before us —
    # treat that as initialized instead of raising from the double call
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        _INITIALIZED = True
        return jax.process_count() > 1

    coordinator_address = coordinator_address or os.environ.get(
        "TPUMCIA_COORDINATOR"
    )
    if num_processes is None and "TPUMCIA_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPUMCIA_NUM_PROCESSES"])
    if process_id is None and "TPUMCIA_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPUMCIA_PROCESS_ID"])

    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            # a partially-specified topology must raise, not silently
            # degrade to single-process (every worker would then compute on
            # 1/N of the data and report wrong results)
            raise ValueError(
                "init_distributed: num_processes/process_id were specified "
                f"(num_processes={num_processes}, process_id={process_id}) "
                "but no coordinator address is configured — pass "
                "coordinator_address or export TPUMCIA_COORDINATOR"
            )
        return False  # single-process run; nothing to initialize

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True
    return jax.process_count() > 1


def shard_across_processes(x, mesh, axis: str = "data"):
    """Assemble per-process local data into one global array sharded over
    ``mesh``'s ``axis``: each process contributes its local block of the
    leading dimension (the multi-host feed for the shard_map pipelines)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = np.asarray(x)
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    from jax.experimental.multihost_utils import (
        host_local_array_to_global_array,
    )

    return host_local_array_to_global_array(x, mesh, P(axis))


def process_summary() -> dict:
    """Small observability blob for logs: process/device topology."""
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "backend": jax.default_backend(),
    }
