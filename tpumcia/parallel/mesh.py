"""Device-mesh construction helpers.

The canonical mesh has a ``data`` axis (objects are embarrassingly parallel —
SURVEY.md §2.4) and an optional ``model`` axis reserved for the CNN path's
parameter sharding. The mesh follows the algorithm only — a flat (data,
model) grid over ``jax.devices()``, no torus or topology mapping: on four
NVLink-connected GPUs the default is (data=4, model=1); tests use a
CPU-simulated 8-device mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if model <= 0:
        raise ValueError("model axis size must be >= 1")
    if data <= 0 and data != -1:
        raise ValueError(
            f"data axis size must be >= 1 (or -1 for 'all remaining'), got {data}"
        )
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    devs = np.asarray(devices[: data * model]).reshape(data, model)
    return Mesh(devs, axis_names=("data", "model"))


def mesh_from_config(cfg, devices=None) -> Mesh | None:
    """Resolve a :class:`tpumcia.config.MeshConfig` into a Mesh, or None for
    a single-device layout (data * model <= 1 resolved devices).

    ``data=-1`` means "all remaining devices after the model axis" — on a
    single chip that resolves to 1 and the pipeline runs unsharded; on a pod
    slice (or the CPU-simulated 8-device test mesh) it turns the same config
    into an SPMD run (SURVEY.md §2.4 DP plan).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    model = cfg.model
    data = cfg.data
    if model <= 0:
        raise ValueError("mesh config: model axis size must be >= 1")
    if data <= 0 and data != -1:
        raise ValueError(
            "mesh config: data axis size must be >= 1 "
            f"(or -1 for 'all remaining'), got {data}"
        )
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model <= 1:
        return None
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {n}"
        )
    return make_mesh(data=data, model=model, devices=devices)


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch/object) axis over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
