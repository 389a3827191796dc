"""Device-mesh construction for one host and for several hosts.

Replacement for the reference's absent distributed backend (SURVEY.md §2.3:
no NCCL/MPI — files on disk were the only "communication"). Here the
communication substrate is XLA collectives (NCCL on GPUs), expressed by
sharding arrays over a named ``jax.sharding.Mesh``. The GPUs of one host
are joined all to all by NVLink, so within a host the mesh follows the
algorithm alone; hosts talk over the network.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1,
              axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 2-D (data, model) mesh over the available devices.

    Args:
        n_devices: how many devices to use (default: all visible).
        model_parallel: size of the model/tensor axis; must divide n_devices.
            The data axis gets the rest. ``model_parallel=1`` is pure DP.
        axis_names: names for (data, model) axes.
        devices: explicit device list (default ``jax.devices()``). Within
            one host every device reaches every other at the same rate, so
            ``jax.devices()`` order serves.
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    n = len(devs)
    if n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n} devices")
    grid = np.array(devs).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, axis_names)


def make_pod_mesh(model_parallel: int = 1,
                  axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """Multi-host mesh: data axis spans hosts (network), model axis stays
    within a host (NVLink).

    Call after ``jax.distributed.initialize()`` on every host. Uses
    ``mesh_utils.create_hybrid_device_mesh`` so collectives over the model
    axis stay inside a host while the data axis only ever all-reduces
    gradients / shards input batches across hosts. Devices without a
    ``slice_index`` attribute (GPUs) are grouped per process.
    """
    import jax.experimental.mesh_utils as mesh_utils

    n_local = jax.local_device_count()
    n_total = jax.device_count()
    if n_local % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must divide local device "
            f"count {n_local} (model axis must not cross hosts)")
    per_host = (n_local // model_parallel, model_parallel)
    n_hosts = n_total // n_local
    if n_hosts == 1:
        # single host — no cross-host dimension to arrange
        return make_mesh(model_parallel=model_parallel,
                         axis_names=axis_names)
    grid = mesh_utils.create_hybrid_device_mesh(
        per_host, (n_hosts, 1), allow_split_physical_axes=True,
        process_is_granule=not hasattr(jax.devices()[0], "slice_index"))
    grid = grid.reshape(n_total // model_parallel, model_parallel)
    return Mesh(grid, axis_names)
