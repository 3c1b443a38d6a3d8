"""Device mesh and multi-host initialization.

The whole distributed design rides two named mesh axes (SURVEY.md §2.2 T8):

- ``'data'``  — batch sharding; gradient psum. May span hosts (only the
  grad all-reduce crosses them).
- ``'model'`` — vocab sharding for the POI embedding / output tables;
  all-to-all id/vector exchange and softmax psum between the cards.

The reference has no parallelism at all (single-process Theano). Here the
collectives are XLA's, issued under ``jax.shard_map`` or inserted by GSPMD;
on the GPU XLA hands them to NCCL. The cards of one host are joined all to
all, so the mesh follows the algorithm alone: devices are laid out in
``jax.devices()`` order.
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from poi_tpu import backend

log = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def local_device_ids_for(process_id: int, gpus_per_host: int) -> list[int] | None:
    """The one card a process drives on a multi-GPU host (processes fill a
    host's cards in order), or None where there are no GPUs to divide."""
    if gpus_per_host <= 0:
        return None
    return [process_id % gpus_per_host]


def maybe_init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the JAX multi-host coordination service when configured.

    No-op for single-process runs. Multi-host bring-up (SURVEY.md §3.2c):
    every host calls this with the same coordinator before touching devices.
    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID from
    the environment when args are omitted.

    On a GPU host each process takes one card of its own
    (``local_device_ids``; ``JAX_LOCAL_DEVICE_IDS`` overrides), so several
    processes on one host do not each reserve memory on every card.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None or jax.distributed.is_initialized():
        return
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0"))
    local_ids = None
    if not os.environ.get("JAX_LOCAL_DEVICE_IDS") and not backend.cpu_requested(
        jax.config.jax_platforms
    ):
        local_ids = local_device_ids_for(process_id, backend.visible_gpu_count())
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_ids,
    )
    log.info(
        "jax.distributed initialized: process %d/%d, %d local / %d global devices",
        process_id, num_processes, jax.local_device_count(), jax.device_count(),
    )


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """Build the ('data', 'model') mesh.

    ``data=-1`` infers the data-parallel degree from the device count.
    Device order is taken from ``jax.devices()``; the 'model' axis is minor.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if model <= 0:
        raise ValueError("model axis size must be >= 1")
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(devices.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batch arrays: leading axis over 'data', replicated over 'model'."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def vocab_sharding(mesh: Mesh) -> NamedSharding:
    """Vocab-dim (row) sharding for embedding tables: [V, D] → V over 'model'."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def local_data_batch(global_batch: int, mesh: Mesh) -> int:
    """Per-host slice of the global batch given this mesh's process layout."""
    return global_batch // jax.process_count()
