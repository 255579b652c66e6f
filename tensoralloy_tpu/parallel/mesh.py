"""Device-mesh data parallelism.

The reference's only parallelism is data-parallel replication with
NCCL/ring all-reduce (`tensoralloy/train/distribute_utils.py:84-159`).
The equivalent here: a 1-D `jax.sharding.Mesh` over the "data" axis;
batches are sharded on their leading axis, params replicated, and XLA
inserts the gradient `psum` (NCCL on GPUs) when the jitted train step
consumes sharded inputs. Multi-host scale-out extends the same mesh
via `jax.distributed` without code changes here.

For very large cells the same machinery can shard the *pair axis* of a
single structure ("spatial parallelism"): pairs are independent rows of
the segment-sum, so a data-axis shard of pair arrays + psum of atomic
energies is sufficient; see `ops/` kernels.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data"
              ) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices but only "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """device_put every leaf with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    def put(x):
        if np.ndim(x) == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, sharding)
    return jax.tree_util.tree_map(put, batch)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (params/opt state) across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator_address: str = None,
                           num_processes: int = None,
                           process_id: int = None):
    """Multi-host scale-out over DCN (replaces the reference's
    TF_CONFIG multi-worker cluster setup,
    `train/distribute_utils.py:316-343`): call once per host before any
    jax op; afterwards `jax.devices()` spans all hosts and the same
    data-parallel Mesh/psum code runs unchanged."""
    import jax
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_count(), jax.process_index()
