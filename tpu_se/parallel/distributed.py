"""Multi-host runtime glue.

The reference is strictly single-process/single-GPU (SURVEY.md §2.4); this
module is the new framework's multi-host entry: ``jax.distributed`` for the
runtime, per-host input sharding via ``tpu_se.data.pipeline.shard_for_host``,
collectives inside the jitted step (GSPMD emits them from the shardings;
XLA hands them to NCCL on GPUs).
"""

from __future__ import annotations

import jax


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           cpu_collectives: str | None = None) -> dict:
    """Initialize jax.distributed when running multi-host; no-op otherwise.

    GPUs reduce over NCCL without further setup; pass
    ``cpu_collectives="gloo"`` for multi-process CPU runs (CI / the
    multi-host equivalence test) so the CPU backend joins the cluster.
    Returns a summary dict (process index/count, local/global devices).
    """
    if coordinator_address is not None:
        if cpu_collectives is not None:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def allgather_host_rows(local, n_total: int, process_index: int,
                        process_count: int):
    """Reassemble a row-sharded host array across processes.

    Each process contributes the rows of its ``shard_for_host`` slice of an
    ``n_total``-row array; returns the full array on every process. This is
    the DCN leg of per-host input sharding: each host reads 1/P of the
    bytes from storage and the interconnect distributes the rest.
    """
    import numpy as np

    from jax.experimental import multihost_utils

    from tpu_se.data.pipeline import shard_for_host

    bounds = [shard_for_host(n_total, p, process_count)
              for p in range(process_count)]
    per_max = max(s.stop - s.start for s in bounds)
    local = np.ascontiguousarray(local)
    if local.shape[0] < per_max:
        pad = np.zeros((per_max - local.shape[0],) + local.shape[1:],
                       local.dtype)
        local = np.concatenate([local, pad])
    stacked = np.asarray(multihost_utils.process_allgather(local))
    return np.concatenate([stacked[p][: bounds[p].stop - bounds[p].start]
                           for p in range(process_count)])


def sync_processes(tag: str = "tpu_se") -> None:
    """Cross-process barrier (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)
