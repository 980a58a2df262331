"""Multi-host bring-up and host-aware meshes.

The reference has no distribution at all (SURVEY.md §2.3).  On several GPU
hosts the recipe is:

  1. every host calls :func:`initialize` (jax.distributed.initialize) with
     the coordinator address (``host:port``), the process count and its
     process id;
  2. :func:`make_multihost_mesh` builds a global (batch, model) mesh that
     places the *batch* axis across hosts (evidence batches shard over the
     network — embarrassingly parallel, no cross-host traffic during
     propagation) and the *model* axis within a host's cards (clique-axis
     psums stay on NVLink);
  3. the same ``make_sharded_query`` / ``sharded_clique_message``
     programs run unchanged — each host feeds its local shard of the mask
     batch via ``jax.make_array_from_process_local_data``.

Tests run it at process_count == 1 and in a two-process CPU run
(tests/test_multihost.py); the mesh-building logic itself is covered by the
virtual multi-device tests in tests/test_sharding.py."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import BATCH_AXIS, MODEL_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize, tolerating single-process runs.

    With no arguments, relies on a cluster launcher that sets the
    environment JAX reads (e.g. SLURM); on a bare machine pass all three."""
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialized
        pass


def make_multihost_mesh(n_model_per_host: int = 1) -> Mesh:
    """Global (batch, model) mesh: model axis within each host's local
    cards (NVLink), batch axis spanning the rest (hosts x remaining cards,
    over the network)."""
    devices = jax.devices()
    n_local = jax.local_device_count()
    if n_model_per_host > n_local:
        raise ValueError(
            f"n_model_per_host={n_model_per_host} exceeds local devices {n_local}"
        )
    n_total = len(devices)
    n_model = n_model_per_host
    n_batch = n_total // n_model
    grid = np.empty((n_batch, n_model), dtype=object)
    # keep each host's model group on consecutive local devices
    for i, d in enumerate(devices):
        grid[i // n_model, i % n_model] = d
    return Mesh(grid, (BATCH_AXIS, MODEL_AXIS))


def host_local_batch_to_global(mesh: Mesh, local_arrays):
    """Assemble per-host local mask batches into a global sharded array
    pytree (jax.make_array_from_process_local_data on the batch axis)."""
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sharding, np.asarray(x)),
        local_arrays,
    )


def scaling_report(qps_per_config: dict) -> dict:
    """Scaling-efficiency table.

    Input {config_name: (n_chips, qps)}; output adds per-config efficiency
    relative to linear scaling from the smallest-chip-count config
    (BASELINE target: >= 80% at 2+ hosts)."""
    if not qps_per_config:
        return {}
    items = sorted(qps_per_config.items(), key=lambda kv: kv[1][0])
    _, (base_n, base_qps) = items[0][0], items[0][1]
    out = {}
    for name, (n, qps) in items:
        ideal = base_qps * (n / base_n)
        out[name] = {
            "chips": n,
            "qps": qps,
            "efficiency": qps / ideal if ideal else 0.0,
        }
    return out
