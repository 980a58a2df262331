"""Worker process for the 2-process jax.distributed CPU test.

Usage: python _multihost_worker.py <process_id> <num_processes> <port>

Each process brings up jax.distributed via multihost.initialize, builds the
global (batch, model) mesh with make_multihost_mesh, contributes its local
shard of a deterministic evidence-mask batch via host_local_batch_to_global,
and runs the shard_map DP query whose global mean-logZ rides a cross-process
psum (Gloo on CPU; NCCL on GPU hosts).  Prints ``GSUM <value>`` for the
parent test to compare against the single-process oracle."""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from junctiontree_tpu.parallel import multihost  # noqa: E402
from junctiontree_tpu.parallel.batch import (  # noqa: E402
    make_sharded_query_shardmap,
)

multihost.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

import junctiontree_tpu as jt  # noqa: E402
from junctiontree_tpu.evidence import batch_masks, random_evidence_batch  # noqa: E402
from junctiontree_tpu.models import grid_mrf_model  # noqa: E402

factors, sizes, values = grid_mrf_model(3, 3, seed=0)
tree = jt.create_junction_tree(factors, sizes)
eng = tree.engine().set_potentials(values)
pots = [np.asarray(p, dtype=np.float32) for p in eng._pots_np]

B = 8
evs = random_evidence_batch(tree.plan, B, list(sizes)[:3], seed=1)
full_masks = [m.astype(np.float32) for m in batch_masks(tree.plan, evs)]

mesh = multihost.make_multihost_mesh(n_model_per_host=1)
assert mesh.shape["batch"] == 4 * nproc and mesh.shape["model"] == 1

per = B // nproc
local_masks = [m[pid * per:(pid + 1) * per] for m in full_masks]
global_masks = multihost.host_local_batch_to_global(mesh, local_masks)

fn = make_sharded_query_shardmap(tree.plan, mesh)
margs, z, mean_logz = fn(pots, global_masks)
jax.block_until_ready(mean_logz)
print(f"GSUM {float(mean_logz):.10f}", flush=True)
print(f"proc {pid} OK", flush=True)
