"""Sharded batched-evidence inference (data parallelism).

The compiled replacement for "one evidence instantiation per propagate
call" (reference junctiontree.py:297-331): evidence masks carry a leading
batch axis, the batch axis is sharded over the mesh with NamedSharding, and
the vmapped propagation program runs SPMD — XLA inserts no cross-device
communication for the embarrassingly parallel part, and collectives only
appear in global aggregates (``psum`` over the batch axis in the shard_map
path below).  SURVEY.md §2.3 row "DP"."""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..executor import (
    apply_masks,
    factor_marginals,
    partition,
    propagate_cliques,
    var_marginals,
)
from ..ops.semirings import SUM_PRODUCT, Semiring
from ..schedule import Plan
from .mesh import BATCH_AXIS, batch_sharding, replicated


def _single_query(plan: Plan, semiring: Semiring, pots, masks):
    mpots = apply_masks(plan, pots, masks, semiring)
    beliefs, _ = propagate_cliques(plan, mpots, semiring)
    return var_marginals(plan, beliefs, semiring), partition(plan, beliefs, semiring)


def make_sharded_query(plan: Plan, mesh: Mesh, semiring: Semiring = SUM_PRODUCT):
    """Compile a batched evidence-query function whose batch axis is sharded
    over ``mesh``'s batch axis.

    Returns ``fn(pots, mask_batch) -> (var_marginals [B,...], Z [B])`` where
    ``pots`` are replicated clique potentials and each ``mask_batch[v]`` is
    [B, size_v].  B must be divisible by the batch-axis size."""
    rep = replicated(mesh)
    shard = batch_sharding(mesh)

    fn = jax.jit(
        jax.vmap(partial(_single_query, plan, semiring), in_axes=(None, 0)),
        in_shardings=(rep, shard),
        out_shardings=(shard, shard),
    )
    return fn


def make_sharded_query_shardmap(
    plan: Plan, mesh: Mesh, semiring: Semiring = SUM_PRODUCT
):
    """shard_map variant with explicit collectives: each device runs its
    local batch shard, then the global log-partition statistics (mean and
    max over the whole batch) are reduced with psum/pmax over the batch
    axis — the pattern multi-host aggregation rides on (NCCL over NVLink
    within a host, the network across hosts).

    Returns ``fn(pots, mask_batch) -> (marginals, Z, global_mean_logZ)``."""

    def local_fn(pots, masks):
        margs, z = jax.vmap(
            partial(_single_query, plan, semiring), in_axes=(None, 0)
        )(pots, masks)
        logz = z if semiring.is_log else jnp.log(z)
        local_sum = jnp.sum(logz)
        local_n = jnp.asarray(logz.shape[0], dtype=logz.dtype)
        gsum = jax.lax.psum(local_sum, BATCH_AXIS)
        gn = jax.lax.psum(local_n, BATCH_AXIS)
        return margs, z, gsum / gn

    n_vars = plan.num_vars
    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(BATCH_AXIS)),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P()),
        )
    )
    return fn
