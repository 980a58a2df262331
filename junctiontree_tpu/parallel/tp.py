"""Tensor parallelism: clique-axis sharding for oversized cliques.

When one clique's state space exceeds one card's memory (SURVEY.md §2.3 TP
row), ``Engine.shard_model`` stores its potential flat, in contiguous blocks
over the ``model`` mesh axis.  A block is the potential restricted to a range
of the clique's LEADING variables (the shortest prefix whose state count the
axis size divides), so each device computes its share of any message where
its block lies — the same factored contraction as one card
(ops/factored.big_clique_sep_message) — and one ``psum`` combines them, an
NCCL all-reduce over NVLink.  No device reads another's block: the program
holds one all-reduce per routed contraction and no resharding.  The batch
axis can be sharded at the same time over the ``batch`` axis (2D mesh)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import factored as fc
from .mesh import BATCH_AXIS, MODEL_AXIS

# largest state count of the leading variables that split a clique over the
# model axis: their masks and messages are expanded to it on every device
MAX_PREFIX_STATES = 4096


def split_prefix(sizes: Sequence[int], n_model: int) -> Optional[int]:
    """Number k of leading variables whose joint state count P the model
    axis divides, so that a flat potential split into ``n_model`` equal
    blocks gives each device P / n_model whole values of those variables.
    None when no prefix up to MAX_PREFIX_STATES states does."""
    P_ = 1
    for k, s in enumerate(sizes, 1):
        P_ *= int(s)
        if P_ > MAX_PREFIX_STATES:
            return None
        if P_ % n_model == 0:
            return k
    return None


def sharded_clique_message(
    mesh: Mesh,
    pot: jnp.ndarray,
    scope: Sequence[int],
    sizes: Sequence[int],
    masks: Dict[int, jnp.ndarray],
    out_vars: Sequence[int],
    msgs: Sequence[Tuple[Sequence[int], jnp.ndarray]] = (),
    *,
    shard_batch: bool = False,
) -> jnp.ndarray:
    """big_clique_sep_message of a clique whose potential is stored flat
    (axes in ``scope`` order) and split in contiguous blocks over the model
    axis, computed block by block where the blocks lie and summed by one
    psum.

    The leading ``split_prefix`` variables become one local variable per
    device (its range of their joint states): their masks and messages are
    expanded to the joint prefix and sliced to that range, and an output
    over any of them is written into its range of a zero [B, P, ...] array
    before the psum.  Callers check ``split_prefix`` and that no message
    crosses the separator boundary once the prefix is merged
    (``local_scopes_cross``).  Returns [B, *sizes of out_vars]."""
    n = mesh.shape[MODEL_AXIS]
    scope = list(scope)
    k = split_prefix([sizes[v] for v in scope], n)
    assert k is not None, "no prefix of the clique splits over the model axis"
    pre, rest = scope[:k], scope[k:]
    pre_sizes = [sizes[v] for v in pre]
    P_ = int(np.prod(pre_sizes))
    L = P_ // n
    pi = max(scope) + 1  # the local prefix variable
    out_vars = list(out_vars)
    out_pre = [v for v in pre if v in out_vars]
    local_out = ([pi] if out_pre else []) + [v for v in out_vars
                                            if v not in pre]
    mask_ids = sorted(masks)
    B = next(iter(masks.values())).shape[0] if masks else msgs[0][1].shape[0]
    shard_b = shard_batch and B % mesh.shape[BATCH_AXIS] == 0
    bspec = P(BATCH_AXIS) if shard_b else P()

    def to_prefix(t, vs):
        """[B, *vs] -> [B, P, *non-prefix vs], broadcast over the prefix
        variables ``vs`` lacks."""
        vs = list(vs)
        others = [v for v in vs if v not in pre]
        order = [vs.index(v) for v in pre if v in vs] + [
            vs.index(v) for v in others]
        t = jnp.transpose(t, [0] + [1 + i for i in order])
        shape = [t.shape[0]] + [sizes[v] if v in vs else 1 for v in pre] + [
            sizes[v] for v in others]
        t = jnp.broadcast_to(t.reshape(shape), [t.shape[0]] + pre_sizes
                             + [sizes[v] for v in others])
        return t.reshape((t.shape[0], P_) + tuple(sizes[v] for v in others))

    def local(pot_l, mask_l, msg_l):
        d = jax.lax.axis_index(MODEL_AXIS)
        pot_l = pot_l.reshape((L,) + tuple(sizes[v] for v in rest))
        lmasks = {v: m for v, m in zip(mask_ids, mask_l) if v not in pre}
        for v, m in zip(mask_ids, mask_l):
            if v in pre:
                m = jax.lax.dynamic_slice_in_dim(to_prefix(m, [v]), d * L, L,
                                                 axis=1)
                lmasks[pi] = m if pi not in lmasks else lmasks[pi] * m
        lmsgs = []
        for (vs, _), t in zip(msgs, msg_l):
            if any(v in pre for v in vs):
                t = jax.lax.dynamic_slice_in_dim(to_prefix(t, vs), d * L, L,
                                                 axis=1)
                vs = [pi] + [v for v in vs if v not in pre]
            lmsgs.append((tuple(vs), t))
        out = fc.big_clique_sep_message(pot_l, [pi] + rest, lmasks,
                                        local_out, msgs=lmsgs)
        if out_pre:
            full = jnp.zeros((out.shape[0], P_) + out.shape[2:], out.dtype)
            out = jax.lax.dynamic_update_slice_in_dim(full, out, d * L,
                                                      axis=1)
        return jax.lax.psum(out, MODEL_AXIS)

    out = jax.shard_map(
        local, mesh=mesh, in_specs=(P(MODEL_AXIS), bspec, bspec),
        out_specs=bspec,
    )(pot.reshape(-1), [masks[v] for v in mask_ids], [t for _, t in msgs])
    if not out_pre:
        return out
    # [B, P, *rest out] -> the prefix's own axes, summed where not wanted,
    # then in out_vars order
    rest_out = [v for v in out_vars if v not in pre]
    out = out.reshape((out.shape[0],) + tuple(pre_sizes) + out.shape[2:])
    drop = [1 + i for i, v in enumerate(pre) if v not in out_vars]
    if drop:
        out = out.sum(axis=tuple(drop))
    have = out_pre + rest_out
    return jnp.transpose(out, [0] + [1 + have.index(v) for v in out_vars])


def local_scopes_cross(scope, n_model, sizes, out_vars, msg_scopes) -> bool:
    """Whether some message would cross the separator boundary once the
    clique's split prefix is merged into one local variable (the factored
    contraction cannot take it then)."""
    k = split_prefix([sizes[v] for v in scope], n_model)
    pre = set(scope[:k])
    out = {("pre" if v in pre else v) for v in out_vars}
    for vs in msg_scopes:
        loc = {("pre" if v in pre else v) for v in vs}
        if loc & out and loc - out:
            return True
    return False
