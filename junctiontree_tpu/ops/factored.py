"""Factored-mask big-clique contraction (the tensor-parallel route).

A clique potential with S = R1*R2*C states, evidence masks and child
messages factored into two batched weight groups W1 [B, R1], W2 [B, R2],
contracted to the separator:

    out[b, c] = sum_{r1, r2} pot[r1, r2, c] * W1[b, r1] * W2[b, r2]

``Engine.shard_model`` serves oversized cliques this way: each device
contracts its block of the potential with the XLA einsum below, and a psum
combines them (parallel/tp.py).

Weight groups come from the factorization of per-variable evidence masks:
W1 = outer product of masks over the group-1 rest variables (computed by a
tiny XLA einsum), likewise W2 — see ``build_weight_groups``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


def reference_factored_contract(
    pot: jnp.ndarray, w1: jnp.ndarray, w2: jnp.ndarray
) -> jnp.ndarray:
    """The contraction as one XLA einsum (full float32 precision;
    accumulates f32 even for bf16 storage)."""
    return jnp.einsum("rsc,br,bs->bc", pot, w1, w2, precision="highest",
                      preferred_element_type=jnp.float32)


def build_weight_groups(
    masks: Sequence[jnp.ndarray],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split per-variable mask vectors [B, K_v] into two balanced groups and
    outer-product each group into W1 [B, prod(K of group1)], W2 [B, ...].

    The group split balances log-state-space so both W tensors stay small
    (each ~ B * sqrt(R))."""
    assert masks, "need at least one mask"
    sizes = [int(m.shape[-1]) for m in masks]
    order = np.argsort(sizes)[::-1]
    g1: List[int] = []
    g2: List[int] = []
    s1 = s2 = 0.0
    for ix in order:
        if s1 <= s2:
            g1.append(int(ix))
            s1 += np.log(sizes[ix])
        else:
            g2.append(int(ix))
            s2 += np.log(sizes[ix])

    def outer(ixs: List[int]) -> jnp.ndarray:
        if not ixs:
            B = masks[0].shape[0]
            return jnp.ones((B, 1), dtype=masks[0].dtype)
        acc = masks[ixs[0]]
        for ix in ixs[1:]:
            acc = (acc[:, :, None] * masks[ix][:, None, :]).reshape(
                acc.shape[0], -1
            )
        return acc

    return outer(g1), outer(g2), g1, g2


_BATCH = -1  # local batch pseudo-label for einsum subscripts


def _contract_items(items, out_vars, B, sizes):
    """Product of batched items ([B, *shape] over vars) broadcast onto
    [B, *out_vars] — a small einsum (item scopes are separators/masks)."""
    from .semirings import SUM_PRODUCT

    ops = [t for _, t in items]
    ovs = [[_BATCH] + list(vs) for vs, _ in items]
    covered = {v for vs, _ in items for v in vs}
    missing = [v for v in out_vars if v not in covered]
    if missing:
        ops.append(
            jnp.ones(tuple(sizes[v] for v in missing), dtype=ops[0].dtype)
        )
        ovs.append(list(missing))
    out = SUM_PRODUCT.contract(ops, ovs, [_BATCH] + list(out_vars))
    return out.reshape(B, -1)


def _group_items(items, sizes):
    """Partition batched items into two weight groups.

    Items sharing variables are merged into components (their product cannot
    be split across the two weight operands); components are then balanced
    greedily by log-state-space so both group weights stay ~sqrt(R)-sized.
    Returns (g1_items, g1_vars, g2_items, g2_vars)."""
    # union-find over items sharing variables
    parent = list(range(len(items)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    var_owner: dict = {}
    for i, (vs, _) in enumerate(items):
        for v in vs:
            if v in var_owner:
                parent[find(i)] = find(var_owner[v])
            else:
                var_owner[v] = i
    roots: List[int] = []
    comps: List[List[int]] = []
    comp_vars: List[List[int]] = []
    root_ix: dict = {}
    for i, (vs, _) in enumerate(items):
        r = find(i)
        if r not in root_ix:
            root_ix[r] = len(comps)
            roots.append(r)
            comps.append([])
            comp_vars.append([])
        ci = root_ix[r]
        comps[ci].append(i)
        for v in vs:
            if v not in comp_vars[ci]:
                comp_vars[ci].append(v)
    weights = [
        sum(np.log(sizes[v]) for v in cv) for cv in comp_vars
    ]
    order = np.argsort(weights)[::-1]
    g1: List[int] = []
    g2: List[int] = []
    s1 = s2 = 0.0
    for ci in order:
        if s1 <= s2:
            g1.append(int(ci))
            s1 += weights[ci]
        else:
            g2.append(int(ci))
            s2 += weights[ci]
    g1_items = [items[i] for ci in g1 for i in comps[ci]]
    g1_vars = [v for ci in g1 for v in comp_vars[ci]]
    g2_items = [items[i] for ci in g2 for i in comps[ci]]
    g2_vars = [v for ci in g2 for v in comp_vars[ci]]
    return g1_items, g1_vars, g2_items, g2_vars


def big_clique_sep_message(
    pot: jnp.ndarray,
    clique_vars: Sequence[int],
    masks: dict,
    sep_vars: Sequence[int],
    *,
    msgs: Sequence[Tuple[Sequence[int], jnp.ndarray]] = (),
) -> jnp.ndarray:
    """Collect/distribute message from a (large) clique to its separator
    under batched evidence masks and batched child messages.

    pot: unbatched clique potential, axes = clique_vars order.
    masks: {var id: [B, size_v]} for observed vars (subset of clique_vars).
    msgs: batched multi-variable operands (child separator messages), each
    (vars, tensor [B, *shape]); every message's vars must lie entirely inside
    sep_vars or entirely outside (messages crossing the separator boundary
    can't be factored — callers fall back to XLA einsum).
    Masks/messages scoped inside sep_vars are applied post-contraction.
    The contraction itself is ``reference_factored_contract`` on
    p3 [R1, R2, C], w1 [B, R1], w2 [B, R2].  Returns [B, *sep_shape]."""
    cset = list(clique_vars)
    sset = list(sep_vars)
    rest = [v for v in cset if v not in sset]
    rest_set = set(rest)
    sep_set = set(sset)
    # permute pot to (rest..., sep...)
    perm = [cset.index(v) for v in rest + sset]
    p = jnp.transpose(pot, perm)
    R = int(np.prod([p.shape[i] for i in range(len(rest))])) if rest else 1
    C = int(np.prod(p.shape[len(rest):])) if sset else 1
    sep_shape = p.shape[len(rest):]
    sizes = {v: pot.shape[cset.index(v)] for v in cset}

    # split batched operands into rest-scoped items (folded into the
    # weight groups) and sep-scoped items (applied to the output)
    items: List[Tuple[Tuple[int, ...], jnp.ndarray]] = []
    sep_items: List[Tuple[Tuple[int, ...], jnp.ndarray]] = []
    for v in cset:
        if v in masks:
            t = ((v,), masks[v])
            (items if v in rest_set else sep_items).append(t)
    for vs, t in msgs:
        vs = tuple(vs)
        if all(v in rest_set for v in vs):
            items.append((vs, t))
        elif all(v in sep_set for v in vs):
            sep_items.append((vs, t))
        else:
            raise ValueError(
                f"message scope {vs} crosses the separator boundary"
            )

    B = None
    for _, t in items + sep_items:
        B = t.shape[0]
        break
    if B is None:
        raise ValueError("need at least one batched operand")

    if items:
        g1_items, g1_vars, g2_items, g2_vars = _group_items(items, sizes)
        un_vars = [v for v in rest if v not in set(g1_vars) | set(g2_vars)]
        new_rest = g1_vars + g2_vars + un_vars
        perm2 = [rest.index(v) for v in new_rest] + list(
            range(len(rest), p.ndim)
        )
        p = jnp.transpose(p, perm2)
        R1 = int(np.prod([sizes[v] for v in g1_vars])) or 1
        R2 = int(np.prod([sizes[v] for v in g2_vars + un_vars])) or 1
        w1 = (
            _contract_items(g1_items, g1_vars, B, sizes)
            if g1_items
            else jnp.ones((B, 1), dtype=pot.dtype)
        )
        w2 = (
            _contract_items(g2_items, g2_vars, B, sizes)
            if g2_items
            else jnp.ones((B, 1), dtype=pot.dtype)
        )
        # w2 broadcast over uncovered rest axes
        n_un = int(np.prod([sizes[v] for v in un_vars])) or 1
        if n_un > 1:
            w2 = jnp.repeat(w2[:, :, None], n_un, axis=2).reshape(B, -1)
        p3 = p.reshape(R1, R2, C)
    else:
        R1, R2 = 1, R
        w1 = jnp.ones((B, 1), dtype=pot.dtype)
        w2 = jnp.ones((B, R), dtype=pot.dtype)
        p3 = p.reshape(R1, R2, C)

    out = reference_factored_contract(p3, w1, w2)
    out = out.reshape((B,) + tuple(sep_shape))

    # apply separator-scoped masks/messages elementwise on the output
    for vs, t in sep_items:
        shape = [B] + [1] * len(sset)
        for i, v in enumerate(vs):
            shape[1 + sset.index(v)] = t.shape[1 + i]
        # order t's axes to separator order
        axes_order = [0] + [
            1 + list(vs).index(v) for v in sset if v in vs
        ]
        out = out * jnp.transpose(t, axes_order).reshape(shape)
    return out
