"""Fuzz tests for the grouped-unrolled contraction path (ops/grouped.py).

Oracle: broadcast every operand to the full union scope and reduce with the
semiring — the same semantics `Semiring.contract` implements, evaluated
independently here so the grouped path is checked against first principles
(mirrors the reference's brute-force oracle pattern,
/root/reference/tests/test_computation.py:19-48).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from junctiontree_tpu.ops.grouped import grouped_batched_contract
from junctiontree_tpu.ops.semirings import SEMIRINGS

BATCH = -1


def _oracle(sr, ops, ovs, outv, sizes, allv):
    scope = sorted(allv)
    acc = None
    for o, vs in zip(ops, ovs):
        vv = [v for v in vs if v != BATCH]
        x = o if vs and vs[0] == BATCH else o[None]
        y = x.reshape([x.shape[0]] + [sizes[s] for s in vv])
        for ax, s in enumerate(scope):
            if s not in vv:
                y = jnp.expand_dims(y, ax + 1)
        acc = y if acc is None else sr._combine(acc, y)
    red = tuple(1 + i for i, s in enumerate(scope) if s not in set(outv))
    return sr._reduce(acc, red) if red else acc


def _random_case(rng):
    nv = int(rng.integers(2, 7))
    sizes = {v: int(rng.integers(2, 4)) for v in range(nv)}
    nops = int(rng.integers(1, 5))
    B = 3
    ops, ovs, allv = [], [], set()
    for _ in range(nops):
        k = int(rng.integers(1, nv + 1))
        vs = sorted(rng.choice(nv, size=k, replace=False).tolist())
        allv |= set(vs)
        batched = rng.random() < 0.5
        shape = ([B] if batched else []) + [sizes[v] for v in vs]
        ops.append(jnp.asarray(rng.random(shape, dtype=np.float32)) + 0.1)
        ovs.append(([BATCH] if batched else []) + vs)
    out_k = int(rng.integers(0, len(allv) + 1))
    outv = sorted(rng.choice(sorted(allv), size=out_k, replace=False).tolist())
    return sizes, ops, ovs, outv, allv


@pytest.mark.parametrize("unroll_cap", [1, 1000])
@pytest.mark.parametrize("sr_name", ["sum_product", "log_sum_exp", "max_product"])
def test_grouped_contract_fuzz(sr_name, unroll_cap):
    """unroll_cap=1000 exercises the unrolled path, =1 the broadcast-reduce
    path; both must match the brute-force union-scope oracle."""
    rng = np.random.default_rng(42 + unroll_cap)
    sr = SEMIRINGS[sr_name]
    checked = 0
    for _ in range(120):
        sizes, ops, ovs, outv, allv = _random_case(rng)
        got = grouped_batched_contract(
            sr, ops, ovs, outv, sizes, BATCH, unroll_cap=unroll_cap
        )
        if got is None:
            continue
        res, b = got
        want = _oracle(sr, ops, ovs, outv, sizes, allv)
        if not b:
            want = want[0]
        np.testing.assert_allclose(
            np.asarray(res), np.asarray(want), rtol=2e-4, atol=2e-4
        )
        checked += 1
    assert checked > 60  # the path must actually engage


def test_grouped_matches_engine_einsum_path():
    """End-to-end: a model big enough to trigger the grouped path yields the
    same posteriors as the plain-einsum program (threshold raised)."""
    import junctiontree_tpu as jt
    from junctiontree_tpu.config import DEFAULT
    from junctiontree_tpu.evidence import batch_masks_sparse, random_evidence_batch
    from junctiontree_tpu.models import grid_mrf_model

    factors, sizes, values = grid_mrf_model(5, 5, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    evs = random_evidence_batch(tree.plan, 7, list(sizes)[:6], seed=4)
    masks = {k: jnp.asarray(v)
             for k, v in batch_masks_sparse(tree.plan, evs).items()}

    old_g = DEFAULT.grouped_min_states
    try:
        DEFAULT.grouped_min_states = 2  # force grouped everywhere
        eng = tree.engine().set_potentials(values)
        post_g, logz_g = eng.posterior_batch(masks)

        DEFAULT.grouped_min_states = 1 << 62  # force plain einsum
        eng2 = tree.engine().set_potentials(values)
        post_e, logz_e = eng2.posterior_batch(masks)
    finally:
        DEFAULT.grouped_min_states = old_g

    np.testing.assert_allclose(np.asarray(logz_g), np.asarray(logz_e),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(post_g, post_e):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
