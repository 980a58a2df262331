"""The plain NumPy junction-tree reference (tests/util.numpy_tree_propagate)
against the brute-force oracle on small models.  The on-card smoke run
compares the compiled serving path with this reference at real sizes."""

import numpy as np
import pytest

import junctiontree_tpu as jt
from junctiontree_tpu.models import grid_mrf_model

from .util import (
    brute_force_marginals,
    brute_force_max_marginals,
    grid_mrf,
    numpy_tree_propagate,
    random_factor_graph,
    random_values,
)


def _check_sum(factors, sizes, values, evidence):
    plan = jt.create_junction_tree(factors, sizes).plan
    margs, logz = numpy_tree_propagate(plan, values, evidence)
    labels = list(plan.table.labels)
    want = brute_force_marginals(
        factors, sizes, values, [[v] for v in labels], evidence=evidence
    )
    z = float(want[0].sum())
    np.testing.assert_allclose(logz, np.log(z), rtol=1e-10, atol=1e-10)
    for v, w in zip(labels, want):
        np.testing.assert_allclose(
            margs[plan.table.id_of(v)], w / w.sum(), rtol=1e-10, atol=1e-12
        )


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_sum_matches_brute_force_random_graphs(seed):
    factors, sizes = random_factor_graph(seed, n_vars=7, n_factors=9)
    values = random_values(factors, sizes, seed)
    rng = np.random.default_rng(seed)
    obs = list(sizes)[:: 3]
    evidence = {v: int(rng.integers(sizes[v])) for v in obs}
    _check_sum(factors, sizes, values, evidence)


@pytest.mark.parametrize("card", [2, 3])
def test_sum_matches_brute_force_grid(card):
    factors, sizes, values = grid_mrf_model(3, 3, card=card, seed=card)
    _check_sum(factors, sizes, values, {"g0_0": 1, "g2_1": 0})


def test_sum_without_evidence():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, 9)
    _check_sum(factors, sizes, values, {})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_matches_brute_force(seed):
    factors, sizes = random_factor_graph(seed + 10, n_vars=6, n_factors=8)
    values = random_values(factors, sizes, seed)
    plan = jt.create_junction_tree(factors, sizes).plan
    maxm, logmax = numpy_tree_propagate(plan, values, mode="max")
    labels = list(plan.table.labels)
    want = brute_force_max_marginals(
        factors, sizes, values, [[v] for v in labels]
    )
    np.testing.assert_allclose(logmax, np.log(want[0].max()), rtol=1e-10)
    for v, w in zip(labels, want):
        np.testing.assert_allclose(maxm[plan.table.id_of(v)], w, rtol=1e-10)


def test_agrees_with_engine_on_mixed_cardinality_bn():
    """A hailfinder-shaped generator at small size: the reference and the
    engine's batched posteriors agree (the smoke run's check, in small)."""
    from junctiontree_tpu.evidence import batch_masks_sparse
    from junctiontree_tpu.models import random_bayesnet

    factors, sizes, values = random_bayesnet(12, max_parents=3,
                                             cards=(2, 3, 4), seed=4)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    rng = np.random.default_rng(5)
    evs = [{v: int(rng.integers(sizes[v])) for v in list(sizes)[::3]}
           for _ in range(3)]
    post, logz = eng.posterior_batch(batch_masks_sparse(tree.plan, evs))
    for b, ev in enumerate(evs):
        margs, lz = numpy_tree_propagate(tree.plan, values, ev)
        assert abs(float(np.asarray(logz)[b]) - lz) < 1e-4
        for vid, m in enumerate(margs):
            np.testing.assert_allclose(np.asarray(post[vid])[b], m,
                                       rtol=1e-4, atol=1e-6)
