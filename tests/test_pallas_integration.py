"""The factored big-clique route inside the batched program: with a model
mesh (Engine.shard_model) big cliques are served by the sharded factored
contraction, here on virtual CPU devices; results must match the plain
einsum program and the brute-force oracle."""

import numpy as np

import junctiontree_tpu as jt
from junctiontree_tpu.evidence import batch_masks_sparse, random_evidence_batch
from junctiontree_tpu.executor import Engine
from junctiontree_tpu.models import grid_mrf_model
from junctiontree_tpu.parallel.mesh import make_mesh

from .util import brute_force_marginals


def test_message_fused_route_fires_and_matches(monkeypatch):
    """A hub clique with a 2-var separator child: the child's batched
    message must be fused into the factored weights (messages whose scope
    stays on one side of the separator do not disqualify the route)."""
    import junctiontree_tpu.ops.factored as fc

    rng = np.random.default_rng(2)
    hub = [f"h{i}" for i in range(5)]
    factors = [hub, [hub[0], hub[1], "p"], ["p", "q"]]
    sizes = {**{h: 2 for h in hub}, "p": 3, "q": 2}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]

    calls_with_msgs = []
    orig = fc.big_clique_sep_message

    def spy(pot, cvars, masks, svars, msgs=(), **kw):
        if msgs:
            calls_with_msgs.append([vs for vs, _ in msgs])
        return orig(pot, cvars, masks, svars, msgs=msgs, **kw)

    monkeypatch.setattr(fc, "big_clique_sep_message", spy)

    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().shard_model(make_mesh(n_batch=1, n_model=2),
                                    min_states=4)
    eng.set_potentials(values)
    evs = random_evidence_batch(tree.plan, 3, ["q", hub[3]], seed=1)
    masks = batch_masks_sparse(tree.plan, evs)
    margs, z = eng.query_batch(masks)

    assert any(
        any(len(vs) >= 2 for vs in call) for call in calls_with_msgs
    ), "no multi-var message was fused into the factored route"

    var_list = list(sizes)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in var_list], evidence=evs[1]
    )
    for i, v in enumerate(var_list):
        vid = tree.plan.table.id_of(v)
        np.testing.assert_allclose(
            np.asarray(margs[vid])[1], expect[i], rtol=1e-4, atol=1e-6
        )


def _check_routed_program(n_model, monkeypatch):
    factors, sizes, values = grid_mrf_model(3, 3, seed=13)
    tree = jt.create_junction_tree(factors, sizes)
    evs = random_evidence_batch(
        tree.plan, 4, ["g0_0", "g1_1", "g2_2"], seed=4
    )
    masks = batch_masks_sparse(tree.plan, evs)
    import junctiontree_tpu.ops.factored as fc

    routed = []
    orig = fc.big_clique_sep_message
    monkeypatch.setattr(
        fc, "big_clique_sep_message",
        lambda *a, **k: routed.append(1) or orig(*a, **k),
    )

    eng = Engine(tree.plan).shard_model(
        make_mesh(n_batch=1, n_model=n_model), min_states=4
    )
    eng.set_potentials(values)
    margs, z = eng.query_batch(masks)
    assert routed, "no contraction took the factored route"

    eng2 = Engine(tree.plan).set_potentials(values)
    margs2, z2 = eng2.query_batch(masks)

    np.testing.assert_allclose(np.asarray(z), np.asarray(z2), rtol=1e-5)
    for a, b in zip(margs, margs2):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7
        )
    var_list = list(sizes)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in var_list], evidence=evs[2]
    )
    for i, v in enumerate(var_list):
        vid = tree.plan.table.id_of(v)
        np.testing.assert_allclose(
            np.asarray(margs[vid])[2], expect[i], rtol=1e-4, atol=1e-6
        )


def test_kernel_routed_program_matches_einsum_program(monkeypatch):
    """A tiny TP threshold routes every big-enough 3x3-grid clique through
    the factored contraction sharded over a 2-way model axis; compare
    against the einsum-only program and the oracle."""
    _check_routed_program(2, monkeypatch)


def test_routed_program_four_way_model_axis(monkeypatch):
    """As above on a 4-way model axis (R1 padded to the axis size)."""
    _check_routed_program(4, monkeypatch)
