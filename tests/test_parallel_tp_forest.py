"""TP (clique-axis sharding) and forest (EP) parallelism tests on the
8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import junctiontree_tpu as jt
from junctiontree_tpu.models import grid_mrf_model
from junctiontree_tpu.ops.factored import big_clique_sep_message
from junctiontree_tpu.parallel.forest import ForestEngine, split_components
from junctiontree_tpu.parallel.mesh import make_mesh
from junctiontree_tpu.parallel.tp import sharded_clique_message

from .util import brute_force_marginals, random_values


def _clique(seed, B, nv=9):
    rng = np.random.default_rng(seed)
    pot = jnp.asarray(rng.random((2,) * nv), dtype=jnp.float32)
    masks = {v: jnp.asarray(rng.random((B, 2)), dtype=jnp.float32)
             for v in (0, 2, 5, 7)}
    return pot, masks


def test_sharded_clique_message_matches_local():
    """Batch sharded as well (DP x TP): every 2D mesh gives the one-device
    factored contraction's answer."""
    pot, masks = _clique(4, 16)
    want = np.asarray(big_clique_sep_message(pot, list(range(9)), masks,
                                             [1, 8]))
    for n_batch, n_model in [(4, 2), (2, 4), (1, 8)]:
        mesh = make_mesh(n_batch=n_batch, n_model=n_model)
        got = np.asarray(sharded_clique_message(
            mesh, pot, list(range(9)), [2] * 9, masks, [1, 8],
            shard_batch=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_clique_message_unsharded_batch():
    """A batch the batch axis does not divide stays whole on each device."""
    pot, masks = _clique(5, 5)
    mesh = make_mesh(n_batch=2, n_model=4)
    got = np.asarray(sharded_clique_message(
        mesh, pot, list(range(9)), [2] * 9, masks, [], shard_batch=True))
    want = np.asarray(big_clique_sep_message(pot, list(range(9)), masks, []))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _forest_model():
    # three disconnected components with different shapes + a scalar factor
    f1, s1, v1 = grid_mrf_model(2, 2, seed=1)
    factors = list(f1) + [["h", "i"], ["i"]] + [["z"]] + [[]]
    sizes = dict(s1, h=3, i=2, z=4)
    rng = np.random.default_rng(0)
    values = list(v1) + [rng.random((3, 2)) + 0.1, rng.random(2) + 0.1,
                         rng.random(4) + 0.1, np.array(2.0)]
    return factors, sizes, values


def test_split_components():
    factors, sizes, values = _forest_model()
    comps = split_components(factors, sizes)
    assert len(comps) == 3
    covered = sorted(i for c in comps for i in c[0])
    assert covered == list(range(len(factors)))


def test_forest_engine_matches_monolithic():
    factors, sizes, values = _forest_model()
    fe = ForestEngine(factors, sizes).set_potentials(values)
    evs = [{"g0_0": 1, "i": 0}, {"z": 2}, {}]
    post, logz = fe.posterior_batch(evs)

    # monolithic engine (components joined by empty separators)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    from junctiontree_tpu.evidence import batch_masks_sparse

    post_m, logz_m = eng.posterior_batch(batch_masks_sparse(tree.plan, evs))
    np.testing.assert_allclose(logz, np.asarray(logz_m), rtol=1e-5)
    for v in sizes:
        vid = tree.plan.table.id_of(v)
        np.testing.assert_allclose(
            post[v], np.asarray(post_m[vid]), rtol=1e-5, atol=1e-6
        )


def test_forest_engine_devices_spread():
    factors, sizes, values = _forest_model()
    fe = ForestEngine(factors, sizes).set_potentials(values)
    assert len({str(d) for d in fe.device_of}) == min(3, len(jax.devices()))


def _big_clique_model(nv=12, seed=0):
    """One clique of nv binary vars (2^nv states) + unary factors."""
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(nv)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 2 for n in names}
    values = [rng.random((2,) * nv).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names
    ]
    return factors, sizes, values


def test_engine_shard_model_posterior_matches_unsharded():
    """Engine.shard_model routes an oversized clique's contractions through
    the model-axis-sharded factored contraction (VERDICT r1 #3: TP must be
    an Engine capability, not a standalone primitive)."""
    factors, sizes, values = _big_clique_model(nv=12, seed=0)
    B = 8

    # unsharded oracle
    tree = jt.create_junction_tree(factors, sizes)
    eng0 = tree.engine().set_potentials(values)
    rng = np.random.default_rng(1)
    masks = {}
    for n in list(sizes)[:7]:
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[n] = m
    post0, logz0 = eng0.posterior_batch(masks)

    # TP engine: every clique >= 2^10 states sharded over model axis (4-way)
    mesh = make_mesh(n_batch=2, n_model=4)
    eng = jt.create_junction_tree(factors, sizes).engine()
    eng.shard_model(mesh, min_states=1 << 10)
    eng.set_potentials(values)
    # the big clique's potential really is stored sharded over the mesh
    big = int(np.argmax([p.size for p in eng._pots_np]))
    assert len(eng._pots[big].sharding.device_set) == 8
    post, logz = eng.posterior_batch(masks)
    np.testing.assert_allclose(
        np.asarray(logz), np.asarray(logz0), rtol=1e-5
    )
    for v in range(len(sizes)):
        np.testing.assert_allclose(
            np.asarray(post[v]), np.asarray(post0[v]), rtol=1e-5, atol=1e-7
        )


def test_engine_shard_model_scales_feasibility_cap():
    """With a model mesh, check_feasible's cap scales by n_model (oversized
    cliques shard instead of raising)."""
    from junctiontree_tpu.executor import MAX_CLIQUE_STATES, check_feasible

    factors, sizes, values = _big_clique_model(nv=10, seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    # pretend the single-chip cap is tiny: unsharded engine refuses
    with pytest.raises(ValueError, match="infeasible"):
        check_feasible(tree.plan, max_states=1 << 8)
    # scaled cap admits it
    check_feasible(tree.plan, max_states=(1 << 8) * 8)

    # single-query path also works on a shard_model engine
    mesh = make_mesh(n_batch=1, n_model=8)
    eng = tree.engine().shard_model(mesh, min_states=1 << 9)
    eng.set_potentials(values)
    post, z = eng.query({"v0": 1})
    (oracle,) = brute_force_marginals(
        factors, sizes, values, [["v3"]], evidence={"v0": 1}
    )
    vid = tree.plan.table.id_of("v3")
    np.testing.assert_allclose(
        post[vid], oracle / oracle.sum(), rtol=1e-5
    )


def test_engine_shard_model_rejects_nonlinear_semirings():
    factors, sizes, values = _big_clique_model(nv=6, seed=3)
    eng = jt.create_junction_tree(factors, sizes).engine("log_sum_exp")
    with pytest.raises(ValueError, match="sum_product"):
        eng.shard_model(make_mesh(n_batch=2, n_model=4))


def test_shard_model_propagate_uses_scaled_cap(monkeypatch):
    """Engine.propagate on a shard_model engine must not re-check the
    unscaled single-chip cap (VERDICT r2 weak #7a)."""
    import junctiontree_tpu.executor as ex

    factors, sizes, values = _big_clique_model(nv=10, seed=2)
    monkeypatch.setattr(ex, "MAX_CLIQUE_STATES", 1 << 9)  # 2^10 clique is "oversized"
    mesh = make_mesh(n_batch=4, n_model=2)
    eng = jt.create_junction_tree(factors, sizes).engine()
    eng.shard_model(mesh, min_states=1 << 10)
    # reference-parity path goes through evaluate_cliques -> check_feasible;
    # it must use the scaled cap (2^9 * 2 = 2^10 allows the clique)
    out = eng.propagate(values)
    assert len(out) == len(values)
    # the unsharded engine refuses the same model
    eng0 = jt.create_junction_tree(factors, sizes).engine()
    with pytest.raises(ValueError, match="infeasible"):
        eng0.propagate(values)


def test_shard_model_unbatched_contraction_stays_sharded():
    """posterior_batch with evidence NOWHERE near the big clique: the
    oversized contraction has no batched operand, and must still route
    through the sharded TP contraction (ones-weights fallback) instead of
    gathering the flat potential (ADVICE r2 medium)."""
    rng = np.random.default_rng(3)
    nv = 10
    names = [f"v{i}" for i in range(nv)]
    factors = [names[:]] + [[n] for n in names] + [["tail0"], ["v0", "tail0"]]
    sizes = {n: 2 for n in names}
    sizes["tail0"] = 2
    values = (
        [rng.random((2,) * nv).astype(np.float32) + 0.1]
        + [rng.random(2) + 0.1 for _ in names]
        + [rng.random(2) + 0.1, rng.random((2, 2)) + 0.1]
    )
    B = 4
    masks = {"tail0": np.tile(np.array([[1.0, 0.0]], np.float32), (B, 1))}

    tree = jt.create_junction_tree(factors, sizes)
    eng0 = tree.engine().set_potentials(values)
    post0, logz0 = eng0.posterior_batch(masks)

    mesh = make_mesh(n_batch=2, n_model=4)
    eng = jt.create_junction_tree(factors, sizes).engine()
    eng.shard_model(mesh, min_states=1 << 10)
    eng.set_potentials(values)
    post, logz = eng.posterior_batch(masks)
    np.testing.assert_allclose(np.asarray(logz), np.asarray(logz0), rtol=1e-5)
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(
            np.asarray(post[v]), np.asarray(post0[v]), rtol=1e-5, atol=1e-7
        )
    # no GSPMD-gather diagnostics: every oversized contraction was routed
    assert eng.describe().get("tp_fallbacks", []) == []


def test_shard_model_indivisible_above_cap_raises(monkeypatch):
    """A mixed-cardinality oversized clique that can't be flat-sharded must
    raise a descriptive error, not silently land whole on one device
    (ADVICE r2 low)."""
    import junctiontree_tpu.executor as ex

    rng = np.random.default_rng(5)
    names = [f"c{i}" for i in range(7)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 3 for n in names}  # 3^7 = 2187 states, never divisible by 4
    values = [rng.random((3,) * 7).astype(np.float32) + 0.1] + [
        rng.random(3) + 0.1 for _ in names
    ]
    monkeypatch.setattr(ex, "MAX_CLIQUE_STATES", 1 << 10)
    mesh = make_mesh(n_batch=2, n_model=4)
    eng = jt.create_junction_tree(factors, sizes).engine()
    eng.shard_model(mesh, min_states=1 << 10)
    with pytest.raises(ValueError, match="not divisible"):
        eng.set_potentials(values)
