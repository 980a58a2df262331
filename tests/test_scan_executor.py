"""Chain (scan/forward-backward) executor tests: detection, parity with the
general program, long-chain compile behavior."""

import time

import numpy as np
import pytest

import junctiontree_tpu as jt
from junctiontree_tpu.evidence import batch_masks_sparse, random_evidence_batch
from junctiontree_tpu.models import chain_bn_model, grid_mrf_model
from junctiontree_tpu.scan_executor import ChainLayout
from junctiontree_tpu.schedule import compile_plan

from .util import brute_force_marginals, chain_bn, random_values


def test_detect_chain():
    plan = compile_plan(*chain_bn(10))
    layout = ChainLayout.detect(plan)
    assert layout is not None
    assert len(layout.clique_order) == 9
    assert len(layout.var_order) == 10
    assert layout.card == 2


def test_detect_rejects_non_chains():
    assert ChainLayout.detect(compile_plan(*chain_bn(10, card=3))) is not None
    # grid: not a chain
    factors, sizes, _ = grid_mrf_model(3, 3)
    assert ChainLayout.detect(compile_plan(factors, sizes)) is None
    # star with hub card != leaf card: cliques 2-var but tree is a star
    factors = [["h", f"l{i}"] for i in range(4)]
    sizes = {"h": 2, **{f"l{i}": 2 for i in range(4)}}
    assert ChainLayout.detect(compile_plan(factors, sizes)) is None
    # mixed cardinalities on a chain
    factors = [["a", "b"], ["b", "c"]]
    assert ChainLayout.detect(compile_plan(factors, {"a": 2, "b": 3, "c": 2})) is None
    # single clique
    assert ChainLayout.detect(compile_plan([["a", "b"]], {"a": 2, "b": 2})) is None


@pytest.mark.parametrize("n,card", [(5, 2), (20, 3), (40, 4)])
def test_chain_posterior_matches_oracle(n, card):
    factors, sizes, values = chain_bn_model(n, card=card, seed=n)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    assert eng._chain_layout() is not None  # chain path engaged
    evs = random_evidence_batch(
        tree.plan, 4, [f"x{n//2}", f"x{n-1}"], seed=n
    )
    masks = batch_masks_sparse(tree.plan, evs)
    post, logz = eng.posterior_batch(masks)
    var_list = list(sizes)
    for b in (0, 3):
        expect = brute_force_marginals(
            factors, sizes, values, [[v] for v in var_list], evidence=evs[b]
        )
        np.testing.assert_allclose(
            float(np.asarray(logz)[b]), np.log(expect[0].sum()), rtol=1e-5
        )
        for i, v in enumerate(var_list):
            vid = tree.plan.table.id_of(v)
            np.testing.assert_allclose(
                np.asarray(post[vid])[b],
                expect[i] / expect[i].sum(),
                rtol=1e-5,
                atol=1e-7,
            )


def test_chain_no_evidence():
    factors, sizes, values = chain_bn_model(12, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    post, logz = eng.posterior_batch({})
    # proper BN: logZ == 0
    np.testing.assert_allclose(np.asarray(logz), 0.0, atol=1e-5)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in sizes]
    )
    for i, v in enumerate(sizes):
        vid = tree.plan.table.id_of(v)
        np.testing.assert_allclose(
            np.asarray(post[vid])[0], expect[i] / expect[i].sum(), rtol=1e-5
        )


def test_long_chain_compile_is_flat():
    """Scan program compile time must not grow linearly with chain length."""
    times = {}
    for n in (200, 800):
        factors, sizes, values = chain_bn_model(n, seed=1)
        tree = jt.create_junction_tree(factors, sizes)
        eng = tree.engine().set_potentials(values)
        masks = batch_masks_sparse(
            tree.plan, [{f"x{n-1}": 0}] * 4
        )
        t0 = time.perf_counter()
        post, logz = eng.posterior_batch(masks)
        times[n] = time.perf_counter() - t0
        assert np.all(np.isfinite(np.asarray(logz)))
    # 4x the cliques must not cost anywhere near 4x the compile
    assert times[800] < 3 * times[200] + 1.0, times


def test_parallel_chain_matches_sequential():
    """Log-depth associative-scan program must match the sequential scan."""
    import jax
    import jax.numpy as jnp

    from junctiontree_tpu.scan_executor import (
        ChainLayout,
        chain_posterior_parallel_program,
        chain_posterior_program,
        stack_chain_potentials,
    )

    for n, card in [(30, 2), (17, 3)]:
        factors, sizes, values = chain_bn_model(n, card=card, seed=n)
        tree = jt.create_junction_tree(factors, sizes)
        eng = tree.engine().set_potentials(values)
        layout = eng._chain_layout()
        A = jnp.asarray(stack_chain_potentials(layout, eng._pots_np))
        masks = {
            tree.plan.table.id_of(f"x{n//2}"): jnp.asarray(
                np.stack([np.eye(card, dtype=np.float32)[s] for s in (0, 1)])
            )
        }
        seq = jax.jit(chain_posterior_program(tree.plan, layout))
        par = jax.jit(chain_posterior_parallel_program(tree.plan, layout))
        post_s, logz_s = seq(A, masks)
        post_p, logz_p = par(A, masks)
        np.testing.assert_allclose(
            np.asarray(logz_p), np.asarray(logz_s), rtol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(post_p), np.asarray(post_s.stacked if hasattr(post_s, "stacked") else post_s),
            rtol=1e-4, atol=1e-6,
        )


def test_parallel_chain_sharded_over_mesh():
    """Step axis sharded over the 8-device mesh: same results."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from junctiontree_tpu.parallel.mesh import make_mesh
    from junctiontree_tpu.scan_executor import (
        chain_posterior_parallel_program,
        stack_chain_potentials,
    )

    n = 65  # 64 transition steps, divisible by the 8-device mesh
    factors, sizes, values = chain_bn_model(n, seed=7)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    layout = eng._chain_layout()
    A = jnp.asarray(stack_chain_potentials(layout, eng._pots_np))
    vid = tree.plan.table.id_of("x10")
    masks = {vid: jnp.asarray(np.array([[1.0, 0.0]], dtype=np.float32))}

    par = jax.jit(chain_posterior_parallel_program(tree.plan, layout))
    post_ref, logz_ref = par(A, masks)

    mesh = make_mesh(n_batch=8, n_model=1)
    A_sharded = jax.device_put(A, NamedSharding(mesh, P("batch")))
    post_sh, logz_sh = par(A_sharded, masks)
    np.testing.assert_allclose(
        np.asarray(logz_sh), np.asarray(logz_ref), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(post_sh), np.asarray(post_ref), rtol=1e-5, atol=1e-7
    )


def test_engine_shard_sequence_picks_parallel_program():
    """Engine-level SP: shard_sequence on a chain engine routes
    posterior_batch through the associative-scan program with the step axis
    sharded, and matches the sequential engine (VERDICT r2 #5)."""
    import jax

    from junctiontree_tpu.parallel.mesh import make_mesh
    from junctiontree_tpu.scan_executor import StackedPosteriors

    n = 65  # 64 transition steps, divisible by the 8-device mesh
    factors, sizes, values = chain_bn_model(n, seed=9)
    tree = jt.create_junction_tree(factors, sizes)
    B = 4
    rng = np.random.default_rng(1)
    masks = {}
    for name in ("x3", "x40"):
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[name] = m

    ref_eng = tree.engine().set_potentials(values)
    post_ref, logz_ref = ref_eng.posterior_batch(masks)

    mesh = make_mesh(n_batch=8, n_model=1)
    sp_eng = tree.engine().set_potentials(values)
    sp_eng.shard_sequence(mesh, axis="batch", min_len=16)
    post_sp, logz_sp = sp_eng.posterior_batch(masks)
    assert isinstance(post_sp, StackedPosteriors)
    # the prestacked transitions really are sharded over the step axis
    shard_shapes = {s.data.shape for s in sp_eng._chain_A.addressable_shards}
    assert len(sp_eng._chain_A.addressable_shards) == 8
    assert all(sh[0] == 64 // 8 for sh in shard_shapes)

    np.testing.assert_allclose(
        np.asarray(logz_sp), np.asarray(logz_ref), rtol=1e-5
    )
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(
            np.asarray(post_sp[v]), np.asarray(post_ref[v]),
            rtol=1e-4, atol=1e-7,
        )


def test_engine_shard_sequence_short_chain_stays_sequential():
    """Below min_len the sequential scan program is kept (K^2 vs K^3 work)."""
    from junctiontree_tpu.parallel.mesh import make_mesh

    factors, sizes, values = chain_bn_model(20, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    eng.shard_sequence(make_mesh(n_batch=8, n_model=1), min_len=1000)
    masks = {"x5": np.array([[1.0, 0.0]], dtype=np.float32)}
    post, logz = eng.posterior_batch(masks)
    ref = tree.engine().set_potentials(values)
    post_r, logz_r = ref.posterior_batch(masks)
    np.testing.assert_allclose(np.asarray(logz), np.asarray(logz_r), rtol=1e-6)


class TestKBest:
    """Exact k-best decoding (list-Viterbi) vs brute-force enumeration."""

    def _setup(self, n=5, card=3, seed=11):
        import itertools

        from junctiontree_tpu import Engine, compile_plan

        from .util import chain_bn, random_values

        factors, sizes = chain_bn(n, card=card)
        values = random_values(factors, sizes, seed=seed)
        plan = compile_plan(factors, sizes)
        eng = Engine(plan).set_potentials(values)
        names = sorted(sizes)

        def joint(assign, evidence):
            for v, s in (evidence or {}).items():
                if assign[v] != s:
                    return -np.inf
            tot = 0.0
            for f, val in zip(factors, values):
                x = float(np.asarray(val)[tuple(assign[v] for v in f)])
                if x <= 0:
                    return -np.inf
                tot += np.log(x)
            return tot

        def brute_top(k, evidence=None):
            scored = []
            for combo in itertools.product(*[range(sizes[v]) for v in names]):
                a = dict(zip(names, combo))
                scored.append(joint(a, evidence))
            scored.sort(reverse=True)
            return [s for s in scored if s > -np.inf][:k]

        return eng, names, brute_top

    def test_kbest_matches_bruteforce(self):
        eng, names, brute_top = self._setup()
        got = eng.top_k_assignments(k=6)
        want = brute_top(6)
        assert len(got) == 6
        np.testing.assert_allclose(
            [s for _, s in got], want, atol=1e-5
        )
        # assignments are distinct and each achieves its reported score
        seen = {tuple(sorted(a.items())) for a, _ in got}
        assert len(seen) == 6
        for a, s in got:
            assert eng.score_assignment(a) == pytest.approx(s, abs=1e-5)

    def test_kbest_with_evidence(self):
        eng, names, brute_top = self._setup()
        ev = {names[2]: 1}
        got = eng.top_k_assignments(ev, k=4)
        np.testing.assert_allclose(
            [s for _, s in got], brute_top(4, ev), atol=1e-5
        )
        assert all(a[names[2]] == 1 for a, _ in got)

    def test_kbest_exhausts_paths(self):
        """k larger than the number of feasible assignments: padding rows
        are dropped, the full ranked list comes back."""
        eng, names, brute_top = self._setup(n=3, card=2)
        got = eng.top_k_assignments(k=20)
        want = brute_top(20)
        assert len(got) == len(want) == 8
        np.testing.assert_allclose([s for _, s in got], want, atol=1e-5)

    def test_kbest_first_equals_map(self):
        eng, names, _ = self._setup(seed=21)
        (a1, s1), *_ = eng.top_k_assignments(k=3)
        a0, s0 = eng.map_assignment()
        assert s1 == pytest.approx(s0, abs=1e-5)

    def test_kbest_general_trees_route_to_tree_program(self):
        """Non-chain plans no longer raise (round-3 limitation): they route
        to map_executor.tree_kbest_program — spot-check rank-1 == MAP here;
        full parity lives in tests/test_tree_kbest.py."""
        from junctiontree_tpu import Engine, compile_plan

        from .util import grid_mrf, random_values

        factors, sizes = grid_mrf(3, 3)
        plan = compile_plan(factors, sizes)
        eng = Engine(plan).set_potentials(random_values(factors, sizes, 1))
        got = eng.top_k_assignments(k=2)
        assert len(got) == 2 and got[0][1] >= got[1][1]
        _, s0 = eng.map_assignment()
        assert got[0][1] == pytest.approx(s0, abs=1e-5)


@pytest.mark.parametrize("n,n_dev", [(62, 8), (30, 4), (47, 2)])
def test_shard_sequence_pads_uneven_step_counts(n, n_dev):
    """A chain whose step count is not a multiple of the device count is
    padded with identity transitions, so every device still holds a shard
    and the posteriors stay exact."""
    from junctiontree_tpu.executor import Engine
    from junctiontree_tpu.parallel.mesh import make_mesh

    factors, sizes, values = chain_bn_model(n, seed=n)
    tree = jt.create_junction_tree(factors, sizes)
    B = 3
    rng = np.random.default_rng(n)
    masks = {}
    for name in ("x1", f"x{n - 2}"):
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[name] = m
    post_ref, logz_ref = Engine(tree.plan).set_potentials(
        values).posterior_batch(masks)

    sp_eng = Engine(tree.plan).set_potentials(values)
    sp_eng.shard_sequence(make_mesh(n_batch=n_dev, n_model=1), min_len=8)
    post_sp, logz_sp = sp_eng.posterior_batch(masks)
    shards = sp_eng._chain_A.addressable_shards
    assert len({s.device for s in shards}) == n_dev
    steps = n - 1
    assert sp_eng._chain_A.shape[0] == steps + (-steps) % n_dev
    np.testing.assert_allclose(
        np.asarray(logz_sp), np.asarray(logz_ref), rtol=1e-5
    )
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(
            np.asarray(post_sp[v]), np.asarray(post_ref[v]),
            rtol=1e-4, atol=1e-6,
        )
