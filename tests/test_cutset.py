"""Cutset conditioning: parity vs the monolithic engine and the brute-force
oracle; treewidth reduction on dense models."""

import numpy as np
import pytest

import junctiontree_tpu as jt
from junctiontree_tpu.cutset import CutsetEngine, choose_cutset
from junctiontree_tpu.evidence import batch_masks_sparse, random_evidence_batch
from junctiontree_tpu.models import grid_mrf_model, hailfinder_like


def _monolithic_posts(factors, sizes, values, masks):
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    posts, logz = eng.posterior_batch(masks, mode="general")
    return {
        v: np.asarray(posts[tree.plan.table.id_of(v)]) for v in sizes
    }, np.asarray(logz)


def test_cutset_matches_monolithic_grid():
    factors, sizes, values = grid_mrf_model(4, 4, seed=1)
    names = list(sizes)
    B = 5
    evs = random_evidence_batch(
        jt.create_junction_tree(factors, sizes).plan, B, names[:3], seed=2
    )
    masks = batch_masks_sparse(
        jt.create_junction_tree(factors, sizes).plan, evs
    )
    # force a nontrivial cutset incl. an observed variable
    ce = CutsetEngine(factors, sizes, values, cutset=[names[0], names[9]])
    got, logz = ce.posterior_batch(masks)
    want, logz_w = _monolithic_posts(factors, sizes, values, masks)
    np.testing.assert_allclose(np.asarray(logz), logz_w, rtol=1e-4)
    for v in sizes:
        np.testing.assert_allclose(
            np.asarray(got[v]), want[v], rtol=1e-4, atol=1e-6
        )


def test_cutset_evidence_on_cutset_variable():
    factors, sizes, values = grid_mrf_model(3, 3, seed=4)
    names = list(sizes)
    B = 3
    cut = names[4]  # center node
    m = np.zeros((B, sizes[cut]), dtype=np.float32)
    m[:, 0] = 1.0
    other = names[1]
    m2 = np.tile(np.array([[0.25, 1.0]], dtype=np.float32), (B, 1))  # soft
    masks = {cut: m, other: m2}
    ce = CutsetEngine(factors, sizes, values, cutset=[cut])
    got, logz = ce.posterior_batch(masks)
    want, logz_w = _monolithic_posts(factors, sizes, values, masks)
    np.testing.assert_allclose(np.asarray(logz), logz_w, rtol=1e-4)
    for v in sizes:
        np.testing.assert_allclose(
            np.asarray(got[v]), want[v], rtol=1e-4, atol=1e-6
        )
    # hard evidence on the cutset var reflected in its posterior
    np.testing.assert_allclose(
        np.asarray(got[cut])[:, 0], np.ones(B), atol=1e-6
    )


def test_choose_cutset_shrinks_dense_model():
    factors, sizes, values = hailfinder_like()
    cut = choose_cutset(factors, sizes, target_states=1 << 14, max_enum=512)
    assert cut  # something was chosen
    from junctiontree_tpu.cutset import _max_states, _without

    before = _max_states(factors, sizes)
    after = _max_states(*_without(factors, sizes, set(cut)))
    assert after < before / 50, (before, after, cut)


def _enum_mpe(factors, sizes, values, evidence):
    """Oracle: enumerate the full joint, return (argmax dict, log score)."""
    import itertools

    names = list(sizes)
    best, best_p = None, -1.0
    for assign in itertools.product(*[range(sizes[v]) for v in names]):
        a = dict(zip(names, assign))
        if any(a[v] != s for v, s in evidence.items()):
            continue
        p = 1.0
        for f, val in zip(factors, values):
            p *= float(np.asarray(val)[tuple(a[v] for v in f)])
        if p > best_p:
            best, best_p = a, p
    return best, np.log(best_p)


def test_cutset_mpe_matches_enumeration():
    factors, sizes, values = grid_mrf_model(3, 3, seed=6)
    names = list(sizes)
    evidence = {names[1]: 1, names[4]: 0}  # names[4] will be the cutset var
    ce = CutsetEngine(factors, sizes, values, cutset=[names[4], names[7]])
    got, score = ce.map_assignment(evidence)
    want, want_score = _enum_mpe(factors, sizes, values, evidence)
    np.testing.assert_allclose(score, want_score, rtol=1e-5)
    # the decoded assignment must attain the optimum (ties possible, so
    # compare scores of the decoded assignment, not states)
    p = 1.0
    for f, val in zip(factors, values):
        p *= float(np.asarray(val)[tuple(got[v] for v in f)])
    np.testing.assert_allclose(np.log(p), want_score, rtol=1e-5)
    for v, s in evidence.items():
        assert got[v] == s


def test_cutset_mpe_batch_matches_monolithic():
    factors, sizes, values = grid_mrf_model(3, 4, seed=8)
    names = list(sizes)
    B = 4
    rng = np.random.default_rng(3)
    masks = {}
    for v in (names[0], names[5]):
        m = np.zeros((B, sizes[v]), dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
        masks[v] = m
    ce = CutsetEngine(factors, sizes, values, cutset=[names[5], names[6]])
    got, scores = ce.map_assignment_batch(masks)

    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine("max_product").set_potentials(values)
    logmasks = {k: np.where(m > 0, 0.0, -np.inf).astype(np.float32)
                for k, m in masks.items()}
    assign_w, scores_w = eng.map_assignment_batch(logmasks)
    assign_w = np.asarray(assign_w)
    np.testing.assert_allclose(scores, np.asarray(scores_w), rtol=1e-4)
    # both decoders attain the same joint score per batch element
    for b in range(B):
        p_got = sum(
            float(np.log(np.asarray(val)[tuple(got[v][b] for v in f)]))
            for f, val in zip(factors, values)
        )
        np.testing.assert_allclose(p_got, scores[b], rtol=1e-4)


def test_cutset_fuzz_vs_oracle():
    """Random small factor graphs x random cutsets x random (hard+soft)
    evidence: posteriors, logZ and MPE all match brute force."""
    from tests.util import brute_force_marginals

    rng = np.random.default_rng(42)
    for trial in range(6):
        nv = int(rng.integers(4, 8))
        names = [f"v{i}" for i in range(nv)]
        sizes = {v: int(rng.integers(2, 4)) for v in names}
        factors = [[v] for v in names]
        for _ in range(int(rng.integers(nv, 2 * nv))):
            k = int(rng.integers(2, min(4, nv) + 1))
            scope = list(rng.choice(nv, size=k, replace=False))
            factors.append([names[i] for i in sorted(scope)])
        values = [
            rng.random(tuple(sizes[v] for v in f)).astype(np.float64) + 0.05
            for f in factors
        ]
        n_cut = int(rng.integers(1, 3))
        cutset = [names[i] for i in rng.choice(nv, n_cut, replace=False)]
        ce = CutsetEngine(factors, sizes, values, cutset=cutset)

        B = 3
        masks = {}
        ev_vars = [names[i] for i in rng.choice(nv, 2, replace=False)]
        for v in ev_vars:
            if rng.random() < 0.5:  # hard
                m = np.zeros((B, sizes[v]), dtype=np.float32)
                m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
            else:  # soft likelihood
                m = rng.random((B, sizes[v])).astype(np.float32) + 0.1
            masks[v] = m

        posts, logz = ce.posterior_batch(masks)
        # oracle per batch row: soft masks become extra unary factors
        for b in range(B):
            bf = [list(f) for f in factors] + [[v] for v in masks]
            bv = list(values) + [
                np.asarray(masks[v][b], dtype=np.float64) for v in masks
            ]
            outs = [[v] for v in names] + [[]]
            *margs, Z = brute_force_marginals(bf, sizes, bv, outs)
            np.testing.assert_allclose(
                float(logz[b]), np.log(Z), rtol=1e-4,
                err_msg=f"trial {trial} row {b} logZ",
            )
            for v, m in zip(names, margs):
                np.testing.assert_allclose(
                    np.asarray(posts[v])[b], m / m.sum(),
                    rtol=2e-4, atol=1e-6,
                    err_msg=f"trial {trial} row {b} var {v}",
                )

        # MPE parity on hard-evidence rows only (soft masks reweight)
        hard_ev = {
            v: int(np.argmax(masks[v][0]))
            for v in masks if set(np.unique(masks[v][0])) <= {0.0, 1.0}
        }
        got, score = ce.map_assignment(hard_ev)
        want, want_score = _enum_mpe(
            factors, sizes, values, hard_ev
        )
        np.testing.assert_allclose(
            score, want_score, rtol=1e-4,
            err_msg=f"trial {trial} MPE score",
        )


def test_cutset_engine_hailfinder_class():
    """End-to-end on the dense BN class: small reduced cliques, finite
    logZ, normalized posteriors for every variable incl. the cutset."""
    factors, sizes, values = hailfinder_like()
    ce = CutsetEngine(factors, sizes, values, target_states=1 << 14,
                      max_enum=512)
    st = ce.describe()
    assert st["max_clique_states"] <= 1 << 16
    assert st["cutset_states"] <= 512
    names = list(sizes)
    B = 2
    rng = np.random.default_rng(0)
    masks = {}
    for v in names[::7]:
        m = np.zeros((B, sizes[v]), dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
        masks[v] = m
    got, logz = ce.posterior_batch(masks)
    assert np.all(np.isfinite(np.asarray(logz)))
    assert set(got) == set(sizes)
    for v in sizes:
        a = np.asarray(got[v])
        assert a.shape == (B, sizes[v])
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-4)
    # observed hard evidence is respected
    for v in masks:
        state = np.argmax(masks[v], axis=1)
        np.testing.assert_allclose(
            np.asarray(got[v])[np.arange(B), state], 1.0, atol=1e-4
        )


def test_cutset_fused_mode_matches_unrolled_and_monolithic():
    """The stacked level-fused reduced program (posterior_batch mode='fused')
    must agree with the unrolled path and the monolithic engine, including
    evidence on a cutset variable and soft evidence."""
    factors, sizes, values = grid_mrf_model(4, 4, seed=3)
    names = list(sizes)
    plan = jt.compile_plan(factors, sizes)
    B = 4
    evs = random_evidence_batch(plan, B, names[:2], seed=7)
    masks = batch_masks_sparse(plan, evs)
    # soft evidence + evidence on a cutset var
    cut = [names[0], names[5]]
    masks[cut[1]] = (
        np.random.default_rng(1).random((B, sizes[cut[1]])).astype(np.float32)
        + 0.1
    )
    ce = CutsetEngine(factors, sizes, values, cutset=cut)
    pf, zf = ce.posterior_batch(masks, mode="fused")
    pu, zu = ce.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zu), rtol=1e-4)
    for v in sizes:
        np.testing.assert_allclose(
            np.asarray(pf[v]), np.asarray(pu[v]), rtol=1e-4, atol=1e-6
        )
    want, logz_w = _monolithic_posts(factors, sizes, values, masks)
    np.testing.assert_allclose(np.asarray(zf), logz_w, rtol=1e-4)
    for v in sizes:
        np.testing.assert_allclose(
            np.asarray(pf[v]), want[v], rtol=1e-4, atol=1e-6
        )


def test_cutset_fused_evidence_only_on_cutset():
    factors, sizes, values = grid_mrf_model(3, 3, seed=6)
    names = list(sizes)
    cut = names[4]
    B = 3
    m = np.zeros((B, sizes[cut]), dtype=np.float32)
    m[:, 1] = 1.0
    masks = {cut: m}
    ce = CutsetEngine(factors, sizes, values, cutset=[cut])
    pf, zf = ce.posterior_batch(masks, mode="fused")
    pu, zu = ce.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zu), rtol=1e-4)
    for v in sizes:
        np.testing.assert_allclose(
            np.asarray(pf[v]), np.asarray(pu[v]), rtol=1e-4, atol=1e-6
        )


def test_cutset_fused_structural_check_and_parity():
    """_fused_routing is the structural check (level groups collapse on a
    regular star; NOT on the irregular hailfinder-class reduced model —
    42 groups / 43 cliques, structure diversity).  Auto mode always runs
    the unrolled program (the fused variant's gain is not measured on the
    GPU — see bench 'cutset fused-vs-unrolled'); forced fused mode stays
    exact."""
    # regular: v -> hub -> 40 identical leaves; cutting v leaves a star
    n_leaves = 40
    sizes = {"v": 3, "hub": 2}
    factors = []
    for i in range(n_leaves):
        leaf = f"leaf{i}"
        sizes[leaf] = 2
        factors.append(["v", "hub", leaf])
    rng = np.random.default_rng(11)
    values = [
        rng.random((3, 2, 2)).astype(np.float64) + 0.05 for _ in factors
    ]
    ce = CutsetEngine(factors, sizes, values, cutset=["v"])
    assert ce.num_states == 3
    assert ce._fused_routing()
    B = 3
    masks = {"leaf0": np.tile(
        np.array([[1.0, 0.0]], dtype=np.float32), (B, 1)
    )}
    pf, zf = ce.posterior_batch(masks, mode="fused")
    pu, zu = ce.posterior_batch(masks)           # auto = unrolled
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zu), rtol=1e-4)
    for v in sizes:
        np.testing.assert_allclose(
            np.asarray(pf[v]), np.asarray(pu[v]), rtol=1e-4, atol=1e-5
        )

    # irregular: the dense-BN reduced model's groups don't collapse
    hf, hs, hv = hailfinder_like()
    hce = CutsetEngine(hf, hs, hv, target_states=1 << 14, max_enum=512)
    assert not hce._fused_routing()


def test_cutset_impossible_evidence_zero_posteriors():
    """Impossible evidence through every cutset serving mode must follow the
    engine's contract — zero posteriors and logZ=-inf, never NaN (round-5
    driving found the aggregations produced NaN; Engine.posterior_batch and
    joint_marginal_batch already guard this)."""
    factors, sizes, values = grid_mrf_model(4, 4, seed=0)
    names = list(sizes)
    B = 3
    ce = CutsetEngine(factors, sizes, values, cutset=[names[5]])
    imp = {names[0]: np.zeros((B, 2), dtype=np.float32)}
    for mode in ("auto", "fused"):
        out, logz = ce.posterior_batch(imp, mode=mode)
        assert np.all(np.isneginf(np.asarray(logz))), mode
        for v, p in out.items():
            arr = np.asarray(p)
            assert not np.isnan(arr).any(), (mode, v)
            np.testing.assert_allclose(arr, 0.0, rtol=0, err_msg=str((mode, v)))
    # a mixed batch: one impossible row, two possible rows
    m = np.ones((B, 2), dtype=np.float32)
    m[1] = 0.0
    out, logz = ce.posterior_batch({names[0]: m})
    logz = np.asarray(logz)
    assert np.isneginf(logz[1]) and np.isfinite(logz[0]) and np.isfinite(logz[2])
    for v, p in out.items():
        arr = np.asarray(p)
        assert not np.isnan(arr).any(), v
        np.testing.assert_allclose(arr[1], 0.0, rtol=0)
        np.testing.assert_allclose(arr[0].sum(), 1.0, rtol=1e-5)
