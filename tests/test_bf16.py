"""bfloat16 storage serving mode (config.storage_dtype): posterior parity
within bf16 tolerance, f32 outputs, doubled capacity, f32-exact parity paths.

The reference is float64 NumPy throughout and has no notion of a storage
dtype; this mode exists for the compiled path (halved memory traffic on
capacity-bound models, f32 accumulation via preferred_element_type)."""

import numpy as np
import pytest

import jax.numpy as jnp

import junctiontree_tpu as jt
from junctiontree_tpu.config import DEFAULT
from junctiontree_tpu.evidence import batch_masks_sparse, random_evidence_batch
from junctiontree_tpu.models import grid_mrf_model, hailfinder_like


@pytest.fixture
def bf16_config():
    old = DEFAULT.storage_dtype
    DEFAULT.storage_dtype = "bfloat16"
    yield
    DEFAULT.storage_dtype = old


def _posts(eng, masks):
    posts, logz = eng.posterior_batch(masks, mode="general")
    return [np.asarray(p) for p in posts], np.asarray(logz)


def test_bf16_posterior_parity_grid(bf16_config):
    factors, sizes, values = grid_mrf_model(6, 6, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    B = 16
    evs = random_evidence_batch(tree.plan, B, list(sizes)[:8], seed=4)
    masks = batch_masks_sparse(tree.plan, evs)

    eng16 = tree.engine().set_potentials(values)
    assert eng16._storage_dtype() == jnp.bfloat16
    got, logz16 = _posts(eng16, masks)
    # outputs are f32 regardless of storage
    posts_raw, _ = eng16.posterior_batch(masks, mode="general")
    assert all(np.asarray(p).dtype == np.float32 for p in posts_raw)

    DEFAULT.storage_dtype = "float32"
    eng32 = jt.create_junction_tree(factors, sizes).engine()
    eng32.set_potentials(values)
    want, logz32 = _posts(eng32, masks)

    np.testing.assert_allclose(logz16, logz32, rtol=0, atol=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=0.02)


def test_bf16_doubles_feasible_batch(bf16_config):
    factors, sizes, values = hailfinder_like()
    eng = jt.create_junction_tree(factors, sizes).engine()
    b16 = eng.max_feasible_batch()
    DEFAULT.storage_dtype = "float32"
    b32 = eng.max_feasible_batch()
    assert b16 == 2 * b32


def test_bf16_leaves_parity_paths_f32(bf16_config):
    """propagate (the reference-parity path) must stay exact f32."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    got = tree.propagate(values)
    DEFAULT.storage_dtype = "float32"
    want = jt.create_junction_tree(factors, sizes).propagate(values)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)


def test_bf16_log_engine_unaffected(bf16_config):
    """log-space engines keep f32 storage (bf16 logsumexp loses the tail)."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=2)
    eng = jt.create_junction_tree(factors, sizes).engine("log_sum_exp")
    assert eng._storage_dtype() == jnp.float32


def test_bf16_big_clique_routed(bf16_config):
    """A big-clique model routed through the factored contraction (the
    tensor-parallel route of Engine.shard_model, here on a 2-way model
    axis) with bf16 storage still matches the f32 answer within bf16
    tolerance (the contraction accumulates f32)."""
    from junctiontree_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    nv = 12
    names = [f"v{i}" for i in range(nv)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 2 for n in names}
    values = [rng.random((2,) * nv).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names
    ]
    B = 8
    masks = {}
    for n in names[:5]:
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[n] = m

    mesh = make_mesh(n_batch=1, n_model=2)
    eng16 = jt.create_junction_tree(factors, sizes).engine()
    eng16.shard_model(mesh, min_states=1 << 10).set_potentials(values)
    got, logz16 = _posts(eng16, masks)
    assert not eng16._tp_notes  # every big-clique step took the route
    DEFAULT.storage_dtype = "float32"
    eng32 = jt.create_junction_tree(factors, sizes).engine()
    eng32.set_potentials(values)
    want, logz32 = _posts(eng32, masks)
    np.testing.assert_allclose(logz16, logz32, rtol=0, atol=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=0.02)
