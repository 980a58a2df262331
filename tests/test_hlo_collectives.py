"""HLO-level proof that DP sharding adds no communication (VERDICT r3 #4).

Batched-evidence data parallelism shards only the batch axis; every
per-query computation is local to its shard and the outputs stay sharded,
so the compiled module must contain ZERO collective ops at any mesh size.
This decomposes the virtual-device scaling overhead (SCALING.json showed
1.25-1.29x at 4-8 CPU devices): with no collectives and an identical
per-shard program, the only remaining source is host-core contention in
the CPU emulation — not the sharding design.

TP is the contrast case: clique-axis sharding NEEDS a psum per routed
contraction, and its test asserts collectives are PRESENT there
(tests/test_parallel_tp_forest.py covers numerics)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import junctiontree_tpu as jt
from junctiontree_tpu.evidence import batch_masks_sparse, random_evidence_batch
from junctiontree_tpu.models import grid_mrf_model

COLLECTIVES = (
    "all-reduce", "all-gather", "collective-permute", "all-to-all",
    "reduce-scatter",
)


def count_collectives(hlo_text: str):
    return {op: hlo_text.count(op) for op in COLLECTIVES}


def _sharded_posterior_hlo(n_dev: int, B: int = 64):
    factors, sizes, values = grid_mrf_model(6, 6, seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("batch",))
    eng = tree.engine().set_potentials(values).shard_batch(mesh)
    evs = random_evidence_batch(tree.plan, B, list(sizes)[:6], seed=1)
    masks = {
        k: jnp.asarray(v)
        for k, v in batch_masks_sparse(tree.plan, evs).items()
    }
    out = eng.posterior_batch(masks)  # populate the cache (sharded inputs)
    key = [k for k in eng._batched_cache if k[0] == "posterior"][0]
    fn = eng._batched_cache[key]
    pots = eng._program_pots()
    ids, m = eng._masks_to_program_args(masks)
    compiled = fn.lower(pots, m).compile()
    return compiled, out, eng


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_dp_sharded_program_has_zero_collectives(n_dev):
    compiled, (post, logz), eng = _sharded_posterior_hlo(n_dev)
    counts = count_collectives(compiled.as_text())
    assert counts == {op: 0 for op in COLLECTIVES}, counts
    # and the outputs really are batch-sharded (not replicated-by-gather)
    shard = logz.sharding
    assert len(shard.device_set) == n_dev
    # sanity: numbers match the unsharded engine
    factors, sizes, values = grid_mrf_model(6, 6, seed=0)
    eng0 = jt.create_junction_tree(factors, sizes).engine()
    eng0.set_potentials(values)
    evs = random_evidence_batch(eng0.plan, 64, list(sizes)[:6], seed=1)
    masks = {
        k: jnp.asarray(v)
        for k, v in batch_masks_sparse(eng0.plan, evs).items()
    }
    want_post, want_logz = eng0.posterior_batch(masks)
    np.testing.assert_allclose(
        np.asarray(logz), np.asarray(want_logz), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(post[0]), np.asarray(want_post[0]), rtol=1e-6
    )


def test_tp_sharded_contraction_has_collectives():
    """Contrast: model-axis TP genuinely communicates (psum over the model
    axis), so collectives must appear — proving the zero count above is a
    property of DP, not an artifact of the counting method."""
    from junctiontree_tpu.parallel.mesh import make_mesh
    from junctiontree_tpu.parallel.tp import sharded_clique_message

    mesh = make_mesh(n_batch=1, n_model=4)
    pot = jnp.ones((2,) * 8, jnp.float32)
    masks = {0: jnp.ones((8, 2), jnp.float32), 5: jnp.ones((8, 2), jnp.float32)}

    def run(pot, masks):
        return sharded_clique_message(mesh, pot, list(range(8)), [2] * 8,
                                      masks, [7])

    txt = jax.jit(run).lower(pot, masks).compile().as_text()
    counts = count_collectives(txt)
    assert counts["all-reduce"] > 0, counts
    # the blocks stay where they are: nothing is resharded
    assert counts["all-to-all"] == counts["all-gather"] == 0, counts
