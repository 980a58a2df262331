"""Card-only checks of full-precision contractions and the serving path.

Run on a GPU with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
Without a card each test skips; whether a card is present is decided in
the ``gpu_device`` fixture, never at import time."""

import numpy as np
import pytest

from chip_smoke import FACTORED_RTOL

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_device():
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU visible to JAX")
    return devs[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "R1,R2,C,B", [(64, 2048, 2, 4096), (64, 4096, 1, 4096), (20, 300, 3, 33)]
)
def test_factored_contraction_full_precision(gpu_device, R1, R2, C, B, dtype):
    """The factored big-clique contraction at the 2^18-state clique's route
    shapes: float32 must stay full precision on the card (TF32 products
    would miss the 1e-5 relative bound by two orders of magnitude).
    bfloat16 storage accumulates in float32; its bound is chip_smoke's."""
    import jax
    import jax.numpy as jnp

    from junctiontree_tpu.ops.factored import reference_factored_contract

    rng = np.random.default_rng(R1 + R2 + C)
    args = [
        jax.device_put(jnp.asarray(rng.random(s), dtype=dtype), gpu_device)
        for s in ((R1, R2, C), (B, R1), (B, R2))
    ]
    got = np.asarray(jax.jit(reference_factored_contract)(*args))
    want = np.einsum("rsc,br,bs->bc",
                     *(np.asarray(x, np.float64) for x in args))
    np.testing.assert_allclose(got, want, rtol=FACTORED_RTOL[dtype])


def test_posterior_batch_on_card_matches_numpy_reference(gpu_device):
    import junctiontree_tpu as jt
    from junctiontree_tpu.evidence import (
        batch_masks_sparse,
        random_evidence_batch,
    )
    from junctiontree_tpu.models import grid_mrf_model

    from .util import numpy_tree_propagate

    factors, sizes, values = grid_mrf_model(5, 5, card=3, seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)
    evs = random_evidence_batch(tree.plan, 64, list(sizes)[::3], seed=1)
    post, logz = eng.posterior_batch(batch_masks_sparse(tree.plan, evs))
    assert next(iter(logz.devices())).platform == "gpu"
    for b in range(4):
        ref, ref_lz = numpy_tree_propagate(tree.plan, values, evs[b])
        assert abs(float(np.asarray(logz)[b]) - ref_lz) < 1e-4
        for vid, m in enumerate(ref):
            np.testing.assert_allclose(np.asarray(post[vid])[b], m,
                                       rtol=1e-4, atol=1e-6)
