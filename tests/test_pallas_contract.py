"""Factored big-clique contraction: the XLA form, its tensor-parallel
sharding, and the weight-group wrapper (ops/factored.py, parallel/tp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from junctiontree_tpu.ops.factored import (
    big_clique_sep_message,
    build_weight_groups,
    reference_factored_contract,
)
from junctiontree_tpu.parallel.mesh import MODEL_AXIS, make_mesh
from junctiontree_tpu.parallel.tp import (
    local_scopes_cross,
    sharded_clique_message,
    split_prefix,
)


def _operands(R1, R2, C, B, seed):
    rng = np.random.default_rng(seed)
    pot = jnp.asarray(rng.random((R1, R2, C)), dtype=jnp.float32)
    w1 = jnp.asarray(rng.random((B, R1)), dtype=jnp.float32)
    w2 = jnp.asarray(rng.random((B, R2)), dtype=jnp.float32)
    return pot, w1, w2


def _oracle(pot, w1, w2):
    return np.einsum("rsc,br,bs->bc", *(np.asarray(x, np.float64)
                                        for x in (pot, w1, w2)))


SHAPES = [
    (16, 16, 1, 5),
    (64, 256, 2, 40),
    (20, 300, 3, 33),
    (300, 20, 5, 17),
    (81, 96, 2, 19),
    (1, 3, 4665, 4),       # degenerate depth-1 factorization, wide separator
    (256, 512, 1, 8),
    (64, 2048, 2, 64),     # the 2^18-state clique's marginal step
]


@pytest.mark.parametrize("R1,R2,C,B", SHAPES)
def test_factored_form_matches_oracle(R1, R2, C, B):
    pot, w1, w2 = _operands(R1, R2, C, B, R1 + R2 + C + B)
    got = reference_factored_contract(pot, w1, w2)
    assert got.shape == (B, C) and got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), _oracle(pot, w1, w2),
                               rtol=1e-5)


@pytest.mark.parametrize(
    "R1,R2,C,B", [(16, 16, 1, 5), (64, 256, 2, 40), (300, 20, 5, 17)]
)
def test_factored_form_bf16_inputs_f32_accumulation(R1, R2, C, B):
    """bf16 storage inputs come back f32 and match the f32 inputs within
    bf16 rounding of the operands."""
    pot, w1, w2 = _operands(R1, R2, C, B, R1 + R2 + C + B + 1)
    got = reference_factored_contract(
        pot.astype(jnp.bfloat16), w1.astype(jnp.bfloat16),
        w2.astype(jnp.bfloat16),
    )
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), _oracle(pot, w1, w2),
                               rtol=3e-2)


def _clique_oracle(pot, scope, masks, msgs, out_vars):
    """float64 einsum of the clique potential with its batched operands."""
    L = {v: chr(ord("a") + i) for i, v in enumerate(scope)}
    terms = ["".join(L[v] for v in scope)]
    ops = [np.asarray(pot, np.float64)]
    for v, m in masks.items():
        terms.append("z" + L[v])
        ops.append(np.asarray(m, np.float64))
    for vs, t in msgs:
        terms.append("z" + "".join(L[v] for v in vs))
        ops.append(np.asarray(t, np.float64))
    spec = ",".join(terms) + "->z" + "".join(L[v] for v in out_vars)
    return np.einsum(spec, *ops)


# (sizes, masked vars, messages' scopes, output vars): outputs over the
# split prefix, messages that touch it, mixed cardinalities (on a 4-way axis
# a leading 3 needs a longer prefix)
CLIQUES = [
    ((2,) * 8, [0, 3, 5], [], [7]),
    ((2,) * 8, [0, 3, 5], [], [1]),
    ((2,) * 8, [1, 6], [], []),
    ((2,) * 8, [2], [(0, 4)], [1, 4]),
    ((3, 2, 2, 4, 2), [0, 4], [(3, 4)], [3, 4]),
    ((3, 2, 2, 4, 2), [1], [(0, 2)], [0]),
]


MESHES = [
    (1, 2, False),
    (1, 4, False),
    (2, 2, True),      # DP x TP: batch sharded as well
    (1, 8, False),
]


def _routable(n_model, case):
    sizes, _, msg_scopes, out_vars = CLIQUES[case]
    return split_prefix(sizes, n_model) is not None and not (
        local_scopes_cross(list(range(len(sizes))), n_model, sizes,
                           out_vars, msg_scopes))


@pytest.mark.parametrize(
    "n_batch,n_model,shard_batch,case",
    [m + (c,) for m in MESHES for c in range(len(CLIQUES))
     if _routable(m[1], c)],
)
def test_tp_contract_matches_oracle(n_batch, n_model, shard_batch, case):
    """The clique message computed where the model axis holds each block
    of the flat potential (shard_map + psum) equals the single-device
    float64 oracle (every mesh and clique the router sends this way)."""
    sizes, masked, msg_scopes, out_vars = CLIQUES[case]
    scope = list(range(len(sizes)))
    rng = np.random.default_rng(case + n_model)
    B = 4 * n_batch
    pot = rng.random(sizes) + 0.1
    masks = {v: jnp.asarray(rng.random((B, sizes[v])), jnp.float32)
             for v in masked}
    msgs = [(vs, jnp.asarray(rng.random((B,) + tuple(sizes[v] for v in vs)),
                             jnp.float32)) for vs in msg_scopes]
    mesh = make_mesh(n_batch=n_batch, n_model=n_model)
    flat = jax.device_put(
        jnp.asarray(pot.reshape(-1), jnp.float32),
        NamedSharding(mesh, PartitionSpec(MODEL_AXIS)))
    got = sharded_clique_message(mesh, flat, scope, list(sizes), masks,
                                 out_vars, msgs, shard_batch=shard_batch)
    want = _clique_oracle(pot.astype(np.float32), scope, masks, msgs,
                          out_vars)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


@pytest.mark.parametrize(
    "sizes,n,k",
    [((2,) * 8, 4, 2), ((2,) * 8, 8, 3), ((3, 2, 2), 4, 3), ((4, 2), 4, 1),
     ((3, 3, 3), 2, None), ((4096, 2), 8192, None)],
)
def test_split_prefix(sizes, n, k):
    """The shortest run of leading variables whose states the axis size
    divides; none where no prefix up to MAX_PREFIX_STATES states does."""
    assert split_prefix(sizes, n) == k


def test_local_scopes_cross_merges_the_prefix():
    """A message over a prefix variable and an output variable crosses the
    separator on one card but not once the prefix is one local variable
    (the sum over the unwanted prefix variable runs after the psum)."""
    scope = list(range(6))
    assert local_scopes_cross(scope, 4, [2] * 6, [1, 5], [(0, 5)]) is False
    assert local_scopes_cross(scope, 4, [2] * 6, [5], [(0, 5)]) is True
    assert local_scopes_cross(scope, 4, [2] * 6, [5], [(3, 4)]) is False


def test_float64_operands_accumulate_f32():
    """f64 test configs go through the same einsum, accumulated in f32."""
    rng = np.random.default_rng(29)
    sizes = (2,) * 9
    pot = jnp.asarray(rng.random(sizes), dtype=jnp.float64)
    masks = {
        v: jnp.asarray(rng.random((3, 2)), dtype=jnp.float64)
        for v in range(8)
    }
    got = big_clique_sep_message(pot, list(range(9)), masks, [8])
    want = jnp.einsum("abcdefghi,xa,xb,xc,xd,xe,xf,xg,xh->xi", pot,
                      *[masks[v] for v in range(8)])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("n_obs", [4, 8])
def test_weight_groups_balance_the_rest_axes(n_obs, monkeypatch):
    """The factored contraction covers the whole clique (R1*R2*C states)
    with the observed rest vars split evenly between W1 and W2, and its
    result is the answer."""
    import junctiontree_tpu.ops.factored as fc

    rng = np.random.default_rng(31)
    n = 11
    pot = jnp.asarray(rng.random((2,) * n), dtype=jnp.float32)
    B = 5
    masks = {v: jnp.asarray(rng.random((B, 2)), dtype=jnp.float32)
             for v in range(n_obs)}
    seen = []

    def contract(p3, w1, w2):
        seen.append((p3.shape, w1.shape, w2.shape))
        return reference_factored_contract(p3, w1, w2)

    monkeypatch.setattr(fc, "reference_factored_contract", contract)
    got = big_clique_sep_message(pot, list(range(n)), masks, [n - 1])
    (R1, R2, C), w1s, w2s = seen[0]
    assert R1 * R2 * C == 2 ** n and C == 2
    assert w1s == (B, R1) and w2s == (B, R2)
    assert R1 == 2 ** (n_obs // 2)  # half of the observed rest vars
    letters = "abcdefghijk"
    want = jnp.einsum(
        letters + "," + ",".join("x" + letters[v] for v in range(n_obs))
        + "->xk", pot, *[masks[v] for v in range(n_obs)],
        precision="highest",
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


def test_build_weight_groups_balanced():
    rng = np.random.default_rng(0)
    masks = [jnp.asarray(rng.random((7, k)), dtype=jnp.float32) for k in (2, 3, 4, 2, 5)]
    w1, w2, g1, g2 = build_weight_groups(masks)
    assert sorted(g1 + g2) == list(range(5))
    # outer products reconstruct the joint product
    R1, R2 = w1.shape[1], w2.shape[1]
    assert R1 * R2 == 2 * 3 * 4 * 2 * 5
    # check one entry: joint weight at index (0,...,0) is prod of masks[.,0]
    np.testing.assert_allclose(
        float(w1[0, 0] * w2[0, 0]),
        float(np.prod([np.asarray(m)[0, 0] for m in masks])),
        rtol=1e-6,
    )


def test_big_clique_sep_message_matches_einsum():
    """End-to-end: wide clique, some observed rest vars, some observed sep
    vars, some unobserved — against a direct einsum oracle."""
    rng = np.random.default_rng(3)
    cvars = [10, 11, 12, 13, 14]            # var ids
    sizes = {10: 2, 11: 3, 12: 2, 13: 4, 14: 3}
    svars = [13, 14]
    B = 9
    pot = jnp.asarray(
        rng.random(tuple(sizes[v] for v in cvars)), dtype=jnp.float32
    )
    masks = {
        10: jnp.asarray(rng.random((B, 2)), dtype=jnp.float32),
        12: jnp.asarray(rng.random((B, 2)), dtype=jnp.float32),
        14: jnp.asarray(rng.random((B, 3)), dtype=jnp.float32),
    }
    got = big_clique_sep_message(
        pot, cvars, masks, svars
    )
    want = jnp.einsum(
        "abcde,xa,xc,xe->xde",
        pot, masks[10], masks[12], masks[14],
        precision="highest",
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
    )


def test_big_clique_sep_message_no_rest_masks():
    rng = np.random.default_rng(5)
    cvars = [0, 1, 2]
    pot = jnp.asarray(rng.random((2, 3, 4)), dtype=jnp.float32)
    masks = {2: jnp.asarray(rng.random((6, 4)), dtype=jnp.float32)}
    got = big_clique_sep_message(pot, cvars, masks, [2])
    want = jnp.einsum("abc,xc->xc", pot, masks[2], precision="highest")
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
    )


def test_big_clique_sep_message_with_messages():
    """Child messages fused into the kernel weight groups: overlapping
    rest-scoped messages (shared var -> same component), a sep-scoped
    message, plus masks — against a direct einsum oracle."""
    rng = np.random.default_rng(11)
    cvars = [0, 1, 2, 3, 4, 5]
    sizes = {0: 2, 1: 3, 2: 2, 3: 4, 4: 3, 5: 2}
    svars = [4, 5]
    B = 7
    pot = jnp.asarray(
        rng.random(tuple(sizes[v] for v in cvars)), dtype=jnp.float32
    )
    masks = {
        0: jnp.asarray(rng.random((B, 2)), dtype=jnp.float32),
        4: jnp.asarray(rng.random((B, 3)), dtype=jnp.float32),
    }
    m12 = jnp.asarray(rng.random((B, 3, 2)), dtype=jnp.float32)
    m23 = jnp.asarray(rng.random((B, 2, 4)), dtype=jnp.float32)
    m45 = jnp.asarray(rng.random((B, 3, 2)), dtype=jnp.float32)
    msgs = [((1, 2), m12), ((2, 3), m23), ((4, 5), m45)]
    got = big_clique_sep_message(
        pot, cvars, masks, svars, msgs=msgs
    )
    want = jnp.einsum(
        "abcdef,xa,xbc,xcd,xe,xef->xef",
        pot, masks[0], m12, m23, masks[4], m45,
        precision="highest",
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
    )
    # message order on a sep-scoped operand in reversed var order
    m54 = jnp.transpose(m45, (0, 2, 1))
    got2 = big_clique_sep_message(
        pot, cvars, masks, svars,
        msgs=[((1, 2), m12), ((2, 3), m23), ((5, 4), m54)],
    )
    np.testing.assert_allclose(
        np.asarray(got2), np.asarray(want), rtol=1e-5, atol=1e-6
    )


def test_big_clique_message_crossing_boundary_raises():
    rng = np.random.default_rng(13)
    pot = jnp.asarray(rng.random((2, 3, 4)), dtype=jnp.float32)
    msg = jnp.asarray(rng.random((5, 3, 4)), dtype=jnp.float32)
    with pytest.raises(ValueError, match="crosses"):
        big_clique_sep_message(
            pot, [0, 1, 2], {}, [2], msgs=[((1, 2), msg)]
        )


def test_depth_one_factorization():
    """No observed rest var: W1 is a unit column, the contraction is one
    plain reduction onto the separator."""
    rng = np.random.default_rng(19)
    sizes = (400, 130)
    pot = jnp.asarray(rng.random(sizes, np.float64), dtype=jnp.float32)
    masks = {1: jnp.asarray(rng.random((3, 130)), dtype=jnp.float32)}
    got = big_clique_sep_message(pot, [0, 1], masks, [1])
    want = jnp.einsum("ab,xb->xb", pot, masks[1], precision="highest")
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5
    )
