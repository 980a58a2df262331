"""Differentiability: the compiled propagation is pure JAX, so gradients of
the log-partition function with respect to log-potentials are exact expected
sufficient statistics (normalized clique marginals) — the foundation for
maximum-likelihood MRF learning on the accelerator, a capability with no reference
analog (the reference is NumPy-only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import junctiontree_tpu as jt
from junctiontree_tpu.executor import (
    evaluate_cliques,
    factor_marginals,
    partition,
    propagate_cliques,
)

from .util import brute_force_marginals, grid_mrf, random_values


def _logz_from_theta(plan, thetas):
    """logZ as a function of per-factor log-potentials (linear-space engine
    on exp(theta), log at the end — differentiable end to end)."""
    vals = [jnp.exp(t) for t in thetas]
    pots = evaluate_cliques(plan, vals)
    beliefs, _ = propagate_cliques(plan, pots)
    return jnp.log(partition(plan, beliefs))


def test_grad_logz_is_marginals():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=21)
    plan = jt.compile_plan(factors, sizes)
    thetas = [jnp.asarray(np.log(v)) for v in values]

    grads = jax.grad(_logz_from_theta, argnums=1)(plan, thetas)
    expect = brute_force_marginals(factors, sizes, values, factors)
    z = expect[0].sum()
    for g, e in zip(grads, expect):
        np.testing.assert_allclose(np.asarray(g), e / z, rtol=1e-6, atol=1e-9)


def test_gradient_ascent_fits_marginals():
    """Three steps of MLE gradient ascent on a tiny MRF decrease the
    KL to a target distribution's moments (smoke test of learnability)."""
    factors, sizes = grid_mrf(2, 2)
    plan = jt.compile_plan(factors, sizes)
    rng = np.random.default_rng(5)
    target_vals = random_values(factors, sizes, seed=99)
    target_m = brute_force_marginals(factors, sizes, target_vals, factors)
    tz = target_m[0].sum()
    target_m = [jnp.asarray(m / tz) for m in target_m]

    thetas = [jnp.zeros(tuple(sizes[v] for v in f)) for f in factors]

    def nll(thetas):
        # maximize sum_f <target_m_f, theta_f> - logZ(theta)
        lin = sum(jnp.vdot(m, t) for m, t in zip(target_m, thetas))
        return _logz_from_theta(plan, thetas) - lin

    loss = jax.jit(nll)
    grad = jax.jit(jax.grad(nll))
    losses = [float(loss(thetas))]
    for _ in range(3):
        g = grad(thetas)
        thetas = [t - 0.5 * gi for t, gi in zip(thetas, g)]
        losses.append(float(loss(thetas)))
    assert losses[-1] < losses[0]
    assert all(b <= a + 1e-9 for a, b in zip(losses, losses[1:]))
