"""Maximum-likelihood learning of factor-graph potentials on the accelerator.

Because propagation is pure JAX, the log-partition function is exactly
differentiable: grad(logZ) w.r.t. per-factor log-potentials equals the
model's expected sufficient statistics (normalized factor marginals).  So
maximum-likelihood fitting of an MRF to data is plain gradient ascent on

    L(theta) = sum_f <empirical_marginal_f, theta_f> - logZ(theta)

whose gradient is (empirical moments - model moments) — moment matching.
The reference (NumPy, inference-only) has no learning story at all.

Uses the rescaled posterior machinery for stability and optax if available
(plain SGD fallback otherwise)."""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .executor import evaluate_cliques, factor_marginals, partition, propagate_cliques
from .schedule import Plan


def empirical_marginals(
    plan: Plan, data: np.ndarray
) -> List[np.ndarray]:
    """Per-factor empirical frequency tables from complete data.

    data: [N, num_vars] int array (columns indexed by interned var id)."""
    N = data.shape[0]
    out = []
    for fvars in plan.factors:
        shape = tuple(plan.sizes[v] for v in fvars)
        if not fvars:
            out.append(np.ones(()))
            continue
        idx = tuple(data[:, v] for v in fvars)
        flat = np.ravel_multi_index(idx, shape)
        counts = np.bincount(flat, minlength=int(np.prod(shape)))
        out.append(counts.reshape(shape) / N)
    return out


def _logz(plan: Plan, thetas: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """logZ via rescaled linear-space propagation (stable at any model
    size; plain linear Z over/underflows float32 beyond ~100 variables)."""
    from .executor import batched_propagate_program

    prog = batched_propagate_program(plan, observed=[], rescale=True)
    vals = [jnp.exp(t) for t in thetas]
    pots = evaluate_cliques(plan, vals)
    _, logz = prog(pots, [])
    return logz[0]


def log_likelihood(plan: Plan, thetas: Sequence[jnp.ndarray],
                   emp: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Average complete-data log-likelihood under log-potentials theta."""
    lin = sum(jnp.vdot(m, t) for m, t in zip(emp, thetas))
    return lin - _logz(plan, thetas)


def fit_mle(
    plan: Plan,
    data: np.ndarray,
    steps: int = 200,
    learning_rate: float = 0.5,
    init_thetas: Optional[Sequence[np.ndarray]] = None,
    verbose: bool = False,
) -> Tuple[List[np.ndarray], List[float]]:
    """Fit factor log-potentials to complete data by gradient ascent.

    Returns (thetas, per-step average log-likelihoods).  Exact moment
    matching: at convergence the model's factor marginals equal the
    empirical tables."""
    emp = [jnp.asarray(m) for m in empirical_marginals(plan, data)]
    if init_thetas is None:
        thetas = [
            jnp.zeros(tuple(plan.sizes[v] for v in f)) for f in plan.factors
        ]
    else:
        # COPY warm-start arrays: the donated step would otherwise
        # invalidate the caller's own buffers (jnp.asarray is a no-op
        # for jax arrays)
        thetas = [jnp.array(t, copy=True) for t in init_thetas]

    loss_grad = jax.jit(
        jax.value_and_grad(lambda th: -log_likelihood(plan, th, emp))
    )

    try:
        import optax

        opt = optax.adam(learning_rate * 0.2)
        state = opt.init(thetas)

        # old params/optimizer state are dead the moment the step returns:
        # donating them lets XLA update in place instead of double-booking
        # every parameter + moment buffer (SURVEY §5 donation/aliasing row)
        @partial(jax.jit, donate_argnums=(0, 1))
        def step(thetas, state):
            loss, g = jax.value_and_grad(
                lambda th: -log_likelihood(plan, th, emp)
            )(thetas)
            updates, state = opt.update(g, state)
            return optax.apply_updates(thetas, updates), state, loss

        history = []
        for i in range(steps):
            thetas, state, loss = step(thetas, state)
            history.append(-float(loss))
            if verbose and i % 20 == 0:
                print(f"step {i}: avg loglik {-float(loss):.6f}")
    except ImportError:  # plain gradient ascent
        history = []
        for i in range(steps):
            loss, g = loss_grad(thetas)
            thetas = [t - learning_rate * gi for t, gi in zip(thetas, g)]
            history.append(-float(loss))

    return [np.asarray(t) for t in thetas], history


def model_marginals(plan: Plan, thetas: Sequence[jnp.ndarray]) -> List[np.ndarray]:
    """Normalized per-factor marginals of the model exp(theta)."""
    vals = [jnp.exp(jnp.asarray(t)) for t in thetas]
    pots = evaluate_cliques(plan, vals)
    beliefs, _ = propagate_cliques(plan, pots)
    z = partition(plan, beliefs)
    return [np.asarray(m / z) for m in factor_marginals(plan, beliefs)]


# ---------------------------------------------------------------------------
# Incomplete data: masks, marginal likelihood, gradient MLE, and EM.
#
# The whole machinery rides one identity: for p(x) ∝ exp(Σ_f θ_f·φ_f(x)),
#   ∂ logZ(evidence) / ∂ θ_f = E[φ_f | evidence],
# so expected sufficient statistics (the E-step) are one autodiff call on the
# batched, rescaled logZ program — no dedicated posterior-moment code path.
# ---------------------------------------------------------------------------


def masks_from_data(
    plan: Plan, data: np.ndarray, missing: int = -1
) -> List[np.ndarray]:
    """Evidence masks for (possibly incomplete) data.

    data: [N, num_vars] int array, columns indexed by interned var id;
    entries equal to ``missing`` mean unobserved.  Returns one [N, size_v]
    float32 mask per var id: one-hot where observed, all-ones where missing
    (the static-shape evidence representation — SURVEY.md §7, vs the
    reference's shape-changing slicing at computation.py:11-34)."""
    N = data.shape[0]
    masks = []
    for v in range(plan.num_vars):
        col = np.asarray(data[:, v])
        m = np.ones((N, plan.sizes[v]), dtype=np.float32)
        obs = col != missing
        if np.any((col[obs] < 0) | (col[obs] >= plan.sizes[v])):
            raise ValueError(f"state out of range for var id {v}")
        m[obs] = 0.0
        m[obs, col[obs]] = 1.0
        masks.append(m)
    return masks


def _obs_logz_program(plan: Plan):
    """fn(thetas, masks) -> logZ(evidence) [B], differentiable in thetas."""
    from .executor import batched_propagate_program

    prog = batched_propagate_program(
        plan, observed=list(range(plan.num_vars)), rescale=True
    )

    def fn(thetas, masks):
        pots = evaluate_cliques(plan, [jnp.exp(t) for t in thetas])
        _, logz = prog(pots, masks)
        return logz

    return fn


def marginal_log_likelihood(
    plan: Plan, thetas: Sequence[jnp.ndarray], masks: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """Average observed-data log-likelihood with missing entries:
    mean_b [logZ(evidence_b)] - logZ."""
    logz_obs = _obs_logz_program(plan)(
        [jnp.asarray(t) for t in thetas], list(masks)
    )
    return jnp.mean(logz_obs) - _logz(plan, [jnp.asarray(t) for t in thetas])


def fit_mle_missing(
    plan: Plan,
    data: np.ndarray,
    steps: int = 200,
    learning_rate: float = 0.1,
    init_thetas: Optional[Sequence[np.ndarray]] = None,
    missing: int = -1,
    verbose: bool = False,
) -> Tuple[List[np.ndarray], List[float]]:
    """Gradient MLE with missing data: ascend mean_b logZ(ev_b) - logZ.

    The gradient is E[φ|observed] (averaged over cases) minus the model
    moments — gradient EM.  Returns (thetas, per-step avg marginal log-lik)."""
    masks = [jnp.asarray(m) for m in masks_from_data(plan, data, missing)]
    if init_thetas is None:
        thetas = [
            jnp.zeros(tuple(plan.sizes[v] for v in f)) for f in plan.factors
        ]
    else:
        # COPY warm-start arrays: the donated step would otherwise
        # invalidate the caller's own buffers (jnp.asarray is a no-op
        # for jax arrays)
        thetas = [jnp.array(t, copy=True) for t in init_thetas]

    obs_logz = _obs_logz_program(plan)

    def neg_loglik(th):
        return _logz(plan, th) - jnp.mean(obs_logz(th, masks))

    try:
        import optax

        opt = optax.adam(learning_rate)
    except ImportError:
        opt = None

    if opt is not None:
        state = opt.init(thetas)

        @partial(jax.jit, donate_argnums=(0, 1))
        def step(thetas, state):
            loss, g = jax.value_and_grad(neg_loglik)(thetas)
            updates, state = opt.update(g, state)
            return optax.apply_updates(thetas, updates), state, loss

        history = []
        for i in range(steps):
            thetas, state, loss = step(thetas, state)
            history.append(-float(loss))
            if verbose and i % 20 == 0:
                print(f"step {i}: avg marginal loglik {-float(loss):.6f}")
    else:
        vg = jax.jit(jax.value_and_grad(neg_loglik))
        history = []
        for i in range(steps):
            loss, g = vg(thetas)
            thetas = [t - learning_rate * gi for t, gi in zip(thetas, g)]
            history.append(-float(loss))

    return [np.asarray(t) for t in thetas], history


def expected_counts(
    plan: Plan,
    values: Sequence[np.ndarray],
    masks: Sequence[jnp.ndarray],
) -> List[np.ndarray]:
    """E-step: Σ_b E[φ_f | evidence_b] per factor, via grad of Σ_b logZ_b."""
    obs_logz = _obs_logz_program(plan)
    thetas = [jnp.log(jnp.maximum(jnp.asarray(v), 1e-38)) for v in values]
    g = jax.grad(lambda th: jnp.sum(obs_logz(th, masks)))(thetas)
    return [np.asarray(c) for c in g]


def fit_em(
    plan: Plan,
    data: np.ndarray,
    steps: int = 50,
    child_axes: Optional[Sequence[int]] = None,
    init_values: Optional[Sequence[np.ndarray]] = None,
    smoothing: float = 1e-3,
    missing: int = -1,
    seed: int = 0,
    verbose: bool = False,
) -> Tuple[List[np.ndarray], List[float]]:
    """Classical EM for Bayesian networks (CPD factors) with missing data.

    Each factor is a CPD over its variable list; ``child_axes[f]`` is the
    axis (position in ``plan.factors[f]``) of the child variable (default:
    the last axis, the reference's README convention of P(child | parents)).
    E-step = one autodiff pass (expected counts); M-step = normalize counts
    along the child axis (closed form, monotone in the smoothed marginal
    likelihood).  Returns (values, per-iteration avg marginal log-lik).

    With complete data this reduces to one-shot maximum-likelihood counting.
    The reference has no learning support at all (SURVEY.md §2: inference
    only)."""
    nf = len(plan.factors)
    if child_axes is None:
        child_axes = [len(f) - 1 for f in plan.factors]
    child_axes = list(child_axes)
    if len(child_axes) != nf:
        raise ValueError("child_axes must align with plan.factors")

    rng = np.random.default_rng(seed)
    if init_values is None:
        values = []
        for f, ax in zip(plan.factors, child_axes):
            shape = tuple(plan.sizes[v] for v in f)
            t = rng.random(shape) + 0.5
            values.append(t / t.sum(axis=ax, keepdims=True))
    else:
        values = [np.asarray(v, dtype=np.float64) for v in init_values]

    masks = [jnp.asarray(m) for m in masks_from_data(plan, data, missing)]
    obs_logz = _obs_logz_program(plan)

    @jax.jit
    def e_step(thetas):
        logz = obs_logz(thetas, masks)
        g = jax.grad(lambda th: jnp.sum(obs_logz(th, masks)))(thetas)
        return logz, g

    history = []
    for it in range(steps):
        thetas = [jnp.log(jnp.maximum(jnp.asarray(v), 1e-38)) for v in values]
        logz, counts = e_step(thetas)
        # observed-data avg log-likelihood at the *current* parameters
        # (CPDs are normalized, so the free logZ is 0)
        history.append(float(jnp.mean(logz)))
        values = []
        for c, ax in zip(counts, child_axes):
            c = np.asarray(c, dtype=np.float64) + smoothing
            values.append(c / c.sum(axis=ax, keepdims=True))
        if verbose and it % 5 == 0:
            print(f"EM iter {it}: avg marginal loglik {history[-1]:.6f}")
    return values, history
