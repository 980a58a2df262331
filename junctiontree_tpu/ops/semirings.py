"""Pluggable semirings for message passing (the "distributive law").

Equivalent role to the reference's ``SumProduct`` wrapper
(/root/reference/junctiontree/sum_product.py:2-35), which anticipates but never
implements alternatives to sum-product.  Here the abstraction is real:

  * SUM_PRODUCT   — linear-space sum-product: contractions are ``jnp.einsum``,
                    which XLA lowers to matmuls.  Exact parity semiring.
  * LOG_SUM_EXP   — log-space sum-product: multiply = add, marginalize =
                    logsumexp.  Numerically safe on large networks where
                    unnormalized linear-space beliefs under/overflow.
  * MAX_PRODUCT   — (log-space) max-product for MAP queries: multiply = add,
                    marginalize = max.

A semiring exposes ``contract(operands, operand_vars, out_vars, sizes)``: the
generalized einsum `product of operands, reduced to out_vars`.  For
SUM_PRODUCT this builds an einsum subscript (matmul path); the others
broadcast to the union scope and reduce (elementwise path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"

# Matmul precision for sum-product einsums.  "highest" keeps full float32
# contractions (exact-inference default; ~1e-7 parity with CPU); on a GPU
# "default" lets XLA use TF32 tensor cores for float32 (~1e-3 error, higher
# throughput) — flip it for throughput-bound serving with
# set_matmul_precision("default").
_MATMUL_PRECISION = "highest"

# log_sum_exp contractions whose union scope has at least this many states
# go through the max-shifted linear einsum (log-matmul-exp) instead of
# broadcast+logsumexp-reduce — see Semiring.contract
LOG_EINSUM_MIN_STATES = 1 << 16


def set_matmul_precision(p: str) -> None:
    global _MATMUL_PRECISION
    assert p in ("default", "high", "highest")
    _MATMUL_PRECISION = p


def get_matmul_precision() -> str:
    return _MATMUL_PRECISION


def make_subscripts(
    operand_vars: Sequence[Sequence[int]], out_vars: Sequence[int]
) -> str:
    """Einsum subscripts for int-labelled axes, relabelled to letters per call."""
    local: dict = {}
    for vs in operand_vars:
        for v in vs:
            if v not in local:
                local[v] = _LETTERS[len(local)]
    for v in out_vars:
        if v not in local:
            # output-only var (broadcast target); give it a letter anyway —
            # caller must have broadcast the operand already
            local[v] = _LETTERS[len(local)]
    ins = ",".join("".join(local[v] for v in vs) for vs in operand_vars)
    outs = "".join(local[v] for v in out_vars)
    return ins + "->" + outs


def _union_scope(operand_vars: Sequence[Sequence[int]], out_vars: Sequence[int]):
    scope: List[int] = []
    seen = set()
    for vs in list(operand_vars) + [list(out_vars)]:
        for v in vs:
            if v not in seen:
                seen.add(v)
                scope.append(v)
    return scope


def _broadcast_to_scope(
    x: jnp.ndarray, vs: Sequence[int], scope: Sequence[int]
) -> jnp.ndarray:
    """Transpose/expand x (axes labelled vs) to the full scope layout."""
    pos = {v: i for i, v in enumerate(vs)}
    perm = [pos[v] for v in scope if v in pos]
    x = jnp.transpose(x, perm)
    shape_ix = 0
    new_shape = []
    for v in scope:
        if v in pos:
            new_shape.append(x.shape[shape_ix])
            shape_ix += 1
        else:
            new_shape.append(1)
    return x.reshape(new_shape)


@dataclass(frozen=True)
class Semiring:
    name: str
    is_log: bool
    # reduce(x, axes) -> marginalized array ; combine = elementwise product op
    _reduce: Callable
    _combine: Callable
    one: float  # multiplicative identity in this space
    # accum(a, b) -> elementwise semiring addition (the binary form of
    # _reduce; used by the grouped-unrolled contraction path)
    _accum: Callable = jnp.add

    def contract(
        self,
        operands: Sequence[jnp.ndarray],
        operand_vars: Sequence[Sequence[int]],
        out_vars: Sequence[int],
    ) -> jnp.ndarray:
        """product(operands) marginalized onto out_vars.

        Every out_var must appear in some operand (callers broadcast clique
        scopes explicitly — see executor), so no output-only axes arise here.
        """
        if self.name == "sum_product":
            # exhaustive contraction-path search is exponential in operand
            # count (a 10-child clique hangs it); switch to greedy beyond 6
            opt = "optimal" if len(operands) <= 6 else "greedy"
            # low-precision storage (config.storage_dtype="bfloat16"):
            # accumulate in f32 — no accuracy cliff from long reduction
            # chains
            pet = (
                jnp.float32
                if any(
                    jnp.result_type(o) in (jnp.bfloat16, jnp.float16)
                    for o in operands
                )
                else None
            )
            return jnp.einsum(
                make_subscripts(operand_vars, out_vars),
                *operands,
                optimize=opt,
                precision=_MATMUL_PRECISION,
                preferred_element_type=pet,
            )
        scope = _union_scope(operand_vars, out_vars)
        if self.name == "log_sum_exp" and len(operands) > 1:
            # Large scopes: log-matmul-exp.  The broadcast+reduce below
            # materializes the full union scope ([B, prod(extents)] floats —
            # 51 GB on a hailfinder-class batched contraction), whereas a
            # max-shifted linear einsum lets opt_einsum contract pairwise as
            # matmuls and never builds the union tensor.  Per-operand global
            # max shift: entries more than ~87 nats below an operand's max
            # underflow to the semiring zero — exact for the mass that
            # matters, and the fallback below remains in force for small
            # scopes where full per-element precision is cheap.
            extent = {}
            for x, vs in zip(operands, operand_vars):
                for d, v in zip(jnp.shape(x), vs):
                    extent[v] = int(d)
            union = 1
            for v in scope:
                union *= extent.get(v, 1)
            if union >= LOG_EINSUM_MIN_STATES:
                shifts = []
                lin = []
                for x, vs in zip(operands, operand_vars):
                    m = jax.lax.stop_gradient(jnp.max(x))
                    m = jnp.where(jnp.isfinite(m), m, 0.0)
                    shifts.append(m)
                    lin.append(jnp.exp(x - m))
                opt = "optimal" if len(operands) <= 6 else "greedy"
                y = jnp.einsum(
                    make_subscripts(operand_vars, out_vars),
                    *lin,
                    optimize=opt,
                    precision=_MATMUL_PRECISION,
                )
                tot = shifts[0]
                for m in shifts[1:]:
                    tot = tot + m
                return jnp.where(y > 0, jnp.log(jnp.maximum(y, 1e-38)), -jnp.inf) + tot
        acc = _broadcast_to_scope(operands[0], operand_vars[0], scope)
        for x, vs in zip(operands[1:], operand_vars[1:]):
            acc = self._combine(acc, _broadcast_to_scope(x, vs, scope))
        out_set = set(out_vars)
        axes = tuple(i for i, v in enumerate(scope) if v not in out_set)
        if axes:
            acc = self._reduce(acc, axes)
        # reorder remaining axes to out_vars order
        rem = [v for v in scope if v in out_set]
        perm = [rem.index(v) for v in out_vars]
        return jnp.transpose(acc, perm)

    def combine(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        return self._combine(a, b)

    def divide(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Inverse of combine where defined (used only by normalization)."""
        if self.is_log:
            return a - b
        return a / b

    def to_linear(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.exp(x) if self.is_log else x

    def from_linear(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.is_log:
            return jnp.log(x)
        return x


SUM_PRODUCT = Semiring(
    name="sum_product",
    is_log=False,
    _reduce=lambda x, axes: jnp.sum(x, axis=axes),
    _combine=jnp.multiply,
    one=1.0,
)

LOG_SUM_EXP = Semiring(
    name="log_sum_exp",
    is_log=True,
    _reduce=lambda x, axes: jax.nn.logsumexp(x, axis=axes),
    _combine=jnp.add,
    one=0.0,
    _accum=jnp.logaddexp,
)

MAX_PRODUCT = Semiring(
    name="max_product",
    is_log=True,
    _reduce=lambda x, axes: jnp.max(x, axis=axes),
    _combine=jnp.add,
    one=0.0,
    _accum=jnp.maximum,
)

SEMIRINGS = {s.name: s for s in (SUM_PRODUCT, LOG_SUM_EXP, MAX_PRODUCT)}
