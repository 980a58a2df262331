"""Compatibility facade mirroring the reference's ``junctiontree.sum_product``
module (/root/reference/junctiontree/sum_product.py): a ``SumProduct`` class
wrapping a pluggable contraction backend with the reference's interleaved
``einsum(arr0, vars0, arr1, vars1, ..., out_vars)`` calling convention.

Unlike the reference, label interning is deterministic (first-appearance
order, not Python set iteration order — the reference's set-order mapping at
sum_product.py:26 makes its results PYTHONHASHSEED-dependent and can produce
wrong marginals; see tests/test_reference_parity.py)."""

from __future__ import annotations

from typing import Any, List

import numpy as np

from .ops.semirings import LOG_SUM_EXP, MAX_PRODUCT, SUM_PRODUCT, Semiring


class SumProduct:
    """Distributive-law wrapper with the reference's interleaved einsum API.

    Like the reference (sum_product.py:6-12), the contraction backend is
    pluggable two ways: pass a ``Semiring`` (or its name) for the
    compiled paths, or pass any einsum-compatible callable (e.g.
    ``np.einsum``, a custom opt_einsum wrapper) plus default kwargs — the
    callable receives the standard subscripts string and arrays."""

    def __init__(self, semiring: Semiring = SUM_PRODUCT, **einsum_kwargs):
        self._einsum_fn = None
        self._einsum_kwargs = einsum_kwargs
        if isinstance(semiring, str):
            from .ops.semirings import SEMIRINGS

            semiring = SEMIRINGS[semiring]
        elif callable(semiring) and not isinstance(semiring, Semiring):
            # injected einsum backend, reference-style
            self._einsum_fn = semiring
            semiring = SUM_PRODUCT
        self.semiring = semiring

    def einsum(self, *args: Any) -> np.ndarray:
        """einsum(arr0, vars0, arr1, vars1, ..., out_vars) with arbitrary
        hashable variable labels (reference sum_product.py:14-35)."""
        if len(args) % 2 != 1:
            raise ValueError(
                "expected interleaved (array, vars, ..., out_vars) arguments"
            )
        operands = list(args[0:-1:2])
        operand_vars = list(args[1:-1:2])
        out_vars = list(args[-1])
        # deterministic interning: first appearance order
        table: dict = {}
        for vs in operand_vars + [out_vars]:
            for v in vs:
                table.setdefault(v, len(table))
        int_ovs = [[table[v] for v in vs] for vs in operand_vars]
        int_out = [table[v] for v in out_vars]
        if self._einsum_fn is not None:
            from .ops.semirings import make_subscripts

            return np.asarray(
                self._einsum_fn(
                    make_subscripts(int_ovs, int_out), *operands,
                    **self._einsum_kwargs,
                )
            )
        import jax.numpy as jnp

        result = self.semiring.contract(
            [jnp.asarray(o) for o in operands],
            int_ovs,
            int_out,
        )
        return np.asarray(result)
