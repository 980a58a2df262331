"""lax.scan chain executor: O(1)-size XLA programs for chain-structured trees.

The unrolled static schedule (executor.py) compiles one contraction per
clique — ~33ms of XLA compile per clique measured, which is fine for
hundreds of cliques but not for UAI-scale chains (SURVEY.md §5 long-context
row: the reference recurses in Python per clique, computation.py:59-66, and
would hit the recursion limit past ~1000 cliques).

A chain junction tree with uniform cardinality K is exactly a batched HMM:
collect = forward scan of masked matvecs, distribute = backward scan, with
HMM-style per-step rescaling so everything stays in float32 linear space
(matmuls [B,K]x[K,K]).  jit cost is constant in chain length.

  F_0 = 1;  F_{k+1}[b,q] = sum_p F_k[b,p] * M_k[b,p] * pot_k[p,q]
  G_m = 1;  G_k[b,p]     = sum_q pot_k[p,q] * M_{k+1}[b,q] * G_{k+1}[b,q]
  posterior(v_k) ∝ F_k ⊙ M_k ⊙ G_k;   logZ = log Σ_p F_m M_m + offsets
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .schedule import Plan

_TINY = 1e-38


@dataclass(frozen=True)
class ChainLayout:
    """A junction tree recognized as a uniform chain.

    var_order: v_0..v_m (chain order, interned ids)
    clique_order: c_0..c_{m-1}; clique k covers (v_k, v_{k+1})
    transpose: per clique, True if its potential (axes in sorted-var order)
               must be transposed to get (v_k, v_{k+1}) layout
    card: the common cardinality K
    """

    var_order: List[int]
    clique_order: List[int]
    transpose: List[bool]
    card: int

    @staticmethod
    def detect(plan: Plan) -> Optional["ChainLayout"]:
        tree = plan.tree
        n = tree.num_cliques
        if n < 2:
            return None
        # every clique exactly 2 vars, every separator exactly 1 var
        if any(len(c) != 2 for c in plan.clique_vars):
            return None
        if any(len(s) != 1 for s in tree.separators):
            return None
        # path topology: degree <= 2, exactly two endpoints
        deg = [0] * n
        adj: List[List[int]] = [[] for _ in range(n)]
        for a, b, _ in tree.edges:
            deg[a] += 1
            deg[b] += 1
            adj[a].append(b)
            adj[b].append(a)
        ends = [i for i in range(n) if deg[i] == 1]
        if len(ends) != 2 or any(d > 2 for d in deg):
            return None
        # uniform cardinality
        cards = {plan.sizes[v] for c in plan.clique_vars for v in c}
        if len(cards) != 1:
            return None
        card = cards.pop()
        # walk the path
        order = [ends[0]]
        prev = -1
        while len(order) < n:
            cur = order[-1]
            nxt = [x for x in adj[cur] if x != prev]
            if len(nxt) != 1:
                return None
            prev = cur
            order.append(nxt[0])
        # recover the var chain: v_0 is the var of c_0 not shared with c_1
        var_order: List[int] = []
        transpose: List[bool] = []
        first = set(plan.clique_vars[order[0]])
        shared01 = first & set(plan.clique_vars[order[1]])
        if len(shared01) != 1:
            return None
        v0 = (first - shared01).pop()
        var_order.append(v0)
        cur_var = v0
        for k, c in enumerate(order):
            cv = plan.clique_vars[c]
            if cur_var not in cv:
                return None
            nxt_var = cv[1] if cv[0] == cur_var else cv[0]
            transpose.append(cv[0] != cur_var)
            var_order.append(nxt_var)
            cur_var = nxt_var
        # chain must cover every variable exactly once
        if sorted(var_order) != list(range(plan.num_vars)):
            return None
        return ChainLayout(var_order, order, transpose, card)


def stack_chain_potentials(
    layout: ChainLayout, pots_np: Sequence[np.ndarray]
) -> np.ndarray:
    """Host-side prestack of clique potentials into the [m, K, K] transition
    tensor (done once per model; keeps the jitted program free of a
    chain-length concatenate)."""
    return np.stack(
        [
            np.transpose(pots_np[c]) if layout.transpose[k] else pots_np[c]
            for k, c in enumerate(layout.clique_order)
        ]
    )


def chain_posterior_program(plan: Plan, layout: ChainLayout):
    """Build ``fn(A, masks) -> (posteriors per var id [B,K], logZ [B])``.

    ``A``: prestacked [m, K, K] transitions (``stack_chain_potentials``),
    linear space.  ``masks``: dict var_id -> [B, K] linear-space mask
    (observed vars only), or a prestacked [m+1, B, K] mask tensor in chain
    order (dense evidence, e.g. training data — avoids O(chain) scatters)."""
    m = len(layout.clique_order)
    K = layout.card

    def fn(A: jnp.ndarray, masks):
        dtype = A.dtype
        if isinstance(masks, dict):
            B = next(iter(masks.values())).shape[0] if masks else 1
            # stacked masks [m+1, B, K]: ones everywhere, scatter the (few)
            # observed variables — O(observed) traced ops, not O(chain length)
            chain_pos = {v: k for k, v in enumerate(layout.var_order)}
            M = jnp.ones((m + 1, B, K), dtype=dtype)
            for v, mk in masks.items():
                M = M.at[chain_pos[v]].set(jnp.asarray(mk, dtype=dtype))
        else:
            M = jnp.asarray(masks, dtype=dtype)
            B = M.shape[1]

        def fwd_step(carry, inp):
            F, off = carry
            a, mk = inp
            Fn = jnp.einsum(
                "bp,pq->bq", F * mk, a, precision="highest"
            )
            s = jnp.maximum(jnp.max(Fn, axis=-1, keepdims=True), _TINY)
            return (Fn / s, off + jnp.log(s[:, 0])), F

        (F_last, off_last), F_stack = jax.lax.scan(
            fwd_step,
            (jnp.ones((B, K), dtype=dtype), jnp.zeros((B,), dtype=dtype)),
            (A, M[:-1]),
        )

        def bwd_step(carry, inp):
            G = carry
            a, mk1 = inp
            Gp = jnp.einsum(
                "pq,bq->bp", a, mk1 * G, precision="highest"
            )
            s = jnp.maximum(jnp.max(Gp, axis=-1, keepdims=True), _TINY)
            return Gp / s, G

        G_last, G_stack_rev = jax.lax.scan(
            bwd_step,
            jnp.ones((B, K), dtype=dtype),
            (A, M[1:]),
            reverse=True,
        )
        # G_stack_rev[k] = G_{k+1}; prepend G_0 = G_last
        G_all = jnp.concatenate([G_last[None], G_stack_rev], axis=0)
        F_all = jnp.concatenate([F_stack, F_last[None]], axis=0)

        # posteriors per chain position, normalized (scales cancel)
        post = F_all * M * G_all  # [m+1, B, K]
        post = post / jnp.maximum(
            jnp.sum(post, axis=-1, keepdims=True), _TINY
        )

        # logZ from the forward pass
        zfin = jnp.sum(F_last * M[-1], axis=-1)
        logz = (
            jnp.where(zfin > 0, jnp.log(jnp.maximum(zfin, _TINY)), -jnp.inf)
            + off_last
        )

        # [m+1, B, K] stacked in chain order; caller maps var id -> position
        return post, logz

    return fn


def chain_posterior_parallel_program(
    plan: Plan, layout: ChainLayout, mesh=None, axis: str = "batch"
):
    """Sequence-parallel chain inference: log-depth associative scans.

    The sequential forward recurrence F_{k+1} = F_k (M_k ⊙ pot_k) is a
    product of per-step [K, K] matrices; ``jax.lax.associative_scan``
    computes all prefixes in O(log m) depth.  With ``mesh``, the step axis
    is split in contiguous blocks over ``axis`` (the SP/ring analog of
    SURVEY.md §2.3): each device scans its own block, the block products
    are exchanged by two all-gathers of [n, B, K, K], and each device
    enters its block with the product of the blocks before (forward) and
    after it (backward) — no other communication.  Each partial product is
    max-normalized inside the (still associative) combine, with
    log-offsets accumulated, so arbitrarily long chains stay in float32.

    Returns ``fn(A, masks) -> (posteriors stacked [m+1, B, K], logZ [B])``
    — same contract as ``chain_posterior_program`` (use for very long
    chains on multi-device meshes; the sequential scan does K^2 work per
    step vs K^3 here, so one card prefers the sequential program).
    ``A`` may carry identity transitions after its m real steps (padding
    the step axis to a multiple of the device count): an identity step
    with an all-ones mask changes no message, so results are exact."""
    m = len(layout.clique_order)
    K = layout.card

    def combine(x, y):
        ax, sx = x
        ay, sy = y
        prod = jnp.einsum("...pq,...qr->...pr", ax, ay, precision="highest")
        c = jnp.maximum(jnp.max(prod, axis=(-2, -1), keepdims=True), _TINY)
        return prod / c, sx + sy + jnp.log(c[..., 0, 0])

    def step(v, o, t, fwd):
        # one normalized vector-matrix step with its log offset
        v = (jnp.einsum("bp,bpq->bq", v, t, precision="highest") if fwd
             else jnp.einsum("bpq,bq->bp", t, v, precision="highest"))
        c = jnp.maximum(jnp.max(v, axis=-1), _TINY)
        return v / c[:, None], o + jnp.log(c)

    def blocks(T, Tb, Mf):
        """Posteriors of this block's positions, and the whole chain's
        forward vector (normalized) with its log offset."""
        zeros = jnp.zeros(T.shape[:2], dtype=T.dtype)
        # Pf[j] = T_0 ... T_j, Qb[j] = T'_j ... T'_last within the block.
        # NOTE: reverse=True associative_scan combines operands in REVERSED
        # order (a[n-1] ⊕ ... ⊕ a[k]); swapping the combine restores the
        # forward matrix-product order (verified empirically — see tests).
        Pf, Sf = jax.lax.associative_scan(combine, (T, zeros), axis=0)
        Qb, Sb = jax.lax.associative_scan(
            lambda x, y: combine(y, x), (Tb, zeros), axis=0, reverse=True
        )
        if mesh is None:
            n, d = 1, 0
            tf, of, tb, ob = Pf[-1:], Sf[-1:], Qb[:1], Sb[:1]
        else:
            n, d = mesh.shape[axis], jax.lax.axis_index(axis)
            tf, of = jax.lax.all_gather((Pf[-1], Sf[-1]), axis)
            tb, ob = jax.lax.all_gather((Qb[0], Sb[0]), axis)
        B = T.shape[1]
        ones = jnp.ones((B, K), dtype=T.dtype)
        f, fo = ones, jnp.zeros((B,), T.dtype)
        f_in, g_in = ones, ones
        for i in range(n):  # blocks before d enter this one (forward)
            f_in = jnp.where(i == d, f, f_in)
            f, fo = step(f, fo + of[i], tf[i], True)
        g = ones
        for i in reversed(range(n)):  # blocks after d (backward)
            g_in = jnp.where(i == d, g, g_in)
            g, _ = step(g, ob[i], tb[i], False)
        # F at each position (exclusive prefix), G (inclusive suffix)
        F = jnp.concatenate([
            f_in[None],
            jnp.einsum("bp,jbpq->jbq", f_in, Pf[:-1], precision="highest"),
        ])
        G = jnp.einsum("jbpq,bq->jbp", Qb, g_in, precision="highest")
        post = F * Mf * G
        post = post / jnp.maximum(jnp.sum(post, axis=-1, keepdims=True),
                                  _TINY)
        # every device holds the same f, fo: one copy each, block 0's used
        return post, f[None], fo[None]

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        blocks = jax.shard_map(
            blocks, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
        )

    def fn(A: jnp.ndarray, masks: Dict[int, jnp.ndarray]):
        B = next(iter(masks.values())).shape[0] if masks else 1
        dtype = A.dtype
        chain_pos = {v: k for k, v in enumerate(layout.var_order)}
        M = jnp.ones((A.shape[0] + 1, B, K), dtype=dtype)
        for v, mk in masks.items():
            M = M.at[chain_pos[v]].set(jnp.asarray(mk, dtype=dtype))
        # per-step transition matrices T_k[b, p, q] = M_k[b, p] * A_k[p, q]
        # and, backward, T'_k[b, p, q] = A_k[p, q] * M_{k+1}[b, q]
        T = M[:-1, :, :, None] * A[:, None, :, :]
        Tb = A[:, None, :, :] * M[1:, :, None, :]
        post, f, fo = blocks(T, Tb, M[:-1])
        f, fo = f[0], fo[0]
        last = f * M[-1]
        zfin = jnp.sum(last, axis=-1)
        post = jnp.concatenate(
            [post, (last / jnp.maximum(zfin, _TINY)[:, None])[None]]
        )[: m + 1]
        logz = (
            jnp.where(zfin > 0, jnp.log(jnp.maximum(zfin, _TINY)), -jnp.inf)
            + fo
        )
        return post, logz

    return fn


def chain_viterbi_program(plan: Plan, layout: ChainLayout):
    """Exact MAP decoding on a uniform chain: log-space max forward scan
    with argmax bookkeeping + traceback scan (classic Viterbi), O(1)-size
    XLA program in chain length.

    Returns ``fn(logA, logmasks) -> (assignment [B, m+1] int32, score [B])``
    where ``logA`` is the [m, K, K] log-transition stack
    (log of ``stack_chain_potentials``) and ``logmasks`` a dict
    var_id -> [B, K] log-space mask."""
    m = len(layout.clique_order)
    K = layout.card

    def fn(logA: jnp.ndarray, logmasks: Dict[int, jnp.ndarray]):
        B = next(iter(logmasks.values())).shape[0] if logmasks else 1
        dtype = logA.dtype
        chain_pos = {v: k for k, v in enumerate(layout.var_order)}
        LM = jnp.zeros((m + 1, B, K), dtype=dtype)
        for v, mk in logmasks.items():
            LM = LM.at[chain_pos[v]].set(jnp.asarray(mk, dtype=dtype))

        def fwd(V, inp):
            a, lm = inp
            # scores[b, p, q] = V[b,p] + lm[b,p] + a[p,q]
            scores = (V + lm)[:, :, None] + a[None]
            Vn = jnp.max(scores, axis=1)
            ptr = jnp.argmax(scores, axis=1).astype(jnp.int32)
            return Vn, ptr

        V_last, ptrs = jax.lax.scan(
            fwd, jnp.zeros((B, K), dtype=dtype), (logA, LM[:-1])
        )
        final = V_last + LM[-1]
        score = jnp.max(final, axis=-1)
        x_last = jnp.argmax(final, axis=-1).astype(jnp.int32)

        def back(x_next, ptr_k):
            x_k = jnp.take_along_axis(
                ptr_k, x_next[:, None], axis=1
            )[:, 0]
            return x_k, x_next

        x0, xs_rev = jax.lax.scan(back, x_last, ptrs, reverse=True)
        # xs_rev[k] = x_{k+1}; prepend x0
        assign = jnp.concatenate([x0[None], xs_rev], axis=0)  # [m+1, B]
        # reorder chain positions -> var-id columns
        order = np.argsort(np.asarray(layout.var_order))
        assign = jnp.transpose(assign, (1, 0))[:, order]
        return assign, score

    return fn


def chain_kbest_program(plan: Plan, layout: ChainLayout, k: int):
    """Exact k-best decoding on a uniform chain (list-Viterbi): the forward
    scan carries the top-k path scores per state ([B, K, k]); each step
    ranks the K*k candidate extensions per successor state with
    ``lax.top_k``; traceback follows (state, rank) pointers.  O(1)-size XLA
    program in chain length, like chain_viterbi_program.

    Distinct ranks are distinct PATHS by construction (each candidate is a
    distinct (predecessor state, predecessor rank) pair).  When fewer than
    k paths exist (k > K at early steps), padding entries score ~-2e30 —
    callers should drop scores below ``_KBEST_PAD_FLOOR``.

    Returns ``fn(logA, logmasks) -> (assign [B, k, m+1] int32 in var-id
    column order, scores [B, k] descending)``."""
    m = len(layout.clique_order)
    K = layout.card

    def fn(logA: jnp.ndarray, logmasks: Dict[int, jnp.ndarray]):
        B = next(iter(logmasks.values())).shape[0] if logmasks else 1
        dtype = logA.dtype
        chain_pos = {v: kk for kk, v in enumerate(layout.var_order)}
        LM = jnp.zeros((m + 1, B, K), dtype=dtype)
        for v, mk in logmasks.items():
            LM = LM.at[chain_pos[v]].set(jnp.asarray(mk, dtype=dtype))

        pad = jnp.asarray(_KBEST_PAD, dtype=dtype)
        V0 = jnp.full((B, K, k), pad, dtype=dtype).at[:, :, 0].set(0.0)

        def fwd(V, inp):
            a, lm = inp
            # cand[b, p, r, q] = V[b,p,r] + lm[b,p] + a[p,q]
            cand = (V + lm[:, :, None])[:, :, :, None] + a[None, :, None, :]
            # rank the K*k extensions per successor state q
            cand = jnp.transpose(cand, (0, 3, 1, 2)).reshape(B, K, K * k)
            top, idx = jax.lax.top_k(cand, k)          # [B, K, k]
            return top, idx.astype(jnp.int32)

        V_last, ptrs = jax.lax.scan(fwd, V0, (logA, LM[:-1]))
        final = (V_last + LM[-1][:, :, None]).reshape(B, K * k)
        scores, flat = jax.lax.top_k(final, k)          # [B, k]
        x_last = (flat // k).astype(jnp.int32)          # state q
        r_last = (flat % k).astype(jnp.int32)           # rank within q

        def back(carry, ptr_t):
            x, r = carry                                # each [B, k]
            # flat predecessor pointer for every kept path
            f = jnp.take_along_axis(
                ptr_t.reshape(B, K * k), (x * k + r), axis=1
            )
            return (f // k, f % k), x

        (_x0, _r0), xs_rev = jax.lax.scan(
            back, (x_last, r_last), ptrs, reverse=True
        )
        assign = jnp.concatenate([_x0[None], xs_rev], axis=0)  # [m+1, B, k]
        order = np.argsort(np.asarray(layout.var_order))
        assign = jnp.transpose(assign, (1, 2, 0))[:, :, order]
        return assign, scores

    return fn


_KBEST_PAD = -2e30
_KBEST_PAD_FLOOR = -1e29  # scores below this are padding, not real paths


class StackedPosteriors:
    """Lazy per-variable-id view over the chain program's stacked [m+1, B, K]
    posterior tensor.  Behaves like the list-of-arrays the general program
    returns (``post[var_id]`` -> [B, K]) without materializing one device
    slice per variable inside the compiled program."""

    def __init__(self, stacked: jnp.ndarray, var_order: Sequence[int]):
        self._stacked = stacked
        self._pos = {v: k for k, v in enumerate(var_order)}

    @property
    def stacked(self) -> jnp.ndarray:
        return self._stacked

    def __len__(self) -> int:
        return len(self._pos)

    def __getitem__(self, var_id: int) -> jnp.ndarray:
        return self._stacked[self._pos[var_id]]

    def __iter__(self):
        for v in range(len(self._pos)):
            yield self[v]
