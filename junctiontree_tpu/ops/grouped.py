"""Grouped-unrolled contractions: compile-cheap big-clique message ops.

Motivation: XLA's compile time grows superlinearly with tensor *rank*
(an earlier backend took about a minute for one rank-17 einsum that
contracts a 2^17-state clique potential against a batched child message
``[B, 2^16]``; its GPU compile time is not measured yet).  The same
contraction expressed as a few broadcast-multiply-accumulate ops over
*grouped* (low-rank, ≤ ~6 axes) operands compiles quickly and is
bandwidth-bound at runtime (its FLOP count is tiny, so one fused
elementwise pass is the least the device can do).

The trick: in junction-tree message passing the operands of a contraction
share most of their axes elementwise.  Sending a message from clique C to
separator S contracts ``pot[C] x msg[B, S_child] x masks... -> out[B, S]``
where ``S_child ∩ S`` is large (elementwise) and the genuinely *contracted*
cross-operand axes (``S_child \\ S`` etc.) are tiny — one or two small
variables.  So:

  1. pre-reduce every axis private to a single operand (one cheap reduce),
  2. bundle the remaining axes into groups by *operand-membership
     signature* (axes appearing in exactly the same operands fuse into one
     reshaped axis — every scope in a Plan is sorted by var id, so this is
     a pure reshape, no transposes),
  3. EITHER unroll the few contracted assignments (each contracted var
     kept as its own sliceable axis) — each term is an elementwise product
     of low-rank slices of the grouped views, accumulated with the
     semiring's addition — OR, when the contracted space is too large to
     unroll, fuse contracted axes by signature too, combine the grouped
     views over the union scope, and let XLA fuse the multiply chain into
     a single reduce.  No dots, no high-rank ops, either way.

Operands and results may be FLAT: an operand whose array rank doesn't
match its var list is taken as ``[B?, prod(sizes)]`` (grouping is a pure
reshape either way), and ``flat_out=True`` returns the result flat.  The
executor keeps every ≥2^14-state potential and message flat end-to-end so
the compiled program never contains a high-rank tensor at all.

No reference-code equivalent: the reference's einsums are unbatched NumPy
(/root/reference/junctiontree/computation.py:84-88) and never face a
compile phase.  This module exists purely because of XLA's compile-time
behavior.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp


def _grouped_views(ops, ovs, batched, out_set, cvars, member, sizes,
                   split_contracted: bool):
    """Reshape every operand to its grouped low-rank view.

    Groups are runs (in sorted var order) of vars with identical
    (operand-membership signature, in-output flag); when
    ``split_contracted`` each contracted var forms its own singleton group
    (so the unroll path can slice it away).  Returns
    (views, groups, gsizes, out_flags); views[i] has shape
    [B|1, g1|1, ..., gk|1] — a pure reshape of operand i, since every scope
    is sorted and each group is all-or-none per operand.
    """
    scope = sorted(member)
    groups: List[List[int]] = []
    keys: List[tuple] = []
    for v in scope:
        if v in out_set:
            k = (frozenset(member[v]), True)
        elif split_contracted:
            k = (v, False)
        else:
            k = (frozenset(member[v]), False)
        if groups and keys[-1] == k and not (split_contracted and not k[1]):
            groups[-1].append(v)
        else:
            groups.append([v])
            keys.append(k)
    gsizes = []
    for g in groups:
        t = 1
        for v in g:
            t *= sizes[v]
        gsizes.append(t)
    out_flags = [k[1] for k in keys]

    views = []
    for i, (x, vs) in enumerate(zip(ops, ovs)):
        mine = set(vs)
        shape = [x.shape[0] if batched[i] else 1]
        for g, gs in zip(groups, gsizes):
            shape.append(gs if g[0] in mine else 1)
        views.append(x.reshape(shape))
    return views, groups, gsizes, out_flags


def grouped_divide_project(
    semiring,
    belief: jnp.ndarray,
    belief_vars: Sequence[int],
    msg: jnp.ndarray,
    msg_vars: Sequence[int],
    sizes: Sequence[int],
    batch_label: int,
    flat_out: bool = False,
) -> jnp.ndarray:
    """Hugin division trick at grouped rank: ``reduce(belief ⊘ msg -> msg_vars)``.

    ``belief`` is a clique belief over ``belief_vars`` (maybe batched,
    maybe flat), ``msg`` the child's collect message over ``msg_vars ⊆
    belief_vars`` (maybe batched, maybe flat; an unbatched msg divides a
    batched belief by broadcast); returns the distribute message to that
    child over exactly ``msg_vars``, batched iff the belief is.  Division
    is guarded the way the reference guards it (zeros stay zeros,
    /root/reference/junctiontree/computation.py:131-136): entries where the
    divisor is the semiring zero produce the semiring zero, which is
    provably harmless downstream (the reference's division-vs-
    remultiplication test, tests/test_computation.py:325-374).  Only valid
    for semirings with invertible ⊗ (sum-product, log-sum-exp) — callers
    gate max-product to the leave-one-out path.
    """
    b_batched = bool(belief_vars) and belief_vars[0] == batch_label
    m_batched = bool(msg_vars) and msg_vars[0] == batch_label
    bvars = [v for v in belief_vars if v != batch_label]
    mvars = [v for v in msg_vars if v != batch_label]
    mset = set(mvars)
    # group belief axes into runs of (in-msg? flag); msg axes follow the
    # same runs (scopes are sorted)
    runs: List[List] = []  # [size, in_msg]
    for v in bvars:
        inm = v in mset
        if runs and runs[-1][1] == inm:
            runs[-1][0] *= sizes[v]
        else:
            runs.append([sizes[v], inm])
    blead = belief.shape[0] if b_batched else 1
    bview = belief.reshape([blead] + [r[0] for r in runs])
    red = tuple(1 + i for i, r in enumerate(runs) if not r[1])
    sep_marg = semiring._reduce(bview, red) if red else bview
    # divide after the reduce (the divisor is constant over reduced axes,
    # so this commutes — and runs on [B, sep] instead of [B, clique])
    mlead = msg.shape[0] if m_batched else 1
    mview = msg.reshape([mlead] + list(sep_marg.shape[1:]))
    if semiring.is_log:
        out = jnp.where(jnp.isneginf(mview), -jnp.inf, sep_marg - mview)
    else:
        out = jnp.where(
            mview != 0, sep_marg / jnp.where(mview != 0, mview, 1.0), 0.0
        )
    lead = [out.shape[0]] if b_batched else []
    if flat_out:
        tot = 1
        for v in mvars:
            tot *= sizes[v]
        return out.reshape(lead + [tot])
    return out.reshape(lead + [sizes[v] for v in mvars])


def grouped_batched_contract(
    semiring,
    operands: Sequence[jnp.ndarray],
    operand_vars: Sequence[Sequence[int]],
    out_vars: Sequence[int],
    sizes: Sequence[int],
    batch_label: int,
    unroll_cap: int = 64,
    flat_out: bool = False,
) -> Optional[Tuple[jnp.ndarray, bool]]:
    """Contract ``product(operands) -> out_vars`` via grouped unrolling.

    ``operand_vars`` entries may lead with ``batch_label``; the output gets
    the batch axis iff any operand is batched (same contract as the
    executor's ``_bcontract``).  Operand arrays may be flat (see module
    docstring).  Returns ``(result, batched)`` or ``None`` when the pattern
    doesn't fit (unsorted scopes, or a batch label in a non-leading
    position).
    """
    n = len(operands)
    batched: List[bool] = []
    ovs: List[List[int]] = []
    for vs in operand_vars:
        vs = list(vs)
        if batch_label in vs:
            if not vs or vs[0] != batch_label or batch_label in vs[1:]:
                return None
            batched.append(True)
            vs = vs[1:]
        else:
            batched.append(False)
        if any(vs[i] >= vs[i + 1] for i in range(len(vs) - 1)):
            return None  # scopes in a Plan are sorted; don't transpose here
        ovs.append(vs)
    out_vars = list(out_vars)
    if any(out_vars[i] >= out_vars[i + 1] for i in range(len(out_vars) - 1)):
        return None
    out_set = set(out_vars)

    # -- 1. pre-reduce axes private to one operand and absent from the output
    ops = list(operands)
    member: dict = {}
    for i, vs in enumerate(ovs):
        for v in vs:
            member.setdefault(v, set()).add(i)
    if any(v not in member for v in out_vars):
        return None  # output-only axes: caller broadcasts explicitly
    for i in range(n):
        priv = set(
            v for v in ovs[i] if len(member[v]) == 1 and v not in out_set
        )
        if priv:
            # run-structured reshape works from flat or full rank alike
            runs: List[List] = []
            for v in ovs[i]:
                p = v in priv
                if runs and runs[-1][1] == p:
                    runs[-1][0] *= sizes[v]
                else:
                    runs.append([sizes[v], p])
            lead = [ops[i].shape[0]] if batched[i] else []
            x = ops[i].reshape(lead + [r[0] for r in runs])
            off = 1 if batched[i] else 0
            x = semiring._reduce(
                x, tuple(off + j for j, r in enumerate(runs) if r[1])
            )
            ovs[i] = [v for v in ovs[i] if v not in priv]
            rem = 1
            for v in ovs[i]:
                rem *= sizes[v]
            ops[i] = x.reshape(lead + ([rem] if ovs[i] else []))
            for v in priv:
                del member[v]

    cvars = sorted(v for v in member if v not in out_set)
    cset = set(cvars)
    unroll = 1
    for v in cvars:
        unroll *= sizes[v]
    do_unroll = unroll <= unroll_cap

    # output-group structure: runs (in sorted var order) of OUT vars with
    # identical operand-membership signature.  A contracted var between two
    # same-signature out vars does not break the run: slicing removes it
    # from every operand that holds it (signature equality means the same
    # operands hold the neighbors), making them adjacent.
    ogroups: List[List[int]] = []
    okeys: List[frozenset] = []
    for v in sorted(member):
        if v not in out_set:
            continue
        k = frozenset(member[v])
        if ogroups and okeys[-1] == k:
            ogroups[-1].append(v)
        else:
            ogroups.append([v])
            okeys.append(k)
    ogsizes = []
    for g in ogroups:
        t = 1
        for v in g:
            t *= sizes[v]
        ogsizes.append(t)
    # Guard: above 8 output groups, take the grouped einsum.  Rank-11
    # unrolled accumulation on the hailfinder-class posterior made XLA
    # materialize each term's ~3 GB broadcast under permuted layouts
    # instead of fusing (on an earlier 16 GB device; not re-measured on
    # the GPU).  The einsum's pairwise dots
    # reduce while multiplying, keeping intermediates compact exactly
    # where it matters.  Also bound the emitted-op count (terms x
    # operands) so a huge contracted space can't produce a pathological
    # HLO graph.
    if do_unroll and (
        1 + len(ogroups) > 8 or unroll * max(1, n) > 4096
    ):
        do_unroll = False
    b = any(batched)

    if not do_unroll:
        views, groups, gsizes, out_flags = _grouped_views(
            ops, ovs, batched, out_set, cvars, member, sizes,
            split_contracted=False,
        )
        # Contract at grouped (low) rank via the semiring einsum: opt_einsum
        # picks a pairwise order, so a batched operand over a big clique
        # never materializes [B, union-scope] — the one-pass broadcast
        # combine+reduce this replaced allocated B x prod(groups) floats
        # (51 GB on a hailfinder-class 3.1M-state grouped scope at B=4096).
        # Rank after grouping is small, so compile stays cheap.
        ops2: List[jnp.ndarray] = []
        ovs2: List[List] = []
        for i, (x, vs) in enumerate(zip(ops, ovs)):
            mine = set(vs)
            gids = [gi for gi, g in enumerate(groups) if g[0] in mine]
            shape = ([x.shape[0]] if batched[i] else []) + [
                gsizes[gi] for gi in gids
            ]
            ops2.append(x.reshape(shape))
            ovs2.append(
                ([batch_label] if batched[i] else []) + [("g", gi) for gi in gids]
            )
        out_gids = [gi for gi, f in enumerate(out_flags) if f]
        acc = semiring.contract(
            ops2, ovs2,
            ([batch_label] if b else []) + [("g", gi) for gi in out_gids],
        )
        if not b:
            acc = acc[None]  # unify with the tail's [lead, groups...] layout
        out_gsizes = [gs for gs, f in zip(gsizes, out_flags) if f]
    else:
        # Unrolled terms at RUN rank, accumulated at GROUP rank.  The
        # round-4 form reshaped every operand to a shared split-contracted
        # view (each contracted var its own singleton axis interleaved
        # with every distinct signature group) and strided-sliced it per
        # term — on mixed-cardinality models that makes rank-9ish
        # odd-shaped slices, which sent an earlier backend's layout passes
        # into minutes of compile on the hailfinder-class reduced model, and
        # its >8-group fallback pushed exactly the big mixed-cardinality
        # steps onto high-rank einsums costing ~20 s of XLA compile EACH
        # (round-5 isolation: one hailfinder distribute step = 56 s).
        # Instead: each operand is reshaped once to its OWN minimal rank —
        # runs of contracted-vs-output vars (rank = #run alternations +
        # batch, typically 3-4) — sliced there with plain integer indices,
        # and the slice reshaped to the shared output-group broadcast
        # structure (pure reshape: slicing removes contracted axes and
        # preserves sorted var order).  The whole multiply-accumulate
        # chain is elementwise at group rank, so XLA fuses it into ONE
        # pass reading each operand once (round-5 measured, isolated worst
        # step: 19.6 s XLA / 4.1 ms -> 8.2 s / 0.05 ms); flattening terms
        # before accumulation instead costs a materialized [B, out] copy
        # PER TERM (measured: +3 GB peak and an HBM-bound 4 ms step).
        infos = []
        for i, (x, vs) in enumerate(zip(ops, ovs)):
            runs: List[List] = []  # [size, is_contracted, vars]
            for v in vs:
                p = v in cset
                if runs and runs[-1][1] == p:
                    runs[-1][0] *= sizes[v]
                    runs[-1][2].append(v)
                else:
                    runs.append([sizes[v], p, [v]])
            lead = [x.shape[0]] if batched[i] else []
            xr = x.reshape(lead + [r[0] for r in runs])
            mine = set(vs)
            gview = [x.shape[0] if batched[i] else 1] + [
                gs if g[0] in mine else 1
                for g, gs in zip(ogroups, ogsizes)
            ]
            infos.append((xr, runs, batched[i], gview))

        def term_slice(i: int, assign: dict) -> jnp.ndarray:
            xr, runs, bat, gview = infos[i]
            idx = [slice(None)] if bat else []
            for sz, p, rvars in runs:
                if p and assign:
                    j = 0
                    for v in rvars:
                        j = j * sizes[v] + assign[v]
                    idx.append(j)
                else:
                    idx.append(slice(None))
            return xr[tuple(idx)].reshape(gview)

        const_ix = [i for i in range(n) if not (set(ovs[i]) & cset)]
        var_ix = [i for i in range(n) if i not in const_ix]

        def combine_all(parts):
            acc = parts[0]
            for p in parts[1:]:
                acc = semiring._combine(acc, p)
            return acc

        const = combine_all([term_slice(i, {}) for i in const_ix]) \
            if const_ix else None
        acc = None
        if var_ix:
            for vals in itertools.product(*[range(sizes[v]) for v in cvars]):
                assign = dict(zip(cvars, vals))
                term = combine_all([term_slice(i, assign) for i in var_ix])
                acc = term if acc is None else semiring._accum(acc, term)
        if const is not None:
            acc = const if acc is None else semiring._combine(const, acc)
        out_gsizes = list(ogsizes)

    # -- final: broadcast to the full grouped out extent, then lay out
    full = [acc.shape[0] if b else 1] + out_gsizes
    acc = jnp.broadcast_to(acc, full)
    if flat_out:
        tot = 1
        for v in out_vars:
            tot *= sizes[v]
        shape = ([full[0]] if b else []) + [tot]
    else:
        shape = ([full[0]] if b else []) + [sizes[v] for v in out_vars]
    return acc.reshape(shape), b
