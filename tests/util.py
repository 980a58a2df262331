"""Test utilities: oracles and property checkers.

Ports the reference's three oracle *patterns* (SURVEY.md §4) without porting
its code:

  #1 brute-force einsum oracle (reference tests/test_computation.py:19-48):
     every per-factor / per-variable marginal of a factor graph computed with
     one global contraction.
  #3 graph-theoretic triangulation proof: instead of the reference's
     Gibbs-cycle chord check (tests/util.py:158-234), we verify chordality by
     the standard maximum-cardinality-search perfect-elimination-order test,
     and verify the junction tree's running-intersection property directly.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


# ---------- oracle #1: brute-force marginals ----------

def brute_force_marginals(
    factors: Sequence[Sequence],
    sizes: Dict,
    values: Sequence[np.ndarray],
    outputs: Sequence[Sequence],
    evidence: Dict = None,
) -> List[np.ndarray]:
    """Unnormalized marginals over each output var-list via one big einsum.

    Evidence (if given) is applied by multiplying one-hot indicators, so the
    result keeps full shapes with zeros off-evidence (mask semantics)."""
    var_list = sorted({v for f in factors for v in f}, key=str)
    subs = {v: _LETTERS[i] for i, v in enumerate(var_list)}
    ops = [np.asarray(v, dtype=np.float64) for v in values]
    op_subs = ["".join(subs[v] for v in f) for f in factors]
    if evidence:
        for v, state in evidence.items():
            ind = np.zeros(sizes[v])
            ind[state] = 1.0
            ops.append(ind)
            op_subs.append(subs[v])
    spec_in = ",".join(op_subs)
    out = []
    for ovars in outputs:
        spec = spec_in + "->" + "".join(subs[v] for v in ovars)
        out.append(np.einsum(spec, *ops, optimize=True))
    return out


def brute_force_max_marginals(
    factors, sizes, values, outputs
) -> List[np.ndarray]:
    """Max-product analog of the brute-force oracle (enumerate full joint)."""
    var_list = sorted({v for f in factors for v in f}, key=str)
    vix = {v: i for i, v in enumerate(var_list)}
    shape = tuple(sizes[v] for v in var_list)
    joint = np.ones(shape)
    for f, val in zip(factors, values):
        axes = [vix[v] for v in f]
        expand = np.asarray(val, dtype=np.float64)
        # move factor axes into joint layout
        full = np.ones(shape)
        idx = [None] * len(var_list)
        perm_shape = [1] * len(var_list)
        src = expand
        # build broadcastable view
        order = np.argsort(axes)
        src = np.transpose(src, order)
        view_shape = [1] * len(var_list)
        for a, s in zip(sorted(axes), src.shape):
            view_shape[a] = s
        joint = joint * src.reshape(view_shape)
    out = []
    for ovars in outputs:
        keep = tuple(vix[v] for v in ovars)
        red = tuple(i for i in range(len(var_list)) if i not in keep)
        m = joint.max(axis=red) if red else joint
        # reorder kept axes to ovars order
        kept_sorted = [i for i in range(len(var_list)) if i in keep]
        perm = [kept_sorted.index(vix[v]) for v in ovars]
        out.append(np.transpose(m, perm) if perm else m)
    return out


# ---------- oracle #2: plain NumPy propagation over a plan's tree ----------

def _np_contract(ops, op_vars, out_vars, mode):
    """Product of ``ops`` (axes labelled by ``op_vars``) reduced onto
    ``out_vars`` by sum (np.einsum) or max, in float64."""
    labels: Dict[int, int] = {}
    for vs in list(op_vars) + [out_vars]:
        for v in vs:
            labels.setdefault(v, len(labels))
    args = []
    for op, vs in zip(ops, op_vars):
        args += [np.asarray(op, dtype=np.float64), [labels[v] for v in vs]]
    if mode == "sum":
        return np.einsum(*args, [labels[v] for v in out_vars], optimize=True)
    union = sorted(labels.values())
    full = np.einsum(*args, union, optimize=False)
    red = tuple(i for i in union if i not in {labels[v] for v in out_vars})
    m = full.max(axis=red) if red else full
    kept = [i for i in union if i not in red]
    return np.transpose(m, [kept.index(labels[v]) for v in out_vars])


def numpy_tree_propagate(plan, values, evidence=None, mode="sum"):
    """Two-pass message passing over ``plan``'s junction tree in float64
    NumPy, independent of the compiled programs (it shares only the plan).

    Evidence {label: state} is applied by multiplying one-hot masks into
    the clique potentials.  ``mode="sum"`` returns (normalized per-variable
    marginals indexed by var id, log Z); ``mode="max"`` returns (per-variable
    max-marginals, log of the largest joint value under the evidence)."""
    cv = [list(c) for c in plan.clique_vars]
    sizes = plan.sizes
    tree = plan.tree
    pots = [np.ones(tuple(sizes[v] for v in c)) for c in cv]
    scale = 1.0
    for f, (fv, val) in enumerate(zip(plan.factors, values)):
        c = plan.tri.factor_to_maxclique[f]
        if c < 0:
            scale *= float(np.asarray(val))
            continue
        pots[c] = _np_contract([pots[c], val], [cv[c], list(fv)], cv[c], "sum")
    for label, state in (evidence or {}).items():
        v = plan.table.id_of(label)
        c = plan.var_to_clique[v]
        hot = np.zeros(sizes[v])
        hot[int(state)] = 1.0
        pots[c] = _np_contract([pots[c], hot], [cv[c], [v]], cv[c], "sum")

    def sep(s):
        return list(tree.separators[s])

    up: Dict[int, np.ndarray] = {}
    for c in reversed(tree.topo_order):
        if tree.parent[c] < 0:
            continue
        kids = tree.children[c]
        up[c] = _np_contract(
            [pots[c]] + [up[k] for k, _ in kids],
            [cv[c]] + [sep(s) for _, s in kids],
            sep(tree.parent_sep[c]), mode,
        )
    down: Dict[int, np.ndarray] = {}
    beliefs: List[np.ndarray] = [None] * len(cv)
    for c in tree.topo_order:
        kids = tree.children[c]
        base_ops, base_vs = [pots[c]], [cv[c]]
        if tree.parent[c] >= 0:
            base_ops.append(down[c])
            base_vs.append(sep(tree.parent_sep[c]))
        beliefs[c] = _np_contract(
            base_ops + [up[k] for k, _ in kids],
            base_vs + [sep(s) for _, s in kids], cv[c], mode,
        )
        for k, s in kids:  # leave-one-out down-message to child k
            others = [(o, so) for o, so in kids if o != k]
            down[k] = _np_contract(
                base_ops + [up[o] for o, _ in others],
                base_vs + [sep(so) for _, so in others], sep(s), mode,
            )
    root = beliefs[tree.root]
    total = (root.sum() if mode == "sum" else root.max()) * scale
    margs = []
    for v in range(plan.num_vars):
        c = plan.var_to_clique[v]
        m = _np_contract([beliefs[c]], [cv[c]], [v], mode) * scale
        margs.append(m / m.sum() if mode == "sum" else m)
    with np.errstate(divide="ignore"):
        return margs, float(np.log(total))


# ---------- oracle #3: chordality + junction tree properties ----------

def is_chordal(n: int, edges: Set[Tuple[int, int]]) -> bool:
    """Maximum-cardinality search + perfect-elimination-order check."""
    adj: List[Set[int]] = [set() for _ in range(n)]
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    weight = [0] * n
    order: List[int] = []
    numbered = [False] * n
    for _ in range(n):
        v = max(
            (x for x in range(n) if not numbered[x]),
            key=lambda x: (weight[x], -x),
        )
        numbered[v] = True
        order.append(v)
        for u in adj[v]:
            if not numbered[u]:
                weight[u] += 1
    pos = {v: i for i, v in enumerate(order)}
    # PEO check on reversed MCS order
    rev = order[::-1]
    rpos = {v: i for i, v in enumerate(rev)}
    for v in rev:
        later = [u for u in adj[v] if rpos[u] > rpos[v]]
        if not later:
            continue
        p = min(later, key=lambda u: rpos[u])
        for u in later:
            if u != p and u not in adj[p]:
                return False
    return True


def check_running_intersection(plan) -> None:
    """For every variable, the cliques containing it form a connected subtree,
    and each separator equals the intersection of its endpoint cliques."""
    tree = plan.tree
    cliques = [set(c) for c in plan.clique_vars]
    for a, b, s in tree.edges:
        assert set(tree.separators[s]) == cliques[a] & cliques[b], (
            "separator %d is not the intersection of cliques %d,%d" % (s, a, b)
        )
    # connectivity per variable: count cliques containing v and tree edges
    # whose separator contains v; connected iff edges == cliques - 1
    for v in range(plan.num_vars):
        n_cliques = sum(1 for c in cliques if v in c)
        n_edges = sum(1 for _, _, s in tree.edges if v in tree.separators[s])
        assert n_edges == n_cliques - 1, (
            "variable %d violates running intersection (%d cliques, %d edges)"
            % (v, n_cliques, n_edges)
        )


def check_triangulation(plan) -> None:
    """Moral graph + fill edges is chordal; cliques cover factors."""
    from junctiontree_tpu.triangulate import build_adjacency

    adj = build_adjacency(plan.factors, plan.num_vars)
    edges = {
        (min(u, v), max(u, v))
        for u in range(plan.num_vars)
        for v in adj[u]
    }
    edges |= set(plan.tri.fill_edges)
    assert is_chordal(plan.num_vars, edges)
    for f, c in zip(plan.factors, plan.tri.factor_to_maxclique):
        if f:
            assert set(f) <= set(plan.clique_vars[c])


# ---------- graph generators (seeded) ----------

def chain_bn(n: int, card: int = 2):
    """Chain Bayes net: prior on x0, pairwise CPDs along the chain."""
    factors = [["x0"]] + [[f"x{i-1}", f"x{i}"] for i in range(1, n)]
    sizes = {f"x{i}": card for i in range(n)}
    return factors, sizes


def grid_mrf(rows: int, cols: int, card: int = 2):
    """Ising-style pairwise grid MRF with unary terms."""
    def name(r, c):
        return f"g{r}_{c}"

    factors = []
    for r in range(rows):
        for c in range(cols):
            factors.append([name(r, c)])
            if r + 1 < rows:
                factors.append([name(r, c), name(r + 1, c)])
            if c + 1 < cols:
                factors.append([name(r, c), name(r, c + 1)])
    sizes = {name(r, c): card for r in range(rows) for c in range(cols)}
    return factors, sizes


def random_factor_graph(seed: int, n_vars=8, n_factors=10, max_arity=3, max_card=4):
    """Random hypergraph with mixed cardinalities; may be disconnected."""
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(n_vars)]
    sizes = {v: int(rng.integers(2, max_card + 1)) for v in names}
    factors = []
    for _ in range(n_factors):
        arity = int(rng.integers(1, max_arity + 1))
        f = list(rng.choice(n_vars, size=min(arity, n_vars), replace=False))
        factors.append([names[i] for i in f])
    # ensure every var appears in some factor
    used = {v for f in factors for v in f}
    for v in names:
        if v not in used:
            factors.append([v])
    return factors, sizes


def random_values(factors, sizes, seed: int, positive=True):
    rng = np.random.default_rng(seed)
    vals = []
    for f in factors:
        shape = tuple(sizes[v] for v in f)
        x = rng.random(shape)
        if positive:
            x = x + 0.1
        vals.append(x)
    return vals
