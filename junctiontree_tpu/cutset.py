"""Cutset conditioning: exact inference past the treewidth wall.

Pearl's classic escape hatch for dense networks, re-designed for batched
accelerator execution: the
cutset's joint states become ANOTHER BATCH AXIS.  Conditioning on a cutset
C removes its variables from the graph, so the reduced model triangulates
with far smaller cliques *and separators* (serving memory is B x
sep_states — see Engine.max_feasible_batch); each cutset assignment s
yields one set of reduced potentials, stacked on a leading S axis; one
compiled program vmaps over (S, B) and aggregates with logsumexp:

    logZ[b]      = logsumexp_s( logZ_s[b] + logw_s[b] )
    P(v = x | e) ∝ logsumexp_s( logmarg_s[v, x] + logw_s[b] )
    P(c = x | e) ∝ logsumexp_{s : s_c = x}( logZ_s[b] + logw_s[b] )

where logw carries any evidence on the cutset variables themselves.
Everything runs in log space (per-state partition functions of big models
underflow linear float32), riding the log-matmul-exp contraction path for
any remaining big scopes.

The reference has nothing like this — its only answer to a dense graph is
an exponentially large clique (SURVEY.md §6: an 8x8 grid already produces a
2^18-state clique).  Hailfinder-class models (12.4M-state cliques,
3.1M-state separators after escalation) reduce to ~10^4-state cliques under
a 3-variable cutset and serve at full batch sizes.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .fused import _TINY
from .ops.semirings import LOG_SUM_EXP
from .schedule import compile_plan


def _expnorm_safe(lp):
    """exp-normalize log scores along the last axis; rows where every score
    is impossible (non-finite logsumexp, or the _NEG clamp floor) return
    ZEROS instead of NaN — the same impossible-evidence contract as
    Engine.posterior_batch (zero posteriors, logZ=-inf; round-5 driving
    found the cutset aggregations produced NaN there)."""
    import jax.nn
    import jax.numpy as jnp

    lse = jax.nn.logsumexp(lp, axis=-1, keepdims=True)
    bad = ~jnp.isfinite(lse) | (lse < -1e29)
    return jnp.where(bad, 0.0, jnp.exp(lp - jnp.where(bad, 0.0, lse)))


def _max_states(factors, sizes, heuristic="min_fill") -> int:
    from .labels import intern_factors
    from .triangulate import min_fill_triangulation

    table, int_factors, int_sizes = intern_factors(factors, sizes)
    if not int_factors:
        return 0
    tri = min_fill_triangulation(int_factors, int_sizes, heuristic=heuristic)
    worst = 1
    for c in tri.maxcliques:
        states = 1
        for v in c:
            states *= int_sizes[v]
        worst = max(worst, states)
    return worst


def _without(factors, sizes, drop: set):
    """Reduced factor scopes with ``drop`` variables conditioned away.
    Scopes may become empty (per-assignment scalar weights)."""
    red = [[v for v in f if v not in drop] for f in factors]
    rsizes = {v: s for v, s in sizes.items() if v not in drop}
    return red, rsizes


def choose_cutset(
    factors,
    sizes,
    target_states: int = 1 << 16,
    max_vars: int = 6,
    max_enum: int = 4096,
) -> List[Hashable]:
    """Greedy loop cutset: repeatedly remove the variable that most shrinks
    the min-fill max-clique state space, until it is <= ``target_states``
    or the enumeration budget (prod of cutset cardinalities) is spent.

    Candidates are restricted to variables of the current largest clique
    (removing anything else cannot shrink it)."""
    from .labels import intern_factors
    from .triangulate import min_fill_triangulation

    cutset: List[Hashable] = []
    cur_factors, cur_sizes = [list(f) for f in factors], dict(sizes)
    enum = 1
    while len(cutset) < max_vars:
        table, int_factors, int_sizes = intern_factors(cur_factors, cur_sizes)
        if not int_factors:
            break
        tri = min_fill_triangulation(int_factors, int_sizes)
        worst_states, worst_clique = 0, None
        for c in tri.maxcliques:
            states = 1
            for v in c:
                states *= int_sizes[v]
            if states > worst_states:
                worst_states, worst_clique = states, c
        if worst_states <= target_states or worst_clique is None:
            break
        best_v, best_cost = None, None
        for v in worst_clique:
            label = table.label_of(v)
            if enum * cur_sizes[label] > max_enum:
                continue
            rf, rs = _without(cur_factors, cur_sizes, {label})
            cost = _max_states(rf, rs)
            if best_cost is None or cost < best_cost:
                best_v, best_cost = label, cost
        if best_v is None:
            break
        cutset.append(best_v)
        enum *= cur_sizes[best_v]
        cur_factors, cur_sizes = _without(cur_factors, cur_sizes, {best_v})
    return cutset


class CutsetEngine:
    """Exact inference by cutset conditioning (see module docstring).

    values are linear-space factor arrays (reference convention).  Queries
    go through ``posterior_batch(mask_batch)`` with linear [B, size] masks
    for ANY variable — reduced or cutset; returns ({label: [B, size]
    normalized posteriors} over every variable, logZ [B])."""

    def __init__(
        self,
        factors: Sequence[Sequence[Hashable]],
        sizes: Dict[Hashable, int],
        values: Sequence[np.ndarray],
        cutset: Optional[Sequence[Hashable]] = None,
        target_states: int = 1 << 16,
        max_enum: int = 4096,
        state_chunk: Optional[int] = None,
        chunk_budget_bytes: int = 8 << 30,
    ):
        import jax

        # None = auto-size per query batch: the chunked map materializes
        # [chunk, B, max_clique_states] beliefs, so chunk is capped by the
        # HBM budget (fixed chunks OOM at large B on wide reduced models)
        self._state_chunk = None if state_chunk is None else int(state_chunk)
        self._chunk_budget = int(chunk_budget_bytes)

        if cutset is None:
            cutset = choose_cutset(
                factors, sizes, target_states=target_states, max_enum=max_enum
            )
        self.cutset = list(cutset)
        cset = set(self.cutset)
        self.sizes = dict(sizes)
        self.factors = [list(f) for f in factors]

        # enumerate cutset assignments (row-major over self.cutset order)
        cards = [sizes[v] for v in self.cutset]
        S = int(np.prod(cards)) if cards else 1
        self.num_states = S
        grids = np.stack(
            [g.ravel() for g in np.meshgrid(
                *[np.arange(k) for k in cards], indexing="ij"
            )], axis=1,
        ) if cards else np.zeros((1, 0), dtype=int)
        self._assignments = grids  # [S, len(cutset)]

        # reduced model: factor scopes minus cutset vars; per-assignment
        # values by indexing the cutset axes.  Empty-scope factors fold into
        # the root clique as scalars (executor handles factor_to_maxclique
        # == -1), so they contribute the per-assignment weight exactly.
        red_factors, red_sizes = _without(self.factors, self.sizes, cset)
        self.plan = compile_plan(red_factors, red_sizes)

        # stack per-assignment clique potentials (log space): [S, *shape]
        from .executor import evaluate_cliques_np

        self._values = [np.asarray(v, dtype=np.float64) for v in values]

        stacks: List[List[np.ndarray]] = None
        for s in range(S):
            vals = self._reduce_values(self._assignments[s])
            with np.errstate(divide="ignore"):
                vals = [np.log(v) for v in vals]
            pots = evaluate_cliques_np(
                self.plan, vals, LOG_SUM_EXP, dtype=np.float32
            )
            if stacks is None:
                stacks = [[] for _ in pots]
            for i, p in enumerate(pots):
                stacks[i].append(p)
        self._pots = [
            jax.device_put(np.stack(ps)) for ps in stacks
        ]  # each [S, *clique_shape]

        # one-hot state matrices for cutset-variable posteriors: [S, card]
        self._onehot = {}
        for j, v in enumerate(self.cutset):
            oh = np.full((S, sizes[v]), -np.inf, dtype=np.float32)
            oh[np.arange(S), self._assignments[:, j]] = 0.0
            self._onehot[v] = jax.device_put(oh)

        self._prog_cache: dict = {}

    def _reduce_values(self, assign_row) -> List[np.ndarray]:
        """Per-assignment reduced factor values: cutset axes indexed at the
        assignment's states, other axes kept (linear space, float64)."""
        cset = set(self.cutset)
        out = []
        for f, val in zip(self.factors, self._values):
            idx = []
            for v in f:
                if v in cset:
                    idx.append(int(assign_row[self.cutset.index(v)]))
                else:
                    idx.append(slice(None))
            out.append(val[tuple(idx)])
        return out

    def describe(self) -> dict:
        st = self.plan.stats()
        st["cutset"] = list(self.cutset)
        st["cutset_states"] = self.num_states
        return st

    def _chunk_for(self, B: int, inner: str = "belief") -> int:
        """Cutset-axis chunk size for the lax.map programs.  Auto mode caps
        the per-chunk working buffers at the HBM budget: the belief-form
        inner materializes [chunk, B, max_clique_states] beliefs, the
        message-form inner only [chunk, B, max_sep_states]-scale messages
        (so its chunks can be much larger)."""
        if self._state_chunk is not None:
            return max(1, min(self.num_states, self._state_chunk))
        st = self.plan.stats()
        states = max(1, st["max_clique_states"])
        if inner == "message":
            # persistent buffers are message-scale, but the big-step einsum
            # contractions still materialize clique-scale dot intermediates
            # per chunk element (measured round 5: budgeting by separator
            # size OOMed at 21.7 G on the hailfinder-class reduced model)
            live = 3
        else:
            live = 2  # XLA keeps ~two clique-sized buffers live per step
        fit = self._chunk_budget // (4 * max(B, 1) * states * live)
        return max(1, min(self.num_states, int(fit), 256))

    def _fused_routing(self) -> bool:
        """Structural check: the reduced model's level groups collapse its
        op count (many small cliques, regular shapes).  NOT used for auto
        routing: cutset reduction destroys regularity on real dense models
        (hailfinder-class: 42 groups / 43 cliques), and the fused program's
        gain over the unrolled chunked map is not measured on the GPU.  The
        fused path stays available via posterior_batch(mode='fused')."""
        st = self.plan.stats()
        if st["num_cliques"] < 32 or st["max_clique_states"] > (1 << 13):
            return False
        from .fused import build_fused_schedule

        if getattr(self, "_fused_sched", None) is None:
            self._fused_sched = build_fused_schedule(self.plan)
        n_groups = sum(len(gs) for gs in self._fused_sched[0].levels)
        return n_groups * 2 <= st["num_cliques"]

    def _fused_stacks(self):
        """[S, G, *shape] LINEAR-space prestacked group potentials (the
        fused program runs rescaled linear sum-product; per-clique factor
        products are O(1)-scaled, so linear f32 storage is safe — the
        dynamic range builds up only inside propagation, where the fused
        program's per-message rescaling absorbs it)."""
        if getattr(self, "_fused_pots", None) is None:
            import jax

            from .executor import evaluate_cliques_np
            from .fused import stack_group_potentials
            from .ops.semirings import SUM_PRODUCT

            sched = self._fused_sched[0]
            per_s = []
            for s in range(self.num_states):
                vals = self._reduce_values(self._assignments[s])
                pots = evaluate_cliques_np(
                    self.plan, vals, SUM_PRODUCT, dtype=np.float32
                )
                per_s.append(stack_group_potentials(sched, pots))
            self._fused_pots = [
                [
                    jax.device_put(
                        np.stack([per_s[s][d][gi] for s in range(self.num_states)])
                    )
                    for gi in range(len(per_s[0][d]))
                ]
                for d in range(len(per_s[0]))
            ]
        return self._fused_pots

    def _posterior_batch_fused(self, mask_batch: Dict[Hashable, np.ndarray]):
        """Stacked/fused cutset serving: the reduced model runs as ONE
        level-fused program (O(levels x groups) ops, fused.py) vmapped over
        cutset-assignment chunks — instead of O(reduced cliques) ops per
        chunk step.  Exact same aggregation math as the unrolled path; the
        per-assignment marginals come back normalized with a separate
        logZ_s, so log-space mixing is unchanged."""
        import jax
        import jax.numpy as jnp

        from .fused import build_fused_schedule, fused_posterior_program

        if getattr(self, "_fused_sched", None) is None:
            self._fused_sched = build_fused_schedule(self.plan)
        plan = self.plan
        cset = set(self.cutset)
        red_ids = tuple(sorted(
            plan.table.id_of(k) for k in mask_batch if k not in cset
        ))
        _, logw, B = self._log_masks_and_weights(mask_batch)
        masks = [
            jnp.asarray(
                np.asarray(mask_batch[plan.table.label_of(v)], dtype=np.float32)
            )
            for v in red_ids
        ]

        chunk = self._chunk_for(B)
        key = ("posterior_fused", chunk, red_ids)
        fn = self._prog_cache.get(key)
        if fn is None:
            sched, sorted_children = self._fused_sched
            prog = fused_posterior_program(sched, sorted_children, list(red_ids))
            clique_pos = sched.clique_pos
            cvars = plan.clique_vars
            _NEG = -1e30

            def agg(pots_stack, masks, logw, onehots):
                marg, z = jax.lax.map(
                    lambda p: prog(p, masks), pots_stack, batch_size=chunk
                )  # dict of [S, B, G, size], z [S, B]
                z = z + logw
                logz = jax.nn.logsumexp(z, axis=0)                 # [B]
                posts = []
                for v in range(plan.num_vars):
                    c = plan.var_to_clique[v]
                    d, gi, slot = clique_pos[c]
                    axis = cvars[c].index(v)
                    m = marg[(d, gi, axis)][:, :, slot]            # [S, B, K]
                    m = m / jnp.maximum(
                        jnp.sum(m, axis=-1, keepdims=True), _TINY
                    )
                    lp = jnp.where(m > 0, jnp.log(jnp.maximum(m, _TINY)), _NEG)
                    lp = lp + z[:, :, None]
                    lp = jax.nn.logsumexp(lp, axis=0)              # [B, K]
                    posts.append(_expnorm_safe(lp))
                cut_posts = []
                for oh in onehots:                                  # [S, card]
                    m2 = z[:, :, None] + oh[:, None, :]
                    m2 = jax.nn.logsumexp(m2, axis=0)
                    cut_posts.append(_expnorm_safe(m2))
                return posts, cut_posts, logz

            from .config import DEFAULT as _CFG

            # donate the per-call mask/weight buffers (built fresh from
            # host arrays above, never retained by the engine)
            fn = jax.jit(
                agg,
                donate_argnums=(
                    (1, 2) if _CFG.donate_serving_masks else ()
                ),
            )
            self._prog_cache[key] = fn

        onehots = [self._onehot[v] for v in self.cutset]
        posts, cut_posts, logz = fn(self._fused_stacks(), masks, logw, onehots)
        out = {
            plan.table.label_of(v): posts[v] for v in range(plan.num_vars)
        }
        for v, m in zip(self.cutset, cut_posts):
            out[v] = m
        return out, logz

    def posterior_batch(
        self, mask_batch: Dict[Hashable, np.ndarray], mode: str = "auto"
    ):
        """Batched posteriors + logZ over (S cutset assignments x B queries).

        mode: "auto" runs the unrolled per-clique belief-form chunked
        program; "message" forces the reduced model's batch-aware message
        program vmapped over cutset-assignment chunks; "fused" forces the
        stacked level-fused reduced program (O(levels x groups) ops).

        The message form was re-attempted in round 5 after its round-4
        compile blocker (214 s mixed-cardinality unroll slicing) was fixed
        — and measured WORSE end-to-end on the hailfinder-class model
        either way: 4620 ms/step / 222 q/s with a 1378 s compile, vs the
        belief form's ~2330 ms / 438 q/s / ~340 s.  vmap over the chunk
        axis adds a rank to every grouped view and big-step einsum, losing
        exactly the layouts that make the un-vmapped program fast.  It
        stays available for environments where that trade differs."""
        if mode == "fused":
            return self._posterior_batch_fused(mask_batch)
        import jax
        import jax.numpy as jnp

        from .parallel.batch import _single_query

        plan = self.plan
        cset = set(self.cutset)
        red_ids = sorted(
            plan.table.id_of(k) for k in mask_batch if k not in cset
        )
        cut_labels = tuple(k for k in self.cutset if k in mask_batch)
        B = None
        for m in mask_batch.values():
            B = int(np.shape(m)[0])
            break
        if B is None:
            raise ValueError("need at least one evidence mask")

        # log-space masks over ALL reduced variables (unobserved -> zeros);
        # the vmapped _single_query takes a full per-var list
        logmasks = []
        by_id = {
            plan.table.id_of(k): np.asarray(v, dtype=np.float64)
            for k, v in mask_batch.items() if k not in cset
        }
        with np.errstate(divide="ignore"):
            for v in range(plan.num_vars):
                if v in by_id:
                    logmasks.append(
                        jnp.asarray(np.log(by_id[v]), dtype=jnp.float32)
                    )
                else:
                    logmasks.append(
                        jnp.zeros((B, plan.sizes[v]), dtype=jnp.float32)
                    )

        # per-(s, b) cutset log-weights from evidence on cutset variables
        logw = jnp.zeros((self.num_states, B), dtype=jnp.float32)
        for k in cut_labels:
            with np.errstate(divide="ignore"):
                lm = jnp.asarray(
                    np.log(np.asarray(mask_batch[k], dtype=np.float64)),
                    dtype=jnp.float32,
                )  # [B, card]
            # state of k per assignment: one-hot [S, card] selects columns
            sel = jnp.asarray(
                self._assignments[:, self.cutset.index(k)]
            )  # [S]
            logw = logw + lm[:, sel].T  # [S, B]

        inner_mode = "message" if mode == "message" else "belief"
        chunk = self._chunk_for(B, inner_mode)
        key = ("posterior", inner_mode, chunk)
        fn = self._prog_cache.get(key)
        if fn is None:
            from functools import partial

            # the cutset axis is CHUNKED (lax.map batch_size) — a full
            # vmap over S would blow the HBM budget; per chunk it's
            # bounded (chunk auto-sized, _chunk_for).
            if inner_mode == "message":
                # Opt-in message-form inner: the reduced model's
                # batch-aware routed program, vmapped by lax.map over the
                # cutset-assignment chunk.  Opt-in: whether it beats the
                # belief form on the GPU is not measured.
                from .executor import batched_propagate_program

                prog_b = batched_propagate_program(plan, LOG_SUM_EXP)
                inner = prog_b
            else:
                single = partial(_single_query, plan, LOG_SUM_EXP)
                inner = jax.vmap(single, in_axes=(None, 0))

            def prog(pots, masks, logw, onehots):
                margs, z = jax.lax.map(
                    lambda p: inner(p, masks), pots, batch_size=chunk
                )   # [S, B, size_v] per var, [S, B]
                z = z + logw
                logz = jax.nn.logsumexp(z, axis=0)             # [B]
                posts = []
                for v in range(plan.num_vars):
                    m = margs[v] + logw[:, :, None]            # [S, B, K]
                    m = jax.nn.logsumexp(m, axis=0)            # [B, K]
                    posts.append(_expnorm_safe(m))
                cut_posts = []
                for oh in onehots:                              # [S, card]
                    m = z[:, :, None] + oh[:, None, :]          # [S, B, card]
                    m = jax.nn.logsumexp(m, axis=0)
                    cut_posts.append(_expnorm_safe(m))
                return posts, cut_posts, logz

            from .config import DEFAULT as _CFG

            # donate the per-call mask/weight buffers — the chunked map's
            # [S, B, ...] intermediates sit on top of persistent pots, so
            # every freed input byte extends the feasible (S-chunk, B) box
            fn = jax.jit(
                prog,
                donate_argnums=(
                    (1, 2) if _CFG.donate_serving_masks else ()
                ),
            )
            self._prog_cache[key] = fn

        onehots = [self._onehot[v] for v in self.cutset]
        posts, cut_posts, logz = fn(self._pots, logmasks, logw, onehots)
        out = {
            plan.table.label_of(v): posts[v] for v in range(plan.num_vars)
        }
        for v, m in zip(self.cutset, cut_posts):
            out[v] = m
        return out, logz

    def _log_masks_and_weights(self, mask_batch):
        """Split linear masks into reduced-model LOG masks (full per-var
        list, clamped so forbidden states survive max-reductions) and the
        per-(s, b) cutset log-weights."""
        import jax.numpy as jnp

        plan = self.plan
        cset = set(self.cutset)
        B = None
        for m in mask_batch.values():
            B = int(np.shape(m)[0])
            break
        if B is None:
            raise ValueError("need at least one evidence mask")
        _NEG = -1e30
        by_id = {
            plan.table.id_of(k): np.asarray(v, dtype=np.float64)
            for k, v in mask_batch.items() if k not in cset
        }
        logmasks = []
        with np.errstate(divide="ignore"):
            for v in range(plan.num_vars):
                if v in by_id:
                    lm = np.maximum(np.log(by_id[v]), _NEG)
                    logmasks.append(jnp.asarray(lm, dtype=jnp.float32))
                else:
                    logmasks.append(
                        jnp.zeros((B, plan.sizes[v]), dtype=jnp.float32)
                    )
        logw = jnp.zeros((self.num_states, B), dtype=jnp.float32)
        for k in self.cutset:
            if k not in mask_batch:
                continue
            with np.errstate(divide="ignore"):
                lm = jnp.asarray(
                    np.maximum(
                        np.log(np.asarray(mask_batch[k], dtype=np.float64)),
                        _NEG,
                    ),
                    dtype=jnp.float32,
                )
            sel = jnp.asarray(self._assignments[:, self.cutset.index(k)])
            logw = logw + lm[:, sel].T
        return logmasks, logw, B

    def map_assignment_batch(self, mask_batch):
        """Exact batched MPE past the treewidth wall: per cutset assignment,
        the reduced model's max-product traceback (map_executor), then the
        best assignment over the cutset axis.

        MPE = max_s [ max_rest joint(rest | s) * w_s(evidence) ] — the max
        distributes over the conditioning exactly like the sum does for
        posteriors.  ``mask_batch``: {label: [B, size] LINEAR masks} for any
        variable (reduced or cutset).  Returns ({label: [B] int arrays over
        EVERY variable incl. the cutset}, scores [B] log unnormalized)."""
        import jax
        import jax.numpy as jnp

        from .map_executor import tree_map_program

        plan = self.plan
        logmasks, logw, B = self._log_masks_and_weights(mask_batch)

        chunk = self._chunk_for(B)
        key = ("map", chunk)
        fn = self._prog_cache.get(key)
        if fn is None:
            prog = tree_map_program(plan, list(range(plan.num_vars)))

            def mp(pots, masks, logw):
                assign, score = jax.lax.map(
                    lambda p: prog(p, masks), pots, batch_size=chunk
                )  # [S, B, n_red_vars] int32, [S, B]
                score = score + logw
                best = jnp.argmax(score, axis=0)                 # [B]
                top = jnp.take_along_axis(
                    score, best[None, :], axis=0
                )[0]                                             # [B]
                sel = jnp.take_along_axis(
                    assign, best[None, :, None], axis=0
                )[0]                                             # [B, n_red]
                return sel, best, top

            from .config import DEFAULT as _CFG

            fn = jax.jit(
                mp,
                donate_argnums=(
                    (1, 2) if _CFG.donate_serving_masks else ()
                ),
            )
            self._prog_cache[key] = fn

        # max-product wants log-space potentials — self._pots already are
        sel, best, top = fn(self._pots, logmasks, logw)
        sel = np.asarray(sel)
        best = np.asarray(best)
        out = {
            plan.table.label_of(v): sel[:, v].astype(np.int32)
            for v in range(plan.num_vars)
        }
        for j, k in enumerate(self.cutset):
            out[k] = self._assignments[best, j].astype(np.int32)
        return out, np.asarray(top)

    def map_assignment(self, evidence: Optional[Dict] = None):
        """Single MPE query with hard evidence {label: state}.  Returns
        ({label: state}, log unnormalized joint at the assignment)."""
        evidence = dict(evidence or {})
        masks = {}
        for k, state in evidence.items():
            m = np.zeros((1, self.sizes[k]), dtype=np.float32)
            m[0, int(state)] = 1.0
            masks[k] = m
        if not masks:  # need one mask to size the batch
            k0 = next(iter(self.sizes))
            masks[k0] = np.ones((1, self.sizes[k0]), dtype=np.float32)
        assign, score = self.map_assignment_batch(masks)
        return {k: int(v[0]) for k, v in assign.items()}, float(score[0])
