"""Approximate inference: loopy belief propagation on the raw factor graph.

The exact engine's cost is exponential in treewidth — a 30x30 grid MRF has
treewidth ~30 and is out of reach for exact junction-tree inference (the
reference library simply cannot run such models at all).  Loopy BP runs sum-
product message passing directly on the (non-chordalized) factor graph with a
synchronous flooding schedule; on tree-structured graphs it is exact, on
loopy graphs it converges to the Bethe approximation of the marginals and
log-partition function.

Accelerator-first design (vs the reference's per-message Python recursion,
/root/reference/junctiontree/computation.py:47-96):

  * factors are bucketed by shape and prestacked into [G, *shape] tensors;
    one flooding iteration is O(buckets x max_arity) dense XLA ops,
    independent of the number of factors — a 30x30 grid (1800 factors) is
    the same program as a 3x3 grid;
  * all messages live in one padded [E, B, K_max] tensor; variable-side
    products are `segment_prod` scatters, factor-side gathers are static;
  * iterations run under `lax.scan` in chunks, with host-side convergence
    checks between chunks (static shapes, one compile);
  * evidence is per-variable masks with a batch axis (same contract as
    `Engine.posterior_batch`), so one compiled program serves every
    evidence instantiation.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .labels import LabelTable, intern_factors

_TINY = 1e-30


class LoopyPosteriors:
    """Lazy list-like view over [V, B, K] loopy-BP beliefs; ``[v]`` returns
    the normalized [B, size_v] posterior for that var id on access."""

    def __init__(self, b_v, sizes):
        self._b_v = b_v
        self._sizes = sizes

    def __len__(self) -> int:
        return len(self._sizes)

    def __getitem__(self, v: int):
        return self._b_v[v, :, : self._sizes[v]]

    def __iter__(self):
        for v in range(len(self)):
            yield self[v]


class LoopyEngine:
    """Loopy-BP engine over a factor graph (no triangulation).

    Same query contract as the exact ``Engine.posterior_batch`` — returns
    (normalized per-variable posteriors, logZ estimate) — but approximate on
    loopy graphs and linear in the factor sizes instead of exponential in
    treewidth."""

    def __init__(
        self,
        factors: Sequence[Sequence[Hashable]],
        sizes: Dict[Hashable, int],
        values: Optional[Sequence[np.ndarray]] = None,
        damping: float = 0.5,
        max_iters: int = 200,
        tol: float = 1e-6,
        chunk_iters: int = 50,
        mesh=None,
        batch_axis: str = "batch",
    ):
        """mesh/batch_axis: optional jax.sharding.Mesh — the evidence batch
        (trailing axis of the internal message layout) is sharded over
        ``batch_axis`` and XLA GSPMD partitions every flooding iteration
        (pure data parallelism: no cross-device collectives until the
        caller aggregates)."""
        self.table, self.factors, self.sizes = intern_factors(factors, sizes)
        if not self.factors:
            raise ValueError("need at least one factor")
        if any(len(f) == 0 for f in self.factors):
            raise ValueError("scalar (zero-variable) factors not supported")
        self.damping = float(damping)
        self.max_iters = int(max_iters)
        self.tol = float(tol)
        self.chunk_iters = int(chunk_iters)
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.num_vars = len(self.sizes)
        self.K = max(self.sizes)

        # ---- bucket factors by shape; build static edge tables ----
        shape_of = lambda f: tuple(self.sizes[v] for v in f)
        bucket_ix: Dict[tuple, int] = {}
        self.bucket_shapes: List[tuple] = []
        self.bucket_factors: List[List[int]] = []
        for fi, f in enumerate(self.factors):
            sh = shape_of(f)
            if sh not in bucket_ix:
                bucket_ix[sh] = len(self.bucket_shapes)
                self.bucket_shapes.append(sh)
                self.bucket_factors.append([])
            self.bucket_factors[bucket_ix[sh]].append(fi)

        # edge = (factor, position); ids assigned bucket-major,
        # position-major — so every (bucket, position) owns a CONTIGUOUS id
        # range.  That turns all message writes into concatenations and all
        # reads into static slices (no scatter/gather in the hot loop).
        self.edge_var: List[int] = []
        self.bucket_eids: List[List[np.ndarray]] = []   # [b][p] -> [G] ids
        self.bucket_estart: List[List[int]] = []        # [b][p] -> start id
        self.bucket_evars: List[List[np.ndarray]] = []  # [b][p] -> [G] vars
        for b, fis in enumerate(self.bucket_factors):
            arity = len(self.bucket_shapes[b])
            eids, evars, starts = [], [], []
            for p in range(arity):
                starts.append(len(self.edge_var))
                ids = []
                vs = []
                for fi in fis:
                    ids.append(len(self.edge_var))
                    v = self.factors[fi][p]
                    self.edge_var.append(v)
                    vs.append(v)
                eids.append(np.asarray(ids, dtype=np.int32))
                evars.append(np.asarray(vs, dtype=np.int32))
            self.bucket_eids.append(eids)
            self.bucket_estart.append(starts)
            self.bucket_evars.append(evars)
        self.E = len(self.edge_var)
        self.edge_var_arr = np.asarray(self.edge_var, dtype=np.int32)
        # per-var incoming-edge table padded to max degree; the pad entry
        # points at a sentinel all-ones row appended to the message tensor
        deg = np.bincount(self.edge_var_arr, minlength=self.num_vars)
        self.max_degree = int(deg.max()) if len(deg) else 0
        self.inc_idx = np.full(
            (self.num_vars, self.max_degree), self.E, dtype=np.int32
        )
        fill = np.zeros(self.num_vars, dtype=np.int64)
        for e, v in enumerate(self.edge_var_arr):
            self.inc_idx[v, fill[v]] = e
            fill[v] += 1
        # lane validity per edge [E, K] and per var [V, K]
        esz = np.asarray([self.sizes[v] for v in self.edge_var])
        lanes = np.arange(self.K)[None, :]
        self.edge_lane = (lanes < esz[:, None]).astype(np.float32)
        vsz = np.asarray(self.sizes)
        self.var_lane = (lanes < vsz[:, None]).astype(np.float32)
        self.degree = np.bincount(
            self.edge_var_arr, minlength=self.num_vars
        ).astype(np.float32)

        self._pots: Optional[List[jnp.ndarray]] = None  # stacked per bucket
        self._cache: dict = {}
        if values is not None:
            self.set_potentials(values)

    # ------------------------------------------------------------------
    def set_potentials(self, values: Sequence[np.ndarray]) -> "LoopyEngine":
        if len(values) != len(self.factors):
            raise ValueError(
                f"expected {len(self.factors)} value arrays, got {len(values)}"
            )
        for f, v in zip(self.factors, values):
            want = tuple(self.sizes[x] for x in f)
            if tuple(np.shape(v)) != want:
                raise ValueError(
                    f"potential shape {np.shape(v)} != factor shape {want}"
                )
        self._pots = [
            jnp.asarray(
                np.stack([np.asarray(values[fi], dtype=np.float32)
                          for fi in fis])
            )
            for fis in self.bucket_factors
        ]
        self._cache.clear()
        return self

    # ------------------------------------------------------------------
    def _program(self, B: int, mode: str = "sum", obs_ids: tuple = ()):
        """Jitted (masks_obs [O,K,B], m [E,K,B]) -> (m', delta) one chunk of
        flooding iterations, plus a belief/readout program.

        Only the observed variables' masks cross host->device ([O,K,B]);
        the dense [V,K,B] mask tensor is built on device (one static
        scatter) — per-query upload scales with the evidence, not the
        model.

        Internal layout is batch-LAST: the large batch axis is the
        contiguous minor dimension, so elementwise work over
        small-cardinality variables (K=2..4) vectorizes over the batch
        instead of over a 2-4 wide axis.  The readout converts back to the
        external [V, B, K] contract.

        mode: "sum" = sum-product (posteriors + Bethe logZ), "max" =
        max-product (approximate MAP max-marginals; readout returns beliefs
        and a zero logZ placeholder)."""
        edge_var = jnp.asarray(self.edge_var_arr)
        edge_lane = jnp.asarray(self.edge_lane)[:, :, None]  # [E,K,1]
        var_lane = jnp.asarray(self.var_lane)[:, :, None]    # [V,K,1]
        inc_idx = jnp.asarray(self.inc_idx)                  # [V,D]
        V, E, K = self.num_vars, self.E, self.K
        pots = self._pots
        damping = self.damping
        reduce_op = jnp.max if mode == "max" else jnp.sum
        obs_arr = np.asarray(obs_ids, dtype=np.int32)

        def dense_masks(masks_obs):
            dm = jnp.ones((V, K, B), dtype=jnp.float32)
            if len(obs_ids):
                dm = dm.at[obs_arr].set(masks_obs)
            return dm

        def var_to_factor(masks, m):
            """v->f messages [E,K,B] from current f->v messages."""
            # per-var product over incoming edges via a padded-degree gather
            # (a gather instead of segment_prod's scatter)
            m_ext = jnp.concatenate(
                [m, jnp.ones((1,) + m.shape[1:], m.dtype)], axis=0
            )
            prod = jnp.prod(m_ext[inc_idx], axis=1)  # [V,K,B]
            belief = masks * prod * var_lane + (1.0 - var_lane)
            v2f = belief[edge_var] / jnp.maximum(m, _TINY)
            s = jnp.sum(v2f * edge_lane, axis=1, keepdims=True)
            return jnp.where(
                edge_lane > 0, v2f / jnp.maximum(s, _TINY), 1.0
            )

        def factor_to_var(v2f, m_old):
            """One flooding update of all f->v messages.

            Edge ids are contiguous per (bucket, position), so the new
            message tensor is a concatenation of per-position blocks — no
            scatter."""
            pieces = []
            for b, sh in enumerate(self.bucket_shapes):
                arity = len(sh)
                G = len(self.bucket_factors[b])
                pot = pots[b][..., None]  # [G,*sh,1]
                ins = []
                for p in range(arity):
                    st = self.bucket_estart[b][p]
                    rows = v2f[st:st + G, : sh[p], :]
                    shape = [G] + [1] * arity + [-1]
                    shape[1 + p] = sh[p]
                    ins.append(rows.reshape(shape))
                # leave-one-out prefix/suffix products
                prefix = [None] * arity
                run = None
                for p in range(arity):
                    prefix[p] = run
                    run = ins[p] if run is None else run * ins[p]
                suffix = [None] * arity
                run = None
                for p in range(arity - 1, -1, -1):
                    suffix[p] = run
                    run = ins[p] if run is None else run * ins[p]
                for p in range(arity):
                    acc = pot
                    if prefix[p] is not None:
                        acc = acc * prefix[p]
                    if suffix[p] is not None:
                        acc = acc * suffix[p]
                    red = tuple(1 + a for a in range(arity) if a != p)
                    out = reduce_op(acc, axis=red) if red else acc
                    s = jnp.sum(out, axis=1, keepdims=True)
                    out = out / jnp.maximum(s, _TINY)  # [G, size_p, B?]
                    if sh[p] < K:
                        out = jnp.pad(
                            out,
                            ((0, 0), (0, K - sh[p]), (0, 0)),
                            constant_values=1.0,
                        )
                    # unary factors have batch-free messages (leave-one-out
                    # excludes their only input); make every block [G,K,B]
                    pieces.append(
                        jnp.broadcast_to(out, (G, K, v2f.shape[-1]))
                    )
            m_new = jnp.concatenate(pieces, axis=0)
            return damping * m_old + (1.0 - damping) * m_new

        def chunk(masks_obs, m):
            masks = dense_masks(masks_obs)

            def body(m, _):
                v2f = var_to_factor(masks, m)
                m2 = factor_to_var(v2f, m)
                delta = jnp.max(jnp.abs(m2 - m))
                return m2, delta
            m, deltas = jax.lax.scan(
                body, m, None, length=self.chunk_iters
            )
            return m, deltas[-1]

        def readout(masks_obs, m):
            """(var marginals [V,B,K] (external layout), logZ_bethe [B])."""
            masks = dense_masks(masks_obs)
            m_ext = jnp.concatenate(
                [m, jnp.ones((1,) + m.shape[1:], m.dtype)], axis=0
            )
            prod = jnp.prod(m_ext[inc_idx], axis=1)
            belief = masks * prod * var_lane
            bsum = jnp.sum(belief, axis=1, keepdims=True)
            b_v = belief / jnp.maximum(bsum, _TINY)  # [V,K,B]
            B_ = belief.shape[-1]
            if mode == "max":  # max-marginals only; no Bethe free energy
                return (
                    jnp.swapaxes(b_v, 1, 2),
                    jnp.zeros((B_,), belief.dtype),
                )
            v2f = var_to_factor(masks, m)

            logz = jnp.zeros((B_,), dtype=belief.dtype)
            xlogy = lambda p, q: jnp.where(
                p > _TINY, p * jnp.log(jnp.maximum(q, _TINY)), 0.0
            )
            for b, sh in enumerate(self.bucket_shapes):
                arity = len(sh)
                G = len(self.bucket_factors[b])
                pot = pots[b][..., None]
                acc = pot
                for p in range(arity):
                    st = self.bucket_estart[b][p]
                    rows = v2f[st:st + G, : sh[p], :]
                    shape = [G] + [1] * arity + [-1]
                    shape[1 + p] = sh[p]
                    acc = acc * rows.reshape(shape)
                axes = tuple(range(1, 1 + arity))
                z_f = jnp.sum(acc, axis=axes, keepdims=True)
                b_f = acc / jnp.maximum(z_f, _TINY)
                # sum_f E_{b_f}[log pot_f - log b_f]
                term = xlogy(b_f, jnp.broadcast_to(pot, b_f.shape)) - xlogy(
                    b_f, b_f
                )
                logz = logz + jnp.sum(term, axis=(0,) + axes).reshape(-1)
            # + sum_v E_{b_v}[log mask_v] + (d_v - 1) E[log b_v]
            logz = logz + jnp.sum(xlogy(b_v, masks), axis=(0, 1))
            dv = jnp.asarray(self.degree)[:, None, None] - 1.0
            logz = logz + jnp.sum(dv * xlogy(b_v, b_v), axis=(0, 1))
            return jnp.swapaxes(b_v, 1, 2), logz

        return jax.jit(chunk), jax.jit(readout)

    # ------------------------------------------------------------------
    def _stack_obs_masks(self, mask_batch, B: int):
        """Dict {var label or id: [B, size]} -> (obs_ids tuple sorted,
        stacked [O, K, B] numpy masks, pad=1).  Only observed variables
        cross host->device."""
        by_id = {}
        for k, m in mask_batch.items():
            vid = k if isinstance(k, int) else self.table.id_of(k)
            m = np.asarray(m, dtype=np.float32)
            if m.shape != (B, self.sizes[vid]):
                raise ValueError(
                    f"mask for {k}: expected {(B, self.sizes[vid])}, "
                    f"got {m.shape}"
                )
            by_id[vid] = m if vid not in by_id else by_id[vid] * m
        obs_ids = tuple(sorted(by_id))
        out = np.ones((len(obs_ids), self.K, B), dtype=np.float32)
        for i, vid in enumerate(obs_ids):
            out[i, : self.sizes[vid], :] = by_id[vid].T
        return obs_ids, out

    def posterior_batch(
        self, mask_batch: Dict, batch: Optional[int] = None
    ):
        """Approximate posteriors + Bethe logZ under batched evidence masks.

        mask_batch: {var label or interned id: [B, size_v]} linear masks.
        Returns (list over var ids of [B, size_v] normalized posteriors,
        logZ [B], info dict with 'iters' and 'delta')."""
        if self._pots is None:
            raise RuntimeError("call set_potentials(values) first")
        if batch is None:
            if not mask_batch:
                raise ValueError("pass batch= when mask_batch is empty")
            batch = int(next(iter(mask_batch.values())).shape[0])
        b_v, logz, info = self._run(mask_batch, batch, mode="sum")
        # lazy per-var view: slicing all V vars eagerly would dispatch V
        # device ops per query even when the caller reads a handful
        return LoopyPosteriors(b_v, self.sizes), logz, info

    def _run(self, mask_batch, batch: int, mode: str):
        obs_ids, masks_np = self._stack_obs_masks(mask_batch, batch)
        key = ("prog", batch, mode, obs_ids)
        if key not in self._cache:
            self._cache[key] = self._program(batch, mode, obs_ids)
        chunk, readout = self._cache[key]
        masks = jnp.asarray(masks_np)
        m = jnp.ones((self.E, self.K, batch), dtype=jnp.float32)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(self.mesh, P(None, None, self.batch_axis))
            masks = jax.device_put(masks, sh)
            m = jax.device_put(m, sh)
        iters = 0
        d = None
        while iters < self.max_iters:
            m, d = chunk(masks, m)
            iters += self.chunk_iters
            # tol<=0 disables early exit, so skip the per-chunk device->host
            # delta read — each sync stalls the device queue; the final
            # delta is read once below
            if self.tol > 0 and float(d) < self.tol:
                break
        b_v, logz = readout(masks, m)
        return b_v, logz, {"iters": iters, "delta": float(d)}

    def map_assignment_batch(
        self, mask_batch: Dict, batch: Optional[int] = None
    ):
        """Approximate MAP by max-product flooding + per-variable argmax.

        Exact on trees (up to ties); on loopy graphs this is the standard
        max-product BP heuristic.  Returns (assignments [B, num_vars] int32,
        scores [B] = log unnormalized joint at the decoded assignment
        including mask terms, info)."""
        if self._pots is None:
            raise RuntimeError("call set_potentials(values) first")
        if batch is None:
            if not mask_batch:
                raise ValueError("pass batch= when mask_batch is empty")
            batch = int(next(iter(mask_batch.values())).shape[0])
        b_v, _, info = self._run(mask_batch, batch, mode="max")
        lanes = jnp.asarray(self.var_lane)[:, None, :]
        assign = np.asarray(
            jnp.argmax(jnp.where(lanes > 0, b_v, -1.0), axis=-1),
            dtype=np.int32,
        ).T  # [B, V]
        # score the decoded assignments: sum of log potentials + log masks
        obs_ids, obs_np = self._stack_obs_masks(mask_batch, batch)
        masks_np = np.ones(
            (self.num_vars, self.K, batch), dtype=np.float32
        )
        if obs_ids:
            masks_np[list(obs_ids)] = obs_np
        scores = np.zeros(batch, dtype=np.float64)
        with np.errstate(divide="ignore"):
            for b, fis in enumerate(self.bucket_factors):
                pot = np.asarray(self._pots[b])  # [G, *shape]
                flat = pot.reshape(len(fis), -1)
                strides = np.cumprod(
                    (self.bucket_shapes[b] + (1,))[::-1]
                )[::-1][1:]
                idx = np.zeros((batch, len(fis)), dtype=np.int64)
                for p, st in enumerate(strides):
                    idx += assign[:, self.bucket_evars[b][p]] * st
                scores += np.log(
                    np.maximum(flat[np.arange(len(fis))[None, :], idx], 0)
                ).sum(axis=1)
            vidx = np.arange(self.num_vars)
            scores += np.log(
                masks_np[vidx[None, :], assign,
                         np.arange(batch)[:, None]]
            ).sum(axis=1)
        return assign, scores, info

    def map_assignment(self, evidence: Optional[Dict[Hashable, int]] = None):
        """Single-query approximate MAP: ({var label: state}, score, info)."""
        evidence = evidence or {}
        masks = {}
        for k, s in evidence.items():
            vid = k if isinstance(k, int) else self.table.id_of(k)
            if not (0 <= s < self.sizes[vid]):
                raise ValueError(f"state {s} out of range for {k}")
            m = np.zeros((1, self.sizes[vid]), dtype=np.float32)
            m[0, s] = 1.0
            masks[vid] = m
        assign, scores, info = self.map_assignment_batch(masks, batch=1)
        out = {
            self.table.label_of(v): int(assign[0, v])
            for v in range(self.num_vars)
        }
        return out, float(scores[0]), info

    def posterior(self, evidence: Optional[Dict[Hashable, int]] = None):
        """Single-query convenience: evidence {var: state} -> (posteriors,
        logZ, info) with the batch axis squeezed."""
        evidence = evidence or {}
        masks = {}
        for k, s in evidence.items():
            vid = k if isinstance(k, int) else self.table.id_of(k)
            if not (0 <= s < self.sizes[vid]):
                raise ValueError(f"state {s} out of range for {k}")
            m = np.zeros((1, self.sizes[vid]), dtype=np.float32)
            m[0, s] = 1.0
            masks[vid] = m
        margs, logz, info = self.posterior_batch(masks, batch=1)
        return [m[0] for m in margs], float(logz[0]), info
