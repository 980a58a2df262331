#!/usr/bin/env python3
"""Smoke run of the serving path on one NVIDIA GPU, checked against a plain
float64 NumPy reference.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: DP, TP and SP against one card

Phases (one card):
  device   the card must be a GPU; its name and power limit are printed
  uai      7x7 card-3 grid MRF written as UAI files, run through the CLI
           (MAR), then Engine.posterior_batch at B=10240 and
           map_assignment_batch at B=2048
  hail     hailfinder-class BN (56 nodes, 12.4M-state cliques), posterior_batch
           at B=256 with chunk=128
  clique   one 2^18-state clique (18 binary vars, evidence on 12),
           posterior_batch at B=4096
  factored the same clique's marginals and Z through the factored
           big-clique contraction (the form Engine.shard_model's shards
           run), against the clique phase; then that contraction at every
           (R1, R2, C, B) shape it met, in f32 and bf16, against a float64
           oracle

Phases (--four, four cards; each against the same query on one card):
  four-dp  Engine.shard_batch: the UAI grid at B=10240, batch over 4 cards
  four-tp  Engine.shard_model: the 2^18-state clique, potential over 4 cards
  four-sp  Engine.shard_sequence: a 5000-variable chain, steps over 4 cards

The repository has no hand-written kernel: every phase runs XLA's own code
for the GPU.

Every model phase compares rows of its batch with tests/util.py's
numpy_tree_propagate.  Any failure exits non-zero before the result line;
so does a run without a GPU.  tests/test_chip_smoke.py runs the phases on
CPU at small sizes.
The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
The UAI files the run writes go to smoke_out/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_out")

# parity tolerances (float32 programs at matmul_precision="highest" against
# the float64 reference)
POST_RTOL, POST_ATOL = 1e-4, 1e-6
LOGZ_ATOL = 1e-4
# the factored contraction against float64 on positive operands: float32
# sums differ from it by summation order only (TF32 products would show
# ~1e-3); bfloat16 storage, accumulated in float32, measured 1.2e-5 on an
# H100
FACTORED_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
# two float32 programs over the same query that sum in different orders
# (factored vs grouped route, four cards vs one): posteriors; their log Z
# must agree to LOGZ_ATOL
AGREE_ATOL = 1e-5

# full-size batch and model sizes (tests/test_chip_smoke.py passes small ones)
SIZES = dict(uai_b=10240, map_b=2048, hail_b=256, hail_chunk=128,
             clique_nv=18, clique_obs=12, clique_b=4096, rows=8, hail_rows=2,
             chain_n=5000, chain_b=1024)


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit (one line per card), from a child
    that stays off JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"


def block(x):
    import jax

    return jax.block_until_ready(x)


def timed_windows(fn, rounds=5, iters=5):
    """Median and range of per-call seconds over ``rounds`` windows."""
    ws = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        block(out)
        ws.append((time.perf_counter() - t0) / iters)
    return statistics.median(ws), min(ws), max(ws)


def interleaved(fns, rounds=7, iters=10):
    """Per-variant median seconds per call, variants timed in turns."""
    for f in fns:
        block(f())
    ws = [[] for _ in fns]
    for _ in range(rounds):
        for i, f in enumerate(fns):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = f()
            block(out)
            ws[i].append((time.perf_counter() - t0) / iters)
    return [statistics.median(w) for w in ws]


def peak_bytes(dev) -> str:
    st = dev.memory_stats() or {}
    p = st.get("peak_bytes_in_use")
    return f"{p / 2**30:.3f} GiB" if p is not None else "not reported"


class Parity:
    """Largest posterior / log Z errors of a phase against the reference."""

    def __init__(self, name):
        self.name, self.post, self.logz = name, 0.0, 0.0

    def check(self, posts, logz, ref_margs, ref_logz):
        import numpy as np

        for vid, m in enumerate(ref_margs):
            got = np.asarray(posts[vid], dtype=np.float64)
            excess = np.abs(got - m) - (POST_ATOL + POST_RTOL * np.abs(m))
            self.post = max(self.post, float(np.max(np.abs(got - m))))
            if np.any(excess > 0):
                raise AssertionError(
                    f"{self.name}: posterior of var {vid} off by "
                    f"{float(np.max(np.abs(got - m))):.3g}"
                )
        err = abs(float(logz) - ref_logz)
        self.logz = max(self.logz, err)
        if not err <= LOGZ_ATOL:
            raise AssertionError(f"{self.name}: log Z off by {err:.3g}")

    def report(self, rows):
        say(f"[{self.name}] parity over {rows} rows: max |posterior err| "
            f"{self.post:.3e} (rtol {POST_RTOL}, atol {POST_ATOL}), "
            f"max |log Z err| {self.logz:.3e} (atol {LOGZ_ATOL})")


class RouteLog:
    """Records the (R1, R2, C, B) and dtype of every factored big-clique
    contraction traced while active."""

    def __init__(self):
        import junctiontree_tpu.ops.factored as fc

        self.fc = fc
        self.shapes = []
        self._orig = fc.reference_factored_contract

    def __enter__(self):
        def rec(pot, w1, w2):
            self.shapes.append(
                (tuple(int(d) for d in pot.shape) + (int(w1.shape[0]),),
                 str(pot.dtype))
            )
            return self._orig(pot, w1, w2)

        self.shapes.clear()
        self.fc.reference_factored_contract = rec
        return self

    def __exit__(self, *exc):
        self.fc.reference_factored_contract = self._orig

    def summary(self):
        from collections import Counter

        return dict(Counter(self.shapes))


def serve(name, eng, plan, values, evs, dev, card, rows, chunk=None,
          build_s=None):
    """posterior_batch on the evidence rows: cold call, timed windows, host
    transfer, then parity of ``rows`` rows against the NumPy reference."""
    import numpy as np

    from junctiontree_tpu.evidence import batch_masks_sparse
    from tests.util import numpy_tree_propagate

    B = len(evs)
    t0 = time.perf_counter()
    masks = batch_masks_sparse(plan, evs)
    mask_s = time.perf_counter() - t0

    def call():
        return eng.posterior_batch(masks, chunk=chunk)

    t0 = time.perf_counter()
    block(call())
    cold = time.perf_counter() - t0
    med, lo, hi = timed_windows(call)
    t0 = time.perf_counter()
    post, logz = call()
    post_h = [np.asarray(p) for p in post]
    logz_h = np.asarray(logz)
    to_host = time.perf_counter() - t0
    say(f"[{name}] B={B}{'' if chunk is None else f' chunk={chunk}'}: "
        f"plan build {build_s:.3f} s, masks {mask_s:.3f} s, cold compile+run "
        f"{cold:.2f} s, step {med * 1e3:.3f} ms [{lo * 1e3:.3f}-"
        f"{hi * 1e3:.3f}] = {B / med:,.0f} q/s, call+to-host "
        f"{to_host * 1e3:.3f} ms, peak_bytes_in_use {peak_bytes(dev)}  "
        f"({card})")
    assert all(np.all(np.isfinite(p)) for p in post_h), "non-finite posterior"
    assert logz_h.shape == (B,) and np.all(np.isfinite(logz_h))
    assert all(p.shape == (B, plan.sizes[v]) for v, p in enumerate(post_h))
    par = Parity(name)
    for b in range(rows):
        ref_m, ref_lz = numpy_tree_propagate(plan, values, evs[b])
        par.check([p[b] for p in post_h], logz_h[b], ref_m, ref_lz)
    par.report(rows)
    return post_h, logz_h


def phase_uai(S, dev, card):
    import numpy as np

    import junctiontree_tpu as jt
    from junctiontree_tpu.__main__ import main as cli_main
    from junctiontree_tpu.evidence import (
        batch_masks_sparse,
        random_evidence_batch,
    )
    from junctiontree_tpu.models import grid_mrf_model
    from junctiontree_tpu.utils.uai import write_uai
    from tests.util import numpy_tree_propagate

    factors, sizes, values = grid_mrf_model(7, 7, card=3, seed=5)
    ids = {name: i for i, name in enumerate(sizes)}
    factors = [[ids[v] for v in f] for f in factors]
    sizes = {ids[v]: s for v, s in sizes.items()}
    model = os.path.join(OUT, "grid7x7_card3.uai")
    with open(model, "w") as f:
        f.write(write_uai(factors, sizes, values))
    cli_ev = {0: 2, 24: 1, 48: 0}
    evid = os.path.join(OUT, "grid7x7_card3.uai.evid")
    with open(evid, "w") as f:
        f.write(f"{len(cli_ev)} " + " ".join(
            f"{k} {v}" for k, v in cli_ev.items()) + "\n")
    mar = os.path.join(OUT, "grid7x7_card3.MAR")
    t0 = time.perf_counter()
    rc = cli_main([model, "--evidence", evid, "--task", "MAR", "--out", mar])
    cli_s = time.perf_counter() - t0
    assert rc == 0, f"CLI exited {rc}"
    toks = open(mar).read().split()
    assert toks[0] == "MAR" and int(toks[1]) == len(sizes)
    t0 = time.perf_counter()
    tree = jt.create_junction_tree(factors, sizes)
    build = time.perf_counter() - t0
    plan = tree.plan
    ref_m, _ = numpy_tree_propagate(plan, values, cli_ev)
    pos, cli_err = 2, 0.0
    for v in range(len(sizes)):
        k = int(toks[pos])
        p = np.array([float(x) for x in toks[pos + 1: pos + 1 + k]])
        pos += 1 + k
        cli_err = max(cli_err, float(np.max(np.abs(
            p - ref_m[plan.table.id_of(v)]))))
    assert cli_err <= 1e-6 + POST_RTOL, f"CLI MAR off by {cli_err:.3g}"
    say(f"[uai] CLI MAR on {model.split(os.sep)[-1]}: {cli_s:.2f} s, "
        f"max |marginal err| {cli_err:.3e} (file written with 8 decimals)")

    eng = tree.engine().set_potentials(values)
    observed = list(sizes)[::3]
    evs = random_evidence_batch(plan, S["uai_b"], observed, seed=11)
    serve("uai", eng, plan, values, evs, dev, card, S["rows"], build_s=build)

    # batched MAP: log-space masks, scores checked against the max-product
    # reference (the decoded assignment must reach the maximum)
    B = S["map_b"]
    mevs = evs[:B]
    lin = batch_masks_sparse(plan, mevs)
    logm = {k: np.where(v > 0, 0.0, -np.inf).astype(np.float32)
            for k, v in lin.items()}
    t0 = time.perf_counter()
    assign, scores = eng.map_assignment_batch(logm)
    block(scores)
    cold = time.perf_counter() - t0
    med, lo, hi = timed_windows(lambda: eng.map_assignment_batch(logm)[1])
    assign = np.asarray(assign)
    scores = np.asarray(scores)
    say(f"[uai-map] B={B}: cold compile+run {cold:.2f} s, step "
        f"{med * 1e3:.3f} ms [{lo * 1e3:.3f}-{hi * 1e3:.3f}] = "
        f"{B / med:,.0f} MAP/s, peak_bytes_in_use {peak_bytes(dev)}")
    worst = 0.0
    for b in range(S["rows"]):
        _, ref_max = numpy_tree_propagate(plan, values, mevs[b], mode="max")
        full = {plan.table.label_of(v): int(assign[b, v])
                for v in range(plan.num_vars)}
        for k, s in mevs[b].items():
            assert full[k] == s, "MAP assignment contradicts the evidence"
        logp = float(sum(
            np.log(values[f][tuple(full[v] for v in fac)])
            for f, fac in enumerate(factors)))
        tol = 1e-4 * max(1.0, abs(ref_max))
        err = max(abs(float(scores[b]) - ref_max), abs(logp - ref_max))
        worst = max(worst, err)
        assert err <= tol, f"MAP row {b}: score off by {err:.3g}"
    say(f"[uai-map] parity over {S['rows']} rows: max |log score err| "
        f"{worst:.3e} (relative tol 1e-4)")


def phase_hail(S, dev, card):
    import junctiontree_tpu as jt
    from junctiontree_tpu.evidence import random_evidence_batch
    from junctiontree_tpu.models import hailfinder_like

    factors, sizes, values = hailfinder_like()
    t0 = time.perf_counter()
    tree = jt.create_junction_tree(factors, sizes)
    build = time.perf_counter() - t0
    st = tree.stats()
    say(f"[hail] treewidth {st['treewidth']}, max clique "
        f"{st['max_clique_states']:,} states, max separator "
        f"{st['max_sep_states']:,} states")
    eng = tree.engine().set_potentials(values)
    evs = random_evidence_batch(tree.plan, S["hail_b"], list(sizes)[::3],
                                seed=7)
    serve("hail", eng, tree.plan, values, evs, dev, card, S["hail_rows"],
          chunk=S["hail_chunk"], build_s=build)


def clique_model(nv):
    import numpy as np

    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(nv)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 2 for n in names}
    values = [rng.random((2,) * nv).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names
    ]
    return factors, sizes, values, names


def phase_clique(S, dev, card):
    import junctiontree_tpu as jt
    from junctiontree_tpu.evidence import random_evidence_batch

    factors, sizes, values, names = clique_model(S["clique_nv"])
    t0 = time.perf_counter()
    tree = jt.create_junction_tree(factors, sizes)
    build = time.perf_counter() - t0
    eng = tree.engine().set_potentials(values)
    evs = random_evidence_batch(tree.plan, S["clique_b"],
                                names[:S["clique_obs"]], seed=1)
    post, logz = serve("clique", eng, tree.plan, values, evs, dev, card,
                       S["rows"], build_s=build)
    return tree, values, evs, post, logz


def phase_factored(S, dev, card, clique):
    """The clique's marginals and Z through the factored big-clique
    contraction on one card (ops/factored.big_clique_sep_message, the form
    each shard of Engine.shard_model runs), against the clique phase; then
    that contraction at the shapes it met, in f32 and bf16, against a
    float64 oracle.  Nothing here is timed: one card serves this clique by
    the grouped route, and only TP shards run the factored form."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import junctiontree_tpu.ops.factored as fc
    from junctiontree_tpu.evidence import batch_masks_sparse

    tree, values, evs, post1, logz1 = clique
    plan = tree.plan
    eng = tree.engine().set_potentials(values)
    masks = {plan.table.id_of(k): jnp.asarray(v)
             for k, v in batch_masks_sparse(plan, evs).items()}
    cvars = plan.clique_vars[0]
    outs = [[v] for v in range(plan.num_vars)] + [[]]
    fn = jax.jit(lambda pot, masks: [
        fc.big_clique_sep_message(pot, cvars, masks, ov) for ov in outs
    ])
    with RouteLog() as routes:
        res = [np.asarray(r, np.float64)
               for r in block(fn(eng._pots[0], masks))]
    err = max(
        float(np.max(np.abs(r / r.sum(-1, keepdims=True) - p)))
        for r, p in zip(res[:-1], post1)
    )
    zerr = float(np.max(np.abs(np.log(res[-1]) - logz1)))
    assert err <= AGREE_ATOL and zerr <= LOGZ_ATOL, (err, zerr)
    say(f"[factored] 2^{plan.num_vars}-state clique B={len(evs)}, "
        f"{len(outs)} factored contractions: max |posterior diff| vs the "
        f"clique phase {err:.2e} (atol {AGREE_ATOL}), |log Z diff| "
        f"{zerr:.2e} (atol {LOGZ_ATOL})")
    say(f"[factored] shapes (R1, R2, C, B), dtype: {routes.summary()}")

    rng = np.random.default_rng(3)
    xla = jax.jit(fc.reference_factored_contract)
    for (R1, R2, C, B) in sorted({sh for sh, _ in routes.shapes}):
        for dt in (jnp.float32, jnp.bfloat16):
            name = jnp.dtype(dt).name
            args = tuple(
                jax.device_put(jnp.asarray(rng.random(shp), dt), dev)
                for shp in ((R1, R2, C), (B, R1), (B, R2))
            )
            ref = np.einsum("rsc,br,bs->bc",
                            *(np.asarray(x, np.float64) for x in args),
                            optimize=True)
            got = np.asarray(block(xla(*args)))
            rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
            assert rel <= FACTORED_RTOL[name], (
                f"{name} factored contraction off by {rel:.3g}")
            say(f"[factored] {name} R1={R1} R2={R2} C={C} B={B}: max rel "
                f"err {rel:.2e} (limit {FACTORED_RTOL[name]})  ({card})")


# ---------------------------------------------------------------- --four

def sharded_devices(x):
    return {s.device for s in x.addressable_shards}


def compare(name, a, b, za, zb):
    """Largest posterior / log Z differences between the four-card and the
    one-card results."""
    import numpy as np

    err = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
              for x, y in zip(a, b))
    zerr = float(np.max(np.abs(np.asarray(za) - np.asarray(zb))))
    assert err <= AGREE_ATOL and zerr <= LOGZ_ATOL, (name, err, zerr)
    return err, zerr


def four_report(name, what, devs, t1, t4, err, zerr, card):
    say(f"[{name}] {what} on cards {sorted(d.id for d in devs)}: max "
        f"|posterior diff| vs one card {err:.2e}, |log Z diff| {zerr:.2e}; "
        f"step 1 card {t1 * 1e3:.3f} ms, 4 cards {t4 * 1e3:.3f} ms  ({card})")


def phase_four_dp(S, card):
    """Engine.shard_batch: the UAI grid's batch over four cards."""
    import junctiontree_tpu as jt
    from junctiontree_tpu.evidence import (
        batch_masks_sparse,
        random_evidence_batch,
    )
    from junctiontree_tpu.executor import Engine
    from junctiontree_tpu.models import grid_mrf_model
    from junctiontree_tpu.parallel.mesh import make_mesh

    factors, sizes, values = grid_mrf_model(7, 7, card=3, seed=5)
    tree = jt.create_junction_tree(factors, sizes)
    evs = random_evidence_batch(tree.plan, S["uai_b"], list(sizes)[::3],
                                seed=11)
    masks = batch_masks_sparse(tree.plan, evs)
    one = Engine(tree.plan).set_potentials(values)
    dp = Engine(tree.plan).set_potentials(values).shard_batch(make_mesh(4))
    p1, z1 = one.posterior_batch(masks)
    p4, z4 = dp.posterior_batch(masks)
    devs = sharded_devices(z4)
    assert len(devs) == 4, f"DP log Z lives on {devs}"
    t1, t4 = interleaved([lambda: one.posterior_batch(masks)[1],
                          lambda: dp.posterior_batch(masks)[1]], 5, 5)
    err, zerr = compare("four-dp", p1, p4, z1, z4)
    four_report("four-dp", f"UAI grid B={len(evs)}, batch sharded", devs,
                t1, t4, err, zerr, card)


def phase_four_tp(S, card):
    """Engine.shard_model: the 2^18-state clique's potential over four
    cards on the model axis."""
    import junctiontree_tpu as jt
    from junctiontree_tpu.evidence import (
        batch_masks_sparse,
        random_evidence_batch,
    )
    from junctiontree_tpu.executor import Engine
    from junctiontree_tpu.parallel.mesh import make_mesh

    factors, sizes, values, names = clique_model(S["clique_nv"])
    tree = jt.create_junction_tree(factors, sizes)
    evs = random_evidence_batch(tree.plan, S["clique_b"],
                                names[:S["clique_obs"]], seed=1)
    masks = batch_masks_sparse(tree.plan, evs)
    one = Engine(tree.plan).set_potentials(values)
    tp = Engine(tree.plan).shard_model(make_mesh(n_batch=1, n_model=4),
                                   min_states=1 << S["clique_nv"])
    tp.set_potentials(values)
    devs = sharded_devices(tp._pots[0])
    assert len(devs) == 4, f"TP clique potential lives on {devs}"
    p1, z1 = one.posterior_batch(masks)
    t0 = time.perf_counter()
    p4, z4 = block(tp.posterior_batch(masks))
    cold = time.perf_counter() - t0
    assert not tp._tp_notes, tp._tp_notes
    t1, t4 = interleaved([lambda: one.posterior_batch(masks)[1],
                          lambda: tp.posterior_batch(masks)[1]], 5, 5)
    err, zerr = compare("four-tp", p1, p4, z1, z4)
    four_report("four-tp", f"2^{S['clique_nv']}-state clique B={len(evs)}, "
                f"potential sharded (cold compile+run {cold:.2f} s)", devs,
                t1, t4, err, zerr, card)


def phase_four_sp(S, card):
    """Engine.shard_sequence: a chain's step axis over four cards."""
    import numpy as np

    import junctiontree_tpu as jt
    from junctiontree_tpu.evidence import (
        batch_masks_sparse,
        random_evidence_batch,
    )
    from junctiontree_tpu.executor import Engine
    from junctiontree_tpu.models import chain_bn_model
    from junctiontree_tpu.parallel.mesh import make_mesh

    n = S["chain_n"]
    factors, sizes, values = chain_bn_model(n, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    evs = random_evidence_batch(tree.plan, S["chain_b"],
                                [f"x{i}" for i in range(0, n, n // 10)],
                                seed=2)
    masks = batch_masks_sparse(tree.plan, evs)
    one = Engine(tree.plan).set_potentials(values)
    sp = Engine(tree.plan).set_potentials(values).shard_sequence(
        make_mesh(4), min_len=min(2048, n // 2))
    p1, z1 = one.posterior_batch(masks)
    t0 = time.perf_counter()
    p4, z4 = block(sp.posterior_batch(masks))
    cold = time.perf_counter() - t0
    devs = sharded_devices(sp._chain_A)
    assert len(devs) == 4, f"SP transitions live on {devs}"
    t1, t4 = interleaved([lambda: one.posterior_batch(masks)[1],
                          lambda: sp.posterior_batch(masks)[1]], 5, 5)
    V = tree.plan.num_vars
    err, zerr = compare("four-sp", [np.asarray(p1[v]) for v in range(V)],
                        [np.asarray(p4[v]) for v in range(V)], z1, z4)
    four_report("four-sp", f"{n}-variable chain B={len(evs)}, steps "
                f"sharded (cold compile+run {cold:.2f} s)", devs, t1, t4,
                err, zerr, card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card DP/TP/SP paths")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import junctiontree_tpu
        from tests import util as _util  # noqa: F401  (the reference)
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})",
              file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(junctiontree_tpu.__file__))
    if os.path.dirname(pkg) != REPO:
        print(f"chip_smoke: imported the package from {pkg}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)

    import jax

    from junctiontree_tpu.config import enable_compilation_cache

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform}: "
              f"{dev.device_kind})", file=sys.stderr)
        return 1
    cache = enable_compilation_cache()
    cards = card_line()
    card = cards.splitlines()[0]
    say(f"[device] {dev.platform} / {dev.device_kind} x {len(devs)}; "
        f"jax {jax.__version__}; compile cache {cache}")
    for line in cards.splitlines():
        say(f"[device] nvidia-smi: {line}")

    failures = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            out = fn(*a)
            say(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
            return out
        except Exception:
            failures.append(name)
            say(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
            traceback.print_exc(file=sys.stdout)
            return None

    S = SIZES
    if args.four:
        if len(devs) != 4:
            print(f"chip_smoke: --four needs 4 GPUs, JAX found {len(devs)}",
                  file=sys.stderr)
            return 1
        run("four-dp", phase_four_dp, S, card)
        run("four-tp", phase_four_tp, S, card)
        run("four-sp", phase_four_sp, S, card)
    else:
        from junctiontree_tpu.ops.semirings import get_matmul_precision

        assert get_matmul_precision() == "highest"
        run("uai", phase_uai, S, dev, card)
        run("hail", phase_hail, S, dev, card)
        clique = run("clique", phase_clique, S, dev, card)
        if clique is not None:
            run("factored", phase_factored, S, dev, card, clique)

    say(f"[summary] card: {card}")
    if failures:
        say(f"[summary] FAILED phases: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
