"""Worked example: the four UAI query types plus information-theoretic
diagnostics, on one medical-style Bayes net.

PR   (partition function)      -> Engine.query / posterior_batch logZ
MAR  (posterior marginals)     -> Engine.query
MPE  (most probable joint)     -> Engine.map_assignment
MMAP (marginal MAP)            -> MarginalMapSolver: max over a QUERY
                                  subset, summing out the rest — the query
                                  an MPE answer silently gets wrong when
                                  nuisance variables exist
H    (posterior joint entropy) -> Engine.entropy: how much uncertainty is
                                  left after the evidence (active-sensing /
                                  diagnostics signal)

The reference library answers only PR/MAR (sum-product); max-product was
anticipated but never implemented (/root/reference/junctiontree/
sum_product.py:7-8), and MMAP/entropy need machinery it doesn't have.

Run:  python examples/queries_quartet.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import junctiontree_tpu as jt

# A small diagnosis net: disease -> {test_a, test_b}, risk -> disease,
# plus a nuisance co-symptom correlated with test_b.
factors = [
    ["risk"],
    ["risk", "disease"],
    ["disease", "test_a"],
    ["disease", "test_b"],
    ["test_b", "cosymptom"],
]
sizes = {"risk": 2, "disease": 3, "test_a": 2, "test_b": 2, "cosymptom": 2}
rng = np.random.default_rng(0)
values = [
    np.array([0.8, 0.2]),
    np.array([[0.90, 0.07, 0.03], [0.55, 0.25, 0.20]]),
    np.array([[0.95, 0.05], [0.30, 0.70], [0.10, 0.90]]),
    np.array([[0.90, 0.10], [0.40, 0.60], [0.20, 0.80]]),
    np.array([[0.7, 0.3], [0.2, 0.8]]),
]

tree = jt.create_junction_tree(factors, sizes)
eng = tree.engine().set_potentials(values)
evidence = {"test_a": 1, "test_b": 1}

# PR + MAR
margs, p_e = eng.query(evidence)
disease_ix = tree.plan.table.id_of("disease")
print("P(evidence)            :", round(p_e, 5))
print("P(disease | evidence)  :", np.round(margs[disease_ix], 4))

# MPE: jointly most probable COMPLETE assignment
mpe, logp = eng.map_assignment(evidence)
print("MPE (all vars)         :", {k: v for k, v in sorted(mpe.items())})

# MMAP: most probable (risk, disease) after SUMMING OUT the nuisance
# cosymptom — can disagree with just projecting the MPE
solver = jt.MarginalMapSolver(factors, sizes, ["risk", "disease"])
solver.set_potentials(values)
mmap, score = solver.query(evidence)
print("MMAP (risk, disease)   :", mmap,
      " log-value", round(score, 4),
      " (constrained width %d)" % solver.constrained_width)
proj = {k: mpe[k] for k in ("risk", "disease")}
if proj != mmap:
    print("  note: projecting the MPE gives", proj, "— the classic trap")

# Entropy: residual uncertainty after evidence (nats)
h0, _ = eng.entropy()
h1, _ = eng.entropy(evidence)
print("H(joint) prior/posterior: %.4f -> %.4f nats" % (h0, h1))

# Batched MMAP serving: every evidence row through ONE compiled program
NEG = -1e30
m = np.zeros((3, 2), dtype=np.float32)
m[0] = [0.0, NEG]   # test_a = 0
m[1] = [NEG, 0.0]   # test_a = 1
m[2] = [0.0, 0.0]   # unobserved
assigns, scores = solver.query_batch({"test_a": m})
print("batched MMAP assigns   :", np.asarray(assigns).tolist(),
      " scores", np.round(np.asarray(scores), 4).tolist())
