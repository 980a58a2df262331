"""Worked example: dense models past the treewidth wall, and bf16 serving.

Two escape hatches the reference library has no answer to (its only option
for a dense graph is an exponentially large clique,
/root/reference/junctiontree/construction.py:98-108 min-fill or bust):

  1. Cutset conditioning (exact): condition on a small cutset so the
     reduced model triangulates with small cliques; the cutset's joint
     states become another batch axis in ONE compiled program.  Exact
     posteriors, logZ, and MPE.
  2. bfloat16 storage (config.storage_dtype): halve HBM traffic so
     capacity-bound models (huge separators) serve twice the batch.

Run:  python examples/dense_models.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import junctiontree_tpu as jt
from junctiontree_tpu.config import DEFAULT
from junctiontree_tpu.models import hailfinder_like

factors, sizes, values = hailfinder_like()
names = list(sizes)

# -- 1. the wall: even escalated triangulation leaves multi-M-state cliques
tree = jt.create_junction_tree(factors, sizes)
st = tree.stats()
print(f"monolithic: treewidth {st['treewidth']}, "
      f"largest clique {st['max_clique_states']:,} states, "
      f"largest separator {st['max_sep_states']:,} states")

# -- 2. cutset conditioning: greedy cutset, exact inference on the reduced
#       model; every variable (incl. the cutset) gets a posterior
ce = jt.CutsetEngine(factors, sizes, values, target_states=1 << 14,
                     max_enum=512)
d = ce.describe()
print(f"cutset {d['cutset']} ({d['cutset_states']} joint states) -> "
      f"largest reduced clique {d['max_clique_states']:,} states")

B = 64
rng = np.random.default_rng(0)
masks = {}
for v in names[::7]:
    m = np.zeros((B, sizes[v]), dtype=np.float32)
    m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
    masks[v] = m
posts, logz = ce.posterior_batch(masks)
print(f"exact logZ[0] = {float(logz[0]):.3f}; "
      f"P({names[1]}|e)[0] = {np.asarray(posts[names[1]])[0].round(3)}")

# exact MPE through the same engine
assignment, logp = ce.map_assignment({names[0]: 0})
print(f"exact MPE log p = {logp:.3f} (assignment over {len(assignment)} vars)")

# -- 3. bf16 storage: double the feasible batch on the monolithic engine
eng = tree.engine()
b_f32 = eng.max_feasible_batch()
DEFAULT.storage_dtype = "bfloat16"
b_bf16 = eng.max_feasible_batch()
DEFAULT.storage_dtype = "float32"
print(f"feasible batch under the device's memory budget: f32 {b_f32} -> "
      f"bf16 {b_bf16}")
