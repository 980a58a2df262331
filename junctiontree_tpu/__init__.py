"""junctiontree_tpu — compiled exact inference on discrete factor graphs.

Brand-new JAX/XLA implementation with the capabilities of jluttine/junction-tree
(reference mounted read-only at /root/reference): factor-graph DSL, min-fill
triangulation, Jensen junction-tree construction, two-pass sum-product belief
propagation, evidence conditioning, and per-factor posterior marginals —
re-designed for accelerators (static-schedule compiled propagation, mask-based
evidence, vmap-batched queries, mesh-sharded batches, pluggable semirings).

Quick start (same shape as the reference README):

    import junctiontree_tpu as jt
    import numpy as np

    tree = jt.create_junction_tree([["a", "b"], ["b", "c"]], {"a": 2, "b": 3, "c": 4})
    marginals = tree.propagate([np.random.rand(2, 3), np.random.rand(3, 4)])

Fast compiled path:

    eng = tree.engine().set_potentials(values)
    marg, p_evidence = eng.query({"b": 1})
"""

from .api import CliqueGraph, FactorGraph, JunctionTree, create_junction_tree
from .approx import LoopyEngine
from .cutset import CutsetEngine, choose_cutset
from .evidence import apply_evidence, batch_masks, shrink_sizes
from .structure import chow_liu
from .executor import Engine, evidence_to_masks
from .incremental import IncrementalSession
from .joint import mutual_information_from_joint, steiner_subtree
from .mmap import MarginalMapSolver, marginal_map
from .ops.semirings import LOG_SUM_EXP, MAX_PRODUCT, SEMIRINGS, SUM_PRODUCT
from .schedule import Plan, compile_plan
from .surgery import (
    add_factor,
    change_root,
    insert_sepset,
    merge_plans,
    merge_trees,
    remove_factor,
)

__version__ = "0.5.0"

__all__ = [
    "create_junction_tree",
    "FactorGraph",
    "CliqueGraph",
    "JunctionTree",
    "Engine",
    "IncrementalSession",
    "LoopyEngine",
    "CutsetEngine",
    "choose_cutset",
    "chow_liu",
    "Plan",
    "compile_plan",
    "add_factor",
    "remove_factor",
    "merge_plans",
    "merge_trees",
    "change_root",
    "insert_sepset",
    "MarginalMapSolver",
    "marginal_map",
    "mutual_information_from_joint",
    "steiner_subtree",
    "apply_evidence",
    "shrink_sizes",
    "batch_masks",
    "evidence_to_masks",
    "SUM_PRODUCT",
    "LOG_SUM_EXP",
    "MAX_PRODUCT",
    "SEMIRINGS",
    "__version__",
]
