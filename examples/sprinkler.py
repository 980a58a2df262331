"""Worked example: the sprinkler Bayes net, end to end.

Mirrors the reference README walkthrough (/root/reference/README.md:85-178)
on the compiled engine: build, propagate, condition on evidence, MAP.

Run:  python examples/sprinkler.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import junctiontree_tpu as jt
from junctiontree_tpu.models import sprinkler_model


def main():
    factors, sizes, values = sprinkler_model()
    tree = jt.create_junction_tree(factors, sizes)
    print("maxcliques:", tree.maxcliques)
    print("separators:", tree.separators)
    print("tree:", tree.tree)
    print("compile stats:", tree.stats())

    # reference-style propagation: unnormalized factor marginals
    marginals = tree.propagate(values)
    p_sprinkler = marginals[1].sum(axis=0) / marginals[1].sum()
    print("P(sprinkler) =", p_sprinkler)  # [0.7, 0.3]

    # fast path: posterior under evidence
    eng = tree.engine().set_potentials(values)
    post, p_wet = eng.query({"wet_grass": 1})
    rain = tree.plan.table.id_of("rain")
    print("P(wet_grass=T) = %.4f" % p_wet)
    print("P(rain|wet_grass=T) = %.4f" % post[rain][1])  # 0.7079

    # MAP: most probable explanation of wet grass
    assign, logp = eng.map_assignment({"wet_grass": 1})
    print("MAP given wet grass:", assign, " log p =", round(logp, 4))


if __name__ == "__main__":
    main()
