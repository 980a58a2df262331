"""Framework configuration.

The reference has no config system — its only knobs are a hardcoded
distributive law (junctiontree.py:305) and einsum backend (computation.py:9).
Here configuration is an explicit dataclass (SURVEY.md §5 config row):
semiring, dtype, matmul precision, elimination heuristic, mesh axes, and
the routing thresholds."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # numeric
    semiring: str = "sum_product"          # sum_product | log_sum_exp | max_product
    matmul_precision: str = "highest"      # highest (full f32) | high | default

    # Storage dtype for the batched serving path (potentials, masks and
    # rescaled messages as they sit in device memory): "float32" (exact
    # default) or "bfloat16".  bfloat16 halves memory traffic — the binding
    # constraint on capacity-bound models (hailfinder-class: [B,
    # 3.1M-state-sep] messages bound the feasible batch) — while
    # contractions still ACCUMULATE in float32 (preferred_element_type).
    # Posterior error is
    # ~1e-2 relative (bf16 has ~3 significant digits); linear sum_product
    # rescaled programs only — the parity paths (propagate/query) stay f32.
    storage_dtype: str = "float32"

    # compile
    heuristic: str = "auto"                # auto (min_fill + escalation) |
    #                                        min_fill | min_degree |
    #                                        min_weight | portfolio[N] | anneal[S]
    backend: str = "auto"                  # auto | python | native (C++ compiler)
    root: Optional[int] = None             # clique to root the tree at

    # 'auto' heuristic: when greedy min-fill lands a clique above this many
    # states, escalate to a 16-restart randomized portfolio and keep the
    # better triangulation (one-time compile cost, often orders of
    # magnitude smaller cliques on hailfinder-class models)
    escalate_min_states: int = 1 << 20

    # distribute-pass Hugin division trick (ops/grouped.py
    # grouped_divide_project): derive each child's down-message from the
    # clique belief by guarded division instead of leave-one-out products —
    # fewer combines, and the belief is reused for the marginal phase.
    # Applied only for invertible semirings (sum/logsumexp) on cliques small
    # enough that their belief is materialized anyway.
    # Default OFF; whether it pays on the GPU (step time against cold
    # compile on mixed-cardinality models) is not measured yet.
    distribute_division: bool = False

    # grouped-unrolled contraction path (ops/grouped.py): operand
    # state-space size above which batched message contractions are
    # rewritten as low-rank broadcast-multiply-accumulate ops (high-rank
    # einsums compile slowly; see ops/grouped.py), and the max number of
    # unrolled cross-operand contracted assignments
    grouped_min_states: int = 1 << 10
    grouped_unroll_cap: int = 64

    # tensor parallelism: clique state-space size above which an Engine with
    # a model mesh (Engine.shard_model) serves the clique sharded over the
    # model axis (shard_map + psum) instead of on one card
    tp_min_states: int = 1 << 26

    # persistent XLA compilation cache directory (enable_compilation_cache;
    # JAX_COMPILATION_CACHE_DIR, where set, takes precedence).  Large
    # irregular models can take minutes of XLA compile; with the cache on,
    # that cost is paid once per (model, batch shape) per machine —
    # subsequent processes deserialize the compiled executable.
    compilation_cache_dir: Optional[str] = None

    # Parallel cold start for the batched posterior program
    # (executor._ColdStartServing): on a compile-cache miss the program is
    # split into cold_start_segments chunk programs whose XLA compiles run
    # CONCURRENTLY, serving begins on the chunked form, and the monolithic
    # program compiles in a background thread and is swapped in for
    # steady-state serving.
    #
    # Default OFF: on models with huge separators the chunk boundaries
    # carry GB-sized tensors, and the persistent XLA compile cache is the
    # production mitigation for cold starts.  Its GPU cost and gain are not
    # measured.  Gates: largest clique >= cold_start_min_states AND largest
    # separator <= cold_start_max_sep.
    parallel_cold_start: bool = False
    cold_start_segments: int = 6
    cold_start_min_states: int = 1 << 17
    cold_start_max_sep: int = 1 << 16

    # Donate the per-call evidence-mask buffers to the batched posterior
    # program (jit donate_argnums), letting XLA reuse them as scratch
    # during the step.  Caller-provided DEVICE arrays are defensively
    # copied first so donation can never invalidate a buffer the caller
    # still holds (Engine._masks_to_program_args); numpy inputs already
    # transfer to a fresh engine-owned buffer.  Mask buffers are small
    # (sum_v B x size_v), so this is hygiene rather than a capacity lever —
    # measured peak on capacity-bound models is set by XLA temp buffers
    # (Engine.memory_analysis), not arguments.
    donate_serving_masks: bool = True

    def apply(self) -> "Config":
        """Push process-wide knobs (matmul precision, compile cache) into
        effect."""
        from .ops.semirings import set_matmul_precision

        set_matmul_precision(self.matmul_precision)
        if self.compilation_cache_dir is not None:
            enable_compilation_cache(self.compilation_cache_dir)
        return self

    # one-stop constructors honoring every knob
    def compile(self, factors, sizes):
        """compile_plan with this config's heuristic/backend/root."""
        from .schedule import compile_plan

        self.apply()
        return compile_plan(
            factors, sizes,
            root=self.root, backend=self.backend, heuristic=self.heuristic,
        )

    def engine(self, factors, sizes, values=None):
        """Plan + Engine (with this config's semiring); values optional."""
        from .executor import Engine
        from .ops.semirings import SEMIRINGS

        eng = Engine(self.compile(factors, sizes), SEMIRINGS[self.semiring])
        if values is not None:
            eng.set_potentials(values)
        return eng


# the one cache directory this package uses when JAX_COMPILATION_CACHE_DIR
# is not set: inside the checkout, listed in .gitignore
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Compiled XLA executables are written to disk keyed by (program, shapes,
    compiler version); re-running the same model skips XLA compilation
    entirely.  This is the production answer to the reference's per-process
    recompile cost (the reference has no compiled artifact at all — its
    "compile" is the in-memory tree, /root/reference/junctiontree/
    junctiontree.py:277-294); here both the host plan (Plan.to_json) and the
    device executable persist.

    Where the environment sets ``JAX_COMPILATION_CACHE_DIR``, JAX already
    uses that directory and no other is set here (``path`` is ignored).
    Otherwise the cache lives at ``path``, by default
    ``CHECKOUT_CACHE_DIR``."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = path or CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache even fast compiles: the win is cross-process determinism, and
    # entries are cheap relative to model potentials
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


DEFAULT = Config()
