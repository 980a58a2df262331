"""Test harness configuration.

Tests run on CPU with 8 virtual devices (SURVEY.md §4 multi-node gap: mesh
tests without accelerator hardware use
--xla_force_host_platform_device_count).  Env must be set before jax
initializes, hence at conftest import time.  ``JAX_PLATFORMS`` defaults to
cpu; the card-only tests (marker ``gpu``) run with ``JAX_PLATFORMS=cuda``."""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# float64 on the CPU test platform: parity tests compare against the float64
# NumPy reference at 1e-6; the GPU serving path stays float32/bfloat16.
jax.config.update("jax_enable_x64", True)
