"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding tests simulate several accelerators via
``--xla_force_host_platform_device_count`` (SURVEY.md §4: the reference has
no distributed tests; we create them). The suite always runs on the CPU;
the accelerator path is exercised by ``chip_smoke.py`` at the repo root.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
