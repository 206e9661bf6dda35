"""Test configuration: force an 8-virtual-device CPU platform.

Multi-device correctness is tested the way the reference never could
(SURVEY §4): a single-host mesh of 8 emulated devices via
``xla_force_host_platform_device_count``, so sims-axis sharding and its
collectives compile+execute without an accelerator.  The platform is
also forced through ``jax.config`` in case JAX was imported before the
environment variable was set.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
