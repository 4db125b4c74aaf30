"""Test environment: the CPU backend with 8 virtual devices, so the
multi-device sharding paths compile and execute without accelerators.

The platform is pinned through jax.config as well as the environment so
that it holds even if a plugin registered another default platform at
interpreter start-up.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8

# Machine-fingerprinted CPU cache dir: XLA:CPU AOT entries are not
# portable across hosts (see utils/cache.py).
from disinfect_slam.utils import cache  # noqa: E402

cache.enable(platform_name="cpu")
