"""Test configuration: force the CPU backend with 8 virtual devices.

Unit tests run without an accelerator; sharded code paths are validated
on a virtual 8-device CPU mesh. The platform is also set through
jax.config before any computation runs, in case the environment pins
another one.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# DISABLE the persistent compilation cache for CPU test runs: XLA:CPU
# executables serialize with machine features (+prefer-no-scatter etc.)
# that the deserializer's host-feature check does not report, and
# reloading such an entry SEGFAULTS inside
# jax.compilation_cache.get_executable_and_time — even write-then-read
# within one process.
jax.config.update("jax_enable_compilation_cache", False)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (multi-minute scale validation)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute scale validation (use --runslow)"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    import pytest

    skip = pytest.mark.skip(reason="slow scale test: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
