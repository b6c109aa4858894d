"""Test configuration: force an 8-virtual-device CPU platform.

Tests never require an accelerator — the pjit/shard_map/psum paths run
on a fake 8-device CPU mesh (the standard JAX answer to testing
multi-device code in CI, SURVEY.md §4), and the Pallas kernel runs in
interpret mode. `jax.config.update` works here because no backend
client has been created yet at conftest-import time.

JAX_PLATFORMS, when set, replaces the CPU default. Tests that need the
card carry the `gpu` marker and skip without one; on a GPU machine,
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs them. When
JAX_PLATFORMS puts another platform than the CPU first, only the `gpu`
tests are collected: the rest build their meshes from the default
devices and expect eight CPU ones.
"""

import os

import jax
import pytest

_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"

jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)


def pytest_collection_modifyitems(config, items):
    if _PLATFORMS.split(",")[0] == "cpu":
        return
    cpu_only = [item for item in items if item.get_closest_marker("gpu") is None]
    if cpu_only:
        config.hook.pytest_deselected(items=cpu_only)
        items[:] = [item for item in items if item.get_closest_marker("gpu") is not None]


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where there is none. Decided when a test
    runs, never at import, so every worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU")
