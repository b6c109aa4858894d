"""Where the renderer runs, and how: the one place that decides.

* `resolve_backend` maps `--backend auto|jnp|pallas` and the device
  platform to the renderer that runs. `auto` takes the Pallas kernel on
  a GPU, where it measured faster end to end than XLA's compilation of
  the jnp path (CHANGES.md), and the jnp path on the CPU.
* `kernel_interpret` says whether the Pallas kernel runs in the
  interpreter: only when its arrays live on the CPU. On a GPU the kernel
  is compiled through Triton; if that fails, the call raises — nothing
  falls back.
* `enable_compile_cache` points JAX's persistent compilation cache at a
  fixed directory.
"""

from __future__ import annotations

import os
from pathlib import Path

BACKENDS = ("auto", "jnp", "pallas")

# `--platform` choice -> the name `jax_platforms` accepts.
PLATFORM_NAMES = {"cpu": "cpu", "gpu": "cuda"}

_AUTO_BACKEND = {"gpu": "pallas", "cpu": "jnp"}

# Default cache location when JAX_COMPILATION_CACHE_DIR is not set: a
# fixed path inside the checkout (listed in .gitignore).
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def devices_platform(devices=None) -> str:
    """Platform of the devices a render runs on: `devices`, else the
    default device (`jax.default_device` when set, else JAX's first)."""
    import jax

    if devices is not None:
        return list(devices)[0].platform
    default = jax.config.jax_default_device
    if default is None:
        return jax.devices()[0].platform
    if isinstance(default, str):
        return jax.devices(default)[0].platform
    return default.platform


def resolve_backend(requested: str, platform: str) -> str:
    """The renderer for `requested` on `platform` ('jnp' or 'pallas')."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}; one of {BACKENDS}")
    if requested != "auto":
        return requested
    return _AUTO_BACKEND.get(platform, "jnp")


def kernel_interpret(platform: str) -> bool:
    """True when the Pallas kernel must run interpreted (CPU arrays),
    False when it compiles (GPU). Any other platform has no kernel."""
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise ValueError(f"the Pallas kernel has no build for platform {platform!r}")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise the cache lives at CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    None where there is no nvidia-smi. Every GPU number the repository
    records carries this line: a card set below its power limit runs
    slower under load."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else None
