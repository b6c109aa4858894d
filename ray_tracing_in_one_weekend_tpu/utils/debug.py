"""Numerical-health guards.

The reference's only runtime checking is the fail-stop
`checkCudaErrors` macro (reference: src/gpu/cuda_utility.h:8-18) and it
has no NaN detection at all. The equivalents here (SURVEY.md §5
"race detection / sanitizers"):

* data races are removed by construction (stateless counter-based RNG,
  pure functional framebuffer), and
* numerical faults are caught by `checkify`-based guards here, usable in
  tests and debugging runs without slowing the production path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ray_tracing_in_one_weekend_tpu.models.camera import Camera
from ray_tracing_in_one_weekend_tpu.models.scene import Scene


def checked_render(scene: Scene, cam: Camera, base_key, chunk_size: int = 4096):
    """Render with float-fault checking: returns (error, image).

    `error.throw()` raises if any NaN/Inf was produced anywhere inside
    the render (jit-compatible via checkify's error lifting). This is
    the debugging entry — the production paths stay guard-free.
    """
    from ray_tracing_in_one_weekend_tpu.ops.render import render

    if isinstance(base_key, int):
        base_key = jax.random.key(base_key)

    def f(scene, key):
        img = render(scene, cam, key, chunk_size=chunk_size, differentiable=True)
        checkify.check(
            jnp.all(jnp.isfinite(img)), "non-finite radiance in framebuffer"
        )
        return img

    checked = checkify.checkify(f, errors=checkify.float_checks)
    return jax.jit(checked)(scene, base_key)


def assert_finite_tree(tree, name: str = "pytree") -> None:
    """Host-side finiteness assert over any pytree (test helper)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            if not bool(jnp.all(jnp.isfinite(leaf))):
                raise AssertionError(f"non-finite values in {name}{path}")
