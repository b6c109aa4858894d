"""Iterative path-tracing integrator.

The reference's CPU integrator is recursive (reference: src/cpu/main.cc:12-30);
its GPU integrator is the iterative rewrite carrying a running
attenuation product through a fixed-depth loop
(reference: src/gpu/camera.h:112-138). The iterative form is exactly the
array-friendly formulation: here it becomes a `lax.fori_loop` over bounce
depth, batched over ALL rays at once, carrying

    (origin, direction, attenuation, radiance, alive, keys)

with an `alive` mask instead of per-thread early exit (SURVEY.md §7 hard
part (b): CUDA tolerates divergence via early return; a batched array
program carries a done-mask and eats the wasted lanes).

Per-iteration semantics (matching reference: src/gpu/camera.h:117-137):
* miss         -> radiance += attenuation * sky_gradient, ray retires
* hit, absorbed-> radiance += 0 (black), ray retires
* hit, scatter -> attenuation *= material attenuation, ray continues
* loop ends with rays still alive -> they contribute black
  (depth exhaustion, reference: src/gpu/camera.h:136-137)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracing_in_one_weekend_tpu.models.scene import Scene
from ray_tracing_in_one_weekend_tpu.ops import sampling
from ray_tracing_in_one_weekend_tpu.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu.ops.intersect import hit_scene
from ray_tracing_in_one_weekend_tpu.ops.materials import scatter_sampled

# Sky gradient endpoints (reference: src/gpu/camera.h:120-122).
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction: jnp.ndarray) -> jnp.ndarray:
    """Background gradient: lerp(white, blue, 0.5*(unit_dir.y + 1))
    (reference: src/gpu/camera.h:119-123)."""
    unit_dir = vm.unit_vector(direction)
    a = 0.5 * (unit_dir[..., 1] + 1.0)
    white = jnp.asarray(SKY_WHITE, direction.dtype)
    blue = jnp.asarray(SKY_BLUE, direction.dtype)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


def trace_rays(
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    keys: jax.Array,
    max_depth: int,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Trace a flat batch of rays to radiance.

    Args:
      scene: SoA scene.
      origin, direction: [R, 3] camera rays.
      keys: [R] per-ray keys (already folded with pixel & sample indices).
      max_depth: static bounce limit (reference default 50,
        reference: src/gpu/camera.h:58).
      differentiable: when True, run a fixed-trip-count `fori_loop`
        (reverse-differentiable). When False, run a `while_loop` that
        exits as soon as EVERY ray in the batch has retired — the batched
        analogue of the CUDA per-thread early return
        (reference: src/gpu/camera.h:124-130); most rays escape to the
        sky in a few bounces, so this skips the long tail of the
        depth-50 budget.

    Returns radiance [R, 3].
    """
    n_rays = origin.shape[0]
    radiance = jnp.zeros((n_rays, 3), origin.dtype)
    attenuation = jnp.ones((n_rays, 3), origin.dtype)
    alive = jnp.ones((n_rays,), bool)

    def bounce(i, carry):
        o, d, atten, rad, live = carry

        rec = hit_scene(scene, o, d)

        # Retiring-on-miss: add the sky, weighted by the running
        # attenuation (reference: src/gpu/camera.h:118-124).
        miss = live & ~rec.hit
        rad = rad + jnp.where(miss[:, None], atten * sky_color(d), 0.0)

        # One batched counter-mode sweep per bounce: 5 uniforms per ray
        # (4 -> Box-Muller unit vector, 1 -> dielectric reflect choice).
        # Drawing per bounce (not the whole depth-50 budget up front)
        # means the early-exit loop only pays for bounces that happen.
        u = sampling.uniforms_b(keys, 5, domain=i)  # [R, 5]
        unit_sample = sampling.unit_vector_from_uniforms(u[:, 0:4])
        reflect_u = u[:, 4]
        new_dir, mat_atten, scat_ok = scatter_sampled(rec, d, unit_sample, reflect_u)

        cont = live & rec.hit & scat_ok  # continues bouncing
        atten = jnp.where(cont[:, None], atten * mat_atten, atten)
        o = jnp.where(cont[:, None], rec.point, o)
        d = jnp.where(cont[:, None], new_dir, d)

        return o, d, atten, rad, cont

    init = (origin, direction, attenuation, radiance, alive)
    if differentiable:
        _, _, _, radiance, _ = jax.lax.fori_loop(0, max_depth, bounce, init)
    else:
        def cond(state):
            i, carry = state
            return (i < max_depth) & jnp.any(carry[4])

        def body(state):
            i, carry = state
            return i + 1, bounce(i, carry)

        _, (_, _, _, radiance, _) = jax.lax.while_loop(cond, body, (0, init))
    return radiance


def ray_color(
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    keys: jax.Array,
    max_depth: int = 50,
) -> jnp.ndarray:
    """Single-name convenience alias mirroring the reference's `ray_color`
    (reference: src/gpu/camera.h:112-138)."""
    return trace_rays(scene, origin, direction, keys, max_depth)
