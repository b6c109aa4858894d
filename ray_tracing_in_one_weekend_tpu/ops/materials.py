"""Branchless material scattering.

The reference dispatches `material::scatter` virtually per ray
(reference: src/gpu/material.h:10-104). Virtual dispatch has no array
form; instead all three material responses are computed for every lane
and the winner is selected by `jnp.where` on the integer
`mat_type`. With only three cheap materials this costs less than the
divergence it avoids, and it keeps every shape static.

Semantics (matching the GPU tree, which is the book's v4 semantics):

* lambertian — scatter direction = normal + random unit vector, with the
  degenerate near-zero direction falling back to the normal; attenuation
  = albedo; always scatters (reference: src/gpu/material.h:20-40).
* metal — reflect(unit(in), normal) + fuzz * random unit vector
  (reference: src/gpu/material.h:42-64; note the CPU tree perturbs with
  `random_in_unit_sphere` instead (reference: src/cpu/material.h:43) — a
  book v3-vs-v4 difference; we follow the GPU/v4 form and document it
  here). Absorbed (scatter fails) when the fuzzed direction points into
  the surface.
* dielectric — attenuation 1; refraction ratio 1/ior entering, ior
  exiting; total internal reflection when ratio*sin(theta) > 1; Schlick
  reflectance vs. a fresh uniform decides reflect-vs-refract
  (reference: src/gpu/material.h:66-104).

Gradients flow through the continuous quantities (normals, albedo, fuzz,
ior via refraction direction and Schlick); the discrete branch decisions
are boolean comparisons and contribute no gradient, matching the
Monte-Carlo-discrete semantics of the reference (SURVEY.md §7 step 5).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ray_tracing_in_one_weekend_tpu.models.scene import DIELECTRIC, LAMBERTIAN, METAL
from ray_tracing_in_one_weekend_tpu.ops import sampling
from ray_tracing_in_one_weekend_tpu.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu.ops.intersect import HitRecord


def schlick_reflectance(cosine: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """Schlick's approximation r0 + (1-r0)(1-cos)^5
    (reference: src/gpu/material.h:98-103)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(
    rec: HitRecord,
    in_direction: jnp.ndarray,
    keys: jax.Array,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Scatter with randomness drawn from per-ray keys (convenience /
    test entry; the integrator pre-draws in bulk and calls
    `scatter_sampled` directly)."""
    unit_sample = sampling.unit_vector_b(sampling.fold_b(keys, 0))  # [R, 3]
    reflect_u = sampling.uniform_b(sampling.fold_b(keys, 1))  # [R]
    return scatter_sampled(rec, in_direction, unit_sample, reflect_u)


def scatter_sampled(
    rec: HitRecord,
    in_direction: jnp.ndarray,
    unit_sample: jnp.ndarray,
    reflect_u: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Scatter every ray against its hit material.

    Args:
      rec: batched hit record (material params pre-gathered).
      in_direction: incident ray directions [R, 3] (not necessarily unit).
      unit_sample: [R, 3] uniform unit vectors (the one shared random
        direction: lambertian offset AND metal fuzz perturbation, as in
        the reference where each material draws its own
        `random_unit_vector`, reference: src/gpu/material.h:29,52).
      reflect_u: [R] uniforms for the dielectric reflect/refract choice.

    Returns:
      (scattered_direction [R, 3], attenuation [R, 3], scattered_ok [R]).
      `scattered_ok` is False only for absorbed metal rays
      (reference: src/gpu/material.h:58).
    """
    unit_in = vm.unit_vector(in_direction)
    normal = rec.normal

    # --- lambertian (reference: src/gpu/material.h:24-36) -------------------
    lam_dir = normal + unit_sample
    lam_dir = jnp.where(vm.near_zero(lam_dir)[:, None], normal, lam_dir)

    # --- metal (reference: src/gpu/material.h:47-59) ------------------------
    reflected = vm.reflect(unit_in, normal)
    metal_dir = reflected + rec.fuzz[:, None] * unit_sample
    metal_ok = vm.dot(metal_dir, normal) > 0.0

    # --- dielectric (reference: src/gpu/material.h:70-93) -------------------
    ratio = jnp.where(rec.front_face, 1.0 / rec.ior, rec.ior)
    cos_theta = jnp.minimum(vm.dot(-unit_in, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 1e-12))
    cannot_refract = ratio * sin_theta > 1.0
    must_reflect = cannot_refract | (schlick_reflectance(cos_theta, ratio) > reflect_u)
    refracted = vm.refract(unit_in, normal, ratio)
    diel_dir = jnp.where(must_reflect[:, None], reflected, refracted)

    # --- masked select on mat_type ------------------------------------------
    is_lam = rec.mat_type == LAMBERTIAN
    is_metal = rec.mat_type == METAL

    direction = jnp.where(
        is_lam[:, None], lam_dir, jnp.where(is_metal[:, None], metal_dir, diel_dir)
    )
    white = jnp.ones_like(rec.albedo)
    attenuation = jnp.where(
        (rec.mat_type == DIELECTRIC)[:, None], white, rec.albedo
    )
    scattered_ok = jnp.where(is_metal, metal_ok, True)

    return direction, attenuation, scattered_ok
