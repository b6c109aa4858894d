"""Vector math on trailing-axis-3 arrays.

Array re-expression of the reference's `vec3` class
(reference: src/gpu/vec3.h:10-121, src/cpu/vec3.h:9-140). Instead of a
scalar 3-vector class with operator overloads, every op here is a pure
function on arrays of shape ``[..., 3]`` so the whole renderer is
batched over rays from the start — XLA vectorizes over the leading
axes.

All functions are autodiff-safe: `unit_vector` and `refract` guard the
zero-length / negative-discriminant lanes with the double-`where` trick
so gradients never see a NaN.
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches the reference's near-zero test threshold 1e-8
# (reference: src/gpu/vec3.h:56-60).
_NEAR_ZERO_EPS = 1e-8


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (reference: src/gpu/vec3.h:97-99)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3D cross product (reference: src/gpu/vec3.h:101-105)."""
    return jnp.cross(a, b)


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(v * v, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(v))


def unit_vector(v: jnp.ndarray) -> jnp.ndarray:
    """Normalize over the trailing axis (reference: src/gpu/vec3.h:107-109).

    Grad-safe: a zero vector normalizes to zero instead of NaN, and the
    backward pass of the masked lanes is zero rather than NaN.
    """
    sq = length_squared(v)
    safe = jnp.where(sq > 0.0, sq, 1.0)
    return v * jnp.where(sq > 0.0, 1.0 / jnp.sqrt(safe), 0.0)[..., None]


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """True where all components are ~0 (reference: src/gpu/vec3.h:56-60)."""
    return jnp.all(jnp.abs(v) < _NEAR_ZERO_EPS, axis=-1)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection about unit normal n (reference: src/gpu/vec3.h:111-113)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: jnp.ndarray, n: jnp.ndarray, etai_over_etat: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction via perpendicular/parallel decomposition
    (reference: src/gpu/vec3.h:115-121).

    `uv` must be unit length; `n` the unit normal facing against the ray.
    `etai_over_etat` broadcasts over the batch. Lanes with total internal
    reflection (negative 1-|perp|^2) are clamped; callers select the
    reflect branch for those lanes, so the clamped value is never used.
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    k = 1.0 - length_squared(r_out_perp)
    # Double-where so total-internal-reflection lanes (k <= 0) have zero
    # gradient rather than the NaN of d/dk sqrt(max(k,0)) at k=0.
    refractable = k > 0.0
    sqrt_k = jnp.where(refractable, jnp.sqrt(jnp.where(refractable, k, 1.0)), 0.0)
    r_out_parallel = -sqrt_k[..., None] * n
    return r_out_perp + r_out_parallel


def ray_at(origin: jnp.ndarray, direction: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Point along a ray: origin + t * direction (reference: src/gpu/ray.h:16-18)."""
    return origin + t[..., None] * direction
