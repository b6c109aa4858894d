"""Stateless, counter-based random sampling.

The reference uses stateful RNG: a shared `std::mt19937` on CPU
(reference: src/cpu/rtweekend.h:27-36 — racy when shared across threads,
src/cpu-multi-threading/rtweekend.h:27-31) and per-pixel curand streams on
GPU seeded as `curand_init(seed, pixel_index, 0)`
(reference: src/gpu/camera.h:186-187).

This design replaces both with counter-based threefry keys:
``key = fold_in(fold_in(base_key, global_pixel_index), sample_index)`` and
per-bounce/per-use subkeys derived with further `fold_in` calls. This is

* stateless → no RNG state arrays, no data races, trivially shardable;
* reproducible across any shard layout, because keys derive from GLOBAL
  pixel/sample indices, never from shard-local ones (SURVEY.md §7 hard
  part (d));
* static-shaped: the reference's rejection loops
  (`random_in_unit_sphere` reference: src/gpu/rtweekend.h:42-49,
  `random_in_unit_disk` reference: src/gpu/rtweekend.h:61-69) are replaced
  by closed-form samplers with identical distributions (documented below),
  which keeps every shape static under `jit`.

Distributional equivalence notes:
* `random_unit_vector` — reference draws uniform in the unit ball and
  normalizes; normalizing an isotropic Gaussian gives the same uniform
  distribution on the sphere (both are rotation-invariant).
* `random_in_unit_disk` — reference rejection-samples the disk; polar
  inversion r=sqrt(U1), theta=2*pi*U2 is the exact same uniform disk law.
* `random_in_unit_sphere` — uniform direction scaled by U^(1/3) radius is
  the exact uniform-ball law.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pixel_sample_key(base_key: jax.Array, pixel_index: jnp.ndarray, sample_index) -> jax.Array:
    """Per-(pixel, sample) key — the analogue of the reference's
    `curand_init(seed, pixel_index, 0)` stream + sequential draws
    (reference: src/gpu/camera.h:186-191)."""
    return jax.random.fold_in(jax.random.fold_in(base_key, pixel_index), sample_index)


def uniform(key: jax.Array, shape=()) -> jnp.ndarray:
    """U[0,1) floats — the reference's `random_float`
    (reference: src/gpu/rtweekend.h:20-29, incl. the (0,1] → [0,1) flip)."""
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def random_unit_vector(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform direction on S^2 (reference: src/gpu/rtweekend.h:51-53).

    Gaussian-normalize replaces the reference's rejection sampler; same
    distribution, static shapes. Guarded against the measure-zero all-zero
    draw.
    """
    g = jax.random.normal(key, (*shape, 3), dtype=jnp.float32)
    sq = jnp.sum(g * g, axis=-1, keepdims=True)
    return g * jax.lax.rsqrt(jnp.maximum(sq, 1e-12))


def random_in_unit_sphere(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform in the unit ball (reference: src/gpu/rtweekend.h:42-49)."""
    k_dir, k_r = jax.random.split(key)
    direction = random_unit_vector(k_dir, shape)
    radius = jax.random.uniform(k_r, (*shape, 1), dtype=jnp.float32) ** (1.0 / 3.0)
    return direction * radius


def random_on_hemisphere(key: jax.Array, normal: jnp.ndarray) -> jnp.ndarray:
    """Uniform on the hemisphere around `normal`
    (reference: src/gpu/rtweekend.h:55-59 — defined but unused in the final
    renderer; kept for capability parity)."""
    v = random_unit_vector(key, normal.shape[:-1])
    same_side = jnp.sum(v * normal, axis=-1, keepdims=True) > 0.0
    return jnp.where(same_side, v, -v)


def random_in_unit_disk(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform in the unit disk, z=0 (reference: src/gpu/rtweekend.h:61-69).

    Polar inversion replaces the rejection loop; identical law.
    """
    k_r, k_t = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k_r, shape, dtype=jnp.float32))
    theta = 2.0 * jnp.pi * jax.random.uniform(k_t, shape, dtype=jnp.float32)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1)


def random_vec3(key: jax.Array, lo: float = 0.0, hi: float = 1.0, shape=()) -> jnp.ndarray:
    """Component-wise uniform vec3 in [lo, hi) (reference: src/gpu/vec3.h random_vec3
    used by the scene generator, src/gpu/main.cu:47-51)."""
    return jax.random.uniform(key, (*shape, 3), dtype=jnp.float32, minval=lo, maxval=hi)


# ---------------------------------------------------------------------------
# Per-ray key-array variants.
#
# The renderer carries one key PER RAY (shape [R]) so that every random
# draw is a pure function of (base seed, global pixel index, sample index,
# bounce, use), independent of how rays are chunked or sharded across
# devices. These vmapped wrappers draw per-lane from a key array.
# ---------------------------------------------------------------------------


def fold_b(keys: jax.Array, data) -> jax.Array:
    """fold_in over a key array; `data` is a scalar or per-lane array."""
    if jnp.ndim(data) == 0:
        return jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)
    return jax.vmap(jax.random.fold_in)(keys, data)


def uniform_b(keys: jax.Array) -> jnp.ndarray:
    """One U[0,1) per key: [R] keys -> [R] floats."""
    return jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(keys)


def uniform2_b(keys: jax.Array) -> jnp.ndarray:
    """Two U[0,1) per key: [R] keys -> [R, 2]."""
    return jax.vmap(lambda k: jax.random.uniform(k, (2,), dtype=jnp.float32))(keys)


def unit_vector_b(keys: jax.Array) -> jnp.ndarray:
    """One uniform S^2 direction per key: [R] keys -> [R, 3]."""
    return jax.vmap(random_unit_vector)(keys)


def in_unit_disk_b(keys: jax.Array) -> jnp.ndarray:
    """One uniform unit-disk point per key: [R] keys -> [R, 3] (z = 0)."""
    return jax.vmap(random_in_unit_disk)(keys)


def uniforms_b(keys: jax.Array, n: int, domain: int = 0) -> jnp.ndarray:
    """n U[0,1) per key in one batched counter-mode sweep:
    [R] keys -> [R, n]. `domain` separates draw sites sharing a key
    (camera rays vs bounce draws)."""
    return jax.vmap(
        lambda k: jax.random.uniform(
            jax.random.fold_in(k, domain), (n,), dtype=jnp.float32
        )
    )(keys)


def unit_vector_from_uniforms(u4: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] uniforms -> [..., 3] uniform directions on S^2 via
    Box-Muller Gaussians + normalize (same construction as the Pallas
    kernel, distributionally equal to `random_unit_vector`)."""
    u0 = jnp.maximum(u4[..., 0], 1e-12)
    u2 = jnp.maximum(u4[..., 2], 1e-12)
    r1 = jnp.sqrt(-2.0 * jnp.log(u0))
    r2 = jnp.sqrt(-2.0 * jnp.log(u2))
    t1 = (2.0 * jnp.pi) * u4[..., 1]
    t2 = (2.0 * jnp.pi) * u4[..., 3]
    g = jnp.stack(
        [r1 * jnp.cos(t1), r1 * jnp.sin(t1), r2 * jnp.cos(t2)], axis=-1
    )
    sq = jnp.sum(g * g, axis=-1, keepdims=True)
    return g * jax.lax.rsqrt(jnp.maximum(sq, 1e-12))
