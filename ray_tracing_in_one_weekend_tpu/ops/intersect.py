"""Batched closest-hit ray-sphere intersection.

The reference finds the closest hit with a sequential scan over objects
behind virtual `hittable::hit` calls, shrinking `closest_so_far`
(reference: src/gpu/hittable_list.h:49-65) and solving the half-b
quadratic per sphere (reference: src/gpu/sphere.h:15-44). Sequential
scans and virtual dispatch have no batched-array form, so this path
evaluates ALL rays against ALL spheres at once as a static `[R, N]`
computation and takes a masked argmin over the sphere axis. (The Pallas
kernel, ops/pallas_render.py, runs the reference's sequential scan per
lane instead.)

The quadratic terms are arranged so the cross terms become two
`[R, 3] @ [3, N]` matmuls (`o . C` and `d . C`) that XLA fuses with the
surrounding elementwise work, instead of materializing the naive
`[R, N, 3]` origin-minus-center tensor, which would triple device-memory
traffic on the hottest op of this path:

    oc        = o - C                      (never materialized)
    a         = |d|^2
    half_b    = oc . d   = o.d - d.C
    c         = |oc|^2 - r^2 = |o|^2 - 2 o.C + (|C|^2 - r^2)
    disc      = half_b^2 - a*c

Root selection matches the reference exactly: nearest root in the open
interval (t_min, t_max) (strict `interval.surrounds`,
reference: src/gpu/interval.h:6-28, src/gpu/sphere.h:28-38), with the
shadow-acne epsilon t_min = 1e-3 applied by the integrator
(reference: src/gpu/camera.h:118, src/cpu/main.cc:19).

Everything is autodiff-safe: gradients flow from the selected hit's
`t`, `point` and `normal` back to that sphere's center and radius; the
discarded lanes are double-`where` masked so they contribute zeros, not
NaNs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracing_in_one_weekend_tpu.models.scene import Scene
from ray_tracing_in_one_weekend_tpu.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu.utils.pytree import pytree_dataclass

# Sentinel "no hit" distance. Large but finite so that min/argmin and the
# downstream arithmetic never produce inf - inf = NaN.
T_MISS = 1e30

# Shadow-acne epsilon (reference: src/gpu/camera.h:118).
T_MIN_EPS = 1e-3


@pytree_dataclass
class HitRecord:
    """Array-of-rays hit record (reference: src/gpu/hittable.h:10-27),
    with the hit sphere's material parameters pre-gathered (the SoA
    replacement for the reference's `material*` pointer)."""

    hit: jnp.ndarray  # [R] bool
    t: jnp.ndarray  # [R]
    point: jnp.ndarray  # [R, 3]
    normal: jnp.ndarray  # [R, 3] — always faces against the incident ray
    front_face: jnp.ndarray  # [R] bool
    sphere_index: jnp.ndarray  # [R] int32
    albedo: jnp.ndarray  # [R, 3]
    fuzz: jnp.ndarray  # [R]
    ior: jnp.ndarray  # [R]
    mat_type: jnp.ndarray  # [R] int32


def sphere_hit_ts(
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_min: float = T_MIN_EPS,
    t_max: float = T_MISS,
) -> jnp.ndarray:
    """Nearest in-range root for every (ray, sphere) pair.

    Returns t of shape [R, N]; misses (no real root in range, or inactive
    slot) are T_MISS.
    """
    centers = scene.center  # [N, 3]
    radius = scene.radius  # [N]

    a = vm.length_squared(direction)[:, None]  # [R, 1]
    o_dot_d = vm.dot(origin, direction)[:, None]  # [R, 1]
    o_sq = vm.length_squared(origin)[:, None]  # [R, 1]
    c_sq_minus_r_sq = (vm.length_squared(centers) - radius * radius)[None, :]  # [1, N]

    # The two matmul cross terms. Precision matters: a GPU f32 matmul may
    # run in TF32 by default, whose 10-bit mantissa perturbs root
    # positions by ~1e-2 — far beyond the 1e-3 shadow-acne epsilon — and
    # visibly darkens the render with spurious self-hits. HIGHEST forces
    # full f32 products.
    d_dot_c = jnp.matmul(
        direction, centers.T, precision=jax.lax.Precision.HIGHEST
    )  # [R, N]
    o_dot_c = jnp.matmul(
        origin, centers.T, precision=jax.lax.Precision.HIGHEST
    )  # [R, N]

    half_b = o_dot_d - d_dot_c  # [R, N]
    c = o_sq - 2.0 * o_dot_c + c_sq_minus_r_sq  # [R, N]

    disc = half_b * half_b - a * c
    has_root = disc > 0.0
    # Double-where: sqrt never sees a negative (forward) and the masked
    # lanes' backward is exactly zero (no NaN * 0).
    sqrt_d = jnp.sqrt(jnp.where(has_root, disc, 1.0))

    inv_a = 1.0 / a
    root_near = (-half_b - sqrt_d) * inv_a
    root_far = (-half_b + sqrt_d) * inv_a

    def in_range(t):
        return (t > t_min) & (t < t_max)  # strict, = interval.surrounds

    t = jnp.where(in_range(root_near), root_near, root_far)
    valid = has_root & scene.active[None, :] & in_range(t)
    return jnp.where(valid, t, T_MISS)


def hit_scene(
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_min: float = T_MIN_EPS,
    t_max: float = T_MISS,
) -> HitRecord:
    """Closest hit over all spheres — masked argmin replaces the
    reference's sequential closest-so-far loop
    (reference: src/gpu/hittable_list.h:49-65)."""
    ts = sphere_hit_ts(scene, origin, direction, t_min, t_max)  # [R, N]

    # Winner selection via a ONE-HOT MATMUL of the mask against the
    # packed parameter matrix, [R,N] @ [N,K], instead of argmin + per-ray
    # gathers. Gradients flow to the winning sphere's parameters through
    # the matmul exactly as they would through a gather (one-hot rows
    # are constants of the backward pass, like the gather indices were).
    # Whether a plain gather is faster on the GPU is ROADMAP S2.
    t_min_r = jnp.min(ts, axis=-1, keepdims=True)  # [R, 1]
    hit = t_min_r[:, 0] < T_MISS * 0.5
    onehot = (ts <= t_min_r).astype(ts.dtype)  # [R, N]
    # Ties double-count in the sum; renormalize (measure-zero for real
    # geometry, but miss rows are ALL-tied at T_MISS and need it).
    onehot = onehot / jnp.maximum(
        jnp.sum(onehot, axis=-1, keepdims=True), 1.0
    )
    onehot = jax.lax.stop_gradient(onehot)

    # Packed per-sphere parameter matrix [N, 10]:
    # cx cy cz r albedo_rgb fuzz ior mat_type
    params = jnp.concatenate(
        [
            scene.center,
            scene.radius[:, None],
            scene.albedo,
            scene.fuzz[:, None],
            scene.ior[:, None],
            scene.mat_type.astype(ts.dtype)[:, None],
        ],
        axis=-1,
    )
    # HIGHEST: a TF32 product would round the gathered scene parameters
    # themselves (centers, radii, albedo) to 10 mantissa bits.
    hit_params = jnp.matmul(
        onehot, params, precision=jax.lax.Precision.HIGHEST
    )  # [R, 10]
    t = jnp.sum(onehot * ts, axis=-1)  # selected t (grad flows into ts)
    sphere_index = jnp.argmax(onehot, axis=-1).astype(jnp.int32)

    center_h = hit_params[:, 0:3]
    radius_h = hit_params[:, 3]

    # Miss lanes get t := 1 so the downstream geometry stays finite and
    # their (masked-out) gradients are zero.
    t_safe = jnp.where(hit, t, 1.0)
    point = vm.ray_at(origin, direction, t_safe)

    # Unit outward normal by construction: (p - center) / radius
    # (reference: src/gpu/sphere.h:40-42).
    outward = (point - center_h) / radius_h[:, None]
    front_face = vm.dot(direction, outward) < 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)

    return HitRecord(
        hit=hit,
        t=t_safe,
        point=point,
        normal=normal,
        front_face=front_face,
        sphere_index=sphere_index,
        albedo=hit_params[:, 4:7],
        fuzz=hit_params[:, 7],
        ior=hit_params[:, 8],
        mat_type=jnp.round(hit_params[:, 9]).astype(jnp.int32),
    )
