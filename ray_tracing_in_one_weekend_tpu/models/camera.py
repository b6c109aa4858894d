"""Camera model: derived viewport constants + batched ray generation.

Array re-expression of the reference camera
(reference: src/gpu/camera.h:11-110). The reference derives
`pixel00_loc`, `pixel_delta_u/v` and the defocus-disk basis in a
`new_camera<<<1,1>>>` kernel; here the same derivation runs on host at
trace time and the results live in a small pytree that jit treats as
constants. Ray generation (`get_ray`,
reference: src/gpu/camera.h:153-167) is a pure batched function over
pixel coordinates.

Axis convention follows the reference GPU tree: x = column (left to
right), y = row (top to bottom), pixel (0,0) at the top-left.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from ray_tracing_in_one_weekend_tpu.ops import sampling
from ray_tracing_in_one_weekend_tpu.ops import vecmath as vm
from ray_tracing_in_one_weekend_tpu.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Camera:
    """Derived camera constants (reference: src/gpu/camera.h:28-35,53-110)."""

    # static config (hashable; part of the jit cache key)
    image_width: int = static_field()
    image_height: int = static_field()
    samples_per_pixel: int = static_field()
    max_depth: int = static_field()

    # traced array data (differentiable camera parameters)
    center: jnp.ndarray  # camera origin (== lookfrom)
    pixel00_loc: jnp.ndarray  # world-space location of pixel (0,0) center
    pixel_delta_u: jnp.ndarray  # world-space offset per +1 column
    pixel_delta_v: jnp.ndarray  # world-space offset per +1 row (points down)
    defocus_disk_u: jnp.ndarray  # lens-disk horizontal basis (zero if no defocus)
    defocus_disk_v: jnp.ndarray  # lens-disk vertical basis
    defocus_angle: jnp.ndarray  # scalar; <= 0 disables defocus sampling

    @property
    def num_pixels(self) -> int:
        return self.image_width * self.image_height


def make_camera(
    image_width: int = 1200,
    aspect_ratio: float = 3.0 / 2.0,
    samples_per_pixel: int = 10,
    max_depth: int = 50,
    vfov_degrees: float = 20.0,
    lookfrom=(13.0, 2.0, 3.0),
    lookat=(0.0, 0.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle_degrees: float = 0.6,
    focus_dist: float = 10.0,
    aperture: float | None = None,
    dtype=jnp.float32,
) -> Camera:
    """Derive the viewport constants exactly as the reference does
    (reference: src/gpu/camera.h:53-110). Defaults are the GPU tree's
    cover-scene camera (reference: src/gpu/camera.h:58-71) with the CPU
    tree's 1200-wide 3:2 framing available via arguments
    (reference: src/cpu/main.cc:82-99).
    """
    image_height = max(1, int(image_width / aspect_ratio))

    lookfrom = jnp.asarray(lookfrom, dtype)
    lookat = jnp.asarray(lookat, dtype)
    vup = jnp.asarray(vup, dtype)

    theta = math.radians(vfov_degrees)
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h * focus_dist
    viewport_width = viewport_height * (image_width / image_height)

    # Orthonormal camera frame; looking toward -w (reference: src/gpu/camera.h:84-86).
    w = vm.unit_vector(lookfrom - lookat)
    u = vm.unit_vector(vm.cross(vup, w))
    v = vm.cross(w, u)

    viewport_u = viewport_width * u  # across, left→right
    viewport_v = viewport_height * -v  # down the image

    pixel_delta_u = viewport_u / image_width
    pixel_delta_v = viewport_v / image_height

    viewport_upper_left = lookfrom - focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    # The GPU tree parameterizes the lens by defocus ANGLE
    # (reference: src/gpu/camera.h:69,105-109); the CPU tree by APERTURE
    # (lens_radius = aperture/2, reference: src/cpu/camera.h:20-26).
    # `aperture`, when given, takes precedence and reproduces the CPU
    # parameterization exactly.
    if aperture is not None:
        defocus_radius = aperture / 2.0
        defocus_angle_degrees = 2.0 * math.degrees(
            math.atan(defocus_radius / focus_dist)
        )
    else:
        defocus_radius = focus_dist * math.tan(
            math.radians(defocus_angle_degrees / 2.0)
        )
    defocus_disk_u = u * defocus_radius
    defocus_disk_v = v * defocus_radius

    return Camera(
        image_width=image_width,
        image_height=image_height,
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        center=lookfrom,
        pixel00_loc=pixel00_loc,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=defocus_disk_u,
        defocus_disk_v=defocus_disk_v,
        defocus_angle=jnp.asarray(defocus_angle_degrees, dtype),
    )


def get_rays(
    cam: Camera,
    px: jnp.ndarray,
    py: jnp.ndarray,
    keys: jax.Array,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched jittered camera rays for integer pixel coords (px=col, py=row).

    The array form of the reference's `get_ray` + `pixel_sample_square` +
    `defocus_disk_sample` (reference: src/gpu/camera.h:140-167): a
    +-0.5-pixel uniform jitter around the pixel center, with the ray
    origin on the defocus disk when `defocus_angle > 0`.

    `keys` is a per-ray key array of shape [R] (one counter-derived key
    per (pixel, sample) — see ops/sampling.py), so ray generation is
    invariant to chunking/sharding layout.

    Returns (origins [R, 3], directions [R, 3]); directions are NOT
    normalized, matching the reference (direction = sample - origin).
    """
    # One batched sweep: 4 uniforms per ray (2 jitter, 2 lens disk).
    # Domain 1<<20 keeps camera draws disjoint from the integrator's
    # per-bounce domains 0..max_depth.
    u4 = sampling.uniforms_b(keys, 4, domain=1 << 20)
    jitter = u4[..., 0:2] - 0.5
    pixel_sample = (
        cam.pixel00_loc
        + (px.astype(jnp.float32) + jitter[..., 0])[..., None] * cam.pixel_delta_u
        + (py.astype(jnp.float32) + jitter[..., 1])[..., None] * cam.pixel_delta_v
    )

    # Polar unit-disk sample (identical law to the reference's rejection
    # loop, reference: src/gpu/rtweekend.h:61-69).
    disk_r = jnp.sqrt(u4[..., 2])
    disk_theta = (2.0 * jnp.pi) * u4[..., 3]
    disk_origin = (
        cam.center
        + (disk_r * jnp.cos(disk_theta))[..., None] * cam.defocus_disk_u
        + (disk_r * jnp.sin(disk_theta))[..., None] * cam.defocus_disk_v
    )
    origin = jnp.where(cam.defocus_angle > 0.0, disk_origin, cam.center)

    direction = pixel_sample - origin
    return origin, direction
