"""Differentiable path tracer in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of the
C++/CUDA "Ray Tracing in One Weekend" reference
(kouei/ray-tracing-in-one-weekend): camera ray generation with defocus
blur, ray-sphere intersection, lambertian/metal/dielectric scattering, a
depth-limited iterative bounce loop, stratified per-pixel multi-sampling,
and gamma-corrected PPM output — designed for array hardware:

* structure-of-arrays scene pytree (no virtual dispatch; masked
  `jnp.where` select over a material-type integer),
* counter-based stateless RNG (`jax.random.fold_in`) instead of curand
  per-pixel streams,
* an iterative `lax.fori_loop` bounce loop with a done-mask (the array
  form of the reference's iterative GPU integrator,
  reference: src/gpu/camera.h:112-138),
* a Pallas GPU kernel (Triton route) over blocks of pixel lanes for
  the hot path,
* `shard_map` over a device mesh for multi-device/multi-host scaling,
* full differentiability: gradients flow from rendered pixels back to
  sphere centers, radii, albedos, fuzz and IOR.
"""

from ray_tracing_in_one_weekend_tpu.models.camera import Camera, make_camera
from ray_tracing_in_one_weekend_tpu.models.scene import (
    Scene,
    cover_scene,
    single_sphere_scene,
    three_sphere_scene,
)
from ray_tracing_in_one_weekend_tpu.ops.integrator import ray_color, trace_rays
from ray_tracing_in_one_weekend_tpu.ops.render import render, render_image
from ray_tracing_in_one_weekend_tpu.utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "make_camera",
    "Scene",
    "cover_scene",
    "single_sphere_scene",
    "three_sphere_scene",
    "ray_color",
    "trace_rays",
    "render",
    "render_image",
    "RenderConfig",
]
