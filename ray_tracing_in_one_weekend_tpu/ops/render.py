"""Full-image render loop (pure-jnp reference path, jit-compiled).

This is the array re-expression of the reference's render kernel
(reference: src/gpu/camera.h:169-195 and the CUDA launch
src/gpu/main.cu:113-132): instead of one CUDA thread per pixel over a
16x16 block grid, pixels are flattened, split into static chunks
(sequenced with `lax.map` to bound live memory at [chunk, N_spheres]),
and each chunk runs a `fori_loop` over samples-per-pixel with the full
bounce loop vectorized over the chunk.

RNG keys derive from GLOBAL pixel index and sample index
(`fold_in(fold_in(base, pixel), sample)`), mirroring the reference's
`curand_init(seed, pixel_index, 0)` per-pixel streams
(reference: src/gpu/camera.h:186-187) and making the image bit-identical
for any chunk size or shard layout.

The output is the LINEAR sample-mean framebuffer [H, W, 3]; gamma and
quantization live in ops/image.py, matching the reference's split
between the framebuffer and `write_color`
(reference: src/gpu/camera.h:194, src/gpu/color.h:16-38).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracing_in_one_weekend_tpu.models.camera import Camera, get_rays
from ray_tracing_in_one_weekend_tpu.models.scene import Scene
from ray_tracing_in_one_weekend_tpu.ops import sampling
from ray_tracing_in_one_weekend_tpu.ops.integrator import trace_rays

# Default pixels per chunk. [chunk, 512-sphere] f32 intermediates are
# 32 MB at 16384 — comfortably inside device memory while long enough to
# keep the device busy. Tests/CPU override with smaller values.
DEFAULT_CHUNK = 16384


def render_pixels(
    scene: Scene,
    cam: Camera,
    pixel_indices: jnp.ndarray,
    base_key: jax.Array,
    spp: int | None = None,
    sample_offset: jnp.ndarray | int = 0,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Render an arbitrary flat batch of global pixel indices.

    Returns the linear sample-mean color [R, 3]. This is the unit the
    distributed layer shards: any subset of pixels renders identically
    regardless of which device renders it. `sample_offset` shifts the
    GLOBAL sample indices this call draws (the spp-sharding hook: device
    d of S renders samples [d*spp/S, (d+1)*spp/S) of the same pixels).
    """
    spp = cam.samples_per_pixel if spp is None else spp
    px = pixel_indices % cam.image_width
    py = pixel_indices // cam.image_width

    pixel_keys = sampling.fold_b(
        jnp.broadcast_to(base_key, pixel_indices.shape), pixel_indices
    )

    def sample_body(s, acc):
        keys = sampling.fold_b(pixel_keys, sample_offset + s)
        ray_keys = sampling.fold_b(keys, 0)
        trace_keys = sampling.fold_b(keys, 1)
        origin, direction = get_rays(cam, px, py, ray_keys)
        color = trace_rays(
            scene, origin, direction, trace_keys, cam.max_depth,
            differentiable=differentiable,
        )
        return acc + color

    total = jax.lax.fori_loop(
        0, spp, sample_body, jnp.zeros((pixel_indices.shape[0], 3), jnp.float32)
    )
    return total / spp


def render_flat(
    scene: Scene,
    cam: Camera,
    pixel_indices: jnp.ndarray,
    base_key: jax.Array,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    sample_offset: jnp.ndarray | int = 0,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Chunked render of a flat batch of global pixel indices -> [R, 3].

    Chunks are processed sequentially with `lax.map` so peak memory is
    O(chunk_size * num_spheres) regardless of batch size — the analogue
    of the CUDA grid launching more blocks than fit at once
    (reference: src/gpu/main.cu:113-118). The distributed layer calls
    this per device shard.
    """
    n = pixel_indices.shape[0]
    chunk_size = min(chunk_size, n)
    n_chunks = -(-n // chunk_size)
    padded = n_chunks * chunk_size
    # Pad with repeats of the last index; sliced away below.
    pad_pos = jnp.minimum(jnp.arange(padded), n - 1)
    chunks = pixel_indices[pad_pos].reshape(n_chunks, chunk_size)

    if n_chunks == 1:
        colors = render_pixels(
            scene, cam, chunks[0], base_key, spp=spp,
            sample_offset=sample_offset, differentiable=differentiable,
        )[None]
    else:
        colors = jax.lax.map(
            lambda c: render_pixels(
                scene, cam, c, base_key, spp=spp,
                sample_offset=sample_offset, differentiable=differentiable,
            ),
            chunks,
        )
    return colors.reshape(padded, 3)[:n]


def render(
    scene: Scene,
    cam: Camera,
    base_key: jax.Array,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Render the full image; returns the linear framebuffer [H, W, 3]."""
    w, h = cam.image_width, cam.image_height
    n_pixels = w * h
    colors = render_flat(
        scene, cam, jnp.arange(n_pixels), base_key, chunk_size=chunk_size,
        spp=spp, differentiable=differentiable,
    )
    return colors.reshape(h, w, 3)


def render_image(
    scene: Scene,
    cam: Camera,
    base_key: jax.Array | int = 0,
    chunk_size: int = DEFAULT_CHUNK,
) -> jnp.ndarray:
    """End-user entry: render and jit-cache by (scene/camera statics)."""
    if isinstance(base_key, int):
        base_key = jax.random.key(base_key)
    return _render_jit(scene, cam, base_key, chunk_size)


def _render_impl(scene, cam, base_key, chunk_size):
    return render(scene, cam, base_key, chunk_size=chunk_size)


_render_jit = jax.jit(_render_impl, static_argnames=("chunk_size",))
