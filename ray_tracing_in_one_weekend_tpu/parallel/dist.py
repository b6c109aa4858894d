"""Multi-chip / multi-host distributed rendering over a device mesh.

The reference has no distributed layer at all (SURVEY.md §2.3): its only
parallelism is 32 CPU threads over scanlines
(reference: src/cpu-multi-threading/main.cc:105-139) and one CUDA thread
per pixel (reference: src/gpu/main.cu:113-118), plus a MANUAL offline
workflow where the author rendered the same scene at several seeds and
merged the PNGs (reference: gallery/gpu/image11-source-images/). The
design here automates exactly those two decompositions over a
`jax.sharding.Mesh`:

* **pixel axis** (`'pixels'`) — the image's flat pixel space is sharded
  across devices; each device renders a contiguous slab. This is the
  data-parallel analogue (DP over rays). No communication is needed in
  the forward pass; the framebuffer is produced already-sharded and XLA
  all-gathers it only if the caller materializes the full image.
* **sample axis** (`'samples'`) — every device renders the SAME pixels
  with a disjoint slice of the sample budget, then a `psum`-mean over
  the axis merges them: the reference's manual PNG-merge workflow, over
  the device interconnect instead of a file manager.

Because every random draw is keyed by GLOBAL (pixel, sample) indices
(ops/sampling.py), the distributed image is bit-identical to the
single-chip image for any mesh shape — rendering is embarrassingly
parallel, so the mesh layout is purely a throughput choice.

Gradients: `render_grads` / `train_step` differentiate straight through
`shard_map` — parameter gradients of replicated scene arrays come out of
the backward pass `psum`-reduced over both axes automatically (XLA
inserts the collectives).

Multi-host: `jax.distributed.initialize()` (utils/cli.py --multihost)
gives one process per host; `render_distributed` then shards over ALL
devices and each host materializes only its addressable framebuffer
shards; utils/ppm.py's writer gathers to host 0.

TP/PP/EP/CP have no referent in a path tracer (SURVEY.md §2.2): there
are no weight matrices to split (no TP), no layer pipeline (no PP), no
experts (no EP), and the bounce loop is strictly sequential per ray (no
CP) — the two meaningful axes are pixels and samples, both implemented
here.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ray_tracing_in_one_weekend_tpu.models.camera import Camera
from ray_tracing_in_one_weekend_tpu.models.scene import Scene
from ray_tracing_in_one_weekend_tpu.ops.render import DEFAULT_CHUNK, render_flat

PIXEL_AXIS = "pixels"
SAMPLE_AXIS = "samples"


def make_mesh(
    mesh_shape: Tuple[int, ...] | None = None,
    devices=None,
) -> Mesh:
    """Build a ('pixels', 'samples') mesh.

    `mesh_shape=(P,)` shards pixels only; `(P, S)` also shards the
    sample budget S ways. Default: all devices on the pixel axis —
    pixel-sharding needs no collective in the forward pass, so it is
    the right default for pure rendering (sample-sharding matters when
    spp is large relative to pixels, or for progressive accumulation).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if mesh_shape is None or len(mesh_shape) == 0:
        mesh_shape = (devices.size,)
    if len(mesh_shape) == 1:
        mesh_shape = (mesh_shape[0], 1)
    if len(mesh_shape) != 2:
        raise ValueError(f"mesh_shape must be (P,) or (P, S), got {mesh_shape}")
    n = mesh_shape[0] * mesh_shape[1]
    if n > devices.size:
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, have {devices.size}")
    return Mesh(
        devices[:n].reshape(mesh_shape), axis_names=(PIXEL_AXIS, SAMPLE_AXIS)
    )


def _padded_pixel_count(n_pixels: int, n_shards: int, chunk_size: int) -> int:
    """Pixels padded so every shard gets the same whole number of pixels."""
    per_shard = -(-n_pixels // n_shards)
    return per_shard * n_shards


def render_distributed(
    scene: Scene,
    cam: Camera,
    base_key: jax.Array,
    mesh: Mesh,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    differentiable: bool = False,
    sample_offset: int = 0,
) -> jnp.ndarray:
    """Render the full image sharded over `mesh` -> linear [H, W, 3].

    Pixel axis: flat pixel space split into equal contiguous slabs.
    Sample axis: spp split into equal slices, merged by psum-mean.
    Bit-identical to the single-chip `ops.render.render` for any mesh.
    `sample_offset` starts the global sample streams there (progressive
    accumulation, utils/checkpoint.py).
    """
    spp = cam.samples_per_pixel if spp is None else spp
    n_pix_shards = mesh.shape[PIXEL_AXIS]
    n_smp_shards = mesh.shape[SAMPLE_AXIS]
    if spp % n_smp_shards != 0:
        raise ValueError(
            f"samples_per_pixel={spp} must divide evenly over the "
            f"'{SAMPLE_AXIS}' mesh axis of size {n_smp_shards}"
        )
    spp_local = spp // n_smp_shards

    w, h = cam.image_width, cam.image_height
    n_pixels = w * h
    padded = _padded_pixel_count(n_pixels, n_pix_shards, chunk_size)
    # Pad with repeats of the last pixel; wasted lanes, sliced away below.
    idx = jnp.minimum(jnp.arange(padded), n_pixels - 1)

    def shard_fn(scene, cam, idx_shard, key):
        s_idx = jax.lax.axis_index(SAMPLE_AXIS)
        colors = render_flat(
            scene,
            cam,
            idx_shard,
            key,
            chunk_size=chunk_size,
            spp=spp_local,
            sample_offset=s_idx * spp_local + sample_offset,
            differentiable=differentiable,
        )
        # Mean over the sample axis = the reference's offline PNG merge
        # (reference: gallery/gpu/image11-source-images/), as a collective.
        return jax.lax.pmean(colors, SAMPLE_AXIS)

    # check_vma=False: the integrator's fori_loop carries start as
    # unvarying constants and become mesh-varying after one iteration,
    # which the static varying-axes checker rejects; semantics are
    # validated instead by the bit-identical-to-single-chip tests.
    colors = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(PIXEL_AXIS), P()),
        out_specs=P(PIXEL_AXIS),
        check_vma=False,
    )(scene, cam, idx, base_key)

    return colors[:n_pixels].reshape(h, w, 3)


@partial(jax.jit, static_argnames=("mesh", "chunk_size", "spp"))
def _render_distributed_jit(scene, cam, base_key, mesh, chunk_size, spp):
    return render_distributed(scene, cam, base_key, mesh, chunk_size, spp)


def render_image_distributed(
    scene: Scene,
    cam: Camera,
    base_key: jax.Array | int = 0,
    mesh: Mesh | None = None,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
) -> jnp.ndarray:
    """End-user entry: jit-compiled mesh-sharded render."""
    if isinstance(base_key, int):
        base_key = jax.random.key(base_key)
    if mesh is None:
        mesh = make_mesh()
    return _render_distributed_jit(scene, cam, base_key, mesh, chunk_size, spp)


def fetch_image(img) -> np.ndarray:
    """Materialize a (possibly multi-host-sharded) framebuffer on every
    host as a plain numpy array.

    Single-process: a plain device fetch. Multi-process (after
    `jax.distributed.initialize`): each host holds only its addressable
    shards of the global framebuffer, so `np.asarray` would fail —
    gather the full image across hosts instead (the distributed form of the
    reference's single-host managed-memory readback,
    reference: src/gpu/main.cu:101,109-110; host 0 then owns the PPM
    write, utils/cli.py)."""
    if jax.process_count() == 1:
        return np.asarray(img)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(img, tiled=True))


# ---------------------------------------------------------------------------
# Differentiable distributed rendering (inverse rendering / "training").
#
# The flagship differentiable workload: given a target image, recover
# scene parameters by gradient descent on the L2 pixel loss. The forward
# is the sharded render above; the backward flows through shard_map, and
# the gradients of the REPLICATED scene arrays are psum-reduced over the
# mesh by construction (this is the DP gradient all-reduce analogue,
# SURVEY.md §2.2).
# ---------------------------------------------------------------------------

# Scene leaves that receive gradients (the continuous parameters;
# mat_type/active are discrete structure).
DIFF_FIELDS = ("center", "radius", "albedo", "fuzz", "ior")


def scene_params(scene: Scene) -> dict:
    """Extract the differentiable sub-pytree of a Scene."""
    return {f: getattr(scene, f) for f in DIFF_FIELDS}


def scene_with_params(scene: Scene, params: dict) -> Scene:
    return scene.replace(**params)


def render_loss(
    params: dict,
    scene: Scene,
    cam: Camera,
    target: jnp.ndarray,
    base_key: jax.Array,
    mesh: Mesh,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
) -> jnp.ndarray:
    """Mean-squared pixel loss of the sharded render against `target`."""
    img = render_distributed(
        scene_with_params(scene, params), cam, base_key, mesh, chunk_size, spp,
        differentiable=True,
    )
    return jnp.mean((img - target) ** 2)


@partial(jax.jit, static_argnames=("mesh", "chunk_size", "spp"))
def render_grads(
    params: dict,
    scene: Scene,
    cam: Camera,
    target: jnp.ndarray,
    base_key: jax.Array,
    mesh: Mesh,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
):
    """(loss, grads) of the distributed render w.r.t. scene parameters."""
    return jax.value_and_grad(render_loss)(
        params, scene, cam, target, base_key, mesh, chunk_size, spp
    )


@partial(jax.jit, static_argnames=("mesh", "chunk_size", "spp", "lr"))
def train_step(
    params: dict,
    scene: Scene,
    cam: Camera,
    target: jnp.ndarray,
    base_key: jax.Array,
    mesh: Mesh,
    chunk_size: int = DEFAULT_CHUNK,
    spp: int | None = None,
    lr: float = 1e-2,
):
    """One SGD step of inverse rendering: returns (loss, new_params).

    This is the full "training step" the multi-chip dry-run compiles:
    sharded differentiable forward, backward through the bounce loop,
    cross-mesh gradient reduction, parameter update.
    """
    loss, grads = jax.value_and_grad(render_loss)(
        params, scene, cam, target, base_key, mesh, chunk_size, spp
    )
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params
