"""Pallas GPU render kernel (Triton route) — the hot path.

The kernel follows the reference's CUDA `render` kernel
(reference: src/gpu/camera.h:169-195, launched at src/gpu/main.cu:113-132
as a 2D grid of 16x16 thread blocks, one thread per pixel):

* CUDA thread block (256 pixels)  ->  one Pallas program per block of
  `tile` lanes (256 by default, one lane per thread at eight warps).
  Every per-ray scalar is a `[tile]` vector, every vec3 a tuple of three
  of them, so the whole bounce state lives in registers; device memory
  is touched only to load the lane state at the start of a pass and
  store it at the end.
* per-thread curand stream        ->  counter-based PCG hash streams
  keyed by GLOBAL (pixel, sample, bounce, draw); the cylinder map for
  unit vectors. Pure uint32 arithmetic, identical compiled and
  interpreted.
* per-thread iterative ray_color  ->  in-kernel `while_loop` over
  (sample, bounce) work items, exiting when every lane of the block has
  retired (the batched form of the CUDA early `return`, reference:
  src/gpu/camera.h:124-130).
* hittable_list::hit scan         ->  the same closest-so-far loop over
  the sphere list (reference: src/gpu/hittable_list.h:49-65), carrying
  `t_best` and the winning slot per lane. Each iteration reads one
  sphere's parameters as scalars from the 32 KB packed scene, which
  stays resident in L1. The winner's parameters are then gathered per
  lane by index.
* material* virtual scatter       ->  branchless 3-way select on the
  gathered mat_type (same math as ops/materials.py).

Everything runs in float32 on the CUDA cores; the kernel has no matrix
product, so no TF32 rounding can reach the geometry.

Scene packing (`pack_scene`): a `[16, N]` parameter matrix (rows: cx, cy,
cz, r, r^2, alb_r, alb_g, alb_b, fuzz, ior, mat_type, active, pad); the
kernel reads its transpose `[N, 16]`, so one sphere's parameters share a
cache line.

RNG NOTE: the kernel's PCG streams differ from the threefry streams of
the pure-jnp path — the two paths agree statistically (same sampling
distributions, documented in ops/sampling.py), not bitwise. The jnp path
remains the parity oracle vs the reference; the kernel is validated
against it at moderate spp (tests/test_pallas.py).

MODE NOTE (compiled vs interpret): the RNG draws are bit-identical in
both modes (pure uint32 + exact float ops), but sin/cos/sqrt/rsqrt come
from CUDA's libdevice when compiled and from XLA's CPU code when
interpreted, and the two differ in the last ulps — so scatter directions
differ by ~1e-7 relative per bounce, and a borderline discrete decision
(hit/miss at a tangent, metal backscatter, Schlick branch) occasionally
flips. Mode equivalence is therefore STATISTICAL, while WITHIN each mode
results are deterministic and the scheduling knobs (tile, budget,
n_passes, mesh) are bit-exact no-ops.

STREAM-WIDTH NOTE: each (pixel, sample) carries a 64-bit stream state
(two uint32 words, `lo`/`hi`, both PCG-mixed from the global pixel and
sample indices; every draw re-keys on both words plus the draw counter).
With a single 32-bit stream word, birthday collisions make two samples
share an entire random sequence with probability ~ n^2 / 2^33: at the
reference GPU preset's 1.04e9 samples (1920x1080x500spp,
reference: src/gpu/camera.h:58-62) that is ~6e7 colliding pairs — ~11%
of samples duplicating another sample's whole path, visibly biasing
variance-convergence. With 64 bits of stream state the same workload
expects ~3e-2 colliding pairs (n^2 / 2^65) — none in practice.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ray_tracing_in_one_weekend_tpu.models.camera import Camera
from ray_tracing_in_one_weekend_tpu.models.scene import Scene
from ray_tracing_in_one_weekend_tpu.utils.platform import (
    devices_platform,
    kernel_interpret,
)

# Lanes per program (one ray per thread at tile // 32 warps). A power of
# two for Triton and a multiple of _compact's 128-lane block. 256 measured
# fastest for the cold multi-pass schedule every fresh render runs, within
# 3% of 128 for the warm single pass (H100, bench preset,
# scripts/sweep_sched.py; numbers in PERF.md).
DEFAULT_TILE = 256

# Keep in sync with ops/intersect.py.
T_MISS = 1e30
T_MIN_EPS = 1e-3

# P-matrix row indices (rows 12:16 are padding).
(_CX, _CY, _CZ, _R, _R2, _AR, _AG, _AB, _FUZZ, _IOR, _MAT, _ACTIVE) = range(12)
P_ROWS = 16

# Per-lane resumable state layout (the kernel's in/out contract; see the
# persistent-sample loop). Float block rows: ray origin, unit direction,
# running attenuation, radiance accumulated so far (sum over this lane's
# retired samples), while-loop trip count (diagnostics, out only),
# cumulative busy-iteration count (the lane's work-rate signal for the
# compaction scheduler, carried across passes). Int block rows: global
# pixel id, samples started, RNG stream low word, bounce depth of the
# live ray, busy flag, RNG stream high word (the two stream words make a
# 64-bit-equivalent state — see module docstring).
_SF_O, _SF_D, _SF_ATT, _SF_RAD = 0, 3, 6, 9
_SF_ITERS = 12
_SF_WORK = 13
SF_ROWS = 16  # 14 used, padded to a power of two
_SI_PIX, _SI_STARTED, _SI_STREAM, _SI_DEPTH, _SI_BUSY, _SI_STREAM2 = range(6)
SI_ROWS = 8

# Per-pass int scalars: [seed, pixel_offset, sample_offset, budget,
# live sphere slots, pad...].
(_SC_SEED, _SC_PIX_OFFSET, _SC_SAMPLE_OFFSET, _SC_BUDGET,
 _SC_N_LIVE) = range(5)
N_SCALARS = 8

# Camera vector layout.
# [0:3] center, [3:6] pixel00, [6:9] delta_u, [9:12] delta_v,
# [12:15] defocus_disk_u, [15:18] defocus_disk_v, [18] defocus_angle,
# [19] image_width (as float), [20] t_min epsilon, rest pad.
CAM_LEN = 32


def pack_scene(scene: Scene) -> jnp.ndarray:
    """Scene SoA -> [16, N] parameter matrix (see module docstring).

    Inactive padding slots are made analytically unhittable instead of
    carrying a mask: center=0 and r^2=-1 give, for unit ray directions,
    disc = (o.d)^2 - (o.o + 1) <= -1 < 0 by Cauchy-Schwarz — so the hot
    loop never tests an `active` row.
    """
    n = scene.center.shape[0]
    act = scene.active.astype(jnp.float32)
    center = scene.center * act[:, None]
    r2 = jnp.where(scene.active, scene.radius * scene.radius, -1.0)
    rows = jnp.zeros((P_ROWS, n), jnp.float32)
    rows = rows.at[_CX].set(center[:, 0])
    rows = rows.at[_CY].set(center[:, 1])
    rows = rows.at[_CZ].set(center[:, 2])
    rows = rows.at[_R].set(scene.radius)
    rows = rows.at[_R2].set(r2)
    rows = rows.at[_AR].set(scene.albedo[:, 0])
    rows = rows.at[_AG].set(scene.albedo[:, 1])
    rows = rows.at[_AB].set(scene.albedo[:, 2])
    rows = rows.at[_FUZZ].set(scene.fuzz)
    rows = rows.at[_IOR].set(scene.ior)
    rows = rows.at[_MAT].set(scene.mat_type.astype(jnp.float32))
    rows = rows.at[_ACTIVE].set(act)
    return rows


def live_slots(scene: Scene) -> jnp.ndarray:
    """One past the last active slot: the sphere loop's trip count.
    Slots beyond it are all inactive, so skipping them changes nothing;
    inactive slots below it are unhittable (see pack_scene)."""
    n = scene.active.shape[0]
    idx = jnp.arange(1, n + 1, dtype=jnp.int32)
    return jnp.max(jnp.where(scene.active, idx, 0))


def pack_camera(cam: Camera, t_min: float = T_MIN_EPS) -> np.ndarray:
    """Camera constants + the shadow-acne epsilon as runtime data.

    `t_min` defaults to the reference's 1e-3 epsilon
    (reference: src/gpu/camera.h:118, src/cpu/main.cc:19); it rides in
    the camera vector (not a kernel static) so the negative-example test
    can disable it without compiling a second kernel variant."""
    v = np.zeros(CAM_LEN, np.float32)
    v[0:3] = np.asarray(cam.center)
    v[3:6] = np.asarray(cam.pixel00_loc)
    v[6:9] = np.asarray(cam.pixel_delta_u)
    v[9:12] = np.asarray(cam.pixel_delta_v)
    v[12:15] = np.asarray(cam.defocus_disk_u)
    v[15:18] = np.asarray(cam.defocus_disk_v)
    v[18] = float(cam.defocus_angle)
    v[19] = float(cam.image_width)
    v[20] = float(t_min)
    return v


# ---------------------------------------------------------------------------
# In-kernel RNG: counter-based PCG hash (O'Neill's pcg_hash, the standard
# GPU path-tracer RNG). Pure uint32 arithmetic — identical results
# compiled and interpreted, no hardware-PRNG state.
# This replaces the reference's per-pixel curand streams
# (reference: src/gpu/camera.h:186-187) with streams keyed by the GLOBAL
# (pixel, sample, bounce, draw) tuple, like ops/sampling.py's threefry
# streams (different generator, same counter-based design).
# ---------------------------------------------------------------------------

_GOLDEN = np.uint32(0x9E3779B9)
_GOLDEN2 = np.uint32(0x85EBCA6B)  # murmur3 fmix constant; independent of _GOLDEN


def _pcg(x):
    """pcg_hash: uint32 -> well-mixed uint32."""
    state = x * np.uint32(747796405) + np.uint32(2891336453)
    word = ((state >> ((state >> 28) + np.uint32(4))) ^ state) * np.uint32(277803737)
    return (word >> 22) ^ word


def _to_unit_float(bits):
    """uint32 -> (0, 1) float32 with a 24-bit mantissa (log-safe): the
    top 24 bits fit a non-negative int32, converted exactly."""
    u = (bits >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / (1 << 24))
    return u + (0.5 / (1 << 24))


def _u01(stream, counter):
    """One U(0,1) per lane from a per-ray 64-bit stream (lo, hi) pair of
    uint32 vectors and a static or traced draw counter.

    Two mixing rounds: pcg(lo ^ ctr) decorrelates the counter within a
    stream; the second round keys on `hi`, so two samples only share a
    sequence if BOTH stream words collide (~2^-64 per pair)."""
    lo, hi = stream
    if isinstance(counter, int):
        c = np.uint32((counter * 0x9E3779B9) & 0xFFFFFFFF)
    else:
        c = counter * _GOLDEN
    return _to_unit_float(_pcg(_pcg(lo ^ c) + hi))


def _unit_vector(stream, counter):
    """Uniform direction on S^2 via the cylinder map (Archimedes):
    z ~ U(-1,1), phi ~ U(0,2pi) -> (sqrt(1-z^2) cos phi, ..., z) is
    EXACTLY uniform on the sphere (area element dz dphi). Distributional
    equivalent of the reference's rejection sampler
    (reference: src/gpu/rtweekend.h:51-53; see ops/sampling.py): 2 draws,
    1 sqrt and 1 sincos, with no data-dependent loop."""
    z = 2.0 * _u01(stream, counter) - 1.0
    phi = (2.0 * math.pi) * _u01(stream, counter + 1)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return (s * jnp.cos(phi), s * jnp.sin(phi), z)


# ---------------------------------------------------------------------------
# vec3 helpers on tuples of three lane vectors.
# ---------------------------------------------------------------------------

def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _scale(a, s):
    return tuple(x * s for x in a)


def _mul(a, b):
    return tuple(x * y for x, y in zip(a, b))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _select(c, a, b):
    return tuple(jnp.where(c, x, y) for x, y in zip(a, b))


def _normalize(v):
    return _scale(v, jax.lax.rsqrt(jnp.maximum(_dot(v, v), 1e-20)))


# ---------------------------------------------------------------------------
# Kernel building blocks.
# ---------------------------------------------------------------------------


def _closest_hit(o, d, pt_ref, n_live, t_min):
    """Closest-so-far sweep over sphere slots [0, n_live)
    (reference: src/gpu/hittable_list.h:49-65, src/gpu/sphere.h:15-44).

    `d` MUST be unit length (a = 1, so the quadratic is
    t^2 + 2*half_b*t + c with roots -half_b -+ sqrt(disc)). Returns
    (t_best, slot) per lane; misses keep t_best = T_MISS and slot 0.
    The strict `t < t_best` keeps the first of two equal roots, as the
    reference's shrinking closest_so_far interval does."""

    def body(k, carry):
        t_best, slot = carry
        oc = (o[0] - pt_ref[k, _CX], o[1] - pt_ref[k, _CY],
              o[2] - pt_ref[k, _CZ])
        half_b = _dot(oc, d)
        c = _dot(oc, oc) - pt_ref[k, _R2]
        disc = half_b * half_b - c
        sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
        root_near = -half_b - sqrt_d
        root = jnp.where(root_near > t_min, root_near, -half_b + sqrt_d)
        better = (disc >= 0.0) & (root > t_min) & (root < t_best)
        return jnp.where(better, root, t_best), jnp.where(better, k, slot)

    shape = d[0].shape
    return jax.lax.fori_loop(
        0, n_live, body,
        (jnp.full(shape, T_MISS, jnp.float32), jnp.zeros(shape, jnp.int32)),
    )


def _scatter(d, n_vec, front_face, mat, albedo, fuzz, ior, stream, ctr):
    """Branchless 3-material scatter (same semantics as
    ops/materials.scatter_sampled). `d` is unit; the returned direction
    is unit (the closest-hit invariant)."""
    unit_sample = _unit_vector(stream, ctr)
    reflect_u = _u01(stream, ctr + 4)

    # lambertian (reference: src/gpu/material.h:24-36)
    lam_dir = _add(n_vec, unit_sample)
    degenerate = _dot(lam_dir, lam_dir) < 1e-16
    lam_dir = _select(degenerate, n_vec, lam_dir)

    # metal (reference: src/gpu/material.h:47-59)
    reflected = _sub(d, _scale(n_vec, 2.0 * _dot(d, n_vec)))
    metal_dir = _add(reflected, _scale(unit_sample, fuzz))
    metal_ok = _dot(metal_dir, n_vec) > 0.0

    # dielectric (reference: src/gpu/material.h:70-93)
    ratio = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(-_dot(d, n_vec), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m_cos = 1.0 - cos_theta
    one_m_cos2 = one_m_cos * one_m_cos
    schlick = r0 + (1.0 - r0) * (one_m_cos2 * one_m_cos2 * one_m_cos)
    must_reflect = cannot_refract | (schlick > reflect_u)
    r_perp = _scale(_add(d, _scale(n_vec, cos_theta)), ratio)
    k = jnp.maximum(1.0 - _dot(r_perp, r_perp), 0.0)
    refracted = _sub(r_perp, _scale(n_vec, jnp.sqrt(k)))
    diel_dir = _select(must_reflect, reflected, refracted)

    is_lam = mat < 0.5
    is_metal = (mat >= 0.5) & (mat < 1.5)
    new_dir = _select(is_lam, lam_dir, _select(is_metal, metal_dir, diel_dir))
    # Restore the unit invariant (lam/metal dirs are not unit;
    # dielectric reflect/refract of a unit vector already is).
    new_dir = _normalize(new_dir)
    is_diel = mat >= 1.5
    atten = tuple(jnp.where(is_diel, 1.0, a) for a in albedo)
    ok = (~is_metal) | metal_ok
    return new_dir, atten, ok


def _camera_ray(cam, h0, px, py, s_global):
    """Camera ray + 64-bit RNG stream (lo, hi) for per-lane GLOBAL
    sample index `s_global` (reference: src/gpu/camera.h:140-167). Both
    stream words mix the global pixel hash h0 with the GLOBAL sample
    index, so streams are invariant to pass/mesh/compaction layout.
    """
    center, pixel00, delta_u, delta_v, disk_u, disk_v, defocus_on = cam
    s_u = s_global.astype(jnp.uint32)
    lo = _pcg(h0 ^ (s_u * _GOLDEN))
    hi = _pcg((h0 + s_u) * _GOLDEN2)
    stream = (lo, hi)
    jx = _u01(stream, 0) - 0.5
    jy = _u01(stream, 1) - 0.5
    sample_pos = _add(
        _add(pixel00, _scale(delta_u, px + jx)), _scale(delta_v, py + jy)
    )
    disk_r = jnp.sqrt(_u01(stream, 2))
    disk_t = (2.0 * math.pi) * _u01(stream, 3)
    disk_origin = _add(
        _add(center, _scale(disk_u, disk_r * jnp.cos(disk_t))),
        _scale(disk_v, disk_r * jnp.sin(disk_t)),
    )
    o = tuple(jnp.where(defocus_on, a, b) for a, b in zip(disk_origin, center))
    # Unit direction: the closest-hit sweep assumes |d| = 1 (t becomes
    # true distance; the reference's t is in |d| units, same geometry).
    d = _normalize(_sub(sample_pos, o))
    return o, d, lo, hi


def _as_u32(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _as_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------

def _render_kernel(
    sc_ref,  # [N_SCALARS] i32 (see _SC_*)
    cam_ref,  # [CAM_LEN] f32 camera vector
    pt_ref,  # [N, 16] f32 transposed scene parameter matrix
    sf_ref,  # [SF_ROWS, tile] f32 lane state in
    si_ref,  # [SI_ROWS, tile] i32 lane state in
    of_ref,  # [SF_ROWS, tile] f32 lane state out
    oi_ref,  # [SI_ROWS, tile] i32 lane state out
    *,
    tile: int,
    spp: int,
    max_depth: int,
):
    def vec3(base):
        return (cam_ref[base], cam_ref[base + 1], cam_ref[base + 2])

    cam = (vec3(0), vec3(3), vec3(6), vec3(9), vec3(12), vec3(15),
           cam_ref[18] > 0.0)
    width = cam_ref[19].astype(jnp.int32)
    t_min = cam_ref[20]
    # Iteration budget as RUNTIME data, not a kernel static: every pass
    # of _multipass — budgeted or the unbudgeted finisher — runs the
    # SAME compiled kernel.
    budget = sc_ref[_SC_BUDGET]
    n_live = sc_ref[_SC_N_LIVE]
    sample_offset = sc_ref[_SC_SAMPLE_OFFSET]

    # Each lane carries its GLOBAL flat pixel index in the int state (the
    # compaction passes shuffle lanes, so lane id no longer implies the
    # pixel). Streams and geometry stay keyed by the global index on any
    # mesh / any pass.
    pix = si_ref[_SI_PIX, :]
    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)

    # Per-pixel RNG stream base: global pixel index x seed, like
    # curand_init(seed, pixel_index, 0) (reference: src/gpu/camera.h:186).
    h0 = _pcg(_as_u32(pix) ^ _pcg(_as_u32(sc_ref[_SC_SEED])))

    def camera_ray(s_local):
        return _camera_ray(cam, h0, px, py, s_local + sample_offset)

    def rows(ref, base):
        return (ref[base, :], ref[base + 1, :], ref[base + 2, :])

    # ---- persistent-sample loop, budgeted & resumable -----------------
    # The CUDA kernel loops samples-outer / bounces-inner per thread
    # (reference: src/gpu/camera.h:189-192); in a block that pays the
    # block's MAX bounce depth for every sample. Instead each lane runs
    # ONE flat loop over (sample, bounce) work items: when its ray
    # retires it immediately regenerates the camera ray for its next
    # unfinished sample.
    #
    # The loop also stops after `budget` iterations and dumps the raw
    # lane state; the host driver compacts unfinished lanes into dense
    # front blocks and re-invokes (tail compaction — see _multipass).
    started = si_ref[_SI_STARTED, :]
    stream_lo = _as_u32(si_ref[_SI_STREAM, :])
    stream_hi = _as_u32(si_ref[_SI_STREAM2, :])
    depth = si_ref[_SI_DEPTH, :]
    busy = si_ref[_SI_BUSY, :] > 0
    o = rows(sf_ref, _SF_O)
    d = rows(sf_ref, _SF_D)
    atten = rows(sf_ref, _SF_ATT)
    rad = rows(sf_ref, _SF_RAD)
    work = sf_ref[_SF_WORK, :]

    # Idle lanes with samples left start one NOW — the first iteration of
    # the bottom-of-loop regeneration, hoisted out of the loop. On a
    # fresh launch that is every live lane's sample 0; on a resumed pass
    # it is only lanes the budget stopped between samples. After this,
    # `started < spp` implies busy, so the loop cond tests busy alone.
    can_start = (~busy) & (started < spp)
    o0, d0, lo0, hi0 = camera_ray(started)
    started = started + can_start.astype(jnp.int32)
    stream_lo = jnp.where(can_start, lo0, stream_lo)
    stream_hi = jnp.where(can_start, hi0, stream_hi)
    depth = jnp.where(can_start, 0, depth)
    atten = _select(can_start, (1.0, 1.0, 1.0), atten)
    o = _select(can_start, o0, o)
    d = _select(can_start, d0, d)
    busy = busy | can_start

    def cond(state):
        iters, busy = state[0], state[5]
        return (iters < budget) & (jnp.max(busy.astype(jnp.int32)) > 0)

    def body(state):
        (iters, started, stream_lo, stream_hi, depth, busy,
         o, d, atten, rad, work) = state
        stream = (stream_lo, stream_hi)
        # Per-lane busy-iteration counter: the compaction scheduler's
        # work-rate signal (bounces executed so far / samples started).
        work = work + busy.astype(jnp.float32)

        t_best, slot = _closest_hit(o, d, pt_ref, n_live, t_min)
        hit = t_best < T_MISS

        # miss -> sky, retire (reference: src/gpu/camera.h:118-124)
        # d is unit by the loop invariant.
        sky_a = 0.5 * (d[1] + 1.0)
        sky = ((1.0 - sky_a) + sky_a * 0.5,
               (1.0 - sky_a) + sky_a * 0.7,
               (1.0 - sky_a) + sky_a * 1.0)
        miss = busy & ~hit
        rad = _select(miss, _add(rad, _mul(atten, sky)), rad)

        # The winner's parameters, gathered per lane (miss lanes read
        # slot 0 and are masked below).
        def param(row):
            return pt_ref[slot, row]

        # hit geometry. The SIGNED radius divides the normal, exactly as
        # the reference's (p - c) / radius (reference: src/gpu/sphere.h:
        # 40-42): a negative radius flips the outward normal inward — the
        # book's hollow-glass-sphere trick.
        center_h = (param(_CX), param(_CY), param(_CZ))
        t_safe = jnp.where(hit, t_best, 1.0)
        p = _add(o, _scale(d, t_safe))
        r_signed = param(_R)
        inv_r = 1.0 / jnp.where(jnp.abs(r_signed) > 1e-8, r_signed, 1.0)
        outward = _scale(_sub(p, center_h), inv_r)
        front_face = _dot(d, outward) < 0.0
        n_vec = _select(front_face, outward, _scale(outward, -1.0))

        ctr = np.uint32(8) + depth.astype(jnp.uint32) * np.uint32(16)
        new_dir, mat_atten, ok = _scatter(
            d, n_vec, front_face, param(_MAT),
            (param(_AR), param(_AG), param(_AB)), param(_FUZZ), param(_IOR),
            stream, ctr,
        )

        depth = depth + 1
        cont = busy & hit & ok & (depth < max_depth)
        atten = _select(cont, _mul(atten, mat_atten), atten)
        o = _select(cont, p, o)
        d = _select(cont, new_dir, d)

        # Retired lanes with samples left start their next sample NOW.
        regen = busy & ~cont & (started < spp)
        o2, d2, lo2, hi2 = camera_ray(started)
        started = started + regen.astype(jnp.int32)
        stream_lo = jnp.where(regen, lo2, stream_lo)
        stream_hi = jnp.where(regen, hi2, stream_hi)
        depth = jnp.where(regen, 0, depth)
        atten = _select(regen, (1.0, 1.0, 1.0), atten)
        o = _select(regen, o2, o)
        d = _select(regen, d2, d)
        busy = cont | regen
        return (iters + 1, started, stream_lo, stream_hi, depth, busy,
                o, d, atten, rad, work)

    state = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), started, stream_lo, stream_hi, depth, busy,
         o, d, atten, rad, work),
    )
    (iters, started, stream_lo, stream_hi, depth, busy,
     o, d, atten, rad, work) = state

    # Raw lane state out — the resume/compaction contract. Radiance rides
    # in the state (raw sum over this lane's retired samples across ALL
    # passes; the driver divides by spp once at the end).
    for base, v in ((_SF_O, o), (_SF_D, d), (_SF_ATT, atten), (_SF_RAD, rad)):
        for i in range(3):
            of_ref[base + i, :] = v[i]
    # Diagnostics row: the block's while-loop trip count (every lane of
    # the block shares it).
    of_ref[_SF_ITERS, :] = jnp.broadcast_to(iters.astype(jnp.float32), (tile,))
    of_ref[_SF_WORK, :] = work
    zeros_f = jnp.zeros((tile,), jnp.float32)
    for r in range(_SF_WORK + 1, SF_ROWS):
        of_ref[r, :] = zeros_f
    oi_ref[_SI_PIX, :] = pix
    oi_ref[_SI_STARTED, :] = started
    oi_ref[_SI_STREAM, :] = _as_i32(stream_lo)
    oi_ref[_SI_DEPTH, :] = depth
    oi_ref[_SI_BUSY, :] = busy.astype(jnp.int32)
    oi_ref[_SI_STREAM2, :] = _as_i32(stream_hi)
    zeros_i = jnp.zeros((tile,), jnp.int32)
    for r in range(_SI_STREAM2 + 1, SI_ROWS):
        oi_ref[r, :] = zeros_i


def _pass_scalars(seed, pixel_offset, sample_offset, n_live):
    """The kernel's int32 scalars (see _SC_*); the budget slot is set
    per pass by _multipass."""
    z = jnp.int32(0)
    return jnp.stack(
        [seed, pixel_offset, sample_offset, z, n_live, z, z, z]
    ).astype(jnp.int32)


def _num_warps(tile: int) -> int:
    """One lane per thread up to 8 warps; wider tiles give each thread
    several lanes."""
    return max(1, min(8, tile // 32))


def _render_pallas_core(pt_mat, cam_vec, scalars, sf, si, tile, spp, max_depth, interpret):
    """One budgeted kernel pass over the whole lane-state buffer.

    `scalars` = [seed, pixel_offset, sample_offset, budget, n_live, pad]
    int32 (pixel_offset is consumed by the driver, not the kernel; budget
    is the pass's while-loop iteration cap, runtime data so all passes
    share one compiled kernel). Returns the advanced
    (float_state [SF_ROWS, P], int_state [SI_ROWS, P]) lane buffers.

    Compiled, this is a Triton kernel; `interpret=True` runs the same
    kernel body in the Pallas interpreter (CPU)."""
    n_spheres = pt_mat.shape[0]
    padded = sf.shape[1]
    kernel = functools.partial(
        _render_kernel, tile=tile, spp=spp, max_depth=max_depth
    )
    return pl.pallas_call(
        kernel,
        grid=(padded // tile,),
        in_specs=[
            pl.BlockSpec((N_SCALARS,), lambda i: (0,)),
            pl.BlockSpec((CAM_LEN,), lambda i: (0,)),
            pl.BlockSpec((n_spheres, P_ROWS), lambda i: (0, 0)),
            pl.BlockSpec((SF_ROWS, tile), lambda i: (0, i)),
            pl.BlockSpec((SI_ROWS, tile), lambda i: (0, i)),
        ],
        out_specs=[
            pl.BlockSpec((SF_ROWS, tile), lambda i: (0, i)),
            pl.BlockSpec((SI_ROWS, tile), lambda i: (0, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((SF_ROWS, padded), jnp.float32),
            jax.ShapeDtypeStruct((SI_ROWS, padded), jnp.int32),
        ],
        compiler_params=pl_triton.CompilerParams(
            num_warps=_num_warps(tile), num_stages=1
        ),
        interpret=interpret,
        name="render_kernel",
    )(scalars, cam_vec, pt_mat, sf, si)


def _init_state(pixel_offset, padded, n_pixels_total, spp):
    """Fresh lane state for the contiguous slab of `padded` lanes with
    global pixel ids pixel_offset + [0, padded). Lanes beyond the image
    are born finished (started = spp, not busy) — permanently dead, but
    holding distinct pixel ids so the slab's ids stay a permutation
    (the final unscramble is then a plain gather)."""
    lane = jnp.arange(padded, dtype=jnp.int32)
    pix = pixel_offset + lane
    sf = jnp.zeros((SF_ROWS, padded), jnp.float32)
    si = jnp.zeros((SI_ROWS, padded), jnp.int32)
    si = si.at[_SI_PIX].set(pix)
    si = si.at[_SI_STARTED].set(jnp.where(pix < n_pixels_total, 0, spp))
    return sf, si


def _compact(sf, si, tile, spp):
    """Tail compaction: densify unfinished lanes into front tiles
    without a global lane sort.

    A global stable lane `argsort` over the ~1M-lane buffer is a full
    multi-stage sort per compaction. What ships is a two-level scheme
    (tile-local lane sorts, then a sort of 128-lane blocks) that matches
    the global sort's density to within one partial block per source
    tile at a fraction of its cost — see the inline comments. Whether
    compaction pays on the GPU at all is an open question (ROADMAP S4).

    Purely a lane permutation — the image is bit-identical (lane state
    carries global pixel ids; the final unscramble gathers by pixel
    id).
    """
    padded = sf.shape[1]
    n_tiles = padded // tile
    # 128-lane blocks: the granularity of the global reorder. One
    # vector-lane row — block moves are contiguous, and a 1-block
    # density loss per source tile is the scheme's only slack.
    BLOCK = 128
    blocks_per_tile = tile // BLOCK
    n_blocks = padded // BLOCK

    unfinished = (si[_SI_BUSY] > 0) | (si[_SI_STARTED] < spp)

    # Per-lane remaining-work estimate: measured bounce rate (busy
    # iterations executed per sample started, the _SF_WORK counter)
    # times samples left. Spatial adjacency alone leaves tiles
    # heterogeneous — one 2048-lane tile spans ~2 image rows crossing
    # sky, ground and glass, whose queues differ 5-10x — so tiles
    # capped by a budget idle their cheap lanes against their deep
    # ones. Rate-sorting clusters lanes of similar remaining work.
    started_f = jnp.maximum(si[_SI_STARTED].astype(jnp.float32), 1.0)
    remaining = (sf[_SF_WORK] / started_f) * (
        spp - si[_SI_STARTED] + si[_SI_BUSY]
    ).astype(jnp.float32)

    # 1. Sort each tile's lanes: unfinished first, deepest remaining
    #    work first — independent row sorts, one per tile.
    lane_key = jnp.where(unfinished, -remaining, jnp.float32(jnp.inf))
    lane_order = jnp.argsort(
        lane_key.reshape(n_tiles, tile), axis=1, stable=True
    )  # [n_tiles, tile]

    # 2. Globally stable-sort the BLOCKS by descending total remaining
    #    work: deep dense blocks first, shallow blocks later (their
    #    tiles retire early), dead blocks (zero work) last. A ~7.5k-
    #    element sort is ~free; the payload move is a block-contiguous
    #    gather. This matches a global stable lane-argsort's density to
    #    within one partial block per source tile while avoiding a
    #    global sort of ~1M lanes per call — and beats it on tile
    #    homogeneity, which pixel order alone does not provide.
    rem_sorted = jnp.take_along_axis(
        jnp.where(unfinished, remaining, 0.0).reshape(n_tiles, tile),
        lane_order, axis=1,
    )
    block_work = jnp.sum(rem_sorted.reshape(n_blocks, BLOCK), axis=1)
    block_order = jnp.argsort(-block_work, stable=True)  # [n_blocks]
    # The (n_blocks, BLOCK) reshapes above and the per-tile lane sorts
    # only line up when tiles are whole numbers of blocks. ValueError,
    # not assert: asserts vanish under `python -O` and this guards a
    # CLI-reachable parameter (render entry points validate too).
    if tile % BLOCK != 0 or blocks_per_tile <= 0:
        raise ValueError(f"tile ({tile}) must be a positive multiple of {BLOCK}")

    def permute(x):
        # int rows (RNG stream words use all 32 bits) must not
        # round-trip through float; permute the two buffers separately.
        x = jnp.take_along_axis(
            x.reshape(x.shape[0], n_tiles, tile), lane_order[None], axis=2
        )
        x = jnp.take_along_axis(
            x.reshape(x.shape[0], n_blocks, BLOCK),
            block_order[None, :, None], axis=1,
        )
        return x.reshape(x.shape[0], padded)

    # Inverse of this compaction's flat lane permutation, so _multipass
    # can compose per-pass inverses instead of paying a global ~1M-lane
    # argsort at unscramble time. The applied permutation is
    # perm[i] = L[B[i]] (tile-local lane sort, then block gather); its
    # inverse is inv[j] = invB[invL[j]]. invL costs one int row-argsort
    # per tile (~ms total), invB a ~n_blocks-element argsort (~free).
    inv_lane = jnp.argsort(lane_order, axis=1).astype(jnp.int32)
    inv_lane_flat = (
        jnp.arange(n_tiles, dtype=jnp.int32)[:, None] * tile + inv_lane
    ).reshape(-1)
    inv_block = jnp.argsort(block_order).astype(jnp.int32)
    inv_block_flat = (
        inv_block[:, None] * BLOCK
        + jnp.arange(BLOCK, dtype=jnp.int32)[None, :]
    ).reshape(-1)
    inv_perm = inv_block_flat[inv_lane_flat]
    return permute(sf), permute(si), inv_perm


def _multipass(pt_mat, cam_vec, scalars, sf, si, tile, spp, max_depth, budget, n_passes, interpret, work_hint=None, with_work=False, work_perm=None):
    """Budgeted kernel passes with tail compaction between them.

    Why: one run-to-completion pass makes every tile pay its MAX lane
    queue — the deep-bounce tail (dielectric/metal chains, ~47 bounces
    on the cover scene vs a ~5.7 mean) idles >90% of lanes for the last
    ~100 iterations. Instead each pass stops after `budget` iterations;
    unfinished lanes are compacted into dense workload-sorted front
    tiles (see _compact), so the next pass runs them shoulder-to-
    shoulder while the dead tail exits at iteration 0. The final pass
    runs unbudgeted (spp*max_depth bounds any lane's remaining queue)
    to guarantee completion. Everything here jits — no host
    round-trips, shapes static, usable as-is inside shard_map.

    Returns the per-pixel radiance sum / spp as [3, padded], indexed by
    LOCAL pixel id (global id - scalars[1]). With `with_work`, also
    returns the per-pixel busy-iteration count [padded] (same local
    order) — the cost map a warm-started re-render feeds back in.

    `work_hint` (or None): per-lane expected cost in INITIAL (identity)
    layout. When given, the lanes are pre-permuted by the same two-level
    scheme compaction uses BEFORE the first pass, so pass 1 already runs
    cost-homogeneous tiles instead of image-order tiles whose per-tile
    max queue is set by their deepest pixel. Pure scheduling: the image
    is bit-identical with any (or no) hint. The payoff is for REPEATED
    renders of the same scene — training loops, progressive refinement,
    seed ensembles — where the previous frame's measured work row is a
    near-perfect predictor (bounce depth is a property of the pixel's
    scene content, not of the sample noise).

    `work_perm` = (perm, inv_perm) [padded] i32: a PRECOMPUTED lane
    permutation (and its inverse) applied instead of the in-graph
    two-level hint sort — the fully-sorted-by-cost order, computed once
    per scene outside this graph (a global ~1M-lane argsort is too
    much per render but nothing once). The two-level scheme matches the
    full sort's DENSITY (its job for in-render compaction) but not its
    tile COST-HOMOGENEITY, which is what the warm single pass is bound
    by. Mutually exclusive with `work_hint`."""
    final_budget = spp * max_depth
    inv_total = None
    if work_perm is not None:
        perm, inv_total = work_perm
        sf = sf[:, perm]
        si = si[:, perm]
    elif work_hint is not None:
        # Seed the compaction's remaining-work estimate with the hint
        # (at started=0 its estimate reduces to work * spp, monotone in
        # the hint), permute, then clear the work row so in-render
        # statistics stay untainted.
        sf = sf.at[_SF_WORK].set(work_hint)
        sf, si, inv_total = _compact(sf, si, tile, spp)
        sf = sf.at[_SF_WORK].set(0.0)
    for p in range(n_passes):
        # `budget` may be a single int or a per-pass tuple (a DECAYING
        # schedule can track the shrinking live set); the last pass is
        # always unbudgeted so completion is guaranteed.
        if p < n_passes - 1:
            b = budget[p] if isinstance(budget, (tuple, list)) else budget
        else:
            b = final_budget
        sf, si = _render_pallas_core(
            pt_mat, cam_vec, scalars.at[_SC_BUDGET].set(b), sf, si,
            tile, spp, max_depth, interpret,
        )
        if p < n_passes - 1:
            sf, si, inv_perm = _compact(sf, si, tile, spp)
            # Compose inverse permutations incrementally: after pass k,
            # lane inv_total[j] holds local pixel j (initial layout is
            # the identity, so inv_total starts as inv_perm itself).
            inv_total = (
                inv_perm if inv_total is None else inv_perm[inv_total]
            )
    # Unscramble via the composed inverse permutation — a single gather
    # straight into image order (no argsort over the lane buffer).
    if inv_total is not None:
        rad = sf[_SF_RAD : _SF_RAD + 3][:, inv_total]
    else:
        rad = sf[_SF_RAD : _SF_RAD + 3]
    rad = rad * (1.0 / spp)
    if not with_work:
        return rad
    work = sf[_SF_WORK]
    if inv_total is not None:
        work = work[inv_total]
    return rad, work


@functools.partial(
    jax.jit,
    static_argnames=(
        "tile", "spp", "max_depth", "budget", "n_passes", "interpret",
        "n_pixels", "padded", "use_perm", "with_work",
    ),
)
def _render_single_jit(
    scene, cam_vec, base, perm_inv, *, tile, spp, max_depth, budget,
    n_passes, interpret, n_pixels, padded, use_perm=False,
    with_work=False,
):
    """Whole single-chip render pipeline as ONE jitted program.

    `base` = i32 [2] (seed, sample_offset) — TRACED, so re-renders with
    a different seed or progressive sample window (utils/checkpoint.py)
    reuse the compiled program. Scene packing and lane-state init live
    inside the jit too: no per-call eager dispatches and no ~100MB of
    eager zero-buffer creation per call. `perm_inv` is a [2, padded] i32
    (permutation, inverse) pair (warm-start scheduling, see
    _multipass's `work_perm`) consumed only when `use_perm`; pass a
    dummy otherwise.
    """
    scalars = _pass_scalars(base[0], 0, base[1], live_slots(scene))
    sf, si = _init_state(0, padded, n_pixels, spp)
    return _multipass(
        pack_scene(scene).T, cam_vec, scalars, sf, si,
        tile, spp, max_depth, budget, n_passes, interpret,
        work_perm=(perm_inv[0], perm_inv[1]) if use_perm else None,
        with_work=with_work,
    )


@functools.partial(jax.jit, static_argnames=("n_slabs",))
def _perm_from_hint(hint, n_slabs=1):
    """Cost map [total] -> stacked (perm, inverse) [2, n_slabs, slab]
    i32 with SLAB-LOCAL indices: each slab's lanes fully sorted by
    descending cost (lanes never cross pixel shards; n_slabs=1 is the
    single-chip global sort). Dead/pad lanes (cost 0) sink to the tail
    tiles, which then exit their while loops immediately. Costs one
    ~1M-lane argsort — run ONCE per scene at cache-fill time, never per
    render."""
    total = hint.shape[0]
    slab = total // n_slabs
    local = jnp.argsort(
        -hint.reshape(n_slabs, slab), axis=1, stable=True
    ).astype(jnp.int32)
    inv_local = jnp.argsort(local, axis=1).astype(jnp.int32)
    return jnp.stack([local, inv_local])  # [2, n_slabs, slab]

# Default budgeted passes before the unbudgeted finisher. 1 disables
# compaction (single run-to-completion pass, the pre-compaction
# behavior). scripts/sweep_sched.py sweeps it with the budget and tile.
DEFAULT_PASSES = 3


def _default_budget(spp: int) -> int:
    # Mean lane queue on the cover scene is ~2.9 iterations per sample;
    # a budget of 3x spp lets most lanes finish in the first pass.
    return max(16, 3 * spp)


def _check_tile(tile: int) -> None:
    """ValueError (not assert — stripped under `python -O`) on tile
    values the kernel or the compaction reshapes cannot handle: Triton
    blocks are powers of two, and compaction moves 128-lane blocks.
    `tile` is reachable from the CLI (`--tile`)."""
    if tile < 128 or tile & (tile - 1):
        raise ValueError(
            f"tile ({tile}) must be a power of two and a multiple of 128"
        )


# ---------------------------------------------------------------------------
# Auto warm-start: per-(scene, camera) schedule cache.
#
# Maps a cheap identity key -> the warm-start lane PERMUTATION (and its
# inverse) derived from the previous render's per-lane cost map: lanes
# fully sorted by descending measured cost (_perm_from_hint, one
# ~1M-lane argsort ONCE per scene at cache-fill time). On a hit the next
# render of the same scene/camera applies the permutation and runs ONE
# uncompacted pass — the steady state of every repeated-render workload:
# bench timing loops, re-renders, training evaluations. The CUDA
# analogue re-runs its hot loop with no scheduling at all
# (reference: src/gpu/camera.h:169-195).
#
# Each entry stores (perm_inv, fill_seed, fill_sample_offset), and the
# permutation is only APPLIED when the incoming render's (seed,
# sample_offset) match the fill's — i.e. it re-renders the exact noise
# realization the cost map measured. A MISMATCHED render (different
# seed or sample window) would be scheduled by another realization's
# variance, so it runs the cold schedule and REFRESHES the fill for its
# own realization instead. Whether either schedule beats a plain single
# pass on the GPU is ROADMAP S4.
#
# Safety: the schedule is a pure lane PERMUTATION — _multipass produces
# a bit-identical image for any permutation/hint (tests/test_pallas.py
# pins this) — so a STALE or WRONG cache hit can only cost throughput,
# never correctness. That is why identity (array object ids + camera
# bytes), not array content, is a sufficient key; the padded lane count
# in the key rules out shape mismatches.
# ---------------------------------------------------------------------------
_WORK_CACHE: OrderedDict = OrderedDict()
_WORK_CACHE_MAX = 8


def _warm_cache_get(key, seed: int, sample_offset: int):
    """The cached permutation, or None unless the fill's (seed,
    sample_offset) match this render's (see the policy note above)."""
    entry = _WORK_CACHE.get(key)
    if entry is None:
        return None
    perm_inv, fill_seed, fill_offset = entry
    if fill_seed != seed or fill_offset != sample_offset:
        return None
    return perm_inv


def _warm_cache_key(scene, cam_bytes: bytes, padded: int, tile: int, extra=()):
    """Identity key for the cost-map cache, or None when uncacheable
    (scene arrays are tracers — render_pallas called under jit/grad,
    where host-side caching would leak tracers)."""
    if isinstance(scene.center, jax.core.Tracer):
        return None
    return (
        id(scene.center), id(scene.radius), scene.center.shape[0],
        cam_bytes, padded, tile, *extra,
    )


def _warm_cache_put(key, perm_inv, seed: int, sample_offset: int) -> None:
    _WORK_CACHE[key] = (perm_inv, seed, sample_offset)
    _WORK_CACHE.move_to_end(key)
    while len(_WORK_CACHE) > _WORK_CACHE_MAX:
        _WORK_CACHE.popitem(last=False)


def render_pallas(
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    tile: int = DEFAULT_TILE,
    spp: int | None = None,
    max_depth: int | None = None,
    interpret: bool | None = None,
    n_passes: int | None = None,
    budget: int | None = None,
    sample_offset: int = 0,
    work_hint: jnp.ndarray | None = None,
    return_work: bool = False,
    warm: bool = True,
    t_min: float = T_MIN_EPS,
):
    """Render the full image with the Pallas kernel -> [H, W, 3].

    `interpret` None picks from the default device's platform
    (`jax.default_device` when set, else JAX's first device;
    utils/platform.py): the interpreter on the CPU, the compiled Triton
    kernel on a GPU;
    True forces the Pallas interpreter.
    `n_passes`/`budget` tune tail compaction (see _multipass); the image
    is bit-identical for any setting — only lane scheduling changes.
    `sample_offset` starts the global sample streams at that index:
    rendering [0, k) then [k, k+n) and averaging equals one (k+n)-sample
    render (the progressive-checkpoint contract, utils/checkpoint.py).

    Warm-start scheduling (the default): the first render of a
    scene/camera/spp records its per-pixel cost map and caches the
    fully-cost-sorted lane permutation derived from it; every later
    render of the SAME (seed, sample window) applies that permutation
    and runs ONE uncompacted pass instead of the cold multi-pass
    compaction schedule, with a bit-identical image (the schedule is a
    pure lane permutation; see _WORK_CACHE). Renders of a DIFFERENT
    seed/sample window run the cold schedule and refresh the cache for
    their own realization. `warm=False` disables the cache entirely;
    passing `work_hint` explicitly (a prior `return_work=True` map,
    [H, W] or flat) overrides it and pays its sort per call. With any
    hint, `n_passes` defaults to 1; without one, DEFAULT_PASSES.

    `t_min` is the shadow-acne epsilon (reference: src/cpu/main.cc:19);
    runtime data, exposed for the negative-example test.
    """
    _check_tile(tile)
    if interpret is None:
        interpret = kernel_interpret(devices_platform())
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth
    w, h = cam.image_width, cam.image_height
    n_pixels = w * h
    padded = -(-n_pixels // tile) * tile

    cam_np = pack_camera(cam, t_min)
    cam_vec = jnp.asarray(cam_np)
    base = jnp.asarray([seed, sample_offset], jnp.int32)

    perm_inv = None  # [2, padded] i32 (lane permutation, inverse)
    cache_key = None
    if work_hint is not None:
        hint = jnp.zeros(padded, jnp.float32).at[:n_pixels].set(
            jnp.asarray(work_hint, jnp.float32).reshape(-1)[:n_pixels]
        )
        perm_inv = _perm_from_hint(hint).reshape(2, padded)
    elif warm:
        # spp is part of the key: a cost map measured at low spp is a
        # NOISY per-pixel estimate (~32% relative at 10 spp), and a
        # 100-spp render scheduled by a 10-spp-map permutation measured
        # 2x slower than one scheduled by its own map (tile max-of-sums
        # amplifies ordering errors as queues lengthen).
        cache_key = _warm_cache_key(
            scene, cam_np.tobytes(), padded, tile, extra=(spp,)
        )
        if cache_key is not None:
            perm_inv = _warm_cache_get(cache_key, seed, sample_offset)
    use_perm = perm_inv is not None
    if n_passes is None:
        n_passes = 1 if use_perm else DEFAULT_PASSES
    budget = _default_budget(spp) if budget is None else budget
    if isinstance(budget, (tuple, list)):
        budget = tuple(budget)  # lists are unhashable as jit statics
        if len(budget) < n_passes - 1:
            raise ValueError(
                f"budget schedule has {len(budget)} entries but "
                f"n_passes={n_passes} needs {n_passes - 1} budgeted passes"
            )
    fill_cache = cache_key is not None and not use_perm
    want_work = return_work or fill_cache

    out = _render_single_jit(
        scene, cam_vec, base,
        perm_inv if use_perm else jnp.zeros((2, 1), jnp.int32),
        tile=tile, spp=spp, max_depth=max_depth, budget=budget,
        n_passes=n_passes, interpret=interpret,
        n_pixels=n_pixels, padded=padded,
        use_perm=use_perm, with_work=want_work,
    )
    rad, work = out if want_work else (out, None)
    if fill_cache:
        # Once per (scene, realization): the full cost sort
        # (see _perm_from_hint).
        _warm_cache_put(
            cache_key, _perm_from_hint(work).reshape(2, padded),
            seed, sample_offset,
        )
    img = rad[:, :n_pixels]  # [3, n_pixels]
    img = jnp.transpose(img).reshape(h, w, 3)
    if return_work:
        return img, work[:n_pixels].reshape(h, w)
    return img


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "tile", "spp_local", "max_depth", "budget", "n_passes",
        "interpret", "n_pixels", "shard_pixels", "use_perm", "with_work",
    ),
)
def _render_dist_jit(
    scene, cam_vec, base, perm_inv, *, mesh, tile, spp_local, max_depth,
    budget, n_passes, interpret, n_pixels, shard_pixels,
    use_perm=False, with_work=False,
):
    """Mesh-sharded render as ONE jitted program, cached on
    (mesh, statics) at module level — a second call with a new seed or
    sample window re-traces NOTHING (see
    tests/test_pallas_dist.py::test_distributed_second_call_no_retrace).

    `base` = i32 [2] (seed, sample_offset), traced. `perm_inv` is the
    precomputed warm-start lane permutation + inverse in SLAB-LOCAL
    indices, [2, n_pix_shards, shard_pixels] (slabs are contiguous
    global pixel ranges), sharded over the pixel axis and replicated
    over the sample axis; each shard applies its own slab's permutation
    (scheduling is shard-local, so warm-start needs no collectives).
    With `with_work`, also returns the measured cost map
    [n_pix_shards * shard_pixels] (pmean over sample shards — their
    schedules may differ, the mean predicts all of them).
    """
    from jax.sharding import PartitionSpec as P

    from ray_tracing_in_one_weekend_tpu.parallel.dist import (
        PIXEL_AXIS,
        SAMPLE_AXIS,
    )

    n_pix_shards = mesh.shape[PIXEL_AXIS]
    pt_mat = pack_scene(scene).T
    n_live = live_slots(scene)
    # Per-pixel-shard slab offsets, replicated along the sample axis.
    offsets = (jnp.arange(n_pix_shards, dtype=jnp.int32) * shard_pixels)[:, None]

    def shard_fn(pt_mat, n_live, cam_vec, base, offset, perm_slab):
        s_idx = jax.lax.axis_index(SAMPLE_AXIS).astype(jnp.int32)
        scalars = _pass_scalars(
            base[0], offset[0, 0], s_idx * spp_local + base[1], n_live
        )
        sf, si = _init_state(offset[0, 0], shard_pixels, n_pixels, spp_local)
        out = _multipass(
            pt_mat, cam_vec, scalars, sf, si,
            tile, spp_local, max_depth, budget, n_passes, interpret,
            work_perm=(
                (perm_slab[0, 0], perm_slab[1, 0]) if use_perm else None
            ),
            with_work=with_work,
        )  # [3, shard_pixels], local-pixel order
        if with_work:
            rad, work = out
            return (
                jax.lax.pmean(rad, SAMPLE_AXIS),
                jax.lax.pmean(work, SAMPLE_AXIS),
            )
        return jax.lax.pmean(out, SAMPLE_AXIS)

    out_specs = (
        (P(None, PIXEL_AXIS), P(PIXEL_AXIS)) if with_work
        else P(None, PIXEL_AXIS)
    )
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(PIXEL_AXIS, None),
                  P(None, PIXEL_AXIS, None)),
        out_specs=out_specs,
        check_vma=False,
    )(pt_mat, n_live, cam_vec, base, offsets, perm_inv)  # [3, padded]


def render_pallas_distributed(
    scene: Scene,
    cam: Camera,
    seed: int = 0,
    mesh=None,
    tile: int = DEFAULT_TILE,
    spp: int | None = None,
    max_depth: int | None = None,
    interpret: bool | None = None,
    n_passes: int | None = None,
    budget: int | None = None,
    sample_offset: int = 0,
    work_hint: jnp.ndarray | None = None,
    return_work: bool = False,
    warm: bool = True,
    t_min: float = T_MIN_EPS,
):
    """Mesh-sharded Pallas render -> [H, W, 3].

    Pixel axis: each device runs the kernel grid over a contiguous,
    tile-aligned slab of the flat pixel space (lane state carries GLOBAL
    pixel ids, so streams and geometry are bit-identical to the
    single-chip kernel for any mesh). Sample axis: devices render
    disjoint slices of the spp budget (`sample_offset`) and psum-mean —
    the automated form of the reference's manual seed-merge workflow
    (reference: gallery/gpu/image11-source-images/). Tail compaction
    (_multipass) runs device-locally inside shard_map: compaction is a
    lane permutation within each shard's slab, so no collectives beyond
    the final pmean. The compiled program is cached on (mesh, statics);
    seed and sample_offset are traced data.

    Warm-start: same contract as `render_pallas` — auto by default via
    the module cost-map cache (keyed additionally on the mesh), or an
    explicit `work_hint` ([H, W] or flat per-pixel map; each shard
    takes its own slab slice). Bit-identical image either way.
    """
    from ray_tracing_in_one_weekend_tpu.parallel.dist import (
        PIXEL_AXIS,
        SAMPLE_AXIS,
        make_mesh,
    )

    if mesh is None:
        mesh = make_mesh()
    _check_tile(tile)
    if interpret is None:
        interpret = kernel_interpret(devices_platform(mesh.devices.flat))
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth

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
    shard_pixels = -(-n_pixels // (n_pix_shards * tile)) * tile
    total = n_pix_shards * shard_pixels

    cam_np = pack_camera(cam, t_min)
    cam_vec = jnp.asarray(cam_np)
    base = jnp.asarray([seed, sample_offset], jnp.int32)

    perm_inv = None  # [2, n_pix_shards, shard_pixels] slab-local
    cache_key = None
    if work_hint is not None:
        hint = jnp.zeros(total, jnp.float32).at[:n_pixels].set(
            jnp.asarray(work_hint, jnp.float32).reshape(-1)[:n_pixels]
        )
        perm_inv = _perm_from_hint(hint, n_slabs=n_pix_shards)
    elif warm:
        cache_key = _warm_cache_key(
            scene, cam_np.tobytes(), total, tile,
            extra=(spp, tuple(mesh.shape.items())),
        )
        if cache_key is not None:
            perm_inv = _warm_cache_get(cache_key, seed, sample_offset)
    use_perm = perm_inv is not None
    if n_passes is None:
        n_passes = 1 if use_perm else DEFAULT_PASSES
    budget = _default_budget(spp_local) if budget is None else budget
    fill_cache = cache_key is not None and not use_perm
    want_work = return_work or fill_cache

    out = _render_dist_jit(
        scene, cam_vec, base,
        perm_inv if use_perm else jnp.zeros((2, n_pix_shards, 1), jnp.int32),
        mesh=mesh, tile=tile, spp_local=spp_local, max_depth=max_depth,
        budget=budget, n_passes=n_passes, interpret=interpret,
        n_pixels=n_pixels, shard_pixels=shard_pixels,
        use_perm=use_perm, with_work=want_work,
    )
    rad, work = out if want_work else (out, None)
    if fill_cache:
        _warm_cache_put(
            cache_key, _perm_from_hint(work, n_slabs=n_pix_shards),
            seed, sample_offset,
        )
    img = rad[:, :n_pixels]
    img = jnp.transpose(img).reshape(h, w, 3)
    if return_work:
        return img, work[:n_pixels].reshape(h, w)
    return img
