"""Structure-of-arrays scene representation + scene generators.

The reference builds its world as heap objects behind virtual `hittable*`
/ `material*` pointers, constructed on-device by a single CUDA thread
(reference: src/gpu/main.cu:18-75, src/gpu/hittable_list.h:8-66). Virtual
dispatch has no array form, and data-dependent object counts break
XLA's static shapes — so the design here is:

* the scene is a pytree of flat arrays (SoA): centers, radii, material
  parameters and an integer material type, padded to a static,
  lane-aligned slot count (512 >= 488, a multiple of 128);
* material polymorphism becomes a masked select over `mat_type`
  (see ops/materials.py);
* the data-dependent sphere count of the cover scene (grid positions
  rejected near (4, 0.2, 0), reference: src/gpu/main.cu:42) becomes a
  static 484-slot grid with an `active` mask.

Because the scene is a pytree of plain arrays, it is trivially
replicable across a device mesh and fully differentiable: gradients flow
from pixels back to `center`, `radius`, `albedo`, `fuzz` and `ior`.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracing_in_one_weekend_tpu.utils.pytree import pytree_dataclass

# Material type codes (replaces virtual dispatch on material*,
# reference: src/gpu/material.h:10-16).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

# Cover scene: 1 ground + 22*22 grid + 3 heroes = 488; padded to 512, a
# power of two and a multiple of 128, so per-sphere axes tile evenly.
COVER_SCENE_SLOTS = 512


@pytree_dataclass
class Scene:
    """SoA sphere scene. All arrays share the leading slot axis [N]."""

    center: jnp.ndarray  # [N, 3]
    radius: jnp.ndarray  # [N]
    albedo: jnp.ndarray  # [N, 3] (lambertian/metal; unused for dielectric)
    fuzz: jnp.ndarray  # [N] (metal only; clamped to <= 1 at construction)
    ior: jnp.ndarray  # [N] (dielectric only)
    mat_type: jnp.ndarray  # [N] int32 in {0, 1, 2}
    active: jnp.ndarray  # [N] bool; padding / rejected slots are False

    @property
    def num_slots(self) -> int:
        return self.center.shape[0]

    @property
    def num_active(self) -> jnp.ndarray:
        return jnp.sum(self.active.astype(jnp.int32))


def from_spheres(
    centers: Sequence[Sequence[float]],
    radii: Sequence[float],
    mat_types: Sequence[int],
    albedos: Sequence[Sequence[float]] | None = None,
    fuzzes: Sequence[float] | None = None,
    iors: Sequence[float] | None = None,
    pad_to: int | None = None,
) -> Scene:
    """Build a Scene from per-sphere lists (test/bench convenience)."""
    n = len(radii)
    albedos = albedos if albedos is not None else [[1.0, 1.0, 1.0]] * n
    fuzzes = fuzzes if fuzzes is not None else [0.0] * n
    iors = iors if iors is not None else [1.5] * n

    pad = 0 if pad_to is None else max(0, pad_to - n)
    center = np.concatenate([np.asarray(centers, np.float32), np.zeros((pad, 3), np.float32)])
    radius = np.concatenate([np.asarray(radii, np.float32), np.ones(pad, np.float32)])
    albedo = np.concatenate([np.asarray(albedos, np.float32), np.zeros((pad, 3), np.float32)])
    fuzz = np.concatenate([np.asarray(fuzzes, np.float32), np.zeros(pad, np.float32)])
    ior = np.concatenate([np.asarray(iors, np.float32), np.ones(pad, np.float32)])
    mat_type = np.concatenate([np.asarray(mat_types, np.int32), np.zeros(pad, np.int32)])
    active = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])

    # Reference clamps metal fuzz to <= 1 at construction
    # (reference: src/gpu/material.h:44-45).
    fuzz = np.minimum(fuzz, 1.0)

    return Scene(
        center=jnp.asarray(center),
        radius=jnp.asarray(radius),
        albedo=jnp.asarray(albedo),
        fuzz=jnp.asarray(fuzz),
        ior=jnp.asarray(ior),
        mat_type=jnp.asarray(mat_type),
        active=jnp.asarray(active),
    )


def single_sphere_scene(pad_to: int | None = None) -> Scene:
    """One lambertian sphere in front of the camera + gradient sky —
    the minimum end-to-end slice (BASELINE.json configs[0]; the book's
    first render, reference: archive/listing9 era)."""
    return from_spheres(
        centers=[[0.0, 0.0, -1.0], [0.0, -100.5, -1.0]],
        radii=[0.5, 100.0],
        mat_types=[LAMBERTIAN, LAMBERTIAN],
        albedos=[[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
        pad_to=pad_to,
    )


def three_sphere_scene(pad_to: int | None = None) -> Scene:
    """Ground + lambertian / dielectric / metal trio — the
    metal+dielectric milestone scene (BASELINE.json configs[2];
    reference: archive/listing50 era)."""
    return from_spheres(
        centers=[
            [0.0, -100.5, -1.0],
            [0.0, 0.0, -1.0],
            [-1.0, 0.0, -1.0],
            [1.0, 0.0, -1.0],
        ],
        radii=[100.0, 0.5, 0.5, 0.5],
        mat_types=[LAMBERTIAN, LAMBERTIAN, DIELECTRIC, METAL],
        albedos=[
            [0.8, 0.8, 0.0],
            [0.1, 0.2, 0.5],
            [1.0, 1.0, 1.0],
            [0.8, 0.6, 0.2],
        ],
        fuzzes=[0.0, 0.0, 0.0, 0.0],
        iors=[1.5, 1.5, 1.5, 1.5],
        pad_to=pad_to,
    )


def cover_scene_reference(pad_to: int = COVER_SCENE_SLOTS) -> Scene:
    """The EXACT cover scene the reference CPU build renders.

    Replays `random_scene()` (reference: src/cpu/main.cc:32-76) draw for
    draw against a bit-exact std::mt19937(5489) +
    uniform_real_distribution<double> replica
    (utils/reference_rng.py) — same sphere centers, albedos, fuzz and
    material assignment as the committed golden image
    (tests/goldens/ref_cpu_cover_1200x800_500spp.png). Sphere order in
    the arrays matches the reference's world list: ground, accepted grid
    spheres, three heroes.
    """
    from ray_tracing_in_one_weekend_tpu.utils.reference_rng import ReferenceRandom

    rng = ReferenceRandom()
    centers = [[0.0, -1000.0, 0.0]]
    radii = [1000.0]
    mats = [LAMBERTIAN]
    albedos = [[0.5, 0.5, 0.5]]
    fuzzes = [0.0]
    iors = [1.5]

    # NOTE on draw order: C++ argument evaluation order is unspecified,
    # and g++ (which built the golden) evaluates call arguments
    # RIGHT-TO-LEFT. So in `point3(a + 0.9*rd(), 0.2, b + 0.9*rd())` the
    # z-offset is drawn BEFORE the x-offset, and `vec3::random()` draws
    # its components z,y,x. Verified empirically against a structurally
    # identical g++ program; a naive left-to-right replay produces a
    # visibly different sphere layout.
    def rand_vec3_rtl(lo=0.0, hi=1.0):
        z = rng.random_double(lo, hi)
        y = rng.random_double(lo, hi)
        x = rng.random_double(lo, hi)
        return (x, y, z)

    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random_double()
            cz = b + 0.9 * rng.random_double()  # drawn first (see NOTE)
            cx = a + 0.9 * rng.random_double()
            dx, dz = cx - 4.0, cz
            if (dx * dx + dz * dz) ** 0.5 > 0.9:
                if choose_mat < 0.8:
                    a1 = rand_vec3_rtl()
                    a2 = rand_vec3_rtl()
                    albedo = [a1[0] * a2[0], a1[1] * a2[1], a1[2] * a2[2]]
                    mats.append(LAMBERTIAN)
                    albedos.append(albedo)
                    fuzzes.append(0.0)
                elif choose_mat < 0.95:
                    albedo = list(rand_vec3_rtl(0.5, 1.0))
                    fuzz = rng.random_double(0.0, 0.5)
                    mats.append(METAL)
                    albedos.append(albedo)
                    fuzzes.append(fuzz)
                else:
                    mats.append(DIELECTRIC)
                    albedos.append([1.0, 1.0, 1.0])
                    fuzzes.append(0.0)
                centers.append([cx, 0.2, cz])
                radii.append(0.2)
                iors.append(1.5)

    for c, r, m, alb, fz in (
        ([0.0, 1.0, 0.0], 1.0, DIELECTRIC, [1.0, 1.0, 1.0], 0.0),
        ([-4.0, 1.0, 0.0], 1.0, LAMBERTIAN, [0.4, 0.2, 0.1], 0.0),
        ([4.0, 1.0, 0.0], 1.0, METAL, [0.7, 0.6, 0.5], 0.0),
    ):
        centers.append(c)
        radii.append(r)
        mats.append(m)
        albedos.append(alb)
        fuzzes.append(fz)
        iors.append(1.5)

    return from_spheres(
        centers=centers,
        radii=radii,
        mat_types=mats,
        albedos=albedos,
        fuzzes=fuzzes,
        iors=iors,
        pad_to=pad_to,
    )


def cover_scene(key: jax.Array | int = 0, pad_to: int = COVER_SCENE_SLOTS) -> Scene:
    """The 488-sphere "cover scene" (reference: src/gpu/main.cu:18-75,
    src/cpu/main.cc:32-76), generated with counter-based keys.

    Semantics reproduced exactly; RNG stream necessarily differs from the
    reference's mt19937/curand sequence (parity is statistical, not
    bitwise — SURVEY.md §7 hard part (c)):

    * ground: lambertian(0.5, 0.5, 0.5), r=1000 at (0, -1000, 0)
    * 22x22 grid over a, b in [-11, 11): center =
      (a + 0.9*U, 0.2, b + 0.9*U); slot INACTIVE when within 0.9 of
      (4, 0.2, 0) (reference: src/gpu/main.cu:42)
    * material mix: U < 0.8 -> lambertian(albedo = U3*U3 component
      product), U < 0.95 -> metal(albedo in [0.5, 1), fuzz in [0, 0.5)),
      else dielectric(1.5)
    * heroes: dielectric(1.5) r=1 at (0,1,0); lambertian(0.4,0.2,0.1)
      r=1 at (-4,1,0); metal((0.7,0.6,0.5), fuzz=0) r=1 at (4,1,0)

    The slot count is static (`pad_to`, default 512); rejected grid cells
    stay in the arrays with `active=False`, so the pytree structure never
    depends on the key.
    """
    if isinstance(key, int):
        key = jax.random.key(key)

    # --- 22x22 grid, one fold_in key per cell -------------------------------
    aa, bb = np.meshgrid(np.arange(-11, 11), np.arange(-11, 11), indexing="ij")
    a = jnp.asarray(aa.reshape(-1), jnp.float32)  # [484]
    b = jnp.asarray(bb.reshape(-1), jnp.float32)
    n_grid = a.shape[0]

    cell_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_grid))

    def per_cell(k):
        k_mat, k_ox, k_oz, k_a1, k_a2, k_fz = jax.random.split(k, 6)
        choose_mat = jax.random.uniform(k_mat, dtype=jnp.float32)
        off_x = jax.random.uniform(k_ox, dtype=jnp.float32)
        off_z = jax.random.uniform(k_oz, dtype=jnp.float32)
        lam_albedo = (
            jax.random.uniform(k_a1, (3,), dtype=jnp.float32)
            * jax.random.uniform(k_a2, (3,), dtype=jnp.float32)
        )
        metal_albedo = jax.random.uniform(k_a1, (3,), dtype=jnp.float32, minval=0.5, maxval=1.0)
        fuzz = jax.random.uniform(k_fz, dtype=jnp.float32, maxval=0.5)
        return choose_mat, off_x, off_z, lam_albedo, metal_albedo, fuzz

    choose_mat, off_x, off_z, lam_albedo, metal_albedo, fuzz = jax.vmap(per_cell)(cell_keys)

    grid_center = jnp.stack(
        [a + 0.9 * off_x, jnp.full_like(a, 0.2), b + 0.9 * off_z], axis=-1
    )
    dist = jnp.linalg.norm(grid_center - jnp.asarray([4.0, 0.2, 0.0]), axis=-1)
    grid_active = dist > 0.9

    is_lam = choose_mat < 0.8
    is_metal = (choose_mat >= 0.8) & (choose_mat < 0.95)
    grid_mat = jnp.where(is_lam, LAMBERTIAN, jnp.where(is_metal, METAL, DIELECTRIC)).astype(
        jnp.int32
    )
    grid_albedo = jnp.where(is_lam[:, None], lam_albedo, metal_albedo)
    grid_fuzz = jnp.where(is_metal, fuzz, 0.0)
    grid_radius = jnp.full((n_grid,), 0.2, jnp.float32)
    grid_ior = jnp.full((n_grid,), 1.5, jnp.float32)

    # --- fixed spheres: ground + heroes -------------------------------------
    fixed_center = jnp.asarray(
        [[0.0, -1000.0, 0.0], [0.0, 1.0, 0.0], [-4.0, 1.0, 0.0], [4.0, 1.0, 0.0]],
        jnp.float32,
    )
    fixed_radius = jnp.asarray([1000.0, 1.0, 1.0, 1.0], jnp.float32)
    fixed_albedo = jnp.asarray(
        [[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]], jnp.float32
    )
    fixed_mat = jnp.asarray([LAMBERTIAN, DIELECTRIC, LAMBERTIAN, METAL], jnp.int32)
    fixed_fuzz = jnp.zeros(4, jnp.float32)
    fixed_ior = jnp.full((4,), 1.5, jnp.float32)
    fixed_active = jnp.ones(4, bool)

    n_total = 4 + n_grid
    pad = max(0, pad_to - n_total)

    def cat(fixed, grid, pad_value):
        pad_shape = (pad, *fixed.shape[1:])
        return jnp.concatenate(
            [fixed, grid, jnp.full(pad_shape, pad_value, fixed.dtype)], axis=0
        )

    return Scene(
        center=cat(fixed_center, grid_center, 0.0),
        radius=cat(fixed_radius, grid_radius, 1.0),  # pad radius 1: keeps 1/r grad-safe
        albedo=cat(fixed_albedo, grid_albedo, 0.0),
        fuzz=cat(fixed_fuzz, grid_fuzz, 0.0),
        ior=cat(fixed_ior, grid_ior, 1.0),
        mat_type=cat(fixed_mat, grid_mat.astype(jnp.int32), 0),
        active=cat(fixed_active, grid_active, False),
    )
