"""Pallas render kernel vs the pure-jnp oracle (interpret mode on CPU).

The kernel's PCG sample streams differ from the jnp path's threefry
streams, so agreement is statistical: per-channel image means converge
to the same values, and per-pixel differences stay within Monte-Carlo
noise at the test spp. Geometry-deterministic scenes (fuzz-0 metal
mirror, sky-only) agree to float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
    live_slots,
    pack_scene,
    render_pallas,
)
from ray_tracing_in_one_weekend_tpu.ops.render import render

KEY = jax.random.key(0)


def _cam(width=32, spp=8, **kw):
    kw.setdefault("aspect_ratio", 2.0)
    kw.setdefault("lookfrom", (0.0, 0.0, 0.0))
    kw.setdefault("lookat", (0.0, 0.0, -1.0))
    kw.setdefault("vfov_degrees", 90.0)
    kw.setdefault("defocus_angle_degrees", 0.0)
    kw.setdefault("focus_dist", 1.0)
    kw.setdefault("max_depth", 6)
    return make_camera(image_width=width, samples_per_pixel=spp, **kw)


def test_pack_scene_layout():
    sc = scene_lib.three_sphere_scene(pad_to=128)
    p = np.asarray(pack_scene(sc))
    assert p.shape == (16, 128)
    np.testing.assert_allclose(p[0:3, 1], [0.0, 0.0, -1.0])  # center sphere
    act = p[11].astype(bool)
    np.testing.assert_allclose(p[4, act], p[3, act] ** 2)  # r^2 row
    # padding slots are analytically unhittable: center 0, r^2 = -1
    np.testing.assert_allclose(p[4, ~act], -1.0)
    np.testing.assert_allclose(p[0:3, ~act], 0.0)
    assert p[11, :4].sum() == 4.0 and p[11, 4:].sum() == 0.0  # active mask
    np.testing.assert_array_equal(p[12:16], 0.0)  # pad rows
    assert int(live_slots(sc)) == 4  # the sphere loop stops at slot 4


def test_sky_only_matches_exactly():
    """No spheres -> no RNG influence on radiance; paths agree to float
    tolerance (both compute the same deterministic sky gradient; jitter
    wiggles the direction but 1 pixel of 16x8 at 16spp averages out)."""
    sc = scene_lib.single_sphere_scene(pad_to=128)
    sc = sc.replace(active=jnp.zeros_like(sc.active))
    cam = _cam(width=16, spp=16)
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=128))
    assert np.abs(img_p - img_j).max() < 0.02  # jitter-noise tolerance
    np.testing.assert_allclose(img_p[..., 2], 1.0, atol=0.02)  # blue channel


def test_single_sphere_statistical_parity():
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=32)
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    # channel means agree well below the per-pixel noise floor
    np.testing.assert_allclose(
        img_p.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), atol=0.01
    )
    assert np.abs(img_p - img_j).mean() < 0.03


def test_three_sphere_materials_parity():
    """Metal + dielectric + lambertian trio: material code agreement."""
    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=32, lookfrom=(0.0, 0.0, 0.5), focus_dist=1.5)
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    np.testing.assert_allclose(
        img_p.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), atol=0.015
    )


def test_seed_changes_noise_not_signal():
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=16, spp=8)
    a = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))
    b = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))
    np.testing.assert_array_equal(a, b)  # deterministic given seed
    c = np.asarray(render_pallas(sc, cam, seed=1, tile=128, interpret=True))
    assert np.abs(a - c).max() > 1e-4  # different noise
    np.testing.assert_allclose(
        a.mean(axis=(0, 1)), c.mean(axis=(0, 1)), atol=0.02
    )  # same signal


def test_tile_layout_invariance():
    """Tile size changes the grid decomposition but not pixel streams
    (streams key on GLOBAL pixel index)."""
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=4)
    a = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))
    b = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_tail_compaction_bit_identical():
    """The budgeted/compacted schedule only reorders lane work; radiance
    per (pixel, sample) is keyed by global ids, so any (n_passes, budget)
    gives the bit-identical image."""
    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=8, lookfrom=(0.0, 0.0, 0.5), focus_dist=1.5)
    base = np.asarray(
        render_pallas(sc, cam, seed=0, tile=128, interpret=True, n_passes=1)
    )
    # A tiny budget forces real compaction work across all passes.
    compacted = np.asarray(
        render_pallas(
            sc, cam, seed=0, tile=128, interpret=True, n_passes=4, budget=3
        )
    )
    np.testing.assert_array_equal(base, compacted)


def test_hollow_glass_negative_radius_parity():
    """The book's hollow-glass trick: a dielectric sphere with NEGATIVE
    radius nested inside a positive one flips the outward normal inward
    via (p - c) / radius (reference: src/gpu/sphere.h:40-42). The kernel
    must honour the radius sign like the jnp path does."""
    sc = scene_lib.from_spheres(
        centers=[[0, -100.5, -1], [0, 0, -1], [0, 0, -1], [-1, 0, -1], [1, 0, -1]],
        radii=[100.0, 0.5, -0.45, 0.5, 0.5],
        mat_types=[0, 2, 2, 0, 1],
        albedos=[[0.8, 0.8, 0.0], [1, 1, 1], [1, 1, 1], [0.1, 0.2, 0.5], [0.8, 0.6, 0.2]],
        pad_to=128,
    )
    cam = _cam(width=32, spp=24, max_depth=16)
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    assert np.isfinite(img_p).all()
    np.testing.assert_allclose(
        img_p.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), atol=0.015
    )
    # The hollow shell must actually transmit: the sphere's silhouette
    # region is not black (a broken inward normal absorbs/darkens it).
    h, w = img_p.shape[:2]
    assert img_p[h // 2, w // 2].mean() > 0.1


def test_defocus_blur_pallas():
    sc = scene_lib.single_sphere_scene(pad_to=128)
    sharp_cam = _cam(width=32, spp=64, defocus_angle_degrees=0.0, focus_dist=1.0)
    blur_cam = _cam(width=32, spp=64, defocus_angle_degrees=20.0, focus_dist=3.0)
    sharp = np.asarray(render_pallas(sc, sharp_cam, seed=0, tile=256, interpret=True))
    blur = np.asarray(render_pallas(sc, blur_cam, seed=0, tile=256, interpret=True))

    def hgrad(img):
        return np.abs(np.diff(img, axis=1))

    assert hgrad(blur).max() < hgrad(sharp).max()


# ---------------------------------------------------------------------------
# Deterministic per-material probes (round-3): paths constructed so the
# material's RNG draw is irrelevant, giving CLOSED-FORM expected radiance
# both backends must hit to ~1e-3 — a few-percent single-material
# radiance bug cannot hide inside Monte-Carlo noise here.
# ---------------------------------------------------------------------------


def _sky(d):
    """Closed-form sky gradient (reference: src/gpu/camera.h:118-124)."""
    d = np.asarray(d, np.float64)
    d = d / np.linalg.norm(d)
    a = 0.5 * (d[1] + 1.0)
    return (1.0 - a) * np.array([1.0, 1.0, 1.0]) + a * np.array([0.5, 0.7, 1.0])


def _pixel_dir(cam, px, py):
    """Mean (jitter-free) camera ray direction of pixel (px, py)."""
    p = (
        np.asarray(cam.pixel00_loc)
        + px * np.asarray(cam.pixel_delta_u)
        + py * np.asarray(cam.pixel_delta_v)
    )
    d = p - np.asarray(cam.center)
    return d / np.linalg.norm(d)


def test_fuzz0_mirror_probe():
    """Fuzz-0 metal scatter is DETERMINISTIC (reflect only): radiance =
    albedo * sky(reflect(d)). The only randomness left is the +-0.5px
    jitter, which averages out over spp on the smooth sky. Checks both
    backends against the closed form and against each other, per pixel."""
    albedo = np.array([0.8, 0.6, 0.2])
    sc = scene_lib.from_spheres(
        centers=[[0.0, 0.0, -3.0]],
        radii=[1.0],
        mat_types=[1],
        albedos=[albedo.tolist()],
        fuzzes=[0.0],
        pad_to=128,
    )
    cam = _cam(width=32, spp=64, vfov_degrees=20.0, lookat=(0, 0, -3.0))
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    h, w = img_p.shape[:2]
    cx, cy = w // 2, h // 2
    # Closed form at the central pixel: head-on hit at (0,0,-2),
    # normal (0,0,1), reflect sends the ray straight back -> sky(+z).
    d = _pixel_dir(cam, cx, cy)
    t_hit = -np.dot(d, [0, 0, 1]) * 3.0 - np.sqrt(
        (np.dot(d, [0, 0, 1]) * 3.0) ** 2 - 9.0 + 1.0
    )
    p_hit = t_hit * d + np.asarray(cam.center)
    n = p_hit - np.array([0.0, 0.0, -3.0])
    n /= np.linalg.norm(n)
    refl = d - 2 * np.dot(d, n) * n
    expected = albedo * _sky(refl)
    for img, name in ((img_p, "pallas"), (img_j, "jnp")):
        np.testing.assert_allclose(
            img[cy, cx], expected, atol=3e-3,
            err_msg=f"{name} center-pixel mirror radiance",
        )
    # Per-pixel agreement across the whole sphere interior (a 5x5 block
    # around the center is safely inside the silhouette).
    np.testing.assert_allclose(
        img_p[cy - 2 : cy + 3, cx - 2 : cx + 3],
        img_j[cy - 2 : cy + 3, cx - 2 : cx + 3],
        atol=3e-3,
    )


def test_ior1_dielectric_passthrough_probe():
    """A dielectric with ior=1 bends nothing and (away from grazing)
    Schlick reflectance is ~(1-cos)^5 < 1e-8, so EVERY sample refracts
    straight through: glass is invisible and radiance = sky(d) exactly.
    Exercises the full refract/Schlick/TIR code path deterministically."""
    sc = scene_lib.from_spheres(
        centers=[[0.0, 0.0, -10.0]],
        radii=[1.0],
        mat_types=[2],
        albedos=[[1.0, 1.0, 1.0]],
        iors=[1.0],
        pad_to=128,
    )
    # vfov small: the sphere subtends ~11 deg, central rays hit with
    # cos(theta) > 0.97.
    cam = _cam(width=32, spp=32, vfov_degrees=8.0, lookat=(0, 0, -10.0), max_depth=8)
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    h, w = img_p.shape[:2]
    cy, cx = h // 2, w // 2
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            expected = _sky(_pixel_dir(cam, cx + dx, cy + dy))
            np.testing.assert_allclose(
                img_p[cy + dy, cx + dx], expected, atol=3e-3,
                err_msg="pallas ior=1 passthrough",
            )
            np.testing.assert_allclose(
                img_j[cy + dy, cx + dx], expected, atol=3e-3,
                err_msg="jnp ior=1 passthrough",
            )


def test_black_lambertian_absorbs_exactly():
    """albedo=0 lambertian: the first bounce zeroes the attenuation, so
    every path through the sphere contributes EXACTLY 0 — bit-exact in
    both backends regardless of RNG."""
    sc = scene_lib.from_spheres(
        centers=[[0.0, 0.0, -3.0]],
        radii=[1.0],
        mat_types=[0],
        albedos=[[0.0, 0.0, 0.0]],
        pad_to=128,
    )
    cam = _cam(width=32, spp=8, vfov_degrees=20.0, lookat=(0, 0, -3.0))
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    h, w = img_p.shape[:2]
    cy, cx = h // 2, w // 2
    assert np.all(img_p[cy - 3 : cy + 4, cx - 3 : cx + 4] == 0.0)
    assert np.all(img_j[cy - 3 : cy + 4, cx - 3 : cx + 4] == 0.0)


def test_closest_hit_negative_disc_is_miss():
    """Closest-so-far sweep at the unit level, on the Triton route in
    interpret mode: rays with a negative discriminant against every
    sphere (pointing away) — and every padding slot, whose r^2 = -1
    makes disc <= -1 for ANY unit ray — come out T_MISS with slot 0, and
    a head-on ray hits at the analytic root."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
        T_MISS,
        _closest_hit,
    )

    sc = scene_lib.single_sphere_scene(pad_to=128)  # sphere (0,0,-1) r=0.5
    pt = pack_scene(sc).T
    n = pt.shape[0]
    tile = 128

    # Lane 0: straight up (misses). Lane 1: straight back (+z, misses).
    # Lane 2: head-on at the sphere (hits, t = 0.5). Rest: +x, misses.
    d = np.zeros((3, tile), np.float32)
    d[1, 0] = 1.0
    d[2, 1] = 1.0
    d[2, 2] = -1.0
    d[0, 3:] = 1.0

    def kernel(pt_ref, d_ref, t_ref, k_ref):
        o = tuple(jnp.zeros((tile,), jnp.float32) for _ in range(3))
        dd = (d_ref[0, :], d_ref[1, :], d_ref[2, :])
        t, k = _closest_hit(o, dd, pt_ref, n, 1e-3)
        t_ref[...] = t
        k_ref[...] = k

    t, k = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((tile,), jnp.float32),
                   jax.ShapeDtypeStruct((tile,), jnp.int32)],
        compiler_params=pl_triton.CompilerParams(num_warps=4),
        interpret=True,
    )(pt, jnp.asarray(d))
    t, k = np.asarray(t), np.asarray(k)
    assert np.all(np.isfinite(t)), "NaNs must not escape the sweep"
    miss = np.ones(tile, bool)
    miss[2] = False
    assert np.all(t[miss] == T_MISS) and np.all(k[miss] == 0)
    np.testing.assert_allclose(t[2], 0.5, rtol=1e-6)
    assert k[2] == 0


def test_closest_hit_keeps_first_of_equal_roots():
    """Two identical spheres: the strict `t < t_best` keeps the first
    slot, as the reference's shrinking closest_so_far interval does."""
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import _closest_hit

    sc = scene_lib.from_spheres(
        centers=[[0, 0, -2], [0, 0, -2], [0, 0, -5]], radii=[0.5, 0.5, 1.0],
        mat_types=[0, 1, 0], pad_to=128,
    )
    pt = pack_scene(sc).T
    o = (jnp.zeros(4), jnp.zeros(4), jnp.zeros(4))
    d = (jnp.zeros(4), jnp.zeros(4), -jnp.ones(4))
    t, k = _closest_hit(o, d, pt, 3, 1e-3)
    np.testing.assert_allclose(np.asarray(t), 1.5, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(k), 0)


def test_budget_schedule_tuple_bit_identical():
    """Per-pass budget schedules (tuples) are pure scheduling: any
    schedule must produce the bit-identical image to a uniform budget
    (the compaction/scheduling no-op contract of _multipass)."""
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=16, spp=4)
    a = np.asarray(render_pallas(
        sc, cam, seed=0, tile=128, budget=6, n_passes=3, interpret=True))
    b = np.asarray(render_pallas(
        sc, cam, seed=0, tile=128, budget=(9, 3), n_passes=3, interpret=True))
    assert np.array_equal(a, b)

    with pytest.raises(ValueError, match="budget schedule"):
        render_pallas(sc, cam, seed=0, tile=128, budget=(6,), n_passes=3,
                      interpret=True)


def test_warm_start_hint_bit_identical_and_checkpoint_carry():
    """Warm-start scheduling (`work_hint` / `return_work`) is pure
    scheduling: any hint — the real cost map, a random one — yields the
    bit-identical image, with n_passes auto-dropping to 1. The
    checkpoint accumulator carries the map across batches, so batched
    warm accumulation equals the cold monolithic render bit for bit."""
    from ray_tracing_in_one_weekend_tpu.utils import checkpoint as ckpt

    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=8)
    base = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))

    img, work = render_pallas(sc, cam, seed=0, tile=128, interpret=True,
                              return_work=True)
    assert np.array_equal(np.asarray(img), base)
    work = np.asarray(work)
    assert work.shape == (cam.image_height, cam.image_width)
    assert work.min() >= 1.0  # every pixel ran >= spp iterations / spp

    warm = render_pallas(sc, cam, seed=0, tile=128, interpret=True,
                         work_hint=work)
    assert np.array_equal(np.asarray(warm), base)
    rnd = np.random.default_rng(1).uniform(0, 40, work.shape).astype(np.float32)
    warm2 = render_pallas(sc, cam, seed=0, tile=128, interpret=True,
                          work_hint=rnd)
    assert np.array_equal(np.asarray(warm2), base)

    # Checkpoint path: batch 1 cold, batches 2+ warm via the carried map.
    state = ckpt.new_state(cam)
    for n in (3, 3, 2):
        state = ckpt.accumulate(state, sc, cam, 0, n, backend="pallas",
                                tile=128, interpret=True)
        if n == 3:
            assert state.work is not None
    np.testing.assert_allclose(np.asarray(state.image), base, atol=2e-7)


def test_auto_warm_start_bit_identical():
    """Auto warm-start (the default): the first render of a scene/camera
    populates the module cost-map cache, every later render runs the
    warm single-pass schedule — and the image is BITWISE identical to a
    cold render (the VERDICT r4 item-1 contract: the hint is a pure
    lane permutation)."""
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=8)
    cold = np.asarray(render_pallas(sc, cam, seed=3, tile=128,
                                    interpret=True, warm=False))

    pr._WORK_CACHE.clear()
    first = np.asarray(render_pallas(sc, cam, seed=3, tile=128, interpret=True))
    assert len(pr._WORK_CACHE) == 1, "first render must populate the cache"
    second = np.asarray(render_pallas(sc, cam, seed=3, tile=128, interpret=True))
    assert np.array_equal(cold, first)
    assert np.array_equal(cold, second)

    # A different seed MISMATCHES the fill realization: it runs the
    # cold schedule (measured faster than a stale permutation at every
    # spp — the _WORK_CACHE policy) and refreshes the entry in place.
    cold5 = np.asarray(render_pallas(sc, cam, seed=5, tile=128,
                                     interpret=True, warm=False))
    warm5 = np.asarray(render_pallas(sc, cam, seed=5, tile=128, interpret=True))
    assert np.array_equal(cold5, warm5)
    assert len(pr._WORK_CACHE) == 1
    assert pr._WORK_CACHE[next(iter(pr._WORK_CACHE))][1] == 5  # refilled
    # ...and the refreshed fill serves seed 5's matched re-render.
    warm5b = np.asarray(render_pallas(sc, cam, seed=5, tile=128, interpret=True))
    assert np.array_equal(cold5, warm5b)


def test_auto_warm_start_distributed_bit_identical():
    """Auto warm-start on a mesh: the sharded render carries per-slab
    cost maps through the same module cache; warm sharded output equals
    both the cold sharded and the single-chip render."""
    from ray_tracing_in_one_weekend_tpu.parallel.dist import make_mesh

    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
        render_pallas_distributed,
    )

    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=8)
    mesh = make_mesh((4, 2))
    cold = np.asarray(render_pallas_distributed(
        sc, cam, seed=0, mesh=mesh, tile=128, interpret=True, warm=False))
    first = np.asarray(render_pallas_distributed(
        sc, cam, seed=0, mesh=mesh, tile=128, interpret=True))
    warm = np.asarray(render_pallas_distributed(
        sc, cam, seed=0, mesh=mesh, tile=128, interpret=True))
    assert np.array_equal(cold, first)
    assert np.array_equal(cold, warm)


def test_checkpoint_warm_carry_distributed():
    """The checkpoint accumulator's warm-start carry now covers meshes
    (VERDICT r4 item 4): batched sharded accumulation — batch 1 cold,
    batches 2+ warm from the carried [H, W] map — matches the cold
    monolithic single-chip render."""
    from ray_tracing_in_one_weekend_tpu.parallel.dist import make_mesh
    from ray_tracing_in_one_weekend_tpu.utils import checkpoint as ckpt

    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=32, spp=8)
    base = np.asarray(render_pallas(sc, cam, seed=0, tile=128,
                                    interpret=True, warm=False))
    mesh = make_mesh((4, 2))
    state = ckpt.new_state(cam)
    for n in (4, 4):
        state = ckpt.accumulate(state, sc, cam, 0, n, backend="pallas",
                                mesh=mesh, tile=128, interpret=True)
        assert state.work is not None
        assert state.work.shape == (cam.image_height, cam.image_width)
    np.testing.assert_allclose(np.asarray(state.image), base, atol=1e-6)


def test_tile_validation():
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=16, spp=2)
    with pytest.raises(ValueError, match="multiple of 128"):
        render_pallas(sc, cam, tile=100, interpret=True)


def test_shadow_acne_negative_example():
    """The reference commits gallery/cpu/shadow-acne-example.png to
    document what happens WITHOUT the t_min=1e-3 epsilon
    (reference: src/cpu/main.cc:19): scattered rays re-hit their own
    sphere at t ~ float-rounding distance and the image breaks into
    dark speckle. Rendering with the epsilon disabled must reproduce
    that failure — a large divergence from the correct image, biased
    DARK (false self-hits absorb instead of escaping to the sky). If
    this test fails, the epsilon has silently stopped mattering."""
    sc = scene_lib.three_sphere_scene(pad_to=128)
    cam = _cam(width=48, spp=8)
    good = np.asarray(render_pallas(sc, cam, seed=0, tile=128,
                                    interpret=True, warm=False))
    acne = np.asarray(render_pallas(sc, cam, seed=0, tile=128,
                                    interpret=True, warm=False, t_min=0.0))
    diff = np.abs(acne - good).mean()
    assert diff > 0.02, (
        f"disabling the shadow-acne epsilon changed the image by only "
        f"{diff:.4f} — the t_min epsilon no longer matters"
    )
    assert acne.mean() < good.mean() - 0.01, (
        "shadow acne must darken the image (absorbed self-hits)"
    )


def test_perm_from_hint_is_slab_local_permutation():
    """The warm-schedule sort: a valid permutation + exact inverse,
    computed slab-locally (distributed lanes never cross shards), with
    zero-cost lanes sunk to each slab's tail."""
    import jax

    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
        _perm_from_hint,
    )

    hint = jax.random.uniform(jax.random.key(0), (512,)) * 10.0
    hint = hint.at[100:140].set(0.0)  # dead lanes
    for n_slabs in (1, 4):
        out = np.asarray(_perm_from_hint(hint, n_slabs=n_slabs))
        assert out.shape == (2, n_slabs, 512 // n_slabs)
        h = np.asarray(hint).reshape(n_slabs, -1)
        for s in range(n_slabs):
            perm, inv = out[0, s], out[1, s]
            n = perm.shape[0]
            assert sorted(perm) == list(range(n)), "not a permutation"
            assert np.array_equal(perm[inv], np.arange(n)), "inverse wrong"
            sorted_cost = h[s][perm]
            assert np.all(np.diff(sorted_cost) <= 1e-6), "not descending"


def test_warm_cache_eviction_bound():
    """The schedule cache is bounded: rendering more distinct
    (scene, camera, spp) combinations than _WORK_CACHE_MAX evicts the
    oldest entries instead of growing without bound."""
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=16, spp=2)
    pr._WORK_CACHE.clear()
    for spp in range(1, pr._WORK_CACHE_MAX + 4):
        render_pallas(sc, cam, seed=0, tile=128, spp=spp, interpret=True)
    assert len(pr._WORK_CACHE) == pr._WORK_CACHE_MAX


# ---------------------------------------------------------------------------
# The Triton-route wrapper: tile/padding/scalar shapes, lowering for CUDA,
# per-material parity with the jnp oracle.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile, ok", [
    (128, True), (256, True), (1024, True),
    (64, False), (100, False), (384, False), (0, False),
])
def test_check_tile_power_of_two_multiple_of_128(tile, ok):
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import _check_tile

    if ok:
        _check_tile(tile)
    else:
        with pytest.raises(ValueError, match="power of two"):
            _check_tile(tile)


def test_kernel_input_shapes_are_triton_blocks():
    """Every block the kernel loads as a vector is a power of two; the
    camera vector is padded to one."""
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    cam = _cam(width=24, spp=2)
    v = pr.pack_camera(cam)
    assert v.shape == (pr.CAM_LEN,) and pr.CAM_LEN == 32
    assert v[19] == 24.0 and v[20] == np.float32(pr.T_MIN_EPS)
    np.testing.assert_array_equal(v[21:], 0.0)
    s = np.asarray(pr._pass_scalars(3, 0, 7, 4))
    assert s.shape == (pr.N_SCALARS,) and s.dtype == np.int32
    assert list(s[:5]) == [3, 0, 7, 0, 4]
    for rows in (pr.SF_ROWS, pr.SI_ROWS, pr.P_ROWS, pr.N_SCALARS):
        assert rows & (rows - 1) == 0
    assert pr._num_warps(128) == 4 and pr._num_warps(512) == 8


def test_lanes_pad_to_whole_tiles_and_dead_lanes_finish():
    """Lane buffers pad the pixel count to whole tiles; pad lanes are
    born finished and never change the image."""
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    sf, si = pr._init_state(0, 256, 200, 4)
    assert sf.shape == (pr.SF_ROWS, 256) and si.shape == (pr.SI_ROWS, 256)
    started = np.asarray(si[pr._SI_STARTED])
    assert np.all(started[:200] == 0) and np.all(started[200:] == 4)
    np.testing.assert_array_equal(np.asarray(si[pr._SI_PIX]), np.arange(256))
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(width=20, spp=2)  # 200 pixels: 56 pad lanes at tile 128
    img = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))
    assert img.shape == (10, 20, 3) and np.isfinite(img).all()


def test_kernel_lowers_to_triton_for_cuda():
    """Cross-platform lowering of the whole render program for CUDA: the
    kernel becomes Triton custom calls, one per pass, with no host
    callback (the compiled path never falls back to the interpreter)."""
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    sc = scene_lib.cover_scene(0)
    cam = _cam(width=64, spp=4)
    n = cam.image_width * cam.image_height
    text = pr._render_single_jit.trace(
        sc, jnp.asarray(pr.pack_camera(cam)), jnp.zeros(2, jnp.int32),
        jnp.zeros((2, 1), jnp.int32), tile=128, spp=4, max_depth=8,
        budget=12, n_passes=3, interpret=False, n_pixels=n, padded=2048,
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 3
    assert "callback" not in text.lower()


@pytest.mark.parametrize("mat, kw", [
    (0, dict(albedos=[[0.7, 0.3, 0.2]])),
    (1, dict(albedos=[[0.8, 0.6, 0.2]], fuzzes=[0.3])),
    (2, dict(iors=[1.5])),
], ids=["lambertian", "metal", "dielectric"])
def test_material_parity_with_jnp(mat, kw):
    """One sphere of each material over a diffuse ground: the Triton-
    route kernel (interpreted) and the jnp oracle agree in channel means
    and 4x4 block means (independent streams, so within MC noise)."""
    sc = scene_lib.from_spheres(
        centers=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0]], radii=[100.0, 0.5],
        mat_types=[0, mat],
        albedos=[[0.5, 0.5, 0.5], kw.pop("albedos", [[1.0, 1.0, 1.0]])[0]],
        fuzzes=[0.0, *kw.pop("fuzzes", [0.0])],
        iors=[1.5, *kw.pop("iors", [1.5])],
        pad_to=128,
    )
    cam = _cam(width=32, spp=32)
    img_p = np.asarray(render_pallas(sc, cam, seed=0, tile=256, interpret=True))
    img_j = np.asarray(render(sc, cam, KEY, chunk_size=512))
    np.testing.assert_allclose(
        img_p.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), atol=0.015
    )
    blocks = lambda x: x.reshape(4, 4, 8, 4, 3).mean(axis=(1, 3))  # noqa: E731
    assert np.abs(blocks(img_p) - blocks(img_j)).mean() < 0.03
