"""Start-up proof on one NVIDIA GPU: the renderer's main path, its Triton
kernel compiled for the card, and the kernel checked against the
plain-JAX reference — in one process, in phases. Any failure raises and
exits non-zero; no phase catches its own failure.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the mesh path on four cards only

Phases (one card):

1. environment: the card's name and power limit, JAX, the device, the
   compile cache; no GPU -> exit non-zero with no result.
2. compile the kernel at the bench preset's lane buffer (1200x800),
   print its memory analysis, and check that the program holds the
   Triton custom call and no host callback (compiled, not interpreted).
3. numbers at the bench preset (1200x800x10 spp, depth 50): median
   Mrays/s over 3 timed renders after compile, compile seconds and peak
   device bytes, for the kernel cold and warm and for the jnp path.
4. kernel correctness on the card: (a) one raw pass compiled vs
   interpreted on the host CPU, (b) the kernel vs the jnp oracle on the
   cover scene at 1200x800x32 spp, (c) cold, warm and single-pass
   schedules give bit-identical images.
5. the main path: `utils.cli.main` at `--preset gpu --backend auto`
   (1920x1080, depth 50, 500 spp), its PPM checked.

With `--four-cards`: the kernel's and the jnp path's mesh renders on
(4,1) and (2,2) meshes at the gpu preset, each compared with the
one-card render on device 0, and the x1 -> x4 scaling.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)


def say(*a):
    print(*a, flush=True)


def median_time(fn, n=3):
    """Median wall seconds of `n` calls; `fn` must block on its result."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def timed_first(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_environment(jax, card):
    from ray_tracing_in_one_weekend_tpu.utils.platform import enable_compile_cache

    dev = jax.devices()[0]
    say(f"[env] card: {card}")
    say(f"[env] jax {jax.__version__}; device {dev.device_kind} "
        f"x{len(jax.devices())}; compile cache {enable_compile_cache()}")


def phase_compile(jax, jnp, tag):
    from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr
    from ray_tracing_in_one_weekend_tpu.utils.config import PRESETS, make_camera_from_config

    cam = make_camera_from_config(PRESETS["bench"])
    n = cam.image_width * cam.image_height
    tile = pr.DEFAULT_TILE
    padded = -(-n // tile) * tile
    t0 = time.perf_counter()
    lowered = pr._render_single_jit.trace(
        cover_scene(0), jnp.asarray(pr.pack_camera(cam)), jnp.zeros(2, jnp.int32),
        jnp.zeros((2, 1), jnp.int32), tile=tile, spp=10, max_depth=50,
        budget=pr._default_budget(10), n_passes=pr.DEFAULT_PASSES,
        interpret=False, n_pixels=n, padded=padded,
    ).lower()
    compiled = lowered.compile()
    say(f"[compile] {tag} kernel program for {cam.image_width}x{cam.image_height} "
        f"(P={padded} lanes, tile {tile}): {time.perf_counter() - t0:.2f}s")
    say(f"[compile] memory_analysis: {compiled.memory_analysis()}")
    text = lowered.as_text()
    n_triton = text.count("__gpu$xla.gpu.triton")
    callback = "callback" in text.lower() or "callback" in compiled.as_text().lower()
    say(f"[compile] Triton custom calls in the program: {n_triton}; host callback: {callback}")
    if n_triton == 0 or callback:
        raise RuntimeError("the kernel is not compiled through Triton")


def phase_numbers(jax, jnp, tag):
    from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import render_pallas
    from ray_tracing_in_one_weekend_tpu.ops.render import render_image
    from ray_tracing_in_one_weekend_tpu.utils.config import PRESETS, make_camera_from_config

    config = PRESETS["bench"]
    scene = cover_scene(config.seed)
    cam = make_camera_from_config(config)
    rays = config.rays_per_frame
    dev = jax.devices()[0]
    rows = (
        ("kernel cold", lambda: render_pallas(scene, cam, seed=0, warm=False), False),
        # A matched re-render runs the warm single pass under the cost map
        # that the scene's first (cold) render caches. That first render
        # runs untimed, so the compile+first figure is the warm program's.
        ("kernel warm", lambda: render_pallas(scene, cam, seed=0), True),
        ("jnp", lambda: render_image(scene, cam, 0), False),
    )
    out = {}
    for name, render, fill_cache in rows:
        def run():
            jax.block_until_ready(render())

        if fill_cache:
            run()
        first = timed_first(run)
        t = median_time(run)
        peak = dev.memory_stats().get("peak_bytes_in_use")
        out[name] = t
        say(f"[numbers] {tag} bench 1200x800x10spp {name}: {rays / t / 1e6:.2f} Mrays/s "
            f"(median {t * 1e3:.1f} ms of 3), compile+first {first:.2f}s, "
            f"process peak bytes in use {peak}")
    say(f"[numbers] {tag} kernel cold / jnp speedup: {out['jnp'] / out['kernel cold']:.1f}x")


def phase_correctness(jax, jnp, tag):
    from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
    from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import render_pallas
    from ray_tracing_in_one_weekend_tpu.ops.render import render_image
    from ray_tracing_in_one_weekend_tpu.utils import kernel_checks as kc

    scene = cover_scene(0)
    say("[correct] both renderers run in float32; the kernel has no matrix "
        "product and the jnp path's products ask for Precision.HIGHEST, so "
        "no TF32 product is involved")

    # (a) compiled vs interpreted, identical inputs.
    small = make_camera(image_width=64, aspect_ratio=2.0, samples_per_pixel=4, max_depth=8)
    block_mad, mean_diff = kc.compiled_vs_interpret(
        scene, small, jax.devices()[0], jax.devices("cpu")[0]
    )
    say(f"[correct] (a) raw pass compiled vs interpreted: 256-lane block MAD "
        f"{block_mad:.5f} (< {kc.MODE_BLOCK_MAD_TOL}), mean diff {mean_diff:.5f} "
        f"(< {kc.MODE_MEAN_DIFF_TOL}); libdevice vs CPU transcendental ulps "
        "make the two agree in distribution, not per lane")
    if not (block_mad < kc.MODE_BLOCK_MAD_TOL and mean_diff < kc.MODE_MEAN_DIFF_TOL):
        raise AssertionError("compiled kernel disagrees with the interpreter")

    # (b) kernel vs the jnp oracle.
    cam = make_camera(image_width=1200, samples_per_pixel=32)
    img_k = np.asarray(render_pallas(scene, cam, seed=0, warm=False))
    img_j = np.asarray(render_image(scene, cam, 0))
    means_k, means_j = img_k.mean(axis=(0, 1)), img_j.mean(axis=(0, 1))
    diff = np.abs(kc.block_means(img_k) - kc.block_means(img_j))
    say(f"[correct] (b) {tag} kernel vs jnp, cover 1200x800x32spp: channel means "
        f"{np.round(means_k, 5).tolist()} vs {np.round(means_j, 5).tolist()}; "
        f"16x16 block-mean MAD {diff.mean():.5f} (< {kc.ORACLE_BLOCK_MAD_TOL}), "
        f"p99.9 {np.percentile(diff, 99.9):.4f} (< {kc.ORACLE_BLOCK_P999_TOL}), "
        f"max {diff.max():.4f}, linear radiance")
    say("[correct] (b) tolerance: two independent Monte-Carlo streams (PCG vs "
        "threefry) agree in law; a geometry or material bug shifts whole "
        "blocks by more than 0.05")
    if not (np.isfinite(img_k).all() and np.abs(means_k - means_j).max() < kc.ORACLE_MEAN_TOL
            and diff.mean() < kc.ORACLE_BLOCK_MAD_TOL
            and np.percentile(diff, 99.9) < kc.ORACLE_BLOCK_P999_TOL):
        raise AssertionError("kernel disagrees with the jnp oracle")

    # (c) scheduling is bit-exact.
    cold3 = np.asarray(render_pallas(scene, cam, seed=1, warm=False))
    single = np.asarray(render_pallas(scene, cam, seed=1, warm=False, n_passes=1))
    render_pallas(scene, cam, seed=1)  # fills the warm cache
    warm = np.asarray(render_pallas(scene, cam, seed=1))
    same = np.array_equal(cold3, single) and np.array_equal(cold3, warm)
    say(f"[correct] (c) cold 3-pass, single-pass and warm schedules bit-identical: {same}")
    if not same:
        raise AssertionError("schedules changed the image")


def phase_main_path(jax, tag, out_dir):
    from ray_tracing_in_one_weekend_tpu.utils import cli, ppm
    from ray_tracing_in_one_weekend_tpu.utils.config import PRESETS
    from ray_tracing_in_one_weekend_tpu.utils.platform import devices_platform, resolve_backend

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "gpu.ppm")
    spp = PRESETS["gpu"].samples_per_pixel
    backend = resolve_backend("auto", devices_platform())
    say(f"[main] --backend auto picked: {backend}")
    argv = ["--preset", "gpu", "--backend", "auto", "--retries", "1", "--out", out]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    with open(out, "rb") as f:
        header = f.read(32).split(b"\n")[:3]
    img = ppm.read_ppm(out)
    say(f"[main] {tag} cli 1920x1080x{spp}spp depth 50: {wall:.1f}s wall incl "
        f"compile and PPM encode; header {header}; image {img.shape}; "
        f"u8 mean {img.mean():.2f} std {img.std():.2f}")
    # Every batch is checked finite by --retries (utils/resilient.py);
    # plausibility bounds of tests/test_golden_fullres.py.
    if header != [b"P3", b"1920 1080", b"255"] or img.shape != (1080, 1920, 3):
        raise AssertionError("bad PPM")
    if not (100 < img.mean() < 190 and img.std() > 40):
        raise AssertionError("implausible image statistics")


def phase_four_cards(jax, jnp, tag):
    from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
        render_pallas,
        render_pallas_distributed,
    )
    from ray_tracing_in_one_weekend_tpu.parallel import dist
    from ray_tracing_in_one_weekend_tpu.utils.config import PRESETS, make_camera_from_config

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have {len(jax.devices())}")
    scene = cover_scene(0)
    cam = make_camera_from_config(PRESETS["gpu"])
    rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    jnp_spp = 8
    say(f"[four] jnp path spp cut from 500 to {jnp_spp} (its one-card rate "
        "makes 500 spp minutes per render)")

    def kernel_one():
        with jax.default_device(jax.devices()[0]):
            return jax.block_until_ready(render_pallas(scene, cam, seed=0, warm=False))

    def jnp_one():
        with jax.default_device(jax.devices()[0]):
            return jax.block_until_ready(dist.render_image_distributed(
                scene, cam, 0, mesh=dist.make_mesh((1, 1)), spp=jnp_spp))

    ref_k = np.asarray(kernel_one())
    t_one = median_time(kernel_one)
    ref_j = np.asarray(jnp_one())
    say(f"[four] {tag} kernel one card {cam.image_width}x{cam.image_height}x"
        f"{cam.samples_per_pixel}spp: {rays / t_one / 1e6:.1f} Mrays/s "
        f"(median {t_one:.3f}s of 3)")
    for shape in ((4, 1), (2, 2)):
        mesh = dist.make_mesh(shape)

        def kernel_mesh():
            return jax.block_until_ready(
                render_pallas_distributed(scene, cam, seed=0, mesh=mesh, warm=False))

        img_k = np.asarray(kernel_mesh())
        t = median_time(kernel_mesh)
        img_j = np.asarray(dist.render_image_distributed(scene, cam, 0, mesh=mesh, spp=jnp_spp))
        dk = float(np.abs(img_k - ref_k).max())
        dj = float(np.abs(img_j - ref_j).max())
        say(f"[four] {tag} mesh {shape}: kernel {rays / t / 1e6:.1f} Mrays/s (median "
            f"{t:.3f}s), x1->x4 scaling {t_one / t:.2f}x ({100 * t_one / t / 4:.0f}% "
            f"efficiency); max |mesh - one card|: kernel {dk:.3g} "
            f"(bit-identical: {dk == 0.0}), jnp {dj:.3g} (bit-identical: {dj == 0.0})")
        # A sample axis > 1 averages per-shard means (pmean), which
        # re-associates the per-sample sum: float rounding only.
        if dk > 1e-5 or dj > 1e-5:
            raise AssertionError(f"mesh {shape} render differs from one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--out-dir", default=os.path.join(_HERE, "chiprun_out", "chip_smoke"),
                    help="where the main path writes its PPM")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    # The package comes from this file's directory, never the caller's:
    # a copy of this file alone fails here, on any platform.
    from ray_tracing_in_one_weekend_tpu.utils.platform import gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1

    card = gpu_name_and_power_limit()
    tag = f"[{card}]"
    phase_environment(jax, card)
    if args.four_cards:
        phase_four_cards(jax, jnp, tag)
        count = 4
    else:
        phase_compile(jax, jnp, tag)
        phase_numbers(jax, jnp, tag)
        phase_correctness(jax, jnp, tag)
        phase_main_path(jax, tag, args.out_dir)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
