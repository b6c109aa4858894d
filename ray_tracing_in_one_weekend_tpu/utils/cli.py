"""Command-line renderer.

The reference has no flags at all — every parameter is a compile-time
constant and the CLI contract is `./main > out.ppm` with logs on stderr
(reference: src/cpu/main.cc:78-133, script/windows/rt-utility.psm1:33-47).
This CLI exposes exactly the reference's parameter set (SURVEY.md §5
"Config / flag system") and keeps the stdout=image / stderr=logs split:

    python -m ray_tracing_in_one_weekend_tpu > out.ppm
    python -m ray_tracing_in_one_weekend_tpu --preset gpu --backend pallas \
        --mesh 2,2 --png out.png > out.ppm

Timing and Mrays/s are reported the way the reference reports them:
wall-clock around the render only (reference: src/gpu/main.cu:128-139).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from ray_tracing_in_one_weekend_tpu.utils.config import (
    PRESETS,
    RenderConfig,
    make_camera_from_config,
    make_scene_from_config,
)
from ray_tracing_in_one_weekend_tpu.utils.platform import (
    BACKENDS,
    PLATFORM_NAMES,
    devices_platform,
    enable_compile_cache,
    resolve_backend,
)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tracing_in_one_weekend_tpu",
        description="Differentiable JAX path tracer (PPM to stdout).",
    )
    d = RenderConfig()
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="start from a reference workload preset")
    p.add_argument("--width", type=int, default=None, help=f"image width (default {d.image_width})")
    p.add_argument("--aspect", type=float, default=None, help="aspect ratio w/h")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=None, help="bounce limit")
    p.add_argument("--vfov", type=float, default=None, help="vertical fov, degrees")
    p.add_argument("--lookfrom", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--lookat", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--vup", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--defocus-angle", type=float, default=None, help="defocus cone angle, degrees (0 = pinhole)")
    p.add_argument("--aperture", type=float, default=None,
                   help="CPU-tree lens aperture (overrides --defocus-angle)")
    p.add_argument("--focus-dist", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scene", choices=("cover", "three", "single"), default=None)
    p.add_argument("--chunk", type=int, default=None, help="pixels per chunk (jnp backend)")
    p.add_argument("--tile", type=int, default=None,
                   help="lanes per kernel program (pallas backend, a power "
                        "of two >= 128; default: the kernel's DEFAULT_TILE)")
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="renderer; auto picks from the device (utils/platform.py)")
    p.add_argument("--mesh", default=None, metavar="P[,S]",
                   help="device mesh: pixel shards, optional sample shards")
    p.add_argument("--platform", choices=("auto", *PLATFORM_NAMES), default="auto",
                   help="force the JAX platform")
    p.add_argument("--num-devices", type=int, default=None,
                   help="virtual CPU device count (with --platform cpu)")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() for multi-host runs")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address for --multihost (default: "
                        "cluster auto-detection)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --multihost with --coordinator")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id for --multihost with --coordinator")
    p.add_argument("--out", default="-", help="output PPM path ('-' = stdout)")
    p.add_argument("--png", default=None, help="also write a PNG here")
    p.add_argument("--no-output", action="store_true", help="render + report timing only")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the timed render into DIR")
    p.add_argument("--checkpoint", default=None, metavar="FILE.npz",
                   help="progressive rendering: accumulate into FILE.npz, resuming "
                        "if it exists; the final image equals a monolithic run "
                        "(same sample streams; within float rounding)")
    p.add_argument("--spp-batch", type=int, default=None,
                   help="samples per accumulation batch (progress/--checkpoint)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="elastic recovery: re-render a failed/corrupt "
                        "sample batch up to N times before failing stop "
                        "(utils/resilient.py)")
    p.add_argument("--no-progress", action="store_true",
                   help="render monolithically even at high spp (suppresses "
                        "the per-batch progress lines)")
    p.add_argument("--cold", action="store_true",
                   help="disable warm-start scheduling (pallas backend): "
                        "every render runs the cold multi-pass compaction "
                        "schedule instead of reusing the cached cost-sorted "
                        "lane permutation (bit-identical image either way)")
    return p


def config_from_args(args) -> RenderConfig:
    config = PRESETS[args.preset] if args.preset else RenderConfig()
    updates = {}
    mapping = {
        "width": "image_width",
        "aspect": "aspect_ratio",
        "spp": "samples_per_pixel",
        "max_depth": "max_depth",
        "vfov": "vfov_degrees",
        "lookfrom": "lookfrom",
        "lookat": "lookat",
        "vup": "vup",
        "defocus_angle": "defocus_angle_degrees",
        "aperture": "aperture",
        "focus_dist": "focus_dist",
        "seed": "seed",
        "scene": "scene",
        "chunk": "chunk_pixels",
        "backend": "backend",
    }
    for arg_name, field in mapping.items():
        v = getattr(args, arg_name)
        if v is not None:
            updates[field] = tuple(v) if isinstance(v, list) else v
    if args.mesh is not None:
        updates["mesh_shape"] = tuple(int(x) for x in args.mesh.split(","))
    return dataclasses.replace(config, **updates)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform != "auto":
        import jax

        jax.config.update("jax_platforms", PLATFORM_NAMES[args.platform])
        if args.num_devices and args.platform == "cpu":
            jax.config.update("jax_num_cpu_devices", args.num_devices)

    if args.multihost:
        import jax

        if args.coordinator:
            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        else:
            jax.distributed.initialize()

    import jax
    import jax.numpy as jnp
    import numpy as np

    enable_compile_cache()
    config = config_from_args(args)
    scene = make_scene_from_config(config)
    cam = make_camera_from_config(config)

    platform = devices_platform()
    backend = resolve_backend(config.backend, platform)

    _log(f"renderer: {config.image_width}x{config.image_height} "
         f"spp={config.samples_per_pixel} depth={config.max_depth} "
         f"scene={config.scene} seed={config.seed}")
    _log(f"backend: {backend} on {platform} "
         f"({len(jax.devices())} device(s)) mesh={config.mesh_shape or '1-chip'}")

    def run():
        if backend == "pallas":
            from ray_tracing_in_one_weekend_tpu.ops import pallas_render

            if config.mesh_shape:
                from ray_tracing_in_one_weekend_tpu.parallel import dist

                mesh = dist.make_mesh(config.mesh_shape)
                return pallas_render.render_pallas_distributed(
                    scene, cam, seed=config.seed, mesh=mesh,
                    tile=args.tile or pallas_render.DEFAULT_TILE,
                    warm=not args.cold,
                )
            return pallas_render.render_pallas(
                scene, cam, seed=config.seed,
                tile=args.tile or pallas_render.DEFAULT_TILE,
                warm=not args.cold,
            )
        if config.mesh_shape:
            from ray_tracing_in_one_weekend_tpu.parallel import dist

            mesh = dist.make_mesh(config.mesh_shape)
            return dist.render_image_distributed(
                scene, cam, config.seed, mesh=mesh, chunk_size=config.chunk_pixels
            )
        from ray_tracing_in_one_weekend_tpu.ops.render import render_image

        return render_image(scene, cam, config.seed, chunk_size=config.chunk_pixels)

    if args.checkpoint:
        return _run_checkpointed(args, config, scene, cam, backend)

    # Progress reporting (the reference streams "Scanlines remaining"
    # during its minutes-long renders, reference: src/cpu/main.cc:112):
    # long renders go through the same sample-batched accumulation the
    # checkpoint path uses, with one stderr line per batch. The final
    # image equals a monolithic run up to float summation order (the
    # batched mean re-associates the per-sample sum; measured <= 2e-7
    # linear, at most 1 u8 level on a rounding boundary — the sample
    # STREAMS are identical, utils/checkpoint.py).
    if not args.no_progress and not args.profile and config.samples_per_pixel >= 64:
        return _run_checkpointed(args, config, scene, cam, backend, persist=False)

    # Warmup/compile outside the timed bracket, like the reference times
    # only the render (reference: src/gpu/main.cu:128-139). The scalar
    # fetch is the completion barrier (dispatch is asynchronous).
    t0 = time.perf_counter()
    img = run()
    float(jnp.sum(img))
    _log(f"compile+first render: {time.perf_counter() - t0:.2f}s")

    def run_with_retries():
        """Monolithic render with the same elastic-recovery contract as
        the batched path (utils/resilient.py): the sample streams are
        pure functions of global indices, so a re-render after a
        transient device fault or NaN frame is bit-identical."""
        last = None
        for attempt in range(1 + max(0, args.retries)):
            try:
                img = run()
                if not bool(jnp.all(jnp.isfinite(img))):
                    raise RuntimeError("non-finite pixels in rendered frame")
                return img
            except Exception as e:  # noqa: BLE001 — retry any device fault
                last = e
                if attempt < args.retries:
                    _log(f"render failed ({type(e).__name__}: "
                         f"{str(e)[:120]}) — retry {attempt + 1}/{args.retries}")
        raise last

    if args.profile:
        # Trace/profiling hook (SURVEY.md §5: the reference only has
        # wall-clock timers; this is the device-level view).
        with jax.profiler.trace(args.profile):
            t0 = time.perf_counter()
            img = run_with_retries()
            float(jnp.sum(img))
            render_s = time.perf_counter() - t0
        _log(f"profile trace written to {args.profile}")
    else:
        t0 = time.perf_counter()
        img = run_with_retries()
        float(jnp.sum(img))
        render_s = time.perf_counter() - t0
    mrays = config.rays_per_frame / render_s / 1e6
    _log(f"render: {render_s:.3f}s  ({mrays:.2f} Mrays/s)")

    if args.no_output:
        return 0

    from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu.parallel.dist import fetch_image
    from ray_tracing_in_one_weekend_tpu.utils import ppm

    # Multi-host: gather the sharded framebuffer (DCN all-gather), then
    # host 0 alone owns stdout/files (SURVEY.md §2.3 host-0 contract).
    full = fetch_image(img)
    if jax.process_count() > 1 and jax.process_index() != 0:
        return 0
    u8 = np.asarray(to_uint8(full))
    if args.png:
        from ray_tracing_in_one_weekend_tpu.utils.png import write_png

        write_png(u8, args.png)
        _log(f"wrote {args.png}")
    if args.out == "-":
        ppm.write_ppm(u8, sys.stdout.buffer)
        sys.stdout.buffer.flush()
    else:
        ppm.write_ppm(u8, args.out)
        _log(f"wrote {args.out}")
    return 0


def _run_checkpointed(args, config, scene, cam, backend, persist=True) -> int:
    """Progressive accumulation (utils/checkpoint.py), on either
    backend, optionally mesh-sharded — the kernel's sample streams key
    on global sample indices, so batching is free of statistical cost
    on every path. With `persist`, the accumulator state round-trips
    through --checkpoint's npz for resume; without it, the same loop
    serves as the long-render progress reporter (the "Scanlines
    remaining" analogue, reference: src/cpu/main.cc:112)."""
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tracing_in_one_weekend_tpu.utils import checkpoint as ckpt

    mesh = None
    if config.mesh_shape:
        from ray_tracing_in_one_weekend_tpu.parallel import dist

        mesh = dist.make_mesh(config.mesh_shape)

    if persist and os.path.exists(args.checkpoint):
        from ray_tracing_in_one_weekend_tpu.utils.resilient import (
            validate_state,
        )

        state = ckpt.load(args.checkpoint)
        validate_state(state)  # corrupt-on-disk fails fast, distinctly
        _log(f"resumed {args.checkpoint} at {int(state.spp_done)} spp")
    else:
        state = ckpt.new_state(cam)

    target_spp = config.samples_per_pixel
    batch = args.spp_batch or max(1, target_spp // 10)
    if mesh is not None:
        # Sample-sharded meshes require every batch to divide evenly
        # over the sample axis (render_pallas_distributed /
        # parallel/dist.py); round the batch to a multiple. Total spp
        # is validated by the render functions themselves.
        from ray_tracing_in_one_weekend_tpu.parallel.dist import SAMPLE_AXIS

        smp = mesh.shape[SAMPLE_AXIS]
        batch = max(smp, (batch // smp) * smp)
    start_spp = int(state.spp_done)  # session accounting (resume-aware)
    render_s = 0.0
    first_batch_s = None
    while int(state.spp_done) < target_spp:
        n = min(batch, target_spp - int(state.spp_done))
        t0 = time.perf_counter()
        if args.retries > 0:
            from ray_tracing_in_one_weekend_tpu.utils.resilient import (
                accumulate_resilient,
            )

            state = accumulate_resilient(
                state, scene, cam, config.seed, n,
                max_retries=args.retries, log=_log,
                chunk_size=config.chunk_pixels,
                backend=backend, mesh=mesh, tile=args.tile,
                warm=not args.cold,
            )
        else:
            state = ckpt.accumulate(
                state, scene, cam, config.seed, n,
                chunk_size=config.chunk_pixels,
                backend=backend, mesh=mesh, tile=args.tile,
                warm=not args.cold,
            )
        float(jnp.sum(state.accum))  # completion barrier
        if persist:
            ckpt.save(state, args.checkpoint)
        dt = time.perf_counter() - t0
        render_s += dt
        if first_batch_s is None:
            first_batch_s = dt  # includes compile
        done = int(state.spp_done)
        remaining = target_spp - done
        # Steady-state rate from THIS SESSION's post-compile batches
        # (resumed checkpoints must not count pre-existing samples).
        session = done - start_spp
        if session > batch:
            steady = (render_s - first_batch_s) / (session - batch)
        else:
            steady = dt / max(n, 1)
        _log(
            f"samples {done}/{target_spp} (+{n} in {dt:.2f}s, "
            f"~{remaining * steady:.0f}s remaining)"
        )
    session = int(state.spp_done) - start_spp
    if session > 0 and render_s > 0:
        # Mrays/s over the samples rendered THIS session only (a resumed
        # run must not charge checkpointed samples to this wall time).
        mrays = (config.image_width * config.image_height * session
                 / render_s / 1e6)
        _log(f"render: {render_s:.3f}s total for {session} spp "
             f"({mrays:.2f} Mrays/s incl compile)")
    else:
        _log(f"checkpoint already complete at {int(state.spp_done)} spp")

    if args.no_output:
        return 0

    from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu.parallel.dist import fetch_image
    from ray_tracing_in_one_weekend_tpu.utils import ppm

    # Same multi-host contract as the monolithic path: gather the
    # sharded framebuffer, host 0 alone owns stdout/files.
    full = fetch_image(state.image)
    if jax.process_count() > 1 and jax.process_index() != 0:
        return 0
    u8 = np.asarray(to_uint8(full))
    if args.png:
        from ray_tracing_in_one_weekend_tpu.utils.png import write_png

        write_png(u8, args.png)
        _log(f"wrote {args.png}")
    if args.out == "-":
        ppm.write_ppm(u8, sys.stdout.buffer)
        sys.stdout.buffer.flush()
    else:
        ppm.write_ppm(u8, args.out)
        _log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
