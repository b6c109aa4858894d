"""Render a preset workload into a gallery artifact + manifest entry.

Usage: python scripts/render_artifact.py <preset> [spp] [--spp-batch N] [--out-dir DIR]

Renders PRESETS[<preset>] (e.g. `gpu` = 1920x1080, 500 spp, defocus
0.6 deg — reference: src/gpu/camera.h:58-62) through the checkpoint
accumulator (utils/checkpoint.py): sample batches accumulate ON DEVICE
in float32, the only per-batch host traffic is a completion barrier,
and the full image is fetched once at the end.

Writes gallery/cover_<W>x<H>_<spp>spp_<preset>.png and records the
render in gallery/MANIFEST.json with the render-sources digest (so
tests/test_golden_fullres.py can detect stale artifacts), the device
and, on a GPU, the card's name and power limit and the timings:
`mrays_per_s` is the steady-state rate over the batches after the
first, which includes compilation; with a single batch there is no
steady window and only `mrays_per_s_incl_compile` is recorded.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def accumulate_timed(scene, cam, seed, spp, spp_batch, backend, label):
    """Accumulate `spp` samples in batches; returns (state, batch_seconds)."""
    import jax

    from ray_tracing_in_one_weekend_tpu.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    state = ckpt.new_state(cam)
    batch_times = []
    while int(state.spp_done) < spp:
        b = min(spp_batch, spp - int(state.spp_done))
        tb = time.perf_counter()
        state = ckpt.accumulate(state, scene, cam, seed, b, backend=backend)
        jax.block_until_ready(state.accum)
        batch_times.append(time.perf_counter() - tb)
        print(f"{label}: samples {int(state.spp_done)}/{spp} "
              f"(+{b} in {batch_times[-1]:.2f}s, "
              f"{time.perf_counter() - t0:.0f}s total)", file=sys.stderr)
    return state, batch_times


def rate_fields(w, h, spp, spp_batch, batch_times) -> dict:
    """Manifest timing fields. The steady rate skips the first batch
    (compilation) and exists only when a later batch does."""
    total = sum(batch_times)
    out = {
        "render_seconds": round(total, 1),
        "batch_seconds": [round(x, 2) for x in batch_times],
        "mrays_per_s_incl_compile": round(w * h * spp / total / 1e6, 1),
    }
    if len(batch_times) > 1:
        steady_rays = w * h * (spp - min(spp_batch, spp))
        out["mrays_per_s"] = round(steady_rays / sum(batch_times[1:]) / 1e6, 1)
    return out


def device_fields(backend: str) -> dict:
    """Where the render ran: backend label, device kind, and the card's
    name and power limit as nvidia-smi reports them (GPU only)."""
    import jax

    from ray_tracing_in_one_weekend_tpu.utils.platform import gpu_name_and_power_limit

    dev = jax.devices()[0]
    label = backend
    if backend == "pallas":
        label = "pallas-interpret" if dev.platform == "cpu" else f"pallas-{dev.platform}"
    out = {"backend": label, "device_kind": dev.device_kind}
    card = gpu_name_and_power_limit()
    if card:
        out["card"] = card
    return out


def render_preset(preset: str, spp: int | None = None, spp_batch: int = 100,
                  out_dir: str = "gallery", backend: str = "pallas",
                  scene=None, name: str | None = None, extra: dict | None = None):
    """Render and record one artifact; returns (name, u8 image)."""
    import jax

    from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu.utils import manifest
    from ray_tracing_in_one_weekend_tpu.utils.config import (
        PRESETS,
        make_camera_from_config,
        make_scene_from_config,
    )
    from ray_tracing_in_one_weekend_tpu.utils.platform import enable_compile_cache
    from ray_tracing_in_one_weekend_tpu.utils.png import write_png

    enable_compile_cache()
    config = PRESETS[preset]
    spp = config.samples_per_pixel if spp is None else spp
    scene = make_scene_from_config(config) if scene is None else scene
    cam = make_camera_from_config(config)
    w, h = cam.image_width, cam.image_height
    label = f"artifact[{preset}/{backend}]"
    print(f"{label}: {w}x{h} spp={spp} depth={cam.max_depth}", file=sys.stderr)

    state, batch_times = accumulate_timed(
        scene, cam, config.seed, spp, spp_batch, backend, label
    )
    u8 = np.asarray(to_uint8(state.image))

    os.makedirs(out_dir, exist_ok=True)
    name = name or f"cover_{w}x{h}_{spp}spp_{preset}.png"
    write_png(u8, os.path.join(out_dir, name))
    # Rates are device metrics: recorded for a GPU run only.
    on_gpu = jax.devices()[0].platform == "gpu"
    rates = rate_fields(w, h, spp, spp_batch, batch_times) if on_gpu else {}
    manifest.record(out_dir, name, {
        "preset": preset,
        "width": w, "height": h, "spp": spp,
        "max_depth": cam.max_depth,
        "seed": config.seed,
        **device_fields(backend),
        **rates,
        "mean_u8": round(float(u8.mean()), 3),
        **(extra or {}),
    })
    print(f"{label}: {name} in {sum(batch_times):.1f}s {rates}, "
          f"mean {u8.mean():.1f}", file=sys.stderr)
    return name, u8


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("preset", nargs="?", default="gpu")
    ap.add_argument("spp", nargs="?", type=int, default=None)
    ap.add_argument("--spp-batch", type=int, default=100)
    ap.add_argument("--out-dir", default="gallery")
    args = ap.parse_args()
    render_preset(args.preset, args.spp, args.spp_batch, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
