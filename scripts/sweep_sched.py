"""Sweep the forward kernel's scheduling knobs (tile, budget, n_passes,
warm-start) on the bench workload and print Mrays/s per config, on a
GPU only. Pure scheduling — the image is bit-identical for every config
(see _multipass docstring).

Usage: python scripts/sweep_sched.py [configs...]
  each config is tile:budget:passes, default sweep if none given; every
  config is timed cold (warm=False) and warm (matched re-render).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    import jax

    from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import render_pallas
    from ray_tracing_in_one_weekend_tpu.utils.config import (
        PRESETS,
        make_camera_from_config,
    )
    from ray_tracing_in_one_weekend_tpu.utils.platform import (
        enable_compile_cache,
        gpu_name_and_power_limit,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"sweep_sched: no GPU (platform {dev.platform}); nothing measured",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"card: {gpu_name_and_power_limit()}", flush=True)

    config = PRESETS["bench"]
    scene = cover_scene(config.seed)
    cam = make_camera_from_config(config)
    rays = config.rays_per_frame

    if len(sys.argv) > 1:
        combos = [tuple(int(x) for x in a.split(":")) for a in sys.argv[1:]]
    else:
        combos = [(t, 30, p) for t in (128, 256, 512) for p in (1, 3)]

    best = None
    for tile, budget, n_passes in combos:
        for warm in (False, True):
            def run():
                img = render_pallas(scene, cam, seed=0, tile=tile, budget=budget,
                                    n_passes=n_passes, warm=warm)
                return float(jax.block_until_ready(img).sum())

            t0 = time.perf_counter()
            s = run()
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
            t = float(np.median(times))
            print(
                f"tile={tile} budget={budget} passes={n_passes} warm={warm}: "
                f"{t:.4f}s ({rays / t / 1e6:.1f} Mrays/s) first call "
                f"{compile_s:.1f}s checksum {s:.1f}",
                flush=True,
            )
            if best is None or t < best[0]:
                best = (t, tile, budget, n_passes, warm)
    t, tile, budget, n_passes, warm = best
    print(f"best: tile={tile} budget={budget} passes={n_passes} warm={warm} "
          f"{t:.4f}s ({rays / t / 1e6:.1f} Mrays/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
