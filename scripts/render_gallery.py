"""Render the repo's gallery artifacts for the reference CPU workload
(1200x800, aperture 0.1, 500 spp, depth 50 — reference:
src/cpu/main.cc:82-99) on the bit-exact mt19937 replay of the
reference's scene, through the Pallas kernel and optionally the jnp
path.

tests/test_golden_fullres.py compares the committed artifacts
(gallery/cover_1200x800_500spp_{pallas,jnp}.png) with the reference's
own render (tests/goldens/ref_cpu_cover_1200x800_500spp.png, rendered
by the reference cpu_ray_tracer with its fixed mt19937(5489) seed —
BASELINE.md).

Usage: python scripts/render_gallery.py [spp] [--jnp-too] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from render_artifact import render_preset  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("spp", nargs="?", type=int, default=500)
    ap.add_argument("--jnp-too", action="store_true",
                    help="also render the jnp-path artifact")
    ap.add_argument("--out-dir", default="gallery")
    args = ap.parse_args()

    from ray_tracing_in_one_weekend_tpu.models.scene import cover_scene_reference

    scene = cover_scene_reference()
    extra = {"scene": "cover_scene_reference"}
    backends = ("pallas", "jnp") if args.jnp_too else ("pallas",)
    for backend in backends:
        render_preset(
            "cpu", args.spp, backend=backend, scene=scene,
            name=f"cover_1200x800_{args.spp}spp_{backend}.png", extra=extra,
            out_dir=args.out_dir,
        )


if __name__ == "__main__":
    main()
