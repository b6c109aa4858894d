"""Inverse rendering demo: recover scene parameters from a target image.

The capability the reference never had (BASELINE.json north star):
because the whole pipeline is differentiable, we can perturb sphere
albedos, render the damaged scene, and drive the parameters back to the
target by gradient descent on the pixel loss — on one device or a full
mesh (gradients all-reduce across the mesh automatically,
parallel/dist.py). Gradients are XLA's autodiff of the jnp path.

Run:  python examples/inverse_render.py [--steps 40] [--mesh 2,2]
Logs loss to stderr; writes target/recovered PNGs to --outdir.
"""

from __future__ import annotations

import argparse
import os
import sys

# Runnable from a source checkout without installation (the console
# script / installed package does not need this).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=30.0)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--mesh", default=None, help="P[,S] device mesh")
    ap.add_argument("--outdir", default="inverse_out")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
    from ray_tracing_in_one_weekend_tpu.parallel import dist

    mesh_shape = (
        tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (1, 1)
    )
    mesh = dist.make_mesh(mesh_shape)

    scene = scene_lib.three_sphere_scene(pad_to=128)
    cam = make_camera(
        image_width=args.width,
        aspect_ratio=2.0,
        samples_per_pixel=args.spp,
        max_depth=8,
        vfov_degrees=90.0,
        lookfrom=(0.0, 0.0, 0.5),
        lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0,
        focus_dist=1.5,
    )
    key = jax.random.key(0)
    target = dist.render_image_distributed(
        scene, cam, key, mesh=mesh, chunk_size=2048
    )

    # Damage the albedos of the three visible spheres.
    params = dist.scene_params(scene)
    true_albedo = params["albedo"]
    damaged = true_albedo.at[1].set(jnp.asarray([0.6, 0.6, 0.6]))
    damaged = damaged.at[3].set(jnp.asarray([0.3, 0.3, 0.8]))
    params["albedo"] = damaged

    before_err = float(jnp.abs(params["albedo"][1] - true_albedo[1]).sum())

    for step in range(args.steps):
        loss, grads = dist.render_grads(
            params, scene, cam, target, key, mesh, chunk_size=2048
        )
        # albedo-only SGD (geometry is already correct in this demo)
        params["albedo"] = jnp.clip(
            params["albedo"] - args.lr * grads["albedo"], 0.0, 1.0
        )
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {float(loss):.6f}", file=sys.stderr)

    after_err = float(jnp.abs(params["albedo"][1] - true_albedo[1]).sum())
    print(
        f"albedo L1 error sphere 1: {before_err:.3f} -> {after_err:.3f}",
        file=sys.stderr,
    )

    from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu.parallel.dist import scene_with_params
    from ray_tracing_in_one_weekend_tpu.utils.png import write_png

    final = dist.render_image_distributed(
        scene_with_params(scene, params), cam, key, mesh=mesh, chunk_size=2048
    )
    for name, img in (("target", target), ("recovered", final)):
        write_png(np.asarray(to_uint8(img)), f"{args.outdir}/inverse_{name}.png")
    print(f"wrote {args.outdir}/inverse_*.png", file=sys.stderr)

    return 0 if after_err < before_err * 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
