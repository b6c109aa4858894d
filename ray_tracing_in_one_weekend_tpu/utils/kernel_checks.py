"""On-device correctness checks of the Pallas kernel, shared by bench.py
and chip_smoke.py.

Two renders of the same scene by different streams or different
arithmetic agree in distribution, not per pixel, so every comparison
here is between block means, where Monte-Carlo noise averages out while
a geometry, material or lowering bug shifts whole blocks.
"""

from __future__ import annotations

import numpy as np

# Compiled vs interpreted raw kernel pass: 256-lane block means of
# per-lane radiance. Noise averages to ~0.006 per block; a lowering bug
# (wrong select, broken RNG, bad normal) shifts whole blocks by > 0.05.
MODE_BLOCK_MAD_TOL = 0.02
MODE_MEAN_DIFF_TOL = 0.01

# Kernel vs the jnp oracle on the cover scene at >= 32 spp: two
# independent Monte-Carlo streams (PCG vs threefry, equal in law). 16x16
# block means of linear radiance carry ~0.002 of noise at 32 spp; a
# geometry or material bug shifts whole blocks by more than 0.05.
ORACLE_MEAN_TOL = 0.01
ORACLE_BLOCK_MAD_TOL = 0.01
ORACLE_BLOCK_P999_TOL = 0.05


def block_means(img: np.ndarray, block: int = 16) -> np.ndarray:
    """[H, W, C] -> [H // block, W // block, C] means (edges cropped)."""
    h = img.shape[0] // block * block
    w = img.shape[1] // block * block
    c = img.shape[2]
    return img[:h, :w].reshape(h // block, block, w // block, block, c).mean(axis=(1, 3))


def compiled_vs_interpret(scene, cam, gpu_device, cpu_device, tile=256, spp=16, max_depth=8):
    """One raw kernel pass compiled on `gpu_device` and interpreted on
    `cpu_device`, on identical inputs; returns (block_mad, mean_diff).

    Feeding both the same arrays isolates the kernel itself: comparing
    full renders across devices would also compare the outer XLA ops
    (compaction sorts), whose reduction orders legitimately differ.
    Bit-identity is not expected: sin/cos/sqrt/rsqrt differ in the last
    ulps between CUDA's libdevice and XLA's CPU code, and bounce dynamics
    are chaotic, so per-lane paths diverge within a few bounces."""
    import jax
    import jax.numpy as jnp

    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    n_pixels = cam.image_width * cam.image_height
    padded = -(-n_pixels // tile) * tile
    pt = np.asarray(pr.pack_scene(scene).T)
    cam_vec = pr.pack_camera(cam)
    scalars = np.asarray(
        pr._pass_scalars(0, 0, 0, pr.live_slots(scene)).at[pr._SC_BUDGET].set(spp * max_depth)
    )
    sf, si = (np.asarray(x) for x in pr._init_state(0, padded, n_pixels, spp))

    def run(interpret, device):
        args = [jax.device_put(jnp.asarray(x), device) for x in (pt, cam_vec, scalars, sf, si)]
        of, _ = pr._render_pallas_core(*args, tile, spp, max_depth, interpret)
        return np.asarray(of)

    rad_c = run(False, gpu_device)[pr._SF_RAD:pr._SF_RAD + 3].mean(axis=0) / spp
    rad_i = run(True, cpu_device)[pr._SF_RAD:pr._SF_RAD + 3].mean(axis=0) / spp
    n_blocks = rad_c.shape[0] // 256
    bc = rad_c[: n_blocks * 256].reshape(n_blocks, 256).mean(axis=1)
    bi = rad_i[: n_blocks * 256].reshape(n_blocks, 256).mean(axis=1)
    return float(np.abs(bc - bi).mean()), float(abs(rad_c.mean() - rad_i.mean()))
