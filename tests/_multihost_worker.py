"""Worker process for tests/test_multihost.py.

Runs as one of N processes of a multi-host CPU rendezvous
(`jax.distributed.initialize` over gloo — SURVEY.md §2.3's multi-host
DCN item, exercised on CPU exactly as a multi-host cluster would run it). Each
process owns `local_devices` virtual CPU devices; the global mesh spans
all processes. The sharded render's global framebuffer is gathered with
`dist.fetch_image` and process 0 compares it against the single-device
oracle render computed locally, then writes the PPM (the host-0 output
contract of utils/cli.py).

Usage: python _multihost_worker.py <process_id> <num_processes> <port> <outdir>
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
outdir = sys.argv[4]

jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc,
    process_id=pid,
)

import numpy as np

from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
    render_pallas,
    render_pallas_distributed,
)
from ray_tracing_in_one_weekend_tpu.ops.render import render_image
from ray_tracing_in_one_weekend_tpu.parallel import dist
from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8
from ray_tracing_in_one_weekend_tpu.utils import ppm

assert jax.process_count() == nproc, jax.process_count()
assert jax.local_device_count() == 4
assert jax.device_count() == 4 * nproc

# 128-slot padding: the Pallas scene matrix requires whole sphere
# chunks (ops/pallas_render.pack_scene).
sc = scene_lib.single_sphere_scene(pad_to=128)
cam = make_camera(
    image_width=32,
    aspect_ratio=2.0,
    samples_per_pixel=4,
    max_depth=4,
    vfov_degrees=90.0,
    lookfrom=(0.0, 0.0, 0.0),
    lookat=(0.0, 0.0, -1.0),
    defocus_angle_degrees=0.0,
    focus_dist=1.0,
)

# Global mesh over every device of every process: pixel x sample axes.
mesh = dist.make_mesh((2 * nproc, 2))
img = dist.render_image_distributed(sc, cam, base_key=0, mesh=mesh, chunk_size=64)
full = dist.fetch_image(img)

# Every process independently renders the single-device oracle; the
# sharded global image must match it (bit-identical modulo the pmean
# summation order on the sample axis).
oracle = np.asarray(render_image(sc, cam, 0, chunk_size=64))
np.testing.assert_allclose(full, oracle, atol=1e-6)

# The Pallas kernel (interpreted: these are CPU devices) runs SHARDED
# over a mesh of this process's own 4 local devices, inside the live
# multi-process runtime (gloo rendezvous up, collectives initialized),
# and is byte-compared against the process-local single-device kernel.
# Cross-shard correctness of the kernel on an 8-device mesh is covered by
# tests/test_pallas_dist.py — the kernel's lane streams key on GLOBAL
# ids, so shard placement (same-process or cross-process) cannot change
# its output.
local_mesh = dist.make_mesh((2, 2), devices=jax.local_devices())
pallas_img = render_pallas_distributed(
    sc, cam, seed=0, mesh=local_mesh, tile=128, interpret=True, warm=False
)
pallas_np = np.asarray(pallas_img)
pallas_single = np.asarray(
    render_pallas(sc, cam, seed=0, tile=128, interpret=True, warm=False)
)
np.testing.assert_allclose(pallas_np, pallas_single, atol=1e-6)
print(f"worker {pid}: pallas local-mesh ok", flush=True)

if pid == 0:
    u8 = np.asarray(to_uint8(full))
    ppm.write_ppm(u8, os.path.join(outdir, "multihost.ppm"))
    with open(os.path.join(outdir, f"ok_{pid}"), "w") as f:
        f.write("MULTIHOST_OK")
else:
    with open(os.path.join(outdir, f"ok_{pid}"), "w") as f:
        f.write("MULTIHOST_OK")
print(f"worker {pid}: ok", flush=True)
