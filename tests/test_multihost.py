"""Multi-host execution (SURVEY.md §2.3): a real 2-process
`jax.distributed.initialize` rendezvous on CPU, global mesh spanning
both processes, sharded render, host-0 gather + PPM write — then the
PPM bytes are compared against a single-process render of the same
scene. This is the CI stand-in for a ≥2-host cluster (gloo over
localhost plays DCN's role)."""

import os
import subprocess
import sys
import socket

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def test_two_process_rendezvous_renders_and_gathers(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    # The workers force the CPU platform themselves.
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
    for pid in range(2):
        assert os.path.exists(os.path.join(tmp_path, f"ok_{pid}"))

    # Host 0 wrote the gathered PPM; byte-compare with a single-process
    # render of the same workload.
    from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
    from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
    from ray_tracing_in_one_weekend_tpu.ops.image import to_uint8
    from ray_tracing_in_one_weekend_tpu.ops.render import render_image
    from ray_tracing_in_one_weekend_tpu.utils import ppm

    sc = scene_lib.single_sphere_scene(pad_to=8)
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
    u8_single = np.asarray(to_uint8(render_image(sc, cam, 0, chunk_size=64)))
    u8_multi = ppm.read_ppm(os.path.join(tmp_path, "multihost.ppm"))
    # The float framebuffers agree to 1 ulp (asserted in the worker);
    # after 8-bit quantization a boundary-straddling value may differ by
    # one level, so allow exactly that.
    assert u8_multi.shape == u8_single.shape
    assert int(np.abs(u8_multi.astype(int) - u8_single.astype(int)).max()) <= 1


def test_cli_multihost_end_to_end(tmp_path):
    """The CLI's --multihost path: 2 processes, explicit rendezvous,
    pixel-sharded mesh over all 8 global devices, host-0-only PPM
    output, byte-identical to a single-process CLI render (pixel
    sharding is bit-exact; no sample axis involved)."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    common = [
        sys.executable, "-m", "ray_tracing_in_one_weekend_tpu",
        "--platform", "cpu", "--num-devices", "4",
        "--scene", "single", "--width", "32", "--aspect", "2.0",
        "--spp", "4", "--max-depth", "4", "--chunk", "64",
        "--backend", "jnp",
    ]
    procs = []
    for pid in range(2):
        out = os.path.join(tmp_path, f"mh_{pid}.ppm")
        procs.append(
            subprocess.Popen(
                common + [
                    "--multihost", "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(pid),
                    "--mesh", "8", "--out", out,
                ],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, cwd=REPO,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"cli worker {pid} failed:\n{out[-2000:]}"
    # host 0 wrote its PPM; host 1 exited before output
    assert os.path.exists(os.path.join(tmp_path, "mh_0.ppm"))
    assert not os.path.exists(os.path.join(tmp_path, "mh_1.ppm"))

    single = os.path.join(tmp_path, "single.ppm")
    r = subprocess.run(
        common + ["--num-devices", "8", "--out", single],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        timeout=240,
    )
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]
    with open(os.path.join(tmp_path, "mh_0.ppm"), "rb") as f:
        multi_bytes = f.read()
    with open(single, "rb") as f:
        single_bytes = f.read()
    assert multi_bytes == single_bytes
