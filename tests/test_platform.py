"""The platform policy (utils/platform.py), the compile-cache helper, the
PNG writer, the flax-free pytrees and chip_smoke.py's refusal to run
without a GPU."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu.models.camera import Camera, make_camera
from ray_tracing_in_one_weekend_tpu.utils import platform as plat

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform, requested, expected",
    [
        ("cpu", "auto", "jnp"),
        ("cpu", "jnp", "jnp"),
        ("cpu", "pallas", "pallas"),
        ("gpu", "auto", "pallas"),
        ("gpu", "jnp", "jnp"),
        ("gpu", "pallas", "pallas"),
    ],
)
def test_resolve_backend(platform, requested, expected):
    assert plat.resolve_backend(requested, platform) == expected


def test_resolve_backend_rejects_unknown():
    with pytest.raises(ValueError, match="unknown backend"):
        plat.resolve_backend("mosaic", "gpu")


@pytest.mark.parametrize("platform, interpret", [("cpu", True), ("gpu", False)])
def test_kernel_interpret_only_on_cpu(platform, interpret):
    """The interpreter runs only where the arrays live on the CPU; a GPU
    never interprets."""
    assert plat.kernel_interpret(platform) is interpret


def test_kernel_has_no_build_elsewhere():
    with pytest.raises(ValueError, match="no build"):
        plat.kernel_interpret("rocm")


@pytest.mark.parametrize("default", [None, "device", "cpu"])
def test_devices_platform_follows_default_device(default):
    """With no devices given, the platform is the default device's:
    `jax.default_device` (a device or a platform name) when set."""
    cpu1 = jax.devices("cpu")[1]
    assert plat.devices_platform([cpu1]) == "cpu"
    if default is None:
        assert plat.devices_platform() == jax.devices()[0].platform
        return
    with jax.default_device(cpu1 if default == "device" else default):
        assert plat.devices_platform() == "cpu"


def test_render_pallas_resolves_interpret_from_devices():
    """interpret=None on CPU arrays takes the interpreter and matches an
    explicit interpret=True render bit for bit."""
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import render_pallas

    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = make_camera(image_width=16, aspect_ratio=2.0, samples_per_pixel=2, max_depth=3)
    a = np.asarray(render_pallas(sc, cam, tile=128, warm=False))
    b = np.asarray(render_pallas(sc, cam, tile=128, warm=False, interpret=True))
    np.testing.assert_array_equal(a, b)


def test_cli_platform_choices_map_to_jax_names():
    from ray_tracing_in_one_weekend_tpu.utils.cli import build_parser

    p = build_parser()
    assert p.parse_args(["--platform", "gpu"]).platform == "gpu"
    assert plat.PLATFORM_NAMES == {"cpu": "cpu", "gpu": "cuda"}
    with pytest.raises(SystemExit):
        p.parse_args(["--platform", "rocm"])


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = plat.enable_compile_cache()
        assert path == str(plat.CACHE_DIR)
        assert os.path.dirname(path) == _ROOT
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert plat.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old  # sets nothing


def test_png_roundtrip(tmp_path):
    from ray_tracing_in_one_weekend_tpu.utils.png import read_png, write_png

    img = np.random.default_rng(0).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(img, path)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_readable_by_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    from ray_tracing_in_one_weekend_tpu.utils.png import write_png

    img = np.random.default_rng(1).integers(0, 256, (5, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(img, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_rejects_non_rgb():
    from ray_tracing_in_one_weekend_tpu.utils.png import encode_png

    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4), np.uint8))


def _hit_record():
    from ray_tracing_in_one_weekend_tpu.ops.intersect import hit_scene

    sc = scene_lib.three_sphere_scene(pad_to=8)
    o = jnp.zeros((4, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (4, 1))
    return hit_scene(sc, o, d)


def _render_state():
    from ray_tracing_in_one_weekend_tpu.utils import checkpoint as ckpt

    return ckpt.new_state(make_camera(image_width=8, aspect_ratio=2.0))


@pytest.mark.parametrize(
    "make",
    [
        lambda: scene_lib.three_sphere_scene(pad_to=8),
        lambda: make_camera(image_width=16, aspect_ratio=2.0),
        _hit_record,
        _render_state,
    ],
    ids=["Scene", "Camera", "HitRecord", "RenderState"],
)
def test_pytree_roundtrip(make):
    obj = make()
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(jax.tree_util.tree_leaves(obj), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # replace() returns a new instance; the original is frozen
    field = dataclasses.fields(obj)[0].name
    new = obj.replace(**{field: None})
    assert getattr(new, field) is None and getattr(obj, field) is not None
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, field, None)


def test_camera_static_fields_are_metadata():
    cam = make_camera(image_width=16, aspect_ratio=2.0, samples_per_pixel=3)
    leaves = jax.tree_util.tree_leaves(cam)
    assert len(leaves) == 7  # the seven array fields
    assert isinstance(cam, Camera) and cam.samples_per_pixel == 3
    # statics ride in the treedef: a jit retraces on a new width
    f = jax.jit(lambda c: c.center * c.image_width)
    np.testing.assert_allclose(f(cam), np.asarray(cam.center) * 16)


def test_package_imports_without_flax():
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import ray_tracing_in_one_weekend_tpu as rt\n"
        "from ray_tracing_in_one_weekend_tpu.utils import checkpoint, cli\n"
        "from ray_tracing_in_one_weekend_tpu.ops import pallas_render\n"
        "print(rt.cover_scene(0).num_slots)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "512"


def test_chip_smoke_refuses_cpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=_ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A copy of chip_smoke.py alone fails for want of the package, even
    when started from a checkout: it imports the package from its own
    directory, never from the caller's, and before it looks for a GPU."""
    import shutil

    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "No module named 'ray_tracing_in_one_weekend_tpu'" in out.stderr
    assert "no GPU found" not in out.stderr
    assert '"ok"' not in out.stdout
