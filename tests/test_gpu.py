"""Card-only checks of the compiled Triton kernel. Each takes the
`gpu_device` fixture (tests/conftest.py), which skips where there is no
GPU; on a GPU machine:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

chip_smoke.py runs the same checks at full size.
"""

import jax
import numpy as np
import pytest

from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu.utils import kernel_checks as kc

pytestmark = pytest.mark.gpu


def test_compiled_kernel_matches_interpreter(gpu_device):
    cam = make_camera(image_width=64, aspect_ratio=2.0, samples_per_pixel=4, max_depth=8)
    block_mad, mean_diff = kc.compiled_vs_interpret(
        scene_lib.cover_scene(0), cam, gpu_device, jax.devices("cpu")[0]
    )
    assert block_mad < kc.MODE_BLOCK_MAD_TOL and mean_diff < kc.MODE_MEAN_DIFF_TOL


def test_compiled_kernel_matches_jnp_oracle(gpu_device):
    from ray_tracing_in_one_weekend_tpu.ops.pallas_render import render_pallas
    from ray_tracing_in_one_weekend_tpu.ops.render import render_image

    sc = scene_lib.cover_scene(0)
    cam = make_camera(image_width=320, samples_per_pixel=32)
    with jax.default_device(gpu_device):
        img_k = np.asarray(render_pallas(sc, cam, seed=0, warm=False))
        img_j = np.asarray(render_image(sc, cam, 0))
    assert np.abs(img_k.mean(axis=(0, 1)) - img_j.mean(axis=(0, 1))).max() < kc.ORACLE_MEAN_TOL
    diff = np.abs(kc.block_means(img_k) - kc.block_means(img_j))
    assert diff.mean() < kc.ORACLE_BLOCK_MAD_TOL
