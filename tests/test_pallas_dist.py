"""Mesh-sharded Pallas kernel: bit-identical to the single-chip kernel
for any mesh layout (streams key on global pixel/sample indices)."""

import jax
import numpy as np
import pytest

from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu.ops.pallas_render import (
    render_pallas,
    render_pallas_distributed,
)
from ray_tracing_in_one_weekend_tpu.parallel.dist import make_mesh


def _cam(spp=8):
    return make_camera(
        image_width=32,
        aspect_ratio=2.0,
        samples_per_pixel=spp,
        max_depth=6,
        vfov_degrees=90.0,
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0,
        focus_dist=1.0,
    )


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_pallas_dist_matches_single(mesh_shape):
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam()
    single = np.asarray(render_pallas(sc, cam, seed=0, tile=128, interpret=True))
    mesh = make_mesh(mesh_shape)
    dist_img = np.asarray(
        render_pallas_distributed(
            sc, cam, seed=0, mesh=mesh, tile=128, interpret=True
        )
    )
    # only difference: pmean summation order on the sample axis (1 ulp)
    np.testing.assert_allclose(dist_img, single, atol=1e-6)


def test_pallas_dist_spp_divisibility():
    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(spp=3)
    with pytest.raises(ValueError, match="divide evenly"):
        render_pallas_distributed(
            sc, cam, seed=0, mesh=make_mesh((1, 8)), tile=128, interpret=True
        )


def test_distributed_second_call_no_retrace():
    """Regression for a perf bug: `render_pallas_distributed` once
    rebuilt and re-traced its shard_map program on EVERY call. The
    program is cached at module level keyed on (mesh, statics), with
    seed and sample_offset as traced data. With auto warm-start, the
    steady state is TWO programs per (scene, camera, mesh): the cold
    first call and the warm schedule every later call runs — so call 2
    may add the warm variant once, and call 3+ with different
    seed/sample_offset must hit the jit cache, not add an entry."""
    from ray_tracing_in_one_weekend_tpu.ops import pallas_render as pr

    sc = scene_lib.single_sphere_scene(pad_to=128)
    cam = _cam(spp=4)
    mesh = make_mesh((4, 2))

    render_pallas_distributed(sc, cam, seed=0, mesh=mesh, tile=128, interpret=True)
    render_pallas_distributed(  # matched re-render: warm variant compiles once
        sc, cam, seed=0, mesh=mesh, tile=128, interpret=True
    )
    render_pallas_distributed(  # mismatched: the cold+fill program again
        sc, cam, seed=1, mesh=mesh, tile=128, interpret=True
    )
    n0 = pr._render_dist_jit._cache_size()
    render_pallas_distributed(
        sc, cam, seed=7, mesh=mesh, tile=128, interpret=True, sample_offset=4
    )
    assert pr._render_dist_jit._cache_size() == n0, (
        "steady-state distributed render re-traced (seed/sample_offset "
        "must be traced data, not part of the cache key)"
    )

    # With the cache disabled, the cold program must also be stable
    # across seeds (the original round-3 contract).
    render_pallas_distributed(
        sc, cam, seed=0, mesh=mesh, tile=128, interpret=True, warm=False
    )
    n0 = pr._render_dist_jit._cache_size()
    render_pallas_distributed(
        sc, cam, seed=9, mesh=mesh, tile=128, interpret=True, warm=False
    )
    assert pr._render_dist_jit._cache_size() == n0

    # And the single-chip entry: after the cold+fill and warm variants
    # exist, any further seed/offset reuses a compiled program.
    render_pallas(sc, cam, seed=0, tile=128, interpret=True)
    render_pallas(sc, cam, seed=0, tile=128, interpret=True)  # warm variant
    render_pallas(sc, cam, seed=1, tile=128, interpret=True)  # cold again
    n0 = pr._render_single_jit._cache_size()
    render_pallas(sc, cam, seed=5, tile=128, interpret=True, sample_offset=4)
    assert pr._render_single_jit._cache_size() == n0
