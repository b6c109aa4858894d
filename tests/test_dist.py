"""Distributed rendering tests on the 8-virtual-device CPU mesh
(SURVEY.md §4: fake mesh is the standard answer to multi-chip CI).

The key property: the sharded render is BIT-IDENTICAL to the
single-chip render for any mesh layout, because RNG keys derive from
global (pixel, sample) indices (SURVEY.md §7 hard part (d))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracing_in_one_weekend_tpu.models import scene as scene_lib
from ray_tracing_in_one_weekend_tpu.models.camera import make_camera
from ray_tracing_in_one_weekend_tpu.ops.render import render
from ray_tracing_in_one_weekend_tpu.parallel import dist

KEY = jax.random.key(7)


def _cam(width=32, spp=4, **kw):
    kw.setdefault("aspect_ratio", 2.0)
    kw.setdefault("lookfrom", (0.0, 0.0, 0.0))
    kw.setdefault("lookat", (0.0, 0.0, -1.0))
    kw.setdefault("vfov_degrees", 90.0)
    kw.setdefault("defocus_angle_degrees", 0.0)
    kw.setdefault("focus_dist", 1.0)
    return make_camera(image_width=width, samples_per_pixel=spp, max_depth=6, **kw)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 1)])
def test_sharded_matches_single_chip(mesh_shape):
    sc = scene_lib.three_sphere_scene(pad_to=8)
    cam = _cam(width=32, spp=8)
    mesh = dist.make_mesh(mesh_shape)
    single = np.asarray(render(sc, cam, KEY, chunk_size=256))
    sharded = np.asarray(
        dist.render_image_distributed(sc, cam, KEY, mesh=mesh, chunk_size=64)
    )
    np.testing.assert_allclose(sharded, single, atol=2e-6)


def test_uneven_pixel_count_pads():
    # 30x15 = 450 pixels does not divide 8 shards evenly.
    sc = scene_lib.single_sphere_scene(pad_to=8)
    cam = _cam(width=30, spp=2)
    assert (cam.image_width * cam.image_height) % 8 != 0
    mesh = dist.make_mesh((8, 1))
    single = np.asarray(render(sc, cam, KEY, chunk_size=128))
    sharded = np.asarray(
        dist.render_image_distributed(sc, cam, KEY, mesh=mesh, chunk_size=32)
    )
    np.testing.assert_allclose(sharded, single, atol=2e-6)


def test_spp_not_divisible_raises():
    sc = scene_lib.single_sphere_scene(pad_to=8)
    cam = _cam(width=16, spp=3)
    mesh = dist.make_mesh((1, 8))
    with pytest.raises(ValueError, match="divide evenly"):
        dist.render_distributed(sc, cam, KEY, mesh)


def test_train_step_reduces_loss():
    """Inverse rendering: perturb an albedo, one SGD step moves it back."""
    sc = scene_lib.single_sphere_scene(pad_to=8)
    cam = _cam(width=16, spp=2)
    mesh = dist.make_mesh((4, 2))

    target = dist.render_image_distributed(sc, cam, KEY, mesh=mesh, chunk_size=32)

    params = dist.scene_params(sc)
    params["albedo"] = params["albedo"].at[0].add(jnp.asarray([0.3, -0.2, 0.1]))

    loss0, grads = dist.render_grads(
        params, sc, cam, target, KEY, mesh, chunk_size=32
    )
    assert float(loss0) > 0.0
    # gradient on the perturbed sphere's albedo is nonzero
    assert float(jnp.abs(grads["albedo"][0]).sum()) > 0.0

    # -grad on the smooth parameter (albedo: shading-only, no silhouette
    # discontinuities) is a descent direction for the deterministic
    # same-key loss: some step size reduces it.
    losses = []
    for lr in (30.0, 10.0, 3.0, 1.0):
        p2 = dict(params)
        p2["albedo"] = params["albedo"] - lr * grads["albedo"]
        loss_after, _ = dist.render_grads(
            p2, sc, cam, target, KEY, mesh, chunk_size=32
        )
        losses.append(float(loss_after))
    assert min(losses) < float(loss0)

    # train_step executes end-to-end and yields finite params.
    step_loss, new_params = dist.train_step(
        params, sc, cam, target, KEY, mesh, chunk_size=32, lr=0.1
    )
    assert np.isfinite(float(step_loss))
    for p in new_params.values():
        assert bool(jnp.all(jnp.isfinite(p)))


def test_grads_match_unsharded():
    """Parameter gradients are identical whatever the mesh layout."""
    sc = scene_lib.three_sphere_scene(pad_to=8)
    cam = _cam(width=16, spp=2)
    target = jnp.zeros((cam.image_height, cam.image_width, 3))
    params = dist.scene_params(sc)

    _, g1 = dist.render_grads(
        params, sc, cam, target, KEY, dist.make_mesh((1, 1)), chunk_size=64
    )
    _, g2 = dist.render_grads(
        params, sc, cam, target, KEY, dist.make_mesh((4, 2)), chunk_size=32
    )
    for f in dist.DIFF_FIELDS:
        np.testing.assert_allclose(
            np.asarray(g1[f]), np.asarray(g2[f]), rtol=1e-4, atol=1e-6
        )


# Finite-difference check of every differentiable leaf through the full
# training step on the 8-device mesh: train_step's update with lr = 1
# exposes the mesh-reduced gradient (p - p_new), which must match central
# differences of the same deterministic sharded loss. Indices and
# epsilons avoid visibility discontinuities (tests/test_grad.py).
_FD_CASES = {
    "albedo": (1e-3, 1e-5, 0.02, [(1, 2), (3, 0)]),
    "center": (3e-4, 2e-4, 0.2, [(1, 1), (1, 2)]),
    "radius": (3e-4, 2e-4, 0.2, [(1,)]),
    "fuzz": (1e-3, 1e-4, 0.1, [(3,)]),
    "ior": (1e-3, 1e-4, 0.1, [(2,)]),
}


@pytest.mark.parametrize("field", dist.DIFF_FIELDS)
def test_train_step_gradient_matches_fd(field):
    eps, atol, rtol, indices = _FD_CASES[field]
    sc = scene_lib.from_spheres(
        centers=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0]],
        radii=[100.0, 0.5, 0.5, 0.5],
        mat_types=[0, 0, 2, 1],
        albedos=[[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [1.0, 1.0, 1.0], [0.8, 0.6, 0.2]],
        fuzzes=[0.0, 0.0, 0.0, 0.2],
        pad_to=8,
    )
    cam = make_camera(
        image_width=24, aspect_ratio=2.0, samples_per_pixel=2, max_depth=4,
        vfov_degrees=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
        defocus_angle_degrees=0.0, focus_dist=1.0,
    )
    mesh = dist.make_mesh((4, 2))
    target = jnp.zeros((cam.image_height, cam.image_width, 3), jnp.float32)
    params = dist.scene_params(sc)
    _, new = dist.train_step(params, sc, cam, target, KEY, mesh, chunk_size=64, lr=1.0)
    grad = np.asarray(params[field]) - np.asarray(new[field])
    assert np.all(np.isfinite(grad))

    loss = jax.jit(
        lambda p: dist.render_loss(p, sc, cam, target, KEY, mesh, 64)
    )
    for idx in indices:
        def at(delta):
            x = np.asarray(params[field]).copy()
            x[idx] += delta
            return float(loss({**params, field: jnp.asarray(x)}))

        fd = (at(eps) - at(-eps)) / (2 * eps)
        assert np.isclose(grad[idx], fd, atol=atol, rtol=rtol), (
            f"{field}[{idx}]: train_step gradient {grad[idx]:.6f} vs FD {fd:.6f}"
        )
