"""Gradient correctness: AD vs central finite differences (the BASELINE
"grad allclose vs FD" gate), plus an inverse-rendering recovery smoke test.

Renders are deterministic for a fixed seed, so FD sees the exact same
sample paths as AD and comparisons are quadrature-tight for smooth
parameters (albedo, emission, sky). Geometry tests use an interior-
dominated view (sphere covering the whole frame) so the excluded
visibility/silhouette gradients cannot contaminate FD.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax.grad import diff


H, W, SPP, BOUNCES = 8, 8, 4, 2
SEED = jnp.uint32(7)
CAM = pt.Camera.reference()


def _loss(scene, target):
    img = pt.render_radiance(scene, CAM, H, W, SPP, BOUNCES, SEED)
    return jnp.mean((img - target) ** 2)


def _target(scene):
    return pt.render_radiance(scene, CAM, H, W, SPP, BOUNCES, jnp.uint32(123))


def _fd(f, x0, eps):
    """Central finite difference of scalar f at every coordinate of x0."""
    x0 = np.asarray(x0, np.float64)
    g = np.zeros_like(x0)
    it = np.nditer(x0, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        xp = x0.copy()
        xp[idx] += eps
        xm = x0.copy()
        xm[idx] -= eps
        g[idx] = (f(xp) - f(xm)) / (2 * eps)
    return g


def _check_leaf(scene, target, get, put, eps, rtol, atol, nonzero=True):
    """Compare AD and FD gradients for one scene leaf."""
    grads = jax.grad(lambda sc: _loss(sc, target), allow_int=True)(scene)
    ad = np.asarray(get(grads), np.float64)

    def f(x):
        return float(_loss(put(scene, jnp.asarray(x, jnp.float32)), target))

    fd = _fd(f, get(scene), eps)
    np.testing.assert_allclose(ad, fd, rtol=rtol, atol=atol)
    if nonzero:
        assert np.any(np.abs(ad) > 1e-7), "gradient identically zero — vacuous test"


def _replace_mat(scene, **kw):
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **kw)
    )


def test_albedo_gradient_matches_fd():
    scene = demo.diffuse_sphere_scene()
    target = _target(scene)
    _check_leaf(
        scene,
        target,
        get=lambda s: s.materials.albedo,
        put=lambda s, x: _replace_mat(s, albedo=x),
        eps=1e-3,
        rtol=2e-2,
        atol=1e-5,
    )


def test_emission_gradient_matches_fd():
    scene = demo.cornell_spheres_scene()
    target = _target(scene)
    _check_leaf(
        scene,
        target,
        get=lambda s: s.materials.emission_strength,
        put=lambda s, x: _replace_mat(s, emission_strength=x),
        eps=1e-3,
        rtol=2e-2,
        atol=1e-5,
    )


def test_sky_gradient_matches_fd():
    scene = demo.diffuse_sphere_scene()
    target = _target(scene)
    _check_leaf(
        scene,
        target,
        get=lambda s: s.sky_color,
        put=lambda s, x: dataclasses.replace(s, sky_color=x),
        eps=1e-3,
        rtol=2e-2,
        atol=1e-6,
    )


def _fullframe_sphere_scene():
    """A sphere covering the entire frame: no silhouette pixels, so the
    interior geometry gradient applies (which, under the reference shading
    model, is exactly zero — see grad/diff.py docstring)."""
    b = pt.SceneBuilder(sky_color=(0.8, 0.8, 1.0))
    m = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7)
    b.add_sphere(center=(0.0, 0.0, 4.0), radius=3.5, material=m)
    return b.build()


def test_sphere_geometry_gradient_matches_fd():
    """AD == FD for geometry. Away from silhouettes the reference shading
    model has no continuous geometry dependence (radiance is a product of
    albedos/emissions selected by discrete events), so both sides are zero
    and must agree exactly; the test still guards against AD inventing a
    spurious nonzero interior gradient or NaNs."""
    scene = _fullframe_sphere_scene()
    target = _target(scene)

    # center
    _check_leaf(
        scene,
        target,
        get=lambda s: s.spheres.center,
        put=lambda s, x: dataclasses.replace(
            s, spheres=dataclasses.replace(s.spheres, center=x)
        ),
        eps=1e-3,
        rtol=5e-2,
        atol=1e-4,
        nonzero=False,
    )
    # radius
    _check_leaf(
        scene,
        target,
        get=lambda s: s.spheres.radius,
        put=lambda s, x: dataclasses.replace(
            s, spheres=dataclasses.replace(s.spheres, radius=x)
        ),
        eps=1e-3,
        rtol=5e-2,
        atol=1e-4,
        nonzero=False,
    )


def test_triangle_geometry_gradient_finite_and_matches_fd():
    """Triangle vertex AD grads are finite and agree with FD (both zero in
    the interior regime — see test_sphere_geometry_gradient_matches_fd)."""
    b = pt.SceneBuilder(sky_color=(0.1, 0.1, 0.1))
    m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=1.0)
    light = b.add_material(
        albedo=(1, 1, 1), emission_color=(1, 1, 1), emission_strength=5.0
    )
    b.add_sphere(center=(0, 8, 4), radius=4.0, material=light)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=m)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50), material=m)
    scene = b.build()
    target = _target(scene)
    grads = jax.grad(lambda sc: _loss(sc, target), allow_int=True)(scene)
    for leaf in [grads.triangles.v0, grads.triangles.v1, grads.triangles.v2]:
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_gradients_finite_everywhere():
    """No NaN/inf in any leaf gradient on the hardest scene (glass+mirror)."""
    scene = demo.demo_scene()
    target = _target(scene)
    grads = jax.grad(lambda sc: _loss(sc, target), allow_int=True)(scene)
    for leaf in jax.tree_util.tree_leaves(grads):
        if np.asarray(leaf).dtype.kind == "f":
            assert np.all(np.isfinite(np.asarray(leaf)))


def test_remat_matches_plain_gradient():
    scene = demo.diffuse_sphere_scene()
    target = _target(scene)

    def loss(sc, remat):
        img = pt.render_radiance(sc, CAM, H, W, SPP, BOUNCES, SEED, remat=remat)
        return jnp.mean((img - target) ** 2)

    g1 = jax.grad(lambda sc: loss(sc, False), allow_int=True)(scene)
    g2 = jax.grad(lambda sc: loss(sc, True), allow_int=True)(scene)
    for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        if np.asarray(a).dtype.kind == "f":
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7
            )


@pytest.mark.slow
def test_inverse_rendering_recovers_albedo():
    """BASELINE config 4 (miniature): recover a perturbed albedo."""
    true_scene = demo.diffuse_sphere_scene()
    target = pt.render_radiance(
        true_scene, CAM, 16, 16, 8, 2, jnp.uint32(999)
    )
    # corrupt the albedo badly
    wrong = _replace_mat(
        true_scene, albedo=jnp.full_like(true_scene.materials.albedo, 0.5)
    )
    fitted, losses = diff.fit_materials(
        wrong, target, CAM, 16, 16, 8, 2, steps=40, lr=0.1
    )
    # Loss bottoms out at the fresh-seed Monte-Carlo noise floor, so the
    # sharp check is parameter recovery, not the loss value itself.
    assert losses[-1] < losses[0], f"loss {losses[0]} -> {losses[-1]}"
    got = np.asarray(fitted.materials.albedo[0])
    want = np.asarray(true_scene.materials.albedo[0])
    assert np.abs(got - want).max() < 0.1, f"{got} vs {want}"
