"""Compiled Triton kernels vs the plain XLA paths, on the card.

Marked ``gpu``: each test skips unless JAX's default backend is a GPU.
Run on a GPU host with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
The kernels and the XLA paths contract mul+add into FMA differently, so a
small share of pixels may take another discrete path (a grazing hit, a
TIR branch); the gates allow that share and bound the mean difference.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax.models.physical import render_physical
from path_tracer_jax.ops.pallas_kernels import render_pallas, render_pallas_vjp
from path_tracer_jax.ops.pallas_physical import (
    render_physical_pallas, render_physical_pallas_vjp,
)

pytestmark = pytest.mark.gpu
CAM = pt.Camera.reference()


def _close(a, b, frac=1e-2, mean=1e-3):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert np.isfinite(np.asarray(a)).all()
    assert (d > 1e-3).mean() <= frac, (d > 1e-3).mean()
    assert d.mean() <= mean, d.mean()


def test_render_pallas_matches_xla(gpu):
    scene = demo.glossy_scene()
    args = (scene, CAM, 128, 128, 8, 4, jnp.uint32(3))
    _close(render_pallas(*args), pt.render_radiance(*args))


def test_render_physical_pallas_matches_xla(gpu):
    scene = demo.cornell_spheres_scene()
    args = (scene, CAM, 128, 128, 8, 4, jnp.uint32(3))
    _close(render_physical_pallas(*args), render_physical(*args))


@pytest.mark.parametrize("tier", ["reference", "physical"])
def test_fused_gradient_matches_core_ad(gpu, tier):
    scene = demo.random_spheres_scene()
    h = w = 64
    if tier == "reference":
        fast = lambda sc: render_pallas_vjp(sc, CAM, h, w, 4, 3, jnp.uint32(5))
        core = lambda sc: pt.render_radiance(sc, CAM, h, w, 4, 3,
                                             jnp.uint32(5), remat=True)
    else:
        fast = lambda sc: render_physical_pallas_vjp(
            sc, CAM, h, w, 4, 3, jnp.uint32(5), jitter=False, geom=False)
        core = lambda sc: render_physical(sc, CAM, h, w, 4, 3, jnp.uint32(5),
                                          jitter=False, remat=True)

    def grad(render):
        def loss(albedo):
            sc = dataclasses.replace(scene, materials=dataclasses.replace(
                scene.materials, albedo=albedo))
            return jnp.mean(render(sc) ** 2)
        return np.asarray(jax.grad(loss)(scene.materials.albedo))

    gf, gc = grad(fast), grad(core)
    assert np.abs(gf - gc).max() <= 2e-2 * np.abs(gc).max()
