"""Split-estimator tests: golden parity vs the scalar oracle, exactness
against single-path selection for deterministic trees, mean-equivalence
+ variance reduction at t = 0.5."""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.models.split import render_split
from path_tracer_jax.models.integrator import render_radiance

import reference_tracer as ref


def _split_scene(transparency=0.5, roughness=0.15):
    b = pt.SceneBuilder(sky_color=(0.55, 0.7, 0.9))
    semi = b.add_material(
        albedo=(0.9, 0.85, 0.8), roughness=roughness,
        transparency=transparency, refractive_index=1.4,
    )
    diffuse = b.add_material(albedo=(0.6, 0.3, 0.2), roughness=1.0)
    light = b.add_material(
        albedo=(1.0, 1.0, 1.0), emission_color=(1.0, 0.9, 0.7),
        emission_strength=3.0,
    )
    b.add_sphere(center=(0.0, 0.0, 4.0), radius=1.2, material=semi)
    b.add_sphere(center=(2.0, 1.0, 6.0), radius=0.8, material=light)
    b.add_triangle(v0=(-30.0, -1.5, -10.0), v1=(30.0, -1.5, -10.0),
                   v2=(0.0, -1.5, 60.0), material=diffuse)
    return b.build()


def test_split_matches_scalar_oracle():
    """Vectorized breadth-first split == the scalar BFS oracle, pixelwise
    (same per-node RNG contract)."""
    scene = _split_scene()
    h, w, spp, bounces, seed = 5, 6, 2, 3, 11
    got = np.asarray(
        render_split(scene, pt.Camera.reference(), h, w, spp, bounces,
                     jnp.uint32(seed))
    )
    want = ref.render_split(scene, h, w, spp, bounces, seed)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_split_equals_single_path_when_deterministic():
    """roughness == 0 and t in {0, 1}: the split tree is a chain, no RNG
    reaches radiance, and split == single-path selection EXACTLY."""
    b = pt.SceneBuilder(sky_color=(0.3, 0.5, 0.8))
    mirror = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=0.0)
    glass = b.add_material(
        albedo=(0.95, 0.95, 0.99), roughness=0.0, transparency=1.0,
        refractive_index=1.5,
    )
    b.add_sphere(center=(-0.8, 0.0, 4.0), radius=1.0, material=mirror)
    b.add_sphere(center=(1.3, 0.2, 5.0), radius=1.0, material=glass)
    scene = b.build()
    h, w, spp, bounces = 6, 8, 1, 4
    cam = pt.Camera.reference()
    split = np.asarray(
        render_split(scene, cam, h, w, spp, bounces, jnp.uint32(3))
    )
    single = np.asarray(
        render_radiance(scene, cam, h, w, spp, bounces, jnp.uint32(3))
    )
    np.testing.assert_allclose(split, single, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_split_mean_matches_single_path_and_reduces_variance():
    """At t = 0.5 the two estimators share an expectation (convex split
    vs unbiased branch pick) and the split has strictly lower variance.
    K independent 1-spp renders per estimator; compare per-pixel means
    within MC error and mean per-pixel variances.

    The K renders run as ONE jitted vmap batch per estimator (not K
    traced calls): round-2 review found the full suite segfaulting in
    XLA's CPU compiler at this test after ~118 green tests — 96 separate
    traces of render_split's level-doubling scan graph on top of the
    suite's accumulated compile state tickled a compiler crash, and also
    took ~7 minutes. One compile per estimator avoids both.
    """
    import jax

    scene = _split_scene(transparency=0.5, roughness=0.3)
    h, w, bounces = 6, 8, 3
    cam = pt.Camera.reference()
    K = 96
    seeds = jnp.arange(1000, 1000 + K, dtype=jnp.uint32)
    split_runs = np.asarray(
        jax.jit(jax.vmap(
            lambda s: render_split(scene, cam, h, w, 1, bounces, s)
        ))(seeds)
    )
    single_runs = np.asarray(
        jax.jit(jax.vmap(
            lambda s: render_radiance(scene, cam, h, w, 1, bounces, s)
        ))(seeds)
    )
    m_split = split_runs.mean(0)
    m_single = single_runs.mean(0)
    v_split = split_runs.var(0)
    v_single = single_runs.var(0)

    # mean parity within ~4 standard errors of the noisier estimator
    se = np.sqrt((v_split + v_single) / K)
    diff = np.abs(m_split - m_single)
    assert (diff <= 4.0 * se + 5e-3).mean() > 0.99, (
        diff.max(), (4.0 * se + 5e-3)[np.unravel_index(diff.argmax(),
                                                       diff.shape)]
    )
    # variance reduction: the split removes the branch-pick randomness
    assert v_split.mean() < 0.8 * v_single.mean(), (
        v_split.mean(), v_single.mean()
    )


def test_split_bounce_budget_guard():
    scene = _split_scene()
    with pytest.raises(ValueError):
        render_split(scene, pt.Camera.reference(), 4, 4, 1, 11,
                     jnp.uint32(0))
