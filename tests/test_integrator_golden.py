"""Golden-image tests: the vectorized wavefront integrator vs the scalar
NumPy oracle on tiny frames (SURVEY.md SS4 strategy (a)/(c)).

Both sides draw bit-identical PCG streams; remaining differences are f32
libm rounding, which can flip a rare chaotic path on silhouette edges —
hence the percentile-based comparison.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
import reference_tracer as ref


def _compare(scene, h, w, spp, bounces, seed):
    cam = pt.Camera.reference()
    img = np.asarray(
        pt.render_radiance(scene, cam, h, w, spp, bounces, jnp.uint32(seed))
    )
    gold = ref.render(scene, h, w, spp, bounces, seed)
    err = np.abs(img - gold)
    # Nearly all pixels must match tightly; allow <=1% chaotic outliers.
    assert np.quantile(err, 0.99) < 5e-4, (
        f"99th pct err {np.quantile(err, 0.99)}"
    )
    assert err.mean() < 1e-3, f"mean err {err.mean()}"
    return img, gold


def test_golden_diffuse_sphere():
    _compare(demo.diffuse_sphere_scene(), 12, 16, 2, 2, seed=5)


def test_golden_demo_scene():
    # Full reference demo scene: mirror + glass + emissive sun + triangles.
    _compare(demo.demo_scene(), 12, 16, 2, 4, seed=11)


def test_golden_cornell():
    _compare(demo.cornell_spheres_scene(), 10, 12, 2, 3, seed=2)


# -- physical tier vs its own scalar oracle -------------


def _compare_physical(scene, h, w, spp, bounces, seed, nee=True):
    from path_tracer_jax.models.physical import render_physical

    cam = pt.Camera.reference()
    img = np.asarray(
        render_physical(scene, cam, h, w, spp, bounces, jnp.uint32(seed),
                        nee=nee, jitter=False)
    )
    gold = ref.render_physical(scene, h, w, spp, bounces, seed, nee=nee)
    err = np.abs(img - gold)
    assert np.quantile(err, 0.99) < 5e-4, (
        f"99th pct err {np.quantile(err, 0.99)}"
    )
    assert err.mean() < 1e-3, f"mean err {err.mean()}"


def test_golden_physical_cornell():
    """BRDF mixture + NEE cone sampling + shadow rays + single-counting,
    pinned by a third, fully independent scalar implementation."""
    _compare_physical(demo.cornell_spheres_scene(), 10, 12, 2, 3, seed=7)


def test_golden_physical_glossy():
    _compare_physical(demo.glossy_scene(), 10, 12, 2, 3, seed=3)


def test_golden_physical_nee_off():
    _compare_physical(demo.cornell_spheres_scene(), 10, 12, 2, 3, seed=5,
                      nee=False)


def test_golden_physical_no_emitters():
    """n_em == 0: NEE inactive, Le always added."""
    _compare_physical(demo.diffuse_sphere_scene(), 10, 12, 2, 2, seed=9)


def test_determinism_same_seed():
    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    a = pt.render_radiance(scene, cam, 16, 16, 4, 2, jnp.uint32(3))
    b = pt.render_radiance(scene, cam, 16, 16, 4, 2, jnp.uint32(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_different_seeds_differ():
    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    a = pt.render_radiance(scene, cam, 16, 16, 2, 2, jnp.uint32(3))
    b = pt.render_radiance(scene, cam, 16, 16, 2, 2, jnp.uint32(4))
    assert not np.allclose(np.asarray(a), np.asarray(b))


def test_spp_convergence():
    """More samples -> closer to a high-spp estimate (MC sanity)."""
    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    hi = np.asarray(pt.render_radiance(scene, cam, 8, 8, 256, 2, jnp.uint32(0)))
    lo4 = np.asarray(pt.render_radiance(scene, cam, 8, 8, 4, 2, jnp.uint32(1)))
    lo64 = np.asarray(pt.render_radiance(scene, cam, 8, 8, 64, 2, jnp.uint32(1)))
    assert np.abs(lo64 - hi).mean() < np.abs(lo4 - hi).mean()


def test_sample_offset_continues_stream():
    """mean(spp=8) == mean of two offset halves — the checkpoint/resume and
    spp-sharding identity."""
    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    full = np.asarray(pt.render_radiance(scene, cam, 8, 8, 8, 2, jnp.uint32(0)))
    h1 = np.asarray(
        pt.render_radiance(scene, cam, 8, 8, 4, 2, jnp.uint32(0), sample_offset=0)
    )
    h2 = np.asarray(
        pt.render_radiance(scene, cam, 8, 8, 4, 2, jnp.uint32(0), sample_offset=4)
    )
    np.testing.assert_allclose(full, (h1 + h2) / 2, rtol=1e-5, atol=1e-6)


def test_sky_only_scene():
    b = pt.SceneBuilder(sky_color=(0.2, 0.4, 0.6))
    scene = b.build()
    cam = pt.Camera.reference()
    img = np.asarray(pt.render_radiance(scene, cam, 4, 4, 1, 2, jnp.uint32(0)))
    np.testing.assert_allclose(img, np.broadcast_to([0.2, 0.4, 0.6], img.shape), atol=1e-6)


def test_emissive_direct_hit():
    """A pixel looking straight at an emitter sees Le (+ bounces)."""
    b = pt.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    m = b.add_material(
        albedo=(0, 0, 0), emission_color=(1.0, 0.5, 0.25), emission_strength=2.0
    )
    b.add_sphere(center=(0, 0, 5), radius=2.0, material=m)
    scene = b.build()
    cam = pt.Camera.reference()
    img = np.asarray(pt.render_radiance(scene, cam, 9, 9, 1, 2, jnp.uint32(0)))
    np.testing.assert_allclose(img[4, 4], [2.0, 1.0, 0.5], atol=1e-5)


def test_image_u8_conversion():
    rad = jnp.asarray([[[0.0, 0.5, 2.0]]])
    u8 = np.asarray(pt.render_image_u8(rad))
    assert u8.dtype == np.uint8
    assert list(u8[0, 0]) == [0, 128, 255]


def test_golden_cpu_tier():
    """The "cpu" capability tier (biased sampler, roughness*0.5, IOR 1.5,
    per-sample clamp — SURVEY.md SS3.3) vs the scalar oracle."""
    scene = demo.demo_scene()
    cam = pt.Camera.reference()
    h, w, spp, bounces, seed = 12, 16, 2, 4, 21
    img = np.asarray(
        pt.render_radiance(
            scene, cam, h, w, spp, bounces, jnp.uint32(seed), variant="cpu"
        )
    )
    gold = ref.render(scene, h, w, spp, bounces, seed, variant="cpu")
    err = np.abs(img - gold)
    assert np.quantile(err, 0.99) < 5e-4, np.quantile(err, 0.99)
    assert img.max() <= 1.0  # per-sample clamp (src/renderer.c:88)


def test_cpu_tier_differs_from_gpu_tier():
    scene = demo.demo_scene()
    cam = pt.Camera.reference()
    a = np.asarray(
        pt.render_radiance(scene, cam, 8, 8, 2, 3, jnp.uint32(1), variant="gpu")
    )
    b = np.asarray(
        pt.render_radiance(scene, cam, 8, 8, 2, 3, jnp.uint32(1), variant="cpu")
    )
    assert not np.allclose(a, b)


def test_bounce_stats_conservation():
    """Per-bounce event histogram obeys ray conservation: every ray at
    bounce b either hits or misses, and the rays reaching bounce b+1 are
    exactly bounce b's hits minus its TIR deaths."""
    from path_tracer_jax.models.integrator import render_bounce_stats

    scene = demo.glass_scene() if hasattr(demo, "glass_scene") else demo.demo_scene()
    cam = pt.Camera.reference()
    h, w, spp, bounces = 16, 32, 4, 5
    st = render_bounce_stats(scene, cam, h, w, spp, bounces, jnp.uint32(3))
    hits = np.asarray(st["hits"])
    misses = np.asarray(st["misses"])
    tir = np.asarray(st["tir_deaths"])
    assert hits.shape == (bounces + 1,)
    assert hits[0] + misses[0] == h * w * spp
    for b in range(1, bounces + 1):
        assert hits[b] + misses[b] == hits[b - 1] - tir[b - 1], b
    assert (tir <= hits).all()
