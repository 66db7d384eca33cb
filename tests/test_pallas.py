"""Pallas megakernel vs the core integrator (interpreter mode on CPU).

Both paths consume identical PCG streams, so interpreter-mode Pallas and
the XLA core path should agree to f32 rounding on every scene.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax.ops.pallas_kernels import render_pallas, render_pallas_vjp


CAM = pt.Camera.reference()


def _compare(scene, h, w, spp, bounces, seed, tile, jitter=False):
    core = np.asarray(
        pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
                           jitter=jitter)
    )
    fast = np.asarray(
        render_pallas(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=tile, interpret=True, jitter=jitter,
        )
    )
    err = np.abs(core - fast)
    assert np.quantile(err, 0.999) < 1e-4, np.quantile(err, 0.999)
    assert err.mean() < 1e-5, err.mean()


def test_pallas_matches_core_diffuse():
    _compare(demo.diffuse_sphere_scene(), 16, 128, 2, 2, 3, tile=(8, 128))


def test_pallas_matches_core_demo():
    _compare(demo.demo_scene(), 16, 128, 2, 4, 11, tile=(8, 128))


def test_pallas_matches_core_cornell():
    _compare(demo.cornell_spheres_scene(), 16, 128, 2, 3, 5, tile=(16, 128))


def test_pallas_tile_grid_cov():
    """Multiple tiles in both grid dimensions."""
    _compare(demo.diffuse_sphere_scene(), 32, 256, 1, 2, 9, tile=(16, 128))


def test_pallas_matches_core_jitter():
    """Anti-aliasing jitter: per-sample sub-pixel rays, same draw order as
    primary_rays(jitter_state) — the config-5 quality path on the fast
    kernel."""
    _compare(demo.demo_scene(), 16, 128, 2, 3, 21, tile=(8, 128),
             jitter=True)


def test_pallas_jitter_differs_from_centered():
    fast = render_pallas(
        demo.demo_scene(), CAM, 8, 128, 2, 2, jnp.uint32(3),
        tile=(8, 128), interpret=True, jitter=True,
    )
    centered = render_pallas(
        demo.demo_scene(), CAM, 8, 128, 2, 2, jnp.uint32(3),
        tile=(8, 128), interpret=True,
    )
    assert np.abs(np.asarray(fast) - np.asarray(centered)).max() > 1e-4


def test_pallas_count_rounds():
    """count_rounds: identical image, executed-round counter bounded by
    the nominal budget, exact on an all-sky scene (every tile exits after
    round 0) — the honest denominator for rays_per_sec_executed
."""
    scene = demo.demo_scene()
    h, w, spp, bounces = 16, 256, 2, 3
    plain = np.asarray(
        render_pallas(scene, CAM, h, w, spp, bounces, jnp.uint32(5),
                      tile=(8, 128), interpret=True)
    )
    img, cnt = render_pallas(scene, CAM, h, w, spp, bounces, jnp.uint32(5),
                             tile=(8, 128), interpret=True,
                             count_rounds=True)
    np.testing.assert_array_equal(plain, np.asarray(img))
    n_tiles = (h // 8) * (w // 128)
    nominal = n_tiles * spp * (bounces + 1)
    assert 0 < int(cnt) <= nominal, (int(cnt), nominal)

    # all-sky scene: under the default whole-tile gate (no jitter) the
    # sample loop is skipped entirely -> 0 executed rounds; the
    # per-round scheme executes exactly 1 round per (tile, sample)
    b = pt.SceneBuilder(sky_color=(0.2, 0.3, 0.4))
    b.add_material(albedo=(1.0, 0.0, 0.0))
    b.add_sphere(center=(0.0, 0.0, -100.0), radius=1.0, material=0)  # behind
    sky_scene = b.build()
    img_sky, cnt_sky = render_pallas(sky_scene, CAM, h, w, spp, bounces,
                                     jnp.uint32(5), tile=(8, 128),
                                     interpret=True, count_rounds=True)
    assert int(cnt_sky) == 0, int(cnt_sky)
    np.testing.assert_array_equal(
        np.asarray(img_sky),
        np.broadcast_to(np.asarray([0.2, 0.3, 0.4], np.float32), (h, w, 3)),
    )
    _, cnt_sky_t = render_pallas(sky_scene, CAM, h, w, spp, bounces,
                                 jnp.uint32(5), tile=(8, 128),
                                 interpret=True, count_rounds=True,
                                 early_exit=True)
    assert int(cnt_sky_t) == n_tiles * spp, (int(cnt_sky_t), n_tiles * spp)

    # physical kernel: same contract
    from path_tracer_jax.ops.pallas_physical import render_physical_pallas

    plain_p = np.asarray(
        render_physical_pallas(scene, CAM, h, w, spp, bounces,
                               jnp.uint32(5), tile=(8, 128), interpret=True)
    )
    img_p, cnt_p = render_physical_pallas(
        scene, CAM, h, w, spp, bounces, jnp.uint32(5), tile=(8, 128),
        interpret=True, count_rounds=True,
    )
    np.testing.assert_array_equal(plain_p, np.asarray(img_p))
    assert 0 < int(cnt_p) <= nominal


def test_pallas_early_exit_schemes_bit_identical():
    """The three early-exit schemes ("once" default, per-round True,
    no-check False) must produce bit-identical images: skipped rounds
    only ever add exact zeros, so the check placement is pure schedule.
    Covers the forward, the physical forward, and both fused kernels
    (primal + Jacobian planes)."""
    from path_tracer_jax.ops.pallas_grad import render_pallas_fused
    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas, render_physical_pallas_fused,
    )

    scene = demo.demo_scene()  # sky region -> tiles that die at round 0
    h, w, spp, bounces, seed = 16, 256, 2, 3, 9
    base = np.asarray(
        render_pallas(scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
                      tile=(8, 128), interpret=True)
    )
    for mode in (True, False):
        alt = np.asarray(
            render_pallas(scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
                          tile=(8, 128), interpret=True, early_exit=mode)
        )
        np.testing.assert_array_equal(base, alt)

    basep = np.asarray(
        render_physical_pallas(scene, CAM, h, w, spp, bounces,
                               jnp.uint32(seed), tile=(8, 128),
                               interpret=True)
    )
    for mode in (True, False):
        altp = np.asarray(
            render_physical_pallas(scene, CAM, h, w, spp, bounces,
                                   jnp.uint32(seed), tile=(8, 128),
                                   interpret=True, early_exit=mode)
        )
        np.testing.assert_array_equal(basep, altp)

    img0, jac0 = render_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), tile=(8, 128),
        interpret=True,
    )
    img1, jac1 = render_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), tile=(8, 128),
        interpret=True, early_exit=True,
    )
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    np.testing.assert_array_equal(np.asarray(jac0), np.asarray(jac1))

    # all-sky scene exercises the fused kernel's whole-tile gate branch
    # (primal == sky, K plane == spp, everything else zero)
    bsky = pt.SceneBuilder(sky_color=(0.2, 0.3, 0.4))
    bsky.add_material(albedo=(1.0, 0.0, 0.0))
    bsky.add_sphere(center=(0.0, 0.0, -100.0), radius=1.0, material=0)
    sky_scene = bsky.build()
    s0, sj0 = render_pallas_fused(
        sky_scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True,
    )
    s1, sj1 = render_pallas_fused(
        sky_scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, early_exit=True,
    )
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(sj0), np.asarray(sj1))

    # gated branches of the physical kernels on the all-sky scene
    # (jitter=False activates the whole-tile probe)
    ps0 = np.asarray(render_physical_pallas(
        sky_scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False))
    ps1 = np.asarray(render_physical_pallas(
        sky_scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False, early_exit=True))
    np.testing.assert_array_equal(ps0, ps1)
    pf0, pfj0, pfg0 = render_physical_pallas_fused(
        sky_scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False, n_em_cap=1)
    pf1, pfj1, pfg1 = render_physical_pallas_fused(
        sky_scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False, n_em_cap=1,
        early_exit=True)
    np.testing.assert_array_equal(np.asarray(pf0), np.asarray(pf1))
    np.testing.assert_array_equal(np.asarray(pfj0), np.asarray(pfj1))
    np.testing.assert_array_equal(np.asarray(pfg0), np.asarray(pfg1))

    p0, pj0, pg0 = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), tile=(8, 128),
        interpret=True, jitter=False, n_em_cap=1,
    )
    p1, pj1, pg1 = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), tile=(8, 128),
        interpret=True, jitter=False, n_em_cap=1, early_exit=True,
    )
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
    np.testing.assert_array_equal(np.asarray(pj0), np.asarray(pj1))
    np.testing.assert_array_equal(np.asarray(pg0), np.asarray(pg1))


def test_pallas_divisibility_error():
    with pytest.raises(ValueError):
        render_pallas(
            demo.diffuse_sphere_scene(), CAM, 20, 128, 1, 2, jnp.uint32(0),
            tile=(16, 128), interpret=True,
        )


def test_pallas_vjp_matches_core_grad():
    import dataclasses

    scene = demo.diffuse_sphere_scene()
    h, w, spp, bounces = 8, 128, 2, 2
    target = pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(55))

    def loss_fast(albedo):
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = render_pallas_vjp(sc, CAM, h, w, spp, bounces, jnp.uint32(4), interpret=True)
        return jnp.mean((img - target) ** 2)

    def loss_core(albedo):
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = pt.render_radiance(sc, CAM, h, w, spp, bounces, jnp.uint32(4))
        return jnp.mean((img - target) ** 2)

    a0 = scene.materials.albedo
    g_fast = np.asarray(jax.grad(loss_fast)(a0))
    g_core = np.asarray(jax.grad(loss_core)(a0))
    np.testing.assert_allclose(g_fast, g_core, rtol=1e-3, atol=1e-7)


def test_pallas_beyond_reference_object_caps():
    """The reference's GPU path caps scenes at 32 materials / 32 spheres
    / 32 triangles (rtx_frag.glsl:54-60). The kernel's scene tables have no
    such cap: a 200-sphere, 48-material scene renders through the
    megakernel and matches the core path."""
    rng_ = np.random.default_rng(0)
    b = pt.SceneBuilder(sky_color=(0.35, 0.45, 0.6))
    mats = [
        b.add_material(
            albedo=tuple(0.2 + 0.7 * rng_.random(3)),
            roughness=float(rng_.random()),
            emission_strength=float(3.0 * (rng_.random() < 0.1)),
            emission_color=(1.0, 0.9, 0.8),
        )
        for _ in range(48)
    ]
    for i in range(200):
        b.add_sphere(
            center=tuple(rng_.normal(0, 4.0, 3) + np.array([0, 0, 10.0])),
            radius=float(0.2 + 0.5 * rng_.random()),
            material=mats[i % len(mats)],
        )
    b.add_triangle(v0=(-60, -6, -60), v1=(60, -6, -60), v2=(0, -6, 80),
                   material=mats[0])
    scene = b.build()
    assert scene.num_spheres == 200 and scene.num_materials == 48

    h, w, spp, bounces, seed = 8, 128, 1, 2, 41
    core = np.asarray(
        pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(seed))
    )
    fast = np.asarray(
        render_pallas(scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
                      tile=(8, 128), interpret=True)
    )
    assert np.isfinite(fast).all() and fast.max() > 0
    err = np.abs(core - fast)
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
