"""Physical-tier Pallas megakernel vs models/physical.py (interpreter mode).

Both paths consume identical PCG streams (7-draw schedule + optional
jitter draws), so interpreter-mode Pallas and the XLA core physical path
must agree to f32 rounding on every scene — the same strategy as
tests/test_pallas.py for the reference tier.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax.models.physical import render_physical
from path_tracer_jax.ops.pallas_physical import render_physical_pallas


CAM = pt.Camera.reference()


def _compare(scene, h, w, spp, bounces, seed, tile, jitter=True, nee=True,
             tri_nee=False):
    core = np.asarray(
        render_physical(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            jitter=jitter, nee=nee, tri_nee=tri_nee,
        )
    )
    fast = np.asarray(
        render_physical_pallas(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=tile, interpret=True, jitter=jitter, nee=nee,
            tri_nee=tri_nee,
        )
    )
    err = np.abs(core - fast)
    # Both run the same estimator on bit-identical RNG streams, but XLA
    # contracts mul+add into FMA differently for the two compilations, so
    # hit distances differ by ulps; grazing-incidence geometry and NEE
    # rim-visibility amplify a tiny fraction of those into discrete path
    # flips (big per-pixel diffs, zero in expectation). Assert: nearly all
    # pixels rounding-tight, flips rare, image means agree.
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()
    assert abs(core.mean() - fast.mean()) < 2e-3, (core.mean(), fast.mean())


def test_phys_pallas_matches_core_cornell():
    """Emissive sphere + NEE shadow rays + mirror + glass."""
    _compare(demo.cornell_spheres_scene(), 16, 128, 2, 3, 7, tile=(8, 128))


def test_phys_pallas_matches_core_glossy():
    """The bench scene (config 3): emissive sun, roughness mix, glass."""
    _compare(demo.glossy_scene(), 16, 128, 2, 4, 11, tile=(8, 128))


def test_phys_pallas_matches_core_no_jitter():
    _compare(demo.cornell_spheres_scene(), 8, 128, 2, 3, 3, tile=(8, 128),
             jitter=False)


def test_phys_pallas_matches_core_nee_off():
    """Pure BSDF sampling (no light sampling): same draw schedule, no
    shadow rays."""
    _compare(demo.cornell_spheres_scene(), 8, 128, 2, 3, 5, tile=(8, 128),
             nee=False)


def test_phys_pallas_matches_core_no_emitters():
    """n_em == 0: NEE terms vanish, picks are clamped, no NaNs."""
    _compare(demo.diffuse_sphere_scene(), 8, 128, 2, 2, 9, tile=(8, 128))


def test_phys_pallas_tile_grid_cov():
    _compare(demo.cornell_spheres_scene(), 16, 256, 1, 2, 13, tile=(8, 128))


def test_phys_pallas_row_block_matches_full():
    """row_start/rows sharding contract: block renders == full-image rows."""
    scene = demo.cornell_spheres_scene()
    h, w, spp, bounces, seed = 16, 128, 2, 3, 17
    full = np.asarray(
        render_physical_pallas(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=(8, 128), interpret=True,
        )
    )
    top = np.asarray(
        render_physical_pallas(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=(8, 128), interpret=True, row_start=0, rows=8,
        )
    )
    bot = np.asarray(
        render_physical_pallas(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=(8, 128), interpret=True, row_start=8, rows=8,
        )
    )
    np.testing.assert_array_equal(np.concatenate([top, bot], axis=0), full)


def test_phys_pallas_divisibility_error():
    with pytest.raises(ValueError):
        render_physical_pallas(
            demo.cornell_spheres_scene(), CAM, 20, 128, 1, 2, jnp.uint32(0),
            tile=(16, 128), interpret=True,
        )


# -- hand-written material/sky backward vs core AD ---------------------------


def _fused_vjp(scene, g, h, w, spp, bounces, seed, jitter, **kw):
    """Scene cotangent of the fused Pallas VJP (primal + Jacobian kernel,
    then the contraction) — the production backward of the physical
    Pallas engine, emitter geometry included."""
    import jax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    _, vjp = jax.vjp(
        lambda sc: render_physical_pallas_vjp(
            sc, CAM, h, w, spp, bounces, jnp.uint32(seed), jitter=jitter,
            interpret=True, **kw,
        ),
        scene,
    )
    return vjp(g)[0]


def _core_vjp(scene, g, h, w, spp, bounces, seed, jitter, **kw):
    import jax

    _, vjp = jax.vjp(
        lambda sc: render_physical(
            sc, CAM, h, w, spp, bounces, jnp.uint32(seed), jitter=jitter,
            **kw,
        ),
        scene,
    )
    return vjp(g)[0]


def _compare_bwd(scene, h, w, spp, bounces, seed, gseed, jitter=True,
                 rtol=5e-3, scale_frac=0.0):
    """Hand backward (the fused kernel's VJP) vs core AD. ``scale_frac``
    adds a tolerance proportional to each cotangent's overall scale — for
    scenes whose giant spheres make a small fraction of samples flip
    between the two compilations, moving *small* elements by O(flip/spp)
    while the big ones stay within rtol."""
    g = jnp.asarray(
        np.random.default_rng(gseed).standard_normal((h, w, 3)), jnp.float32
    )
    d_core = _core_vjp(scene, g, h, w, spp, bounces, seed, jitter)
    d_hand = _fused_vjp(scene, g, h, w, spp, bounces, seed, jitter)
    pairs = [
        (d_hand.materials.albedo, d_core.materials.albedo),
        (d_hand.materials.emission_color, d_core.materials.emission_color),
        (d_hand.materials.emission_strength,
         d_core.materials.emission_strength),
        (d_hand.materials.transparency, d_core.materials.transparency),
        (d_hand.sky_color, d_core.sky_color),
    ]
    for a, c in pairs:
        a, c = np.asarray(a), np.asarray(c)
        atol = 3e-5 + scale_frac * np.abs(c).max()
        np.testing.assert_allclose(a, c, rtol=rtol, atol=atol)
    # Geometry: the hand kernel carries the NEE emitter chain only
    # (center/radius through the cone weight), so emitter rows are
    # nonzero/finite; NON-emitter rows are zero by contract (the core's
    # are genuinely nonzero there — full-path AD, the documented gap).
    hc = np.asarray(d_hand.spheres.center)
    hr = np.asarray(d_hand.spheres.radius)
    assert np.isfinite(hc).all() and np.isfinite(hr).all()
    em = np.asarray(
        scene.spheres.active
        & (scene.materials.emission_strength[scene.spheres.material] > 0.0)
    )
    assert not np.any(hc[~em]) and not np.any(hr[~em])
    # roughness is detached in both (lobe selection is stop-gradient)
    assert not np.any(np.asarray(d_core.materials.roughness))
    assert not np.any(np.asarray(d_hand.materials.roughness))
    return d_hand, d_core


def test_phys_bwd_matches_core_cornell():
    # Giant wall spheres (r=1000) amplify the FMA-contraction ulp
    # differences between the two compilations: |oc|^2 - r^2 cancels
    # catastrophically in f32, so a small fraction of samples flips
    # discrete decisions, and each flip moves a cotangent by O(Le/spp).
    # Averaging over more samples shrinks it (verified: rel err 0.042 ->
    # 0.013 going 2 -> 32 spp); controlled scenes without giant spheres
    # match to rounding at rtol=5e-3 (test below + the minimal scenes).
    _compare_bwd(demo.cornell_spheres_scene(), 8, 128, 8, 3, seed=3,
                 gseed=0, rtol=2e-2, scale_frac=0.03)


def test_phys_bwd_matches_core_glossy():
    _compare_bwd(demo.glossy_scene(), 8, 128, 2, 3, seed=5, gseed=1)


def test_phys_bwd_matches_core_no_jitter():
    _compare_bwd(demo.cornell_spheres_scene(), 8, 128, 8, 2, seed=7,
                 gseed=2, jitter=False, rtol=2e-2, scale_frac=0.03)


def _cornell_triangles_scene():
    """Cornell box with TRIANGLE walls instead of r=1000 spheres: same
    material mix (diffuse walls, emissive lamp, mirror, glass) and the
    same code paths (NEE, Le-skip, refraction, TIR), but no catastrophic
    |oc|^2 - r^2 cancellation — so backward parity gates can be tight
."""
    b = pt.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), roughness=1.0)
    light = b.add_material(
        albedo=(1.0, 1.0, 1.0), emission_color=(1.0, 0.9, 0.7),
        emission_strength=15.0,
    )
    mirror = b.add_material(albedo=(0.95, 0.95, 0.95), roughness=0.05)
    glass = b.add_material(
        albedo=(1.0, 1.0, 1.0), transparency=1.0, refractive_index=1.5
    )

    def quad(p00, p10, p11, p01, m):
        b.add_triangle(v0=p00, v1=p10, v2=p11, material=m)
        b.add_triangle(v0=p00, v1=p11, v2=p01, material=m)

    z0, z1, x_, y_ = 2.0, 10.0, 3.0, 2.0
    quad((-x_, -y_, z0), (x_, -y_, z0), (x_, -y_, z1), (-x_, -y_, z1), white)
    quad((-x_, y_, z0), (x_, y_, z0), (x_, y_, z1), (-x_, y_, z1), white)
    quad((-x_, -y_, z0), (-x_, y_, z0), (-x_, y_, z1), (-x_, -y_, z1), red)
    quad((x_, -y_, z0), (x_, y_, z0), (x_, y_, z1), (x_, -y_, z1), green)
    quad((-x_, -y_, z1), (x_, -y_, z1), (x_, y_, z1), (-x_, y_, z1), white)
    b.add_sphere(center=(0.0, 1.55, 6.0), radius=0.8, material=light)
    b.add_sphere(center=(-1.0, -1.2, 6.5), radius=0.8, material=mirror)
    b.add_sphere(center=(1.1, -1.3, 5.0), radius=0.7, material=glass)
    return b.build()


def test_phys_bwd_matches_core_cornell_flipfree():
    """Tight-gate twin of test_phys_bwd_matches_core_cornell: identical
    material mix and code paths, triangle walls -> no f32-cancellation
    flips -> default (5e-3) gates with no scale_frac slack."""
    _compare_bwd(_cornell_triangles_scene(), 8, 128, 8, 3, seed=3, gseed=0)


def test_phys_bwd_matches_core_cornell_flipfree_no_jitter():
    """Tight-gate twin of test_phys_bwd_matches_core_no_jitter."""
    _compare_bwd(_cornell_triangles_scene(), 8, 128, 8, 2, seed=7, gseed=2,
                 jitter=False)


def test_phys_bwd_matches_core_emitter_nee_counted():
    """A big, frequently-BSDF-hit emitter exercises the Le-skip
    (nee_counted) terms; no giant spheres, so the match is rounding-tight."""
    b = pt.SceneBuilder(sky_color=(0.3, 0.4, 0.5))
    ground = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=1.0)
    lamp = b.add_material(albedo=(1.0, 1.0, 1.0),
                          emission_color=(1.0, 0.8, 0.6),
                          emission_strength=10.0)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50),
                   material=ground)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50),
                   material=ground)
    b.add_sphere(center=(0.0, 3.0, 6.0), radius=3.0, material=lamp)
    gm = b.add_material(albedo=(1.0, 1.0, 1.0), transparency=1.0,
                        refractive_index=1.5)
    b.add_sphere(center=(1.0, -0.3, 4.0), radius=0.7, material=gm)
    mm = b.add_material(albedo=(0.95, 0.95, 0.95), roughness=0.05)
    b.add_sphere(center=(-1.0, -0.3, 4.0), radius=0.7, material=mm)
    _compare_bwd(b.build(), 8, 128, 2, 3, seed=7, gseed=2, jitter=False,
                 rtol=1e-3)


def _nee_light_scene(light_albedo=0.0):
    """Diffuse room lit by one small sphere light. With a BLACK light
    albedo, paths that strike the light die immediately, so core AD's
    geometry gradient for the light reduces to exactly the NEE cone-weight
    chain — the chain the hand kernel replays — making the comparison
    rounding-tight rather than approximation-bounded."""
    b = pt.SceneBuilder(sky_color=(0.05, 0.06, 0.08))
    ground = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=1.0)
    wall = b.add_material(albedo=(0.4, 0.45, 0.6), roughness=1.0)
    lamp = b.add_material(
        albedo=(light_albedo,) * 3, emission_color=(1.0, 0.85, 0.6),
        emission_strength=12.0,
    )
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50),
                   material=ground)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50),
                   material=ground)
    b.add_sphere(center=(0.0, 0.0, 6.0), radius=1.2, material=wall)
    b.add_sphere(center=(1.6, 2.2, 4.5), radius=0.35, material=lamp)
    return b.build()


def test_phys_bwd_emitter_geometry_matches_core():
    """NEE emitter center/radius cotangents vs core AD: on the black-albedo-light scene both sides compute the identical
    chain, so the match is tight."""
    scene = _nee_light_scene(light_albedo=0.0)
    d_hand, d_core = _compare_bwd(scene, 16, 128, 4, 3, seed=23, gseed=5,
                                  jitter=False, rtol=5e-3)
    hc = np.asarray(d_hand.spheres.center)
    cc = np.asarray(d_core.spheres.center)
    hr = np.asarray(d_hand.spheres.radius)
    cr = np.asarray(d_core.spheres.radius)
    # the light is sphere 1 (index order of add_sphere calls)
    assert np.abs(cc[1]).max() > 1e-6, "core light-center grad unexpectedly 0"
    np.testing.assert_allclose(hc[1], cc[1], rtol=5e-3, atol=1e-7)
    np.testing.assert_allclose(hr[1], cr[1], rtol=5e-3, atol=1e-7)


def test_phys_bwd_emitter_geometry_dominant_terms():
    """With a NON-black light albedo core AD adds continuation terms the
    sweep omits (documented contract); on an NEE-dominated scene the
    hand cotangents must still carry the bulk of the core gradient —
    same sign, magnitude within 25%."""
    scene = _nee_light_scene(light_albedo=0.8)
    d_hand, d_core = _compare_bwd(scene, 16, 128, 4, 3, seed=29, gseed=6,
                                  jitter=False, rtol=5e-3)
    hc = np.asarray(d_hand.spheres.center)[1]
    cc = np.asarray(d_core.spheres.center)[1]
    denom = np.abs(cc).max()
    assert denom > 1e-6
    assert np.abs(hc - cc).max() / denom < 0.25, (hc, cc)


def test_phys_fused_primal_matches_forward():
    """The fused physical kernel's primal IS the geom=False VJP's primal,
    so it must be bit-identical to render_physical_pallas (same bounce()
    code, structural-death loop only adds exact zeros)."""
    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas, render_physical_pallas_fused,
    )

    for scene, nee, jitter in ((demo.cornell_spheres_scene(), True, False),
                               (demo.glossy_scene(), True, False),
                               (demo.cornell_spheres_scene(), False, False),
                               (demo.cornell_spheres_scene(), True, True)):
        h, w, spp, bounces, seed = 16, 128, 2, 3, 31
        fwd = np.asarray(
            render_physical_pallas(
                scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
                tile=(8, 128), interpret=True, jitter=jitter, nee=nee,
            )
        )
        fused, _ = render_physical_pallas_fused(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=(8, 128), interpret=True, jitter=jitter, nee=nee,
        )
        if jitter:
            # XLA may FMA-contract the sub-pixel camera chain differently
            # between the two graphs (see test_fused_primal in
            # test_pallas_grad.py)
            np.testing.assert_allclose(fwd, np.asarray(fused),
                                       rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(fwd, np.asarray(fused))


def test_phys_fused_jacobian_matches_two_pass_bwd():
    """geom=False contraction grads (the fused kernel's material/sky
    planes contracted with g) == core AD on the flip-free Cornell box."""
    from path_tracer_jax.ops.pallas_physical import (
        contract_physical_jacobian, render_physical_pallas_fused,
    )

    scene = _cornell_triangles_scene()
    h, w, spp, bounces, seed = 16, 128, 2, 3, 37
    g = jnp.asarray(
        np.random.default_rng(9).standard_normal((h, w, 3)), jnp.float32
    )
    _, jac = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False,
    )
    d_fused = contract_physical_jacobian(scene, jac, g, spp)
    d_core = _core_vjp(scene, g, h, w, spp, bounces, seed, False)
    for get in (
        lambda d: d.materials.albedo,
        lambda d: d.materials.emission_color,
        lambda d: d.materials.emission_strength,
        lambda d: d.materials.transparency,
        lambda d: d.sky_color,
    ):
        np.testing.assert_allclose(
            np.asarray(get(d_fused)), np.asarray(get(d_core)),
            rtol=5e-3, atol=3e-5,
        )


@pytest.mark.slow
def test_fit_geometry_fast_path_recovers_light():
    """Light-center recovery running ENTIRELY on the physical Pallas
    kernel (fit_geometry(engine='physical_pallas')) — the fast-path
    route. The light has BLACK albedo so the
    fast path's NEE-chain cotangent is the complete gradient (a visible
    white-albedo light would need the continuation terms the sweep
    omits — measured: its y-gradient is then dominated by them and the
    fit diverges; that configuration belongs to the core engine)."""
    import dataclasses

    from path_tracer_jax.grad.diff import fit_geometry

    b = pt.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    light = b.add_material(
        albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
        emission_strength=10.0,
    )
    diffuse = b.add_material(albedo=(0.7, 0.5, 0.4), roughness=1.0)
    b.add_sphere(center=(1.5, 2.4, 4.0), radius=0.45, material=light)
    b.add_sphere(center=(0.0, -0.2, 5.0), radius=1.0, material=diffuse)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(50, -1.2, -50),
                   v2=(50, -1.2, 50), material=diffuse)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(-50, -1.2, 50),
                   v2=(50, -1.2, 50), material=diffuse)
    true_scene = b.build()
    h = w = 16
    spp, bounces = 8, 2
    target = render_physical(
        true_scene, CAM, h, w, 64, bounces, jnp.uint32(1234),
        nee=True, jitter=False,
    )
    init = dataclasses.replace(
        true_scene,
        spheres=dataclasses.replace(
            true_scene.spheres,
            center=true_scene.spheres.center.at[0].add(
                jnp.asarray([0.3, -0.2, 0.25], jnp.float32)
            ),
        ),
    )
    fitted, losses = fit_geometry(
        init, target, CAM, h, w, spp, bounces,
        sphere_indices=[0], steps=80, lr=0.02, seed0=7,
        engine="physical_pallas", interpret=True,
    )
    err0 = float(jnp.abs(
        init.spheres.center[0] - true_scene.spheres.center[0]).max())
    err1 = float(jnp.abs(
        fitted.spheres.center[0] - true_scene.spheres.center[0]).max())
    # measured: loss 1.28 -> 2.9e-6, center err 0.30 -> 0.077
    assert losses[-1] < losses[0] * 0.01, (losses[0], losses[-1])
    assert err1 < err0 * 0.5, (err0, err1)


def test_fit_triangle_light_fast_path():
    """TRIANGLE-light position recovery running ENTIRELY on the fused
    physical Pallas kernel (fit_geometry(engine='physical_pallas',
    triangle_indices=...)): the fast
    path's tri-NEE vertex cotangents drive the same fit the core-AD
    test (tests/test_physical.py::test_fit_triangle_light_position_
    with_tri_nee) runs ~190x slower. Black-albedo lamp: the NEE chain
    is the complete gradient."""
    import dataclasses

    import jax

    from path_tracer_jax.grad.diff import fit_geometry

    b = pt.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                          emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40),
                   material=ground)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40),
                   material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0),
                   v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0),
                   v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    true_scene = b.build()
    h = w = 16
    spp, bounces = 16, 2
    target = render_physical(
        true_scene, CAM, h, w, 64, bounces, jnp.uint32(1234),
        jitter=False, tri_nee=True,
    )
    off = jnp.asarray([0.4, -0.35, 0.3], jnp.float32)
    d = jnp.zeros_like(true_scene.triangles.v0).at[2:4].add(off[None, :])
    init = dataclasses.replace(
        true_scene,
        triangles=dataclasses.replace(
            true_scene.triangles,
            v0=true_scene.triangles.v0 + d,
            v1=true_scene.triangles.v1 + d,
            v2=true_scene.triangles.v2 + d,
        ),
    )

    # -- apples-to-apples re-run of the core test: same 3-dof shared
    # offset, same hyperparameters, fused engine. The fused and core
    # offset-gradients agree to every printed digit on this scene
    # (measured), so the trajectory matches the core test's.
    import optax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    def apply_off(offset):
        d = jnp.zeros_like(true_scene.triangles.v0).at[2:4].add(
            offset[None, :]
        )
        tr = dataclasses.replace(
            true_scene.triangles,
            v0=true_scene.triangles.v0 + d,
            v1=true_scene.triangles.v1 + d,
            v2=true_scene.triangles.v2 + d,
        )
        return dataclasses.replace(true_scene, triangles=tr)

    opt = optax.adam(0.05)
    p = jnp.asarray([0.4, -0.35, 0.3], jnp.float32)
    err0 = float(jnp.abs(p).max())
    state = opt.init(p)

    @jax.jit
    def step(p, st, seed):
        def loss(p):
            img = render_physical_pallas_vjp(
                apply_off(p), CAM, h, w, spp, bounces, seed,
                jitter=False, tri_nee=True, interpret=True,
            )
            return jnp.mean((img - target) ** 2)

        l, g = jax.value_and_grad(loss)(p)
        up, st = opt.update(g, st)
        return optax.apply_updates(p, up), st, l

    losses = []
    for i in range(60):
        p, state, l = step(p, state, jnp.uint32(i + 1))
        losses.append(float(l))
    err1 = float(jnp.abs(p).max())
    # measured (core twin: loss 10.8 -> 2.4, err 0.40 -> 0.072)
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])
    assert err1 < err0 * 0.5, (err0, err1)

    # -- driver rehearsal: the generic fit_geometry(triangle_indices=...)
    # entry point (18 raw-vertex dof — harder conditioning than the
    # shared offset, so the gate is descent, not convergence)
    fitted, dlosses = fit_geometry(
        init, target, CAM, h, w, spp, bounces,
        sphere_indices=(), triangle_indices=(2, 3), steps=20, lr=0.05,
        seed0=7, engine="physical_pallas", interpret=True,
    )
    assert dlosses[-1] < dlosses[0] * 0.85, (dlosses[0], dlosses[-1])


def test_phys_fused_geometry_matches_two_pass_bwd():
    """The fused kernel's in-bounce NEE emitter-geometry Jacobian
    (contracted with g) against core AD: on the black-albedo-light scene
    the NEE chain IS core AD's whole light gradient (tight match); with a
    reflective light core AD adds continuation terms the fused chain
    omits by contract, and the chain still carries their bulk."""
    from path_tracer_jax.ops.pallas_physical import (
        contract_physical_jacobian, render_physical_pallas_fused,
    )

    for albedo, tol in ((0.0, 5e-3), (0.8, 0.25)):
        scene = _nee_light_scene(albedo)
        n_em_cap = min(scene.num_spheres, 8)
        h, w, spp, bounces, seed = 16, 128, 2, 3, 41
        g = jnp.asarray(
            np.random.default_rng(11).standard_normal((h, w, 3)), jnp.float32
        )
        _, jac, jgeo = render_physical_pallas_fused(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=(8, 128), interpret=True, jitter=False, n_em_cap=n_em_cap,
        )
        d_fused = contract_physical_jacobian(scene, jac, g, spp,
                                             jac_geo=jgeo)
        d_core = _core_vjp(scene, g, h, w, spp, bounces, seed, False)
        for get in (lambda d: d.spheres.center[1],
                    lambda d: d.spheres.radius[1]):
            f, c = np.asarray(get(d_fused)), np.asarray(get(d_core))
            assert np.abs(c).max() > 1e-7
            assert np.abs(f - c).max() / np.abs(c).max() < tol, (f, c)
        # non-emitter geometry is zero by contract
        assert not np.any(np.asarray(d_fused.spheres.center)[0])
        np.testing.assert_allclose(
            np.asarray(d_fused.materials.albedo),
            np.asarray(d_core.materials.albedo), rtol=5e-3, atol=3e-5,
        )


def test_phys_fused_geometry_matches_core_on_nee_chain():
    """End-to-end: jax.grad through the (fused) vjp wrapper reproduces
    core AD's light center/radius gradient on the black-albedo-light
    scene, where the NEE chain IS the whole core geometry gradient."""
    import jax

    scene = _nee_light_scene(light_albedo=0.0)
    h, w, spp, bounces = 16, 128, 4, 3

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    target = render_physical(
        scene, CAM, h, w, spp, bounces, jnp.uint32(77), jitter=False
    )

    light = 1  # the lamp is the second add_sphere in _nee_light_scene

    def loss(fn, center, radius):
        import dataclasses

        sc = dataclasses.replace(
            scene,
            spheres=dataclasses.replace(
                scene.spheres,
                center=scene.spheres.center.at[light].set(center),
                radius=scene.spheres.radius.at[light].set(radius),
            ),
        )
        img = fn(sc, CAM, h, w, spp, bounces, jnp.uint32(5))
        return jnp.mean((img - target) ** 2)

    fast = lambda *a: render_physical_pallas_vjp(*a, jitter=False, interpret=True)
    core = lambda *a: render_physical(*a, jitter=False)
    c0 = scene.spheres.center[light]
    r0 = scene.spheres.radius[light]
    gc_f, gr_f = jax.grad(lambda c, r: loss(fast, c, r), argnums=(0, 1))(
        c0, r0)
    gc_c, gr_c = jax.grad(lambda c, r: loss(core, c, r), argnums=(0, 1))(
        c0, r0)
    assert np.abs(np.asarray(gc_c)).max() > 1e-8
    np.testing.assert_allclose(np.asarray(gc_f), np.asarray(gc_c),
                               rtol=5e-3, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gr_f), np.asarray(gr_c),
                               rtol=5e-3, atol=1e-9)


def test_emitter_cap_warns_and_tracks_first_k():
    """A scene with more live emitters than n_em_cap warns (concrete
    scenes only) and still produces correct
    cotangents for the first k ordinals; ordinals >= k get exact zeros."""
    import warnings

    from path_tracer_jax.ops.pallas_physical import (
        contract_physical_jacobian, render_physical_pallas_fused,
        render_physical_pallas_vjp,
    )

    b = pt.SceneBuilder(sky_color=(0.02, 0.02, 0.03))
    ground = b.add_material(albedo=(0.5, 0.5, 0.5), roughness=1.0)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50),
                   material=ground)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50),
                   material=ground)
    for i in range(10):
        lamp = b.add_material(
            albedo=(0.0, 0.0, 0.0),
            emission_color=(1.0, 0.9, 0.8),
            emission_strength=4.0 + i,
        )
        b.add_sphere(center=(-4.5 + i, 2.0, 6.0), radius=0.3, material=lamp)
    scene = b.build()
    h, w, spp, bounces, seed = 8, 128, 2, 2, 43
    g = jnp.ones((h, w, 3), jnp.float32)

    # the default cap (min(n_sph, 8) = 8) is smaller than the 10 live
    # emitters -> the public wrapper warns
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        render_physical_pallas_vjp(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed), jitter=False, interpret=True
        )
        assert any("n_em_cap" in str(r.message) for r in rec), (
            [str(r.message) for r in rec]
        )

    # cap=4: ordinals 0-3 match the full-cap run; ordinals >= 4 exact 0
    _, jac10, jgeo10 = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False, n_em_cap=10,
    )
    full = contract_physical_jacobian(scene, jac10, g, spp, jac_geo=jgeo10)
    _, jac, jgeo = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
        tile=(8, 128), interpret=True, jitter=False, n_em_cap=4,
    )
    capped = contract_physical_jacobian(scene, jac, g, spp, jac_geo=jgeo)
    fc = np.asarray(full.spheres.center)
    cc = np.asarray(capped.spheres.center)
    # the 10 spheres are the 10 emitters, index == ordinal
    np.testing.assert_allclose(cc[:4], fc[:4], rtol=2e-4, atol=1e-7)
    assert np.abs(fc[4:]).max() > 0.0  # full cap tracks them...
    assert not np.any(cc[4:])  # ...capped run zeroes them, as documented


def test_phys_vjp_camera_cotangent_contract():
    """Camera cotangents through the physical Pallas VJP are ZERO BY
    CONTRACT (an approximation — core AD's are nonzero through the NEE
    cosine/solid-angle terms). Pin both halves so the documented gap
    stays documented."""
    import jax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene = _nee_light_scene(light_albedo=0.8)
    h, w, spp, bounces = 8, 128, 2, 2

    def loss(fn, cam):
        return jnp.mean(fn(scene, cam, h, w, spp, bounces, jnp.uint32(3)))

    g_fast = jax.grad(
        lambda c: loss(
            lambda *a: render_physical_pallas_vjp(*a, jitter=False, interpret=True), c
        )
    )(CAM)
    g_core = jax.grad(
        lambda c: loss(lambda *a: render_physical(*a, jitter=False), c)
    )(CAM)
    fast_leaves = np.concatenate(
        [np.ravel(l) for l in jax.tree_util.tree_leaves(g_fast)]
    )
    core_leaves = np.concatenate(
        [np.ravel(l) for l in jax.tree_util.tree_leaves(g_core)]
    )
    assert not np.any(fast_leaves)  # the contract: exact zeros
    assert np.abs(core_leaves).max() > 1e-8  # the gap is real


def _tri_light_mixed_scene():
    """Triangle ceiling light + sphere light + diffuse content: the
    mixed emitter pool for tri_nee parity tests."""
    b = pt.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                          emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    slamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                           emission_color=(0.8, 0.9, 1.0),
                           emission_strength=8.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40),
                   material=ground)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40),
                   material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0),
                   v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0),
                   v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    b.add_sphere(center=(2.0, 2.0, 3.5), radius=0.4, material=slamp)
    return b.build()


def test_phys_pallas_tri_nee_matches_core():
    """Pallas tri_nee == core tri_nee (same pick/sample math from the
    same draws; measured q99 = 6e-8 with zero flips on this scene)."""
    _compare(_tri_light_mixed_scene(), 16, 128, 2, 3, 7, tile=(8, 128),
             jitter=False, tri_nee=True)


def test_phys_tri_nee_fused_and_bwd_parity():
    """With tri_nee: the fused primal stays bit-identical to the
    forward, and the fused-contraction material grads match core AD (the
    material-plane algebra generalizes to the mixed pool through the same
    emitter-keyed records)."""
    from path_tracer_jax.ops.pallas_physical import (
        contract_physical_jacobian, render_physical_pallas,
        render_physical_pallas_fused,
    )

    scene = _tri_light_mixed_scene()
    h, w, spp, bounces, seed = 16, 128, 2, 3, 7
    fwd = np.asarray(
        render_physical_pallas(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
            tile=(8, 128), interpret=True, jitter=False, tri_nee=True,
        )
    )
    fused, jac, jgeo = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), tile=(8, 128),
        interpret=True, jitter=False, n_em_cap=1, tri_nee=True,
    )
    np.testing.assert_array_equal(fwd, np.asarray(fused))

    g = jnp.asarray(
        np.random.default_rng(3).standard_normal((h, w, 3)), jnp.float32
    )
    d_fused = contract_physical_jacobian(scene, jac, g, spp, jac_geo=jgeo)
    d_core = _core_vjp(scene, g, h, w, spp, bounces, seed, False,
                       tri_nee=True)
    for get in (
        lambda d: d.materials.albedo,
        lambda d: d.materials.emission_color,
        lambda d: d.materials.emission_strength,
        lambda d: d.sky_color,
    ):
        np.testing.assert_allclose(
            np.asarray(get(d_fused)), np.asarray(get(d_core)),
            rtol=5e-3, atol=1e-5,
        )
    # sphere-emitter geometry still tracked; triangle picks excluded
    # (ordinal -1): finite
    assert np.isfinite(np.asarray(d_fused.spheres.center)).all()


def _tri_nee_black_lights_scene():
    """Mixed pool (1 sphere emitter + 2 triangle emitters, n_tot=3) with
    BLACK-albedo lights: paths striking a light die, so core AD's light
    geometry gradient reduces to exactly the NEE chain — tight AND
    scale-sensitive (a pool-size factor error shows up as exactly 3x)."""
    b = pt.SceneBuilder(sky_color=(0.04, 0.05, 0.07))
    ground = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                          emission_color=(1.0, 0.85, 0.6),
                          emission_strength=12.0)
    tlamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                           emission_color=(0.7, 0.8, 1.0),
                           emission_strength=9.0)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50),
                   material=ground)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50),
                   material=ground)
    b.add_triangle(v0=(-1.2, 3.0, 4.0), v1=(0.8, 3.0, 4.0),
                   v2=(0.8, 3.0, 6.0), material=tlamp)
    b.add_triangle(v0=(-1.2, 3.0, 4.0), v1=(-1.2, 3.0, 6.0),
                   v2=(0.8, 3.0, 6.0), material=tlamp)
    b.add_sphere(center=(1.6, 2.2, 4.5), radius=0.35, material=lamp)
    return b.build()


def test_phys_tri_nee_sphere_geometry_matches_core():
    """Regression: under tri_nee the forward's sphere-pick
    weight carries the POOL size n_tot, so both geometry-VJP chains must
    pass n_tot into _cone_w_chain — the old code passed n_em, silently
    mis-scaling every sphere-emitter center/radius cotangent by
    n_em/n_tot (exactly 1/3 on this pool). Core AD is the scale anchor
    the fused-vs-two-pass parity test cannot provide (both shared the
    bug)."""
    import dataclasses

    import jax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene = _tri_nee_black_lights_scene()
    h, w, spp, bounces = 16, 128, 4, 3
    target = render_physical(
        scene, CAM, h, w, spp, bounces, jnp.uint32(77), jitter=False,
        tri_nee=True,
    )
    light = 0  # only sphere in the scene

    def loss(fn, center, radius):
        sc = dataclasses.replace(
            scene,
            spheres=dataclasses.replace(
                scene.spheres,
                center=scene.spheres.center.at[light].set(center),
                radius=scene.spheres.radius.at[light].set(radius),
            ),
        )
        img = fn(sc, CAM, h, w, spp, bounces, jnp.uint32(5))
        return jnp.mean((img - target) ** 2)

    fast = lambda *a: render_physical_pallas_vjp(*a, jitter=False,
                                                 tri_nee=True, interpret=True)
    core = lambda *a: render_physical(*a, jitter=False, tri_nee=True)
    c0 = scene.spheres.center[light]
    r0 = scene.spheres.radius[light]
    gc_f, gr_f = jax.grad(lambda c, r: loss(fast, c, r), argnums=(0, 1))(
        c0, r0)
    gc_c, gr_c = jax.grad(lambda c, r: loss(core, c, r), argnums=(0, 1))(
        c0, r0)
    assert np.abs(np.asarray(gc_c)).max() > 1e-8
    np.testing.assert_allclose(np.asarray(gc_f), np.asarray(gc_c),
                               rtol=5e-3, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gr_f), np.asarray(gr_c),
                               rtol=5e-3, atol=1e-9)


def test_phys_tri_vertex_geometry_matches_core():
    """Triangle-emitter VERTEX cotangents: jax.grad
    through the fused vjp wrapper reproduces core AD's vertex gradient
    on the black-albedo-lights scene, where the tri-NEE chain IS the
    whole core vertex gradient (paths striking a light die, so no
    continuation terms). Measured rel err ~4e-7 on this scene."""
    import dataclasses

    import jax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene = _tri_nee_black_lights_scene()
    h, w, spp, bounces = 16, 128, 4, 3
    target = render_physical(
        scene, CAM, h, w, spp, bounces, jnp.uint32(77), jitter=False,
        tri_nee=True,
    )
    TRI = 2  # first lamp triangle (after the two ground triangles)

    def loss(fn, v0, v1, v2):
        sc = dataclasses.replace(
            scene,
            triangles=dataclasses.replace(
                scene.triangles,
                v0=scene.triangles.v0.at[TRI].set(v0),
                v1=scene.triangles.v1.at[TRI].set(v1),
                v2=scene.triangles.v2.at[TRI].set(v2),
            ),
        )
        img = fn(sc, CAM, h, w, spp, bounces, jnp.uint32(5))
        return jnp.mean((img - target) ** 2)

    fast = lambda *a: render_physical_pallas_vjp(*a, jitter=False,
                                                 tri_nee=True, interpret=True)
    core = lambda *a: render_physical(*a, jitter=False, tri_nee=True)
    args = (scene.triangles.v0[TRI], scene.triangles.v1[TRI],
            scene.triangles.v2[TRI])
    gf = jax.grad(lambda a, b, c: loss(fast, a, b, c),
                  argnums=(0, 1, 2))(*args)
    gc = jax.grad(lambda a, b, c: loss(core, a, b, c),
                  argnums=(0, 1, 2))(*args)
    den = np.abs(
        np.concatenate([np.ravel(np.asarray(x)) for x in gc])
    ).max()
    assert den > 1e-8, "core vertex grad unexpectedly zero"
    for f, c in zip(gf, gc):
        np.testing.assert_allclose(np.asarray(f), np.asarray(c),
                                   rtol=5e-3, atol=den * 1e-4)


def test_phys_tri_vertex_cap_warns_and_geom_off_zeros():
    """tri_em_cap smaller than the live tri-emitter count warns; with
    geom=False (or tri_nee=False) triangle cotangents are exactly
    zero."""
    import jax
    import warnings

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene = _tri_nee_black_lights_scene()  # 2 live tri emitters
    h, w, spp, bounces = 8, 128, 2, 2

    def vloss(v0, tri_nee=True, geom=True, **kw):
        import dataclasses

        sc = dataclasses.replace(
            scene,
            triangles=dataclasses.replace(
                scene.triangles, v0=scene.triangles.v0.at[2].set(v0)
            ),
        )
        return jnp.mean(render_physical_pallas_vjp(
            sc, CAM, h, w, spp, bounces, jnp.uint32(3), jitter=False,
            tri_nee=tri_nee, geom=geom, **kw, interpret=True,
        ))

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        g1 = jax.grad(lambda v: vloss(v, tri_em_cap=1))(
            scene.triangles.v0[2]
        )
        assert any("tri_em_cap=1" in str(r.message) for r in rec), (
            [str(r.message) for r in rec]
        )
    assert np.isfinite(np.asarray(g1)).all()
    g_off = jax.grad(lambda v: vloss(v, geom=False))(
        scene.triangles.v0[2]
    )
    assert not np.asarray(g_off).any()
    g_no_tri_nee = jax.grad(lambda v: vloss(v, tri_nee=False))(
        scene.triangles.v0[2]
    )
    assert not np.asarray(g_no_tri_nee).any()


def test_phys_vjp_wrapper_matches_core_grad():
    """grad through render_physical_pallas_vjp == grad through the core
    physical path, for a material-parameterized loss."""
    import dataclasses

    import jax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene = demo.cornell_spheres_scene()
    h, w, spp, bounces = 8, 128, 2, 2
    target = render_physical(scene, CAM, h, w, spp, bounces, jnp.uint32(9))

    def with_albedo(albedo):
        return dataclasses.replace(
            scene, materials=dataclasses.replace(
                scene.materials, albedo=albedo
            )
        )

    def loss_fast(albedo):
        img = render_physical_pallas_vjp(
            with_albedo(albedo), CAM, h, w, spp, bounces, jnp.uint32(4), interpret=True
        )
        return jnp.mean((img - target) ** 2)

    def loss_core(albedo):
        img = render_physical(
            with_albedo(albedo), CAM, h, w, spp, bounces, jnp.uint32(4)
        )
        return jnp.mean((img - target) ** 2)

    a0 = scene.materials.albedo
    g_fast = np.asarray(jax.grad(loss_fast)(a0))
    g_core = np.asarray(jax.grad(loss_core)(a0))
    np.testing.assert_allclose(g_fast, g_core, rtol=2e-2, atol=1e-6)


def test_phys_fused_executed_round_counter_matches_forward():
    """count_rounds on the fused physical kernel: equal executed-round
    totals vs the forward (same schedule), counter does not perturb the
    primal, and the counter composes with the geometry caps (outputs
    append in cap order, count last)."""
    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas, render_physical_pallas_fused,
    )

    scene = demo.cornell_spheres_scene()
    h, w, spp, bounces = 16, 128, 2, 3
    img_f, cnt_f = render_physical_pallas(
        scene, CAM, h, w, spp, bounces, jnp.uint32(7), tile=(8, 128),
        jitter=False, count_rounds=True, interpret=True,
    )
    img_g, _, cnt_g = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(7), tile=(8, 128),
        jitter=False, count_rounds=True, interpret=True,
    )
    assert int(cnt_f) == int(cnt_g) > 0
    np.testing.assert_array_equal(np.asarray(img_f), np.asarray(img_g))
    out = render_physical_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(7), tile=(8, 128),
        jitter=False, count_rounds=True, n_em_cap=1, interpret=True,
    )
    assert len(out) == 4  # img, jac, jgeo, count
    assert int(out[-1]) == int(cnt_f)


@pytest.mark.slow
def test_phys_bwd_flip_error_shrinks_with_spp():
    """Evidence for the loose giant-sphere Cornell gates: the hand-vs-core cotangent discrepancy there is discrete
    path FLIPS (FMA-contraction ulps on the catastrophically-cancelling
    |oc|^2 - r^2 of r=1000 walls), each worth O(Le/spp) — so averaging
    over more samples must shrink it. Measure the error at 2 and 32 spp
    and assert the shrink the comment at the loose gates claims."""
    scene = demo.cornell_spheres_scene()
    h, w, bounces, seed, gseed = 8, 128, 3, 3, 0
    g = jnp.asarray(
        np.random.default_rng(gseed).standard_normal((h, w, 3)), jnp.float32
    )

    def rel_err(spp):
        d_core = _core_vjp(scene, g, h, w, spp, bounces, seed, True)
        d_hand = _fused_vjp(scene, g, h, w, spp, bounces, seed, True)
        errs = []
        for get in (
            lambda d: d.materials.albedo,
            lambda d: d.materials.emission_color,
            lambda d: d.materials.emission_strength,
            lambda d: d.materials.transparency,
            lambda d: d.sky_color,
        ):
            a, c = np.asarray(get(d_hand)), np.asarray(get(d_core))
            denom = np.abs(c).max()
            if denom > 1e-8:
                errs.append(np.abs(a - c).max() / denom)
        return max(errs)

    e2 = rel_err(2)
    e32 = rel_err(32)
    # measured: 0.041 -> 0.010 (the 2->32 shrink the loose-gate comment
    # cites); gate at a conservative fraction of that
    assert e32 < e2 * 0.75, (e2, e32)


def test_phys_fused_rough_grad_matches_core():
    """The fused kernel's score-function roughness planes (rough_grad=
    True, 3 extra Jacobian planes per material): d/d(roughness) through the vjp wrapper matches core
    rough_grad AD (measured rel err 8e-8 on the lobe-asymmetry scene),
    the primal is bit-identical to the plain forward, and the OTHER
    material cotangents are unchanged."""
    import dataclasses

    import jax

    b = pt.SceneBuilder(sky_color=(0.02, 0.02, 0.03))
    m = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=0.5)
    ground = b.add_material(albedo=(0.4, 0.35, 0.3), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                          emission_color=(1.0, 0.9, 0.8),
                          emission_strength=25.0)
    b.add_sphere(center=(0.0, 0.0, 3.0), radius=1.0, material=m)
    b.add_sphere(center=(2.0, 3.5, 2.0), radius=0.5, material=lamp)
    b.add_triangle(v0=(-60, -1.2, -60), v1=(60, -1.2, -60),
                   v2=(60, -1.2, 60), material=ground)
    b.add_triangle(v0=(-60, -1.2, -60), v1=(-60, -1.2, 60),
                   v2=(60, -1.2, 60), material=ground)
    scene = b.build()
    h, w, spp, bounces = 16, 128, 4, 3
    target = jnp.zeros((h, w, 3), jnp.float32)

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas, render_physical_pallas_vjp,
    )

    fast = lambda sc: render_physical_pallas_vjp(
        sc, CAM, h, w, spp, bounces, jnp.uint32(5), jitter=False,
        rough_grad=True, interpret=True)
    core = lambda sc: render_physical(
        sc, CAM, h, w, spp, bounces, jnp.uint32(5), jitter=False,
        rough_grad=True)
    gF = jax.grad(lambda sc: jnp.mean((fast(sc) - target) ** 2),
                  allow_int=True)(scene)
    gC = jax.grad(lambda sc: jnp.mean((core(sc) - target) ** 2),
                  allow_int=True)(scene)
    for name in ("roughness", "albedo", "transparency",
                 "emission_strength", "emission_color"):
        a = np.asarray(getattr(gF.materials, name))
        c = np.asarray(getattr(gC.materials, name))
        den = max(np.abs(c).max(), 1e-12)
        assert np.abs(a - c).max() / den < 5e-3, (name, a, c)
    assert np.abs(np.asarray(gC.materials.roughness)).max() > 1e-8
    # primal unchanged by the extra planes
    p0 = np.asarray(render_physical_pallas(
        scene, CAM, h, w, spp, bounces, jnp.uint32(5), jitter=False, interpret=True))
    p1 = np.asarray(fast(scene))
    np.testing.assert_array_equal(p0, p1)


def test_phys_fused_rough_grad_fit():
    """End-to-end roughness recovery on the FAST path:
    fit_materials(engine='physical_pallas', rough_grad=True)."""
    import dataclasses

    from path_tracer_jax.grad.diff import fit_materials

    b = pt.SceneBuilder(sky_color=(0.02, 0.02, 0.03))
    m = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=0.5)
    ground = b.add_material(albedo=(0.4, 0.35, 0.3), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                          emission_color=(1.0, 0.9, 0.8),
                          emission_strength=25.0)
    b.add_sphere(center=(0.0, 0.0, 3.0), radius=1.0, material=m)
    b.add_sphere(center=(2.0, 3.5, 2.0), radius=0.5, material=lamp)
    b.add_triangle(v0=(-60, -1.2, -60), v1=(60, -1.2, -60),
                   v2=(60, -1.2, 60), material=ground)
    b.add_triangle(v0=(-60, -1.2, -60), v1=(-60, -1.2, 60),
                   v2=(60, -1.2, 60), material=ground)
    true_scene = b.build()
    h, w, spp, bounces = 16, 128, 16, 2
    target = render_physical(true_scene, CAM, h, w, 64, bounces,
                             jnp.uint32(99), jitter=False)
    init = dataclasses.replace(
        true_scene,
        materials=dataclasses.replace(
            true_scene.materials,
            roughness=true_scene.materials.roughness.at[0].set(0.15),
        ),
    )
    fitted, losses = fit_materials(
        init, target, CAM, h, w, spp, bounces, steps=25, lr=0.05,
        seed0=3, engine="physical_pallas", rough_grad=True, interpret=True,
    )
    r_true = float(true_scene.materials.roughness[0])
    err0 = abs(0.15 - r_true)
    err1 = abs(float(fitted.materials.roughness[0]) - r_true)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert err1 < err0 * 0.5, (err0, err1)


def test_phys_fused_all_flags_compose():
    """All opt-in estimator features at once — geom (sphere planes),
    tri_nee (+vertex planes), rough_grad (+score-function planes) — in
    ONE fused kernel pass: every cotangent family matches core AD on
    the mixed black-lights scene (roughness via the core rough_grad
    tangent; geometry via the NEE chains, which are the whole core
    gradient here)."""
    import dataclasses

    import jax

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    base = _tri_nee_black_lights_scene()
    # give the ground some speculars so roughness matters
    scene = dataclasses.replace(
        base,
        materials=dataclasses.replace(
            base.materials,
            roughness=base.materials.roughness.at[0].set(0.6),
        ),
    )
    h, w, spp, bounces = 16, 128, 4, 3
    target = jnp.zeros((h, w, 3), jnp.float32)

    fast = lambda sc: render_physical_pallas_vjp(
        sc, CAM, h, w, spp, bounces, jnp.uint32(5), jitter=False,
        geom=True, tri_nee=True, rough_grad=True, interpret=True)
    core = lambda sc: render_physical(
        sc, CAM, h, w, spp, bounces, jnp.uint32(5), jitter=False,
        tri_nee=True, rough_grad=True)
    gF = jax.grad(lambda sc: jnp.mean((fast(sc) - target) ** 2),
                  allow_int=True)(scene)
    gC = jax.grad(lambda sc: jnp.mean((core(sc) - target) ** 2),
                  allow_int=True)(scene)
    checks = [
        ("roughness", np.asarray(gF.materials.roughness),
         np.asarray(gC.materials.roughness)),
        ("albedo", np.asarray(gF.materials.albedo),
         np.asarray(gC.materials.albedo)),
        ("sphere center", np.asarray(gF.spheres.center),
         np.asarray(gC.spheres.center)),
        ("sphere radius", np.asarray(gF.spheres.radius),
         np.asarray(gC.spheres.radius)),
        ("tri v0", np.asarray(gF.triangles.v0)[2:],
         np.asarray(gC.triangles.v0)[2:]),  # lamp triangles only: the
        # ground triangles' core gradient carries continuation terms
        # the fused contract excludes
        ("tri v1", np.asarray(gF.triangles.v1)[2:],
         np.asarray(gC.triangles.v1)[2:]),
    ]
    for name, a, c in checks:
        den = max(np.abs(c).max(), 1e-12)
        assert np.abs(a - c).max() / den < 1e-2, (name, a, c)
        assert np.abs(c).max() > 1e-10, (name, "core grad zero")


def test_phys_fused_tile_matches_wrapper():
    """The fused wrapper sizes its tile with the ONE tile rule
    (pallas_kernels.tile_for): its default tile is a power of two on both
    sides, it is clipped and shrunk to the row block, and a requested
    tile that is not a power of two is refused."""
    from path_tracer_jax.ops import pallas_kernels as fk
    from path_tracer_jax.ops.pallas_physical import (
        PHYS_FUSED_TILE, render_physical_pallas_fused,
    )

    th, tw = fk.tile_for(1024, 1024, PHYS_FUSED_TILE)
    assert (th, tw) == PHYS_FUSED_TILE
    assert th & (th - 1) == 0 and tw & (tw - 1) == 0
    assert fk.tile_for(4, 1024, PHYS_FUSED_TILE) == (4, tw)
    # odd blocks shrink to the largest power-of-two divisor
    assert fk.tile_for(24, 96, (16, 128), shrink=True) == (8, 32)
    assert fk.tile_for(6, 32, PHYS_FUSED_TILE, shrink=True) == (2, tw)
    scene = demo.cornell_spheres_scene()
    for tile in ((8, 48), (12, 32)):
        with pytest.raises(ValueError):
            render_physical_pallas_fused(
                scene, CAM, 24, 96, 1, 1, jnp.uint32(0), tile=tile,
                interpret=True,
            )
