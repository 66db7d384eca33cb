"""Hand-written Pallas backward kernel vs core-path AD (interpreter mode)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax.ops.pallas_grad import render_pallas_bwd
from path_tracer_jax.ops.pallas_kernels import render_pallas_vjp


CAM = pt.Camera.reference()


def _mixed_scene():
    """Exercises every cotangent path: emission, partial transparency
    (ratio term + TIR), diffuse bounces, sky misses."""
    b = pt.SceneBuilder(sky_color=(0.2, 0.3, 0.5))
    b.add_material(albedo=(0.9, 0.8, 0.7), roughness=0.4,
                   emission_color=(1.0, 0.8, 0.6), emission_strength=3.0)
    glassy = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.1,
                            transparency=0.5, refractive_index=1.4)
    diffuse = b.add_material(albedo=(0.6, 0.3, 0.2), roughness=1.0)
    b.add_sphere(center=(0, 2.5, 6), radius=1.5, material=0)
    b.add_sphere(center=(0.5, -0.2, 4), radius=1.0, material=glassy)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50),
                   material=diffuse)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50),
                   material=diffuse)
    return b.build()


def _compare(scene, h, w, spp, bounces, seed, gseed, tile=(8, 128),
             jitter=False, rtol=5e-3):
    g = jnp.asarray(
        np.random.default_rng(gseed).standard_normal((h, w, 3)), jnp.float32
    )
    _, vjp = jax.vjp(
        lambda sc: pt.render_radiance(sc, CAM, h, w, spp, bounces,
                                      jnp.uint32(seed), jitter=jitter),
        scene,
    )
    d_core = vjp(g)[0]
    d_hand = render_pallas_bwd(scene, CAM, g, h, w, spp, bounces,
                               jnp.uint32(seed), tile=tile, jitter=jitter, interpret=True)
    pairs = [
        (d_hand.materials.albedo, d_core.materials.albedo),
        (d_hand.materials.emission_color, d_core.materials.emission_color),
        (d_hand.materials.emission_strength, d_core.materials.emission_strength),
        (d_hand.materials.transparency, d_core.materials.transparency),
        (d_hand.sky_color, d_core.sky_color),
    ]
    for a, c in pairs:
        # rtol covers rare chaotic path flips between the two
        # compilations: XLA contracts mul+add into FMA differently for
        # the kernel and the core path, so hit distances differ by ulps,
        # which grazing incidence on giant spheres amplifies into
        # discrete decision flips; systematic errors blow far past this.
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(c), rtol=rtol, atol=2e-5
        )
    # geometry cotangents are exactly zero on both sides
    assert not np.any(np.asarray(d_core.spheres.center))
    assert not np.any(np.asarray(d_hand.spheres.center))


def test_bwd_matches_core_mixed():
    _compare(_mixed_scene(), 16, 128, 3, 4, seed=7, gseed=0)


def test_bwd_matches_core_demo():
    _compare(demo.demo_scene(), 8, 128, 2, 4, seed=3, gseed=1)


def test_bwd_matches_core_cornell():
    # Giant wall spheres make closest hits grazing-sensitive, so a couple
    # of paths flip between the two compilations -> wider rtol (see
    # _compare).
    _compare(demo.cornell_spheres_scene(), 8, 128, 2, 3, seed=5, gseed=2,
             rtol=2e-2)


def _black_albedo_scene():
    """Camera inside an exactly-black sphere: the lane's
    throughput hits exact zero at bounce 0, but d_albedo there needs the
    suffix carry from the *untraced future* path — a replay that exits on
    zero throughput gets it ~2x wrong."""
    b = pt.SceneBuilder(sky_color=(0.8, 0.6, 0.4))
    black = b.add_material(albedo=(0.0, 0.0, 0.0), roughness=0.7,
                           emission_color=(1.0, 0.9, 0.8),
                           emission_strength=0.5)
    b.add_sphere(center=(0.0, 0.0, 0.0), radius=5.0, material=black)
    return b.build()


def test_bwd_matches_core_black_albedo():
    _compare(_black_albedo_scene(), 8, 128, 2, 4, seed=11, gseed=3)


def test_bwd_matches_core_black_albedo_mixed():
    """Black material mixed into a scene with live paths around it."""
    scene = _mixed_scene()
    import dataclasses

    mats = scene.materials
    scene = dataclasses.replace(
        scene,
        materials=dataclasses.replace(
            mats, albedo=mats.albedo.at[2].set(0.0)
        ),
    )
    _compare(scene, 8, 128, 3, 4, seed=13, gseed=4)


def test_bwd_matches_core_jitter():
    """Anti-aliased (per-sample sub-pixel ray) backward replay."""
    _compare(_mixed_scene(), 8, 128, 2, 3, seed=17, gseed=5, jitter=True)


def test_bwd_tile_fallback_odd_height():
    """Heights not divisible by the default (64, 128) tile auto-shrink
    instead of raising."""
    _compare(_mixed_scene(), 24, 128, 2, 3, seed=19, gseed=6,
             tile=(64, 128))


def test_bwd_row_block_matches_full():
    """row_start/rows: per-block backward sums to the full-image VJP."""
    scene = _mixed_scene()
    h, w, spp, bounces, seed = 16, 128, 2, 3, 23
    g = jnp.asarray(
        np.random.default_rng(7).standard_normal((h, w, 3)), jnp.float32
    )
    d_full = render_pallas_bwd(scene, CAM, g, h, w, spp, bounces,
                               jnp.uint32(seed), tile=(8, 128), interpret=True)
    d_top = render_pallas_bwd(scene, CAM, g[:8], h, w, spp, bounces,
                              jnp.uint32(seed), tile=(8, 128),
                              row_start=0, rows=8, interpret=True)
    d_bot = render_pallas_bwd(scene, CAM, g[8:], h, w, spp, bounces,
                              jnp.uint32(seed), tile=(8, 128),
                              row_start=8, rows=8, interpret=True)
    for get in (
        lambda d: d.materials.albedo,
        lambda d: d.materials.emission_color,
        lambda d: d.materials.emission_strength,
        lambda d: d.materials.transparency,
        lambda d: d.sky_color,
    ):
        np.testing.assert_allclose(
            np.asarray(get(d_top)) + np.asarray(get(d_bot)),
            np.asarray(get(d_full)),
            rtol=1e-5, atol=1e-7,
        )


def test_fused_primal_bit_matches_forward():
    """The fused kernel's primal IS the VJP's primal output (custom_vjp
    fwd rule), so it must match the plain forward megakernel: the
    radiance math is the same op sequence and the structural-death bounce
    loop only adds exact zeros. Non-jitter renders are bit-identical;
    with jitter XLA contracts the sub-pixel camera chain's mul+add into
    FMA differently between the two graphs, so a few pixels move by 1 ulp
    (checked to that tolerance)."""
    from path_tracer_jax.ops.pallas_grad import render_pallas_fused
    from path_tracer_jax.ops.pallas_kernels import render_pallas

    for scene, jitter in ((_mixed_scene(), False),
                          (demo.demo_scene(), True),
                          (_black_albedo_scene(), False)):
        h, w, spp, bounces, seed = 16, 128, 3, 4, 21
        fwd = np.asarray(
            render_pallas(scene, CAM, h, w, spp, bounces, jnp.uint32(seed),
                          jitter=jitter, interpret=True)
        )
        fused, _ = render_pallas_fused(
            scene, CAM, h, w, spp, bounces, jnp.uint32(seed), jitter=jitter, interpret=True
        )
        if jitter:
            np.testing.assert_allclose(fwd, np.asarray(fused), rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(fwd, np.asarray(fused))


def test_vjp_wrapper_uses_hand_kernel():
    scene = _mixed_scene()
    h, w, spp, bounces = 8, 128, 2, 3
    target = pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(9))

    def loss_fast(albedo):
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = render_pallas_vjp(sc, CAM, h, w, spp, bounces, jnp.uint32(2), interpret=True)
        return jnp.mean((img - target) ** 2)

    def loss_core(albedo):
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = pt.render_radiance(sc, CAM, h, w, spp, bounces, jnp.uint32(2))
        return jnp.mean((img - target) ** 2)

    a0 = scene.materials.albedo
    g_fast = np.asarray(jax.grad(loss_fast)(a0))
    g_core = np.asarray(jax.grad(loss_core)(a0))
    np.testing.assert_allclose(g_fast, g_core, rtol=1e-3, atol=1e-7)


def test_fused_mat_skip_variant_matches():
    """The mat_skip=True variant (per-material presence-guarded
    accumulation — kept for very large material tables, slower on the
    bench scene) must produce the identical Jacobian."""
    from path_tracer_jax.ops.pallas_grad import render_pallas_fused

    scene = _mixed_scene()
    h, w, spp, bounces, seed = 8, 128, 2, 3, 43
    img0, j0 = render_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), mat_skip=False, interpret=True
    )
    img1, j1 = render_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(seed), mat_skip=True, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    np.testing.assert_array_equal(np.asarray(j0), np.asarray(j1))


def test_fused_executed_round_counter_matches_forward():
    """count_rounds on the FUSED kernel: the replay
    runs the exact same "once"/sky-gate schedule as the forward, so the
    executed-round totals must be EQUAL — and turning the counter on
    must not perturb the primal (the counter is an int loop-carry + one
    store per program)."""
    from path_tracer_jax.ops.pallas_grad import render_pallas_fused
    from path_tracer_jax.ops.pallas_kernels import render_pallas

    scene = demo.demo_scene()
    h, w, spp, bounces = 16, 128, 2, 3
    img_f, cnt_f = render_pallas(
        scene, CAM, h, w, spp, bounces, jnp.uint32(7), tile=(8, 128),
        jitter=False, count_rounds=True, interpret=True,
    )
    img_g, _, cnt_g = render_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(7), tile=(8, 128),
        jitter=False, count_rounds=True, interpret=True,
    )
    assert int(cnt_f) == int(cnt_g) > 0
    img_g0, _ = render_pallas_fused(
        scene, CAM, h, w, spp, bounces, jnp.uint32(7), tile=(8, 128),
        jitter=False, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(img_g), np.asarray(img_g0))
