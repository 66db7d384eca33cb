"""Sharding layer on the 8-fake-device CPU mesh (SURVEY.md SS4 strategy (d)):
sharded renders must be bit-identical to single-device renders, and the
sharded train step must agree with the unsharded gradient path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax import parallel
from path_tracer_jax.grad import diff


CAM = pt.Camera.reference()


@pytest.fixture(scope="module")
def scene():
    return demo.diffuse_sphere_scene()


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("tile,spp_ax", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_render_bit_identical(scene, tile, spp_ax):
    h, w, spp, bounces = 16, 16, 8, 2
    single = np.asarray(
        pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(5))
    )
    mesh = parallel.make_mesh(tile=tile, spp=spp_ax)
    sharded = parallel.render_sharded(
        scene, CAM, h, w, spp, bounces, jnp.uint32(5), mesh
    )
    # Identical modulo the spp-mean association order: pmean of block means
    # vs one global mean; both sum the same f32 values grouped differently.
    np.testing.assert_allclose(np.asarray(sharded), single, rtol=1e-6, atol=1e-6)


def test_sharded_render_exact_when_tile_only(scene):
    """With no spp split, even the mean association is identical ->
    bit-exact equality with the single-device image."""
    h, w, spp, bounces = 16, 16, 4, 2
    single = np.asarray(
        pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(9))
    )
    mesh = parallel.make_mesh(tile=8, spp=1)
    sharded = np.asarray(
        parallel.render_sharded(scene, CAM, h, w, spp, bounces, jnp.uint32(9), mesh)
    )
    np.testing.assert_array_equal(sharded, single)


def test_output_sharding_layout(scene):
    mesh = parallel.make_mesh(tile=4, spp=2)
    img = parallel.render_sharded(scene, CAM, 16, 16, 8, 2, jnp.uint32(0), mesh)
    assert img.shape == (16, 16, 3)
    shard_rows = {s.index[0] for s in img.addressable_shards}
    assert len(shard_rows) == 4  # image rows sharded over the tile axis


def test_divisibility_validation(scene):
    mesh = parallel.make_mesh(tile=8, spp=1)
    with pytest.raises(ValueError):
        parallel.render_sharded(scene, CAM, 12, 16, 4, 2, jnp.uint32(0), mesh)
    mesh = parallel.make_mesh(tile=1, spp=8)
    with pytest.raises(ValueError):
        parallel.render_sharded(scene, CAM, 16, 16, 4, 2, jnp.uint32(0), mesh)


def test_replicate_scene(scene):
    mesh = parallel.make_mesh(tile=4, spp=2)
    rs = parallel.replicate_scene(scene, mesh)
    leaf = rs.spheres.center
    assert len(leaf.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(leaf), np.asarray(scene.spheres.center))


def test_sharded_gradient_matches_unsharded(scene):
    h, w, spp, bounces = 16, 16, 4, 2
    target = pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(77))
    mesh = parallel.make_mesh(tile=4, spp=2)

    def loss_sharded(albedo):
        import dataclasses

        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = parallel.render_sharded(
            sc, CAM, h, w, spp, bounces, jnp.uint32(3), mesh
        )
        return jnp.mean((img - target) ** 2)

    def loss_single(albedo):
        import dataclasses

        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = pt.render_radiance(sc, CAM, h, w, spp, bounces, jnp.uint32(3))
        return jnp.mean((img - target) ** 2)

    a0 = scene.materials.albedo
    g_sharded = np.asarray(jax.grad(loss_sharded)(a0))
    g_single = np.asarray(jax.grad(loss_single)(a0))
    np.testing.assert_allclose(g_sharded, g_single, rtol=1e-4, atol=1e-7)


def test_train_step_decreases_loss(scene):
    h, w, spp, bounces = 16, 16, 4, 2
    mesh = parallel.make_mesh(tile=4, spp=2)
    target = parallel.render_sharded(
        scene, CAM, h, w, spp, bounces, jnp.uint32(101), mesh
    )
    wrong_params = jax.tree_util.tree_map(
        lambda x: x, diff.make_material_params(scene)
    )
    wrong_params["albedo_logit"] = jnp.zeros_like(wrong_params["albedo_logit"])

    opt = optax.adam(0.1)
    step = parallel.make_train_step(
        CAM, h, w, spp, bounces, mesh, opt, diff.apply_material_params
    )
    opt_state = opt.init(wrong_params)
    params = wrong_params
    losses = []
    for i in range(12):
        params, opt_state, loss = step(
            params, opt_state, scene, target, jnp.uint32(i + 1)
        )
        losses.append(float(loss))
    # spp=4 keeps the MC noise floor high; check the trend and that the
    # albedo moved toward the truth, not an absolute loss drop.
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    true_albedo = np.asarray(scene.materials.albedo)
    err0 = np.abs(1 / (1 + np.exp(-np.asarray(wrong_params["albedo_logit"]))) - true_albedo)
    err1 = np.abs(1 / (1 + np.exp(-np.asarray(params["albedo_logit"]))) - true_albedo)
    assert err1[:2].mean() < err0[:2].mean(), (err0[:2].mean(), err1[:2].mean())


def test_health_check():
    status = parallel.distributed.health_check()
    assert status["alive"] and status["devices"] == 8


def test_mesh_validation():
    with pytest.raises(ValueError):
        parallel.make_mesh(tile=3, spp=2)  # 6 != 8
    with pytest.raises(ValueError):
        parallel.make_mesh(spp=3)  # 8 % 3


def test_sharded_pallas_engine_matches_core(scene):
    """Megakernel per shard under shard_map == sharded core path."""
    h, w, spp, bounces = 16, 128, 4, 2
    mesh = parallel.make_mesh(tile=2, spp=4)
    core = np.asarray(
        parallel.render_sharded(
            scene, CAM, h, w, spp, bounces, jnp.uint32(3), mesh
        )
    )
    fast = np.asarray(
        parallel.render_sharded(
            scene, CAM, h, w, spp, bounces, jnp.uint32(3), mesh,
            engine="pallas", interpret=True,
        )
    )
    np.testing.assert_allclose(fast, core, rtol=1e-5, atol=1e-5)


def test_sharded_pallas_gradient_matches_unsharded_core(scene):
    """The fast multi-chip backward: Pallas fwd + hand-written bwd kernel
    per shard, gradients psummed by shard_map's transpose, vs the
    unsharded core-AD gradient."""
    import dataclasses

    h, w, spp, bounces = 16, 128, 4, 2
    target = pt.render_radiance(scene, CAM, h, w, spp, bounces, jnp.uint32(77))
    mesh = parallel.make_mesh(tile=2, spp=4)

    def loss_sharded_pallas(albedo):
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = parallel.render_sharded(
            sc, CAM, h, w, spp, bounces, jnp.uint32(3), mesh, engine="pallas", interpret=True
        )
        return jnp.mean((img - target) ** 2)

    def loss_single_core(albedo):
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo)
        )
        img = pt.render_radiance(sc, CAM, h, w, spp, bounces, jnp.uint32(3))
        return jnp.mean((img - target) ** 2)

    a0 = scene.materials.albedo
    g_fast = np.asarray(jax.grad(loss_sharded_pallas)(a0))
    g_core = np.asarray(jax.grad(loss_single_core)(a0))
    np.testing.assert_allclose(g_fast, g_core, rtol=1e-3, atol=1e-7)


def _flipfree_physical_scene():
    """Physical-tier scene WITHOUT giant wall spheres: triangle ground +
    unit-scale spheres + one emitter. r=1000 walls make |oc|^2 - r^2
    cancel catastrophically in f32, so rare samples flip discrete
    decisions between compilations and force loose gradient gates
; this scene is flip-free and the gate is tight."""
    b = pt.SceneBuilder(sky_color=(0.25, 0.3, 0.4))
    ground = b.add_material(albedo=(0.55, 0.45, 0.35), roughness=1.0)
    lamp = b.add_material(albedo=(0.9, 0.9, 0.9),
                          emission_color=(1.0, 0.85, 0.6),
                          emission_strength=8.0)
    glass = b.add_material(albedo=(0.95, 0.97, 1.0), transparency=0.6,
                           refractive_index=1.45, roughness=0.2)
    mirror = b.add_material(albedo=(0.9, 0.92, 0.95), roughness=0.05)
    b.add_triangle(v0=(-60, -1, -60), v1=(60, -1, -60), v2=(60, -1, 60),
                   material=ground)
    b.add_triangle(v0=(-60, -1, -60), v1=(-60, -1, 60), v2=(60, -1, 60),
                   material=ground)
    b.add_sphere(center=(0.0, 2.6, 5.5), radius=0.5, material=lamp)
    b.add_sphere(center=(-1.0, -0.2, 4.5), radius=0.8, material=mirror)
    b.add_sphere(center=(1.1, -0.3, 4.0), radius=0.7, material=glass)
    b.add_sphere(center=(0.1, -0.45, 3.2), radius=0.5, material=ground)
    return b.build()


def test_sharded_physical_pallas_gradient_matches_core():
    """Fast physical training path: physical megakernel fwd + hand
    material backward per shard vs the unsharded core physical gradient."""
    import dataclasses

    from path_tracer_jax.models.physical import render_physical

    scene_l = _flipfree_physical_scene()
    h, w, spp, bounces = 16, 128, 2, 2
    target = render_physical(
        scene_l, CAM, h, w, spp, bounces, jnp.uint32(77), jitter=False
    )
    mesh = parallel.make_mesh(tile=2, spp=4)

    def with_albedo(albedo):
        return dataclasses.replace(
            scene_l,
            materials=dataclasses.replace(scene_l.materials, albedo=albedo),
        )

    def loss_sharded_fast(albedo):
        img = parallel.render_sharded(
            with_albedo(albedo), CAM, h, w, spp * 4, bounces, jnp.uint32(3),
            mesh, engine="physical_pallas", jitter=False, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    def loss_single_core(albedo):
        img = render_physical(
            with_albedo(albedo), CAM, h, w, spp * 4, bounces, jnp.uint32(3),
            jitter=False,
        )
        return jnp.mean((img - target) ** 2)

    a0 = scene_l.materials.albedo
    g_fast = np.asarray(jax.grad(loss_sharded_fast)(a0))
    g_core = np.asarray(jax.grad(loss_single_core)(a0))
    # flip-free scene (no r=1000 walls): tight gate, same class as the
    # other backward parity tests
    np.testing.assert_allclose(g_fast, g_core, rtol=2e-3, atol=3e-6)


def test_sharded_physical_geom_gradient_matches_unsharded():
    """geom=True under the mesh:
    the psummed NEE emitter-geometry cotangent must equal the unsharded
    fused cotangent, and must be nonzero for the light."""
    import dataclasses

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene_l = _flipfree_physical_scene()
    h, w, spp, bounces = 16, 128, 4, 2
    target = jnp.zeros((h, w, 3), jnp.float32)
    mesh = parallel.make_mesh(tile=2, spp=4)

    def with_light(center):
        return dataclasses.replace(
            scene_l,
            spheres=dataclasses.replace(
                scene_l.spheres,
                center=scene_l.spheres.center.at[0].set(center),
            ),
        )

    def loss_sharded(center):
        img = parallel.render_sharded(
            with_light(center), CAM, h, w, spp, bounces, jnp.uint32(3),
            mesh, engine="physical_pallas", jitter=False, geom=True,
            n_em_cap=1, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    def loss_single(center):
        img = render_physical_pallas_vjp(
            with_light(center), CAM, h, w, spp, bounces, jnp.uint32(3),
            jitter=False, geom=True, n_em_cap=1, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    c0 = scene_l.spheres.center[0]
    g_sharded = np.asarray(jax.grad(loss_sharded)(c0))
    g_single = np.asarray(jax.grad(loss_single)(c0))
    assert np.abs(g_single).max() > 1e-8
    np.testing.assert_allclose(g_sharded, g_single, rtol=1e-4, atol=1e-9)


def test_sharded_physical_engine_matches_unsharded(scene):
    """Physical BRDF/NEE tier under a mesh == its unsharded render."""
    from path_tracer_jax.models.physical import render_physical

    h, w, spp, bounces = 16, 16, 4, 2
    scene_l = demo.cornell_spheres_scene()
    single = np.asarray(
        render_physical(scene_l, CAM, h, w, spp, bounces, jnp.uint32(5))
    )
    mesh = parallel.make_mesh(tile=4, spp=2)
    sharded = np.asarray(
        parallel.render_sharded(
            scene_l, CAM, h, w, spp, bounces, jnp.uint32(5), mesh,
            engine="physical", jitter=True,
        )
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5)


def _tri_lamp_scene():
    """Quad triangle light over a diffuse floor + ball (the tri_nee
    workload), small enough for the 8-fake-device mesh tests."""
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
    return b.build()


def test_sharded_tri_nee_matches_unsharded():
    """tri_nee through the parallel layer: the
    sharded tri-NEE render equals its unsharded render in BOTH physical
    engines, and tri_nee on a non-physical engine raises."""
    from path_tracer_jax.models.physical import render_physical
    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene_t = _tri_lamp_scene()
    h, w, spp, bounces = 16, 16, 4, 2
    mesh = parallel.make_mesh(tile=4, spp=2)
    single = np.asarray(
        render_physical(scene_t, CAM, h, w, spp, bounces, jnp.uint32(5),
                        jitter=False, tri_nee=True)
    )
    for engine in ("physical", "physical_pallas"):
        sharded = np.asarray(
            parallel.render_sharded(
                scene_t, CAM, h, w, spp, bounces, jnp.uint32(5), mesh,
                engine=engine, jitter=False, tri_nee=True, interpret=True,
            )
        )
        np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5,
                                   err_msg=engine)
    with pytest.raises(ValueError):
        parallel.render_sharded(
            scene_t, CAM, h, w, spp, bounces, jnp.uint32(5), mesh,
            engine="core", tri_nee=True,
        )


def test_sharded_tri_nee_vertex_gradient_matches_unsharded():
    """The psummed tri-emitter VERTEX cotangent (geom=True + tri_nee
    under the mesh) equals the unsharded fused cotangent, and is
    nonzero for the lamp."""
    import dataclasses

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene_t = _tri_lamp_scene()
    h, w, spp, bounces = 16, 16, 4, 2
    target = jnp.zeros((h, w, 3), jnp.float32)
    mesh = parallel.make_mesh(tile=2, spp=4)

    def with_lamp(v0):
        return dataclasses.replace(
            scene_t,
            triangles=dataclasses.replace(
                scene_t.triangles, v0=scene_t.triangles.v0.at[2].set(v0)
            ),
        )

    def loss_sharded(v0):
        img = parallel.render_sharded(
            with_lamp(v0), CAM, h, w, spp, bounces, jnp.uint32(3), mesh,
            engine="physical_pallas", jitter=False, geom=True,
            n_em_cap=1, tri_nee=True, tri_em_cap=2, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    def loss_single(v0):
        img = render_physical_pallas_vjp(
            with_lamp(v0), CAM, h, w, spp, bounces, jnp.uint32(3),
            jitter=False, geom=True, n_em_cap=1, tri_nee=True,
            tri_em_cap=2, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    v0 = scene_t.triangles.v0[2]
    g_sharded = np.asarray(jax.grad(loss_sharded)(v0))
    g_single = np.asarray(jax.grad(loss_single)(v0))
    assert np.abs(g_single).max() > 1e-10
    np.testing.assert_allclose(g_sharded, g_single, rtol=1e-4, atol=1e-12)


def test_sharded_rough_grad_matches_unsharded():
    """The psummed score-function roughness cotangent (rough_grad=True
    under the mesh, fused Jacobian planes per shard) equals the
    unsharded one, and is nonzero."""
    import dataclasses

    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    scene_g = demo.glossy_scene()
    h, w, spp, bounces = 16, 16, 4, 2
    target = jnp.zeros((h, w, 3), jnp.float32)
    mesh = parallel.make_mesh(tile=2, spp=4)

    def with_rough(r):
        return dataclasses.replace(
            scene_g,
            materials=dataclasses.replace(
                scene_g.materials,
                roughness=scene_g.materials.roughness.at[0].set(r),
            ),
        )

    def loss_sharded(r):
        img = parallel.render_sharded(
            with_rough(r), CAM, h, w, spp, bounces, jnp.uint32(3), mesh,
            engine="physical_pallas", jitter=False, rough_grad=True, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    def loss_single(r):
        img = render_physical_pallas_vjp(
            with_rough(r), CAM, h, w, spp, bounces, jnp.uint32(3),
            jitter=False, geom=False, rough_grad=True, interpret=True,
        )
        return jnp.mean((img - target) ** 2)

    r0 = scene_g.materials.roughness[0]
    g_sharded = float(jax.grad(loss_sharded)(r0))
    g_single = float(jax.grad(loss_single)(r0))
    assert abs(g_single) > 1e-10
    assert abs(g_sharded - g_single) <= 1e-4 * max(abs(g_single), 1e-6)
    with pytest.raises(ValueError, match="rough_grad"):
        parallel.render_sharded(
            scene_g, CAM, h, w, spp, bounces, jnp.uint32(3), mesh,
            engine="pallas", rough_grad=True, interpret=True,
        )
