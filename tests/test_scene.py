"""Scene builder: the five verbs of include/scene.h:17-30 and the demo
scene's exact values (src/main.c:202-230)."""

import numpy as np
import jax.numpy as jnp
import pytest

from path_tracer_jax import SceneBuilder, demo


def test_add_material_returns_index():
    b = SceneBuilder()
    assert b.add_material(albedo=(1, 0, 0)) == 0
    assert b.add_material(albedo=(0, 1, 0)) == 1
    assert b.add_material(albedo=(0, 0, 1)) == 2


def test_growth_beyond_initial_capacity():
    # src/scene.c grows by doubling; our builder is a list + padded build.
    b = SceneBuilder()
    m = b.add_material(albedo=(1, 1, 1))
    for i in range(100):
        b.add_sphere(center=(i, 0, 0), radius=1.0, material=m)
    s = b.build()
    assert s.num_spheres >= 100
    assert int(np.sum(np.asarray(s.spheres.active))) == 100


def test_capacity_validation():
    b = SceneBuilder()
    m = b.add_material(albedo=(1, 1, 1))
    for i in range(10):
        b.add_sphere(center=(i, 0, 0), radius=1.0, material=m)
    with pytest.raises(ValueError):
        b.build(sphere_capacity=4)


def test_padding_is_inactive():
    b = SceneBuilder()
    m = b.add_material(albedo=(1, 1, 1))
    b.add_sphere(center=(0, 0, 5), radius=1.0, material=m)
    s = b.build(sphere_capacity=16, triangle_capacity=8)
    act = np.asarray(s.spheres.active)
    assert act[0] and not act[1:].any()
    assert not np.asarray(s.triangles.active).any()


def test_demo_scene_matches_reference_values():
    s = demo.demo_scene()
    # 5 materials, 4 spheres, 2 triangles, black sky (src/main.c:202-230).
    assert s.num_materials == 5
    assert int(np.sum(np.asarray(s.spheres.active))) == 4
    assert int(np.sum(np.asarray(s.triangles.active))) == 2
    np.testing.assert_allclose(np.asarray(s.sky_color), 0.0)
    # sun material (src/main.c:208-210)
    np.testing.assert_allclose(
        np.asarray(s.materials.albedo[0]), [0.9372, 0.7490, 0.0157], atol=1e-6
    )
    assert float(s.materials.emission_strength[0]) == 10.0
    # glass (src/main.c:218-219): transparency 1, IOR 1.52
    assert float(s.materials.transparency[4]) == 1.0
    assert abs(float(s.materials.refractive_index[4]) - 1.52) < 1e-6
    # mirror sphere (src/main.c:224): center (0,1.5,10) r=2.5
    np.testing.assert_allclose(np.asarray(s.spheres.center[3]), [0.0, 1.5, 10.0])
    assert float(s.spheres.radius[3]) == 2.5


def test_scene_is_pytree():
    import jax

    s = demo.demo_scene()
    leaves = jax.tree_util.tree_leaves(s)
    assert all(isinstance(l, jnp.ndarray) for l in leaves)
    s2 = jax.tree_util.tree_map(lambda x: x, s)
    assert type(s2) is type(s)


def test_scene_json_roundtrip(tmp_path):
    from path_tracer_jax.scene import io as scene_io

    scene = demo.demo_scene()
    p = tmp_path / "demo.json"
    scene_io.save_scene(p, scene)
    loaded = scene_io.load_scene(p)
    import jax

    for a, b in zip(
        jax.tree_util.tree_leaves(scene), jax.tree_util.tree_leaves(loaded)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scene_json_renders_identically(tmp_path):
    from path_tracer_jax.scene import io as scene_io
    import path_tracer_jax as pt

    scene = demo.diffuse_sphere_scene()
    p = tmp_path / "s.json"
    scene_io.save_scene(p, scene)
    loaded = scene_io.load_scene(p)
    cam = pt.Camera.reference()
    a = pt.render_radiance(scene, cam, 8, 8, 2, 2, jnp.uint32(1))
    b = pt.render_radiance(loaded, cam, 8, 8, 2, 2, jnp.uint32(1))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
