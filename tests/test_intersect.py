"""Intersection: vectorized ray/sphere + ray/triangle vs analytic cases and
the scalar reference (semantics of rtx_frag.glsl:92-192)."""

import numpy as np
import jax.numpy as jnp

from path_tracer_jax import SceneBuilder, trace
from path_tracer_jax.ops.intersect import ray_sphere_t, ray_triangle_t
import reference_tracer as ref


def _rays(rows):
    o = jnp.asarray([r[0] for r in rows], jnp.float32)
    d = jnp.asarray([r[1] for r in rows], jnp.float32)
    return o, d


def test_sphere_analytic():
    o, d = _rays(
        [
            ((0, 0, 0), (0, 0, 1)),  # head-on: hits at z=4
            ((0, 0, 0), (0, 0, -1)),  # away: miss
            ((0, 0, 10), (0, 0, -1)),  # from behind: hits at 4 -> t=6... z=6
            ((0, 3, 0), (0, 0, 1)),  # offset: miss (radius 1)
            ((0, 0, 5), (0, 0, 1)),  # inside: exits at z=6 -> t=1
        ]
    )
    center = jnp.asarray([[0.0, 0.0, 5.0]])
    radius = jnp.asarray([1.0])
    active = jnp.asarray([True])
    t = np.asarray(ray_sphere_t(o, d, center, radius, active))[:, 0]
    assert np.isclose(t[0], 4.0)
    assert np.isinf(t[1])
    assert np.isclose(t[2], 4.0)
    assert np.isinf(t[3])
    assert np.isclose(t[4], 1.0)  # nearer root negative -> t2 (glsl:112-114)


def test_sphere_inactive_masked():
    o, d = _rays([((0, 0, 0), (0, 0, 1))])
    t = ray_sphere_t(
        o, d, jnp.asarray([[0.0, 0.0, 5.0]]), jnp.asarray([1.0]), jnp.asarray([False])
    )
    assert np.isinf(np.asarray(t)).all()


def test_triangle_analytic():
    v0 = jnp.asarray([[-1.0, -1.0, 5.0]])
    v1 = jnp.asarray([[1.0, -1.0, 5.0]])
    v2 = jnp.asarray([[0.0, 1.0, 5.0]])
    active = jnp.asarray([True])
    o, d = _rays(
        [
            ((0, 0, 0), (0, 0, 1)),  # through the middle
            ((5, 5, 0), (0, 0, 1)),  # outside
            ((0, 0, 10), (0, 0, 1)),  # behind
            ((0, 0, 0), (1, 0, 0)),  # parallel to plane
        ]
    )
    t = np.asarray(ray_triangle_t(o, d, v0, v1, v2, active))[:, 0]
    assert np.isclose(t[0], 5.0)
    assert np.isinf(t[1])
    assert np.isinf(t[2])
    assert np.isinf(t[3])


def test_matches_scalar_reference_random_rays():
    rng = np.random.default_rng(0)
    b = SceneBuilder()
    m = b.add_material(albedo=(1, 1, 1))
    for _ in range(6):
        b.add_sphere(center=tuple(rng.uniform(-3, 3, 3) + [0, 0, 6]), radius=rng.uniform(0.5, 1.5), material=m)
    for _ in range(4):
        base = rng.uniform(-3, 3, 3) + [0, 0, 6]
        b.add_triangle(
            v0=tuple(base),
            v1=tuple(base + rng.uniform(-2, 2, 3)),
            v2=tuple(base + rng.uniform(-2, 2, 3)),
            material=m,
        )
    scene = b.build()
    sc = ref.scene_to_numpy(scene)

    n = 64
    o_np = rng.uniform(-1, 1, (n, 3))
    d_np = rng.normal(size=(n, 3))
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    hit = trace(jnp.asarray(o_np, jnp.float32), jnp.asarray(d_np, jnp.float32), scene)

    for i in range(n):
        got = ref.trace_ray(sc, o_np[i], d_np[i])
        if got is None:
            assert not bool(hit.mask[i]), f"ray {i}: jax hit, scalar missed"
        else:
            t_ref, p_ref, n_ref_, mi = got
            assert bool(hit.mask[i]), f"ray {i}: jax missed, scalar hit"
            assert np.isclose(float(hit.t[i]), t_ref, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                np.asarray(hit.point[i]), p_ref, rtol=1e-3, atol=1e-3
            )
            np.testing.assert_allclose(
                np.asarray(hit.normal[i]), n_ref_, rtol=1e-2, atol=1e-3
            )
            assert int(hit.material[i]) == int(mi)


def test_triangle_normal_opposes_ray():
    b = SceneBuilder()
    m = b.add_material(albedo=(1, 1, 1))
    b.add_triangle(v0=(-5, -1, 0), v1=(5, -1, 0), v2=(0, -1, 10), material=m)
    scene = b.build()
    # from above and from below: normal must oppose the ray both times
    o, d = _rays([((0, 1, 3), (0, -1, 0)), ((0, -3, 3), (0, 1, 0))])
    hit = trace(o, d, scene)
    assert float(jnp.sum(hit.normal[0] * d[0])) < 0
    assert float(jnp.sum(hit.normal[1] * d[1])) < 0
