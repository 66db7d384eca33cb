"""RNG: vectorized PCG must match the scalar reference bit-for-bit and be
statistically sound (SURVEY.md SS4 determinism strategy)."""

import numpy as np
import jax.numpy as jnp

from path_tracer_jax.ops import rng
import reference_tracer as ref


def test_pcg_bits_match_scalar():
    states = np.array([0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF], dtype=np.uint32)
    jstate, jbits = rng.pcg_next(jnp.asarray(states))
    for i, s in enumerate(states):
        ps, pb = ref.pcg_next(int(s))
        assert int(jstate[i]) == ps
        assert int(jbits[i]) == pb


def test_pcg_stream_matches_scalar():
    s_j = jnp.asarray(np.uint32(42))
    s_p = 42
    for _ in range(100):
        s_j, b_j = rng.pcg_next(s_j)
        s_p, b_p = ref.pcg_next(s_p)
        assert int(b_j) == b_p


def test_uniform_range_and_match():
    state = rng.seed_state(
        jnp.arange(4096, dtype=jnp.int32), jnp.int32(0), jnp.uint32(7)
    )
    state, u = rng.uniform(state)
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.02
    # spot-check a lane against the scalar path
    st = ref.seed_state(17, 0, 7)
    st, up = ref.uniform(st)
    assert np.isclose(u[17], up, atol=1e-6)


def test_normal_moments():
    state = rng.seed_state(
        jnp.arange(1 << 14, dtype=jnp.int32), jnp.int32(3), jnp.uint32(0)
    )
    state, x = rng.normal(state)
    x = np.asarray(x)
    assert abs(x.mean()) < 0.03
    assert abs(x.std() - 1.0) < 0.03


def test_unit_sphere_is_unit_and_isotropic():
    state = rng.seed_state(
        jnp.arange(1 << 14, dtype=jnp.int32), jnp.int32(0), jnp.uint32(9)
    )
    state, v = rng.unit_sphere(state)
    v = np.asarray(v)
    norms = np.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    assert np.all(np.abs(v.mean(axis=0)) < 0.03)


def test_seed_state_decorrelates_samples():
    """Consecutive sample streams must not overlap (unlike the reference's
    rng_state += sample_id quirk, rtx_frag.glsl:289)."""
    pix = jnp.arange(1024, dtype=jnp.int32)
    s0 = np.asarray(rng.seed_state(pix, jnp.int32(0), jnp.uint32(1)))
    s1 = np.asarray(rng.seed_state(pix, jnp.int32(1), jnp.uint32(1)))
    assert not np.any(s0 == s1)


def test_draw_order_stability():
    """3 draws per bounce: unit_sphere advances state by 2, uniform by 1."""
    s = jnp.asarray(np.uint32(1234))
    s1, _ = rng.unit_sphere(s)
    expect = s
    for _ in range(2):
        expect, _ = rng.pcg_next(expect)
    assert int(s1) == int(expect)


def test_gaussian_sampler_unit_and_isotropic():
    """The reference-matching Gaussian sampler stays available."""
    state = rng.seed_state(
        jnp.arange(1 << 12, dtype=jnp.int32), jnp.int32(0), jnp.uint32(2)
    )
    state, v = rng.unit_sphere_gaussian(state)
    v = np.asarray(v)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    assert np.all(np.abs(v.mean(axis=0)) < 0.06)


def test_sincos_2pi_polynomial_spec():
    """The shared polynomial trig spec: accurate to a few f32 ulps vs
    float64 trig, near-unit norm, and the oracle's numpy mirror matches
    bit-for-bit (it IS the same formula in f32)."""
    import math

    import reference_tracer as ref

    u = jnp.asarray(np.linspace(0.0, 1.0, 4097, dtype=np.float32)[:-1])
    c, s = rng.sincos_2pi(u)
    c, s = np.asarray(c, np.float64), np.asarray(s, np.float64)
    u64 = np.asarray(u, np.float64)
    assert np.abs(c - np.cos(2 * math.pi * u64)).max() < 5e-7
    assert np.abs(s - np.sin(2 * math.pi * u64)).max() < 5e-7
    assert np.abs(c * c + s * s - 1.0).max() < 1e-6
    # oracle mirror is bit-identical on the same f32 inputs
    for uu in np.random.default_rng(3).random(64, dtype=np.float32):
        co, so = ref.sincos_2pi(float(uu))
        cj, sj = rng.sincos_2pi(jnp.float32(uu))
        assert np.float32(co) == np.float32(cj), uu
        assert np.float32(so) == np.float32(sj), uu


def test_unit_sphere_polynomial_isotropic():
    """unit_sphere with the polynomial sincos stays unit-norm and
    isotropic (mean direction ~0, z moments uniform)."""
    state = rng.seed_state(
        jnp.arange(1 << 13, dtype=jnp.int32), jnp.int32(1), jnp.uint32(5)
    )
    _, v = rng.unit_sphere(state)
    v = np.asarray(v)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=2e-6)
    assert np.all(np.abs(v.mean(axis=0)) < 0.04)
    # z uniform on [-1,1]: var = 1/3
    assert abs(np.var(v[:, 2]) - 1.0 / 3.0) < 0.02
