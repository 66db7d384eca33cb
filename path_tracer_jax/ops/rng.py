"""Counter-based PCG random number generation, vectorized.

Vectorized re-design of the reference's GPU RNG (C10 in SURVEY.md):
the PCG hash of ``/root/reference/shaders/rtx_frag.glsl:64-90`` (constants
747796405 / 2891336453 / 277803737, shift schedule identical), the Box-Muller
normal sampler (``rtx_frag.glsl:78-83``) and the Gaussian unit-sphere sampler
(``rtx_frag.glsl:85-90``), implemented as pure functions over uint32 jnp
arrays so that

* the same stream is reproducible across CPU / GPU / Pallas kernels
  (all three implement this exact hash), enabling exact golden tests, and
* every lane of a ray wavefront carries its own counter, so results are
  independent of how pixels are sharded across chips (the multi-host
  determinism requirement of SURVEY.md SS7 hard-part (e)).

Unlike the reference host seeding (``srandom(time(NULL))``,
``/root/reference/src/main.c:140``), seeding here is fully deterministic from
``(pixel_idx, sample_idx, root_seed)``. We also decorrelate sample streams
properly instead of the reference's overlapping ``rng_state += sample_id``
re-seed (``rtx_frag.glsl:289``).

All functions are shape-polymorphic: ``state`` may be any uint32 array and
draws are elementwise over it.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "PCG_MULT",
    "pcg_next",
    "uniform",
    "normal",
    "sincos_2pi",
    "unit_sphere",
    "unit_sphere_gaussian",
    "unit_sphere_biased",
    "seed_state",
]

# Constants from rtx_frag.glsl:66-71 (PCG, www.pcg-random.org).
PCG_MULT = 747796405
PCG_INC = 2891336453
PCG_XSH = 277803737
# Weyl / splitmix-style mixing constants for decorrelated seeding.
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35

_TWO_PI = 6.283185307179586
_INV_U32_MAX = 1.0 / 4294967295.0  # rtx_frag.glsl:74 divides by 2^32 - 1.


def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def pcg_next(state):
    """One PCG step: returns ``(new_state, random_bits)``.

    Bit-exact with ``next_random`` at rtx_frag.glsl:66-71: the state advances
    by an LCG and the output is an xorshift-multiply permutation of the *new*
    state.
    """
    state = _u32(state)
    state = state * _u32(PCG_MULT) + _u32(PCG_INC)
    word = ((state >> ((state >> 28) + _u32(4))) ^ state) * _u32(PCG_XSH)
    bits = (word >> 22) ^ word
    return state, bits


def uniform(state):
    """Uniform float32 in [0, 1]; returns ``(new_state, value)``.

    Matches ``random_value`` (rtx_frag.glsl:73-75): bits / (2^32 - 1).
    """
    state, bits = pcg_next(state)
    return state, bits.astype(jnp.float32) * jnp.float32(_INV_U32_MAX)


def normal(state):
    """Standard normal via Box-Muller; returns ``(new_state, value)``.

    Matches ``random_value_normal_dist`` (rtx_frag.glsl:78-83): theta from
    the first uniform, rho from the second. The log argument is clamped away
    from zero (the reference can produce log(0) with probability 2^-32).
    """
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    theta = jnp.float32(_TWO_PI) * u1
    rho = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u2, jnp.float32(1e-38))))
    return state, rho * jnp.cos(theta)


# Quadrant-folded polynomial sin/cos of 2*pi*u — THE trig spec shared by
# every implementation (core, both Pallas kernel families via direct
# import, the scalar oracle via its numpy mirror): it unrolls to ~20
# ALU ops and is bit-identical wherever it runs. Max abs error vs
# float64 sin/cos: 3.9e-7 (~3 f32 ulps) — far below Monte-Carlo noise.
# Least-squares coefficients on [-pi/4, pi/4] (script in git history).
_COS_C1 = -4.9999915618e-01
_COS_C2 = 4.1657625659e-02
_COS_C3 = -1.3615911837e-03
_SIN_C1 = -1.6666653296e-01
_SIN_C2 = 8.3321242496e-03
_SIN_C3 = -1.9513782088e-04
_HALF_PI = 1.5707963267948966


def sincos_2pi(u):
    """(cos(2*pi*u), sin(2*pi*u)) for u in [0, 1), branchless polynomial.

    Fold into the quadrant nearest k*pi/2 (residual in [-pi/4, pi/4]),
    evaluate degree-6/7 minimax polynomials, and reassemble with sign/
    swap selects. Elementwise jnp — works on scalars, wavefront arrays
    and Pallas (TH, TW) planes alike.
    """
    f32 = jnp.float32
    u = u.astype(jnp.float32) if hasattr(u, "astype") else f32(u)
    k = jnp.floor(u * f32(4.0) + f32(0.5))
    r = u * f32(_TWO_PI) - k * f32(_HALF_PI)
    t2 = r * r
    cosr = f32(1.0) + t2 * (
        f32(_COS_C1) + t2 * (f32(_COS_C2) + t2 * f32(_COS_C3))
    )
    sinr = r * (
        f32(1.0) + t2 * (f32(_SIN_C1) + t2 * (f32(_SIN_C2)
                                              + t2 * f32(_SIN_C3)))
    )
    k4 = k - f32(4.0) * jnp.floor(k * f32(0.25))
    swap = (k4 == 1.0) | (k4 == 3.0)
    a = jnp.where(swap, sinr, cosr)
    b = jnp.where(swap, cosr, sinr)
    neg_c = (k4 == 1.0) | (k4 == 2.0)
    neg_s = (k4 == 2.0) | (k4 == 3.0)
    return jnp.where(neg_c, -a, a), jnp.where(neg_s, -b, b)


def unit_sphere(state):
    """Unbiased uniform direction on S^2, cylindrical (z, phi) method.

    Archimedes: z uniform on [-1, 1] and phi uniform give an exactly
    uniform sphere direction — the same distribution as the reference's
    three-Gaussian sampler (rand_unit_sphere, rtx_frag.glsl:85-90, kept
    as :func:`unit_sphere_gaussian`) at a fraction of the transcendental
    cost (2 draws + sqrt + polynomial sincos vs 6 draws + 3 log + 3 cos
    + sqrt). This is the production sampler across core, Pallas and the
    oracle. Returns ``(new_state, dir)`` with a trailing axis of size 3.
    """
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    z = 1.0 - 2.0 * u1
    c, s = sincos_2pi(u2)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return state, jnp.stack([r * c, r * s, z], axis=-1)


def unit_sphere_gaussian(state):
    """The reference GPU sampler: three Gaussians normalized
    (rand_unit_sphere, rtx_frag.glsl:85-90). Distribution-identical to
    :func:`unit_sphere`; kept for documentation and statistical tests."""
    state, x = normal(state)
    state, y = normal(state)
    state, z = normal(state)
    v = jnp.stack([x, y, z], axis=-1)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-20))
    return state, v / norm


def unit_sphere_biased(state):
    """The CPU backend's *biased* sphere sampler (src/renderer.c:11-19).

    Normalizes a uniform sample of the cube [-1, 1]^3 — directions toward
    cube corners are over-represented. Kept verbatim as the "cpu" capability
    tier's sampler (SURVEY.md SS3.3 documents the two tiers); the default
    tier uses the unbiased :func:`unit_sphere`. Three uniforms are drawn
    (the reference draws ``random()`` three times).
    """
    state, x = uniform(state)
    state, y = uniform(state)
    state, z = uniform(state)
    v = jnp.stack([x, y, z], axis=-1) * 2.0 - 1.0
    norm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-20))
    return state, v / norm


def seed_state(pixel_idx, sample_idx, root_seed):
    """Derive a well-mixed uint32 PCG state from global counters.

    Counter-based analog of the per-pixel seeding at rtx_frag.glsl:277-278
    (``rng_state = pixel_idx + random_seed``) but decorrelated across samples
    with splitmix-style multiplies plus two PCG rounds, instead of the
    reference's overlapping ``rng_state += sample_id`` (rtx_frag.glsl:289).

    ``pixel_idx`` / ``sample_idx`` are global indices, so the stream is
    independent of device sharding.
    """
    s = (
        _u32(pixel_idx) * _u32(_GOLDEN)
        ^ _u32(sample_idx) * _u32(_MIX1)
        ^ _u32(root_seed) * _u32(_MIX2)
    )
    s, _ = pcg_next(s)
    s, _ = pcg_next(s)
    return s
