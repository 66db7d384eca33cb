"""The reference GPU shader's deterministic two-branch SPLIT estimator.

The reference's ``incident_light`` pushes BOTH children of a transparent
hit onto a ray stack — reflect weighted ``1 - t`` and refract weighted
``t`` (``/root/reference/shaders/rtx_frag.glsl:193-273``, stack of
``(1 << MAX_BOUNCES) + 1`` items) — a deterministic convex split, not a
random branch pick. The production tiers here use single-path selection
(expectation-identical, and exact for t in {0, 1}; the SPLIT is strictly
lower-variance for 0 < t < 1 — tested in tests/test_split.py), because
one path per lane is what keeps a wavefront megakernel's state bounded.

Vectorized re-design of the stack: **breadth-first level expansion**. The
Python loop over tree levels unrolls at trace time, so level ``b`` is a
statically-shaped ``(N * 2^b,)`` wavefront — no dynamic stack, no masking
waste; the total node count equals the reference's tree exactly. Children
of slot ``k`` land in slots ``2k`` (reflect) and ``2k+1`` (refract).

RNG contract: each node draws its roughness deviation from its OWN
stream. The reference threads one sequential ``rng_state`` through its
LIFO pops (an order no parallel schedule can reproduce), so the split
tier's documented contract is per-node streams instead — the reflect
child inherits the parent's advanced state, the refract child gets a
decorrelating PCG hop (``pcg_next(state ^ SPLIT_SALT)``). The scalar
oracle (tests/reference_tracer.incident_light_split) mirrors this BFS
contract exactly; the expectation equals the reference's (streams are
iid).

This is a PARITY/ANALYSIS tier (core XLA path only): it exists so the
reference's exact estimator semantics are runnable and so the
variance/throughput tradeoff vs single-path selection is measurable —
the production fast path stays single-path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import rng as _rng
from ..ops.camera import Camera, pixel_indices, primary_rays
from ..ops.intersect import trace
from ..ops.sampling import reflect, refract
from ..scene.scene import Scene
from .integrator import DEFAULT_EPS_OFFSET, EPS_OFFSET_SCALE

__all__ = ["trace_paths_split", "render_split", "SPLIT_SALT"]

# Decorrelating salt for the refract child's stream (see module doc).
SPLIT_SALT = 0x632BE59B


def _child_state(state):
    """The refract child's RNG stream: one PCG hop off a salted parent."""
    st, _ = _rng.pcg_next(state ^ jnp.uint32(SPLIT_SALT))
    return st


def trace_paths_split(scene: Scene, origins, directions, state,
                      max_bounces: int):
    """Split-estimator radiance (N, 3) for a wavefront of N camera rays.

    Level arrays double per bounce (static shapes; see module doc), so
    memory is O(N * 2^max_bounces) — use small bounce budgets (the
    reference's own stack bounds MAX_BOUNCES the same way,
    rtx_frag.glsl:195).
    """
    if max_bounces > 10:
        raise ValueError("split estimator: max_bounces > 10 would "
                         f"materialize 2^{max_bounces} paths per sample")
    n = origins.shape[0]
    sky = scene.sky_color[None, :]
    mats = scene.materials

    total = jnp.zeros((n, 3), jnp.float32)
    o, d = origins, directions
    w = jnp.ones((n, 3), jnp.float32)  # color (throughput weight)
    st = state
    live = jnp.ones((n,), bool)

    def fold(total, contrib):
        # level-b contributions are (n * 2^b, 3): sum siblings per camera ray
        return total + jnp.sum(contrib.reshape(n, -1, 3), axis=1)

    for b in range(max_bounces + 1):
        hit = trace(o, d, scene)
        miss = live & ~hit.mask
        total = fold(total, jnp.where(miss[:, None], w * sky, 0.0))
        alive = live & hit.mask

        # Le then albedo (rtx_frag.glsl:224-228)
        m = hit.material
        emission = (mats.emission_color[m]
                    * mats.emission_strength[m][:, None])
        total = fold(total, jnp.where(alive[:, None], w * emission, 0.0))
        w = jnp.where(alive[:, None], w * mats.albedo[m], w)

        # ONE unit-sphere draw per node; both children share the
        # perturbed normal (rtx_frag.glsl:231-233 draws before branching)
        st, dev = _rng.unit_sphere(st)
        rough_n = hit.normal + mats.roughness[m][:, None] * dev
        rough_n = rough_n * jax.lax.rsqrt(jnp.maximum(
            jnp.sum(rough_n * rough_n, -1, keepdims=True), 1e-20))

        transp = mats.transparency[m]
        refl_d = reflect(d, rough_n)
        ndot = jnp.sum(d * rough_n, axis=-1, keepdims=True)
        entering = ndot < 0.0
        eta = jnp.where(entering[..., 0], 1.0 / mats.refractive_index[m],
                        mats.refractive_index[m])[:, None]
        refr_nrm = jnp.where(entering, rough_n, -rough_n)
        refr_d, tir = refract(d, refr_nrm, eta)

        # child push rules (rtx_frag.glsl:235-270): reflect iff t < 1,
        # refract iff t > 0 and not TIR; weights (1-t) / t
        refl_alive = alive & (transp < 1.0)
        refr_alive = alive & (transp > 0.0) & ~tir
        refl_w = w * (1.0 - transp)[:, None]
        refr_w = w * transp[:, None]

        if b == max_bounces:
            # children would exceed the bounce budget: they pop straight
            # into the sky contribution (rtx_frag.glsl:211-214)
            total = fold(total, jnp.where(refl_alive[:, None],
                                          refl_w * sky, 0.0))
            total = fold(total, jnp.where(refr_alive[:, None],
                                          refr_w * sky, 0.0))
            break

        # self-intersection offset along the normal with the
        # scale-adaptive magnitude shared by the other tiers
        p = hit.point
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * jnp.sqrt(
            jnp.maximum(jnp.sum(p * p, axis=-1, keepdims=True), 1e-20)
        )
        side_r = jnp.where(
            jnp.sum(refl_d * hit.normal, -1, keepdims=True) >= 0.0, 1.0, -1.0
        )
        side_t = jnp.where(
            jnp.sum(refr_d * hit.normal, -1, keepdims=True) >= 0.0, 1.0, -1.0
        )

        def il(a, bb):
            # interleave so slot k's children are 2k / 2k+1
            return jnp.stack([a, bb], axis=1).reshape((-1,) + a.shape[1:])

        o = il(p + offs * side_r * hit.normal,
               p + offs * side_t * hit.normal)
        d = il(refl_d, jnp.where(tir[:, None], d, refr_d))
        w = il(refl_w, refr_w)
        st = il(st, _child_state(st))
        live = il(refl_alive, refr_alive)

    return total


def render_split(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset=0,
):
    """Split-estimator radiance image (H, W, 3) — the reference GPU
    shader's exact estimator semantics (see module doc). Core XLA path;
    memory scales with 2^max_bounces."""
    pix = pixel_indices(height, width, 0, height)
    o, d = primary_rays(camera, height, width)

    def body(accum, sample_idx):
        st = _rng.seed_state(pix, sample_idx, seed)
        return accum + trace_paths_split(scene, o, d, st, max_bounces), None

    init = jnp.zeros((height * width, 3), jnp.float32)
    sample_ids = jnp.arange(spp, dtype=jnp.int32) + jnp.int32(sample_offset)
    accum, _ = jax.lax.scan(body, init, sample_ids)
    return (accum / spp).reshape(height, width, 3)
