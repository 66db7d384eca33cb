"""Wavefront path-tracing integrator: ``lax.scan`` over bounces.

The vectorized re-design of the reference's two light-transport loops (C3:
recursive ``incident_light`` at ``/root/reference/src/renderer.c:21-74``;
C9: the explicit ray *stack* at ``shaders/rtx_frag.glsl:194-274``). Instead
of recursion or a per-pixel stack, the whole image is a **wavefront**: every
pixel-sample advances one bounce per ``lax.scan`` iteration with throughput
accumulation, and terminated rays become masked lanes — the SIMD-friendly
form SURVEY.md SS3.2 calls for.

Estimator: the GPU reference *branches* into a reflect ray weighted
``(1 - transparency)`` and a refract ray weighted ``transparency``
(rtx_frag.glsl:237-270). Branching does not map to SIMD lanes, so we use
**single-path stochastic selection**: choose refraction with probability
``transparency`` and keep the branch weight implicit. The expectation is
identical — E[child] = (1-t)*reflect + t*refract — so the estimator is
unbiased w.r.t. the reference, and for the common t in {0, 1} materials it
is *exactly* the reference path. A ratio reparameterization keeps the
estimator differentiable in ``transparency`` itself.

Per-bounce semantics follow rtx_frag.glsl (the semantic spec per SURVEY.md
SS7): emission then albedo (rtx_frag.glsl:226-230), roughness-perturbed
normal (233-234), per-material IOR with entering/exit flip (249-259), TIR
rays dropped (260-262), 1e-4 origin offsets (239, 263), sky on miss *and*
on bounce exhaustion (212-221), MAX_BOUNCES+1 total trace rounds.

RNG discipline: exactly 3 PCG draws per ray per bounce (2 for the unit
sphere, 1 for branch selection), drawn unconditionally so every lane stays
in lockstep — this fixed schedule is what lets the Pallas kernel and the
scalar test reference reproduce the stream bit-for-bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import rng as _rng
from ..ops.camera import Camera, pixel_indices, primary_rays
from ..ops.intersect import trace
from ..ops.sampling import perturb_normal, reflect, refract
from ..scene.scene import Scene

__all__ = [
    "trace_paths",
    "render_tile",
    "render_radiance",
    "render_bounce_stats",
    "render_image_u8",
    "DEFAULT_EPS_OFFSET",
]

DEFAULT_EPS_OFFSET = 1e-4  # rtx_frag.glsl:239,263
EPS_OFFSET_SCALE = 4e-6  # extra offset per unit |hit point| (f32 round-off)


def pvary_missing(tree, axes):
    """Promote every leaf to varying over exactly ``axes`` (shard_map VMA).

    Leaves may already vary over a subset (e.g. camera-ray origins carry
    {tile} from ``row_start = axis_index``); ``pvary`` rejects re-adding
    an axis, so promote only each leaf's complement."""

    if hasattr(jax.lax, "pcast"):  # jax.lax.pvary deprecated in favor of pcast
        _pvary = lambda x, need: jax.lax.pcast(x, need, to="varying")
    else:  # pragma: no cover - older JAX
        _pvary = jax.lax.pvary

    def one(x):
        have = getattr(jax.typeof(x), "vma", frozenset()) or frozenset()
        need = tuple(a for a in axes if a not in have)
        return _pvary(x, need) if need else x

    return jax.tree_util.tree_map(one, tree)


def trace_paths(
    scene: Scene, origins, directions, state, max_bounces: int,
    variant: str = "gpu",
    remat: bool = False,
    collect_stats: bool = False,
    vma_axes: tuple = (),
):
    """Estimate incident radiance for a wavefront of rays.

    Args:
      scene: SoA scene pytree.
      origins, directions: (N, 3) primary rays (directions unit).
      state: (N,) uint32 counter-based RNG state (one stream per ray).
      max_bounces: static bounce cap; ``max_bounces + 1`` trace rounds run,
        matching the stack semantics of rtx_frag.glsl:212-214.
      variant: "gpu" (default — rtx_frag.glsl semantics) or "cpu", which
        reproduces the compiled-out CPU backend's deltas (SURVEY.md SS3.3):
        biased cube sphere sampling (src/renderer.c:11-19), normal
        deviation scaled roughness*0.5 (src/renderer.c:40), hard-coded IOR
        1.5 ignoring the material (src/renderer.c:58), and a final [0,1]
        clamp per sample (src/renderer.c:88). The CPU backend's two-branch
        recursion tree is estimated by the same single-path selection
        (identical expectation; exact for transparency in {0, 1}).

    Returns:
      (radiance (N, 3), final RNG state); with ``collect_stats=True`` also
      a dict of per-bounce (max_bounces+1,) int32 event counts — the
      bounce-histogram observability the reference lacks entirely
      (SURVEY.md SS5 "Metrics"): ``hits`` (rays shaded), ``misses`` (sky
      exits), ``tir_deaths`` (refract rays dropped to total internal
      reflection, rtx_frag.glsl:261-262).
    """
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"unknown variant {variant!r}")
    cpu_tier = variant == "cpu"
    n = origins.shape[0]
    sky = scene.sky_color[None, :]
    mats = scene.materials
    sg = jax.lax.stop_gradient

    def step(carry, _):
        o, d, thr, total, alive, st = carry
        hit = trace(o, d, scene)

        live = alive[:, None]
        miss_now = alive & ~hit.mask
        total = total + jnp.where(miss_now[:, None], thr * sky, 0.0)
        alive = alive & hit.mask
        hit_now = alive
        live = alive[:, None]

        m = hit.material
        albedo = mats.albedo[m]
        emission = mats.emission_color[m] * mats.emission_strength[m][:, None]
        rough = mats.roughness[m]
        transp = mats.transparency[m]
        ior = mats.refractive_index[m]
        if cpu_tier:
            rough = rough * 0.5  # src/renderer.c:40
            ior = jnp.full_like(ior, 1.5)  # src/renderer.c:58

        # Le then albedo, in the reference's order (rtx_frag.glsl:226-230).
        total = total + jnp.where(live, thr * emission, 0.0)
        thr = jnp.where(live, thr * albedo, thr)

        # Fixed draw schedule: unit sphere (2 draws gpu / 3 cpu-biased)
        # + branch uniform (1), drawn unconditionally for lane lockstep.
        if cpu_tier:
            st, sph = _rng.unit_sphere_biased(st)
        else:
            st, sph = _rng.unit_sphere(st)
        st, u_branch = _rng.uniform(st)

        nrm = perturb_normal(hit.normal, sph, rough)
        refl_dir = reflect(d, nrm)

        ndot = jnp.sum(d * nrm, axis=-1, keepdims=True)
        entering = ndot < 0.0
        eta = jnp.where(entering[..., 0], 1.0 / ior, ior)[:, None]
        refr_normal = jnp.where(entering, nrm, -nrm)
        refr_dir, tir = refract(d, refr_normal, eta)

        choose_refr = u_branch < sg(transp)
        # Ratio reparameterization: equals 1 in value but carries the
        # d/d(transparency) of the reference's (1-t)/t branch weights.
        ratio = jnp.where(
            choose_refr,
            transp / jnp.maximum(sg(transp), 1e-6),
            (1.0 - transp) / jnp.maximum(sg(1.0 - transp), 1e-6),
        )
        thr = jnp.where(live, thr * ratio[:, None], thr)

        new_d = jnp.where(choose_refr[:, None], refr_dir, refl_dir)
        died = choose_refr & tir  # TIR refract rays are dropped (glsl:261-262)
        alive = alive & ~died
        live = alive[:, None]
        new_d = jnp.where(died[:, None], d, new_d)
        # Self-intersection offset. The reference uses a fixed 1e-4 step
        # along the new direction (rtx_frag.glsl:239,263); in f32 that is
        # smaller than the intersection round-off for large/distant
        # geometry, so we instead step along the *geometric normal* (signed
        # toward the side the ray departs on) with a magnitude that scales
        # with the hit point's float spacing.
        p = hit.point
        # max() guard keeps reverse-mode finite on miss lanes (p == 0 at
        # the camera origin); primal bit-identical (see models/physical.py).
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * jnp.sqrt(
            jnp.maximum(jnp.sum(p * p, axis=-1, keepdims=True), 1e-20)
        )
        side = jnp.where(
            jnp.sum(new_d * hit.normal, axis=-1, keepdims=True) >= 0.0, 1.0, -1.0
        )
        new_o = p + offs * side * hit.normal
        o = jnp.where(live, new_o, o)
        d = jnp.where(live, new_d, d)
        stats = None
        if collect_stats:
            stats = {
                "hits": jnp.sum(hit_now.astype(jnp.int32)),
                "misses": jnp.sum(miss_now.astype(jnp.int32)),
                "tir_deaths": jnp.sum((hit_now & died).astype(jnp.int32)),
            }
        return (o, d, thr, total, alive, st), stats

    total = jnp.zeros_like(origins)
    thr = jnp.ones_like(origins)
    alive = jnp.ones((n,), dtype=bool)
    carry = (origins, directions, thr, total, alive, state)
    if vma_axes:
        # Under shard_map with the varying-axis checker ON, the scan's
        # carry must enter with the VMA it will have after one step (the
        # constant inits are mesh-invariant; the step mixes in varying
        # scene/seed data). Explicit pvary keeps check_vma=True usable in
        # parallel/render.py instead of disabling the checker wholesale.
        carry = pvary_missing(carry, vma_axes)
    # remat: recompute each bounce in the backward pass, storing only the
    # O(N) carries — without it reverse-mode keeps every bounce's (N, S+T)
    # intersection intermediates alive and OOMs at production resolutions.
    step_fn = jax.checkpoint(step) if remat else step
    carry, stats = jax.lax.scan(step_fn, carry, None, length=max_bounces + 1)
    o, d, thr, total, alive, st = carry
    # Bounce budget exhausted -> sky, like stack items popped with
    # bounces > MAX_BOUNCES (rtx_frag.glsl:212-214).
    total = total + jnp.where(alive[:, None], thr * sky, 0.0)
    if cpu_tier:
        total = jnp.clip(total, 0.0, 1.0)  # per-sample clamp, renderer.c:88
    if collect_stats:
        return total, st, stats
    return total, st


def render_tile(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    jitter: bool = False,
    remat: bool = False,
    sample_offset=0,
    row_start=0,
    rows: int | None = None,
    variant: str = "gpu",
    vma_axes: tuple = (),
):
    """Monte-Carlo radiance for a row block: (rows, W, 3) f32 mean over spp.

    Samples run as an outer ``lax.scan`` (memory O(rows*W), any spp), each
    sample a full wavefront over the block's pixels — the replacement
    for the per-pixel sample loops at rtx_frag.glsl:288-292 /
    src/renderer.c:104-108. The row block is the unit of image sharding
    (``row_start`` may be a traced ``axis_index``); RNG streams key on
    *global* pixel and sample indices, so any sharding produces bit-
    identical images. ``sample_offset`` shifts the global sample indices —
    how spp splits across devices and how checkpoint/resume continues a
    render without replaying samples.

    ``remat`` wraps each sample in ``jax.checkpoint`` so reverse-mode AD
    recomputes the bounce loop instead of storing per-bounce residuals
    (HBM-bound backward; SURVEY.md SS5 memory note).
    """
    rows = height if rows is None else rows
    pix = pixel_indices(height, width, row_start, rows)
    rays = primary_rays(camera, height, width, row_start=row_start, rows=rows)

    def one_sample(sample_idx):
        st = _rng.seed_state(pix, sample_idx, seed)
        if jitter:
            o, d, st = primary_rays(
                camera, height, width, st, row_start=row_start, rows=rows
            )
        else:
            o, d = rays
        radiance, _ = trace_paths(
            scene, o, d, st, max_bounces, variant=variant, remat=remat,
            vma_axes=vma_axes,
        )
        return radiance

    if remat:
        one_sample = jax.checkpoint(one_sample)

    def body(accum, sample_idx):
        return accum + one_sample(sample_idx), None

    init = jnp.zeros((rows * width, 3), jnp.float32)
    if vma_axes:  # see trace_paths: sample-scan carry VMA under shard_map
        init = pvary_missing(init, vma_axes)
    sample_ids = jnp.arange(spp, dtype=jnp.int32) + jnp.int32(sample_offset)
    accum, _ = jax.lax.scan(body, init, sample_ids)
    return (accum / spp).reshape(rows, width, 3)


def render_radiance(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    jitter: bool = False,
    remat: bool = False,
    sample_offset=0,
    variant: str = "gpu",
):
    """Full-image radiance, (H, W, 3) f32 — :func:`render_tile` over all rows."""
    return render_tile(
        scene,
        camera,
        height,
        width,
        spp,
        max_bounces,
        seed,
        jitter=jitter,
        remat=remat,
        sample_offset=sample_offset,
        variant=variant,
    )


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def render_bounce_stats(scene, camera, height, width, spp, max_bounces, seed):
    """Per-bounce event histogram over a full render.

    Returns a dict of (max_bounces + 1,) int32 arrays summed over all
    pixels and samples: ``hits``, ``misses``, ``tir_deaths`` — the
    structured observability SURVEY.md SS5 mandates (the reference's only
    runtime signal is a commented-out frame-time printf, src/main.c:253-258).
    Event counts are exact for the Pallas engine too: both engines run the
    same estimator on the same RNG streams, so their discrete decisions
    coincide (tested to f32 tolerance).
    """
    pix = pixel_indices(height, width, 0, height)
    o, d = primary_rays(camera, height, width)

    def body(acc, sample_idx):
        st = _rng.seed_state(pix, sample_idx, seed)
        _, _, stats = trace_paths(scene, o, d, st, max_bounces,
                                  collect_stats=True)
        return jax.tree_util.tree_map(jnp.add, acc, stats), None

    zeros = {
        k: jnp.zeros((max_bounces + 1,), jnp.int32)
        for k in ("hits", "misses", "tir_deaths")
    }
    acc, _ = jax.lax.scan(body, zeros, jnp.arange(spp, dtype=jnp.int32))
    return acc


def render_image_u8(radiance):
    """Radiance -> RGB8 exactly like the reference's output stage.

    GL writes the fragment color into an RGB8 texture with unsigned-
    normalized rounding (clamp then round; src/main.c:297-307, the CPU path
    clamps at src/renderer.c:88 and scales by 255 at src/renderer.c:108).
    """
    return jnp.round(jnp.clip(radiance, 0.0, 1.0) * 255.0).astype(jnp.uint8)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 7))
def render_jit(scene, camera, height, width, spp, max_bounces, seed, jitter=False):
    """jit-compiled convenience wrapper around :func:`render_radiance`."""
    return render_radiance(
        scene, camera, height, width, spp, max_bounces, seed, jitter=jitter
    )
