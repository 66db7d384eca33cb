"""Physically-based shading mode: importance-sampled BRDF + NEE.

An *extension* beyond the reference's stylized shading (the reference has
no BRDF normalization, cosine terms or light sampling — rtx_frag.glsl:
226-246 multiplies albedo and perturbs a mirror direction). This mode is
the "importance-sampled BRDF" tier of BASELINE config 3 and, crucially,
gives the estimator **continuous geometry dependence** — cosine and
solid-angle factors — so sphere-light position/radius gradients become
nonzero and finite-difference-matchable (the reference shading model's
interior geometry gradient is exactly zero; see grad/diff.py).

Material interpretation (same scene schema as the reference tier):

* albedo   -> Lambert reflectance (f = albedo / pi); specular tint
* roughness-> mixture weight: diffuse with probability ``roughness``,
  mirror-specular with probability ``1 - roughness``
* transparency / refractive_index -> perfect refraction branch, as in the
  reference tier
* emission -> Le

Estimator:

* BSDF sampling: cosine-weighted hemisphere for the diffuse lobe (the
  cos/pdf factor cancels to exactly ``albedo``), mirror direction for the
  specular lobe.
* Next-event estimation: at every diffuse vertex, sample one emissive
  *sphere* by solid-angle cone sampling, cast a shadow ray, and add
  ``thr * (albedo/pi) * Le * cos(theta) * n_emitters / pdf_omega``.
  Radiance an emitter would contribute through a *diffuse-sampled* ray is
  then skipped at the next vertex (single-counting); specular/refract
  chains and camera rays still collect Le directly. Emissive triangles
  keep direct accumulation by default (unbiased); ``tri_nee=True``
  (opt-in; core path AND the Pallas physical kernels) adds them to the
  light-sampling pool by uniform area sampling — measured 302x
  per-pixel variance reduction on a triangle-lit room
  (tests/test_physical.py; Pallas parity in
  tests/test_pallas_physical.py).

RNG: fixed 7-draw schedule per bounce (u_transp, u_lobe, 2 BSDF, 1 pick,
2 cone), all lanes in lockstep.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import rng as _rng
from ..ops.camera import Camera, pixel_indices, primary_rays
from ..ops.intersect import ray_sphere_t, trace
from ..ops.sampling import reflect, refract
from ..scene.scene import Scene
from .integrator import DEFAULT_EPS_OFFSET, EPS_OFFSET_SCALE

__all__ = [
    "trace_paths_physical", "render_physical",
    "render_bounce_stats_physical",
]

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def _onb(n):
    """Branchless orthonormal basis around unit n (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bv = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bv


def _cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about n; pdf = cos(theta)/pi.

    Uses the shared polynomial sincos spec (ops/rng.sincos_2pi) like
    every sampler in every tier."""
    r = jnp.sqrt(u1)
    c, s = _rng.sincos_2pi(u2)
    lx = r * c
    ly = r * s
    lz = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    t, b = _onb(n)
    return lx[..., None] * t + ly[..., None] * b + lz[..., None] * n


def trace_paths_physical(
    scene: Scene,
    origins,
    directions,
    state,
    max_bounces: int,
    nee: bool = True,
    collect_stats: bool = False,
    vma_axes: tuple = (),
    rough_grad: bool = False,
    tri_nee: bool = False,
):
    """Physical-mode radiance estimate for a wavefront; see module doc.

    ``tri_nee=True`` (opt-in) adds emissive TRIANGLES to
    the light-sampling pool: the emitter pick becomes uniform over
    sphere + triangle emitters, triangles are sampled uniformly by area
    (the same v1/v2 draws the sphere cone uses — the 7-draw schedule is
    unchanged), with the area pdf converted to solid angle
    (``pdf_w = dist^2 / (area * |cos_l|)``; two-sided emission), and
    their direct Le is single-counted on diffuse arrivals like sphere
    emitters. Off by default: the default estimator (and every Pallas
    kernel) keeps direct accumulation for emissive triangles, which is
    also unbiased — tri_nee only reduces variance for triangle-lit
    scenes (tests/test_physical.py pins both the matching means and the
    variance reduction).

    ``collect_stats=True`` additionally returns a dict of per-bounce
    (max_bounces + 1,) int32 event counts — ``hits``, ``misses``,
    ``tir_deaths`` (parity with the reference tier's
    ``render_bounce_stats``) plus the NEE-specific ``nee_candidates``
    (diffuse vertices that attempted a light sample) and ``nee_visible``
    (shadow rays that reached the emitter) — the observability the NEE
    estimator needs (visibility ratios explain its variance)."""
    n = origins.shape[0]
    sky = scene.sky_color[None, :]
    mats = scene.materials
    sg = jax.lax.stop_gradient

    # Emissive-sphere table for NEE (static shapes; counts are traced).
    sph = scene.spheres
    em_mask = sph.active & (mats.emission_strength[sph.material] > 0.0)
    n_em = jnp.sum(em_mask.astype(jnp.int32))
    em_cum = jnp.cumsum(em_mask.astype(jnp.int32))
    tri = scene.triangles
    if tri_nee:
        tri_em_mask = tri.active & (
            mats.emission_strength[tri.material] > 0.0
        )
        n_em_t = jnp.sum(tri_em_mask.astype(jnp.int32))
        tri_cum = jnp.cumsum(tri_em_mask.astype(jnp.int32))
        # precomputed per-triangle geometric normals and areas
        tri_e1 = tri.v1 - tri.v0
        tri_e2 = tri.v2 - tri.v0
        tri_cross = jnp.cross(tri_e1, tri_e2)
        tri_2area = jnp.sqrt(
            jnp.maximum(jnp.sum(tri_cross * tri_cross, -1), 1e-20)
        )
        tri_nrm = tri_cross / tri_2area[:, None]
        tri_area = 0.5 * tri_2area
    else:
        n_em_t = jnp.int32(0)
    if scene.num_triangles == 0:
        tri_nee = False  # nothing to sample; keep the default graph
    n_tot = n_em + n_em_t

    def step(carry, _):
        o, d, thr, total, alive, prev_diff, st = carry
        alive_in = alive
        hit = trace(o, d, scene)

        miss_now = alive & ~hit.mask
        total = total + jnp.where(miss_now[:, None], thr * sky, 0.0)
        alive = alive & hit.mask
        live = alive[:, None]

        m = hit.material
        albedo = mats.albedo[m]
        emission = mats.emission_color[m] * mats.emission_strength[m][:, None]
        rough = mats.roughness[m]
        transp = mats.transparency[m]
        ior = mats.refractive_index[m]

        # Le, skipped when the vertex was reached by a diffuse-sampled ray
        # and this emitter was light-sampleable (sphere emitter, NEE on).
        nee_counted = (
            prev_diff
            & hit.is_sphere
            & (mats.emission_strength[m] > 0.0)
            & (n_em > 0)
        ) if nee else jnp.zeros_like(prev_diff)
        if nee and tri_nee:
            # emissive triangles are light-sampleable too: single-count
            # their Le on diffuse arrivals, same rule as sphere emitters
            nee_counted = nee_counted | (
                prev_diff
                & hit.mask
                & ~hit.is_sphere
                & (mats.emission_strength[m] > 0.0)
                & (n_em_t > 0)
            )
        add_le = alive & ~nee_counted
        total = total + jnp.where(add_le[:, None], thr * emission, 0.0)

        # Fixed 7-draw schedule.
        st, u_transp = _rng.uniform(st)
        st, u_lobe = _rng.uniform(st)
        st, u1 = _rng.uniform(st)
        st, u2 = _rng.uniform(st)
        st, u_pick = _rng.uniform(st)
        st, v1 = _rng.uniform(st)
        st, v2 = _rng.uniform(st)

        nrm = hit.normal  # geometric normal (already opposes the ray)

        # -- branch selection --
        choose_refr = u_transp < sg(transp)
        choose_diff = (~choose_refr) & (u_lobe < sg(rough))
        ratio = jnp.where(
            choose_refr,
            transp / jnp.maximum(sg(transp), 1e-6),
            (1.0 - transp) / jnp.maximum(sg(1.0 - transp), 1e-6),
        )
        thr = jnp.where(live, thr * ratio[:, None], thr)

        if rough_grad:
            # Score-function (REINFORCE) estimator for d/d(roughness)
            #: the lobe mixture samples
            # diffuse with probability ``rough``, so multiplying the
            # throughput by ``p_chosen / stop_grad(p_chosen)`` leaves the
            # primal EXACTLY 1 (x/x) while its tangent carries
            # d(log p)/d(rough) * path_contribution — an unbiased
            # estimate of the expectation gradient (same reparameterized
            # -ratio trick the transparency branch uses above). Pathwise
            # FD cannot see it (fixed-seed primals are rough-independent
            # away from threshold flips); validate against FD of the
            # high-spp MC *expectation* (tests/test_physical.py). Higher
            # variance than the smooth material gradients — opt in for
            # roughness fits only.
            lobe_ratio = jnp.where(
                choose_diff,
                rough / jnp.maximum(sg(rough), 1e-6),
                (1.0 - rough) / jnp.maximum(sg(1.0 - rough), 1e-6),
            )
            lobe_ratio = jnp.where(choose_refr, 1.0, lobe_ratio)
            thr = jnp.where(live, thr * lobe_ratio[:, None], thr)

        # refract (reference-tier physics)
        ndot = jnp.sum(d * nrm, axis=-1, keepdims=True)
        entering = ndot < 0.0
        eta = jnp.where(entering[..., 0], 1.0 / ior, ior)[:, None]
        refr_normal = jnp.where(entering, nrm, -nrm)
        refr_dir, tir = refract(d, refr_normal, eta)
        # specular mirror
        spec_dir = reflect(d, nrm)
        # cosine-weighted diffuse
        diff_dir = _cosine_hemisphere(nrm, u1, u2)

        new_d = jnp.where(
            choose_refr[:, None],
            refr_dir,
            jnp.where(choose_diff[:, None], diff_dir, spec_dir),
        )
        died = choose_refr & tir
        alive = alive & ~died
        live = alive[:, None]
        new_d = jnp.where(died[:, None], d, new_d)

        # -- NEE at diffuse vertices --
        p = hit.point
        # max() guard: miss lanes have p == camera origin == 0, and
        # d(sqrt)/dp at 0 is NaN in reverse mode (poisons geometry
        # gradients through the masked branch). Primal is bit-identical:
        # the 1e-10 floor adds 4e-16 to a 1e-4 offset, below f32 ulp.
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * jnp.sqrt(
            jnp.maximum(jnp.sum(p * p, axis=-1, keepdims=True), 1e-20)
        )
        shadow_o = p + offs * nrm

        if nee:
            # pick the k-th emitter (uniform over the pool: spheres,
            # then — with tri_nee — triangles)
            pool = n_tot if tri_nee else n_em
            k = jnp.clip(
                jnp.floor(u_pick * pool).astype(jnp.int32), 0, jnp.maximum(pool - 1, 0)
            )
            e_idx = jnp.searchsorted(em_cum, k + 1, side="left")
            e_idx = jnp.clip(e_idx, 0, scene.num_spheres - 1)
            c_e = sph.center[e_idx]  # (N,3)
            r_e = sph.radius[e_idx]
            m_e = sph.material[e_idx]
            le_e = (
                mats.emission_color[m_e]
                * mats.emission_strength[m_e][:, None]
            )

            dc = c_e - shadow_o
            d2 = jnp.sum(dc * dc, axis=-1)
            dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
            wz = dc / dist[:, None]
            # sin2max capped strictly below 1: at exactly 1 the sqrt's
            # gradient is infinite, and lanes inside/touching the emitter
            # (masked by ``outside`` in the primal) would still poison
            # reverse-mode geometry gradients through the untaken branch.
            sin2max = jnp.clip(
                r_e * r_e / jnp.maximum(d2, 1e-12), 0.0, 1.0 - 1e-7
            )
            cosmax = jnp.sqrt(1.0 - sin2max)
            outside = d2 > r_e * r_e
            # sample cos(theta) uniform in [cosmax, 1] (cone solid angle);
            # the 1e-12 floor keeps d(sth)/d(cth) finite at cth -> 1.
            cth = 1.0 - v1 * (1.0 - cosmax)
            sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 1e-12))
            cphi, sphi = _rng.sincos_2pi(v2)  # shared polynomial trig spec
            t_ax, b_ax = _onb(wz)
            omega = (
                (sth * cphi)[:, None] * t_ax
                + (sth * sphi)[:, None] * b_ax
                + cth[:, None] * wz
            )
            pdf_omega = 1.0 / jnp.maximum(_TWO_PI * (1.0 - cosmax), 1e-8)
            cos_surf = jnp.sum(nrm * omega, axis=-1)

            # expected hit distance on the sampled emitter (analytic)
            t_e = ray_sphere_t(
                shadow_o, omega, sph.center, sph.radius, sph.active
            )[jnp.arange(n), e_idx]

            if tri_nee:
                # triangle-emitter candidate from the SAME v1/v2 draws:
                # uniform-by-area barycentric sample, area pdf converted
                # to solid angle (w = cos_surf * area * |cos_l| / d^2),
                # two-sided emission.
                kt = jnp.clip(k - n_em, 0, jnp.maximum(n_em_t - 1, 0))
                t_idx = jnp.clip(
                    jnp.searchsorted(tri_cum, kt + 1, side="left"),
                    0, scene.num_triangles - 1,
                )
                is_tri = (k >= n_em) & (n_em_t > 0)
                su = jnp.sqrt(v1)
                b1 = su * (1.0 - v2)
                b2 = su * v2
                b0 = 1.0 - su
                q = (
                    b0[:, None] * tri.v0[t_idx]
                    + b1[:, None] * tri.v1[t_idx]
                    + b2[:, None] * tri.v2[t_idx]
                )
                dq = q - shadow_o
                d2t = jnp.sum(dq * dq, axis=-1)
                dist_t = jnp.sqrt(jnp.maximum(d2t, 1e-12))
                omega_t = dq / dist_t[:, None]
                cos_l = jnp.abs(jnp.sum(tri_nrm[t_idx] * omega_t, axis=-1))
                w_tri_geom = tri_area[t_idx] * cos_l / jnp.maximum(
                    d2t, 1e-12
                )
                m_t = tri.material[t_idx]
                le_t = (
                    mats.emission_color[m_t]
                    * mats.emission_strength[m_t][:, None]
                )
                itc = is_tri[:, None]
                omega = jnp.where(itc, omega_t, omega)
                cos_surf = jnp.where(
                    is_tri, jnp.sum(nrm * omega_t, axis=-1), cos_surf
                )
                t_e = jnp.where(is_tri, dist_t, t_e)
                le_e = jnp.where(itc, le_t, le_e)
                pool_ok = n_tot > 0
                branch_ok = jnp.where(is_tri, cos_l > 1e-6, outside)
                weight = (
                    jnp.where(
                        is_tri, cos_surf * w_tri_geom,
                        cos_surf / pdf_omega,
                    )
                    * n_tot.astype(jnp.float32)
                )
            else:
                pool_ok = n_em > 0
                branch_ok = outside
                weight = cos_surf / pdf_omega * n_em.astype(jnp.float32)

            # occlusion: the closest scene hit must be the emitter itself
            s_hit = trace(shadow_o, omega, scene)
            visible = (
                s_hit.mask
                & (s_hit.t >= t_e * (1.0 - 1e-3) - 1e-4)
                & jnp.isfinite(t_e)
            )
            valid = (
                alive
                & choose_diff
                & pool_ok
                & branch_ok
                & (cos_surf > 0.0)
                & visible
            )
            contrib = thr * (albedo / _PI) * le_e * weight[:, None]
            total = total + jnp.where(valid[:, None], contrib, 0.0)

        # continuing throughput: cos/pdf cancels for the diffuse lobe, the
        # specular/refract lobes tint by albedo like the reference tier.
        thr = jnp.where(live, thr * albedo, thr)

        side = jnp.where(
            jnp.sum(new_d * nrm, axis=-1, keepdims=True) >= 0.0, 1.0, -1.0
        )
        new_o = p + offs * side * nrm
        o = jnp.where(live, new_o, o)
        d = jnp.where(live, new_d, d)
        prev_diff = jnp.where(alive, choose_diff, prev_diff) if nee else prev_diff
        stats = None
        if collect_stats:
            cnt = lambda m: jnp.sum(m.astype(jnp.int32))
            stats = {
                "hits": cnt(alive_in & hit.mask),
                "misses": cnt(miss_now),
                "tir_deaths": cnt(died),
            }
            if nee:
                cand = (
                    alive & choose_diff & pool_ok & branch_ok
                    & (cos_surf > 0.0)
                )
                stats["nee_candidates"] = cnt(cand)
                stats["nee_visible"] = cnt(cand & visible)
        return (o, d, thr, total, alive, prev_diff, st), stats

    total = jnp.zeros_like(origins)
    thr = jnp.ones_like(origins)
    alive = jnp.ones((n,), dtype=bool)
    prev_diff = jnp.zeros((n,), dtype=bool)
    carry = (origins, directions, thr, total, alive, prev_diff, state)
    if vma_axes:  # scan-carry VMA under shard_map — see trace_paths
        from .integrator import pvary_missing

        carry = pvary_missing(carry, vma_axes)
    carry, stats = jax.lax.scan(step, carry, None, length=max_bounces + 1)
    o, d, thr, total, alive, prev_diff, st = carry
    total = total + jnp.where(alive[:, None], thr * sky, 0.0)
    if collect_stats:
        return total, st, stats
    return total, st


def render_physical(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    nee: bool = True,
    jitter: bool = True,
    remat: bool = False,
    sample_offset=0,
    row_start=0,
    rows: int | None = None,
    vma_axes: tuple = (),
    rough_grad: bool = False,
    tri_nee: bool = False,
):
    """Physical-mode radiance image (rows, W, 3); anti-aliasing jitter on
    by default (unlike the reference tier, which shoots identical primary
    rays for parity). ``row_start``/``rows`` select a row block with
    global-index RNG — the unit of image sharding (parallel/render.py),
    same contract as ``render_tile``. ``rough_grad=True`` enables the
    score-function roughness gradient (bit-identical primal, see
    trace_paths_physical)."""
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
        radiance, _ = trace_paths_physical(
            scene, o, d, st, max_bounces, nee=nee, vma_axes=vma_axes,
            rough_grad=rough_grad, tri_nee=tri_nee,
        )
        return radiance

    if remat:
        one_sample = jax.checkpoint(one_sample)

    def body(accum, sample_idx):
        return accum + one_sample(sample_idx), None

    init = jnp.zeros((rows * width, 3), jnp.float32)
    if vma_axes:  # see trace_paths_physical
        from .integrator import pvary_missing

        init = pvary_missing(init, vma_axes)
    sample_ids = jnp.arange(spp, dtype=jnp.int32) + jnp.int32(sample_offset)
    accum, _ = jax.lax.scan(body, init, sample_ids)
    return (accum / spp).reshape(rows, width, 3)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 7, 8))
def render_bounce_stats_physical(
    scene, camera, height, width, spp, max_bounces, seed,
    nee: bool = True, jitter: bool = False,
):
    """Physical-tier per-bounce event histogram over a full render:
    the reference-tier counts plus NEE shadow-ray visibility (the number
    that explains NEE variance). Same (max_bounces + 1,) int32 layout as
    ``models.integrator.render_bounce_stats``."""
    pix = pixel_indices(height, width, 0, height)
    rays = primary_rays(camera, height, width)

    def body(acc, sample_idx):
        st = _rng.seed_state(pix, sample_idx, seed)
        if jitter:
            o, d, st = primary_rays(camera, height, width, st)
        else:
            o, d = rays
        _, _, stats = trace_paths_physical(
            scene, o, d, st, max_bounces, nee=nee, collect_stats=True
        )
        return jax.tree_util.tree_map(jnp.add, acc, stats), None

    keys = ["hits", "misses", "tir_deaths"]
    if nee:
        keys += ["nee_candidates", "nee_visible"]
    zeros = {k: jnp.zeros((max_bounces + 1,), jnp.int32) for k in keys}
    acc, _ = jax.lax.scan(body, zeros, jnp.arange(spp, dtype=jnp.int32))
    return acc
