"""Pallas (Triton) megakernels for the physical shading tier (BRDF + NEE).

The fast path for BASELINE config 3's "importance-sampled BRDF": the same
estimator as ``models/physical.py`` (cosine-weighted diffuse lobe, mirror
specular, reference-tier refraction, next-event estimation against
emissive spheres by solid-angle cone sampling) run as a register-resident
per-pixel kernel, one Triton program per pixel tile — the physical tier's
analog of the reference-tier megakernel in ``pallas_kernels.py`` (which
reproduces ``/root/reference/shaders/rtx_frag.glsl:194-274``; the physical
tier is the capability *extension* SURVEY.md §7 assigns to config 3).

Per bounce the kernel runs TWO intersection queries: the path's closest
hit (shared ``make_geometry`` code — the invariant that the fused
kernel's replay and every tier intersect identically) and a distance-only shadow
query for NEE visibility. RNG is the physical tier's fixed 7-draw
schedule (u_transp, u_lobe, 2 BSDF, 1 emitter pick, 2 cone draws) on the
same PCG streams as the core path, so interpreter-mode renders match
``render_physical`` to f32 rounding.

**Backward** (``render_physical_pallas_fused``): per sample the radiance is

    total[c] = sum_b P_b[c]*E_b[c]*addle_b
             + sum_b P_b[c]*(albedo_b[c]/pi)*le_b[c]*w_b*valid_b
             + P_end[c]*sky[c]

with ``P_b`` the albedo prefix product, ``E_b`` the hit emission,
``w_b = cos_surf/pdf * n_pool`` the NEE geometry weight. All *material*
dependence (albedo, emission, transparency via the ratio
reparameterization, sky) is a prefix/suffix product structure, AND the
NEE emitter-geometry dependence — the sampled SPHERE emitter's
center/radius through the cone chain, and (``tri_nee``) the sampled
TRIANGLE emitter's vertices through the area/cos/d² chain — is purely
per-bounce-local, so the production VJP is ONE fused kernel
(``render_physical_pallas_fused``) that emits the primal, the
material/sky Jacobian planes (suffix sweep) and the emitter-geometry
Jacobian planes (in-bounce, prefix-only; 12 per sphere ordinal up to
``n_em_cap``, 27 per tri ordinal up to ``tri_em_cap``) — the backward
collapses to an XLA contraction. **Geometry contract**: cotangents
carry only the NEE emitter chain; continuation terms (hit points and
normals of struck surfaces — full-path AD quantities with no local
structure) and non-emitter geometry are zero, as are camera cotangents
— those fits belong to the core path
(``models/physical.render_physical`` under ``jax.grad``). Material and
sky cotangents match core AD (tests/test_pallas_physical.py).

The emissive-sphere table (cumulative emitter count + per-sphere
premultiplied radiance) is built from the scene outside the kernel and
read by it with scalar loads — the physical tier's extension of the uniform-upload
analog (pallas_kernels._scene_operands).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .. import backend
from ..scene.scene import Scene
from ..ops.camera import Camera
from ..models.integrator import DEFAULT_EPS_OFFSET, EPS_OFFSET_SCALE
from . import pallas_kernels as fk

__all__ = [
    "render_physical_pallas",
    "render_physical_pallas_fused",
    "contract_physical_jacobian",
    "render_physical_pallas_vjp",
]

_INV_PI = np.float32(1.0 / math.pi)
_TWO_PI = np.float32(2.0 * math.pi)

# Pixel tiles: the forward kernel's and the fused kernel's, each the best
# of a tile sweep on the H100 (PERF.md).
PHYS_TILE = (8, 32)
PHYS_FUSED_TILE = (4, 32)
# Planes of one round record: P[3], 4 masks, albedo[3], E[3], nee[3],
# EmW[3], dr, the rough_grad lobe derivative, material, emitter material.
_RECORD_PLANES = 23


def _cone_w_chain(cx, cy, cz, rr, sox, soy, soz, nxp, nyp, nzp, v1p,
                  cphi, sphi, n_em_f):
    """The NEE cone-weight chain ``w = cos_surf / pdf * n_em`` as a pure
    function of the sampled emitter's center/radius — value-identical to
    ``make_physical_shading``'s NEE block (including every clip/floor
    guard, so a ``jax.vjp`` through it matches core AD). The fused
    kernel's in-bounce geometry Jacobian is its transpose."""
    dcx_ = cx - sox
    dcy_ = cy - soy
    dcz_ = cz - soz
    d2 = dcx_ * dcx_ + dcy_ * dcy_ + dcz_ * dcz_
    dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
    wzx = dcx_ / dist
    wzy = dcy_ / dist
    wzz = dcz_ / dist
    sin2max = jnp.clip(rr * rr / jnp.maximum(d2, 1e-12), 0.0, 1.0 - 1e-7)
    cosmax = jnp.sqrt(1.0 - sin2max)
    cth = 1.0 - v1p * (1.0 - cosmax)
    sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 1e-12))
    (tax, tay, taz), (bax, bay, baz) = _onb(wzx, wzy, wzz)
    omx = sth * cphi * tax + sth * sphi * bax + cth * wzx
    omy = sth * cphi * tay + sth * sphi * bay + cth * wzy
    omz = sth * cphi * taz + sth * sphi * baz + cth * wzz
    cos_surf = nxp * omx + nyp * omy + nzp * omz
    return cos_surf * jnp.maximum(_TWO_PI * (1.0 - cosmax), 1e-8) * n_em_f


def _tri_w_chain(ax, ay, az, bx, by, bz, cx, cy, cz,
                 sox, soy, soz, nxp, nyp, nzp, v1p, v2p, n_tot_f):
    """The tri-NEE weight chain ``w = cos_surf * area*|cos_l|/d^2 * n_tot``
    as a pure function of the sampled TRIANGLE emitter's nine vertex
    components — value-identical to ``models/physical.py``'s tri_nee
    branch (same barycentric draws, sqrt/clip guards, and normal/area
    formulas ``cr = (v1-v0)x(v2-v0)``, ``2A = sqrt(max(|cr|^2,1e-20))``),
    so a ``jax.vjp`` through it matches core AD's vertex gradient on the
    NEE chain. The triangle twin of :func:`_cone_w_chain`: ONE
    implementation, used by the fused kernel's in-bounce vertex Jacobian
    (the per-bounce-local structure is identical to the sphere cone
    chain)."""
    su = jnp.sqrt(v1p)
    b1 = su * (1.0 - v2p)
    b2 = su * v2p
    b0 = 1.0 - su
    qx = b0 * ax + b1 * bx + b2 * cx
    qy = b0 * ay + b1 * by + b2 * cy
    qz = b0 * az + b1 * bz + b2 * cz
    dqx = qx - sox
    dqy = qy - soy
    dqz = qz - soz
    d2t = dqx * dqx + dqy * dqy + dqz * dqz
    dist = jnp.sqrt(jnp.maximum(d2t, 1e-12))
    otx = dqx / dist
    oty = dqy / dist
    otz = dqz / dist
    e1x = bx - ax
    e1y = by - ay
    e1z = bz - az
    e2x = cx - ax
    e2y = cy - ay
    e2z = cz - az
    crx = e1y * e2z - e1z * e2y
    cry = e1z * e2x - e1x * e2z
    crz = e1x * e2y - e1y * e2x
    two_area = jnp.sqrt(
        jnp.maximum(crx * crx + cry * cry + crz * crz, 1e-20)
    )
    tnx = crx / two_area
    tny = cry / two_area
    tnz = crz / two_area
    area = 0.5 * two_area
    cos_l = jnp.abs(tnx * otx + tny * oty + tnz * otz)
    w_geom = area * cos_l / jnp.maximum(d2t, 1e-12)
    cos_surf = nxp * otx + nyp * oty + nzp * otz
    return cos_surf * w_geom * n_tot_f


def _onb(nx, ny, nz):
    """Branchless orthonormal basis (Duff et al. 2017) — plane-wise port
    of models/physical._onb."""
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tx = 1.0 + sign * nx * nx * a
    ty = sign * b
    tz = -sign * nx
    bx = b
    by = sign + ny * ny * a
    bz = -ny
    return (tx, ty, tz), (bx, by, bz)


def make_physical_shading(
    sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m, tri_a,
    m_alb, m_eco, m_est, m_rgh, m_trn, m_ior, em_cum, le_sph,
    tri_cum, le_tri, tri_area, sky,
    th, tw, n_sph, n_tri, n_mat, n_em, n_em_t, nee, want_dw=False,
    tri_nee=False, want_dwt=False, rough_grad=False,
):
    """Build the physical-tier ``bounce`` routine over the scene refs.

    Shared by the forward megakernel and the fused primal + Jacobian
    kernel — they MUST be the same code (the fused kernel's sweep replays
    the forward's discrete decisions). ``bounce(state, b=None,
    store=None)`` advances one bounce; with ``store`` it also calls
    ``store(b, info)``, where ``info`` holds the per-bounce planes the
    suffix sweep needs, and returns ``(state, store's result)``.

    State: (ox,oy,oz, dx,dy,dz, tr,tg,tb, ar,ag,ab, rng, prevd) — all
    (th, tw) planes; termination is zero throughput; ``prevd`` (f32 0/1)
    is the diffuse-arrival flag for NEE single-counting.
    """
    if want_dwt and not tri_nee:
        raise ValueError("want_dwt (triangle-vertex Jacobian) requires "
                         "tri_nee=True — the chain only exists in the "
                         "tri-NEE estimator")
    sky_r, sky_g, sky_b = sky
    n_em_f = n_em.astype(jnp.float32)
    has_em = n_em > 0
    if tri_nee:
        # pool = sphere emitters then triangle emitters (ordinals
        # n_em..n_tot-1); mirrors models/physical.py's tri_nee tables
        n_tot = n_em + n_em_t
        n_tot_f = n_tot.astype(jnp.float32)
        has_em_t = n_em_t > 0
    zero = jnp.zeros((th, tw), jnp.float32)
    ones = jnp.ones((th, tw), jnp.float32)

    closest_hit, _, _ = fk.make_geometry(
        sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m,
        tri_a, m_alb, m_eco, m_est, m_rgh, m_trn, m_ior,
        sky, th, tw, n_sph, n_tri, n_mat,
    )
    closest_hit_kind = closest_hit.kind
    closest_t = closest_hit.closest_t

    def fetch_materials(mat):
        """Physical-tier material fetch: the reference-tier planes plus the
        raw emission strength (for the NEE single-counting test)."""
        alb_r = zero; alb_g = zero; alb_b = zero
        em_r = zero; em_g = zero; em_b = zero
        est = zero; rgh = zero; trn = zero
        ior = ones

        def mat_body(mi, c):
            alr, alg, alb_, emr, emg, emb, es_, rg, tn, io = c
            msk = mat == mi
            es = m_est[mi, 0]
            return (
                jnp.where(msk, m_alb[mi, 0], alr),
                jnp.where(msk, m_alb[mi, 1], alg),
                jnp.where(msk, m_alb[mi, 2], alb_),
                jnp.where(msk, m_eco[mi, 0] * es, emr),
                jnp.where(msk, m_eco[mi, 1] * es, emg),
                jnp.where(msk, m_eco[mi, 2] * es, emb),
                jnp.where(msk, es, es_),
                jnp.where(msk, m_rgh[mi, 0], rg),
                jnp.where(msk, m_trn[mi, 0], tn),
                jnp.where(msk, m_ior[mi, 0], io),
            )

        return fk._scene_loop(
            n_mat, mat_body,
            (alb_r, alb_g, alb_b, em_r, em_g, em_b, est, rgh, trn, ior),
        )

    def bounce(st_, b=None, store=None):
        """One physical-tier bounce — the plane-wise port of
        models/physical.trace_paths_physical's ``step`` (same op order,
        same 7-draw schedule)."""
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, rng, prevd) = st_
        bt, nx, ny, nz, mat, sphm = closest_hit_kind(ox, oy, oz, dx, dy, dz)
        hitm = bt < fk._INF

        # prefix throughput at Le time (the suffix sweep's P_b)
        P_r, P_g, P_b_ = tr, tg, tb

        # miss -> sky, terminate by zeroing throughput
        ar = ar + jnp.where(hitm, 0.0, tr * sky_r)
        ag = ag + jnp.where(hitm, 0.0, tg * sky_g)
        ab = ab + jnp.where(hitm, 0.0, tb * sky_b)
        tr = jnp.where(hitm, tr, 0.0)
        tg = jnp.where(hitm, tg, 0.0)
        tb = jnp.where(hitm, tb, 0.0)

        (alb_r, alb_g, alb_b, em_r, em_g, em_b, est, rgh, trn, ior) = (
            fetch_materials(mat)
        )

        # Le, skipped when this vertex was reached by a diffuse-sampled ray
        # and the emitter was light-sampleable (models/physical.py:117-125).
        if nee:
            nee_counted = (prevd > 0.0) & (sphm > 0.0) & (est > 0.0) & has_em
            if tri_nee:
                # sampled triangles are single-counted too (core parity:
                # models/physical.py's tri_nee nee_counted extension)
                nee_counted = nee_counted | (
                    (prevd > 0.0) & hitm & (sphm == 0.0) & (est > 0.0)
                    & has_em_t
                )
        else:
            nee_counted = jnp.zeros((th, tw), bool)
        ar = ar + jnp.where(nee_counted, 0.0, tr * em_r)
        ag = ag + jnp.where(nee_counted, 0.0, tg * em_g)
        ab = ab + jnp.where(nee_counted, 0.0, tb * em_b)

        # Fixed 7-draw schedule (models/physical.py:127-134).
        rng, u_transp = fk._uniform(rng)
        rng, u_lobe = fk._uniform(rng)
        rng, u1 = fk._uniform(rng)
        rng, u2 = fk._uniform(rng)
        rng, u_pick = fk._uniform(rng)
        rng, v1 = fk._uniform(rng)
        rng, v2 = fk._uniform(rng)

        choose_refr = u_transp < trn
        choose_diff = (~choose_refr) & (u_lobe < rgh)

        # refract (reference-tier physics, per-material IOR)
        ndot = dx * nx + dy * ny + dz * nz
        entering = ndot < 0.0
        eta = jnp.where(entering, 1.0 / ior, ior)
        rnx = jnp.where(entering, nx, -nx)
        rny = jnp.where(entering, ny, -ny)
        rnz = jnp.where(entering, nz, -nz)
        ni = rnx * dx + rny * dy + rnz * dz
        k_ = 1.0 - eta * eta * (1.0 - ni * ni)
        tirm = k_ < 0.0
        # matches ops/sampling.refract's guarded sqrt (see there)
        ksafe = jnp.where(tirm, 1.0, jnp.maximum(k_, 1e-12))
        coef = eta * ni + jnp.sqrt(ksafe)
        txx = jnp.where(tirm, 0.0, eta * dx - coef * rnx)
        txy = jnp.where(tirm, 0.0, eta * dy - coef * rny)
        txz = jnp.where(tirm, 0.0, eta * dz - coef * rnz)
        # mirror specular
        rfx = dx - 2.0 * ndot * nx
        rfy = dy - 2.0 * ndot * ny
        rfz = dz - 2.0 * ndot * nz
        # cosine-weighted diffuse about the geometric normal (shared
        # polynomial trig spec — ops/rng.sincos_2pi)
        from . import rng as _rngmod

        rdiff = jnp.sqrt(u1)
        cphi_d, sphi_d = _rngmod.sincos_2pi(u2)
        lx = rdiff * cphi_d
        ly = rdiff * sphi_d
        lz = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
        (tx_, ty_, tz_), (bx_, by_, bz_) = _onb(nx, ny, nz)
        ddx = lx * tx_ + ly * bx_ + lz * nx
        ddy = lx * ty_ + ly * by_ + lz * ny
        ddz = lx * tz_ + ly * bz_ + lz * nz

        ndx = jnp.where(choose_refr, txx, jnp.where(choose_diff, ddx, rfx))
        ndy = jnp.where(choose_refr, txy, jnp.where(choose_diff, ddy, rfy))
        ndz = jnp.where(choose_refr, txz, jnp.where(choose_diff, ddz, rfz))
        died = choose_refr & tirm
        tr = jnp.where(died, 0.0, tr)
        tg = jnp.where(died, 0.0, tg)
        tb = jnp.where(died, 0.0, tb)
        ndx = jnp.where(died, dx, ndx)
        ndy = jnp.where(died, dy, ndy)
        ndz = jnp.where(died, dz, ndz)

        ts = jnp.where(hitm, bt, 0.0)
        px = ox + ts * dx
        py = oy + ts * dy
        pz = oz + ts * dz
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * jnp.sqrt(
            px * px + py * py + pz * pz
        )
        sox = px + offs * nx
        soy = py + offs * ny
        soz = pz + offs * nz

        if nee:
            # pick the k-th emitter, uniform over the pool (spheres,
            # then — with tri_nee — triangles; models/physical.py parity)
            if tri_nee:
                kf = jnp.floor(u_pick * n_tot_f).astype(jnp.int32)
                kk = jnp.clip(kf, 0, jnp.maximum(n_tot - 1, 0))
            else:
                kf = jnp.floor(u_pick * n_em_f).astype(jnp.int32)
                kk = jnp.clip(kf, 0, jnp.maximum(n_em - 1, 0))
            kk_ord = kk  # emitter ordinal, stored for the backward's
            # per-emitter geometry accumulation
            # e_idx = #{i : em_cum[i] <= k} (searchsorted-left)
            e_idx = jnp.zeros((th, tw), jnp.int32)

            def cum_body(i, e):
                return e + jnp.where(em_cum[i, 0] <= kk, 1, 0)

            e_idx = fk._scene_loop(n_sph, cum_body, e_idx)
            e_idx = jnp.clip(e_idx, 0, max(n_sph - 1, 0))

            cex = zero; cey = zero; cez = zero; rer = zero
            ler = zero; leg = zero; leb = zero
            emat = jnp.zeros((th, tw), jnp.int32)

            def em_body(i, c):
                cex, cey, cez, rer, ler, leg, leb, emat = c
                msk = e_idx == i
                return (
                    jnp.where(msk, sph_c[i, 0], cex),
                    jnp.where(msk, sph_c[i, 1], cey),
                    jnp.where(msk, sph_c[i, 2], cez),
                    jnp.where(msk, sph_r[i, 0], rer),
                    jnp.where(msk, le_sph[i, 0], ler),
                    jnp.where(msk, le_sph[i, 1], leg),
                    jnp.where(msk, le_sph[i, 2], leb),
                    jnp.where(msk, sph_m[i, 0], emat),
                )

            cex, cey, cez, rer, ler, leg, leb, emat = fk._scene_loop(
                n_sph, em_body, (cex, cey, cez, rer, ler, leg, leb, emat)
            )

            dcx_ = cex - sox
            dcy_ = cey - soy
            dcz_ = cez - soz
            d2 = dcx_ * dcx_ + dcy_ * dcy_ + dcz_ * dcz_
            dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
            wzx = dcx_ / dist
            wzy = dcy_ / dist
            wzz = dcz_ / dist
            # sin2max cap + sth floor mirror models/physical.py exactly
            # (they exist for the core path's AD; values are identical).
            sin2max = jnp.clip(
                rer * rer / jnp.maximum(d2, 1e-12), 0.0, 1.0 - 1e-7
            )
            cosmax = jnp.sqrt(1.0 - sin2max)
            outside = d2 > rer * rer
            cth = 1.0 - v1 * (1.0 - cosmax)
            sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 1e-12))
            cp_, sp_ = _rngmod.sincos_2pi(v2)  # shared polynomial trig
            (tax, tay, taz), (bax, bay, baz) = _onb(wzx, wzy, wzz)
            cphi = sth * cp_
            sphi = sth * sp_
            omx = cphi * tax + sphi * bax + cth * wzx
            omy = cphi * tay + sphi * bay + cth * wzy
            omz = cphi * taz + sphi * baz + cth * wzz
            pdf_omega = 1.0 / jnp.maximum(_TWO_PI * (1.0 - cosmax), 1e-8)
            cos_surf = nx * omx + ny * omy + nz * omz

            # analytic hit distance on the sampled emitter — EXACT
            # replication of ops/intersect.ray_sphere_t (full-b quadratic,
            # 1e-30 sqrt guard): the visibility compare s_bt >= t_e*(1-1e-3)
            # sits on a knife edge for cone-rim grazing rays, so t_e must
            # round identically to the core path's.
            odd = omx * omx + omy * omy + omz * omz
            ocx_ = sox - cex
            ocy_ = soy - cey
            ocz_ = soz - cez
            be = 2.0 * (ocx_ * omx + ocy_ * omy + ocz_ * omz)
            cqe = ocx_ * ocx_ + ocy_ * ocy_ + ocz_ * ocz_ - rer * rer
            dete = be * be - 4.0 * odd * cqe
            vale = dete >= 0.0
            sqe = jnp.sqrt(jnp.where(vale, jnp.maximum(dete, 1e-30), 1.0))
            oinv2 = 0.5 / odd
            te1 = (-be - sqe) * oinv2
            te2 = (-be + sqe) * oinv2
            t_e = jnp.where(te1 >= 0.0, te1, jnp.where(te2 >= 0.0, te2, fk._INF))
            t_e = jnp.where(vale, t_e, fk._INF)

            if tri_nee:
                # triangle-emitter candidate from the SAME v1/v2 draws
                # (uniform-by-area barycentric, area pdf -> solid angle;
                # mirrors models/physical.py's tri_nee branch op-for-op)
                kt = jnp.clip(kk - n_em, 0, jnp.maximum(n_em_t - 1, 0))
                is_tri = (kk >= n_em) & has_em_t
                t_idx = jnp.zeros((th, tw), jnp.int32)

                def tcum_body(i, e):
                    return e + jnp.where(tri_cum[i, 0] <= kt, 1, 0)

                t_idx = fk._scene_loop(n_tri, tcum_body, t_idx)
                t_idx = jnp.clip(t_idx, 0, max(n_tri - 1, 0))

                tv = [zero] * 9
                tnx = zero; tny = zero; tnz = zero
                tar = zero
                tlr = zero; tlg = zero; tlb = zero
                tmat = jnp.zeros((th, tw), jnp.int32)

                def tfetch(i, c):
                    tv, tnx, tny, tnz, tar, tlr, tlg, tlb, tmat = c
                    msk = t_idx == i
                    tv = tuple(
                        jnp.where(msk, src[i, ax], tv[j * 3 + ax])
                        for j, src in enumerate((tri_v0, tri_v1, tri_v2))
                        for ax in range(3)
                    )
                    return (
                        tv,
                        jnp.where(msk, tri_n[i, 0], tnx),
                        jnp.where(msk, tri_n[i, 1], tny),
                        jnp.where(msk, tri_n[i, 2], tnz),
                        jnp.where(msk, tri_area[i, 0], tar),
                        jnp.where(msk, le_tri[i, 0], tlr),
                        jnp.where(msk, le_tri[i, 1], tlg),
                        jnp.where(msk, le_tri[i, 2], tlb),
                        jnp.where(msk, tri_m[i, 0], tmat),
                    )

                (tv, tnx, tny, tnz, tar, tlr, tlg, tlb, tmat) = (
                    fk._scene_loop(
                        n_tri, tfetch,
                        (tuple(tv), tnx, tny, tnz, tar, tlr, tlg, tlb,
                         tmat),
                    )
                )
                su = jnp.sqrt(v1)
                b1c = su * (1.0 - v2)
                b2c = su * v2
                b0c = 1.0 - su
                qx = b0c * tv[0] + b1c * tv[3] + b2c * tv[6]
                qy = b0c * tv[1] + b1c * tv[4] + b2c * tv[7]
                qz = b0c * tv[2] + b1c * tv[5] + b2c * tv[8]
                dqx = qx - sox
                dqy = qy - soy
                dqz = qz - soz
                d2t = dqx * dqx + dqy * dqy + dqz * dqz
                dist_t = jnp.sqrt(jnp.maximum(d2t, 1e-12))
                otx = dqx / dist_t
                oty = dqy / dist_t
                otz = dqz / dist_t
                cos_l = jnp.abs(tnx * otx + tny * oty + tnz * otz)
                w_geom_t = tar * cos_l / jnp.maximum(d2t, 1e-12)
                itf = is_tri
                omx = jnp.where(itf, otx, omx)
                omy = jnp.where(itf, oty, omy)
                omz = jnp.where(itf, otz, omz)
                cos_surf = jnp.where(
                    itf, nx * otx + ny * oty + nz * otz, cos_surf
                )
                t_e = jnp.where(itf, dist_t, t_e)
                ler = jnp.where(itf, tlr, ler)
                leg = jnp.where(itf, tlg, leg)
                leb = jnp.where(itf, tlb, leb)
                emat = jnp.where(itf, tmat, emat)
                # tri picks carry no sphere-geometry cotangent: ordinal
                # -1 never matches any tracked k in the jgeo/geo loops
                kk_ord = jnp.where(itf, jnp.int32(-1), kk_ord)
                # ... and sphere picks carry no TRIANGLE-geometry
                # cotangent: the tri-emitter ordinal plane is -1 there
                kkt_ord = jnp.where(itf, kt, jnp.int32(-1))

            s_bt = closest_t(sox, soy, soz, omx, omy, omz)
            visible = (
                (s_bt < fk._INF)
                & (s_bt >= t_e * (1.0 - 1e-3) - 1e-4)
                & (t_e < fk._INF)
            )
            if tri_nee:
                # boolean and/or form of the branch choice
                branch_ok = (is_tri & (cos_l > 1e-6)) | (
                    ~is_tri & outside
                )
                valid = (
                    hitm & choose_diff & (n_tot > 0) & branch_ok
                    & (cos_surf > 0.0) & visible
                )
                w = jnp.where(
                    is_tri, cos_surf * w_geom_t, cos_surf / pdf_omega
                ) * n_tot_f
            else:
                valid = (
                    hitm & choose_diff & has_em & outside
                    & (cos_surf > 0.0) & visible
                )
                w = cos_surf / pdf_omega * n_em_f
            ar = ar + jnp.where(valid, tr * alb_r * _INV_PI * ler * w, 0.0)
            ag = ag + jnp.where(valid, tg * alb_g * _INV_PI * leg * w, 0.0)
            ab = ab + jnp.where(valid, tb * alb_b * _INV_PI * leb * w, 0.0)
            if want_dw:
                # ∂w/∂(center, radius) of the sampled emitter — the
                # g-independent half of the NEE geometry cotangent (the
                # per-channel factor F closes it; see the fused kernel).
                # The chain is _cone_w_chain, evaluated on the live
                # values. The pick-count factor is the POOL size: n_tot
                # under tri_nee (the forward's sphere-pick weight at the
                # `w = ... * n_tot_f` line above), n_em otherwise —
                # passing n_em_f here under tri_nee mis-scales every
                # sphere-emitter geometry cotangent by n_em/n_tot
                # (regression-pinned in tests/test_pallas_physical.py).
                pool_w_f = n_tot_f if tri_nee else n_em_f
                _, w_vjp = jax.vjp(
                    lambda cx_, cy_, cz_, rr_: _cone_w_chain(
                        cx_, cy_, cz_, rr_, sox, soy, soz, nx, ny, nz,
                        v1, cp_, sp_, pool_w_f,
                    ),
                    cex, cey, cez, rer,
                )
                dw = w_vjp(ones)
            else:
                dw = None
            if want_dwt:
                # ∂w/∂(v0,v1,v2) of the sampled TRIANGLE emitter — the
                # vertex twin of dw above, through the ONE shared
                # _tri_w_chain. Same per-channel closure factor F.
                # Sphere-pick lanes evaluate the chain on their fetched
                # tri candidate (garbage but guarded — no NaN) and are
                # masked out by kkt == -1 in the accumulation loops.
                _, wt_vjp = jax.vjp(
                    lambda a0, a1, a2, b0_, b1_, b2_, c0_, c1_, c2_: (
                        _tri_w_chain(
                            a0, a1, a2, b0_, b1_, b2_, c0_, c1_, c2_,
                            sox, soy, soz, nx, ny, nz, v1, v2, n_tot_f,
                        )
                    ),
                    *tv,
                )
                dwt = wt_vjp(ones)
            else:
                dwt = None
        else:
            valid = jnp.zeros((th, tw), bool)
            w = zero
            ler = zero; leg = zero; leb = zero
            emat = jnp.zeros((th, tw), jnp.int32)
            kk_ord = jnp.zeros((th, tw), jnp.int32)
            kkt_ord = jnp.full((th, tw), -1, jnp.int32)
            dw = (zero, zero, zero, zero) if want_dw else None
            dwt = (zero,) * 9 if want_dwt else None

        if store is not None:
            validf = jnp.where(valid, 1.0, 0.0)
            extra = {}
            if want_dw or want_dwt:
                # per-channel closure factor of the geometry cotangent:
                # dL/d(comp) = sum_c g_c * F_c * dw_comp, with
                # F_c = valid * P_c * albedo_c * le_c / pi
                extra = dict(
                    F=(
                        validf * P_r * alb_r * ler * _INV_PI,
                        validf * P_g * alb_g * leg * _INV_PI,
                        validf * P_b_ * alb_b * leb * _INV_PI,
                    ),
                )
                if want_dw:
                    extra["dw"] = dw
                if want_dwt:
                    extra["dwt"] = dwt
                    extra["kkt"] = kkt_ord
            rec = store(
                b,
                dict(
                    **extra,
                    P=(P_r, P_g, P_b_),
                    mat=mat,
                    emat=emat,
                    hitm=hitm,
                    missm=~hitm,
                    tirm=died & hitm,
                    addle=hitm & ~nee_counted,
                    # hit material's albedo and emission E = eco*est
                    alb=(alb_r, alb_g, alb_b),
                    E=(em_r, em_g, em_b),
                    # transparency ratio derivative
                    dr=jnp.where(
                        choose_refr,
                        1.0 / jnp.maximum(trn, 1e-6),
                        -1.0 / jnp.maximum(1.0 - trn, 1e-6),
                    ),
                    # score-function lobe derivative d(log p)/d(rough)
                    # (rough_grad only): the lobe mixture samples
                    # diffuse w.p. rough, so the REINFORCE factor is
                    # +1/rough (diffuse), -1/(1-rough) (specular), 0
                    # (refract — the lobe draw is not taken). Same
                    # guards as models/physical.py's lobe_ratio.
                    **(
                        dict(drg=jnp.where(
                            choose_refr,
                            0.0,
                            jnp.where(
                                choose_diff,
                                1.0 / jnp.maximum(rgh, 1e-6),
                                -1.0 / jnp.maximum(1.0 - rgh, 1e-6),
                            ),
                        ))
                        if rough_grad else {}
                    ),
                    # NEE contribution per unit throughput:
                    # nee_c = valid * le_c * w / pi
                    nee=(
                        validf * ler * w * _INV_PI,
                        validf * leg * w * _INV_PI,
                        validf * leb * w * _INV_PI,
                    ),
                    # emitter-emission weight per unit g:
                    # EmW_c = valid * P_c * albedo_c * w / pi
                    EmW=(
                        validf * P_r * alb_r * w * _INV_PI,
                        validf * P_g * alb_g * w * _INV_PI,
                        validf * P_b_ * alb_b * w * _INV_PI,
                    ),
                    # the sampled emitter's ordinal (geometry planes)
                    kk=kk_ord,
                ),
            )

        # continuing throughput (cos/pdf cancels for the diffuse lobe)
        tr = tr * alb_r
        tg = tg * alb_g
        tb = tb * alb_b

        side = jnp.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
        nox = px + offs * side * nx
        noy = py + offs * side * ny
        noz = pz + offs * side * nz

        # prev_diff for alive lanes (hit & survived); dead lanes' garbage
        # updates never matter — their throughput is zero.
        alive_now = hitm & ~died
        prevd = jnp.where(
            alive_now, jnp.where(choose_diff, 1.0, 0.0), prevd
        )
        st_ = (nox, noy, noz, ndx, ndy, ndz, tr, tg, tb, ar, ag, ab, rng,
               prevd)
        return st_ if store is None else (st_, rec)

    # expose the factory's own distance-only query (the whole-tile sky
    # probes must intersect with EXACTLY the bounce's geometry code —
    # the CLAUDE.md replay invariant — so no second make_geometry)
    bounce.closest_t = closest_t
    return bounce


def _camera_setup(par_f, par_i, th, tw, ti, tj):
    """Shared per-tile camera/pixel decode for both physical kernels."""
    tan2 = par_f[0, 0]
    aspect = par_f[0, 1]
    width = par_f[0, 2]
    height = par_f[0, 3]
    row_start = par_i[0, 2]
    rows = (
        jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0) + ti * th + row_start
    )
    cols = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1) + tj * tw
    pix = (rows * width.astype(jnp.int32) + cols).astype(jnp.uint32)
    crx, cry, crz = par_f[0, 10], par_f[0, 11], par_f[0, 12]
    cux, cuy, cuz = par_f[0, 13], par_f[0, 14], par_f[0, 15]
    cfx, cfy, cfz = par_f[0, 16], par_f[0, 17], par_f[0, 18]

    def ray_dirs(jx, jy):
        x = (cols.astype(jnp.float32) + jx) / width * 2.0 - 1.0
        y = -((rows.astype(jnp.float32) + jy) / height * 2.0 - 1.0)
        dcx = x * tan2
        dcy = y * tan2 / aspect
        pdx = dcx * crx + dcy * cux + cfx
        pdy = dcx * cry + dcy * cuy + cfy
        pdz = dcx * crz + dcy * cuz + cfz
        pn = jax.lax.rsqrt(pdx * pdx + pdy * pdy + pdz * pdz)
        return pdx * pn, pdy * pn, pdz * pn

    return pix, ray_dirs


def _phys_kernel(
    sph_c, sph_r, sph_m, sph_a,
    tri_v0, tri_v1, tri_v2, tri_n, tri_m, tri_a,
    m_alb, m_eco, m_est, m_rgh, m_trn, m_ior,
    em_cum,  # (S, 1) int32 cumulative count of emissive spheres
    le_sph,  # (S, 3) f32 premultiplied emitter radiance (eco * est)
    tri_cum,  # (T, 1) int32 cumulative count of emissive triangles
    le_tri,  # (T, 3) f32 premultiplied triangle radiance
    tri_area,  # (T, 1) f32 triangle areas
    par_f,
    par_i,  # (1, 5) int32: seed, sample_offset, row_start, n_em, n_em_t
    out_ref,  # (3, TH, TW) radiance tile
    *maybe_cnt,  # with count_rounds: (1, 1) i32 rounds this program ran
    th, tw, n_sph, n_tri, n_mat, spp, max_bounces, jitter, nee,
    count_rounds=False,
    early_exit="once",
    tri_nee=False,
):
    ti = pl.program_id(0)
    tj = pl.program_id(1)
    sky = (par_f[0, 4], par_f[0, 5], par_f[0, 6])
    cox, coy, coz = par_f[0, 7], par_f[0, 8], par_f[0, 9]
    seed = par_i[0, 0].astype(jnp.uint32)
    sample_offset = par_i[0, 1]
    n_em = par_i[0, 3]
    n_em_t = par_i[0, 4]

    pix, ray_dirs = _camera_setup(par_f, par_i, th, tw, ti, tj)
    zero = jnp.zeros((th, tw), jnp.float32)
    ones = jnp.ones((th, tw), jnp.float32)
    if not jitter:
        pdx, pdy, pdz = ray_dirs(jnp.float32(0.5), jnp.float32(0.5))

    bounce = make_physical_shading(
        sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m,
        tri_a, m_alb, m_eco, m_est, m_rgh, m_trn, m_ior, em_cum, le_sph,
        tri_cum, le_tri, tri_area,
        sky, th, tw, n_sph, n_tri, n_mat, n_em, n_em_t, nee,
        tri_nee=tri_nee,
    )

    cam_ox = jnp.full((th, tw), cox)
    cam_oy = jnp.full((th, tw), coy)
    cam_oz = jnp.full((th, tw), coz)
    # whole-tile sky gate (pallas_kernels._kernel): with shared primary
    # rays, "every lane misses at bounce 0" is a per-tile fact; one
    # distance-only probe replaces all per-sample checks and sky tiles
    # skip the sample loop. Physical bounce arithmetic for a bounce-0
    # miss is exactly acc += sky (throughput zeroed before Le/NEE).
    tile_gate = early_exit == "once" and not jitter
    if tile_gate:
        t0p = bounce.closest_t(cam_ox, cam_oy, cam_oz, pdx, pdy, pdz)
        tile_alive = jnp.max(jnp.where(t0p < fk._INF, 1.0, 0.0)) > 0.0

    def sample_body(s, acc):
        acc_r, acc_g, acc_b = acc[:3]
        sample = (s + sample_offset).astype(jnp.uint32)
        st = (
            pix * fk._u32(0x9E3779B9)
            ^ sample * fk._u32(0x85EBCA6B)
            ^ seed * fk._u32(0xC2B2AE35)
        )
        st, _ = fk._pcg(st)
        st, _ = fk._pcg(st)

        if jitter:
            st, jx = fk._uniform(st)
            st, jy = fk._uniform(st)
            sdx, sdy, sdz = ray_dirs(jx, jy)
        else:
            sdx, sdy, sdz = pdx, pdy, pdz

        state0 = (
            cam_ox, cam_oy, cam_oz,
            sdx, sdy, sdz,
            ones, ones, ones,
            zero, zero, zero,
            st, zero,
        )

        # same early-exit scheme menu as the reference forward kernel
        # (pallas_kernels._kernel): "once" checks a single cross-lane
        # reduce after round 0 (sky tiles die there; content tiles run
        # ~the full budget), True checks every round, False never.
        if tile_gate:
            # the tile-level probe already proved a bounce-0 hit exists
            # (shared primaries), so no per-sample check at all
            out = jax.lax.fori_loop(0, max_bounces + 1,
                                    lambda b, s2: bounce(s2), state0)
            bend = jnp.int32(max_bounces + 1)
        elif early_exit == "once":
            st1 = bounce(state0)
            alive0 = jnp.max(st1[6] + st1[7] + st1[8]) > 0.0
            out = jax.lax.cond(
                alive0,
                lambda s_: jax.lax.fori_loop(
                    1, max_bounces + 1, lambda b, s2: bounce(s2), s_),
                lambda s_: s_,
                st1,
            )
            bend = jnp.where(alive0, jnp.int32(max_bounces + 1),
                             jnp.int32(1))
        else:
            def w_cond(carry):
                b, s_ = carry
                if not early_exit:
                    return b < max_bounces + 1
                return (b < max_bounces + 1) & (
                    jnp.max(s_[6] + s_[7] + s_[8]) > 0.0
                )

            def w_body(carry):
                b, s_ = carry
                return b + 1, bounce(s_)

            bend, out = jax.lax.while_loop(w_cond, w_body,
                                           (jnp.int32(0), state0))
        (_, _, _, _, _, _, tr, tg, tb, ar, ag, ab, _, _) = out
        # bounce budget exhausted -> sky
        ar = ar + tr * sky[0]
        ag = ag + tg * sky[1]
        ab = ab + tb * sky[2]
        if count_rounds:
            return (acc_r + ar, acc_g + ag, acc_b + ab, acc[3] + bend)
        return (acc_r + ar, acc_g + ag, acc_b + ab)

    init = (zero, zero, zero) + (
        (jnp.int32(0),) if count_rounds else ()
    )
    if tile_gate:
        def run_sky():
            def sbody(s, a):
                out = (a[0] + sky[0], a[1] + sky[1], a[2] + sky[2])
                return out + ((a[3],) if count_rounds else ())

            return jax.lax.fori_loop(0, spp, sbody, init)

        acc = jax.lax.cond(
            tile_alive,
            lambda: jax.lax.fori_loop(0, spp, sample_body, init),
            run_sky,
        )
    else:
        acc = jax.lax.fori_loop(0, spp, sample_body, init)
    inv = jnp.float32(1.0 / spp)
    out_ref[0] = acc[0] * inv
    out_ref[1] = acc[1] * inv
    out_ref[2] = acc[2] * inv
    if count_rounds:
        (cnt_ref,) = maybe_cnt
        cnt_ref[0, 0] = acc[3]


def _phys_fused_kernel(
    sph_c, sph_r, sph_m, sph_a,
    tri_v0, tri_v1, tri_v2, tri_n, tri_m, tri_a,
    m_alb, m_eco, m_est, m_rgh, m_trn, m_ior,
    em_cum, le_sph, tri_cum, le_tri, tri_area, par_f, par_i,
    img_ref,  # (3, TH, TW): primal radiance tile (mean over spp)
    j_ref,  # (9*M + 3, TH, TW): Jacobian planes; last 3 = sky K
    jgeo_ref,  # (max(12*K, 1), TH, TW): NEE emitter-geometry planes
    jtri_ref,  # (max(27*Kt, 1), TH, TW): tri-emitter VERTEX planes
    h_ref,  # ((B+1) * 23, TH, TW): round records (the history buffer)
    *maybe_cnt,  # with count_rounds: (1, 1) i32 rounds this program ran
    th, tw, n_sph, n_tri, n_mat, spp, max_bounces, jitter, nee, n_em_cap,
    early_exit="once",
    tri_nee=False,
    tri_em_cap=0,
    count_rounds=False,
    rough_grad=False,
    sync=False,
):
    """Fused physical-tier primal + material/sky Jacobian (the physical
    analog of pallas_grad._fused_kernel; see that module's math). Per
    material the Jacobian planes are A[3] (albedo, incl. the NEE term),
    S'[3] (emission base: addle-gated P plus the emitter-keyed EmW), and
    R[3] (transparency); 3 sky-K planes close the list.

    With ``n_em_cap > 0`` the kernel ALSO emits the NEE emitter-geometry
    Jacobian: the sampled emitter's center/radius cotangent is
    ``sum_c g_c * F_c * dw_comp`` with ``F_c = valid * P_c * albedo_c *
    le_c / pi`` and ``dw = ∂w/∂(center, radius)`` — BOTH g-independent and
    purely prefix quantities, so the planes ``G[k, comp, c] += [kk=k] *
    F_c * dw_comp`` accumulate directly in the bounce (no sweep
    dependence) and the backward stays a contraction. Emitter ordinals
    >= n_em_cap and non-emitter geometry get zeros.

    Each round's record — the values the suffix sweep reads — goes to
    this program's tile of the history buffer ``h_ref`` (device memory,
    as in pallas_grad._fused_kernel) and is read back by the sweep."""
    ti = pl.program_id(0)
    tj = pl.program_id(1)
    sky_r, sky_g, sky_b = par_f[0, 4], par_f[0, 5], par_f[0, 6]
    cox, coy, coz = par_f[0, 7], par_f[0, 8], par_f[0, 9]
    seed = par_i[0, 0].astype(jnp.uint32)
    sample_offset = par_i[0, 1]
    n_em = par_i[0, 3]
    n_em_t = par_i[0, 4]

    pix, ray_dirs = _camera_setup(par_f, par_i, th, tw, ti, tj)
    zero = jnp.zeros((th, tw), jnp.float32)
    ones = jnp.ones((th, tw), jnp.float32)
    izero = jnp.zeros((th, tw), jnp.int32)
    if not jitter:
        pdx, pdy, pdz = ray_dirs(jnp.float32(0.5), jnp.float32(0.5))

    bounce = make_physical_shading(
        sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m,
        tri_a, m_alb, m_eco, m_est, m_rgh, m_trn, m_ior, em_cum, le_sph,
        tri_cum, le_tri, tri_area,
        (sky_r, sky_g, sky_b), th, tw, n_sph, n_tri, n_mat, n_em, n_em_t,
        nee, want_dw=n_em_cap > 0, tri_nee=tri_nee,
        want_dwt=tri_em_cap > 0, rough_grad=rough_grad,
    )

    cam_ox = jnp.full((th, tw), cox)
    cam_oy = jnp.full((th, tw), coy)
    cam_oz = jnp.full((th, tw), coz)
    # whole-tile sky gate (see _phys_kernel): for an all-miss tile the
    # primal is exactly sky, the only nonzero Jacobian entry is the
    # sky-K plane += 1 per sample (the sweep's single miss round), and
    # the geometry planes stay zero — so the gated branch writes those
    # closed forms and skips the replay + sweep entirely.
    tile_gate = early_exit == "once" and not jitter
    if tile_gate:
        t0p = bounce.closest_t(cam_ox, cam_oy, cam_oz, pdx, pdy, pdz)
        tile_alive = jnp.max(jnp.where(t0p < fk._INF, 1.0, 0.0)) > 0.0

    # per-material plane count: A[3] + S'[3] + R[3], plus — with
    # rough_grad — the score-function roughness planes G[3]
    mp = 12 if rough_grad else 9
    n_j = mp * n_mat + 3
    sky_base = mp * n_mat

    def zero_j(k, _):
        j_ref[k] = zero
        return None

    jax.lax.fori_loop(0, n_j, zero_j, None)

    def zero_geo(k, _):
        jgeo_ref[k] = zero
        return None

    jax.lax.fori_loop(0, max(12 * n_em_cap, 1), zero_geo, None)

    def zero_tri(k, _):
        jtri_ref[k] = zero
        return None

    jax.lax.fori_loop(0, max(27 * tri_em_cap, 1), zero_tri, None)

    def store(b, info):
        """This round's record for the sweep: P[3], hit/miss/TIR/addle
        masks (f32 0/1), albedo[3], E[3], nee[3], EmW[3], the
        transparency ratio derivative, (rough_grad) the lobe
        derivative, material and emitter material. The geometry planes
        accumulate here directly."""
        if n_em_cap:
            # direct in-bounce geometry accumulation: F and dw are prefix
            # quantities (no suffix dependence), so no record and no
            # sweep work — 12 products + K masked RMWs per bounce.
            dwx, dwy, dwz, dwr = info["dw"]
            F = info["F"]
            kkp = info["kk"]
            prods = [F[c] * dcomp for dcomp in (dwx, dwy, dwz, dwr)
                     for c in range(3)]

            def geo_body(k, _):
                # F carries the valid mask; kk is garbage only where F==0
                mk_ = jnp.where(kkp == k, 1.0, 0.0)
                for j in range(12):
                    jgeo_ref[k * 12 + j] = jgeo_ref[k * 12 + j] + mk_ * prods[j]
                return None

            fk._scene_loop(n_em_cap, geo_body, None)
        if tri_em_cap:
            # triangle-emitter VERTEX planes: same prefix-only structure
            # as the sphere planes above — 27 products + Kt masked RMW
            # loops per bounce, no sweep work. Tri-pick lanes carry
            # kk == -1 in the sphere loop and sphere-pick lanes carry
            # kkt == -1 here, so the two plane families never
            # double-count a lane.
            dwt = info["dwt"]
            Ft = info["F"]
            kktp = info["kkt"]
            prods_t = [Ft[c] * dcomp for dcomp in dwt for c in range(3)]

            def tri_body(k, _):
                mk_ = jnp.where(kktp == k, 1.0, 0.0)
                for j in range(27):
                    jtri_ref[k * 27 + j] = (
                        jtri_ref[k * 27 + j] + mk_ * prods_t[j]
                    )
                return None

            fk._scene_loop(tri_em_cap, tri_body, None)
        f01 = lambda m: jnp.where(m, 1.0, 0.0)
        return (
            info["P"],
            (f01(info["hitm"]), f01(info["missm"]), f01(info["tirm"]),
             f01(info["addle"])),
            info["alb"], info["E"], info["nee"], info["EmW"],
            info["dr"], info["drg"] if rough_grad else zero,
            info["mat"], info["emat"],
        )

    # The structure and dtypes of one round record (the sweep reads the
    # records back from the history buffer in this shape).
    z3 = (zero, zero, zero)
    record_like = (z3, (zero,) * 4, z3, z3, z3, z3, zero, zero, izero, izero)

    def sweep_round(rec, S):
        """One suffix-sweep step: accumulate this round's Jacobian planes
        and carry S_{b-1} = addle*E + albedo*(S_h + nee) (hit), sky
        (miss), pass-through (dead — re-anchored at the death)."""
        (P, (hitf, missf, tirf, addle), alb, E, neep, emw, dr_b, rg_b,
         mat, emat) = rec
        Sr, Sg, Sb = S
        hitm = hitf > 0.0
        missm = missf > 0.0
        tirm = tirf > 0.0
        Pr = jnp.where(hitm | missm, P[0], 0.0)
        Pg = jnp.where(hitm | missm, P[1], 0.0)
        Pb_ = jnp.where(hitm | missm, P[2], 0.0)
        Sr_h = jnp.where(tirm, 0.0, Sr)
        Sg_h = jnp.where(tirm, 0.0, Sg)
        Sb_h = jnp.where(tirm, 0.0, Sb)

        j_ref[sky_base + 0] = j_ref[sky_base + 0] + jnp.where(
            missm, Pr, 0.0)
        j_ref[sky_base + 1] = j_ref[sky_base + 1] + jnp.where(
            missm, Pg, 0.0)
        j_ref[sky_base + 2] = j_ref[sky_base + 2] + jnp.where(
            missm, Pb_, 0.0)

        nee_r = jnp.where(hitm, neep[0], 0.0)
        nee_g = jnp.where(hitm, neep[1], 0.0)
        nee_b = jnp.where(hitm, neep[2], 0.0)
        # albedo weight: P * (S_h + nee), hit lanes only
        cAr = jnp.where(hitm, Pr * (Sr_h + nee_r), 0.0)
        cAg = jnp.where(hitm, Pg * (Sg_h + nee_g), 0.0)
        cAb = jnp.where(hitm, Pb_ * (Sb_h + nee_b), 0.0)
        # emission base: addle-gated P (the Le-skip lanes add none)
        cSr = addle * Pr
        cSg = addle * Pg
        cSb = addle * Pb_
        dr = jnp.where(hitm, dr_b, 0.0)
        cRr = cAr * dr
        cRg = cAg * dr
        cRb = cAb * dr
        if rough_grad:
            # score-function roughness planes: the lobe factor sits at
            # the SAME point of the product chain as the transparency
            # ratio, so its cotangent reuses cA with d(log p)/d(rough)
            # in place of dr (albedo closes at the contraction, like the
            # R planes).
            rg = jnp.where(hitm, rg_b, 0.0)
            cGr = cAr * rg
            cGg = cAg * rg
            cGb = cAb * rg
        emw_r = jnp.where(hitm, emw[0], 0.0)
        emw_g = jnp.where(hitm, emw[1], 0.0)
        emw_b = jnp.where(hitm, emw[2], 0.0)

        def mat_body(mi, _):
            mskf = jnp.where(mat == mi, 1.0, 0.0)
            mske = jnp.where(emat == mi, 1.0, 0.0)
            base = mp * mi
            j_ref[base + 0] = j_ref[base + 0] + mskf * cAr
            j_ref[base + 1] = j_ref[base + 1] + mskf * cAg
            j_ref[base + 2] = j_ref[base + 2] + mskf * cAb
            j_ref[base + 3] = j_ref[base + 3] + (
                mskf * cSr + mske * emw_r
            )
            j_ref[base + 4] = j_ref[base + 4] + (
                mskf * cSg + mske * emw_g
            )
            j_ref[base + 5] = j_ref[base + 5] + (
                mskf * cSb + mske * emw_b
            )
            j_ref[base + 6] = j_ref[base + 6] + mskf * cRr
            j_ref[base + 7] = j_ref[base + 7] + mskf * cRg
            j_ref[base + 8] = j_ref[base + 8] + mskf * cRb
            if rough_grad:
                j_ref[base + 9] = j_ref[base + 9] + mskf * cGr
                j_ref[base + 10] = j_ref[base + 10] + mskf * cGg
                j_ref[base + 11] = j_ref[base + 11] + mskf * cGb
            return None

        fk._scene_loop(n_mat, mat_body, None)

        Er = jnp.where(hitm, E[0], 0.0)
        Eg = jnp.where(hitm, E[1], 0.0)
        Eb = jnp.where(hitm, E[2], 0.0)
        Ar = jnp.where(hitm, alb[0], 0.0)
        Ag = jnp.where(hitm, alb[1], 0.0)
        Ab = jnp.where(hitm, alb[2], 0.0)
        Sr = jnp.where(
            hitm, addle * Er + Ar * (Sr_h + nee_r),
            jnp.where(missm, sky_r, Sr),
        )
        Sg = jnp.where(
            hitm, addle * Eg + Ag * (Sg_h + nee_g),
            jnp.where(missm, sky_g, Sg),
        )
        Sb = jnp.where(
            hitm, addle * Eb + Ab * (Sb_h + nee_b),
            jnp.where(missm, sky_b, Sb),
        )
        return (Sr, Sg, Sb)

    S0 = (jnp.full((th, tw), sky_r), jnp.full((th, tw), sky_g),
          jnp.full((th, tw), sky_b))

    def structurally_dead(rec):
        """Lanes that missed or died by TIR in this round, as f32 0/1."""
        hitf, _, tirf, _ = rec[1]
        return jnp.where((hitf > 0.0) & (tirf == 0.0), 0.0, 1.0)

    def sample_body(s, acc_img):
        acc_r, acc_g, acc_b = acc_img[:3]
        sample = (s + sample_offset).astype(jnp.uint32)
        st = (
            pix * fk._u32(0x9E3779B9)
            ^ sample * fk._u32(0x85EBCA6B)
            ^ seed * fk._u32(0xC2B2AE35)
        )
        st, _ = fk._pcg(st)
        st, _ = fk._pcg(st)
        if jitter:
            st, jx = fk._uniform(st)
            st, jy = fk._uniform(st)
            sdx, sdy, sdz = ray_dirs(jx, jy)
        else:
            sdx, sdy, sdz = pdx, pdy, pdz

        s_ = (
            cam_ox, cam_oy, cam_oz,
            sdx, sdy, sdz,
            ones, ones, ones,
            zero, zero, zero,
            st, zero,
        )

        # replay = the forward (the budget ends only on structural deaths;
        # a zero-albedo lane still needs its suffix carry —
        # pallas_grad.py). Extra rounds on mid-dying tiles are exact: dead
        # lanes record P == 0 and the sweep re-anchors at the recorded
        # death.
        def round_b(b, s_):
            return bounce(s_, b=b, store=store)

        s_, bend = fk.rolled_rounds(
            round_b, s_, h_ref, max_bounces, early_exit,
            lambda f, rec: structurally_dead(rec))
        # budget exhausted -> sky weight K, then the sweep over the
        # executed rounds from last to first
        for c in range(3):
            j_ref[sky_base + c] = j_ref[sky_base + c] + s_[6 + c]
        if sync:
            pl_triton.debug_barrier()

        def bwd(i, S):
            rec = fk.load_record(h_ref, bend - 1 - i, record_like)
            return sweep_round(rec, S)

        jax.lax.fori_loop(0, bend, bwd, S0)

        # budget exhausted -> sky; same association as _phys_kernel so
        # the primal stays bit-identical to render_physical_pallas
        ar = s_[9] + s_[6] * sky_r
        ag = s_[10] + s_[7] * sky_g
        ab = s_[11] + s_[8] * sky_b
        out = (acc_r + ar, acc_g + ag, acc_b + ab)
        if count_rounds:
            return out + (acc_img[3] + bend,)
        return out

    acc0 = (zero, zero, zero) + (
        (jnp.int32(0),) if count_rounds else ()
    )
    if tile_gate:
        def run_sky():
            sppf = jnp.float32(spp)
            for c in range(3):
                j_ref[sky_base + c] = j_ref[sky_base + c] + sppf * ones

            def sbody(s, a):
                # gated sky tiles report 0 executed rounds (forward
                # kernels' convention)
                out = (a[0] + sky_r, a[1] + sky_g, a[2] + sky_b)
                return out + ((a[3],) if count_rounds else ())

            return jax.lax.fori_loop(0, spp, sbody, acc0)

        acc = jax.lax.cond(
            tile_alive,
            lambda: jax.lax.fori_loop(0, spp, sample_body, acc0),
            run_sky,
        )
    else:
        acc = jax.lax.fori_loop(0, spp, sample_body, acc0)
    inv = jnp.float32(1.0 / spp)
    img_ref[0] = acc[0] * inv
    img_ref[1] = acc[1] * inv
    img_ref[2] = acc[2] * inv
    if count_rounds:
        (cnt_ref,) = maybe_cnt
        cnt_ref[0, 0] = acc[3]


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "spp", "max_bounces", "tile", "interpret",
        "rows", "jitter", "nee", "n_em_cap", "early_exit", "tri_nee",
        "tri_em_cap", "count_rounds", "rough_grad",
    ),
)
def render_physical_pallas_fused(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset=0,
    tile=PHYS_FUSED_TILE,
    interpret: bool = False,
    row_start=0,
    rows: int | None = None,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int = 0,
    early_exit: bool | str = "once",
    tri_nee: bool = False,
    tri_em_cap: int = 0,
    count_rounds: bool = False,
    rough_grad: bool = False,
):
    """Physical-tier primal radiance (rows, W, 3) PLUS its per-pixel
    material/sky Jacobian (9*M+3, rows, W) in one kernel pass — the
    physical analog of pallas_grad.render_pallas_fused. Contract with
    :func:`contract_physical_jacobian`.

    ``n_em_cap > 0`` additionally emits the NEE emitter-geometry Jacobian
    (12*n_em_cap, rows, W) for the first ``n_em_cap`` emitter ordinals
    (layout ``[k, comp(cx,cy,cz,r), channel]``); ``tri_em_cap > 0``
    (requires ``tri_nee``) emits the triangle-emitter VERTEX Jacobian
    (27*tri_em_cap, rows, W; layout ``[k, comp(v0..v2 xyz), channel]``).
    The return appends ``jac_geo`` then ``jac_tri`` for whichever caps
    are nonzero, then — with ``count_rounds=True`` — the executed
    bounce-round total.

    Residual footprint note: the Jacobian outputs live in device memory
    at ``(9*n_mat + 3 + 12*n_em_cap + 27*tri_em_cap) * rows * width * 4``
    bytes — ~0.25 GB for 15 materials + 1 tracked emitter at 1024^2.
    Size fit workloads accordingly (the custom_vjp holds it from forward
    to backward)."""
    rows = height if rows is None else rows
    th, tw = fk.tile_for(rows, width, tile, shrink=True)
    interpret = backend.kernel_interpret(
        interpret, "render_physical_pallas_fused"
    )

    n_mat = scene.num_materials
    n_j = (12 if rough_grad else 9) * n_mat + 3
    n_geo = max(12 * n_em_cap, 1)
    n_tri_j = max(27 * tri_em_cap, 1)
    kern = partial(
        _phys_fused_kernel,
        th=th, tw=tw,
        n_sph=scene.num_spheres,
        n_tri=scene.num_triangles,
        n_mat=n_mat,
        spp=spp,
        max_bounces=max_bounces,
        jitter=jitter,
        nee=nee,
        n_em_cap=n_em_cap,
        early_exit=early_exit,
        tri_nee=tri_nee,
        tri_em_cap=tri_em_cap,
        count_rounds=count_rounds,
        rough_grad=rough_grad,
        sync=not interpret,
    )
    operands = _phys_operands(
        scene, camera, height, width, seed, sample_offset, row_start
    )
    grid = (rows // th, width // tw)
    out_specs = [
        pl.BlockSpec((n, th, tw), lambda i, j: (0, i, j))
        for n in (3, n_j, n_geo, n_tri_j)
    ]
    out_shape = [
        jax.ShapeDtypeStruct((n, rows, width), jnp.float32)
        for n in (3, n_j, n_geo, n_tri_j)
    ]
    n_h = (max_bounces + 1) * _RECORD_PLANES
    out_specs.append(pl.BlockSpec((n_h, th, tw), lambda i, j: (0, i, j)))
    out_shape.append(jax.ShapeDtypeStruct((n_h, rows, width), jnp.float32))
    if count_rounds:
        out_specs.append(fk.round_count_spec())
        out_shape.append(jax.ShapeDtypeStruct(grid, jnp.int32))
    all_out = pl.pallas_call(
        kern,
        grid=grid,
        in_specs=fk.whole_array_specs(operands),
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=fk.compiler_params(),
        interpret=interpret,
        name="render_physical_pallas_fused",
    )(*operands)
    img, jac, jgeo, jtri = all_out[:4]
    out = (jnp.transpose(img, (1, 2, 0)), jac)
    if n_em_cap:
        out = out + (jgeo,)
    if tri_em_cap:
        out = out + (jtri,)
    if count_rounds:
        out = out + (jnp.sum(all_out[-1]),)
    return out


def _scatter_emitter_geometry(scene: Scene, geo, n_em_cap: int):
    """Sphere cotangent pytree from per-emitter-ordinal rows ``geo``
    ((>=n_em_cap, 4): d_center xyz + d_radius per ordinal): scatter rows
    back onto their sphere indices, zeroing rows beyond the live emitter
    count. Used by the fused contraction."""
    import dataclasses

    d_spheres = jax.tree_util.tree_map(jnp.zeros_like, scene.spheres)
    if not n_em_cap:
        return d_spheres
    em_cum, _, n_em = _emitter_operands(scene)
    ks = jnp.arange(n_em_cap, dtype=jnp.int32)
    sph_idx = jnp.clip(
        jnp.searchsorted(em_cum[:, 0], ks + 1, side="left"),
        0, scene.num_spheres - 1,
    )
    live = (ks < n_em)[:, None]
    d_center = jnp.zeros_like(scene.spheres.center).at[sph_idx].add(
        jnp.where(live, geo[:n_em_cap, 0:3], 0.0)
    )
    d_radius = jnp.zeros_like(scene.spheres.radius).at[sph_idx].add(
        jnp.where(live[:, 0], geo[:n_em_cap, 3], 0.0)
    )
    return dataclasses.replace(d_spheres, center=d_center, radius=d_radius)


def _scatter_tri_emitter_geometry(scene: Scene, geo, tri_em_cap: int):
    """Triangle cotangent pytree from per-tri-emitter-ordinal rows
    ``geo`` ((>=tri_em_cap, 9): d_v0 xyz + d_v1 xyz + d_v2 xyz per
    ordinal): scatter rows back onto their triangle indices, zeroing
    rows beyond the live tri-emitter count. The vertex twin of
    :func:`_scatter_emitter_geometry`."""
    import dataclasses

    d_tri = jax.tree_util.tree_map(jnp.zeros_like, scene.triangles)
    if not tri_em_cap:
        return d_tri
    tri_cum, _, _, n_em_t = _tri_emitter_operands(scene)
    ks = jnp.arange(tri_em_cap, dtype=jnp.int32)
    t_idx = jnp.clip(
        jnp.searchsorted(tri_cum[:, 0], ks + 1, side="left"),
        0, scene.num_triangles - 1,
    )
    live = (ks < n_em_t)[:, None]
    rows = jnp.where(live, geo[:tri_em_cap], 0.0)
    d_v0 = jnp.zeros_like(scene.triangles.v0).at[t_idx].add(rows[:, 0:3])
    d_v1 = jnp.zeros_like(scene.triangles.v1).at[t_idx].add(rows[:, 3:6])
    d_v2 = jnp.zeros_like(scene.triangles.v2).at[t_idx].add(rows[:, 6:9])
    return dataclasses.replace(d_tri, v0=d_v0, v1=d_v1, v2=d_v2)


def contract_physical_jacobian(scene: Scene, jac, g, spp: int,
                               jac_geo=None, jac_tri=None):
    """Scene cotangent pytree (materials + sky, plus NEE emitter geometry
    when ``jac_geo`` is given, plus tri-emitter vertex geometry when
    ``jac_tri`` is given) from the fused physical kernel's Jacobian
    planes and the image cotangent g."""
    import dataclasses

    n_mat = scene.num_materials
    mats = scene.materials
    # per-material plane count encodes whether the kernel emitted the
    # score-function roughness planes (12) or not (9)
    mp = (jac.shape[0] - 3) // n_mat if n_mat else 9
    g_cp = jnp.transpose(g.astype(jnp.float32), (2, 0, 1))
    jm = jac[: mp * n_mat].reshape(
        n_mat, mp // 3, 3, jac.shape[1], jac.shape[2]
    )
    # f32 contractions: no TF32 on the GPU (a reference-grade gradient)
    dot = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    gq = dot("mkchw,chw->mkc", jm, g_cp) / spp
    d_alb = gq[:, 0]
    d_eco = gq[:, 1] * mats.emission_strength[:, None]
    d_est = jnp.sum(gq[:, 1] * mats.emission_color, axis=1)
    d_trn = jnp.sum(gq[:, 2] * mats.albedo, axis=1)
    d_sky = dot("chw,chw->c", jac[mp * n_mat:], g_cp) / spp

    zeros = lambda x: jnp.zeros_like(x)
    d_rgh = (
        jnp.sum(gq[:, 3] * mats.albedo, axis=1)
        if mp == 12 else zeros(mats.roughness)
    )
    d_mats = dataclasses.replace(
        mats,
        albedo=d_alb,
        emission_color=d_eco,
        emission_strength=d_est,
        transparency=d_trn,
        roughness=d_rgh,
        metallicity=zeros(mats.metallicity),
        refractive_index=zeros(mats.refractive_index),
    )
    if jac_geo is not None and jac_geo.shape[0] >= 12:
        n_em_cap = jac_geo.shape[0] // 12
        jg = jac_geo[: 12 * n_em_cap].reshape(
            n_em_cap, 4, 3, jac_geo.shape[1], jac_geo.shape[2]
        )
        geo = dot("kqchw,chw->kq", jg, g_cp) / spp
        d_spheres = _scatter_emitter_geometry(scene, geo, n_em_cap)
    else:
        d_spheres = jax.tree_util.tree_map(zeros, scene.spheres)
    if jac_tri is not None and jac_tri.shape[0] >= 27:
        tri_em_cap = jac_tri.shape[0] // 27
        jt = jac_tri[: 27 * tri_em_cap].reshape(
            tri_em_cap, 9, 3, jac_tri.shape[1], jac_tri.shape[2]
        )
        geo_t = dot("kqchw,chw->kq", jt, g_cp) / spp
        d_triangles = _scatter_tri_emitter_geometry(scene, geo_t,
                                                    tri_em_cap)
    else:
        d_triangles = jax.tree_util.tree_map(zeros, scene.triangles)
    return dataclasses.replace(
        scene,
        materials=d_mats,
        spheres=d_spheres,
        triangles=d_triangles,
        sky_color=d_sky,
    )


def live_emitter_mask(scene: Scene):
    """Host-side per-sphere live-emitter mask (the emitter-pool
    definition `_emitter_operands` encodes in jnp form: active &
    strength > 0), or ``None`` when the scene is traced. The ONE place
    the host-side mask lives — cap sizing (fits, bench) and the cap
    warning all derive from it, so they cannot drift from the kernel's
    emitter table."""
    es = scene.materials.emission_strength
    if isinstance(es, jax.core.Tracer) or isinstance(
        scene.spheres.material, jax.core.Tracer
    ):
        return None
    return np.asarray(scene.spheres.active) & (
        np.asarray(es)[np.asarray(scene.spheres.material)] > 0.0
    )


def live_emitter_count(scene: Scene):
    """Host-side live emitter count, or ``None`` when the scene is
    traced (see :func:`live_emitter_mask`)."""
    em = live_emitter_mask(scene)
    return None if em is None else int(em.sum())


def live_tri_emitter_mask(scene: Scene):
    """Host-side per-triangle live-emitter mask (active & emissive), or
    ``None`` when the scene is traced — the triangle twin of
    :func:`live_emitter_mask` and the ONE place the host-side tri-emitter
    definition lives (mirrors ``_tri_emitter_operands``)."""
    es = scene.materials.emission_strength
    if isinstance(es, jax.core.Tracer) or isinstance(
        scene.triangles.material, jax.core.Tracer
    ):
        return None
    return np.asarray(scene.triangles.active) & (
        np.asarray(es)[np.asarray(scene.triangles.material)] > 0.0
    )


def live_tri_emitter_count(scene: Scene):
    """Host-side live triangle-emitter count, or ``None`` when traced."""
    em = live_tri_emitter_mask(scene)
    return None if em is None else int(em.sum())


def _check_tri_emitter_cap(scene: Scene, tri_em_cap: int):
    """Warn when the scene has more live TRIANGLE emitters than the
    vertex-geometry cap tracks (ordinals >= tri_em_cap get exactly-zero
    vertex cotangents by contract — the tri twin of
    :func:`_check_emitter_cap`). Returns the live count (None when
    traced)."""
    import warnings

    n_em_t = live_tri_emitter_count(scene)
    if n_em_t is None:
        return None
    if n_em_t > tri_em_cap:
        warnings.warn(
            f"scene has {n_em_t} emissive triangles but the vertex "
            f"cotangent cap is tri_em_cap={tri_em_cap}: tri-emitter "
            f"ordinals >= {tri_em_cap} receive exactly-zero vertex "
            "gradients. Pass a larger tri_em_cap to track them.",
            stacklevel=3,
        )
    return n_em_t


def _check_emitter_cap(scene: Scene, n_em_cap: int, raise_: bool = False):
    """Warn (or raise) when the scene has more live emitters than the
    geometry cap tracks — emitter ordinals >= n_em_cap get exactly-zero
    center/radius cotangents by contract, which would otherwise silently
    freeze those lights in a fit. Checkable only when
    the scene is concrete (under jit tracing the emitter count is a
    tracer; callers holding concrete scenes — fits, benches — see it).
    Returns the live count (None when traced)."""
    import warnings

    n_em = live_emitter_count(scene)
    if n_em is None:
        return None
    if n_em > n_em_cap:
        msg = (
            f"scene has {n_em} emissive spheres but the NEE geometry "
            f"cotangent cap is n_em_cap={n_em_cap}: emitter ordinals >= "
            f"{n_em_cap} receive exactly-zero center/radius gradients. "
            "Pass a larger n_em_cap to track them."
        )
        if raise_:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)
    return n_em


def _emitter_operands(scene: Scene):
    """Host-side emissive-sphere table: (cumulative emitter count (S,1)
    i32, premultiplied emitter radiance (S,3) f32, n_em scalar i32) —
    mirrors models/physical.py:96-98."""
    mats = scene.materials
    sph = scene.spheres
    em_mask = sph.active & (mats.emission_strength[sph.material] > 0.0)
    em_cum = jnp.cumsum(em_mask.astype(jnp.int32))
    n_em = jnp.sum(em_mask.astype(jnp.int32))
    le_sph = (
        mats.emission_color[sph.material]
        * mats.emission_strength[sph.material][:, None]
    )
    return em_cum[:, None], le_sph.astype(jnp.float32), n_em


def _tri_emitter_operands(scene: Scene):
    """Host-side emissive-TRIANGLE table for tri_nee: cumulative emitter
    count (T,1) i32, premultiplied radiance (T,3) f32, area (T,1) f32,
    live count. Mirrors models/physical.py's tri_nee tables (same mask,
    same area formula) so the Pallas pick/sample matches core."""
    mats = scene.materials
    tri = scene.triangles
    em_mask = tri.active & (mats.emission_strength[tri.material] > 0.0)
    tri_cum = jnp.cumsum(em_mask.astype(jnp.int32))
    n_em_t = jnp.sum(em_mask.astype(jnp.int32))
    le_tri = (
        mats.emission_color[tri.material]
        * mats.emission_strength[tri.material][:, None]
    )
    cr = jnp.cross(tri.v1 - tri.v0, tri.v2 - tri.v0)
    area = 0.5 * jnp.sqrt(jnp.maximum(jnp.sum(cr * cr, -1), 1e-20))
    return (tri_cum[:, None], le_tri.astype(jnp.float32),
            area.astype(jnp.float32)[:, None], n_em_t)


def _phys_operands(scene, camera, height, width, seed, sample_offset,
                   row_start):
    em_cum, le_sph, n_em = _emitter_operands(scene)
    tri_cum, le_tri, tri_area, n_em_t = _tri_emitter_operands(scene)
    par_i = jnp.stack(
        [jnp.asarray(seed, jnp.uint32).astype(jnp.int32),
         jnp.asarray(sample_offset, jnp.int32),
         jnp.asarray(row_start, jnp.int32),
         n_em.astype(jnp.int32),
         n_em_t.astype(jnp.int32)]
    )[None, :]
    return fk._scene_operands(scene) + [
        em_cum,
        le_sph,
        tri_cum,
        le_tri,
        tri_area,
        fk._camera_params(camera, scene, height, width),
        par_i,
    ]


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "spp", "max_bounces", "tile", "interpret", "rows",
        "jitter", "nee", "count_rounds", "early_exit", "tri_nee",
    ),
)
def render_physical_pallas(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset=0,
    tile: tuple[int, int] = PHYS_TILE,
    interpret: bool = False,
    row_start=0,
    rows: int | None = None,
    jitter: bool = True,
    nee: bool = True,
    count_rounds: bool = False,
    early_exit: bool | str = "once",
    tri_nee: bool = False,
):
    """Physical-tier radiance image (rows, W, 3) f32 via the Pallas
    megakernel — the fast path for ``models/physical.render_physical``
    (identical estimator, identical RNG streams; interpreter-mode parity
    is pinned by tests/test_pallas_physical.py). Same sharding contract as
    ``render_pallas``: ``row_start``/``rows`` select a row block with
    global-index RNG. ``count_rounds=True`` returns
    ``(img, executed_rounds)`` like ``render_pallas``."""
    rows = height if rows is None else rows
    th, tw = fk.tile_for(rows, width, tile)
    interpret = backend.kernel_interpret(interpret, "render_physical_pallas")

    kern = partial(
        _phys_kernel,
        th=th,
        tw=tw,
        n_sph=scene.num_spheres,
        n_tri=scene.num_triangles,
        n_mat=scene.num_materials,
        spp=spp,
        max_bounces=max_bounces,
        jitter=jitter,
        nee=nee,
        count_rounds=count_rounds,
        early_exit=early_exit,
        tri_nee=tri_nee,
    )
    operands = _phys_operands(
        scene, camera, height, width, seed, sample_offset, row_start
    )
    grid = (rows // th, width // tw)
    out_specs = [pl.BlockSpec((3, th, tw), lambda i, j: (0, i, j))]
    out_shape = [jax.ShapeDtypeStruct((3, rows, width), jnp.float32)]
    if count_rounds:
        out_specs.append(fk.round_count_spec())
        out_shape.append(jax.ShapeDtypeStruct(grid, jnp.int32))
    out = pl.pallas_call(
        kern,
        grid=grid,
        in_specs=fk.whole_array_specs(operands),
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=fk.compiler_params(),
        interpret=interpret,
        name="render_physical_pallas",
    )(*operands)
    img = jnp.transpose(out[0], (1, 2, 0))
    if count_rounds:
        return img, jnp.sum(out[1])
    return img


# -- differentiable wrapper: Pallas forward + Pallas material backward ------


@partial(jax.custom_vjp,
         nondiff_argnums=(2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13))
def _render_physical_pallas_vjp(
    scene, camera, height, width, spp, max_bounces, rows, jitter, nee,
    geo_cap, tri_nee, tri_geo_cap, rough_grad, interpret, seed,
    sample_offset, row_start,
):
    return render_physical_pallas(
        scene, camera, height, width, spp, max_bounces, seed,
        sample_offset=sample_offset, row_start=row_start, rows=rows,
        jitter=jitter, nee=nee, tri_nee=tri_nee, interpret=interpret,
    )


def _vjp_fwd(
    scene, camera, height, width, spp, max_bounces, rows, jitter, nee,
    geo_cap, tri_nee, tri_geo_cap, rough_grad, interpret, seed,
    sample_offset, row_start,
):
    # One fused primal+Jacobian kernel either way (no ray traced twice);
    # geo_cap > 0 adds the in-bounce NEE emitter-geometry planes and
    # tri_geo_cap > 0 the triangle-emitter vertex planes.
    out_all = render_physical_pallas_fused(
        scene, camera, height, width, spp, max_bounces, seed,
        sample_offset=sample_offset, row_start=row_start, rows=rows,
        jitter=jitter, nee=nee, n_em_cap=geo_cap, tri_nee=tri_nee,
        tri_em_cap=tri_geo_cap, rough_grad=rough_grad, interpret=interpret,
    )
    out, jac = out_all[0], out_all[1]
    rest = list(out_all[2:])
    jgeo = rest.pop(0) if geo_cap else None
    jtri = rest.pop(0) if tri_geo_cap else None
    return out, (scene, camera, jac, jgeo, jtri)


def _vjp_bwd(height, width, spp, max_bounces, rows, jitter, nee, geo_cap,
             tri_nee, tri_geo_cap, rough_grad, interpret, res, g):
    scene, camera, jac, jgeo, jtri = res
    d_scene = contract_physical_jacobian(scene, jac, g, spp, jac_geo=jgeo,
                                         jac_tri=jtri)
    d_scene = fk._float0_ints(d_scene, scene)
    # Camera cotangents are ZERO BY CONTRACT — an approximation in this
    # tier: the reference tier's radiance really is piecewise-constant in
    # camera pose (pallas_kernels.py), but the physical tier's NEE cosine
    # and solid-angle factors vary continuously with the primary ray, so
    # core AD would return nonzero d_camera here. Camera-pose fits must
    # use models/physical.render_physical under jax.grad (documented in
    # render_physical_pallas_vjp; pinned by
    # tests/test_pallas_physical.py::test_phys_vjp_camera_cotangent_contract).
    d_camera = jax.tree_util.tree_map(jnp.zeros_like, camera)
    return d_scene, d_camera, None, None, None


_render_physical_pallas_vjp.defvjp(_vjp_fwd, _vjp_bwd)


def render_physical_pallas_vjp(
    scene, camera, height, width, spp, max_bounces, seed,
    sample_offset=0, row_start=0, rows: int | None = None,
    jitter: bool = True, nee: bool = True, geom: bool = True,
    n_em_cap: int | None = None, tri_nee: bool = False,
    tri_em_cap: int | None = None, rough_grad: bool = False,
    interpret: bool = False,
):
    """Differentiable physical-tier fast render (fused primal+Jacobian).
    ``rough_grad=True`` adds the score-function roughness planes (3 per
    material), making the roughness cotangent the same unbiased
    REINFORCE estimate as the core path's ``rough_grad`` — the primal
    stays bit-identical, since the lobe factor is exactly 1.

    Albedo, emission, transparency and sky cotangents match core AD in
    both modes. ``geom=True`` (default) also emits NEE emitter-geometry
    cotangents: sampled SPHERE emitter center/radius through the cone
    weight for the first ``n_em_cap`` emitter ordinals (default
    ``min(num_spheres, 8)``), and — with ``tri_nee=True`` — sampled
    TRIANGLE emitter vertices through the area/cos/d^2 weight for the
    first ``tri_em_cap`` tri-emitter ordinals (default
    ``min(num_triangles, 8)``). Both caps clamp to the scene's live
    emitter counts when concrete, and more live emitters than a cap
    warns. ``geom=False`` skips all geometry planes (slightly cheaper;
    use for material-only fits and sharded material training —
    grad/diff and parallel/render pass it automatically).

    Contract vs core AD (tests/test_pallas_physical.py): geometry
    cotangents carry ONLY the NEE emitter chains — continuation terms
    (hit points/normals of struck surfaces) and non-emitter geometry are
    zero; **camera cotangents are zero** even though the physical tier's
    NEE terms do vary continuously with the primary ray — a camera-pose
    fit through this wrapper would silently not move, so use core AD
    (``models/physical.render_physical``) or the FD driver
    (``grad/diff.fit_camera``) for camera fits.
    """
    rows = height if rows is None else rows
    if n_em_cap is None:
        n_em_cap = min(scene.num_spheres, 8)
    geo_cap = int(n_em_cap) if (geom and nee) else 0
    if geo_cap:
        n_live = _check_emitter_cap(scene, geo_cap)
        if n_live is not None:
            # concrete scene: tracking more ordinals than live emitters
            # only buys provably-zero planes (12 per ordinal, each an
            # O(rows*width) device-memory residual + a masked RMW loop
            # per bounce) — clamp the cap down to the real count
            geo_cap = min(geo_cap, n_live)
    if tri_em_cap is None:
        tri_em_cap = min(scene.num_triangles, 8)
    tri_geo_cap = int(tri_em_cap) if (geom and nee and tri_nee) else 0
    if tri_geo_cap:
        n_live_t = _check_tri_emitter_cap(scene, tri_geo_cap)
        if n_live_t is not None:
            tri_geo_cap = min(tri_geo_cap, n_live_t)
    return _render_physical_pallas_vjp(
        scene, camera, height, width, spp, max_bounces, rows, jitter, nee,
        geo_cap, tri_nee, tri_geo_cap, rough_grad, interpret,
        jnp.asarray(seed, jnp.uint32),
        jnp.asarray(sample_offset, jnp.int32),
        jnp.asarray(row_start, jnp.int32),
    )
