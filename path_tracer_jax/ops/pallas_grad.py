"""Fused primal + Jacobian Pallas kernel for the path-trace VJP.

Reverse-mode through the XLA core integrator materialises every bounce's
all-pairs intersection tensors for the backward pass. Here **one kernel
emits the primal image AND a per-pixel material Jacobian**, and the
backward becomes a small XLA contraction of the upstream cotangent ``g``
with that Jacobian — no ray is traced twice.

Why a per-pixel Jacobian is exact and small: per sample, radiance is
``total[c] = sum_b P_b[c] * E_b[c] + P_end[c] * sky[c]`` where ``P_b`` is
the prefix product of ``albedo * ratio`` along the path and ``E_b`` the
bounce's emission (or sky on a miss). All *continuous* scene dependence
lives in the albedo/emission/transparency/sky factors — material indices,
hit distances, normals and directions enter only through discrete events,
so their cotangents are exactly zero (the AD tests pin this down). Every
material cotangent is therefore **linear in g** with per-pixel weights:

    d_albedo[m,c]   = sum_p g[p,c] * A[m,c,p] / spp
    d_eco[m,c]      = es_m  * sum_p g[p,c] * S[m,c,p] / spp
    d_est[m]        = sum_c ec_mc * sum_p g[p,c] * S[m,c,p] / spp
    d_transp[m]     = sum_c al_mc * sum_p g[p,c] * R[m,c,p] / spp
    d_sky[c]        = sum_p g[p,c] * K[c,p] / spp

with the weight planes accumulated over samples and bounces:

    A[m,c] = sum_b [mat_b=m, hit] P_b[c] * T_b[c]       (albedo)
    S[m,c] = sum_b [mat_b=m, hit] P_b[c]                (emission)
    R[m,c] = sum_b [mat_b=m, hit] P_b[c] * T_b[c] * dr_b (transparency,
             ratio reparameterization: dr = 1/t on refract, -1/(1-t) on
             reflect)
    K[c]   = sum_b [miss] P_b[c]  +  P_end[c]           (sky)

``T_b[c]`` — the suffix "radiance collected after bounce b per unit
throughput" — is built by an in-kernel suffix sweep (``T_{b-1} = Le_b +
albedo_b * T_b`` on surviving lanes, 0 after a TIR death, sky at a miss)
over per-bounce records made while the kernel runs the forward once (the
forward IS the replay, and also emits the primal tile). Each program
writes its records to its own tile of a device-memory history buffer
(an extra output, ``(max_bounces + 1) * 14`` planes) and reads them back
in the sweep: the bounce loop stays rolled, so the kernel compiles in
seconds, and each program re-reads only what it wrote. (An unrolled loop
holding the records in registers ran up to 1.6x faster per step on the
H100 but compiled for minutes at 8 bounces — PERF.md.) The
zero-albedo subtlety is preserved: a lane killed by an exactly-zero
albedo has P == 0 downstream yet its albedo cotangent ``g*P_b*T_b`` needs
``T_b`` built from the future path, so the bounce budget ends only on
*structural* deaths (miss / TIR), never on zero throughput.

``jax.grad`` through :func:`pallas_kernels.render_pallas_vjp` runs the
fused kernel in the custom_vjp's fwd rule (primal + Jacobian residual)
and the contraction in the bwd rule. Supports the default "gpu" variant,
with or without anti-aliasing jitter and row-block sharding
(``row_start``/``rows``); the "cpu" tier (whose per-sample clamp breaks
the product structure) falls back to core-path AD.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .. import backend
from ..scene.scene import Scene
from ..ops.camera import Camera
from . import pallas_kernels as fk

__all__ = [
    "render_pallas_fused", "render_pallas_bwd", "contract_jacobian",
    "FUSED_TILE",
]

# Pixel tile of the fused kernel: the best of a sweep on the H100 at
# config 4's fit shape (PERF.md).
FUSED_TILE = (4, 32)

# Per-material Jacobian planes: A[3] + S[3] + R[3] (module docstring).
_MAT_J_PLANES = 9
# Planes of one round record: P[3], 3 masks, material, albedo[3], Le[3], dr.
_RECORD_PLANES = 14


def _fused_kernel(
    sph_c, sph_r, sph_m, sph_a,
    tri_v0, tri_v1, tri_v2, tri_n, tri_m, tri_a,
    m_alb, m_eco, m_est, m_rgh, m_trn, m_ior,
    par_f, par_i,
    img_ref,  # (3, TH, TW): primal radiance tile (mean over spp)
    j_ref,  # (9*M + 3, TH, TW): Jacobian planes; last 3 = sky K
    h_ref,  # ((B+1) * 14, TH, TW): round records (the history buffer)
    *maybe_cnt,  # with count_rounds: (1, 1) i32 rounds this program ran
    th, tw, n_sph, n_tri, n_mat, spp, max_bounces, jitter, mat_skip,
    early_exit="once",
    count_rounds=False,
    sync=False,
):
    ti = pl.program_id(0)
    tj = pl.program_id(1)

    tan2 = par_f[0, 0]
    aspect = par_f[0, 1]
    width = par_f[0, 2]
    height = par_f[0, 3]
    sky_r, sky_g, sky_b = par_f[0, 4], par_f[0, 5], par_f[0, 6]
    cox, coy, coz = par_f[0, 7], par_f[0, 8], par_f[0, 9]
    crx, cry, crz = par_f[0, 10], par_f[0, 11], par_f[0, 12]
    cux, cuy, cuz = par_f[0, 13], par_f[0, 14], par_f[0, 15]
    cfx, cfy, cfz = par_f[0, 16], par_f[0, 17], par_f[0, 18]
    seed = par_i[0, 0].astype(jnp.uint32)
    sample_offset = par_i[0, 1]
    row_start = par_i[0, 2]  # global row of this kernel's first row (sharding)

    rows = (
        jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0) + ti * th + row_start
    )
    cols = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1) + tj * tw
    pix = (rows * width.astype(jnp.int32) + cols).astype(jnp.uint32)

    x = (cols.astype(jnp.float32) + 0.5) / width * 2.0 - 1.0
    y = -((rows.astype(jnp.float32) + 0.5) / height * 2.0 - 1.0)
    dcx = x * tan2
    dcy = y * tan2 / aspect
    pdx = dcx * crx + dcy * cux + cfx
    pdy = dcx * cry + dcy * cuy + cfy
    pdz = dcx * crz + dcy * cuz + cfz
    pn = jax.lax.rsqrt(pdx * pdx + pdy * pdy + pdz * pdz)
    pdx, pdy, pdz = pdx * pn, pdy * pn, pdz * pn

    zero = jnp.zeros((th, tw), jnp.float32)
    ones = jnp.ones((th, tw), jnp.float32)
    n_j = _MAT_J_PLANES * n_mat + 3
    sky_base = _MAT_J_PLANES * n_mat

    # zero the Jacobian output block (accumulated across samples/bounces)
    def zero_j(k, _):
        j_ref[k] = zero
        return None

    jax.lax.fori_loop(0, n_j, zero_j, None)

    closest_hit, fetch_materials, _ = fk.make_geometry(
        sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m,
        tri_a, m_alb, m_eco, m_est, m_rgh, m_trn, m_ior,
        (sky_r, sky_g, sky_b), th, tw, n_sph, n_tri, n_mat,
    )

    cam_ox = jnp.full((th, tw), cox)
    cam_oy = jnp.full((th, tw), coy)
    cam_oz = jnp.full((th, tw), coz)
    if not jitter:
        hit0 = closest_hit(cam_ox, cam_oy, cam_oz, pdx, pdy, pdz)
        mats0 = fetch_materials(hit0[4])
    # whole-tile sky gate (see pallas_kernels._kernel): sound only when
    # bounce 0 is sample-invariant
    tile_gate = early_exit == "once" and not jitter

    def fwd_round(b, fc):
        """One bounce of the forward (= replay). Returns the next state and
        this round's history record, the values the suffix sweep reads:
        P[3], hit/miss/TIR masks (f32 0/1), material, albedo[3], Le[3],
        transparency ratio derivative.

        Dead lanes trace garbage, but every contribution their garbage
        could make is multiplied by the recorded prefix P == 0, and the
        sweep's carry for a dead lane is re-anchored at the bounce where
        the real death event is recorded, so later corruption never
        propagates past it. The bounce budget cannot end on zero
        throughput: a lane killed by an exactly-zero albedo has P == 0
        downstream yet its albedo cotangent g*P_b*T_b needs T_b built from
        the *untraced future* path, so only structural deaths (miss / TIR)
        end it — tracked in ``done`` (f32 0/1)."""
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, rng, done) = fc
        if isinstance(b, int) and b == 0 and not jitter:
            hit, mats = hit0, mats0
        else:
            hit = closest_hit(ox, oy, oz, dx, dy, dz)
            mats = fetch_materials(hit[4])
        bt, nx, ny, nz, mat = hit
        hitmask = bt < fk._INF
        P = (tr, tg, tb)
        (alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior) = mats

        # primal: sky on miss, Le then albedo on hit
        # (rtx_frag.glsl:226-230); miss lanes terminate by zeroed
        # throughput.
        ar = ar + jnp.where(hitmask, tr * em_r, tr * sky_r)
        ag = ag + jnp.where(hitmask, tg * em_g, tg * sky_g)
        ab = ab + jnp.where(hitmask, tb * em_b, tb * sky_b)
        tr = jnp.where(hitmask, tr * alb_r, 0.0)
        tg = jnp.where(hitmask, tg * alb_g, 0.0)
        tb = jnp.where(hitmask, tb * alb_b, 0.0)

        rng, (sx_, sy_, sz_) = fk._unit_sphere(rng)
        rng, u_branch = fk._uniform(rng)

        wnx = nx + rgh * sx_
        wny = ny + rgh * sy_
        wnz = nz + rgh * sz_
        wn = jax.lax.rsqrt(
            jnp.maximum(wnx * wnx + wny * wny + wnz * wnz, 1e-20)
        )
        wnx, wny, wnz = wnx * wn, wny * wn, wnz * wn

        ndot = dx * wnx + dy * wny + dz * wnz
        rfx = dx - 2.0 * ndot * wnx
        rfy = dy - 2.0 * ndot * wny
        rfz = dz - 2.0 * ndot * wnz
        entering = ndot < 0.0
        eta = jnp.where(entering, 1.0 / ior, ior)
        rnx = jnp.where(entering, wnx, -wnx)
        rny = jnp.where(entering, wny, -wny)
        rnz = jnp.where(entering, wnz, -wnz)
        ni = rnx * dx + rny * dy + rnz * dz
        k = 1.0 - eta * eta * (1.0 - ni * ni)
        tirm = k < 0.0
        # matches ops/sampling.refract's guarded sqrt (see there)
        ksafe = jnp.where(tirm, 1.0, jnp.maximum(k, 1e-12))
        coef = eta * ni + jnp.sqrt(ksafe)
        txx = jnp.where(tirm, 0.0, eta * dx - coef * rnx)
        txy = jnp.where(tirm, 0.0, eta * dy - coef * rny)
        txz = jnp.where(tirm, 0.0, eta * dz - coef * rnz)

        choose_refr = u_branch < trn
        ndx = jnp.where(choose_refr, txx, rfx)
        ndy = jnp.where(choose_refr, txy, rfy)
        ndz = jnp.where(choose_refr, txz, rfz)
        died = choose_refr & tirm

        # Dead lanes record garbage events here, but the sweep
        # multiplies every contribution by their recorded P == 0 and
        # re-anchors the carry at the real death event, so un-gated
        # records are exact. The transparency ratio derivative
        # (reparameterization): the estimator's per-bounce factor is
        # albedo * ratio with ratio = t/t_detached (refract) or
        # (1-t)/(1-t)_detached (reflect).
        rec = (
            P,
            jnp.where(hitmask, 1.0, 0.0),
            jnp.where(hitmask, 0.0, 1.0),
            jnp.where(died & hitmask, 1.0, 0.0),
            mat,
            (alb_r, alb_g, alb_b),
            (em_r, em_g, em_b),
            jnp.where(
                choose_refr,
                1.0 / jnp.maximum(trn, 1e-6),
                -1.0 / jnp.maximum(1.0 - trn, 1e-6),
            ),
        )

        # Structural death this bounce: miss or TIR. Zero albedo is
        # NOT a death (see the docstring).
        done = jnp.maximum(done, jnp.where(hitmask & ~died, 0.0, 1.0))

        tr = jnp.where(died, 0.0, tr)
        tg = jnp.where(died, 0.0, tg)
        tb = jnp.where(died, 0.0, tb)
        ndx = jnp.where(died, dx, ndx)
        ndy = jnp.where(died, dy, ndy)
        ndz = jnp.where(died, dz, ndz)

        px = ox + jnp.where(hitmask, bt, 0.0) * dx
        py = oy + jnp.where(hitmask, bt, 0.0) * dy
        pz = oz + jnp.where(hitmask, bt, 0.0) * dz
        offs = fk.DEFAULT_EPS_OFFSET + fk.EPS_OFFSET_SCALE * jnp.sqrt(
            px * px + py * py + pz * pz
        )
        side = jnp.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
        fc = (px + offs * side * nx, py + offs * side * ny,
              pz + offs * side * nz, ndx, ndy, ndz, tr, tg, tb,
              ar, ag, ab, rng, done)
        return fc, rec

    # The structure and dtypes of one round record (the sweep reads the
    # records back from the history buffer in this shape).
    izero = jnp.zeros((th, tw), jnp.int32)
    record_like = ((zero, zero, zero), zero, zero, zero, izero,
                   (zero, zero, zero), (zero, zero, zero), zero)

    def sweep_round(rec, T):
        """One suffix-sweep step: accumulate this round's Jacobian planes
        and carry T_{b-1} = Le_b + albedo_b * T_b (hit), sky (miss),
        pass-through (lane already dead — value never consumed)."""
        (P, hitf, missf, tirf, mat, alb, le, dr_b) = rec
        Tr, Tg, Tb = T
        hitm = hitf > 0.0
        missm = missf > 0.0
        tirm = tirf > 0.0
        Pr = jnp.where(hitm | missm, P[0], 0.0)
        Pg = jnp.where(hitm | missm, P[1], 0.0)
        Pb_ = jnp.where(hitm | missm, P[2], 0.0)

        # TIR lanes have no downstream throughput cotangent.
        Tr_h = jnp.where(tirm, 0.0, Tr)
        Tg_h = jnp.where(tirm, 0.0, Tg)
        Tb_h = jnp.where(tirm, 0.0, Tb)

        # sky weight K from misses at this bounce
        j_ref[sky_base + 0] = j_ref[sky_base + 0] + jnp.where(missm, Pr, 0.0)
        j_ref[sky_base + 1] = j_ref[sky_base + 1] + jnp.where(missm, Pg, 0.0)
        j_ref[sky_base + 2] = j_ref[sky_base + 2] + jnp.where(missm, Pb_, 0.0)

        # per-lane weight pieces (hit lanes only)
        cAr = jnp.where(hitm, Pr * Tr_h, 0.0)
        cAg = jnp.where(hitm, Pg * Tg_h, 0.0)
        cAb = jnp.where(hitm, Pb_ * Tb_h, 0.0)
        cSr = jnp.where(hitm, Pr, 0.0)
        cSg = jnp.where(hitm, Pg, 0.0)
        cSb = jnp.where(hitm, Pb_, 0.0)
        dr = jnp.where(hitm, dr_b, 0.0)
        cRr = cAr * dr
        cRg = cAg * dr
        cRb = cAb * dr

        # accumulate per material. The weight planes are already zero
        # off their event masks, so the material mask alone (no & hitm)
        # segregates exactly. ``mat_skip`` guards each material's 9
        # read-modify-writes behind a tile-level presence test (a
        # block-wide reduce per material).
        def mat_body(mi, _):
            mskf = jnp.where(mat == mi, 1.0, 0.0)

            def accumulate():
                base = _MAT_J_PLANES * mi
                j_ref[base + 0] = j_ref[base + 0] + mskf * cAr
                j_ref[base + 1] = j_ref[base + 1] + mskf * cAg
                j_ref[base + 2] = j_ref[base + 2] + mskf * cAb
                j_ref[base + 3] = j_ref[base + 3] + mskf * cSr
                j_ref[base + 4] = j_ref[base + 4] + mskf * cSg
                j_ref[base + 5] = j_ref[base + 5] + mskf * cSb
                j_ref[base + 6] = j_ref[base + 6] + mskf * cRr
                j_ref[base + 7] = j_ref[base + 7] + mskf * cRg
                j_ref[base + 8] = j_ref[base + 8] + mskf * cRb

            if mat_skip:
                hit_here = jnp.where(mat == mi, hitf, 0.0)
                pl.when(jnp.max(hit_here) > 0.0)(accumulate)
            else:
                accumulate()
            return None

        fk._scene_loop(n_mat, mat_body, None)

        Lr = jnp.where(hitm, le[0], 0.0)
        Lg = jnp.where(hitm, le[1], 0.0)
        Lb = jnp.where(hitm, le[2], 0.0)
        Ar = jnp.where(hitm, alb[0], 0.0)
        Ag = jnp.where(hitm, alb[1], 0.0)
        Ab = jnp.where(hitm, alb[2], 0.0)
        Tr = jnp.where(hitm, Lr + Ar * Tr_h, jnp.where(missm, sky_r, Tr))
        Tg = jnp.where(hitm, Lg + Ag * Tg_h, jnp.where(missm, sky_g, Tg))
        Tb = jnp.where(hitm, Lb + Ab * Tb_h, jnp.where(missm, sky_b, Tb))
        return (Tr, Tg, Tb)

    # T0 = sky is only read by lanes alive at the end of the budget;
    # dead lanes re-anchor their carry at their death bounce.
    T0 = (jnp.full((th, tw), sky_r), jnp.full((th, tw), sky_g),
          jnp.full((th, tw), sky_b))

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
            # Anti-aliasing replay: same 2 draws + draw order as
            # primary_rays(jitter_state) (ops/camera.py:123-131).
            st, jx = fk._uniform(st)
            st, jy = fk._uniform(st)
            xj = (cols.astype(jnp.float32) + jx) / width * 2.0 - 1.0
            yj = -((rows.astype(jnp.float32) + jy) / height * 2.0 - 1.0)
            djx = xj * tan2
            djy = yj * tan2 / aspect
            sdx = djx * crx + djy * cux + cfx
            sdy = djx * cry + djy * cuy + cfy
            sdz = djx * crz + djy * cuz + cfz
            sn = jax.lax.rsqrt(sdx * sdx + sdy * sdy + sdz * sdz)
            sdx, sdy, sdz = sdx * sn, sdy * sn, sdz * sn
        else:
            sdx, sdy, sdz = pdx, pdy, pdz

        fc = (
            cam_ox, cam_oy, cam_oz, sdx, sdy, sdz,
            ones, ones, ones, zero, zero, zero, st, zero,
        )
        # The forward rounds (the structural-death early-exit schemes of
        # pallas_kernels.rolled_rounds), each writing its round record to
        # this program's tile of the history buffer.
        fc, bend = fk.rolled_rounds(fwd_round, fc, h_ref, max_bounces,
                                    early_exit, lambda f, rec: f[13])
        # Budget exhausted -> sky weight K (dead lanes carry P == 0, so no
        # mask is needed); then sweep the executed rounds, last to first.
        for c in range(3):
            j_ref[sky_base + c] = j_ref[sky_base + c] + fc[6 + c]
        if sync:
            pl_triton.debug_barrier()

        def bwd(i, T):
            rec = fk.load_record(h_ref, bend - 1 - i, record_like)
            return sweep_round(rec, T)

        jax.lax.fori_loop(0, bend, bwd, T0)

        # Sum into ar BEFORE the accumulator add — the same association
        # the forward kernel uses, keeping the primal bit-identical.
        ar = fc[9] + fc[6] * sky_r
        ag = fc[10] + fc[7] * sky_g
        ab = fc[11] + fc[8] * sky_b
        out = (acc_r + ar, acc_g + ag, acc_b + ab)
        if count_rounds:
            return out + (acc_img[3] + bend,)
        return out

    acc0 = (zero, zero, zero) + (
        (jnp.int32(0),) if count_rounds else ()
    )
    if tile_gate:
        # Whole-tile sky gate (pallas_kernels._kernel): all primaries
        # miss -> every sample's primal is exactly sky and the ONLY
        # nonzero Jacobian entry is the sky weight K += P_0 == 1 per
        # sample (the sweep's single miss round). The gated branch
        # replays that arithmetic exactly: sequential ones-sums equal a
        # single +spp for integer-valued f32 (spp << 2^24), and the
        # sequential acc += sky matches the live path's rounding.
        tile_alive = jnp.max(jnp.where(hit0[0] < fk._INF, 1.0, 0.0)) > 0.0

        def run_sky():
            sppf = jnp.float32(spp)
            for c in range(3):
                j_ref[sky_base + c] = j_ref[sky_base + c] + sppf * ones

            def sbody(s, a):
                # gated sky tiles report 0 executed rounds (same
                # convention as the forward kernels' counter)
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
        "rows", "jitter", "mat_skip", "early_exit", "count_rounds",
    ),
)
def render_pallas_fused(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset=0,
    tile=FUSED_TILE,
    interpret: bool = False,
    row_start=0,
    rows: int | None = None,
    jitter: bool = False,
    mat_skip: bool = False,
    early_exit: bool | str = "once",
    count_rounds: bool = False,
):
    """Primal radiance image (rows, W, 3) PLUS its per-pixel material
    Jacobian (9*M+3, rows, W) in one kernel pass (module docstring).
    ``count_rounds=True`` appends the executed bounce-round total (the
    replay loop's rounds) to the return: ``(img, jac, executed_rounds)``.

    The Jacobian output is an O(n_mat * rows * width) device array —
    ``(9*n_mat + 3) * rows * width * 4`` bytes (~0.5 GB at 1024^2 with
    15 materials); the VJP holds it as its residual from forward to
    backward, so size fit workloads accordingly.

    The Jacobian rows are, per material m: A[3] (albedo), S[3] (emission),
    R[3] (transparency), then 3 sky-K planes; contract with the image
    cotangent via :func:`contract_jacobian`. ``row_start``/``rows`` select
    a row block with global-index RNG, so the pair runs per shard under
    ``shard_map``."""
    rows = height if rows is None else rows
    th, tw = fk.tile_for(rows, width, tile, shrink=True)
    interpret = backend.kernel_interpret(interpret, "render_pallas_fused")

    n_mat = scene.num_materials
    n_j = _MAT_J_PLANES * n_mat + 3
    kern = partial(
        _fused_kernel,
        th=th, tw=tw,
        n_sph=scene.num_spheres,
        n_tri=scene.num_triangles,
        n_mat=n_mat,
        spp=spp,
        max_bounces=max_bounces,
        jitter=jitter,
        mat_skip=mat_skip,
        early_exit=early_exit,
        count_rounds=count_rounds,
        sync=not interpret,
    )
    par_i = jnp.stack(
        [jnp.asarray(seed, jnp.uint32).astype(jnp.int32),
         jnp.asarray(sample_offset, jnp.int32),
         jnp.asarray(row_start, jnp.int32)]
    )[None, :]

    operands = fk._scene_operands(scene) + [
        fk._camera_params(camera, scene, height, width),
        par_i,
    ]
    grid = (rows // th, width // tw)
    out_specs = [
        pl.BlockSpec((3, th, tw), lambda i, j: (0, i, j)),
        pl.BlockSpec((n_j, th, tw), lambda i, j: (0, i, j)),
    ]
    out_shape = [
        jax.ShapeDtypeStruct((3, rows, width), jnp.float32),
        jax.ShapeDtypeStruct((n_j, rows, width), jnp.float32),
    ]
    n_h = (max_bounces + 1) * _RECORD_PLANES
    out_specs.append(pl.BlockSpec((n_h, th, tw), lambda i, j: (0, i, j)))
    out_shape.append(jax.ShapeDtypeStruct((n_h, rows, width), jnp.float32))
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
        name="render_pallas_fused",
    )(*operands)
    img = jnp.transpose(out[0], (1, 2, 0))
    if count_rounds:
        return img, out[1], jnp.sum(out[-1])
    return img, out[1]


def contract_jacobian(scene: Scene, jac, g, spp: int):
    """Scene cotangent pytree from the fused kernel's Jacobian and the
    image cotangent ``g`` (rows, W, 3) — the whole backward pass is this
    contraction (a few fused elementwise-reduce ops in XLA)."""
    n_mat = scene.num_materials
    mats = scene.materials
    g_cp = jnp.transpose(g.astype(jnp.float32), (2, 0, 1))  # (3, rows, W)
    # (m, kind{A,S,R}, c): contract every material plane with its channel
    jm = jac[: _MAT_J_PLANES * n_mat].reshape(
        n_mat, 3, 3, jac.shape[1], jac.shape[2]
    )
    # f32 contractions: no TF32 on the GPU (a reference-grade gradient)
    hi = jax.lax.Precision.HIGHEST
    gq = jnp.einsum("mkchw,chw->mkc", jm, g_cp, precision=hi) / spp
    d_alb = gq[:, 0]
    d_eco = gq[:, 1] * mats.emission_strength[:, None]
    d_est = jnp.sum(gq[:, 1] * mats.emission_color, axis=1)
    d_trn = jnp.sum(gq[:, 2] * mats.albedo, axis=1)
    d_sky = (
        jnp.einsum("chw,chw->c", jac[_MAT_J_PLANES * n_mat:], g_cp,
                   precision=hi) / spp
    )

    zeros = lambda x: jnp.zeros_like(x)
    d_mats = dataclasses.replace(
        mats,
        albedo=d_alb,
        emission_color=d_eco,
        emission_strength=d_est,
        transparency=d_trn,
        roughness=zeros(mats.roughness),
        metallicity=zeros(mats.metallicity),
        refractive_index=zeros(mats.refractive_index),
    )
    return dataclasses.replace(
        scene,
        materials=d_mats,
        spheres=jax.tree_util.tree_map(zeros, scene.spheres),
        triangles=jax.tree_util.tree_map(zeros, scene.triangles),
        sky_color=d_sky,
    )


def render_pallas_bwd(
    scene: Scene,
    camera: Camera,
    g,  # (rows, W, 3) cotangent of the radiance image (row block)
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset=0,
    tile=FUSED_TILE,
    interpret: bool = False,
    row_start=0,
    rows: int | None = None,
    jitter: bool = False,
):
    """VJP of :func:`pallas_kernels.render_pallas` w.r.t. the scene:
    the fused kernel's Jacobian contracted with ``g``.

    Returns a Scene-shaped cotangent pytree (zeros for geometry,
    roughness, IOR, metallicity and masks — exactly what AD produces, see
    module docstring). Standalone entry point for when only the backward
    is wanted; ``jax.grad`` through ``render_pallas_vjp`` instead reuses
    the Jacobian already produced by its forward pass."""
    rows = height if rows is None else rows
    _, jac = render_pallas_fused(
        scene, camera, height, width, spp, max_bounces, seed,
        sample_offset=sample_offset, tile=tile, interpret=interpret,
        row_start=row_start, rows=rows, jitter=jitter,
    )
    return contract_jacobian(scene, jac, g, spp)
