"""Pallas megakernel (Triton): the performance render path.

The reference's GPU fragment shader (C9,
``shaders/rtx_frag.glsl:194-300``) runs one thread per
pixel with the whole sample loop (rtx_frag.glsl:288-292) and bounce loop
(196-271) in registers and the scene in uniform arrays. This kernel has
the same shape: one Triton program per **pixel tile** (grid over row/col
blocks), every per-ray quantity a (TH, TW) register plane — origins,
directions, throughput, accumulated light, RNG state (termination is
encoded as zero throughput; there is no alive plane) — so device-memory
traffic is one radiance tile out; the scene tables are read as scalar
loads (the uniform-array analog of rtx_frag.glsl:54-60). Terminated rays
are masked lanes.

Numerics are identical to the core integrator (models/integrator.py): same
PCG draws (ops/rng.py), same intersection rules, same shading order, same
self-intersection offsets — so the megakernel is validated against the
core path and the scalar oracle to f32-rounding tolerance (bit-exact in
interpreter mode).

The backward pass (``render_pallas_vjp``) pairs this forward with the
fused primal + Jacobian kernel in ``pallas_grad.py`` — both consume the
same RNG streams, so the VJP is exact for the forward's estimator;
``row_start``/``rows``/``sample_offset`` shard both directions under
``shard_map``.
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

__all__ = ["render_pallas", "render_pallas_vjp", "make_geometry", "DEFAULT_TILE"]

# Pixel tile of one Triton program and its warp count: the best of a
# tile sweep on the H100 at config 3's shape (PERF.md).
DEFAULT_TILE = (16, 32)
NUM_WARPS = 4


def _scene_loop(n, body, init):
    """fori_loop over a static-size scene table (spheres, triangles,
    materials). Every kernel walks its scene tables through this ONE
    function, so the replay invariant (forward and fused kernels make the
    same discrete decisions) holds whatever loop form it emits."""
    return jax.lax.fori_loop(0, n, body, init)


def compiler_params():
    """Triton launch parameters shared by every kernel of the package."""
    return pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def whole_array_specs(operands):
    """Each scene/parameter operand as one whole-array block: the kernel
    reads it with scalar loads."""
    return [
        pl.BlockSpec(x.shape, lambda i, j, nd=x.ndim: (0,) * nd)
        for x in operands
    ]


def _pow2_divisor(n: int, cap: int) -> int:
    """The largest power of two that is <= cap and divides n."""
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def tile_for(rows: int, width: int, tile, shrink: bool = False):
    """The kernel tile for a (rows, width) block: ``tile`` clipped to the
    block. Both sides must be powers of two (Triton's block shapes) and
    divide the block; ``shrink=True`` instead shrinks each side to the
    largest power of two that divides the block."""
    for n in tile:
        if n < 1 or n & (n - 1):
            raise ValueError(f"tile side {n} is not a power of two")
    th, tw = min(tile[0], rows), min(tile[1], width)
    if shrink:
        th, tw = _pow2_divisor(rows, th), _pow2_divisor(width, tw)
    for n in (th, tw):
        if n & (n - 1):
            raise ValueError(f"tile side {n} is not a power of two")
    if rows % th or width % tw:
        raise ValueError(f"{rows}x{width} not divisible by tile {th}x{tw}")
    return th, tw


def store_record(h_ref, b, rec):
    """Write one round record (a pytree of (TH, TW) planes) to slot ``b``
    of the device-memory history ``h_ref``; integer planes are stored as
    f32 (exact for scene-table indices)."""
    leaves = jax.tree_util.tree_leaves(rec)
    n = len(leaves)
    for k, x in enumerate(leaves):
        h_ref[b * n + k] = x.astype(jnp.float32)


def load_record(h_ref, b, like):
    """Read slot ``b`` of ``h_ref`` back into the structure and dtypes of
    the record ``like``."""
    leaves, tree = jax.tree_util.tree_flatten(like)
    n = len(leaves)
    return tree.unflatten(
        [h_ref[b * n + k].astype(x.dtype) for k, x in enumerate(leaves)]
    )


def rolled_rounds(fwd_round, fc, h_ref, max_bounces, early_exit, dead_of):
    """Run a fused kernel's forward rounds as a rolled loop, writing each
    round's record to the device-memory history ``h_ref``. Returns (final
    state, executed rounds). Round 0 runs outside the loop (it may reuse
    the hoisted primary hit); ``dead_of(state, record)`` is the 0/1 plane
    of structurally dead lanes, which the early-exit schemes reduce."""

    def fwd_store(b, carry):
        fc, done = carry
        fc, rec = fwd_round(b, fc)
        store_record(h_ref, b, rec)
        return fc, jnp.maximum(done, dead_of(fc, rec))

    carry = fwd_store(0, (fc, jnp.zeros_like(fc[6])))
    if early_exit == "once":
        alive0 = jnp.min(carry[1]) < 1.0
        carry = jax.lax.cond(
            alive0,
            lambda c: jax.lax.fori_loop(1, max_bounces + 1, fwd_store, c),
            lambda c: c,
            carry,
        )
        return carry[0], jnp.where(alive0, jnp.int32(max_bounces + 1),
                                   jnp.int32(1))

    def w_cond(c):
        b, (_, done) = c
        if not early_exit:
            return b < max_bounces + 1
        return (b < max_bounces + 1) & (jnp.min(done) < 1.0)

    def w_body(c):
        b, carry = c
        return b + 1, fwd_store(b, carry)

    bend, carry = jax.lax.while_loop(w_cond, w_body, (jnp.int32(1), carry))
    return carry[0], bend


def round_count_spec():
    """Out spec of the executed-round counter: one int32 per program,
    summed outside the kernel (programs run in no fixed order, so no
    program may accumulate into another's output)."""
    return pl.BlockSpec((1, 1), lambda i, j: (i, j))


# Plain numpy scalars: module-level jnp values would be captured as
# constants by pallas_call, which rejects them.
_INF = np.float32(np.inf)
_TRI_EPS = np.float32(1e-6)
_INV_U32_MAX = np.float32(1.0 / 4294967295.0)
_TWO_PI = np.float32(2.0 * math.pi)


def _u32(x):
    return jnp.uint32(x)


def _pcg(state):
    """One PCG round on a (TH, TW) uint32 plane — ops/rng.pcg_next inlined."""
    state = state * _u32(747796405) + _u32(2891336453)
    word = ((state >> ((state >> 28) + _u32(4))) ^ state) * _u32(277803737)
    return state, (word >> 22) ^ word


def _uniform(state):
    # Round-to-nearest uint32 -> f32, then the scale: the same two
    # operations as ops/rng.uniform, so the streams are bit-identical.
    state, bits = _pcg(state)
    return state, bits.astype(jnp.float32) * _INV_U32_MAX


def _normal(state):
    state, u1 = _uniform(state)
    state, u2 = _uniform(state)
    theta = _TWO_PI * u1
    rho = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u2, jnp.float32(1e-38))))
    return state, rho * jnp.cos(theta)


def _unit_sphere(state):
    # cylindrical (z, phi) sampler — bit-matches ops/rng.unit_sphere,
    # including its polynomial sincos (the shared trig spec; a real
    # sin/cos here would break bit-parity with the core stream —
    # ops/rng.sincos_2pi).
    from . import rng as _rng

    state, u1 = _uniform(state)
    state, u2 = _uniform(state)
    z = 1.0 - 2.0 * u1
    c, s = _rng.sincos_2pi(u2)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return state, (r * c, r * s, z)


def make_geometry(
    sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m, tri_a,
    m_alb, m_eco, m_est, m_rgh, m_trn, m_ior, sky,
    th, tw, n_sph, n_tri, n_mat,
):
    """Build the per-tile (closest_hit, shade) routines over the scene refs.

    ``closest_hit`` is shared by the forward megakernel, the backward
    replay kernel (pallas_grad.py) and the physical-tier kernels
    (pallas_physical.py) — they MUST be the same code: the backward
    replays the forward's paths, and any numeric drift between the two
    breaks the replay's discrete decisions. ``sky`` is a tuple of three
    scalars. Returns ``(closest_hit, fetch_materials, shade)`` with two
    extra routines reachable as attributes on ``closest_hit``:
    ``closest_hit.kind`` (also returns a sphere-winner 0/1 plane, for the
    physical tier's NEE single-counting) and ``closest_hit.closest_t``
    (distance-only query for shadow rays).
    """
    sky_r, sky_g, sky_b = sky
    zero = jnp.zeros((th, tw), jnp.float32)

    def sph_t(i, ox, oy, oz, dx, dy, dz, dd, invdd):
        """One sphere's hit distance plane (INF-masked) + its center.

        Half-b quadratic: with h = oc.d, det/4 = h^2 - dd*cq has the same
        sign as the full discriminant and the same roots — two multiplies
        cheaper per sphere than the textbook form."""
        cx, cy, cz = sph_c[i, 0], sph_c[i, 1], sph_c[i, 2]
        r = sph_r[i, 0]
        act = sph_a[i, 0]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        h = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        det = h * h - dd * cq
        sq = jnp.sqrt(jnp.maximum(det, 0.0))
        t1 = (-h - sq) * invdd
        t2 = (-h + sq) * invdd
        t = jnp.where(t1 >= 0.0, t1, jnp.where(t2 >= 0.0, t2, _INF))
        t = jnp.where((det >= 0.0) & (act > 0.0), t, _INF)
        return t, cx, cy, cz

    def tri_t(i, ox, oy, oz, dx, dy, dz):
        """One triangle's Möller–Trumbore hit distance plane (INF-masked)."""
        v0x, v0y, v0z = tri_v0[i, 0], tri_v0[i, 1], tri_v0[i, 2]
        e1x = tri_v1[i, 0] - v0x
        e1y = tri_v1[i, 1] - v0y
        e1z = tri_v1[i, 2] - v0z
        e2x = tri_v2[i, 0] - v0x
        e2y = tri_v2[i, 1] - v0y
        e2z = tri_v2[i, 2] - v0z
        act = tri_a[i, 0]
        # rce = cross(d, e2)
        rcx = dy * e2z - dz * e2y
        rcy = dz * e2x - dx * e2z
        rcz = dx * e2y - dy * e2x
        det = e1x * rcx + e1y * rcy + e1z * rcz
        nonpar = jnp.abs(det) >= _TRI_EPS
        inv = 1.0 / jnp.where(nonpar, det, 1.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = inv * (sx * rcx + sy * rcy + sz * rcz)
        # sce = cross(s, e1)
        scx = sy * e1z - sz * e1y
        scy = sz * e1x - sx * e1z
        scz = sx * e1y - sy * e1x
        v = inv * (dx * scx + dy * scy + dz * scz)
        t = inv * (e2x * scx + e2y * scy + e2z * scz)
        ok = (
            nonpar
            & (u >= _TRI_EPS)
            & (u <= 1.0)
            & (v >= _TRI_EPS)
            & (u + v <= 1.0)
            & (t >= _TRI_EPS)
            & (act > 0.0)
        )
        return jnp.where(ok, t, _INF)

    def _closest_hit(ox, oy, oz, dx, dy, dz, track_kind):
        # -- closest hit: spheres then triangles (rtx_frag.glsl:158-192) --
        best_t = jnp.full((th, tw), _INF)
        mat = jnp.zeros((th, tw), jnp.int32)
        # Winning sphere's center, carried instead of a normal: the normal
        # is materialized ONCE after the argmin (select-then-normalize,
        # same order as ops/intersect.py:168) instead of normalized per
        # sphere — drops an rsqrt + hit-point chain from every iteration.
        bcx = zero
        bcy = zero
        bcz = zero
        sphm = zero  # 1.0 where the winner is a sphere (track_kind only)

        dd = dx * dx + dy * dy + dz * dz
        invdd = 1.0 / dd

        def sph_body(i, c):
            bt, bcx, bcy, bcz, mat, sphm = c
            t, cx, cy, cz = sph_t(i, ox, oy, oz, dx, dy, dz, dd, invdd)
            upd = t < bt
            return (
                jnp.where(upd, t, bt),
                jnp.where(upd, cx, bcx),
                jnp.where(upd, cy, bcy),
                jnp.where(upd, cz, bcz),
                jnp.where(upd, sph_m[i, 0], mat),
                jnp.where(upd, 1.0, sphm) if track_kind else sphm,
            )

        best_t, bcx, bcy, bcz, mat, sphm = _scene_loop(
            n_sph, sph_body, (best_t, bcx, bcy, bcz, mat, sphm)
        )
        ts = jnp.where(best_t < _INF, best_t, 0.0)  # keep NaNs off miss lanes
        hx = ox + ts * dx - bcx
        hy = oy + ts * dy - bcy
        hz = oz + ts * dz - bcz
        hn = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-20))
        nx = hx * hn
        ny = hy * hn
        nz = hz * hn

        def tri_body(i, c):
            bt, nx, ny, nz, mat, sphm = c
            t = tri_t(i, ox, oy, oz, dx, dy, dz)
            upd = t < bt
            # Face normal flipped to oppose the ray (rtx_frag.glsl:186).
            fnx, fny, fnz = tri_n[i, 0], tri_n[i, 1], tri_n[i, 2]
            s = jnp.where(fnx * dx + fny * dy + fnz * dz < 0.0, 1.0, -1.0)
            return (
                jnp.where(upd, t, bt),
                jnp.where(upd, s * fnx, nx),
                jnp.where(upd, s * fny, ny),
                jnp.where(upd, s * fnz, nz),
                jnp.where(upd, tri_m[i, 0], mat),
                jnp.where(upd, 0.0, sphm) if track_kind else sphm,
            )

        best_t, nx, ny, nz, mat, sphm = _scene_loop(
            n_tri, tri_body, (best_t, nx, ny, nz, mat, sphm)
        )
        if track_kind:
            return best_t, nx, ny, nz, mat, sphm
        return best_t, nx, ny, nz, mat

    def closest_hit(ox, oy, oz, dx, dy, dz):
        return _closest_hit(ox, oy, oz, dx, dy, dz, track_kind=False)

    def closest_hit_kind(ox, oy, oz, dx, dy, dz):
        return _closest_hit(ox, oy, oz, dx, dy, dz, track_kind=True)

    def closest_t(ox, oy, oz, dx, dy, dz):
        """Distance-only closest hit (shadow/occlusion query): the same
        per-object t math as closest_hit, skipping normals and argmin
        metadata — ~half the selects per object."""
        dd = dx * dx + dy * dy + dz * dz
        invdd = 1.0 / dd

        def sph_body(i, bt):
            t, _, _, _ = sph_t(i, ox, oy, oz, dx, dy, dz, dd, invdd)
            return jnp.minimum(bt, t)

        def tri_body(i, bt):
            return jnp.minimum(bt, tri_t(i, ox, oy, oz, dx, dy, dz))

        best_t = _scene_loop(n_sph, sph_body, jnp.full((th, tw), _INF))
        return _scene_loop(n_tri, tri_body, best_t)

    closest_hit.kind = closest_hit_kind
    closest_hit.closest_t = closest_t

    def fetch_materials(mat):
        """Material planes by index (uniform materials[] analog): one
        masked select-loop over the material table. Split out of shade so
        the bounce-0 fetch (whose hit is sample-invariant) can be hoisted
        out of the sample loop."""
        zero_ = jnp.zeros((th, tw), jnp.float32)
        alb_r = zero_
        alb_g = zero_
        alb_b = zero_
        em_r = zero_
        em_g = zero_
        em_b = zero_
        rgh = zero_
        trn = zero_
        ior = jnp.ones((th, tw), jnp.float32)

        def mat_body(mi, c):
            alr, alg, alb_, emr, emg, emb, rg, tn, io = c
            msk = mat == mi
            es = m_est[mi, 0]
            return (
                jnp.where(msk, m_alb[mi, 0], alr),
                jnp.where(msk, m_alb[mi, 1], alg),
                jnp.where(msk, m_alb[mi, 2], alb_),
                jnp.where(msk, m_eco[mi, 0] * es, emr),
                jnp.where(msk, m_eco[mi, 1] * es, emg),
                jnp.where(msk, m_eco[mi, 2] * es, emb),
                jnp.where(msk, m_rgh[mi, 0], rg),
                jnp.where(msk, m_trn[mi, 0], tn),
                jnp.where(msk, m_ior[mi, 0], io),
            )

        return _scene_loop(
            n_mat, mat_body,
            (alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior),
        )

    def shade(hit, mats, st):
        """One bounce's shading + next-ray update, given the closest hit.

        There is no explicit alive mask: termination is encoded as zero
        throughput. A lane that misses pays the sky and has its throughput
        zeroed; every later contribution it could make is ``T * x`` with
        ``T == 0``, i.e. exactly zero, so re-shading dead lanes is
        bit-identical to masking them — one fewer loop-carried plane
        and ~8 fewer selects per bounce. It also strengthens the all-dead
        early exit: lanes whose throughput hits exact zero through a black
        albedo terminate too (exact, zero-variance Russian roulette)."""
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab, rng) = st
        best_t, nx, ny, nz, mat = hit

        hitmask = best_t < _INF
        ar = ar + jnp.where(hitmask, 0.0, tr * sky_r)
        ag = ag + jnp.where(hitmask, 0.0, tg * sky_g)
        ab = ab + jnp.where(hitmask, 0.0, tb * sky_b)

        ts = jnp.where(hitmask, best_t, 0.0)
        px = ox + ts * dx
        py = oy + ts * dy
        pz = oz + ts * dz

        # Material planes (emission premultiplied color x strength —
        # the forward only ever uses the product).
        (alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior) = mats

        # Le then albedo (rtx_frag.glsl:226-230); miss lanes terminate by
        # zeroing their throughput here.
        ar = ar + jnp.where(hitmask, tr * em_r, 0.0)
        ag = ag + jnp.where(hitmask, tg * em_g, 0.0)
        ab = ab + jnp.where(hitmask, tb * em_b, 0.0)
        tr = jnp.where(hitmask, tr * alb_r, 0.0)
        tg = jnp.where(hitmask, tg * alb_g, 0.0)
        tb = jnp.where(hitmask, tb * alb_b, 0.0)

        # Reference-tier 3-draw schedule: unit sphere (2) + branch uniform
        # (1) per bounce — the contract shared with ops/rng.py, the scalar
        # oracle, and the backward replay. (The physical tier has its own
        # 7-draw schedule in pallas_physical.py / models/physical.py.)
        rng, (sx_, sy_, sz_) = _unit_sphere(rng)
        rng, u_branch = _uniform(rng)

        # Roughness-perturbed normal (rtx_frag.glsl:233-234).
        wnx = nx + rgh * sx_
        wny = ny + rgh * sy_
        wnz = nz + rgh * sz_
        wn = jax.lax.rsqrt(jnp.maximum(wnx * wnx + wny * wny + wnz * wnz, 1e-20))
        wnx, wny, wnz = wnx * wn, wny * wn, wnz * wn

        ndot = dx * wnx + dy * wny + dz * wnz
        # reflect
        rfx = dx - 2.0 * ndot * wnx
        rfy = dy - 2.0 * ndot * wny
        rfz = dz - 2.0 * ndot * wnz
        # refract with entering/exit flip (rtx_frag.glsl:249-259)
        entering = ndot < 0.0
        eta = jnp.where(entering, 1.0 / ior, ior)
        rnx = jnp.where(entering, wnx, -wnx)
        rny = jnp.where(entering, wny, -wny)
        rnz = jnp.where(entering, wnz, -wnz)
        ni = rnx * dx + rny * dy + rnz * dz
        k = 1.0 - eta * eta * (1.0 - ni * ni)
        tirm = k < 0.0
        # sqrt(1) on the discarded TIR branch + 1e-12 floor: keeps the
        # backward replay identical to ops/sampling.refract (see there).
        ksafe = jnp.where(tirm, 1.0, jnp.maximum(k, 1e-12))
        coef = eta * ni + jnp.sqrt(ksafe)
        txx = jnp.where(tirm, 0.0, eta * dx - coef * rnx)
        txy = jnp.where(tirm, 0.0, eta * dy - coef * rny)
        txz = jnp.where(tirm, 0.0, eta * dz - coef * rnz)

        choose_refr = u_branch < trn
        ndx = jnp.where(choose_refr, txx, rfx)
        ndy = jnp.where(choose_refr, txy, rfy)
        ndz = jnp.where(choose_refr, txz, rfz)
        # TIR death: zero the throughput; keep the old (nonzero) direction
        # so the dead lane's re-traces stay NaN-free.
        died = choose_refr & tirm
        tr = jnp.where(died, 0.0, tr)
        tg = jnp.where(died, 0.0, tg)
        tb = jnp.where(died, 0.0, tb)
        ndx = jnp.where(died, dx, ndx)
        ndy = jnp.where(died, dy, ndy)
        ndz = jnp.where(died, dz, ndz)

        # Scale-adaptive normal offset (see models/integrator.py).
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * jnp.sqrt(
            px * px + py * py + pz * pz
        )
        side = jnp.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
        nox = px + offs * side * nx
        noy = py + offs * side * ny
        noz = pz + offs * side * nz

        # Unconditional ray update: dead lanes (zero throughput) may carry
        # garbage rays, but everything they add downstream is T * x == 0.
        return (nox, noy, noz, ndx, ndy, ndz, tr, tg, tb, ar, ag, ab, rng)

    return closest_hit, fetch_materials, shade


def _kernel(
    # scene tables (2D each), read with scalar loads
    sph_c,  # (S, 3)
    sph_r,  # (S, 1)
    sph_m,  # (S, 1) int32
    sph_a,  # (S, 1) f32 0/1
    tri_v0,  # (T, 3)
    tri_v1,
    tri_v2,
    tri_n,  # (T, 3) unit face normals (host-precomputed)
    tri_m,  # (T, 1) int32
    tri_a,  # (T, 1)
    m_alb,  # (M, 3)
    m_eco,  # (M, 3)
    m_est,  # (M, 1)
    m_rgh,  # (M, 1)
    m_trn,  # (M, 1)
    m_ior,  # (M, 1)
    par_f,  # (1, PF) f32: tan_fov2, aspect, W, H, sky rgb, cam origin/right/up/fwd
    par_i,  # (1, 2) int32: seed, sample_offset
    out_ref,  # (3, TH, TW) radiance tile
    *maybe_cnt,  # with count_rounds: (1, 1) i32 rounds this program ran
    th: int,
    tw: int,
    n_sph: int,
    n_tri: int,
    n_mat: int,
    spp: int,
    max_bounces: int,
    jitter: bool = False,
    count_rounds: bool = False,
    early_exit: bool | str = "once",
):
    ti = pl.program_id(0)
    tj = pl.program_id(1)
    tan2 = par_f[0, 0]
    aspect = par_f[0, 1]
    width = par_f[0, 2]
    sky_r, sky_g, sky_b = par_f[0, 4], par_f[0, 5], par_f[0, 6]
    cox, coy, coz = par_f[0, 7], par_f[0, 8], par_f[0, 9]
    crx, cry, crz = par_f[0, 10], par_f[0, 11], par_f[0, 12]
    cux, cuy, cuz = par_f[0, 13], par_f[0, 14], par_f[0, 15]
    cfx, cfy, cfz = par_f[0, 16], par_f[0, 17], par_f[0, 18]
    height = par_f[0, 3]
    seed = par_i[0, 0].astype(jnp.uint32)
    sample_offset = par_i[0, 1]
    row_start = par_i[0, 2]  # global row of this kernel's first row (sharding)

    # Pixel coordinates of this tile (global, so RNG streams are
    # sharding-invariant — rtx_frag.glsl:277's pixel_idx analog).
    rows = (
        jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0) + ti * th + row_start
    )
    cols = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1) + tj * tw
    pix = (rows * width.astype(jnp.int32) + cols).astype(jnp.uint32)

    # Primary rays: pinhole camera (rtx_frag.glsl:280-284).
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

    closest_hit, fetch_materials, shade = make_geometry(
        sph_c, sph_r, sph_m, sph_a, tri_v0, tri_v1, tri_v2, tri_n, tri_m,
        tri_a, m_alb, m_eco, m_est, m_rgh, m_trn, m_ior,
        (sky_r, sky_g, sky_b), th, tw, n_sph, n_tri, n_mat,
    )

    # Without jitter, the first trace round is RNG-independent (all samples
    # share the same camera ray — the reference shoots identical primary
    # rays per pixel, rtx_frag.glsl:288-292), so hoist it — and its
    # material fetch — out of the sample loop. With jitter every sample
    # shoots its own sub-pixel ray, so nothing hoists.
    cam_ox = jnp.full((th, tw), cox)
    cam_oy = jnp.full((th, tw), coy)
    cam_oz = jnp.full((th, tw), coz)
    if not jitter:
        hit0 = closest_hit(cam_ox, cam_oy, cam_oz, pdx, pdy, pdz)
        mats0 = fetch_materials(hit0[4])
    # whole-tile sky gate: only sound when bounce 0 is sample-invariant
    tile_gate = early_exit == "once" and not jitter

    def sample_body(s, acc):
        acc_r, acc_g, acc_b = acc[:3]
        sample = (s + sample_offset).astype(jnp.uint32)
        # seed_state (ops/rng.py): splitmix-style mix + two PCG rounds.
        st = (
            pix * _u32(0x9E3779B9)
            ^ sample * _u32(0x85EBCA6B)
            ^ seed * _u32(0xC2B2AE35)
        )
        st, _ = _pcg(st)
        st, _ = _pcg(st)

        if jitter:
            # Anti-aliasing: 2 sub-pixel uniforms per sample, same draw
            # order as primary_rays(jitter_state) (ops/camera.py:123-131).
            st, jx = _uniform(st)
            st, jy = _uniform(st)
            xj = (cols.astype(jnp.float32) + jx) / width * 2.0 - 1.0
            yj = -((rows.astype(jnp.float32) + jy) / height * 2.0 - 1.0)
            djx = xj * tan2
            djy = yj * tan2 / aspect
            sdx = djx * crx + djy * cux + cfx
            sdy = djx * cry + djy * cuy + cfy
            sdz = djx * crz + djy * cuz + cfz
            sn = jax.lax.rsqrt(sdx * sdx + sdy * sdy + sdz * sdz)
            sdx, sdy, sdz = sdx * sn, sdy * sn, sdz * sn
            hit_s = closest_hit(cam_ox, cam_oy, cam_oz, sdx, sdy, sdz)
            mats_s = fetch_materials(hit_s[4])
        else:
            sdx, sdy, sdz = pdx, pdy, pdz
            hit_s, mats_s = hit0, mats0

        ones = jnp.ones((th, tw), jnp.float32)
        state0 = (
            cam_ox, cam_oy, cam_oz,
            sdx, sdy, sdz,
            ones, ones, ones,
            zero, zero, zero,
            st,
        )
        st13 = shade(hit_s, mats_s, state0)

        # Remaining bounces with early exit: termination is zero
        # throughput (see shade), so once every lane's throughput is zero
        # the rest of the bounce budget contributes exactly nothing.
        # ``early_exit`` selects the check scheme (bit-identical output
        # in all three: skipped rounds only ever add exact zeros):
        #   True  — per-round cross-lane reduce in the while cond;
        #   "once" — ONE reduce after the hoisted round 0, then the rest
        #           of the budget unconditionally: round skips are
        #           bimodal (sky tiles die at round 0, content tiles run
        #           ~the full budget), so one check keeps most of the
        #           skip value at 1/max_bounces of the reduce cost;
        #   False — no check, full budget (diagnostic).
        def w_body_b(b, s):
            hit = closest_hit(s[0], s[1], s[2], s[3], s[4], s[5])
            return shade(hit, fetch_materials(hit[4]), s)

        if tile_gate:
            # the whole-tile sky gate below already proved some lane hit
            # at bounce 0 (shared across samples — no jitter), so run
            # the full budget with no per-sample check at all
            out = jax.lax.fori_loop(1, max_bounces + 1, w_body_b, st13)
            bend = jnp.int32(max_bounces + 1)
        elif early_exit == "once":
            alive0 = jnp.max(st13[6] + st13[7] + st13[8]) > 0.0
            out = jax.lax.cond(
                alive0,
                lambda s: jax.lax.fori_loop(1, max_bounces + 1,
                                            w_body_b, s),
                lambda s: s,
                st13,
            )
            bend = jnp.where(alive0, jnp.int32(max_bounces + 1),
                             jnp.int32(1))
        else:
            def w_cond(carry):
                b, s = carry
                if not early_exit:
                    return b < max_bounces + 1
                return (b < max_bounces + 1) & (
                    jnp.max(s[6] + s[7] + s[8]) > 0.0
                )

            def w_body(carry):
                b, s = carry
                return b + 1, w_body_b(b, s)

            bend, out = jax.lax.while_loop(w_cond, w_body,
                                           (jnp.int32(1), st13))
        (_, _, _, _, _, _, tr, tg, tb, ar, ag, ab, _) = out
        # Bounce budget exhausted -> sky (rtx_frag.glsl:212-214); dead
        # lanes carry zero throughput, so no mask is needed.
        ar = ar + tr * sky_r
        ag = ag + tg * sky_g
        ab = ab + tb * sky_b
        if count_rounds:
            # bend = hoisted round 0 + loop iterations: the trace rounds
            # this tile actually executed for this sample (the all-dead
            # early exit skips the rest) — the honest denominator next to
            # the nominal max_bounces+1 (utils/metrics.rays_per_render).
            return (acc_r + ar, acc_g + ag, acc_b + ab, acc[3] + bend)
        return (acc_r + ar, acc_g + ag, acc_b + ab)

    init = (zero, zero, zero) + (
        (jnp.int32(0),) if count_rounds else ()
    )
    if tile_gate:
        # Whole-tile sky gate: without jitter every sample shares the
        # hoisted bounce-0 hit, so "all lanes miss at bounce 0" is a
        # per-TILE fact — one reduce replaces 64 per-sample checks, and
        # all-sky tiles skip the sample loop entirely. The sky branch
        # replays the live path's exact arithmetic (per sample:
        # acc += (0 + 1*sky + 0.0...) == acc + sky), so images stay
        # bit-identical to the checked schemes.
        tile_alive = jnp.max(jnp.where(hit0[0] < _INF, 1.0, 0.0)) > 0.0

        def run_sky():
            def sbody(s, acc):
                a = (acc[0] + sky_r, acc[1] + sky_g, acc[2] + sky_b)
                return a + ((acc[3],) if count_rounds else ())

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


def _scene_operands(scene: Scene):
    """Flatten the scene pytree into the kernel's scene operand list."""
    tri_e1 = scene.triangles.v0 - scene.triangles.v1
    tri_e2 = scene.triangles.v0 - scene.triangles.v2
    tri_n = jnp.cross(tri_e1, tri_e2)
    tri_n = tri_n * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(tri_n * tri_n, -1, keepdims=True), 1e-20)
    )
    f32 = jnp.float32
    return [
        scene.spheres.center.astype(f32),
        scene.spheres.radius.astype(f32)[:, None],
        scene.spheres.material.astype(jnp.int32)[:, None],
        scene.spheres.active.astype(f32)[:, None],
        scene.triangles.v0.astype(f32),
        scene.triangles.v1.astype(f32),
        scene.triangles.v2.astype(f32),
        tri_n.astype(f32),
        scene.triangles.material.astype(jnp.int32)[:, None],
        scene.triangles.active.astype(f32)[:, None],
        scene.materials.albedo.astype(f32),
        scene.materials.emission_color.astype(f32),
        scene.materials.emission_strength.astype(f32)[:, None],
        scene.materials.roughness.astype(f32)[:, None],
        scene.materials.transparency.astype(f32)[:, None],
        scene.materials.refractive_index.astype(f32)[:, None],
    ]


def _camera_params(camera: Camera, scene: Scene, height: int, width: int):
    tan2 = jnp.tan(camera.fov * 0.5)
    par = jnp.concatenate(
        [
            jnp.stack(
                [
                    tan2,
                    jnp.float32(width / height),
                    jnp.float32(width),
                    jnp.float32(height),
                ]
            ),
            scene.sky_color.astype(jnp.float32),
            camera.origin.astype(jnp.float32),
            camera.right.astype(jnp.float32),
            camera.up.astype(jnp.float32),
            camera.forward.astype(jnp.float32),
        ]
    )
    return par[None, :]


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "spp", "max_bounces", "tile", "interpret", "rows",
        "jitter", "count_rounds", "early_exit",
    ),
)
def render_pallas(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset=0,
    tile: tuple[int, int] = DEFAULT_TILE,
    interpret: bool = False,
    row_start=0,
    rows: int | None = None,
    jitter: bool = False,
    count_rounds: bool = False,
    early_exit: bool | str = "once",
):
    """Radiance image (rows, W, 3) f32 via the Pallas megakernel.

    ``height`` is the full image height (NDC mapping); ``row_start``/
    ``rows`` select a row block — the unit of image sharding, with
    global-index RNG like the core path. Block dims must divide the tile.
    ``jitter=True`` draws per-sample sub-pixel offsets (anti-aliasing),
    matching ``render_tile(jitter=True)`` bit-for-bit in draw order.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); without it the kernel needs a GPU (backend.kernel_interpret).

    ``count_rounds=True`` returns ``(img, executed_rounds)`` where
    ``executed_rounds`` (scalar i32) is the total number of per-tile
    trace rounds the kernel actually executed across all samples — the
    all-dead early exit makes this less than the nominal
    ``n_tiles * spp * (max_bounces + 1)``. Each program writes its own
    count; the sum is taken outside the kernel. It is a separate compile
    of the same kernel; headline timings use the plain variant.
    """
    rows = height if rows is None else rows
    th, tw = tile_for(rows, width, tile)
    interpret = backend.kernel_interpret(interpret, "render_pallas")

    kern = partial(
        _kernel,
        th=th,
        tw=tw,
        n_sph=scene.num_spheres,
        n_tri=scene.num_triangles,
        n_mat=scene.num_materials,
        spp=spp,
        max_bounces=max_bounces,
        jitter=jitter,
        count_rounds=count_rounds,
        early_exit=early_exit,
    )
    par_i = jnp.stack(
        [jnp.asarray(seed, jnp.uint32).astype(jnp.int32),
         jnp.asarray(sample_offset, jnp.int32),
         jnp.asarray(row_start, jnp.int32)]
    )[None, :]

    operands = _scene_operands(scene) + [
        _camera_params(camera, scene, height, width),
        par_i,
    ]
    grid = (rows // th, width // tw)
    out_specs = [pl.BlockSpec((3, th, tw), lambda i, j: (0, i, j))]
    out_shape = [jax.ShapeDtypeStruct((3, rows, width), jnp.float32)]
    if count_rounds:
        out_specs.append(round_count_spec())
        out_shape.append(jax.ShapeDtypeStruct(grid, jnp.int32))
    out = pl.pallas_call(
        kern,
        grid=grid,
        in_specs=whole_array_specs(operands),
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=compiler_params(),
        interpret=interpret,
        name="render_pallas",
    )(*operands)
    img = jnp.transpose(out[0], (1, 2, 0))
    if count_rounds:
        return img, jnp.sum(out[1])
    return img


# -- differentiable wrapper: Pallas forward, core-path backward -------------


@partial(
    jax.custom_vjp,
    nondiff_argnums=(2, 3, 4, 5, 6, 7, 8),
)
def _render_pallas_vjp(
    scene, camera, height, width, spp, max_bounces, rows, jitter, interpret,
    seed, sample_offset, row_start,
):
    return render_pallas(
        scene, camera, height, width, spp, max_bounces, seed,
        sample_offset=sample_offset, row_start=row_start, rows=rows,
        jitter=jitter, interpret=interpret,
    )


def _fwd(
    scene, camera, height, width, spp, max_bounces, rows, jitter, interpret,
    seed, sample_offset, row_start,
):
    from .pallas_grad import render_pallas_fused

    # Under AD, run the FUSED kernel: one pass emits the primal AND the
    # per-pixel material Jacobian (pallas_grad.py), so the backward rule
    # is a tiny contraction instead of a second full path replay — the
    # VJP no longer traces any ray twice.
    out, jac = render_pallas_fused(
        scene, camera, height, width, spp, max_bounces, seed,
        sample_offset=sample_offset, row_start=row_start, rows=rows,
        jitter=jitter, interpret=interpret,
    )
    return out, (scene, camera, jac)


def _float0_ints(cotangent, primal):
    """Replace int/bool-leaf cotangents with float0 zeros (custom_vjp
    contract for non-differentiable leaves)."""
    import numpy as np

    def fix(c, p):
        if jnp.issubdtype(p.dtype, jnp.floating):
            return c
        return np.zeros(np.shape(p), dtype=jax.dtypes.float0)

    return jax.tree_util.tree_map(fix, cotangent, primal)


def _bwd(height, width, spp, max_bounces, rows, jitter, interpret, res, g):
    from .pallas_grad import contract_jacobian

    scene, camera, jac = res
    # The Jacobian was built by the fused forward; the backward is just
    # its contraction with g. Camera cotangents are exactly zero
    # (radiance is piecewise-constant in camera parameters under this
    # shading model, like geometry — grad/diff.py).
    d_scene = contract_jacobian(scene, jac, g, spp)
    d_scene = _float0_ints(d_scene, scene)
    d_camera = jax.tree_util.tree_map(jnp.zeros_like, camera)
    return d_scene, d_camera, None, None, None


_render_pallas_vjp.defvjp(_fwd, _bwd)


def render_pallas_vjp(
    scene, camera, height, width, spp, max_bounces, seed,
    sample_offset=0, row_start=0, rows: int | None = None,
    jitter: bool = False, interpret: bool = False,
):
    """Differentiable fast render: megakernel forward, hand-written Pallas
    backward (ops/pallas_grad.py).

    Forward and backward consume identical RNG streams (same counter
    seeding), so the backward is the exact VJP of the forward estimator up
    to f32 rounding between the two implementations. ``row_start`` /
    ``rows`` / ``sample_offset`` make this shardable under ``shard_map``
    (parallel/render.py) — the backward kernel replays the same global
    pixel/sample indices per shard.

    Memory note: the fwd rule saves the fused kernel's per-pixel
    Jacobian as the VJP residual — ``(9*n_mat + 3) * rows * width * 4``
    bytes of device memory held from forward to backward (~0.5 GB at
    1024^2 with 15 materials). Row-block sharding divides it per device;
    budget large-scene fits accordingly.
    """
    rows = height if rows is None else rows
    return _render_pallas_vjp(
        scene, camera, height, width, spp, max_bounces, rows, jitter,
        interpret,
        jnp.asarray(seed, jnp.uint32),
        jnp.asarray(sample_offset, jnp.int32),
        jnp.asarray(row_start, jnp.int32),
    )
