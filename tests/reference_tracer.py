"""Scalar NumPy reference tracer — the golden-image oracle.

An intentionally slow, loopy, scalar implementation of *exactly* the
estimator the framework specifies (single-path selection, 7-draw RNG
schedule, GPU-backend shading semantics from
``/root/reference/shaders/rtx_frag.glsl``), written with per-object Python
loops and masked 32-bit integer arithmetic so it shares no code path with
the vectorized JAX implementation. If the wavefront integrator and this
tracer agree pixel-wise, the vectorization/masking/scan machinery is
correct.

RNG draws produce bit-identical uint32 streams to ``ops/rng.py`` (integer
ops are exact); float math may differ by libm rounding, so image
comparisons use tolerances.
"""

from __future__ import annotations

import math

import numpy as np

_MASK = 0xFFFFFFFF
_INV_U32_MAX = 1.0 / 4294967295.0
TRI_EPS = 1e-6
EPS_OFFSET = 1e-4


# -- RNG (mirrors ops/rng.py, via masked python ints) -----------------------

def pcg_next(state: int):
    state = (state * 747796405 + 2891336453) & _MASK
    shift = ((state >> 28) + 4) & 31
    word = (((state >> shift) ^ state) * 277803737) & _MASK
    bits = ((word >> 22) ^ word) & _MASK
    return state, bits


def uniform(state: int):
    state, bits = pcg_next(state)
    return state, float(np.float32(bits) * np.float32(_INV_U32_MAX))


def normal(state: int):
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    theta = np.float32(2.0 * math.pi) * np.float32(u1)
    rho = np.float32(
        math.sqrt(-2.0 * math.log(max(np.float32(u2), np.float32(1e-38))))
    )
    return state, float(rho * np.float32(math.cos(theta)))


def sincos_2pi(u: float):
    """f32 mirror of ops/rng.sincos_2pi — the shared polynomial trig
    spec (quadrant fold + degree-6/7 minimax on [-pi/4, pi/4])."""
    f = np.float32
    u = f(u)
    k = np.floor(u * f(4.0) + f(0.5))
    r = f(u * f(2.0 * math.pi) - k * f(math.pi / 2.0))
    t2 = r * r
    cosr = f(1.0) + t2 * (
        f(-4.9999915618e-01) + t2 * (f(4.1657625659e-02)
                                     + t2 * f(-1.3615911837e-03))
    )
    sinr = r * (
        f(1.0) + t2 * (f(-1.6666653296e-01)
                       + t2 * (f(8.3321242496e-03)
                               + t2 * f(-1.9513782088e-04)))
    )
    k4 = k - f(4.0) * np.floor(k * f(0.25))
    swap = k4 in (1.0, 3.0)
    a, b = (sinr, cosr) if swap else (cosr, sinr)
    c = -a if k4 in (1.0, 2.0) else a
    s = -b if k4 in (2.0, 3.0) else b
    return float(c), float(s)


def unit_sphere(state: int):
    """Cylindrical (z, phi) uniform sphere sampler — mirrors ops/rng.py,
    polynomial sincos included (the shared trig spec)."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    z = 1.0 - 2.0 * u1
    c, s = sincos_2pi(u2)
    r = math.sqrt(max(1.0 - z * z, 0.0))
    return state, np.array([r * c, r * s, z])


def unit_sphere_biased(state: int):
    """CPU-tier biased cube sampler (src/renderer.c:11-19)."""
    state, x = uniform(state)
    state, y = uniform(state)
    state, z = uniform(state)
    v = np.array([x, y, z], dtype=np.float64) * 2.0 - 1.0
    n = math.sqrt(max(float(v @ v), 1e-20))
    return state, v / n


def seed_state(pixel_idx: int, sample_idx: int, root_seed: int) -> int:
    s = (
        (pixel_idx * 0x9E3779B9) & _MASK
        ^ (sample_idx * 0x85EBCA6B) & _MASK
        ^ (root_seed * 0xC2B2AE35) & _MASK
    )
    s, _ = pcg_next(s)
    s, _ = pcg_next(s)
    return s


# -- intersection (mirrors rtx_frag.glsl:92-192, scalar) --------------------

def ray_sphere(o, d, center, radius):
    oc = o - center
    a = float(d @ d)
    b = 2.0 * float(oc @ d)
    c = float(oc @ oc) - radius * radius
    det = b * b - 4.0 * a * c
    if det < 0:
        return -1.0
    sq = math.sqrt(det)
    t1 = (-b - sq) / (2 * a)
    if t1 >= 0:
        return t1
    t2 = (-b + sq) / (2 * a)
    if t2 >= 0:
        return t2
    return -1.0


def ray_triangle(o, d, v0, v1, v2):
    e1 = v1 - v0
    e2 = v2 - v0
    rce = np.cross(d, e2)
    det = float(e1 @ rce)
    if abs(det) < TRI_EPS:
        return -1.0
    inv = 1.0 / det
    s = o - v0
    u = inv * float(s @ rce)
    if u < TRI_EPS or u > 1.0:
        return -1.0
    sce = np.cross(s, e1)
    v = inv * float(d @ sce)
    if v < TRI_EPS or (u + v) > 1.0:
        return -1.0
    t = inv * float(e2 @ sce)
    if t < TRI_EPS:
        return -1.0
    return t


def _normalize(v):
    n = math.sqrt(max(float(v @ v), 1e-20))
    return v / n


def trace_ray(sc, o, d):
    """Linear closest-hit scan like trace_ray (rtx_frag.glsl:158-192)."""
    best_t = math.inf
    best = None
    for i in range(sc["ns"]):
        if not sc["sph_active"][i]:
            continue
        t = ray_sphere(o, d, sc["sph_center"][i], sc["sph_radius"][i])
        if 0 <= t < best_t:
            p = o + t * d
            best_t = t
            best = (p, _normalize(p - sc["sph_center"][i]), sc["sph_mat"][i])
    for i in range(sc["nt"]):
        if not sc["tri_active"][i]:
            continue
        v0, v1, v2 = sc["tri_v0"][i], sc["tri_v1"][i], sc["tri_v2"][i]
        t = ray_triangle(o, d, v0, v1, v2)
        if 0 <= t < best_t:
            p = o + t * d
            n = _normalize(np.cross(v0 - v1, v0 - v2))
            if float(n @ d) > 0:
                n = -n
            best_t = t
            best = (p, n, sc["tri_mat"][i])
    if best is None:
        return None
    return best_t, *best


def reflect(i, n):
    return i - 2.0 * float(n @ i) * n


def refract(i, n, eta):
    ni = float(n @ i)
    k = 1.0 - eta * eta * (1.0 - ni * ni)
    if k < 0:
        return None  # TIR
    # 1e-12 floor matches ops/sampling.refract's AD guard (value changes
    # only for k in [0, 1e-12) — exact critical angle).
    return eta * i - (eta * ni + math.sqrt(max(k, 1e-12))) * n


def incident_light(sc, o, d, state, max_bounces, variant="gpu"):
    """Single-path estimator, one scalar ray: mirrors trace_paths."""
    cpu_tier = variant == "cpu"
    total = np.zeros(3)
    thr = np.ones(3)
    for _ in range(max_bounces + 1):
        hit = trace_ray(sc, o, d)
        if hit is None:
            out = total + thr * sc["sky"]
            return (np.clip(out, 0, 1) if cpu_tier else out), state
        _, p, n_geom, mi = hit
        mat_emission = sc["m_emission_color"][mi] * sc["m_emission_strength"][mi]
        total = total + thr * mat_emission
        thr = thr * sc["m_albedo"][mi]

        if cpu_tier:
            state, sph = unit_sphere_biased(state)
        else:
            state, sph = unit_sphere(state)
        state, u_branch = uniform(state)

        rough = sc["m_roughness"][mi] * (0.5 if cpu_tier else 1.0)
        n = _normalize(n_geom + rough * sph)
        transp = sc["m_transparency"][mi]
        if u_branch < transp:
            ior = 1.5 if cpu_tier else sc["m_ior"][mi]
            ndot = float(d @ n)
            if ndot < 0:
                eta, rn = 1.0 / ior, n
            else:
                eta, rn = ior, -n
            new_d = refract(d, rn, eta)
            if new_d is None:
                # TIR refract ray dropped (glsl:261-262)
                return (np.clip(total, 0, 1) if cpu_tier else total), state
        else:
            new_d = reflect(d, n)
        # Scale-adaptive normal offset — see models/integrator.py.
        offs = EPS_OFFSET + 4e-6 * math.sqrt(float(p @ p))
        side = 1.0 if float(new_d @ n_geom) >= 0 else -1.0
        o = p + offs * side * n_geom
        d = new_d
    out = total + thr * sc["sky"]
    return (np.clip(out, 0, 1) if cpu_tier else out), state


SPLIT_SALT = 0x632BE59B  # models/split.SPLIT_SALT


def incident_light_split(sc, o, d, state, max_bounces):
    """The reference GPU shader's two-branch SPLIT estimator
    (rtx_frag.glsl:193-273), in the breadth-first order + per-node RNG
    contract of models/split.py: reflect child inherits the parent's
    advanced state, refract child takes one PCG hop off the salted
    parent. Slot k's children sit at 2k / 2k+1, exactly like the
    vectorized interleave."""
    total = np.zeros(3)
    level = [(o, d, np.ones(3), state)]
    for b in range(max_bounces + 1):
        nxt = []
        for (o_, d_, w, st) in level:
            hit = trace_ray(sc, o_, d_)
            if hit is None:
                total = total + w * sc["sky"]
                continue
            _, p, n_geom, mi = hit
            total = total + w * (
                sc["m_emission_color"][mi] * sc["m_emission_strength"][mi]
            )
            w = w * sc["m_albedo"][mi]

            st, sph = unit_sphere(st)
            n = _normalize(n_geom + sc["m_roughness"][mi] * sph)
            transp = sc["m_transparency"][mi]

            refl_d = reflect(d_, n)
            ndot = float(d_ @ n)
            eta, rn = (1.0 / sc["m_ior"][mi], n) if ndot < 0 else (
                sc["m_ior"][mi], -n)
            refr_d = refract(d_, rn, eta)  # None on TIR

            offs = EPS_OFFSET + 4e-6 * math.sqrt(float(p @ p))

            children = []
            if transp < 1.0:
                side = 1.0 if float(refl_d @ n_geom) >= 0 else -1.0
                children.append(
                    (p + offs * side * n_geom, refl_d, w * (1.0 - transp),
                     st)
                )
            if transp > 0.0 and refr_d is not None:
                cst, _ = pcg_next((st ^ SPLIT_SALT) & _MASK)
                side = 1.0 if float(refr_d @ n_geom) >= 0 else -1.0
                children.append(
                    (p + offs * side * n_geom, refr_d, w * transp, cst)
                )
            if b == max_bounces:
                for (_, _, cw, _) in children:
                    total = total + cw * sc["sky"]
            else:
                nxt.extend(children)
        level = nxt
        if not level:
            break
    return total


def render_split(scene, height, width, spp, max_bounces, seed,
                 fov_deg=90.0):
    """Golden split-estimator image; mirrors models/split.render_split."""
    sc = scene_to_numpy(scene)
    aspect = width / height
    tf = math.tan(math.radians(fov_deg) / 2)
    img = np.zeros((height, width, 3))
    for py in range(height):
        for px in range(width):
            x = (px + 0.5) / width * 2.0 - 1.0
            y = -((py + 0.5) / height * 2.0 - 1.0)
            d = _normalize(np.array([x * tf, y * tf / aspect, 1.0]))
            acc = np.zeros(3)
            for s in range(spp):
                state = seed_state(py * width + px, s, seed)
                acc += incident_light_split(
                    sc, np.zeros(3), d.copy(), state, max_bounces
                )
            img[py, px] = acc / spp
    return img


# -- physical tier (mirrors models/physical.py, scalar) ---------------------

def _onb(n):
    """Branchless Duff et al. orthonormal basis — scalar mirror of
    models/physical._onb."""
    nx, ny, nz = float(n[0]), float(n[1]), float(n[2])
    sign = 1.0 if nz >= 0.0 else -1.0
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = np.array([1.0 + sign * nx * nx * a, sign * b, -sign * nx])
    bv = np.array([b, sign + ny * ny * a, -ny])
    return t, bv


def trace_ray_kind(sc, o, d):
    """trace_ray plus whether the winner was a sphere and its index."""
    best_t = math.inf
    best = None
    for i in range(sc["ns"]):
        if not sc["sph_active"][i]:
            continue
        t = ray_sphere(o, d, sc["sph_center"][i], sc["sph_radius"][i])
        if 0 <= t < best_t:
            p = o + t * d
            best_t = t
            best = (p, _normalize(p - sc["sph_center"][i]), sc["sph_mat"][i],
                    True)
    for i in range(sc["nt"]):
        if not sc["tri_active"][i]:
            continue
        v0, v1, v2 = sc["tri_v0"][i], sc["tri_v1"][i], sc["tri_v2"][i]
        t = ray_triangle(o, d, v0, v1, v2)
        if 0 <= t < best_t:
            p = o + t * d
            n = _normalize(np.cross(v0 - v1, v0 - v2))
            if float(n @ d) > 0:
                n = -n
            best_t = t
            best = (p, n, sc["tri_mat"][i], False)
    if best is None:
        return None
    return best_t, *best


def _closest_t(sc, o, d):
    """Distance-only closest hit over every active object (shadow query)."""
    best_t = math.inf
    for i in range(sc["ns"]):
        if sc["sph_active"][i]:
            t = ray_sphere(o, d, sc["sph_center"][i], sc["sph_radius"][i])
            if 0 <= t < best_t:
                best_t = t
    for i in range(sc["nt"]):
        if sc["tri_active"][i]:
            t = ray_triangle(o, d, sc["tri_v0"][i], sc["tri_v1"][i],
                             sc["tri_v2"][i])
            if 0 <= t < best_t:
                best_t = t
    return best_t


def incident_light_physical(sc, o, d, state, max_bounces, nee=True):
    """Scalar mirror of models/physical.trace_paths_physical's ``step``:
    cosine-weighted diffuse / mirror specular / reference refract mixture,
    NEE by solid-angle cone sampling against emissive spheres with
    single-counting, fixed 7-draw schedule. Third, fully independent
    implementation of the physical estimator."""
    emitters = [
        i for i in range(sc["ns"])
        if sc["sph_active"][i]
        and sc["m_emission_strength"][sc["sph_mat"][i]] > 0.0
    ]
    n_em = len(emitters)
    total = np.zeros(3)
    thr = np.ones(3)
    prev_diff = False
    for _ in range(max_bounces + 1):
        hit = trace_ray_kind(sc, o, d)
        if hit is None:
            return total + thr * sc["sky"]
        _, p, nrm, mi, is_sphere = hit

        nee_counted = (
            nee and prev_diff and is_sphere
            and sc["m_emission_strength"][mi] > 0.0 and n_em > 0
        )
        if not nee_counted:
            total = total + thr * (
                sc["m_emission_color"][mi] * sc["m_emission_strength"][mi]
            )

        state, u_transp = uniform(state)
        state, u_lobe = uniform(state)
        state, u1 = uniform(state)
        state, u2 = uniform(state)
        state, u_pick = uniform(state)
        state, v1 = uniform(state)
        state, v2 = uniform(state)

        transp = sc["m_transparency"][mi]
        rough = sc["m_roughness"][mi]
        choose_refr = u_transp < transp
        choose_diff = (not choose_refr) and (u_lobe < rough)

        if choose_refr:
            ior = sc["m_ior"][mi]
            ndot = float(d @ nrm)
            eta, rn = (1.0 / ior, nrm) if ndot < 0 else (ior, -nrm)
            new_d = refract(d, rn, eta)
            if new_d is None:  # TIR death
                return total
        elif choose_diff:
            # cosine-weighted hemisphere about the geometric normal
            r_ = math.sqrt(u1)
            cphi_d, sphi_d = sincos_2pi(u2)
            lx = r_ * cphi_d
            ly = r_ * sphi_d
            lz = math.sqrt(max(1.0 - u1, 0.0))
            t_ax, b_ax = _onb(nrm)
            new_d = lx * t_ax + ly * b_ax + lz * nrm
        else:
            new_d = reflect(d, nrm)

        offs = EPS_OFFSET + 4e-6 * math.sqrt(float(p @ p))
        shadow_o = p + offs * nrm

        if nee and n_em > 0 and choose_diff:
            k = min(int(u_pick * n_em), n_em - 1)
            e = emitters[k]
            c_e = sc["sph_center"][e]
            r_e = float(sc["sph_radius"][e])
            m_e = sc["sph_mat"][e]
            le = sc["m_emission_color"][m_e] * sc["m_emission_strength"][m_e]

            dc = c_e - shadow_o
            d2 = float(dc @ dc)
            dist = math.sqrt(max(d2, 1e-12))
            wz = dc / dist
            sin2max = min(max(r_e * r_e / max(d2, 1e-12), 0.0), 1.0 - 1e-7)
            cosmax = math.sqrt(1.0 - sin2max)
            outside = d2 > r_e * r_e
            cth = 1.0 - v1 * (1.0 - cosmax)
            sth = math.sqrt(max(1.0 - cth * cth, 1e-12))
            cphi, sphi = sincos_2pi(v2)
            t_ax, b_ax = _onb(wz)
            omega = (
                sth * cphi * t_ax
                + sth * sphi * b_ax
                + cth * wz
            )
            pdf_omega = 1.0 / max(2.0 * math.pi * (1.0 - cosmax), 1e-8)
            cos_surf = float(nrm @ omega)

            t_e = ray_sphere(shadow_o, omega, c_e, r_e)
            t_e = math.inf if t_e < 0 else t_e
            s_t = _closest_t(sc, shadow_o, omega)
            visible = (
                s_t < math.inf
                and s_t >= t_e * (1.0 - 1e-3) - 1e-4
                and math.isfinite(t_e)
            )
            if outside and cos_surf > 0.0 and visible:
                total = total + thr * (sc["m_albedo"][mi] / math.pi) * le * (
                    cos_surf / pdf_omega * n_em
                )

        thr = thr * sc["m_albedo"][mi]
        side = 1.0 if float(new_d @ nrm) >= 0 else -1.0
        o = p + offs * side * nrm
        d = new_d
        prev_diff = choose_diff if nee else prev_diff
    return total + thr * sc["sky"]


def render_physical(scene, height, width, spp, max_bounces, seed,
                    fov_deg=90.0, nee=True):
    """Golden physical-tier image; mirrors models/physical.render_physical
    with jitter=False."""
    sc = scene_to_numpy(scene)
    aspect = width / height
    tf = math.tan(math.radians(fov_deg) / 2)
    img = np.zeros((height, width, 3))
    for py in range(height):
        for px in range(width):
            x = (px + 0.5) / width * 2.0 - 1.0
            y = -((py + 0.5) / height * 2.0 - 1.0)
            d = _normalize(np.array([x * tf, y * tf / aspect, 1.0]))
            acc = np.zeros(3)
            for s in range(spp):
                state = seed_state(py * width + px, s, seed)
                acc += incident_light_physical(
                    sc, np.zeros(3), d.copy(), state, max_bounces, nee=nee
                )
            img[py, px] = acc / spp
    return img


def scene_to_numpy(scene):
    """Flatten a path_tracer_jax Scene pytree into plain numpy arrays."""
    import jax

    g = lambda x: np.asarray(jax.device_get(x), dtype=np.float64)
    return dict(
        ns=int(scene.num_spheres),
        nt=int(scene.num_triangles),
        sph_center=g(scene.spheres.center),
        sph_radius=g(scene.spheres.radius),
        sph_mat=np.asarray(jax.device_get(scene.spheres.material)),
        sph_active=np.asarray(jax.device_get(scene.spheres.active)),
        tri_v0=g(scene.triangles.v0),
        tri_v1=g(scene.triangles.v1),
        tri_v2=g(scene.triangles.v2),
        tri_mat=np.asarray(jax.device_get(scene.triangles.material)),
        tri_active=np.asarray(jax.device_get(scene.triangles.active)),
        m_albedo=g(scene.materials.albedo),
        m_roughness=g(scene.materials.roughness),
        m_emission_color=g(scene.materials.emission_color),
        m_emission_strength=g(scene.materials.emission_strength),
        m_transparency=g(scene.materials.transparency),
        m_ior=g(scene.materials.refractive_index),
        sky=g(scene.sky_color),
    )


def render(scene, height, width, spp, max_bounces, seed, fov_deg=90.0,
           variant="gpu"):
    """Golden radiance image, (H, W, 3) float64. Slow; keep images tiny."""
    sc = scene_to_numpy(scene)
    aspect = width / height
    tf = math.tan(math.radians(fov_deg) / 2)
    img = np.zeros((height, width, 3))
    for py in range(height):
        for px in range(width):
            x = (px + 0.5) / width * 2.0 - 1.0
            y = -((py + 0.5) / height * 2.0 - 1.0)
            d = _normalize(np.array([x * tf, y * tf / aspect, 1.0]))
            o = np.zeros(3)
            acc = np.zeros(3)
            pixel_idx = py * width + px
            for s in range(spp):
                state = seed_state(pixel_idx, s, seed)
                li, _ = incident_light(
                    sc, o.copy(), d.copy(), state, max_bounces, variant
                )
                acc += li
            img[py, px] = acc / spp
    return img
