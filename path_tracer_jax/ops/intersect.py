"""Vectorized ray-scene intersection.

Vectorized replacement for the reference's two intersection code paths (C2:
``/root/reference/src/ray.c``; C9: ``shaders/rtx_frag.glsl:92-192``): the
per-object linear scan with early-out becomes a **batched rays x objects
evaluation plus a masked argmin** — branch-free and statically shaped;
the dot products against object tables are (N,3)x(3,S) contractions.

Semantics follow the GPU backend (SURVEY.md SS7 picks rtx_frag.glsl as the
spec):

* sphere: quadratic with the *nearer non-negative* root, ``t1 >= 0 ? t1 :
  (t2 >= 0 ? t2 : miss)`` (rtx_frag.glsl:92-117);
* triangle: Moller-Trumbore with eps = 1e-6 rejecting ``u < eps``, ``u > 1``,
  ``v < eps``, ``u + v > 1``, ``t < eps`` (rtx_frag.glsl:121-156);
* closest hit = positive-t minimum. The reference's closest-hit guard
  (``dist >= closest && closest > 0``, src/ray.c:25 / rtx_frag.glsl:166)
  reduces to exactly this — its only extra behavior is garbage metadata when
  *nothing* hits, which callers never read;
* sphere normal = normalize(p - center) (rtx_frag.glsl:171); triangle normal
  = face normal of cross(v0-v1, v0-v2) flipped to oppose the ray direction
  (rtx_frag.glsl:185-186, src/ray.c:50-56).

Misses are encoded as ``t = +inf`` (the reference uses -1; +inf makes the
argmin trivial and the mask explicit).

Differentiability: the winning-object *index* is discrete (gradients do not
flow through it — the standard detached-discontinuity treatment, SURVEY.md
SS7 hard-part (b)), but ``t``, the hit point and the normal are smooth in
the winning object's parameters, which is what the inverse-rendering
gradients need.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
import dataclasses

import jax
import numpy as np
import jax.numpy as jnp

from ..scene.scene import Scene

__all__ = ["Hit", "ray_sphere_t", "ray_triangle_t", "trace"]

# numpy scalar, not jnp: a module-level jnp constant would initialize the
# XLA backend at import time, which breaks jax.distributed.initialize
# (must run before any backend use).
INF = np.float32(np.inf)
_TRI_EPS = 1e-6  # rtx_frag.glsl:123


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass(frozen=True)
class Hit:
    """Batched ray-hit record, the SoA analog of ``RayHit``
    (rtx_frag.glsl:19-24 / include/ray.h:7-12)."""

    t: jnp.ndarray  # (N,) distance; +inf on miss
    point: jnp.ndarray  # (N, 3)
    normal: jnp.ndarray  # (N, 3) unit, opposing the ray for triangles
    material: jnp.ndarray  # (N,) int32
    mask: jnp.ndarray  # (N,) bool — True where the ray hit something
    is_sphere: jnp.ndarray  # (N,) bool — winning object kind
    obj_idx: jnp.ndarray  # (N,) int32 — index within its kind's table


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _safe_normalize(v, eps=1e-20):
    return v * jax.lax.rsqrt(jnp.maximum(_dot(v, v), eps))[..., None]


def ray_sphere_t(o, d, center, radius, active):
    """All-pairs ray/sphere distances: (N,3) rays x (S,) spheres -> (N,S).

    Quadratic solve of rtx_frag.glsl:92-117, vectorized. Like the GLSL
    (rtx_frag.glsl:94) the ray is translated into the sphere's frame
    *before* squaring — the expanded ``|o|^2 - 2 o.c + |c|^2`` form loses
    ~ulp(|o|^2) to cancellation in f32, which for large distant spheres
    exceeds the self-intersection offset and makes secondary rays re-hit
    their own surface. ``sqrt`` is guarded so reverse-mode AD never sees a
    NaN from grazing / missing rays.
    """
    dd = _dot(d, d)[:, None]
    oc = o[:, None, :] - center[None, :, :]  # (N,S,3)
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)  # (N,S)
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    det = b * b - 4.0 * dd * c
    valid = det >= 0.0
    sq = jnp.sqrt(jnp.where(valid, jnp.maximum(det, 1e-30), 1.0))
    inv_2a = 0.5 / dd
    t1 = (-b - sq) * inv_2a
    t2 = (-b + sq) * inv_2a
    t = jnp.where(t1 >= 0.0, t1, jnp.where(t2 >= 0.0, t2, INF))
    t = jnp.where(valid & active[None, :], t, INF)
    return t


def ray_triangle_t(o, d, v0, v1, v2, active):
    """All-pairs Moller-Trumbore distances: (N,3) rays x (T,) tris -> (N,T).

    Vectorization of rtx_frag.glsl:121-156 (same eps and rejection tests).
    """
    # Full f32 products: a TF32 contraction on the GPU would move hit
    # decisions away from the scalar oracle's.
    dot = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    e1 = v1 - v0  # (T,3)
    e2 = v2 - v0
    rce = jnp.cross(d[:, None, :], e2[None, :, :])  # (N,T,3)
    det = dot("tc,ntc->nt", e1, rce)
    nonparallel = jnp.abs(det) >= _TRI_EPS
    inv = 1.0 / jnp.where(nonparallel, det, 1.0)
    s = o[:, None, :] - v0[None, :, :]  # (N,T,3)
    u = inv * dot("ntc,ntc->nt", s, rce)
    sce = jnp.cross(s, e1[None, :, :])  # (N,T,3)
    v = inv * dot("nc,ntc->nt", d, sce)
    t = inv * dot("tc,ntc->nt", e2, sce)
    ok = (
        nonparallel
        & (u >= _TRI_EPS)
        & (u <= 1.0)
        & (v >= _TRI_EPS)
        & (u + v <= 1.0)
        & (t >= _TRI_EPS)
        & active[None, :]
    )
    return jnp.where(ok, t, INF)


def trace(o, d, scene: Scene) -> Hit:
    """Closest-hit query for a wavefront of rays against the whole scene.

    Replaces ``trace_ray`` (rtx_frag.glsl:158-192, src/ray.c:4-73): every
    ray tests every active object, then a single argmin picks the winner.
    """
    S = scene.num_spheres
    ts = ray_sphere_t(
        o, d, scene.spheres.center, scene.spheres.radius, scene.spheres.active
    )
    tt = ray_triangle_t(
        o,
        d,
        scene.triangles.v0,
        scene.triangles.v1,
        scene.triangles.v2,
        scene.triangles.active,
    )
    t_all = jnp.concatenate([ts, tt], axis=1)  # (N, S+T)
    idx = jnp.argmin(t_all, axis=1)  # (N,) int — detached by construction
    t = jnp.take_along_axis(t_all, idx[:, None], axis=1)[:, 0]
    mask = jnp.isfinite(t)
    t_safe = jnp.where(mask, t, 0.0)
    point = o + t_safe[:, None] * d

    is_sphere = idx < S
    sidx = jnp.clip(idx, 0, S - 1)
    tidx = jnp.clip(idx - S, 0, scene.num_triangles - 1)

    center_sel = scene.spheres.center[sidx]  # (N,3)
    n_sphere = _safe_normalize(point - center_sel)

    v0 = scene.triangles.v0[tidx]
    v1 = scene.triangles.v1[tidx]
    v2 = scene.triangles.v2[tidx]
    n_tri = _safe_normalize(jnp.cross(v0 - v1, v0 - v2))
    # Flip to oppose the ray (rtx_frag.glsl:186).
    n_tri = jnp.where(_dot(n_tri, d)[:, None] < 0.0, n_tri, -n_tri)

    normal = jnp.where(is_sphere[:, None], n_sphere, n_tri)
    material = jnp.where(
        is_sphere, scene.spheres.material[sidx], scene.triangles.material[tidx]
    )
    return Hit(
        t=t, point=point, normal=normal, material=material, mask=mask,
        is_sphere=is_sphere, obj_idx=jnp.where(is_sphere, sidx, tidx),
    )
