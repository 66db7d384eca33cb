"""Differentiable rendering: losses, gradients, inverse-rendering optimizer.

The reference has no gradient story at all; this module is the
BASELINE.json north-star capability ("reparameterized/detached-sampling
gradients ... so pixel gradients w.r.t. material albedo, emission, and
geometry parameters match a finite-difference reference").

How the estimator stays differentiable (SURVEY.md SS7 hard-part (b)):

* all RNG decisions are **detached by construction** — PCG states are
  uint32 (no tangents), sample directions enter shading through smooth
  arithmetic, and branch *selection* compares against a stop-gradient of
  transparency while a ratio factor re-attaches d/d(transparency)
  (models/integrator.py);
* material gradients (albedo, emission, sky) flow through the pure
  throughput/emission product chain — exactly smooth, FD-matchable;
* geometry gradients (sphere center/radius, triangle vertices) flow
  through the closest-hit distance, hit point and normal of the *winning*
  object (the argmin index itself is discrete). Note a structural property
  inherited from the reference shading model: path radiance is a product of
  albedos and emissions selected by discrete path events, with **no
  continuous geometry term** (no cosine factors, no 1/r^2 — see
  rtx_frag.glsl:226-230), so away from visibility edges the image is
  piecewise-constant in geometry and the true interior gradient is zero.
  AD and FD agree exactly there (both zero). Non-trivial geometry
  gradients require shading terms that touch geometry continuously —
  the physical tier (models/physical.py) provides them: its next-event
  estimation carries cosine and solid-angle factors, making sphere-light
  center/radius gradients nonzero and FD-matchable (tests/test_physical).

Fixed seeds make renders deterministic, so finite differences see the same
sample paths and the comparison is quadrature-tight, not Monte-Carlo-loose.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from .. import backend
from ..models.integrator import render_radiance
from ..scene.scene import Scene

__all__ = [
    "mse_loss",
    "render_loss",
    "loss_and_grad",
    "make_material_params",
    "apply_material_params",
    "fit_materials",
    "make_geometry_params",
    "apply_geometry_params",
    "fit_geometry",
    "fit_camera",
]


def mse_loss(img, target):
    """Mean squared pixel error — the inverse-rendering objective."""
    return jnp.mean((img - target) ** 2)


def render_loss(
    scene: Scene, target, camera, height, width, spp, max_bounces, seed,
    engine: str = "auto",
    rough_grad: bool = False,
    interpret: bool = False,
):
    """Differentiable pixel loss. ``engine="auto"`` uses the fused Pallas
    primal + Jacobian kernel on the GPU (ops/pallas_grad.py) when the
    shapes tile, the XLA core path elsewhere — and WARNS when a GPU
    shape forces the slower core backward, so the fallback is never
    silent. ``engine="physical"``/``"physical_pallas"`` fit against the
    physical BRDF/NEE tier (core AD / fused Pallas kernel).
    ``rough_grad=True`` (physical engines only) enables the
    score-function roughness gradient — bit-identical primal, REINFORCE
    tangent; the Pallas engine emits it as 3 extra Jacobian planes per
    material (ops/pallas_physical). ``interpret=True`` runs the Pallas
    engines in the Pallas interpreter (backend.kernel_interpret)."""
    if rough_grad and engine not in ("physical", "physical_pallas"):
        raise ValueError(
            "rough_grad requires a physical engine (the score-function "
            "roughness estimator lives in the physical tier); got "
            f"engine={engine!r}. The reference tier keeps roughness "
            "detached by contract."
        )
    if engine in ("physical", "physical_pallas"):
        if engine == "physical_pallas":
            from ..ops.pallas_physical import render_physical_pallas_vjp

            # material-fit objective: the fused primal+Jacobian kernel
            # (geom=False) — geometry cotangents aren't consumed here
            img = render_physical_pallas_vjp(
                scene, camera, height, width, spp, max_bounces, seed,
                jitter=False, geom=False, rough_grad=rough_grad,
                interpret=interpret,
            )
        else:
            from ..models.physical import render_physical

            img = render_physical(
                scene, camera, height, width, spp, max_bounces, seed,
                jitter=False, remat=True, rough_grad=rough_grad,
            )
        return mse_loss(img, target)
    if engine == "auto":
        engine = backend.auto_engine()
        if engine == "pallas":
            from ..ops.pallas_grad import FUSED_TILE

            th, tw = FUSED_TILE
            if height % th or width % tw:
                import warnings

                warnings.warn(
                    f"render_loss: {height}x{width} is not "
                    f"{th}x{tw}-tileable; falling back to the XLA core "
                    "backward (slower than the fused Pallas VJP). Pad the "
                    f"image to multiples of {th}x{tw} to use the fast path.",
                    stacklevel=2,
                )
                engine = "core"
    if engine == "pallas":
        from ..ops.pallas_kernels import render_pallas_vjp

        img = render_pallas_vjp(
            scene, camera, height, width, spp, max_bounces, seed,
            interpret=interpret,
        )
    else:
        img = render_radiance(
            scene, camera, height, width, spp, max_bounces, seed, remat=True
        )
    return mse_loss(img, target)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 8))
def loss_and_grad(scene, target, camera, height, width, spp, max_bounces,
                  seed, engine: str = "auto"):
    """(loss, d loss / d scene) — gradients for every scene leaf.

    ``engine`` selects the differentiable render path (render_loss)."""
    return jax.value_and_grad(
        lambda sc: render_loss(
            sc, target, camera, height, width, spp, max_bounces, seed,
            engine=engine,
        ),
        allow_int=True,  # int leaves (indices, masks) get float0 grads
    )(scene)


# -- constrained material parameterization ----------------------------------
#
# Optimizing raw scene leaves can leave the physical domain (albedo outside
# [0,1], negative emission). The fit runs in an unconstrained space and maps
# back smoothly: albedo via sigmoid of logits, emission strength via
# softplus, emission color via sigmoid.

_EPS = 1e-6


def _logit(p):
    p = jnp.clip(p, _EPS, 1.0 - _EPS)
    return jnp.log(p) - jnp.log1p(-p)


def _inv_softplus(y):
    y = jnp.maximum(y, _EPS)
    return y + jnp.log(-jnp.expm1(-y))


def make_material_params(scene: Scene, include_roughness: bool = False):
    """Extract unconstrained optimization variables from a scene.
    ``include_roughness=True`` adds a roughness logit (sigmoid-mapped,
    stays in (0,1)) — pair with a ``rough_grad=True`` fit, since
    roughness is otherwise detached in every tier."""
    m = scene.materials
    params = {
        "albedo_logit": _logit(m.albedo),
        "emission_color_logit": _logit(m.emission_color),
        "emission_strength_raw": _inv_softplus(m.emission_strength),
    }
    if include_roughness:
        params["roughness_logit"] = _logit(m.roughness)
    return params


def apply_material_params(scene: Scene, params) -> Scene:
    """Scene with materials replaced by the constrained mapping of params."""
    import dataclasses

    m = dataclasses.replace(
        scene.materials,
        albedo=jax.nn.sigmoid(params["albedo_logit"]),
        emission_color=jax.nn.sigmoid(params["emission_color_logit"]),
        emission_strength=jax.nn.softplus(params["emission_strength_raw"]),
    )
    if "roughness_logit" in params:
        m = dataclasses.replace(
            m, roughness=jax.nn.sigmoid(params["roughness_logit"])
        )
    return dataclasses.replace(scene, materials=m)


def _run_fit_loop(step_fn, params, opt_state, steps, seed0, callback,
                  checkpoint_path=None, checkpoint_every: int = 0):
    """Shared optimizer driver: per-step seeds are STEP-INDEXED
    (``seed0 + i + 1``), so a run resumed from a fit checkpoint replays
    exactly the seeds an uninterrupted run would have used — resumed fits
    are bit-identical (utils/checkpoint.save_fit)."""
    from pathlib import Path

    from ..utils import checkpoint as ckpt_mod

    start, losses = 0, []
    if checkpoint_path and Path(checkpoint_path).exists():
        start, params, opt_state, losses = ckpt_mod.load_fit(
            checkpoint_path, params, opt_state
        )
    for i in range(start, steps):
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.uint32(seed0 + i + 1)
        )
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
        if checkpoint_path and checkpoint_every and (
            (i + 1) % checkpoint_every == 0 or i + 1 == steps
        ):
            ckpt_mod.save_fit(checkpoint_path, i + 1, params, opt_state,
                              losses)
    return params, losses


def fit_materials(
    scene_init: Scene,
    target,
    camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    steps: int = 100,
    lr: float = 0.05,
    seed0: int = 0,
    callback=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    engine: str = "auto",
    rough_grad: bool = False,
    interpret: bool = False,
):
    """Recover albedo + emission from a target image (BASELINE config 4).

    Adam in the unconstrained space; a fresh RNG seed per step so the
    gradient is an unbiased estimate over sample paths (fixed-seed renders
    would overfit one path realization). ``checkpoint_path`` /
    ``checkpoint_every`` persist optimizer state every N steps; an
    existing checkpoint resumes bit-identically (step-indexed seeds).
    ``engine`` selects the differentiable render path (see
    :func:`render_loss`; ``interpret`` is passed on to it).
    ``rough_grad=True`` ALSO fits roughness via
    the score-function estimator (physical engines only; the Pallas
    engine emits the REINFORCE term as fused Jacobian planes). The
    REINFORCE term is higher-variance than the smooth material
    gradients, so prefer more spp or a lower lr for
    roughness-dominated fits. Returns ``(scene, losses)``.
    """
    if rough_grad and engine not in ("physical", "physical_pallas"):
        raise ValueError(
            "fit_materials(rough_grad=True) requires a physical engine "
            f"(got {engine!r}) — see render_loss"
        )

    params = make_material_params(scene_init, include_roughness=rough_grad)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @partial(jax.jit, static_argnums=())
    def step(params, opt_state, seed):
        def loss_fn(p):
            sc = apply_material_params(scene_init, p)
            return render_loss(
                sc, target, camera, height, width, spp, max_bounces, seed,
                engine=engine, rough_grad=rough_grad, interpret=interpret,
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    params, losses = _run_fit_loop(
        step, params, opt_state, steps, seed0, callback,
        checkpoint_path, checkpoint_every,
    )
    return apply_material_params(scene_init, params), losses


# -- geometry recovery (physical tier) ---------------------------------------
#
# The reference shading model is piecewise-constant in geometry (see module
# docstring), so geometry fits run the PHYSICAL tier, whose NEE cosine and
# solid-angle factors give sphere center/radius (and triangle vertex)
# parameters nonzero, FD-matchable interior gradients
# (tests/test_physical.py).


def make_geometry_params(scene: Scene, sphere_indices,
                         triangle_indices=()):
    """Unconstrained optimization variables for selected geometry:
    raw sphere centers + inverse-softplus radii (radius stays positive),
    and — when ``triangle_indices`` is nonempty — raw triangle vertices
    stacked as ``(T_sel, 3 verts, 3)``."""
    params = {}
    if len(tuple(sphere_indices)):
        idx = jnp.asarray(sphere_indices, jnp.int32)
        params["center"] = scene.spheres.center[idx]
        params["radius_raw"] = _inv_softplus(scene.spheres.radius[idx])
    if len(tuple(triangle_indices)):
        tidx = jnp.asarray(triangle_indices, jnp.int32)
        params["tri_v"] = jnp.stack(
            [scene.triangles.v0[tidx], scene.triangles.v1[tidx],
             scene.triangles.v2[tidx]], axis=1,
        )
    return params


def apply_geometry_params(scene: Scene, params, sphere_indices,
                          triangle_indices=()) -> Scene:
    import dataclasses

    if "center" in params:
        idx = jnp.asarray(sphere_indices, jnp.int32)
        sph = dataclasses.replace(
            scene.spheres,
            center=scene.spheres.center.at[idx].set(params["center"]),
            radius=scene.spheres.radius.at[idx].set(
                jax.nn.softplus(params["radius_raw"])
            ),
        )
        scene = dataclasses.replace(scene, spheres=sph)
    if "tri_v" in params:
        tidx = jnp.asarray(triangle_indices, jnp.int32)
        tv = params["tri_v"]
        tri = dataclasses.replace(
            scene.triangles,
            v0=scene.triangles.v0.at[tidx].set(tv[:, 0]),
            v1=scene.triangles.v1.at[tidx].set(tv[:, 1]),
            v2=scene.triangles.v2.at[tidx].set(tv[:, 2]),
        )
        scene = dataclasses.replace(scene, triangles=tri)
    return scene


def fit_geometry(
    scene_init: Scene,
    target,
    camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    sphere_indices=(0,),
    steps: int = 100,
    lr: float = 0.02,
    seed0: int = 0,
    callback=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    engine: str = "physical",
    triangle_indices=(),
    tri_nee: bool | None = None,
    interpret: bool = False,
):
    """Recover geometry (sphere center/radius and/or triangle vertices)
    from a target image.

    Runs the physical-tier estimator (the only tier with continuous
    geometry dependence). ``engine="physical"`` (default) uses core-path
    AD — complete interior gradients. ``engine="physical_pallas"`` uses
    the fused Pallas kernel, whose geometry cotangents carry the NEE
    emitter chains (sphere center/radius through the cone weight;
    triangle vertices through the area/cos/d^2 weight —
    ops/pallas_physical.py): valid when the fitted geometry belongs to
    the emissive objects, as in light-source recovery (fitting
    NON-emissive geometry under this engine warns — its gradient would
    be exactly zero). The emitter-geometry caps are sized to the scene's
    live emitter counts automatically, so no light silently freezes.
    ``triangle_indices`` selects triangles whose vertices are fitted;
    ``tri_nee`` defaults to True when triangles are fitted (the
    triangle-vertex chain only exists in the tri-NEE estimator).
    ``interpret=True`` runs the Pallas engine in the Pallas interpreter.
    Interior gradients only in both engines: visibility-edge
    (silhouette) gradients are not modeled. Returns
    ``(scene, losses)``.
    """
    from ..models.physical import render_physical

    sphere_indices = tuple(int(i) for i in sphere_indices)
    triangle_indices = tuple(int(i) for i in triangle_indices)
    if tri_nee is None:
        tri_nee = bool(triangle_indices)
    n_em_cap = 0
    tri_em_cap = 0
    if engine == "physical_pallas":
        import warnings

        from ..ops.pallas_physical import (
            live_emitter_mask, live_tri_emitter_mask,
        )

        # concrete scene: size the caps to the live emitter counts so
        # every emitter ordinal is tracked (no silent zeros); the masks
        # are the ONE shared host-side emitter
        # definition (ops/pallas_physical.live_*_emitter_mask)
        em = live_emitter_mask(scene_init)
        n_em_cap = max(int(em.sum()), 1)
        non_em = [int(i) for i in sphere_indices if not em[int(i)]]
        em_t = live_tri_emitter_mask(scene_init)
        tri_em_cap = max(int(em_t.sum()), 1) if tri_nee else 0
        non_em_t = [
            int(i) for i in triangle_indices
            if not (tri_nee and em_t[int(i)])
        ]
        if non_em or non_em_t:
            what = []
            if non_em:
                what.append(f"spheres {non_em}")
            if non_em_t:
                what.append(
                    f"triangles {non_em_t}"
                    + ("" if tri_nee else " (tri_nee is off)")
                )
            warnings.warn(
                f"fit_geometry(engine='physical_pallas'): {' and '.join(what)} "
                "are not light-sampled emitters — the fused kernel's "
                "geometry cotangent carries only the NEE emitter chains, "
                "so their gradients are exactly zero and they will not "
                "move. Use engine='physical' (core AD) for non-emitter "
                "geometry.",
                stacklevel=2,
            )
    params = make_geometry_params(scene_init, sphere_indices,
                                  triangle_indices)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, seed):
        def loss_fn(p):
            sc = apply_geometry_params(scene_init, p, sphere_indices,
                                       triangle_indices)
            if engine == "physical_pallas":
                from ..ops.pallas_physical import render_physical_pallas_vjp

                img = render_physical_pallas_vjp(
                    sc, camera, height, width, spp, max_bounces, seed,
                    nee=True, jitter=False, n_em_cap=n_em_cap,
                    tri_nee=tri_nee, tri_em_cap=tri_em_cap,
                    interpret=interpret,
                )
            else:
                img = render_physical(
                    sc, camera, height, width, spp, max_bounces, seed,
                    nee=True, jitter=False, remat=True, tri_nee=tri_nee,
                )
            return mse_loss(img, target)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    params, losses = _run_fit_loop(
        step, params, opt_state, steps, seed0, callback,
        checkpoint_path, checkpoint_every,
    )
    return (
        apply_geometry_params(scene_init, params, sphere_indices,
                              triangle_indices),
        losses,
    )


# -- camera recovery (physical tier) ------------------------------------------
#
# The Pallas physical VJP's camera cotangents are ZERO BY CONTRACT (an
# approximation — ops/pallas_physical.render_physical_pallas_vjp), so a
# camera fit routed through engine="physical_pallas" would silently not
# move. fit_camera routes camera fits: core AD by default, an explicit hard
# error for the Pallas engine, and a finite-difference mode that drives the
# fast Pallas forward (13 renders per step for 6 camera scalars).


def fit_camera(
    scene: Scene,
    target,
    camera_init,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    steps: int = 50,
    lr: float = 0.02,
    seed0: int = 0,
    callback=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    engine: str = "physical",
    fd_eps: float = 1e-3,
    fov_deg: float | None = None,
    interpret: bool = False,
):
    """Recover camera pose (origin + look-at target, 6 scalars) from a
    target image, physical tier.

    ``engine="physical"`` (default): core-path AD — exact interior
    gradients. ``engine="physical_fd"``: central finite differences over
    the 6 pose scalars, each loss evaluated through the fast Pallas
    physical forward (``render_physical_pallas``) — 13 renders per step,
    fixed per-step seed so the differences are quadrature-tight.
    ``engine="physical_pallas"`` RAISES: that VJP's camera cotangents
    are zero by contract, and a silently frozen camera fit must not be
    constructible. ``interpret=True`` runs the ``physical_fd`` engine's
    Pallas forward in the Pallas interpreter. Returns ``(camera,
    losses)``.
    """
    import jax.flatten_util  # registers jax.flatten_util.ravel_pytree
    import jax.numpy as jnp

    from ..ops.camera import Camera

    if engine == "physical_pallas":
        raise ValueError(
            "fit_camera(engine='physical_pallas') would silently not "
            "move: the Pallas physical VJP's camera cotangents are zero "
            "by contract (see render_physical_pallas_vjp). Use "
            "engine='physical' (core AD) or engine='physical_fd' "
            "(finite differences over the fast Pallas forward)."
        )
    if engine not in ("physical", "physical_fd"):
        raise ValueError(f"unknown fit_camera engine {engine!r}")

    import numpy as np

    o0 = jnp.asarray(camera_init.origin, jnp.float32)
    t0 = o0 + camera_init.forward / jnp.maximum(
        jnp.linalg.norm(camera_init.forward), 1e-8
    )
    params = {"origin": o0, "target": t0}
    # FOV and the up hint come from camera_init unless overridden — a
    # hardcoded 90 would silently fit a wrong-FOV camera for any
    # non-default camera_init.
    if fov_deg is None:
        fov_deg = float(np.rad2deg(np.asarray(camera_init.fov)))
    up_hint = tuple(np.asarray(camera_init.up, np.float32))

    def cam_of(p):
        return Camera.look_at(p["origin"], p["target"], up=up_hint,
                              fov_deg=fov_deg)

    if engine == "physical":
        from ..models.physical import render_physical

        def loss_fn(p, seed):
            img = render_physical(
                scene, cam_of(p), height, width, spp, max_bounces, seed,
                jitter=False, remat=True,
            )
            return mse_loss(img, target)

        @jax.jit
        def value_and_grad(p, seed):
            return jax.value_and_grad(loss_fn)(p, seed)
    else:
        from ..ops.pallas_physical import render_physical_pallas

        def loss_val(p, seed):
            img = render_physical_pallas(
                scene, cam_of(p), height, width, spp, max_bounces, seed,
                jitter=False, interpret=interpret,
            )
            return mse_loss(img, target)

        flat0, unravel = jax.flatten_util.ravel_pytree(params)
        n_par = flat0.shape[0]

        @jax.jit
        def value_and_grad(p, seed):
            flat, _ = jax.flatten_util.ravel_pytree(p)
            base = loss_val(p, seed)
            gs = []
            for i in range(n_par):  # unrolled: 2 fast renders per scalar
                e = jnp.zeros_like(flat).at[i].set(fd_eps)
                lp = loss_val(unravel(flat + e), seed)
                lm = loss_val(unravel(flat - e), seed)
                gs.append((lp - lm) / (2.0 * fd_eps))
            return base, unravel(jnp.stack(gs))

    opt = optax.adam(lr)
    opt_state = opt.init(params)

    # The pose landscape is steep and narrow (a small pose change
    # misaligns every pixel), so Adam routinely overshoots the minimum
    # and oscillates after converging — return the BEST-seen pose, not
    # the last iterate (measured: min loss 3e-6 vs final 0.39 on the
    # recovery test without this). The best pose rides INSIDE the
    # fit-loop state so checkpoint/resume restores it too (a
    # session-local best would silently return the initial pose on a
    # resumed/completed-checkpoint run).
    state = {"opt": params, "best": params,
             "best_loss": jnp.float32(jnp.inf)}

    def step(state, opt_state, seed):
        loss, grads = value_and_grad(state["opt"], seed)
        better = loss < state["best_loss"]
        best = jax.tree_util.tree_map(
            lambda b, c: jnp.where(better, c, b), state["best"],
            state["opt"],
        )
        updates, opt_state = opt.update(grads, opt_state)
        new_p = optax.apply_updates(state["opt"], updates)
        new_state = {"opt": new_p, "best": best,
                     "best_loss": jnp.minimum(state["best_loss"], loss)}
        return new_state, opt_state, loss

    state, losses = _run_fit_loop(
        step, state, opt_state, steps, seed0, callback,
        checkpoint_path, checkpoint_every,
    )
    return cam_of(state["best"]), losses
