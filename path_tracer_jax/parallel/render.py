"""Sharded rendering and training steps: ``shard_map`` over a device mesh.

This is the distributed layer the reference lacks entirely (SURVEY.md SS2
"Distributed communication backend: none exists"): image row-blocks shard
over the ``tile`` mesh axis, Monte-Carlo samples split over the ``spp``
axis with a ``pmean`` reduction, the scene replicates everywhere, and
inverse-rendering gradients ``psum`` across the whole mesh (handled by
shard_map's transpose of the replicated in_spec). All collectives are XLA
collectives: pick a mesh, annotate shardings, let XLA insert the comms.

Determinism: RNG streams key on global pixel/sample indices
(ops/camera.pixel_indices + rng.seed_state), so for any mesh shape the
sharded render is **bit-identical** to the single-device render — the
property the multi-host tests pin down.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.integrator import render_tile
from ..ops.camera import Camera
from ..scene.scene import Scene
from .mesh import SPP_AXIS, TILE_AXIS

__all__ = ["render_sharded", "make_train_step", "replicate_scene"]


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Place the scene replicated on every mesh device — the analog of the
    per-frame uniform upload (src/main.c:246-248, 263)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), scene)


def _check_divisible(height, spp, mesh):
    n_tile = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if height % n_tile:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if spp % n_spp:
        raise ValueError(f"spp {spp} not divisible by spp axis {n_spp}")
    return height // n_tile, spp // n_spp


def render_sharded(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    mesh: Mesh,
    jitter: bool = False,
    remat: bool = False,
    engine: str = "core",
    geom: bool = False,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    tri_em_cap: int | None = None,
    rough_grad: bool = False,
    interpret: bool = False,
):
    """Full-image radiance rendered across the mesh: (H, W, 3), sharded
    over rows on the ``tile`` axis.

    Each device renders its (row-block, sample-block); ``pmean`` over the
    ``spp`` axis averages the sample splits (the cross-chip analog of the
    sample mean at rtx_frag.glsl:292). The returned array keeps its row
    sharding — materialize with ``np.asarray`` (an all-gather to host,
    the glReadPixels analog) only at the output boundary.

    ``engine="pallas"`` runs the megakernel per shard (the fast multi-chip
    path, differentiable through the hand-written backward kernel — the
    gradient psum from shard_map's transpose overlaps with the other
    shards' backward work); ``engine="physical"`` runs the physical
    BRDF/NEE tier per shard. ``tri_nee=True`` (physical engines only)
    adds emissive triangles to the light-sampling pool per shard — the
    302x-variance-reduction estimator is a first-class sharded
    capability, bit-identical to its unsharded render like every other
    engine flag. RNG keys on global indices in every engine, so all
    engines and any mesh shape agree with their unsharded renders.
    ``interpret=True`` runs the Pallas engines in the Pallas interpreter.
    """
    rows_local, spp_local = _check_divisible(height, spp, mesh)
    if tri_nee and engine not in ("physical", "physical_pallas"):
        raise ValueError(
            f"tri_nee requires a physical engine, got engine={engine!r} "
            "(the reference tier has no light-sampling pool)"
        )
    if rough_grad and engine not in ("physical", "physical_pallas"):
        raise ValueError(
            f"rough_grad requires a physical engine, got engine={engine!r}"
        )
    if engine == "pallas":
        from ..ops.pallas_kernels import render_pallas_vjp
    elif engine == "physical":
        from ..models.physical import render_physical
    elif engine == "physical_pallas":
        # Fast physical tier per shard. Differentiable for materials and
        # sky; ``geom=True`` adds the fused NEE emitter-geometry
        # cotangents (first n_em_cap emitter ordinals; non-emitter
        # geometry stays zero by contract —
        # ops/pallas_physical.render_physical_pallas_vjp). Full-path
        # geometry AD needs engine="physical".
        from ..ops.pallas_physical import render_physical_pallas_vjp
    elif engine != "core":
        raise ValueError(f"unknown engine {engine!r}")

    # The varying-axis checker is ON for the XLA engines: they take
    # vma_axes=(tile, spp) and pvary their scan-carry inits (see
    # models/integrator.trace_paths), so shard_map verifies every
    # collective's mesh-axis bookkeeping. The Pallas engines run with the
    # checker off — pallas_call's out_shape carries no VMA type, and the
    # checker (correctly) refuses to guess; their sharded-vs-unsharded
    # parity is pinned value-wise by tests/test_parallel.py instead.
    vma = (TILE_AXIS, SPP_AXIS)
    pallas_engine = engine in ("pallas", "physical_pallas")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(TILE_AXIS, None, None),
        check_vma=not pallas_engine,
    )
    def _render(scene, seed):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        if engine == "pallas":
            img = render_pallas_vjp(
                scene,
                camera,
                height,
                width,
                spp_local,
                max_bounces,
                seed,
                sample_offset=si * spp_local,
                row_start=ti * rows_local,
                rows=rows_local,
                jitter=jitter,
                interpret=interpret,
            )
        elif engine == "physical":
            img = render_physical(
                scene,
                camera,
                height,
                width,
                spp_local,
                max_bounces,
                seed,
                jitter=jitter,
                remat=remat,
                sample_offset=si * spp_local,
                row_start=ti * rows_local,
                rows=rows_local,
                vma_axes=vma,
                tri_nee=tri_nee,
                rough_grad=rough_grad,
            )
        elif engine == "physical_pallas":
            img = render_physical_pallas_vjp(
                scene,
                camera,
                height,
                width,
                spp_local,
                max_bounces,
                seed,
                sample_offset=si * spp_local,
                row_start=ti * rows_local,
                rows=rows_local,
                jitter=jitter,
                # default geom=False: material training skips the
                # geometry Jacobian planes; geometry fits opt in (the
                # fused scheme makes geom=True nearly the same cost)
                geom=geom,
                n_em_cap=n_em_cap,
                tri_nee=tri_nee,
                tri_em_cap=tri_em_cap,
                rough_grad=rough_grad,
                interpret=interpret,
            )
        else:
            img = render_tile(
                scene,
                camera,
                height,
                width,
                spp_local,
                max_bounces,
                seed,
                jitter=jitter,
                remat=remat,
                sample_offset=si * spp_local,
                row_start=ti * rows_local,
                rows=rows_local,
                vma_axes=vma,
            )
        return jax.lax.pmean(img, SPP_AXIS)

    return _render(scene, jnp.asarray(seed, jnp.uint32))


def make_train_step(
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    mesh: Mesh,
    optimizer,
    param_fns,
    engine: str = "core",
    geom: bool = False,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    tri_em_cap: int | None = None,
    rough_grad: bool = False,
    interpret: bool = False,
):
    """Build a jitted sharded inverse-rendering train step.

    ``param_fns = (apply_params, )``-style pair from ``grad.diff``:
    ``apply_params(scene0, params) -> Scene``. The step renders the
    parameterized scene across the mesh, computes MSE against the
    (tile-sharded) target, backprops — shard_map's transpose inserts the
    gradient ``psum`` over both axes for the replicated scene — and
    applies an optax update. Returns ``step(params, opt_state, scene0,
    target, seed) -> (params, opt_state, loss)``.

    ``engine="pallas"`` runs the fused primal + Jacobian kernel per shard
    (ops/pallas_grad.py) — the fast multi-device training path.
    ``geom=True`` (physical_pallas engine) makes the step emit NEE
    emitter-geometry cotangents for sharded geometry fits, and
    ``tri_nee=True`` light-samples emissive triangles (with vertex
    cotangents when geom=True — see render_sharded).
    """
    apply_params = param_fns

    def loss_fn(params, scene0, target, seed):
        img = render_sharded(
            apply_params(scene0, params),
            camera,
            height,
            width,
            spp,
            max_bounces,
            seed,
            mesh,
            remat=engine in ("core", "physical"),  # XLA-AD engines only
            engine=engine,
            geom=geom,
            n_em_cap=n_em_cap,
            tri_nee=tri_nee,
            tri_em_cap=tri_em_cap,
            rough_grad=rough_grad,
            interpret=interpret,
        )
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(params, opt_state, scene0, target, seed):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene0, target, seed)
        updates, opt_state = optimizer.update(grads, opt_state)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return step
