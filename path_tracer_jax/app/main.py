"""Driver CLI: offline render, animated sweep, inverse rendering, bench.

The counterpart of the reference's ``main()``
(``/root/reference/src/main.c:138-341``): same capabilities — demo scene,
offline render to ``output.bmp`` (the default output name, src/main.c:329),
an animated camera sweep (the ``#ifdef RT`` realtime mode, src/main.c:
250-286, as frames on disk instead of a vsynced window) — plus the
capabilities the reference lacks: config files instead of recompiles,
scene selection, engine selection (Pallas megakernel or core XLA), device-
mesh sharding, checkpoint/resume, inverse rendering, and structured
metrics. Engine ``auto`` (the default) runs the Pallas kernels on the GPU
and the XLA engines elsewhere (path_tracer_jax/backend.py).

Usage:
    python -m path_tracer_jax.app.main render --scene demo --width 640 \
        --height 400 --spp 32 --out output.bmp
    python -m path_tracer_jax.app.main animate --frames 24 --out-dir frames/
    python -m path_tracer_jax.app.main fit --steps 100
    python -m path_tracer_jax.app.main render --config configs/offline.json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np


def _scenes():
    from ..scene import demo

    return {
        "demo": demo.demo_scene,
        "diffuse": demo.diffuse_sphere_scene,
        "cornell": demo.cornell_spheres_scene,
        "glossy": demo.glossy_scene,
        "spheres32": demo.random_spheres_scene,
    }


def get_scene(name: str):
    """Resolve a scene by built-in name or JSON file path (scene/io.py)."""
    scenes = _scenes()
    if name in scenes:
        return scenes[name]()
    if name.endswith(".json") and Path(name).exists():
        from ..scene.io import load_scene

        return load_scene(name)
    raise SystemExit(
        f"unknown scene '{name}'; available: {', '.join(sorted(scenes))} "
        "or a scene .json path"
    )


def _tiles(rows: int, width: int, tile) -> bool:
    from ..ops.pallas_kernels import tile_for

    try:
        tile_for(rows, width, tile)
    except ValueError:
        return False
    return True


def resolve_engine(engine: str, rows: int, width: int) -> str:
    """The engine a render runs: ``auto`` is the Pallas kernel on the GPU
    and the core path elsewhere; ``physical`` upgrades to the Pallas
    physical kernel on the GPU. Both choose the XLA path when the
    (per-shard) ``rows x width`` block does not tile the kernel."""
    from .. import backend
    from ..ops.pallas_kernels import DEFAULT_TILE
    from ..ops.pallas_physical import PHYS_TILE

    if engine == "auto":
        engine = backend.auto_engine("reference")
        if engine == "pallas" and not _tiles(rows, width, DEFAULT_TILE):
            engine = "core"
    elif engine == "physical" and backend.on_gpu():
        if _tiles(rows, width, PHYS_TILE):
            engine = "physical_pallas"
    return engine


def _render_once(scene, camera, cfg, seed, sample_offset=0):
    """Dispatch to the configured engine/mesh; returns (H, W, 3) radiance."""
    import jax.numpy as jnp

    from ..models.integrator import render_radiance
    from ..ops.pallas_kernels import render_pallas

    if cfg.mesh.tile * cfg.mesh.spp > 1:
        if cfg.engine == "split":
            raise SystemExit(
                "engine 'split' is a single-device parity/analysis tier "
                "and does not support a multi-device mesh; drop the mesh "
                "or use engine auto/core/pallas/physical"
            )
        from .. import parallel

        mesh = parallel.make_mesh(tile=cfg.mesh.tile, spp=cfg.mesh.spp)
        rows_local = cfg.height // max(cfg.mesh.tile, 1)
        engine = resolve_engine(cfg.engine, rows_local, cfg.width)
        return parallel.render_sharded(
            scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
            jnp.uint32(seed), mesh, jitter=cfg.jitter, engine=engine,
        )
    engine = resolve_engine(cfg.engine, cfg.height, cfg.width)
    if engine == "physical_pallas":
        from ..ops.pallas_physical import render_physical_pallas

        return render_physical_pallas(
            scene, camera, cfg.height, cfg.width, cfg.spp,
            cfg.max_bounces, jnp.uint32(seed),
            sample_offset=sample_offset, jitter=cfg.jitter,
            tri_nee=getattr(cfg, "tri_nee", False),
        )
    if engine == "physical":
        from ..models.physical import render_physical

        return render_physical(
            scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
            jnp.uint32(seed), jitter=cfg.jitter, sample_offset=sample_offset,
            tri_nee=getattr(cfg, "tri_nee", False),
        )
    if engine == "split":
        # the reference GPU shader's exact two-branch estimator
        # (models/split.py) — parity/analysis tier, core XLA path
        from ..models.split import render_split

        return render_split(
            scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
            jnp.uint32(seed), sample_offset=sample_offset,
        )
    if engine == "pallas":
        return render_pallas(
            scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
            jnp.uint32(seed), sample_offset=sample_offset, jitter=cfg.jitter,
        )
    return render_radiance(
        scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
        jnp.uint32(seed), jitter=cfg.jitter, sample_offset=sample_offset,
    )


def cmd_render(args):
    from ..ops.camera import Camera
    from ..models.integrator import render_image_u8
    from ..utils import bitmap, checkpoint as ckpt_mod
    from ..utils.config import RenderConfig, load
    from ..utils.metrics import MetricsLogger, Timer, throughput

    cfg = load(args.config) if args.config else RenderConfig()
    for name in (
        "width", "height", "spp", "max_bounces", "seed", "scene", "engine",
    ):
        v = getattr(args, name, None)
        if v is not None:
            setattr(cfg, name, v)
    if args.out:
        cfg.output = args.out
    if getattr(args, "debug_nans", False):
        cfg.debug_nans = True
    if getattr(args, "progressive", False):
        cfg.progressive = True
    if getattr(args, "tri_nee", False):
        cfg.tri_nee = True
    viewer = None
    if getattr(args, "live", False):
        # terminal live view (the RT-window analog on a headless host)
        from ..utils.termview import TerminalViewer

        viewer = TerminalViewer()
        if not cfg.checkpoint_every:
            cfg.checkpoint_every = max(1, cfg.spp // 8)

    if cfg.debug_nans:
        # Sanitizer analog (SURVEY.md §5 A2): XLA re-runs the op that
        # produced a NaN un-jitted and raises FloatingPointError at it.
        import jax

        jax.config.update("jax_debug_nans", True)
    if cfg.progressive and not cfg.checkpoint_every:
        # progressive needs chunks to refine over: default to 8 previews
        cfg.checkpoint_every = max(1, cfg.spp // 8)

    scene = get_scene(cfg.scene)
    camera = Camera.reference(cfg.fov_deg)
    metrics = MetricsLogger(args.metrics)

    ck = None
    spp_done = 0
    if cfg.checkpoint_path and Path(cfg.checkpoint_path).exists():
        ck = ckpt_mod.load_render(cfg.checkpoint_path)
        spp_done = ck.spp_done
        print(f"resuming from {cfg.checkpoint_path}: {spp_done} spp done")

    import jax.numpy as jnp

    chunk = cfg.checkpoint_every or (cfg.spp - spp_done)
    while spp_done < cfg.spp:
        n = min(chunk, cfg.spp - spp_done)
        with Timer() as t:
            rad = np.asarray(
                _render_once(scene, camera, dataclasses.replace(cfg, spp=n),
                             cfg.seed, sample_offset=spp_done)
            )
        if cfg.debug_nans and not np.isfinite(rad).all():
            bad = int(np.count_nonzero(~np.isfinite(rad)))
            raise FloatingPointError(
                f"non-finite radiance in chunk at spp_done={spp_done}: "
                f"{bad} values (seed {cfg.seed}, engine {cfg.engine})"
            )
        ck = ckpt_mod.accumulate(ck, rad, n, cfg.seed)
        spp_done = ck.spp_done
        rps = throughput(cfg.height, cfg.width, n, cfg.max_bounces, t.seconds)
        metrics.log("render_chunk", spp_done=spp_done, seconds=t.seconds,
                    rays_per_sec=rps)
        print(f"spp {spp_done}/{cfg.spp}  {t.seconds:.2f}s  {rps:.3e} rays/s")
        if cfg.checkpoint_path:
            ckpt_mod.save_render(cfg.checkpoint_path, ck)
        if cfg.progressive and spp_done < cfg.spp:
            # progressive preview: rewrite the output with the mean so far
            u8 = np.asarray(render_image_u8(jnp.asarray(ck.image)))
            bitmap.write_bitmap(cfg.output, u8, y_inverted=True)
            metrics.log("progressive_preview", spp_done=spp_done)
        if viewer is not None:
            u8 = np.asarray(render_image_u8(jnp.asarray(ck.image)))
            viewer.show(u8, caption=f"spp {spp_done}/{cfg.spp}")

    if getattr(args, "bounce_stats", False):
        stats_spp = min(cfg.spp, 4)
        if cfg.engine == "physical":
            from ..models.physical import render_bounce_stats_physical

            stats = render_bounce_stats_physical(
                scene, camera, cfg.height, cfg.width, stats_spp,
                cfg.max_bounces, jnp.uint32(cfg.seed), jitter=cfg.jitter,
            )
        else:
            from ..models.integrator import render_bounce_stats

            stats = render_bounce_stats(
                scene, camera, cfg.height, cfg.width, stats_spp,
                cfg.max_bounces, jnp.uint32(cfg.seed),
            )
        stats = {k: np.asarray(v).tolist() for k, v in stats.items()}
        # the histogram's own spp (capped at 4: events are counted on a
        # separate stats render, not the image's engine run)
        metrics.log("bounce_histogram", spp=stats_spp,
                    engine=cfg.engine, **stats)
        print(f"bounce histogram ({stats_spp} spp, per bounce): {stats}")

    u8 = np.asarray(render_image_u8(jnp.asarray(ck.image)))
    bitmap.write_bitmap(cfg.output, u8, y_inverted=True)
    print(f"wrote {cfg.output} ({cfg.width}x{cfg.height}, {cfg.spp} spp)")


def cmd_animate(args):
    """Animated camera sweep (BASELINE config 5 / RT-mode analog)."""
    from ..ops.camera import Camera
    from ..models.integrator import render_image_u8
    from ..utils import bitmap
    from ..utils.config import AnimationConfig, RenderConfig, load
    from ..utils.metrics import MetricsLogger, Timer, throughput

    acfg = load(args.config, AnimationConfig) if args.config else AnimationConfig()
    cfg = acfg.render
    for name in ("width", "height", "spp", "max_bounces", "scene", "engine"):
        v = getattr(args, name, None)
        if v is not None:
            setattr(cfg, name, v)
    if args.frames:
        acfg.frames = args.frames
    if args.out_dir:
        acfg.out_dir = args.out_dir

    scene = get_scene(cfg.scene)
    out_dir = Path(acfg.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = MetricsLogger(args.metrics)
    viewer = None
    if getattr(args, "live", False):
        from ..utils.termview import TerminalViewer

        viewer = TerminalViewer()

    import jax.numpy as jnp

    # Optional native async encoder pipeline: device renders frame n+1
    # while the host encodes/writes frame n.
    writer = None
    try:
        from ..utils import native

        if native.available():
            writer = native.AsyncBitmapWriter()
    except Exception:
        writer = None

    for f in range(acfg.frames):
        ang = 2.0 * np.pi * f / acfg.frames
        eye = (
            acfg.orbit_radius * np.sin(ang),
            acfg.orbit_height,
            acfg.target[2] - acfg.orbit_radius * np.cos(ang),
        )
        camera = Camera.look_at(eye, acfg.target, fov_deg=cfg.fov_deg)
        with Timer() as t:
            rad = _render_once(scene, camera, cfg, cfg.seed + f)
            u8 = np.asarray(render_image_u8(rad))
        path = out_dir / f"frame_{f:04d}.bmp"
        if writer is not None:
            writer.submit(str(path), u8, True)
        else:
            bitmap.write_bitmap(path, u8, y_inverted=True)
        if viewer is not None:
            viewer.show(u8, caption=f"frame {f + 1}/{acfg.frames}")
        rps = throughput(cfg.height, cfg.width, cfg.spp, cfg.max_bounces, t.seconds)
        metrics.log("frame", frame=f, seconds=t.seconds, rays_per_sec=rps)
        print(f"frame {f + 1}/{acfg.frames}  {t.seconds:.2f}s  {rps:.3e} rays/s")
    if writer is not None:
        writer.drain()
    print(f"wrote {acfg.frames} frames to {out_dir}")


def _fit_sharded_materials(init, target, camera, cfg, fcfg, metrics):
    """Mesh-sharded material fit: parallel.make_train_step per step —
    the CLI route onto the sharded training path."""
    import jax.numpy as jnp
    import optax

    from .. import parallel
    from ..grad import diff

    mesh = parallel.make_mesh(tile=cfg.mesh.tile, spp=cfg.mesh.spp)
    engine = resolve_engine(cfg.engine, cfg.height // cfg.mesh.tile,
                            cfg.width)
    if engine not in ("core", "pallas", "physical", "physical_pallas"):
        engine = "core"
    opt = optax.adam(fcfg.lr)
    step = parallel.make_train_step(
        camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces, mesh, opt,
        lambda scene0, p: diff.apply_material_params(scene0, p),
        engine=engine,
    )
    params = diff.make_material_params(init)
    opt_state = opt.init(params)
    scene_rep = parallel.replicate_scene(init, mesh)
    losses = []
    for i in range(fcfg.steps):
        params, opt_state, loss = step(
            params, opt_state, scene_rep, target, jnp.uint32(cfg.seed + i + 1)
        )
        losses.append(float(loss))
        metrics.log("fit_step", step=i, loss=losses[-1], engine=engine,
                    mesh=[cfg.mesh.tile, cfg.mesh.spp])
    return diff.apply_material_params(init, params), losses


def cmd_fit(args):
    """Inverse rendering (BASELINE config 4): recover materials — or, with
    ``--mode geometry``, light-sphere geometry (physical tier)."""
    import jax.numpy as jnp

    from ..grad import diff
    from ..ops.camera import Camera
    from ..scene import demo
    from ..utils.config import FitConfig, load
    from ..utils.metrics import MetricsLogger

    fcfg = load(args.config, FitConfig) if args.config else FitConfig()
    cfg = fcfg.render
    for name in ("width", "height", "spp", "max_bounces", "scene", "engine"):
        v = getattr(args, name, None)
        if v is not None:
            setattr(cfg, name, v)
    if args.steps:
        fcfg.steps = args.steps
    if getattr(args, "checkpoint_path", None):
        fcfg.checkpoint_path = args.checkpoint_path
    if getattr(args, "checkpoint_every", None):
        fcfg.checkpoint_every = args.checkpoint_every
    if fcfg.checkpoint_path and not fcfg.checkpoint_every:
        fcfg.checkpoint_every = max(1, fcfg.steps // 10)
    mode = getattr(args, "mode", None) or fcfg.mode or "materials"
    if mode not in ("materials", "geometry", "roughness"):
        raise SystemExit(
            f"fit: unknown mode {mode!r} (config file?) — expected "
            "materials | geometry | roughness"
        )

    true_scene = get_scene(cfg.scene)
    camera = Camera.reference(cfg.fov_deg)
    metrics = MetricsLogger(args.metrics)

    if fcfg.target:
        target = jnp.asarray(np.load(fcfg.target))
    elif mode in ("geometry", "roughness"):
        from ..models.physical import render_physical

        target = render_physical(
            true_scene, camera, cfg.height, cfg.width, cfg.spp,
            cfg.max_bounces, jnp.uint32(cfg.seed + 12345), jitter=False,
        )
    else:
        from ..models.integrator import render_radiance

        target = render_radiance(
            true_scene, camera, cfg.height, cfg.width, cfg.spp,
            cfg.max_bounces, jnp.uint32(cfg.seed + 12345),
        )

    t0 = time.time()
    if mode == "geometry":
        # Perturb the emissive light sphere's center, then recover it via
        # the physical tier's NEE geometry gradients (grad/diff.py).
        import jax

        sph = true_scene.spheres
        em = np.asarray(
            sph.active
            & (true_scene.materials.emission_strength[sph.material] > 0.0)
        )
        if not em.any():
            raise SystemExit(
                "fit --mode geometry needs a scene with an emissive sphere"
            )
        li = int(np.argmax(em))
        init = dataclasses.replace(
            true_scene,
            spheres=dataclasses.replace(
                sph,
                center=sph.center.at[li].add(
                    jnp.asarray([0.3, -0.2, 0.25], sph.center.dtype)
                ),
            ),
        )
        engine = cfg.engine if cfg.engine in (
            "physical", "physical_pallas") else "physical"
        fitted, losses = diff.fit_geometry(
            init, target, camera, cfg.height, cfg.width, cfg.spp,
            cfg.max_bounces, sphere_indices=(li,), steps=fcfg.steps,
            lr=fcfg.lr, seed0=cfg.seed,
            callback=lambda i, l: metrics.log("fit_step", step=i, loss=l),
            checkpoint_path=fcfg.checkpoint_path or None,
            checkpoint_every=fcfg.checkpoint_every,
            engine=engine,
        )
        err = float(
            jnp.abs(fitted.spheres.center[li]
                    - true_scene.spheres.center[li]).max()
        )
        print(
            f"geometry fit ({engine}): {fcfg.steps} steps in "
            f"{time.time() - t0:.1f}s, loss {losses[0]:.3e} -> "
            f"{losses[-1]:.3e}, max light-center err {err:.4f}"
        )
        return

    if mode == "roughness":
        # Corrupt every material's roughness, then recover via the
        # score-function estimator (rough_grad=True; both physical
        # engines carry the REINFORCE tangent — the Pallas one as fused
        # Jacobian planes).
        init = dataclasses.replace(
            true_scene,
            materials=dataclasses.replace(
                true_scene.materials,
                roughness=jnp.full_like(
                    true_scene.materials.roughness, 0.5
                ),
            ),
        )
        engine = cfg.engine if cfg.engine in (
            "physical", "physical_pallas") else "physical"
        fitted, losses = diff.fit_materials(
            init, target, camera, cfg.height, cfg.width, cfg.spp,
            cfg.max_bounces, steps=fcfg.steps, lr=fcfg.lr, seed0=cfg.seed,
            callback=lambda i, l: metrics.log("fit_step", step=i, loss=l),
            checkpoint_path=fcfg.checkpoint_path or None,
            checkpoint_every=fcfg.checkpoint_every,
            engine=engine, rough_grad=True,
        )
        err = float(
            jnp.abs(fitted.materials.roughness
                    - true_scene.materials.roughness).max()
        )
        print(
            f"roughness fit ({engine}, score-function): {fcfg.steps} "
            f"steps in {time.time() - t0:.1f}s, loss {losses[0]:.3e} -> "
            f"{losses[-1]:.3e}, max roughness err {err:.4f}"
        )
        return

    # Corrupt materials, then recover them.
    init = dataclasses.replace(
        true_scene,
        materials=dataclasses.replace(
            true_scene.materials,
            albedo=jnp.full_like(true_scene.materials.albedo, 0.5),
            emission_strength=jnp.full_like(
                true_scene.materials.emission_strength, 0.1
            ),
        ),
    )
    if cfg.mesh.tile * cfg.mesh.spp > 1:
        fitted, losses = _fit_sharded_materials(
            init, target, camera, cfg, fcfg, metrics
        )
    else:
        fitted, losses = diff.fit_materials(
            init, target, camera, cfg.height, cfg.width, cfg.spp,
            cfg.max_bounces,
            steps=fcfg.steps, lr=fcfg.lr, seed0=cfg.seed,
            callback=lambda i, l: metrics.log("fit_step", step=i, loss=l),
            checkpoint_path=fcfg.checkpoint_path or None,
            checkpoint_every=fcfg.checkpoint_every,
            engine=cfg.engine,
        )
    err = float(
        jnp.abs(fitted.materials.albedo - true_scene.materials.albedo).max()
    )
    print(
        f"fit: {fcfg.steps} steps in {time.time() - t0:.1f}s, "
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}, max albedo err {err:.4f}"
    )


def build_parser():
    p = argparse.ArgumentParser(
        prog="path_tracer_jax", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", help="JSON config file")
        sp.add_argument("--scene")
        sp.add_argument("--width", type=int)
        sp.add_argument("--height", type=int)
        sp.add_argument("--spp", type=int)
        sp.add_argument("--max-bounces", type=int, dest="max_bounces")
        sp.add_argument(
            "--engine",
            choices=["auto", "pallas", "core", "physical",
                     "physical_pallas", "split"],
        )
        sp.add_argument("--metrics", help="metrics JSONL output path")

    r = sub.add_parser("render", help="offline render to BMP")
    common(r)
    r.add_argument("--seed", type=int)
    r.add_argument("--out", help="output BMP path")
    r.add_argument(
        "--bounce-stats", action="store_true", dest="bounce_stats",
        help="log a per-bounce hit/miss/TIR event histogram (counted on a "
             "separate stats render capped at 4 spp — engine-matched for "
             "physical, core-path otherwise; plus NEE visibility counts "
             "in physical mode)",
    )
    r.add_argument(
        "--debug-nans", action="store_true", dest="debug_nans",
        help="NaN-debug mode: enable jax_debug_nans and assert every "
             "rendered chunk is finite (sanitizer analog)",
    )
    r.add_argument(
        "--progressive", action="store_true",
        help="rewrite the output BMP with the accumulating image after "
             "every checkpoint chunk (progressive single-view preview)",
    )
    r.add_argument(
        "--tri-nee", action="store_true", dest="tri_nee",
        help="light-sample emissive TRIANGLES too (physical engines, "
             "core and Pallas — variance reduction for triangle-lit "
             "scenes)",
    )
    r.add_argument(
        "--live", action="store_true",
        help="draw the accumulating image in the terminal (ANSI "
             "truecolor half-blocks, redrawn in place) after every "
             "chunk — the realtime-window analog for headless hosts",
    )
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="animated camera sweep to frames/")
    common(a)
    a.add_argument("--frames", type=int)
    a.add_argument("--out-dir")
    a.add_argument(
        "--live", action="store_true",
        help="draw each frame in the terminal as it renders (realtime "
             "sweep view)",
    )
    a.set_defaults(fn=cmd_animate)

    f = sub.add_parser("fit", help="inverse rendering: recover materials")
    common(f)
    f.add_argument("--steps", type=int)
    f.add_argument(
        "--mode", choices=["materials", "geometry", "roughness"],
        default=None,  # falls back to FitConfig.mode ("materials")
        help="materials: recover albedo+emission (config 4); geometry: "
             "recover the emissive light sphere's center via the physical "
             "tier's NEE geometry gradients; roughness: recover material "
             "roughness via the score-function (rough_grad) estimator "
             "on the core physical engine",
    )
    f.add_argument(
        "--checkpoint-path", dest="checkpoint_path",
        help="optimizer-state checkpoint file; resumes bit-identically "
             "if it exists (step-indexed per-step seeds)",
    )
    f.add_argument(
        "--checkpoint-every", type=int, dest="checkpoint_every",
        help="steps between optimizer checkpoints (default steps/10 when "
             "a checkpoint path is set)",
    )
    f.set_defaults(fn=cmd_fit)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    from .. import backend

    backend.enable_compile_cache()
    sys.exit(main())
