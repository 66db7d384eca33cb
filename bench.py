#!/usr/bin/env python
"""Headline benchmark: rays/sec on one GPU at config 3's workload.

Times the render and fit kernels on the glossy scene (config 3) at
1024^2 / 64 spp / 8 bounces: the reference-tier and physical-tier forward
kernels, and the fused primal + Jacobian kernels under ``jax.grad``.
Needs a GPU: without one it exits non-zero and prints no result. Prints
the card's name and power limit on stderr, then ONE JSON line:

    {"metric": "rays/sec fwd 1024x1024/64spp/8bounce", "value": ...,
     "unit": "rays/s", "vs_baseline": ..., "extra": {...}}

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is the reference workload's implied throughput: its GLSL tracer
issues <= 3.6e10 ray-casts per frame (BASELINE.md table); at an assumed
30 s/frame on a mid-range GL 4.1 GPU that is ~1.2e9 rays/s. We use 1.0e9
rays/s as the nominal baseline denominator and record it in "extra".

A "ray" is one trace round of one pixel-sample:
H * W * spp * (max_bounces + 1) per render (utils/metrics.py). The
executed counts multiply the kernels' in-kernel round counters (rounds the
all-dead early exit really ran) by the tile's pixel count.

Usage: python bench.py
"""

import json
import sys
import time

H = W = 1024
SPP, BOUNCES = 64, 8
BASELINE_RAYS_PER_SEC = 1.0e9


def main():
    import jax
    import jax.numpy as jnp

    from path_tracer_jax import backend

    backend.enable_compile_cache()
    if not backend.on_gpu():
        sys.exit(f"bench.py measures the GPU; JAX's default backend is "
                 f"{backend.platform()!r}")
    print(f"card: {backend.card_line()}", file=sys.stderr)

    import path_tracer_jax as pt
    from path_tracer_jax.scene import demo
    from path_tracer_jax.ops import pallas_grad as pg
    from path_tracer_jax.ops import pallas_kernels as fk
    from path_tracer_jax.ops import pallas_physical as pp
    from path_tracer_jax.utils.metrics import rays_per_render

    scene = demo.glossy_scene()
    cam = pt.Camera.reference()
    rays = rays_per_render(H, W, SPP, BOUNCES)
    T0 = time.perf_counter()

    def log(msg):
        print(f"[bench +{time.perf_counter() - T0:.0f}s] {msg}",
              file=sys.stderr)

    def timed(name, fn, runs=3):
        """Median seconds of ``fn(seed)`` after one compiling call; a new
        seed per call."""
        log(f"compiling {name}")
        jax.block_until_ready(fn(jnp.uint32(100)))
        times = []
        for i in range(runs):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(jnp.uint32(i + 1)))
            times.append(time.perf_counter() - t0)
        log(f"{name}: {sorted(times)}")
        return sorted(times)[len(times) // 2]

    def executed_rays(fn, tile):
        out = jax.block_until_ready(fn(jnp.uint32(1)))
        return int(out[-1]) * tile[0] * tile[1]

    def grad_of(render, target):
        return jax.jit(jax.grad(
            lambda sc, sd: jnp.mean((render(sc, sd) - target) ** 2),
            allow_int=True,
        ))

    fwd = lambda s: fk.render_pallas(scene, cam, H, W, SPP, BOUNCES, s)
    fwd_s = timed("forward", fwd)
    fwd_exec = executed_rays(
        lambda s: fk.render_pallas(scene, cam, H, W, SPP, BOUNCES, s,
                                   count_rounds=True),
        fk.tile_for(H, W, fk.DEFAULT_TILE))

    target = fwd(jnp.uint32(424242))
    bwd = grad_of(
        lambda sc, sd: fk.render_pallas_vjp(sc, cam, H, W, SPP, BOUNCES, sd),
        target)
    bwd_s = timed("fwd+bwd", lambda s: bwd(scene, s), runs=2)
    fused_exec = executed_rays(
        lambda s: pg.render_pallas_fused(scene, cam, H, W, SPP, BOUNCES, s,
                                         count_rounds=True),
        fk.tile_for(H, W, pg.FUSED_TILE))

    phys = lambda s: pp.render_physical_pallas(scene, cam, H, W, SPP,
                                               BOUNCES, s)
    phys_s = timed("physical", phys)
    phys_exec = executed_rays(
        lambda s: pp.render_physical_pallas(scene, cam, H, W, SPP, BOUNCES,
                                            s, count_rounds=True),
        fk.tile_for(H, W, pp.PHYS_TILE))

    # physical fwd+bwd: materials only (training), and with the emitter
    # geometry planes of the scene's live emitters (geometry fits)
    ptarget = phys(jnp.uint32(515151))
    n_em = pp.live_emitter_count(scene)
    pbwd = {}
    for geom in (False, True):
        g = grad_of(
            lambda sc, sd, geom=geom: pp.render_physical_pallas_vjp(
                sc, cam, H, W, SPP, BOUNCES, sd, geom=geom,
                n_em_cap=n_em if geom else None),
            ptarget)
        pbwd[geom] = timed(f"physical fwd+bwd (geom={geom})",
                           lambda s, g=g: g(scene, s), runs=2)

    fwd_rps = rays / fwd_s
    print(json.dumps({
        "metric": f"rays/sec fwd {H}x{W}/{SPP}spp/{BOUNCES}bounce",
        "value": round(fwd_rps, 1),
        "unit": "rays/s",
        "vs_baseline": round(fwd_rps / BASELINE_RAYS_PER_SEC, 3),
        "extra": {
            "fwd_seconds": fwd_s,
            "fwd_rays_nominal": rays,
            "fwd_rays_executed": fwd_exec,
            "fwd_bwd_seconds": bwd_s,
            "fwd_bwd_rays_per_sec": round(rays / bwd_s, 1),
            "fused_rays_executed": fused_exec,
            "physical_seconds": phys_s,
            "physical_rays_per_sec": round(rays / phys_s, 1),
            "physical_rays_executed": phys_exec,
            "physical_fwd_bwd_seconds": pbwd[False],
            "physical_fwd_bwd_geom_seconds": pbwd[True],
            "card": backend.card_line(),
            "device": backend.device_info(),
            "baseline_assumed_rays_per_sec": BASELINE_RAYS_PER_SEC,
        },
    }))


if __name__ == "__main__":
    main()
