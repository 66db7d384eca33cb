#!/usr/bin/env python
"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: render, fit, kernel checks
    python chip_smoke.py --multi   # four cards: sharded render + train step

Drives the system through the entry points a user calls
(``python -m path_tracer_jax.app.main render|fit``, ``render_loss``,
``parallel.render_sharded``, ``parallel.make_train_step``) at config 3's
shape (glossy scene, 1024^2, 64 spp, 8 bounces) and config 4's fit shape
(spheres32, 256^2, 8 spp, 3 bounces). For every Triton kernel it shows
that the compiled program holds the Triton custom call (so no interpreter
ran), compares the kernel with the plain XLA path at the same seed and
with the scalar oracle (tests/reference_tracer.py) at a small size, and
times it against XLA. Fused-kernel gradients are compared with core AD.

Precision: every path computes in float32; the XLA paths run their
contractions at ``Precision.HIGHEST`` (no TF32). The kernel and XLA
contract mul+add into FMA differently, so a small share of pixels takes
another discrete path (a grazing hit, a TIR branch, an NEE visibility
test): the image gates bound that share and the mean difference, and the
gradient gates bound the relative max error.

Exits non-zero (and prints no result) on any failure, or when JAX finds
no GPU. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG3 = os.path.join(ROOT, "configs", "config3_glossy_1024.json")
CONFIG4 = os.path.join(ROOT, "configs", "config4_inverse_spheres32.json")

# Image gates (kernel vs XLA at the same seed): share of pixel channels
# that differ by more than 1e-3, and the mean absolute difference.
MAX_FLIP_SHARE = 1e-3
MAX_MEAN_DIFF = 1e-4
# Scalar-oracle gates (as in tests/test_integrator_golden.py).
ORACLE_Q99 = 5e-4
ORACLE_MEAN = 1e-3
# Gradient gate: max |fused - core AD| / max |core AD| per parameter.
GRAD_RTOL = 2e-2


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn, *args, runs=3):
    """(compile+first-run seconds, best of ``runs`` seconds, last result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def image_gap(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float((d > 1e-3).mean()), float(d.mean()), float(d.max())


def compile_with_triton(fn, *args, name):
    """Compile ``fn`` for ``args`` and check that its HLO holds the Triton
    custom call of kernel ``name`` (a program that interpreted the kernel
    would hold none). Returns the compiled executable."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    text = compiled.as_text()
    check("__gpu$xla.gpu.triton" in text and name in text,
          f"{name}: no Triton call in the compiled HLO")
    say(f"{name}: Triton custom call in the compiled HLO: yes")
    return compiled


def phase_device():
    import jax

    from path_tracer_jax import backend

    say("== device")
    say("jax.devices():", jax.devices())
    say("device_kind:", jax.devices()[0].device_kind)
    say("card (nvidia-smi name, power.limit):", backend.card_line())


def phase_render_cli(tmp):
    """config 3 through the CLI: physical tier (the config's engine,
    upgraded to the Pallas physical kernel on the GPU) and the reference
    tier (engine auto)."""
    from path_tracer_jax.app import main as app
    from path_tracer_jax.utils import bitmap

    say("== render (CLI, config 3: glossy 1024x1024, 64 spp, 8 bounces)")
    for engine in ("physical", "auto"):
        out = os.path.join(tmp, f"config3_{engine}.bmp")
        t0 = time.perf_counter()
        app.main(["render", "--config", CONFIG3, "--engine", engine,
                  "--out", out])
        data = open(out, "rb").read()
        check(data[:2] == b"BM", f"render {engine}: not a BMP")
        px = np.frombuffer(data[54:], np.uint8)
        check(px.max() > 0, f"render {engine}: black image")
        check(len(data) == len(bitmap.bitmap_bytes(
            np.zeros((1024, 1024, 3), np.uint8))), "BMP size")
        say(f"render engine={engine}: {out} ok "
            f"({time.perf_counter() - t0:.1f}s incl. compile)")


def phase_kernels():
    """Each forward kernel: Triton in the HLO, parity with XLA at config
    3's shape, parity with the scalar oracle, time against XLA."""
    import jax
    import jax.numpy as jnp

    import path_tracer_jax as pt
    from path_tracer_jax.models.physical import render_physical
    from path_tracer_jax.ops.pallas_kernels import render_pallas
    from path_tracer_jax.ops.pallas_physical import render_physical_pallas
    from path_tracer_jax.scene import demo

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_tracer as ref

    say("== forward kernels vs XLA (config 3 shape) and the scalar oracle")
    scene = demo.glossy_scene()
    cam = pt.Camera.reference()
    H = W = 1024
    SPP, B = 64, 8
    cases = (
        ("render_pallas",
         lambda s: render_pallas(scene, cam, H, W, SPP, B, s),
         jax.jit(lambda s: pt.render_radiance(scene, cam, H, W, SPP, B, s)),
         lambda sc, h, w: render_pallas(sc, cam, h, w, 2, 3, jnp.uint32(7)),
         lambda sc, h, w: ref.render(sc, h, w, 2, 3, 7)),
        ("render_physical_pallas",
         lambda s: render_physical_pallas(scene, cam, H, W, SPP, B, s),
         jax.jit(lambda s: render_physical(scene, cam, H, W, SPP, B, s)),
         lambda sc, h, w: render_physical_pallas(
             sc, cam, h, w, 2, 3, jnp.uint32(7), jitter=False),
         lambda sc, h, w: ref.render_physical(sc, h, w, 2, 3, 7)),
    )
    timings = {}
    for name, kern, xla, small, oracle in cases:
        seed = jnp.uint32(3)
        t0 = time.perf_counter()
        compiled = compile_with_triton(kern, seed, name=name)
        kc = time.perf_counter() - t0
        say(f"{name} memory_analysis: {compiled.memory_analysis()}")
        _, kt, kimg = timed(compiled, seed)
        xc, xt, ximg = timed(xla, seed)
        flips, mean, mx = image_gap(kimg, ximg)
        check(np.isfinite(np.asarray(kimg)).all(), f"{name}: non-finite")
        check(kimg.shape == (H, W, 3), f"{name}: shape {kimg.shape}")
        say(f"{name} vs XLA (seed 3, f32): share>1e-3 {flips:.2e} "
            f"(gate {MAX_FLIP_SHARE}), mean {mean:.2e} "
            f"(gate {MAX_MEAN_DIFF}), max {mx:.3f}")
        check(flips <= MAX_FLIP_SHARE and mean <= MAX_MEAN_DIFF,
              f"{name}: differs from XLA")
        for sc in (demo.cornell_spheres_scene(), demo.glossy_scene()):
            got = np.asarray(small(sc, 16, 32))
            err = np.abs(got - oracle(sc, 16, 32))
            q99, mean = float(np.quantile(err, 0.99)), float(err.mean())
            say(f"{name} vs scalar oracle (16x32, 2 spp, 3 bounces, "
                f"{sc.num_spheres} spheres): q99 {q99:.2e} "
                f"(gate {ORACLE_Q99}), mean {mean:.2e} (gate {ORACLE_MEAN})")
            check(q99 < ORACLE_Q99 and mean < ORACLE_MEAN,
                  f"{name}: differs from the scalar oracle")
        timings[name] = (kt, xt)
        say(f"TIME {name}: kernel {kt * 1e3:.2f} ms, XLA {xt * 1e3:.2f} ms "
            f"(compile {kc:.1f}s / XLA compile+first {xc:.1f}s), "
            f"speedup {xt / kt:.1f}x")
    return timings


def _fit_step(scene, cam, H, W, SPP, B, engine, target):
    import jax
    import jax.numpy as jnp

    from path_tracer_jax.grad import diff

    p0 = diff.make_material_params(scene)

    @jax.jit
    def step(seed):
        return jax.value_and_grad(lambda p: diff.render_loss(
            diff.apply_material_params(scene, p), target, cam, H, W, SPP, B,
            seed, engine=engine))(p0)

    return step


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def phase_fit(tmp):
    """config 4 fit through the CLI (default engine), then fused-kernel
    gradients vs core AD and fit-step times, at config 4's shape."""
    import jax
    import jax.numpy as jnp

    import path_tracer_jax as pt
    from path_tracer_jax.app import main as app
    from path_tracer_jax.models.physical import render_physical
    from path_tracer_jax.scene import demo

    say("== fit (CLI, config 4: spheres32 256x256, 8 spp, 3 bounces)")
    t0 = time.perf_counter()
    app.main(["fit", "--config", CONFIG4, "--steps", "3",
              "--metrics", os.path.join(tmp, "fit.jsonl")])
    say(f"fit: 3 Adam steps ok ({time.perf_counter() - t0:.1f}s incl. "
        "compile)")

    say("== fused kernels: gradients vs core AD, step time vs XLA AD")
    cam = pt.Camera.reference()
    scene = demo.random_spheres_scene()
    H = W = 256
    SPP, B = 8, 3
    timings = {}
    for tier, fast, core, name in (
            ("reference", "pallas", "core", "render_pallas_fused"),
            ("physical", "physical_pallas", "physical",
             "render_physical_pallas_fused")):
        if tier == "reference":
            target = pt.render_radiance(scene, cam, H, W, SPP, B,
                                        jnp.uint32(99))
        else:
            target = render_physical(scene, cam, H, W, SPP, B,
                                     jnp.uint32(99), jitter=False)
        kstep = compile_with_triton(
            _fit_step(scene, cam, H, W, SPP, B, fast, target),
            jnp.uint32(0), name=name)
        xstep = _fit_step(scene, cam, H, W, SPP, B, core, target)
        (lk, gk), (lx, gx) = kstep(jnp.uint32(5)), xstep(jnp.uint32(5))
        check(abs(float(lk) - float(lx)) <= 1e-3 * abs(float(lx)),
              f"{name}: loss {lk} vs core {lx}")
        for k in gk:
            e = rel_err(gk[k], gx[k])
            say(f"{name} material grad {k}: rel max err vs core AD {e:.2e} "
                f"(gate {GRAD_RTOL})")
            check(e <= GRAD_RTOL, f"{name}: {k} gradient differs")
        _, kt, _ = timed(kstep, jnp.uint32(1), runs=2)
        _, xt, _ = timed(xstep, jnp.uint32(1), runs=2)
        timings[name] = (kt, xt)
        say(f"TIME {name} fit step (value_and_grad, config 4 shape): "
            f"kernel {kt * 1e3:.2f} ms, XLA AD {xt * 1e3:.2f} ms, "
            f"speedup {xt / kt:.1f}x")
    return timings


def _black_light_scene():
    """A sphere light and a two-triangle light, both black-albedo: a path
    that strikes a light ends there, so core AD's light-geometry gradient
    IS the NEE chain the fused kernel carries — a tight comparison."""
    import path_tracer_jax as pt

    b = pt.SceneBuilder(sky_color=(0.04, 0.05, 0.07))
    ground = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=1.0)
    wall = b.add_material(albedo=(0.4, 0.45, 0.6), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                          emission_color=(1.0, 0.85, 0.6),
                          emission_strength=12.0)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50),
                   material=ground)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50),
                   material=ground)
    b.add_sphere(center=(0.0, 0.0, 6.0), radius=1.2, material=wall)
    b.add_sphere(center=(1.6, 2.2, 4.5), radius=0.35, material=lamp)
    tlamp = b.add_material(albedo=(0.0, 0.0, 0.0),
                           emission_color=(0.7, 0.8, 1.0),
                           emission_strength=9.0)
    b.add_triangle(v0=(-1.2, 3.0, 4.0), v1=(0.8, 3.0, 4.0),
                   v2=(0.8, 3.0, 6.0), material=tlamp)
    b.add_triangle(v0=(-1.2, 3.0, 4.0), v1=(-1.2, 3.0, 6.0),
                   v2=(0.8, 3.0, 6.0), material=tlamp)
    return b.build()


def phase_geometry_grads():
    """Sphere-emitter (geom=True) and triangle-vertex (tri_nee=True)
    gradients of the fused physical kernel vs core AD, on one scene with
    both light families in the NEE pool."""
    import jax
    import jax.numpy as jnp

    import path_tracer_jax as pt
    from path_tracer_jax.models.physical import render_physical
    from path_tracer_jax.ops.pallas_physical import (
        render_physical_pallas_vjp,
    )

    say("== fused physical kernel: geometry gradients vs core AD")
    cam = pt.Camera.reference()
    H = W = 128
    SPP, B = 8, 3
    scene = _black_light_scene()
    target = render_physical(scene, cam, H, W, SPP, B, jnp.uint32(77),
                             jitter=False, tri_nee=True)

    def grads(render):
        def loss(sph_c, sph_r, tri_v0):
            sc = dataclasses.replace(
                scene,
                spheres=dataclasses.replace(
                    scene.spheres, center=sph_c, radius=sph_r),
                triangles=dataclasses.replace(scene.triangles, v0=tri_v0),
            )
            return jnp.mean((render(sc) - target) ** 2)

        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            scene.spheres.center, scene.spheres.radius, scene.triangles.v0)

    fast = grads(lambda sc: render_physical_pallas_vjp(
        sc, cam, H, W, SPP, B, jnp.uint32(5), jitter=False, tri_nee=True))
    core = grads(lambda sc: render_physical(
        sc, cam, H, W, SPP, B, jnp.uint32(5), jitter=False, tri_nee=True))
    light = 1  # the lamp sphere; triangles 2 and 3 are the lamp quad
    for what, f, c in (("sphere light center", fast[0][light],
                        core[0][light]),
                       ("sphere light radius", fast[1][light],
                        core[1][light]),
                       ("triangle light v0", fast[2][2:], core[2][2:])):
        e = rel_err(f, c)
        say(f"{what} grad (tri_nee): rel max err vs core AD {e:.2e} "
            f"(gate {GRAD_RTOL})")
        check(np.abs(np.asarray(c)).max() > 0, f"{what}: core grad 0")
        check(e <= GRAD_RTOL, f"{what} gradient differs")


def phase_memory():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_multi():
    """Four cards: sharded renders on tile 4 x spp 1 and tile 2 x spp 2
    against the one-card render, and one sharded train step per Pallas
    engine against one device's gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    import path_tracer_jax as pt
    from path_tracer_jax import parallel
    from path_tracer_jax.grad import diff
    from path_tracer_jax.models.physical import render_physical
    from path_tracer_jax.ops.pallas_kernels import render_pallas
    from path_tracer_jax.ops.pallas_physical import render_physical_pallas
    from path_tracer_jax.scene import demo

    check(len(jax.devices()) == 4, f"--multi needs 4 GPUs, "
          f"found {len(jax.devices())}")
    say("== sharded render (config 5's scene, 512x512, 16 spp, 4 bounces)")
    cam = pt.Camera.reference()
    scene = demo.demo_scene()
    H = W = 512
    SPP, B = 16, 4
    single = {
        "pallas": np.asarray(render_pallas(scene, cam, H, W, SPP, B,
                                           jnp.uint32(3))),
        "physical_pallas": np.asarray(render_physical_pallas(
            scene, cam, H, W, SPP, B, jnp.uint32(3), jitter=False)),
    }
    for tile, spp in ((4, 1), (2, 2)):
        mesh = parallel.make_mesh(tile=tile, spp=spp)
        for engine, one in single.items():
            f = lambda: parallel.render_sharded(
                scene, cam, H, W, SPP, B, jnp.uint32(3), mesh,
                engine=engine, jitter=False)
            _, t, img = timed(f)
            flips, mean, mx = image_gap(img, one)
            say(f"mesh tile{tile}xspp{spp} {engine}: vs 1 card share>1e-3 "
                f"{flips:.2e}, mean {mean:.2e}, max {mx:.2e}; "
                f"{t * 1e3:.1f} ms")
            check(mean <= 1e-6 and flips <= MAX_FLIP_SHARE,
                  f"sharded {engine} {tile}x{spp} differs from one card")

    say("== sharded train step (config 4's scene, 256x256, 8 spp)")
    scene = demo.random_spheres_scene()
    H = W = 256
    SPP, B = 8, 3
    mesh = parallel.make_mesh(tile=2, spp=2)
    for engine in ("pallas", "physical_pallas"):
        if engine == "pallas":
            target = pt.render_radiance(scene, cam, H, W, SPP, B,
                                        jnp.uint32(9))
        else:
            target = render_physical(scene, cam, H, W, SPP, B,
                                     jnp.uint32(9), jitter=False)
        params = diff.make_material_params(scene)
        opt = optax.sgd(1.0)
        step = parallel.make_train_step(
            cam, H, W, SPP, B, mesh, opt, diff.apply_material_params,
            engine=engine)
        new, _, loss = step(params, opt.init(params),
                            parallel.replicate_scene(scene, mesh), target,
                            jnp.uint32(4))
        # one device: the same loss and gradient (sgd(1.0): new = p - g)
        l1, g1 = jax.value_and_grad(lambda p: diff.render_loss(
            diff.apply_material_params(scene, p), target, cam, H, W, SPP,
            B, jnp.uint32(4), engine=engine))(params)
        for k in params:
            gs = np.asarray(params[k]) - np.asarray(new[k])
            e = rel_err(gs, g1[k])
            say(f"train step {engine} {k}: rel max err vs one device "
                f"{e:.2e}")
            check(e <= 1e-3, f"sharded {engine} gradient {k} differs")
        check(abs(float(loss) - float(l1)) <= 1e-4 * abs(float(l1)),
              f"sharded {engine} loss differs")
        say(f"train step {engine}: loss {float(loss):.6e} "
            f"(one device {float(l1):.6e})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args()

    from path_tracer_jax import backend

    backend.enable_compile_cache()
    if not backend.on_gpu():
        sys.exit("chip_smoke.py needs a GPU; JAX's default backend is "
                 f"{backend.platform()!r}")

    phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        if args.multi:
            phase_multi()
        else:
            phase_render_cli(tmp)
            fwd = phase_kernels()
            fit = phase_fit(tmp)
            phase_geometry_grads()
            say("== summary (kernel vs XLA, best of runs, seconds)")
            for name, (k, x) in {**fwd, **fit}.items():
                say(f"{name}: kernel {k:.6f} XLA {x:.6f}")
        phase_memory()
    print(json.dumps({"ok": True, "device": backend.device_info()}))


if __name__ == "__main__":
    main()
