"""Driver CLI smoke tests (the main.c analog, exercised end-to-end)."""

import struct

import numpy as np
import pytest

from path_tracer_jax.app import main as app


def test_render_writes_bmp(tmp_path):
    out = tmp_path / "out.bmp"
    app.main([
        "render", "--scene", "diffuse", "--width", "32", "--height", "16",
        "--spp", "2", "--max-bounces", "2", "--engine", "core",
        "--out", str(out),
    ])
    data = out.read_bytes()
    assert data[:2] == b"BM"
    w, h = struct.unpack("<ii", data[18:26])
    assert (w, h) == (32, 16)


def test_render_checkpoint_resume(tmp_path):
    from path_tracer_jax.utils import config

    out = tmp_path / "out.bmp"
    ckpt = tmp_path / "r.npz"
    cfg = config.RenderConfig(
        width=16, height=8, spp=4, max_bounces=2, scene="diffuse",
        engine="core", output=str(out), checkpoint_every=2,
        checkpoint_path=str(ckpt),
    )
    cfgp = tmp_path / "cfg.json"
    config.save(cfg, cfgp)
    app.main(["render", "--config", str(cfgp)])
    assert ckpt.exists() and out.exists()

    from path_tracer_jax.utils import checkpoint as ck

    c = ck.load_render(ckpt)
    assert c.spp_done == 4


def test_animate_frames(tmp_path):
    app.main([
        "animate", "--scene", "diffuse", "--width", "16", "--height", "8",
        "--spp", "1", "--max-bounces", "1", "--engine", "core",
        "--frames", "3", "--out-dir", str(tmp_path / "fr"),
    ])
    frames = sorted((tmp_path / "fr").glob("frame_*.bmp"))
    assert len(frames) == 3
    # frames differ (camera moved)
    assert frames[0].read_bytes() != frames[1].read_bytes()


def test_fit_runs(tmp_path, capsys):
    app.main([
        "fit", "--scene", "diffuse", "--width", "8", "--height", "8",
        "--spp", "2", "--max-bounces", "2", "--steps", "3",
    ])
    outtext = capsys.readouterr().out
    assert "fit: 3 steps" in outtext


def test_fit_roughness_mode_runs(tmp_path, capsys):
    """CLI rehearsal: fit --mode roughness drives the score-function
    estimator end-to-end."""
    app.main([
        "fit", "--scene", "glossy", "--width", "8", "--height", "8",
        "--spp", "2", "--max-bounces", "2", "--steps", "2",
        "--mode", "roughness",
    ])
    outtext = capsys.readouterr().out
    assert "roughness fit" in outtext
    assert "2 steps" in outtext


def test_unknown_scene_errors():
    with pytest.raises(SystemExit):
        app.main(["render", "--scene", "nope", "--width", "8", "--height", "8"])


def test_split_engine_rejects_mesh(tmp_path):
    """engine=split + multi-device mesh fails with an app-level message,
    not a deep ValueError."""
    import json

    cfg = {
        "width": 16, "height": 16, "spp": 2, "max_bounces": 2,
        "scene": "diffuse", "engine": "split",
        "mesh": {"tile": 4, "spp": 2}, "output": str(tmp_path / "o.bmp"),
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="split"):
        app.main(["render", "--config", str(p)])


def test_render_engine_physical_pallas(tmp_path, monkeypatch):
    """--engine physical_pallas forces the Pallas physical megakernel from
    the CLI: without a GPU it refuses (no silent interpreter), and the
    route reaches the kernel (run here in the interpreter)."""
    from path_tracer_jax import backend

    out = tmp_path / "pp.bmp"
    argv = [
        "render", "--scene", "cornell", "--width", "128", "--height", "8",
        "--spp", "1", "--max-bounces", "2", "--engine", "physical_pallas",
        "--out", str(out),
    ]
    with pytest.raises(backend.KernelUnavailable):
        app.main(argv)
    monkeypatch.setattr(backend, "kernel_interpret", lambda i, name: True)
    app.main(argv)
    data = out.read_bytes()
    assert data[:2] == b"BM"
    w, h = struct.unpack("<ii", data[18:26])
    assert (w, h) == (128, 8)


def test_render_with_device_mesh(tmp_path):
    """CLI render across the 8-fake-device mesh (config-5 style)."""
    from path_tracer_jax.utils import config

    out = tmp_path / "mesh.bmp"
    cfg = config.RenderConfig(
        width=16, height=16, spp=8, max_bounces=2, scene="diffuse",
        engine="core", output=str(out), mesh=config.MeshConfig(tile=4, spp=2),
    )
    cfgp = tmp_path / "cfg.json"
    config.save(cfg, cfgp)
    app.main(["render", "--config", str(cfgp)])
    data = out.read_bytes()
    assert data[:2] == b"BM"

    # must equal the single-device render exactly (global-index RNG)
    import jax.numpy as jnp
    import numpy as np
    import path_tracer_jax as pt
    from path_tracer_jax.scene import demo
    from path_tracer_jax.models.integrator import render_image_u8

    single = render_image_u8(
        pt.render_radiance(
            demo.diffuse_sphere_scene(), pt.Camera.reference(), 16, 16, 8, 2,
            jnp.uint32(0),
        )
    )
    import struct

    stride = (3 * 16 + 3) // 4 * 4
    px = np.frombuffer(data[54:], np.uint8).reshape(16, stride)[:, : 3 * 16]
    px = px.reshape(16, 16, 3)[::-1, :, ::-1]
    np.testing.assert_array_equal(px, np.asarray(single))


@pytest.mark.slow
def test_config5_scale_rehearsal(tmp_path):
    """Config-5 end-to-end rehearsal: drive the
    ACTUAL configs/config5_sweep_2048_multihost.json semantics — auto
    engine, a tile x spp mesh, animated camera sweep, async native frame
    writer — through the CLI on the 8-virtual-device mesh, with the
    workload scaled down (2048^2/256spp/48f -> 32x128/2spp/2f). Then the
    same config's render path with checkpointed chunks + resume."""
    import json
    from pathlib import Path

    cfg_path = Path(__file__).parent.parent / (
        "configs/config5_sweep_2048_multihost.json"
    )
    acfg = json.loads(cfg_path.read_text())
    assert acfg["render"]["mesh"] == {"tile": 2, "spp": 2}  # 4 cards
    assert acfg["render"]["engine"] == "auto"
    # scale the workload, preserve every structural knob (engine, scene,
    # jitter, fov); the 8-device test host doubles the mesh's tile axis
    acfg["render"].update(width=128, height=32, spp=2, max_bounces=2,
                          mesh={"tile": 4, "spp": 2})
    acfg.update(frames=2, out_dir=str(tmp_path / "fr"))
    small = tmp_path / "cfg5_small.json"
    small.write_text(json.dumps(acfg))

    app.main(["animate", "--config", str(small)])
    frames = sorted((tmp_path / "fr").glob("frame_*.bmp"))
    assert len(frames) == 2
    assert frames[0].read_bytes() != frames[1].read_bytes()
    for f in frames:
        data = f.read_bytes()
        assert data[:2] == b"BM"
        w, h = struct.unpack("<ii", data[18:26])
        assert (w, h) == (128, 32)

    # the render leg: same engine+mesh, checkpointed chunks, resume
    rcfg = dict(acfg["render"])
    out = tmp_path / "c5.bmp"
    ck = tmp_path / "c5.npz"
    rcfg.update(spp=4, checkpoint_every=2, checkpoint_path=str(ck),
                output=str(out))
    rpath = tmp_path / "cfg5_render.json"
    rpath.write_text(json.dumps(rcfg))
    app.main(["render", "--config", str(rpath)])
    assert out.exists()
    from path_tracer_jax.utils import checkpoint as ck_mod

    c = ck_mod.load_render(ck)
    assert c.spp_done == 4
    # resume is a no-op render (checkpoint already complete)
    app.main(["render", "--config", str(rpath)])
    assert ck_mod.load_render(ck).spp_done == 4


def test_terminal_live_view(tmp_path, capsys):
    """--live draws ANSI truecolor half-block frames (the RT-window
    analog, src/main.c:250-286) during an animate run; frame_to_ansi is
    also checked directly for escape structure."""
    import numpy as np

    from path_tracer_jax.utils.termview import frame_to_ansi

    img = np.zeros((4, 6, 3), np.uint8)
    img[0, 0] = (255, 0, 0)
    s = frame_to_ansi(img)
    assert s.count("\n") == 1  # 4 pixel rows -> 2 half-block rows
    assert "\x1b[38;2;255;0;0m" in s and s.endswith("\x1b[0m")

    app.main([
        "animate", "--scene", "diffuse", "--width", "16", "--height", "8",
        "--spp", "1", "--max-bounces", "1", "--engine", "core",
        "--frames", "2", "--out-dir", str(tmp_path / "fr"), "--live",
    ])
    out = capsys.readouterr().out
    assert "\x1b[38;2;" in out  # truecolor escapes were emitted
    assert "frame 2/2" in out


def test_render_bounce_stats_metrics(tmp_path):
    from path_tracer_jax.utils.metrics import MetricsLogger

    out = tmp_path / "out.bmp"
    mpath = tmp_path / "m.jsonl"
    app.main([
        "render", "--scene", "demo", "--width", "32", "--height", "16",
        "--spp", "2", "--max-bounces", "3", "--engine", "core",
        "--out", str(out), "--metrics", str(mpath), "--bounce-stats",
    ])
    recs = [r for r in MetricsLogger.read(str(mpath))
            if r["kind"] == "bounce_histogram"]
    assert len(recs) == 1
    assert len(recs[0]["hits"]) == 4
    assert sum(recs[0]["hits"]) > 0
    # the record says which spp/engine the histogram was counted with
    assert recs[0]["spp"] == 2 and recs[0]["engine"] == "core"


def test_render_bounce_stats_physical_engine(tmp_path):
    """--bounce-stats with the physical engine reports NEE visibility."""
    from path_tracer_jax.utils.metrics import MetricsLogger

    mpath = tmp_path / "m.jsonl"
    app.main([
        "render", "--scene", "demo", "--width", "16", "--height", "8",
        "--spp", "2", "--max-bounces", "2", "--engine", "physical",
        "--out", str(tmp_path / "out.bmp"), "--metrics", str(mpath),
        "--bounce-stats",
    ])
    (rec,) = [r for r in MetricsLogger.read(str(mpath))
              if r["kind"] == "bounce_histogram"]
    assert rec["engine"] == "physical"
    assert len(rec["nee_candidates"]) == 3
    assert sum(rec["nee_candidates"]) >= sum(rec["nee_visible"])
    assert sum(rec["nee_candidates"]) > 0  # demo scene has a sun sphere


def test_fit_checkpoint_resume_bit_identical(tmp_path):
    """fit --checkpoint-path: interrupted-then-resumed == uninterrupted
    (step-indexed seeds; utils/checkpoint.save_fit)."""
    import jax.numpy as jnp
    import path_tracer_jax as pt
    from path_tracer_jax.grad import diff
    from path_tracer_jax.scene import demo

    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    h = w = 8
    target = pt.render_radiance(scene, cam, h, w, 2, 2, jnp.uint32(77))

    # uninterrupted 6 steps
    ref_scene, ref_losses = diff.fit_materials(
        scene, target, cam, h, w, 2, 2, steps=6, seed0=3
    )

    # interrupted at 3, resumed to 6 via checkpoint
    ckpt = tmp_path / "fit.npz"
    diff.fit_materials(
        scene, target, cam, h, w, 2, 2, steps=3, seed0=3,
        checkpoint_path=str(ckpt), checkpoint_every=1,
    )
    assert ckpt.exists()
    res_scene, res_losses = diff.fit_materials(
        scene, target, cam, h, w, 2, 2, steps=6, seed0=3,
        checkpoint_path=str(ckpt), checkpoint_every=1,
    )
    assert res_losses == ref_losses
    np.testing.assert_array_equal(
        np.asarray(res_scene.materials.albedo),
        np.asarray(ref_scene.materials.albedo),
    )


def test_fit_cli_checkpoint(tmp_path):
    ckpt = tmp_path / "fit.npz"
    app.main([
        "fit", "--scene", "diffuse", "--width", "8", "--height", "8",
        "--spp", "2", "--max-bounces", "2", "--steps", "3",
        "--checkpoint-path", str(ckpt), "--checkpoint-every", "1",
    ])
    assert ckpt.exists()
    from path_tracer_jax.utils import checkpoint as ck

    with np.load(ckpt) as z:
        assert int(z["step"]) == 3
        assert len(z["losses"]) == 3


def test_progressive_preview_writes_intermediates(tmp_path, monkeypatch):
    """--progressive rewrites the output after each chunk; the final image
    equals the non-progressive render bit-for-bit."""
    from path_tracer_jax.utils import bitmap as bm

    writes = []
    real_write = bm.write_bitmap
    monkeypatch.setattr(
        bm, "write_bitmap",
        lambda p, u8, y_inverted=False: (writes.append(str(p)),
                                         real_write(p, u8, y_inverted))[1],
    )
    out = tmp_path / "prog.bmp"
    app.main([
        "render", "--scene", "diffuse", "--width", "16", "--height", "8",
        "--spp", "4", "--max-bounces", "2", "--engine", "core",
        "--out", str(out), "--progressive",
    ])
    # spp=4 -> checkpoint_every defaults to max(1, 4//8)=1 -> 3 previews
    # + 1 final write
    assert writes.count(str(out)) == 4

    ref = tmp_path / "ref.bmp"
    app.main([
        "render", "--scene", "diffuse", "--width", "16", "--height", "8",
        "--spp", "4", "--max-bounces", "2", "--engine", "core",
        "--out", str(ref),
    ])
    assert out.read_bytes() == ref.read_bytes()


def test_debug_nans_flag_catches_nan(tmp_path):
    """--debug-nans raises on a scene that produces non-finite radiance;
    the same render without the flag writes the (bad) image silently."""
    import jax.numpy as jnp
    import dataclasses
    import path_tracer_jax as pt
    from path_tracer_jax.scene import demo
    from path_tracer_jax.scene.io import save_scene

    scene = demo.diffuse_sphere_scene()
    bad = dataclasses.replace(
        scene,
        materials=dataclasses.replace(
            scene.materials,
            emission_strength=jnp.full_like(
                scene.materials.emission_strength, jnp.nan
            ),
        ),
    )
    spath = tmp_path / "bad_scene.json"
    save_scene(spath, bad)

    args = [
        "render", "--scene", str(spath), "--width", "16", "--height", "8",
        "--spp", "1", "--max-bounces", "1", "--engine", "core",
        "--out", str(tmp_path / "nan.bmp"),
    ]
    with pytest.raises(FloatingPointError):
        app.main(args + ["--debug-nans"])


@pytest.mark.slow
def test_config4_inverse_rehearsal(tmp_path, capsys):
    """Config-4 end-to-end rehearsal: drive the ACTUAL
    configs/config4_inverse_spheres32.json semantics (spheres32 scene,
    pallas engine, material recovery) through the fit CLI with the
    workload scaled down (256^2/8spp/200 steps -> 32x128/2spp/3 steps)."""
    import json
    from pathlib import Path

    cfg_path = Path(__file__).parent.parent / (
        "configs/config4_inverse_spheres32.json"
    )
    fcfg = json.loads(cfg_path.read_text())
    assert fcfg["render"]["scene"] == "spheres32"
    fcfg["render"].update(width=128, height=32, spp=2, max_bounces=2)
    fcfg.update(steps=3)
    small = tmp_path / "cfg4_small.json"
    small.write_text(json.dumps(fcfg))
    app.main(["fit", "--config", str(small)])
    out = capsys.readouterr().out
    assert "fit: 3 steps" in out


@pytest.mark.slow
def test_configs_1_2_3_render_rehearsal(tmp_path):
    """Drive the ACTUAL config files for BASELINE configs 1-3 through the
    render CLI (scene + engine + structural knobs preserved, resolution/
    spp scaled down), so every shipped config is exercised end to end —
    completing the config coverage story with configs 4/5's rehearsals."""
    import glob
    import json
    from pathlib import Path

    root = Path(__file__).parent.parent
    for i in (1, 2, 3):
        cfg_path = glob.glob(str(root / f"configs/config{i}_*.json"))[0]
        cfg = json.loads(Path(cfg_path).read_text())
        cfg.update(width=128, height=16, spp=2,
                   max_bounces=min(cfg["max_bounces"], 2),
                   output=str(tmp_path / f"c{i}.bmp"))
        small = tmp_path / f"cfg{i}_small.json"
        small.write_text(json.dumps(cfg))
        app.main(["render", "--config", str(small)])
        data = (tmp_path / f"c{i}.bmp").read_bytes()
        assert data[:2] == b"BM", cfg_path
        w, h = struct.unpack("<ii", data[18:26])
        assert (w, h) == (128, 16), cfg_path


def test_render_tri_nee_flag(tmp_path):
    """--tri-nee routes the physical engine through the core path with
    triangle-emitter light sampling (and never the sphere-NEE-only
    Pallas kernel)."""
    out = tmp_path / "tri.bmp"
    app.main([
        "render", "--scene", "demo", "--width", "16", "--height", "8",
        "--spp", "2", "--max-bounces", "2", "--engine", "physical",
        "--tri-nee", "--out", str(out),
    ])
    data = out.read_bytes()
    assert data[:2] == b"BM"
    w, h = struct.unpack("<ii", data[18:26])
    assert (w, h) == (16, 8)
