"""Config / metrics / checkpoint / native-runtime subsystem tests."""

import numpy as np
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax.scene import demo
from path_tracer_jax.utils import bitmap, checkpoint as ck, config, metrics, native


# -- config -----------------------------------------------------------------

def test_config_roundtrip(tmp_path):
    cfg = config.RenderConfig(width=640, height=400, spp=32, scene="cornell",
                              mesh=config.MeshConfig(tile=4, spp=2))
    p = tmp_path / "cfg.json"
    config.save(cfg, p)
    got = config.load(p)
    assert got == cfg


def test_config_defaults_match_reference():
    cfg = config.RenderConfig()
    assert (cfg.width, cfg.height) == (1280, 800)  # src/main.c:17-18
    assert cfg.max_bounces == 4  # rtx_frag.glsl:4
    assert cfg.fov_deg == 90.0  # src/main.c:200
    assert cfg.output == "output.bmp"  # src/main.c:329


def test_fit_config_nested_roundtrip(tmp_path):
    cfg = config.FitConfig(steps=7, render=config.RenderConfig(width=64))
    p = tmp_path / "fit.json"
    config.save(cfg, p)
    got = config.load(p, config.FitConfig)
    assert got.steps == 7 and got.render.width == 64


# -- metrics ----------------------------------------------------------------

def test_rays_per_render():
    # 1 extra trace round beyond max_bounces (integrator semantics).
    assert metrics.rays_per_render(4, 4, 2, 3) == 4 * 4 * 2 * 4


def test_metrics_logger(tmp_path):
    p = tmp_path / "m.jsonl"
    log = metrics.MetricsLogger(str(p))
    log.log("render_chunk", spp_done=4, rays_per_sec=1e9)
    log.log("frame", frame=0)
    recs = metrics.MetricsLogger.read(p)
    assert len(recs) == 2
    assert recs[0]["kind"] == "render_chunk"
    assert recs[0]["rays_per_sec"] == 1e9


# -- checkpoint / resume ----------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    c = ck.accumulate(None, img, spp=4, seed=7, meta={"scene": "demo"})
    p = tmp_path / "r.npz"
    ck.save_render(p, c)
    got = ck.load_render(p)
    assert got.spp_done == 4 and got.seed == 7
    assert got.meta == {"scene": "demo"}
    np.testing.assert_allclose(got.image, img, rtol=1e-6)


def test_checkpoint_seed_mismatch(tmp_path):
    img = np.zeros((2, 2, 3), np.float32)
    c = ck.accumulate(None, img, spp=1, seed=1)
    with pytest.raises(ValueError):
        ck.accumulate(c, img, spp=1, seed=2)


def test_resume_bit_identical():
    """Checkpointed two-chunk render == uninterrupted render, exactly."""
    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    full = np.asarray(pt.render_radiance(scene, cam, 8, 8, 8, 2, jnp.uint32(3)))
    c = None
    for off, n in ((0, 4), (4, 4)):
        rad = np.asarray(
            pt.render_radiance(
                scene, cam, 8, 8, n, 2, jnp.uint32(3), sample_offset=off
            )
        )
        c = ck.accumulate(c, rad, n, seed=3)
    np.testing.assert_allclose(c.image, full, rtol=1e-6, atol=1e-7)


# -- native runtime ---------------------------------------------------------

@pytest.fixture(scope="session")
def native_lib():
    """The native runtime, built once per test session (per worker)."""
    if not (native.available() or native.build()):
        pytest.skip("native build failed (needs g++)")


needs_native = pytest.mark.usefixtures("native_lib")


@needs_native
def test_native_bmp_byte_identical():
    rng = np.random.default_rng(1)
    for h, w in [(1, 1), (2, 5), (33, 7), (64, 64)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for inv in (True, False):
            assert native.bitmap_bytes(img, inv) == bitmap.bitmap_bytes(img, inv)


@needs_native
def test_native_write(tmp_path):
    img = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    p = tmp_path / "n.bmp"
    native.write_bitmap(p, img)
    assert p.read_bytes() == bitmap.bitmap_bytes(img)


@needs_native
def test_async_writer(tmp_path):
    img = np.full((8, 8, 3), 9, np.uint8)
    w = native.AsyncBitmapWriter()
    paths = [tmp_path / f"f{i}.bmp" for i in range(8)]
    for p in paths:
        w.submit(str(p), img)
    w.drain()
    for p in paths:
        assert p.read_bytes() == bitmap.bitmap_bytes(img)


@needs_native
def test_native_threadpool():
    pool = native.ThreadPool(4)
    assert pool.size == 4
    pool.wait()  # empty pool wait must not deadlock
    pool.close()


# -- profiling --------------------------------------------------------------

def test_time_fn():
    import jax.numpy as jnp
    from path_tracer_jax.utils import profiling

    t = profiling.time_fn(lambda x: x * 2, jnp.ones(16), warmup=1, iters=3)
    assert t >= 0


def test_distributed_initialize_single_process_noop():
    from path_tracer_jax.parallel import distributed

    distributed.initialize(num_processes=1)  # must not raise


@needs_native
def test_async_writer_large_frames(tmp_path):
    """Regression: large frames used to deadlock — the async task fanned
    row-encode chunks onto its own pool and Wait()ed on itself."""
    img = np.random.default_rng(0).integers(0, 256, (128, 64, 3), dtype=np.uint8)
    w = native.AsyncBitmapWriter()
    for i in range(4):
        w.submit(str(tmp_path / f"big{i}.bmp"), img)
    w.drain()
    for i in range(4):
        assert (tmp_path / f"big{i}.bmp").read_bytes() == bitmap.bitmap_bytes(img)
