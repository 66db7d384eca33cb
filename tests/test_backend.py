"""The backend decision point, the kernels' CUDA lowering, the shared RNG
conversion and the per-program round counter — all checked on the CPU.

The CUDA lowering tests trace each kept Triton kernel and lower it for
the ``cuda`` platform without a card
(``jax.jit(f).trace(...).lower(lowering_platforms=("cuda",))``). That
catches primitives Triton cannot lower; register and shared-memory limits
show only when the card compiles the kernel (chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import path_tracer_jax as pt
from path_tracer_jax import backend
from path_tracer_jax.scene import demo
from path_tracer_jax.ops import pallas_kernels as fk
from path_tracer_jax.ops import rng
from path_tracer_jax.ops.pallas_grad import render_pallas_fused
from path_tracer_jax.ops.pallas_physical import (
    render_physical_pallas, render_physical_pallas_fused,
    render_physical_pallas_vjp,
)

CAM = pt.Camera.reference()


def _kernel_calls():
    scene = demo.cornell_spheres_scene()
    args = (scene, CAM, 8, 32, 1, 1, jnp.uint32(0))
    return {
        "render_pallas": lambda **kw: fk.render_pallas(*args, **kw),
        "render_pallas_fused": lambda **kw: render_pallas_fused(*args, **kw),
        "render_pallas_vjp": lambda **kw: fk.render_pallas_vjp(*args, **kw),
        "render_physical_pallas": (
            lambda **kw: render_physical_pallas(*args, **kw)),
        "render_physical_pallas_fused": (
            lambda **kw: render_physical_pallas_fused(*args, **kw)),
        "render_physical_pallas_vjp": (
            lambda **kw: render_physical_pallas_vjp(*args, **kw)),
    }


# -- the decision point -----------------------------------------------------


def test_kernel_interpret_passthrough():
    assert backend.kernel_interpret(True, "k") is True


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_explicit_pallas_raises_off_gpu(name):
    """A Pallas kernel asked for on the CPU without interpret=True raises
    instead of falling back to the interpreter."""
    assert jax.default_backend() == "cpu"
    with pytest.raises(backend.KernelUnavailable, match="interpret=True"):
        _kernel_calls()[name]()


def test_kernel_interpret_false_on_gpu(monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert backend.kernel_interpret(False, "k") is False


def test_auto_engine(monkeypatch):
    assert backend.auto_engine() == "core"
    assert backend.auto_engine("physical") == "physical"
    with pytest.raises(ValueError):
        backend.auto_engine("split")
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert backend.auto_engine() == "pallas"
    assert backend.auto_engine("physical") == "physical_pallas"


def test_cli_resolve_engine(monkeypatch):
    from path_tracer_jax.app.main import resolve_engine

    assert resolve_engine("auto", 64, 64) == "core"
    assert resolve_engine("physical", 64, 64) == "physical"
    assert resolve_engine("pallas", 64, 64) == "pallas"  # explicit stays
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert resolve_engine("auto", 64, 64) == "pallas"
    assert resolve_engine("auto", 64, 100) == "core"  # width does not tile
    assert resolve_engine("physical", 64, 64) == "physical_pallas"
    assert resolve_engine("physical", 64, 100) == "physical"
    assert resolve_engine("core", 64, 64) == "core"


def test_render_loss_auto_uses_core_on_cpu():
    from path_tracer_jax.grad.diff import render_loss

    scene = demo.diffuse_sphere_scene()
    target = jnp.zeros((8, 8, 3))
    auto = render_loss(scene, target, CAM, 8, 8, 1, 1, jnp.uint32(2))
    core = render_loss(scene, target, CAM, 8, 8, 1, 1, jnp.uint32(2),
                       engine="core")
    assert float(auto) == float(core)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets
    nothing; unset, it points JAX at the fixed in-checkout directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert backend.compile_cache_dir() == tmp_path / "cc"
    assert backend.enable_compile_cache() == tmp_path / "cc"
    assert jax.config.jax_compilation_cache_dir == before

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    want = backend.compile_cache_dir()
    assert want.name == ".jax_cache"
    assert want.parent == backend._DEFAULT_CACHE.parent
    try:
        assert backend.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == str(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_ignored_by_git():
    root = backend._DEFAULT_CACHE.parent
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# -- the shared RNG conversion ----------------------------------------------


def test_kernel_uniform_bit_identical_to_rng():
    """The kernels' u32 -> f32 draw (astype, one rounding) is bit-identical
    to ops/rng.uniform across the whole range, including the values where
    round-to-nearest carries into the next binade."""
    r = np.random.default_rng(0)
    edges = np.array(
        [0, 1, 2**24 - 1, 2**24 + 1, 2**31 - 1, 2**31, 2**31 + 1,
         2**32 - 129, 2**32 - 128, 2**32 - 1], np.uint32)
    states = jnp.asarray(
        np.concatenate([edges, r.integers(0, 2**32, 4096, np.uint32)])
    )
    s_k, u_k = fk._uniform(states)
    s_r, u_r = rng.uniform(states)
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(s_r))
    np.testing.assert_array_equal(
        np.asarray(u_k).view(np.uint32), np.asarray(u_r).view(np.uint32)
    )


# -- the executed-round counter ---------------------------------------------


@pytest.mark.parametrize("tier", ["reference", "physical"])
def test_count_rounds_is_a_per_program_sum(tier):
    """Each program writes its own round count and the wrapper sums them:
    the total is independent of how the grid is cut into row blocks."""
    scene = demo.demo_scene()
    fn = fk.render_pallas if tier == "reference" else render_physical_pallas
    kw = dict(tile=(8, 32), interpret=True, count_rounds=True, jitter=False)
    args = (scene, CAM, 16, 64, 2, 2, jnp.uint32(4))
    img, total = fn(*args, **kw)
    top, c_top = fn(*args, row_start=0, rows=8, **kw)
    bot, c_bot = fn(*args, row_start=8, rows=8, **kw)
    np.testing.assert_array_equal(np.asarray(img[:8]), np.asarray(top))
    np.testing.assert_array_equal(np.asarray(img[8:]), np.asarray(bot))
    assert int(total) == int(c_top) + int(c_bot)
    # 8 programs, 2 samples, at most 3 rounds each; sky tiles count none
    assert 0 < int(total) <= 8 * 2 * 3


# -- CUDA lowering of every kept kernel -------------------------------------


def _lowered_for_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


def _grad_loss(render):
    def loss(albedo, scene):
        sc = dataclasses.replace(
            scene,
            materials=dataclasses.replace(scene.materials, albedo=albedo),
        )
        return jnp.mean(render(sc) ** 2)

    return jax.grad(loss)


_CUDA_CASES = {
    "render_pallas": lambda sc: fk.render_pallas(
        sc, CAM, 64, 64, 4, 3, jnp.uint32(1)),
    "render_physical_pallas": lambda sc: render_physical_pallas(
        sc, CAM, 64, 64, 4, 3, jnp.uint32(1)),
    "render_pallas_fused": lambda sc: render_pallas_fused(
        sc, CAM, 64, 64, 4, 3, jnp.uint32(1)),
    "render_physical_pallas_fused": lambda sc: render_physical_pallas_fused(
        sc, CAM, 64, 64, 4, 3, jnp.uint32(1), n_em_cap=1, tri_nee=True,
        tri_em_cap=1, rough_grad=True),
}


@pytest.mark.parametrize("name", sorted(_CUDA_CASES))
def test_kernel_lowers_for_cuda(name, monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    scene = demo.cornell_spheres_scene()
    text = _lowered_for_cuda(_CUDA_CASES[name], scene).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f'name = "{name}"' in text


@pytest.mark.parametrize("tier", ["reference", "physical"])
def test_fit_gradient_lowers_for_cuda(tier, monkeypatch):
    """The fit path (jax.grad through the fused VJP) lowers for CUDA with
    the fused kernel inside."""
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    scene = demo.random_spheres_scene()
    if tier == "reference":
        render = lambda sc: fk.render_pallas_vjp(
            sc, CAM, 32, 32, 2, 3, jnp.uint32(1))
        name = "render_pallas_fused"
    else:
        render = lambda sc: render_physical_pallas_vjp(
            sc, CAM, 32, 32, 2, 3, jnp.uint32(1), jitter=False)
        name = "render_physical_pallas_fused"
    text = _lowered_for_cuda(
        _grad_loss(render), scene.materials.albedo, scene).as_text()
    assert f'name = "{name}"' in text
