"""Test session config: JAX on the CPU with 8 virtual devices.

The reference has no tests at all (SURVEY.md SS4); this suite follows the
strategy SURVEY.md SS4 mandates instead. The virtual-device CPU mesh
(``--xla_force_host_platform_device_count``) is the backend the sharding
tests run on. The Pallas kernels run in the Pallas interpreter here
(``interpret=True``); tests marked ``gpu`` need the card and skip
elsewhere — run them on a GPU host with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

Env vars must be set before jax initializes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables after every test module.

    The full suite compiles hundreds of distinct XLA:CPU programs in one
    process; with enough accumulated LLVM-JIT state the CPU backend
    eventually SEGFAULTS inside backend_compile_and_load on an otherwise
    fine graph (always after ~40+ green tests, never in isolation).
    Dropping the executable caches between modules keeps the per-process
    compiler footprint bounded; the cost is re-compiling the handful of
    cross-module shared graphs."""
    yield
    jax.clear_caches()
