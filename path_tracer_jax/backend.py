"""Where the program runs, decided in one place.

The hand-written kernels are Pallas kernels compiled through Triton for an
NVIDIA GPU. Every choice that depends on the device goes through this
module:

* :func:`kernel_interpret` — whether a ``pallas_call`` runs compiled or in
  the Pallas interpreter. The interpreter runs only when the caller asks
  for it (``interpret=True``, as the CPU tests do). A kernel requested on
  a backend other than the GPU without ``interpret=True`` raises: it never
  falls back to the interpreter silently.
* :func:`auto_engine` — what ``engine="auto"`` means: the Pallas kernels on
  the GPU, the XLA engines anywhere else.
* :func:`enable_compile_cache` — JAX's persistent compilation cache.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

__all__ = [
    "platform", "on_gpu", "kernel_interpret", "auto_engine",
    "compile_cache_dir", "enable_compile_cache", "KernelUnavailable",
    "device_info", "card_line",
]

# Inside the checkout, listed in .gitignore. A fixed path: the directory
# is part of the cache key, so a moving path never hits.
_DEFAULT_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


class KernelUnavailable(RuntimeError):
    """A Pallas kernel was requested where it cannot be compiled."""


def platform() -> str:
    """JAX's default backend: ``"gpu"``, ``"cpu"``, ..."""
    return jax.default_backend()


def on_gpu() -> bool:
    return platform() == "gpu"


def kernel_interpret(interpret: bool, name: str) -> bool:
    """The ``interpret`` flag for the Pallas kernel ``name``.

    ``True`` when the caller asked for the interpreter; ``False`` on the
    GPU; otherwise :class:`KernelUnavailable`."""
    if interpret:
        return True
    if on_gpu():
        return False
    raise KernelUnavailable(
        f"{name} is a Triton kernel and needs a GPU, but JAX's default "
        f"backend is {platform()!r}. Pass interpret=True to run it in the "
        "Pallas interpreter, or choose an XLA engine."
    )


def auto_engine(tier: str = "reference") -> str:
    """The engine ``"auto"`` resolves to for a shading tier: the Pallas
    kernel on the GPU, the XLA path elsewhere."""
    if tier == "reference":
        return "pallas" if on_gpu() else "core"
    if tier == "physical":
        return "physical_pallas" if on_gpu() else "physical"
    raise ValueError(f"unknown tier {tier!r}")


def compile_cache_dir() -> Path:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` in the
    checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else _DEFAULT_CACHE


def enable_compile_cache() -> Path:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return compile_cache_dir()
    path = compile_cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path


def device_info() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them (a
    card set below its maximum power runs slower under load, so every
    measurement is reported beside this line)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
