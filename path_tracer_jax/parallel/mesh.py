"""Device meshes for tile x spp sharded rendering.

The multi-device counterpart of the reference's two parallel-execution
engines (SURVEY.md SS2 table: the pthread scanline pool C5 and the
per-fragment SIMT of C9): parallelism across *devices* is a 2D logical mesh

* ``tile`` — image row-blocks (the scanline-pool analog, one block per
  mesh slot instead of one row per pthread task);
* ``spp``  — Monte-Carlo sample splits (the sample-loop analog), reduced
  with ``pmean``.

Scene parameters are replicated to every device (the uniform-upload analog,
src/main.c:24-136); the rendered image lives sharded over ``tile`` and is
gathered only at the host boundary (the glReadPixels analog).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "TILE_AXIS", "SPP_AXIS"]

TILE_AXIS = "tile"
SPP_AXIS = "spp"


def make_mesh(
    tile: int | None = None, spp: int = 1, devices=None
) -> Mesh:
    """Build a ``(tile, spp)`` mesh over the given (default: all) devices.

    With only ``spp`` given, ``tile`` absorbs the remaining devices. The
    cards of one host are joined all to all, so the mesh follows the
    algorithm alone: devices fill it in order.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if tile is None:
        if n % spp:
            raise ValueError(f"{n} devices not divisible by spp={spp}")
        tile = n // spp
    if tile * spp != n:
        raise ValueError(f"tile*spp = {tile * spp} != {n} devices")
    arr = np.asarray(devices).reshape(tile, spp)
    return Mesh(arr, (TILE_AXIS, SPP_AXIS))
