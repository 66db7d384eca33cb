"""Multi-host initialization and health checks.

The reference is single-process (SURVEY.md SS5 "failure detection:
absent"); this module provides the multi-host story BASELINE.json's north
star requires: ``jax.distributed`` bring-up, a collective health check that
verifies every host/device answers before a long render starts, and helpers
to map global meshes onto multi-host device sets.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

logger = logging.getLogger("path_tracer_jax.distributed")

__all__ = ["initialize", "health_check", "is_multi_host", "local_device_count"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Bring up jax.distributed when running multi-host.

    No-op when single-process (the common single-host case and all CI).
    Pass all three arguments where the environment announces no cluster
    (e.g. ``coordinator_address="localhost:<port>"``).
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info(
            "distributed init ok: process %d/%d, %d local / %d global devices",
            jax.process_index(),
            jax.process_count(),
            jax.local_device_count(),
            jax.device_count(),
        )
    except (RuntimeError, ValueError) as e:
        # Already initialized or single-process context.
        logger.debug("distributed.initialize skipped: %s", e)


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_device_count() -> int:
    return jax.local_device_count()


def health_check(mesh=None) -> dict:
    """Every-device liveness probe before committing to a long render.

    Two stages: (1) a host->device->host round trip on every *addressable*
    device, (2) a global cross-device (and cross-process) reduction over
    all devices of the mesh — a hung or missing chip/host fails here in
    seconds instead of minutes into a render. Returns a status dict for
    the metrics log.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = list(mesh.devices.flat) if mesh is not None else jax.devices()
    n = len(devices)
    pidx = jax.process_index()
    local = [d for d in devices if d.process_index == pidx]
    xs = [jax.device_put(jnp.ones(()), d) for d in local]
    local_ok = sum(float(np.asarray(x)) for x in xs) == float(len(local))

    # global reduction across every device (a cross-device collective)
    mesh1d = Mesh(np.asarray(devices), ("d",))
    sharding = NamedSharding(mesh1d, P("d"))
    garr = jax.make_array_from_callback(
        (n,), sharding, lambda idx: np.ones((n,), np.float32)[idx]
    )
    total = float(np.asarray(jax.jit(jnp.sum)(garr)))
    ok = local_ok and total == float(n)
    status = {
        "devices": n,
        "local_devices": len(local),
        "processes": jax.process_count(),
        "alive": ok,
        "platform": devices[0].platform if devices else "none",
    }
    if not ok:
        raise RuntimeError(f"health check failed: {status}")
    logger.info("health check ok: %s", status)
    return status
