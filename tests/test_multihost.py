"""True multi-process 'multi-host' test: 2 processes x 4 fake CPU devices
render one tile/spp-sharded image via jax.distributed, and the result must
be bit-identical to the single-process render (global-counter RNG).

This is the CPU stand-in for the N-host path (SURVEY.md SS4 (d)): the
same parallel/ code paths — distributed.initialize, mesh over all global
devices, shard_map with pmean — run across real process boundaries.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_render(tmp_path):
    port = _free_port()
    out = tmp_path / "img.npy"
    workers = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    root = Path(__file__).resolve().parent
    for i in range(2):
        workers.append(
            subprocess.Popen(
                [
                    sys.executable,
                    str(root / "multihost_worker.py"),
                    str(i), "2", str(port), str(out),
                ],
                cwd=root.parent,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    logs = []
    for w in workers:
        try:
            stdout, _ = w.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            w.kill()
            stdout, _ = w.communicate()
        logs.append(stdout.decode(errors="replace"))
    for i, w in enumerate(workers):
        assert w.returncode == 0, f"worker {i} failed:\n{logs[i][-3000:]}"
    assert out.exists()

    import path_tracer_jax as pt
    from path_tracer_jax.scene import demo

    single = np.asarray(
        pt.render_radiance(
            demo.diffuse_sphere_scene(), pt.Camera.reference(), 16, 16, 8, 2,
            jnp.uint32(5),
        )
    )
    multi = np.load(out)
    np.testing.assert_allclose(multi, single, rtol=1e-6, atol=1e-6)
