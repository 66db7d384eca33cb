"""Worker process for the multi-host test: renders a tile/spp-sharded image
across 2 processes x 4 fake CPU devices and writes process 0's gathered
result to disk. Launched by tests/test_multihost.py."""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    idx = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = sys.argv[3]
    out = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from path_tracer_jax.parallel import distributed

    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=idx,
    )
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.device_count() == 4 * nprocs

    import numpy as np
    import jax.numpy as jnp

    import path_tracer_jax as pt
    from path_tracer_jax import parallel
    from path_tracer_jax.scene import demo

    distributed.health_check()
    scene = demo.diffuse_sphere_scene()
    cam = pt.Camera.reference()
    mesh = parallel.make_mesh(tile=4, spp=2)  # 8 global devices, 2 hosts
    img = parallel.render_sharded(
        scene, cam, 16, 16, 8, 2, jnp.uint32(5), mesh
    )
    # gather the tile-sharded global image to every host
    from jax.sharding import NamedSharding, PartitionSpec as P

    gathered = jax.device_put(
        img, NamedSharding(mesh, P())
    )  # all-gather via resharding
    local = np.asarray(gathered)
    if idx == 0:
        np.save(out, local)
    # implicit barrier via final collective already done
    print(f"worker {idx} ok", flush=True)


if __name__ == "__main__":
    main()
