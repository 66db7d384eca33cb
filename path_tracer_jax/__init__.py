"""path_tracer_jax — a differentiable path-tracing framework in JAX.

Brand-new JAX/XLA/Pallas re-design with the capabilities of the reference C
path tracer (MysteryCoder456/path_tracer_c, mounted at /root/reference; see
SURVEY.md for the layer map). Scenes are SoA pytrees, the bounce loop is a
`lax.scan` wavefront with counter-based RNG, the hot path is a Pallas
megakernel compiled through Triton for the GPU, parallelism is `shard_map` over a device mesh, and — beyond the
reference — the estimator is differentiable for inverse rendering.
"""

from .scene.scene import Scene, SceneBuilder, Materials, Spheres, Triangles
from .scene import demo
from .ops.camera import Camera, primary_rays
from .ops.intersect import Hit, trace
from .models.integrator import (
    render_radiance,
    render_image_u8,
    render_jit,
    trace_paths,
)
from .utils.bitmap import write_bitmap, bitmap_bytes

__version__ = "0.1.0"

__all__ = [
    "Scene", "SceneBuilder", "Materials", "Spheres", "Triangles", "demo",
    "Camera", "primary_rays", "Hit", "trace",
    "render_radiance", "render_image_u8", "render_jit", "trace_paths",
    "write_bitmap", "bitmap_bytes",
]
