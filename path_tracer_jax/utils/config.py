"""Config system: every knob the reference hard-codes, as data.

The reference's settings are all compile-time constants — WIDTH/HEIGHT
(``/root/reference/src/main.c:17-18``), FOV / MAX_BOUNCES / NUM_SAMPLES
(src/renderer.c:7-9, rtx_frag.glsl:4-5), the RT mode ``#ifdef``
(src/main.c:250), even the scene itself (src/main.c:202-242). Here they
are dataclasses with JSON round-trip, so the five BASELINE.json configs
are files under ``configs/`` and a render is reproducible from its config
+ seed alone (SURVEY.md SS5 config-system requirement).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["RenderConfig", "MeshConfig", "FitConfig", "AnimationConfig", "load", "save"]


@dataclass
class MeshConfig:
    """tile x spp device mesh layout (parallel/mesh.py); 1x1 = one device."""

    tile: int = 1
    spp: int = 1


@dataclass
class RenderConfig:
    """One render: resolution / sampling / scene / camera / output."""

    width: int = 1280  # reference default, src/main.c:17
    height: int = 800  # src/main.c:18
    spp: int = 64
    max_bounces: int = 4  # rtx_frag.glsl:4
    fov_deg: float = 90.0  # src/main.c:200
    seed: int = 0
    scene: str = "demo"  # name in scene.demo or a scene JSON path
    jitter: bool = False  # reference shoots identical primary rays
    # "auto" | "pallas" | "core" | "physical" | "physical_pallas" |
    # "split". "auto" runs the Pallas megakernel on the GPU and the core
    # path elsewhere; "physical" upgrades to the Pallas physical kernel
    # on the GPU when the (possibly mesh-sharded) shapes tile. The
    # explicit Pallas engines need a GPU (app.main.resolve_engine).
    engine: str = "auto"
    output: str = "output.bmp"  # src/main.c:329
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_every: int = 0  # spp between checkpoints; 0 = off
    checkpoint_path: str = ""
    # NaN-debug mode (the sanitizer analog, SURVEY.md §5 A2): turns on
    # jax_debug_nans (XLA re-runs the offending op un-jitted and raises
    # FloatingPointError at it) and makes the app assert every rendered
    # chunk is finite.
    debug_nans: bool = False
    # Progressive preview (RT-mode analog, src/main.c:250-286): rewrite
    # the output BMP with the accumulated image after every checkpoint
    # chunk, refining a single view in place.
    progressive: bool = False
    # Triangle-emitter NEE (physical engines): add emissive triangles
    # to the light-sampling pool — variance reduction for triangle-lit
    # scenes (models/physical.py and ops/pallas_physical.py, tri_nee).
    tri_nee: bool = False


@dataclass
class FitConfig:
    """Inverse rendering (BASELINE config 4)."""

    render: RenderConfig = field(default_factory=RenderConfig)
    steps: int = 200
    lr: float = 0.05
    target: str = ""  # target image path (npy) or empty to self-render
    checkpoint_every: int = 0  # steps between optimizer checkpoints; 0 = off
    checkpoint_path: str = ""  # resumes bit-identically if the file exists
    # "materials" (albedo+emission, config 4) | "geometry" (emissive
    # light pose, physical tier) | "roughness" (score-function
    # estimator, rough_grad) — the CLI --mode flag overrides.
    mode: str = "materials"


@dataclass
class AnimationConfig:
    """Animated camera sweep (realtime-mode analog, src/main.c:250-286)."""

    render: RenderConfig = field(default_factory=RenderConfig)
    frames: int = 48
    orbit_radius: float = 8.0
    orbit_height: float = 1.5
    target: tuple = (0.0, 0.0, 6.0)
    out_dir: str = "frames"


def _to_dict(cfg):
    return dataclasses.asdict(cfg)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            v = _from_dict(f.type, v)
        elif f.name == "render" and isinstance(v, dict):
            v = _from_dict(RenderConfig, v)
        elif f.name == "mesh" and isinstance(v, dict):
            v = _from_dict(MeshConfig, v)
        elif f.name == "target" and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save(cfg, path) -> None:
    Path(path).write_text(json.dumps(_to_dict(cfg), indent=2) + "\n")


def load(path, cls=RenderConfig):
    return _from_dict(cls, json.loads(Path(path).read_text()))
