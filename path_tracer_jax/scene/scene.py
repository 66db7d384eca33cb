"""SoA scene representation and builder API.

Replacement for the reference's scene model (C1 in SURVEY.md:
``/root/reference/src/scene.c``, ``include/scene.h:17-30``,
``include/shapes.h:17-36``) and its host->device transfer path (C11,
``src/main.c:24-136``). Instead of an AoS tagged-union ``shape`` array
serialized into named GL uniforms, the scene is a **pytree of jnp arrays in
structure-of-arrays layout** with static (padded) capacities:

* static shapes keep every render jit-compilable once and XLA-tileable;
* the materials / spheres / triangles arrays are tiny and get *replicated*
  to every device by the sharding layer (the uniform-upload analog);
* the differentiable leaves (albedo, emission, geometry, sky) are exactly
  the gradient targets of BASELINE.json's inverse-rendering config.

The builder exposes the same five verbs as ``include/scene.h:17-30``
(``init / add_material / add_sphere / add_triangle`` + build instead of
destroy) with doubling growth like ``src/scene.c:6-15``; ``add_material``
returns the material index like ``scene_add_material`` (src/scene.c:46).

Inactive padding slots are masked with per-object ``active`` flags rather
than degenerate geometry, so padding can never alias a real hit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import numpy as np
import jax.numpy as jnp

__all__ = ["Materials", "Spheres", "Triangles", "Scene", "SceneBuilder"]

# Initial builder capacities, mirroring src/scene.c:19-27 (64 objects split
# between the two shape kinds / 16 materials).
_INIT_MATERIALS = 16
_INIT_OBJECTS = 64


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass(frozen=True)
class Materials:
    """Material table, one row per material (include/shapes.h:17-27).

    ``metallicity`` is carried for API parity but is **unused by both
    reference backends** (never read in src/renderer.c nor rtx_frag.glsl);
    we preserve the field and the non-behavior.
    """

    albedo: jnp.ndarray  # (M, 3)
    roughness: jnp.ndarray  # (M,)
    metallicity: jnp.ndarray  # (M,)
    emission_color: jnp.ndarray  # (M, 3)
    emission_strength: jnp.ndarray  # (M,)
    transparency: jnp.ndarray  # (M,)
    refractive_index: jnp.ndarray  # (M,)


@_register
@dataclass(frozen=True)
class Spheres:
    center: jnp.ndarray  # (S, 3)
    radius: jnp.ndarray  # (S,)
    material: jnp.ndarray  # (S,) int32
    active: jnp.ndarray  # (S,) bool — False for padding slots


@_register
@dataclass(frozen=True)
class Triangles:
    v0: jnp.ndarray  # (T, 3)
    v1: jnp.ndarray  # (T, 3)
    v2: jnp.ndarray  # (T, 3)
    material: jnp.ndarray  # (T,) int32
    active: jnp.ndarray  # (T,) bool


@_register
@dataclass(frozen=True)
class Scene:
    """Full scene pytree: differentiable leaves + masks.

    Gradient targets (BASELINE.json north star): ``materials.albedo``,
    ``materials.emission_color/strength``, ``spheres.center/radius``,
    ``triangles.v0/v1/v2``, ``sky_color``.
    """

    materials: Materials
    spheres: Spheres
    triangles: Triangles
    sky_color: jnp.ndarray  # (3,)

    @property
    def num_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.material.shape[0]

    @property
    def num_materials(self) -> int:
        return self.materials.roughness.shape[0]


def _cap(n: int) -> int:
    return max(n, 1)


@dataclass
class SceneBuilder:
    """Host-side scene construction with the reference's five verbs.

    Example (the demo scene of src/main.c:202-230 is built exactly like
    this in ``path_tracer_jax.scene.demo``)::

        b = SceneBuilder(sky_color=(0, 0, 0))
        red = b.add_material(albedo=(1, 0, 0), roughness=0.85, ...)
        b.add_sphere(center=(-2, 0, 4), radius=1, material=red)
        scene = b.build()
    """

    sky_color: tuple = (0.0, 0.0, 0.0)
    _materials: list = field(default_factory=list)
    _spheres: list = field(default_factory=list)
    _triangles: list = field(default_factory=list)

    def add_material(
        self,
        albedo,
        roughness=0.0,
        metallicity=0.0,
        emission_color=(0.0, 0.0, 0.0),
        emission_strength=0.0,
        transparency=0.0,
        refractive_index=1.0,
    ) -> int:
        """Append a material; returns its index (src/scene.c:29-46)."""
        self._materials.append(
            dict(
                albedo=tuple(albedo),
                roughness=float(roughness),
                metallicity=float(metallicity),
                emission_color=tuple(emission_color),
                emission_strength=float(emission_strength),
                transparency=float(transparency),
                refractive_index=float(refractive_index),
            )
        )
        return len(self._materials) - 1

    def add_sphere(self, center, radius, material: int) -> int:
        """Append a sphere (src/scene.c:49-58); returns its index."""
        self._spheres.append((tuple(center), float(radius), int(material)))
        return len(self._spheres) - 1

    def add_triangle(self, v0, v1, v2, material: int) -> int:
        """Append a triangle (src/scene.c:61-70); returns its index."""
        self._triangles.append(
            (tuple(v0), tuple(v1), tuple(v2), int(material))
        )
        return len(self._triangles) - 1

    # -- capacities ---------------------------------------------------------

    @property
    def num_materials(self) -> int:
        return len(self._materials)

    @property
    def num_spheres(self) -> int:
        return len(self._spheres)

    @property
    def num_triangles(self) -> int:
        return len(self._triangles)

    def build(
        self,
        dtype=jnp.float32,
        sphere_capacity: int | None = None,
        triangle_capacity: int | None = None,
    ) -> Scene:
        """Freeze into a static-shape SoA ``Scene`` pytree.

        Capacities default to the exact object counts — padding slots cost
        real intersection work in the kernels' per-object loops. Pass
        explicit capacities when a fixed layout should survive scene edits
        (e.g. the animated path keeping one compiled executable while
        objects are added).
        """
        ns, nt = len(self._spheres), len(self._triangles)
        cap_s = sphere_capacity if sphere_capacity is not None else _cap(ns)
        cap_t = triangle_capacity if triangle_capacity is not None else _cap(nt)
        if cap_s < ns or cap_t < nt:
            raise ValueError("capacity smaller than object count")
        nm = max(len(self._materials), 1)

        def arr(vals, shape, dt=dtype):
            out = np.zeros(shape, dtype=np.dtype(dt))
            if vals:
                out[: len(vals)] = np.asarray(vals, dtype=np.dtype(dt))
            return jnp.asarray(out)

        mats = self._materials or [
            dict(
                albedo=(0.0, 0.0, 0.0),
                roughness=0.0,
                metallicity=0.0,
                emission_color=(0.0, 0.0, 0.0),
                emission_strength=0.0,
                transparency=0.0,
                refractive_index=1.0,
            )
        ]
        materials = Materials(
            albedo=arr([m["albedo"] for m in mats], (nm, 3)),
            roughness=arr([m["roughness"] for m in mats], (nm,)),
            metallicity=arr([m["metallicity"] for m in mats], (nm,)),
            emission_color=arr([m["emission_color"] for m in mats], (nm, 3)),
            emission_strength=arr([m["emission_strength"] for m in mats], (nm,)),
            transparency=arr([m["transparency"] for m in mats], (nm,)),
            refractive_index=arr(
                [m["refractive_index"] for m in mats], (nm,)
            ),
        )
        spheres = Spheres(
            center=arr([s[0] for s in self._spheres], (cap_s, 3)),
            radius=arr([s[1] for s in self._spheres], (cap_s,)),
            material=arr([s[2] for s in self._spheres], (cap_s,), jnp.int32),
            active=jnp.asarray(np.arange(cap_s) < ns),
        )
        triangles = Triangles(
            v0=arr([t[0] for t in self._triangles], (cap_t, 3)),
            v1=arr([t[1] for t in self._triangles], (cap_t, 3)),
            v2=arr([t[2] for t in self._triangles], (cap_t, 3)),
            material=arr([t[3] for t in self._triangles], (cap_t,), jnp.int32),
            active=jnp.asarray(np.arange(cap_t) < nt),
        )
        return Scene(
            materials=materials,
            spheres=spheres,
            triangles=triangles,
            sky_color=jnp.asarray(self.sky_color, dtype=dtype),
        )
