"""Compute primitives: RNG, intersection, sampling, camera, Pallas kernels.

The Pallas modules (pallas_kernels, pallas_grad, pallas_physical) are
imported lazily by their users — importing them here would pull the Pallas
machinery into every ``import path_tracer_jax``.
"""
from . import rng, intersect, sampling, camera

__all__ = ["rng", "intersect", "sampling", "camera"]
