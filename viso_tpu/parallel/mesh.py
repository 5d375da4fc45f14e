"""Device-mesh helpers for multi-chip execution.

The reference is single-threaded CPU (SURVEY.md §2: no parallel or
distributed machinery anywhere); all distribution here is new: a 1-D
`landmark` mesh axis shards the bundle-adjustment landmark/observation
dimension, with camera blocks replicated and reduced with collectives
(`psum`) inside `shard_map`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401

LANDMARK_AXIS = "landmark"


def make_mesh(num_devices: int | None = None, axis: str = LANDMARK_AXIS) -> Mesh:
    """1-D mesh over the first `num_devices` devices (default: all)."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (axis,))


def shard_landmarks(mesh: Mesh, axis: str = LANDMARK_AXIS):
    """Sharding that splits the leading landmark dimension across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
