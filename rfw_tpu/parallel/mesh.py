"""Device-mesh helpers.

The reference is strictly single-device (SURVEY §2.9); multi-chip is a new
capability of the rebuild: image tiles shard across devices, the scene
replicates (it's MBs, not GBs). This module owns mesh construction so
engines/tests/bench share one convention: a 1-D mesh over all local devices
with axis name "tiles".
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_tile_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (TILE_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard the leading (pixel) dimension across tiles."""
    return NamedSharding(mesh, P(TILE_AXIS))
