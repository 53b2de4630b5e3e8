"""Deterministic stream compaction + ray sorting.

The reference compacts its wavefront with atomic counters
(/root/reference/RFW/backends/CUDART/src/Kernels.cu:151-179 InitCounters,
:640,747,788 atomicAdd queues). The equivalent here is mask → sort, which
is bit-deterministic (SURVEY §2.9).

Ray *sorting* groups coherent rays into the same 256-ray block so the visit
intersector's per-block candidate lists stay short on bounce rays:
keys combine the direction octant with a Morton code of the ray origin —
the standard wavefront-coherence recipe.
"""

from __future__ import annotations

import jax.numpy as jnp


def _morton3(x, y, z, bits: int = 7):
    """Interleave ``bits`` bits of three normalized uint coordinates."""
    out = jnp.zeros_like(x, dtype=jnp.uint32)
    for i in range(bits):
        out = out | (((x >> i) & 1) << (3 * i + 2))
        out = out | (((y >> i) & 1) << (3 * i + 1))
        out = out | (((z >> i) & 1) << (3 * i))
    return out


def ray_sort_keys(origins, directions, scene_lo, scene_hi,
                  bits: int = 5, dir_bits: int = 2):
    """Coherence keys: [octant3 | Morton(dir, dir_bits) | Morton(origin,
    bits)] — 3 + 3*dir_bits + 3*bits low bits (callers stack flags
    from bit 28 up).

    DIRECTION-MAJOR below the octant: hemisphere-scattered directions
    drive a block's crossed-cell union on depth-1 bounce streams, so a
    coarse direction grouping ABOVE the origin Morton shortens the visit
    lists; finer direction bins (3+) scatter the origin clusters and
    lose (a host-side count of visits per 256-ray block, no device
    timing)."""
    octant = ((directions[:, 0] > 0).astype(jnp.uint32)
              | ((directions[:, 1] > 0).astype(jnp.uint32) << 1)
              | ((directions[:, 2] > 0).astype(jnp.uint32) << 2))
    ext = jnp.maximum(scene_hi - scene_lo, 1e-6)
    q = jnp.clip((origins - scene_lo) / ext, 0.0, 1.0)
    scale = jnp.float32((1 << bits) - 1)
    qi = (q * scale).astype(jnp.uint32)
    morton = _morton3(qi[:, 0], qi[:, 1], qi[:, 2], bits)
    key = morton
    if dir_bits:
        dq = jnp.clip((directions + 1.0) * 0.5, 0.0, 1.0)
        di = jnp.minimum((dq * (1 << dir_bits)).astype(jnp.uint32),
                         (1 << dir_bits) - 1)
        dmorton = _morton3(di[:, 0], di[:, 1], di[:, 2], dir_bits)
        key = (dmorton << (3 * bits)) | key
    return (octant << (3 * bits + 3 * dir_bits)) | key
