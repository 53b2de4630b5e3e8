"""Primary-ray generation: pixel jitter AA + 9-blade-aperture thin lens.

Reimplements ``generatePrimaryRay``
(/root/reference/RFW/backends/CUDART/src/Kernels.cu:383-426) as a batched jnp
function over all pixels at once.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from . import rng
from .intersect import normalize

_PI_OVER_4P5 = math.pi / 4.5  # 9 aperture blades


def aperture_point(r0, r2, r3):
    """Sample the 9-bladed aperture polygon (Kernels.cu:401-414).

    r0 selects the blade (reusing the AA random, as the reference does),
    (r2, r3) sample the blade triangle. Returns (xr, yr) in the unit disk-ish
    polygon.
    """
    blade = jnp.floor(r0 * 9.0)
    r2 = (r2 - blade * (1.0 / 9.0)) * 9.0
    a1 = blade * _PI_OVER_4P5
    a2 = (blade + 1.0) * _PI_OVER_4P5
    x1, y1 = jnp.sin(a1), jnp.cos(a1)
    x2, y2 = jnp.sin(a2), jnp.cos(a2)
    flip = (r2 + r3) > 1.0
    r2 = jnp.where(flip, 1.0 - r2, r2)
    r3 = jnp.where(flip, 1.0 - r3, r3)
    return x1 * r2 + x2 * r3, y1 * r2 + y2 * r3


def generate_primary_rays(view, width: int, height: int, sample_index,
                          blue_noise_mask=None, pixel_ids=None,
                          pixel_cache=None):
    """Rays for every pixel: returns (origins, directions) each (N, 3).

    ``view`` is the CameraView pytree (camera.py). Random numbers r0..r3 come
    from the blue-noise/R2 sampler for low spp when a mask is given, matching
    the reference's sampler selection (Kernels.cu:390-399), else WangHash.
    ``pixel_ids`` overrides the full-frame arange (multi-chip tiles render a
    sub-range of the pixel domain).

    ``pixel_cache`` (optional) supplies the SAMPLE-INVARIANT per-pixel
    values precomputed once per resolution/scene (wavefront_driver): "sx"/
    "sy" pixel coordinates (the u32 div/mod) and "bn_row" blue-noise shift
    rows (the (N, dims) gather). Values are bitwise-identical to the
    inline computation — this only removes repeated per-sample work.
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.uint32)
    pid = pixel_ids
    if pixel_cache is not None:
        sx = pixel_cache["sx"]
        sy = pixel_cache["sy"]
    else:
        sx = (pid % jnp.uint32(width)).astype(jnp.int32)
        sy = (pid // jnp.uint32(width)).astype(jnp.int32)

    if blue_noise_mask is not None and blue_noise_mask.ndim == 3:
        # pre-shifted stack: ONE row gather for all four dims' shifts
        row = (pixel_cache["bn_row"]
               if pixel_cache is not None and "bn_row" in pixel_cache
               else rng.blue_noise_shift_row(blue_noise_mask, sx, sy))
        r0 = rng.blue_noise_from_shift(row[:, 0], sample_index, 0)
        r1 = rng.blue_noise_from_shift(row[:, 1], sample_index, 1)
        r2 = rng.blue_noise_from_shift(row[:, 2], sample_index, 2)
        r3 = rng.blue_noise_from_shift(row[:, 3], sample_index, 3)
    elif blue_noise_mask is not None:
        r0 = rng.blue_noise_sample(blue_noise_mask, sx, sy, sample_index, 0)
        r1 = rng.blue_noise_sample(blue_noise_mask, sx, sy, sample_index, 1)
        r2 = rng.blue_noise_sample(blue_noise_mask, sx, sy, sample_index, 2)
        r3 = rng.blue_noise_sample(blue_noise_mask, sx, sy, sample_index, 3)
    else:
        seed = rng.path_seed(pid, sample_index)
        seed, (r0, r1, r2, r3) = rng.random_floats(seed, 4)

    xr, yr = aperture_point(r0, r2, r3)

    right = view["p2"] - view["p1"]
    up = view["p3"] - view["p1"]
    origin = (view["pos"][None, :]
              + view["aperture"] * (right[None, :] * xr[:, None]
                                    + up[None, :] * yr[:, None]))
    u = (sx.astype(jnp.float32) + r0) * jnp.float32(1.0 / width)
    v = (sy.astype(jnp.float32) + r1) * jnp.float32(1.0 / height)
    point = view["p1"][None, :] + u[:, None] * right[None, :] + v[:, None] * up[None, :]
    direction = normalize(point - origin)
    return origin, direction
