"""Forward-shading preview engine — the GLRenderer analog.

The reference's GLRenderer (/root/reference/RFW/backends/GLRenderer/) is a
forward rasterizer: per fragment it evaluates every light of all four types
with distance/NdotL attenuation and **no shadows** (shaders/simple.frag:
297-341; ShadowMap.cpp is an empty stub). Its role is the cheap, always-
available preview/editor view.

Primary visibility here comes from
the same intersectors as the path tracers (one bounce, no shadow rays, no
accumulation) — the *output contract* of GLRenderer (instant un-shadowed
forward shading with Lambert falloff) on the one compute substrate the chip
has. One sample per pixel is deterministic: no RNG, center-of-pixel rays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bsdf.common import dot3, safe_normalize
from ..ops.shade import get_shading_data
from .context import register_engine
from .engines import PathTracerEngine
from .integrator import sample_skybox


def _eval_lights(lights, p, n, albedo):
    """All four light loops of simple.frag:297-341 (no occlusion)."""
    color = jnp.zeros_like(albedo)
    f = albedo * (1.0 / np.pi)

    # area lights (radiance * energy * NdotL / d²; LNdotL gate)
    l_vec = lights["area_position"][None] - p[:, None, :]
    d2 = jnp.sum(l_vec * l_vec, axis=-1)
    l_dir = safe_normalize(l_vec)
    ndotl = dot3(n[:, None, :], l_dir)
    lndotl = -dot3(lights["area_normal"][None], l_dir)
    w = jnp.where((ndotl > 0) & (lndotl > 0),
                  ndotl / jnp.maximum(d2, 1e-9)
                  * lights["area_area"][None], 0.0)
    color = color + f * jnp.sum(
        w[..., None] * lights["area_radiance"][None], axis=1)

    # point lights
    l_vec = lights["point_position"][None] - p[:, None, :]
    d2 = jnp.sum(l_vec * l_vec, axis=-1)
    l_dir = safe_normalize(l_vec)
    ndotl = dot3(n[:, None, :], l_dir)
    w = jnp.where(ndotl > 0, ndotl / jnp.maximum(d2, 1e-9), 0.0)
    color = color + f * jnp.sum(
        w[..., None] * lights["point_radiance"][None], axis=1)

    # spot lights
    l_vec = p[:, None, :] - lights["spot_position"][None]
    d2 = jnp.sum(l_vec * l_vec, axis=-1)
    l_dir = safe_normalize(l_vec)
    denom = (lights["spot_cos_inner"] - lights["spot_cos_outer"])[None]
    fall = jnp.clip((dot3(l_dir, lights["spot_direction"][None])
                     - lights["spot_cos_outer"][None])
                    / jnp.where(denom != 0, denom, 1.0), 0.0, 1.0)
    ndotl = -dot3(n[:, None, :], l_dir)
    w = jnp.where(ndotl > 0, ndotl * fall / jnp.maximum(d2, 1e-9), 0.0)
    color = color + f * jnp.sum(
        w[..., None] * lights["spot_radiance"][None], axis=1)

    # directional lights
    ndotl = -dot3(n[:, None, :], lights["dir_direction"][None])
    w = jnp.maximum(ndotl, 0.0)
    color = color + f * jnp.sum(
        w[..., None] * lights["dir_radiance"][None], axis=1)
    return color


@register_engine("raster")
class RasterEngine(PathTracerEngine):
    """Un-shadowed forward shading (GLRenderer contract)."""

    default_intersector = "bvh"

    def _get_trace_fn(self, width: int, height: int):
        if self._trace_fn is not None and self._size == (width, height):
            return self._trace_fn
        from .intersectors import FACTORIES
        cfg = self.config
        intersector = FACTORIES[self._intersector_name](cfg)

        @functools.partial(jax.jit, donate_argnums=(1,))
        def step(scene, accumulator, view, sample_index, probe_index):
            from ..ops import raygen
            origin, direction = raygen.generate_primary_rays(
                view, width, height, jnp.uint32(0))   # deterministic
            t, prim, u, v = intersector.closest(scene, origin, direction)
            miss = prim < 0
            prim_safe = jnp.maximum(prim, 0)
            hit_pos = origin + direction * t[..., None]
            sd, n_geom, i_n, _, _, _ = get_shading_data(
                scene, prim_safe, u, v, direction,
                view["spread_angle"] * t)
            flip = jnp.where(dot3(direction, i_n) > 0, -1.0, 1.0)
            i_n = i_n * flip[..., None]
            shaded = _eval_lights(scene["lights"], hit_pos, i_n, sd["color"])
            # emissive surfaces show their color (lamp visualization)
            emissive = jnp.any(sd["color"] > 1.0, axis=-1)
            shaded = jnp.where(emissive[..., None], sd["color"], shaded)
            sky = sample_skybox(scene, direction)
            radiance = jnp.where(miss[..., None], sky, shaded)
            probe = jnp.stack([
                scene["tri_instance"][prim_safe][probe_index].astype(
                    jnp.float32),
                scene["tri_prim"][prim_safe][probe_index].astype(jnp.float32),
                jnp.where(miss[probe_index], -1.0, t[probe_index])])
            stats = {"ray_count_0": jnp.sum(~miss | miss)}
            # non-progressive: replace, don't accumulate (GLRenderer redraws)
            del accumulator
            return radiance, probe, stats

        # wrap to match the accumulate-API: always overwrite
        def wrapped(scene, accumulator, view, sample_index, probe_index):
            radiance, probe, stats = step(scene, accumulator, view,
                                          sample_index, probe_index)
            return radiance, probe, stats

        self._trace_fn = wrapped
        self._size = (width, height)
        return wrapped

    def render_frame(self, view, status=None, samples: int = 1):
        from .context import RenderStatus
        # force a fresh (non-accumulating) frame each call
        out = super().render_frame(view, RenderStatus.RESET, samples=1)
        self._sample_count = 1
        return out
