"""Accumulator → display: ACES-fitted tonemap with brightness/contrast.

Reimplements the reference's GL tone-map fullscreen pass
(/root/reference/assets/shaders/tone-map.frag, driven by system.cpp:694-714)
as a jnp op. Input is linear HDR radiance; output linear [0,1] RGB (callers
apply sRGB encoding when writing PNGs).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Stephen Hill's ACES fit matrices (public; identical constants to the
# reference shader, which uses the same well-known fit).
_ACES_INPUT = np.array([
    [0.59719, 0.35458, 0.04823],
    [0.07600, 0.90834, 0.01566],
    [0.02840, 0.13383, 0.83777],
], dtype=np.float32)
_ACES_OUTPUT = np.array([
    [1.60475, -0.53108, -0.07367],
    [-0.10208, 1.10813, -0.00605],
    [-0.00327, -0.07276, 1.07602],
], dtype=np.float32)
# The colour einsums here run at the default matmul precision (TF32 on the
# GPU): ~1e-3 relative error on display values in [0, 1], below one 8-bit
# step (1/255). Geometry contractions elsewhere ask for HIGHEST.


def _rrt_and_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(color):
    """ACESFitted (tone-map.frag): (..., 3) linear → (..., 3) in [0,1]."""
    c = jnp.einsum("ij,...j->...i", jnp.asarray(_ACES_INPUT), color)
    c = _rrt_and_odt_fit(c)
    c = jnp.einsum("ij,...j->...i", jnp.asarray(_ACES_OUTPUT), c)
    return jnp.clip(c, 0.0, 1.0)


def tonemap(hdr, brightness=0.05, contrast=1.0):
    """Full pass (tone-map.frag main): contrast/brightness shift then ACES."""
    x = jnp.maximum(0.0, hdr - 0.5 * contrast + 0.5 + brightness)
    return aces_fitted(x)


def resolve_accumulator(accumulator, sample_count):
    """accumulator/spp (reference blitBuffer, Kernels.cu:181-203)."""
    return accumulator / jnp.maximum(jnp.float32(sample_count), 1.0)


# ---------------------------------------------------------------------------
# FXAA (the reference app harness's post blit, app.h:23-61 runs FXAA over
# the tonemapped target before presenting)
# ---------------------------------------------------------------------------

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def fxaa(ldr, span_max: float = 8.0, reduce_mul: float = 1.0 / 8.0,
         reduce_min: float = 1.0 / 128.0):
    """FXAA 3.11-style luma edge AA on a tonemapped (H, W, 3) LDR frame.

    The classic Lottes algorithm (public): estimate the local luma
    gradient from the 4 diagonal neighbours, step up to ``span_max``
    pixels along the edge, and blend two taps along that direction
    (falling back to the centre blend when the far taps leave the local
    luma range). Pure jnp — one fused elementwise pass + 4 shifted
    gathers, the stand-in for the reference's fullscreen GLSL blit.
    """
    img = jnp.asarray(ldr, jnp.float32)
    h, w = img.shape[0], img.shape[1]
    luma = jnp.einsum("...c,c->...", img, jnp.asarray(_LUMA))

    def sl(dy, dx):
        return jnp.roll(luma, (-dy, -dx), axis=(0, 1))

    l_nw, l_ne = sl(-1, -1), sl(-1, 1)
    l_sw, l_se = sl(1, -1), sl(1, 1)
    l_m = luma
    l_min = jnp.minimum(l_m, jnp.minimum(jnp.minimum(l_nw, l_ne),
                                         jnp.minimum(l_sw, l_se)))
    l_max = jnp.maximum(l_m, jnp.maximum(jnp.maximum(l_nw, l_ne),
                                         jnp.maximum(l_sw, l_se)))

    dir_x = -((l_nw + l_ne) - (l_sw + l_se))
    dir_y = (l_nw + l_sw) - (l_ne + l_se)
    dir_reduce = jnp.maximum(
        (l_nw + l_ne + l_sw + l_se) * 0.25 * reduce_mul, reduce_min)
    rcp = 1.0 / (jnp.minimum(jnp.abs(dir_x), jnp.abs(dir_y)) + dir_reduce)
    dx = jnp.clip(dir_x * rcp, -span_max, span_max)
    dy = jnp.clip(dir_y * rcp, -span_max, span_max)

    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]

    def sample(fx, fy):
        # bilinear taps: FXAA's sub-pixel offsets are mostly < 0.5 px,
        # so nearest sampling would collapse every tap onto the centre
        xf = jnp.clip(xs + fx, 0.0, w - 1.0)
        yf = jnp.clip(ys + fy, 0.0, h - 1.0)
        x0 = jnp.floor(xf)
        y0 = jnp.floor(yf)
        tx = (xf - x0)[..., None]
        ty = (yf - y0)[..., None]
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        x1i = jnp.minimum(x0i + 1, w - 1)
        y1i = jnp.minimum(y0i + 1, h - 1)
        return ((1 - tx) * (1 - ty) * img[y0i, x0i]
                + tx * (1 - ty) * img[y0i, x1i]
                + (1 - tx) * ty * img[y1i, x0i]
                + tx * ty * img[y1i, x1i])

    rgb_a = 0.5 * (sample(dx * (1.0 / 3.0 - 0.5), dy * (1.0 / 3.0 - 0.5))
                   + sample(dx * (2.0 / 3.0 - 0.5),
                            dy * (2.0 / 3.0 - 0.5)))
    rgb_b = rgb_a * 0.5 + 0.25 * (sample(-0.5 * dx, -0.5 * dy)
                                  + sample(0.5 * dx, 0.5 * dy))
    l_b = jnp.einsum("...c,c->...", rgb_b, jnp.asarray(_LUMA))
    use_a = (l_b < l_min) | (l_b > l_max)
    return jnp.where(use_a[..., None], rgb_a, rgb_b)
