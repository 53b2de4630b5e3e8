"""Shared BSDF math (vectorized jnp port of
/root/reference/RFW/system/context/rfw/bsdf/tools.h + compat.h helpers).

All functions broadcast over leading dims; directions are unit (..., 3).
Branches are jnp.where selections — everything evaluates branchlessly, which
is both the form vector units want and exactly how a lockstep warp executes the
reference's CUDA branches anyway.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

PI = math.pi
INVPI = 1.0 / math.pi
INV2PI = 1.0 / (2.0 * math.pi)
TWOPI = 2.0 * math.pi


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def sqr(x):
    return x * x


def lerp(a, b, t):
    return a + t * (b - a)


def safe_normalize(v):
    """SafeNormalize (disney.h:75-82): zero vector stays zero."""
    ls = dot3(v, v)[..., None]
    return jnp.where(ls > 0.0, v / jnp.sqrt(jnp.maximum(ls, 1e-30)), 0.0)


def schlick_fresnel(u):
    """SchlickFresnel (disney.h:33-37)."""
    m = jnp.clip(1.0 - u, 0.0, 1.0)
    return (m * m) * (m * m) * m


def gtr1(n_dot_h, a):
    """GTR1 (disney.h:39-46); a >= 1 returns 1/pi."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    val = (a2 - 1.0) / (PI * jnp.log(jnp.maximum(a2, 1e-8)) *
                        jnp.where(t != 0, t, 1.0))
    return jnp.where(a >= 1.0, INVPI, val)


def gtr2(n_dot_h, a):
    """GTR2 / GGX NDF (disney.h:48-53)."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (PI * t * t)


def smith_ggx(n_dot_v, alpha_g):
    """SmithGGX separable masking term (disney.h:55-60)."""
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / (n_dot_v + jnp.sqrt(jnp.maximum(a + b - a * b, 0.0)))


def fr(v_dot_n, eio):
    """Exact dielectric Fresnel `Fr` (disney.h:62-73); returns 1 on TIR."""
    sin_theta_t2 = sqr(eio) * (1.0 - v_dot_n * v_dot_n)
    tir = sin_theta_t2 > 1.0
    l_dot_n = jnp.sqrt(jnp.maximum(1.0 - sin_theta_t2, 0.0))
    eta = 1.0 / jnp.maximum(eio, 1e-6)
    denom1 = v_dot_n + eta * l_dot_n
    denom2 = l_dot_n + eta * v_dot_n
    r1 = (v_dot_n - eta * l_dot_n) / jnp.where(denom1 != 0, denom1, 1.0)
    r2 = (l_dot_n - eta * v_dot_n) / jnp.where(denom2 != 0, denom2, 1.0)
    return jnp.where(tir, 1.0, 0.5 * (sqr(r1) + sqr(r2)))


def refract_dir(wi, n, eta):
    """Refract (disney.h:20-30): returns (ok, wt)."""
    cos_i = dot3(n, wi)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = (eta[..., None] * (-wi)
          + (eta * cos_i - cos_t)[..., None] * n)
    return ok, wt


def reflect(d, n):
    """GLSL reflect: d - 2 dot(d, n) n."""
    return d - 2.0 * dot3(d, n)[..., None] * n


def diffuse_reflection_uniform(r0, r1):
    """DiffuseReflectionUniform (tools.h:102-108) — local frame (x,y,z)."""
    term1 = TWOPI * r0
    term2 = jnp.sqrt(jnp.maximum(1.0 - r1 * r1, 0.0))
    return jnp.stack([jnp.cos(term1) * term2, jnp.sin(term1) * term2, r1],
                     axis=-1)


def diffuse_reflection_cos_weighted(r0, r1):
    """DiffuseReflectionCosWeighted (tools.h:110-117)."""
    term1 = TWOPI * r0
    term2 = jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))
    v = jnp.stack([jnp.cos(term1) * term2, jnp.sin(term1) * term2,
                   jnp.sqrt(jnp.maximum(r1, 0.0))], axis=-1)
    return safe_normalize(v)


def tangent_to_world(local, t, b, n):
    """T*x + B*y + N*z."""
    return (t * local[..., 0:1] + b * local[..., 1:2] + n * local[..., 2:3])


def world_to_tangent(v, t, b, n):
    return jnp.stack([dot3(v, t), dot3(v, b), dot3(v, n)], axis=-1)


def survival_probability(throughput):
    """SurvivalProbability (tools.h:86): min(1, max channel)."""
    return jnp.minimum(1.0, jnp.max(throughput, axis=-1))


def clamp_intensity(value, clamp_value):
    """clampIntensity (tools.h:184-192): scale so max channel ≤ clamp."""
    v = jnp.max(value, axis=-1, keepdims=True)
    scale = jnp.where(v > clamp_value, clamp_value / jnp.maximum(v, 1e-20),
                      1.0)
    return value * scale


def safe_origin(origin, normal):
    """SafeOrigin (tools.h:119-122, active branch): O + N * 1e-5."""
    return origin + normal * 1e-5
