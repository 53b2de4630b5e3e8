"""Ray–primitive intersection primitives (pure jnp, vectorized SoA).

Replaces the reference's scalar/SSE Möller–Trumbore kernels
(/root/reference/RFW/system/bvh/.../bvh_tree.cpp:116-351) and the CUDA
`intersect_triangle` (CUDART/src/Kernels.cu:226-303) with batched array ops.

Also provides the *Woop unit-triangle transform*: each triangle is turned into
a 3x4 affine matrix mapping world space into a frame where the triangle is the
unit right triangle in z=0. Transforming R rays against K triangles then
becomes a `[2R,4] @ [4,3K]` contraction — the dense form the ``dense``
intersector and the visit kernel (as FMA rows) evaluate instead of
pointer-chasing a BVH.

Conventions: positions/directions are float32 arrays with a trailing dim of 3;
all functions broadcast over leading dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, NOT jnp: a module-level jnp constant forces backend init at
# import time
BIG_T = np.float32(1e30)


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def normalize(v, eps=1e-20):
    return v / jnp.sqrt(jnp.maximum(dot3(v, v), eps))[..., None]


def cross3(a, b):
    return jnp.cross(a, b)


# ---------------------------------------------------------------------------
# Möller–Trumbore
# ---------------------------------------------------------------------------

def intersect_tri(origin, direction, v0, e1, e2, t_epsilon=1e-4, t_max=BIG_T):
    """Möller–Trumbore ray/triangle test (reference bvh_tree.cpp:129-160).

    origin/direction: (..., 3); v0/e1/e2: (..., 3) precomputed vertex + edges
    (the reference precomputes p0/e1/e2 per triangle — bvh_tree.cpp:388-452).

    Returns (hit, t, u, v): boolean mask and hit distance/barycentrics.
    """
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec)
    valid = jnp.abs(det) > 1e-12
    inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = (
        valid
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_epsilon) & (t < t_max)
    )
    return hit, t, u, v


# ---------------------------------------------------------------------------
# Woop unit-triangle transform (dense formulation)
# ---------------------------------------------------------------------------

def woop_matrices(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Precompute per-triangle 3x4 world→unit-triangle matrices (host, numpy).

    For M = inverse([e1 | e2 | n]) with n = e1×e2, and translation -M@v0:
    a point p maps to (u, v, w) with w=0 on the triangle's plane; a ray hits
    the triangle where w(t)=0, at barycentrics (u,v).

    Returns (T, 3, 4) float32. Degenerate triangles get a matrix whose plane
    is unreachable (w ≡ 1, dz = 0 ⇒ no hit).
    """
    e1 = (v1 - v0).astype(np.float64)
    e2 = (v2 - v0).astype(np.float64)

    # closed-form inverse of M = [e1 | e2 | n]: adjugate rows are cross
    # products of the columns, det = n·(e1×e2) = |n|^2 — no LAPACK.
    # Component arithmetic into a preallocated buffer: np.cross/stack/
    # concatenate each copy the whole array (6.4 s → ~0.4 s at 500k tris).
    def cross_into(a, b, out):
        out[:, 0] = a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1]
        out[:, 1] = a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2]
        out[:, 2] = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
        return out

    t = v0.shape[0]
    n = cross_into(e1, e2, np.empty_like(e1))
    det = np.einsum("ti,ti->t", n, n)
    bad = det < 1e-18
    inv_det = (1.0 / np.where(bad, 1.0, det))[:, None]
    m64 = np.empty((t, 3, 4))
    cross_into(e2, n, m64[:, 0, :3])
    cross_into(n, e1, m64[:, 1, :3])
    m64[:, 2, :3] = n
    m64[:, :, :3] *= inv_det[:, :, None]
    m64[bad, :, :3] = np.eye(3)
    v064 = v0.astype(np.float64)
    m64[:, :, 3] = -np.einsum("tij,tj->ti", m64[:, :, :3], v064)
    out = m64.astype(np.float32)
    if bad.any():
        out[bad] = 0.0
        out[bad, 2, 3] = 1.0                     # w ≡ 1: plane never crossed
    return out


def intersect_woop(origin, direction, woop, t_epsilon=1e-4, t_max=BIG_T):
    """Intersect rays against Woop-transformed triangles via dense contraction.

    origin/direction: (R, 3); woop: (K, 3, 4).
    Returns (hit, t, u, v) each (R, K). The two einsums are the
    `[R,4] @ [4,3K]` contractions, at HIGHEST precision: a TF32 product
    would flip closest-hit winners.
    """
    t_max = jnp.asarray(t_max)
    if t_max.ndim == 1:          # per-ray bound → broadcast over triangles
        t_max = t_max[:, None]
    o4 = jnp.concatenate([origin, jnp.ones_like(origin[..., :1])], axis=-1)
    d4 = jnp.concatenate([direction, jnp.zeros_like(direction[..., :1])], axis=-1)
    w = woop.reshape(woop.shape[0] * 3, 4)             # (3K, 4)
    hi = jax.lax.Precision.HIGHEST
    op = jnp.einsum("ri,ki->rk", o4, w, precision=hi,
                    preferred_element_type=jnp.float32).reshape(
                        origin.shape[0], woop.shape[0], 3)
    dp = jnp.einsum("ri,ki->rk", d4, w, precision=hi,
                    preferred_element_type=jnp.float32).reshape(
                        origin.shape[0], woop.shape[0], 3)
    oz, dz = op[..., 2], dp[..., 2]
    valid = jnp.abs(dz) > 1e-12
    t = -oz / jnp.where(valid, dz, 1.0)
    u = op[..., 0] + t * dp[..., 0]
    v = op[..., 1] + t * dp[..., 1]
    hit = (
        valid
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_epsilon) & (t < t_max)
    )
    return hit, t, u, v


def closest_hit_woop(origin, direction, woop, prim_ids, t_epsilon=1e-4,
                     t_max=BIG_T, tri_verts=None):
    """Closest hit of rays (R,3) against triangles (K,3,4) with ids (K,).

    Returns (t, prim, u, v): t=BIG_T / prim=-1 on miss. If ``tri_verts``
    (K, 3, 3) is given, the winning hit is *refined* with one Möller–Trumbore
    step — the Woop matmul form loses ~1e-3 relative precision to f32
    cancellation (dot products against un-centered world coordinates), while
    MT subtracts v0 first and is well-conditioned; search-then-refine keeps
    the dense throughput and the MT accuracy.
    """
    hit, t, u, v = intersect_woop(origin, direction, woop, t_epsilon, t_max)
    t = jnp.where(hit, t, BIG_T)
    k = jnp.argmin(t, axis=-1)
    r = jnp.arange(t.shape[0])
    t_best = t[r, k]
    found = t_best < BIG_T
    u_best = u[r, k]
    v_best = v[r, k]
    if tri_verts is not None:
        tv = tri_verts[k]                              # (R, 3, 3)
        rhit, rt, ru, rv = intersect_tri(
            origin, direction, tv[:, 0], tv[:, 1] - tv[:, 0],
            tv[:, 2] - tv[:, 0], t_epsilon=t_epsilon * 0.5, t_max=t_max)
        # keep the refined values when MT agrees; fall back to Woop numbers
        # on the rare boundary disagreement.
        t_best = jnp.where(found & rhit, rt, t_best)
        u_best = jnp.where(found & rhit, ru, u_best)
        v_best = jnp.where(found & rhit, rv, v_best)
    return (
        t_best,
        jnp.where(found, prim_ids[k], -1),
        jnp.where(found, u_best, 0.0),
        jnp.where(found, v_best, 0.0),
    )


# ---------------------------------------------------------------------------
# AABB slab test
# ---------------------------------------------------------------------------

def intersect_aabb(origin, inv_dir, bmin, bmax, t_max=BIG_T):
    """Slab test (reference bvh_node.h / mbvh_node.cpp:33-80).

    origin/inv_dir: (..., 3); bmin/bmax: (..., 3) — broadcastable.
    Returns (hit, t_near).
    """
    t1 = (bmin - origin) * inv_dir
    t2 = (bmax - origin) * inv_dir
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_max)
    return hit, tmin


def safe_inv_dir(direction):
    """1/d with the sign-preserving clamp the reference uses to avoid inf*0."""
    d = jnp.where(jnp.abs(direction) < 1e-12,
                  jnp.where(direction < 0, -1e-12, 1e-12), direction)
    return 1.0 / d
