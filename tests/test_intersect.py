"""Intersection primitive tests: Möller–Trumbore vs Woop-matmul formulation."""

import jax.numpy as jnp
import numpy as np

from rfw_tpu.ops import intersect as isec


def random_scene(n=64, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return v0, v1, v2


def random_rays(r=128, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_tri_basic():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 1.0, 0.0]])
    o = jnp.array([[0.25, 0.25, -1.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    hit, t, u, v = isec.intersect_tri(o, d, v0, e1, e2)
    assert bool(hit[0])
    assert abs(float(t[0]) - 1.0) < 1e-6
    assert abs(float(u[0]) - 0.25) < 1e-6
    assert abs(float(v[0]) - 0.25) < 1e-6
    # miss outside barycentric range
    o2 = jnp.array([[1.5, 1.5, -1.0]])
    hit2, *_ = isec.intersect_tri(o2, d, v0, e1, e2)
    assert not bool(hit2[0])


def test_woop_matches_moller_trumbore():
    v0, v1, v2 = random_scene(48)
    o, d = random_rays(96)
    woop = isec.woop_matrices(v0, v1, v2)

    # brute force via MT: (R, K)
    hit_mt, t_mt, u_mt, v_mt = isec.intersect_tri(
        o[:, None, :], d[:, None, :], v0[None], (v1 - v0)[None],
        (v2 - v0)[None])
    hit_w, t_w, u_w, v_w = isec.intersect_woop(jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(woop))
    hit_mt, hit_w = np.asarray(hit_mt), np.asarray(hit_w)
    assert (hit_mt == hit_w).mean() > 0.999  # boundary cases may differ
    both = hit_mt & hit_w
    # Woop-via-matmul is less precise than MT on ill-conditioned (skinny)
    # random triangles; relative t error stays small and median is tight.
    rel_t = (np.abs(np.asarray(t_mt)[both] - np.asarray(t_w)[both])
             / np.maximum(np.asarray(t_mt)[both], 1e-3))
    assert rel_t.max() < 2e-2  # raw Woop; production path refines (below)
    assert np.abs(np.asarray(u_mt)[both] - np.asarray(u_w)[both]).max() < 5e-2


def test_closest_hit_refined_precision():
    """Search-then-refine must restore MT-level accuracy on random scenes."""
    v0, v1, v2 = random_scene(48)
    o, d = random_rays(96)
    woop = isec.woop_matrices(v0, v1, v2)
    tv = np.stack([v0, v1, v2], axis=1)
    t_w, prim, u_w, v_w = isec.closest_hit_woop(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(woop), jnp.arange(48),
        tri_verts=jnp.asarray(tv))
    # brute-force MT closest hit as oracle
    hit, t, u, v = isec.intersect_tri(
        o[:, None, :], d[:, None, :], v0[None], (v1 - v0)[None],
        (v2 - v0)[None])
    t = np.where(np.asarray(hit), np.asarray(t), 1e30)
    k = t.argmin(axis=-1)
    t_ref = t[np.arange(96), k]
    both = (np.asarray(prim) >= 0) & (t_ref < 1e30)
    rel = np.abs(np.asarray(t_w)[both] - t_ref[both]) / t_ref[both]
    assert rel.max() < 1e-4


def test_closest_hit_woop():
    # two parallel triangles; nearest must win
    v0 = np.array([[0, 0, 1], [0, 0, 2.0]], np.float32)
    v1 = np.array([[4, 0, 1], [4, 0, 2.0]], np.float32)
    v2 = np.array([[0, 4, 1], [0, 4, 2.0]], np.float32)
    woop = isec.woop_matrices(v0, v1, v2)
    o = jnp.array([[0.5, 0.5, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    t, prim, u, v = isec.closest_hit_woop(o, d, jnp.asarray(woop),
                                          jnp.arange(2))
    assert int(prim[0]) == 0
    assert abs(float(t[0]) - 1.0) < 1e-5


def test_degenerate_triangle_no_hit():
    v0 = np.zeros((1, 3), np.float32)
    v1 = np.ones((1, 3), np.float32)
    v2 = np.ones((1, 3), np.float32) * 2  # collinear
    woop = isec.woop_matrices(v0, v1, v2)
    o, d = random_rays(16)
    hit, *_ = isec.intersect_woop(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(woop))
    assert not bool(np.asarray(hit).any())


def test_aabb():
    o = jnp.array([[0.0, 0.0, -5.0]])
    inv = isec.safe_inv_dir(jnp.array([[0.0, 0.0, 1.0]]))
    hit, tnear = isec.intersect_aabb(o, inv, jnp.array([-1.0, -1, -1]),
                                     jnp.array([1.0, 1, 1]))
    assert bool(hit[0]) and abs(float(tnear[0]) - 4.0) < 1e-5
    hit2, _ = isec.intersect_aabb(
        jnp.array([[0.0, 5.0, -5.0]]), inv,
        jnp.array([-1.0, -1, -1]), jnp.array([1.0, 1, 1]))
    assert not bool(hit2[0])


def test_woop_highest_matches_moller_trumbore_grazing():
    """Near-degenerate rays (within ~0.5 degrees of the triangle plane)
    through triangle interiors: the Woop contraction, requested at HIGHEST
    precision (a TF32 product would flip these), agrees with Möller–
    Trumbore on every hit and on t."""
    import jax

    rng = np.random.default_rng(3)
    k, r = 32, 256
    v0, v1, v2 = random_scene(k, seed=5)
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    tri = rng.integers(0, k, r)
    b = rng.uniform(0.2, 0.4, (r, 2))
    p = (v0[tri] + b[:, :1] * (v1 - v0)[tri] + b[:, 1:] * (v2 - v0)[tri])
    inplane = np.cross(n[tri], rng.normal(size=(r, 3)))
    inplane /= np.linalg.norm(inplane, axis=1, keepdims=True)
    tilt = rng.uniform(2e-3, 1e-2, (r, 1)) * rng.choice([-1, 1], (r, 1))
    d = inplane + tilt * n[tri]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = (p - 3.0 * d).astype(np.float32)

    woop = jnp.asarray(isec.woop_matrices(v0, v1, v2))
    jaxpr = str(jax.make_jaxpr(isec.intersect_woop)(
        jnp.asarray(o), jnp.asarray(d), woop))
    assert jaxpr.count("HIGHEST") >= 2, "geometry contraction not HIGHEST"
    hit_w, t_w, _, _ = isec.intersect_woop(jnp.asarray(o), jnp.asarray(d),
                                           woop)
    hit_mt, t_mt, _, _ = isec.intersect_tri(
        o[:, None, :], d[:, None, :], v0[None], (v1 - v0)[None],
        (v2 - v0)[None])
    own = np.arange(r), tri
    assert np.asarray(hit_mt)[own].all() and np.asarray(hit_w)[own].all()
    rel = (np.abs(np.asarray(t_w)[own] - np.asarray(t_mt)[own])
           / np.asarray(t_mt)[own])
    assert rel.max() < 1e-2
