"""BVH invariants + traversal == brute force (SURVEY §4c)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rfw_tpu.bvh import (build_bvh, collapse_wide, extract_treelets,
                         triangle_bounds)
from rfw_tpu.ops import traverse


def random_tris(n=500, seed=3, spread=4.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    return np.stack([v0, v1, v2], axis=1)


def test_bvh_invariants():
    verts = random_tris(777)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    bvh.validate()
    assert bvh.max_depth < 64
    # root bounds contain everything
    assert (bvh.bmin[0] <= tmin.min(0) + 1e-5).all()
    assert (bvh.bmax[0] >= tmax.max(0) - 1e-5).all()


def test_wide_collapse_preserves_leaves():
    verts = random_tris(300)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    wide = collapse_wide(bvh, width=4)
    # total leaf triangle count preserved
    leaf = wide.count > 0
    assert wide.count[leaf].sum() == 300
    # all leaf ranges within bounds
    firsts = wide.child[leaf]
    counts = wide.count[leaf]
    assert (firsts >= 0).all() and ((firsts + counts) <= 300).all()


@pytest.mark.parametrize("n", [65, 1000])
def test_traversal_matches_brute_force(n):
    verts = random_tris(n, seed=n)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    wide = collapse_wide(bvh, width=4)

    perm = verts[bvh.prim_order]
    v0 = jnp.asarray(perm[:, 0])
    e1 = jnp.asarray(perm[:, 1] - perm[:, 0])
    e2 = jnp.asarray(perm[:, 2] - perm[:, 0])

    rng = np.random.default_rng(10)
    r = 256
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    wb = {"bmin": jnp.asarray(wide.bmin), "bmax": jnp.asarray(wide.bmax),
          "child": jnp.asarray(wide.child), "count": jnp.asarray(wide.count)}
    t_b, prim_b, _, _ = traverse.traverse_wide(
        jnp.asarray(o), jnp.asarray(d), wb, (v0, e1, e2), leaf_size=4)
    t_ref, prim_ref, _, _ = traverse.brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), (v0, e1, e2))

    t_b, t_ref = np.asarray(t_b), np.asarray(t_ref)
    prim_b, prim_ref = np.asarray(prim_b), np.asarray(prim_ref)
    hit_b, hit_ref = prim_b >= 0, prim_ref >= 0
    assert (hit_b == hit_ref).all()
    # same t everywhere (identical math; overlapping-surface prim ties OK)
    assert np.allclose(t_b[hit_b], t_ref[hit_ref], rtol=1e-5, atol=1e-5)
    assert (prim_b[hit_b] == prim_ref[hit_ref]).mean() > 0.98


def test_any_hit_terminates_consistently():
    verts = random_tris(400, seed=5)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    wide = collapse_wide(bvh, width=4)
    perm = verts[bvh.prim_order]
    tris = (jnp.asarray(perm[:, 0]), jnp.asarray(perm[:, 1] - perm[:, 0]),
            jnp.asarray(perm[:, 2] - perm[:, 0]))
    rng = np.random.default_rng(11)
    o = rng.uniform(-6, 6, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wb = {"bmin": jnp.asarray(wide.bmin), "bmax": jnp.asarray(wide.bmax),
          "child": jnp.asarray(wide.child), "count": jnp.asarray(wide.count)}
    t_c, prim_c, _, _ = traverse.traverse_wide(
        jnp.asarray(o), jnp.asarray(d), wb, tris, leaf_size=4)
    t_a, prim_a, _, _ = traverse.traverse_wide(
        jnp.asarray(o), jnp.asarray(d), wb, tris, leaf_size=4, any_hit=True)
    # any-hit finds a hit iff closest-hit does
    assert ((np.asarray(prim_a) >= 0) == (np.asarray(prim_c) >= 0)).all()
    # any-hit t is >= closest t (it may stop on a farther surface)
    hit = np.asarray(prim_c) >= 0
    assert (np.asarray(t_a)[hit] >= np.asarray(t_c)[hit] - 1e-5).all()


def test_treelets_cover_all_triangles():
    verts = random_tris(923, seed=7)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    tl = extract_treelets(bvh, tmin, tmax, size=64)
    ids = tl.pad_map[tl.pad_map >= 0]
    assert sorted(ids.tolist()) == list(range(923))
    assert (tl.count <= 64).all()
    # every treelet's AABB contains its triangles
    for k in range(len(tl.count)):
        tri_ids = tl.pad_map[k * tl.size:k * tl.size + tl.count[k]]
        assert (verts[tri_ids].reshape(-1, 3) >= tl.bmin[k] - 1e-4).all()
        assert (verts[tri_ids].reshape(-1, 3) <= tl.bmax[k] + 1e-4).all()


def test_spatial_treelets_cover_and_occupancy():
    from rfw_tpu.bvh import spatial_treelets
    verts = random_tris(923, seed=11)
    tmin, tmax = triangle_bounds(verts)
    tl = spatial_treelets(tmin, tmax, size=64)
    ids = tl.pad_map[tl.pad_map >= 0]
    assert sorted(ids.tolist()) == list(range(923))
    assert (tl.count <= 64).all()
    # size-aligned splits: padding waste stays small
    assert tl.count.sum() / (len(tl.count) * 64) > 0.85
    # cell AABBs contain their members
    for k in range(len(tl.count)):
        tri_ids = tl.pad_map[k * tl.size:k * tl.size + tl.count[k]]
        assert (verts[tri_ids].reshape(-1, 3) >= tl.bmin[k] - 1e-4).all()
        assert (verts[tri_ids].reshape(-1, 3) <= tl.bmax[k] + 1e-4).all()


def test_spatial_treelets_tiny():
    from rfw_tpu.bvh import spatial_treelets
    verts = random_tris(5, seed=2)
    tmin, tmax = triangle_bounds(verts)
    tl = spatial_treelets(tmin, tmax, size=64)
    assert len(tl.count) == 1 and tl.count[0] == 5
