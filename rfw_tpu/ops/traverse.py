"""BVH traversal in pure jnp (gather-based, vmapped while_loop).

The functional analog of the reference's stack-based SIMD traversal kernels
(/root/reference/RFW/system/bvh/.../mbvh_node.h:122-307, bvh_node.h:237-448):
each ray carries an explicit fixed-depth stack; the W children of a node are
tested in parallel (vector lanes); leaves hold contiguous triangle ranges.

This path is the *oracle* engine — it runs on every backend; the visit-list
intersector (ops/visit_intersect.py) is the GPU's fast path. Both are
cross-checked against ``brute_force_closest`` (SURVEY §4: traversal ==
brute-force intersect on random scenes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .intersect import BIG_T, intersect_tri, safe_inv_dir

STACK_DEPTH = 64


def _leaf_intersect(origin, direction, first, count, tris, leaf_size,
                    best, t_epsilon):
    """Intersect up to ``leaf_size`` triangles at [first, first+count)."""
    v0, e1, e2 = tris

    def body(i, best):
        t_best, prim, ub, vb = best
        idx = first + i
        live = i < count
        idx = jnp.where(live, idx, 0)
        hit, t, u, v = intersect_tri(
            origin, direction, v0[idx], e1[idx], e2[idx],
            t_epsilon=t_epsilon, t_max=t_best)
        hit = hit & live
        return (
            jnp.where(hit, t, t_best),
            jnp.where(hit, idx, prim),
            jnp.where(hit, u, ub),
            jnp.where(hit, v, vb),
        )

    return jax.lax.fori_loop(0, leaf_size, body, best)


@functools.partial(jax.jit, static_argnames=("leaf_size", "any_hit"))
def traverse_wide(origins, directions, wbvh, tris, leaf_size: int = 4,
                  t_max=None, t_epsilon=1e-4, any_hit: bool = False):
    """Closest-hit (or any-hit) traversal for a batch of rays.

    origins/directions: (R, 3). wbvh: dict with bmin/bmax (N, W, 3), child /
    count (N, W) — see bvh.wide.WideBVH. tris: (v0, e1, e2) each (T, 3) in
    the *builder-permuted* order, so leaf ranges are contiguous.

    Returns (t, prim, u, v); prim is an index into the permuted order
    (callers map back through prim_order), -1 on miss. With ``any_hit`` the
    traversal stops at the first confirmed hit (shadow rays,
    traverse_mbvh_shadow analog).
    """
    w = wbvh["child"].shape[1]
    n_rays = origins.shape[0]
    if t_max is None:
        t_max = jnp.full(n_rays, BIG_T)
    else:
        t_max = jnp.broadcast_to(t_max, (n_rays,))

    def one_ray(origin, direction, t_far):
        inv_dir = safe_inv_dir(direction)
        stack = jnp.zeros(STACK_DEPTH, jnp.int32)
        # stack starts with root node 0 at ptr=1
        state = (stack, jnp.int32(1),
                 (t_far, jnp.int32(-1), jnp.float32(0), jnp.float32(0)))

        def cond(state):
            _, ptr, best = state
            go = ptr > 0
            if any_hit:
                go = go & (best[1] < 0)
            return go

        def body(state):
            stack, ptr, best = state
            node = stack[ptr - 1]
            ptr = ptr - 1

            cb_min = wbvh["bmin"][node]          # (W, 3)
            cb_max = wbvh["bmax"][node]
            child = wbvh["child"][node]          # (W,)
            count = wbvh["count"][node]

            t1 = (cb_min - origin[None, :]) * inv_dir[None, :]
            t2 = (cb_max - origin[None, :]) * inv_dir[None, :]
            tnear = jnp.max(jnp.minimum(t1, t2), axis=-1)
            tfar = jnp.min(jnp.maximum(t1, t2), axis=-1)
            hit = (tfar >= jnp.maximum(tnear, 0.0)) & (tnear < best[0]) & \
                  (child >= 0)

            # leaves: masked triangle loop per hit leaf slot (static unroll
            # over W keeps this a handful of fori_loops)
            for j in range(w):
                is_leaf_hit = hit[j] & (count[j] > 0)
                new_best = _leaf_intersect(
                    origin, direction, child[j], count[j] & 0x7FFFFFFF,
                    tris, leaf_size, best, t_epsilon)
                best = jax.tree.map(
                    lambda nb, ob: jnp.where(is_leaf_hit, nb, ob),
                    new_best, best)

            # internal nodes: push hit children (static unroll, ordered by
            # slot; near-child ordering arrives with the distance sort below)
            push = hit & (count < 0)
            order = jnp.argsort(jnp.where(push, tnear, BIG_T))[::-1]
            for j in range(w):
                slot = order[j]
                do = push[slot]
                stack = stack.at[jnp.minimum(ptr, STACK_DEPTH - 1)].set(
                    jnp.where(do, child[slot], stack[jnp.minimum(
                        ptr, STACK_DEPTH - 1)]))
                ptr = ptr + do.astype(jnp.int32)
            return stack, ptr, best

        _, _, best = jax.lax.while_loop(cond, body, state)
        return best

    t, prim, u, v = jax.vmap(one_ray)(origins, directions, t_max)
    return t, prim, u, v


def brute_force_closest(origins, directions, tris, t_epsilon=1e-4,
                        chunk=4096):
    """O(R·T) closest hit — the ground-truth oracle for tiny scenes."""
    v0, e1, e2 = tris

    def scan_chunk(carry, chunk_tris):
        t_best, prim, ub, vb = carry
        cv0, ce1, ce2, cids = chunk_tris
        hit, t, u, v = intersect_tri(
            origins[:, None, :], directions[:, None, :],
            cv0[None], ce1[None], ce2[None], t_epsilon=t_epsilon,
            t_max=t_best[:, None])
        t = jnp.where(hit, t, BIG_T)
        k = jnp.argmin(t, axis=-1)
        r = jnp.arange(t.shape[0])
        better = t[r, k] < t_best
        return (
            jnp.where(better, t[r, k], t_best),
            jnp.where(better, cids[k], prim),
            jnp.where(better, u[r, k], ub),
            jnp.where(better, v[r, k], vb),
        ), None

    n = v0.shape[0]
    pad = (-n) % chunk
    ids = jnp.arange(n, dtype=jnp.int32)
    if pad:
        zpad3 = jnp.zeros((pad, 3), v0.dtype)
        v0 = jnp.concatenate([v0, zpad3])
        e1 = jnp.concatenate([e1, zpad3])
        e2 = jnp.concatenate([e2, zpad3])
        ids = jnp.concatenate([ids, jnp.full(pad, -1, jnp.int32)])
    init = (jnp.full(origins.shape[0], BIG_T), jnp.full(
        origins.shape[0], -1, jnp.int32),
        jnp.zeros(origins.shape[0]), jnp.zeros(origins.shape[0]))
    (t, prim, u, v), _ = jax.lax.scan(
        scan_chunk, init,
        (v0.reshape(-1, chunk, 3), e1.reshape(-1, chunk, 3),
         e2.reshape(-1, chunk, 3), ids.reshape(-1, chunk)))
    return t, prim, u, v
