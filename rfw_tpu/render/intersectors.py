"""Intersector implementations pluggable into the integrator.

Each factory returns an ``Intersector(closest, occluded)`` pair over the
device scene dict. This is the seam where the engines differ — the rebuild's
analog of the reference's per-backend traversal code:

* ``brute``  — O(R·T) dense, exact; the ground-truth oracle (tiny scenes).
* ``bvh``    — 4-wide BVH gather traversal (ops/traverse.py); runs on
               every backend; the CPURT/EmbreeRT analog.
* ``dense``  — treelet-binned dense Woop intersection in pure jnp
               (the visit kernel's test, XLA-compiled; tiny scenes).
* ``visit``  — the per-block visit-list Pallas kernel through Triton
               (ops/visit_intersect.py).
* ``tlas``   — two-level instancing traversal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import traverse
from ..ops.intersect import BIG_T, closest_hit_woop, intersect_woop
from .integrator import Intersector


def _tris_from_scene(scene):
    v = scene["tri_vertices"]
    return (v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])


def make_brute_intersector(config: RenderConfig) -> Intersector:
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        t, prim, u, v = traverse.brute_force_closest(
            o, d, _tris_from_scene(scene), t_epsilon=config.t_epsilon)
        if t_max is not None:
            prim = jnp.where(t < t_max, prim, -1)
            t = jnp.where(prim >= 0, t, BIG_T)
        return t, prim, u, v

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        t, prim, _, _ = traverse.brute_force_closest(
            o, d, _tris_from_scene(scene), t_epsilon=config.t_epsilon)
        return (prim >= 0) & (t < dist)

    return Intersector(closest, occluded)


def make_bvh_intersector(config: RenderConfig,
                         leaf_size: int = 4) -> Intersector:
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        return traverse.traverse_wide(
            o, d, scene["bvh"], _tris_from_scene(scene),
            leaf_size=leaf_size, t_epsilon=config.t_epsilon, t_max=t_max)

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        t, prim, _, _ = traverse.traverse_wide(
            o, d, scene["bvh"], _tris_from_scene(scene),
            leaf_size=leaf_size, t_max=dist, t_epsilon=config.t_epsilon,
            any_hit=True)
        return prim >= 0

    return Intersector(closest, occluded)


def make_dense_intersector(config: RenderConfig) -> Intersector:
    """Treelet-binned dense intersection, pure jnp.

    For each block of rays: slab-test the block against every treelet AABB
    (vectorized), then intersect the block densely against every treelet any
    ray in the block hit — except in jnp we cannot skip treelets with static
    shapes, so this variant intersects against *all* treelets and relies on
    XLA throughput. Correct everywhere; economical only for small scenes
    — the visit kernel adds the dynamic skipping.
    """

    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        tl = scene["treelets"]
        t, slot, u, v = closest_hit_woop(
            o, d, tl["woop"], jnp.arange(tl["woop"].shape[0]),
            t_epsilon=config.t_epsilon, tri_verts=tl["verts"],
            t_max=BIG_T if t_max is None else t_max)
        prim = jnp.where(slot >= 0, tl["slot_to_prim"][jnp.maximum(slot, 0)],
                         -1)
        t = jnp.where(prim >= 0, t, BIG_T)
        return t, prim, u, v

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        tl = scene["treelets"]
        hit, t, u, v = intersect_woop(o, d, tl["woop"],
                                      t_epsilon=config.t_epsilon)
        return jnp.any(hit & (t < dist[:, None]), axis=-1)

    return Intersector(closest, occluded)


def make_visit_intersector(config: RenderConfig) -> Intersector:
    """Per-block exact visit-list kernel (ops/visit_intersect.py): exact
    per-ray candidates at cell granularity, per-256-ray-block union visit
    lists, no pair-expansion sorts — the round-2 flagship path for every
    stream class (coherent and scattered)."""
    from ..ops import visit_intersect

    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        return visit_intersect.closest_hit(scene, o, d, config,
                                           t_max=t_max, sort=sort,
                                           coherent=coherent)

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        return visit_intersect.any_hit(scene, o, d, dist, config,
                                       sort=sort, coherent=coherent)

    return Intersector(closest, occluded)


# premask ray-chunk: bounds the (rays × instances) slab-test transient to
# ~RAY_CHUNK·I·3 floats; module-level so tests can shrink it to exercise
# the padded multi-chunk scan path with small ray counts
_TLAS_RAY_CHUNK = 65536


def make_tlas_intersector(config: RenderConfig) -> Intersector:
    """Two-level TLAS/BLAS traversal (reference TopLevelBVH parity,
    top_level_bvh.cpp:104-135): per instance, cull against its world AABB,
    transform surviving rays into object space with the cached inverse
    (direction left unnormalized so object t == world t), and run the
    wide-BVH traversal of the SHARED per-mesh BLAS. Requires
    ``config.use_tlas`` so the device scene carries the tables.

    Instance-count scaling (the reference's BVH-over-instances role,
    top_level_bvh.cpp:55-102): the cull is **touched-compaction**: ONE
    batched slab pass marks every instance some ray crosses (a few fused
    elementwise ops over the (rays × instances) matrix, chunked over
    rays), the touched ids are compacted to the front with a stable
    argsort, and a ``while_loop`` visits ONLY those — off-ray instances
    cost ~0 loop iterations instead of a scan step + lax.cond each.
    Results are bitwise-identical to the full scan: the premask is
    a conservative superset (caps only shrink during the walk), untouched
    instances can't produce hits, and touched ones are visited in original
    instance order so strict ``<`` tie-breaks match.

    Hit prims map back into the permuted flattened shading planes via
    inst_base + orig_to_perm, so the integrator shades identically to the
    flattened intersectors.

    SUPPORT BOUND: the instance loop costs O(touched instances) per
    launch, so this is the oracle/dynamics path at example-scale instance
    counts. The production instancing route is the flagship flatten +
    device-refit path.
    """

    def _loop(scene, o, d, t_max, any_hit: bool):
        RAY_CHUNK = _TLAS_RAY_CHUNK   # bounds the premask transient
        tl = scene["tlas"]
        n = o.shape[0]
        best_t = jnp.asarray(jnp.broadcast_to(t_max, (n,)), jnp.float32)
        best_flat = jnp.full(n, -1, jnp.int32)
        best_u = jnp.zeros(n)
        best_v = jnp.zeros(n)
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)

        def any_cross(lo_all, hi_all, o_, iv_, cap_):
            """Per instance: (does any ray in this chunk cross its AABB?,
            min entry distance over crossing rays — drives the
            front-to-back visit order below)."""
            t1 = (lo_all[None, :, :] - o_[:, None, :]) * iv_[:, None, :]
            t2 = (hi_all[None, :, :] - o_[:, None, :]) * iv_[:, None, :]
            tn = jnp.max(jnp.minimum(t1, t2), axis=-1)
            tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
            hit = (tf >= jnp.maximum(tn, 0.0)) & (tn < cap_[:, None])
            return (jnp.any(hit, axis=0),
                    jnp.min(jnp.where(hit, jnp.maximum(tn, 0.0), BIG_T),
                            axis=0))

        for blas in tl["blas"]:
            wb = {"bmin": blas["bmin"], "bmax": blas["bmax"],
                  "child": blas["child"], "count": blas["count"]}
            tris = (blas["v0"], blas["e1"], blas["e2"])
            prim_order = blas["prim_order"]
            lo_all = blas["inst_bmin"]
            hi_all = blas["inst_bmax"]
            inst_inv = blas["inst_inv"]
            inst_base = blas["inst_base"]
            n_inst = lo_all.shape[0]

            # --- batched premask: one fused pass over all (ray, inst)
            # pairs, chunked over rays to bound the transient ---
            if n <= RAY_CHUNK:
                cross, tn_min = any_cross(lo_all, hi_all, o, inv_d, best_t)
            else:
                pad = (-n) % RAY_CHUNK
                o_r = jnp.pad(o, ((0, pad), (0, 0))).reshape(
                    -1, RAY_CHUNK, 3)
                # padded rows: inv_d = 0 ⇒ tn = tf = 0, cap = −1 ⇒ no hit
                iv_r = jnp.pad(inv_d, ((0, pad), (0, 0))).reshape(
                    -1, RAY_CHUNK, 3)
                cap_r = jnp.pad(best_t, (0, pad),
                                constant_values=-1.0).reshape(-1, RAY_CHUNK)

                def scan_body(acc, xs):
                    oc, ic, cc = xs
                    c, tm = any_cross(lo_all, hi_all, oc, ic, cc)
                    return (acc[0] | c, jnp.minimum(acc[1], tm)), None

                (cross, tn_min), _ = jax.lax.scan(
                    scan_body,
                    (jnp.zeros(n_inst, bool), jnp.full(n_inst, BIG_T)),
                    (o_r, iv_r, cap_r))

            # touched instances first, FRONT-TO-BACK by min entry distance
            # (shrinks best_t early, so the in-loop occlusion cull below
            # skips far instances' traversals — the traversal-order win a
            # real instance BVH would give, top_level_bvh.cpp:55-102)
            order = jnp.argsort(jnp.where(cross, tn_min, jnp.inf),
                                stable=True).astype(jnp.int32)
            count = jnp.sum(cross.astype(jnp.int32))

            def body_fn(state, wb=wb, tris=tris, prim_order=prim_order,
                        lo_all=lo_all, hi_all=hi_all, inst_inv=inst_inv,
                        inst_base=inst_base, order=order):
                k, best_t, best_flat, best_u, best_v = state
                i = order[k]
                lo, hi = lo_all[i], hi_all[i]
                inv, base = inst_inv[i], inst_base[i]
                t1 = (lo[None] - o) * inv_d
                t2 = (hi[None] - o) * inv_d
                tn = jnp.max(jnp.minimum(t1, t2), axis=-1)
                tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
                hit_box = (tf >= jnp.maximum(tn, 0.0)) & (tn < best_t)
                if any_hit:
                    hit_box = hit_box & (best_flat < 0)

                def visit(carry):
                    best_t, best_flat, best_u, best_v = carry
                    hi = jax.lax.Precision.HIGHEST
                    o_obj = jnp.matmul(o, inv[:3, :3].T,
                                       precision=hi) + inv[:3, 3]
                    d_obj = jnp.matmul(d, inv[:3, :3].T, precision=hi)
                    t_i, prim_i, u_i, v_i = traverse.traverse_wide(
                        o_obj, d_obj, wb, tris, leaf_size=4,
                        t_max=jnp.where(hit_box, best_t, 0.0),
                        t_epsilon=config.t_epsilon, any_hit=any_hit)
                    better = (prim_i >= 0) & (t_i < best_t)
                    orig = base + prim_order[jnp.maximum(prim_i, 0)]
                    flat = tl["orig_to_perm"][orig]
                    return (jnp.where(better, t_i, best_t),
                            jnp.where(better, flat, best_flat),
                            jnp.where(better, u_i, best_u),
                            jnp.where(better, v_i, best_v))

                # occlusion-driven runtime cull: committed hits shrink
                # best_t as the front-to-back walk progresses, so later
                # (farther) instances fail tn < best_t for every ray and
                # skip their whole BLAS traversal
                carry = (best_t, best_flat, best_u, best_v)
                best_t, best_flat, best_u, best_v = jax.lax.cond(
                    jnp.any(hit_box), visit, lambda c: c, carry)
                return (k + 1, best_t, best_flat, best_u, best_v)

            def cond_fn(state, count=count):
                more = state[0] < count
                if any_hit:     # all lanes occluded ⇒ nothing left to find
                    more = more & jnp.any(state[2] < 0)
                return more

            (_, best_t, best_flat, best_u, best_v) = jax.lax.while_loop(
                cond_fn, body_fn,
                (jnp.int32(0), best_t, best_flat, best_u, best_v))
        return best_t, best_flat, best_u, best_v

    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        n = o.shape[0]
        tm = jnp.full(n, BIG_T) if t_max is None else t_max
        t, prim, u, v = _loop(scene, o, d, tm, any_hit=False)
        return jnp.where(prim >= 0, t, BIG_T), prim, u, v

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        _, prim, _, _ = _loop(scene, o, d, dist, any_hit=True)
        return prim >= 0

    return Intersector(closest, occluded)


FACTORIES = {
    "tlas": make_tlas_intersector,
    "brute": make_brute_intersector,
    "bvh": make_bvh_intersector,
    "dense": make_dense_intersector,
    "visit": make_visit_intersector,
}
