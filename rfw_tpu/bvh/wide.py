"""Wide-BVH collapse + treelet extraction.

The reference collapses its binary BVH into a 4-wide SoA MBVH for SIMD
traversal (/root/reference/RFW/system/bvh/.../mbvh_node.h:43-107, built by the
rtbvh ``create_mbvh`` call). Here the same collapse feeds two consumers:

* ``collapse_wide`` — W-wide SoA nodes for the gather-based jnp traversal
  (ops/traverse.py), W=4 by default like the reference.
* ``extract_treelets`` — cuts the binary BVH into leaf subtrees of at most K
  triangles. Because the builder permutes triangles into leaf-contiguous
  order, each treelet is a *contiguous* triangle range; the dense and visit
  intersectors test (ray block × treelet) pairs densely. A second, shallow BVH over
  treelet AABBs provides the culling hierarchy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .builder import BVH, build_bvh

INVALID = np.int32(-1)

# consecutive kd cells grouped into one cull unit ("super"): the scene
# build packs per-super bounds tables (scene_data cbounds/sbmin/sbmax) and
# the visit intersector's optional "super" granularity walks supers
# instead of cells (ops/visit_intersect._granularity).
SUPER_G = 8


@dataclasses.dataclass
class WideBVH:
    """W-wide SoA nodes. child[i, j] encoding: <0 empty; otherwise if
    count[i, j] > 0 it is the first-triangle offset of a leaf, else the index
    of another wide node (cf. MBVHNode child/count packing, mbvh_node.h)."""

    bmin: np.ndarray    # (N, W, 3)
    bmax: np.ndarray    # (N, W, 3)
    child: np.ndarray   # (N, W) int32
    count: np.ndarray   # (N, W) int32  (-1 = internal, >=0 leaf tri count)

    @property
    def width(self) -> int:
        return int(self.child.shape[1])

    @property
    def node_count(self) -> int:
        return int(self.child.shape[0])


def collapse_wide(bvh: BVH, width: int = 4,
                  use_native: bool = True) -> WideBVH:
    """Greedy collapse: repeatedly expand the child with the largest surface
    area until ``width`` slots are used (the standard 2→4-wide collapse the
    rtbvh crate performs). Uses the C++ implementation when available
    (animation-rate updates; Python fallback below is loop-bound).
    """
    if use_native:
        from ..native import native_collapse_wide
        out = native_collapse_wide(bvh, width)
        if out is not None:
            return WideBVH(*out)

    def area(i: int) -> float:
        d = np.maximum(bvh.bmax[i] - bvh.bmin[i], 0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    nodes_bmin: list[np.ndarray] = []
    nodes_bmax: list[np.ndarray] = []
    nodes_child: list[np.ndarray] = []
    nodes_count: list[np.ndarray] = []

    # queue of (wide slot index, binary node index)
    pending: list[tuple[int, int]] = []

    def alloc_wide() -> int:
        nodes_bmin.append(np.zeros((width, 3), np.float32))
        nodes_bmax.append(np.zeros((width, 3), np.float32))
        nodes_child.append(np.full(width, INVALID, np.int32))
        nodes_count.append(np.full(width, INVALID, np.int32))
        return len(nodes_child) - 1

    root_wide = alloc_wide()
    pending.append((root_wide, 0))

    while pending:
        wide_idx, bin_idx = pending.pop()
        # gather up to `width` binary subtree roots under bin_idx
        if bvh.count[bin_idx] > 0:
            slots = [bin_idx]
        else:
            slots = [int(bvh.child[bin_idx]), int(bvh.child[bin_idx]) + 1]
            while len(slots) < width:
                # expand the internal slot with the largest surface area
                internal = [s for s in slots if bvh.count[s] == 0]
                if not internal:
                    break
                pick = max(internal, key=area)
                slots.remove(pick)
                slots.extend([int(bvh.child[pick]), int(bvh.child[pick]) + 1])

        for j, s in enumerate(slots):
            nodes_bmin[wide_idx][j] = bvh.bmin[s]
            nodes_bmax[wide_idx][j] = bvh.bmax[s]
            if bvh.count[s] > 0:  # leaf
                nodes_child[wide_idx][j] = bvh.child[s]
                nodes_count[wide_idx][j] = bvh.count[s]
            else:
                w = alloc_wide()
                nodes_child[wide_idx][j] = w
                nodes_count[wide_idx][j] = INVALID
                pending.append((w, s))

    return WideBVH(
        bmin=np.stack(nodes_bmin), bmax=np.stack(nodes_bmax),
        child=np.stack(nodes_child), count=np.stack(nodes_count),
    )


@dataclasses.dataclass
class Treelets:
    """Contiguous triangle ranges + their bounds + a top hierarchy.

    first/count: (T,) ranges into the builder's permuted triangle order,
    padded so every treelet spans exactly ``size`` slots in the *padded*
    triangle arrays (padding triangles are degenerate ⇒ never hit); this
    gives the dense intersector static shapes.
    """

    first: np.ndarray       # (T,) int32 into padded triangle arrays
    count: np.ndarray       # (T,) int32 real triangles in the treelet
    bmin: np.ndarray        # (T, 3)
    bmax: np.ndarray        # (T, 3)
    size: int               # padded triangles per treelet
    pad_map: np.ndarray     # (T*size,) int32: padded slot → original tri id (-1 pad)
    top: WideBVH            # wide hierarchy over treelet AABBs (leaves =
    #                         treelet ids via count>0 ⇒ child = treelet id)


def spatial_treelets(tri_min: np.ndarray, tri_max: np.ndarray,
                     size: int = 128, top_width: int = 4) -> Treelets:
    """Cut triangles into SPATIALLY DISJOINT cells of ≤ ``size`` members by
    recursive centroid-median kd splits; cell bounds are tight AABBs over the
    member triangles.

    Why this replaces SAH-subtree extraction for the dense intersector:
    SAH-subtree treelet AABBs overlap so heavily that a ray's slab path
    crosses tens of treelets *before its own hit distance* (front-to-back
    early exit cannot help — the entry bounds are all earlier than the
    hit); disjoint centroid cells cut that to one or two (a host-side
    count on a 305k-triangle interior). The trade-off
    — boundary triangles poke slightly past their cell (the cells' tight
    bounds may overlap a little) — costs ~3 extra crossings per ray and
    nothing in correctness: the intersector's conservative per-block
    front-to-back bound logic never assumed disjointness.

    Splits are size-aligned (the left child takes a multiple of ``size``), so
    every cell except at most one per subtree is exactly full — dense-lane
    occupancy stays near 100% where SAH cuts average ~60%.

    This is the visit lists' answer to the reference's SBVH spatial splits
    (top_level_bvh.cpp:41, rtbvh create_spatial_bvh): spatial partitioning
    buys exactly what a lockstep dense intersector needs — short, genuinely
    front-to-back candidate lists.
    """
    t = tri_min.shape[0]
    native = None
    if t > 4 * size:   # native pays off past a few cells
        from ..native import native_spatial_treelets
        native = native_spatial_treelets(tri_min, tri_max, size)
    if native is not None:
        # C++ cutter (nth_element medians — ~20x the python loop at
        # Sponza scale; cell membership can differ from the stable-sort
        # path only on exact centroid ties, and member order inside a
        # cell is unspecified either way: cells are unordered sets with
        # tight bounds, downstream exactness never depends on them)
        count, order, bmin, bmax = native
        n = count.shape[0]
        pad_map = np.full(n * size, -1, np.int32)
        ends = np.cumsum(count)
        starts = ends - count
        slots = (np.arange(n, dtype=np.int64)[:, None] * size
                 + np.arange(size, dtype=np.int64)[None, :])
        valid = np.arange(size, dtype=np.int64)[None, :] < count[:, None]
        src = starts[:, None] + np.arange(size, dtype=np.int64)[None, :]
        pad_map[slots[valid]] = order[src[valid]]
    else:
        c = 0.5 * (tri_min + tri_max)
        cells: list[np.ndarray] = []
        stack = [np.arange(t, dtype=np.int64)]
        while stack:
            idx = stack.pop()
            if len(idx) <= size:
                cells.append(idx)
                continue
            cc = c[idx]
            ax = int(np.argmax(cc.max(0) - cc.min(0)))
            order = np.argsort(cc[:, ax], kind="stable")
            n_cells = -(-len(idx) // size)
            half = (n_cells // 2) * size      # size-aligned split point
            stack.append(idx[order[half:]])
            stack.append(idx[order[:half]])

        n = len(cells)
        count = np.array([len(ci) for ci in cells], np.int32)
        bmin = np.stack([tri_min[ci].min(0)
                         for ci in cells]).astype(np.float32)
        bmax = np.stack([tri_max[ci].max(0)
                         for ci in cells]).astype(np.float32)
        pad_map = np.full(n * size, -1, np.int32)
        for k, ci in enumerate(cells):
            pad_map[k * size:k * size + len(ci)] = ci

    # the leaf→treelet-id remap below requires EXACTLY one cell per top
    # leaf; the native builder's degenerate-centroid path may emit 2-prim
    # leaves at leaf_size=1 (coincident cell centroids), so fall back to
    # the numpy builder (which median-splits degenerates down to 1) when
    # that happens
    top_bin = build_bvh(bmin, bmax, leaf_size=1)
    if int(top_bin.count.max(initial=0)) > 1:
        top_bin = build_bvh(bmin, bmax, leaf_size=1, use_native=False)
    top = collapse_wide(top_bin, width=top_width)
    leaf_mask = top.count > 0
    top.child = np.where(
        leaf_mask, top_bin.prim_order[np.clip(top.child, 0, n - 1)],
        top.child)

    return Treelets(
        first=np.arange(n, dtype=np.int32) * size, count=count,
        bmin=bmin, bmax=bmax, size=size, pad_map=pad_map, top=top,
    )


def extract_treelets(bvh: BVH, tri_min: np.ndarray, tri_max: np.ndarray,
                     size: int = 64, top_width: int = 4,
                     use_native: bool = True) -> Treelets:
    """Cut the binary BVH into subtrees of ≤ ``size`` triangles.

    Walk from the root; descend while a subtree holds more than ``size``
    tris; each stopping point becomes one treelet (its triangle range is
    contiguous in prim_order by construction). C++ fast path when built.
    """
    native = None
    if use_native:
        from ..native import native_extract_treelets
        native = native_extract_treelets(bvh, size)
    if native is not None:
        first_a, count_a, bmin_a, bmax_a = native
        first = list(first_a)
        count = list(count_a)
        bmin = list(bmin_a)
        bmax = list(bmax_a)
    else:
        # subtree triangle ranges bottom-up (children appear after parents
        # in the builder's layout)
        n = bvh.node_count
        lo = np.zeros(n, np.int64)
        hi = np.zeros(n, np.int64)
        for i in range(n - 1, -1, -1):
            if bvh.count[i] > 0:
                lo[i] = bvh.child[i]
                hi[i] = bvh.child[i] + bvh.count[i]
            else:
                l = bvh.child[i]
                lo[i] = lo[l]
                hi[i] = hi[l + 1]

        first, count, bmin, bmax = [], [], [], []
        stack = [0]
        while stack:
            i = stack.pop()
            if hi[i] - lo[i] <= size or bvh.count[i] > 0:
                first.append(lo[i])
                count.append(hi[i] - lo[i])
                bmin.append(bvh.bmin[i])
                bmax.append(bvh.bmax[i])
            else:
                stack.append(int(bvh.child[i]))
                stack.append(int(bvh.child[i]) + 1)

    t = len(first)
    count_arr = np.asarray(count, np.int32)
    pad_first = np.arange(t, dtype=np.int32) * size
    pad_map = np.full(t * size, -1, np.int32)
    first_arr = np.asarray(first, np.int64)
    # vectorized scatter of per-treelet ranges into the padded layout
    slot_idx = np.arange(size)[None, :]                      # (1, size)
    valid = slot_idx < count_arr[:, None]                    # (t, size)
    src = np.minimum(first_arr[:, None] + slot_idx,
                     len(bvh.prim_order) - 1)
    flat = np.where(valid, bvh.prim_order[src], -1).reshape(-1)
    pad_map[:] = flat

    top_bin = build_bvh(np.stack(bmin), np.stack(bmax), leaf_size=1,
                        use_native=False)
    # remap the top BVH's "triangle" ids to treelet ids
    top = collapse_wide(top_bin, width=top_width)
    leaf_mask = top.count > 0
    top.child = np.where(
        leaf_mask, top_bin.prim_order[np.clip(top.child, 0, t - 1)],
        top.child)

    return Treelets(
        first=pad_first, count=count_arr,
        bmin=np.stack(bmin).astype(np.float32),
        bmax=np.stack(bmax).astype(np.float32),
        size=size, pad_map=pad_map, top=top,
    )
