// Native BVH builder: binned-SAH top-down build + bottom-up refit.
//
// The framework's replacement for the reference's Rust `rtbvh` crate
// (pulled via FFI in /root/reference/RFW/system/bvh/CMakeLists.txt:12-47 and
// wrapped by bvh_tree.cpp:74-101): same role — fast host-side construction
// feeding device traversal — with a plain C ABI consumed through ctypes
// (rfw_tpu/native/__init__.py). Output layout matches the numpy builder in
// rfw_tpu/bvh/builder.py exactly (cross-checked in tests/test_native.py).
//
// Build: make -C rfw_tpu/native   (or python -m rfw_tpu.native.build)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct V3 {
  float x, y, z;
  V3() : x(0), y(0), z(0) {}
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
  void set(int i, float v) { (i == 0 ? x : (i == 1 ? y : z)) = v; }
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
  V3 lo{1e30f, 1e30f, 1e30f};
  V3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const V3 &a, const V3 &b) {
    lo = vmin(lo, a);
    hi = vmax(hi, b);
  }
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildContext {
  const float *tri_min;
  const float *tri_max;
  std::vector<V3> centroid;
  float *out_bmin;
  float *out_bmax;
  int *out_child;
  int *out_count;
  int *out_depth;
  int *out_order;
  int n_nodes = 0;
  int n_placed = 0;
  int capacity = 0;
  int leaf_size = 4;
};

struct WorkItem {
  int node;
  int begin, end;  // range into the index array
  int depth;
};

void build(BuildContext &ctx, std::vector<int> &index) {
  std::vector<WorkItem> stack;
  stack.reserve(64);
  ctx.n_nodes = 1;
  stack.push_back({0, 0, (int)index.size(), 0});

  std::vector<int> tmp;
  tmp.reserve(index.size());

  while (!stack.empty()) {
    WorkItem w = stack.back();
    stack.pop_back();
    const int count = w.end - w.begin;

    AABB bounds, cbounds;
    for (int i = w.begin; i < w.end; ++i) {
      const int t = index[i];
      bounds.grow(V3(ctx.tri_min[3 * t], ctx.tri_min[3 * t + 1],
                     ctx.tri_min[3 * t + 2]),
                  V3(ctx.tri_max[3 * t], ctx.tri_max[3 * t + 1],
                     ctx.tri_max[3 * t + 2]));
      cbounds.grow(ctx.centroid[t], ctx.centroid[t]);
    }
    ctx.out_bmin[3 * w.node] = bounds.lo.x;
    ctx.out_bmin[3 * w.node + 1] = bounds.lo.y;
    ctx.out_bmin[3 * w.node + 2] = bounds.lo.z;
    ctx.out_bmax[3 * w.node] = bounds.hi.x;
    ctx.out_bmax[3 * w.node + 1] = bounds.hi.y;
    ctx.out_bmax[3 * w.node + 2] = bounds.hi.z;
    ctx.out_depth[w.node] = w.depth;

    bool make_leaf = count <= ctx.leaf_size;
    int best_axis = -1, best_bin = -1;

    if (!make_leaf) {
      // binned SAH over the largest centroid axis (mirrors the numpy
      // builder's _sah_split; see bvh/builder.py)
      float ext[3] = {cbounds.hi.x - cbounds.lo.x,
                      cbounds.hi.y - cbounds.lo.y,
                      cbounds.hi.z - cbounds.lo.z};
      int axis = 0;
      if (ext[1] > ext[0]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;
      if (ext[axis] < 1e-12f) {
        // degenerate: median split to bound leaf size
        if (count > 2 * ctx.leaf_size) {
          best_axis = 3;  // sentinel: median split
        } else {
          make_leaf = true;
        }
      } else {
        AABB bin_bounds[kNumBins];
        int bin_count[kNumBins] = {0};
        const float scale = kNumBins / ext[axis];
        const float base = cbounds.lo[axis];
        for (int i = w.begin; i < w.end; ++i) {
          const int t = index[i];
          int b = (int)((ctx.centroid[t][axis] - base) * scale);
          b = std::min(std::max(b, 0), kNumBins - 1);
          bin_count[b]++;
          bin_bounds[b].grow(
              V3(ctx.tri_min[3 * t], ctx.tri_min[3 * t + 1],
                 ctx.tri_min[3 * t + 2]),
              V3(ctx.tri_max[3 * t], ctx.tri_max[3 * t + 1],
                 ctx.tri_max[3 * t + 2]));
        }
        float left_area[kNumBins], right_area[kNumBins];
        int left_cnt[kNumBins], right_cnt[kNumBins];
        AABB acc;
        int c = 0;
        for (int b = 0; b < kNumBins; ++b) {
          acc.grow(bin_bounds[b]);
          c += bin_count[b];
          left_area[b] = acc.area();
          left_cnt[b] = c;
        }
        acc = AABB();
        c = 0;
        for (int b = kNumBins - 1; b >= 0; --b) {
          acc.grow(bin_bounds[b]);
          c += bin_count[b];
          right_area[b] = acc.area();
          right_cnt[b] = c;
        }
        float best_cost = 1e30f;
        for (int b = 0; b < kNumBins - 1; ++b) {
          if (left_cnt[b] == 0 || right_cnt[b + 1] == 0) continue;
          const float cost =
              left_area[b] * left_cnt[b] + right_area[b + 1] * right_cnt[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_bin = b;
          }
        }
        if (best_axis < 0) {
          if (count > 2 * ctx.leaf_size) best_axis = 3;  // median fallback
          else make_leaf = true;
        }
      }
    }

    if (make_leaf) {
      ctx.out_child[w.node] = ctx.n_placed;
      ctx.out_count[w.node] = count;
      for (int i = w.begin; i < w.end; ++i)
        ctx.out_order[ctx.n_placed++] = index[i];
      continue;
    }

    // partition [begin, end) — stable to match the numpy builder's masking
    int mid;
    if (best_axis == 3) {
      mid = w.begin + count / 2;
    } else {
      AABB cb;
      for (int i = w.begin; i < w.end; ++i)
        cb.grow(ctx.centroid[index[i]], ctx.centroid[index[i]]);
      const float scale = kNumBins / (cb.hi[best_axis] - cb.lo[best_axis]);
      const float base = cb.lo[best_axis];
      tmp.clear();
      int out = w.begin;
      for (int i = w.begin; i < w.end; ++i) {
        const int t = index[i];
        int b = (int)((ctx.centroid[t][best_axis] - base) * scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        if (b <= best_bin) index[out++] = t;
        else tmp.push_back(t);
      }
      mid = out;
      std::memcpy(&index[mid], tmp.data(), tmp.size() * sizeof(int));
    }

    const int left = ctx.n_nodes;
    ctx.n_nodes += 2;
    ctx.out_child[w.node] = left;
    ctx.out_count[w.node] = 0;
    stack.push_back({left + 1, mid, w.end, w.depth + 1});
    stack.push_back({left, w.begin, mid, w.depth + 1});
  }
}

}  // namespace

extern "C" {

// Returns node count, or -1 on error. Output arrays must hold 2*T nodes
// (bmin/bmax: 3 floats per node) and T ints for prim_order.
int rfw_build_bvh(const float *tri_min, const float *tri_max, int n_tris,
                  int leaf_size, float *out_bmin, float *out_bmax,
                  int *out_child, int *out_count, int *out_depth,
                  int *out_order) {
  if (n_tris <= 0) return -1;
  BuildContext ctx;
  ctx.tri_min = tri_min;
  ctx.tri_max = tri_max;
  ctx.out_bmin = out_bmin;
  ctx.out_bmax = out_bmax;
  ctx.out_child = out_child;
  ctx.out_count = out_count;
  ctx.out_depth = out_depth;
  ctx.out_order = out_order;
  ctx.leaf_size = leaf_size > 0 ? leaf_size : 4;
  ctx.centroid.resize(n_tris);
  for (int t = 0; t < n_tris; ++t)
    ctx.centroid[t] =
        V3(0.5f * (tri_min[3 * t] + tri_max[3 * t]),
           0.5f * (tri_min[3 * t + 1] + tri_max[3 * t + 1]),
           0.5f * (tri_min[3 * t + 2] + tri_max[3 * t + 2]));
  std::vector<int> index(n_tris);
  for (int t = 0; t < n_tris; ++t) index[t] = t;
  build(ctx, index);
  return ctx.n_nodes;
}

// Spatially-disjoint treelet cut (the flagship intersector's cell builder;
// mirrors bvh/wide.py spatial_treelets): recursive centroid-median kd
// splits, size-aligned so every cell but one per subtree is exactly full.
// Uses nth_element instead of full sorts. Outputs, for C cells:
//   out_count (C,), out_order (T, concatenated cell members),
//   out_bmin/out_bmax (C, 3) tight member bounds.
// Returns C, or -1 on error. Capacities: out_count >= ceil(T/size)*2,
// out_order T.
int rfw_spatial_treelets(const float *tri_min, const float *tri_max,
                         int n_tris, int size, int *out_count,
                         int *out_order, float *out_bmin, float *out_bmax) {
  if (n_tris <= 0 || size <= 0) return -1;
  std::vector<V3> c(n_tris);
  for (int t = 0; t < n_tris; ++t)
    c[t] = V3(0.5f * (tri_min[3 * t] + tri_max[3 * t]),
              0.5f * (tri_min[3 * t + 1] + tri_max[3 * t + 1]),
              0.5f * (tri_min[3 * t + 2] + tri_max[3 * t + 2]));
  std::vector<int> idx(n_tris);
  for (int t = 0; t < n_tris; ++t) idx[t] = t;

  struct Seg {
    int begin, end;
  };
  std::vector<Seg> stack{{0, n_tris}};
  std::vector<Seg> cells;
  cells.reserve((size_t)(n_tris / size + 8));
  while (!stack.empty()) {
    Seg s = stack.back();
    stack.pop_back();
    const int len = s.end - s.begin;
    if (len <= size) {
      cells.push_back(s);
      continue;
    }
    V3 lo(1e30f, 1e30f, 1e30f), hi(-1e30f, -1e30f, -1e30f);
    for (int i = s.begin; i < s.end; ++i) {
      lo = vmin(lo, c[idx[i]]);
      hi = vmax(hi, c[idx[i]]);
    }
    int ax = 0;
    float ext = hi.x - lo.x;
    if (hi.y - lo.y > ext) { ax = 1; ext = hi.y - lo.y; }
    if (hi.z - lo.z > ext) ax = 2;
    const int n_cells = (len + size - 1) / size;
    const int half = (n_cells / 2) * size;
    // size-aligned median: the python version uses a STABLE argsort and
    // takes the first `half` — replicate with a stable partial ordering
    // (nth_element + stable tie-break on the original index keeps the
    // partition deterministic; member ORDER inside a cell differs from
    // the stable-sort version, which downstream never relies on: cells
    // are unordered member sets with tight bounds)
    std::nth_element(idx.begin() + s.begin, idx.begin() + s.begin + half,
                     idx.begin() + s.end, [&](int a, int b) {
                       const float ca = c[a][ax], cb = c[b][ax];
                       if (ca != cb) return ca < cb;
                       return a < b;
                     });
    stack.push_back({s.begin + half, s.end});
    stack.push_back({s.begin, s.begin + half});
  }

  const int n = (int)cells.size();
  int placed = 0;
  for (int k = 0; k < n; ++k) {
    const Seg s = cells[k];
    out_count[k] = s.end - s.begin;
    AABB b;
    for (int i = s.begin; i < s.end; ++i) {
      const int t = idx[i];
      out_order[placed++] = t;
      b.grow(V3(tri_min[3 * t], tri_min[3 * t + 1], tri_min[3 * t + 2]),
             V3(tri_max[3 * t], tri_max[3 * t + 1], tri_max[3 * t + 2]));
    }
    for (int q = 0; q < 3; ++q) {
      out_bmin[3 * k + q] = b.lo[q];
      out_bmax[3 * k + q] = b.hi[q];
    }
  }
  return n;
}

// Locally-ordered-clustering build (PLOC, Meister & Bittner 2018) — the
// reference's rtbvh crate exposes this as its second build mode next to
// BinnedSAH (create_bvh(BvhType::LocallyOrderedClustering), consumed at
// /root/reference/RFW/system/bvh/bvh_tree.cpp:74-101). Bottom-up
// agglomerative: Morton-sort primitive centroids, then repeatedly merge
// mutually-nearest clusters (min merged surface area) within a window of
// ``search_radius`` along the sorted order. Output uses the exact layout
// of rfw_build_bvh (children consecutive, parents before children), with
// subtrees of <= leaf_size primitives collapsed into leaves at emission.
// Returns node count, or -1 on error. Same output capacities as
// rfw_build_bvh (2*T nodes, T prim order).
int rfw_build_bvh_loc(const float *tri_min, const float *tri_max, int n_tris,
                      int leaf_size, int search_radius, float *out_bmin,
                      float *out_bmax, int *out_child, int *out_count,
                      int *out_depth, int *out_order) {
  if (n_tris <= 0) return -1;
  if (leaf_size <= 0) leaf_size = 4;
  if (search_radius <= 0) search_radius = 16;

  // --- Morton order of centroids ---
  AABB scene;
  std::vector<V3> centroid(n_tris);
  for (int t = 0; t < n_tris; ++t) {
    centroid[t] = V3(0.5f * (tri_min[3 * t] + tri_max[3 * t]),
                     0.5f * (tri_min[3 * t + 1] + tri_max[3 * t + 1]),
                     0.5f * (tri_min[3 * t + 2] + tri_max[3 * t + 2]));
    scene.grow(centroid[t], centroid[t]);
  }
  auto expand10 = [](uint32_t v) {
    v &= 0x3ff;
    v = (v | (v << 16)) & 0x030000FF;
    v = (v | (v << 8)) & 0x0300F00F;
    v = (v | (v << 4)) & 0x030C30C3;
    v = (v | (v << 2)) & 0x09249249;
    return v;
  };
  std::vector<std::pair<uint32_t, int>> morton(n_tris);
  for (int t = 0; t < n_tris; ++t) {
    uint32_t code = 0;
    for (int k = 0; k < 3; ++k) {
      const float ext = scene.hi[k] - scene.lo[k];
      float u = ext > 1e-20f ? (centroid[t][k] - scene.lo[k]) / ext : 0.5f;
      u = std::min(std::max(u, 0.f), 1.f);
      code |= expand10((uint32_t)(u * 1023.f)) << (2 - k);
    }
    morton[t] = {code, t};
  }
  std::sort(morton.begin(), morton.end());

  // --- temp node pool (bottom-up) ---
  struct PNode {
    AABB box;
    int left = -1, right = -1;  // pool indices; -1 = leaf
    int prim = -1;              // original triangle id when leaf
    int n_prims = 1;
  };
  std::vector<PNode> pool;
  pool.reserve((size_t)2 * n_tris);
  std::vector<int> cluster(n_tris);  // live cluster -> pool index
  for (int i = 0; i < n_tris; ++i) {
    PNode p;
    const int t = morton[i].second;
    p.box.grow(V3(tri_min[3 * t], tri_min[3 * t + 1], tri_min[3 * t + 2]),
               V3(tri_max[3 * t], tri_max[3 * t + 1], tri_max[3 * t + 2]));
    p.prim = t;
    pool.push_back(p);
    cluster[i] = i;
  }

  std::vector<int> nearest(n_tris);
  std::vector<int> next;
  next.reserve(n_tris);
  int n_live = n_tris;
  while (n_live > 1) {
    const int r = search_radius;
    // nearest neighbor within the window (min merged area)
    for (int i = 0; i < n_live; ++i) {
      float best = 1e30f;
      int bj = i > 0 ? i - 1 : 1;
      const int j0 = std::max(0, i - r), j1 = std::min(n_live - 1, i + r);
      for (int j = j0; j <= j1; ++j) {
        if (j == i) continue;
        AABB m = pool[cluster[i]].box;
        m.grow(pool[cluster[j]].box);
        const float a = m.area();
        if (a < best) {
          best = a;
          bj = j;
        }
      }
      nearest[i] = bj;
    }
    // merge mutually-nearest pairs
    next.clear();
    for (int i = 0; i < n_live; ++i) {
      const int j = nearest[i];
      if (nearest[j] == i) {
        if (i < j) {
          PNode p;
          p.left = cluster[i];
          p.right = cluster[j];
          p.box = pool[cluster[i]].box;
          p.box.grow(pool[cluster[j]].box);
          p.prim = -1;
          p.n_prims = pool[cluster[i]].n_prims + pool[cluster[j]].n_prims;
          pool.push_back(p);
          next.push_back((int)pool.size() - 1);
        }
        // i > j: dropped (merged by its partner)
      } else {
        next.push_back(cluster[i]);
      }
    }
    if ((int)next.size() == n_live) {
      // no mutual pair (can happen only with degenerate equal areas):
      // force-merge the first adjacent pair to guarantee progress
      PNode p;
      p.left = next[0];
      p.right = next[1];
      p.box = pool[next[0]].box;
      p.box.grow(pool[next[1]].box);
      p.prim = -1;
      p.n_prims = pool[next[0]].n_prims + pool[next[1]].n_prims;
      pool.push_back(p);
      next[0] = (int)pool.size() - 1;
      next.erase(next.begin() + 1);
    }
    cluster.assign(next.begin(), next.end());
    n_live = (int)cluster.size();
  }

  // --- emit in the rfw_build_bvh layout (pre-order, children
  // consecutive, small subtrees collapsed into leaves) ---
  const int root = cluster[0];
  int n_nodes = 1, n_placed = 0;
  std::vector<std::pair<int, std::pair<int, int>>> stack;  // (pool, (out, depth))
  stack.push_back({root, {0, 0}});
  std::vector<int> collect;
  while (!stack.empty()) {
    auto [p, od] = stack.back();
    stack.pop_back();
    const int out = od.first, depth = od.second;
    const PNode &node = pool[p];
    for (int k = 0; k < 3; ++k) {
      out_bmin[3 * out + k] = node.box.lo[k];
      out_bmax[3 * out + k] = node.box.hi[k];
    }
    out_depth[out] = depth;
    if (node.n_prims <= leaf_size) {
      // collapse the whole subtree into one leaf
      collect.clear();
      std::vector<int> sub{p};
      while (!sub.empty()) {
        const int q = sub.back();
        sub.pop_back();
        if (pool[q].prim >= 0) {
          collect.push_back(pool[q].prim);
        } else {
          sub.push_back(pool[q].left);
          sub.push_back(pool[q].right);
        }
      }
      out_child[out] = n_placed;
      out_count[out] = (int)collect.size();
      for (int t : collect) out_order[n_placed++] = t;
      continue;
    }
    const int left = n_nodes;
    n_nodes += 2;
    out_child[out] = left;
    out_count[out] = 0;
    stack.push_back({node.right, {left + 1, depth + 1}});
    stack.push_back({node.left, {left, depth + 1}});
  }
  return n_nodes;
}

// Bottom-up refit (the reference's refit path, bvh_tree.cpp:104-114 /
// rtbvh refit): recompute node bounds from updated triangle bounds without
// changing topology. Children always have higher indices than parents in
// this builder's layout, so a reverse sweep is bottom-up.
void rfw_refit_bvh(float *bmin, float *bmax, const int *child,
                   const int *count, int n_nodes, const float *tri_min,
                   const float *tri_max, const int *prim_order) {
  for (int i = n_nodes - 1; i >= 0; --i) {
    if (count[i] > 0) {
      AABB b;
      for (int j = child[i]; j < child[i] + count[i]; ++j) {
        const int t = prim_order[j];
        b.grow(V3(tri_min[3 * t], tri_min[3 * t + 1], tri_min[3 * t + 2]),
               V3(tri_max[3 * t], tri_max[3 * t + 1], tri_max[3 * t + 2]));
      }
      bmin[3 * i] = b.lo.x; bmin[3 * i + 1] = b.lo.y; bmin[3 * i + 2] = b.lo.z;
      bmax[3 * i] = b.hi.x; bmax[3 * i + 1] = b.hi.y; bmax[3 * i + 2] = b.hi.z;
    } else {
      const int l = child[i];
      for (int k = 0; k < 3; ++k) {
        bmin[3 * i + k] = std::min(bmin[3 * l + k], bmin[3 * (l + 1) + k]);
        bmax[3 * i + k] = std::max(bmax[3 * l + k], bmax[3 * (l + 1) + k]);
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Wide-BVH collapse + treelet extraction (host pipeline hot path; the numpy
// versions in bvh/wide.py are Python-loop bound at animation rates).
// ---------------------------------------------------------------------------

extern "C" {

// Greedy binary→W-wide collapse (mirrors bvh/wide.py collapse_wide).
// Outputs sized for worst case n_nodes wide nodes. Returns wide node count.
int rfw_collapse_wide(const float *bmin, const float *bmax, const int *child,
                      const int *count, int n_nodes, int width,
                      float *out_bmin,   // (N, W, 3)
                      float *out_bmax, int *out_child, int *out_count) {
  if (n_nodes <= 0 || width < 2 || width > 16) return -1;
  auto area = [&](int i) {
    const float dx = std::max(bmax[3 * i] - bmin[3 * i], 0.f);
    const float dy = std::max(bmax[3 * i + 1] - bmin[3 * i + 1], 0.f);
    const float dz = std::max(bmax[3 * i + 2] - bmin[3 * i + 2], 0.f);
    return dx * dy + dy * dz + dz * dx;
  };

  std::vector<std::pair<int, int>> pending;  // (wide idx, binary idx)
  int n_wide = 1;
  pending.push_back({0, 0});
  std::vector<int> slots;
  slots.reserve(width);

  while (!pending.empty()) {
    auto [w, b] = pending.back();
    pending.pop_back();
    slots.clear();
    if (count[b] > 0) {
      slots.push_back(b);
    } else {
      slots.push_back(child[b]);
      slots.push_back(child[b] + 1);
      while ((int)slots.size() < width) {
        int pick = -1;
        float best = -1.f;
        for (size_t i = 0; i < slots.size(); ++i) {
          if (count[slots[i]] == 0 && area(slots[i]) > best) {
            best = area(slots[i]);
            pick = (int)i;
          }
        }
        if (pick < 0) break;
        const int node = slots[pick];
        slots.erase(slots.begin() + pick);
        slots.push_back(child[node]);
        slots.push_back(child[node] + 1);
      }
    }
    for (int j = 0; j < width; ++j) {
      float *obmin = out_bmin + (size_t)w * width * 3 + j * 3;
      float *obmax = out_bmax + (size_t)w * width * 3 + j * 3;
      if (j < (int)slots.size()) {
        const int s = slots[j];
        for (int k = 0; k < 3; ++k) {
          obmin[k] = bmin[3 * s + k];
          obmax[k] = bmax[3 * s + k];
        }
        if (count[s] > 0) {
          out_child[(size_t)w * width + j] = child[s];
          out_count[(size_t)w * width + j] = count[s];
        } else {
          const int nw = n_wide++;
          out_child[(size_t)w * width + j] = nw;
          out_count[(size_t)w * width + j] = -1;
          pending.push_back({nw, s});
        }
      } else {
        for (int k = 0; k < 3; ++k) {
          obmin[k] = 0.f;
          obmax[k] = 0.f;
        }
        out_child[(size_t)w * width + j] = -1;
        out_count[(size_t)w * width + j] = -1;
      }
    }
  }
  return n_wide;
}

// Cut the binary BVH into subtrees of <= size triangles (mirrors
// bvh/wide.py extract_treelets): emits (first, count, bmin, bmax) per
// treelet in prim_order space. Returns treelet count.
int rfw_extract_treelets(const float *bmin, const float *bmax,
                         const int *child, const int *count, int n_nodes,
                         int size, int *out_first, int *out_count,
                         float *out_bmin, float *out_bmax) {
  if (n_nodes <= 0 || size <= 0) return -1;
  // subtree ranges bottom-up (children have higher indices than parents)
  std::vector<int> lo(n_nodes), hi(n_nodes);
  for (int i = n_nodes - 1; i >= 0; --i) {
    if (count[i] > 0) {
      lo[i] = child[i];
      hi[i] = child[i] + count[i];
    } else {
      lo[i] = lo[child[i]];
      hi[i] = hi[child[i] + 1];
    }
  }
  int n_out = 0;
  std::vector<int> stack;
  stack.push_back(0);
  while (!stack.empty()) {
    const int i = stack.back();
    stack.pop_back();
    if (hi[i] - lo[i] <= size || count[i] > 0) {
      out_first[n_out] = lo[i];
      out_count[n_out] = hi[i] - lo[i];
      for (int k = 0; k < 3; ++k) {
        out_bmin[3 * n_out + k] = bmin[3 * i + k];
        out_bmax[3 * n_out + k] = bmax[3 * i + k];
      }
      ++n_out;
    } else {
      stack.push_back(child[i]);
      stack.push_back(child[i] + 1);
    }
  }
  return n_out;
}

}  // extern "C"
