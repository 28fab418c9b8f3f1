// Host binned-SAH BVH builder of the PyTorch port: the BVH part of
// mitsuba_im_tpu/native/bvh.cpp (mitpu_build_bvh, mitpu_tri_bounds), copied
// so that both packages build the same tree bit for bit from the same
// inputs.  The two-level cluster hierarchy (accel/hierarchy.py) is packed
// from its threaded (skip-link) depth-first layout.
//
// Built at first use by accel/bvh.py with the host C++ compiler and the
// reference Makefile's flags (-O3 -march=native -fPIC -std=c++17, -shared
// -lpthread) into build/mitsuba_im_tpu_torch/; bound with ctypes.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct AABB {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& o) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], o.lo[k]);
      hi[k] = std::max(hi[k], o.hi[k]);
    }
  }
  void grow_point(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  float half_area() const {
    float dx = std::max(0.f, hi[0] - lo[0]);
    float dy = std::max(0.f, hi[1] - lo[1]);
    float dz = std::max(0.f, hi[2] - lo[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildContext {
  const float* prim_lo;  // (N,3)
  const float* prim_hi;  // (N,3)
  const float* prim_cent;  // (N,3)
  int32_t* order;          // (N) permuted primitive ids
  int leaf_size;
  // output arrays (preallocated for 2N nodes worst case)
  float* node_lo;
  float* node_hi;
  int32_t* node_start;  // leaf: first prim in order[]; inner: -1
  int32_t* node_count;  // leaf: prim count; inner: 0
  int32_t* node_skip;   // index of next node when this subtree is done
  std::atomic<int32_t> n_nodes{0};
};

constexpr int kBins = 16;

// Builds the subtree over order[begin, end); returns node index.
// Nodes are emitted in depth-first order so an inner node's near child is
// node+1 and `skip` threads to the subtree's continuation.
static int32_t build_range(BuildContext& ctx, int begin, int end, const AABB& bounds,
                           int depth) {
  int32_t node = ctx.n_nodes.fetch_add(1);
  std::memcpy(&ctx.node_lo[node * 3], bounds.lo, 12);
  std::memcpy(&ctx.node_hi[node * 3], bounds.hi, 12);

  int count = end - begin;
  bool make_leaf = count <= ctx.leaf_size || depth > 60;

  int best_axis = -1, best_bin = -1;
  if (!make_leaf) {
    // Binned SAH over the centroid bounds.
    AABB cb;
    for (int i = begin; i < end; ++i)
      cb.grow_point(&ctx.prim_cent[ctx.order[i] * 3]);
    float best_cost = FLT_MAX;
    for (int axis = 0; axis < 3; ++axis) {
      float extent = cb.hi[axis] - cb.lo[axis];
      if (extent <= 1e-12f) continue;
      float scale = kBins / extent;
      AABB bin_bounds[kBins];
      int bin_count[kBins] = {0};
      for (int i = begin; i < end; ++i) {
        int32_t p = ctx.order[i];
        int b = std::min(kBins - 1,
                         (int)((ctx.prim_cent[p * 3 + axis] - cb.lo[axis]) * scale));
        ++bin_count[b];
        AABB pb;
        std::memcpy(pb.lo, &ctx.prim_lo[p * 3], 12);
        std::memcpy(pb.hi, &ctx.prim_hi[p * 3], 12);
        bin_bounds[b].grow(pb);
      }
      // sweep: suffix areas then prefix scan
      float right_area[kBins];
      AABB acc;
      int acc_n = 0;
      for (int b = kBins - 1; b > 0; --b) {
        acc.grow(bin_bounds[b]);
        acc_n += bin_count[b];
        right_area[b] = acc_n ? acc.half_area() * acc_n : 0.f;
      }
      acc = AABB();
      acc_n = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bin_bounds[b]);
        acc_n += bin_count[b];
        if (acc_n == 0 || acc_n == count) continue;
        float cost = acc.half_area() * acc_n + right_area[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }
    if (best_axis < 0 || best_cost >= bounds.half_area() * count)
      make_leaf = count <= 64 ? true : false;  // force split of huge nodes
    if (best_axis < 0) make_leaf = true;

    if (!make_leaf) {
      AABB cb2;
      for (int i = begin; i < end; ++i)
        cb2.grow_point(&ctx.prim_cent[ctx.order[i] * 3]);
      float extent = cb2.hi[best_axis] - cb2.lo[best_axis];
      float scale = kBins / extent;
      int32_t* mid = std::partition(
          ctx.order + begin, ctx.order + end, [&](int32_t p) {
            int b = std::min(
                kBins - 1,
                (int)((ctx.prim_cent[p * 3 + best_axis] - cb2.lo[best_axis]) * scale));
            return b <= best_bin;
          });
      int m = (int)(mid - ctx.order);
      if (m == begin || m == end) m = begin + count / 2;  // fallback median

      AABB lb, rb;
      for (int i = begin; i < m; ++i) {
        AABB pb;
        std::memcpy(pb.lo, &ctx.prim_lo[ctx.order[i] * 3], 12);
        std::memcpy(pb.hi, &ctx.prim_hi[ctx.order[i] * 3], 12);
        lb.grow(pb);
      }
      for (int i = m; i < end; ++i) {
        AABB pb;
        std::memcpy(pb.lo, &ctx.prim_lo[ctx.order[i] * 3], 12);
        std::memcpy(pb.hi, &ctx.prim_hi[ctx.order[i] * 3], 12);
        rb.grow(pb);
      }
      ctx.node_start[node] = -1;
      ctx.node_count[node] = 0;
      int32_t left = build_range(ctx, begin, m, lb, depth + 1);
      (void)left;  // left == node + 1 by construction
      int32_t right = build_range(ctx, m, end, rb, depth + 1);
      // Thread skip links: left subtree's exit -> right; right's -> parent's skip
      // (filled by caller via fixup below). We store right sibling for fixup.
      ctx.node_skip[node] = right;  // temporarily: index of far child
      return node;
    }
  }

  ctx.node_start[node] = begin;
  ctx.node_count[node] = count;
  ctx.node_skip[node] = -2;  // leaf marker pre-fixup
  return node;
}

// Convert (far-child links) into proper skip threading.
static void fixup_skips(BuildContext& ctx, int32_t node, int32_t skip) {
  while (true) {
    int32_t far_child = ctx.node_skip[node];
    if (ctx.node_count[node] > 0 || far_child == -2) {  // leaf
      ctx.node_skip[node] = skip;
      return;
    }
    ctx.node_skip[node] = skip;
    fixup_skips(ctx, node + 1, far_child);  // near child exits into far child
    node = far_child;                        // tail-recurse into far child
  }
}

}  // namespace

extern "C" {

// Returns number of nodes written. All output buffers must hold >= 2N-1
// entries (x3 for lo/hi). order must hold N entries.
int32_t mitpu_build_bvh(int32_t n_prims, const float* prim_lo, const float* prim_hi,
                        const float* prim_cent, int32_t leaf_size, float* node_lo,
                        float* node_hi, int32_t* node_start, int32_t* node_count,
                        int32_t* node_skip, int32_t* order) {
  if (n_prims <= 0) return 0;
  BuildContext ctx;
  ctx.prim_lo = prim_lo;
  ctx.prim_hi = prim_hi;
  ctx.prim_cent = prim_cent;
  ctx.order = order;
  ctx.leaf_size = leaf_size;
  ctx.node_lo = node_lo;
  ctx.node_hi = node_hi;
  ctx.node_start = node_start;
  ctx.node_count = node_count;
  ctx.node_skip = node_skip;
  for (int32_t i = 0; i < n_prims; ++i) order[i] = i;
  AABB root;
  for (int32_t i = 0; i < n_prims; ++i) {
    AABB pb;
    std::memcpy(pb.lo, &prim_lo[i * 3], 12);
    std::memcpy(pb.hi, &prim_hi[i * 3], 12);
    root.grow(pb);
  }
  build_range(ctx, 0, n_prims, root, 0);
  fixup_skips(ctx, 0, -1);
  return ctx.n_nodes.load();
}

// Parallel AABB+centroid computation for triangle soup (v0,v1,v2 packed).
void mitpu_tri_bounds(int32_t n_tris, const float* p0, const float* e1,
                      const float* e2, float* lo, float* hi, float* cent) {
  int hw = (int)std::thread::hardware_concurrency();
  int n_threads = std::max(1, std::min(hw, n_tris / 65536 + 1));
  auto work = [&](int t) {
    int64_t b = (int64_t)n_tris * t / n_threads;
    int64_t e = (int64_t)n_tris * (t + 1) / n_threads;
    for (int64_t i = b; i < e; ++i) {
      for (int k = 0; k < 3; ++k) {
        float a = p0[i * 3 + k];
        float v1 = a + e1[i * 3 + k];
        float v2 = a + e2[i * 3 + k];
        float mn = std::min(a, std::min(v1, v2));
        float mx = std::max(a, std::max(v1, v2));
        lo[i * 3 + k] = mn;
        hi[i * 3 + k] = mx;
        cent[i * 3 + k] = (mn + mx) * 0.5f;
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
}

}  // extern "C"
