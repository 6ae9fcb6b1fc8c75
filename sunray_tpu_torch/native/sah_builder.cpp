// Binned-SAH BVH builder (host-side, native).
//
// The native runtime component replacing the reference's Vulkan-side
// quality BVH build (vkCmdBuildAccelerationStructures with
// PREFER_FAST_TRACE, acceleration_structure/accel.rs:82-156). Built at
// scene load / on the AsState SLOW_BUILD op; the emitted topology feeds
// the same walk (B2) as the device LBVH but with better trees
// (SAH-optimal splits vs Morton splits).
//
// Output contract (matches sunray_tpu_torch.ops.bvh.Bvh):
//   - NL leaves of <= K triangles (padded with -1)
//   - NL-1 internal nodes, ids [0, NL-2], root 0
//   - leaf k referenced as node id (NL-1) + k
//   - leaves numbered left-to-right (DFS), so every internal node covers a
//     contiguous leaf range [first, last] (enables refit_bvh).
//
// C ABI only; bound from Python with ctypes (no pybind11 in this image).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Aabb &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildCtx {
  const float *v0, *v1, *v2;
  int leaf_size;
  std::vector<Aabb> tri_box;
  std::vector<Vec3> tri_centroid;
  std::vector<int> order;  // triangle ids, partitioned in place

  // Output, gathered during emission.
  std::vector<int> child_l, child_r, range_first, range_last;
  std::vector<float> node_min_i, node_max_i;  // internal boxes
  std::vector<float> leaf_min, leaf_max;
  std::vector<int> leaf_tri;  // NL * K
};

constexpr int kBins = 16;

struct BuiltNode {
  Aabb box;
  int start, count;       // triangle range in ctx.order
  int left = -1, right = -1;  // indices into the temp node vector
  bool leaf = false;
};

int build_recursive(BuildCtx &ctx, std::vector<BuiltNode> &nodes, int start,
                    int count) {
  Aabb box, cbox;
  for (int i = start; i < start + count; i++) {
    box.grow(ctx.tri_box[ctx.order[i]]);
    cbox.grow(ctx.tri_centroid[ctx.order[i]]);
  }
  int self = (int)nodes.size();
  nodes.push_back({box, start, count});

  if (count <= ctx.leaf_size) {
    nodes[self].leaf = true;
    return self;
  }

  // Choose the best binned-SAH split over the 3 axes.
  float best_cost = FLT_MAX;
  int best_axis = -1, best_bin = -1;
  float cb_lo[3] = {cbox.lo.x, cbox.lo.y, cbox.lo.z};
  float cb_hi[3] = {cbox.hi.x, cbox.hi.y, cbox.hi.z};
  for (int axis = 0; axis < 3; axis++) {
    float lo = cb_lo[axis], hi = cb_hi[axis];
    if (hi - lo < 1e-12f) continue;
    float scale = kBins / (hi - lo);
    Aabb bins[kBins];
    int bin_count[kBins] = {0};
    for (int i = start; i < start + count; i++) {
      int t = ctx.order[i];
      const Vec3 &c = ctx.tri_centroid[t];
      float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      int b = std::min(kBins - 1, (int)((v - lo) * scale));
      bins[b].grow(ctx.tri_box[t]);
      bin_count[b]++;
    }
    Aabb right_acc[kBins];
    Aabb acc;
    for (int b = kBins - 1; b > 0; b--) {
      acc.grow(bins[b]);
      right_acc[b] = acc;
    }
    Aabb left;
    int n_left = 0;
    for (int b = 0; b < kBins - 1; b++) {
      left.grow(bins[b]);
      n_left += bin_count[b];
      int n_right = count - n_left;
      if (n_left == 0 || n_right == 0) continue;
      float cost = left.half_area() * n_left +
                   right_acc[b + 1].half_area() * n_right;
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_bin = b;
      }
    }
  }

  int mid;
  if (best_axis < 0) {
    mid = start + count / 2;  // degenerate: median split
  } else {
    float lo = cb_lo[best_axis], hi = cb_hi[best_axis];
    float scale = kBins / (hi - lo);
    auto pred = [&](int t) {
      const Vec3 &c = ctx.tri_centroid[t];
      float v = best_axis == 0 ? c.x : (best_axis == 1 ? c.y : c.z);
      int b = std::min(kBins - 1, (int)((v - lo) * scale));
      return b <= best_bin;
    };
    int *first = ctx.order.data() + start;
    int *last = ctx.order.data() + start + count;
    int *m = std::partition(first, last, pred);
    mid = start + (int)(m - first);
    if (mid == start || mid == start + count) mid = start + count / 2;
  }

  int l = build_recursive(ctx, nodes, start, mid - start);
  int r = build_recursive(ctx, nodes, mid, start + count - mid);
  nodes[self].left = l;
  nodes[self].right = r;
  return self;
}

// Emit in the Bvh contract numbering: internals in preorder, leaves
// left-to-right. Returns (internal id) or (leaf id + marker).
struct Emitter {
  BuildCtx &ctx;
  std::vector<BuiltNode> &nodes;
  int next_internal = 0;
  int next_leaf = 0;
  int k;

  int emit(int ni) {  // returns node id in final numbering, given NL known
    BuiltNode &n = nodes[ni];
    if (n.leaf) {
      int leaf_id = next_leaf++;
      for (int j = 0; j < k; j++) {
        ctx.leaf_tri[leaf_id * k + j] =
            j < n.count ? ctx.order[n.start + j] : -1;
      }
      ctx.leaf_min[leaf_id * 3 + 0] = n.box.lo.x;
      ctx.leaf_min[leaf_id * 3 + 1] = n.box.lo.y;
      ctx.leaf_min[leaf_id * 3 + 2] = n.box.lo.z;
      ctx.leaf_max[leaf_id * 3 + 0] = n.box.hi.x;
      ctx.leaf_max[leaf_id * 3 + 1] = n.box.hi.y;
      ctx.leaf_max[leaf_id * 3 + 2] = n.box.hi.z;
      return ~leaf_id;  // marker: negative => leaf
    }
    int self = next_internal++;
    int first_leaf = next_leaf;
    int lid = emit(n.left);
    int rid = emit(n.right);
    int last_leaf = next_leaf - 1;
    ctx.child_l[self] = lid;
    ctx.child_r[self] = rid;
    ctx.range_first[self] = first_leaf;
    ctx.range_last[self] = last_leaf;
    ctx.node_min_i[self * 3 + 0] = n.box.lo.x;
    ctx.node_min_i[self * 3 + 1] = n.box.lo.y;
    ctx.node_min_i[self * 3 + 2] = n.box.lo.z;
    ctx.node_max_i[self * 3 + 0] = n.box.hi.x;
    ctx.node_max_i[self * 3 + 1] = n.box.hi.y;
    ctx.node_max_i[self * 3 + 2] = n.box.hi.z;
    return self;
  }
};

}  // namespace

extern "C" {

// Returns the number of leaves NL (or -1 on error). Output buffers must be
// sized for the worst case NL_max = num_tris:
//   child_l/child_r/range_first/range_last: NL_max ints
//   node_min/node_max: (2*NL_max) * 3 floats  (internals then leaves)
//   leaf_tri: NL_max * leaf_size ints
int sunray_build_sah_bvh(const float *v0, const float *v1, const float *v2,
                         int num_tris, int leaf_size, int *child_l,
                         int *child_r, int *range_first, int *range_last,
                         float *node_min, float *node_max, int *leaf_tri) {
  if (num_tris <= 0 || leaf_size <= 0) return -1;
  BuildCtx ctx;
  ctx.v0 = v0;
  ctx.v1 = v1;
  ctx.v2 = v2;
  ctx.leaf_size = leaf_size;
  ctx.tri_box.resize(num_tris);
  ctx.tri_centroid.resize(num_tris);
  ctx.order.resize(num_tris);
  for (int t = 0; t < num_tris; t++) {
    Vec3 a{v0[t * 3], v0[t * 3 + 1], v0[t * 3 + 2]};
    Vec3 b{v1[t * 3], v1[t * 3 + 1], v1[t * 3 + 2]};
    Vec3 c{v2[t * 3], v2[t * 3 + 1], v2[t * 3 + 2]};
    Aabb box;
    box.grow(a);
    box.grow(b);
    box.grow(c);
    ctx.tri_box[t] = box;
    ctx.tri_centroid[t] = {(a.x + b.x + c.x) / 3.f, (a.y + b.y + c.y) / 3.f,
                           (a.z + b.z + c.z) / 3.f};
    ctx.order[t] = t;
  }

  std::vector<BuiltNode> nodes;
  nodes.reserve(2 * num_tris);
  int root = build_recursive(ctx, nodes, 0, num_tris);

  int n_leaves = 0;
  for (auto &n : nodes)
    if (n.leaf) n_leaves++;
  int n_internal = n_leaves - 1;

  ctx.child_l.assign(std::max(n_internal, 0), 0);
  ctx.child_r.assign(std::max(n_internal, 0), 0);
  ctx.range_first.assign(std::max(n_internal, 0), 0);
  ctx.range_last.assign(std::max(n_internal, 0), 0);
  ctx.node_min_i.assign((size_t)std::max(n_internal, 0) * 3, 0.f);
  ctx.node_max_i.assign((size_t)std::max(n_internal, 0) * 3, 0.f);
  ctx.leaf_min.assign((size_t)n_leaves * 3, 0.f);
  ctx.leaf_max.assign((size_t)n_leaves * 3, 0.f);
  ctx.leaf_tri.assign((size_t)n_leaves * leaf_size, -1);

  Emitter em{ctx, nodes, 0, 0, leaf_size};
  em.emit(root);

  // Resolve leaf markers to final node ids: leaf k => (NL-1) + k.
  int leaf_base = n_leaves - 1;
  for (int i = 0; i < n_internal; i++) {
    if (ctx.child_l[i] < 0) ctx.child_l[i] = leaf_base + ~ctx.child_l[i];
    if (ctx.child_r[i] < 0) ctx.child_r[i] = leaf_base + ~ctx.child_r[i];
  }

  std::memcpy(child_l, ctx.child_l.data(), sizeof(int) * n_internal);
  std::memcpy(child_r, ctx.child_r.data(), sizeof(int) * n_internal);
  std::memcpy(range_first, ctx.range_first.data(), sizeof(int) * n_internal);
  std::memcpy(range_last, ctx.range_last.data(), sizeof(int) * n_internal);
  std::memcpy(node_min, ctx.node_min_i.data(),
              sizeof(float) * 3 * n_internal);
  std::memcpy(node_min + (size_t)3 * n_internal, ctx.leaf_min.data(),
              sizeof(float) * 3 * n_leaves);
  std::memcpy(node_max, ctx.node_max_i.data(),
              sizeof(float) * 3 * n_internal);
  std::memcpy(node_max + (size_t)3 * n_internal, ctx.leaf_max.data(),
              sizeof(float) * 3 * n_leaves);
  std::memcpy(leaf_tri, ctx.leaf_tri.data(),
              sizeof(int) * (size_t)n_leaves * leaf_size);
  return n_leaves;
}

}  // extern "C"
