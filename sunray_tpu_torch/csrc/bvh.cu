// B2 and B3: the BVH stack walks, one ray a thread.
//
// B2, the unified walk, replaces sunray_tpu/ops/bvh.py's _traverse_one
// (:375-475, called by trace_closest_bvh :505 and trace_occluded_bvh
// :535); B3, the two-level walk, replaces sunray_tpu/ops/bvh2.py's
// _traverse_one2 (:454-565, called by trace_*_bvh2 :567, :592). Neither
// is a pallas_call: JAX walks every ray of a block in lock step with
// lax.while_loop. A lock-step walk in PyTorch takes ~50 launches a round
// over hundreds of rounds; on the card a walk is a natural one-thread
// program, so both are hand kernels (templated on closest / any hit and on
// one / two levels).
//
// The walk, for each ray (the plain twin, ops/bvh.walk_plain, runs the
// same steps in lock step):
//   pop the top entry (node, instance code);
//   two levels: the ray into the object space of the code's instance,
//     o' = A o + b, d' = A d (d' not renormalized, so t is the world t),
//     and 1 / d' (1e12 where |d'| <= 1e-12);
//   a leaf (id < NL): Moller-Trumbore against its K triangles on
//     [tmin, best t]; the first of the least t in the leaf wins and
//     replaces the best (so a later leaf at an equal t replaces an
//     earlier one); ids become world ids by the code's offset; any hit
//     ends the walk at the first leaf with a hit;
//   an internal node (row id - NL): both children's slab tests on
//     [tmin, best t] (tn <= tf, tf >= tmin, tn <= best t); push the far
//     child, then the near one (the left is near when tn_l <= tn_r); the
//     stack pointer is clamped to kStack - 1, as JAX's; a child's
//     instance code 0 inherits the parent's.
//
// Roundings: --fmad=false keeps every multiply and add rounded on its
// own; fmaf() stands where the plain twin calls ops/fp.fma: the three-term
// dots dot3(x, y) = fmaf(x2, y2, fmaf(x1, y1, x0 * y0)), the cross
// products' fmaf(a1, b2, -(a2 * b1)), and the instance transform's row
// dots (b is added after the fused dot). Division is IEEE. So kernel and
// twin give the same bits.
//
// What bounds it: operations. Each slab test is 27 fp32 operations and
// each triangle test 53; a ray reads 32 bytes and writes 17. The walk's
// work is data dependent (chip_smoke.py counts the tests the plain twin
// runs for each ray).
//
// Design (first version): one thread a ray, 128 threads a block, the
// stacks (node and instance code, kStack entries each) in local memory,
// a node row read as one int4 (children, codes) and three float4 loads
// (the two boxes), leaf rows through the read-only cache.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;          // ops/bvh.py STACK_DEPTH
constexpr float kDetEps = 1e-9f;    // ops/intersect.py DET_EPS

__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1, float x2,
                                      float y2) {
  return fmaf(x2, y2, fmaf(x1, y1, x0 * y0));
}

__device__ __forceinline__ float inverse_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// Slab test of one box: hit, and t near in *tn.
__device__ __forceinline__ bool box(const float o[3], const float inv[3], const float lo[3],
                                    const float hi[3], float tmin, float tmax, float* tn) {
  float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t1 = (lo[c] - o[c]) * inv[c];
    const float t2 = (hi[c] - o[c]) * inv[c];
    t_near = fmaxf(t_near, fminf(t1, t2));
    t_far = fminf(t_far, fmaxf(t1, t2));
  }
  *tn = t_near;
  return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax);
}

template <bool kAny, bool kTwoLevel>
__global__ void __launch_bounds__(kThreads)
    bvh_walk_kernel(const int4* __restrict__ node_ids, const float4* __restrict__ node_box,
                    const float* __restrict__ leaf_v, const int* __restrict__ leaf_ids,
                    int nl, int k, const int* __restrict__ root, const float* __restrict__ inst_inv,
                    const int* __restrict__ inst_off, const float* __restrict__ orig,
                    const float* __restrict__ dir, const float* __restrict__ tmin_a,
                    const float* __restrict__ tmax_a, const int* __restrict__ exclude,
                    int64_t n, float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    uint8_t* __restrict__ hit_out, int* __restrict__ tests) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const float wo[3] = {orig[3 * r], orig[3 * r + 1], orig[3 * r + 2]};
  const float wd[3] = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  const float tmin = tmin_a[r];
  const int ex = exclude != nullptr ? exclude[r] : 0;
  float best_t = tmax_a[r], best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool found = false;

  int stack[kStack];
  int istack[kStack];
  stack[0] = __ldg(root);
  istack[0] = kTwoLevel ? __ldg(root + 1) : 0;
  int sp = 1;
  int box_tests = 0, tri_tests = 0;
  float o[3], d[3], inv[3];
  if (!kTwoLevel) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = wo[c];
      d[c] = wd[c];
      inv[c] = inverse_dir(wd[c]);
    }
  }

  while (sp > 0 && !(kAny && found)) {
    const int s = sp - 1;
    const int node = stack[s];
    const int code = istack[s];
    if (kTwoLevel) {
      const float* a = inst_inv + 12 * static_cast<int64_t>(code);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float a0 = __ldg(a + 3 * i), a1 = __ldg(a + 3 * i + 1), a2 = __ldg(a + 3 * i + 2);
        o[i] = dot3(a0, wo[0], a1, wo[1], a2, wo[2]) + __ldg(a + 9 + i);
        d[i] = dot3(a0, wd[0], a1, wd[1], a2, wd[2]);
        inv[i] = inverse_dir(d[i]);
      }
    }
    if (node < nl) {
      // Leaf: its K triangles; the first of the least t wins.
      const float* lv = leaf_v + static_cast<int64_t>(node) * k * 9;
      const int* li = leaf_ids + static_cast<int64_t>(node) * k;
      const int off = kTwoLevel ? __ldg(inst_off + code) : 0;
      float lt = INFINITY, lu = 0.0f, lvv = 0.0f;
      int ltri = 0;
      bool lok = false, first = true;
      for (int j = 0; j < k; ++j) {
        const float* tri = lv + 9 * j;
        const int id = __ldg(li + j);
        const float ax = __ldg(tri), ay = __ldg(tri + 1), az = __ldg(tri + 2);
        const float e1x = __ldg(tri + 3) - ax, e1y = __ldg(tri + 4) - ay,
                    e1z = __ldg(tri + 5) - az;
        const float e2x = __ldg(tri + 6) - ax, e2y = __ldg(tri + 7) - ay,
                    e2z = __ldg(tri + 8) - az;
        const float px = fmaf(d[1], e2z, -(d[2] * e2y));
        const float py = fmaf(d[2], e2x, -(d[0] * e2z));
        const float pz = fmaf(d[0], e2y, -(d[1] * e2x));
        const float det = dot3(e1x, px, e1y, py, e1z, pz);
        const bool det_ok = fabsf(det) > kDetEps;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tx = o[0] - ax, ty = o[1] - ay, tz = o[2] - az;
        const float u = dot3(tx, px, ty, py, tz, pz) * inv_det;
        const float qx = fmaf(ty, e1z, -(tz * e1y));
        const float qy = fmaf(tz, e1x, -(tx * e1z));
        const float qz = fmaf(tx, e1y, -(ty * e1x));
        const float v = dot3(d[0], qx, d[1], qy, d[2], qz) * inv_det;
        const float t = dot3(e2x, qx, e2y, qy, e2z, qz) * inv_det;
        const int wid = id + off;
        tri_tests += id >= 0 ? 1 : 0;
        const bool ok = det_ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= tmin) &
                        (t <= best_t) & (id >= 0) & (exclude == nullptr || wid != ex);
        const float tm = ok ? t : INFINITY;
        // torch.argmin / jnp.argmin: the first index of the least value.
        if (first || tm < lt) {
          lt = tm;
          lu = u;
          lvv = v;
          ltri = wid;
          lok = ok;
          first = false;
        }
      }
      if (lok) {
        best_t = lt;
        best_u = lu;
        best_v = lvv;
        best_tri = ltri;
        found = true;
      }
      sp = s;
      continue;
    }
    // Internal: children, codes and both boxes from one row.
    const int row = node - nl;
    const int4 ids = __ldg(node_ids + row);
    const float4 b0 = __ldg(node_box + 3 * row);
    const float4 b1 = __ldg(node_box + 3 * row + 1);
    const float4 b2 = __ldg(node_box + 3 * row + 2);
    const float llo[3] = {b0.x, b0.y, b0.z}, lhi[3] = {b0.w, b1.x, b1.y};
    const float rlo[3] = {b1.z, b1.w, b2.x}, rhi[3] = {b2.y, b2.z, b2.w};
    float tn_l, tn_r;
    const bool hit_l = box(o, inv, llo, lhi, tmin, best_t, &tn_l);
    const bool hit_r = box(o, inv, rlo, rhi, tmin, best_t, &tn_r);
    box_tests += 2;
    const int il = kTwoLevel && ids.z > 0 ? ids.z : code;
    const int ir = kTwoLevel && ids.w > 0 ? ids.w : code;
    const bool l_near = tn_l <= tn_r;
    const int far_c = l_near ? ids.y : ids.x, far_i = l_near ? ir : il;
    const bool far_h = l_near ? hit_r : hit_l;
    const int near_c = l_near ? ids.x : ids.y, near_i = l_near ? il : ir;
    const bool near_h = l_near ? hit_l : hit_r;
    if (far_h) {
      stack[s] = far_c;
      istack[s] = far_i;
    }
    const int s1 = s + (far_h ? 1 : 0);
    const int s1c = s1 < kStack - 1 ? s1 : kStack - 1;
    if (near_h) {
      stack[s1c] = near_c;
      istack[s1c] = near_i;
    }
    const int s2 = s1 + (near_h ? 1 : 0);
    sp = s2 < kStack - 1 ? s2 : kStack - 1;
  }
  if (tests != nullptr) {
    tests[2 * r] = box_tests;
    tests[2 * r + 1] = tri_tests;
  }
  hit_out[r] = found ? 1 : 0;
  if (!kAny) {
    t_out[r] = found ? best_t : INFINITY;
    tri_out[r] = best_tri;
    u_out[r] = best_u;
    v_out[r] = best_v;
  }
}

template <bool kAny, bool kTwoLevel>
cudaError_t launch(const int4* node_ids, const float4* node_box, const float* leaf_v,
                   const int* leaf_ids, int nl, int k, const int* root, const float* inst_inv,
                   const int* inst_off, const float* o, const float* d, const float* tmin,
                   const float* tmax, const int* exclude, int64_t n, float* t, int* tri,
                   float* u, float* v, uint8_t* hit, int* tests, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  bvh_walk_kernel<kAny, kTwoLevel><<<grid, kThreads, 0, s>>>(
      node_ids, node_box, leaf_v, leaf_ids, nl, k, root, inst_inv, inst_off, o, d,
      tmin, tmax, exclude, n, t, tri, u, v, hit, tests);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sunray_bvh_launch_shape(int* out) {
  out[0] = kThreads;
  out[1] = kStack;
  return 0;
}

// One launch. two_level: B3 (inst_inv, inst_off given), else B2. any_hit:
// only hit is written; else t, tri, u, v and hit. exclude may be null;
// tests, where given, gets each ray's (box tests, triangle tests).
extern "C" int sunray_bvh_walk(const void* node_ids, const void* node_box, int n_nodes,
                               const float* leaf_v, const int* leaf_ids, int nl, int k,
                               const int* root, const float* inst_inv, const int* inst_off,
                               int two_level, int any_hit, const float* o, const float* d,
                               const float* tmin, const float* tmax, const int* exclude,
                               int64_t n, float* t, int* tri, float* u, float* v,
                               uint8_t* hit, int* tests, void* stream) {
  if (nl < 1 || k < 1 || n_nodes < 1 || (two_level && (inst_inv == nullptr || inst_off == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto ni = static_cast<const int4*>(node_ids);
  auto nb = static_cast<const float4*>(node_box);
  cudaError_t err;
  if (two_level) {
    err = any_hit ? launch<true, true>(ni, nb, leaf_v, leaf_ids, nl, k, root, inst_inv,
                                       inst_off, o, d, tmin, tmax, exclude, n, t, tri, u, v,
                                       hit, tests, s)
                  : launch<false, true>(ni, nb, leaf_v, leaf_ids, nl, k, root,
                                        inst_inv, inst_off, o, d, tmin, tmax, exclude, n, t,
                                        tri, u, v, hit, tests, s);
  } else {
    err = any_hit ? launch<true, false>(ni, nb, leaf_v, leaf_ids, nl, k, root,
                                        inst_inv, inst_off, o, d, tmin, tmax, exclude, n, t,
                                        tri, u, v, hit, tests, s)
                  : launch<false, false>(ni, nb, leaf_v, leaf_ids, nl, k, root,
                                         inst_inv, inst_off, o, d, tmin, tmax, exclude, n, t,
                                         tri, u, v, hit, tests, s);
  }
  return static_cast<int>(err);
}
