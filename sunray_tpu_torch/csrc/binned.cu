// K10 / K11 / K12: the binned (cluster-culled) tracer's kernels.
//
// Replaces sunray_tpu/ops/binned_trace.py:
//   K10 binned_round   <- _round_call (_closest_kernel, _anyhit_kernel)
//   K11 cluster_scan   <- _cluster_scan (_cluster_scan_kernel)
//   K12 pair_round     <- _pair_round_call (_closest_pair_kernel,
//                         _anyhit_pair_kernel)
// The TPU kernels walk a sorted work list as a sequential grid, one
// (ray block, cluster) item per step, accumulating in VMEM across steps
// and merging fixed-size rounds in a while_loop with aliased "touched"
// planes (XLA's static shapes). Here each block of the grid owns its rays
// for the whole walk, so none of that is needed: the cull, the sorts and
// the reductions stay in PyTorch (ops/binned_trace.py), and the kernels
// get per-block lists whose lengths are known on the device.
//
// What bounds them: the triangle tests. One test is ~50 fp32 operations
// and one IEEE division; a ray reads 36 bytes and writes 16. A trace needs,
// per ray, the clusters whose box the ray enters before its closest hit
// (2.5 a camera ray on the 82k-triangle sphere) x 128 triangles tests:
// tens of GFLOP against ~100 MB at 2M rays, so operations bound K10 and
// K12, as they bound K11's slab tests (every ray against every
// supercluster box). What a kernel runs beyond those needed tests is its
// cull's slack.
//
// Design:
//   K10: one thread per ray; each block's clusters order[b, 0:count[b]]
//        walked near to far. The cull is per warp: before a cluster's K
//        triangle tests every lane slab-tests its own ray against the
//        cluster's box between tmin and min(tmax, best t) (any-hit: tmax,
//        and only while not occluded), and a warp none of whose lanes can
//        meet the box skips the tests (__any_sync). A warp of a camera
//        block is 32 neighbouring pixels of one row and needs a few
//        clusters, where the 512-pixel strip's list holds ~20.
//        Why the skip changes no output: a hit Moller-Trumbore accepts is,
//        up to its roundings, a point of the triangle, so of the box. Those
//        roundings move it by a few ulps of the coordinates in play (the
//        ray's origin, the triangle's vertices); along a grazing ray that
//        becomes a long stretch of t, which K11's slack in t does not cover
//        (a hit 1.4e-3 before a flat wall's box, ROADMAP Queue 3). So each
//        face of the box moves out by 1e-4 (1 + |box| + |origin|), max
//        norms: the cluster's share is in the ClusterSet's walk_box, the
//        lane adds its origin's. That is ~1,700 ulps of every coordinate
//        in play, on the box's thin axis too, whose slab then spans a t
//        range that grows as the ray turns parallel to it, as the error
//        does. tests/test_torch_binned_cull.py holds it on grazing, wall
//        corner and box corner rays.
//        The block's vote stays the TPU kernel's, which decides what the
//        plain version runs: closest-hit passes a cluster when every lane of
//        the 512 has its best t below the block's entry bound, so one CTA
//        of 512 threads owns the block; any-hit stops a lane's walk once it
//        is occluded, which no later test can change, so four CTAs of 128
//        share a block and stop on their own.
//        Staging is off the critical path: clusters come from the
//        ClusterSet's edge pack (v0, e1 = v1 - v0, e2 = v2 - v0, id: 10
//        rows of K words, one contiguous 5 KB run per cluster at K = 128,
//        made once per refit) into two shared-memory buffers by cp.async.
//        While the CTA tests one cluster, the copy of the next listed
//        cluster that some lane may still need (vote and box test on the
//        best t before that test, so never one it needs skipped) is in
//        flight. Blocks with nothing listed exit before any copy.
//   K11: four rays a thread (256 threads, 1,024 rays a CTA); the
//        supercluster boxes are staged in shared memory in tiles of 256
//        (161 at full size: one tile), each box as two 16-byte words, so
//        that one box costs a warp two broadcast loads that feed four slab
//        tests (one ray a thread read six 4-byte loads a test). The four
//        tests are straight-line code and the rare hits (~3 of 161 boxes
//        a ray) are recorded after them, in the ray's 8 slots held in
//        registers (118 registers, no spills, under -Xptxas -v). Boxes in
//        __constant__ memory were the other way out of the loads; they
//        would need a copy to the symbol before every launch and tiling
//        above 64 KB, for loads that are also warp-uniform. Fewer loads
//        did not move K11: on an H100 SXM at 700 W, 0.488 ms against 0.490
//        for one ray a thread on 2M GI rays x 161 boxes; two rays a thread
//        0.477, but 1.320 against 1.294 ms on 6.2M visibility rays. The
//        suspect is the issue of the slab test's ~27 operations, none of
//        which may fuse (its bits must stay the TPU kernel's): ten are
//        min/max and three compares, which may issue at half the add
//        rate; not measured (PERF.md §6).
//   K12: pair lanes sorted by supercluster, 512 a block, one CTA of 128
//        threads a quarter block; a CTA holds the runs of one or a few
//        superclusters. Each lane visits the SC_K clusters of its own
//        supercluster in order under K10's per-warp cull: before cluster
//        q, every lane of the run tests its ray against q's padded box up
//        to its running result (any-hit: tmax while not occluded), and a
//        warp none of whose lanes of that run needs q skips the K tests.
//        The argument that this changes no output is K10's, held for the
//        pair kernel's rounding of t by tests/test_torch_pair_cull.py. A
//        CTA-wide vote decides whether to stage q at all, and the
//        clusters it needs come from the edge pack by cp.async into two
//        buffers, the next one in flight while the current one is
//        tested, as in K10. The tests read each row's four consecutive
//        slots with one 16-byte load (K a multiple of 4), a quarter of
//        the shared-memory loads, at 80 registers; CTAs of 128 keep six
//        CTAs an SM at that count and leave a barrier fewer warps to wait
//        for (the first design: all SC_K * K triangles for every live
//        lane, staged by a synchronous loop, 4x the tests the rays need). A
//        lane's run comes from a warp ballot and a prefix over the CTA's
//        warps. A block with no pair (the dead tail after the sort) exits
//        at once: the wrapper fills the outputs with misses and the kernel
//        writes the live pair positions only (the unsort is this scatter).
//        Shared memory: 10 KB of buffers at K = 128 and 528 bytes.
//
// Numerics follow binned_trace.py:249-289 as XLA's CPU backend compiles
// it in interpret mode (pinned in ops/cuda_binned.py): cross products
// fmaf(a1, b2, -(a2 * b1)); det and u fmaf(x2, y2, fmaf(x0, y0, x1 * y1));
// v fmaf(x2, y2, fmaf(x1, y1, x0 * y0)); t as v in K10 and as u in K12.
// Built with --fmad=false, so these are the only contractions and each
// kernel agrees bit for bit with its plain version. Ties: slots in order,
// and a hit replaces the running best only when strictly nearer, which is
// the first slot of least t within a cluster and the earlier cluster
// between clusters (jnp.argmin and `better = tile_t < t_out`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockRays = 512;
constexpr int kSlots = 8;        // L_SLOTS
constexpr int kScK = 4;          // SC_K
constexpr int kEdgeRows = 10;   // edge pack rows: v0, e1 = v1 - v0, e2 = v2 - v0, id
constexpr int kScTile = 256;     // K11 boxes per shared-memory tile
constexpr float kDetEps = 1e-9f;

// One staged triangle slot per index: v0, e1 = v1 - v0, e2 = v2 - v0, id.
struct Tris {
  float* v0[3];
  float* e1[3];
  float* e2[3];
  int* id;
};

__device__ __forceinline__ Tris carve(int* smem, int n) {
  Tris s;
  float* f = reinterpret_cast<float*>(smem);
  for (int a = 0; a < 3; ++a) {
    s.v0[a] = f + a * n;
    s.e1[a] = f + (3 + a) * n;
    s.e2[a] = f + (6 + a) * n;
  }
  s.id = smem + 9 * n;
  return s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
  int ex;
};

__device__ __forceinline__ Ray load_ray(int i, int nl, const float* __restrict__ o_t,
                                        const float* __restrict__ d_t, float tmin,
                                        const float* __restrict__ tx,
                                        const int* __restrict__ ex) {
  Ray r;
  r.ox = o_t[i];
  r.oy = o_t[nl + i];
  r.oz = o_t[2 * nl + i];
  r.dx = d_t[i];
  r.dy = d_t[nl + i];
  r.dz = d_t[2 * nl + i];
  r.tmin = tmin;
  r.tmax = tx[i];
  r.ex = ex[i];
  return r;
}

// Moller-Trumbore of ray r against one triangle (binned_trace.py:249-289).
template <bool kPairT>
__device__ __forceinline__ bool hit_tri(float v0x, float v0y, float v0z, float e1x,
                                        float e1y, float e1z, float e2x, float e2y,
                                        float e2z, int id, const Ray& r, float& t,
                                        float& u, float& v) {
  const float px = fmaf(r.dy, e2z, -(r.dz * e2y));
  const float py = fmaf(r.dz, e2x, -(r.dx * e2z));
  const float pz = fmaf(r.dx, e2y, -(r.dy * e2x));
  const float det = fmaf(e1z, pz, fmaf(e1x, px, e1y * py));
  const bool det_ok = fabsf(det) > kDetEps;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - v0x;
  const float tvy = r.oy - v0y;
  const float tvz = r.oz - v0z;
  u = fmaf(tvz, pz, fmaf(tvx, px, tvy * py)) * inv_det;
  const float qx = fmaf(tvy, e1z, -(tvz * e1y));
  const float qy = fmaf(tvz, e1x, -(tvx * e1z));
  const float qz = fmaf(tvx, e1y, -(tvy * e1x));
  v = fmaf(r.dz, qz, fmaf(r.dy, qy, r.dx * qx)) * inv_det;
  t = kPairT ? fmaf(e2z, qz, fmaf(e2x, qx, e2y * qy)) * inv_det
             : fmaf(e2z, qz, fmaf(e2y, qy, e2x * qx)) * inv_det;
  return det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= r.tmin &&
         t <= r.tmax && id >= 0 && id != r.ex;
}

// ... against staged slot j.
template <bool kPairT>
__device__ __forceinline__ bool hit_slot(const Tris& s, int j, const Ray& r, float& t,
                                         float& u, float& v) {
  return hit_tri<kPairT>(s.v0[0][j], s.v0[1][j], s.v0[2][j], s.e1[0][j], s.e1[1][j],
                         s.e1[2][j], s.e2[0][j], s.e2[1][j], s.e2[2][j], s.id[j], r, t,
                         u, v);
}

// K12's slots [0, n) in order, four a step: each row's four words in one
// 16-byte shared load (n a multiple of 4, rows 16-byte aligned). Closest:
// into a running closest hit; any-hit: until one hits (occ).
template <bool kClosest>
__device__ __forceinline__ void pair_slots4(const Tris& s, int n, const Ray& r,
                                            float& best_t, int& best_tri, float& best_u,
                                            float& best_v, bool& occ) {
  for (int j = 0; j < n; j += 4) {
    const float4 v0x = *reinterpret_cast<const float4*>(s.v0[0] + j);
    const float4 v0y = *reinterpret_cast<const float4*>(s.v0[1] + j);
    const float4 v0z = *reinterpret_cast<const float4*>(s.v0[2] + j);
    const float4 e1x = *reinterpret_cast<const float4*>(s.e1[0] + j);
    const float4 e1y = *reinterpret_cast<const float4*>(s.e1[1] + j);
    const float4 e1z = *reinterpret_cast<const float4*>(s.e1[2] + j);
    const float4 e2x = *reinterpret_cast<const float4*>(s.e2[0] + j);
    const float4 e2y = *reinterpret_cast<const float4*>(s.e2[1] + j);
    const float4 e2z = *reinterpret_cast<const float4*>(s.e2[2] + j);
    const int4 id = *reinterpret_cast<const int4*>(s.id + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float t, u, v;
      const bool h = hit_tri<true>((&v0x.x)[q], (&v0y.x)[q], (&v0z.x)[q], (&e1x.x)[q],
                                   (&e1y.x)[q], (&e1z.x)[q], (&e2x.x)[q], (&e2y.x)[q],
                                   (&e2z.x)[q], (&id.x)[q], r, t, u, v);
      if (kClosest) {
        if (h && t < best_t) {
          best_t = t;
          best_tri = (&id.x)[q];
          best_u = u;
          best_v = v;
        }
      } else if (h) {
        occ = true;
        return;
      }
    }
  }
}

// Slots [0, n) in order into a running closest hit.
template <bool kPairT>
__device__ __forceinline__ void closest_slots(const Tris& s, int n, const Ray& r,
                                              float& best_t, int& best_tri, float& best_u,
                                              float& best_v) {
  for (int j = 0; j < n; ++j) {
    float t, u, v;
    if (hit_slot<kPairT>(s, j, r, t, u, v) && t < best_t) {
      best_t = t;
      best_tri = s.id[j];
      best_u = u;
      best_v = v;
    }
  }
}

template <bool kPairT>
__device__ __forceinline__ bool any_slot(const Tris& s, int n, const Ray& r) {
  for (int j = 0; j < n; ++j) {
    float t, u, v;
    if (hit_slot<kPairT>(s, j, r, t, u, v)) return true;
  }
  return false;
}

__device__ __forceinline__ float inv_dir(float v) {
  const float tiny = v >= 0.0f ? 1e-12f : -1e-12f;
  return 1.0f / (fabsf(v) < 1e-12f ? tiny : v);
}

// ---- K10 --------------------------------------------------------------------

constexpr int kAnyHitCta = 128;     // K10 any-hit lanes a CTA (closest: the block)
constexpr float kBoxPad = 1e-4f;    // the lane's share of the box pad
constexpr float kBoxSlack = 1e-4f;  // K11's

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying cluster c of the edge pack (kEdgeRows * k contiguous words)
// into a shared buffer laid out as carve() reads it.
__device__ __forceinline__ void stage_async(int* buf, const int* __restrict__ edges, int c,
                                            int k) {
  const int n = kEdgeRows * k;
  const int* src = edges + static_cast<int64_t>(c) * n;
  if ((k & 3) == 0) {
    for (int q = threadIdx.x * 4; q < n; q += blockDim.x * 4) cp_async16(buf + q, src + q);
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) cp_async4(buf + q, src + q);
  }
}

// Whether the ray (inverse direction ix, iy, iz) can meet the box [lo3,
// hi3], grown by po on every face, at a t in [tmin, upper]: K11's slab test
// and slack.
__device__ __forceinline__ bool enters(const float* __restrict__ box, const Ray& r, float ix,
                                       float iy, float iz, float po, float upper) {
  const float t1x = (__ldg(box + 0) - po - r.ox) * ix, t2x = (__ldg(box + 3) + po - r.ox) * ix;
  const float t1y = (__ldg(box + 1) - po - r.oy) * iy, t2y = (__ldg(box + 4) + po - r.oy) * iy;
  const float t1z = (__ldg(box + 2) - po - r.oz) * iz, t2z = (__ldg(box + 5) + po - r.oz) * iz;
  const float tnc = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tfc = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return tnc <= tfc + kBoxSlack && tfc >= r.tmin - kBoxSlack && tnc <= upper + kBoxSlack;
}

template <bool kClosest>
__global__ void __launch_bounds__(kClosest ? kBlockRays : kAnyHitCta)
binned_kernel(const int* __restrict__ order, const float* __restrict__ ents,
              const int* __restrict__ count, int n_c, const float* __restrict__ o_t,
              const float* __restrict__ d_t, const float* __restrict__ tn,
              const float* __restrict__ tx, const int* __restrict__ ex,
              const int* __restrict__ edges, const float* __restrict__ box, int k,
              float* __restrict__ t_out, int32_t* __restrict__ tri_out,
              float* __restrict__ u_out, float* __restrict__ v_out,
              uint8_t* __restrict__ occ_out, int nl) {
  extern __shared__ __align__(16) int walk_smem[];
  constexpr int kCta = kClosest ? kBlockRays : kAnyHitCta;
  const int b = blockIdx.x / (kBlockRays / kCta);
  const int i = blockIdx.x * kCta + threadIdx.x;
  const Ray r = load_ray(i, nl, o_t, d_t, tn[i], tx, ex);
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  const float po = kBoxPad * fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  const bool dead = r.tmax == -INFINITY;   // padding: resolved from the start
  float best_t = dead ? -INFINITY : INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occ = dead;
  const int n = count[b];
  const int64_t row = static_cast<int64_t>(b) * n_c;

  // The lane's box test on cluster c, bounded by its running result
  // (state passed by value, so that it stays in registers).
  auto needs = [&](int c, float bt, bool oc) {
    const float upper = kClosest ? fminf(r.tmax, bt) : (oc ? -INFINITY : r.tmax);
    return enters(box + 6 * static_cast<int64_t>(c), r, ix, iy, iz, po, upper);
  };
  // The list position after j that the CTA may still need, or n: not one
  // the vote passes, and one whose box some lane can meet. Every position
  // looked at costs a barrier, so once this returns every thread is past
  // the tests that came before the call.
  auto next = [&](int j, float bt, bool oc) {
    for (++j; j < n; ++j) {
      if (kClosest) {
        if (__syncthreads_and(bt < ents[row + j])) continue;
      } else if (__syncthreads_and(oc)) {
        return n;
      }
      if (__syncthreads_or(needs(order[row + j], bt, oc))) return j;
    }
    return n;
  };

  const int slots = kEdgeRows * k;
  int cur = next(-1, best_t, occ);
  int buf = 0;
  if (cur < n) stage_async(walk_smem, edges, order[row + cur], k);
  cp_async_commit();
  while (cur < n) {
    // Barriers inside next() free the other buffer before its copy starts.
    const int nxt = next(cur, best_t, occ);
    if (nxt < n) stage_async(walk_smem + (buf ^ 1) * slots, edges, order[row + nxt], k);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of cluster `cur` landed
    // The barrier that makes every thread's copies visible; the vote again
    // on the current results (next() voted before the last cluster's tests).
    const bool pass = kClosest ? __syncthreads_and(best_t < ents[row + cur])
                               : __syncthreads_and(occ);
    if (!pass) {
      const Tris s = carve(walk_smem + buf * slots, k);
      if (__any_sync(0xffffffffu, needs(order[row + cur], best_t, occ))) {
        if (kClosest) {
          closest_slots<false>(s, k, r, best_t, best_tri, best_u, best_v);
        } else if (!occ) {
          occ = any_slot<false>(s, k, r);
        }
      }
    } else if (!kClosest) {
      break;
    }
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  if (kClosest) {
    const bool hit = best_tri >= 0;
    t_out[i] = hit ? best_t : INFINITY;
    tri_out[i] = best_tri;
    u_out[i] = hit ? best_u : 0.0f;
    v_out[i] = hit ? best_v : 0.0f;
  } else {
    occ_out[i] = (n > 0 && occ) ? 1 : 0;
  }
}

// ---- K11 --------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanRays = 4;     // K11 rays a thread: each box load feeds 4 slab tests

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ o_t, const float* __restrict__ d_t,
            const float* __restrict__ tn, const float* __restrict__ tx, int nl,
            const float* __restrict__ box, int n_sc, int32_t* __restrict__ slots,
            int32_t* __restrict__ cnt) {
  // A tile of boxes, each as two 16-byte words {lo x, lo y, lo z, hi x},
  // {hi y, hi z, -, -}: one warp-uniform (broadcast) load apiece.
  __shared__ float4 sb[kScTile][2];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanThreads * kScanRays +
                        threadIdx.x;
  float ox[kScanRays], oy[kScanRays], oz[kScanRays];
  float ix[kScanRays], iy[kScanRays], iz[kScanRays], lo_t[kScanRays], hi_t[kScanRays];
  int slot[kScanRays][kSlots], c_hit[kScanRays];
#pragma unroll
  for (int r = 0; r < kScanRays; ++r) {
    const int64_t i = first + r * kScanThreads;
    const bool live = i < nl;
    ox[r] = live ? o_t[i] : 0.0f;
    oy[r] = live ? o_t[nl + i] : 0.0f;
    oz[r] = live ? o_t[2 * nl + i] : 0.0f;
    ix[r] = inv_dir(live ? d_t[i] : 1.0f);
    iy[r] = inv_dir(live ? d_t[nl + i] : 1.0f);
    iz[r] = inv_dir(live ? d_t[2 * nl + i] : 1.0f);
    lo_t[r] = (live ? tn[i] : 0.0f) - 1e-4f;
    hi_t[r] = (live ? tx[i] : -INFINITY) + 1e-4f;
    c_hit[r] = 0;
#pragma unroll
    for (int l = 0; l < kSlots; ++l) slot[r][l] = -1;
  }
  for (int base = 0; base < n_sc; base += kScTile) {
    const int m = min(kScTile, n_sc - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kScanThreads) {
      const float* b = box + static_cast<int64_t>(base + j) * 6;
      sb[j][0] = make_float4(b[0], b[1], b[2], b[3]);
      sb[j][1] = make_float4(b[4], b[5], 0.0f, 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 p = sb[j][0], q = sb[j][1];
      // The rays' tests in straight-line code, the rare hits after them.
      bool hit[kScanRays];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kScanRays; ++r) {
        const float t1x = (p.x - ox[r]) * ix[r], t2x = (p.w - ox[r]) * ix[r];
        const float t1y = (p.y - oy[r]) * iy[r], t2y = (q.x - oy[r]) * iy[r];
        const float t1z = (p.z - oz[r]) * iz[r], t2z = (q.y - oz[r]) * iz[r];
        const float tnc = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tfc = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        hit[r] = tnc <= tfc + 1e-4f && tfc >= lo_t[r] && tnc <= hi_t[r];
        any |= hit[r];
      }
      if (any) {
#pragma unroll
        for (int r = 0; r < kScanRays; ++r) {
#pragma unroll
          for (int l = 0; l < kSlots; ++l)
            if (hit[r] && l == c_hit[r]) slot[r][l] = base + j;
          c_hit[r] += hit[r];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kScanRays; ++r) {
    const int64_t i = first + r * kScanThreads;
    if (i >= nl) continue;
#pragma unroll
    for (int l = 0; l < kSlots; ++l) slots[static_cast<int64_t>(l) * nl + i] = slot[r][l];
    cnt[i] = c_hit[r];
  }
}

// ---- K12 --------------------------------------------------------------------

constexpr int kPairCta = 128;   // K12 pair lanes a CTA (a quarter of a block)

template <bool kClosest>
__global__ void __launch_bounds__(kPairCta)
pair_kernel(const int* __restrict__ cid_s, const int* __restrict__ pos_s,
            const int* __restrict__ runs, int n_sc, const float* __restrict__ o_t,
            const float* __restrict__ d_t, const float* __restrict__ tn,
            const float* __restrict__ tx, const int* __restrict__ ex, int nl,
            const int* __restrict__ edges, const float* __restrict__ box, int n_c, int k,
            float* __restrict__ t_out, int32_t* __restrict__ tri_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            uint8_t* __restrict__ occ_out) {
  extern __shared__ __align__(16) int pair_smem[];   // two staged clusters
  __shared__ int s_run_cid[kPairCta];
  __shared__ int s_starts[kPairCta / 32];
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kPairCta + threadIdx.x;
  // A block with no run holds no pair, and neither does any after it (the
  // dead id sorts last): the wrapper's misses stand at its positions.
  if (runs[blockIdx.x / (kBlockRays / kPairCta)] == 0) return;
  const int cid = cid_s[lane];
  const bool live = cid < n_sc;
  const int pos = live ? pos_s[lane] : 0;
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occ = false;
  // The lane's run: lanes are sorted by supercluster id, so a run starts
  // where the id changes; its index is the count of starts up to it.
  const bool start = live && (threadIdx.x == 0 || cid_s[lane - 1] != cid);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const unsigned ball = __ballot_sync(0xffffffffu, start);
  if (l == 0) s_starts[w] = __popc(ball);
  __syncthreads();
  int my_run = __popc(ball & ((2u << l) - 1u)) - 1, n_runs = 0;
  for (int q = 0; q < kPairCta / 32; ++q) {
    my_run += q < w ? s_starts[q] : 0;
    n_runs += s_starts[q];
  }
  if (!live) my_run = -1;
  if (start) s_run_cid[my_run] = cid;
  __syncthreads();

  Ray r = {};
  float ix = 1.0f, iy = 1.0f, iz = 1.0f, po = 0.0f;
  if (live) {
    r = load_ray(pos % nl, nl, o_t, d_t, tn[0], tx, ex);
    ix = inv_dir(r.dx);
    iy = inv_dir(r.dy);
    iz = inv_dir(r.dz);
    po = kBoxPad * fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  }
  // Item j is cluster j % kScK of run j / kScK's supercluster.
  const int n_items = n_runs * kScK;
  auto cluster = [&](int j) { return s_run_cid[j / kScK] * kScK + j % kScK; };
  // The lane's box test on item j, bounded by its running result.
  auto needs = [&](int j, float bt, bool oc) {
    if (my_run != j / kScK) return false;
    const float upper = kClosest ? fminf(r.tmax, bt) : (oc ? -INFINITY : r.tmax);
    return enters(box + 6 * static_cast<int64_t>(cluster(j)), r, ix, iy, iz, po, upper);
  };
  // The item after j that some lane of the CTA may need, or n_items.
  // Every item looked at costs a barrier, so once this returns a j <
  // n_items every thread is past the tests that came before the call.
  auto next = [&](int j, float bt, bool oc) {
    for (++j; j < n_items; ++j)
      if (cluster(j) < n_c && __syncthreads_or(needs(j, bt, oc))) return j;
    return n_items;
  };

  const int slots = kEdgeRows * k;
  int cur = next(-1, best_t, occ);
  int buf = 0;
  if (cur < n_items) stage_async(pair_smem, edges, cluster(cur), k);
  cp_async_commit();
  while (cur < n_items) {
    // Barriers inside next() free the other buffer before its copy starts.
    const int nxt = next(cur, best_t, occ);
    if (nxt < n_items) stage_async(pair_smem + (buf ^ 1) * slots, edges, cluster(nxt), k);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of item `cur` landed
    __syncthreads();      // ... and every thread's
    // The warp's vote again on the current results (next() voted before
    // the last item's tests).
    if (__any_sync(0xffffffffu, needs(cur, best_t, occ)) && my_run == cur / kScK) {
      const Tris s = carve(pair_smem + buf * slots, k);
      if ((k & 3) == 0) {
        if (kClosest || !occ)
          pair_slots4<kClosest>(s, k, r, best_t, best_tri, best_u, best_v, occ);
      } else if (kClosest) {
        closest_slots<true>(s, k, r, best_t, best_tri, best_u, best_v);
      } else if (!occ) {
        occ = any_slot<true>(s, k, r);
      }
    }
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  if (!live) return;
  if (kClosest) {
    const bool hit = best_tri >= 0;
    t_out[pos] = hit ? best_t : INFINITY;
    tri_out[pos] = best_tri;
    u_out[pos] = hit ? best_u : 0.0f;
    v_out[pos] = hit ? best_v : 0.0f;
  } else {
    occ_out[pos] = occ ? 1 : 0;
  }
}

size_t tri_smem(int slots) { return static_cast<size_t>(slots) * kEdgeRows * sizeof(int); }

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kClosest>
int launch_binned(const int* order, const float* ents, const int* count, int nb, int n_c,
                  const float* o_t, const float* d_t, const float* tn, const float* tx,
                  const int* ex, const int* edges, const float* box, int k, float* t,
                  int32_t* tri, float* u, float* v, uint8_t* occ, void* stream) {
  if (nb == 0) return 0;
  constexpr int kCta = kClosest ? kBlockRays : kAnyHitCta;
  const size_t bytes = 2 * tri_smem(k);   // two buffers
  if (int err = set_smem(binned_kernel<kClosest>, bytes)) return err;
  binned_kernel<kClosest><<<nb * (kBlockRays / kCta), kCta, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      order, ents, count, n_c, o_t, d_t, tn, tx, ex, edges, box, k, t, tri, u, v, occ,
      nb * kBlockRays);
  return static_cast<int>(cudaGetLastError());
}

template <bool kClosest>
int launch_pairs(const int* cid_s, const int* pos_s, const int* runs, int n_p, int n_sc,
                 const float* o_t, const float* d_t, const float* tn, const float* tx,
                 const int* ex, int nl, const int* edges, const float* box, int n_c, int k,
                 float* t, int32_t* tri, float* u, float* v, uint8_t* occ, void* stream) {
  if (n_p == 0) return 0;
  const size_t bytes = 2 * tri_smem(k);   // two buffers
  if (int err = set_smem(pair_kernel<kClosest>, bytes)) return err;
  pair_kernel<kClosest><<<n_p / kPairCta, kPairCta, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      cid_s, pos_s, runs, n_sc, o_t, d_t, tn, tx, ex, nl, edges, box, n_c, k, t, tri, u, v,
      occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sunray_binned_closest(const int* order, const float* ents, const int* count, int nb,
                          int n_c, const float* o_t, const float* d_t, const float* tn,
                          const float* tx, const int* ex, const int* edges, const float* box,
                          int k, float* t, int32_t* tri, float* u, float* v, void* stream) {
  return launch_binned<true>(order, ents, count, nb, n_c, o_t, d_t, tn, tx, ex, edges, box, k,
                             t, tri, u, v, nullptr, stream);
}

int sunray_binned_occluded(const int* order, const float* ents, const int* count, int nb,
                           int n_c, const float* o_t, const float* d_t, const float* tn,
                           const float* tx, const int* ex, const int* edges,
                           const float* box, int k, uint8_t* occ, void* stream) {
  return launch_binned<false>(order, ents, count, nb, n_c, o_t, d_t, tn, tx, ex, edges, box,
                              k, nullptr, nullptr, nullptr, nullptr, occ, stream);
}

int sunray_cluster_scan(const float* o_t, const float* d_t, const float* tn,
                        const float* tx, int nl, const float* box, int n_sc,
                        int32_t* slots, int32_t* cnt, void* stream) {
  if (nl > 0) {
    constexpr int kRaysPerBlock = kScanThreads * kScanRays;
    scan_kernel<<<(nl + kRaysPerBlock - 1) / kRaysPerBlock, kScanThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        o_t, d_t, tn, tx, nl, box, n_sc, slots, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}

int sunray_pair_closest(const int* cid_s, const int* pos_s, const int* runs, int n_p,
                        int n_sc, const float* o_t, const float* d_t, const float* tn,
                        const float* tx, const int* ex, int nl, const int* edges,
                        const float* box, int n_c, int k, float* t, int32_t* tri, float* u,
                        float* v, void* stream) {
  return launch_pairs<true>(cid_s, pos_s, runs, n_p, n_sc, o_t, d_t, tn, tx, ex, nl, edges,
                            box, n_c, k, t, tri, u, v, nullptr, stream);
}

int sunray_pair_occluded(const int* cid_s, const int* pos_s, const int* runs, int n_p,
                         int n_sc, const float* o_t, const float* d_t, const float* tn,
                         const float* tx, const int* ex, int nl, const int* edges,
                         const float* box, int n_c, int k, uint8_t* occ, void* stream) {
  return launch_pairs<false>(cid_s, pos_s, runs, n_p, n_sc, o_t, d_t, tn, tx, ex, nl, edges,
                             box, n_c, k, nullptr, nullptr, nullptr, nullptr, occ, stream);
}

}  // extern "C"
