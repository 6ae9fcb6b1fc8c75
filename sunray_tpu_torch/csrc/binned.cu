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
// and one IEEE division; a ray reads 36 bytes and writes 16. K10 and K12
// run (items that survive the cull and the early exit) x 512 lanes x 128
// triangles tests; at 2M camera rays against the 82k-triangle sphere that
// is tens of GFLOP against ~100 MB, so operations bound them, as they bound
// K11's slab tests (every ray against every supercluster box).
//
// Design:
//   K10: one CTA of 512 threads per ray block, one thread per ray. The
//        block walks its clusters order[b, 0:count[b]] near to far; before
//        each it votes (__syncthreads_and) to skip the cluster when every
//        lane's best t is below the cluster's entry bound (any-hit: to stop
//        once every lane is occluded), then stages the cluster's K
//        triangles in shared memory (v0, e1, e2, id: 10 words each, 5 KB
//        at K = 128) and every thread tests its ray against all of them.
//   K11: one thread per ray lane; the supercluster boxes are staged in
//        shared memory in tiles of 256 (161 at full size: one tile); each
//        thread records its first 8 hits in ascending id and counts all.
//   K12: one CTA of 512 threads per block of 512 pair lanes sorted by
//        supercluster. The block walks its runs of equal supercluster id
//        (runs[b] of them, from _pair_work), stages the run's SC_K
//        clusters (20 KB at K = 128), and the lanes of that run test all
//        SC_K * K triangles. Each lane writes its result at its pair
//        position (the unsort is this scatter).
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
constexpr int kPackRows = 16;
constexpr int kIdRow = 9;
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

// Stage cluster `c` of the pack into slots [base, base + k).
__device__ __forceinline__ void stage(const Tris& s, const int* __restrict__ pack,
                                      int c, int k, int base) {
  const int* p = pack + static_cast<int64_t>(c) * kPackRows * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    for (int a = 0; a < 3; ++a) {
      const float a0 = __int_as_float(p[a * k + j]);
      s.v0[a][base + j] = a0;
      s.e1[a][base + j] = __int_as_float(p[(3 + a) * k + j]) - a0;
      s.e2[a][base + j] = __int_as_float(p[(6 + a) * k + j]) - a0;
    }
    s.id[base + j] = p[kIdRow * k + j];
  }
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

// Moller-Trumbore of ray r against staged slot j (binned_trace.py:249-289).
template <bool kPairT>
__device__ __forceinline__ bool hit_slot(const Tris& s, int j, const Ray& r, float& t,
                                         float& u, float& v) {
  const float e1x = s.e1[0][j], e1y = s.e1[1][j], e1z = s.e1[2][j];
  const float e2x = s.e2[0][j], e2y = s.e2[1][j], e2z = s.e2[2][j];
  const float px = fmaf(r.dy, e2z, -(r.dz * e2y));
  const float py = fmaf(r.dz, e2x, -(r.dx * e2z));
  const float pz = fmaf(r.dx, e2y, -(r.dy * e2x));
  const float det = fmaf(e1z, pz, fmaf(e1x, px, e1y * py));
  const bool det_ok = fabsf(det) > kDetEps;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - s.v0[0][j];
  const float tvy = r.oy - s.v0[1][j];
  const float tvz = r.oz - s.v0[2][j];
  u = fmaf(tvz, pz, fmaf(tvx, px, tvy * py)) * inv_det;
  const float qx = fmaf(tvy, e1z, -(tvz * e1y));
  const float qy = fmaf(tvz, e1x, -(tvx * e1z));
  const float qz = fmaf(tvx, e1y, -(tvy * e1x));
  v = fmaf(r.dz, qz, fmaf(r.dy, qy, r.dx * qx)) * inv_det;
  t = kPairT ? fmaf(e2z, qz, fmaf(e2x, qx, e2y * qy)) * inv_det
             : fmaf(e2z, qz, fmaf(e2y, qy, e2x * qx)) * inv_det;
  const int id = s.id[j];
  return det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= r.tmin &&
         t <= r.tmax && id >= 0 && id != r.ex;
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

// ---- K10 --------------------------------------------------------------------

template <bool kClosest>
__global__ void __launch_bounds__(kBlockRays)
binned_kernel(const int* __restrict__ order, const float* __restrict__ ents,
              const int* __restrict__ count, int n_c, const float* __restrict__ o_t,
              const float* __restrict__ d_t, const float* __restrict__ tn,
              const float* __restrict__ tx, const int* __restrict__ ex,
              const int* __restrict__ pack, int k, float* __restrict__ t_out,
              int32_t* __restrict__ tri_out, float* __restrict__ u_out,
              float* __restrict__ v_out, uint8_t* __restrict__ occ_out, int nl) {
  extern __shared__ int smem[];
  const Tris s = carve(smem, k);
  const int b = blockIdx.x;
  const int i = b * kBlockRays + threadIdx.x;
  const Ray r = load_ray(i, nl, o_t, d_t, tn[i], tx, ex);
  const bool dead = r.tmax == -INFINITY;   // padding: resolved from the start
  float best_t = dead ? -INFINITY : INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occ = dead;
  const int n = count[b];
  const int64_t row = static_cast<int64_t>(b) * n_c;
  for (int j = 0; j < n; ++j) {
    // Also the barrier that frees the previous cluster's shared slots.
    if (kClosest) {
      if (__syncthreads_and(best_t < ents[row + j])) continue;
    } else if (__syncthreads_and(occ)) {
      break;
    }
    stage(s, pack, order[row + j], k, 0);
    __syncthreads();
    if (kClosest) {
      closest_slots<false>(s, k, r, best_t, best_tri, best_u, best_v);
    } else if (!occ) {
      occ = any_slot<false>(s, k, r);
    }
  }
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

__device__ __forceinline__ float inv_dir(float v) {
  const float tiny = v >= 0.0f ? 1e-12f : -1e-12f;
  return 1.0f / (fabsf(v) < 1e-12f ? tiny : v);
}

__global__ void __launch_bounds__(256)
scan_kernel(const float* __restrict__ o_t, const float* __restrict__ d_t,
            const float* __restrict__ tn, const float* __restrict__ tx, int nl,
            const float* __restrict__ box, int n_sc, int32_t* __restrict__ slots,
            int32_t* __restrict__ cnt) {
  __shared__ float sb[6][kScTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < nl;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, ix = 1.0f, iy = 1.0f, iz = 1.0f;
  float tmin = 0.0f, tmax = -INFINITY;
  if (live) {
    ox = o_t[i];
    oy = o_t[nl + i];
    oz = o_t[2 * nl + i];
    ix = inv_dir(d_t[i]);
    iy = inv_dir(d_t[nl + i]);
    iz = inv_dir(d_t[2 * nl + i]);
    tmin = tn[i];
    tmax = tx[i];
  }
  int slot[kSlots];
#pragma unroll
  for (int l = 0; l < kSlots; ++l) slot[l] = -1;
  int c_hit = 0;
  for (int base = 0; base < n_sc; base += kScTile) {
    const int m = min(kScTile, n_sc - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      for (int a = 0; a < 6; ++a) sb[a][j] = box[(base + j) * 6 + a];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      const float t1x = (sb[0][j] - ox) * ix, t2x = (sb[3][j] - ox) * ix;
      const float t1y = (sb[1][j] - oy) * iy, t2y = (sb[4][j] - oy) * iy;
      const float t1z = (sb[2][j] - oz) * iz, t2z = (sb[5][j] - oz) * iz;
      const float tnc = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tfc = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      if (tnc <= tfc + 1e-4f && tfc >= tmin - 1e-4f && tnc <= tmax + 1e-4f) {
#pragma unroll
        for (int l = 0; l < kSlots; ++l)
          if (l == c_hit) slot[l] = base + j;
        ++c_hit;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int l = 0; l < kSlots; ++l) slots[static_cast<int64_t>(l) * nl + i] = slot[l];
  cnt[i] = c_hit;
}

// ---- K12 --------------------------------------------------------------------

template <bool kClosest>
__global__ void __launch_bounds__(kBlockRays)
pair_kernel(const int* __restrict__ cid_s, const int* __restrict__ pos_s,
            const int* __restrict__ runs, int n_sc, const float* __restrict__ o_t,
            const float* __restrict__ d_t, const float* __restrict__ tn,
            const float* __restrict__ tx, const int* __restrict__ ex, int nl,
            const int* __restrict__ pack, int n_c, int k, float* __restrict__ t_out,
            int32_t* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
  extern __shared__ int smem[];
  __shared__ int s_cid[kBlockRays];
  __shared__ int s_next;
  const Tris s = carve(smem, kScK * k);
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kBlockRays + threadIdx.x;
  const int cid = cid_s[lane];
  const int pos = pos_s[lane];
  s_cid[threadIdx.x] = cid;
  Ray r = {};
  if (cid < n_sc) r = load_ray(pos % nl, nl, o_t, d_t, tn[0], tx, ex);
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occ = false;
  const int n_runs = runs[blockIdx.x];
  int start = 0;
  __syncthreads();
  // Live runs come first: the dead sentinel n_sc sorts after every id.
  for (int run = 0; run < n_runs; ++run) {
    const int cur = s_cid[start];
    int n_slots = 0;
    for (int q = 0; q < kScK && cur * kScK + q < n_c; ++q, n_slots += k)
      stage(s, pack, cur * kScK + q, k, n_slots);
    const int t = threadIdx.x;
    if (cid == cur && (t == kBlockRays - 1 || s_cid[t + 1] != cur)) s_next = t + 1;
    __syncthreads();
    if (cid == cur) {
      if (kClosest) {
        closest_slots<true>(s, n_slots, r, best_t, best_tri, best_u, best_v);
      } else {
        occ = any_slot<true>(s, n_slots, r);
      }
    }
    start = s_next;
    __syncthreads();   // the next run's staging and s_next wait for this one
  }
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

size_t tri_smem(int slots) { return static_cast<size_t>(slots) * 10 * sizeof(int); }

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
                  const int* ex, const int* pack, int k, float* t, int32_t* tri, float* u,
                  float* v, uint8_t* occ, void* stream) {
  if (nb == 0) return 0;
  const size_t bytes = tri_smem(k);
  if (int err = set_smem(binned_kernel<kClosest>, bytes)) return err;
  binned_kernel<kClosest><<<nb, kBlockRays, bytes, static_cast<cudaStream_t>(stream)>>>(
      order, ents, count, n_c, o_t, d_t, tn, tx, ex, pack, k, t, tri, u, v, occ,
      nb * kBlockRays);
  return static_cast<int>(cudaGetLastError());
}

template <bool kClosest>
int launch_pairs(const int* cid_s, const int* pos_s, const int* runs, int n_p, int n_sc,
                 const float* o_t, const float* d_t, const float* tn, const float* tx,
                 const int* ex, int nl, const int* pack, int n_c, int k, float* t,
                 int32_t* tri, float* u, float* v, uint8_t* occ, void* stream) {
  if (n_p == 0) return 0;
  const size_t bytes = tri_smem(kScK * k);
  if (int err = set_smem(pair_kernel<kClosest>, bytes)) return err;
  pair_kernel<kClosest><<<n_p / kBlockRays, kBlockRays, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      cid_s, pos_s, runs, n_sc, o_t, d_t, tn, tx, ex, nl, pack, n_c, k, t, tri, u, v, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sunray_binned_closest(const int* order, const float* ents, const int* count, int nb,
                          int n_c, const float* o_t, const float* d_t, const float* tn,
                          const float* tx, const int* ex, const int* pack, int k, float* t,
                          int32_t* tri, float* u, float* v, void* stream) {
  return launch_binned<true>(order, ents, count, nb, n_c, o_t, d_t, tn, tx, ex, pack, k, t,
                             tri, u, v, nullptr, stream);
}

int sunray_binned_occluded(const int* order, const float* ents, const int* count, int nb,
                           int n_c, const float* o_t, const float* d_t, const float* tn,
                           const float* tx, const int* ex, const int* pack, int k,
                           uint8_t* occ, void* stream) {
  return launch_binned<false>(order, ents, count, nb, n_c, o_t, d_t, tn, tx, ex, pack, k,
                              nullptr, nullptr, nullptr, nullptr, occ, stream);
}

int sunray_cluster_scan(const float* o_t, const float* d_t, const float* tn,
                        const float* tx, int nl, const float* box, int n_sc,
                        int32_t* slots, int32_t* cnt, void* stream) {
  if (nl > 0) {
    scan_kernel<<<(nl + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        o_t, d_t, tn, tx, nl, box, n_sc, slots, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}

int sunray_pair_closest(const int* cid_s, const int* pos_s, const int* runs, int n_p,
                        int n_sc, const float* o_t, const float* d_t, const float* tn,
                        const float* tx, const int* ex, int nl, const int* pack, int n_c,
                        int k, float* t, int32_t* tri, float* u, float* v, void* stream) {
  return launch_pairs<true>(cid_s, pos_s, runs, n_p, n_sc, o_t, d_t, tn, tx, ex, nl, pack,
                            n_c, k, t, tri, u, v, nullptr, stream);
}

int sunray_pair_occluded(const int* cid_s, const int* pos_s, const int* runs, int n_p,
                         int n_sc, const float* o_t, const float* d_t, const float* tn,
                         const float* tx, const int* ex, int nl, const int* pack, int n_c,
                         int k, uint8_t* occ, void* stream) {
  return launch_pairs<false>(cid_s, pos_s, runs, n_p, n_sc, o_t, d_t, tn, tx, ex, nl, pack,
                             n_c, k, nullptr, nullptr, nullptr, nullptr, occ, stream);
}

}  // extern "C"
