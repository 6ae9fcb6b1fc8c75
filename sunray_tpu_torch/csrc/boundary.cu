// B1: per-pixel top-K silhouette-edge candidates of the shadow-boundary
// gradient term.
//
// Replaces the candidate pruning of sunray_tpu/render/boundary.py
// (nee_boundary_term's extraction loop, :205-231, and _candidate_score,
// :252-297). That stage is jnp, not a pallas_call: it scores every
// (pixel, edge) pair with (P, E, 3) temporaries and takes K argmax
// extractions over (P, E), for each light. Here one thread does one pixel
// and up to kLightGroup lights: it walks the edges once and keeps, for
// each of its lights, the K best (score, edge) pairs in registers.
//
// For every edge e, with x the pixel's shading point (all inputs are
// detached; the selection carries no gradient):
//   silhouette: the two faces' sides of x differ (front_i = dot(x - c_i,
//               n_i) > 0), or the edge is open (one face);
//   face2:      the side reference is the second face's opposite corner
//               (!front1 && has2 && front2, boundary.py:191-195);
//   ok:         for an endpoint or the midpoint pt, the segment x -> pt
//               heads toward the light's plane, reaches it beyond pt
//               (t > 1 + 1e-6), at a point inside the light's box widened
//               by 0.6 of its longest side;
//   score:      |b - a| / max(|mid - x|, 1e-3) where silhouette, ok and
//               the pixel's NEE mask hold, else 0.
// The K kept are the K successive argmax extractions of the reference:
// score descending, then edge index ascending, zeros included (every
// score is >= 0 and a taken one is set to -1 there).
//
// Roundings: --fmad=false keeps every multiply and add rounded on its
// own; fmaf() stands where the plain version (ops/cuda_boundary.py)
// calls ops/fp.fma: the three-term dots, the projected point y. sqrtf
// and division are IEEE (no fast math). So kernel and plain version
// give the same bits and the same selection.
//
// What bounds it here: operations. A (pixel, edge) takes 18 fp32
// operations for its two side tests; a silhouette edge of a pixel in the
// mask then takes the differences pt - x of the points any light tests
// (3 each), for each light up to three projections (up to 23 operations
// each: heading, one division, the box), and one score (11) if any light
// passes; a pixel reads 13 bytes and writes 6 K + 4 bytes a light.
//
// Design:
// - The side tests do not depend on the light, so a thread covers the
//   pixel's lights (kLightGroup of them; more go on blockIdx.y) and runs
//   them once an edge. The differences pt - x of the three points and
//   the score are shared by the lights too.
// - K is a template argument (1..kMaxK, each instantiated): the slots and
//   their shift are K long. kLightGroup lights of K slots of (score,
//   code) are 4 K registers: 32 at K = 8.
// - Only positive scores enter the slots (a slot starts at 0 and a pair
//   enters on a strictly greater score, shifting the slots below it down
//   one, so equal scores keep edge order). A lane with fewer than K live
//   edges fills its other slots with the zero-score edges in index
//   order: at most `live` edges are positive, so those are among edges
//   0..K-1, whose silhouette and face2 bits (and which of them scored)
//   the walk keeps in bitmasks.
// - A lane takes the heading test of all three points first and divides
//   only for a point that heads toward the light.
// - The edge table is staged in shared memory kEdgeTile edges at a time;
//   every lane of a warp reads the same address. Constant memory, tried
//   first for the table, took 3.4x the time on the 720p step's call on
//   an H100: warps at different edges of a 6 KB table miss its cache. The lights
//   (a block reads its two, 96 bytes) are copied into constant memory on
//   the launch's stream ahead of the kernel, kConstLights a launch, and
//   the arithmetic takes them as operands: 13% less time than from
//   shared memory. That copy is the module's: launches on two streams at
//   once would race on it (the renderer launches on one stream).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kEdgeWords = 24;      // ops/cuda_boundary.py EDGE_WORDS
constexpr int kLightWords = 12;     // ops/cuda_boundary.py LIGHT_WORDS
constexpr int kLightGroup = 2;      // lights a thread covers
constexpr int kMaxK = 16;           // ops/cuda_boundary.py MAX_K
constexpr int kEdgeTile = 256;      // edges staged a pass (24 KB)
constexpr int kConstLights = 1024;  // lights in constant memory a launch (48 KB)
constexpr int kSil = 1 << 30;       // flags packed above the edge index
constexpr int kFace2 = 1 << 29;
constexpr int kIndex = kFace2 - 1;

__constant__ float c_lights[kConstLights * kLightWords];

__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1,
                                      float x2, float y2) {
  return fmaf(x2, y2, fmaf(x1, y1, x0 * y0));
}

// The `project_ok` of boundary.py:268-287 for the light L (its
// light_table row in constant memory), any of the three points with
// differences d (a, b, mid rows): the heading tests first, then, in
// order, the points that head toward the light up to the first that
// passes.
__device__ __forceinline__ bool project_any(const float* L, const float (&x)[3], float cnum,
                                            const float (&d)[3][3]) {
  float den[3];
  unsigned heads = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    den[i] = dot3(d[i][0], L[3], d[i][1], L[4], d[i][2], L[5]);
    heads |= static_cast<unsigned>(den[i] * cnum > 0.0f) << i;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (!((heads >> i) & 1u)) continue;
    const float t = cnum / (fabsf(den[i]) > 1e-9f ? den[i] : 1e-9f);
    if (!(t > 1.0f + 1e-6f)) continue;
    const float y0 = fmaf(t, d[i][0], x[0]);
    const float y1 = fmaf(t, d[i][1], x[1]);
    const float y2 = fmaf(t, d[i][2], x[2]);
    if (y0 > L[6] && y0 < L[9] && y1 > L[7] && y1 < L[10] && y2 > L[8] && y2 < L[11])
      return true;
  }
  return false;
}

// (v, c) into slots sorted by score descending, given v > best[K - 1]:
// it takes the first slot whose score it strictly exceeds, and the slots
// below move down one.
template <int K>
__device__ __forceinline__ void insert(float (&best)[K], int (&code)[K], float v, int c) {
#pragma unroll
  for (int r = K - 1; r >= 1; --r) {
    const bool up = v > best[r - 1];
    const bool here = v > best[r];
    best[r] = up ? best[r - 1] : (here ? v : best[r]);
    code[r] = up ? code[r - 1] : (here ? c : code[r]);
  }
  if (v > best[0]) {
    best[0] = v;
    code[0] = c;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
boundary_candidates_kernel(const float* __restrict__ xs, const uint8_t* __restrict__ mask,
                           const float* __restrict__ edges, int n_edges, int n_lights,
                           int light_base, int64_t n, int32_t* __restrict__ idx,
                           int32_t* __restrict__ n_live, uint8_t* __restrict__ sil,
                           uint8_t* __restrict__ face2) {
  __shared__ float tile[kEdgeTile * kEdgeWords];
  const int l0 = blockIdx.y * kLightGroup;                 // first light of the group
  const int nl = min(kLightGroup, n_lights - l0);          // lights of the group
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool lane = p < n;
  float x[3] = {0.0f, 0.0f, 0.0f};
  bool on = false;
  if (lane) {
    x[0] = xs[3 * p];
    x[1] = xs[3 * p + 1];
    x[2] = xs[3 * p + 2];
    on = mask[p] != 0;
  }
  // A block with no pixel in the mask scores nothing: it needs the side
  // bits of edges 0..K-1 alone.
  const bool scores = __syncthreads_or(on);
  const int e_end = scores ? n_edges : min(n_edges, K);
  float cnum[kLightGroup];
  float best[kLightGroup][K];
  int code[kLightGroup][K];
  int live[kLightGroup];
  unsigned pos[kLightGroup];    // edges 0..K-1 with a positive score
#pragma unroll
  for (int l = 0; l < kLightGroup; ++l) {
    const float* L = c_lights + (l0 + (l < nl ? l : 0)) * kLightWords;
    cnum[l] = dot3(L[0] - x[0], L[3], L[1] - x[1], L[4], L[2] - x[2], L[5]);
    live[l] = 0;
    pos[l] = 0u;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      best[l][r] = 0.0f;
      code[l][r] = 0;
    }
  }
  unsigned sil_bits = 0u, f2_bits = 0u;   // of edges 0..K-1

  for (int base = 0; base < e_end; base += kEdgeTile) {
    const int count = min(kEdgeTile, e_end - base);
    __syncthreads();
    for (int i = threadIdx.x; i < count * kEdgeWords; i += kThreads)
      tile[i] = edges[static_cast<int64_t>(base) * kEdgeWords + i];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      const float* t = tile + j * kEdgeWords;
      const bool front1 =
          dot3(x[0] - t[13], t[10], x[1] - t[14], t[11], x[2] - t[15], t[12]) > 0.0f;
      const bool front2 =
          dot3(x[0] - t[19], t[16], x[1] - t[20], t[17], x[2] - t[21], t[18]) > 0.0f;
      const bool has2 = t[22] > 0.0f;
      const bool s = has2 ? (front1 != front2) : true;
      const bool f2 = !front1 && has2 && front2;
      const int e = base + j;
      if (e < K) {
        sil_bits |= static_cast<unsigned>(s) << e;
        f2_bits |= static_cast<unsigned>(f2) << e;
      }
      if (!(s && on)) continue;
      float d[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d[i][0] = t[3 * i] - x[0];
        d[i][1] = t[3 * i + 1] - x[1];
        d[i][2] = t[3 * i + 2] - x[2];
      }
      bool ok[kLightGroup];
#pragma unroll
      for (int l = 0; l < kLightGroup; ++l)
        ok[l] = l < nl && project_any(c_lights + (l0 + l) * kLightWords, x, cnum[l], d);
      bool any = false;
#pragma unroll
      for (int l = 0; l < kLightGroup; ++l) any = any || ok[l];
      if (!any) continue;
      const float nrm = sqrtf(dot3(d[2][0], d[2][0], d[2][1], d[2][1], d[2][2], d[2][2]));
      const float score = t[9] / (nrm < 1e-3f ? 1e-3f : nrm);
      if (!(score > 0.0f)) continue;
      const int c = e | kSil | (f2 ? kFace2 : 0);
#pragma unroll
      for (int l = 0; l < kLightGroup; ++l) {
        if (!ok[l]) continue;
        ++live[l];
        if (e < K) pos[l] |= 1u << e;
        if (score > best[l][K - 1]) insert<K>(best[l], code[l], score, c);
      }
    }
  }
  if (!lane) return;
#pragma unroll
  for (int l = 0; l < kLightGroup; ++l) {
    if (l >= nl) break;
    const int64_t li = light_base + l0 + l;
    n_live[li * n + p] = live[l];
    const int kept = live[l] < K ? live[l] : K;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r < kept) {
        const int64_t o = (li * K + r) * n + p;
        idx[o] = code[l][r] & kIndex;
        sil[o] = 1;
        face2[o] = (code[l][r] & kFace2) != 0;
      }
    }
    // The zero-score edges in index order after the positive ones.
    int r = kept;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (r < K && !((pos[l] >> e) & 1u)) {
        const int64_t o = (li * K + r) * n + p;
        idx[o] = e;
        sil[o] = (sil_bits >> e) & 1u;
        face2[o] = (f2_bits >> e) & 1u;
        ++r;
      }
    }
  }
}

// Launch the instantiation for k (K..kMaxK).
template <int K>
cudaError_t launch_k(int k, dim3 grid, cudaStream_t s, const float* xs, const uint8_t* mask,
                     const float* edges, int n_edges, int n_lights, int light_base, int64_t n,
                     int32_t* idx, int32_t* n_live, uint8_t* sil, uint8_t* face2) {
  if constexpr (K > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (k != K)
      return launch_k<K + 1>(k, grid, s, xs, mask, edges, n_edges, n_lights, light_base, n,
                             idx, n_live, sil, face2);
    boundary_candidates_kernel<K><<<grid, kThreads, 0, s>>>(
        xs, mask, edges, n_edges, n_lights, light_base, n, idx, n_live, sil, face2);
    return cudaGetLastError();
  }
}

}  // namespace

// {kThreads, kLightGroup, kMaxK, kEdgeTile, kConstLights}:
// ops/cuda_boundary.py models them and cuda_build checks them at load.
extern "C" int sunray_boundary_launch_shape(int* out) {
  out[0] = kThreads;
  out[1] = kLightGroup;
  out[2] = kMaxK;
  out[3] = kEdgeTile;
  out[4] = kConstLights;
  return 0;
}

// One launch for each kConstLights lights, each after its lights' copy
// into constant memory.
extern "C" int sunray_boundary_candidates(const float* xs, const uint8_t* mask,
                                          const float* edges, int n_edges,
                                          const float* lights, int n_lights, int64_t n,
                                          int k, int32_t* idx, int32_t* n_live,
                                          uint8_t* sil, uint8_t* face2, void* stream) {
  if (k < 1 || k > kMaxK || k > n_edges || n_edges >= kFace2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_lights <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  for (int base = 0; err == cudaSuccess && base < n_lights; base += kConstLights) {
    const int count = n_lights - base < kConstLights ? n_lights - base : kConstLights;
    err = cudaMemcpyToSymbolAsync(c_lights, lights + static_cast<int64_t>(base) * kLightWords,
                                  sizeof(float) * kLightWords * count, 0,
                                  cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) break;
    const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    (count + kLightGroup - 1) / kLightGroup);
    err = launch_k<1>(k, grid, s, xs, mask, edges, n_edges, count, base, n, idx, n_live, sil,
                      face2);
  }
  if (err != cudaSuccess) cudaGetLastError();   // not left for the next launch to report
  return static_cast<int>(err);
}
