// B1: per-pixel top-K silhouette-edge candidates of the shadow-boundary
// gradient term.
//
// Replaces the candidate pruning of sunray_tpu/render/boundary.py
// (nee_boundary_term's extraction loop, :205-231, and _candidate_score,
// :252-297). That stage is jnp, not a pallas_call: it scores every
// (pixel, edge) pair with (P, E, 3) temporaries and takes K argmax
// extractions over (P, E), for each light. Here one thread does one
// (pixel, light): it walks the edges once and keeps its K best
// (score, edge) pairs in registers.
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
// score is >= 0 and a taken one is set to -1 there). A new pair enters
// only on a strictly greater score than the slot it takes; once it
// enters, the slots below it shift down one, so equal scores keep edge
// order.
//
// Roundings: --fmad=false keeps every multiply and add rounded on its
// own; fmaf() stands where the plain version (ops/cuda_boundary.py)
// calls ops/fp.fma: the three-term dots, the projected point y. sqrtf
// and division are IEEE (no fast math). So kernel and plain version
// give the same bits and the same selection.
//
// What bounds it here: operations. Each (pixel, light, edge) evaluation
// takes ~120 fp32 operations (two side tests, up to three projections,
// one norm and one division) on 24 words of edge data that every thread
// of a block reads from shared memory; a pixel reads 13 bytes and writes
// 6 K + 4 bytes a light. The edge table is staged in shared memory a tile
// at a time, once a block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kEdgeWords = 24;    // ops/cuda_boundary.py EDGE_WORDS
constexpr int kLightWords = 12;   // ops/cuda_boundary.py LIGHT_WORDS
constexpr int kEdgeTile = 256;    // edges staged a pass (24 KB)
constexpr int kMaxK = 16;         // ops/cuda_boundary.py MAX_K
constexpr int kSil = 1 << 30;     // flags packed above the edge index
constexpr int kFace2 = 1 << 29;
constexpr int kIndex = kFace2 - 1;

__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1,
                                      float x2, float y2) {
  return fmaf(x2, y2, fmaf(x1, y1, x0 * y0));
}

struct Light {
  float p0[3], nl[3], lo[3], hi[3];
};

// The `project_ok` of boundary.py:268-287 for the point (px, py, pz).
__device__ __forceinline__ bool project_ok(const float* x, const Light& l, float cnum,
                                           float px, float py, float pz) {
  const float d0 = px - x[0], d1 = py - x[1], d2 = pz - x[2];
  const float denom = dot3(d0, l.nl[0], d1, l.nl[1], d2, l.nl[2]);
  if (!(denom * cnum > 0.0f)) return false;
  const float t = cnum / (fabsf(denom) > 1e-9f ? denom : 1e-9f);
  if (!(t > 1.0f + 1e-6f)) return false;
  const float y0 = fmaf(t, d0, x[0]);
  const float y1 = fmaf(t, d1, x[1]);
  const float y2 = fmaf(t, d2, x[2]);
  return y0 > l.lo[0] && y0 < l.hi[0] && y1 > l.lo[1] && y1 < l.hi[1] &&
         y2 > l.lo[2] && y2 < l.hi[2];
}

__global__ void __launch_bounds__(kThreads)
boundary_candidates_kernel(const float* __restrict__ xs, const uint8_t* __restrict__ mask,
                           const float* __restrict__ edges, int n_edges,
                           const float* __restrict__ lights, int64_t n, int k,
                           int32_t* __restrict__ idx, int32_t* __restrict__ n_live,
                           uint8_t* __restrict__ sil, uint8_t* __restrict__ face2) {
  __shared__ float tile[kEdgeTile * kEdgeWords];
  const int li = blockIdx.y;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool lane = p < n;
  Light l;
  for (int i = 0; i < 3; ++i) {
    l.p0[i] = lights[li * kLightWords + i];
    l.nl[i] = lights[li * kLightWords + 3 + i];
    l.lo[i] = lights[li * kLightWords + 6 + i];
    l.hi[i] = lights[li * kLightWords + 9 + i];
  }
  float x[3] = {0.0f, 0.0f, 0.0f};
  bool on = false;
  if (lane) {
    x[0] = xs[3 * p];
    x[1] = xs[3 * p + 1];
    x[2] = xs[3 * p + 2];
    on = mask[p] != 0;
  }
  const float cnum = dot3(l.p0[0] - x[0], l.nl[0], l.p0[1] - x[1], l.nl[1],
                          l.p0[2] - x[2], l.nl[2]);

  float best[kMaxK];
  int code[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    best[j] = -INFINITY;
    code[j] = 0;
  }
  float kth = -INFINITY;   // best[k - 1]
  int live = 0;

  for (int base = 0; base < n_edges; base += kEdgeTile) {
    const int count = min(kEdgeTile, n_edges - base);
    __syncthreads();
    for (int i = threadIdx.x; i < count * kEdgeWords; i += kThreads)
      tile[i] = edges[static_cast<int64_t>(base) * kEdgeWords + i];
    __syncthreads();
    if (!lane) continue;
    for (int j = 0; j < count; ++j) {
      const float* e = tile + j * kEdgeWords;
      const bool front1 = dot3(x[0] - e[13], e[10], x[1] - e[14], e[11],
                               x[2] - e[15], e[12]) > 0.0f;
      const bool front2 = dot3(x[0] - e[19], e[16], x[1] - e[20], e[17],
                               x[2] - e[21], e[18]) > 0.0f;
      const bool has2 = e[22] > 0.0f;
      const bool s = has2 ? (front1 != front2) : true;
      const bool f2 = !front1 && has2 && front2;
      float score = 0.0f;
      if (s && on &&
          (project_ok(x, l, cnum, e[0], e[1], e[2]) ||
           project_ok(x, l, cnum, e[3], e[4], e[5]) ||
           project_ok(x, l, cnum, e[6], e[7], e[8]))) {
        const float v0 = e[6] - x[0], v1 = e[7] - x[1], v2 = e[8] - x[2];
        const float nrm = sqrtf(dot3(v0, v0, v1, v1, v2, v2));
        score = e[9] / (nrm < 1e-3f ? 1e-3f : nrm);
      }
      live += score > 0.0f;
      if (score > kth) {
        int c = (base + j) | (s ? kSil : 0) | (f2 ? kFace2 : 0);
        float v = score;
        bool moved = false;
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < k && (moved || v > best[r])) {
            const float tv = best[r];
            const int tc = code[r];
            best[r] = v;
            code[r] = c;
            v = tv;
            c = tc;
            moved = true;
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxK; ++r)
          if (r == k - 1) kth = best[r];
      }
    }
  }
  if (!lane) return;
  n_live[li * n + p] = live;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k) {
      const int64_t o = (static_cast<int64_t>(li) * k + r) * n + p;
      idx[o] = code[r] & kIndex;
      sil[o] = (code[r] & kSil) != 0;
      face2[o] = (code[r] & kFace2) != 0;
    }
  }
}

}  // namespace

extern "C" int sunray_boundary_candidates(const float* xs, const uint8_t* mask,
                                          const float* edges, int n_edges,
                                          const float* lights, int n_lights, int64_t n,
                                          int k, int32_t* idx, int32_t* n_live,
                                          uint8_t* sil, uint8_t* face2, void* stream) {
  if (k < 1 || k > kMaxK || n_edges >= kFace2) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && n_lights > 0) {
    const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), n_lights);
    boundary_candidates_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        xs, mask, edges, n_edges, lights, n, k, idx, n_live, sil, face2);
  }
  return static_cast<int>(cudaGetLastError());
}
