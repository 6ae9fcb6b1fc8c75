// K3-K6: the ReSTIR merge kernels (RIS audition, DI temporal merge, DI
// spatial merge, GI spatial merge).
//
// Replace sunray_tpu/ops/pallas_restir.py: ris_audition_pallas (_kernel),
// di_temporal_pallas (_di_temporal_kernel), di_spatial_pallas
// (_di_spatial_kernel) and gi_spatial_pallas (_gi_spatial_kernel). The TPU
// kernels hold 4096 pixels as (8, 512) planes in VMEM, rebuild the PCG
// draws through a 31-bit split (Mosaic has no uint32 -> f32 cast), fetch
// lights by select chains or one-hot MXU products, and take every
// neighbour and history reservoir as planes gathered outside the kernel.
//
// What bounds them here: per pixel a few hundred fp32 operations against
// ~100-300 bytes of reservoir and surface data (a 2M-pixel launch moves
// 0.2-0.6 GB, ~0.1-0.2 ms at 3.35 TB/s; K3 with K=16 candidates is
// ~16 x 150 operations a pixel, ~5 GFLOP, ~75 us at the fp32 peak).
// Design: one thread per pixel over plain (P,) and (P, 3) arrays, every
// intermediate in registers; no (K, P) or (T, P) plane is ever written.
// K3 reads each light as a 64-byte record computed once a light, from
// shared memory when the table fits and otherwise through __ldg; K4 reads
// the history reservoir at the reprojected pixel and K5 each neighbour at
// its shared offset in place; K3-K5 read light emission from the table.
// Light and triangle ids stay int32 throughout.
//
// Numerics follow the plain PyTorch versions (ops/cuda_restir.py, which
// follow the JAX package's jnp paths) operation for operation. The
// library is built with --fmad=false, so the only fused multiply-adds are
// the fmaf() calls, placed where the plain versions call ops/fp.fma; x^5
// is x * ((x*x) * (x*x)); sqrt and division are IEEE (no fast math). The
// draws are the jnp PCG draws in uint32, u = (float)result * 2^-32-ish
// (rng.py:45-51), not the Pallas 31-bit split; seeds come back bit-equal.
//
// bf16 shading (cfg.shading_dtype="bf16"): each kernel has a second
// instantiation that reads the five attribute planes (normal, view, albedo,
// roughness, metallic) as __nv_bfloat16 and rounds with
// __float2bfloat16_rn exactly where the plain versions round
// (ops/brdf.py's bf16 rule: an operation between bf16 operands takes them
// rounded and computes in fp32; its result is rounded where another bf16
// operation reads it and read unrounded where an fp32 operation does).
// K5 also reads the fp32 normal for its neighbour test and K6 the fp32
// normal, albedo and metallic for its final ray and contribution, as the
// JAX frame does. The fp32 instantiations are the kernels they were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 8;
constexpr float kPi = 3.14159f;
constexpr float kInvPi = 0.3183101415634155f;          // f32(1 / f32(kPi))
constexpr float kInvU32Max = 2.3283064365386963e-10f;  // f32(1 / 4294967295)
// f32(1 / f32(e1 - e0)) of the smoothsteps (restir.py:711-713).
constexpr float kInvSs0990 = 11.11111068725586f;       // (0.9, 0.99)
constexpr float kInvSs0520 = 6.666666507720947f;       // (0.05, 0.20)
// The bf16 path's constants: bf16(0.04), bf16(0.001) and f32(1 / bf16(kPi))
// (a bf16 x / PI compiles to x * kInvPiBf16).
constexpr float kBf0p04 = 0.0400390625f;
constexpr float kBf0p001 = 0.00099945068359375f;
constexpr float kInvPiBf16 = 0.31840795278549194f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* __restrict__ p, long long i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
// Attribute planes: fp32, or bf16 widened (exactly) to fp32.
__device__ __forceinline__ float lda(const float* __restrict__ p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float lda(const __nv_bfloat16* __restrict__ p, long long i) {
  return __bfloat162float(__ldg(p + i));
}
template <typename A>
__device__ __forceinline__ V3 lda3(const A* __restrict__ p, long long i) {
  return {lda(p, 3 * i), lda(p, 3 * i + 1), lda(p, 3 * i + 2)};
}
// x rounded to bf16 (nearest even), held in fp32 (ops/brdf.rb).
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename A>
constexpr bool kIsBf16 = !std::is_same<A, float>::value;
__device__ __forceinline__ void st3(float* __restrict__ p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ float comp(V3 a, int c) { return c == 0 ? a.x : (c == 1 ? a.y : a.z); }

// jnp.sum(a * b, -1): fma(a2, b2, fma(a1, b1, a0 * b0))   (ops/fp.dot)
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
}
// a0*b0 + a1*b1 + a2*b2 written out: fma(a2, b2, fma(a0, b0, a1 * b1))  (ops/fp.sum3)
__device__ __forceinline__ float sum3(V3 a, V3 b) {
  return fmaf(a.z, b.z, fmaf(a.x, b.x, a.y * b.y));
}
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(fmaxf(x, 1e-20f)); }
// brdf.vec_norm: the squares summed unfused.
__device__ __forceinline__ float vec_norm(V3 v) {
  return safe_sqrt(v.x * v.x + v.y * v.y + v.z * v.z);
}
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// rt_utils.slang:54-59 (ops/rng.rnd).
__device__ __forceinline__ float rnd(uint32_t& seed) {
  seed = seed * 747796405u + 2891336453u;
  const uint32_t shift = (seed >> 28) + 4u;
  const uint32_t word = ((seed >> shift) ^ seed) * 277803737u;
  const uint32_t result = (word >> 22) ^ word;
  return (float)result * kInvU32Max;
}

struct Surface {
  V3 pos, n, v, al;
  float rough, metal;
};

template <typename A>
__device__ __forceinline__ Surface load_surface(const float* pos, const A* nrm,
                                                const A* view, const A* alb,
                                                const A* rough, const A* metal,
                                                long long i) {
  return {ld3(pos, i), lda3(nrm, i), lda3(view, i), lda3(alb, i), lda(rough, i),
          lda(metal, i)};
}

// The terms of eval_light that depend on the surface alone, for a surface
// that meets many light samples (K3's candidates): the same operations,
// computed once.
struct ShadeTerms {
  float ndv, a2, a2m1, one_m, root_v;
  V3 f0, one_f0, diff;   // fmaf(al, metal, 0.04 (1 - metal)), 1 - f0, al (1 - metal)
};

// bf = true: the attributes are bf16 (ops/brdf.py's bf16 forms): NdotV is
// bf16 (a bf16 chain when planar, the fp32 sum of exact products rounded
// otherwise), alpha = rb(r * r) and a2 its exact square, a2m1 and one_m
// from rb(a2), root_v ggx_v's bf16 chain, f0 = rb(0.04 rb(1 - m)) +
// rb(al m), one_f0 = 1 - rb(f0), diff = al rb(1 - m).
template <bool planar, bool bf>
__device__ __forceinline__ ShadeTerms shade_terms(const Surface& s) {
  ShadeTerms t;
  if constexpr (bf) {
    const float ndv = planar ? rb(rb(rb(s.n.x * s.v.x) + rb(s.n.y * s.v.y)) +
                                  rb(s.n.z * s.v.z))
                             : rb(dot3(s.n, s.v));
    t.ndv = fmaxf(ndv, kBf0p001);
    const float a = rb(s.rough * s.rough);
    t.a2 = a * a;
    const float a2r = rb(t.a2);
    t.a2m1 = a2r - 1.0f;
    t.one_m = 1.0f - a2r;
    t.root_v = sqrtf(rb(rb(rb(t.ndv * t.ndv) * rb(t.one_m)) + a2r));
    const float m1 = rb(1.0f - s.metal);
    const float base = rb(kBf0p04 * m1);
    float f0[3], diff[3];
    for (int c = 0; c < 3; ++c) {
      f0[c] = base + rb(comp(s.al, c) * s.metal);
      diff[c] = comp(s.al, c) * m1;
    }
    t.f0 = {f0[0], f0[1], f0[2]};
    t.one_f0 = {1.0f - rb(f0[0]), 1.0f - rb(f0[1]), 1.0f - rb(f0[2])};
    t.diff = {diff[0], diff[1], diff[2]};
    return t;
  }
  t.ndv = fmaxf(planar ? sum3(s.n, s.v) : dot3(s.n, s.v), 0.001f);
  const float a = s.rough * s.rough;
  t.a2 = a * a;
  t.a2m1 = t.a2 - 1.0f;
  t.one_m = 1.0f - t.a2;
  t.root_v = sqrtf(fmaf(t.ndv * t.ndv, t.one_m, t.a2));
  const float base = 0.04f * (1.0f - s.metal);
  float f0[3], diff[3];
  for (int c = 0; c < 3; ++c) {
    f0[c] = fmaf(comp(s.al, c), s.metal, base);
    diff[c] = comp(s.al, c) * (1.0f - s.metal);
  }
  t.f0 = {f0[0], f0[1], f0[2]};
  t.one_f0 = {1.0f - f0[0], 1.0f - f0[1], 1.0f - f0[2]};
  t.diff = {diff[0], diff[1], diff[2]};
  return t;
}

// GGX D*V*F + Lambert of a light sample, unshadowed (rt_utils.slang:203-234).
// planar = true rounds as brdf.eval_p_hat_planar (written-out dot products),
// false as brdf.eval_unshadowed_light (jnp.sum reductions). Returns f_y
// (rgb); p_hat is its max channel. bf: the terms are shade_terms<planar,
// true>'s, and the visibility term's sum fuses ggx_l's product.
template <bool planar, bool bf = false>
__device__ __forceinline__ V3 eval_light(const Surface& s, const ShadeTerms& t, V3 em,
                                         V3 lpos, V3 lnrm) {
  V3 l = sub(lpos, s.pos);
  const float dist =
      fmaxf(planar ? safe_sqrt(sum3(l, l)) : vec_norm(l), 1e-4f);
  l = divs(l, dist);
  const float ndl = fmaxf(planar ? sum3(s.n, l) : dot3(s.n, l), 0.0f);
  const float cos_light =
      fmaxf(planar ? -sum3(lnrm, l) : dot3(lnrm, neg(l)), 0.0f);
  const bool lit = ndl > 0.0f && cos_light > 0.0f;
  V3 h = add(s.v, l);
  const float h_n = fmaxf(planar ? safe_sqrt(sum3(h, h)) : vec_norm(h), 1e-12f);
  h = divs(h, h_n);
  const float ndh = fmaxf(planar ? sum3(s.n, h) : dot3(s.n, h), 0.0f);
  const float vdh = fmaxf(planar ? sum3(s.v, h) : dot3(s.v, h), 0.0f);
  const float denom = fmaf(ndh * ndh, t.a2m1, 1.0f);
  const float d_term = t.a2 / (denom * kPi * denom);
  const float root_l = sqrtf(fmaf(ndl * ndl, t.one_m, t.a2));
  const float v_term =
      bf ? 0.5f / fmaxf(fmaf(t.ndv, root_l, ndl * t.root_v), 1e-4f)
         : 0.5f / fmaxf(fmaf(ndl, t.root_v, t.ndv * root_l), 1e-4f);
  const float dv = d_term * v_term;
  const float fres5 = pow5(1.0f - vdh);
  const float geometry = ndl * cos_light / fmaxf(dist * dist, 1e-4f);
  float out[3];
  for (int c = 0; c < 3; ++c) {
    const float f = fmaf(comp(t.one_f0, c), fres5, comp(t.f0, c));
    const float shade = fmaf(dv, f, comp(t.diff, c) * (1.0f - f) * kInvPi);
    out[c] = lit ? comp(em, c) * shade * geometry : 0.0f;
  }
  return {out[0], out[1], out[2]};
}

template <bool planar, bool bf = false>
__device__ __forceinline__ V3 eval_light(const Surface& s, V3 em, V3 lpos, V3 lnrm) {
  return eval_light<planar, bf>(s, shade_terms<planar, bf>(s), em, lpos, lnrm);
}

__device__ __forceinline__ float max3(V3 v) { return fmaxf(fmaxf(v.x, v.y), v.z); }

// brdf.gi_target_pdf (planar = false) / gi_target_pdf_planar (true); bf:
// the diffuse factor rb(al rb(1 - m)) * f32(1 / bf16(PI)).
template <bool planar, bool bf = false>
__device__ __forceinline__ float gi_p_hat(const Surface& s, V3 spos, V3 srad) {
  V3 w = sub(spos, s.pos);
  const float d = fmaxf(planar ? safe_sqrt(sum3(w, w)) : vec_norm(w), 1e-4f);
  w = divs(w, d);
  const float ndl = fmaxf(planar ? sum3(s.n, w) : dot3(s.n, w), 0.0f);
  float p = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float fd = bf ? rb(comp(s.al, c) * rb(1.0f - s.metal)) * kInvPiBf16
                        : comp(s.al, c) * (1.0f - s.metal) * kInvPi;
    const float contrib = comp(srad, c) * fd * ndl;
    p = c == 0 ? contrib : fmaxf(p, contrib);
  }
  return p;
}

// The accumulate-and-take step of merge_di / merge_gi (restir.py:94-124).
__device__ __forceinline__ bool merge(float& w_sum, float& m, float new_m, float weight,
                                      float u, bool enable) {
  m = m + (enable ? new_m : 0.0f);
  weight = enable ? weight : 0.0f;
  w_sum = w_sum + weight;
  return enable && (u < weight / fmaxf(w_sum, 1e-4f));
}

__device__ __forceinline__ float smoothstep(float e0, float inv, float x) {
  const float t = fminf(fmaxf((x - e0) * inv, 0.0f), 1.0f);
  return t * t * (3.0f - 2.0f * t);
}
__device__ __forceinline__ float one_minus_smoothstep(float e0, float inv, float x) {
  const float t = fminf(fmaxf((x - e0) * inv, 0.0f), 1.0f);
  return fmaf(-(t * t), 3.0f - 2.0f * t, 1.0f);
}

__device__ __forceinline__ V3 emission(const float* __restrict__ em, int idx, int n_lights) {
  return ld3(em, min(max(idx, 0), n_lights - 1));
}

// ---- K3 --------------------------------------------------------------------
//
// What holds it back: per candidate the light sample, the target function
// (eval_light<true>: 9 IEEE divisions and 4 roots, each a short sequence
// with a guarded slow-path call) and the take. PR 2's kernel also read
// the candidate's light as 12 scalar loads, recomputed the light's cross
// product, its norm, its unit normal (three divisions) and its area for
// every candidate, recomputed the surface's own shading terms (a root
// among them) for every candidate, and took the winner under a branch.
//
// Design: one small launch computes each light's 64-byte record once
// (light_records_kernel, the operations and order of ris_audition_plain,
// so the values are the bits each candidate computed before):
//   q[0] = (v0, em.x)  q[1] = (v1, em.y)  q[2] = (v2, em.z)
//   q[3] = (unit normal cr / max(|cr|, 1e-12), max(L * 0.5 * |cr|, 1e-4))
// and the audition reads a candidate's light as four 16-byte loads: from
// shared memory when the table fits in 48 KB (kRisSmemLights lights),
// else through the read-only cache. One thread per pixel computes its
// surface's shading terms once (shade_terms), then draws and evaluates the
// candidates one at a time in the stream order (u_pick, u1, u2, u_keep),
// the take by selects. A lane that is disabled only draws: its weights
// are 0 whatever the target function is. Drawing and evaluating 2 or 4
// candidates before their takes, for the scheduler to overlap, cost more
// registers than it won (79 and 110 against 64: fewer warps an SM; 5% and
// 27% slower on the 1080p frame's inputs).
constexpr int kRisSmemLights = 768;  // 48 KB of 64-byte records; reported by
                                     // sunray_ris_launch_shape

__global__ void __launch_bounds__(128)
light_records_kernel(const float* __restrict__ tab, int n_lights,
                     float4* __restrict__ rec) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_lights) return;
  const float* t = tab + 12 * j;
  const V3 v0 = {t[0], t[1], t[2]}, v1 = {t[3], t[4], t[5]}, v2 = {t[6], t[7], t[8]};
  const V3 e1 = sub(v1, v0), e2 = sub(v2, v0);
  const V3 cr = {fmaf(e1.y, e2.z, -(e1.z * e2.y)), fmaf(e1.z, e2.x, -(e1.x * e2.z)),
                 fmaf(e1.x, e2.y, -(e1.y * e2.x))};
  const float cr_n = safe_sqrt(sum3(cr, cr));
  const float area = 0.5f * cr_n;
  const V3 ln = divs(cr, fmaxf(cr_n, 1e-12f));
  rec[4 * j + 0] = make_float4(v0.x, v0.y, v0.z, t[9]);
  rec[4 * j + 1] = make_float4(v1.x, v1.y, v1.z, t[10]);
  rec[4 * j + 2] = make_float4(v2.x, v2.y, v2.z, t[11]);
  rec[4 * j + 3] = make_float4(ln.x, ln.y, ln.z, fmaxf((float)n_lights * area, 1e-4f));
}

template <bool kSmem, typename A>
__global__ void __launch_bounds__(kThreads)
ris_audition_kernel(const float4* __restrict__ g_rec, int n_lights,
                    const long long* __restrict__ seed_in, const float* __restrict__ pos,
                    const A* __restrict__ nrm, const A* __restrict__ view,
                    const A* __restrict__ alb, const A* __restrict__ rough,
                    const A* __restrict__ metal, const uint8_t* __restrict__ enable_in,
                    int n, int k, long long* __restrict__ seed_out, float* __restrict__ o_pos,
                    float* __restrict__ o_nrm, float* __restrict__ o_wsum,
                    float* __restrict__ o_m, int32_t* __restrict__ o_idx,
                    float* __restrict__ o_w) {
  extern __shared__ float4 s_rec[];
  if (kSmem) {
    for (int j = threadIdx.x; j < 4 * n_lights; j += blockDim.x) s_rec[j] = g_rec[j];
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr bool bf = kIsBf16<A>;
  const Surface s = load_surface(pos, nrm, view, alb, rough, metal, i);
  const ShadeTerms terms = shade_terms<true, bf>(s);
  const bool enable = enable_in[i] != 0;
  uint32_t seed = (uint32_t)seed_in[i];

  float w_sum = 0.0f;
  int r_idx = 0;
  V3 r_pos = {0.0f, 0.0f, 0.0f}, r_nrm = r_pos, r_em = r_pos;
  const float lf = (float)n_lights;
  for (int c = 0; c < k; ++c) {
    const float u_pick = rnd(seed);
    const float u1 = rnd(seed);
    const float u2 = rnd(seed);
    const float u_keep = rnd(seed);
    const int idx = min((int)(u_pick * lf), n_lights - 1);
    float4 q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = kSmem ? s_rec[4 * idx + j] : __ldg(g_rec + 4 * idx + j);
    const float sqr1 = sqrtf(u1);
    const float bu = 1.0f - sqr1;
    const float bv = u2 * sqr1;
    const float bw = 1.0f - bu - bv;
    const V3 lp = {fmaf(q[2].x, bw, fmaf(q[0].x, bu, q[1].x * bv)),
                   fmaf(q[2].y, bw, fmaf(q[0].y, bu, q[1].y * bv)),
                   fmaf(q[2].z, bw, fmaf(q[0].z, bu, q[1].z * bv))};
    const V3 ln = {q[3].x, q[3].y, q[3].z};
    const V3 em = {q[0].w, q[1].w, q[2].w};
    const float wi =
        enable ? max3(eval_light<true, bf>(s, terms, em, lp, ln)) * q[3].w : 0.0f;
    w_sum = w_sum + wi;
    const bool take = enable & (u_keep < wi / fmaxf(w_sum, 1e-4f));
    r_idx = take ? idx : r_idx;
    r_pos = sel(take, lp, r_pos);
    r_nrm = sel(take, ln, r_nrm);
    r_em = sel(take, em, r_em);
  }
  const float m = enable ? (float)k : 0.0f;
  // W for the winner (ray_gen_ris.slang:225-231), its emission kept in
  // registers from its take.
  const float p_hat_w = max3(eval_light<false, bf>(s, r_em, r_pos, r_nrm));
  const float w = w_sum / fmaxf(m * p_hat_w, 1e-4f);
  seed_out[i] = (long long)seed;
  st3(o_pos, i, r_pos);
  st3(o_nrm, i, r_nrm);
  o_wsum[i] = w_sum;
  o_m[i] = m;
  o_idx[i] = r_idx;
  o_w[i] = (enable && w_sum > 0.0f) ? w : 0.0f;
}

// ---- K4 --------------------------------------------------------------------

template <typename A>
struct DiTemporalArgs {
  const float* em;
  int n_lights;
  const long long* seed;
  const float *r_pos, *r_nrm, *r_wsum, *r_m;
  const int32_t* r_idx;
  const float* r_w;
  const float *h_pos, *h_nrm, *h_w, *h_m;
  const int32_t* h_idx;
  const float *h_hn, *h_depth;
  long long n_hist;
  const long long* pi;
  const uint8_t* ok;
  const float* pos;
  const A *nrm, *view, *alb, *rough, *metal;
  const float* vdist;
  int n;
  float m_clamp, w_clamp;
  long long* seed_out;
  float *o_pos, *o_nrm, *o_wsum, *o_m;
  int32_t* o_idx;
  float* o_w;
};

template <typename A>
__global__ void __launch_bounds__(kThreads) di_temporal_kernel(DiTemporalArgs<A> a) {
  constexpr bool bf = kIsBf16<A>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Surface s = load_surface(a.pos, a.nrm, a.view, a.alb, a.rough, a.metal, i);
  uint32_t seed = (uint32_t)a.seed[i];
  const long long j = min(max(a.pi[i], 0ll), a.n_hist - 1);
  const V3 h_pos = ld3(a.h_pos, j), h_nrm = ld3(a.h_nrm, j);
  float h_m = fminf(__ldg(a.h_m + j), a.m_clamp);
  const float h_w = fminf(__ldg(a.h_w + j), a.w_clamp);
  const int h_idx = min(__ldg(a.h_idx + j), a.n_lights - 1);
  const float vd = __ldg(a.vdist + i);
  const float ndot = dot3(s.n, ld3(a.h_hn, j));
  const float depth_diff = fabsf(vd - __ldg(a.h_depth + j)) / fmaxf(vd, 1e-4f);
  h_m = h_m * (smoothstep(0.9f, kInvSs0990, ndot) *
               one_minus_smoothstep(0.05f, kInvSs0520, depth_diff));
  const bool use = a.ok[i] != 0 && h_w > 0.0f;
  const V3 h_em = emission(a.em, h_idx, a.n_lights);
  const float p_hat_hist = max3(eval_light<false, bf>(s, h_em, h_pos, h_nrm));
  const float u_m = rnd(seed);
  float w_sum = __ldg(a.r_wsum + i);
  float m = __ldg(a.r_m + i);
  const bool take = merge(w_sum, m, h_m, p_hat_hist * h_w * h_m, u_m, use);
  const int r_idx = __ldg(a.r_idx + i);
  const int idx = take ? h_idx : r_idx;
  const V3 lp = take ? h_pos : ld3(a.r_pos, i);
  const V3 ln = take ? h_nrm : ld3(a.r_nrm, i);
  const V3 em = take ? h_em : emission(a.em, r_idx, a.n_lights);
  const float p_hat_m = max3(eval_light<false, bf>(s, em, lp, ln));
  const float w_new = w_sum / fmaxf(m * p_hat_m, 1e-4f);
  a.seed_out[i] = (long long)seed;
  st3(a.o_pos, i, lp);
  st3(a.o_nrm, i, ln);
  a.o_wsum[i] = w_sum;
  a.o_m[i] = m;
  a.o_idx[i] = idx;
  a.o_w[i] = use ? w_new : __ldg(a.r_w + i);
}

// ---- K5 --------------------------------------------------------------------
//
// What holds it back: latency. The first kernel (blocks of 256, each
// tap's loads behind its tests) issued 684 SASS instructions around its
// tap loop and 324 a used tap, at 79 registers (24 warps an SM); that
// issue floor is 47% of its time and its bytes bound 42%, and each tap
// waits on loads of a neighbour up to 30 px away.
//
// Design: one thread per pixel, on blocks of 128 capped at 64 registers
// (32 warps an SM): 0.82x the first kernel's time, though the cap
// spills 20 bytes and the count is 327 SASS a used tap and 696 around. The shading terms of each flavour
// are computed once a lane (the compiler had already hoisted them out of
// the tap loop: the SASS count did not move), and a tap's five
// neighbour-test loads are issued together (the first kernel's
// short-circuit put the depth load behind the normal test). Measured and dropped: the winner's
// f_y by a select where the centre won and no tap took (bit-equal there,
// but 0.0-0.4% of warps have all their lanes keep the centre, and the
// kept f_y cost 9 registers), and the next tap's loads issued before the
// current tap's target function (88 registers, or spills under a cap:
// slower at every budget). The operations and their order are the first
// kernel's, so every output keeps its bits. The draws keep the stream order: the
// centre's first, then one a tap in tap order, a skipped tap's included.

template <typename A>
struct DiSpatialArgs {
  const float* em;
  int n_lights;
  const long long* seed;
  const float *c_pos, *c_nrm, *c_w, *c_m;
  const int32_t* c_idx;
  const uint8_t* pending;
  const float *gnormal, *gdepth, *cur_depth;
  const float* pos;
  const A *nrm, *view, *alb, *rough, *metal;
  const float* tnrm;  // the neighbour test's fp32 normal (bf16 only)
  // The centre lanes are `height` rows of `width`; the neighbour planes
  // (c_*, gnormal, gdepth) are a window of height + 2 * halo rows whose
  // row `halo` is the band's row 0, and the band's row 0 is global row
  // row0 of an image of h_global rows. The whole frame: halo 0, row0 0,
  // h_global = height.
  int width, height, halo, row0, h_global;
  int taps[2 * kMaxTaps];
  int n_taps;
  float w_clamp, m_clamp, ws_clamp;
  long long* seed_out;
  float *o_pos, *o_nrm, *o_wsum, *o_m;
  int32_t* o_idx;
  float *o_wspatial, *o_fy;
  uint8_t* o_has;
};

// What a tap's neighbour test reads: the neighbour's index, whether it is
// on the image, its G-buffer normal and depth and its reservoir's W, M
// and light id (not read off the image).
struct TapHead {
  bool inside;
  long long j;
  V3 gn;
  float gd, w, m;
  int idx;
};

// Blocks of 128, at least 8 an SM: at most 64 registers (20 bytes
// spilled), 32 warps an SM.
constexpr int kSpatialThreads = 128;
constexpr int kSpatialMinBlocks = 8;

template <typename A>
__device__ __forceinline__ TapHead tap_head(const DiSpatialArgs<A>& a, int x, int y,
                                            int t) {
  TapHead h = {};
  const int nx = x + a.taps[2 * t], ny = y + a.taps[2 * t + 1];
  const int gy = a.row0 + ny;  // the in-image test runs on global rows
  h.inside = nx >= 0 && gy >= 0 && nx < a.width && gy < a.h_global;
  if (!h.inside) return h;
  h.j = (long long)(ny + a.halo) * a.width + nx;
  h.gn = ld3(a.gnormal, h.j);
  h.gd = __ldg(a.gdepth + h.j);
  h.w = __ldg(a.c_w + h.j);
  h.m = __ldg(a.c_m + h.j);
  h.idx = __ldg(a.c_idx + h.j);
  return h;
}

template <typename A>
__global__ void __launch_bounds__(kSpatialThreads, kSpatialMinBlocks)
di_spatial_kernel(DiSpatialArgs<A> a) {
  constexpr bool bf = kIsBf16<A>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.width * a.height;
  if (i >= n) return;
  const Surface s = load_surface(a.pos, a.nrm, a.view, a.alb, a.rough, a.metal, i);
  // The shading terms of each flavour, once: the centre and the winner
  // round as eval_unshadowed_light (planar = false), the taps as
  // eval_p_hat_planar (true).
  const ShadeTerms t_full = shade_terms<false, bf>(s);
  const ShadeTerms t_tap = shade_terms<true, bf>(s);
  const bool pending = a.pending[i] != 0;
  uint32_t seed = (uint32_t)a.seed[i];

  // Centre merge (the pixel's own reservoir, ray_gen_final.slang:147-158),
  // read at its lane of the window.
  const long long ci = i + (long long)a.halo * a.width;
  const int c_raw = __ldg(a.c_idx + ci);
  const float c_w = __ldg(a.c_w + ci), c_m = __ldg(a.c_m + ci);
  const bool c_ok = pending && c_w > 0.0f && c_raw < a.n_lights;
  const int c_idx = min(c_raw, a.n_lights - 1);
  const V3 c_pos = ld3(a.c_pos, ci), c_nrm = ld3(a.c_nrm, ci);
  const V3 c_em = emission(a.em, c_idx, a.n_lights);
  const float p_hat_c = max3(eval_light<false, bf>(s, t_full, c_em, c_pos, c_nrm));
  const float u_m = rnd(seed);
  float w_sum = 0.0f, m_acc = 0.0f;
  const bool c_take = merge(w_sum, m_acc, c_m, p_hat_c * c_w * c_m, u_m, c_ok);
  int r_idx = c_take ? c_idx : 0;
  const V3 zero = {0.0f, 0.0f, 0.0f};
  V3 r_pos = sel(c_take, c_pos, zero), r_nrm = sel(c_take, c_nrm, zero);
  V3 r_em = c_take ? c_em : emission(a.em, 0, a.n_lights);

  // Shared-offset taps, each neighbour read in place (pathtrace.py:583-599).
  const int x = i % a.width, y = i / a.width;
  const float cur = __ldg(a.cur_depth + i);
  V3 test_n = s.n;
  if constexpr (bf) test_n = ld3(a.tnrm, i);
#pragma unroll 1
  for (int t = 0; t < a.n_taps; ++t) {
    const TapHead h = tap_head(a, x, y, t);
    const float u = rnd(seed);
    if (!h.inside) continue;
    const bool ok = dot3(test_n, h.gn) >= 0.9f && fabsf(cur - h.gd) <= 0.1f * cur;
    const float w_cl = fminf(h.w, a.w_clamp);
    const float m_cl = fminf(h.m, a.m_clamp);
    const bool use = pending && ok && w_cl > 0.0f && h.idx < a.n_lights;
    if (!use) continue;  // merge() with enable false leaves every value
    const int idx = min(h.idx, a.n_lights - 1);
    const V3 lp = ld3(a.c_pos, h.j), ln = ld3(a.c_nrm, h.j);
    const V3 em = emission(a.em, idx, a.n_lights);
    const float p_hat = max3(eval_light<true, bf>(s, t_tap, em, lp, ln));
    if (merge(w_sum, m_acc, m_cl, p_hat * w_cl * m_cl, u, true)) {
      r_idx = idx;
      r_pos = lp;
      r_nrm = ln;
      r_em = em;
    }
  }

  // Resolve, clamp and the winner's f_y (ray_gen_final.slang:203-222).
  const V3 f_y = eval_light<false, bf>(s, t_full, r_em, r_pos, r_nrm);
  const float w_spatial = fminf(w_sum / fmaxf(m_acc * max3(f_y), 1e-3f), a.ws_clamp);
  a.seed_out[i] = (long long)seed;
  st3(a.o_pos, i, r_pos);
  st3(a.o_nrm, i, r_nrm);
  a.o_wsum[i] = w_sum;
  a.o_m[i] = m_acc;
  a.o_idx[i] = r_idx;
  a.o_wspatial[i] = w_spatial;
  st3(a.o_fy, i, f_y);
  a.o_has[i] = (pending && w_sum > 0.0f) ? 1 : 0;
}

// ---- K6 --------------------------------------------------------------------

template <typename A>
struct GiSpatialArgs {
  const long long* seed;
  const float *c_spos, *c_srad;
  const int32_t* c_stri;
  const float *c_wsum, *c_m;
  const float *t_spos, *t_srad;           // (T, P, 3)
  const int32_t* t_stri;                  // (T, P)
  const float *t_w, *t_m, *t_jac;         // (T, P)
  const uint8_t* t_ok;                    // (T, P)
  int n_taps;
  const uint8_t* pending;
  const float *pos, *nrm, *alb, *metal;
  const A *snrm, *salb, *smetal;  // the target function's (fp32: nrm, alb, metal)
  int n;
  float w_clamp;
  long long* seed_out;
  float *o_gdir, *o_gdist;
  int32_t* o_stri;
  uint8_t* o_try;
  float* o_contrib;
};

template <typename A>
__global__ void __launch_bounds__(kThreads) gi_spatial_kernel(GiSpatialArgs<A> a) {
  constexpr bool bf = kIsBf16<A>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  // s: the target function's surface; g: the fp32 one of the final ray and
  // contribution (the same values without bf16 shading).
  Surface s;
  s.pos = ld3(a.pos, i);
  s.n = lda3(a.snrm, i);
  s.al = lda3(a.salb, i);
  s.metal = lda(a.smetal, i);
  s.v = {0.0f, 0.0f, 0.0f};
  s.rough = 0.0f;
  Surface g = s;
  if constexpr (bf) {
    g.n = ld3(a.nrm, i);
    g.al = ld3(a.alb, i);
    g.metal = __ldg(a.metal + i);
  }
  uint32_t seed = (uint32_t)a.seed[i];
  float w_sum = __ldg(a.c_wsum + i), m_acc = __ldg(a.c_m + i);
  V3 r_pos = ld3(a.c_spos, i), r_rad = ld3(a.c_srad, i);
  int r_tri = __ldg(a.c_stri + i);
  for (int t = 0; t < a.n_taps; ++t) {
    const long long j = (long long)t * a.n + i;
    const float u = rnd(seed);
    if (a.t_ok[j] == 0) continue;  // merge() with enable false leaves every value
    const V3 spos = ld3(a.t_spos, j), srad = ld3(a.t_srad, j);
    const float w_t = __ldg(a.t_w + j), m_t = __ldg(a.t_m + j);
    const float p_hat = gi_p_hat<true, bf>(s, spos, srad);
    if (merge(w_sum, m_acc, m_t, p_hat * w_t * m_t * __ldg(a.t_jac + j), u, true)) {
      r_pos = spos;
      r_rad = srad;
      r_tri = __ldg(a.t_stri + j);
    }
  }
  // Final resolve (ray_gen_final.slang:305-327).
  const float p_hat_f = gi_p_hat<false, bf>(s, r_pos, r_rad);
  float w_gi = p_hat_f > 1e-3f
                   ? w_sum / (fmaxf(m_acc, 1.0f) * fmaxf(p_hat_f, 1e-9f))
                   : 0.0f;
  w_gi = fminf(w_gi, a.w_clamp);
  const V3 gvec = sub(r_pos, s.pos);
  const float gdist = fmaxf(vec_norm(gvec), 1e-4f);
  const V3 gdir = divs(gvec, gdist);
  const float gndl = fmaxf(dot3(g.n, gdir), 0.0f);
  const bool pending = a.pending[i] != 0;
  a.seed_out[i] = (long long)seed;
  st3(a.o_gdir, i, gdir);
  a.o_gdist[i] = gdist;
  a.o_stri[i] = r_tri;
  a.o_try[i] = (pending && w_gi > 0.0f && gndl > 0.0f) ? 1 : 0;
  const float scale = gndl * w_gi;
  V3 contrib;
  contrib.x = r_rad.x * (g.al.x * (1.0f - g.metal) * kInvPi) * scale;
  contrib.y = r_rad.y * (g.al.y * (1.0f - g.metal) * kInvPi) * scale;
  contrib.z = r_rad.z * (g.al.z * (1.0f - g.metal) * kInvPi) * scale;
  st3(a.o_contrib, i, contrib);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename A>
int launch_ris_audition(const float* tab, int n_lights, float* rec, const long long* seed,
                        const float* pos, const void* nrm, const void* view,
                        const void* alb, const void* rough, const void* metal,
                        const uint8_t* enable, int n, int k, long long* seed_out,
                        float* o_pos, float* o_nrm, float* o_wsum, float* o_m,
                        int32_t* o_idx, float* o_w, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* r = reinterpret_cast<const float4*>(rec);
    const A *an = static_cast<const A*>(nrm), *av = static_cast<const A*>(view),
            *aa = static_cast<const A*>(alb), *ar = static_cast<const A*>(rough),
            *am = static_cast<const A*>(metal);
    light_records_kernel<<<(n_lights + 127) / 128, 128, 0, s>>>(
        tab, n_lights, reinterpret_cast<float4*>(rec));
    if (n_lights <= kRisSmemLights) {
      ris_audition_kernel<true, A><<<blocks_for(n), kThreads,
                                     sizeof(float4) * 4 * n_lights, s>>>(
          r, n_lights, seed, pos, an, av, aa, ar, am, enable, n, k, seed_out, o_pos, o_nrm,
          o_wsum, o_m, o_idx, o_w);
    } else {
      ris_audition_kernel<false, A><<<blocks_for(n), kThreads, 0, s>>>(
          r, n_lights, seed, pos, an, av, aa, ar, am, enable, n, k, seed_out, o_pos, o_nrm,
          o_wsum, o_m, o_idx, o_w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_di_temporal(const float* em, int n_lights, const long long* seed,
                       const float* r_pos, const float* r_nrm, const float* r_wsum,
                       const float* r_m, const int32_t* r_idx, const float* r_w,
                       const float* h_pos, const float* h_nrm, const float* h_w,
                       const float* h_m, const int32_t* h_idx, const float* h_hn,
                       const float* h_depth, long long n_hist, const long long* pi,
                       const uint8_t* ok, const float* pos, const void* nrm,
                       const void* view, const void* alb, const void* rough,
                       const void* metal, const float* vdist, int n, float m_clamp,
                       float w_clamp, long long* seed_out, float* o_pos, float* o_nrm,
                       float* o_wsum, float* o_m, int32_t* o_idx, float* o_w,
                       void* stream) {
  if (n > 0) {
    DiTemporalArgs<A> a = {em,       n_lights, seed,     r_pos,    r_nrm,   r_wsum,
                           r_m,      r_idx,    r_w,      h_pos,    h_nrm,   h_w,
                           h_m,      h_idx,    h_hn,     h_depth,  n_hist,  pi,
                           ok,       pos,      static_cast<const A*>(nrm),
                           static_cast<const A*>(view), static_cast<const A*>(alb),
                           static_cast<const A*>(rough), static_cast<const A*>(metal),
                           vdist,    n,        m_clamp,  w_clamp,  seed_out, o_pos,
                           o_nrm,    o_wsum,   o_m,      o_idx,    o_w};
    di_temporal_kernel<A>
        <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_di_spatial(const float* em, int n_lights, const long long* seed,
                      const float* c_pos, const float* c_nrm, const float* c_w,
                      const float* c_m, const int32_t* c_idx, const uint8_t* pending,
                      const float* gnormal, const float* gdepth, const float* cur_depth,
                      const float* pos, const void* nrm, const void* view, const void* alb,
                      const void* rough, const void* metal, const float* tnrm, int width,
                      int height, int halo, int row0, int h_global, const int* taps,
                      int n_taps, float w_clamp, float m_clamp, float ws_clamp,
                      long long* seed_out, float* o_pos, float* o_nrm, float* o_wsum,
                      float* o_m, int32_t* o_idx, float* o_wspatial, float* o_fy,
                      uint8_t* o_has, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  if (halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < n_taps; ++t) {
    // A window's taps must stay inside it (the whole frame's are bounded
    // by the in-image test).
    if (halo > 0 && (taps[2 * t + 1] > halo || taps[2 * t + 1] < -halo))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = width * height;
  if (n > 0) {
    DiSpatialArgs<A> a;
    a.em = em;
    a.n_lights = n_lights;
    a.seed = seed;
    a.c_pos = c_pos;
    a.c_nrm = c_nrm;
    a.c_w = c_w;
    a.c_m = c_m;
    a.c_idx = c_idx;
    a.pending = pending;
    a.gnormal = gnormal;
    a.gdepth = gdepth;
    a.cur_depth = cur_depth;
    a.pos = pos;
    a.nrm = static_cast<const A*>(nrm);
    a.view = static_cast<const A*>(view);
    a.alb = static_cast<const A*>(alb);
    a.rough = static_cast<const A*>(rough);
    a.metal = static_cast<const A*>(metal);
    a.tnrm = tnrm;
    a.width = width;
    a.height = height;
    a.halo = halo;
    a.row0 = row0;
    a.h_global = h_global;
    for (int t = 0; t < 2 * kMaxTaps; ++t) a.taps[t] = taps[t];
    a.n_taps = n_taps;
    a.w_clamp = w_clamp;
    a.m_clamp = m_clamp;
    a.ws_clamp = ws_clamp;
    a.seed_out = seed_out;
    a.o_pos = o_pos;
    a.o_nrm = o_nrm;
    a.o_wsum = o_wsum;
    a.o_m = o_m;
    a.o_idx = o_idx;
    a.o_wspatial = o_wspatial;
    a.o_fy = o_fy;
    a.o_has = o_has;
    di_spatial_kernel<A><<<(n + kSpatialThreads - 1) / kSpatialThreads, kSpatialThreads,
                           0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_gi_spatial(const long long* seed, const float* c_spos, const float* c_srad,
                      const int32_t* c_stri, const float* c_wsum, const float* c_m,
                      const float* t_spos, const float* t_srad, const int32_t* t_stri,
                      const float* t_w, const float* t_m, const float* t_jac,
                      const uint8_t* t_ok, int n_taps, const uint8_t* pending,
                      const float* pos, const float* nrm, const float* alb,
                      const float* metal, const void* snrm, const void* salb,
                      const void* smetal, int n, float w_clamp, long long* seed_out,
                      float* o_gdir, float* o_gdist, int32_t* o_stri, uint8_t* o_try,
                      float* o_contrib, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    GiSpatialArgs<A> a = {seed,    c_spos, c_srad, c_stri, c_wsum, c_m,   t_spos,
                          t_srad,  t_stri, t_w,    t_m,    t_jac,  t_ok,  n_taps,
                          pending, pos,    nrm,    alb,    metal,
                          static_cast<const A*>(snrm), static_cast<const A*>(salb),
                          static_cast<const A*>(smetal), n, w_clamp, seed_out,
                          o_gdir,  o_gdist, o_stri, o_try, o_contrib};
    gi_spatial_kernel<A>
        <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3-K6 with fp32 attribute planes; the _bf16 entry points take them as
// bf16 (K5 also the neighbour test's fp32 normal, K6 the target function's
// bf16 normal, albedo and metallic beside the fp32 ones).

int sunray_ris_audition(const float* tab, int n_lights, float* rec,
                        const long long* seed, const float* pos, const float* nrm,
                        const float* view, const float* alb, const float* rough,
                        const float* metal, const uint8_t* enable, int n, int k,
                        long long* seed_out, float* o_pos, float* o_nrm, float* o_wsum,
                        float* o_m, int32_t* o_idx, float* o_w, void* stream) {
  return launch_ris_audition<float>(tab, n_lights, rec, seed, pos, nrm, view, alb, rough,
                                    metal, enable, n, k, seed_out, o_pos, o_nrm, o_wsum,
                                    o_m, o_idx, o_w, stream);
}

int sunray_ris_audition_bf16(const float* tab, int n_lights, float* rec,
                             const long long* seed, const float* pos, const void* nrm,
                             const void* view, const void* alb, const void* rough,
                             const void* metal, const uint8_t* enable, int n, int k,
                             long long* seed_out, float* o_pos, float* o_nrm,
                             float* o_wsum, float* o_m, int32_t* o_idx, float* o_w,
                             void* stream) {
  return launch_ris_audition<__nv_bfloat16>(tab, n_lights, rec, seed, pos, nrm, view, alb,
                                            rough, metal, enable, n, k, seed_out, o_pos,
                                            o_nrm, o_wsum, o_m, o_idx, o_w, stream);
}

// K3's launch shape, {kRisSmemLights}: the host's copy
// (ops/cuda_restir.RIS_SMEM_LIGHTS) is checked against it when the library
// loads.
int sunray_ris_launch_shape(int* out) {
  out[0] = kRisSmemLights;
  return 0;
}

int sunray_di_temporal(const float* em, int n_lights, const long long* seed,
                       const float* r_pos, const float* r_nrm, const float* r_wsum,
                       const float* r_m, const int32_t* r_idx, const float* r_w,
                       const float* h_pos, const float* h_nrm, const float* h_w,
                       const float* h_m, const int32_t* h_idx, const float* h_hn,
                       const float* h_depth, long long n_hist, const long long* pi,
                       const uint8_t* ok, const float* pos, const float* nrm,
                       const float* view, const float* alb, const float* rough,
                       const float* metal, const float* vdist, int n, float m_clamp,
                       float w_clamp, long long* seed_out, float* o_pos, float* o_nrm,
                       float* o_wsum, float* o_m, int32_t* o_idx, float* o_w,
                       void* stream) {
  return launch_di_temporal<float>(em, n_lights, seed, r_pos, r_nrm, r_wsum, r_m, r_idx,
                                   r_w, h_pos, h_nrm, h_w, h_m, h_idx, h_hn, h_depth,
                                   n_hist, pi, ok, pos, nrm, view, alb, rough, metal,
                                   vdist, n, m_clamp, w_clamp, seed_out, o_pos, o_nrm,
                                   o_wsum, o_m, o_idx, o_w, stream);
}

int sunray_di_temporal_bf16(const float* em, int n_lights, const long long* seed,
                            const float* r_pos, const float* r_nrm, const float* r_wsum,
                            const float* r_m, const int32_t* r_idx, const float* r_w,
                            const float* h_pos, const float* h_nrm, const float* h_w,
                            const float* h_m, const int32_t* h_idx, const float* h_hn,
                            const float* h_depth, long long n_hist, const long long* pi,
                            const uint8_t* ok, const float* pos, const void* nrm,
                            const void* view, const void* alb, const void* rough,
                            const void* metal, const float* vdist, int n, float m_clamp,
                            float w_clamp, long long* seed_out, float* o_pos,
                            float* o_nrm, float* o_wsum, float* o_m, int32_t* o_idx,
                            float* o_w, void* stream) {
  return launch_di_temporal<__nv_bfloat16>(
      em, n_lights, seed, r_pos, r_nrm, r_wsum, r_m, r_idx, r_w, h_pos, h_nrm, h_w, h_m,
      h_idx, h_hn, h_depth, n_hist, pi, ok, pos, nrm, view, alb, rough, metal, vdist, n,
      m_clamp, w_clamp, seed_out, o_pos, o_nrm, o_wsum, o_m, o_idx, o_w, stream);
}

int sunray_di_spatial(const float* em, int n_lights, const long long* seed,
                      const float* c_pos, const float* c_nrm, const float* c_w,
                      const float* c_m, const int32_t* c_idx, const uint8_t* pending,
                      const float* gnormal, const float* gdepth, const float* cur_depth,
                      const float* pos, const float* nrm, const float* view,
                      const float* alb, const float* rough, const float* metal, int width,
                      int height, const int* taps, int n_taps, float w_clamp,
                      float m_clamp, float ws_clamp, long long* seed_out, float* o_pos,
                      float* o_nrm, float* o_wsum, float* o_m, int32_t* o_idx,
                      float* o_wspatial, float* o_fy, uint8_t* o_has, void* stream) {
  return launch_di_spatial<float>(em, n_lights, seed, c_pos, c_nrm, c_w, c_m, c_idx,
                                  pending, gnormal, gdepth, cur_depth, pos, nrm, view, alb,
                                  rough, metal, nrm, width, height, 0, 0, height, taps,
                                  n_taps, w_clamp, m_clamp, ws_clamp, seed_out, o_pos,
                                  o_nrm, o_wsum, o_m, o_idx, o_wspatial, o_fy, o_has,
                                  stream);
}

int sunray_di_spatial_bf16(const float* em, int n_lights, const long long* seed,
                           const float* c_pos, const float* c_nrm, const float* c_w,
                           const float* c_m, const int32_t* c_idx, const uint8_t* pending,
                           const float* gnormal, const float* gdepth,
                           const float* cur_depth, const float* pos, const void* nrm,
                           const void* view, const void* alb, const void* rough,
                           const void* metal, const float* tnrm, int width, int height,
                           const int* taps, int n_taps, float w_clamp, float m_clamp,
                           float ws_clamp, long long* seed_out, float* o_pos,
                           float* o_nrm, float* o_wsum, float* o_m, int32_t* o_idx,
                           float* o_wspatial, float* o_fy, uint8_t* o_has, void* stream) {
  return launch_di_spatial<__nv_bfloat16>(
      em, n_lights, seed, c_pos, c_nrm, c_w, c_m, c_idx, pending, gnormal, gdepth,
      cur_depth, pos, nrm, view, alb, rough, metal, tnrm, width, height, 0, 0, height, taps,
      n_taps, w_clamp, m_clamp, ws_clamp, seed_out, o_pos, o_nrm, o_wsum, o_m, o_idx,
      o_wspatial, o_fy, o_has, stream);
}

// K5's window form (a row-sharded frame, parallel/halo.py): the centre
// lanes are the band's height x width pixels, the reservoir and guide
// planes a window of height + 2 * halo rows around it, and the in-image
// test runs on global rows (row0 + local row) of an h_global-row image.
// With halo 0, row0 0 and h_global = height it is sunray_di_spatial.
int sunray_di_spatial_window(const float* em, int n_lights, const long long* seed,
                             const float* c_pos, const float* c_nrm, const float* c_w,
                             const float* c_m, const int32_t* c_idx,
                             const uint8_t* pending, const float* gnormal,
                             const float* gdepth, const float* cur_depth, const float* pos,
                             const float* nrm, const float* view, const float* alb,
                             const float* rough, const float* metal, int width, int height,
                             int halo, int row0, int h_global, const int* taps, int n_taps,
                             float w_clamp, float m_clamp, float ws_clamp,
                             long long* seed_out, float* o_pos, float* o_nrm, float* o_wsum,
                             float* o_m, int32_t* o_idx, float* o_wspatial, float* o_fy,
                             uint8_t* o_has, void* stream) {
  return launch_di_spatial<float>(em, n_lights, seed, c_pos, c_nrm, c_w, c_m, c_idx,
                                  pending, gnormal, gdepth, cur_depth, pos, nrm, view, alb,
                                  rough, metal, nrm, width, height, halo, row0, h_global,
                                  taps, n_taps, w_clamp, m_clamp, ws_clamp, seed_out, o_pos,
                                  o_nrm, o_wsum, o_m, o_idx, o_wspatial, o_fy, o_has,
                                  stream);
}

int sunray_di_spatial_window_bf16(
    const float* em, int n_lights, const long long* seed, const float* c_pos,
    const float* c_nrm, const float* c_w, const float* c_m, const int32_t* c_idx,
    const uint8_t* pending, const float* gnormal, const float* gdepth,
    const float* cur_depth, const float* pos, const void* nrm, const void* view,
    const void* alb, const void* rough, const void* metal, const float* tnrm, int width,
    int height, int halo, int row0, int h_global, const int* taps, int n_taps,
    float w_clamp, float m_clamp, float ws_clamp, long long* seed_out, float* o_pos,
    float* o_nrm, float* o_wsum, float* o_m, int32_t* o_idx, float* o_wspatial,
    float* o_fy, uint8_t* o_has, void* stream) {
  return launch_di_spatial<__nv_bfloat16>(
      em, n_lights, seed, c_pos, c_nrm, c_w, c_m, c_idx, pending, gnormal, gdepth,
      cur_depth, pos, nrm, view, alb, rough, metal, tnrm, width, height, halo, row0,
      h_global, taps, n_taps, w_clamp, m_clamp, ws_clamp, seed_out, o_pos, o_nrm, o_wsum,
      o_m, o_idx, o_wspatial, o_fy, o_has, stream);
}

int sunray_gi_spatial(const long long* seed, const float* c_spos, const float* c_srad,
                      const int32_t* c_stri, const float* c_wsum, const float* c_m,
                      const float* t_spos, const float* t_srad,
                      const int32_t* t_stri, const float* t_w,
                      const float* t_m, const float* t_jac, const uint8_t* t_ok, int n_taps,
                      const uint8_t* pending, const float* pos, const float* nrm,
                      const float* alb, const float* metal, int n, float w_clamp,
                      long long* seed_out, float* o_gdir, float* o_gdist, int32_t* o_stri,
                      uint8_t* o_try, float* o_contrib, void* stream) {
  return launch_gi_spatial<float>(seed, c_spos, c_srad, c_stri, c_wsum, c_m, t_spos,
                                  t_srad, t_stri, t_w, t_m, t_jac, t_ok, n_taps, pending,
                                  pos, nrm, alb, metal, nrm, alb, metal, n, w_clamp,
                                  seed_out, o_gdir, o_gdist, o_stri, o_try, o_contrib,
                                  stream);
}

int sunray_gi_spatial_bf16(const long long* seed, const float* c_spos, const float* c_srad,
                           const int32_t* c_stri, const float* c_wsum, const float* c_m,
                           const float* t_spos, const float* t_srad,
                           const int32_t* t_stri, const float* t_w, const float* t_m,
                           const float* t_jac, const uint8_t* t_ok, int n_taps,
                           const uint8_t* pending, const float* pos, const float* nrm,
                           const float* alb, const float* metal, const void* snrm,
                           const void* salb, const void* smetal, int n, float w_clamp,
                           long long* seed_out, float* o_gdir, float* o_gdist,
                           int32_t* o_stri, uint8_t* o_try, float* o_contrib,
                           void* stream) {
  return launch_gi_spatial<__nv_bfloat16>(
      seed, c_spos, c_srad, c_stri, c_wsum, c_m, t_spos, t_srad, t_stri, t_w, t_m, t_jac,
      t_ok, n_taps, pending, pos, nrm, alb, metal, snrm, salb, smetal, n, w_clamp,
      seed_out, o_gdir, o_gdist, o_stri, o_try, o_contrib, stream);
}

}  // extern "C"
