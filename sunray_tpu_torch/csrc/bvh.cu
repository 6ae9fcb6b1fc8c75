// B2 and B3: the BVH stack walks, one ray a thread.
//
// B2, the unified walk, replaces sunray_tpu/ops/bvh.py's _traverse_one
// (:375-475, called by trace_closest_bvh :505 and trace_occluded_bvh
// :535); B3, the two-level walk, replaces sunray_tpu/ops/bvh2.py's
// _traverse_one2 (:454-565, called by trace_*_bvh2 :567, :592). Neither
// is a pallas_call: JAX walks every ray of a block in lock step with
// lax.while_loop. A lock-step walk in PyTorch takes ~50 launches a round
// over hundreds of rounds; on the card a walk is a natural one-thread
// program, so both are hand kernels (one template: closest / any hit, one
// / two levels, with or without alpha cutout).
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
// Alpha cutout (kAlpha; render/trace.py's rounds, any_hit.slang:11-43):
// each thread runs its own ray's rounds, which the batch rounds define
// lane by lane (ops/bvh.walk_alpha_plain is the twin):
//   closest: walk; while the hit is a MASK hit whose alpha is below its
//     cutoff, walk again from t + 1e-4 with the same tmax, at most
//     `rounds` times;
//   occlusion: at most rounds + 1 closest walks on [tmin, tmax], no
//     exclude inside the walk; the first hit that is not the excluded id
//     and passes the alpha test occludes; a miss ends the ray visible;
//     any other hit moves tmin to t + 1e-4.
// The alpha test (render/trace.alpha_accepts, ops/texture.sample_texture):
// triangle -> its MASK material's primitive (-1: opaque, accepted), the
// base-colour uv w0 c0 + w1 c1 + w2 c2 fused as fmaf(w2, c2, fmaf(w0, c0,
// w1 * c1)) with w0 = (1 - u) - v, then the texture's alpha channel
// (nearest, or bilinear with its sums fused on the left product; the
// texel position unfused), wrapped per axis (repeat and mirror with
// torch.remainder's floor semantics, clamp) in int64 texel coordinates;
// NULL_TEXTURE takes the base colour's alpha, the static 1x1x1 atlas 1.
//
// Roundings: --fmad=false keeps every multiply and add rounded on its
// own; fmaf() stands where the plain twin calls ops/fp.fma: the three-term
// dots dot3(x, y) = fmaf(x2, y2, fmaf(x1, y1, x0 * y0)), the cross
// products' fmaf(a1, b2, -(a2 * b1)), and the instance transform's row
// dots (b is added after the fused dot). Division is IEEE. So kernel and
// twin give the same bits.
//
// What bounds it: neither bytes nor operations. Each slab test is 27 fp32
// operations and each triangle test 53; a ray reads 32 bytes and writes
// 17; the trees (4.2 MB of node rows, 12.6 MB of leaf rows for 256K
// triangles) sit in the 50 MB L2. The walk is bound by the latency of its
// dependent loads and by the instructions it issues (chip_smoke.py gives
// its issue floor from the SASS of a pop and of a triangle test and the
// tests the kernel counts).
//
// Design, for Hopper (times on an H100 SXM at 700 W):
//   - one thread a ray, 128 threads a block, at most 64 registers (8
//     blocks an SM: the walk hides the latency of its dependent loads
//     with warps; 146 registers without the bound cost B3 a third);
//   - a while-while loop (internal nodes, then leaves; Aila and Laine,
//     "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009)
//     with the top entry in registers: a hit near child is walked next
//     without a store and a load, only the far one is pushed;
//   - the stack holds one word an entry: the node id (B2), or node and
//     instance code packed in 32 bits where the host sees that they fit
//     (node_bits), else in 64 (B3 2-5% slower: 24 KB of shared memory a
//     block against 16); its top kShared entries live in shared memory, a
//     column a thread (conflict-free), deeper ones spill to a local
//     array, so the clamp at kStack - 1 stays JAX's;
//   - B3 transforms the ray only when the popped code differs from the
//     last one (the transform is a function of code and ray);
//   - a leaf skips its padding slots (id -1) without a test;
//   - a leaf triangle is three aligned float4 rows (a, e1 = b - a, e2 =
//     c - a, padded to 12 floats; pack time computes e1 and e2 in float32,
//     the subtraction of ops/intersect.mt_components);
//   - B3's TLAS rows (the last rows of the node table) are staged in
//     shared memory when there are at most kTlasSmem of them;
//   - persistent warps, as many blocks as the card holds: a warp takes the
//     next 32 rays from a counter when all of its rays have ended (3-8%
//     off the shadow walks against a full grid of one-shot blocks, 2% off
//     B3's bounce walk, the camera walks level);
//   - a node row is one int4 (children, codes) and three float4 (boxes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;          // ops/bvh.py STACK_DEPTH
constexpr int kShared = 16;         // stack entries a thread keeps in shared memory
constexpr int kTlasSmem = 128;      // TLAS rows staged in shared memory, at most
constexpr int kMinBlocks = 8;       // blocks an SM: at most 64 registers
constexpr float kDetEps = 1e-9f;    // ops/intersect.py DET_EPS
constexpr float kRetrace = 1e-4f;   // render/trace.py: past a rejected hit
constexpr int kNullTexture = -1;    // scene/types.py NULL_TEXTURE
constexpr int kWrapRepeat = 0, kWrapClamp = 1, kWrapMirror = 2;
constexpr int kUvSlots = 5;         // uvs (V, 5, 2); the base colour's is slot 0

struct Tables {
  const int4* node_ids;     // (rows,) children (left, right), their codes
  const float4* node_box;   // (rows, 3) left min/max, right min/max
  const float4* leaf_e;     // (NL, K, 3) a, e1, e2, padded
  const int* leaf_ids;      // (NL, K) triangle ids, -1 pad
  const int* root;          // (2,) the root's id and code
  const float* inst_inv;    // (I + 1, 12) world->object rows, by code
  const int* inst_off;      // (I + 1,) world triangle offsets, by code
  int nl, k;
  int smem_first, smem_rows;  // node rows staged in shared memory
  int node_bits;              // 32-bit two-level words: the node id's bits
};

struct Alpha {
  const int* tri_mat;       // (T,) the MASK primitive, -1 opaque
  const int* tri_vidx;      // (T, 3)
  const float* uvs;         // (V, 5, 2)
  const int* mat_tex;       // (P,) base-colour texture or NULL_TEXTURE
  const float* base_color;  // (P, 4)
  const float* cutoff;      // (P,)
  const float* atlas;       // (N, H, W, 4)
  const int* tex_size;      // (N, 2) (w, h)
  const int* tex_wrap;      // (N, 2)
  const int* tex_filt;      // (N,) 1 bilinear, else nearest
  int atlas_h, atlas_w, trivial, rounds;
};

struct Rays {
  const float* o;
  const float* d;
  const float* tmin;
  const float* tmax;
  const int* exclude;
  int64_t n;
  float* t;
  int* tri;
  float* u;
  float* v;
  uint8_t* hit;
  int* tests;
  unsigned long long* next;   // persistent warps' ray counter
};

struct Hit {
  float t, u, v;
  int tri;
  bool found;
};

// The ray in world space and in the object space of instance `code`.
struct Ray {
  float wo[3], wd[3];
  float o[3], d[3], inv[3];
  int code;
};

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

// The stack: entry i of this thread at top[i * kThreads] in shared memory
// below kShared, in a local array above.
template <typename Word>
struct Stack {
  Word* top;
  Word spill[kStack - kShared];

  __device__ __forceinline__ Word get(int i) const {
    return i < kShared ? top[i * kThreads] : spill[i - kShared];
  }
  __device__ __forceinline__ void set(int i, Word w) {
    if (i < kShared)
      top[i * kThreads] = w;
    else
      spill[i - kShared] = w;
  }
};

// A stack word: the node id in the low `bits` bits (32 in a 64-bit
// word), the instance code above it; B2's words hold the node id alone.
template <typename Word>
__device__ __forceinline__ int word_bits(int bits) {
  return sizeof(Word) == 8 ? 32 : bits;
}

template <bool kTwoLevel, typename Word>
__device__ __forceinline__ Word pack(int node, int code, int bits) {
  if (!kTwoLevel) return static_cast<Word>(static_cast<uint32_t>(node));
  return static_cast<Word>(static_cast<uint32_t>(node)) |
         (static_cast<Word>(static_cast<uint32_t>(code)) << word_bits<Word>(bits));
}

template <bool kTwoLevel, typename Word>
__device__ __forceinline__ void unpack(Word w, int bits, int* node, int* code) {
  if (!kTwoLevel) {
    *node = static_cast<int>(w);
    *code = 0;
    return;
  }
  const int b = word_bits<Word>(bits);
  *node = static_cast<int>(w & ((static_cast<Word>(1) << b) - 1));
  *code = static_cast<int>(w >> b);
}

__device__ __forceinline__ void to_object(const Tables& tb, int code, Ray& ray) {
  const float* a = tb.inst_inv + 12 * static_cast<int64_t>(code);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a0 = __ldg(a + 3 * i), a1 = __ldg(a + 3 * i + 1), a2 = __ldg(a + 3 * i + 2);
    ray.o[i] = dot3(a0, ray.wo[0], a1, ray.wo[1], a2, ray.wo[2]) + __ldg(a + 9 + i);
    ray.d[i] = dot3(a0, ray.wd[0], a1, ray.wd[1], a2, ray.wd[2]);
    ray.inv[i] = inverse_dir(ray.d[i]);
  }
  ray.code = code;
}

// One walk on [tmin, tmax]: the closest hit, or with kAny the first leaf
// with a hit. has_ex: drop world triangle id ex.
//
// The entry on top of the stack (node, code) stays in registers; the
// stack in memory holds the entries below it (sp - 1 of them). The loop
// is while-while: internal nodes one after the other until the lane
// reaches a leaf, then leaves one after the other until it pops an
// internal node, so the lanes of a warp run the same code more often.
// Each lane still takes its entries in the reference's order.
template <bool kAny, bool kTwoLevel, typename Word>
__device__ __forceinline__ Hit walk(const Tables& tb, const int4* s_ids, const float4* s_box,
                                    Stack<Word>& st, Ray& ray, float tmin, float tmax,
                                    bool has_ex, int ex, int& box_tests, int& tri_tests) {
  Hit h{tmax, 0.0f, 0.0f, -1, false};
  int node = __ldg(tb.root), code = kTwoLevel ? __ldg(tb.root + 1) : 0;
  int sp = 1;
  for (;;) {
    // Internal nodes: children, codes and both boxes from one row.
    while (node >= tb.nl) {
      if (kTwoLevel && code != ray.code) to_object(tb, code, ray);
      const int s = sp - 1;
      const int row = node - tb.nl;
      const int srow = row - tb.smem_first;
      int4 ids;
      float4 b0, b1, b2;
      if (kTwoLevel && static_cast<unsigned>(srow) < static_cast<unsigned>(tb.smem_rows)) {
        ids = s_ids[srow];
        b0 = s_box[3 * srow];
        b1 = s_box[3 * srow + 1];
        b2 = s_box[3 * srow + 2];
      } else {
        ids = __ldg(tb.node_ids + row);
        b0 = __ldg(tb.node_box + 3 * row);
        b1 = __ldg(tb.node_box + 3 * row + 1);
        b2 = __ldg(tb.node_box + 3 * row + 2);
      }
      const float llo[3] = {b0.x, b0.y, b0.z}, lhi[3] = {b0.w, b1.x, b1.y};
      const float rlo[3] = {b1.z, b1.w, b2.x}, rhi[3] = {b2.y, b2.z, b2.w};
      float tn_l, tn_r;
      const bool hit_l = box(ray.o, ray.inv, llo, lhi, tmin, h.t, &tn_l);
      const bool hit_r = box(ray.o, ray.inv, rlo, rhi, tmin, h.t, &tn_r);
      box_tests += 2;
      const int il = kTwoLevel && ids.z > 0 ? ids.z : code;
      const int ir = kTwoLevel && ids.w > 0 ? ids.w : code;
      const bool l_near = tn_l <= tn_r;
      const bool far_h = l_near ? hit_r : hit_l;
      const bool near_h = l_near ? hit_l : hit_r;
      const int far_node = l_near ? ids.y : ids.x, far_code = l_near ? ir : il;
      const int near_node = l_near ? ids.x : ids.y, near_code = l_near ? il : ir;
      // JAX's pushes: the far child at s, the near one at min(s + 1, kStack
      // - 1), the stack pointer clamped to kStack - 1: with s = kStack - 2
      // the near child lands above the pointer and is never popped.
      if (far_h && near_h && s + 1 < kStack - 1) {
        st.set(s, pack<kTwoLevel, Word>(far_node, far_code, tb.node_bits));
        node = near_node;
        code = near_code;
        sp = s + 2;
      } else if (far_h || near_h) {
        node = far_h ? far_node : near_node;
        code = far_h ? far_code : near_code;
        sp = s + 1;
      } else {
        if (s == 0) return h;
        unpack<kTwoLevel, Word>(st.get(s - 1), tb.node_bits, &node, &code);
        sp = s;
      }
    }
    // Leaves: K triangles each; the first of the least t wins.
    do {
      if (kTwoLevel && code != ray.code) to_object(tb, code, ray);
      const float4* le = tb.leaf_e + 3 * static_cast<int64_t>(node) * tb.k;
      const int* li = tb.leaf_ids + static_cast<int64_t>(node) * tb.k;
      const int off = kTwoLevel ? __ldg(tb.inst_off + code) : 0;
      float lt = INFINITY, lu = 0.0f, lv = 0.0f;
      int ltri = 0;
      bool lok = false;
      for (int j = 0; j < tb.k; ++j) {
        const int id = __ldg(li + j);
        if (id < 0) continue;  // padding: never a hit, not a test
        const float4 r0 = __ldg(le + 3 * j), r1 = __ldg(le + 3 * j + 1),
                     r2 = __ldg(le + 3 * j + 2);
        const float ax = r0.x, ay = r0.y, az = r0.z;
        const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
        const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
        const float px = fmaf(ray.d[1], e2z, -(ray.d[2] * e2y));
        const float py = fmaf(ray.d[2], e2x, -(ray.d[0] * e2z));
        const float pz = fmaf(ray.d[0], e2y, -(ray.d[1] * e2x));
        const float det = dot3(e1x, px, e1y, py, e1z, pz);
        const bool det_ok = fabsf(det) > kDetEps;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tx = ray.o[0] - ax, ty = ray.o[1] - ay, tz = ray.o[2] - az;
        const float u = dot3(tx, px, ty, py, tz, pz) * inv_det;
        const float qx = fmaf(ty, e1z, -(tz * e1y));
        const float qy = fmaf(tz, e1x, -(tx * e1z));
        const float qz = fmaf(tx, e1y, -(ty * e1x));
        const float v = dot3(ray.d[0], qx, ray.d[1], qy, ray.d[2], qz) * inv_det;
        const float t = dot3(e2x, qx, e2y, qy, e2z, qz) * inv_det;
        const int wid = id + off;
        ++tri_tests;
        const bool ok = det_ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= tmin) &
                        (t <= h.t) & (!has_ex | (wid != ex));
        // torch.argmin / jnp.argmin over t (inf where not ok): the first
        // index of the least value, slot 0 where every value is inf, so
        // slot 0 is taken whenever it is ok (its t may be inf when tmax
        // is).
        if (ok && (t < lt || j == 0)) {
          lt = t;
          lu = u;
          lv = v;
          ltri = wid;
          lok = true;
        }
      }
      if (lok) {
        h.t = lt;
        h.u = lu;
        h.v = lv;
        h.tri = ltri;
        h.found = true;
        if (kAny) return h;
      }
      const int s = sp - 1;
      if (s == 0) return h;
      unpack<kTwoLevel, Word>(st.get(s - 1), tb.node_bits, &node, &code);
      sp = s;
    } while (node < tb.nl);
  }
}

// torch.remainder on integers: the sign of the divisor.
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// ops/texture.apply_wrap of one texel coordinate.
__device__ int64_t apply_wrap(int64_t c, int64_t size, int mode) {
  size = size > 1 ? size : 1;
  const int64_t repeat = floor_mod(c, size);
  const int64_t clamp = c < 0 ? 0 : c < size - 1 ? c : size - 1;
  const int64_t period = 2 * size;
  const int64_t m = floor_mod(floor_mod(c, period) + period, period);
  const int64_t mirror = m < size ? m : period - 1 - m;
  return (mode == kWrapRepeat ? repeat : 0) + (mode == kWrapClamp ? clamp : 0) +
         (mode == kWrapMirror ? mirror : 0);
}

__device__ __forceinline__ float texel_alpha(const Alpha& al, int tex, int64_t y, int64_t x) {
  return __ldg(al.atlas + ((static_cast<int64_t>(tex) * al.atlas_h + y) * al.atlas_w + x) * 4 + 3);
}

// Channel 3 of ops/texture.sample_texture at uv (ux, uy) of texture tex.
__device__ float texture_alpha(const Alpha& al, int tex, float ux, float uy) {
  const int64_t w = __ldg(al.tex_size + 2 * tex), h = __ldg(al.tex_size + 2 * tex + 1);
  const int wrap_x = __ldg(al.tex_wrap + 2 * tex), wrap_y = __ldg(al.tex_wrap + 2 * tex + 1);
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  if (__ldg(al.tex_filt + tex) == 1) {
    const float px = ux * wf - 0.5f, py = uy * hf - 0.5f;
    const float bxf = floorf(px), byf = floorf(py);
    const float fx = px - bxf, fy = py - byf;
    const int64_t bx = static_cast<int64_t>(bxf), by = static_cast<int64_t>(byf);
    const int64_t x0 = apply_wrap(bx, w, wrap_x), x1 = apply_wrap(bx + 1, w, wrap_x);
    const int64_t y0 = apply_wrap(by, h, wrap_y), y1 = apply_wrap(by + 1, h, wrap_y);
    const float t00 = texel_alpha(al, tex, y0, x0), t10 = texel_alpha(al, tex, y0, x1);
    const float t01 = texel_alpha(al, tex, y1, x0), t11 = texel_alpha(al, tex, y1, x1);
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    return fmaf(fmaf(t00, gx, t10 * fx), gy, fmaf(t01, gx, t11 * fx) * fy);
  }
  const int64_t nx = apply_wrap(static_cast<int64_t>(floorf(ux * wf)), w, wrap_x);
  const int64_t ny = apply_wrap(static_cast<int64_t>(floorf(uy * hf)), h, wrap_y);
  return texel_alpha(al, tex, ny, nx);
}

// render/trace.alpha_accepts of one hit: true = accepted.
__device__ bool alpha_accepts(const Alpha& al, int tri, float u, float v) {
  const int prim = __ldg(al.tri_mat + tri);
  if (prim < 0) return true;
  const int* vi = al.tri_vidx + 3 * static_cast<int64_t>(tri);
  const float* c0 = al.uvs + 2 * kUvSlots * static_cast<int64_t>(__ldg(vi));
  const float* c1 = al.uvs + 2 * kUvSlots * static_cast<int64_t>(__ldg(vi + 1));
  const float* c2 = al.uvs + 2 * kUvSlots * static_cast<int64_t>(__ldg(vi + 2));
  const float w0 = (1.0f - u) - v;
  const float ux = fmaf(v, __ldg(c2), fmaf(w0, __ldg(c0), u * __ldg(c1)));
  const float uy = fmaf(v, __ldg(c2 + 1), fmaf(w0, __ldg(c0 + 1), u * __ldg(c1 + 1)));
  const int tex = __ldg(al.mat_tex + prim);
  const float alpha = tex == kNullTexture ? __ldg(al.base_color + 4 * prim + 3)
                      : al.trivial        ? 1.0f
                                          : texture_alpha(al, tex, ux, uy);
  return alpha >= __ldg(al.cutoff + prim);
}

template <bool kAny, bool kTwoLevel, bool kAlpha, typename Word>
__device__ __forceinline__ void trace_ray(const Tables& tb, const Alpha& al, const Rays& rs,
                                          const int4* s_ids, const float4* s_box,
                                          Stack<Word>& st, int64_t r) {
  Ray ray;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ray.wo[c] = rs.o[3 * r + c];
    ray.wd[c] = rs.d[3 * r + c];
    ray.o[c] = ray.wo[c];
    ray.d[c] = ray.wd[c];
    ray.inv[c] = kTwoLevel ? 0.0f : inverse_dir(ray.wd[c]);
  }
  ray.code = -1;
  const float tmin = rs.tmin[r], tmax = rs.tmax[r];
  const bool has_ex = rs.exclude != nullptr;
  const int ex = has_ex ? rs.exclude[r] : 0;
  int box_tests = 0, tri_tests = 0;
  Hit h;
  bool hit;
  if (!kAlpha) {
    h = walk<kAny, kTwoLevel, Word>(tb, s_ids, s_box, st, ray, tmin, tmax, has_ex, ex,
                                    box_tests, tri_tests);
    hit = h.found;
  } else if (!kAny) {
    // Closest: walk again past each rejected hit, at most `rounds` times.
    float cur = tmin;
    for (int i = 0;; ++i) {
      h = walk<false, kTwoLevel, Word>(tb, s_ids, s_box, st, ray, cur, tmax, false, 0,
                                       box_tests, tri_tests);
      if (i == al.rounds || !h.found || alpha_accepts(al, h.tri, h.u, h.v)) break;
      cur = h.t + kRetrace;
    }
    hit = h.found;
  } else {
    // Occlusion: closest hits until an accepted one that is not excluded.
    float cur = tmin;
    hit = false;
    for (int i = 0; i <= al.rounds; ++i) {
      const Hit c = walk<false, kTwoLevel, Word>(tb, s_ids, s_box, st, ray, cur, tmax, false,
                                                 0, box_tests, tri_tests);
      if (!c.found) break;
      if ((!has_ex || c.tri != ex) && alpha_accepts(al, c.tri, c.u, c.v)) {
        hit = true;
        break;
      }
      cur = c.t + kRetrace;
    }
  }
  if (rs.tests != nullptr) {
    rs.tests[2 * r] = box_tests;
    rs.tests[2 * r + 1] = tri_tests;
  }
  rs.hit[r] = hit ? 1 : 0;
  if (!kAny) {
    rs.t[r] = h.found ? h.t : INFINITY;
    rs.tri[r] = h.tri;
    rs.u[r] = h.u;
    rs.v[r] = h.v;
  }
}

template <bool kAny, bool kTwoLevel, bool kAlpha, typename Word>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bvh_walk_kernel(const Tables tb, const Alpha al, const Rays rs) {
  __shared__ Word s_stack[kShared * kThreads];
  __shared__ int4 s_ids[kTwoLevel ? kTlasSmem : 1];
  __shared__ float4 s_box[kTwoLevel ? 3 * kTlasSmem : 1];
  if (kTwoLevel && tb.smem_rows > 0) {
    for (int i = threadIdx.x; i < tb.smem_rows; i += kThreads) {
      const int row = tb.smem_first + i;
      s_ids[i] = __ldg(tb.node_ids + row);
#pragma unroll
      for (int c = 0; c < 3; ++c) s_box[3 * i + c] = __ldg(tb.node_box + 3 * row + c);
    }
    __syncthreads();
  }
  Stack<Word> st;
  st.top = s_stack + threadIdx.x;
  // Persistent warps: the next 32 rays once all of the warp's have ended.
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(rs.next, 32ULL);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= static_cast<unsigned long long>(rs.n)) break;
    const int64_t r = static_cast<int64_t>(base) + lane;
    if (r < rs.n) trace_ray<kAny, kTwoLevel, kAlpha, Word>(tb, al, rs, s_ids, s_box, st, r);
    __syncwarp();
  }
}

template <bool kAny, bool kTwoLevel, bool kAlpha, typename Word>
cudaError_t launch(const Tables& tb, const Alpha& al, const Rays& rs, cudaStream_t s) {
  auto kernel = bvh_walk_kernel<kAny, kTwoLevel, kAlpha, Word>;
  // As many blocks as the card holds at once (fewer for a small query).
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(rs.next, 0, sizeof(*rs.next), s);
  if (err != cudaSuccess) return err;
  const int64_t needed = (rs.n + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(needed < resident ? needed : resident), kThreads, 0, s>>>(tb, al,
                                                                                         rs);
  return cudaGetLastError();
}

template <bool kAlpha>
cudaError_t dispatch(const Tables& tb, const Alpha& al, const Rays& rs, bool two_level,
                     bool any_hit, cudaStream_t s) {
  if (!two_level)
    return any_hit ? launch<true, false, kAlpha, uint32_t>(tb, al, rs, s)
                   : launch<false, false, kAlpha, uint32_t>(tb, al, rs, s);
  if (tb.node_bits > 0)
    return any_hit ? launch<true, true, kAlpha, uint32_t>(tb, al, rs, s)
                   : launch<false, true, kAlpha, uint32_t>(tb, al, rs, s);
  return any_hit ? launch<true, true, kAlpha, unsigned long long>(tb, al, rs, s)
                 : launch<false, true, kAlpha, unsigned long long>(tb, al, rs, s);
}

// The walk's arguments shared by both entry points; returns an error code
// for what the kernel does not take, else 0.
int make_args(const void* node_ids, const void* node_box, int n_nodes, const void* leaf_e,
              const int* leaf_ids, int nl, int k, const int* root, const float* inst_inv,
              const int* inst_off, int smem_rows, int node_bits, const float* o,
              const float* d, const float* tmin, const float* tmax, const int* exclude,
              int64_t n, float* t, int* tri, float* u, float* v, uint8_t* hit, int* tests,
              void* next, Tables* tb, Rays* rs) {
  const bool two_level = inst_inv != nullptr;
  if (nl < 1 || k < 1 || n_nodes < 1 || (two_level && inst_off == nullptr) ||
      smem_rows < 0 || smem_rows > kTlasSmem || smem_rows > n_nodes ||
      (!two_level && smem_rows != 0) || node_bits < 0 || node_bits > 31 || next == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  *tb = Tables{static_cast<const int4*>(node_ids), static_cast<const float4*>(node_box),
               static_cast<const float4*>(leaf_e), leaf_ids, root, inst_inv, inst_off, nl, k,
               n_nodes - smem_rows, smem_rows, node_bits};
  *rs = Rays{o, d, tmin, tmax, exclude, n, t, tri, u, v, hit, tests,
             static_cast<unsigned long long*>(next)};
  return 0;
}

}  // namespace

// (threads a block, stack entries, entries in shared memory, TLAS rows
// staged at most).
extern "C" int sunray_bvh_launch_shape(int* out) {
  out[0] = kThreads;
  out[1] = kStack;
  out[2] = kShared;
  out[3] = kTlasSmem;
  return 0;
}

// One walk launch. inst_inv and inst_off given: B3, else B2. smem_rows:
// the last rows of the node table staged in shared memory (B3's TLAS; at
// most kTlasSmem). node_bits: B3's stack words pack (node, code) in 32
// bits with node_bits for the node id, or in 64 bits when 0. tmin, tmax:
// any floats, tmax infinite too. any_hit:
// only hit is written; else t, tri, u, v and hit. exclude may be null;
// tests, where given, gets each ray's (box tests, triangle tests). next:
// an 8-byte scratch word (the persistent warps' ray counter, zeroed on
// the stream before the kernel).
extern "C" int sunray_bvh_walk(const void* node_ids, const void* node_box, int n_nodes,
                               const void* leaf_e, const int* leaf_ids, int nl, int k,
                               const int* root, const float* inst_inv, const int* inst_off,
                               int smem_rows, int node_bits, int any_hit, const float* o,
                               const float* d, const float* tmin, const float* tmax,
                               const int* exclude, int64_t n, float* t, int* tri, float* u,
                               float* v, uint8_t* hit, int* tests, void* next, void* stream) {
  Tables tb;
  Rays rs;
  const int bad = make_args(node_ids, node_box, n_nodes, leaf_e, leaf_ids, nl, k, root, inst_inv,
                            inst_off, smem_rows, node_bits, o, d, tmin, tmax, exclude, n, t, tri,
                            u, v, hit, tests, next, &tb, &rs);
  if (bad) return bad;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Alpha al{};
  return static_cast<int>(dispatch<false>(tb, al, rs, inst_inv != nullptr, any_hit != 0,
                                          static_cast<cudaStream_t>(stream)));
}

// One walk launch with alpha cutout inside the walk: a ray's rounds in
// its thread (closest: at most `rounds` walks again past rejected hits;
// any_hit: occlusion by at most rounds + 1 closest walks, exclude applied
// to each hit). The walk's arguments as sunray_bvh_walk's; the alpha
// tables as ops/bvh.AlphaTables holds them, the atlas (N, atlas_h,
// atlas_w, 4), trivial for the static 1x1x1 atlas.
extern "C" int sunray_bvh_walk_alpha(
    const void* node_ids, const void* node_box, int n_nodes, const void* leaf_e,
    const int* leaf_ids, int nl, int k, const int* root, const float* inst_inv,
    const int* inst_off, int smem_rows, int node_bits, int any_hit, const int* tri_mat,
    const int* tri_vidx, const float* uvs, const int* mat_tex, const float* base_color,
    const float* cutoff, const float* atlas, const int* tex_size, const int* tex_wrap,
    const int* tex_filt, int atlas_h, int atlas_w, int trivial, int rounds, const float* o,
    const float* d, const float* tmin, const float* tmax, const int* exclude, int64_t n,
    float* t, int* tri, float* u, float* v, uint8_t* hit, int* tests, void* next,
    void* stream) {
  Tables tb;
  Rays rs;
  const int bad = make_args(node_ids, node_box, n_nodes, leaf_e, leaf_ids, nl, k, root, inst_inv,
                            inst_off, smem_rows, node_bits, o, d, tmin, tmax, exclude, n, t, tri,
                            u, v, hit, tests, next, &tb, &rs);
  if (bad) return bad;
  if (rounds < 0 || atlas_h < 1 || atlas_w < 1 || tri_mat == nullptr || tri_vidx == nullptr ||
      uvs == nullptr || mat_tex == nullptr || base_color == nullptr || cutoff == nullptr ||
      atlas == nullptr || tex_size == nullptr || tex_wrap == nullptr || tex_filt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Alpha al{tri_mat, tri_vidx, uvs,    mat_tex, base_color, cutoff, atlas,
                 tex_size, tex_wrap, tex_filt, atlas_h, atlas_w,  trivial, rounds};
  return static_cast<int>(dispatch<true>(tb, al, rs, inst_inv != nullptr, any_hit != 0,
                                         static_cast<cudaStream_t>(stream)));
}
