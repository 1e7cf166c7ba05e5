// K8: BLS12-381 G1 scalar multiplication by the GLV endomorphism.
//
// g1_glv_kernel replaces zkdl_tpu/curve/g1.py:scalar_mul_glv (:302-326), an
// XLA loop on the TPU (no Pallas kernel), which the JAX package runs on an
// accelerator for the generator MSM of every revealed-fold opening check
// (pedersen._verify_reveal_dev) and for the blinded tier's H^b
// (pedersen._smul). It computes, for each point P and raw scalar s:
//   s = s1 + lambda s2, 0 <= s1 < lambda (glv_decompose, :251), lambda =
//     X^2 - 1 for the BLS parameter X, so phi(P) = (beta x, y, z) = lambda P;
//   t1[k] = k P and t2[k] = k phi(P) for k < 16 (_mk_table, :294): t[0] =
//     (0, 0, 0), t[1] the point's own limbs, t[k] = add(t[k - 1], t[1]);
//   from out = (0, 0, 0), for each of the 33 4-bit windows from the top:
//     four doubles, out = add(out, t1[d1]), out = add(out, t2[d2]).
// The results are fixed down to the limb (the port's tests hold them
// against the JAX function's), so every formula is g1.py's (add-2007-bl and
// dbl-2009-l with its selects: p == O gives q's limbs, q == O p's, equal
// points double(p), a z = 0 point doubles to itself), over canonical
// Montgomery Fp values (csrc/g1_var.cuh's Var, as K5).
//
// Decomposition: in the kernel, by exact integer division. For s < r the
// pair with 0 <= s1 < lambda is unique, so any exact division gives the
// JAX Barrett division's digits: qhat = floor(s M / 2^256), M =
// floor(2^256 / lambda), undershoots the quotient by at most one; two
// conditional subtractions of lambda end it (glv_split; its word-level
// model is tests/port/test_torch_glv.py). s2 < 2^129 for every 256-bit s,
// so the 33 windows hold all of it (the JAX quotient keeps 128 bits: above
// s = 2^128 lambda, past r, the two differ).
//
// What is skipped: the windows above a warp's highest nonzero digit (the
// walk doubles (0, 0, 0) and adds t[0] = (0, 0, 0) there, leaving those
// limbs), and the top window's doubles (out is still (0, 0, 0) for every
// point of the warp).
//
// Tables: two of 16 entries of (x, y, z), 1152 words (4608 bytes) a point,
// too many for registers at any layout. They go to a scratch vector in
// device memory that the wrapper allocates, one row a point: at the
// verify's 18,432 points 85 MB, beyond L2's 50 MB, but each window reads
// two entries (288 bytes) against ~100 dependent Fp products, so the
// traffic is ~0.2 GB a launch (0.06 ms at 3.35 TB/s), far under the
// products' time; shared memory would cap the layouts at a few points a
// block. Team 0's lanes of a point write its tables; after a __syncwarp
// every lane reads them with plain (coherent) loads.
//
// Layouts: Team, Quad and Solo as K5 (csrc/fp_team.cuh), one, four or
// sixteen points a warp, picked by the launch's size (GLV_QUAD_FROM,
// GLV_SOLO_FROM) or forced; every layout gives the same bits.
//
// What bounds it on an H100: the 32-bit multiply-adds of its Fp products,
// counted at the JAX formulas' cost (a generic add 11 products and 5
// squarings, a double 2 and 5): per point with s < r, ~124 doubles and
// ~90 generic adds (28 for the tables, two a window), and one product for
// phi, about 1.2M multiply-adds against double-and-add's ~2M (K5). At the
// verify's 18,432 points that is ~1.4 ms at 16.7e12/s; chip_smoke.py's
// glv_bound counts the exact doubles and adds of a launch's data.
//
// C interface (loaded with ctypes): zk_g1_glv launches on the given stream
// and device and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "fp_team.cuh"
#include "g1_var.cuh"

namespace {

// K8's layout by the launch (the crossovers measured in PERF.md, PR 11):
// one point a warp is the shortest chain (best at 256 points); four points
// a warp the fewer instructions (best from 1024); sixteen points a warp the
// fewest (best from 8192)
constexpr int64_t GLV_QUAD_FROM = 1024;
constexpr int64_t GLV_SOLO_FROM = 8192;
constexpr int GLV_ENTRIES = 16;
constexpr int64_t TABLE_WORDS = 2 * GLV_ENTRIES * 3 * NL;  // a point's scratch

// lambda = X^2 - 1 (128 bits), M = floor(2^256 / lambda) (129 bits), and
// beta in Montgomery form (beta R mod p), little-endian words
__device__ __forceinline__ uint32_t glv_lambda(int i) {
  constexpr uint32_t L[4] = {0xffffffffu, 0x00000000u, 0x0001a402u, 0xac45a401u};
  return L[i];
}
__device__ __forceinline__ uint32_t glv_m(int i) {
  constexpr uint32_t M[5] = {0xf6cfee30u, 0x63f6e522u, 0xe01faaddu, 0x7c6becf1u, 0x00000001u};
  return M[i];
}
__device__ uint32_t GLV_BETA_MONT[NL] = {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u,
                                         0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu,
                                         0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u};

// s = s1 + lambda s2, 0 <= s1 < lambda, for a 256-bit s: s1 in 4 words,
// s2 in 5. qhat = words 8..12 of s M; the remainder s - qhat lambda lies in
// [0, 2 lambda) and so is exact over the low 5 words; two conditional
// subtractions of lambda, each adding one to the quotient, end it.
__device__ __forceinline__ void glv_split(const uint32_t (&s)[8], uint32_t (&s1)[4], uint32_t (&s2)[5]) {
  uint32_t t[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t v = (uint64_t)s[j] * glv_m(i) + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = v >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  uint32_t ql[5] = {0, 0, 0, 0, 0};  // qhat lambda mod 2^160
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j < 5) {
        const uint64_t v = (uint64_t)t[8 + i] * glv_lambda(j) + ql[i + j] + c;
        ql[i + j] = (uint32_t)v;
        c = v >> 32;
      }
    }
    if (i == 0) ql[4] = (uint32_t)c;
  }
  uint32_t rem[5], q[5];
  uint32_t b = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint64_t v = (uint64_t)s[i] - ql[i] - b;
    rem[i] = (uint32_t)v;
    b = (uint32_t)(v >> 32) & 1u;
    q[i] = t[8 + i];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint32_t d[5];
    b = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint64_t v = (uint64_t)rem[i] - (i < 4 ? glv_lambda(i) : 0u) - b;
      d[i] = (uint32_t)v;
      b = (uint32_t)(v >> 32) & 1u;
    }
    const bool ge = b == 0;  // rem >= lambda
    uint32_t c = ge ? 1u : 0u;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      rem[i] = ge ? d[i] : rem[i];
      const uint64_t v = (uint64_t)q[i] + c;
      q[i] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s1[i] = rem[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) s2[i] = q[i];
}

// 4-bit window w of a little-endian word vector, without a dynamically
// indexed array (which would go to local memory)
template <int N>
__device__ __forceinline__ int window(const uint32_t (&v)[N], int w) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) word = (w >> 3) == i ? v[i] : word;
  return (int)((word >> (4 * (w & 7))) & 15u);
}

// the highest nonzero window, -1 for 0
template <int N>
__device__ __forceinline__ int top_window(const uint32_t (&v)[N]) {
  int top = -1;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (v[i]) top = 8 * i + (31 - __clz(v[i])) / 4;
  return top;
}

template <class T>
struct Glv {
  using V = Var<T>;
  using Pt = typename V::Pt;

  // g1.py:double: a z = 0 point keeps its limbs
  __device__ static Pt dbl(const T& tm, const Pt& P) { return V::sel(tm.zero(P.z), P, V::dbl(tm, P)); }

  // g1.py:add with its selects: P == O -> Q, Q == O -> P, equal -> double(P)
  __device__ static Pt add(const T& tm, const Pt& P, const Pt& Q) {
    const bool pO = tm.zero(P.z), qO = tm.zero(Q.z);
    const bool gen = !pO && !qO;
    Pt sum = P;
    if (T::ALWAYS_ADD || __any_sync(FULL, gen)) {
      bool same;
      V::add(tm, P, Q, sum, same);
      if (__any_sync(FULL, gen && same)) sum = V::sel(same, V::dbl(tm, P), sum);  // equal points: rare
    }
    return V::sel(pO, Q, V::sel(qO, P, sum));
  }

  __device__ static void put(const T& tm, uint32_t* table, int64_t at, const Pt& e) {
    tm.store(table, at, e.x);
    tm.store(table, at + NL, e.y);
    tm.store(table, at + 2 * NL, e.z);
  }
  __device__ static Pt get(const T& tm, const uint32_t* table, int64_t at) {
    return {tm.load_rw(table, at), tm.load_rw(table, at + NL), tm.load_rw(table, at + 2 * NL)};
  }
};

// out[i] = scalar_i * p[i] by GLV. PTS = 32 / T::POINT_LANES points a warp;
// the lanes of a warp's points past n mirror point n - 1 and store nothing.
template <class T>
__global__ void __launch_bounds__(Launch<T>::THREADS, Launch<T>::MIN_BLOCKS)
    g1_glv_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py, const uint32_t* __restrict__ pz,
                  int64_t p_stride, const uint32_t* __restrict__ sc, uint32_t* table,
                  uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  constexpr int PTS = 32 / T::POINT_LANES;
  using G = Glv<T>;
  using Pt = typename G::Pt;
  const int lane = threadIdx.x & 31;
  const int64_t first = ((int64_t)blockIdx.x * Launch<T>::THREADS + threadIdx.x) / 32 * PTS;
  if (first >= n) return;  // the whole warp
  const int64_t i = first + lane / T::POINT_LANES;
  const bool live = i < n;
  const int64_t src = live ? i : n - 1;
  const T tm(lane);

  uint32_t s[8], s1[4], s2[5];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = __ldg(sc + src * 8 + k);
  glv_split(s, s1, s2);
  const int start = __reduce_max_sync(FULL, max(top_window(s1), top_window(s2)) + 1) - 1;  // the warp's

  // the two tables, written by team 0 of each live point
  const int64_t tb = src * TABLE_WORDS;
  const bool writer = live && tm.team == 0;
  const int64_t off = src * p_stride;
  const Pt P{tm.load(px, off), tm.load(py, off), tm.load(pz, off)};
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    Pt B = P;
    if (t) B.x = tm.mul(P.x, tm.load(GLV_BETA_MONT, 0));  // phi(P)
    const int64_t at = tb + (int64_t)t * GLV_ENTRIES * 3 * NL;
    if (writer) {
      G::put(tm, table, at, Pt{});
      G::put(tm, table, at + 3 * NL, B);
    }
    Pt e = B;
#pragma unroll 1
    for (int k = 2; k < GLV_ENTRIES; ++k) {
      e = G::add(tm, e, B);
      if (writer) G::put(tm, table, at + (int64_t)k * 3 * NL, e);
    }
  }
  __syncwarp();

  Pt out{};
#pragma unroll 1
  for (int w = start; w >= 0; --w) {
    if (w < start) {
#pragma unroll 1
      for (int j = 0; j < 4; ++j) out = G::dbl(tm, out);
    }
    out = G::add(tm, out, G::get(tm, table, tb + (int64_t)window(s1, w) * 3 * NL));
    out = G::add(tm, out, G::get(tm, table, tb + (int64_t)(GLV_ENTRIES + window(s2, w)) * 3 * NL));
  }
  if (live && tm.team == 0) {
    tm.store(ox, i * NL, out.x);
    tm.store(oy, i * NL, out.y);
    tm.store(oz, i * NL, out.z);
  }
}

template <class T>
void launch_glv(const void* px, const void* py, const void* pz, long long p_stride, const void* scalars, void* table,
                void* ox, void* oy, void* oz, long long n, void* stream) {
  constexpr long long PER_BLOCK = Launch<T>::THREADS / T::POINT_LANES;  // points a block
  g1_glv_kernel<T><<<(unsigned)((n + PER_BLOCK - 1) / PER_BLOCK), Launch<T>::THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, p_stride, (const uint32_t*)scalars,
      (uint32_t*)table, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
}

}  // namespace

// n >= 1 points (element stride p_stride words), a raw scalar each ((n, 8)
// words); table: n * 1152 words of scratch. form 1: one point a warp
// (Team); 2: four (Quad); 3: sixteen (Solo); 0: by the launch, Team below
// GLV_QUAD_FROM points, Solo from GLV_SOLO_FROM, Quad between. Every form
// gives the same bits.
extern "C" int zk_g1_glv(int form, const void* px, const void* py, const void* pz, long long p_stride,
                         const void* scalars, void* table, void* ox, void* oy, void* oz, long long n, void* stream,
                         int device) {
  if (form == 0) form = n < GLV_QUAD_FROM ? 1 : n >= GLV_SOLO_FROM ? 3 : 2;
  if (n < 1 || n > (1ll << 32) || form < 1 || form > 3 || table == nullptr) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    if (form == 1) launch_glv<Team>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
    else if (form == 2) launch_glv<Quad>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
    else launch_glv<Solo>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
  });
}
