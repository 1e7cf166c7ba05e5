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
// points double(p), a z = 0 point doubles to itself), value for value as
// K5's csrc/g1_var.cuh:Var. Every value a formula returns, stores or
// tests is canonical, so how each is computed is free: inside a formula
// the values are lazy (csrc/fp_chain.cuh: products and sums below 2p).
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
// What bounds it on an H100: the 32-bit multiply-adds of its Fp products,
// counted at the JAX formulas' cost (a generic add 11 products and 5
// squarings, a double 2 and 5): per point, four doubles a window below its
// highest nonzero one and a generic add a nonzero digit after its first,
// t1's double and 13 adds, and 15 products (phi and t2); chip_smoke.py's
// glv_bound counts them on a launch's data. In practice the chain: a
// product's carry chains run one after another (PTX has one carry flag,
// so two products of one lane do not overlap), and a warp issues from one
// of an SM's four schedulers, so a launch of fewer warps than four an SM
// is bound by one warp's chain of product rounds, and a larger one by the
// schedulers' issue.
//
// The design:
//   - The product (fp_chain.cuh): CIOS in PTX carry chains, even and odd
//     word pairs in two accumulators, no carry words past p's spare bits,
//     no final subtraction (values stay below 2p inside a formula; each
//     formula reduces what it returns, and add-2007-bl what it compares).
//   - Two layouts (fp_chain.cuh), each every value of a point on each of its
//     lanes: Four, four lanes a point, a round of up to four independent
//     products one a lane (double in 3 rounds, add in 5; eight points a
//     warp), for launches of up to one warp a scheduler, where the chain
//     bounds the time; Pair, two lanes a point, two products a round
//     (double in 4, add in 8; sixteen points a warp, fewer instructions a
//     point), for larger ones. zk_g1_glv picks by the launch and the
//     card's SM count (glv_form).
//   - The tables, 1152 words (4608 bytes) a point: t1 is built in the
//     point's arithmetic, and t2 follows from it by one product an entry
//     (the identity that g1_glv_kernel states), spread over the point's
//     lanes; where it does not hold (the identity, points off the subgroup)
//     t2 is built by adds. Four keeps the tables in dynamic shared memory
//     (eight points, 36,864 bytes a one-warp block); Pair writes them to a
//     device scratch the wrapper allocates and fetches each window's two
//     entries (288 bytes a point) into shared memory with cp.async while
//     the window before runs (two buffers), so no table read stands in the
//     chain. The formulas read the second operand's coordinates from shared
//     memory where they use them, and every select is a lop3 in asm
//     (fp_chain.cuh:pick), which keeps every value in registers: no local
//     memory and no spills (ptxas, PERF.md).
//   - Each layout has its own __launch_bounds__ (GlvLaunch).
//   - The formulas, the table build, the launch bounds and the choice of
//     form live in csrc/g1_team.cuh, shared with K13 (csrc/g1_win.cu).
//
// C interface (loaded with ctypes): zk_g1_glv launches on the given stream
// and device and returns cudaGetLastError(); zk_g1_glv_scratch_words gives
// the scratch a launch needs.
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_team.cuh"

namespace {

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
__device__ uint32_t GLV_BETA_MONT[NW] = {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u,
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

// The split scalar of each point of a block, in shared memory for the walk
// (registers are the scarce resource): s1 in words 0..4 (word 4 is 0), s2 in
// words 5..9.
constexpr int SPLIT_WORDS = 10;

// 4-bit window w of s1 (t = 0) or s2 (t = 1), for w < 33
__device__ __forceinline__ int window(const uint32_t* split, int t, int w) {
  return (int)((split[t * 5 + (w >> 3)] >> (4 * (w & 7))) & 15u);
}

constexpr int64_t TABLE_WORDS = 2 * GLV_ENTRIES * ENTRY_WORDS;  // a point's two tables

// out[i] = scalar_i * p[i] by GLV. A block is one warp of PTS = 32 /
// T::POINT_LANES points; the lanes of its points past n mirror point n - 1
// and store nothing. TABLES: SHARED keeps the warp's tables in dynamic
// shared memory (PTS * 4608 bytes); FETCHED writes them to table (n rows of
// TABLE_WORDS) and fetches each window's entries into ring ahead of use.
template <class T, int TABLES = GlvLaunch<T>::TABLES>
__global__ void __launch_bounds__(32, GlvLaunch<T>::MIN_BLOCKS)
    g1_glv_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py, const uint32_t* __restrict__ pz,
                  int64_t p_stride, const uint32_t* __restrict__ sc, uint32_t* table, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  constexpr int PTS = 32 / T::POINT_LANES;
  extern __shared__ uint4 tables_smem[];  // SHARED: [PTS][TABLE_WORDS]
  __shared__ uint32_t splits[PTS][SPLIT_WORDS];
  // FETCHED: [window parity][PTS][table][entry]
  __shared__ uint4 ring[TABLES == FETCHED ? 2 * PTS * 2 * ENTRY_VECS : 1];
  using G = Glv<T>;
  const int lane = threadIdx.x;
  const int pt = lane / T::POINT_LANES;
  const int role = lane % T::POINT_LANES;
  const int64_t i = (int64_t)blockIdx.x * PTS + pt;
  const bool live = i < n;
  const int64_t src = live ? i : n - 1;
  const T tm(lane);

  int start;  // the warp's highest nonzero window, -1 for none
  const uint32_t* const split = splits[pt];
  {
    uint32_t s[8], s1[4], s2[5];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = __ldg(sc + src * 8 + k);
    glv_split(s, s1, s2);
    start = __reduce_max_sync(FULL, max(top_window(s1), top_window(s2)) + 1) - 1;
    if (role == 0) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        splits[pt][k] = k < 4 ? s1[k] : 0u;
        splits[pt][5 + k] = s2[k];
      }
    }
  }

  // the tables: this point's at tab (table t, entry k at tab + (t * 16 + k) * 36)
  uint32_t* tab = TABLES == SHARED ? reinterpret_cast<uint32_t*>(tables_smem) + pt * TABLE_WORDS
                                   : table + src * TABLE_WORDS;
  // t1, P's table, in the point's arithmetic (every lane holds it; lane 0
  // of the point writes it). t2, phi(P)'s, follows from t1 entry by entry,
  // with phi(P) = (beta x, y, z) and beta^3 = 1. JAX's double of (beta X,
  // Y, Z) is (beta X3, Y3, Z3) where (X3, Y3, Z3) doubles (X, Y, Z). Its
  // add-2007-bl of (beta^a X1, Y1, beta^b Z1) and (beta^c X2, Y2, beta^d Z2)
  // with e = a + 2d = c + 2b mod 3: U1 and U2, so H, carry beta^e; S1, S2,
  // R, J = H I and V = U1 I carry none, so neither do X3 and Y3; and Z3 =
  // 2 Z1 Z2 H carries beta^(b + d + e). So t2[2] = (beta X, Y, Z) of t1[2];
  // t2[3] = t2[2] + phi(P) (a = 1, b = 0, c = 1, d = 0: e = 1) is (X, Y,
  // beta Z) of t1[3]; and each t2[k] + phi(P) from there (a = 0, b = 1,
  // c = 1, d = 0: e = 0) is (X, Y, beta Z) of t1[k + 1]. This holds
  // wherever each of t1's adds from t1[3] on ran the generic formula (always
  // for a point of the order-r subgroup that is not the identity: kP is
  // never O or P there). A point of the warp where one did not (the
  // identity; points off the subgroup) gets t2 the long way.
  const bool writer = (TABLES == SHARED || live) && role == 0;
  uint32_t* const tab2 = tab + GLV_ENTRIES * ENTRY_WORDS;
  // B's copies for the adds: in Four the tables' own t[1]; in Pair the ring,
  // free until the walk
  uint32_t* const ring_pt = reinterpret_cast<uint32_t*>(ring + pt * 2 * ENTRY_VECS);
  uint32_t* const stash1 = TABLES == SHARED ? tab + ENTRY_WORDS : ring_pt;
  uint32_t* const stash2 = TABLES == SHARED ? tab2 + ENTRY_WORDS : ring_pt + ENTRY_WORDS;
  // (P lives in stash1 while t1 is built: registers are the scarce resource)
  bool derive;
  {
    const int64_t off = src * p_stride;
    Pt P;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      P.x.w[k] = __ldg(px + off + k);
      P.y.w[k] = __ldg(py + off + k);
      P.z.w[k] = __ldg(pz + off + k);
    }
    derive = build_table(tm, P, tab, stash1, role == 0, writer);
  }
  if constexpr (TABLES == FETCHED) __threadfence_block();
  __syncwarp();
  const Pt P = Shared{stash1}.pt();
  derive = derive && !T::zero(P.z);
  Fq beta;
#pragma unroll
  for (int k = 0; k < NW; ++k) beta.w[k] = GLV_BETA_MONT[k];
  const Fq bx = canon(mont_mul(P.x, beta));  // phi(P).x
  if (writer) {
    put_entry(tab2, Pt{});
    put_entry(tab2 + ENTRY_WORDS, Pt{bx, P.y, P.z});
  }
#pragma unroll 1
  for (int k = 2 + role; k < GLV_ENTRIES; k += T::POINT_LANES) {  // a product a lane
    const uint32_t* e = tab + k * ENTRY_WORDS;
    const uint32_t two = k == 2 ? FULL : 0u;
    const Fq x = get_fq(e), z = get_fq(e + 2 * NW);
    const Fq b = canon(mont_mul(pick(two, x, z), beta));
    if ((TABLES == SHARED || live) && derive)
      put_entry(tab2 + k * ENTRY_WORDS, Pt{pick(two, b, x), get_fq(e + NW), pick(two, z, b)});
  }
  if (__any_sync(FULL, !derive)) build_table(tm, Pt{bx, P.y, P.z}, tab2, stash2, role == 0, writer && !derive);
  if constexpr (TABLES == FETCHED) __threadfence_block();
  __syncwarp();

  // FETCHED (Pair): this lane fetches table `role`'s entry of window w into ring[w & 1]
  auto fetch = [&](int w) {
    const uint32_t* g = tab + (role * GLV_ENTRIES + window(split, role, w)) * ENTRY_WORDS;
    uint4* d = ring + (((w & 1) * PTS + pt) * 2 + role) * ENTRY_VECS;
#pragma unroll
    for (int q = 0; q < ENTRY_VECS; ++q) cp_async16(d + q, g + 4 * q);
  };
  if constexpr (TABLES == FETCHED) {
    if (start >= 0) fetch(start);
    cp_async_commit();
  }

  Pt out{};
#pragma unroll 1
  for (int w = start; w >= 0; --w) {
    const uint32_t *e0, *e1;  // the window's entries of t1 and t2
    if constexpr (TABLES == FETCHED) {
      __syncwarp();  // every lane is done with ring[(w - 1) & 1]'s last entries
      if (w > 0) fetch(w - 1);
      cp_async_commit();
      cp_async_wait<1>();  // window w's entries are in
      __syncwarp();        // and the other lane's too
      e0 = reinterpret_cast<const uint32_t*>(ring + ((w & 1) * PTS + pt) * 2 * ENTRY_VECS);
      e1 = e0 + ENTRY_WORDS;
    } else {
      e0 = tab + window(split, 0, w) * ENTRY_WORDS;
      e1 = tab + (GLV_ENTRIES + window(split, 1, w)) * ENTRY_WORDS;
    }
    if (w < start) {
#pragma unroll 1
      for (int j = 0; j < 4; ++j) out = G::dbl(tm, out);
    }
#pragma unroll 1
    for (int t = 0; t < 2; ++t) out = G::add(tm, out, Shared{t ? e1 : e0});
  }
  if constexpr (TABLES == FETCHED) cp_async_wait<0>();
  if (live && role == 0) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      ox[i * NW + k] = out.x.w[k];
      oy[i * NW + k] = out.y.w[k];
      oz[i * NW + k] = out.z.w[k];
    }
  }
}

template <class T>
cudaError_t launch_glv(const void* px, const void* py, const void* pz, long long p_stride, const void* scalars,
                       void* table, void* ox, void* oy, void* oz, long long n, void* stream) {
  constexpr long long PTS = 32 / T::POINT_LANES;
  const auto kernel = g1_glv_kernel<T>;
  const int smem = GlvLaunch<T>::TABLES == SHARED ? (int)(PTS * TABLE_WORDS * 4) : 0;
  if (smem) {  // the tables' shared memory, and the SM's carveout at its most shared
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)((n + PTS - 1) / PTS), 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, p_stride, (const uint32_t*)scalars,
      (uint32_t*)table, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return cudaSuccess;
}

}  // namespace

// Words of device scratch a launch of n points in this form needs on
// `device` (0: none; -1: a bad form or a failed device query).
extern "C" long long zk_g1_glv_scratch_words(int form, long long n, int device) {
  if (form < 0 || form > GLV_FORMS || glv_form(form, n, device) != cudaSuccess) return -1;
  return glv_scratch(form) ? n * TABLE_WORDS : 0;
}

// n >= 1 points (element stride p_stride words), a raw scalar each ((n, 8)
// words); table: zk_g1_glv_scratch_words(form, n, device) words of scratch
// (may be null where that is 0). Every form gives the same bits.
extern "C" int zk_g1_glv(int form, const void* px, const void* py, const void* pz, long long p_stride,
                         const void* scalars, void* table, void* ox, void* oy, void* oz, long long n, void* stream,
                         int device) {
  if (n < 1 || n > (1ll << 32) || form < 0 || form > GLV_FORMS) return (int)cudaErrorInvalidValue;
  const cudaError_t err = glv_form(form, n, device);
  if (err != cudaSuccess) return (int)err;
  if (glv_scratch(form) && table == nullptr) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    switch (form) {
      case 1: return launch_glv<Four>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
      default: return launch_glv<Pair>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
    }
  });
}
