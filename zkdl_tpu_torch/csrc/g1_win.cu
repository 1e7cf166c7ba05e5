// K13: BLS12-381 G1 scalar multiplication by fixed 4-bit windows.
//
// g1_windowed_kernel replaces zkdl_tpu/curve/g1.py:scalar_mul_windowed
// (:187-214), an XLA loop on the TPU (no Pallas kernel): for each point P
// and raw scalar k, a table t[0] = (0, 0, 0), t[1] = P, t[j] = add(t[j - 1],
// P) for j < 16 (so t[2] = add(P, P) doubles), then from out = (0, 0, 0)
// over k's 64 windows from the top: four doubles, out = add(out,
// t[digit]). The formulas are g1.py's (csrc/g1_team.cuh, K8's), value for
// value, so the Jacobian limbs equal the JAX function's, identities with
// nonzero limbs included (a double returns them as they are, an add of one
// returns the other operand).
//
// What is skipped: the windows above a warp's highest nonzero window (the
// walk doubles (0, 0, 0) and adds t[0] = (0, 0, 0) there, leaving the
// limbs), the top window's doubles (out is still (0, 0, 0) for every point
// of the warp), and, where every scalar of a warp is 0, the table and the
// walk: the result is (0, 0, 0).
//
// What bounds it on an H100: the 32-bit multiply-adds of its Fp products
// (the table's double and 13 adds, 4 doubles a window below the top one and
// an add a nonzero digit after the first: chip_smoke.py's windowed_bound),
// against 288 bytes a point and 32 a scalar. In practice, as for K8
// (csrc/g1_glv.cu): one warp's chain of product rounds for launches of
// fewer warps than four an SM, the schedulers' issue for larger ones.
//
// The design is K8's with one table and no split: a point's
// products run on a team of lanes (csrc/fp_chain.cuh's layouts, every value
// of the point on each of its lanes), a double in 3 or 4 rounds and an add
// in 5 or 8 (g1_team.cuh's dbl_gen / add_gen); the table is built in the
// layout's arithmetic (g1_team.cuh:build_table). Four keeps the warp's
// eight tables in dynamic shared memory (8 x 16 entries x 144 bytes =
// 18,432 bytes a one-warp block); Pair writes them to a device scratch the
// wrapper allocates (2304 bytes a point) and fetches each window's entry
// into shared memory with cp.async while the window before runs (the
// digits are known in advance), so no table read stands in the chain. The
// scalars sit in shared memory; every select is a lop3 (fp_chain.cuh:pick):
// no local memory and no spills (ptxas, PERF.md). zk_g1_windowed picks the
// form by the launch and the card's SM count (g1_team.cuh:glv_form).
//
// C interface (loaded with ctypes): points are three (n, 12) uint32
// coordinate arrays at a common element stride (words), scalars (n, 8) raw;
// zk_g1_windowed launches on the given stream and device and returns
// cudaGetLastError(); zk_g1_windowed_scratch_words gives the scratch a
// launch needs.
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_team.cuh"

namespace {

constexpr int64_t WIN_TABLE_WORDS = GLV_ENTRIES * ENTRY_WORDS;  // a point's table

// 4-bit window w < 64 of the raw scalar k (8 words)
__device__ __forceinline__ int digit(const uint32_t* k, int w) { return (int)((k[w >> 3] >> (4 * (w & 7))) & 15u); }

// out[i] = scalar_i * p[i] by fixed 4-bit windows. A block is one warp of
// PTS = 32 / T::POINT_LANES points; the lanes of its points past n mirror
// point n - 1 and store nothing. TABLES: SHARED keeps the warp's tables in
// dynamic shared memory (PTS * 2304 bytes); FETCHED writes them to table (n
// rows of WIN_TABLE_WORDS) and fetches each window's entry into ring ahead
// of use.
template <class T, int TABLES = GlvLaunch<T>::TABLES>
__global__ void __launch_bounds__(32, GlvLaunch<T>::MIN_BLOCKS)
    g1_windowed_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                       const uint32_t* __restrict__ pz, int64_t p_stride, const uint32_t* __restrict__ sc,
                       uint32_t* table, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                       uint32_t* __restrict__ oz, int64_t n) {
  constexpr int PTS = 32 / T::POINT_LANES;
  extern __shared__ uint4 tables_smem[];  // SHARED: [PTS][WIN_TABLE_WORDS]
  __shared__ uint32_t scal[PTS][8];
  // FETCHED: [window parity][PTS][entry]
  __shared__ uint4 ring[TABLES == FETCHED ? 2 * PTS * ENTRY_VECS : 1];
  using G = Glv<T>;
  const int lane = threadIdx.x;
  const int pt = lane / T::POINT_LANES;
  const int role = lane % T::POINT_LANES;
  const int64_t i = (int64_t)blockIdx.x * PTS + pt;
  const bool live = i < n;
  const int64_t src = live ? i : n - 1;
  const T tm(lane);

  int start;  // the warp's highest nonzero window, -1 for none
  const uint32_t* const k = scal[pt];
  {
    uint32_t s[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w] = __ldg(sc + src * 8 + w);
    start = __reduce_max_sync(FULL, top_window(s) + 1) - 1;
    if (role == 0) {
#pragma unroll
      for (int w = 0; w < 8; ++w) scal[pt][w] = s[w];
    }
  }

  Pt out{};
  if (start >= 0) {  // (warp-uniform)
    // this point's table: entry j at tab + j * ENTRY_WORDS
    uint32_t* const tab = TABLES == SHARED ? reinterpret_cast<uint32_t*>(tables_smem) + pt * WIN_TABLE_WORDS
                                           : table + src * WIN_TABLE_WORDS;
    // P's copy for the adds: in Four the table's own t[1]; in Pair the ring,
    // free until the walk
    uint32_t* const stash =
        TABLES == SHARED ? tab + ENTRY_WORDS : reinterpret_cast<uint32_t*>(ring + pt * ENTRY_VECS);
    {
      const int64_t off = src * p_stride;
      Pt P;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        P.x.w[w] = __ldg(px + off + w);
        P.y.w[w] = __ldg(py + off + w);
        P.z.w[w] = __ldg(pz + off + w);
      }
      build_table(tm, P, tab, stash, role == 0, (TABLES == SHARED || live) && role == 0);
    }
    if constexpr (TABLES == FETCHED) __threadfence_block();
    __syncwarp();

    // FETCHED (Pair): the point's first lane fetches window w's entry into ring[w & 1]
    auto fetch = [&](int w) {
      if (role == 0) {
        const uint32_t* g = tab + digit(k, w) * ENTRY_WORDS;
        uint4* d = ring + ((w & 1) * PTS + pt) * ENTRY_VECS;
#pragma unroll
        for (int q = 0; q < ENTRY_VECS; ++q) cp_async16(d + q, g + 4 * q);
      }
    };
    if constexpr (TABLES == FETCHED) {
      fetch(start);
      cp_async_commit();
    }

#pragma unroll 1
    for (int w = start; w >= 0; --w) {
      const uint32_t* e;  // the window's entry
      if constexpr (TABLES == FETCHED) {
        __syncwarp();  // every lane is done with ring[(w - 1) & 1]'s last entry
        if (w > 0) fetch(w - 1);
        cp_async_commit();
        cp_async_wait<1>();  // window w's entry is in
        __syncwarp();        // for every lane of the point
        e = reinterpret_cast<const uint32_t*>(ring + ((w & 1) * PTS + pt) * ENTRY_VECS);
      } else {
        e = tab + digit(k, w) * ENTRY_WORDS;
      }
      if (w < start) {
#pragma unroll 1
        for (int j = 0; j < 4; ++j) out = G::dbl(tm, out);
      }
      out = G::add(tm, out, Shared{e});
    }
    if constexpr (TABLES == FETCHED) cp_async_wait<0>();
  }
  if (live && role == 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      ox[i * NW + w] = out.x.w[w];
      oy[i * NW + w] = out.y.w[w];
      oz[i * NW + w] = out.z.w[w];
    }
  }
}

template <class T>
cudaError_t launch_windowed(const void* px, const void* py, const void* pz, long long p_stride, const void* scalars,
                            void* table, void* ox, void* oy, void* oz, long long n, void* stream) {
  constexpr long long PTS = 32 / T::POINT_LANES;
  const auto kernel = g1_windowed_kernel<T>;
  const int smem = GlvLaunch<T>::TABLES == SHARED ? (int)(PTS * WIN_TABLE_WORDS * 4) : 0;
  if (smem) {  // the SM's carveout at its most shared
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
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
extern "C" long long zk_g1_windowed_scratch_words(int form, long long n, int device) {
  if (form < 0 || form > GLV_FORMS || glv_form(form, n, device) != cudaSuccess) return -1;
  return glv_scratch(form) ? n * WIN_TABLE_WORDS : 0;
}

// n >= 1 points (element stride p_stride words), a raw scalar each ((n, 8)
// words); table: zk_g1_windowed_scratch_words(form, n, device) words of
// scratch (may be null where that is 0). Every form gives the same bits.
extern "C" int zk_g1_windowed(int form, const void* px, const void* py, const void* pz, long long p_stride,
                              const void* scalars, void* table, void* ox, void* oy, void* oz, long long n,
                              void* stream, int device) {
  if (n < 1 || n > (1ll << 32) || form < 0 || form > GLV_FORMS) return (int)cudaErrorInvalidValue;
  const cudaError_t err = glv_form(form, n, device);
  if (err != cudaSuccess) return (int)err;
  if (glv_scratch(form) && table == nullptr) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    switch (form) {
      case 1: return launch_windowed<Four>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
      default: return launch_windowed<Pair>(px, py, pz, p_stride, scalars, table, ox, oy, oz, n, stream);
    }
  });
}
