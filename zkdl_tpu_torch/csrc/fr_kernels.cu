// Planar Fr kernels for the prover hot path: K1 mul, K2 mul_scalar, K3 dot.
//
// Replace the Pallas TPU kernels of zkdl_tpu/field/pallas_fr.py:
//   K1 fr_mul        <- _mul_kernel (:156), wrapper mul (:253)
//   K2 fr_mul_scalar <- _mul_scalar_kernel (:163), wrapper mul_scalar (:275)
//   K3 fr_dot        <- _dot_cols_kernel (:186) + finalize_cols (:315),
//                       wrappers dot / dot_many (:340-352)
//
// Layout: planar uint32 (8, n): limb i of element e at a[i * stride + e], so
// thread e's eight limb loads are each coalesced across the warp.
//
// What bounds them on an H100: K1 reads 64 B and writes 32 B per element, K3
// reads 64 B; one CIOS product is 128 32x32->64 multiply-adds (+8 low
// products), ~264 IMAD instructions. At 3.35 TB/s and ~16.7e12 IMAD/s the
// bytes take longer (2.9e-11 s vs 1.6e-11 s per element for K1), so K1 and
// K2 are memory-bound; the design keeps each element in registers from load
// to store and moves nothing else.
//
// K3 is lazy, the Hopper counterpart of the TPU's digit columns
// (pallas_fr.py:186-223, finalize_cols :315-337). Sum mont(a_e * b_e) mod p
// = T * R^-1 mod p with T = sum a_e * b_e, so each thread adds the raw
// 512-bit products into a wide accumulator (an 8x8 schoolbook of 64 wide
// multiply-adds with carry, no reduction per element) and reduces once at
// the end: for T = L + H 2^256 + C 2^512,
//   T R^-1 = REDC(L) + H + C R  (mod p),
// with H < 2^256 < 3p brought below p by two conditional subtracts and
// C R = mont(C, R^2). The threads' canonical results are summed with warp
// shuffles and one shared-memory step. A (pair, batch) slot spread over
// several blocks is finished in the same launch by the last of its blocks to
// arrive (a per-slot counter); a slot of one block writes its result
// directly. Sum mont(a*b) mod p has one canonical value, so the result is
// bit-identical to the JAX package's whatever the order of the additions.
//
// C interface (loaded with ctypes): every entry point launches on the given
// stream and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FrSpec::N;
constexpr int THREADS = 256;

struct Fr8 {
  uint32_t v[NL];
};

__global__ void fr_mul_kernel(const uint32_t* __restrict__ a, int64_t sa,
                              const uint32_t* __restrict__ b, int64_t sb,
                              uint32_t* __restrict__ out, int64_t n) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[NL], y[NL], r[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      x[i] = a[i * sa + e];
      y[i] = b[i * sb + e];
    }
    mont_mul<FrSpec>(x, y, r);
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i * n + e] = r[i];
  }
}

__global__ void fr_mul_scalar_kernel(const uint32_t* __restrict__ a, int64_t sa, Fr8 s,
                                     uint32_t* __restrict__ out, int64_t n) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[NL], r[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) x[i] = a[i * sa + e];
    mont_mul<FrSpec>(x, s.v, r);
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i * n + e] = r[i];
  }
}

// ---------------------------------------------------------------------------
// K3 fr_dot
// ---------------------------------------------------------------------------

constexpr int DOT_MAX_PAIRS = 8;
constexpr int DOT_MAX_THREADS = 128;
// Six blocks of 128 threads per SM (at most 80 registers a thread) keep one
// wave of plan_dot's grid resident on 132 SMs.
constexpr int DOT_BLOCKS_PER_SM = 6;
// Accumulator bound: a product a_e * b_e of canonical operands is < p^2 <
// 2^510, and a thread adds at most 2^MAX_TERMS_LOG2 of them, so its sum is
// < 2^542 and fits ACC_WORDS 32-bit words (2^544). The planner
// (field/kernels.py:plan_dot) keeps every thread's count within it: at most
// 2 ceil(n / (2 G threads)) + 1 elements, two per step of the loop and one
// odd tail.
constexpr int MAX_TERMS_LOG2 = 32;
constexpr int ACC_WORDS = 17;

// R^2 mod p, for the lift of the accumulator's top word.
__device__ __forceinline__ uint32_t fr_r2(int i) {
  constexpr uint32_t R2[8] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                              0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
  return R2[i];
}

// w[0 .. 8] += (a0 + a1 2^64 + a2 2^128 + a3 2^192) * b: the four 64-bit
// products' lo:hi halves land on the word pairs (w[2k], w[2k+1]), so ptxas
// fuses each mad.lo.cc / madc.hi.cc pair into one wide multiply-add with
// carry (IMAD.WIDE.U32.X); the carry out goes into w[8]. The carry flag
// lives only inside this asm statement.
__device__ __forceinline__ void mad_row4(uint32_t* w, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b) {
  asm("mad.lo.cc.u32  %0, %9,  %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9,  %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8,  0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]), "+r"(w[6]),
        "+r"(w[7]), "+r"(w[8])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b));
}

// acc (ACC_WORDS words) += a * b, the full 512-bit product.
//
// Row r of the schoolbook splits into the products a_j b_r of even j and of
// odd j; each half is one mad_row4 chain over 8 words. The halves go to two
// arrays by the parity of the word pairs they write, E (pairs at 2m, 2m + 1)
// and O (pairs at 2m + 1, 2m + 2), so every pair keeps one register pair in
// every row (no moves) and the E and O chains of a row run independently:
//   row r even: even j -> E[r ..], odd j -> O[r + 1 ..]
//   row r odd:  even j -> O[r ..], odd j -> E[r + 1 ..]
// No carry is lost: each chain's carry word holds at most one earlier carry
// (no earlier chain ran through it), and E, O stay below a * b < 2^512.
// The carry chains of the final additions span consecutive asm statements:
// volatile keeps their order, and nothing between them writes the flag.
__device__ __forceinline__ void mul_acc(const uint32_t* a, const uint32_t* b, uint32_t* acc) {
  uint32_t E[2 * NL + 1], O[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) E[i] = O[i] = 0;
  E[2 * NL] = 0;
#pragma unroll
  for (int r = 0; r < NL; r += 2) {
    mad_row4(E + r, a[0], a[2], a[4], a[6], b[r]);
    mad_row4(O + r + 1, a[1], a[3], a[5], a[7], b[r]);
    mad_row4(O + r + 1, a[0], a[2], a[4], a[6], b[r + 1]);
    mad_row4(E + r + 2, a[1], a[3], a[5], a[7], b[r + 1]);
  }
  asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(acc[0]) : "r"(E[0]));
#pragma unroll
  for (int i = 1; i <= 2 * NL; ++i) asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(acc[i]) : "r"(E[i]));
  asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(acc[1]) : "r"(O[1]));
#pragma unroll
  for (int i = 2; i < 2 * NL; ++i) asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(acc[i]) : "r"(O[i]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(acc[2 * NL]));
}

// r = acc * R^-1 mod p, canonical: acc = L + H 2^256 + C 2^512 gives
// REDC(L) + H + C R.
__device__ __forceinline__ void reduce_acc(const uint32_t* acc, uint32_t* r) {
  uint32_t one[NL], c[NL], r2[NL], s0[NL], s1[NL], s2[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    one[i] = i == 0 ? 1u : 0u;
    c[i] = i == 0 ? acc[2 * NL] : 0u;
    r2[i] = fr_r2(i);
  }
  mont_mul<FrSpec>(acc, one, s0);  // L * 1 < R <= p R
  sub_p_if_gte<FrSpec>(acc + NL, 0u, s1);
  sub_p_if_gte<FrSpec>(s1, 0u, s1);  // H < 2^256 < 3p
  mont_mul<FrSpec>(c, r2, s2);       // C R^2 R^-1
  mod_add<FrSpec>(s0, s1, r);
  mod_add<FrSpec>(r, s2, r);
}

__device__ __forceinline__ void warp_sum(uint32_t* v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t o[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) o[i] = __shfl_down_sync(0xffffffffu, v[i], off);
    mod_add<FrSpec>(v, o, v);
  }
}

// Modular sum of the block's v into thread 0's v (blockDim.x a multiple of
// 32); every thread calls it.
__device__ __forceinline__ void block_sum(uint32_t* v, uint32_t (*sh)[NL]) {
  warp_sum(v);
  const int n_warps = blockDim.x >> 5;
  if (n_warps == 1) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NL; ++i) sh[warp][i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NL; ++i) v[i] = lane < n_warps ? sh[lane][i] : 0u;
    warp_sum(v);
  }
  __syncthreads();  // sh is free again
}

// One operand pair: a (8, B, n) with limb stride sa0 and batch stride sa1,
// b likewise (sb1 = 0: one table shared by the batch).
struct DotPair {
  const uint32_t* a;
  long long sa0, sa1;
  const uint32_t* b;
  long long sb0, sb1;
};

struct DotPairs {
  DotPair p[DOT_MAX_PAIRS];
};

// Slot s = pair * B + batch; out (8, slots) planar. Block x serves slot
// x % slots and share g = x / slots of its elements, so consecutive blocks
// serve different slots over the same element range: pairs that share an
// operand read it while it is in L2. With G > 1 blocks per slot, each block
// leaves its canonical partial in partials[slot * G + g] and the last block
// of the slot to arrive sums them; counters[slot] is 0 before and after.
__global__ void __launch_bounds__(DOT_MAX_THREADS, DOT_BLOCKS_PER_SM)
    fr_dot_kernel(DotPairs pairs, long long n, int B, int G, long long slots,
                  uint32_t* __restrict__ out, uint32_t* __restrict__ partials,
                  unsigned* __restrict__ counters) {
  __shared__ uint32_t sh[DOT_MAX_THREADS / 32][NL];
  __shared__ bool last;
  const long long slot = blockIdx.x % slots;
  const long long g = blockIdx.x / slots;
  const int pair = (int)(slot / B);
  const long long batch = slot - (long long)pair * B;
  DotPair op = pairs.p[0];
#pragma unroll
  for (int q = 1; q < DOT_MAX_PAIRS; ++q)
    if (q == pair) op = pairs.p[q];
  const uint32_t* a = op.a + batch * op.sa1;
  const uint32_t* b = op.b + batch * op.sb1;

  uint32_t acc[ACC_WORDS];
#pragma unroll
  for (int i = 0; i < ACC_WORDS; ++i) acc[i] = 0;
  // Elements two at a time with 8-byte loads when both operands allow it
  // (the same for every thread of the block); one at a time otherwise.
  const long long step = (long long)G * blockDim.x;
  const long long first = g * blockDim.x + threadIdx.x;
  uint32_t x[NL], y[NL];
  if (((((unsigned long long)a | (unsigned long long)b) & 7) | ((op.sa0 | op.sb0) & 1)) == 0) {
    for (long long e2 = first; e2 < n / 2; e2 += step) {
      uint2 x2[NL], y2[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        x2[i] = *reinterpret_cast<const uint2*>(a + i * op.sa0 + 2 * e2);
        y2[i] = *reinterpret_cast<const uint2*>(b + i * op.sb0 + 2 * e2);
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) x[i] = x2[i].x, y[i] = y2[i].x;
      mul_acc(x, y, acc);
#pragma unroll
      for (int i = 0; i < NL; ++i) x[i] = x2[i].y, y[i] = y2[i].y;
      mul_acc(x, y, acc);
    }
    if ((n & 1) && first == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) x[i] = a[i * op.sa0 + n - 1], y[i] = b[i * op.sb0 + n - 1];
      mul_acc(x, y, acc);
    }
  } else {
    for (long long e = first; e < n; e += step) {
#pragma unroll
      for (int i = 0; i < NL; ++i) x[i] = a[i * op.sa0 + e], y[i] = b[i * op.sb0 + e];
      mul_acc(x, y, acc);
    }
  }
  uint32_t v[NL];
  reduce_acc(acc, v);
  block_sum(v, sh);
  if (G == 1) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) out[i * slots + slot] = v[i];
    }
    return;
  }
  if (threadIdx.x == 0) {
    uint32_t* dst = partials + (slot * G + g) * NL;
#pragma unroll
    for (int i = 0; i < NL; ++i) dst[i] = v[i];
    __threadfence();  // the partial is visible before the counter moves
    last = atomicAdd(counters + slot, 1u) == (unsigned)(G - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the slot's last block: every partial is written; read them from L2
#pragma unroll
  for (int i = 0; i < NL; ++i) v[i] = 0;
  for (int q = threadIdx.x; q < G; q += blockDim.x) {
    const uint32_t* src = partials + (slot * G + q) * NL;
    uint32_t o[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) o[i] = __ldcg(src + i);
    mod_add<FrSpec>(v, o, v);
  }
  block_sum(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i * slots + slot] = v[i];
    counters[slot] = 0;
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;  // grid-stride loops cover the rest
  return (int)(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

int zk_fr_mul(const void* a, long long sa, const void* b, long long sb, void* out, long long n,
              void* stream) {
  fr_mul_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, sa, (const uint32_t*)b, sb, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// s_host: 8 u32 limbs in host memory, passed to the kernel by value.
int zk_fr_mul_scalar(const void* a, long long sa, const void* s_host, void* out, long long n,
                     void* stream) {
  Fr8 s;
  for (int i = 0; i < NL; ++i) s.v[i] = ((const uint32_t*)s_host)[i];
  fr_mul_scalar_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, sa, s, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// K3 over k pairs of (8, B, n) operands in one launch. args (int64): k, n, B,
// G (blocks per slot), threads, device, out (8, k * B), partials
// (k * B * G * 8 u32, used when G > 1), counters (k * B u32, zero), stream,
// then per pair a, sa0, sa1, b, sb0, sb1. Launches on `device` and restores
// the current device after.
int zk_fr_dot(const long long* args) {
  const int k = (int)args[0];
  const long long n = args[1];
  const int B = (int)args[2], G = (int)args[3], threads = (int)args[4], dev = (int)args[5];
  const long long slots = (long long)k * B;
  if (k < 1 || k > DOT_MAX_PAIRS || B < 1 || G < 1 || threads < 32 ||
      threads > DOT_MAX_THREADS || threads % 32 != 0 || slots * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DotPairs pairs = {};
  for (int q = 0; q < k; ++q) {
    const long long* p = args + 10 + 6 * q;
    pairs.p[q] = {(const uint32_t*)p[0], p[1], p[2], (const uint32_t*)p[3], p[4], p[5]};
  }
  int prev = dev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  fr_dot_kernel<<<(unsigned)(slots * G), threads, 0, (cudaStream_t)args[9]>>>(
      pairs, n, B, G, slots, (uint32_t*)args[6], (uint32_t*)args[7], (unsigned*)args[8]);
  err = cudaGetLastError();
  if (prev != dev) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
