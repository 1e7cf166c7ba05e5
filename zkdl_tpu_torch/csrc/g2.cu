// K11 and K12: BLS12-381 G2 (the twist over Fp2) scalar multiplication and
// point addition.
//
// g2_scalar_mul_kernel (K11) replaces zkdl_tpu/curve/g2.py:scalar_mul
// (:148-161, jitted at :164), an XLA loop on the TPU (no Pallas kernel):
// for each point P and raw scalar k, from acc = (0, 0, 0) over k's 256 bits
// from the lowest, acc = add(acc, P) where the bit is set, then P =
// double(P); the LSB-first double-and-add of G1's K5. g2_add_kernel (K12)
// replaces g2.py:add (:86-112), the step of g2_sum's tree (:167-188) and so
// of msm (:191): one add a pair, the pairs read at any stride (a tree
// level's halves p[0::2], p[1::2]). The formulas are csrc/jac.cuh's over
// Fp2, value for value the JAX ones, so the Jacobian limbs equal the JAX
// function's (the points need not lie in the r-torsion subgroup: none of
// this assumes it).
//
// What is skipped: the doubles of P past k's highest set bit (P is not read
// again). A set bit's add and a double run where the JAX loop selects
// them; the results are the same limbs.
//
// What bounds it on an H100: the 32-bit multiply-adds of the Fp products,
// an Fp2 product 3 and a squaring 2 of them, a double 16, a generic add
// 43 (chip_smoke.py's g2_bound), against 288 bytes a point in and out and
// 32 a scalar. The design, simple first: one thread a point, its two
// points (144 words) and the formulas' temporaries in registers and local
// memory (a formula is one non-inlined call, csrc/jac.cuh); K8's
// carry-chain Fp product (csrc/fp_chain.cuh), lazy values below 2p inside a
// formula, every stored or compared value reduced.
//
// C interface (loaded with ctypes): points are (n, 72) uint32 words, x.c0,
// x.c1, y.c0, y.c1, z.c0, z.c1 (12 each, Montgomery); each function launches
// on the given stream and device and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "jac.cuh"

namespace {

constexpr int PW = 6 * NW;  // words of a point
constexpr int THREADS = 128;

using G2 = Jac<F2>;

__device__ __forceinline__ Fq load_fq(const uint32_t* p) {
  Fq f;
#pragma unroll
  for (int k = 0; k < NW; ++k) f.w[k] = p[k];
  return f;
}

__device__ __forceinline__ void store_fq(uint32_t* p, const Fq& f) {
#pragma unroll
  for (int k = 0; k < NW; ++k) p[k] = f.w[k];
}

__device__ __forceinline__ G2 load_point(const uint32_t* p) {
  return {{load_fq(p), load_fq(p + NW)}, {load_fq(p + 2 * NW), load_fq(p + 3 * NW)},
          {load_fq(p + 4 * NW), load_fq(p + 5 * NW)}};
}

__device__ __forceinline__ void store_point(uint32_t* p, const G2& v) {
  store_fq(p, v.x.c0);
  store_fq(p + NW, v.x.c1);
  store_fq(p + 2 * NW, v.y.c0);
  store_fq(p + 3 * NW, v.y.c1);
  store_fq(p + 4 * NW, v.z.c0);
  store_fq(p + 5 * NW, v.z.c1);
}

__global__ void __launch_bounds__(THREADS) g2_scalar_mul_kernel(const uint32_t* __restrict__ pts,
                                                                const uint32_t* __restrict__ scalars,
                                                                long long scalar_stride, uint32_t* __restrict__ out,
                                                                long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t k[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) k[w] = scalars[i * scalar_stride + w];
  int top = -1;
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (k[w]) top = 32 * w + 31 - __clz(k[w]);
  G2 base = load_point(pts + i * PW);
  G2 acc;
  acc.x.c0 = acc.x.c1 = acc.y.c0 = acc.y.c1 = acc.z.c0 = acc.z.c1 = Fq{};
  for (int b = 0; b <= top; ++b) {
    if ((k[b >> 5] >> (b & 31)) & 1u) acc = jac_add<F2>(acc, base);
    if (b < top) base = jac_double<F2>(base);
  }
  store_point(out + i * PW, acc);
}

__global__ void __launch_bounds__(THREADS) g2_add_kernel(const uint32_t* __restrict__ p, long long sp,
                                                         const uint32_t* __restrict__ q, long long sq,
                                                         uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(out + i * PW, jac_add<F2>(load_point(p + i * sp), load_point(q + i * sq)));
}

int finish(int prev) {
  const cudaError_t e = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)e;
}

int enter(int device, int* prev) {
  cudaError_t e = cudaGetDevice(prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  return (int)e;
}

}  // namespace

extern "C" {

// out[i] = k_i P_i; scalars (n, 8) raw uint32 (scalar_stride 8) or one (8,)
// for all (scalar_stride 0).
int zk_g2_scalar_mul(const void* pts, const void* scalars, long long scalar_stride, void* out, long long n, void* stream,
                     int device) {
  if (n <= 0) return 0;
  int prev = 0;
  const int rc = enter(device, &prev);
  if (rc) return rc;
  g2_scalar_mul_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)scalars, scalar_stride, (uint32_t*)out, n);
  return finish(prev);
}

// out[i] = add(p[i], q[i]); point i of p at p + i sp words (72 for a
// contiguous vector, 144 for a tree level's halves), of q at q + i sq.
int zk_g2_add(const void* p, long long sp, const void* q, long long sq, void* out, long long n, void* stream,
              int device) {
  if (n <= 0) return 0;
  int prev = 0;
  const int rc = enter(device, &prev);
  if (rc) return rc;
  g2_add_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, sp, (const uint32_t*)q, sq, (uint32_t*)out, n);
  return finish(prev);
}

}  // extern "C"
