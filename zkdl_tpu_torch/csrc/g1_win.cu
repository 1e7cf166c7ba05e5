// K13: BLS12-381 G1 scalar multiplication by fixed 4-bit windows.
//
// g1_windowed_kernel replaces zkdl_tpu/curve/g1.py:scalar_mul_windowed
// (:187-214), an XLA loop on the TPU (no Pallas kernel): for each point P
// and raw scalar k, a table t[0] = (0, 0, 0), t[1] = P, t[j] = add(t[j - 1],
// P) for j < 16 (so t[2] = add(P, P) doubles), then from out = (0, 0, 0)
// over k's 64 windows from the top: four doubles, out = add(out,
// t[digit]). The formulas are csrc/jac.cuh's over Fp, value for value
// g1.py's, so the Jacobian limbs equal the JAX function's, identities with
// nonzero limbs included (a double returns them as they are, an add of one
// returns the other operand).
//
// What is skipped: the windows above k's highest nonzero window (the walk
// doubles (0, 0, 0) and adds t[0] = (0, 0, 0) there, leaving the limbs),
// and, for k = 0, everything: the result is (0, 0, 0).
//
// What bounds it on an H100: the 32-bit multiply-adds of its Fp products
// (the table's double and 13 adds, 4 doubles a window below the top one and
// an add a nonzero digit after the first: chip_smoke.py's windowed_bound),
// against 288 bytes a point and 32 a scalar. The design, simple first: one
// thread a point, its 16-entry table (2304 bytes) in local memory, K8's
// carry-chain Fp product (csrc/fp_chain.cuh) with lazy values inside a
// formula.
//
// C interface (loaded with ctypes): points are three (n, 12) uint32
// coordinate arrays at a common element stride (words), scalars (n, 8) raw;
// zk_g1_windowed launches on the given stream and device and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "jac.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ENTRIES = 16;

using G1 = Jac<F1>;

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

__global__ void __launch_bounds__(THREADS) g1_windowed_kernel(const uint32_t* __restrict__ px,
                                                              const uint32_t* __restrict__ py,
                                                              const uint32_t* __restrict__ pz, long long stride,
                                                              const uint32_t* __restrict__ scalars,
                                                              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                                              uint32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t k[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) k[w] = scalars[i * 8 + w];
  int top = -1;  // the highest nonzero 4-bit window
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (k[w]) top = 8 * w + (31 - __clz(k[w])) / 4;
  G1 out{Fq{}, Fq{}, Fq{}};
  if (top >= 0) {
    G1 table[ENTRIES];
    table[0] = out;
    table[1] = {load_fq(px + i * stride), load_fq(py + i * stride), load_fq(pz + i * stride)};
    for (int j = 2; j < ENTRIES; ++j) table[j] = jac_add<F1>(table[j - 1], table[1]);
    for (int win = top; win >= 0; --win) {
      if (win < top)
        for (int d = 0; d < 4; ++d) out = jac_double<F1>(out);
      out = jac_add<F1>(out, table[(k[win >> 3] >> (4 * (win & 7))) & 15u]);
    }
  }
  store_fq(ox + i * 12, out.x);
  store_fq(oy + i * 12, out.y);
  store_fq(oz + i * 12, out.z);
}

}  // namespace

extern "C" {

int zk_g1_windowed(const void* px, const void* py, const void* pz, long long stride, const void* scalars, void* ox,
                   void* oy, void* oz, long long n, void* stream, int device) {
  if (n <= 0) return 0;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  g1_windowed_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, stride, (const uint32_t*)scalars, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  e = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
