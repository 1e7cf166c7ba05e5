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
// bytes take longer (2.9e-11 s vs 1.6e-11 s per element for K1), so all
// three are memory-bound; the design keeps each element in registers from
// load to store and moves nothing else.
//
// K3: the TPU kernel accumulates lazy digit columns across a grid that runs
// in order (pallas_fr.py:14-18). Hopper runs blocks in parallel, so each
// thread keeps a canonical running sum of mont(a_e * b_e) over a grid-stride
// loop, the block reduces its threads with modular adds, and a second launch
// reduces the per-block partials. Sum mont(a*b) mod p is the lazy sum's
// canonical value, so the result is unique and bit-identical.
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

// Modular sum of the block's per-thread values into sh[0]; all threads call.
__device__ void block_reduce(uint32_t (*sh)[NL], uint32_t* acc) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NL; ++i) sh[tid][i] = acc[i];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      uint32_t o[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) o[i] = sh[tid + s][i];
      mod_add<FrSpec>(acc, o, acc);
#pragma unroll
      for (int i = 0; i < NL; ++i) sh[tid][i] = acc[i];
    }
    __syncthreads();
  }
}

// a: (8, B, n) with limb stride sa0 and batch stride sa1; b likewise (sb1 = 0
// broadcasts one table over the batch). partials: (B, gridDim.x, 8).
__global__ void fr_dot_partial_kernel(const uint32_t* __restrict__ a, int64_t sa0, int64_t sa1,
                                      const uint32_t* __restrict__ b, int64_t sb0, int64_t sb1,
                                      int64_t n, uint32_t* __restrict__ partials) {
  __shared__ uint32_t sh[THREADS][NL];
  const int64_t batch = blockIdx.y;
  const uint32_t* ab = a + batch * sa1;
  const uint32_t* bb = b + batch * sb1;
  uint32_t acc[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) acc[i] = 0;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[NL], y[NL], r[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      x[i] = ab[i * sa0 + e];
      y[i] = bb[i * sb0 + e];
    }
    mont_mul<FrSpec>(x, y, r);
    mod_add<FrSpec>(acc, r, acc);
  }
  block_reduce(sh, acc);
  if (threadIdx.x == 0) {
    uint32_t* dst = partials + (batch * gridDim.x + blockIdx.x) * NL;
#pragma unroll
    for (int i = 0; i < NL; ++i) dst[i] = acc[i];
  }
}

// One block per batch entry: out (8, B) planar = sum of its G partials.
__global__ void fr_dot_finalize_kernel(const uint32_t* __restrict__ partials, int64_t G,
                                       int64_t B, uint32_t* __restrict__ out) {
  __shared__ uint32_t sh[THREADS][NL];
  const int64_t batch = blockIdx.x;
  uint32_t acc[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) acc[i] = 0;
  for (int64_t g = threadIdx.x; g < G; g += blockDim.x) {
    uint32_t o[NL];
    const uint32_t* src = partials + (batch * G + g) * NL;
#pragma unroll
    for (int i = 0; i < NL; ++i) o[i] = src[i];
    mod_add<FrSpec>(acc, o, acc);
  }
  block_reduce(sh, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i * B + batch] = acc[i];
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

// partials: scratch of B * G * 8 u32 (G = blocks per batch entry).
int zk_fr_dot(const void* a, long long sa0, long long sa1, const void* b, long long sb0,
              long long sb1, long long n, long long B, long long G, void* partials, void* out,
              void* stream) {
  dim3 grid((unsigned)G, (unsigned)B);
  fr_dot_partial_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, sa0, sa1, (const uint32_t*)b, sb0, sb1, n, (uint32_t*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fr_dot_finalize_kernel<<<(unsigned)B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partials, G, B, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
