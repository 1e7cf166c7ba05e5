// K9: the canonical reduction of cross-rank Fr sums (the B17 collective).
//
// Replaces the XLA code of zkdl_tpu/parallel/collectives.py:35-58
// (reduce_mod_p, psum_fr, fr_sum_local_then_psum). The JAX version splits
// each value into 16-bit digits so that psum keeps their carries, then
// carry-normalizes the digit sums and subtracts p 2^j, j = 7 ... 0, where it
// fits. The port keeps limbs in int64, so the all-reduce of the eight limbs
// of n ranks' canonical values is exact (each limb sum < n 2^32); this kernel
// takes those sums and writes the canonical value of their total S < n p:
// one thread a value, the eight sums carry-normalized into nine 32-bit words
// (S < 2^8 p < 2^264 for n <= 255 ranks), then the eight conditional
// subtractions of p 2^j. Fr values have one canonical form, so the output is
// bit-equal to a single-device modular sum and to reduce_mod_p o psum_fr.
//
// Bound on an H100: bytes (64 in and 32 out a value); ~100 integer
// instructions a value, far below the bytes' time at any width.
#include <cstdint>

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NL = 8;
constexpr int NW = NL + 1;  // nine words: S < 2^8 p
constexpr int MAX_SHIFT = 7;
constexpr int THREADS = 256;

__global__ void fr_collect_kernel(const long long* __restrict__ sums, uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t v = (uint64_t)sums[i * NL + k] + carry;  // < 2^40 + 2^9
    w[k] = (uint32_t)v;
    carry = v >> 32;
  }
  w[NL] = (uint32_t)carry;
#pragma unroll
  for (int j = MAX_SHIFT; j >= 0; --j) {
    // d = w - p 2^j over nine words; keep it where no borrow is left
    uint32_t d[NW];
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const uint32_t lo = k < NL ? FrSpec::p(k) << j : 0u;
      const uint32_t hi = (j == 0 || k == 0) ? 0u : FrSpec::p(k - 1) >> (32 - j);
      const uint64_t s = (uint64_t)w[k] - (lo | hi) - borrow;
      d[k] = (uint32_t)s;
      borrow = (uint32_t)(s >> 32) & 1u;
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = borrow ? w[k] : d[k];
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) out[i * NL + k] = w[k];
}

}  // namespace

extern "C" {

// sums: (n, 8) int64, each limb sum below 2^40; out: (n, 8) uint32. Launches
// on `device` and restores the current device after.
int zk_fr_collect(const void* sums, void* out, long long n, void* stream, int device) {
  if (n <= 0) return 0;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + THREADS - 1) / THREADS;
  fr_collect_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>((const long long*)sums,
                                                                            (uint32_t*)out, n);
  e = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
