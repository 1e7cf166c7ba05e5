// K10: the radix-2 NTT over Fr.
//
// Replaces zkdl_tpu/tensor/fft.py:_ntt_core (:71-85), an XLA loop on the TPU
// (no Pallas kernel): a (n, 8) Montgomery tensor, n = 2^log_n, is permuted
// by bit reversal, then stage s = 1 .. log_n combines the pairs (lo, hi) of
// every block of m = 2^s as (lo + hi w_s^j, lo - hi w_s^j), j < m/2, w_s the
// primitive 2^s-th root (or its inverse); the inverse transform ends with a
// product by n^-1 R mod p. Fr values have one reduced form (field.cuh's
// product and sums return values below p), so the output is bit-equal to
// the JAX function whatever the order of the work.
//
// Twiddles: w_s^j = W[j 2^(log_n - s)] with W[k] = w^k, k < n/2, w the
// 2^log_n-th root, so one table of n/2 values (built once per size and
// direction by the wrapper, tensor/fft.py) serves every stage.
//
// What bounds it on an H100: the Fr products, log_n n/2 of them (264 32-bit
// multiply-adds each), against the bytes (the input, the output and the
// table, once); chip_smoke.py's ntt_bound. The design, simple first:
//   - ntt_local: a block takes 2^L consecutive outputs (L = min(10,
//     log_n): 1024 values, 32 KB of shared memory), gathers their
//     bit-reversed inputs, and runs stages 1 .. L in shared memory (the
//     pairs of those stages never leave a block), one butterfly a thread a
//     stage;
//   - ntt_stage: one launch for each stage above L, one butterfly a thread,
//     in place in the output (memory-bound: each such stage reads and
//     writes the whole tensor);
//   - the inverse's product by n^-1 is folded into the last stage.
//
// C interface (loaded with ctypes): zk_fr_ntt launches the stages on the
// given stream and device and returns cudaGetLastError().
#include <cstdint>

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NL = 8;
constexpr int LOCAL_LOG = 10;  // 1024 values in shared memory
constexpr int LOCAL_THREADS = 512;
constexpr int STAGE_THREADS = 256;

struct Scale {
  uint32_t w[NL];
};

__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&v)[NL]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&v)[NL]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// (lo, hi) <- (lo + hi w, lo - hi w), each then times scale if do_scale
__device__ __forceinline__ void butterfly(uint32_t (&lo)[NL], uint32_t (&hi)[NL], const uint32_t (&w)[NL],
                                          bool do_scale, const Scale& scale) {
  uint32_t t[NL];
  mont_mul<FrSpec>(hi, w, t);
  mod_sub<FrSpec>(lo, t, hi);
  mod_add<FrSpec>(lo, t, lo);
  if (do_scale) {
    mont_mul<FrSpec>(lo, scale.w, lo);
    mont_mul<FrSpec>(hi, scale.w, hi);
  }
}

// Outputs [b 2^L, (b + 1) 2^L) from the bit-reversed inputs, stages 1 .. L.
__global__ void __launch_bounds__(LOCAL_THREADS) ntt_local(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                                           const uint32_t* __restrict__ tw, int log_n, int L,
                                                           int scale_last, Scale scale) {
  __shared__ __align__(16) uint32_t sh[(1 << LOCAL_LOG) * NL];
  const int chunk = 1 << L;
  const long long base = (long long)blockIdx.x << L;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const uint32_t idx = (uint32_t)(base + i);
    const uint32_t src = log_n == 0 ? 0u : __brev(idx) >> (32 - log_n);
    uint32_t v[NL];
    load(in + (size_t)src * NL, v);
    if (L == 0 && scale_last) mont_mul<FrSpec>(v, scale.w, v);  // n = 1: the inverse's product alone
    store(sh + i * NL, v);
  }
  __syncthreads();
  for (int s = 1; s <= L; ++s) {
    const int half = 1 << (s - 1);
    const bool do_scale = scale_last && s == L;
    for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
      const int j = t & (half - 1);
      const int lo = ((t >> (s - 1)) << s) + j;
      uint32_t a[NL], b[NL], w[NL];
      load(sh + lo * NL, a);
      load(sh + (lo + half) * NL, b);
      load(tw + ((size_t)j << (log_n - s)) * NL, w);
      butterfly(a, b, w, do_scale, scale);
      store(sh + lo * NL, a);
      store(sh + (lo + half) * NL, b);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    uint32_t v[NL];
    load(sh + i * NL, v);
    store(out + (size_t)(base + i) * NL, v);
  }
}

// Stage s > L, in place: one butterfly a thread.
__global__ void __launch_bounds__(STAGE_THREADS) ntt_stage(uint32_t* __restrict__ a, const uint32_t* __restrict__ tw,
                                                           int log_n, int s, int do_scale, Scale scale) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (1ll << (log_n - 1))) return;
  const long long half = 1ll << (s - 1);
  const long long j = t & (half - 1);
  const long long lo = ((t >> (s - 1)) << s) + j;
  uint32_t x[NL], y[NL], w[NL];
  load(a + lo * NL, x);
  load(a + (lo + half) * NL, y);
  load(tw + ((size_t)j << (log_n - s)) * NL, w);
  butterfly(x, y, w, do_scale != 0, scale);
  store(a + lo * NL, x);
  store(a + (lo + half) * NL, y);
}

}  // namespace

extern "C" {

// in, out: (2^log_n, 8) uint32, distinct; tw: (2^(log_n - 1), 8) W table
// (unused for log_n = 0); scale: 8 host words, n^-1 R mod p for the
// inverse (then inverse = 1). Launches on `device` and restores the
// current device after; *launched gets the number of kernels launched
// (1 + max(0, log_n - LOCAL_LOG)).
int zk_fr_ntt(const void* in, void* out, const void* tw, int log_n, int inverse, const uint32_t* scale, void* stream,
              int device, int* launched) {
  *launched = 0;
  if (log_n < 0 || log_n > 31) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Scale sc;
  for (int k = 0; k < NL; ++k) sc.w[k] = inverse ? scale[k] : 0u;
  const int L = log_n < LOCAL_LOG ? log_n : LOCAL_LOG;
  const long long n = 1ll << log_n;
  const int threads = L == 0 ? 1 : ((1 << (L - 1)) < LOCAL_THREADS ? (1 << (L - 1)) : LOCAL_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  ntt_local<<<(unsigned)(n >> L), threads, 0, st>>>((const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw, log_n, L,
                                                   inverse && L == log_n, sc);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  for (int s = L + 1; e == cudaSuccess && s <= log_n; ++s) {
    const long long pairs = n / 2;
    ntt_stage<<<(unsigned)((pairs + STAGE_THREADS - 1) / STAGE_THREADS), STAGE_THREADS, 0, st>>>(
        (uint32_t*)out, (const uint32_t*)tw, log_n, s, inverse && s == log_n, sc);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
