// K7: batched inversion over Fr, Montgomery in and out.
//
// Replaces zkdl_tpu/sumcheck/lookup.py:batch_inverse (:55-80), an XLA
// associative_scan of fr.mul (prefix products, and suffix products of the
// reversed tensor), one Fermat power of the total (fr.pow_static) and two
// elementwise products. No Pallas kernel: it was XLA on the TPU. The logUp
// lookup prover (lookup.py:_lookup_core :123-124) runs it twice per lookup,
// on the witness side (a + z) and the table side (t + z).
//
// What it computes is fixed: out_i = x_i^-1 in canonical Montgomery form
// (x_i^(p-2) R mod p), one correct value whatever the algorithm. A zero
// input makes the product of all inputs zero and, as in the JAX function
// (whose inverse of the total is then pow(0) = 0), every output zero.
//
// Design: Montgomery's trick over chunks instead of a scan. Launch 1
// (fr_inv_up): thread t runs a serial prefix product over its chunk of
// consecutive elements, keeps the prefixes in out (scratch until launch 2)
// and writes the chunk's product tot[t]. The last block to finish (an
// atomic ticket, as K3's multi-block finish) takes every tot[t]: its
// threads each own a run of chunk products (serial prefixes lp), a block
// scan forward and backward over the runs' products, one thread raises the
// grand product to p - 2 (255 squarings and the products of its set bits),
// and each thread walks its run back to hand every chunk the inverse of its
// product, tinv[t]. Launch 2 (fr_inv_down): thread t walks its chunk back,
// out_i = prefix_(i-1) * inv(prefix_i), inv(prefix_(i-1)) = inv(prefix_i) * x_i.
//
// What bounds it on an H100: not bytes (64 B an element, 1 MB at the
// lookup's 16,384 entries: 0.3 us at 3.35 TB/s) nor the multiply rate (about
// 3 products an element), but the chain of dependent products of one thread:
// the chunk walks (2 * CHUNK products up and back), the scans and above all
// the Fermat power, about 380 dependent products in one thread. A simple
// kernel that is right first; its time against the bound is in PERF.md.
//
// C interface (loaded with ctypes): zk_fr_batch_inverse launches both
// kernels on the given stream and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FrSpec::N;
constexpr int THREADS = 256;  // a block; the last block's threads run the middle step
constexpr int64_t TARGET_CHUNKS = 2048;  // chunks a launch aims at: 8 per thread of the middle step

// R mod p (Montgomery one) and p - 2, little-endian words.
__constant__ uint32_t ONE_MONT[NL] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                                      0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
__constant__ uint32_t P_MINUS_2[NL] = {0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
                                       0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

__device__ __forceinline__ void load(const uint32_t* src, int64_t i, uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = src[i * NL + k];
}

__device__ __forceinline__ void load_cg(const uint32_t* src, int64_t i, uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = __ldcg(src + i * NL + k);
}

__device__ __forceinline__ void store(uint32_t* dst, int64_t i, const uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) dst[i * NL + k] = v[k];
}

__device__ __forceinline__ void set_one(uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = ONE_MONT[k];
}

__device__ __forceinline__ void copy(const uint32_t* a, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = a[k];
}

__device__ __forceinline__ void mul(const uint32_t* a, const uint32_t* b, uint32_t* r) { mont_mul<FrSpec>(a, b, r); }

// r = a^(p-2) (Montgomery), left to right over the exponent's bits.
__device__ void fermat(const uint32_t* a, uint32_t* r) {
  uint32_t acc[NL];
  set_one(acc);
#pragma unroll 1
  for (int b = 255; b >= 0; --b) {
    mul(acc, acc, acc);
    if ((P_MINUS_2[b >> 5] >> (b & 31)) & 1u) mul(acc, a, acc);
  }
  copy(acc, r);
}

__device__ __forceinline__ void chunk_range(int64_t t, int64_t n, int64_t chunk, int64_t& s, int64_t& e) {
  s = t * chunk;
  e = s + chunk < n ? s + chunk : n;
}

// The middle step, on the last block: tinv[t] = (product of chunk t)^-1 for
// every t < T, from tot; lp is scratch of T elements.
__device__ void middle(const uint32_t* tot, uint32_t* lp, uint32_t* tinv, int64_t T) {
  __shared__ uint32_t fwd[2][THREADS][NL];
  __shared__ uint32_t bwd[2][THREADS][NL];
  __shared__ uint32_t inv_total[NL];
  const int j = threadIdx.x;
  const int64_t per = (T + THREADS - 1) / THREADS;
  const int64_t s = j * per, e = s + per < T ? s + per : T;
  uint32_t acc[NL], v[NL];
  set_one(acc);
  for (int64_t t = s; t < e; ++t) {  // the run's prefixes lp
    load_cg(tot, t, v);
    mul(acc, v, acc);
    store(lp, t, acc);
  }
  // inclusive scans of the runs' products, forward (P_j) and backward (Q_j)
#pragma unroll
  for (int k = 0; k < NL; ++k) fwd[0][j][k] = bwd[0][j][k] = acc[k];
  __syncthreads();
  int cur = 0;
#pragma unroll 1
  for (int d = 1; d < THREADS; d <<= 1) {
    uint32_t f[NL], b[NL];
    copy(fwd[cur][j], f);
    copy(bwd[cur][j], b);
    if (j >= d) mul(fwd[cur][j - d], f, f);
    if (j + d < THREADS) mul(b, bwd[cur][j + d], b);
    copy(f, fwd[cur ^ 1][j]);
    copy(b, bwd[cur ^ 1][j]);
    cur ^= 1;
    __syncthreads();
  }
  if (j == 0) fermat(fwd[cur][THREADS - 1], inv_total);
  __syncthreads();
  // inv(run j's product) = P_(j-1) * inv(P_j), inv(P_j) = inv(total) * Q_(j+1)
  uint32_t il[NL];
  copy(inv_total, il);
  if (j + 1 < THREADS) mul(il, bwd[cur][j + 1], il);
  if (j > 0) mul(il, fwd[cur][j - 1], il);
  // walk the run back: inv(tot_t) = lp_(t-1) * inv(lp_t), inv(lp_(t-1)) = inv(lp_t) * tot_t
  for (int64_t t = e - 1; t >= s; --t) {
    uint32_t r[NL];
    if (t > s) {
      load(lp, t - 1, v);
      mul(v, il, r);
    } else {
      copy(il, r);
    }
    store(tinv, t, r);
    load_cg(tot, t, v);
    mul(il, v, il);
  }
}

__global__ void __launch_bounds__(THREADS) fr_inv_up(const uint32_t* __restrict__ x, uint32_t* __restrict__ pre,
                                                     uint32_t* tot, uint32_t* lp, uint32_t* tinv,
                                                     unsigned* counter, int64_t n, int64_t chunk, int64_t T) {
  __shared__ bool last;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t < T) {
    int64_t s, e;
    chunk_range(t, n, chunk, s, e);
    uint32_t acc[NL], v[NL];
    load(x, s, acc);
    store(pre, s, acc);
    for (int64_t i = s + 1; i < e; ++i) {
      load(x, i, v);
      mul(acc, v, acc);
      store(pre, i, acc);
    }
    store(tot, t, acc);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  middle(tot, lp, tinv, T);
  if (threadIdx.x == 0) *counter = 0;
}

__global__ void __launch_bounds__(THREADS) fr_inv_down(const uint32_t* __restrict__ x, uint32_t* pre_out,
                                                       const uint32_t* __restrict__ tinv, int64_t n,
                                                       int64_t chunk, int64_t T) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  int64_t s, e;
  chunk_range(t, n, chunk, s, e);
  uint32_t il[NL], v[NL], r[NL];
  load(tinv, t, il);  // inv(prefix_(e-1))
  for (int64_t i = e - 1; i > s; --i) {
    load(pre_out, i - 1, v);
    mul(v, il, r);
    load(x, i, v);
    mul(il, v, il);
    store(pre_out, i, r);  // prefix_i is read no more
  }
  store(pre_out, s, il);
}

}  // namespace

extern "C" {

// out[i] = x[i]^-1 for n >= 1 Montgomery (n, 8) rows; scratch holds
// 3 * T * 8 words and counter one zero word (left at zero), T the chunk count
// (zk_fr_batch_inverse_chunks). Launches on `device`, restoring the caller's.
long long zk_fr_batch_inverse_chunks(long long n) {
  const long long chunk = (n + TARGET_CHUNKS - 1) / TARGET_CHUNKS;
  return (n + chunk - 1) / chunk;
}

int zk_fr_batch_inverse(const void* x, void* out, void* scratch, void* counter, long long n, void* stream,
                        int device) {
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long chunk = (n + TARGET_CHUNKS - 1) / TARGET_CHUNKS;
  const long long T = (n + chunk - 1) / chunk;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  uint32_t* tot = (uint32_t*)scratch;
  uint32_t* lp = tot + T * NL;
  uint32_t* tinv = lp + T * NL;
  const unsigned blocks = (unsigned)((T + THREADS - 1) / THREADS);
  fr_inv_up<<<blocks, THREADS, 0, (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, tot, lp, tinv,
                                                           (unsigned*)counter, n, chunk, T);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    fr_inv_down<<<blocks, THREADS, 0, (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, tinv, n,
                                                               chunk, T);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
