// K5 and K6: variable-base BLS12-381 G1 arithmetic, one thread per point.
//
// K5, g1_scalar_mul_kernel, replaces zkdl_tpu/curve/g1.py:scalar_mul (:168-184),
// a lax.fori_loop over the 256 scalar bits, LSB first: out = bit ? add(out, acc)
// : out, then acc = double(acc). K6, g1_add_kernel, replaces g1.py:add
// (:106-132), the step of g1_sum (:413-430), of pedersen._commit_bits_rows
// (:659-671) and of me_step (:433-452). Both were XLA on the TPU (no Pallas
// kernel). The committed-aux tier runs them: every aux row commitment is a
// tree of K6 levels, the NUMS generators are cofactor-cleared by K5, and the
// verifier's generator MSM and row-commitment MLE are K5 and K6 launches.
//
// What they compute is fixed down to the limb: the aux commitments' Jacobian
// x/y/z are absorbed by the Fiat-Shamir transcript, so both follow g1.py
// formula by formula over canonical Montgomery Fp values (any way of
// computing a canonical value gives the same bits). add is add-2007-bl and
// double is dbl-2009-l (g1.py:90-103). The JAX code selects branchlessly,
// in the order same -> double(p), q == O -> p, p == O -> q; here each select
// is a branch with the same outcome: p == O returns q's limbs (so O + O
// returns q's), q == O returns p's, equal points return double(p), and
// p = -q runs the generic formula to (r^2, -r^3, 0). double passes a point
// with z = 0 through unchanged. A point with z = 0 is the identity whatever
// its x and y, and keeps those limbs.
//
// K5 stops after the scalar's highest set bit: past it the JAX loop only
// doubles acc, which no later step reads, so out is the same.
//
// K6 has a bit mode for the first level of a masked row sum
// (_commit_bits_rows): its leaves are bits[e] ? G[e mod gen] : O, read from
// the 0/1 words and the generator vector, so the (m, gen) leaf points are
// never stored (2.4 GB for a zkdl256 mag_bin commitment). Pairs (2i, 2i + 1)
// of one level never straddle two rows when the row width is even.
//
// What bounds them on an H100: the 32-bit multiply-adds of the Fp products.
// A generic add is 11 products and 5 squarings, a double 2 and 5; a product
// is a 12-limb CIOS (csrc/field.cuh), 300 wide multiply-adds. Bytes are
// few (144 B a point). The design is the simplest one that is right: one
// thread walks one point through every formula in registers, so a point's
// chain of dependent products is serial in its thread, and a launch of a few
// thousand points (a verifier MSM or fold level, a NUMS clearing) fills a few warps a
// SM: latency-bound, far from the multiply rate (see PERF.md).
//
// C interface (loaded with ctypes): each function launches on the given
// stream and device and returns cudaGetLastError(). Point operands are
// three (x, y, z) word pointers with an element stride in words (12 for a
// contiguous vector, 24 for every other element of one); outputs are
// contiguous.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FpSpec::N;  // limbs of an Fp value
constexpr int THREADS = 64;

struct Pt {
  uint32_t x[NL], y[NL], z[NL];
};

__device__ __forceinline__ void fmul(const uint32_t* a, const uint32_t* b, uint32_t* r) { mont_mul<FpSpec>(a, b, r); }
__device__ __forceinline__ void fadd(const uint32_t* a, const uint32_t* b, uint32_t* r) { mod_add<FpSpec>(a, b, r); }
__device__ __forceinline__ void fsub(const uint32_t* a, const uint32_t* b, uint32_t* r) { mod_sub<FpSpec>(a, b, r); }
__device__ __forceinline__ void fdbl(const uint32_t* a, uint32_t* r) { mod_add<FpSpec>(a, a, r); }

__device__ __forceinline__ void load(Pt& p, const uint32_t* x, const uint32_t* y, const uint32_t* z, int64_t off) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    p.x[k] = x[off + k];
    p.y[k] = y[off + k];
    p.z[k] = z[off + k];
  }
}

__device__ __forceinline__ void zero(Pt& p) {
#pragma unroll
  for (int k = 0; k < NL; ++k) p.x[k] = p.y[k] = p.z[k] = 0;
}

__device__ __forceinline__ void store(const Pt& p, uint32_t* x, uint32_t* y, uint32_t* z, int64_t off) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    x[off + k] = p.x[k];
    y[off + k] = p.y[k];
    z[off + k] = p.z[k];
  }
}

// p = double(p): dbl-2009-l; a point with z = 0 passes unchanged.
__device__ __forceinline__ void g1_double(Pt& p) {
  if (is_zero<NL>(p.z)) return;
  uint32_t a[NL], b[NL], c[NL], d[NL], e[NL], t[NL];
  fmul(p.x, p.x, a);
  fmul(p.y, p.y, b);
  fmul(b, b, c);
  fadd(p.x, b, t);
  fmul(t, t, d);
  fsub(d, a, d);
  fsub(d, c, d);
  fdbl(d, d);  // d = 2 ((x + b)^2 - a - c)
  fdbl(a, e);
  fadd(e, a, e);  // e = 3 a
  fmul(p.y, p.z, t);
  fdbl(t, p.z);  // z3 = 2 y z
  fmul(e, e, t);
  fsub(t, d, t);
  fsub(t, d, p.x);  // x3 = e^2 - d - d
  fsub(d, p.x, t);
  fmul(t, e, t);
  fdbl(c, c);
  fdbl(c, c);
  fdbl(c, c);
  fsub(t, c, p.y);  // y3 = (d - x3) e - 8 c
}

// p = add(p, q): add-2007-bl with g1.py:add's edge cases.
__device__ __forceinline__ void g1_add_into(Pt& p, const Pt& q) {
  if (is_zero<NL>(p.z)) {
    p = q;
    return;
  }
  if (is_zero<NL>(q.z)) return;
  uint32_t z1z1[NL], z2z2[NL], u1[NL], u2[NL], s1[NL], s2[NL], t[NL];
  fmul(p.z, p.z, z1z1);
  fmul(q.z, q.z, z2z2);
  fmul(p.x, z2z2, u1);
  fmul(q.x, z1z1, u2);
  fmul(p.y, q.z, s1);
  fmul(s1, z2z2, s1);
  fmul(q.y, p.z, s2);
  fmul(s2, z1z1, s2);
  if (equal<NL>(u1, u2) && equal<NL>(s1, s2)) {
    g1_double(p);
    return;
  }
  fsub(u2, u1, u2);  // h
  fsub(s2, s1, s2);
  fdbl(s2, s2);  // r = 2 (s2 - s1)
  fadd(p.z, q.z, t);
  fmul(t, t, t);
  fsub(t, z1z1, t);
  fsub(t, z2z2, t);
  fmul(t, u2, p.z);  // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  fdbl(u2, z1z1);
  fmul(z1z1, z1z1, z1z1);  // i = (2 h)^2
  fmul(u2, z1z1, z2z2);  // j = h i
  fmul(u1, z1z1, u1);  // v = u1 i
  fmul(s2, s2, t);
  fsub(t, z2z2, t);
  fsub(t, u1, t);
  fsub(t, u1, p.x);  // x3 = r^2 - j - v - v
  fsub(u1, p.x, t);
  fmul(t, s2, t);
  fmul(s1, z2z2, s1);
  fdbl(s1, s1);
  fsub(t, s1, p.y);  // y3 = r (v - x3) - 2 s1 j
}

// Word k of the scalar, k in [0, 8), without a dynamically indexed array
// (which would go to local memory).
__device__ __forceinline__ uint32_t word_at(const uint32_t (&w)[8], int k) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) out = k == i ? w[i] : out;
  return out;
}

__global__ void __launch_bounds__(THREADS)
    g1_scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                         const uint32_t* __restrict__ pz, int64_t p_stride, const uint32_t* __restrict__ sc,
                         int64_t s_stride, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = sc[i * s_stride + k];
  int top = -1;  // the highest set bit
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (w[k]) top = 32 * k + 31 - __clz(w[k]);
  Pt acc, out;
  load(acc, px, py, pz, i * p_stride);
  zero(out);
#pragma unroll 1
  for (int b = 0; b <= top; ++b) {
    if ((word_at(w, b >> 5) >> (b & 31)) & 1u) g1_add_into(out, acc);
    if (b < top) g1_double(acc);
  }
  store(out, ox, oy, oz, i * NL);
}

// out[i] = add(p[i], q[i]) (q negated first when neg_q), or, in bit mode
// (bits != null), add(leaf(2i), leaf(2i + 1)) with leaf(e) = bits[e] != 0 ?
// G[e mod gen] : O, G read through p's pointers.
__global__ void __launch_bounds__(THREADS)
    g1_add_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pz, int64_t p_stride, const uint32_t* __restrict__ qx,
                  const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz, int64_t q_stride,
                  int neg_q, const uint32_t* __restrict__ bits, int64_t gen, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  Pt p, q;
  if (bits != nullptr) {
    const int64_t e = 2 * i;
    if (bits[e]) load(p, px, py, pz, (e % gen) * NL);
    else zero(p);
    if (bits[e + 1]) load(q, px, py, pz, ((e + 1) % gen) * NL);
    else zero(q);
  } else {
    load(p, px, py, pz, i * p_stride);
    load(q, qx, qy, qz, i * q_stride);
  }
  if (neg_q) {
    uint32_t z[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) z[k] = 0;
    fsub(z, q.y, q.y);  // fp.neg: 0 - y mod p
  }
  g1_add_into(p, q);
  store(p, ox, oy, oz, i * NL);
}

unsigned blocks(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// Run f on `device`, restoring the caller's device.
template <class F>
int on_device(int device, F f) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  f();
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// n >= 1 points; s_stride 8 (a scalar a point, (n, 8) raw words) or 0 (one
// scalar for all).
extern "C" int zk_g1_scalar_mul(const void* px, const void* py, const void* pz, long long p_stride,
                                const void* scalars, long long s_stride, void* ox, void* oy, void* oz,
                                long long n, void* stream, int device) {
  if (n < 1 || n > ((long long)THREADS << 31)) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    g1_scalar_mul_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, p_stride, (const uint32_t*)scalars,
        s_stride, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  });
}

// n >= 1 sums. Bit mode: bits != null holds 2n words, the generators of
// length gen >= 1 are (px, py, pz), and q and the strides are not read.
extern "C" int zk_g1_add(const void* px, const void* py, const void* pz, long long p_stride, const void* qx,
                         const void* qy, const void* qz, long long q_stride, int neg_q, const void* bits,
                         long long gen, void* ox, void* oy, void* oz, long long n, void* stream, int device) {
  if (n < 1 || n > ((long long)THREADS << 31) || (bits != nullptr && gen < 1)) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    g1_add_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, p_stride, (const uint32_t*)qx,
        (const uint32_t*)qy, (const uint32_t*)qz, q_stride, neg_q, (const uint32_t*)bits, gen,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  });
}
