// K4: fixed-base comb exponentiation of the BLS12-381 G1 generator.
//
// Replaces zkdl_tpu/curve/g1.py:generator_pow (:378-397), a lax.fori_loop of
// 64 add_mixed (:135-158) + select steps over 12-limb Montgomery Fp (XLA on
// the TPU, no Pallas kernel). Every Pedersen row commitment and every opening
// point of the prover goes through it.
//
// One thread per scalar walks the 64 4-bit windows LSB-first with the point
// in registers and the host-built comb table (g1.py:_comb_table layout
// (64, 16, 12), Montgomery affine x and y; 98 KB, so global memory through
// the read-only cache rather than the 64 KB constant bank). The formulas are
// g1.py's add_mixed (madd-2007-bl) and double (dbl-2009-l), value for value:
// the Jacobian limbs are absorbed by the Fiat-Shamir transcript, so a point
// that were only equal in affine form would change every later challenge.
// The branchless selects of the JAX code become branches with the same
// outcome: a zero digit keeps the point (g1.py:394-395), an identity point
// takes the lifted table entry, equal points take double(p).
//
// What bounds it on an H100: integer multiplies. One window costs 11 Fp
// products (18 when the points coincide), each a 12-limb CIOS of 288
// 32x32->64 multiply-adds; bytes are negligible (32 B in, 144 B out per
// scalar). On the prover's call sizes (35 scalars per opening, 2048 per
// commitment) the card is far from full: the time is one thread's latency
// through ~700 dependent Fp products.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FpSpec::N;
constexpr int WINDOWS = 64;
constexpr int ENTRIES = 16;
constexpr int THREADS = 64;

struct Pt {
  uint32_t x[NL], y[NL], z[NL];
};

__device__ __forceinline__ void fmul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  mont_mul<FpSpec>(a, b, r);
}
__device__ __forceinline__ void fadd(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  mod_add<FpSpec>(a, b, r);
}
__device__ __forceinline__ void fsub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  mod_sub<FpSpec>(a, b, r);
}
__device__ __forceinline__ void fdbl(const uint32_t* a, uint32_t* r) { mod_add<FpSpec>(a, a, r); }

// dbl-2009-l (g1.py:double :90-103); p is not the identity here.
__device__ void g1_double(Pt& p) {
  uint32_t a[NL], b[NL], c[NL], d[NL], e[NL], f[NL], t[NL], x3[NL], y3[NL], z3[NL];
  fmul(p.x, p.x, a);
  fmul(p.y, p.y, b);
  fmul(b, b, c);
  fadd(p.x, b, t);
  fmul(t, t, d);
  fsub(d, a, d);
  fsub(d, c, d);
  fdbl(d, d);
  fdbl(a, e);
  fadd(e, a, e);
  fmul(e, e, f);
  fmul(p.y, p.z, z3);
  fdbl(z3, z3);
  fsub(f, d, x3);
  fsub(x3, d, x3);
  fdbl(c, c);
  fdbl(c, c);
  fdbl(c, c);  // c8
  fsub(d, x3, t);
  fmul(t, e, y3);
  fsub(y3, c, y3);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    p.x[i] = x3[i];
    p.y[i] = y3[i];
    p.z[i] = z3[i];
  }
}

// madd-2007-bl (g1.py:add_mixed :135-158) with its edge cases.
__device__ void g1_add_mixed(Pt& p, const uint32_t* qx, const uint32_t* qy) {
  if (is_zero<NL>(p.z)) {  // identity + q = (q.x, q.y, mont(1))
    constexpr uint32_t ONE[NL] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                                  0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                                  0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      p.x[i] = qx[i];
      p.y[i] = qy[i];
      p.z[i] = ONE[i];
    }
    return;
  }
  uint32_t z1z1[NL], u2[NL], s2[NL], t[NL];
  fmul(p.z, p.z, z1z1);
  fmul(qx, z1z1, u2);
  fmul(qy, p.z, t);
  fmul(t, z1z1, s2);
  if (equal<NL>(p.x, u2) && equal<NL>(p.y, s2)) {
    g1_double(p);
    return;
  }
  uint32_t h[NL], hh[NL], ii[NL], j[NL], r[NL], v[NL], x3[NL], y3[NL], z3[NL];
  fsub(u2, p.x, h);
  fmul(h, h, hh);
  fdbl(hh, ii);
  fdbl(ii, ii);
  fmul(h, ii, j);
  fsub(s2, p.y, r);
  fdbl(r, r);
  fmul(p.x, ii, v);
  fmul(r, r, x3);
  fsub(x3, j, x3);
  fdbl(v, t);
  fsub(x3, t, x3);
  fsub(v, x3, t);
  fmul(t, r, y3);
  fmul(p.y, j, t);
  fdbl(t, t);
  fsub(y3, t, y3);
  fadd(p.z, h, t);
  fmul(t, t, z3);
  fsub(z3, z1z1, z3);
  fsub(z3, hh, z3);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    p.x[i] = x3[i];
    p.y[i] = y3[i];
    p.z[i] = z3[i];
  }
}

// scalars: (n, 8) raw 256-bit values; tx, ty: (64, 16, 12); out: (n, 12) each.
__global__ void g1_comb_kernel(const uint32_t* __restrict__ scalars,
                               const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                               uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, int64_t n) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = scalars[e * 8 + i];
  Pt p;
#pragma unroll
  for (int i = 0; i < NL; ++i) p.x[i] = p.y[i] = p.z[i] = 0;
  for (int w = 0; w < WINDOWS; ++w) {
    const uint32_t d = (s[w >> 3] >> (4 * (w & 7))) & 15u;
    if (d == 0) continue;  // k = 0 slots are the identity: keep p
    const int64_t off = ((int64_t)w * ENTRIES + d) * NL;
    uint32_t qx[NL], qy[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      qx[i] = __ldg(tx + off + i);
      qy[i] = __ldg(ty + off + i);
    }
    g1_add_mixed(p, qx, qy);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    ox[e * NL + i] = p.x[i];
    oy[e * NL + i] = p.y[i];
    oz[e * NL + i] = p.z[i];
  }
}

}  // namespace

extern "C" int zk_g1_comb(const void* scalars, const void* tx, const void* ty, void* ox, void* oy,
                          void* oz, long long n, void* stream) {
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  g1_comb_kernel<<<blocks < 1 ? 1 : blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, (const uint32_t*)tx, (const uint32_t*)ty, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}
