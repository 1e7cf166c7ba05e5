// K4: fixed-base comb exponentiation of the BLS12-381 G1 generator.
//
// Replaces zkdl_tpu/curve/g1.py:generator_pow (:378-397), a lax.fori_loop of
// 64 add_mixed (:135-158) + select steps over 12-limb Montgomery Fp (XLA on
// the TPU, no Pallas kernel). Every Pedersen row commitment and every opening
// point of the prover goes through it: 35 scalars per opening, 2048 per
// setup or layer commitment.
//
// What it computes is fixed down to the limb: the Jacobian limbs are absorbed
// by the Fiat-Shamir transcript, so each scalar walks the 64 4-bit windows
// LSB first with the host-built comb table (g1.py:_comb_table, (64, 16, 12)
// Montgomery affine x and y; 98 KB, read through the read-only path), and
// every window does g1.py's add_mixed (madd-2007-bl) value for value. The
// branchless selects of the JAX code become branches with the same outcome:
// a zero digit keeps the point, an identity point takes the lifted entry
// (qx, qy, mont(1)), equal points take double(p) (dbl-2009-l, g1.py:90-103),
// and p = -q runs the generic formula to z3 = 0. Every Fp value is canonical
// (< p), so how a product or sum is computed is free.
//
// What bounds it on an H100: not the multiply rate (the prover's calls need
// well under a microsecond of the card's IMAD throughput) but the chain of
// dependent Fp products of one scalar. add_mixed has 5 levels of products
// that depend on each other: {z1z1 = z^2, qyz = qy z}, {u2, s2}, {hh = h^2,
// rr = r^2, zh2 = (z + h)^2}, {j = h i, v = x i}, {(v - x3) r, y j}; 64
// windows x 5 = 320 product levels a scalar, plus the adds and subs between
// them. In one thread a 12-limb product is a long serial carry chain: the
// one-thread kernel this replaces took ~43 us a window.
//
// The design: one warp serves one scalar, as two teams of 16 lanes (Team in
// csrc/fp_team.cuh, which K5 shares); lane k < 12 of a team holds limb k of
// every Fp value, lanes 12-15 idle. Both teams hold the whole point. The
// products of one level run side by side, one per team (a level of three
// takes two rounds), and each result reaches the other team by a shuffle.
// All of a warp's decisions (zero digit, identity, equal points) are its
// scalar's, so the warp never diverges.
//
// Grid: 128-thread blocks, 4 scalars a block; a warp past n exits.
//
// C interface (loaded with ctypes): zk_g1_comb launches on the given stream
// and device and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_team.cuh"

namespace {

constexpr int WINDOWS = 64;
constexpr int ENTRIES = 16;
constexpr int THREADS = 128;

// scalars: (n, 8) raw 256-bit values; tx, ty: (64, 16, 12); out: (n, 12) each.
// One warp a scalar.
__global__ void __launch_bounds__(THREADS)
    g1_comb_kernel(const uint32_t* __restrict__ scalars, const uint32_t* __restrict__ tx,
                   const uint32_t* __restrict__ ty, uint32_t* __restrict__ ox,
                   uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int64_t n) {
  const int64_t e = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  if (e >= n) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const Team tm(lane);
  const bool holds = tm.k < NL;
  const uint32_t sw = lane < 8 ? __ldg(scalars + e * 8 + lane) : 0u;
  auto digit = [&](int w) { return (__shfl_sync(FULL, sw, w >> 3) >> (4 * (w & 7))) & 15u; };
  Team::Pt P{0, 0, 0};
  // this lane's limbs of the table entries, loaded a window ahead
  uint32_t nx = 0, ny = 0;
  uint32_t nd = digit(0);
  auto load = [&](int w, uint32_t d) {
    if (!holds) return;
    const int64_t off = ((int64_t)w * ENTRIES + d) * NL + tm.k;
    nx = __ldg(tx + off);
    ny = __ldg(ty + off);
  };
  load(0, nd);
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
    const uint32_t d = nd, qx = nx, qy = ny;
    if (w + 1 < WINDOWS) {
      nd = digit(w + 1);
      load(w + 1, nd);
    }
    if (d != 0) tm.add_mixed(P, qx, qy);  // k = 0 slots are the identity: keep the point
  }
  if (tm.team == 0 && holds) {
    const int64_t o = e * NL + tm.k;
    ox[o] = P.x;
    oy[o] = P.y;
    oz[o] = P.z;
  }
}

}  // namespace

// n >= 1 scalars.
extern "C" int zk_g1_comb(const void* scalars, const void* tx, const void* ty, void* ox, void* oy,
                          void* oz, long long n, void* stream, int device) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int PER_BLOCK = THREADS / 32;
  g1_comb_kernel<<<(unsigned)((n + PER_BLOCK - 1) / PER_BLOCK), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, (const uint32_t*)tx, (const uint32_t*)ty, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
