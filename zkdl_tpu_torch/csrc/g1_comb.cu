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
// The design: one warp serves one scalar, as two teams of 16 lanes; lane
// k < 12 of a team holds limb k of every Fp value, lanes 12-15 idle. Both
// teams hold the whole point. The products of one level run side by side,
// one per team (a level of three takes two rounds), and each result reaches
// the other team by a shuffle (both lay out limbs alike). A Montgomery
// product is operand scanning over b's 12 limbs spread over a team: each
// lane adds its limb's a b_i and m p into its word with one wide multiply-add
// each, and the accumulator shifts one word down the team with a shuffle.
// Every lane also keeps a copy of lane 0's word (fed lane 1's word at each
// shift), so each computes m = t_0 p' mod 2^32 itself and no shuffle of m
// stands in the chain. A lane's carry out of its word stays pending (e) and
// is added where that word lands after the shift, so lane 0's word never has
// a carry pending into it and t_0 is exact. Bounds, with words < 2^32: each
// wide multiply-add x y + t <= 2^64 - 2^32; during a step e < 4 + 2^33;
// after the shift e < 4. After the 12 steps the pending e go up one lane,
// and one two-stage operation resolves the carries this leaves between lanes
// and the conditional subtract of p (see Team::resolve); add, sub and double
// are the same two-stage operation. The carry flags are gathered by ballots
// of the whole warp, and every shuffle spans the whole warp: all of a warp's
// decisions (zero digit, identity, equal points) are its scalar's, so the
// warp never diverges. (ptxas guards every ballot and shuffle with a
// divergence test whose slow path is a loop; a ballot over part of a warp
// takes that path even in a converged warp.)
//
// Grid: 128-thread blocks, 4 scalars a block; a warp past n exits.
//
// C interface (loaded with ctypes): zk_g1_comb launches on the given stream
// and device and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FpSpec::N;  // limbs of an Fp value = lanes of a team that hold one
constexpr int WINDOWS = 64;
constexpr int ENTRIES = 16;
constexpr int THREADS = 128;
constexpr int TEAM_WIDTH = 16;  // lanes a team spans; two teams fill a warp
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t TEAM_BITS = (1u << NL) - 1;

__device__ __forceinline__ uint32_t one_mont(int i) {  // mont(1) = 2^384 mod p
  constexpr uint32_t ONE[NL] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                                0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                                0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
  return ONE[i];
}

// An Fp value is one uint32_t a lane: lane k's limb.
struct Team {
  struct Pt {
    uint32_t x, y, z;
  };

  int k;      // lane within the team (k >= NL: idle, holds a don't-care word)
  int team;   // 0 or 1
  int tbase;  // the team's first lane in the warp
  uint32_t p, one;  // this lane's limb of p and of mont(1)

  __device__ explicit Team(int lane) : k(lane % TEAM_WIDTH), team(lane / TEAM_WIDTH), tbase(lane - k), p(0), one(0) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (i == k) {
        p = FpSpec::p(i);
        one = one_mont(i);
      }
    }
  }

  // --- team-wide carries ---------------------------------------------------
  //
  // Every add, sub and product ends in a two-stage operation over the team:
  // stage 1 adds (subtracts) two values, stage 2 subtracts (adds) p. Each
  // lane computes the carry out of its word for every carry-in it could get:
  // stage 1 for in = 0 and 1, stage 2 for each stage-1 carry-in and each
  // stage-2 carry-in. Six ballots gather these flags of every lane, and
  // every lane resolves both stages' carries from them by lookahead: with
  // G = the lanes that carry out on in = 0 and P = the lanes that carry out
  // only on in = 1, the carry-ins are ((G << 1) + P) ^ P and bit 12 of
  // (G << 1) + P is the carry out of the team.

  // The team's lanes where f holds, as bits 0 .. 11.
  __device__ uint32_t flags(bool f) const { return (__ballot_sync(FULL, f) >> tbase) & TEAM_BITS; }

  struct Carries {
    uint32_t in1, in2;    // this lane's carry-in of stage 1, stage 2
    uint32_t top1, top2;  // the team's carry out of stage 1, stage 2
  };

  // o1c: stage-1 carry out for carry-in c; o2cb: stage-2 carry out for
  // stage-1 carry-in c and stage-2 carry-in b.
  __device__ Carries resolve(bool o10, bool o11, bool o200, bool o201, bool o210, bool o211) const {
    const uint32_t G1 = flags(o10), P1 = flags(o11) & ~G1;
    const uint32_t S1 = (G1 << 1) + P1, C1 = (S1 ^ P1) & TEAM_BITS;
    const uint32_t G2 = (flags(o200) & ~C1) | (flags(o210) & C1);
    const uint32_t P2 = ((flags(o201) & ~C1) | (flags(o211) & C1)) & ~G2;
    const uint32_t S2 = (G2 << 1) + P2;
    return {(C1 >> k) & 1u, ((S2 ^ P2) >> k) & 1u, S1 >> NL, S2 >> NL};
  }

  // (x + y) mod p for x + y < 2p: stage 1 x + y, stage 2 minus p, kept when
  // it does not borrow out of the team.
  __device__ uint32_t add(uint32_t x, uint32_t y) const {
    const uint32_t s0 = x + y, s1 = s0 + 1;
    const bool o10 = s0 < x, o11 = o10 || s0 == FULL;
    const bool o200 = s0 < p, o201 = s0 <= p;
    const bool o210 = s1 < p, o211 = s1 <= p;
    const Carries c = resolve(o10, o11, o200, o201, o210, o211);
    const uint32_t s = c.in1 ? s1 : s0;
    return c.top2 ? s : s - p - c.in2;
  }
  __device__ uint32_t dbl(uint32_t x) const { return add(x, x); }

  // (x - y) mod p: stage 1 x - y, stage 2 plus p, taken when stage 1 borrows
  // out of the team (the carry out of stage 2 is dropped).
  __device__ uint32_t sub(uint32_t x, uint32_t y) const {
    const uint32_t d0 = x - y, d1 = d0 - 1, s0 = d0 + p, s1 = d1 + p;
    const bool o10 = x < y, o11 = x <= y;
    const bool o200 = s0 < p, o201 = o200 || s0 == FULL;
    const bool o210 = s1 < p, o211 = o210 || s1 == FULL;
    const Carries c = resolve(o10, o11, o200, o201, o210, o211);
    const uint32_t d = c.in1 ? d1 : d0;
    return c.top1 ? d + p + c.in2 : d;
  }

  // t += x y; the high word is added to the pending carry e.
  __device__ static void row(uint32_t& t, uint32_t x, uint32_t y, uint64_t& e) {
    const uint64_t v = (uint64_t)x * y + t;  // <= 2^64 - 2^32
    t = (uint32_t)v;
    e += v >> 32;
  }

  // Shift one word down the team: the new word is `up` plus the carry
  // pending into it.
  __device__ static void shift(uint32_t& t, uint32_t up, uint64_t& e) {
    const uint64_t v = (uint64_t)up + e;
    t = (uint32_t)v;
    e = v >> 32;
  }

  // a * b * 2^-384 mod p over the team (see the note at the top).
  __device__ uint32_t mul(uint32_t a, uint32_t b) const {
    uint32_t bl[NL];  // b's limbs, on every lane
#pragma unroll
    for (int i = 0; i < NL; ++i) bl[i] = __shfl_sync(FULL, b, i, TEAM_WIDTH);
    const uint32_t a0 = __shfl_sync(FULL, a, 0, TEAM_WIDTH), p0 = FpSpec::p(0);
    // t: this lane's word; s: lane 0's word, kept by every lane so that each
    // computes m itself. e, es: the carries pending out of them (into the
    // next lane's word; the last lane's into word 12).
    uint32_t t = 0, s = 0;
    uint64_t e = 0, es = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      row(t, a, bl[i], e);
      row(s, a0, bl[i], es);
      const uint32_t m = s * FpSpec::NP0;
      row(t, p, m, e);
      row(s, p0, m, es);
      // word 0 is now 0; every lane takes its next lane's word, the copy of
      // lane 0 takes lane 1's
      uint32_t up = __shfl_down_sync(FULL, t, 1, TEAM_WIDTH);
      if (k >= NL - 1) up = 0;
      const uint32_t up_s = __shfl_sync(FULL, t, 1, TEAM_WIDTH);
      shift(t, up, e);  // e < 4 after the shift
      shift(s, up_s, es);
    }
    // the pending e (< 4; the last lane's is 0 since the result is < 2p <
    // 2^384) go up one lane; then one add with the carries left between lanes
    // and the conditional subtract of p
    uint32_t y = __shfl_up_sync(FULL, (uint32_t)e, 1, TEAM_WIDTH);
    if (k == 0) y = 0;
    return add(t, y);
  }

  // Two products side by side: team 0 computes x0 y0, team 1 x1 y1; every
  // lane gets both.
  __device__ void mul2(uint32_t x0, uint32_t y0, uint32_t x1, uint32_t y1, uint32_t& o0, uint32_t& o1) const {
    const uint32_t z = mul(team ? x1 : x0, team ? y1 : y0);
    o0 = __shfl_sync(FULL, z, k);
    o1 = __shfl_sync(FULL, z, TEAM_WIDTH + k);
  }

  // dbl-2009-l (g1.py:double :90-103); p is not the identity here.
  __device__ void dbl_point(Pt& P) const {
    uint32_t A, B, C, xb2;
    mul2(P.x, P.x, P.y, P.y, A, B);
    const uint32_t yz = mul(P.y, P.z);
    const uint32_t E = add(dbl(A), A);
    const uint32_t xb = add(P.x, B);
    mul2(B, B, xb, xb, C, xb2);
    const uint32_t F_ = mul(E, E);
    const uint32_t D = dbl(sub(sub(xb2, A), C));
    const uint32_t x3 = sub(sub(F_, D), D);
    const uint32_t c8 = dbl(dbl(dbl(C)));
    const uint32_t y3 = mul(sub(D, x3), E);
    P.z = dbl(yz);
    P.x = x3;
    P.y = sub(y3, c8);
  }

  // madd-2007-bl (g1.py:add_mixed :135-158) with its edge cases; both teams
  // hold the same point, so a team's flags decide for the warp.
  __device__ void add_mixed(Pt& P, uint32_t qx, uint32_t qy) const {
    if (flags(P.z != 0) == 0) {  // identity + q = (qx, qy, mont(1))
      P.x = qx;
      P.y = qy;
      P.z = one;
      return;
    }
    uint32_t z1z1, qyz, u2, s2;
    mul2(P.z, P.z, qy, P.z, z1z1, qyz);
    mul2(qx, z1z1, qyz, z1z1, u2, s2);
    if (flags(P.x != u2 || P.y != s2) == 0) {  // equal points: never on the prover's path
      dbl_point(P);
      return;
    }
    const uint32_t h = sub(u2, P.x);
    const uint32_t r = dbl(sub(s2, P.y));
    const uint32_t zh = add(P.z, h);
    uint32_t hh, rr;
    mul2(h, h, r, r, hh, rr);
    const uint32_t zh2 = mul(zh, zh);
    const uint32_t i = dbl(dbl(hh));
    uint32_t j, v;
    mul2(h, i, P.x, i, j, v);
    const uint32_t x3 = sub(sub(rr, j), dbl(v));
    uint32_t vr, yj;
    mul2(sub(v, x3), r, P.y, j, vr, yj);
    P.y = sub(vr, dbl(yj));
    P.z = sub(sub(zh2, z1z1), hh);
    P.x = x3;
  }
};

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
