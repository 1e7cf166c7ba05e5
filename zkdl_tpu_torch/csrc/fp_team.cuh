// Fp arithmetic spread over a team of lanes: the device side of the G1
// kernels that give one point (or scalar) a warp or part of one (g1_comb.cu,
// g1_var.cu).
//
// A 12-limb Montgomery product in one thread is a long serial carry chain
// (csrc/field.cuh). Here a team of lanes holds an Fp value, each lane a run
// of its limbs, and two teams hold the same point, so that the independent
// products of one formula level run side by side, one a team (mul2), while
// the adds and subs between them run on both teams alike. Every Fp value
// is canonical (< p), so how a product or sum is computed is free: the bits
// are those of the one-thread code.
//
// Three layouts (Team and Quad share the carry logic below):
//   Team: lane k < 12 of a 16-lane team holds limb k; two teams a warp, one
//         point (or scalar) a warp (K4; K5 on small launches).
//   Quad: lane k of a 4-lane team holds limbs 3k .. 3k + 2; two teams a
//         point, four points a warp (K5: fewer instructions a product).
//   Solo: one lane is a team and holds all 12 limbs (the one-thread
//         arithmetic of field.cuh, no ballot); two lanes a point, sixteen
//         points a warp (K5: fewer instructions still, a longer chain).
//
// A Montgomery product is operand scanning over b's 12 limbs spread over a
// team: each lane adds a_lane b_i and m p_lane into its words with wide
// multiply-adds, and the accumulator shifts one word down the team with a
// shuffle. A lane's carry out of its top word stays pending (e) and is added
// where that word lands after the shift; after the 12 steps the pending
// carries go up one lane, and one two-stage operation resolves the carries
// this leaves between lanes and the conditional subtract of p (resolve);
// add, sub and double are the same two-stage operation. The carry flags are
// gathered by ballots of the whole warp, and every shuffle spans the whole
// warp. (ptxas guards every ballot and shuffle with a divergence test whose
// slow path is a loop; a ballot over part of a warp takes that path even in
// a converged warp.)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FpSpec::N;   // limbs of an Fp value
constexpr int TEAM_WIDTH = 16;  // lanes a Team spans; two teams fill a warp
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t TEAM_BITS = (1u << NL) - 1;

__device__ __forceinline__ uint32_t one_mont(int i) {  // mont(1) = 2^384 mod p
  constexpr uint32_t ONE[NL] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                                0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                                0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
  return ONE[i];
}

// --- team-wide carries -----------------------------------------------------
//
// Every add, sub and product ends in a two-stage operation over the team:
// stage 1 adds (subtracts) two values, stage 2 subtracts (adds) p. Each lane
// computes the carry out of its words for every carry-in it could get: stage
// 1 for in = 0 and 1, stage 2 for each stage-1 carry-in and each stage-2
// carry-in. Six ballots gather these flags of every lane (f.. below: the
// team's lanes where each holds, as bits 0 .. W - 1), and every lane
// resolves both stages' carries from them by lookahead: with G = the lanes
// that carry out on in = 0 and P = the lanes that carry out only on in = 1,
// the carry-ins are ((G << 1) + P) ^ P and bit W of (G << 1) + P is the
// carry out of the team.

struct Carries {
  uint32_t in1, in2;    // this lane's carry-in of stage 1, stage 2
  uint32_t top1, top2;  // the team's carry out of stage 1, stage 2
};

// f1c: stage-1 carry out for carry-in c; f2cb: stage-2 carry out for
// stage-1 carry-in c and stage-2 carry-in b. W lanes a team, k this lane's.
template <int W>
__device__ __forceinline__ Carries lookahead(uint32_t f10, uint32_t f11, uint32_t f200, uint32_t f201,
                                             uint32_t f210, uint32_t f211, int k) {
  constexpr uint32_t BITS = (1u << W) - 1;
  const uint32_t G1 = f10, P1 = f11 & ~G1;
  const uint32_t S1 = (G1 << 1) + P1, C1 = (S1 ^ P1) & BITS;
  const uint32_t G2 = (f200 & ~C1) | (f210 & C1);
  const uint32_t P2 = ((f201 & ~C1) | (f211 & C1)) & ~G2;
  const uint32_t S2 = (G2 << 1) + P2;
  return {(C1 >> k) & 1u, ((S2 ^ P2) >> k) & 1u, S1 >> W, S2 >> W};
}

// An Fp value is one uint32_t a lane: lane k's limb.
struct Team {
  struct Pt {
    uint32_t x, y, z;
  };
  using Fp = uint32_t;
  static constexpr int POINT_LANES = 2 * TEAM_WIDTH;  // one point a warp
  static constexpr bool ALWAYS_ADD = false;  // K5 may run a bit as a double alone

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

  // The team's lanes where f holds, as bits 0 .. 11.
  __device__ uint32_t flags(bool f) const { return (__ballot_sync(FULL, f) >> tbase) & TEAM_BITS; }

  __device__ Carries resolve(bool o10, bool o11, bool o200, bool o201, bool o210, bool o211) const {
    return lookahead<NL>(flags(o10), flags(o11), flags(o200), flags(o201), flags(o210), flags(o211), k);
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

  // a * b * 2^-384 mod p over the team. Every lane also keeps a copy of lane
  // 0's word (fed lane 1's word at each shift), so each computes m = t_0 p'
  // mod 2^32 itself and no shuffle of m stands in the chain. Lane 0's word
  // never has a carry pending into it, so t_0 is exact. Bounds, with words
  // < 2^32: each wide multiply-add x y + t <= 2^64 - 2^32; during a step
  // e < 4 + 2^33; after the shift e < 4.
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

  // --- per point (here: per warp), for code written over both layouts ------
  __device__ bool zero(uint32_t v) const { return flags(v != 0) == 0; }
  __device__ bool eq(uint32_t a, uint32_t b) const { return flags(a != b) == 0; }
  __device__ static uint32_t sel(bool c, uint32_t a, uint32_t b) { return c ? a : b; }
  __device__ uint32_t load(const uint32_t* __restrict__ base, int64_t off) const {
    return k < NL ? __ldg(base + off + k) : 0u;
  }
  __device__ void store(uint32_t* __restrict__ base, int64_t off, uint32_t v) const {
    if (k < NL) base[off + k] = v;
  }
  // load of words this kernel wrote (a plain load: __ldg's read-only path
  // is not coherent with the kernel's own stores)
  __device__ uint32_t load_rw(const uint32_t* base, int64_t off) const { return k < NL ? base[off + k] : 0u; }
};

// An Fp value is three uint32_t a lane: lane k's limbs 3k .. 3k + 2. Four
// lanes a team, two teams a point (lanes 8j .. 8j + 7 of a warp serve its
// j-th point), four points a warp. Every lane holds limbs, so no lane idles,
// and a product's shuffles and carry bookkeeping are shared by three limbs.
struct Quad {
  static constexpr int L = 3;                 // limbs a lane
  static constexpr int W = NL / L;            // lanes a team (4)
  static constexpr int POINT_LANES = 2 * W;   // two teams a point
  static constexpr bool ALWAYS_ADD = false;
  static constexpr uint32_t BITS = (1u << W) - 1;
  struct Fp {
    uint32_t w[L];
  };

  int k;      // lane within the team
  int team;   // 0 or 1 within the point
  int tbase;  // the team's first lane in the warp
  uint32_t p[L];  // this lane's limbs of p

  __device__ explicit Quad(int lane) : k(lane % W), team((lane / W) & 1), tbase(lane - k) {
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (i / L == k) p[i % L] = FpSpec::p(i);
  }

  __device__ uint32_t flags(bool f) const { return (__ballot_sync(FULL, f) >> tbase) & BITS; }

  __device__ Carries resolve(bool o10, bool o11, bool o200, bool o201, bool o210, bool o211) const {
    return lookahead<W>(flags(o10), flags(o11), flags(o200), flags(o201), flags(o210), flags(o211), k);
  }

  __device__ static Fp sel(bool c, const Fp& a, const Fp& b) {
    Fp r;
#pragma unroll
    for (int j = 0; j < L; ++j) r.w[j] = c ? a.w[j] : b.w[j];
    return r;
  }

  // borrow out of v - p - b over this lane's words
  __device__ bool below(const Fp& v, uint32_t b) const {
#pragma unroll
    for (int j = 0; j < L; ++j) b = (uint32_t)(((uint64_t)v.w[j] - p[j] - b) >> 32) & 1u;
    return b;
  }
  // carry out of v + p + c over this lane's words
  __device__ bool over(const Fp& v, uint32_t c) const {
#pragma unroll
    for (int j = 0; j < L; ++j) c = (uint32_t)(((uint64_t)v.w[j] + p[j] + c) >> 32);
    return c;
  }
  __device__ Fp minus_p(const Fp& v, uint32_t b) const {
    Fp r;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t d = (uint64_t)v.w[j] - p[j] - b;
      r.w[j] = (uint32_t)d;
      b = (uint32_t)(d >> 32) & 1u;
    }
    return r;
  }
  __device__ Fp plus_p(const Fp& v, uint32_t c) const {
    Fp r;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = (uint64_t)v.w[j] + p[j] + c;
      r.w[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    return r;
  }

  // (x + y) mod p for x + y < 2p (Team::add over three words a lane).
  __device__ Fp add(const Fp& x, const Fp& y) const {
    Fp s0, s1;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)x.w[j] + y.w[j] + c;
      s0.w[j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    const bool o10 = c;
    c = 1;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)s0.w[j] + c;
      s1.w[j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    const bool o11 = o10 || c;
    const Carries cr = resolve(o10, o11, below(s0, 0), below(s0, 1), below(s1, 0), below(s1, 1));
    const Fp s = sel(cr.in1, s1, s0);
    return cr.top2 ? s : minus_p(s, cr.in2);
  }
  __device__ Fp dbl(const Fp& x) const { return add(x, x); }

  // (x - y) mod p (Team::sub over three words a lane).
  __device__ Fp sub(const Fp& x, const Fp& y) const {
    Fp d0, d1;
    uint32_t b = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)x.w[j] - y.w[j] - b;
      d0.w[j] = (uint32_t)v;
      b = (uint32_t)(v >> 32) & 1u;
    }
    const bool o10 = b;
    b = 1;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)d0.w[j] - b;
      d1.w[j] = (uint32_t)v;
      b = (uint32_t)(v >> 32) & 1u;
    }
    const bool o11 = o10 || b;
    const Carries cr = resolve(o10, o11, over(d0, 0), over(d0, 1), over(d1, 0), over(d1, 1));
    const Fp d = sel(cr.in1, d1, d0);
    return cr.top1 ? plus_p(d, cr.in2) : d;
  }

  // a * b * 2^-384 mod p over the team. Each step adds a b_i and m p into the
  // lane's three words with one carry chain each (a wide multiply-add x y +
  // t + c <= 2^64 - 1); m comes from lane 0's word 0 by a shuffle. The carry
  // out of the lane's top word is pending (e) into the next lane's word 0,
  // which lands in the lane's top word at the shift: during a step e < 2^33
  // + 4, after the shift e < 4.
  __device__ Fp mul(const Fp& a, const Fp& b) const {
    uint32_t bl[NL];  // b's limbs, on every lane
#pragma unroll
    for (int i = 0; i < NL; ++i) bl[i] = __shfl_sync(FULL, b.w[i % L], i / L, W);
    uint32_t t[L];
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] = 0;
    uint64_t e = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      uint32_t c = 0;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint64_t v = (uint64_t)a.w[j] * bl[i] + t[j] + c;
        t[j] = (uint32_t)v;
        c = (uint32_t)(v >> 32);
      }
      e += c;
      const uint32_t m = __shfl_sync(FULL, t[0], 0, W) * FpSpec::NP0;
      c = 0;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint64_t v = (uint64_t)p[j] * m + t[j] + c;
        t[j] = (uint32_t)v;
        c = (uint32_t)(v >> 32);
      }
      e += c;
      // word 0 of the team is now 0: shift one word down
      uint32_t up = __shfl_down_sync(FULL, t[0], 1, W);
      if (k == W - 1) up = 0;
#pragma unroll
      for (int j = 0; j + 1 < L; ++j) t[j] = t[j + 1];
      const uint64_t v = (uint64_t)up + e;
      t[L - 1] = (uint32_t)v;
      e = v >> 32;
    }
    // the pending e (< 4; the last lane's is 0) go up one lane into its
    // word 0; one add resolves them and subtracts p if needed
    uint32_t y = __shfl_up_sync(FULL, (uint32_t)e, 1, W);
    if (k == 0) y = 0;
    Fp r, ys;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      r.w[j] = t[j];
      ys.w[j] = j == 0 ? y : 0u;
    }
    return add(r, ys);
  }

  // Two products side by side: team 0 computes x0 y0, team 1 x1 y1; every
  // lane of the point gets both.
  __device__ void mul2(const Fp& x0, const Fp& y0, const Fp& x1, const Fp& y1, Fp& o0, Fp& o1) const {
    const Fp z = mul(sel(team, x1, x0), sel(team, y1, y0));
    Fp other;
#pragma unroll
    for (int j = 0; j < L; ++j) other.w[j] = __shfl_xor_sync(FULL, z.w[j], W);
    o0 = sel(team, other, z);
    o1 = sel(team, z, other);
  }

  // --- per point: both teams hold the same values, so a team's flags decide
  __device__ bool zero(const Fp& v) const { return flags((v.w[0] | v.w[1] | v.w[2]) != 0) == 0; }
  __device__ bool eq(const Fp& a, const Fp& b) const {
    return flags(((a.w[0] ^ b.w[0]) | (a.w[1] ^ b.w[1]) | (a.w[2] ^ b.w[2])) != 0) == 0;
  }
  __device__ Fp load(const uint32_t* __restrict__ base, int64_t off) const {
    Fp r;
#pragma unroll
    for (int j = 0; j < L; ++j) r.w[j] = __ldg(base + off + L * k + j);
    return r;
  }
  __device__ void store(uint32_t* __restrict__ base, int64_t off, const Fp& v) const {
#pragma unroll
    for (int j = 0; j < L; ++j) base[off + L * k + j] = v.w[j];
  }
  __device__ Fp load_rw(const uint32_t* base, int64_t off) const {
    Fp r;
#pragma unroll
    for (int j = 0; j < L; ++j) r.w[j] = base[off + L * k + j];
    return r;
  }
};

// An Fp value is twelve uint32_t a lane: a team is one lane, two lanes
// serve a point (lanes 2j, 2j + 1 its j-th), sixteen points a warp. The
// products and sums are field.cuh's one-thread code; mul2's two products
// meet by twelve shuffles.
struct Solo {
  static constexpr int POINT_LANES = 2;
  // K5 runs every bit through its add-and-double rounds: with its products
  // inlined one thread each, a second hot path (a bit as a double alone)
  // made a launch twice as slow where a warp's scalars agree
  static constexpr bool ALWAYS_ADD = true;
  struct Fp {
    uint32_t w[NL];
  };

  int team;  // 0 or 1 within the point

  __device__ explicit Solo(int lane) : team(lane & 1) {}

  __device__ static Fp sel(bool c, const Fp& a, const Fp& b) {
    Fp r;
#pragma unroll
    for (int j = 0; j < NL; ++j) r.w[j] = c ? a.w[j] : b.w[j];
    return r;
  }
  __device__ Fp add(const Fp& x, const Fp& y) const {
    Fp r;
    mod_add<FpSpec>(x.w, y.w, r.w);
    return r;
  }
  __device__ Fp dbl(const Fp& x) const { return add(x, x); }
  __device__ Fp sub(const Fp& x, const Fp& y) const {
    Fp r;
    mod_sub<FpSpec>(x.w, y.w, r.w);
    return r;
  }
  __device__ Fp mul(const Fp& a, const Fp& b) const {
    Fp r;
    mont_mul<FpSpec>(a.w, b.w, r.w);
    return r;
  }
  __device__ void mul2(const Fp& x0, const Fp& y0, const Fp& x1, const Fp& y1, Fp& o0, Fp& o1) const {
    const Fp z = mul(sel(team, x1, x0), sel(team, y1, y0));
    Fp other;
#pragma unroll
    for (int j = 0; j < NL; ++j) other.w[j] = __shfl_xor_sync(FULL, z.w[j], 1);
    o0 = sel(team, other, z);
    o1 = sel(team, z, other);
  }
  // both lanes of a point hold the same values: a lane decides for it
  __device__ bool zero(const Fp& v) const { return is_zero<NL>(v.w); }
  __device__ bool eq(const Fp& a, const Fp& b) const { return equal<NL>(a.w, b.w); }
  __device__ Fp load(const uint32_t* __restrict__ base, int64_t off) const {
    Fp r;
#pragma unroll
    for (int j = 0; j < NL; ++j) r.w[j] = __ldg(base + off + j);
    return r;
  }
  __device__ void store(uint32_t* __restrict__ base, int64_t off, const Fp& v) const {
#pragma unroll
    for (int j = 0; j < NL; ++j) base[off + j] = v.w[j];
  }
  __device__ Fp load_rw(const uint32_t* base, int64_t off) const {
    Fp r;
#pragma unroll
    for (int j = 0; j < NL; ++j) r.w[j] = base[off + j];
    return r;
  }
};

}  // namespace
