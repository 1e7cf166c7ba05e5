// G1 formulas over the team layouts of fp_team.cuh (Team, Quad, Solo), for
// K5 (g1_var.cu): g1.py's add (add-2007-bl,
// :106-132) and double (dbl-2009-l, :90-103) value for value, so the
// Jacobian limbs are the JAX package's; the launch geometry of each layout;
// and the host helper that launches on a given device.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "fp_team.cuh"

namespace {

template <class T>
struct Var {
  using Fp = typename T::Fp;
  struct Pt {
    Fp x, y, z;
  };

  __device__ static Pt sel(bool c, const Pt& a, const Pt& b) {
    return {T::sel(c, a.x, b.x), T::sel(c, a.y, b.y), T::sel(c, a.z, b.z)};
  }

  // dbl-2009-l (g1.py:double :90-103) of a point that is not the identity:
  // 4 rounds.
  __device__ static Pt dbl(const T& tm, const Pt& P) {
    Fp A, B, C, F, XB2, YZ;
    tm.mul2(P.x, P.x, P.y, P.y, A, B);
    const Fp E = tm.add(tm.dbl(A), A);
    const Fp XB = tm.add(P.x, B);
    tm.mul2(B, B, E, E, C, F);
    tm.mul2(XB, XB, P.y, P.z, XB2, YZ);
    const Fp D = tm.dbl(tm.sub(tm.sub(XB2, A), C));
    const Fp X3 = tm.sub(tm.sub(F, D), D);
    const Fp DE = tm.mul(tm.sub(D, X3), E);
    return {X3, tm.sub(DE, tm.dbl(tm.dbl(tm.dbl(C)))), tm.dbl(YZ)};
  }

  // add-2007-bl (g1.py:add :106-132) of P1 and P2, neither the identity,
  // and dbl-2009-l of P2, as one stream of 12 product rounds; same: P1 and
  // P2 are equal points (then add gives double(P1), which the caller runs).
  __device__ static void add_dbl(const T& tm, const Pt& P1, const Pt& P2, Pt& sum, bool& same, Pt& dbl2) {
    Fp Z1Z1, Z2Z2, S1a, S2a, U1, U2, S1, S2, I, RR, J, V, VR, SJ, ZZ, A, Z3, B, YZ, F, C, XB2;
    tm.mul2(P1.z, P1.z, P2.z, P2.z, Z1Z1, Z2Z2);
    tm.mul2(P1.y, P2.z, P2.y, P1.z, S1a, S2a);
    tm.mul2(P1.x, Z2Z2, P2.x, Z1Z1, U1, U2);
    tm.mul2(S1a, Z2Z2, S2a, Z1Z1, S1, S2);
    same = tm.eq(U1, U2) & tm.eq(S1, S2);  // both ballots on every lane: no short circuit
    const Fp H = tm.sub(U2, U1);
    const Fp R = tm.dbl(tm.sub(S2, S1));
    const Fp H2 = tm.dbl(H);
    tm.mul2(H2, H2, R, R, I, RR);
    tm.mul2(H, I, U1, I, J, V);
    const Fp X3 = tm.sub(tm.sub(RR, J), tm.dbl(V));
    const Fp VX = tm.sub(V, X3);
    tm.mul2(VX, R, S1, J, VR, SJ);
    const Fp Y3 = tm.sub(VR, tm.dbl(SJ));
    const Fp ZS = tm.add(P1.z, P2.z);
    tm.mul2(ZS, ZS, P2.x, P2.x, ZZ, A);
    const Fp T2 = tm.sub(tm.sub(ZZ, Z1Z1), Z2Z2);
    tm.mul2(T2, H, P2.y, P2.y, Z3, B);
    const Fp E = tm.add(tm.dbl(A), A);
    tm.mul2(P2.y, P2.z, E, E, YZ, F);
    const Fp XB = tm.add(P2.x, B);
    tm.mul2(B, B, XB, XB, C, XB2);
    const Fp D = tm.dbl(tm.sub(tm.sub(XB2, A), C));
    const Fp X3d = tm.sub(tm.sub(F, D), D);
    const Fp DE = tm.mul(tm.sub(D, X3d), E);
    sum = {X3, Y3, Z3};
    dbl2 = {X3d, tm.sub(DE, tm.dbl(tm.dbl(tm.dbl(C)))), tm.dbl(YZ)};
  }

  // One bit of g1.py:scalar_mul: out = bit ? add(out, acc) : out, acc =
  // double(acc), with add's and double's edge cases as selects per point.
  __device__ static void step(const T& tm, Pt& out, Pt& acc, bool bit) {
    const bool out_O = tm.zero(out.z), acc_O = tm.zero(acc.z);
    const bool gen = bit && !out_O && !acc_O;
    Pt next;
    if (T::ALWAYS_ADD || __any_sync(FULL, gen)) {
      Pt sum;
      bool same;
      add_dbl(tm, out, acc, sum, same, next);
      if (__any_sync(FULL, gen && same)) sum = sel(same, dbl(tm, out), sum);  // never on the verifier's path
      out = sel(gen, sum, out);
    } else {
      next = dbl(tm, acc);
    }
    out = sel(bit && out_O, acc, out);  // O + acc = acc (the first set bit)
    acc = sel(acc_O, acc, next);        // double keeps a z = 0 point
  }
};

// K5's blocks: THREADS a block, at least MIN_BLOCKS blocks an SM: 16 warps
// an SM for the team layouts; 9 for Solo, which then gets 168 registers a
// thread (3 warps of a sub-partition's 16K) and holds the verify's MSM,
// 1152 warps, in one wave.
template <class T>
struct Launch {
  static constexpr int THREADS = 128, MIN_BLOCKS = 4;
};
template <>
struct Launch<Solo> {
  static constexpr int THREADS = 32, MIN_BLOCKS = 9;
};

// Word k of the scalar, k in [0, 8), without a dynamically indexed array
// (which would go to local memory).
__device__ __forceinline__ uint32_t word_at(const uint32_t (&w)[8], int k) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) out = k == i ? w[i] : out;
  return out;
}

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
