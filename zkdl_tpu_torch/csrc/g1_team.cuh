// K8's and K13's G1 arithmetic on lane teams (csrc/g1_glv.cu, csrc/g1_win.cu):
// g1.py's double and add (dbl-2009-l, add-2007-bl with its selects) in the
// layouts of csrc/fp_chain.cuh, a point's 16-entry window table (g1.py:
// _mk_table) built in the layout's arithmetic, the cp.async helpers that
// fetch a table entry a window ahead, the layouts' launch bounds and the
// choice of layout by the launch's size.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fp_chain.cuh"

namespace {

// the highest nonzero window, -1 for 0
template <int N>
__device__ __forceinline__ int top_window(const uint32_t (&v)[N]) {
  int top = -1;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (v[i]) top = 8 * i + (31 - __clz(v[i])) / 4;
  return top;
}

constexpr int GLV_ENTRIES = 16;
constexpr int ENTRY_WORDS = 3 * NW;                                  // (x, y, z)
constexpr int ENTRY_VECS = ENTRY_WORDS / 4;                          // 16-byte pieces of an entry

struct Pt {
  Fq x, y, z;
};

// The formulas' second operand, a table entry in shared memory: each
// coordinate read where it is used, so it takes no registers across a
// formula.
struct Shared {
  const uint32_t* e;  // (x, y, z) in shared memory, 16-byte aligned
  __device__ __forceinline__ Fq word(int c) const {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(e + c * NW);
    Fq f;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(f.w[4 * q]), "=r"(f.w[4 * q + 1]), "=r"(f.w[4 * q + 2]), "=r"(f.w[4 * q + 3])
                   : "r"(a + 16 * q));
    return f;
  }
  __device__ __forceinline__ Fq x() const { return word(0); }
  __device__ __forceinline__ Fq y() const { return word(1); }
  __device__ __forceinline__ Fq z() const { return word(2); }
  __device__ __forceinline__ Pt pt() const { return {x(), y(), z()}; }
};

// g1.py's double and add over a layout T (fp_chain.cuh), value for value as
// g1.py (and K5's csrc/g1_var.cuh:Var). Canonical coordinates in and out;
// inside, every product is below 2p and every sum and difference in
// [0, 2p) (fp_chain.cuh); what add-2007-bl compares is reduced first.

// dbl-2009-l (g1.py:double :90-103) of a point that is not the identity,
// with two products a round (Pair): 4 rounds.
template <class T>
__device__ __forceinline__ Pt dbl_gen(const T& tm, const Pt& P) {
  Fq A, B, C, F, XB2, YZ;
  tm.mul2(P.x, P.x, P.y, P.y, A, B);
  const Fq E = tm.add(tm.dbl(A), A);
  const Fq XB = tm.add(P.x, B);
  tm.mul2(B, B, E, E, C, F);
  tm.mul2(XB, XB, P.y, P.z, XB2, YZ);
  const Fq D = tm.dbl(tm.sub(tm.sub(XB2, A), C));
  const Fq X3 = tm.sub(tm.sub(F, D), D);
  const Fq DE = tm.mul(tm.sub(D, X3), E);
  return {tm.canon(X3), tm.canon(tm.sub(DE, tm.dbl(tm.dbl(tm.dbl(C))))), tm.canon(tm.dbl(YZ))};
}

// The same with up to four products a round (Four): 3 rounds.
__device__ __forceinline__ Pt dbl_gen(const Four& tm, const Pt& P) {
  Fq A, B, YZ, C, F, XB2;
  tm.mul3(P.x, P.x, P.y, P.y, P.y, P.z, A, B, YZ);
  const Fq E = tm.add(tm.dbl(A), A);
  const Fq XB = tm.add(P.x, B);
  tm.mul3(B, B, E, E, XB, XB, C, F, XB2);
  const Fq D = tm.dbl(tm.sub(tm.sub(XB2, A), C));
  const Fq X3 = tm.sub(tm.sub(F, D), D);
  const Fq DE = tm.mul(tm.sub(D, X3), E);
  return {tm.canon(X3), tm.canon(tm.sub(DE, tm.dbl(tm.dbl(tm.dbl(C))))), tm.canon(tm.dbl(YZ))};
}

// add-2007-bl (g1.py:add :106-132) of P1 and P2, neither the identity,
// with two products a round (Pair): 16 products in 8 rounds, each
// round's pair independent; same: equal points (then add gives
// double(P1), which the caller runs).
template <class T, class E>
__device__ __forceinline__ void add_gen(const T& tm, const Pt& P1, const E& P2, Pt& sum, bool& same) {
  Fq Z1Z1, Z2Z2, U1, U2, I, S1a, S2a, J, V, S1, S2, ZZ, RR, SJ, VR, Z3;
  tm.mul2(P1.z, P1.z, P2.z(), P2.z(), Z1Z1, Z2Z2);
  tm.mul2(P1.x, Z2Z2, P2.x(), Z1Z1, U1, U2);
  const Fq H = tm.sub(U2, U1);
  const Fq H2 = tm.dbl(H);
  tm.mul2(H2, H2, P1.y, P2.z(), I, S1a);
  tm.mul2(P2.y(), P1.z, H, I, S2a, J);
  tm.mul2(U1, I, S1a, Z2Z2, V, S1);
  const Fq ZS = tm.add(P1.z, P2.z());
  tm.mul2(S2a, Z1Z1, ZS, ZS, S2, ZZ);
  same = tm.eq(tm.canon(U1), tm.canon(U2)) & tm.eq(tm.canon(S1), tm.canon(S2));  // no short circuit
  const Fq R = tm.dbl(tm.sub(S2, S1));
  tm.mul2(R, R, S1, J, RR, SJ);
  const Fq X3 = tm.sub(tm.sub(RR, J), tm.dbl(V));
  const Fq VX = tm.sub(V, X3);
  const Fq T2 = tm.sub(tm.sub(ZZ, Z1Z1), Z2Z2);
  tm.mul2(VX, R, T2, H, VR, Z3);
  sum = {tm.canon(X3), tm.canon(tm.sub(VR, tm.dbl(SJ))), tm.canon(Z3)};
}

// The same with up to four products a round (Four): 16 products in 5
// rounds, each round's products independent.
template <class E>
__device__ __forceinline__ void add_gen(const Four& tm, const Pt& P1, const E& P2, Pt& sum, bool& same) {
  Fq Z1Z1, Z2Z2, S1a, S2a, U1, U2, S1, S2, I, RR, ZZ, J, V, Z3, VR, SJ;
  tm.mul4(P1.z, P1.z, P2.z(), P2.z(), P1.y, P2.z(), P2.y(), P1.z, Z1Z1, Z2Z2, S1a, S2a);
  tm.mul4(P1.x, Z2Z2, P2.x(), Z1Z1, S1a, Z2Z2, S2a, Z1Z1, U1, U2, S1, S2);
  same = tm.eq(tm.canon(U1), tm.canon(U2)) & tm.eq(tm.canon(S1), tm.canon(S2));  // no short circuit
  const Fq H = tm.sub(U2, U1);
  const Fq H2 = tm.dbl(H);
  const Fq R = tm.dbl(tm.sub(S2, S1));
  const Fq ZS = tm.add(P1.z, P2.z());
  tm.mul3(H2, H2, R, R, ZS, ZS, I, RR, ZZ);
  const Fq T2 = tm.sub(tm.sub(ZZ, Z1Z1), Z2Z2);
  tm.mul3(H, I, U1, I, T2, H, J, V, Z3);
  const Fq X3 = tm.sub(tm.sub(RR, J), tm.dbl(V));
  const Fq VX = tm.sub(V, X3);
  tm.mul2(VX, R, S1, J, VR, SJ);
  sum = {tm.canon(X3), tm.canon(tm.sub(VR, tm.dbl(SJ))), tm.canon(Z3)};
}

template <class T>
struct Glv {
  __device__ __forceinline__ static Pt sel(bool c, const Pt& a, const Pt& b) {
    return {T::sel(c, a.x, b.x), T::sel(c, a.y, b.y), T::sel(c, a.z, b.z)};
  }

  // g1.py:double: a z = 0 point keeps its limbs
  __device__ __forceinline__ static Pt dbl(const T& tm, const Pt& P) { return sel(T::zero(P.z), P, dbl_gen(tm, P)); }

  // g1.py:add with its selects: P == O -> Q, Q == O -> P, equal -> double(P);
  // generic: the result is add-2007-bl's (none of the three)
  template <class E>
  __device__ __forceinline__ static Pt add(const T& tm, const Pt& P, const E& Q, bool& generic) {
    const bool pO = T::zero(P.z), qO = T::zero(Q.z());
    const bool gen = !pO && !qO;
    Pt sum = P;
    generic = false;
    if (__any_sync(FULL, gen)) {
      bool same;
      add_gen(tm, P, Q, sum, same);
      generic = gen && !same;
      if (__any_sync(FULL, gen && same)) sum = sel(same, dbl_gen(tm, P), sum);  // equal points: rare
    }
    sum = sel(qO, P, sum);
    if (__any_sync(FULL, pO)) sum = sel(pO, Q.pt(), sum);  // (Q read only here: P is dead by now)
    return sum;
  }
  template <class E>
  __device__ __forceinline__ static Pt add(const T& tm, const Pt& P, const E& Q) {
    bool generic;
    return add(tm, P, Q, generic);
  }
};

// --- tables -----------------------------------------------------------------

// word k < 36 of an entry (x, y, z): k constant after unrolling
__device__ __forceinline__ uint32_t entry_word(const Pt& e, int k) {
  return k < NW ? e.x.w[k] : k < 2 * NW ? e.y.w[k - NW] : e.z.w[k - 2 * NW];
}

__device__ __forceinline__ void put_entry(uint32_t* dst, const Pt& e) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < ENTRY_VECS; ++q)
    d[q] = make_uint4(entry_word(e, 4 * q), entry_word(e, 4 * q + 1), entry_word(e, 4 * q + 2),
                      entry_word(e, 4 * q + 3));
}

__device__ __forceinline__ Fq get_fq(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  Fq f;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 v = s[q];
    f.w[4 * q] = v.x;
    f.w[4 * q + 1] = v.y;
    f.w[4 * q + 2] = v.z;
    f.w[4 * q + 3] = v.w;
  }
  return f;
}

// One table in the layout's arithmetic: entry k at dst + k ENTRY_WORDS:
// t[0] = (0, 0, 0), t[1] = B, t[k] = add(t[k - 1], t[1]) (g1.py:_mk_table).
// Every add reads B from stash, a copy in shared memory that the point's
// lead lane writes. Returns whether every add from t[3] on ran the generic
// formula.
template <class T>
__device__ __forceinline__ bool build_table(const T& tm, const Pt& B, uint32_t* dst, uint32_t* stash, bool lead,
                                            bool writer) {
  if (lead) put_entry(stash, B);
  if (writer) {
    put_entry(dst, Pt{});
    put_entry(dst + ENTRY_WORDS, B);
  }
  __syncwarp();
  Pt e = B;
  bool all_generic = true;
#pragma unroll 1
  for (int k = 2; k < GLV_ENTRIES; ++k) {
    bool generic;
    e = Glv<T>::add(tm, e, Shared{stash}, generic);
    all_generic &= generic || k == 2;
    if (writer) put_entry(dst + k * ENTRY_WORDS, e);
  }
  return all_generic;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"((uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

enum Tables { SHARED = 0, FETCHED = 1 };

// Each layout's tables and launch bounds (a block is one warp; registers
// and shared memory from the ptxas report, PERF.md): Four keeps its eight
// points' tables in shared memory (K8's two a point: 36,864 bytes a block,
// six blocks an SM); Pair fetches its sixteen points' entries from the
// scratch, eight blocks an SM (255 registers a thread).
template <class T>
struct GlvLaunch;
template <>
struct GlvLaunch<Four> {
  static constexpr int TABLES = SHARED, MIN_BLOCKS = 6;
};
template <>
struct GlvLaunch<Pair> {
  static constexpr int TABLES = FETCHED, MIN_BLOCKS = 8;
};

// Run f on `device`, restoring the caller's device; returns the first error.
template <class F>
int on_device(int device, F f) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = f();
  const cudaError_t last = cudaGetLastError();
  if (err == cudaSuccess) err = last;
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// The forms of K8 and K13: 1 Four, 2 Pair; 0 by the launch: Four while
// every warp has a scheduler of its own (eight points a warp, four
// schedulers an SM), Pair from there (PERF.md's sweeps). Sets form to the
// one that runs.
constexpr int GLV_FORMS = 2;

cudaError_t glv_form(int& form, long long n, int device) {
  if (form != 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  form = n <= 4ll * sms * 8 ? 1 : 2;
  return err;
}
bool glv_scratch(int form) { return form == 2; }

}  // namespace
