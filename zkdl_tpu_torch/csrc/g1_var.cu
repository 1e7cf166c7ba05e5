// K5 and K6: variable-base BLS12-381 G1 arithmetic.
//
// K5, g1_scalar_mul_kernel, replaces zkdl_tpu/curve/g1.py:scalar_mul (:168-184),
// a lax.fori_loop over the 256 scalar bits, LSB first: out = bit ? add(out, acc)
// : out, then acc = double(acc). K6, g1_add_kernel, replaces g1.py:add
// (:106-132), the step of g1_sum (:413-430), of pedersen._commit_bits_rows
// (:659-671) and of me_step (:433-452). Both were XLA on the TPU (no Pallas
// kernel). The committed-aux tier runs them: every aux row commitment is a
// tree of K6 levels, the NUMS generators are cofactor-cleared by K5, and the
// verifier's generator MSM and row-commitment MLE folds are K5 and K6
// launches.
//
// What they compute is fixed down to the limb: the aux commitments' Jacobian
// x/y/z are absorbed by the Fiat-Shamir transcript, so both follow g1.py
// formula by formula over canonical Montgomery Fp values (any way of
// computing a canonical value gives the same bits). add is add-2007-bl and
// double is dbl-2009-l (g1.py:90-103). The JAX code selects branchlessly,
// in the order same -> double(p), q == O -> p, p == O -> q; here the same
// outcome: p == O returns q's limbs (so O + O returns q's), q == O returns
// p's, equal points return double(p), and p = -q runs the generic formula
// to (r^2, -r^3, 0). double passes a point with z = 0 through unchanged. A
// point with z = 0 is the identity whatever its x and y, and keeps those
// limbs. K5 stops after the scalar's highest set bit: past it the JAX loop
// only doubles acc, which no later step reads, so out is the same.
//
// What bounds them on an H100: the 32-bit multiply-adds of the Fp products
// (a generic add is 11 products and 5 squarings, a double 2 and 5), and,
// for K5, the chain of dependent products of one scalar: 256 bits, each a
// double and, on a set bit, an add. In one thread a 12-limb product is a
// serial carry chain of ~300 wide multiply-adds; a thread a point leaves
// the verifier's launches (6 to 18,432 points) latency-bound.
//
// K5's design: a point's two teams of lanes (csrc/fp_team.cuh, the teams of
// K4) run the products of each formula level side by side, one a team. The
// double of acc for bit b + 1 does not depend on the add into out at bit b,
// so a bit whose add runs is one stream of 12 product rounds (add_dbl: the
// add's 16 products and the double's 7), and a bit with no add 4 (dbl).
// Every decision (the bit, the identity cases, equal points, the top bit)
// is a select per point under warp-uniform control: a round runs when any
// point of the warp needs it, and every ballot and shuffle runs on every
// lane (no short-circuit around a team operation: with several points a
// warp, the points' tests differ). One formula code (Var), three layouts:
//   Team: one point a warp, a limb a lane (lanes 12-15 of a team idle);
//         every decision is the warp's own, so a bit with no add costs 4
//         rounds. The shortest chain (~1.8 ms a launch), but ~440
//         instructions a round: from a few thousand points the card's
//         instruction rate, not the chain, bounds it.
//   Quad: four points a warp, three limbs a lane: a quarter of Team's
//         instructions a point-round, a longer chain (~4.5 ms a launch),
//         and 12 rounds a bit unless the warp's four scalars agree, as a
//         fold level's do (one challenge a vector).
//   Solo: sixteen points a warp, a team one lane with the one-thread
//         arithmetic of field.cuh: the fewest instructions, the longest
//         chain (~11 ms a launch), and every bit runs add_dbl (ALWAYS_ADD):
//         best on thousands of points, the MSM's.
// zk_g1_scalar_mul picks the layout by the launch (QUAD_FROM, SOLO_FROM).
//
// K6's design: the kind of each pair (either side the identity, or
// generic) is known before any arithmetic, from the bits in bit mode and
// from the z limbs otherwise. A block classifies a tile of pairs (ADD_TILE,
// or fewer where the launch would then fill fewer than ADD_BLOCKS blocks),
// writes each identity or copy result at once, and appends each generic
// pair to a list in shared memory (a ballot and one atomic a warp); then
// its threads run the list densely, one thread a generic add. A warp thus
// runs generic adds on all its lanes but at the list's tail, where one
// thread a pair left ~70% of the lanes of a bit-mode level idle.
//
// K6 has a bit mode for the first level of a masked row sum
// (_commit_bits_rows): its leaves are bits[e] ? G[e mod gen] : O, read from
// the 0/1 words and the generator vector (read-only path), so the (m, gen)
// leaf points are never stored (2.4 GB for a zkdl256 mag_bin commitment).
// Pairs (2i, 2i + 1) of one level never straddle two rows when the row
// width is even.
//
// C interface (loaded with ctypes): each function launches on the given
// stream and device and returns cudaGetLastError(). Point operands are
// three (x, y, z) word pointers with an element stride in words (12 for a
// contiguous vector, 24 for every other element of one); outputs are
// contiguous.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "fp_team.cuh"
#include "g1_var.cuh"

namespace {

// K5's layout by the launch (the crossovers measured in PERF.md):
// one point a warp is the shortest chain; four points a warp the fewest
// instructions a point of the team layouts, best where a warp's scalars
// agree (the fold's levels); sixteen points a warp the fewest of all and
// the longest chain, best on the MSM's thousands of points
constexpr int64_t QUAD_FROM = 2560;
constexpr int64_t SOLO_FROM = 8192;
constexpr int ADD_THREADS = 128;
constexpr int ADD_MIN_BLOCKS = 3;
constexpr int ADD_TILE = 4096;  // the most pairs a K6 block classifies
constexpr int ADD_BLOCKS = 4 * 132;  // K6 takes a smaller tile until its launch has this many blocks

// out[i] = scalar_i * p[i]. PTS = 32 / T::POINT_LANES points a warp; the
// lanes of a warp's points past n mirror point n - 1 and store nothing.
template <class T>
__global__ void __launch_bounds__(Launch<T>::THREADS, Launch<T>::MIN_BLOCKS)
    g1_scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                         const uint32_t* __restrict__ pz, int64_t p_stride, const uint32_t* __restrict__ sc,
                         int64_t s_stride, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, int64_t n) {
  constexpr int PTS = 32 / T::POINT_LANES;
  using V = Var<T>;
  const int lane = threadIdx.x & 31;
  const int64_t first = ((int64_t)blockIdx.x * Launch<T>::THREADS + threadIdx.x) / 32 * PTS;
  if (first >= n) return;  // the whole warp
  const int pl = lane % T::POINT_LANES, pbase = lane - pl;
  const int64_t i = first + lane / T::POINT_LANES;
  const bool live = i < n;
  const int64_t src = live ? i : n - 1;
  const T tm(lane);
  const int64_t off = src * p_stride;
  typename V::Pt acc{tm.load(px, off), tm.load(py, off), tm.load(pz, off)};
  typename V::Pt out{};
  if constexpr (T::POINT_LANES >= 8) {
    // lane j < 8 of a point holds its scalar's word j; top: its highest set bit
    const uint32_t sw = pl < 8 ? __ldg(sc + src * s_stride + pl) : 0u;
    int top = sw ? 32 * pl + 31 - __clz(sw) : -1;
    top = max(top, __shfl_xor_sync(FULL, top, 1));
    top = max(top, __shfl_xor_sync(FULL, top, 2));
    top = max(top, __shfl_xor_sync(FULL, top, 4));
    top = __shfl_sync(FULL, top, pbase);
    const int last = __reduce_max_sync(FULL, top + 1) - 1;  // the warp's
#pragma unroll 1
    for (int b = 0; b <= last; ++b) {
      const bool bit = (__shfl_sync(FULL, sw, pbase + (b >> 5)) >> (b & 31)) & 1u;
      V::step(tm, out, acc, bit);
    }
  } else {
    // every lane holds its point's scalar
    uint32_t w[8];
    int top = -1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w[k] = __ldg(sc + src * s_stride + k);
      if (w[k]) top = 32 * k + 31 - __clz(w[k]);
    }
    const int last = __reduce_max_sync(FULL, top + 1) - 1;  // the warp's
#pragma unroll 1
    for (int b = 0; b <= last; ++b) V::step(tm, out, acc, (word_at(w, b >> 5) >> (b & 31)) & 1u);
  }
  if (live && tm.team == 0) {
    tm.store(ox, i * NL, out.x);
    tm.store(oy, i * NL, out.y);
    tm.store(oz, i * NL, out.z);
  }
}

// ---------------------------------------------------------------------------
// K6: one thread a generic add, over a block's compacted list
// ---------------------------------------------------------------------------

struct Pt {
  uint32_t x[NL], y[NL], z[NL];
};

__device__ __forceinline__ void fmul(const uint32_t* a, const uint32_t* b, uint32_t* r) { mont_mul<FpSpec>(a, b, r); }
__device__ __forceinline__ void fadd(const uint32_t* a, const uint32_t* b, uint32_t* r) { mod_add<FpSpec>(a, b, r); }
__device__ __forceinline__ void fsub(const uint32_t* a, const uint32_t* b, uint32_t* r) { mod_sub<FpSpec>(a, b, r); }
__device__ __forceinline__ void fdbl(const uint32_t* a, uint32_t* r) { mod_add<FpSpec>(a, a, r); }

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

// p = add(p, q) for p, q not the identity: add-2007-bl, equal points double.
__device__ __forceinline__ void g1_add_generic(Pt& p, const Pt& q) {
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

struct AddArgs {
  const uint32_t *px, *py, *pz;
  int64_t p_stride;
  const uint32_t *qx, *qy, *qz;  // in bit mode the generators' (px, py, pz)
  int64_t q_stride;
  int neg_q;
  const uint32_t* bits;  // null, or 2n 0/1 words (bit mode)
  int64_t gen;
  uint32_t *ox, *oy, *oz;
  int64_t n;
  int tile;  // pairs a block takes: a multiple of ADD_THREADS, at most ADD_TILE
};

// Word offsets of pair i's operands, -1 for a bit-mode leaf that is O.
__device__ __forceinline__ void operands(const AddArgs& a, int64_t i, int64_t& po, int64_t& qo) {
  if (a.bits != nullptr) {
    const int64_t e = 2 * i;
    po = __ldg(a.bits + e) ? (e % a.gen) * NL : -1;
    qo = __ldg(a.bits + e + 1) ? ((e + 1) % a.gen) * NL : -1;
  } else {
    po = i * a.p_stride;
    qo = i * a.q_stride;
  }
}

__device__ __forceinline__ bool is_identity(const uint32_t* z, int64_t off) {
  if (off < 0) return true;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) acc |= __ldg(z + off + k);
  return acc == 0;
}

__device__ __forceinline__ void load(Pt& p, const uint32_t* x, const uint32_t* y, const uint32_t* z, int64_t off) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    p.x[k] = off < 0 ? 0u : __ldg(x + off + k);
    p.y[k] = off < 0 ? 0u : __ldg(y + off + k);
    p.z[k] = off < 0 ? 0u : __ldg(z + off + k);
  }
}

__device__ __forceinline__ void load_q(Pt& q, const AddArgs& a, int64_t qo) {
  load(q, a.qx, a.qy, a.qz, qo);
  if (a.neg_q) {
    uint32_t z[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) z[k] = 0;
    fsub(z, q.y, q.y);  // fp.neg: 0 - y mod p
  }
}

// Output rows are 48-byte aligned in 16-byte-aligned (n, 12) vectors.
__device__ __forceinline__ void store_row(uint32_t* base, int64_t i, const uint32_t* v) {
  uint4* d = reinterpret_cast<uint4*>(base + i * NL);
#pragma unroll
  for (int w = 0; w < NL / 4; ++w) d[w] = make_uint4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
}

__device__ __forceinline__ void store(const Pt& p, const AddArgs& a, int64_t i) {
  store_row(a.ox, i, p.x);
  store_row(a.oy, i, p.y);
  store_row(a.oz, i, p.z);
}

// out[i] = add(p[i], q[i]) (q negated first when neg_q), or, in bit mode,
// add(leaf(2i), leaf(2i + 1)) with leaf(e) = bits[e] != 0 ? G[e mod gen] : O.
// Pass 1 writes every pair whose one side is the identity (p == O: q's
// limbs, else q == O: p's) and lists the generic pairs; pass 2 adds those.
__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS) g1_add_kernel(const AddArgs a) {
  __shared__ uint16_t list[ADD_TILE];
  __shared__ int count;
  const int64_t base = (int64_t)blockIdx.x * a.tile;
  const int m = a.n - base < a.tile ? (int)(a.n - base) : a.tile;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
#pragma unroll 1
  for (int j0 = 0; j0 < m; j0 += ADD_THREADS) {
    const int j = j0 + threadIdx.x;
    bool generic = false;
    if (j < m) {
      const int64_t i = base + j;
      int64_t po, qo;
      operands(a, i, po, qo);
      const bool p_id = is_identity(a.pz, po);
      if (p_id || is_identity(a.qz, qo)) {
        Pt r;
        if (p_id) load_q(r, a, qo);
        else load(r, a.px, a.py, a.pz, po);
        store(r, a, i);
      } else {
        generic = true;
      }
    }
    const unsigned mask = __ballot_sync(FULL, generic);
    int at = 0;
    if (lane == 0 && mask) at = atomicAdd(&count, __popc(mask));
    at = __shfl_sync(FULL, at, 0);
    if (generic) list[at + __popc(mask & ((1u << lane) - 1))] = (uint16_t)j;
  }
  __syncthreads();
  const int total = count;
#pragma unroll 1
  for (int g = threadIdx.x; g < total; g += ADD_THREADS) {
    const int64_t i = base + list[g];
    int64_t po, qo;
    operands(a, i, po, qo);
    Pt p, q;
    load(p, a.px, a.py, a.pz, po);
    load_q(q, a, qo);
    g1_add_generic(p, q);
    store(p, a, i);
  }
}

template <class T>
void launch_scalar_mul(const void* px, const void* py, const void* pz, long long p_stride, const void* scalars,
                       long long s_stride, void* ox, void* oy, void* oz, long long n, void* stream) {
  constexpr long long PER_BLOCK = Launch<T>::THREADS / T::POINT_LANES;  // points a block
  g1_scalar_mul_kernel<T><<<(unsigned)((n + PER_BLOCK - 1) / PER_BLOCK), Launch<T>::THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, p_stride, (const uint32_t*)scalars, s_stride,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
}

}  // namespace

// n >= 1 points; s_stride 8 (a scalar a point, (n, 8) raw words) or 0 (one
// scalar for all). form 1: one point a warp (Team); 2: four points a warp
// (Quad); 3: sixteen points a warp (Solo); 0: by the launch, the fastest
// measured (PERF.md): Team below QUAD_FROM points, Solo from
// SOLO_FROM points with a scalar each, Quad between (and above with one
// scalar for all). Every form gives the same bits.
extern "C" int zk_g1_scalar_mul_form(int form, const void* px, const void* py, const void* pz, long long p_stride,
                                     const void* scalars, long long s_stride, void* ox, void* oy, void* oz,
                                     long long n, void* stream, int device) {
  if (form == 0) form = n < QUAD_FROM ? 1 : (n >= SOLO_FROM && s_stride != 0) ? 3 : 2;
  if (n < 1 || n > (1ll << 32) || form < 1 || form > 3) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    if (form == 1) launch_scalar_mul<Team>(px, py, pz, p_stride, scalars, s_stride, ox, oy, oz, n, stream);
    else if (form == 2) launch_scalar_mul<Quad>(px, py, pz, p_stride, scalars, s_stride, ox, oy, oz, n, stream);
    else launch_scalar_mul<Solo>(px, py, pz, p_stride, scalars, s_stride, ox, oy, oz, n, stream);
  });
}

extern "C" int zk_g1_scalar_mul(const void* px, const void* py, const void* pz, long long p_stride,
                                const void* scalars, long long s_stride, void* ox, void* oy, void* oz,
                                long long n, void* stream, int device) {
  return zk_g1_scalar_mul_form(0, px, py, pz, p_stride, scalars, s_stride, ox, oy, oz, n, stream, device);
}

// n >= 1 sums. Bit mode: bits != null holds 2n words, the generators of
// length gen >= 1 are (px, py, pz), and q and the strides are not read.
// n >= 1 sums. Bit mode: bits != null holds 2n words, the generators of
// length gen >= 1 are (px, py, pz), and q and the strides are not read.
extern "C" int zk_g1_add(const void* px, const void* py, const void* pz, long long p_stride, const void* qx,
                         const void* qy, const void* qz, long long q_stride, int neg_q, const void* bits,
                         long long gen, void* ox, void* oy, void* oz, long long n, void* stream, int device) {
  if (n < 1 || n > ((long long)ADD_TILE << 31) || (bits != nullptr && gen < 1)) return (int)cudaErrorInvalidValue;
  // the tile: ADD_TILE pairs on a launch that fills ADD_BLOCKS blocks with
  // it, else the smallest multiple of ADD_THREADS that does (a tree's last
  // levels and the verifier's launches spread over the card)
  long long tile = (n + ADD_BLOCKS - 1) / ADD_BLOCKS;
  tile = (tile + ADD_THREADS - 1) / ADD_THREADS * ADD_THREADS;
  tile = tile < ADD_TILE ? tile : ADD_TILE;
  AddArgs a{(const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, p_stride,
            (const uint32_t*)(bits ? px : qx), (const uint32_t*)(bits ? py : qy), (const uint32_t*)(bits ? pz : qz),
            q_stride, bits ? 0 : neg_q, (const uint32_t*)bits, gen,
            (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, (int)tile};
  return on_device(device, [&] {
    g1_add_kernel<<<(unsigned)((n + tile - 1) / tile), ADD_THREADS, 0, (cudaStream_t)stream>>>(a);
  });
}
