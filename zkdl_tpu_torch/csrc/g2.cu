// K11 and K12: BLS12-381 G2 (the twist over Fp2) scalar multiplication and
// point addition.
//
// g2_team_kernel (K11) replaces zkdl_tpu/curve/g2.py:scalar_mul (:148-161,
// jitted at :164), an XLA loop on the TPU (no Pallas kernel): for each
// point P and raw scalar k, from acc = (0, 0, 0) over k's 256 bits from the
// lowest, acc = add(acc, P) where the bit is set, then P = double(P); the
// LSB-first double-and-add of G1's K5. g2_add_kernel (K12) replaces
// g2.py:add (:86-112), the step of g2_sum's tree (:167-188) and so of msm
// (:191): one add a pair, the pairs read at any stride (a tree level's
// halves p[0::2], p[1::2]). The formulas are the JAX ones over Fp2 value
// for value (K12: csrc/jac.cuh; K11: the programs of csrc/g2_prog.cuh,
// written from zkdl_tpu_torch/curve/g2_program.py), with jac.cuh's selects
// in g1.py's order (an identity operand, equal points double the first,
// p + (-p) runs the generic formula to z = 0), so the Jacobian limbs equal
// the JAX function's (the points need not lie in the r-torsion subgroup:
// none of this assumes it).
//
// What is skipped: the doubles of P past k's highest set bit (P is not read
// again). A set bit's add and a double run where the JAX loop selects
// them; the results are the same limbs.
//
// What bounds it on an H100: the 32-bit multiply-adds of the Fp products,
// an Fp2 product 3 and a squaring 2 of them, a double 16, a generic add
// 43 (chip_smoke.py's g2_bound), against 288 bytes a point in and out and
// 32 a scalar. In practice, as for K8, the chain of dependent products
// where a launch has fewer warps than the card's schedulers, and the
// schedulers' issue above that.
//
// K11's design: a team of L lanes a point (forms "four", "eight",
// "sixteen": L = 4, 8, 16), the point's values in shared memory, one Fp
// value a 48-byte slot (a point's workspace: acc, base, the entry being
// added, which the programs' output overwrites, the compared values and the
// formulas' temporaries, slots assigned by liveness: 54-55 a point). A G2 point is
// 72 words; two of them and an add's temporaries do not fit 255 registers,
// so, unlike K8, no lane holds a point: a stage of a program is a set of
// independent Fp products (or sums) that the team's lanes share out, each
// lane reading its operands from their slots and writing its result to
// one, and the team meets after each stage (__syncwarp). The programs are
// tables in constant memory; a lane picks its operation by its index, so a
// round costs one Montgomery product a lane (fp_chain.cuh, K8's
// carry-chain product) and no selects of operands. An add (43 products)
// runs in 12 rounds on 4 lanes, 7 on 8, 5 on 16; a double (16) in 4, 3, 3.
// The doubles of base and the adds into acc run as steps of their own:
// each double pushes the new base onto the point's ring (16 entries in a
// device scratch) where its bit is set, each add pops the oldest, and the
// warp adds where a ring is full or the doubles are done, so the adds'
// lanes work for points that have a base to add: a warp that ran the add
// at every bit would pay for ~1.6x the walk's products. Then jac_add's
// selects on each point: acc == O takes the entry, entry == O keeps acc,
// equal points (rare: U1 == U2 and S1 == S2, compared canonical) take
// DACC's double(acc), run only where some point of the warp needs it; a
// double of an identity base keeps its limbs. Values inside a program are
// lazy (below 2p); every value stored as a coordinate or compared is
// canonical. g2_form picks the form by the launch and the card's SM count.
//
// C interface (loaded with ctypes): points are (n, 72) uint32 words, x.c0,
// x.c1, y.c0, y.c1, z.c0, z.c1 (12 each, Montgomery); each function launches
// on the given stream and device and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_prog.cuh"
#include "jac.cuh"

namespace {

constexpr int PW = 6 * NW;  // words of a point
constexpr int THREADS = 128;

using G2 = Jac<F2>;

__device__ __forceinline__ Fq load_fq(const uint32_t* p) {
  Fq f;
#pragma unroll
  for (int k = 0; k < NW; ++k) f.w[k] = p[k];
  return f;
}

__device__ __forceinline__ void store_fq(uint32_t* p, const Fq& f) {
#pragma unroll
  for (int k = 0; k < NW; ++k) p[k] = f.w[k];
}

__device__ __forceinline__ G2 load_point(const uint32_t* p) {
  return {{load_fq(p), load_fq(p + NW)}, {load_fq(p + 2 * NW), load_fq(p + 3 * NW)},
          {load_fq(p + 4 * NW), load_fq(p + 5 * NW)}};
}

__device__ __forceinline__ void store_point(uint32_t* p, const G2& v) {
  store_fq(p, v.x.c0);
  store_fq(p + NW, v.x.c1);
  store_fq(p + 2 * NW, v.y.c0);
  store_fq(p + 3 * NW, v.y.c1);
  store_fq(p + 4 * NW, v.z.c0);
  store_fq(p + 5 * NW, v.z.c1);
}

// --- K11: the walk on a team of lanes ----------------------------------------

constexpr int POINT_VECS = PW / 4;  // 16-byte pieces of a point

// A point's workspace in shared memory: slot s is words [12 s, 12 s + 12).
__device__ __forceinline__ Fq ws_load(const uint32_t* W, int slot) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(W + slot * NW);
  Fq f;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(f.w[4 * q]), "=r"(f.w[4 * q + 1]), "=r"(f.w[4 * q + 2]), "=r"(f.w[4 * q + 3])
                 : "r"(a + 16 * q)
                 : "memory");
  return f;
}

__device__ __forceinline__ void ws_store(uint32_t* W, int slot, const Fq& f) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(W + slot * NW);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a + 16 * q), "r"(f.w[4 * q]),
                 "r"(f.w[4 * q + 1]), "r"(f.w[4 * q + 2]), "r"(f.w[4 * q + 3])
                 : "memory");
}

// add_lazy(v, v) for v < 2p, by a shift (2v < 4p fits 12 words)
__device__ __forceinline__ Fq dbl_lazy(const Fq& v) {
  Fq w;
  w.w[0] = v.w[0] << 1;
#pragma unroll
  for (int q = 1; q < NW; ++q) w.w[q] = __funnelshift_l(v.w[q - 1], v.w[q], 1);
  Fq t = w;
  const uint32_t below = minus_q(t);
  return pick(below, w, t);
}

// A sum's value: +-2^e[j] t[j] over its terms (the first positive), lazy,
// canonical where o->canon (one pick for both cases). A step computes both
// acc + v and acc - v and picks one: the two chains run side by side, so a
// step is as deep as one.
// The operation's fields are read from constant memory where they are
// used (a copy indexed by j would sit in local memory).
__device__ __forceinline__ Fq lin_value(const uint32_t* W, const G2Lin* o) {
  Fq acc = ws_load(W, o->t[0]);
#pragma unroll 1
  for (int e = 0; e < o->e[0]; ++e) acc = dbl_lazy(acc);
  const int n = o->n, neg = o->neg;
#pragma unroll 1
  for (int j = 1; j < n; ++j) {
    Fq v = ws_load(W, o->t[j]);
#pragma unroll 1
    for (int e = 0; e < o->e[j]; ++e) v = dbl_lazy(v);
    acc = pick((neg >> j) & 1 ? FULL : 0u, sub_lazy(acc, v), add_lazy(acc, v));
  }
  Fq t = acc;
  const uint32_t below = minus_p(t);
  return pick(below | (o->canon ? 0u : FULL), acc, t);
}

// Program `prog` on the point's workspace W, this lane being lane k of L.
template <int L>
__device__ __forceinline__ void run(uint32_t* W, int k, int prog) {
  using Tb = G2Tables<L>;
  const G2Prog pr = Tb::prog()[prog];
#pragma unroll 1
  for (int s = pr.first; s < pr.first + pr.n; ++s) {
    const G2Stage st = Tb::stage()[s];
    if (st.kind == 0) {
#pragma unroll 1
      for (int t = k; t < st.n; t += L) {
        const G2Mul o = Tb::mul()[st.first + t];
        ws_store(W, o.d, mont_mul(ws_load(W, o.a), ws_load(W, o.b)));
      }
    } else {
#pragma unroll 1
      for (int t = k; t < st.n; t += L) {
        const G2Lin* const o = Tb::lin() + st.first + t;
        ws_store(W, o->d, lin_value(W, o));
      }
    }
    __syncwarp();
  }
}

// the two canonical Fp values at slots s, s + 1 are 0
__device__ __forceinline__ bool ws_zero2(const uint32_t* W, int s) {
  const Fq a = ws_load(W, s), b = ws_load(W, s + 1);
  return FqOps::zero(a) && FqOps::zero(b);
}

// the Fp2 values at slots (a, a + 1) and (b, b + 1) are equal (canonical)
__device__ __forceinline__ bool ws_eq2(const uint32_t* W, int a, int b) {
  return FqOps::eq(ws_load(W, a), ws_load(W, b)) && FqOps::eq(ws_load(W, a + 1), ws_load(W, b + 1));
}

// the point at slots from .. from + 5 to slots to .. to + 5, a share a lane
template <int L>
__device__ __forceinline__ void ws_copy(uint4* W4, int from, int to, int k) {
#pragma unroll 1
  for (int q = k; q < POINT_VECS; q += L) W4[to * 3 + q] = W4[from * 3 + q];
}

// Each form's launch bounds (a block is one warp of 32 / L points; its
// shared memory 32 / L * SLOTS * 48 bytes: 21,120 for L = 4, 10,560 for 8,
// 5,184 for 16).
template <int L>
struct G2Launch;
template <>
struct G2Launch<4> {
  static constexpr int MIN_BLOCKS = 8;
};
template <>
struct G2Launch<8> {
  static constexpr int MIN_BLOCKS = 16;
};
template <>
struct G2Launch<16> {
  static constexpr int MIN_BLOCKS = 20;
};

// A point's ring: the bases 2^b P of its set bits b, doubled but not yet
// added, oldest first (words of device scratch: RING points a point).
constexpr int RING = 16;

// out[i] = k_i P_i, a team of L lanes a point. The walk's doubles of base
// and its adds into acc are steps of their own (DBL, ADD): a double pushes
// the new base onto the point's ring where its bit is set, an add pops the
// oldest. Each step, the warp adds where a ring is full or no point has a
// double left, and doubles otherwise, so that an add's lanes work for the
// points that have a base to add (in a step of both, every point would pay
// for an add at every bit: half of them are clear). The adds take the set
// bits' bases in order and the doubles run as in g2.py, so acc and base go
// through the JAX loop's values. A point past n has scalar 0: it doubles,
// adds and stores nothing.
template <int L>
__global__ void __launch_bounds__(32, G2Launch<L>::MIN_BLOCKS)
    g2_team_kernel(const uint32_t* __restrict__ pts, const uint32_t* __restrict__ scalars, long long scalar_stride,
                   uint32_t* ring, uint32_t* __restrict__ out, long long n) {
  constexpr int PTS = 32 / L;
  extern __shared__ uint4 g2_smem[];  // [PTS][SLOTS][3]
  __shared__ uint32_t ks[PTS][8];
  const int lane = threadIdx.x;
  const int pt = lane / L;
  const int k = lane % L;
  const long long i = (long long)blockIdx.x * PTS + pt;
  const bool live = i < n;
  const long long src = live ? i : n - 1;
  uint4* const W4 = g2_smem + pt * G2Tables<L>::SLOTS * 3;
  uint32_t* const W = reinterpret_cast<uint32_t*>(W4);
#pragma unroll
  for (int w = k; w < 8; w += L) ks[pt][w] = live ? __ldg(scalars + src * scalar_stride + w) : 0u;
  const uint4* const p4 = reinterpret_cast<const uint4*>(pts + src * PW);
#pragma unroll 1
  for (int q = k; q < POINT_VECS; q += L) {
    W4[G2_BASE * 3 + q] = __ldg(p4 + q);
    W4[G2_ACC * 3 + q] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncwarp();
  int top = -1;  // k's highest set bit
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (ks[pt][w]) top = 32 * w + 31 - __clz(ks[pt][w]);
  // this point's ring (a lane writes and reads back the same words of an entry)
  uint4* const R4 = reinterpret_cast<uint4*>(ring) + (live ? i : 0) * RING * POINT_VECS;
  int head = 0, tail = 0;  // entries popped and pushed
  auto push = [&]() {
    uint4* const e = R4 + (tail % RING) * POINT_VECS;
#pragma unroll 1
    for (int q = k; q < POINT_VECS; q += L) e[q] = W4[G2_BASE * 3 + q];
    ++tail;
  };
  if (ks[pt][0] & 1u) push();
  int b = 0;  // base holds 2^b P (for b <= top)
#pragma unroll 1
  for (;;) {
    const bool need = b < top;
    const int count = tail - head;
    const bool any_full = __any_sync(FULL, count == RING), any_need = __any_sync(FULL, need);
    if (any_full || (!any_need && __any_sync(FULL, count > 0))) {  // ADD: acc += the oldest base
      const bool pend = count > 0;
      if (pend) {
        const uint4* const e = R4 + (head % RING) * POINT_VECS;
#pragma unroll 1
        for (int q = k; q < POINT_VECS; q += L) W4[G2_ENT * 3 + q] = e[q];
      }
      __syncwarp();
      // jac_add's selects, in its order: acc == O takes the entry (now: ADD
      // writes its output over the entry), the entry == O keeps acc, equal
      // points take double(acc), the rest ADD's output
      const bool pO = ws_zero2(W, G2_ACC + 4), qO = ws_zero2(W, G2_ENT + 4);
      __syncwarp();  // every lane has read acc before it changes
      if (pend && pO) ws_copy<L>(W4, G2_ENT, G2_ACC, k);
      __syncwarp();
      run<L>(W, k, G2_ADD);
      const bool same = ws_eq2(W, G2_CMP, G2_CMP + 2) && ws_eq2(W, G2_CMP + 4, G2_CMP + 6);
      if (__any_sync(FULL, pend && !pO && !qO && same)) run<L>(W, k, G2_DACC);
      const int from = !pend || pO || qO ? -1 : same ? G2_DA : G2_OUT;
      if (from >= 0) ws_copy<L>(W4, from, G2_ACC, k);  // (no lane reads acc after ADD)
      __syncwarp();
      head += pend;
    } else if (any_need) {  // DBL: base = double(base); push it where its bit is set
      run<L>(W, k, G2_DBL);
      const bool keep = !need || ws_zero2(W, G2_BASE + 4);  // jac_double keeps an identity as it is
      __syncwarp();
      if (!keep) ws_copy<L>(W4, G2_OUT, G2_BASE, k);
      __syncwarp();
      ++b;
      if (need && ((ks[pt][b >> 5] >> (b & 31)) & 1u)) push();
    } else {
      break;
    }
  }
  if (live) {
    uint4* const o4 = reinterpret_cast<uint4*>(out + i * PW);
#pragma unroll 1
    for (int q = k; q < POINT_VECS; q += L) o4[q] = W4[G2_ACC * 3 + q];
  }
}

template <int L>
cudaError_t launch_team(const void* pts, const void* scalars, long long scalar_stride, void* ring, void* out,
                        long long n, void* stream) {
  constexpr long long PTS = 32 / L;
  const auto kernel = g2_team_kernel<L>;
  const int smem = (int)(PTS * G2Tables<L>::SLOTS * NW * 4);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((n + PTS - 1) / PTS), 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)scalars, scalar_stride, (uint32_t*)ring, (uint32_t*)out, n);
  return cudaSuccess;
}

// K11's forms: 1 four, 2 eight, 3 sixteen lanes a point; 0 by the launch:
// sixteen while every warp has a scheduler of its own (two points a warp,
// four schedulers an SM), eight up to 32 points an SM, four from there
// (PERF.md's sweep). Sets form to the one that runs.
constexpr int G2_FORMS = 3;

cudaError_t g2_form(int& form, long long n, int device) {
  if (form != 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  form = n <= 8ll * sms ? 3 : n <= 32ll * sms ? 2 : 1;
  return err;
}

__global__ void __launch_bounds__(THREADS) g2_add_kernel(const uint32_t* __restrict__ p, long long sp,
                                                         const uint32_t* __restrict__ q, long long sq,
                                                         uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(out + i * PW, jac_add<F2>(load_point(p + i * sp), load_point(q + i * sq)));
}

int finish(int prev) {
  const cudaError_t e = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)e;
}

int enter(int device, int* prev) {
  cudaError_t e = cudaGetDevice(prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  return (int)e;
}

}  // namespace

extern "C" {

// Words of device scratch (the rings) a launch of n points needs.
long long zk_g2_scalar_mul_scratch_words(long long n) { return n * RING * PW; }

// out[i] = k_i P_i; scalars (n, 8) raw uint32 (scalar_stride 8) or one (8,)
// for all (scalar_stride 0); ring: zk_g2_scalar_mul_scratch_words(n) words;
// form as g2_form. Every form gives the same bits.
int zk_g2_scalar_mul(int form, const void* pts, const void* scalars, long long scalar_stride, void* ring, void* out,
                     long long n, void* stream, int device) {
  if (n <= 0) return 0;
  if (n > (1ll << 32) || form < 0 || form > G2_FORMS || ring == nullptr) return (int)cudaErrorInvalidValue;
  int prev = 0;
  int rc = enter(device, &prev);
  if (rc) return rc;
  rc = (int)g2_form(form, n, device);
  if (rc == 0) {
    switch (form) {
      case 1: rc = (int)launch_team<4>(pts, scalars, scalar_stride, ring, out, n, stream); break;
      case 2: rc = (int)launch_team<8>(pts, scalars, scalar_stride, ring, out, n, stream); break;
      default: rc = (int)launch_team<16>(pts, scalars, scalar_stride, ring, out, n, stream); break;
    }
  }
  const int last = finish(prev);
  return rc ? rc : last;
}

// out[i] = add(p[i], q[i]); point i of p at p + i sp words (72 for a
// contiguous vector, 144 for a tree level's halves), of q at q + i sq.
int zk_g2_add(const void* p, long long sp, const void* q, long long sq, void* out, long long n, void* stream,
              int device) {
  if (n <= 0) return 0;
  int prev = 0;
  const int rc = enter(device, &prev);
  if (rc) return rc;
  g2_add_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, sp, (const uint32_t*)q, sq, (uint32_t*)out, n);
  return finish(prev);
}

}  // extern "C"
