// K8's Fp arithmetic (csrc/g1_glv.cu): a BLS12-381 base-field value is 12
// 32-bit words, little-endian, held by one thread, in Montgomery form.
//
// The product (mont_mul) is CIOS, operand scanning over b's words with a
// reduction step after each, and its multiply-adds run in PTX carry chains.
// As in K3's fr_dot (csrc/fr_kernels.cu:mul_acc) the accumulator is split
// by the parity of its word pairs: a_j b_i of even j lands on the word
// pairs (j, j + 1) of the "even" array, of odd j on those of the "odd"
// array (its word k sits at position k + 1), so each half is one chain of
// mad.lo.cc / madc.hi.cc pairs, which ptxas fuses into IMAD.WIDE.U32.X, and
// the two halves of a step run side by side. Each chain is one asm
// statement: the carry flag lives only inside it.
//
// p < 2^381 leaves three spare top bits, so the accumulator needs no word
// past 12 positions and no carry word (field.cuh's mont_mul carries two):
// with a, b < 2p, every partial result T_i of the loop is below a + p <
// 3p, and before its division by 2^32 below 3p (2^32 + 1) < 2^415, so
//   - either array alone is at most the whole sum: the odd array stays below
//     2^383 (12 words, top word < 2^31), and the chains that end on its top
//     word (odd_shift, odd_red) and the carries into it (even_mad,
//     even_red) never carry out;
//   - the result (a b + M p) / 2^384 < a b / 2^384 + p < 0.41 p + p < 2p.
// Dividing by 2^32 moves no word: the odd array becomes the next step's
// even array, and the next step's odd products are added to the even array
// shifted two words down (odd_shift), so the two arrays swap roles every
// step.
//
// Lazy values: mont_mul takes a, b < 2p and returns a value < 2p (no final
// subtraction); add, sub and dbl take values < 2p and return values in
// [0, 2p). canon reduces a value < 2p to [0, p). The formulas of g1_glv.cu
// keep values lazy inside a formula and reduce every value that is stored,
// returned or tested. tests/port/test_torch_glv_fp.py runs the asm
// statements of this file, instruction by instruction, against integers.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NW = 12;                 // words of an Fp value
constexpr uint32_t NP0 = 0xfffcfffdu;  // -p^-1 mod 2^32
constexpr unsigned FULL = 0xffffffffu;

// p and 2p, little-endian words (the chains' immediates)
constexpr uint32_t PW0 = 0xffffaaabu, PW1 = 0xb9feffffu, PW2 = 0xb153ffffu, PW3 = 0x1eabfffeu, PW4 = 0xf6b0f624u,
                   PW5 = 0x6730d2a0u, PW6 = 0xf38512bfu, PW7 = 0x64774b84u, PW8 = 0x434bacd7u, PW9 = 0x4b1ba7b6u,
                   PW10 = 0x397fe69au, PW11 = 0x1a0111eau;
constexpr uint32_t QW0 = 0xffff5556u, QW1 = 0x73fdffffu, QW2 = 0x62a7ffffu, QW3 = 0x3d57fffdu, QW4 = 0xed61ec48u,
                   QW5 = 0xce61a541u, QW6 = 0xe70a257eu, QW7 = 0xc8ee9709u, QW8 = 0x869759aeu, QW9 = 0x96374f6cu,
                   QW10 = 0x72ffcd34u, QW11 = 0x340223d4u;

struct Fq {
  uint32_t w[NW];
};

// --- the product's chains -----------------------------------------------------

// Step 0: x = a_even b (pairs at positions (2k, 2k + 1)), y = a_odd b (pairs
// at (2k + 1, 2k + 2)); the products of a half do not overlap: no carries.
__device__ __forceinline__ void mul_first(uint32_t (&x)[NW], uint32_t (&y)[NW], const uint32_t (&a)[NW], uint32_t b) {
#pragma unroll
  for (int k = 0; k < NW; k += 2) {
    x[k] = a[k] * b;
    x[k + 1] = __umulhi(a[k], b);
    y[k] = a[k + 1] * b;
    y[k + 1] = __umulhi(a[k + 1], b);
  }
}

// Step i >= 1, its odd half: x is the last step's even array (its word 0
// is 0 after the reduction), y0 word 0 of its odd array, which becomes the
// new even array. x's word 1 is added at position 0 (into y0), and x[k] =
// lo/hi(a_odd b) + x[k + 2]: x becomes the new odd array.
__device__ __forceinline__ void odd_shift(uint32_t (&x)[NW], uint32_t& y0, const uint32_t (&a)[NW], uint32_t b) {
  asm("add.cc.u32      %12, %12, %1;\n\t"
      "madc.lo.cc.u32  %0, %13, %19, %2;\n\t"
      "madc.hi.cc.u32  %1, %13, %19, %3;\n\t"
      "madc.lo.cc.u32  %2, %14, %19, %4;\n\t"
      "madc.hi.cc.u32  %3, %14, %19, %5;\n\t"
      "madc.lo.cc.u32  %4, %15, %19, %6;\n\t"
      "madc.hi.cc.u32  %5, %15, %19, %7;\n\t"
      "madc.lo.cc.u32  %6, %16, %19, %8;\n\t"
      "madc.hi.cc.u32  %7, %16, %19, %9;\n\t"
      "madc.lo.cc.u32  %8, %17, %19, %10;\n\t"
      "madc.hi.cc.u32  %9, %17, %19, %11;\n\t"
      "madc.lo.cc.u32  %10, %18, %19, 0;\n\t"
      "madc.hi.u32     %11, %18, %19, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]), "+r"(x[6]), "+r"(x[7]),
        "+r"(x[8]), "+r"(x[9]), "+r"(x[10]), "+r"(x[11]), "+r"(y0)
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]), "r"(b));
}

// Step i >= 1, its even half: y += a_even b; the carry out of y[11]
// (position 12) lands in x11, the odd array's top word.
__device__ __forceinline__ void even_mad(uint32_t (&y)[NW], uint32_t& x11, const uint32_t (&a)[NW], uint32_t b) {
  asm("mad.lo.cc.u32   %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32  %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32  %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32  %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32  %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32  %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32  %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32  %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32  %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32  %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32  %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32  %11, %18, %19, %11;\n\t"
      "addc.u32        %12, %12, 0;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]), "+r"(y[5]), "+r"(y[6]), "+r"(y[7]),
        "+r"(y[8]), "+r"(y[9]), "+r"(y[10]), "+r"(y[11]), "+r"(x11)
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(a[8]), "r"(a[10]), "r"(b));
}

// The reduction's odd half: the odd array x += p_odd m.
__device__ __forceinline__ void odd_red(uint32_t (&x)[NW], uint32_t m) {
  asm("mad.lo.cc.u32   %0, %12, %13, %0;\n\t"
      "madc.hi.cc.u32  %1, %12, %13, %1;\n\t"
      "madc.lo.cc.u32  %2, %12, %14, %2;\n\t"
      "madc.hi.cc.u32  %3, %12, %14, %3;\n\t"
      "madc.lo.cc.u32  %4, %12, %15, %4;\n\t"
      "madc.hi.cc.u32  %5, %12, %15, %5;\n\t"
      "madc.lo.cc.u32  %6, %12, %16, %6;\n\t"
      "madc.hi.cc.u32  %7, %12, %16, %7;\n\t"
      "madc.lo.cc.u32  %8, %12, %17, %8;\n\t"
      "madc.hi.cc.u32  %9, %12, %17, %9;\n\t"
      "madc.lo.cc.u32  %10, %12, %18, %10;\n\t"
      "madc.hi.u32     %11, %12, %18, %11;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]), "+r"(x[6]), "+r"(x[7]),
        "+r"(x[8]), "+r"(x[9]), "+r"(x[10]), "+r"(x[11])
      : "r"(m), "n"(PW1), "n"(PW3), "n"(PW5), "n"(PW7), "n"(PW9), "n"(PW11));
}

// The reduction's even half: the even array y += p_even m (its word 0
// becomes 0); the carry out of y[11] lands in x11.
__device__ __forceinline__ void even_red(uint32_t (&y)[NW], uint32_t& x11, uint32_t m) {
  asm("mad.lo.cc.u32   %0, %13, %14, %0;\n\t"
      "madc.hi.cc.u32  %1, %13, %14, %1;\n\t"
      "madc.lo.cc.u32  %2, %13, %15, %2;\n\t"
      "madc.hi.cc.u32  %3, %13, %15, %3;\n\t"
      "madc.lo.cc.u32  %4, %13, %16, %4;\n\t"
      "madc.hi.cc.u32  %5, %13, %16, %5;\n\t"
      "madc.lo.cc.u32  %6, %13, %17, %6;\n\t"
      "madc.hi.cc.u32  %7, %13, %17, %7;\n\t"
      "madc.lo.cc.u32  %8, %13, %18, %8;\n\t"
      "madc.hi.cc.u32  %9, %13, %18, %9;\n\t"
      "madc.lo.cc.u32  %10, %13, %19, %10;\n\t"
      "madc.hi.cc.u32  %11, %13, %19, %11;\n\t"
      "addc.u32        %12, %12, 0;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]), "+r"(y[5]), "+r"(y[6]), "+r"(y[7]),
        "+r"(y[8]), "+r"(y[9]), "+r"(y[10]), "+r"(y[11]), "+r"(x11)
      : "r"(m), "n"(PW0), "n"(PW2), "n"(PW4), "n"(PW6), "n"(PW8), "n"(PW10));
}

// After the last step: x (the odd array) += y (the even array) / 2^32, the
// result (y[0] is 0).
__device__ __forceinline__ void merge(uint32_t (&x)[NW], const uint32_t (&y)[NW]) {
  asm("add.cc.u32      %0, %0, %12;\n\t"
      "addc.cc.u32     %1, %1, %13;\n\t"
      "addc.cc.u32     %2, %2, %14;\n\t"
      "addc.cc.u32     %3, %3, %15;\n\t"
      "addc.cc.u32     %4, %4, %16;\n\t"
      "addc.cc.u32     %5, %5, %17;\n\t"
      "addc.cc.u32     %6, %6, %18;\n\t"
      "addc.cc.u32     %7, %7, %19;\n\t"
      "addc.cc.u32     %8, %8, %20;\n\t"
      "addc.cc.u32     %9, %9, %21;\n\t"
      "addc.cc.u32     %10, %10, %22;\n\t"
      "addc.u32        %11, %11, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]), "+r"(x[6]), "+r"(x[7]),
        "+r"(x[8]), "+r"(x[9]), "+r"(x[10]), "+r"(x[11])
      : "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]),
        "r"(y[10]), "r"(y[11]));
}

// a b 2^-384 mod p, for a, b < 2p: a value < 2p.
__device__ __forceinline__ Fq mont_mul(const Fq& a, const Fq& b) {
  uint32_t x[NW], y[NW];
  mul_first(x, y, a.w, b.w[0]);
  uint32_t m = x[0] * NP0;
  odd_red(y, m);
  even_red(x, y[11], m);
#pragma unroll
  for (int i = 1; i < NW; i += 2) {
    // odd step: the even array is x, the odd y; after it, y and x
    odd_shift(x, y[0], a.w, b.w[i]);
    even_mad(y, x[11], a.w, b.w[i]);
    m = y[0] * NP0;
    odd_red(x, m);
    even_red(y, x[11], m);
    if (i + 1 < NW) {  // even step: the roles swap back
      odd_shift(y, x[0], a.w, b.w[i + 1]);
      even_mad(x, y[11], a.w, b.w[i + 1]);
      m = x[0] * NP0;
      odd_red(y, m);
      even_red(x, y[11], m);
    }
  }
  merge(x, y);  // after step 11 the even array is y, the odd x
  Fq r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = x[k];
  return r;
}

// --- sums, differences, reduction -------------------------------------------

// a where mask is all ones, b where it is 0 (word by word). One lop3 a
// word in asm: as C, LLVM turns a select of two values into a select of
// their addresses, which puts both in local memory.
__device__ __forceinline__ Fq pick(uint32_t mask, const Fq& a, const Fq& b) {
  Fq r;
#pragma unroll
  for (int k = 0; k < NW; ++k) asm("lop3.b32 %0, %1, %2, %3, 0xe4;" : "=r"(r.w[k]) : "r"(a.w[k]), "r"(b.w[k]), "r"(mask));
  return r;
}

// v -= 2p (minus_q) or p (minus_p), returning the borrow out as a mask
__device__ __forceinline__ uint32_t minus_q(Fq& v) {
  uint32_t mask;
  asm("sub.cc.u32      %0, %0, %13;\n\t"
      "subc.cc.u32     %1, %1, %14;\n\t"
      "subc.cc.u32     %2, %2, %15;\n\t"
      "subc.cc.u32     %3, %3, %16;\n\t"
      "subc.cc.u32     %4, %4, %17;\n\t"
      "subc.cc.u32     %5, %5, %18;\n\t"
      "subc.cc.u32     %6, %6, %19;\n\t"
      "subc.cc.u32     %7, %7, %20;\n\t"
      "subc.cc.u32     %8, %8, %21;\n\t"
      "subc.cc.u32     %9, %9, %22;\n\t"
      "subc.cc.u32     %10, %10, %23;\n\t"
      "subc.cc.u32     %11, %11, %24;\n\t"
      "subc.u32        %12, 0, 0;"
      : "+r"(v.w[0]), "+r"(v.w[1]), "+r"(v.w[2]), "+r"(v.w[3]), "+r"(v.w[4]), "+r"(v.w[5]), "+r"(v.w[6]),
        "+r"(v.w[7]), "+r"(v.w[8]), "+r"(v.w[9]), "+r"(v.w[10]), "+r"(v.w[11]), "=r"(mask)
      : "n"(QW0), "n"(QW1), "n"(QW2), "n"(QW3), "n"(QW4), "n"(QW5), "n"(QW6), "n"(QW7), "n"(QW8), "n"(QW9), "n"(QW10),
        "n"(QW11));
  return mask;
}
__device__ __forceinline__ uint32_t minus_p(Fq& v) {
  uint32_t mask;
  asm("sub.cc.u32      %0, %0, %13;\n\t"
      "subc.cc.u32     %1, %1, %14;\n\t"
      "subc.cc.u32     %2, %2, %15;\n\t"
      "subc.cc.u32     %3, %3, %16;\n\t"
      "subc.cc.u32     %4, %4, %17;\n\t"
      "subc.cc.u32     %5, %5, %18;\n\t"
      "subc.cc.u32     %6, %6, %19;\n\t"
      "subc.cc.u32     %7, %7, %20;\n\t"
      "subc.cc.u32     %8, %8, %21;\n\t"
      "subc.cc.u32     %9, %9, %22;\n\t"
      "subc.cc.u32     %10, %10, %23;\n\t"
      "subc.cc.u32     %11, %11, %24;\n\t"
      "subc.u32        %12, 0, 0;"
      : "+r"(v.w[0]), "+r"(v.w[1]), "+r"(v.w[2]), "+r"(v.w[3]), "+r"(v.w[4]), "+r"(v.w[5]), "+r"(v.w[6]),
        "+r"(v.w[7]), "+r"(v.w[8]), "+r"(v.w[9]), "+r"(v.w[10]), "+r"(v.w[11]), "=r"(mask)
      : "n"(PW0), "n"(PW1), "n"(PW2), "n"(PW3), "n"(PW4), "n"(PW5), "n"(PW6), "n"(PW7), "n"(PW8), "n"(PW9), "n"(PW10),
        "n"(PW11));
  return mask;
}

// v += y; the carry out is dropped (none where the sum fits, or where it
// cancels a borrow)
__device__ __forceinline__ void plus(Fq& v, const Fq& y) {
  asm("add.cc.u32      %0, %0, %12;\n\t"
      "addc.cc.u32     %1, %1, %13;\n\t"
      "addc.cc.u32     %2, %2, %14;\n\t"
      "addc.cc.u32     %3, %3, %15;\n\t"
      "addc.cc.u32     %4, %4, %16;\n\t"
      "addc.cc.u32     %5, %5, %17;\n\t"
      "addc.cc.u32     %6, %6, %18;\n\t"
      "addc.cc.u32     %7, %7, %19;\n\t"
      "addc.cc.u32     %8, %8, %20;\n\t"
      "addc.cc.u32     %9, %9, %21;\n\t"
      "addc.cc.u32     %10, %10, %22;\n\t"
      "addc.u32        %11, %11, %23;"
      : "+r"(v.w[0]), "+r"(v.w[1]), "+r"(v.w[2]), "+r"(v.w[3]), "+r"(v.w[4]), "+r"(v.w[5]), "+r"(v.w[6]),
        "+r"(v.w[7]), "+r"(v.w[8]), "+r"(v.w[9]), "+r"(v.w[10]), "+r"(v.w[11])
      : "r"(y.w[0]), "r"(y.w[1]), "r"(y.w[2]), "r"(y.w[3]), "r"(y.w[4]), "r"(y.w[5]), "r"(y.w[6]), "r"(y.w[7]),
        "r"(y.w[8]), "r"(y.w[9]), "r"(y.w[10]), "r"(y.w[11]));
}

// v -= y, returning the borrow out as a mask
__device__ __forceinline__ uint32_t minus(Fq& v, const Fq& y) {
  uint32_t mask;
  asm("sub.cc.u32      %0, %0, %13;\n\t"
      "subc.cc.u32     %1, %1, %14;\n\t"
      "subc.cc.u32     %2, %2, %15;\n\t"
      "subc.cc.u32     %3, %3, %16;\n\t"
      "subc.cc.u32     %4, %4, %17;\n\t"
      "subc.cc.u32     %5, %5, %18;\n\t"
      "subc.cc.u32     %6, %6, %19;\n\t"
      "subc.cc.u32     %7, %7, %20;\n\t"
      "subc.cc.u32     %8, %8, %21;\n\t"
      "subc.cc.u32     %9, %9, %22;\n\t"
      "subc.cc.u32     %10, %10, %23;\n\t"
      "subc.cc.u32     %11, %11, %24;\n\t"
      "subc.u32        %12, 0, 0;"
      : "+r"(v.w[0]), "+r"(v.w[1]), "+r"(v.w[2]), "+r"(v.w[3]), "+r"(v.w[4]), "+r"(v.w[5]), "+r"(v.w[6]),
        "+r"(v.w[7]), "+r"(v.w[8]), "+r"(v.w[9]), "+r"(v.w[10]), "+r"(v.w[11]), "=r"(mask)
      : "r"(y.w[0]), "r"(y.w[1]), "r"(y.w[2]), "r"(y.w[3]), "r"(y.w[4]), "r"(y.w[5]), "r"(y.w[6]), "r"(y.w[7]),
        "r"(y.w[8]), "r"(y.w[9]), "r"(y.w[10]), "r"(y.w[11]));
  return mask;
}

// x + y for x, y < 2p: in [0, 2p). The sum is below 4p < 2^384; 2p comes
// off unless that borrows.
__device__ __forceinline__ Fq add_lazy(const Fq& x, const Fq& y) {
  Fq s = x;
  plus(s, y);
  Fq t = s;
  const uint32_t below = minus_q(t);
  return pick(below, s, t);
}

// x - y for x, y < 2p: in [0, 2p). Where it borrows, 2p is added back
// (its carry out cancels the borrow).
__device__ __forceinline__ Fq sub_lazy(const Fq& x, const Fq& y) {
  Fq d = x;
  const uint32_t borrow = minus(d, y);
  const Fq q{{QW0 & borrow, QW1 & borrow, QW2 & borrow, QW3 & borrow, QW4 & borrow, QW5 & borrow, QW6 & borrow,
              QW7 & borrow, QW8 & borrow, QW9 & borrow, QW10 & borrow, QW11 & borrow}};
  plus(d, q);
  return d;
}

// x mod p for x < 2p: canonical.
__device__ __forceinline__ Fq canon(const Fq& x) {
  Fq t = x;
  const uint32_t below = minus_p(t);
  return pick(below, x, t);
}

// --- layouts -------------------------------------------------------------------
//
// Each holds every value of a point on each of its lanes; they differ in
// where a round's independent products run.

struct FqOps {
  using Fp = Fq;
  __device__ __forceinline__ static Fq add(const Fq& x, const Fq& y) { return add_lazy(x, y); }
  __device__ __forceinline__ static Fq dbl(const Fq& x) { return add_lazy(x, x); }
  __device__ __forceinline__ static Fq sub(const Fq& x, const Fq& y) { return sub_lazy(x, y); }
  __device__ __forceinline__ static Fq canon(const Fq& x) { return ::canon(x); }
  __device__ __forceinline__ static Fq mul(const Fq& a, const Fq& b) { return mont_mul(a, b); }
  __device__ __forceinline__ static Fq sel(bool c, const Fq& a, const Fq& b) { return pick(c ? FULL : 0u, a, b); }
  // canonical values only
  __device__ __forceinline__ static bool zero(const Fq& v) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) acc |= v.w[k];
    return acc == 0;
  }
  __device__ __forceinline__ static bool eq(const Fq& a, const Fq& b) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) acc |= a.w[k] ^ b.w[k];
    return acc == 0;
  }
};

// Pair: two lanes a point (lanes 2j and 2j + 1 its j-th), each running one
// of a round's products; the two meet by twelve shuffles.
struct Pair : FqOps {
  static constexpr int POINT_LANES = 2;
  int team;  // 0 or 1 within the point
  __device__ __forceinline__ explicit Pair(int lane) : team(lane & 1) {}
  __device__ __forceinline__ void mul2(const Fq& x0, const Fq& y0, const Fq& x1, const Fq& y1, Fq& o0, Fq& o1) const {
    const Fq z = mont_mul(sel(team, x1, x0), sel(team, y1, y0));
    Fq other;
#pragma unroll
    for (int k = 0; k < NW; ++k) other.w[k] = __shfl_xor_sync(FULL, z.w[k], 1);
    o0 = sel(team, other, z);
    o1 = sel(team, z, other);
  }
};

// Four: four lanes a point (lanes 4j .. 4j + 3 its j-th), each running one
// of a round's products (rounds of up to four: g1_glv.cu's 3-round double
// and 5-round add); every lane gets every product by shuffles. Where a
// round has fewer products, the spare lanes repeat one.
struct Four : FqOps {
  static constexpr int POINT_LANES = 4;
  int k;     // lane within the point
  int base;  // the point's first lane
  __device__ __forceinline__ explicit Four(int lane) : k(lane & 3), base(lane & ~3) {}
  // every lane's copy of lane base + j's z
  __device__ __forceinline__ Fq from(const Fq& z, int j) const {
    Fq o;
#pragma unroll
    for (int w = 0; w < NW; ++w) o.w[w] = __shfl_sync(FULL, z.w[w], base + j);
    return o;
  }
  __device__ __forceinline__ void mul4(const Fq& x0, const Fq& y0, const Fq& x1, const Fq& y1, const Fq& x2, const Fq& y2,
                       const Fq& x3, const Fq& y3, Fq& o0, Fq& o1, Fq& o2, Fq& o3) const {
    const Fq z = mont_mul(sel(k & 2, sel(k & 1, x3, x2), sel(k & 1, x1, x0)),
                          sel(k & 2, sel(k & 1, y3, y2), sel(k & 1, y1, y0)));
    o0 = from(z, 0);
    o1 = from(z, 1);
    o2 = from(z, 2);
    o3 = from(z, 3);
  }
  __device__ __forceinline__ void mul3(const Fq& x0, const Fq& y0, const Fq& x1, const Fq& y1, const Fq& x2, const Fq& y2, Fq& o0,
                       Fq& o1, Fq& o2) const {
    const Fq z = mont_mul(sel(k & 2, x2, sel(k & 1, x1, x0)), sel(k & 2, y2, sel(k & 1, y1, y0)));
    o0 = from(z, 0);
    o1 = from(z, 1);
    o2 = from(z, 2);
  }
  __device__ __forceinline__ void mul2(const Fq& x0, const Fq& y0, const Fq& x1, const Fq& y1, Fq& o0, Fq& o1) const {
    const Fq z = mont_mul(sel(k & 1, x1, x0), sel(k & 1, y1, y0));
    o0 = from(z, 0);
    o1 = from(z, 1);
  }
};

}  // namespace
