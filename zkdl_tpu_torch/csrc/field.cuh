// Montgomery arithmetic on 32-bit limbs for one thread: the device side of
// the Fr and Fp kernels (fr_kernels.cu, g1_comb.cu).
//
// The TPU kernels (zkdl_tpu/field/pallas_fr.py) split every u32 limb into two
// 16-bit digits because the TPU's vector unit has no 32x32->64 multiply.
// Hopper has one (IMAD.WIDE), so here a product is the textbook CIOS loop on
// 32-bit words with 64-bit intermediates, followed by one conditional
// subtraction. Inputs must satisfy a*b < p*R (true for canonical operands);
// outputs are canonical (< p), hence bit-identical to the JAX package's
// Montgomery product whatever the algorithm.
#pragma once

#include <cstdint>

struct FrSpec {
  static constexpr int N = 8;
  static constexpr uint32_t NP0 = 0xffffffffu;  // -p^-1 mod 2^32
  __device__ static uint32_t p(int i) {
    constexpr uint32_t P[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                               0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
    return P[i];
  }
};

struct FpSpec {
  static constexpr int N = 12;
  static constexpr uint32_t NP0 = 0xfffcfffdu;
  __device__ static uint32_t p(int i) {
    constexpr uint32_t P[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                                0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                                0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return P[i];
  }
};

// r = t - p if t (with overflow word hi) >= p, else t.
template <class F>
__device__ __forceinline__ void sub_p_if_gte(const uint32_t* t, uint32_t hi, uint32_t* r) {
  constexpr int N = F::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t s = (uint64_t)t[i] - F::p(i) - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = ge ? d[i] : t[i];
}

// r = a * b * 2^(-32N) mod p (CIOS). r may alias a or b.
template <class F>
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: never overflows
      uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::NP0;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  sub_p_if_gte<F>(t, t[N], r);
}

// r = (a + b) mod p for canonical a, b.
template <class F>
__device__ __forceinline__ void mod_add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  constexpr int N = F::N;
  uint32_t s[N];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  sub_p_if_gte<F>(s, c, r);
}

// r = (a - b) mod p for canonical a, b.
template <class F>
__device__ __forceinline__ void mod_sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  constexpr int N = F::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 32) & 1u;
  }
  // on borrow add p back (the carry out of the top limb is dropped)
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)d[i] + (borrow ? F::p(i) : 0u) + c;
    r[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ bool equal(const uint32_t* a, const uint32_t* b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a[i] ^ b[i];
  return acc == 0;
}
