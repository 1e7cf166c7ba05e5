// Jacobian point formulas over Fp2 (G2) for one thread a point: the device
// side of K12 (csrc/g2.cu).
//
// The formulas are the JAX package's, value for value (zkdl_tpu/curve/g2.py
// :73-112, g1.py's EFD formulas over Fp2): dbl-2009-l, whose identity
// (z = 0) is returned as it is, and add-2007-bl with its selects in g1.py's
// order (equal points double(p), q == O gives p, p == O gives q; p + (-p)
// runs the generic formula to z = 0). Their results are fixed down to the limb, so each must be those
// formulas; how a value is computed is free. Inside a formula the values
// are lazy (csrc/fp_chain.cuh, K8's carry-chain Fp product: products, sums
// and differences below 2p); every value a formula returns, and every value
// it compares, is reduced first (canon), so points at rest are canonical.
//
// Fp2 = Fp[u]/(u^2 + 1) (zkdl_tpu/field/fp2.py): mul is Karatsuba (3 Fp
// products, fp2.py:74), sqr the complex squaring (2, :82).
#pragma once

#include "fp_chain.cuh"

namespace {

struct Fq2 {
  Fq c0, c1;
};

// Fp2 on the same lazy Fp ops
struct F2 {
  using T = Fq2;
  __device__ __forceinline__ static T add(const T& a, const T& b) { return {add_lazy(a.c0, b.c0), add_lazy(a.c1, b.c1)}; }
  __device__ __forceinline__ static T sub(const T& a, const T& b) { return {sub_lazy(a.c0, b.c0), sub_lazy(a.c1, b.c1)}; }
  __device__ __forceinline__ static T dbl(const T& a) { return {add_lazy(a.c0, a.c0), add_lazy(a.c1, a.c1)}; }
  // Karatsuba: (a0 b0 - a1 b1, (a0 + a1)(b0 + b1) - a0 b0 - a1 b1)
  __device__ __forceinline__ static T mul(const T& a, const T& b) {
    const Fq v0 = mont_mul(a.c0, b.c0);
    const Fq v1 = mont_mul(a.c1, b.c1);
    const Fq c = mont_mul(add_lazy(a.c0, a.c1), add_lazy(b.c0, b.c1));
    return {sub_lazy(v0, v1), sub_lazy(sub_lazy(c, v0), v1)};
  }
  // complex squaring: ((a0 + a1)(a0 - a1), 2 a0 a1)
  __device__ __forceinline__ static T sqr(const T& a) {
    const Fq ab = mont_mul(a.c0, a.c1);
    return {mont_mul(add_lazy(a.c0, a.c1), sub_lazy(a.c0, a.c1)), add_lazy(ab, ab)};
  }
  __device__ __forceinline__ static T canon(const T& a) { return {::canon(a.c0), ::canon(a.c1)}; }
  __device__ __forceinline__ static bool zero(const T& a) { return FqOps::zero(a.c0) && FqOps::zero(a.c1); }
  __device__ __forceinline__ static bool eq(const T& a, const T& b) { return FqOps::eq(a.c0, b.c0) && FqOps::eq(a.c1, b.c1); }
};

template <class F>
struct Jac {
  typename F::T x, y, z;
};

// dbl-2009-l (g1.py:double, g2.py:double); canonical in and out
template <class F>
__device__ __noinline__ Jac<F> jac_double(const Jac<F>& p) {
  using T = typename F::T;
  if (F::zero(p.z)) return p;
  const T a = F::sqr(p.x);
  const T b = F::sqr(p.y);
  const T c = F::sqr(b);
  const T d = F::dbl(F::sub(F::sub(F::sqr(F::add(p.x, b)), a), c));
  const T e = F::add(F::dbl(a), a);
  const T f = F::sqr(e);
  const T z3 = F::dbl(F::mul(p.y, p.z));
  const T x3 = F::sub(F::sub(f, d), d);
  const T c8 = F::dbl(F::dbl(F::dbl(c)));
  const T y3 = F::sub(F::mul(F::sub(d, x3), e), c8);
  return {F::canon(x3), F::canon(y3), F::canon(z3)};
}

// add-2007-bl (g1.py:add, g2.py:add) with its selects; canonical in and out
template <class F>
__device__ __noinline__ Jac<F> jac_add(const Jac<F>& p, const Jac<F>& q) {
  using T = typename F::T;
  if (F::zero(p.z)) return q;
  if (F::zero(q.z)) return p;
  const T z1z1 = F::sqr(p.z);
  const T z2z2 = F::sqr(q.z);
  const T u1 = F::canon(F::mul(p.x, z2z2));
  const T u2 = F::canon(F::mul(q.x, z1z1));
  const T s1 = F::canon(F::mul(F::mul(p.y, q.z), z2z2));
  const T s2 = F::canon(F::mul(F::mul(q.y, p.z), z1z1));
  if (F::eq(u1, u2) && F::eq(s1, s2)) return jac_double<F>(p);
  const T h = F::sub(u2, u1);
  const T i = F::sqr(F::dbl(h));
  const T j = F::mul(h, i);
  const T r = F::dbl(F::sub(s2, s1));
  const T v = F::mul(u1, i);
  const T x3 = F::sub(F::sub(F::sub(F::sqr(r), j), v), v);
  const T y3 = F::sub(F::mul(F::sub(v, x3), r), F::dbl(F::mul(s1, j)));
  const T z3 = F::mul(F::sub(F::sub(F::sqr(F::add(p.z, q.z)), z1z1), z2z2), h);
  return {F::canon(x3), F::canon(y3), F::canon(z3)};
}

}  // namespace
