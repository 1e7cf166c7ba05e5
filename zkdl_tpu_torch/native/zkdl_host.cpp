// Native host-side BLS12-381 G1 arithmetic for the port's verifier.
//
// The verifier runs on the host, and its hot loop is G1 scalar
// multiplication: the fold of a layer's row commitments down to com(u_row)
// (commit/pedersen.py:verify_open_against_com) and the three cross terms of
// every opening round (verify_open). This library does it in C++ with
// 6x64-bit-limb Montgomery arithmetic (CIOS, __uint128_t carries); it is the
// port's own copy of zkdl_tpu/native/zkdl_host.cpp: the batched scalar
// multiplication, and the library's other entry points (the G1 MSM, sum,
// batched add and equality, the batched Fr Montgomery product). Built with g++ at first use (utils/build.py) and bound with ctypes
// (native/__init__.py); curve/host_g1.py keeps the pure-Python formulas as
// the tests' oracle.
//
// ABI: little-endian u64 limb arrays. Fp coordinates and scalars cross the
// boundary as plain (non-Montgomery) integers; conversion happens inside.
// Points are Jacobian (x, y, z), 18 u64 each; z == 0 encodes identity.

#include <cstdint>
#include <cstring>
#include <cstddef>

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// constants (generated from the canonical parameters; cross-checked by tests
// against the Python host oracle)
// ---------------------------------------------------------------------------

static const uint64_t FR_P[4] = { 0xffffffff00000001ULL, 0x53bda402fffe5bfeULL, 0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL };
static const uint64_t FR_INV = 0xfffffffeffffffffULL;
static const uint64_t FP_P[6] = { 0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL };
static const uint64_t FP_INV = 0x89f3fffcfffcfffdULL;
static const uint64_t FP_R2[6] = { 0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL };

// ---------------------------------------------------------------------------
// generic N-limb Montgomery field ops (templated on limb count)
// ---------------------------------------------------------------------------

template <int N>
static inline bool gte(const uint64_t* a, const uint64_t* b) {
    for (int i = N - 1; i >= 0; --i) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;  // equal
}

template <int N>
static inline void sub_nored(uint64_t* out, const uint64_t* a, const uint64_t* b) {
    u128 borrow = 0;
    for (int i = 0; i < N; ++i) {
        u128 d = (u128)a[i] - b[i] - (uint64_t)borrow;
        out[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

template <int N>
static inline void mod_add(uint64_t* out, const uint64_t* a, const uint64_t* b, const uint64_t* P) {
    u128 carry = 0;
    uint64_t t[N + 1];
    for (int i = 0; i < N; ++i) {
        u128 s = (u128)a[i] + b[i] + (uint64_t)carry;
        t[i] = (uint64_t)s;
        carry = s >> 64;
    }
    t[N] = (uint64_t)carry;
    if (t[N] || gte<N>(t, P)) {
        u128 borrow = 0;
        for (int i = 0; i < N; ++i) {
            u128 d = (u128)t[i] - P[i] - (uint64_t)borrow;
            out[i] = (uint64_t)d;
            borrow = (d >> 64) ? 1 : 0;
        }
    } else {
        for (int i = 0; i < N; ++i) out[i] = t[i];
    }
}

template <int N>
static inline void mod_sub(uint64_t* out, const uint64_t* a, const uint64_t* b, const uint64_t* P) {
    if (gte<N>(a, b)) {
        sub_nored<N>(out, a, b);
    } else {
        uint64_t t[N];
        sub_nored<N>(t, b, a);
        sub_nored<N>(out, P, t);
    }
}

// CIOS Montgomery multiplication on 64-bit limbs.
template <int N>
static inline void mont_mul(uint64_t* out, const uint64_t* a, const uint64_t* b,
                            const uint64_t* P, uint64_t inv) {
    uint64_t t[N + 2];
    for (int i = 0; i < N + 2; ++i) t[i] = 0;
    for (int i = 0; i < N; ++i) {
        u128 carry = 0;
        for (int j = 0; j < N; ++j) {
            u128 s = (u128)t[j] + (u128)a[j] * b[i] + (uint64_t)carry;
            t[j] = (uint64_t)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[N] + (uint64_t)carry;
        t[N] = (uint64_t)s;
        t[N + 1] = (uint64_t)(s >> 64);

        uint64_t m = t[0] * inv;
        carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
        for (int j = 1; j < N; ++j) {
            u128 s2 = (u128)t[j] + (u128)m * P[j] + (uint64_t)carry;
            t[j - 1] = (uint64_t)s2;
            carry = s2 >> 64;
        }
        s = (u128)t[N] + (uint64_t)carry;
        t[N - 1] = (uint64_t)s;
        t[N] = t[N + 1] + (uint64_t)(s >> 64);
    }
    if (t[N] || gte<N>(t, P)) {
        sub_nored<N>(out, t, P);
        // a second subtraction can never be needed: inputs < p keep t < 2p
    } else {
        for (int i = 0; i < N; ++i) out[i] = t[i];
    }
}

template <int N>
static inline bool is_zero(const uint64_t* a) {
    for (int i = 0; i < N; ++i) if (a[i]) return false;
    return true;
}

// ---------------------------------------------------------------------------
// Fp helpers (6 limbs, Montgomery form internally)
// ---------------------------------------------------------------------------

struct Fp { uint64_t v[6]; };

static inline void fp_mul(Fp& o, const Fp& a, const Fp& b) { mont_mul<6>(o.v, a.v, b.v, FP_P, FP_INV); }
static inline void fp_sqr(Fp& o, const Fp& a) { mont_mul<6>(o.v, a.v, a.v, FP_P, FP_INV); }
static inline void fp_add(Fp& o, const Fp& a, const Fp& b) { mod_add<6>(o.v, a.v, b.v, FP_P); }
static inline void fp_sub(Fp& o, const Fp& a, const Fp& b) { mod_sub<6>(o.v, a.v, b.v, FP_P); }
static inline void fp_dbl(Fp& o, const Fp& a) { mod_add<6>(o.v, a.v, a.v, FP_P); }
static inline bool fp_is_zero(const Fp& a) { return is_zero<6>(a.v); }
static inline void fp_to_mont(Fp& o, const Fp& a) { Fp r2; std::memcpy(r2.v, FP_R2, 48); mont_mul<6>(o.v, a.v, r2.v, FP_P, FP_INV); }
static inline void fp_from_mont(Fp& o, const Fp& a) {
    uint64_t one[6] = {1, 0, 0, 0, 0, 0};
    mont_mul<6>(o.v, a.v, one, FP_P, FP_INV);
}
static inline bool fp_eq(const Fp& a, const Fp& b) {
    for (int i = 0; i < 6; ++i) if (a.v[i] != b.v[i]) return false;
    return true;
}

// ---------------------------------------------------------------------------
// G1 Jacobian (Montgomery-form coordinates internally)
// ---------------------------------------------------------------------------

struct G1 { Fp x, y, z; };

static inline bool g1_is_identity(const G1& p) { return fp_is_zero(p.z); }

static inline void g1_set_identity(G1& p) {
    std::memset(&p, 0, sizeof(G1));
}

// dbl-2009-l (the formulas of curve/host_g1.py:double)
static void g1_double(G1& o, const G1& p) {
    if (g1_is_identity(p)) { o = p; return; }
    Fp a, b, c, d, e, f, t0, t1;
    fp_sqr(a, p.x);                  // A = X^2
    fp_sqr(b, p.y);                  // B = Y^2
    fp_sqr(c, b);                    // C = B^2
    fp_add(t0, p.x, b); fp_sqr(t0, t0); fp_sub(t0, t0, a); fp_sub(t0, t0, c);
    fp_dbl(d, t0);                   // D = 2((X+B)^2 - A - C)
    fp_dbl(e, a); fp_add(e, e, a);   // E = 3A
    fp_sqr(f, e);                    // F = E^2
    G1 r;
    fp_dbl(t0, d); fp_sub(r.x, f, t0);           // X3 = F - 2D
    fp_sub(t0, d, r.x); fp_mul(t0, e, t0);
    fp_dbl(t1, c); fp_dbl(t1, t1); fp_dbl(t1, t1);
    fp_sub(r.y, t0, t1);                         // Y3 = E(D - X3) - 8C
    fp_mul(t0, p.y, p.z); fp_dbl(r.z, t0);       // Z3 = 2YZ
    o = r;
}

// add-2007-bl (the formulas of curve/host_g1.py:add)
static void g1_add(G1& o, const G1& p, const G1& q) {
    if (g1_is_identity(p)) { o = q; return; }
    if (g1_is_identity(q)) { o = p; return; }
    Fp z1z1, z2z2, u1, u2, s1, s2, t0;
    fp_sqr(z1z1, p.z);
    fp_sqr(z2z2, q.z);
    fp_mul(u1, p.x, z2z2);
    fp_mul(u2, q.x, z1z1);
    fp_mul(t0, p.y, q.z); fp_mul(s1, t0, z2z2);
    fp_mul(t0, q.y, p.z); fp_mul(s2, t0, z1z1);
    if (fp_eq(u1, u2) && fp_eq(s1, s2)) { g1_double(o, p); return; }
    Fp h, i, j, r, v, t1;
    fp_sub(h, u2, u1);
    fp_dbl(t0, h); fp_sqr(i, t0);
    fp_mul(j, h, i);
    fp_sub(t0, s2, s1); fp_dbl(r, t0);
    fp_mul(v, u1, i);
    G1 out;
    fp_sqr(t0, r); fp_sub(t0, t0, j); fp_dbl(t1, v); fp_sub(out.x, t0, t1);
    fp_sub(t0, v, out.x); fp_mul(t0, r, t0);
    fp_mul(t1, s1, j); fp_dbl(t1, t1);
    fp_sub(out.y, t0, t1);
    fp_add(t0, p.z, q.z); fp_sqr(t0, t0); fp_sub(t0, t0, z1z1); fp_sub(t0, t0, z2z2);
    fp_mul(out.z, t0, h);
    o = out;
}

// LSB-first 256-bit double&add (the orbit of curve/host_g1.py:scalar_mul).
static void g1_scalar_mul(G1& o, const G1& p, const uint64_t k[4]) {
    G1 acc = p, out;
    g1_set_identity(out);
    for (int w = 0; w < 4; ++w) {
        uint64_t kw = k[w];
        for (int b = 0; b < 64; ++b) {
            if (kw & 1) g1_add(out, out, acc);
            g1_double(acc, acc);
            kw >>= 1;
        }
    }
    o = out;
}

static inline void g1_load(G1& o, const uint64_t* in /*18 u64, plain ints*/) {
    Fp t;
    std::memcpy(t.v, in, 48);      fp_to_mont(o.x, t);
    std::memcpy(t.v, in + 6, 48);  fp_to_mont(o.y, t);
    std::memcpy(t.v, in + 12, 48); fp_to_mont(o.z, t);
}

static inline void g1_store(uint64_t* out, const G1& p) {
    Fp t;
    fp_from_mont(t, p.x); std::memcpy(out, t.v, 48);
    fp_from_mont(t, p.y); std::memcpy(out + 6, t.v, 48);
    fp_from_mont(t, p.z); std::memcpy(out + 12, t.v, 48);
}

// ---------------------------------------------------------------------------
// exported C API
// ---------------------------------------------------------------------------

extern "C" {

// out = a * b * R^-1 mod r (Montgomery-form ints in and out), batched
void zk_fr_mont_mul_batch(const uint64_t* a, const uint64_t* b, uint64_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i)
        mont_mul<4>(out + 4 * i, a + 4 * i, b + 4 * i, FR_P, FR_INV);
}

// points: n*18 u64 plain-int Jacobian; scalars: n*4 u64 raw 256-bit
void zk_g1_scalar_mul_batch(const uint64_t* pts, const uint64_t* scalars,
                            uint64_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        G1 p, r;
        g1_load(p, pts + 18 * i);
        g1_scalar_mul(r, p, scalars + 4 * i);
        g1_store(out + 18 * i, r);
    }
}

void zk_g1_add_batch(const uint64_t* p, const uint64_t* q, uint64_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        G1 a, b, r;
        g1_load(a, p + 18 * i);
        g1_load(b, q + 18 * i);
        g1_add(r, a, b);
        g1_store(out + 18 * i, r);
    }
}

// out = sum_i pts[i], left to right from the identity
void zk_g1_sum(const uint64_t* pts, uint64_t* out, size_t n) {
    G1 acc;
    g1_set_identity(acc);
    for (size_t i = 0; i < n; ++i) {
        G1 p;
        g1_load(p, pts + 18 * i);
        g1_add(acc, acc, p);
    }
    g1_store(out, acc);
}

// out = sum_i scalar_i * P_i: each product by double-and-add, summed left
// to right from the identity
void zk_g1_msm(const uint64_t* pts, const uint64_t* scalars, uint64_t* out, size_t n) {
    G1 acc;
    g1_set_identity(acc);
    for (size_t i = 0; i < n; ++i) {
        G1 p, r;
        g1_load(p, pts + 18 * i);
        g1_scalar_mul(r, p, scalars + 4 * i);
        g1_add(acc, acc, r);
    }
    g1_store(out, acc);
}

// affine equality by cross-multiplication (no inversion)
int zk_g1_eq(const uint64_t* p_in, const uint64_t* q_in) {
    G1 p, q;
    g1_load(p, p_in);
    g1_load(q, q_in);
    bool pi = g1_is_identity(p), qi = g1_is_identity(q);
    if (pi || qi) return pi == qi;
    // x1/z1^2 == x2/z2^2 and y1/z1^3 == y2/z2^3
    Fp z1z1, z2z2, a, b;
    fp_sqr(z1z1, p.z); fp_sqr(z2z2, q.z);
    fp_mul(a, p.x, z2z2); fp_mul(b, q.x, z1z1);
    if (!fp_eq(a, b)) return 0;
    Fp z1c, z2c;
    fp_mul(z1c, z1z1, p.z); fp_mul(z2c, z2z2, q.z);
    fp_mul(a, p.y, z2c); fp_mul(b, q.y, z1c);
    return fp_eq(a, b) ? 1 : 0;
}

}  // extern "C"
