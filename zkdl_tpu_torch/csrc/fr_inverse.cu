// K7: batched inversion over Fr, Montgomery in and out, over one or more
// segments in one call.
//
// Replaces zkdl_tpu/sumcheck/lookup.py:batch_inverse (:55-80), an XLA
// associative_scan of fr.mul (prefix products, and suffix products of the
// reversed tensor), one Fermat power of the total (fr.pow_static) and two
// elementwise products. No Pallas kernel: it was XLA on the TPU. The logUp
// lookup prover (lookup.py:_lookup_core :123-124) inverts the witness side
// (a + z) and the table side (t + z); the port hands both to one call as two
// segments.
//
// What it computes is fixed: out_i = x_i^-1 in canonical Montgomery form
// (x_i^(p-2) R mod p), one correct value whatever the algorithm. Each
// segment keeps the JAX function's zero rule on its own: a zero input makes
// its segment's product zero and, as in the JAX function (whose inverse of
// the total is then pow(0) = 0), every output of that segment zero. The
// other segments are untouched: every segment has its own tree and its own
// inversion.
//
// Design: Montgomery's trick as a product tree, spread over the grid.
//   Launch 1 (fr_inv_up). A block belongs to one segment. Thread j walks its
//   chunk of CHUNK consecutive elements (serial prefixes, kept in out until
//   launch 2; CHUNK = ceil(total / TARGET_CHUNKS), 1 at the lookup's sizes),
//   and the block multiplies its chunk products up a binary tree in shared
//   memory (a level a __syncthreads, each node one product), keeping the
//   tree's inner nodes in scratch. The last block to finish (an atomic
//   ticket, as K3's multi-block finish) builds each segment's tree over
//   its block products, inverts each segment's root in its own warp (warp s
//   takes segment s, so the segments' inversions run side by side), and
//   walks the trees down: inv(child) = inv(parent) * sibling, one product a
//   level. It leaves each block the inverse of its product in binv.
//   Launch 2 (fr_inv_down). Each block walks its own tree down from binv to
//   the inverse of each chunk product; thread j walks its chunk back,
//   out_i = prefix_(i-1) * inv(prefix_i), inv(prefix_(i-1)) = inv(prefix_i) * x_i.
//   One element takes the same two launches with no tree products: its block
//   product is the element, so the call is the inversion alone.
//
// The inversion of one element is a binary extended GCD, not a Fermat
// power: Bernstein and Yang's divsteps ("safegcd"), in the variable-time
// form with batches of 30 divsteps on the low 32-bit words of f and g
// (as libsecp256k1's modinv32_var). A batch's 30 divsteps run on two words
// (a few shifts, adds and a swap each, several at once where g's low bits
// are zero), and give a 2x2 matrix of signed entries, |u| + |v| <= 2^30 and
// |q| + |r| <= 2^30; applying it to f, g and to d, e (the Bezout
// coefficients, kept mod p and divided by 2^30 a batch through a multiple
// of p that clears their low 30 bits) is a row of 9 signed 30-bit limbs
// each, 64-bit multiply-adds whose sums stay below 2^62. The GCD stops when
// g = 0 (18 batches on average over random inputs, 19 at most in a seeded
// search; 25 bounds any 256-bit input) and leaves d = (xR)^-1 exactly (k = 0 in
// (xR)^-1 2^-k: the division by 2^30 is modular), so one Montgomery
// product by C = R^3 mod p gives x^-1 R. Variable time is acceptable: the
// value is unique and the port claims no constant time. A zero gives zero,
// as pow(0, p - 2) does.
//
// Critical path (dependent products, CHUNK = 1): the block trees' depth up
// (8 levels for 256 chunks), the last block's tree up (log2 of the
// segment's padded block count), one GCD, the product by C, the same two
// trees down: 2 * (8 + 6) + 1 = 29 at 16,384 elements (64 blocks), 2 * (8 + 4)
// + 1 = 25 at 4,096 (16 blocks), 29 for the lookup's two segments in one
// call (a Fermat power would add 420 to each). Past 32,768 elements a chunk
// adds 2 (CHUNK - 1) + 1 serial products.
//
// What bounds it on an H100: not bytes (64 B an element, 1.3 MB at the
// lookup's 20,480 entries: 0.4 us at 3.35 TB/s) nor the multiply rate (about
// 3 products an element), but that chain: each product is a CIOS loop of
// dependent 64-bit carries on one thread. Its time against the bound is in
// PERF.md.
//
// C interface (loaded with ctypes): zk_fr_batch_inverse launches the kernels
// on the given stream and returns cudaGetLastError();
// zk_fr_batch_inverse_scratch sizes its scratch.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int NL = FrSpec::N;
constexpr int THREADS = 256;  // a block: 256 chunks, a tree of depth 8
constexpr int64_t TARGET_CHUNKS = 32768;  // chunks a call aims at: one element a chunk up to 32,768 elements
constexpr int MAX_SEGMENTS = 8;  // a call's segments: warp s of the last block inverts segment s's product
// The last block's trees: a segment of B blocks takes 2 * next_pow2(B) heap
// slots. CHUNK = ceil(total / TARGET_CHUNKS) keeps the blocks of all
// segments at most TARGET_CHUNKS / THREADS + MAX_SEGMENTS, and next_pow2(B)
// <= 2B - 1, so the padded leaves are at most 2 * TARGET_CHUNKS / THREADS + MAX_SEGMENTS.
constexpr int LAST_LEAVES = 2 * TARGET_CHUNKS / THREADS + MAX_SEGMENTS;  // 264
constexpr int LAST_ITEMS = (LAST_LEAVES + THREADS - 1) / THREADS;  // a level's nodes a thread, at most
constexpr int MAX_BATCHES = 25;  // batches of 30 divsteps that end the GCD of any 256-bit modulus and input
constexpr int32_t M30 = (int32_t)(0xffffffffu >> 2);
constexpr uint32_t P_INV30 = 1;  // p^-1 mod 2^30 (p = 1 mod 2^32)

// R mod p (Montgomery one) and R^3 mod p, little-endian 32-bit words; p in
// 9 signed 30-bit limbs.
__constant__ uint32_t ONE_MONT[NL] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                                      0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
__constant__ uint32_t R3_MOD_P[NL] = {0x439b73afu, 0xc62c1807u, 0x8cf06990u, 0x1b3e0d18u,
                                      0xc7b5f418u, 0x73d13c71u, 0xc8db33e9u, 0x6e2a5bb9u};
__constant__ int32_t P30[9] = {0x00000001, 0x3ffffffc, 0x3fe5bfef, 0x2f6900bf, 0x21d80553,
                               0x27602026, 0x17d48333, 0x29d4ca67, 0x000073ed};

// A call's segments: their tensors, sizes and places in the grid and in the
// last block's trees. Passed by value to both launches.
struct Layout {
  const uint32_t* x[MAX_SEGMENTS];
  uint32_t* out[MAX_SEGMENTS];
  long long n[MAX_SEGMENTS];
  int block0[MAX_SEGMENTS + 1];  // first block of segment s; block0[S] = the grid
  int lg[MAX_SEGMENTS];          // depth of segment s's tree over its block products
  int node0[MAX_SEGMENTS];       // its heap's base in the last block's shared memory
  long long chunk;               // elements a thread walks
  int S;
};

__device__ __forceinline__ void load(const uint32_t* src, int64_t i, uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = src[i * NL + k];
}

__device__ __forceinline__ void load_cg(const uint32_t* src, int64_t i, uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = __ldcg(src + i * NL + k);
}

__device__ __forceinline__ void store(uint32_t* dst, int64_t i, const uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) dst[i * NL + k] = v[k];
}

__device__ __forceinline__ void set_one(uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = ONE_MONT[k];
}

__device__ __forceinline__ void copy(const uint32_t* a, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = a[k];
}

// r = a b (Montgomery). The operands are read into registers first: they
// may lie in shared memory, and r may alias either.
__device__ __forceinline__ void mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t x[NL], y[NL], z[NL];
  copy(a, x);
  copy(b, y);
  mont_mul<FrSpec>(x, y, z);
  copy(z, r);
}

// ---------------------------------------------------------------------------
// The inversion of one element: Bernstein-Yang divsteps
// ---------------------------------------------------------------------------

struct Mat {
  int32_t u, v, q, r;  // [f', g'] 2^30 = [[u, v], [q, r]] [f, g] after a batch
};

// 30 divsteps on the low words of f and g from eta (= -delta); returns the
// new eta and the batch's matrix. Where g's low bits are zero, several
// divsteps (halvings of g) run as one shift; where g is odd and eta >= 0,
// g += w f cancels up to min(eta + 1, 8) of its low bits at once.
__device__ int32_t divsteps30(int32_t eta, uint32_t f, uint32_t g, Mat& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    const int zeros = __ffs(g | (0xffffffffu << i)) - 1;  // a sentinel bit stops at i
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {  // swap: f, g = g, -f
      uint32_t tmp;
      eta = -eta;
      tmp = f, f = g, g = 0u - tmp;
      tmp = u, u = q, q = 0u - tmp;
      tmp = v, v = r, r = 0u - tmp;
    }
    const int limit = eta + 1 < i ? eta + 1 : i;
    const uint32_t m = (0xffffffffu >> (32 - limit)) & 255u;
    uint32_t finv = f;  // f^-1 mod 2^12 by two Newton steps from f = f^-1 mod 8
    finv *= 2u - f * finv;
    finv *= 2u - f * finv;
    const uint32_t w = (g * (0u - finv)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return eta;
}

// [d, e] = ([[u, v], [q, r]] [d, e] + p [md, me]) / 2^30, md and me chosen
// so that the low 30 bits vanish: the Bezout coefficients stay in (-2p, p).
__device__ __forceinline__ void update_de(int32_t* d, int32_t* e, const Mat& t) {
  const int32_t sd = d[8] >> 31, se = e[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
  int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
  md -= (int32_t)((P_INV30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((P_INV30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)P30[0] * md;
  ce += (int64_t)P30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    cd += (int64_t)t.u * d[k] + (int64_t)t.v * e[k] + (int64_t)P30[k] * md;
    ce += (int64_t)t.q * d[k] + (int64_t)t.r * e[k] + (int64_t)P30[k] * me;
    d[k - 1] = (int32_t)cd & M30;
    e[k - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d[8] = (int32_t)cd;
  e[8] = (int32_t)ce;
}

// [f, g] = [[u, v], [q, r]] [f, g] / 2^30 (exact: the batch cleared the low bits).
__device__ __forceinline__ void update_fg(int32_t* f, int32_t* g, const Mat& t) {
  int64_t cf = (int64_t)t.u * f[0] + (int64_t)t.v * g[0];
  int64_t cg = (int64_t)t.q * f[0] + (int64_t)t.r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    cf += (int64_t)t.u * f[k] + (int64_t)t.v * g[k];
    cg += (int64_t)t.q * f[k] + (int64_t)t.r * g[k];
    f[k - 1] = (int32_t)cf & M30;
    g[k - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f[8] = (int32_t)cf;
  g[8] = (int32_t)cg;
}

// Carry the limbs below the top into [0, 2^30); the top limb keeps the sign.
__device__ __forceinline__ void carry(int32_t* r) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r[k + 1] += r[k] >> 30;
    r[k] &= M30;
  }
}

// r += p where r < 0 (its limbs carried), then carry.
__device__ __forceinline__ void add_p_if_negative(int32_t* r) {
  const int32_t neg = r[8] >> 31;
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] += P30[k] & neg;
  carry(r);
}

// r = a^-1 mod p for a canonical a < p (an integer, not read as Montgomery);
// r = 0 for a = 0.
__device__ void gcd_inverse(const uint32_t* a, uint32_t* r) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) any |= a[k];
  if (any == 0) {
#pragma unroll
    for (int k = 0; k < NL; ++k) r[k] = 0;
    return;
  }
  int32_t d[9], e[9], f[9], g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {  // g = a in 30-bit limbs: limb k is bits [30k, 30k + 30)
    const int w = 30 * k / 32, off = 30 * k % 32;
    const uint64_t pair = a[w] | (w + 1 < NL ? (uint64_t)a[w + 1] << 32 : 0);
    g[k] = (int32_t)((pair >> off) & (uint64_t)M30);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = P30[k];
    d[k] = 0;
    e[k] = k == 0;
  }
  int32_t eta = -1;  // delta = 1
#pragma unroll 1
  for (int batch = 0; batch < MAX_BATCHES; ++batch) {
    Mat t;
    eta = divsteps30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de(d, e, t);
    update_fg(f, g, t);
    int32_t left = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) left |= g[k];
    if (left == 0) break;
  }
  // f = +-1 = d a (mod p), d in (-2p, p): a^-1 = sign(f) d, brought into [0, p)
  add_p_if_negative(d);  // (-p, p)
  const int32_t neg = f[8] >> 31;
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = (d[k] ^ neg) - neg;
  carry(d);
  add_p_if_negative(d);  // [0, p)
#pragma unroll
  for (int k = 0; k < NL; ++k) {  // back to 32-bit words: word k is bits [32k, 32k + 32)
    const int l = 32 * k / 30, off = 32 * k % 30;
    const uint64_t pair = (uint32_t)d[l] | (uint64_t)(uint32_t)d[l + 1] << 30;
    r[k] = (uint32_t)(pair >> off);
  }
}

// r = a^-1 in Montgomery form: gcd_inverse gives (xR)^-1 for a = xR, and a
// product by R^3 (R^-1 of it the Montgomery product's) gives x^-1 R.
__device__ void inverse_mont(const uint32_t* a, uint32_t* r) {
  uint32_t t[NL], c[NL];
  gcd_inverse(a, t);
#pragma unroll
  for (int k = 0; k < NL; ++k) c[k] = R3_MOD_P[k];
  mul(t, c, r);
}

// ---------------------------------------------------------------------------
// Montgomery's trick as a tree
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ceil_log2(int m) { return m <= 1 ? 0 : 32 - __clz(m - 1); }

// Segment of block b, the block's chunks (threads with elements) and the
// depth of its tree over them.
__device__ __forceinline__ void block_shape(const Layout& L, int b, int& s, int& m, int& lg) {
  s = 0;
  while (b >= L.block0[s + 1]) ++s;
  const long long T = (L.n[s] + L.chunk - 1) / L.chunk;
  const long long rest = T - (long long)(b - L.block0[s]) * THREADS;
  m = rest < THREADS ? (int)rest : THREADS;
  lg = ceil_log2(m);
}

// The item-th node at depth d over the last block's trees of depth >= need,
// as a heap base and an index in it.
__device__ __forceinline__ bool node_at(const Layout& L, int d, int item, int need, int& base, int& k) {
  for (int s = 0; s < L.S; ++s) {
    if (L.lg[s] < need) continue;
    if (item < (1 << d)) {
      base = L.node0[s];
      k = (1 << d) + item;
      return true;
    }
    item -= 1 << d;
  }
  return false;
}

// The last block of launch 1: every segment's tree over its block products
// (the roots of the block trees, tree[b][1]), its root inverted by warp s,
// and binv[b] = (block b's product)^-1.
__device__ void middle(const Layout& L, const uint32_t* tree, uint32_t* binv) {
  __shared__ uint32_t h[2 * LAST_LEAVES][NL];
  const int j = threadIdx.x;
  int D = 0;
  for (int s = 0; s < L.S; ++s) {
    const int B = L.block0[s + 1] - L.block0[s], P = 1 << L.lg[s];
    D = L.lg[s] > D ? L.lg[s] : D;
    for (int i = j; i < P; i += THREADS) {
      uint32_t v[NL];
      if (i < B) {
        load_cg(tree, (int64_t)(L.block0[s] + i) * THREADS + 1, v);
      } else {
        set_one(v);
      }
      copy(v, h[L.node0[s] + P + i]);
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int d = D - 1; d >= 0; --d) {  // up: a node is the product of its children
    int base, k;
    for (int item = j; node_at(L, d, item, d + 1, base, k); item += THREADS) {
      mul(h[base + 2 * k], h[base + 2 * k + 1], h[base + k]);
    }
    __syncthreads();
  }
  if ((j & 31) == 0 && (j >> 5) < L.S) {
    uint32_t* root = h[L.node0[j >> 5] + 1];
    uint32_t r[NL];
    inverse_mont(root, r);
    copy(r, root);
  }
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d <= D; ++d) {  // down: inv(child) = inv(parent) * sibling
    uint32_t r[LAST_ITEMS][NL];
    int base[LAST_ITEMS], k[LAST_ITEMS];
    bool on[LAST_ITEMS];
#pragma unroll
    for (int q = 0; q < LAST_ITEMS; ++q) {
      on[q] = node_at(L, d, j + q * THREADS, d, base[q], k[q]);
      if (on[q]) mul(h[base[q] + (k[q] >> 1)], h[base[q] + (k[q] ^ 1)], r[q]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < LAST_ITEMS; ++q) {
      if (on[q]) copy(r[q], h[base[q] + k[q]]);
    }
    __syncthreads();
  }
  for (int s = 0; s < L.S; ++s) {
    const int B = L.block0[s + 1] - L.block0[s], P = 1 << L.lg[s];
    for (int i = j; i < B; i += THREADS) store(binv, L.block0[s] + i, h[L.node0[s] + P + i]);
  }
}

// Launch 1: chunk prefixes into out, the block's tree into tree[b][1..P-1]
// (tree[b][1] its product); the last block runs the middle step.
__global__ void __launch_bounds__(THREADS) fr_inv_up(Layout L, uint32_t* tree, uint32_t* binv,
                                                     unsigned* counter) {
  __shared__ uint32_t h[2 * THREADS][NL];
  __shared__ bool last;
  const int b = blockIdx.x, j = threadIdx.x;
  int s, m, lg;
  block_shape(L, b, s, m, lg);
  const int P = 1 << lg;
  if (j < P) {
    uint32_t acc[NL];
    if (j < m) {
      const uint32_t* x = L.x[s];
      uint32_t* pre = L.out[s];
      const int64_t s0 = ((int64_t)(b - L.block0[s]) * THREADS + j) * L.chunk;
      const int64_t e0 = s0 + L.chunk < L.n[s] ? s0 + L.chunk : L.n[s];
      uint32_t v[NL];
      load(x, s0, acc);
      store(pre, s0, acc);
      for (int64_t i = s0 + 1; i < e0; ++i) {
        load(x, i, v);
        mul(acc, v, acc);
        store(pre, i, acc);
      }
    } else {
      set_one(acc);
    }
    copy(acc, h[P + j]);
  }
  __syncthreads();
#pragma unroll 1
  for (int d = lg - 1; d >= 0; --d) {
    if (j < (1 << d)) {
      const int k = (1 << d) + j;
      mul(h[2 * k], h[2 * k + 1], h[k]);
    }
    __syncthreads();
  }
  uint32_t* tb = tree + (int64_t)b * THREADS * NL;
  for (int k = 1 + j; k < (P > 1 ? P : 2); k += THREADS) store(tb, k, h[k]);
  __threadfence();
  __syncthreads();
  if (j == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  middle(L, tree, binv);
  if (j == 0) *counter = 0;
}

// Launch 2: the block's tree walked down from binv[b] to the inverse of
// each chunk product, then each chunk walked back.
__global__ void __launch_bounds__(THREADS) fr_inv_down(Layout L, const uint32_t* __restrict__ tree,
                                                       const uint32_t* __restrict__ binv) {
  __shared__ uint32_t h[2 * THREADS][NL];
  const int b = blockIdx.x, j = threadIdx.x;
  int s, m, lg;
  block_shape(L, b, s, m, lg);
  const int P = 1 << lg;
  const uint32_t* x = L.x[s];
  uint32_t* out = L.out[s];
  const int64_t s0 = ((int64_t)(b - L.block0[s]) * THREADS + j) * L.chunk;
  const int64_t e0 = s0 + L.chunk < L.n[s] ? s0 + L.chunk : L.n[s];
  uint32_t il[NL], v[NL], r[NL];
  if (lg == 0) {
    if (j == 0) load(binv, b, il);
  } else {
    if (j < P) {  // leaves: each chunk's product, its last prefix
      if (j < m) {
        load(out, e0 - 1, v);
      } else {
        set_one(v);
      }
      copy(v, h[P + j]);
    }
    const uint32_t* tb = tree + (int64_t)b * THREADS * NL;
    for (int k = 2 + j; k < P; k += THREADS) {
      load(tb, k, v);
      copy(v, h[k]);
    }
    if (j == 0) {
      load(binv, b, v);
      copy(v, h[1]);
    }
    __syncthreads();
#pragma unroll 1
    for (int d = 1; d <= lg; ++d) {
      const bool on = j < (1 << d);
      const int k = (1 << d) + j;
      if (on) mul(h[k >> 1], h[k ^ 1], il);
      __syncthreads();
      if (on && d < lg) copy(il, h[k]);
      __syncthreads();
    }
  }
  if (j >= m) return;
  for (int64_t i = e0 - 1; i > s0; --i) {  // il = inv(prefix_i)
    load(out, i - 1, v);
    mul(v, il, r);
    load(x, i, v);
    mul(il, v, il);
    store(out, i, r);  // prefix_i is read no more
  }
  store(out, s0, il);
}

// The layout of S segments of n[s] >= 1 elements (pointers left unset);
// false past the kernel's limits.
bool plan(const long long* n, int S, Layout& L) {
  if (S < 1 || S > MAX_SEGMENTS) return false;
  long long total = 0;
  for (int s = 0; s < S; ++s) {
    if (n[s] < 1 || n[s] > 0x7fffffffLL) return false;
    total += n[s];
  }
  if (total > 0x7fffffffLL) return false;
  L.S = S;
  L.chunk = (total + TARGET_CHUNKS - 1) / TARGET_CHUNKS;
  int blocks = 0, nodes = 0;
  for (int s = 0; s < S; ++s) {
    const long long T = (n[s] + L.chunk - 1) / L.chunk;
    const int B = (int)((T + THREADS - 1) / THREADS);
    int lg = 0;
    while ((1 << lg) < B) ++lg;
    L.n[s] = n[s];
    L.block0[s] = blocks;
    L.lg[s] = lg;
    L.node0[s] = nodes;
    blocks += B;
    nodes += 2 << lg;
  }
  L.block0[S] = blocks;
  return nodes <= 2 * LAST_LEAVES;
}

}  // namespace

extern "C" {

// Scratch words of a call over S segments of n[s] elements: every block's
// tree (THREADS slots of 8 words) and its inverse (8 words); -1 past the
// kernel's limits.
long long zk_fr_batch_inverse_scratch(const long long* n, int S) {
  Layout L;
  if (!plan(n, S, L)) return -1;
  return (long long)L.block0[S] * (THREADS + 1) * NL;
}

// out[s][i] = x[s][i]^-1 for S segments of n[s] >= 1 Montgomery (n[s], 8)
// rows; scratch as zk_fr_batch_inverse_scratch sizes it, counter one zero
// word (left at zero). Launches on `device`, restoring the caller's.
int zk_fr_batch_inverse(const void* const* x, void* const* out, const long long* n, int S, void* scratch,
                        void* counter, void* stream, int device) {
  Layout L;
  if (!plan(n, S, L)) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < S; ++s) {
    L.x[s] = (const uint32_t*)x[s];
    L.out[s] = (uint32_t*)out[s];
  }
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = L.block0[S];
  uint32_t* tree = (uint32_t*)scratch;
  uint32_t* binv = tree + (int64_t)blocks * THREADS * NL;
  fr_inv_up<<<blocks, THREADS, 0, st>>>(L, tree, binv, (unsigned*)counter);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    fr_inv_down<<<blocks, THREADS, 0, st>>>(L, tree, binv);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
