// ENet's 2x2 max-pool-with-argmax-mask and mask-unpool, forward and
// backward, as CUDA kernels for Hopper (sm_90a), on NHWC tensors.
//
// Replaces dct_tpu/ops/pallas_pool.py:
//   pool_mask_fwd  <- _pool_mask_kernel (max_pool_2x2_with_mask_pallas)
//   unpool_fwd     <- _unpool_kernel    (mask_unpool_2x2_pallas)
//   pool_mask_bwd, unpool_bwd <- the gradients JAX derives for those two
//   functions by autodiff of ops/pooling.py.
//
// Semantics (held bit-equal to dct_tpu_torch/ops/pooling.py):
//   * pool: pooled = max(max(a, b), max(c, d)) over the window corners
//     a=(0,0) b=(0,1) c=(1,0) d=(1,1), NaN-propagating like jnp.maximum
//     (fmaxf would drop the NaN). The mask is one-hot {0,1} in x's dtype at
//     the first corner, in row-major order, equal to the pooled value; a
//     window holding a NaN pools to NaN and sets its mask at (1,1).
//   * pool backward: JAX's derivative of that maximum tree, which splits a
//     tie evenly at each of its two levels: corner a gets
//     g * w(m1, p, m2) * w(a, m1, b) with w(x, z, y) = x == z ? (y == z ?
//     1/2 : 1) : 0, so [1,1,1,0] gives [1/4, 1/4, 1/2, 0]. Every weight is
//     1, 1/2, 1/4 or 0, so the products are exact. The mask gets no gradient.
//   * unpool: out = y repeated over each window times the mask. It is a
//     multiply, not a select, so a NaN in y spreads over its window. A
//     product of two bf16 values is exact in fp32, so one mul.rn.bf16x2 a
//     corner rounds as the plain fp32 multiply and one rounding do.
//   * unpool backward: gy = the window sum of g * mask. Every corner is
//     multiplied, the masked-out ones too, so a NaN or an inf in g where
//     the mask is 0 makes gy NaN. The contract is the mask pool_mask_fwd
//     makes, one 1 and three 0 a window: each product is then exact and
//     the sum adds one of them to zeros, so every order and rounding gives
//     the plain version's bits. The kernel sums as a chain of fused
//     multiply-adds (fma.rn.bf16x2 on bf16 pairs, fp32 otherwise). On other
//     masks it may round otherwise than the plain version, which rounds
//     each bf16 product before it sums in fp32.
//
// Bound on an H100 SXM: bytes. Each kernel does a few compares or multiplies
// per element it moves, far below the card's ~20 operations per byte for
// fp32 CUDA-core math, so its least time is the bytes it must read and write
// over 3.35 TB/s. bf16 channel pairs are compared and multiplied as 32-bit
// words (set.*.u32.bf16x2, mul.rn.bf16x2, fma.rn.bf16x2), single channels
// in fp32 (__bfloat162float for bf16); pooled values are copied from the
// input bits, never re-rounded.
//
// All four kernels are one template, tiled_kernel<Op, T, N, kExact>, on
// row pairs: for a fixed (n, i) the full-resolution rows 2i and 2i+1 are
// each one contiguous span of 2w*c elements and the pooled row i one span
// of w*c. A 2-D grid (tile of the row, row pair) names a block's work, so
// the kernel has no division: the wrapper computes the tiling (tile, grid,
// threads, shared memory, N and a magic multiplier for c / N, whose
// umulhi gives a pack's column), and the entry points check it against the
// shape and the pointers. bf16 pairs are compared, selected and multiplied
// as 32-bit words.
//
// The pool pair stages a tile in shared memory. A tile is the pooled
// columns [j0, j0 + tile_w) of one row pair, so it reads and writes three
// contiguous spans:
//   1. stage: copy the spans of x (and, backward, of g) into shared memory,
//      16 bytes a thread with cp.async; a span's unaligned head and tail go
//      one element a thread, inside the same kernel;
//   2. compute: each thread takes pooled elements two channels at a time
//      (c even) as one 32-bit shared-memory access, reads the four window
//      corners and writes pooled (forward) and the mask or gx back over the
//      staged x (windows are disjoint, so each thread owns its four slots);
//      one mul.rn.bf16x2 per corner weights the backward;
//   3. store: pooled, mask or gx go out as 16-byte vectors along the spans.
// 256-element tiles and 2 elements a thread give the main path 2,048 blocks
// of 128 threads at each shape, all resident at once.
//
// The unpool pair loads and stores one pack of N channels a thread straight
// from and to the tensors, DIRECT_THREADS (128) packs a block, with no
// shared memory and no loop, so each thread's loads are all in flight before
// it computes. unpool_fwd walks the two full-resolution rows (a warp's
// loads and stores are each one contiguous run; the pack of y repeats in
// L1); unpool_bwd walks the pooled row and loads the four corners of g and
// of the mask (corner (0,1) finds in L1 the sectors that corner (0,0)
// fetched). Row pairs beyond the grid's 65,535 rows take its third
// dimension. Staging the unpool pair in shared memory like the pool pair,
// with 16-byte stores, was slower on an H100 in the same chip call at both
// main-path shapes in bf16, most of all in the backward, which reads four
// spans for every one it writes (PERF.md).
//
// Shared memory per pool block: two buffers of 2*tile_w*c elements and one
// of tile_w*c, each padded by one vector so a buffer and its span agree
// modulo 16 bytes (ops/pool_kernels.py:pool_tiling computes the same size):
// 2,288 / 2,608 bytes in bf16 and 4,528 / 5,168 in fp32 on the main path
// (C = 14 / C = 64), all dynamic. -Xptxas -v on an H100 (sm_90a, CUDA
// 12.8), the main path's instances (N = 2; whole spans for the pool): 20
// (pool fwd), 26 (pool bwd), 16 (unpool fwd) and 24 (unpool bwd) registers
// a thread in bf16, 22, 28, 20 and 25 in fp32; no instance spills.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16(v);
  }
};

// True when max(a, b) is a: a is larger, or a is NaN (NaN propagates).
__device__ __forceinline__ bool first_is_max(float a, float b) {
  return a > b || a != a;
}

// JAX's balanced tie weight for d max(x, y) / dx at z = max(x, y).
__device__ __forceinline__ float balanced(float x, float z, float y) {
  return x == z ? (y == z ? 0.5f : 1.0f) : 0.0f;
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte access

// How a span of len elements, starting at element off of a 16-byte aligned
// tensor, lies in its shared-memory buffer (element e at pad + e, so the
// buffer and the span agree modulo 16 bytes) and splits into a scalar head,
// a body of whole 16-byte vectors and a scalar tail. vec == 0 (a pointer is
// not 16-byte aligned): all scalar. kExact (the wrapper found every span of
// the launch to be whole aligned vectors): all body, and no head or tail
// code.
struct Span {
  int pad, head, body, len;
};

template <typename T, bool kExact>
__device__ __forceinline__ Span span_of(int64_t off, int len, int vec) {
  constexpr int V = kVec<T>;
  Span s;
  s.len = len;
  if (kExact) {
    s.pad = 0;
    s.head = 0;
    s.body = len;
  } else if (!vec) {
    s.pad = 0;
    s.head = len;
    s.body = 0;
  } else {
    s.pad = static_cast<int>(off & (V - 1));
    s.head = min(len, (V - s.pad) & (V - 1));
    s.body = (len - s.head) & ~(V - 1);
  }
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Device span g -> buffer sm (the caller waits and synchronises).
template <typename T, bool kExact>
__device__ __forceinline__ void stage(T* sm, const T* __restrict__ g, Span s) {
  sm += s.pad;
  const uint4* gv = reinterpret_cast<const uint4*>(g + s.head);
  uint4* sv = reinterpret_cast<uint4*>(sm + s.head);
  const int nv = s.body / kVec<T>;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) cp_async16(sv + v, gv + v);
  if constexpr (!kExact) {
    for (int e = threadIdx.x; e < s.head; e += blockDim.x) sm[e] = g[e];
    for (int e = s.head + s.body + threadIdx.x; e < s.len; e += blockDim.x)
      sm[e] = g[e];
  }
}

// Buffer sm -> device span g.
template <typename T, bool kExact>
__device__ __forceinline__ void unstage(T* __restrict__ g, const T* sm, Span s) {
  sm += s.pad;
  const uint4* sv = reinterpret_cast<const uint4*>(sm + s.head);
  uint4* gv = reinterpret_cast<uint4*>(g + s.head);
  const int nv = s.body / kVec<T>;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) gv[v] = sv[v];
  if constexpr (!kExact) {
    for (int e = threadIdx.x; e < s.head; e += blockDim.x) g[e] = sm[e];
    for (int e = s.head + s.body + threadIdx.x; e < s.len; e += blockDim.x)
      g[e] = sm[e];
  }
}

// Launch parameters, all computed by the wrapper (ops/pool_kernels.py:
// pool_tiling). Sizes are the pooled tensor's; rows = n * h row pairs.
struct Tiling {
  int rows, w, c;
  int tile_w;      // pool: pooled columns a tile; unpool: packs (= threads)
  int vec;         // 0: all scalar; 1: 16-byte body; 2: spans all whole
  unsigned magic;  // ceil(2^32 / (c / N)): j = umulhi(kk, magic), exact here
};

// Tile (tj, rp): pooled columns [tj * tile_w, +tile_w) of row pair rp =
// n * h + i, whose full-resolution rows are 2 * rp and 2 * rp + 1 of the
// (n * 2h, 2w * c) view. A 2-D grid (tiles of a row, row pairs) needs no
// division to find them.
struct Tile {
  int64_t in0, in1, out;  // span starts: full rows 2i, 2i+1; pooled row i
  int m;                  // pooled elements in the tile (columns * c)
};

__device__ __forceinline__ Tile tile_of(int tj, int rp, const Tiling& a) {
  const int j0 = tj * a.tile_w;
  const int64_t wc = static_cast<int64_t>(a.w) * a.c;  // one pooled row
  Tile tl;
  tl.m = min(a.tile_w, a.w - j0) * a.c;
  tl.in0 = 4 * wc * rp + 2 * static_cast<int64_t>(j0) * a.c;
  tl.in1 = tl.in0 + 2 * wc;
  tl.out = rp * wc + static_cast<int64_t>(j0) * a.c;
  return tl;
}

// Shared-memory buffer of a span of len elements: len plus one vector of
// padding, rounded up to whole vectors (keeps the next buffer aligned).
template <typename T, typename I>
__host__ __device__ __forceinline__ I buffer_elems(I len) {
  return (len + 2 * kVec<T> - 1) / kVec<T> * kVec<T>;
}

// N neighbouring channels, read and written as one access, in shared memory
// (pool pair) or in the tensors (unpool pair). The wrapper picks N = 2
// where c is even (and, for the unpool pair, every pointer aligned), else
// 1, so a pack never crosses a window corner and stays aligned.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N>& pack_at(T* p) {
  return *reinterpret_cast<Pack<T, N>*>(p);
}

// Offset in a full-resolution row of the (0,0) corner of pooled pack kk
// (counted from the same column): pooled element k = N * kk at column
// j = k / c, channel k - j * c, sits at 2 * j * c + (k - j * c) = k + j * c.
template <int N>
__device__ __forceinline__ int corner_of(int kk, const Tiling& a) {
  const int j = a.c == N ? kk : static_cast<int>(__umulhi(kk, a.magic));
  return N * kk + j * a.c;
}

// bf16 pairs as 32-bit words: comparisons give 0xFFFF per true half
// (set.*.u32.bf16x2 on sm_90), selections are bitwise, so the pooled value
// keeps the input's bits and the mask is built from the constant 1.0.
__device__ __forceinline__ __nv_bfloat162 b2(unsigned u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, sizeof(r));
  return r;
}

__device__ __forceinline__ unsigned u32(__nv_bfloat162 v) {
  unsigned r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

__device__ __forceinline__ unsigned pick(unsigned m, unsigned a, unsigned b) {
  return (a & m) | (b & ~m);
}

// first_is_max on each half: a > b, or a is NaN.
__device__ __forceinline__ unsigned first_max2(unsigned a, unsigned b) {
  return __hgt2_mask(b2(a), b2(b)) | __hneu2_mask(b2(a), b2(a));
}

__device__ __forceinline__ unsigned eq2(unsigned a, unsigned b) {
  return __heq2_mask(b2(a), b2(b));
}

constexpr unsigned kOne2 = 0x3F803F80u;  // bf16 1.0 in both halves
constexpr unsigned kExp2 = 0x00800080u;  // its exponent's lowest bit: x 0.5

// JAX's tie weight for one corner, w(m, p, m') * w(x, m, y), on each half
// from the masks m == p, m' == p, x == m, y == m: 0, or 1.0 halved once for
// each tie (1, 1/2 or 1/4), built in the exponent bits.
__device__ __forceinline__ unsigned weight2(unsigned mp, unsigned m2p,
                                            unsigned xm, unsigned ym) {
  return mp & xm & (kOne2 - (m2p & kExp2) - (ym & kExp2));
}

template <typename T, int N>
constexpr bool kPairs = std::is_same<T, __nv_bfloat16>::value && N == 2;

template <typename T, int N>
__device__ __forceinline__ unsigned word(const Pack<T, N>& p) {
  unsigned w;
  memcpy(&w, &p, sizeof(w));
  return w;
}

template <typename T, int N>
__device__ __forceinline__ void set_word(Pack<T, N>& p, unsigned w) {
  memcpy(&p, &w, sizeof(w));
}

// pool_mask_fwd on one pack: pooled into po, the mask over the corners.
template <typename T, int N>
__device__ __forceinline__ void fwd_pack(Pack<T, N>& pa, Pack<T, N>& pb,
                                         Pack<T, N>& pc, Pack<T, N>& pd,
                                         Pack<T, N>& po) {
  if constexpr (kPairs<T, N>) {
    const unsigned a = word(pa), b = word(pb), c = word(pc), d = word(pd);
    const unsigned m1 = pick(first_max2(a, b), a, b);
    const unsigned m2 = pick(first_max2(c, d), c, d);
    const unsigned p = pick(first_max2(m1, m2), m1, m2);
    const unsigned e00 = eq2(a, p);
    const unsigned e01 = eq2(b, p) & ~e00;
    const unsigned e10 = eq2(c, p) & ~(e00 | e01);
    const unsigned e11 = ~(e00 | e01 | e10);
    set_word(po, p);
    set_word(pa, e00 & kOne2);
    set_word(pb, e01 & kOne2);
    set_word(pc, e10 & kOne2);
    set_word(pd, e11 & kOne2);
  } else {
    const T one = Cvt<T>::from(1.0f), zero = Cvt<T>::from(0.0f);
    Pack<T, N> ra = pa, rb = pb, rc = pc, rd = pd, rp;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float fa = Cvt<T>::to(ra.v[q]), fb = Cvt<T>::to(rb.v[q]);
      const float fc = Cvt<T>::to(rc.v[q]), fd = Cvt<T>::to(rd.v[q]);
      const bool ab = first_is_max(fa, fb);
      const bool cd = first_is_max(fc, fd);
      const float m1 = ab ? fa : fb, m2 = cd ? fc : fd;
      const bool top = first_is_max(m1, m2);
      const float p = top ? m1 : m2;
      rp.v[q] = top ? (ab ? ra.v[q] : rb.v[q]) : (cd ? rc.v[q] : rd.v[q]);
      const bool e00 = fa == p;
      const bool e01 = !e00 && fb == p;
      const bool e10 = !e00 && !e01 && fc == p;
      const bool e11 = !e00 && !e01 && !e10;
      ra.v[q] = e00 ? one : zero;
      rb.v[q] = e01 ? one : zero;
      rc.v[q] = e10 ? one : zero;
      rd.v[q] = e11 ? one : zero;
    }
    po = rp;
    pa = ra;
    pb = rb;
    pc = rc;
    pd = rd;
  }
}

// pool_mask_bwd on one pack: gx over the corners, from the pooled gradient.
// The weight products are 0, 1/4, 1/2 or 1, so g * (w1 * wa) rounds once,
// in one bf16 multiply as in fp32 ones.
template <typename T, int N>
__device__ __forceinline__ void bwd_pack(Pack<T, N>& pa, Pack<T, N>& pb,
                                         Pack<T, N>& pc, Pack<T, N>& pd,
                                         const Pack<T, N>& pg) {
  if constexpr (kPairs<T, N>) {
    const unsigned a = word(pa), b = word(pb), c = word(pc), d = word(pd);
    const unsigned m1 = pick(first_max2(a, b), a, b);
    const unsigned m2 = pick(first_max2(c, d), c, d);
    const unsigned p = pick(first_max2(m1, m2), m1, m2);
    const unsigned m1p = eq2(m1, p), m2p = eq2(m2, p);
    const unsigned am = eq2(a, m1), bm = eq2(b, m1);
    const unsigned cm = eq2(c, m2), dm = eq2(d, m2);
    const __nv_bfloat162 gp = b2(word(pg));
    set_word(pa, u32(__hmul2_rn(gp, b2(weight2(m1p, m2p, am, bm)))));
    set_word(pb, u32(__hmul2_rn(gp, b2(weight2(m1p, m2p, bm, am)))));
    set_word(pc, u32(__hmul2_rn(gp, b2(weight2(m2p, m1p, cm, dm)))));
    set_word(pd, u32(__hmul2_rn(gp, b2(weight2(m2p, m1p, dm, cm)))));
  } else {
    Pack<T, N> ra = pa, rb = pb, rc = pc, rd = pd;
    const Pack<T, N> rg = pg;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float fa = Cvt<T>::to(ra.v[q]), fb = Cvt<T>::to(rb.v[q]);
      const float fc = Cvt<T>::to(rc.v[q]), fd = Cvt<T>::to(rd.v[q]);
      const float m1 = first_is_max(fa, fb) ? fa : fb;
      const float m2 = first_is_max(fc, fd) ? fc : fd;
      const float p = first_is_max(m1, m2) ? m1 : m2;
      const float gp = Cvt<T>::to(rg.v[q]);
      const float w1 = balanced(m1, p, m2), w2 = balanced(m2, p, m1);
      ra.v[q] = Cvt<T>::from(gp * (w1 * balanced(fa, m1, fb)));
      rb.v[q] = Cvt<T>::from(gp * (w1 * balanced(fb, m1, fa)));
      rc.v[q] = Cvt<T>::from(gp * (w2 * balanced(fc, m2, fd)));
      rd.v[q] = Cvt<T>::from(gp * (w2 * balanced(fd, m2, fc)));
    }
    pa = ra;
    pb = rb;
    pc = rc;
    pd = rd;
  }
}

// unpool_fwd on one pack of one full-resolution row: y * mask.
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> unpool_fwd_pack(const Pack<T, N>& pm,
                                                      const Pack<T, N>& py) {
  Pack<T, N> r;
  if constexpr (kPairs<T, N>) {
    set_word(r, u32(__hmul2_rn(b2(word(py)), b2(word(pm)))));
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q)
      r.v[q] = Cvt<T>::from(Cvt<T>::to(py.v[q]) * Cvt<T>::to(pm.v[q]));
  }
  return r;
}

// unpool_bwd on one pack: gy = sum over the corners of g * mask, as a chain
// of fused multiply-adds (exact for the one-hot masks of the contract). The
// chain runs from corner (1,1) back to (0,0): in that order ptxas issues
// all eight loads of a thread before the first multiply (in the order
// (0,0) first it waits for half of them in bf16, two memory round trips).
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> unpool_bwd_pack(
    const Pack<T, N>& ga, const Pack<T, N>& gb, const Pack<T, N>& gc,
    const Pack<T, N>& gd, const Pack<T, N>& ma, const Pack<T, N>& mb,
    const Pack<T, N>& mc, const Pack<T, N>& md) {
  Pack<T, N> r;
  if constexpr (kPairs<T, N>) {
    __nv_bfloat162 s = __hmul2_rn(b2(word(gd)), b2(word(md)));
    s = __hfma2(b2(word(gc)), b2(word(mc)), s);
    s = __hfma2(b2(word(gb)), b2(word(mb)), s);
    s = __hfma2(b2(word(ga)), b2(word(ma)), s);
    set_word(r, u32(s));
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float s = Cvt<T>::to(gd.v[q]) * Cvt<T>::to(md.v[q]);
      s = fmaf(Cvt<T>::to(gc.v[q]), Cvt<T>::to(mc.v[q]), s);
      s = fmaf(Cvt<T>::to(gb.v[q]), Cvt<T>::to(mb.v[q]), s);
      s = fmaf(Cvt<T>::to(ga.v[q]), Cvt<T>::to(ma.v[q]), s);
      r.v[q] = Cvt<T>::from(s);
    }
  }
  return r;
}

enum class Op { kPoolFwd, kPoolBwd, kUnpoolFwd, kUnpoolBwd };

// The pool pair stages its tiles in shared memory; the unpool pair loads
// and stores each pack straight from and to the tensors.
template <Op kOp>
constexpr bool kStaged = kOp == Op::kPoolFwd || kOp == Op::kPoolBwd;

// The pool pair on one tile: stage x's two row spans (and, backward, g's
// pooled span), compute in shared memory, store the outputs' spans.
template <Op kOp, typename T, int N, bool kExact>
__device__ __forceinline__ void staged_tile(const T* __restrict__ x,
                                            const T* __restrict__ g,
                                            T* __restrict__ full_out,
                                            T* __restrict__ pooled,
                                            const Tile& tl, const Tiling& a) {
  constexpr bool kBwd = kOp == Op::kPoolBwd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c;
  const int in_elems = buffer_elems<T>(2 * a.tile_w * c);
  T* const s0 = reinterpret_cast<T*>(smem);  // x row 2i, then mask or gx
  T* const s1 = s0 + in_elems;               // x row 2i+1, then mask or gx
  T* const so = s1 + in_elems;               // pooled (fwd) or g (bwd)
  const Span r0 = span_of<T, kExact>(tl.in0, 2 * tl.m, a.vec);
  const Span r1 = span_of<T, kExact>(tl.in1, 2 * tl.m, a.vec);
  const Span ro = span_of<T, kExact>(tl.out, tl.m, a.vec);
  stage<T, kExact>(s0, x + tl.in0, r0);
  stage<T, kExact>(s1, x + tl.in1, r1);
  if constexpr (kBwd) stage<T, kExact>(so, g + tl.out, ro);
  cp_async_wait_all();
  __syncthreads();
  T* const u = s0 + r0.pad;
  T* const v = s1 + r1.pad;
  T* const o = so + ro.pad;
  for (int kk = threadIdx.x; kk < tl.m / N; kk += blockDim.x) {
    const int ia = corner_of<N>(kk, a);
    Pack<T, N>& pa = pack_at<T, N>(u + ia);
    Pack<T, N>& pb = pack_at<T, N>(u + ia + c);
    Pack<T, N>& pc = pack_at<T, N>(v + ia);
    Pack<T, N>& pd = pack_at<T, N>(v + ia + c);
    if constexpr (kBwd)
      bwd_pack<T, N>(pa, pb, pc, pd, pack_at<T, N>(o + N * kk));
    else
      fwd_pack<T, N>(pa, pb, pc, pd, pack_at<T, N>(o + N * kk));
  }
  __syncthreads();
  if constexpr (!kBwd) unstage<T, kExact>(pooled + tl.out, so, ro);
  unstage<T, kExact>(full_out + tl.in0, s0, r0);
  unstage<T, kExact>(full_out + tl.in1, s1, r1);
  __syncthreads();  // the next row pair restages the buffers
}

// A pack of global memory read once through the read-only path, in one
// access of N * sizeof(T) bytes (the wrapper picks N = 2 only where every
// pointer and offset keeps it aligned).
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* __restrict__ p) {
  using W = std::conditional_t<sizeof(Pack<T, N>) == 8, uint2,
            std::conditional_t<sizeof(Pack<T, N>) == 4, unsigned,
                               unsigned short>>;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  Pack<T, N> r;
  memcpy(&r, &w, sizeof(r));
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* __restrict__ p,
                                           const Pack<T, N>& v) {
  pack_at<T, N>(p) = v;
}

// The unpool pair, one pack a thread, straight from and to the tensors
// (no shared memory, no loop: each thread's loads are all in flight before
// it computes). Pack kk of row pair rp is, for unpool_fwd, a pack of each
// of the two full-resolution rows, in column q = kk / (c / N) (by magic),
// with the pack of y whose window holds it: a warp's loads and stores are
// each one contiguous run, and its loads of y repeat in L1. For unpool_bwd
// it is a pack of the pooled row, with its four corners of g and of the
// mask: a warp's loads of corner (0,0) fetch the sectors that its loads of
// corner (0,1) then find in L1, and its stores of gy are contiguous.
template <Op kOp, typename T, int N>
__device__ __forceinline__ void direct_pack(const T* __restrict__ full,
                                            const T* __restrict__ mask,
                                            const T* __restrict__ y,
                                            T* __restrict__ out,
                                            T* __restrict__ gy, int64_t rp,
                                            int kk, const Tiling& a) {
  const int c = a.c;
  const int wc = a.w * c;  // one pooled row (< 2^31: checked at launch)
  const int64_t in0 = 4 * rp * wc, in1 = in0 + 2 * wc, po = rp * wc;
  if constexpr (kOp == Op::kUnpoolFwd) {  // full is the mask
    if (kk >= 2 * wc / N) return;
    const int q = c == N ? kk : static_cast<int>(__umulhi(kk, a.magic));
    const int e = N * kk;  // (q, e - q * c) sits in pooled (q / 2, e - q * c)
    const Pack<T, N> py = load_pack<T, N>(y + po + e - ((q + 1) >> 1) * c);
    const Pack<T, N> m0 = load_pack<T, N>(full + in0 + e);
    const Pack<T, N> m1 = load_pack<T, N>(full + in1 + e);
    store_pack<T, N>(out + in0 + e, unpool_fwd_pack<T, N>(m0, py));
    store_pack<T, N>(out + in1 + e, unpool_fwd_pack<T, N>(m1, py));
  } else {  // full is g
    if (kk >= wc / N) return;
    const int ia = corner_of<N>(kk, a);
    const T* const g0 = full + in0 + ia;
    const T* const g1 = full + in1 + ia;
    const T* const m0 = mask + in0 + ia;
    const T* const m1 = mask + in1 + ia;
    store_pack<T, N>(gy + po + N * kk,
                     unpool_bwd_pack<T, N>(
                         load_pack<T, N>(g0), load_pack<T, N>(g0 + c),
                         load_pack<T, N>(g1), load_pack<T, N>(g1 + c),
                         load_pack<T, N>(m0), load_pack<T, N>(m0 + c),
                         load_pack<T, N>(m1), load_pack<T, N>(m1 + c)));
  }
}

// One template for the four kernels. The tensors by role (unused ones
// null):
//   full       full-resolution input: x (pool), the mask (unpool_fwd), g
//   mask       unpool_bwd's mask
//   pooled_in  pooled input: g (pool_mask_bwd), y (unpool_fwd)
//   full_out   full-resolution output: the mask (pool_mask_fwd), gx, out
//   pooled_out pooled output: pooled (pool_mask_fwd), gy (unpool_bwd)
// The pool pair: block (tj, y) takes the tile (tj, rp) of row pair rp = y,
// and y + gridDim.y, ... where there are more row pairs than a grid has
// rows. The unpool pair: block (tj, y, z) takes packs [tj * tile_w, +tile_w)
// of row pair rp = z * gridDim.y + y, one a thread (tile_w = blockDim.x).
template <Op kOp, typename T, int N, bool kExact>
__global__ void tiled_kernel(const T* __restrict__ full,
                             const T* __restrict__ mask,
                             const T* __restrict__ pooled_in,
                             T* __restrict__ full_out,
                             T* __restrict__ pooled_out, Tiling a) {
  if constexpr (kStaged<kOp>) {
    for (int rp = blockIdx.y; rp < a.rows; rp += gridDim.y)
      staged_tile<kOp, T, N, kExact>(full, pooled_in, full_out, pooled_out,
                                     tile_of(blockIdx.x, rp, a), a);
  } else {
    const int64_t rp = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
    if (rp < a.rows)
      direct_pack<kOp, T, N>(full, mask, pooled_in, full_out, pooled_out, rp,
                             blockIdx.x * blockDim.x + threadIdx.x, a);
  }
}

// The tensors of one launch, by their role in tiled_kernel.
struct Ptrs {
  const void *full, *mask, *pooled_in;
  void *full_out, *pooled_out;
};

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }

template <typename T>
T* out(void* p) { return static_cast<T*>(p); }

// Above 48 KB of dynamic shared memory a kernel must be allowed it first.
template <Op kOp, typename T, int N, bool kExact>
cudaError_t launch(const Ptrs& p, const Tiling& a, dim3 grid, int threads,
                   int smem_bytes, cudaStream_t s) {
  const auto kernel = tiled_kernel<kOp, T, N, kExact>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem_bytes, s>>>(
      in<T>(p.full), in<T>(p.mask), in<T>(p.pooled_in), out<T>(p.full_out),
      out<T>(p.pooled_out), a);
  return cudaSuccess;
}

// Whether the wrapper's tiling fits the shape, so the kernel neither misses
// nor overruns an element: the tiles of a row reach its end with none left
// empty, and the magic divides exactly by c / N for every pack of a row.
// The pool pair's buffers fit in smem_bytes, and its 16-byte accesses are
// only asked of aligned pointers (vec >= 1) and of spans that are whole
// vectors (vec == 2). The unpool pair takes one pack a thread (threads ==
// tile_w), no shared memory and no 16-byte access (vec == 0), and a pack
// of two only of pointers aligned to it.
template <Op kOp, typename T>
bool tiling_fits(const Ptrs& p, const Tiling& a, int tiles_per_row,
                 int threads, int smem_bytes, int pack) {
  constexpr int64_t V = kVec<T>;
  if (a.tile_w <= 0 || threads <= 0 || threads > 1024 || pack <= 0 ||
      a.c % pack != 0 || a.vec < 0 || a.vec > (kStaged<kOp> ? 2 : 0))
    return false;
  const int64_t wc = static_cast<int64_t>(a.w) * a.c;  // one pooled row
  const int64_t cn = a.c / pack;
  const int64_t m = static_cast<int64_t>(a.tile_w) * a.c;  // a staged tile
  // the packs the magic divides: at most m in a staged tile; a
  // full-resolution row's (unpool_fwd) or the pooled row's (unpool_bwd)
  const int64_t packs = kStaged<kOp> ? m
                        : (kOp == Op::kUnpoolFwd ? 2 : 1) * wc / pack;
  if (kStaged<kOp>) {
    if (tiles_per_row != (a.w + a.tile_w - 1) / a.tile_w ||
        2 * m + 2 * V > INT32_MAX ||
        smem_bytes < static_cast<int64_t>(sizeof(T)) *
                         (2 * buffer_elems<T>(2 * m) + buffer_elems<T>(m)))
      return false;
  } else if (threads != a.tile_w || smem_bytes != 0 || 2 * wc > INT32_MAX ||
             tiles_per_row != (packs + a.tile_w - 1) / a.tile_w) {
    return false;
  }
  if (cn > 1 && (packs * cn >= (int64_t{1} << 32) ||
                 a.magic != static_cast<unsigned>(((int64_t{1} << 32) + cn - 1) / cn)))
    return false;
  // the pool pair's packs live in shared memory, the unpool pair's in the
  // tensors themselves
  const uintptr_t align = a.vec >= 1 ? 16 : kStaged<kOp> ? 1 : pack * sizeof(T);
  for (const void* q : {p.full, p.mask, p.pooled_in,
                        static_cast<const void*>(p.full_out),
                        static_cast<const void*>(p.pooled_out)})
    if (reinterpret_cast<uintptr_t>(q) % align != 0) return false;
  const int64_t tiles = (a.w + a.tile_w - 1) / a.tile_w;
  const int64_t last_w = a.w - (tiles - 1) * a.tile_w;
  if (a.vec == 2 && (wc % V != 0 || m % V != 0 || (last_w * a.c) % V != 0))
    return false;
  return true;
}

template <Op kOp, typename T, int N>
cudaError_t run(const Ptrs& p, const Tiling& a, dim3 grid, int threads,
                int smem_bytes, cudaStream_t s) {
  if constexpr (kStaged<kOp>)  // the unpool pair has no edge code to drop
    if (a.vec == 2)
      return launch<kOp, T, N, true>(p, a, grid, threads, smem_bytes, s);
  return launch<kOp, T, N, false>(p, a, grid, threads, smem_bytes, s);
}

template <Op kOp, typename T>
cudaError_t run(const Ptrs& p, int pack, const Tiling& a, dim3 grid,
                int threads, int smem_bytes, cudaStream_t s) {
  if (!tiling_fits<kOp, T>(p, a, static_cast<int>(grid.x), threads,
                           smem_bytes, pack))
    return cudaErrorInvalidValue;
  switch (pack) {
    case 2:
      return run<kOp, T, 2>(p, a, grid, threads, smem_bytes, s);
    case 1:
      return run<kOp, T, 1>(p, a, grid, threads, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <Op kOp>
int enter(const Ptrs& p, int64_t n, int64_t h, int64_t w, int64_t c,
             int is_bf16, int device, void* stream, int tile_w,
             int tiles_per_row, int grid_rows, int threads, int smem_bytes,
             int vec, int pack, unsigned magic) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = n * h;
  if (rows == 0 || w == 0 || c == 0) return 0;
  if (rows > INT32_MAX || w > INT32_MAX || c > INT32_MAX || tile_w <= 0 ||
      tiles_per_row <= 0 || grid_rows != (rows < 65535 ? rows : 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiling a{static_cast<int>(rows), static_cast<int>(w),
                 static_cast<int>(c), tile_w, vec, magic};
  // the pool pair loops over row pairs beyond the grid's rows, the unpool
  // pair takes them in its third dimension (rows < 65535^2: no limit)
  const int64_t layers = kStaged<kOp> ? 1 : (rows + grid_rows - 1) / grid_rows;
  const dim3 grid(tiles_per_row, grid_rows, static_cast<unsigned>(layers));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? run<kOp, __nv_bfloat16>(p, pack, a, grid, threads,
                                          smem_bytes, s)
                : run<kOp, float>(p, pack, a, grid, threads, smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All sizes are those of the pooled (half-resolution) tensor: the
// full-resolution tensors are (n, 2h, 2w, c). is_bf16 selects
// __nv_bfloat16 over float; device is the CUDA ordinal of every pointer.
// The last eight arguments are the tiling from
// ops/pool_kernels.py:pool_tiling.
extern "C" {

#define TILING_ARGS                                                          \
  int tile_w, int tiles_per_row, int grid_rows, int threads, int smem_bytes, \
      int vec, int pack, unsigned magic
#define TILING tile_w, tiles_per_row, grid_rows, threads, smem_bytes, vec, pack, magic

// x (n,2h,2w,c) -> pooled (n,h,w,c), mask (n,2h,2w,c)
int pool_mask_fwd(const void* x, void* pooled, void* mask, int64_t n,
                  int64_t h, int64_t w, int64_t c, int is_bf16, int device,
                  void* stream, TILING_ARGS) {
  return enter<Op::kPoolFwd>({x, nullptr, nullptr, mask, pooled}, n, h, w,
                                c, is_bf16, device, stream, TILING);
}

// x (n,2h,2w,c), g (n,h,w,c) -> gx (n,2h,2w,c)
int pool_mask_bwd(const void* x, const void* g, void* gx, int64_t n,
                  int64_t h, int64_t w, int64_t c, int is_bf16, int device,
                  void* stream, TILING_ARGS) {
  return enter<Op::kPoolBwd>({x, nullptr, g, gx, nullptr}, n, h, w, c,
                                is_bf16, device, stream, TILING);
}

// y (n,h,w,c), mask (n,2h,2w,c) -> out (n,2h,2w,c)
int unpool_fwd(const void* y, const void* mask, void* out, int64_t n,
               int64_t h, int64_t w, int64_t c, int is_bf16, int device,
               void* stream, TILING_ARGS) {
  return enter<Op::kUnpoolFwd>({mask, nullptr, y, out, nullptr}, n, h, w,
                                  c, is_bf16, device, stream, TILING);
}

// g (n,2h,2w,c), mask (n,2h,2w,c) -> gy (n,h,w,c)
int unpool_bwd(const void* g, const void* mask, void* gy, int64_t n,
               int64_t h, int64_t w, int64_t c, int is_bf16, int device,
               void* stream, TILING_ARGS) {
  return enter<Op::kUnpoolBwd>({g, mask, nullptr, nullptr, gy}, n, h, w, c,
                                  is_bf16, device, stream, TILING);
}

#undef TILING
#undef TILING_ARGS

}  // extern "C"
