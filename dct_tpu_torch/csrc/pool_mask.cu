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
//   * unpool: out = y repeated over each window times the mask (a multiply,
//     so NaN * 0 stays NaN); its backward is the window sum of g * mask.
//
// Bound on an H100 SXM: bytes. Each kernel does a few compares or multiplies
// per element it moves, far below the card's ~20 operations per byte for
// fp32 CUDA-core math, so its least time is the bytes it must read and write
// over 3.35 TB/s. Comparisons run in fp32 (__bfloat162float for bf16), and
// pooled values are copied from the input bits, never re-rounded.
//
// pool_mask_fwd and pool_mask_bwd (one template, pool_tiled_kernel) work on
// row-pair tiles. For a fixed (n, i) the input rows 2i and 2i+1 are each one
// contiguous span of 2w*c elements and the pooled row i one span of w*c; a
// tile is the pooled columns [j0, j0 + tile_w) of one row pair, so it reads
// and writes three contiguous spans. Block (tile of the row, row pair) takes
// one tile:
//   1. stage: copy the spans of x (and, backward, of g) into shared memory,
//      16 bytes a thread with cp.async; a span's unaligned head and tail go
//      one element a thread, inside the same kernel;
//   2. compute: each thread takes pooled elements two channels at a time
//      (c even) as one 32-bit shared-memory access, reads the four window
//      corners and writes pooled (forward) and the mask or gx back over the
//      staged x (windows are disjoint, so each thread owns its four slots).
//      bf16 pairs are compared, selected and weighted as 32-bit words
//      (set.*.u32.bf16x2, bitwise selects, one mul.rn.bf16x2 per corner);
//   3. store: pooled, mask or gx go out as 16-byte vectors along the same
//      spans.
// What the design does about the one-thread-per-element kernel before it:
//   * instructions per byte: a warp's global load or store moves 512 bytes
//     instead of 64 (bf16); bf16 window math is ~1/3 of the instructions;
//   * sectors: each 32-byte sector of x, mask or gx is moved by one
//     instruction, whatever C is (C = 14 runs of 28 bytes included);
//   * index math: the wrapper computes the tiling (tile width, grid,
//     threads, shared memory, a magic multiplier for c / 2, and whether all
//     spans are whole 16-byte vectors, which compiles the head and tail code
//     out). The kernel has no division: a 2-D grid names the tile, and
//     column = umulhi(pair, magic). Only a tile's base offset is 64-bit;
//   * bytes in flight: every thread issues all its copies before it waits;
//     256-element tiles and 2 elements a thread give the main path 2,048
//     blocks of 128 threads, all resident at once.
// Shared memory per block: two x buffers of 2*tile_w*c elements and one of
// tile_w*c, each padded by one vector so a buffer and its span agree modulo
// 16 bytes (ops/pool_kernels.py:pool_tiling computes the same size). On the
// main path that is 2,288 / 2,608 bytes in bf16 and 4,528 / 5,168 in fp32
// (bottleneck_1_0 / bottleneck_2_0), all dynamic. -Xptxas -v on an H100
// (sm_90a, CUDA 12.8): the main path's instances (N = 2, whole spans) use
// 20 (fwd) and 26 (bwd) registers a thread in bf16, 22 and 28 in fp32; no
// instance spills or uses more than 32.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cstring>
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

// Offsets of the four window corners of pooled element idx (n, i, j, ch) in
// an (n, 2h, 2w, c) tensor: r0 = (0,0); r0 + c = (0,1); r1 = (1,0); r1 + c.
struct Window {
  int64_t r0, r1;
};

__device__ __forceinline__ Window window_of(int64_t idx, int64_t h, int64_t w,
                                            int64_t c) {
  const int64_t ch = idx % c;
  int64_t t = idx / c;
  const int64_t j = t % w;
  t /= w;
  const int64_t i = t % h;
  const int64_t n = t / h;
  const int64_t row = 2 * w * c;  // one full-resolution row
  Window win;
  win.r0 = (n * 2 * h + 2 * i) * row + 2 * j * c + ch;
  win.r1 = win.r0 + row;
  return win;
}

// ---- pool_mask_fwd / pool_mask_bwd: row-pair tiles in shared memory ----

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
  int rows, w, c, tile_w;
  int vec;         // 0: all scalar; 1: 16-byte body; 2: spans all whole
  unsigned magic;  // ceil(2^32 / (c / N)): j = umulhi(kk, magic), exact here
};

// Tile (tj, rp): pooled columns [tj * tile_w, +tile_w) of row pair rp =
// n * h + i, whose input rows are 2 * rp and 2 * rp + 1 of the
// (n * 2h, 2w * c) view of x. A 2-D grid (tiles of a row, row pairs) needs
// no division to find them.
struct Tile {
  int64_t in0, in1, out;  // span starts: input rows 2i, 2i+1; pooled row i
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

// N neighbouring channels, read and written in shared memory as one access
// (the wrapper picks N = 2 where c is even, else 1, so a pack never
// crosses a window corner and stays aligned).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N>& pack_at(T* p) {
  return *reinterpret_cast<Pack<T, N>*>(p);
}

// Offset in a staged input row of the (0,0) corner of pack kk of the tile:
// pooled element k = N * kk at column j = k / c, channel k - j * c, sits at
// 2 * j * c + (k - j * c) = k + j * c.
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

// The forward on one pack: pooled into po, the mask over the corners.
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

// The backward on one pack: gx over the corners, from the pooled gradient.
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

// pool_mask_fwd (kBwd false: small = pooled, big = mask) and pool_mask_bwd
// (kBwd true: small = g, read only; big = gx). Block (tj, y) takes the tile
// (tj, rp) of row pair rp = y, and y + gridDim.y, ... where there are more
// row pairs than a grid has rows.
template <typename T, int N, bool kBwd, bool kExact>
__global__ void pool_tiled_kernel(const T* __restrict__ x,
                                  T* __restrict__ small, T* __restrict__ big,
                                  Tiling a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c;
  const int in_elems = buffer_elems<T>(2 * a.tile_w * c);
  T* const s0 = reinterpret_cast<T*>(smem);  // input row 2i, then mask/gx
  T* const s1 = s0 + in_elems;               // input row 2i+1, then mask/gx
  T* const so = s1 + in_elems;               // pooled (fwd) or g (bwd)
  for (int rp = blockIdx.y; rp < a.rows; rp += gridDim.y) {
    const Tile tl = tile_of(blockIdx.x, rp, a);
    const Span r0 = span_of<T, kExact>(tl.in0, 2 * tl.m, a.vec);
    const Span r1 = span_of<T, kExact>(tl.in1, 2 * tl.m, a.vec);
    const Span ro = span_of<T, kExact>(tl.out, tl.m, a.vec);
    stage<T, kExact>(s0, x + tl.in0, r0);
    stage<T, kExact>(s1, x + tl.in1, r1);
    if (kBwd) stage<T, kExact>(so, small + tl.out, ro);
    cp_async_wait_all();
    __syncthreads();
    T* const u = s0 + r0.pad;
    T* const v = s1 + r1.pad;
    T* const o = so + ro.pad;
    for (int kk = threadIdx.x; kk < tl.m / N; kk += blockDim.x) {
      const int ia = corner_of<N>(kk, a);
      if (kBwd)
        bwd_pack<T, N>(pack_at<T, N>(u + ia), pack_at<T, N>(u + ia + c),
                       pack_at<T, N>(v + ia), pack_at<T, N>(v + ia + c),
                       pack_at<T, N>(o + N * kk));
      else
        fwd_pack<T, N>(pack_at<T, N>(u + ia), pack_at<T, N>(u + ia + c),
                       pack_at<T, N>(v + ia), pack_at<T, N>(v + ia + c),
                       pack_at<T, N>(o + N * kk));
    }
    __syncthreads();
    if (!kBwd) unstage<T, kExact>(small + tl.out, so, ro);
    unstage<T, kExact>(big + tl.in0, s0, r0);
    unstage<T, kExact>(big + tl.in1, s1, r1);
    __syncthreads();  // the next row pair restages the buffers
  }
}

// ---- unpool_fwd / unpool_bwd: one thread per pooled element ----

template <typename T>
__global__ void unpool_fwd_kernel(const T* __restrict__ y,
                                  const T* __restrict__ mask,
                                  T* __restrict__ out, int64_t total,
                                  int64_t h, int64_t w, int64_t c) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Window win = window_of(idx, h, w, c);
  const float v = Cvt<T>::to(y[idx]);
  out[win.r0] = Cvt<T>::from(v * Cvt<T>::to(mask[win.r0]));
  out[win.r0 + c] = Cvt<T>::from(v * Cvt<T>::to(mask[win.r0 + c]));
  out[win.r1] = Cvt<T>::from(v * Cvt<T>::to(mask[win.r1]));
  out[win.r1 + c] = Cvt<T>::from(v * Cvt<T>::to(mask[win.r1 + c]));
}

template <typename T>
__global__ void unpool_bwd_kernel(const T* __restrict__ g,
                                  const T* __restrict__ mask,
                                  T* __restrict__ gy, int64_t total,
                                  int64_t h, int64_t w, int64_t c) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Window win = window_of(idx, h, w, c);
  const float s = Cvt<T>::to(g[win.r0]) * Cvt<T>::to(mask[win.r0])
                + Cvt<T>::to(g[win.r0 + c]) * Cvt<T>::to(mask[win.r0 + c])
                + Cvt<T>::to(g[win.r1]) * Cvt<T>::to(mask[win.r1])
                + Cvt<T>::to(g[win.r1 + c]) * Cvt<T>::to(mask[win.r1 + c]);
  gy[idx] = Cvt<T>::from(s);
}

constexpr int kThreads = 256;

// Pointers arrive in each entry point's argument order (p0, p1, p2); each
// Launch casts them to the kernel's types. h, w are the pooled
// (half-resolution) sizes; total = n * h * w * c.
template <template <typename> class Launch>
int dispatch(const void* p0, const void* p1, const void* p2, int64_t n,
             int64_t h, int64_t w, int64_t c, int is_bf16, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = n * h * w * c;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    Launch<__nv_bfloat16>::run(blocks, s, p0, p1, p2, total, h, w, c);
  } else {
    Launch<float>::run(blocks, s, p0, p1, p2, total, h, w, c);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }

template <typename T>
T* out(const void* p) { return static_cast<T*>(const_cast<void*>(p)); }

// The tiled kernels: the wrapper's tiling arrives as plain integers. Above
// 48 KB of dynamic shared memory a kernel must be allowed it first.
template <typename Kernel, typename... Args>
cudaError_t launch_tiled(Kernel kernel, dim3 grid, int threads, int smem_bytes,
                         cudaStream_t s, Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem_bytes, s>>>(args...);
  return cudaSuccess;
}

template <typename T, int N, bool kExact>
cudaError_t run_tiled(bool bwd, const void* p0, const void* p1, const void* p2,
                      const Tiling& a, dim3 grid, int threads, int smem_bytes,
                      cudaStream_t s) {
  if (bwd)  // x, g, gx
    return launch_tiled(pool_tiled_kernel<T, N, true, kExact>, grid, threads,
                        smem_bytes, s, in<T>(p0), out<T>(p1), out<T>(p2), a);
  // x, pooled, mask
  return launch_tiled(pool_tiled_kernel<T, N, false, kExact>, grid, threads,
                      smem_bytes, s, in<T>(p0), out<T>(p1), out<T>(p2), a);
}

template <typename T, int N>
cudaError_t run_tiled(bool bwd, const void* p0, const void* p1, const void* p2,
                      const Tiling& a, dim3 grid, int threads, int smem_bytes,
                      cudaStream_t s) {
  return a.vec == 2 ? run_tiled<T, N, true>(bwd, p0, p1, p2, a, grid, threads,
                                            smem_bytes, s)
                    : run_tiled<T, N, false>(bwd, p0, p1, p2, a, grid,
                                             threads, smem_bytes, s);
}

// Whether the wrapper's tiling fits the shape, so the kernel neither misses
// nor overruns an element: the tiles of a row reach its end with none left
// empty, the buffers fit in smem_bytes, the magic divides exactly by c / N
// for every pack of a tile, and 16-byte accesses are only asked of aligned
// pointers (vec >= 1) and of spans that are whole vectors (vec == 2).
template <typename T>
bool tiling_fits(const void* const (&ptrs)[3], const Tiling& a, int threads,
                 int smem_bytes, int pack) {
  constexpr int64_t V = kVec<T>;
  if (a.tile_w <= 0 || threads <= 0 || threads > 1024 || pack <= 0 ||
      a.c % pack != 0 || a.vec < 0 || a.vec > 2)
    return false;
  const int64_t tiles_per_row = (a.w + a.tile_w - 1) / a.tile_w;
  const int64_t last_w = a.w - (tiles_per_row - 1) * a.tile_w;
  const int64_t m = static_cast<int64_t>(a.tile_w) * a.c;  // a whole tile
  if (2 * m + 2 * V > INT32_MAX) return false;
  if (smem_bytes < static_cast<int64_t>(sizeof(T)) *
                       (2 * buffer_elems<T>(2 * m) + buffer_elems<T>(m)))
    return false;
  const int64_t cn = a.c / pack;
  if (cn > 1 && (m * cn >= (int64_t{1} << 32) ||
                 a.magic != static_cast<unsigned>(((int64_t{1} << 32) + cn - 1) / cn)))
    return false;
  if (a.vec >= 1)
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  if (a.vec == 2 &&
      ((static_cast<int64_t>(a.w) * a.c) % V != 0 || m % V != 0 || (last_w * a.c) % V != 0))
    return false;
  return true;
}

template <typename T>
cudaError_t run_tiled(int pack, bool bwd, const void* p0, const void* p1,
                      const void* p2, const Tiling& a, dim3 grid, int threads,
                      int smem_bytes, cudaStream_t s) {
  const void* const ptrs[3] = {p0, p1, p2};
  if (!tiling_fits<T>(ptrs, a, threads, smem_bytes, pack) ||
      grid.x != static_cast<unsigned>((a.w + a.tile_w - 1) / a.tile_w))
    return cudaErrorInvalidValue;
  switch (pack) {
    case 2:
      return run_tiled<T, 2>(bwd, p0, p1, p2, a, grid, threads, smem_bytes, s);
    case 1:
      return run_tiled<T, 1>(bwd, p0, p1, p2, a, grid, threads, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch_tiled(bool bwd, const void* p0, const void* p1, const void* p2,
                   int64_t n, int64_t h, int64_t w, int64_t c, int is_bf16,
                   int device, void* stream, int tile_w, int tiles_per_row,
                   int grid_rows, int threads, int smem_bytes, int vec,
                   int pack, unsigned magic) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = n * h;
  if (rows == 0 || w == 0 || c == 0) return 0;
  if (rows > INT32_MAX || w > INT32_MAX || c > INT32_MAX || tile_w <= 0 ||
      tiles_per_row <= 0 || grid_rows != (rows < 65535 ? rows : 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiling a{static_cast<int>(rows), static_cast<int>(w),
                 static_cast<int>(c), tile_w, vec, magic};
  const dim3 grid(tiles_per_row, grid_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? run_tiled<__nv_bfloat16>(pack, bwd, p0, p1, p2, a, grid,
                                           threads, smem_bytes, s)
                : run_tiled<float>(pack, bwd, p0, p1, p2, a, grid, threads,
                                   smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct UnpoolFwd {  // y, mask, out
  static void run(unsigned blocks, cudaStream_t s, const void* p0,
                  const void* p1, const void* p2, int64_t total, int64_t h,
                  int64_t w, int64_t c) {
    unpool_fwd_kernel<T><<<blocks, kThreads, 0, s>>>(
        in<T>(p0), in<T>(p1), out<T>(p2), total, h, w, c);
  }
};

template <typename T>
struct UnpoolBwd {  // g, mask, gy
  static void run(unsigned blocks, cudaStream_t s, const void* p0,
                  const void* p1, const void* p2, int64_t total, int64_t h,
                  int64_t w, int64_t c) {
    unpool_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
        in<T>(p0), in<T>(p1), out<T>(p2), total, h, w, c);
  }
};

}  // namespace

// All sizes are those of the pooled (half-resolution) tensor: the
// full-resolution tensors are (n, 2h, 2w, c). is_bf16 selects
// __nv_bfloat16 over float; device is the CUDA ordinal of every pointer.
extern "C" {

// x (n,2h,2w,c) -> pooled (n,h,w,c), mask (n,2h,2w,c). The last eight
// arguments are the tiling from ops/pool_kernels.py:pool_tiling.
int pool_mask_fwd(const void* x, void* pooled, void* mask, int64_t n,
                  int64_t h, int64_t w, int64_t c, int is_bf16, int device,
                  void* stream, int tile_w, int tiles_per_row, int grid_rows,
                  int threads, int smem_bytes, int vec, int pack,
                  unsigned magic) {
  return dispatch_tiled(false, x, pooled, mask, n, h, w, c, is_bf16, device,
                        stream, tile_w, tiles_per_row, grid_rows, threads,
                        smem_bytes, vec, pack, magic);
}

// x (n,2h,2w,c), g (n,h,w,c) -> gx (n,2h,2w,c); tiling as above.
int pool_mask_bwd(const void* x, const void* g, void* gx, int64_t n,
                  int64_t h, int64_t w, int64_t c, int is_bf16, int device,
                  void* stream, int tile_w, int tiles_per_row, int grid_rows,
                  int threads, int smem_bytes, int vec, int pack,
                  unsigned magic) {
  return dispatch_tiled(true, x, g, gx, n, h, w, c, is_bf16, device, stream,
                        tile_w, tiles_per_row, grid_rows, threads, smem_bytes,
                        vec, pack, magic);
}

// y (n,h,w,c), mask (n,2h,2w,c) -> out (n,2h,2w,c)
int unpool_fwd(const void* y, const void* mask, void* out, int64_t n,
               int64_t h, int64_t w, int64_t c, int is_bf16, int device,
               void* stream) {
  return dispatch<UnpoolFwd>(y, mask, out, n, h, w, c, is_bf16, device,
                             stream);
}

// g (n,2h,2w,c), mask (n,2h,2w,c) -> gy (n,h,w,c)
int unpool_bwd(const void* g, const void* mask, void* gy, int64_t n,
               int64_t h, int64_t w, int64_t c, int is_bf16, int device,
               void* stream) {
  return dispatch<UnpoolBwd>(g, mask, gy, n, h, w, c, is_bf16, device,
                             stream);
}

}  // extern "C"
