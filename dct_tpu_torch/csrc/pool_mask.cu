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
// over 3.35 TB/s. Design: one thread per pooled element (n, i, j, c) with c
// fastest, so the 32 threads of a warp touch 32 neighbouring channels of
// each of the four window corners: every load and store coalesces along C,
// for any C (C = 14 included) and with no vector-width assumption. Each
// input element is read once and each output element written once; nothing
// is reused, so nothing is staged in shared memory. Comparisons run in fp32
// (__bfloat162float for bf16), and pooled values are copied from the input
// bits, never re-rounded.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cstdint>

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

template <typename T>
__global__ void pool_mask_fwd_kernel(const T* __restrict__ x,
                                     T* __restrict__ pooled,
                                     T* __restrict__ mask, int64_t total,
                                     int64_t h, int64_t w, int64_t c) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Window win = window_of(idx, h, w, c);
  const T ra = x[win.r0], rb = x[win.r0 + c], rc = x[win.r1], rd = x[win.r1 + c];
  const float a = Cvt<T>::to(ra), b = Cvt<T>::to(rb);
  const float cc = Cvt<T>::to(rc), d = Cvt<T>::to(rd);
  const bool ab = first_is_max(a, b);
  const bool cd = first_is_max(cc, d);
  const float m1 = ab ? a : b, m2 = cd ? cc : d;
  const bool top = first_is_max(m1, m2);
  const float p = top ? m1 : m2;
  pooled[idx] = top ? (ab ? ra : rb) : (cd ? rc : rd);
  const bool e00 = a == p;
  const bool e01 = !e00 && b == p;
  const bool e10 = !e00 && !e01 && cc == p;
  const bool e11 = !e00 && !e01 && !e10;
  const T one = Cvt<T>::from(1.0f), zero = Cvt<T>::from(0.0f);
  mask[win.r0] = e00 ? one : zero;
  mask[win.r0 + c] = e01 ? one : zero;
  mask[win.r1] = e10 ? one : zero;
  mask[win.r1 + c] = e11 ? one : zero;
}

template <typename T>
__global__ void pool_mask_bwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ g,
                                     T* __restrict__ gx, int64_t total,
                                     int64_t h, int64_t w, int64_t c) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Window win = window_of(idx, h, w, c);
  const float a = Cvt<T>::to(x[win.r0]), b = Cvt<T>::to(x[win.r0 + c]);
  const float cc = Cvt<T>::to(x[win.r1]), d = Cvt<T>::to(x[win.r1 + c]);
  const float m1 = first_is_max(a, b) ? a : b;
  const float m2 = first_is_max(cc, d) ? cc : d;
  const float p = first_is_max(m1, m2) ? m1 : m2;
  const float gp = Cvt<T>::to(g[idx]);
  const float w1 = balanced(m1, p, m2), w2 = balanced(m2, p, m1);
  gx[win.r0] = Cvt<T>::from(gp * (w1 * balanced(a, m1, b)));
  gx[win.r0 + c] = Cvt<T>::from(gp * (w1 * balanced(b, m1, a)));
  gx[win.r1] = Cvt<T>::from(gp * (w2 * balanced(cc, m2, d)));
  gx[win.r1 + c] = Cvt<T>::from(gp * (w2 * balanced(d, m2, cc)));
}

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

template <typename T>
struct PoolFwd {  // x, pooled, mask
  static void run(unsigned blocks, cudaStream_t s, const void* p0,
                  const void* p1, const void* p2, int64_t total, int64_t h,
                  int64_t w, int64_t c) {
    pool_mask_fwd_kernel<T><<<blocks, kThreads, 0, s>>>(
        in<T>(p0), out<T>(p1), out<T>(p2), total, h, w, c);
  }
};

template <typename T>
struct PoolBwd {  // x, g, gx
  static void run(unsigned blocks, cudaStream_t s, const void* p0,
                  const void* p1, const void* p2, int64_t total, int64_t h,
                  int64_t w, int64_t c) {
    pool_mask_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
        in<T>(p0), in<T>(p1), out<T>(p2), total, h, w, c);
  }
};

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

// x (n,2h,2w,c) -> pooled (n,h,w,c), mask (n,2h,2w,c)
int pool_mask_fwd(const void* x, void* pooled, void* mask, int64_t n,
                  int64_t h, int64_t w, int64_t c, int is_bf16, int device,
                  void* stream) {
  return dispatch<PoolFwd>(x, pooled, mask, n, h, w, c, is_bf16, device,
                           stream);
}

// x (n,2h,2w,c), g (n,h,w,c) -> gx (n,2h,2w,c)
int pool_mask_bwd(const void* x, const void* g, void* gx, int64_t n,
                  int64_t h, int64_t w, int64_t c, int is_bf16, int device,
                  void* stream) {
  return dispatch<PoolBwd>(x, g, gx, n, h, w, c, is_bf16, device, stream);
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
