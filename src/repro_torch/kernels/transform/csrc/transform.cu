// Blockwise 4-point DCT-II transform kernels for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// transform_f32 replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/transform/kernel.py (_call, via fwd and inv): each 4x4
// block of an (R, C) float32 grid is rotated by a 4x4 basis, c = M b M^T,
// last axis first, then the rows ("2d" mode), or along the last axis only
// ("1d" mode).  The caller passes MAT (forward) or MAT^T (inverse), rounded
// to float32 on the host.
//
// transform_axis_f64 has no TPU counterpart: it is the float64 product the
// JAX package's coder computes with numpy on the host
// (src/repro/core/transform.py:92, _apply_axis), done on the card so the
// coder's verification stays on the card.  It applies a 4x4 matrix along one
// axis of a contiguous array viewed as (outer, len, inner).
//
// Both are bound by device memory: 16 multiplies and 12 adds per 4 values
// read and 4 written, far below the card's ALU rate per byte.
//   * transform_f32: one thread per 4x4 block ("2d") or per 4-group ("1d").
//     A thread reads its block as four float4 loads of 16 B (one per row)
//     and writes four float4 stores; neighbouring threads own neighbouring
//     blocks along a row, so every warp access is coalesced.  The product
//     stays in registers.  No shared memory: each block is independent.
//   * transform_axis_f64: one thread per group of 4 along the axis and
//     position in the inner dimension; neighbouring threads own neighbouring
//     inner positions (or, for the last axis, neighbouring groups).
//
// Rounding, as written, so that each kernel equals its plain version
// (../ref.py and numpy) bit for bit:
//   * float32: every output is ((m0*b0 + m1*b1) + m2*b2) + m3*b3 with
//     __fmul_rn / __fadd_rn, which the compiler never contracts into an FMA.
//   * float64, by the order argument (ORDERS in ../ref.py), with
//     p_j = m_j*b_j and fma(p, c) = p + c rounded once:
//       0 fma_chain  fma(p3, fma(p2, fma(p1, fma(p0, 0))))  BLAS dgemm, and
//                    numpy 2.3's own loop, along an axis longer than 4;
//       1 pairs      (p0 + p2) + (p1 + p3)                   BLAS dgemv, MAT;
//       2 pair_fma   fma(p3, fma(p2, p0 + p1))               BLAS dgemv, MAT^T.
//   The caller picks the one this machine's numpy uses for the axis.
// Do not build with --use_fast_math.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGrid = 1 << 16;  // cap for grid-stride launches

struct Mat4f {
  float m[16];  // row-major: m[4 * k + j] multiplies input j into output k
};

struct Mat4d {
  double m[16];
};

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

__device__ __forceinline__ float dot4(const Mat4f& mat, int k, float b0, float b1,
                                      float b2, float b3) {
  const float* m = mat.m + 4 * k;
  float acc = __fadd_rn(__fmul_rn(m[0], b0), __fmul_rn(m[1], b1));
  acc = __fadd_rn(acc, __fmul_rn(m[2], b2));
  return __fadd_rn(acc, __fmul_rn(m[3], b3));
}

__device__ __forceinline__ float4 rotate4(const Mat4f& mat, float4 b) {
  return make_float4(dot4(mat, 0, b.x, b.y, b.z, b.w), dot4(mat, 1, b.x, b.y, b.z, b.w),
                     dot4(mat, 2, b.x, b.y, b.z, b.w), dot4(mat, 3, b.x, b.y, b.z, b.w));
}

// "1d": every 4-group along the last axis, one float4 per thread.
__global__ void rotate_1d_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                 int64_t groups, Mat4f mat) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    out[g] = rotate4(mat, x[g]);
  }
}

// "2d": every 4x4 block; a row of the grid holds cols4 = C / 4 float4s.
__global__ void rotate_2d_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                 int64_t block_rows, int64_t cols4, Mat4f mat) {
  const int64_t n = block_rows * cols4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; b < n;
       b += stride) {
    const int64_t base = (b / cols4) * 4 * cols4 + b % cols4;
    // last axis first: each of the block's four rows
    const float4 t0 = rotate4(mat, x[base]);
    const float4 t1 = rotate4(mat, x[base + cols4]);
    const float4 t2 = rotate4(mat, x[base + 2 * cols4]);
    const float4 t3 = rotate4(mat, x[base + 3 * cols4]);
    // then down the rows, column by column
    float4 o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = make_float4(dot4(mat, k, t0.x, t1.x, t2.x, t3.x), dot4(mat, k, t0.y, t1.y, t2.y, t3.y),
                         dot4(mat, k, t0.z, t1.z, t2.z, t3.z), dot4(mat, k, t0.w, t1.w, t2.w, t3.w));
    }
    out[base] = o[0];
    out[base + cols4] = o[1];
    out[base + 2 * cols4] = o[2];
    out[base + 3 * cols4] = o[3];
  }
}

template <int kOrder>
__device__ __forceinline__ double dot4_f64(const double* m, const double* b) {
  if (kOrder == 0) {
    double acc = __fma_rn(m[0], b[0], 0.0);
    acc = __fma_rn(m[1], b[1], acc);
    acc = __fma_rn(m[2], b[2], acc);
    return __fma_rn(m[3], b[3], acc);
  }
  if (kOrder == 1) {
    return __dadd_rn(__dadd_rn(__dmul_rn(m[0], b[0]), __dmul_rn(m[2], b[2])),
                     __dadd_rn(__dmul_rn(m[1], b[1]), __dmul_rn(m[3], b[3])));
  }
  return __fma_rn(m[3], b[3],
                  __fma_rn(m[2], b[2], __dadd_rn(__dmul_rn(m[0], b[0]), __dmul_rn(m[1], b[1]))));
}

template <int kOrder>
__global__ void axis_f64_kernel(const double* __restrict__ x, double* __restrict__ out,
                                int64_t outer, int64_t len, int64_t inner, Mat4d mat) {
  const int64_t groups = len / 4;
  const int64_t n = outer * groups * inner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int64_t i = t % inner;
    const int64_t g = (t / inner) % groups;
    const int64_t o = t / (inner * groups);
    const int64_t base = (o * len + 4 * g) * inner + i;
    double b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = x[base + j * inner];
#pragma unroll
    for (int k = 0; k < 4; ++k) out[base + k * inner] = dot4_f64<kOrder>(mat.m + 4 * k, b);
  }
}

}  // namespace

extern "C" {

// (rows, cols) float32, cols % 4 == 0 (and rows % 4 == 0 when two_d), both
// pointers 16-byte aligned; m_host: 16 floats, row-major, read at launch.
int transform_f32(const float* x, float* out, int64_t rows, int64_t cols,
                  const float* m_host, int two_d, void* stream) {
  Mat4f mat;
  for (int i = 0; i < 16; ++i) mat.m[i] = m_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (two_d) {
    const int64_t n = (rows / 4) * (cols / 4);
    if (n > 0) rotate_2d_kernel<<<grid_for(n), kThreads, 0, s>>>(x4, o4, rows / 4, cols / 4, mat);
  } else {
    const int64_t n = rows * (cols / 4);
    if (n > 0) rotate_1d_kernel<<<grid_for(n), kThreads, 0, s>>>(x4, o4, n, mat);
  }
  return static_cast<int>(cudaGetLastError());
}

// A contiguous float64 array viewed as (outer, len, inner), len % 4 == 0;
// m_host: 16 doubles, row-major, read at launch; order: 0, 1 or 2 (above).
int transform_axis_f64(const double* x, double* out, int64_t outer, int64_t len,
                       int64_t inner, const double* m_host, int order, void* stream) {
  if (order < 0 || order > 2) return static_cast<int>(cudaErrorInvalidValue);
  Mat4d mat;
  for (int i = 0; i < 16; ++i) mat.m[i] = m_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = outer * (len / 4) * inner;
  if (n > 0) {
    const unsigned grid = grid_for(n);
    if (order == 0) {
      axis_f64_kernel<0><<<grid, kThreads, 0, s>>>(x, out, outer, len, inner, mat);
    } else if (order == 1) {
      axis_f64_kernel<1><<<grid, kThreads, 0, s>>>(x, out, outer, len, inner, mat);
    } else {
      axis_f64_kernel<2><<<grid, kThreads, 0, s>>>(x, out, outer, len, inner, mat);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
