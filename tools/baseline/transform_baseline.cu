// The first port of the float32 transform kernels (one thread per 4x4
// block or 4-group, a 256-thread grid-stride launch), kept as it was (its
// float32 entry point only) as the yardstick that the current kernel
// (src/repro_torch/kernels/transform/csrc/transform.cu) is timed against in
// turns: chip_smoke.py's transform_kernels phase builds it beside the port's
// sources and times both at the main paths' and the checkpoint's shapes.  It
// is no part of the port and no path calls it.  Entry point: transform_f32
// (float32 in and out).
//
// Rounding: every output is ((m0*b0 + m1*b1) + m2*b2) + m3*b3 with
// __fmul_rn / __fadd_rn, last axis first, then the rows, as the current
// kernel computes it.  Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGrid = 1 << 16;  // cap for grid-stride launches

struct Mat4f {
  float m[16];  // row-major: m[4 * k + j] multiplies input j into output k
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

}  // extern "C"
