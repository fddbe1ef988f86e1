// Per-block mean and max deviation for the fast tier, for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// fastmode_block_stats replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/fastmode/kernel.py (block_stats, _kernel): for each row
// of an (nb, bs) float32 block matrix, bs in {128, 256}, the mean sum/bs and
// max |x - mean|.  The TPU kernel writes both as (nb, 128) lane-broadcast
// columns; this one writes two (nb,) vectors.
//
// It is bound by device memory: it reads each element once (4 B) and writes
// 8 B per block.  One warp owns one block: each lane loads bs/128 float4s of
// 16 B (lane l holds elements 4l..4l+3, and 128+4l..128+4l+3 when bs = 256),
// so a warp's loads are 512 contiguous bytes.  The block stays in registers
// for the second pass, so it is read from memory once.  Eight warps (eight
// blocks) per thread block; no shared memory.
//
// Rounding, as written, so that the kernel equals its plain version
// (../ref.py) bit for bit:
//   * each lane sums its 4 or 8 values in order with __fadd_rn, then the
//     lanes combine by an xor-shuffle tree over offsets 16, 8, 4, 2, 1
//     (float addition commutes, so every lane ends with the same sum);
//   * mean = sum / bs, exact up to underflow since bs is a power of two;
//   * dev = max over |x - mean| (__fsub_rn, fabsf); the max propagates NaN,
//     as torch.amax does.
// Do not build with --use_fast_math.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // blocks of the coder per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int64_t kMaxGrid = 1 << 16;  // cap for grid-stride launches
constexpr unsigned kFull = 0xffffffffu;

// max that propagates NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int kVecs>  // float4s per lane: bs / 128
__global__ void block_stats_kernel(const float4* __restrict__ x, float* __restrict__ means,
                                   float* __restrict__ devs, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t b = warp; b < nb; b += warps) {
    const float4* row = x + b * (32 * kVecs);
    float4 v[kVecs];
#pragma unroll
    for (int c = 0; c < kVecs; ++c) v[c] = row[32 * c + lane];
    float s = v[0].x;
    s = __fadd_rn(s, v[0].y);
    s = __fadd_rn(s, v[0].z);
    s = __fadd_rn(s, v[0].w);
#pragma unroll
    for (int c = 1; c < kVecs; ++c) {
      s = __fadd_rn(s, v[c].x);
      s = __fadd_rn(s, v[c].y);
      s = __fadd_rn(s, v[c].z);
      s = __fadd_rn(s, v[c].w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    const float mean = __fdiv_rn(s, static_cast<float>(128 * kVecs));
    float d = fabsf(__fsub_rn(v[0].x, mean));
    d = nan_max(d, fabsf(__fsub_rn(v[0].y, mean)));
    d = nan_max(d, fabsf(__fsub_rn(v[0].z, mean)));
    d = nan_max(d, fabsf(__fsub_rn(v[0].w, mean)));
#pragma unroll
    for (int c = 1; c < kVecs; ++c) {
      d = nan_max(d, fabsf(__fsub_rn(v[c].x, mean)));
      d = nan_max(d, fabsf(__fsub_rn(v[c].y, mean)));
      d = nan_max(d, fabsf(__fsub_rn(v[c].z, mean)));
      d = nan_max(d, fabsf(__fsub_rn(v[c].w, mean)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d = nan_max(d, __shfl_xor_sync(kFull, d, off));
    if (lane == 0) {
      means[b] = mean;
      devs[b] = d;
    }
  }
}

}  // namespace

extern "C" {

// x: (nb, bs) float32, contiguous, 16-byte aligned; bs is 128 or 256.
// Returns cudaErrorInvalidValue for any other bs.
int fastmode_block_stats(const float* x, float* means, float* devs, int64_t nb, int bs,
                         void* stream) {
  if (bs != 128 && bs != 256) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    int64_t blocks = (nb + kWarps - 1) / kWarps;
    const unsigned grid = static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bs == 128) {
      block_stats_kernel<1><<<grid, kThreads, 0, s>>>(x4, means, devs, nb);
    } else {
      block_stats_kernel<2><<<grid, kThreads, 0, s>>>(x4, means, devs, nb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
