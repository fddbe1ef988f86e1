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
// 8 B per block.  One warp reduces one block at a time: each lane loads
// bs/128 float4s of 16 B (lane l holds elements 4l..4l+3, and
// 128+4l..128+4l+3 when bs = 256), so a warp's loads are 512 contiguous
// bytes, and the block stays in registers for the second pass.  The grid
// is sized to the card (SMs x resident blocks, from the occupancy API) and
// each warp walks blocks warp, warp + warps, ...: it issues the streaming
// loads (__ldcs) of its next block before it reduces the current one, so
// every warp keeps loads in flight through its reductions, and there are
// no waves of short-lived warps that each pay a load latency alone.  Eight
// warps per thread block; no shared memory.
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

constexpr int kWarps = 8;  // warps per thread block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// max that propagates NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int kVecs>
__device__ __forceinline__ void load_block(const float4* __restrict__ x, int64_t b, int lane,
                                           float4 (&v)[kVecs]) {
  const float4* row = x + b * (32 * kVecs);
#pragma unroll
  for (int c = 0; c < kVecs; ++c) v[c] = __ldcs(row + 32 * c + lane);
}

template <int kVecs>  // float4s per lane: bs / 128
__global__ void __launch_bounds__(kThreads)
block_stats_kernel(const float4* __restrict__ x, float* __restrict__ means,
                   float* __restrict__ devs, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  if (warp >= nb) return;
  float4 v[kVecs], next[kVecs];
  load_block<kVecs>(x, warp, lane, v);
  for (int64_t b = warp; b < nb; b += warps) {
    if (b + warps < nb) load_block<kVecs>(x, b + warps, lane, next);  // in flight meanwhile
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
#pragma unroll
    for (int c = 0; c < kVecs; ++c) v[c] = next[c];
  }
}

// Thread blocks for nb blocks of the coder: one warp each, at most as many
// as the card holds at once.
// The count is taken once per device (a race writes the same value twice).
template <int kVecs>
unsigned grid_for(int64_t nb) {
  static int64_t resident_of[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t resident = dev < 64 ? resident_of[dev] : 0;
  if (resident == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_stats_kernel<kVecs>, kThreads, 0);
    resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident_of[dev] = resident;
  }
  const int64_t needed = (nb + kWarps - 1) / kWarps;
  return static_cast<unsigned>(needed < resident ? needed : resident);
}

}  // namespace

extern "C" {

// x: (nb, bs) float32, contiguous, 16-byte aligned; bs is 128 or 256.
// Returns cudaErrorInvalidValue for any other bs.
int fastmode_block_stats(const float* x, float* means, float* devs, int64_t nb, int bs,
                         void* stream) {
  if (bs != 128 && bs != 256) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bs == 128) {
      block_stats_kernel<1><<<grid_for<1>(nb), kThreads, 0, s>>>(x4, means, devs, nb);
    } else {
      block_stats_kernel<2><<<grid_for<2>(nb), kThreads, 0, s>>>(x4, means, devs, nb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
