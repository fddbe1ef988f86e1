// The 32x32 bitplane transpose for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// bitplane_encode replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/bitplane/kernel.py (encode, _encode_kernel): for each
// group r of 32 uint32 values v[r, 0..31] it writes the 32 plane words
//   w[p, r] = sum_k ((v[r, k] >> p) & 1) << k,
// an (R, 32) -> (32, R) bit transpose.  bitplane_decode replaces decode
// (_decode_kernel), the inverse.  The TPU kernel shifts, masks and reduces a
// (512, 32) tile on the vector unit; here the transpose is a warp vote.
//
// It is bound by device memory: 4 bytes read and 4 written per value, and
// 32 votes per 32 values.  Design: a CTA of 1024 threads takes 32
// consecutive groups (4 KB):
//   * encode loads v[r0 + t/32, t%32] with thread t, one coalesced 4 KB
//     run.  Warp w then holds group r0+w, lane k value k, and
//     __ballot_sync over bit p of every lane is exactly w[p, r0+w]; lane p
//     keeps ballot p.  The (32 planes x 32 groups) words are staged in
//     shared memory padded to [32][33], so neither the column write nor the
//     row read has a bank conflict, and thread (p = t/32, j = t%32) stores
//     w[p, r0 + j]: one 128-byte run per plane.
//   * decode is the same in reverse: thread (p, j) loads w[p, r0 + j] into
//     shared memory, warp w's lane p takes word p of group r0+w, and the
//     ballot over bit k gives v[r0+w, k] for lane k, stored coalesced.
// The tail CTA guards groups past R (zeros in, nothing out).  A grid-stride
// loop covers any R with at most kMaxGrid CTAs.
//
// The entry points launch on the given stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 32;  // groups of 32 values per CTA
constexpr int kThreads = 32 * kGroups;
constexpr int64_t kMaxGrid = 1 << 16;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ w, int64_t R) {
  __shared__ uint32_t tile[32][33];  // [plane][group]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * kGroups; r0 < R;
       r0 += static_cast<int64_t>(gridDim.x) * kGroups) {
    const int64_t r = r0 + warp;
    const uint32_t val = r < R ? v[r * 32 + lane] : 0u;
    uint32_t mine = 0;
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const uint32_t word = __ballot_sync(kFull, (val >> p) & 1u);
      if (lane == p) mine = word;
    }
    tile[lane][warp] = mine;
    __syncthreads();
    if (r0 + lane < R) w[static_cast<int64_t>(warp) * R + r0 + lane] = tile[warp][lane];
    __syncthreads();  // the tile is rewritten by the next iteration
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ w, uint32_t* __restrict__ v, int64_t R) {
  __shared__ uint32_t tile[32][33];  // [plane][group]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * kGroups; r0 < R;
       r0 += static_cast<int64_t>(gridDim.x) * kGroups) {
    tile[warp][lane] = r0 + lane < R ? w[static_cast<int64_t>(warp) * R + r0 + lane] : 0u;
    __syncthreads();
    const uint32_t word = tile[lane][warp];  // plane `lane` of group r0+warp
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t val = __ballot_sync(kFull, (word >> k) & 1u);
      if (lane == k) mine = val;
    }
    const int64_t r = r0 + warp;
    if (r < R) v[r * 32 + lane] = mine;
    __syncthreads();
  }
}

unsigned grid_for(int64_t R) {
  const int64_t ctas = (R + kGroups - 1) / kGroups;
  return static_cast<unsigned>(ctas < kMaxGrid ? ctas : kMaxGrid);
}

}  // namespace

extern "C" int bitplane_encode(const void* v, void* w, int64_t R, void* stream) {
  if (R > 0) {
    encode_kernel<<<grid_for(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(v), static_cast<uint32_t*>(w), R);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitplane_decode(const void* w, void* v, int64_t R, void* stream) {
  if (R > 0) {
    decode_kernel<<<grid_for(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(w), static_cast<uint32_t*>(v), R);
  }
  return static_cast<int>(cudaGetLastError());
}
