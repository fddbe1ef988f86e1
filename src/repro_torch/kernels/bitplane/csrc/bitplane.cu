// The 32x32 bitplane transpose for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// bitplane_encode replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/bitplane/kernel.py (encode, _encode_kernel): for each
// group r of 32 uint32 values v[r, 0..31] it writes the 32 plane words
//   w[p, r] = sum_k ((v[r, k] >> p) & 1) << k,
// an (R, 32) -> (32, R) bit transpose.  bitplane_decode replaces decode
// (_decode_kernel), the inverse.  The TPU kernel shifts, masks and reduces a
// (512, 32) tile on the vector unit.
//
// It is bound by device memory: 4 bytes read and 4 written per value.  So
// the design keeps many bytes in flight and spends few instructions a value:
//   * One group per thread, transposed in registers: bit k of word p equals
//     bit p of word k, so encode and decode are the same 32x32 bit-matrix
//     transpose, five rounds of masked block swaps (16, 8, 4, 2, 1 bits) on
//     a statically indexed uint32_t[32], about 0.5 warp instructions a
//     value (a warp vote per bit would take 2).
//   * A warp works a tile of 32 consecutive groups (4 KB of values, one
//     128-byte run of each of the 32 planes) and walks tiles grid-stride;
//     the grid is as many 4-warp blocks as the card holds at once.
//   * Each warp double-buffers its tiles in shared memory with cp.async:
//     the next tile's copies are in flight while the current one is
//     transposed, and they take no registers.
//   * Value side (encode's input, decode's output): a tile is 4 KB of
//     contiguous memory, moved as 16-byte accesses, 512 contiguous bytes a
//     warp instruction.  A thread needs its group's 128-byte row, so the
//     rows are staged in shared memory with the 16-byte chunk j of row g at
//     slot j ^ (g & 7): the coalesced copies and the per-row 16-byte reads
//     both spread over all 32 banks.  An encode input that is not 16-byte
//     aligned (a view at a storage offset) takes the same kernel with
//     4-byte accesses (kVec false), chosen from the pointer; decode writes
//     an output its wrapper allocates, and its entry point refuses an
//     unaligned one.
//   * Plane side: lane l touches w[p, r0 + l] for p = 0..31, 32 independent
//     4-byte accesses, each a coalesced 128-byte warp access, for any R.
//   * Groups past R: copies zero-fill, stores are skipped.
//
// The entry points launch on the given stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;          // tiles per warp in shared memory
constexpr int kTileWords = 32 * 32;  // 32 groups of 32 values

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; valid false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// word k of row g of a staged value tile (16-byte chunk k/4 swizzled)
__device__ __forceinline__ int slot(int g, int k) {
  return g * 32 + ((((k >> 2) ^ g) & 7) << 2) + (k & 3);
}

// One round of the transpose: for every k with bit J clear, swap bits
// [J, 2J) of each 2J-bit field of a[k] with bits [0, J) of a[k + J].
template <int J, uint32_t M>
__device__ __forceinline__ void swap_round(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = ((i & ~(J - 1)) << 1) | (i & (J - 1));
    const uint32_t t = ((a[k] >> J) ^ a[k + J]) & M;
    a[k + J] ^= t;
    a[k] ^= t << J;
  }
}

// a[p] bit k <- a[k] bit p
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  swap_round<16, 0x0000FFFFu>(a);
  swap_round<8, 0x00FF00FFu>(a);
  swap_round<4, 0x0F0F0F0Fu>(a);
  swap_round<2, 0x33333333u>(a);
  swap_round<1, 0x55555555u>(a);
}

// Value tile t (groups 32t..32t+31 of v) into buf, rows swizzled.
template <bool kVec>
__device__ __forceinline__ void load_values(uint32_t* buf, const uint32_t* v, int64_t t, int64_t R,
                                            int lane) {
  const int64_t g0 = t * 32;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * 32 + lane;  // 16-byte chunk of the tile
      const int g = c >> 3;
      const bool ok = g0 + g < R;
      cp_async16(buf + slot(g, (c & 7) << 2), ok ? v + g0 * 32 + c * 4 : v, ok);
    }
  } else {
#pragma unroll
    for (int g = 0; g < 32; ++g) {
      const bool ok = g0 + g < R;
      cp_async4(buf + slot(g, lane), ok ? v + (g0 + g) * 32 + lane : v, ok);
    }
  }
}

// Plane tile t (w[p, 32t..32t+31] for every p) into buf[p][lane].
__device__ __forceinline__ void load_planes(uint32_t* buf, const uint32_t* w, int64_t t, int64_t R,
                                            int lane) {
  const int64_t r = t * 32 + lane;
  const bool ok = r < R;
#pragma unroll
  for (int p = 0; p < 32; ++p) cp_async4(buf + p * 32 + lane, ok ? w + p * R + r : w, ok);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ w, int64_t R) {
  __shared__ __align__(16) uint32_t ring[kWarps][kStages][kTileWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (R + 31) / 32;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t < tiles) load_values<kVec>(ring[warp][0], v, t, R, lane);
  cp_async_commit();
  for (int s = 0; t < tiles; t += step, s ^= 1) {
    if (t + step < tiles) load_values<kVec>(ring[warp][s ^ 1], v, t + step, R, lane);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncwarp();
    const uint32_t* buf = ring[warp][s];
    uint32_t a[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 q = *reinterpret_cast<const uint4*>(buf + slot(lane, 4 * j));
      a[4 * j] = q.x;
      a[4 * j + 1] = q.y;
      a[4 * j + 2] = q.z;
      a[4 * j + 3] = q.w;
    }
    __syncwarp();  // every lane has read stage s before it is refilled
    transpose32(a);
    const int64_t r = t * 32 + lane;
    if (r < R) {
#pragma unroll
      for (int p = 0; p < 32; ++p) w[p * R + r] = a[p];
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ w, uint32_t* __restrict__ v, int64_t R) {
  __shared__ __align__(16) uint32_t ring[kWarps][kStages][kTileWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (R + 31) / 32;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t < tiles) load_planes(ring[warp][0], w, t, R, lane);
  cp_async_commit();
  for (int s = 0; t < tiles; t += step, s ^= 1) {
    if (t + step < tiles) load_planes(ring[warp][s ^ 1], w, t + step, R, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies of tile t have landed
    uint32_t* buf = ring[warp][s];
    uint32_t a[32];
#pragma unroll
    for (int p = 0; p < 32; ++p) a[p] = buf[p * 32 + lane];
    __syncwarp();  // every lane has read its planes before the rows overwrite them
    transpose32(a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint4*>(buf + slot(lane, 4 * j)) =
          make_uint4(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]);
    }
    __syncwarp();
    const int64_t g0 = t * 32;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * 32 + lane;  // 16-byte chunk of the tile
      const int g = c >> 3;
      if (g0 + g < R) {
        *reinterpret_cast<uint4*>(v + g0 * 32 + c * 4) =
            *reinterpret_cast<const uint4*>(buf + slot(g, (c & 7) << 2));
      }
    }
    __syncwarp();  // every lane has read stage s before it is refilled
  }
  cp_async_wait<0>();
}

// Thread blocks for R groups: one tile of 32 groups per warp, at most as
// many blocks as the card holds at once.  The count is taken once per
// device and kernel (a race writes the same value twice).
template <auto Kernel>
unsigned grid_for(int64_t R) {
  static int64_t resident_of[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t resident = dev < 64 ? resident_of[dev] : 0;
  if (resident == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident_of[dev] = resident;
  }
  const int64_t needed = ((R + 31) / 32 + kWarps - 1) / kWarps;
  return static_cast<unsigned>(needed < resident ? needed : resident);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <auto Kernel>
void launch(const void* src, void* dst, int64_t R, void* stream) {
  Kernel<<<grid_for<Kernel>(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), R);
}

}  // namespace

// v: (R, 32) and w: (32, R) uint32, contiguous, 4-byte aligned.
extern "C" int bitplane_encode(const void* v, void* w, int64_t R, void* stream) {
  if (R > 0) {
    if (aligned16(v)) {
      launch<encode_kernel<true>>(v, w, R, stream);
    } else {
      launch<encode_kernel<false>>(v, w, R, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The same, with v 16-byte aligned; returns cudaErrorInvalidValue otherwise.
extern "C" int bitplane_decode(const void* w, void* v, int64_t R, void* stream) {
  if (!aligned16(v)) return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0) launch<decode_kernel>(w, v, R, stream);
  return static_cast<int>(cudaGetLastError());
}
