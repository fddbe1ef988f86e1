// Fused prequantize + Lorenzo kernels for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// They replace the JAX package's Pallas TPU kernels in
// src/repro/kernels/lorenzo/kernel.py:
//   lorenzo_encode_1d  <- encode_1d  (_encode1d_kernel)
//   lorenzo_encode_2d  <- encode_2d  (_encode2d_kernel)
//   lorenzo_decode_1d  <- decode_1d  (_decode1d_kernel)
//   lorenzo_decode_2d  <- decode_2d  (_decode2d_kernel)
// and compute the same bits (the contract is stated in ../ref.py).
//
// All four are bound by device memory bandwidth: a handful of integer ops
// per 4-byte element.  The TPU kernels carry the last row or column through
// VMEM scratch along a grid that runs in order.  Hopper blocks run in no
// order, so the design here needs no carry between blocks:
//   * encode: one thread per element.  Each thread re-reads its left, up and
//     up-left neighbours (L1/L2 hits) and recomputes their prequantized
//     values, so one pass reads x once from DRAM and writes codes and raw
//     diffs once: 12 B per element.
//   * decode_1d: a device-wide inclusive scan of each row, reduce-then-scan
//     over 4096-element tiles: tile sums, an exclusive scan of the sums per
//     row, then each tile rescans with its offset and writes the dequantized
//     float.  A (1, N) row with N in the tens of millions fills the card.
//     Input is read twice: 12 B per element against the 8 B minimum.
//   * decode_2d: the same row scan writing int32, then a column scan split
//     into 64-row segments (segment sums, a per-column scan of the sums, a
//     rescan that fuses the dequant).  Adjacent threads own adjacent
//     columns, so every access is coalesced.
//
// Bit identity with the JAX kernels rests on IEEE single arithmetic:
//   * 1/(2eb) and 2eb arrive as floats rounded from Python float64 on the
//     host; the device never computes a reciprocal.
//   * __fmul_rn is a single-rounding multiply that the compiler never
//     contracts into an FMA; __float2int_rn rounds half to even like
//     jnp.rint; __int2float_rn rounds to nearest like astype(float32).
//   * Integer sums wrap in two's complement like jnp.cumsum(dtype=int32).
//     Signed overflow is undefined in C++, so every sum is taken in uint32
//     and reinterpreted.
// Do not build with --use_fast_math.
//
// Each entry point launches on the given stream, allocates nothing (the
// caller passes outputs and scratch) and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kItems = 16;                  // elements per thread in a tile
constexpr int kTile = kThreads * kItems;    // elements per row-scan tile
constexpr int kSegRows = 64;                // rows per column-scan segment
constexpr int64_t kMaxGrid = 1 << 16;       // cap for grid-stride launches

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t prequant(float x, float inv_two_eb) {
  return static_cast<uint32_t>(__float2int_rn(__fmul_rn(x, inv_two_eb)));
}

__device__ __forceinline__ float dequant(uint32_t q, float two_eb) {
  return __fmul_rn(__int2float_rn(static_cast<int32_t>(q)), two_eb);
}

// codes = d + radius where |d| < radius else 0, with |INT32_MIN| == INT32_MIN
// as in jnp.abs / torch.abs on int32.
__device__ __forceinline__ int32_t code_of(uint32_t d, int32_t radius) {
  const int32_t ad = static_cast<int32_t>(static_cast<int32_t>(d) < 0 ? 0u - d : d);
  return ad < radius ? static_cast<int32_t>(d + static_cast<uint32_t>(radius)) : 0;
}

__global__ void encode_1d_kernel(const float* __restrict__ x,
                                 int32_t* __restrict__ codes,
                                 int32_t* __restrict__ draw, int64_t rows,
                                 int64_t cols, float inv_two_eb, int32_t radius) {
  const int64_t n = rows * cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t c = i % cols;
    const uint32_t q = prequant(x[i], inv_two_eb);
    const uint32_t left = c > 0 ? prequant(x[i - 1], inv_two_eb) : 0u;
    const uint32_t d = q - left;
    draw[i] = static_cast<int32_t>(d);
    codes[i] = code_of(d, radius);
  }
}

__global__ void encode_2d_kernel(const float* __restrict__ x,
                                 int32_t* __restrict__ codes,
                                 int32_t* __restrict__ draw, int64_t rows,
                                 int64_t cols, float inv_two_eb, int32_t radius) {
  const int64_t n = rows * cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t r = i / cols;
    const int64_t c = i - r * cols;
    const uint32_t q = prequant(x[i], inv_two_eb);
    const uint32_t left = c > 0 ? prequant(x[i - 1], inv_two_eb) : 0u;
    const uint32_t up = r > 0 ? prequant(x[i - cols], inv_two_eb) : 0u;
    const uint32_t upleft =
        (r > 0 && c > 0) ? prequant(x[i - cols - 1], inv_two_eb) : 0u;
    // (q - up) - (left - upleft): the column difference of the row difference
    const uint32_t d = (q - up) - (left - upleft);
    draw[i] = static_cast<int32_t>(d);
    codes[i] = code_of(d, radius);
  }
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive scan of one value per thread across the block (blockDim.x ==
// kThreads); *total receives the block's sum.  Every thread must call it.
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    w = warp_inclusive_scan(w);
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t prefix = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return prefix + inc - v;
}

// Pass 1 of the row scan: the wrapping sum of each (row, tile).
__global__ void tile_sum_kernel(const int32_t* __restrict__ d,
                                uint32_t* __restrict__ sums, int64_t cols,
                                int64_t tiles_per_row) {
  const int64_t b = blockIdx.x;
  const int64_t row = b / tiles_per_row;
  const int64_t start = (b - row * tiles_per_row) * kTile;
  const int32_t* src = d + row * cols + start;
  const int64_t n_here = imin(kTile, cols - start);
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = k * kThreads + threadIdx.x;
    if (j < n_here) acc += static_cast<uint32_t>(src[j]);
  }
  uint32_t total;
  block_exclusive_scan(acc, &total);
  if (threadIdx.x == 0) sums[b] = total;
}

// Pass 2 of the row scan: one block per row turns its tile sums into
// exclusive tile offsets, in place, with a running carry.
__global__ void tile_offsets_kernel(uint32_t* __restrict__ sums,
                                    int64_t tiles_per_row) {
  uint32_t* s = sums + static_cast<int64_t>(blockIdx.x) * tiles_per_row;
  uint32_t carry = 0;
  for (int64_t base = 0; base < tiles_per_row; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const uint32_t v = i < tiles_per_row ? s[i] : 0u;
    uint32_t total;
    const uint32_t excl = block_exclusive_scan(v, &total);
    if (i < tiles_per_row) s[i] = carry + excl;
    carry += total;
  }
}

// Shared-memory slot of tile element j: one pad word every 32 keeps both
// the coalesced phase and the thread-contiguous phase free of bank conflicts.
__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

// Pass 3 of the row scan: each block rescans one tile from its offset
// (nullptr: one tile per row, offset 0) and writes int32 sums or, with
// kDequant, the dequantized floats.
template <bool kDequant>
__global__ void scan_tile_kernel(const int32_t* __restrict__ d,
                                 void* __restrict__ out,
                                 const uint32_t* __restrict__ offsets,
                                 int64_t cols, int64_t tiles_per_row,
                                 float two_eb) {
  __shared__ uint32_t s[kTile + kTile / 32];
  const int64_t b = blockIdx.x;
  const int64_t row = b / tiles_per_row;
  const int64_t start = (b - row * tiles_per_row) * kTile;
  const int64_t base_index = row * cols + start;
  const int n_here = static_cast<int>(imin(kTile, cols - start));
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    s[skew(j)] = j < n_here ? static_cast<uint32_t>(d[base_index + j]) : 0u;
  }
  __syncthreads();
  const int j0 = threadIdx.x * kItems;
  uint32_t run[kItems];
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc += s[skew(j0 + k)];
    run[k] = acc;
  }
  uint32_t total;
  const uint32_t prefix =
      block_exclusive_scan(acc, &total) + (offsets != nullptr ? offsets[b] : 0u);
#pragma unroll
  for (int k = 0; k < kItems; ++k) s[skew(j0 + k)] = prefix + run[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < n_here) {
      const uint32_t q = s[skew(j)];
      if (kDequant) {
        static_cast<float*>(out)[base_index + j] = dequant(q, two_eb);
      } else {
        static_cast<int32_t*>(out)[base_index + j] = static_cast<int32_t>(q);
      }
    }
  }
}

// Column scan, pass 1: the wrapping sum of each (segment, column).
__global__ void seg_sum_kernel(const int32_t* __restrict__ q,
                               uint32_t* __restrict__ sums, int64_t rows,
                               int64_t cols, int64_t col_blocks) {
  const int64_t seg = blockIdx.x / col_blocks;
  const int64_t c = (blockIdx.x - seg * col_blocks) * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int64_t r1 = imin(rows, (seg + 1) * kSegRows);
  uint32_t acc = 0;
  for (int64_t r = seg * kSegRows; r < r1; ++r) acc += static_cast<uint32_t>(q[r * cols + c]);
  sums[seg * cols + c] = acc;
}

// Column scan, pass 2: per column, exclusive offsets of the segments.
__global__ void seg_offsets_kernel(uint32_t* __restrict__ sums, int64_t n_seg,
                                   int64_t cols) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= cols) return;
  uint32_t carry = 0;
  for (int64_t seg = 0; seg < n_seg; ++seg) {
    const uint32_t v = sums[seg * cols + c];
    sums[seg * cols + c] = carry;
    carry += v;
  }
}

// Column scan, pass 3: rescan each segment from its offset, fused dequant.
__global__ void col_scan_kernel(const int32_t* __restrict__ q,
                                const uint32_t* __restrict__ offsets,
                                float* __restrict__ out, int64_t rows,
                                int64_t cols, int64_t col_blocks, float two_eb) {
  const int64_t seg = blockIdx.x / col_blocks;
  const int64_t c = (blockIdx.x - seg * col_blocks) * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int64_t r1 = imin(rows, (seg + 1) * kSegRows);
  uint32_t acc = offsets[seg * cols + c];
  for (int64_t r = seg * kSegRows; r < r1; ++r) {
    acc += static_cast<uint32_t>(q[r * cols + c]);
    out[r * cols + c] = dequant(acc, two_eb);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

unsigned grid_stride_blocks(int64_t n) {
  return static_cast<unsigned>(imin(ceil_div(n, kThreads), kMaxGrid));
}

// Row scan of a (rows, cols) int32 matrix into `out` (int32, or float with
// kDequant), using rows * tiles_per_row words of `scratch` when a row spans
// more than one tile.
template <bool kDequant>
void row_scan(const int32_t* d, void* out, uint32_t* scratch, int64_t rows,
              int64_t cols, float two_eb, cudaStream_t stream) {
  const int64_t tiles = ceil_div(cols, kTile);
  const unsigned blocks = static_cast<unsigned>(rows * tiles);
  const uint32_t* offsets = nullptr;
  if (tiles > 1) {
    tile_sum_kernel<<<blocks, kThreads, 0, stream>>>(d, scratch, cols, tiles);
    tile_offsets_kernel<<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(scratch, tiles);
    offsets = scratch;
  }
  scan_tile_kernel<kDequant><<<blocks, kThreads, 0, stream>>>(d, out, offsets, cols,
                                                              tiles, two_eb);
}

}  // namespace

extern "C" {

// Words of uint32 scratch the decode entry points need for a (rows, cols)
// input; the caller allocates them.  The launch grids need
// rows * ceil(cols / 4096) and ceil(rows / 64) * ceil(cols / 256) below 2^31.
int64_t lorenzo_decode_scratch_words(int64_t rows, int64_t cols, int two_d) {
  int64_t words = rows * ceil_div(cols, kTile);
  if (two_d) words += rows * cols + ceil_div(rows, kSegRows) * cols;
  return words;
}

int lorenzo_encode_1d(const float* x, int32_t* codes, int32_t* draw, int64_t rows,
                      int64_t cols, float inv_two_eb, int radius, void* stream) {
  const int64_t n = rows * cols;
  if (n > 0) {
    encode_1d_kernel<<<grid_stride_blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, codes, draw, rows, cols,
                                                             inv_two_eb, radius);
  }
  return static_cast<int>(cudaGetLastError());
}

int lorenzo_encode_2d(const float* x, int32_t* codes, int32_t* draw, int64_t rows,
                      int64_t cols, float inv_two_eb, int radius, void* stream) {
  const int64_t n = rows * cols;
  if (n > 0) {
    encode_2d_kernel<<<grid_stride_blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, codes, draw, rows, cols,
                                                             inv_two_eb, radius);
  }
  return static_cast<int>(cudaGetLastError());
}

int lorenzo_decode_1d(const int32_t* d, float* out, uint32_t* scratch, int64_t rows,
                      int64_t cols, float two_eb, void* stream) {
  if (rows * cols > 0) {
    row_scan<true>(d, out, scratch, rows, cols, two_eb,
                   static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

int lorenzo_decode_2d(const int32_t* d, float* out, uint32_t* scratch, int64_t rows,
                      int64_t cols, float two_eb, void* stream) {
  if (rows * cols > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint32_t* tile_sums = scratch;
    int32_t* row_sums = reinterpret_cast<int32_t*>(scratch + rows * ceil_div(cols, kTile));
    uint32_t* seg_sums = reinterpret_cast<uint32_t*>(row_sums + rows * cols);
    row_scan<false>(d, row_sums, tile_sums, rows, cols, two_eb, s);
    const int64_t n_seg = ceil_div(rows, kSegRows);
    const int64_t col_blocks = ceil_div(cols, kThreads);
    const unsigned blocks = static_cast<unsigned>(n_seg * col_blocks);
    seg_sum_kernel<<<blocks, kThreads, 0, s>>>(row_sums, seg_sums, rows, cols, col_blocks);
    seg_offsets_kernel<<<static_cast<unsigned>(col_blocks), kThreads, 0, s>>>(seg_sums, n_seg,
                                                                          cols);
    col_scan_kernel<<<blocks, kThreads, 0, s>>>(row_sums, seg_sums, out, rows, cols,
                                                col_blocks, two_eb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
