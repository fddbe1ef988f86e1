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
//   * encode_1d and encode_2d (_encode1d_kernel, _encode2d_kernel).  Bound:
//     bytes, 12 B per element (x read once, codes and raw diffs written
//     once).  What the design does about it: one warp per span of a row
//     (1d: 256 elements, 8 a lane; 2d: 128 columns, 4 a lane, down a strip
//     of H <= 8 rows), found by one division per warp, none per element.
//     A lane issues all its loads before any arithmetic (a 2d warp has its
//     whole strip, up to 8 rows of 512 B, in flight), and each element is
//     prequantized once.  The left neighbour comes by shuffle from the
//     lane before (lane 0: lane 31's previous chunk, or its own load of
//     the element left of the span); 2d carries the previous row's q down
//     the strip in registers, the TPU kernel's VMEM row carry, and lane 0
//     the left column's q as well.  Every warp load or store covers 512
//     contiguous bytes (float4 in, int4 out) where all rows start 16-byte
//     aligned, else 128 bytes of 4-byte accesses in the same kernel.  Extra
//     reads: a 2d strip's first row reads the row above (1/H of x, mostly
//     from L2) and lane 0 one element a row (2d) or a span (1d).  H comes
//     from the host: the longest strip that still gives each SM 8 warps,
//     so short chunks spread over the card.  No cache hints: the caller
//     reads x again right after and decodes the raw diffs.
//   * decode_1d: an inclusive scan of each row in one launch, a chained
//     scan with decoupled look-back (Merrill & Garland, "Single-pass
//     Parallel Prefix Scan with Decoupled Look-back", 2016) over tiles of
//     256 x 16 elements.  Bound: bytes, 8 B per element (int32 in,
//     float32 out), each read and written once, with int4 loads
//     and float4 stores where every tile starts 16-byte aligned.  What the
//     design does about it: tile order comes from an atomic counter, so a
//     block waits only on tiles that already started; each tile publishes
//     {flag, value} in one 64-bit word (aggregate, then inclusive), and
//     warp 0 sums 32 predecessors per L2 round trip until it meets an
//     inclusive prefix or the row's start.  The status words of 32
//     consecutive tiles lie on 32 different cache lines.  What still
//     bounds it: the waits.  A tile writes only after every earlier tile of
//     its row has loaded and published, and under a saturated memory system
//     loads finish out of order, so blocks stay resident waiting and fewer
//     loads are in flight: built without its look-back (wrong sums, the
//     same bytes) the same kernel ran much faster on an H100 80GB HBM3 at
//     700 W (PERF.md), so the gap is the waits' price.  Two alternatives
//     ran no faster: a two-level look-back whose walk takes one round trip
//     at any distance (so the walk is not the bound), and persistent
//     blocks that copy their next tile while they look back.  At the chunked engine's (1, 2^20) the
//     whole grid is 256 tiles, so the one launch (after a memset of the
//     status words) replaces three dependent launches.  The reduce-then-scan
//     it replaced read the input twice (12 B per element).
//   * decode_2d: a tiled 2-D inclusive scan in three launches, none of
//     which waits on another block.  Tiles are 32 x 128 (at the chunked
//     engine's (291, 3600) that is 290 tiles, two per SM).  (1) Each tile
//     reads d once, asking the L2 to keep it, and writes its 32 row sums,
//     128 column sums and its total.  (2) One warp per line scans, in
//     place: each row's sums into rowleft (the row's sum over the tiles to
//     its left), each column's into colabove (over the tiles above), and
//     the tile totals along the shorter axis of the tile grid.  (3) Each
//     tile, in reverse order, reads d again (from L2 where it fits), scans
//     its rows across the warp and its columns down the block in
//     registers and shared memory, and adds the corner (everything above
//     and left of it: at most min(tile rows, tile columns) - 1 scanned
//     totals, summed by one warp) + the inclusive cumsum of rowleft down
//     its rows + that of colabove along its columns, then streams out.
//     Where that costs launch 3 at most half a tile more reads (short,
//     wide grids such as the chunk shapes), launch 3 sums its carries from
//     launch 1's sums itself and launch 2 is skipped: two launches.
//     Bound: bytes, 8 B per element; the design moves about 12 (4 read,
//     4 read again, 4 written) plus 4% for the sums, with no memset, no
//     status words and no spinning.  A single row or column is one 1-D
//     scan: it takes decode_1d's kernel on (1, rows * cols).
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

constexpr int kThreads = 256;               // threads per block, every decode kernel
constexpr int kWarps = kThreads / 32;

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

// Encodes.  A warp works on a span of one row: K chunks of W elements per
// lane, chunk k of lane l at span elements (32 k + l) W .. (32 k + l) W + W - 1,
// so each of the warp's loads and stores covers 32 W contiguous elements:
// 512 bytes with W = 4 (float4 in, int4 out), 128 with W = 1.  W = 4 needs
// every span to start 16-byte aligned; W = 1 takes any address.
constexpr int kEncWarps = 4;        // warps per block, both encodes
constexpr int kEnc2dCols = 32 * 4;  // encode_2d: columns per warp
constexpr int kEnc2dMaxStrip = 8;   // encode_2d: most rows a warp walks

// encode_1d's elements per warp: 8 a lane (two float4) with 16-byte
// accesses, 4 with 4-byte ones, where more, shorter warps ran faster on
// short rows.
__host__ __device__ constexpr int enc1d_span(bool vec) { return vec ? 256 : 128; }

// This lane's chunk at span offset j, zeros at and past n.
template <int W>
__device__ __forceinline__ void enc_load(const float* __restrict__ p, int j, int n, float (&v)[W]) {
  if constexpr (W == 4) {
    if (j + 4 <= n) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < W; ++e) v[e] = j + e < n ? p[j + e] : 0.0f;
}

template <int W>
__device__ __forceinline__ void enc_store(int32_t* __restrict__ p, int j, int n, const uint32_t (&v)[W]) {
  if constexpr (W == 4) {
    if (j + 4 <= n) {
      *reinterpret_cast<int4*>(p + j) = make_int4(static_cast<int32_t>(v[0]), static_cast<int32_t>(v[1]),
                                                  static_cast<int32_t>(v[2]), static_cast<int32_t>(v[3]));
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if (j + e < n) p[j + e] = static_cast<int32_t>(v[e]);
  }
}

// d = v minus the value left of it along the span, in the chunk layout.
// `before` is the value left of the span's first element (read on lane 0).
// The left neighbour of a chunk's first element is lane l - 1's last of the
// same chunk, or for lane 0 lane 31's last of the chunk before.
template <int K, int W>
__device__ __forceinline__ void span_left_diff(const uint32_t (&v)[K][W], uint32_t before,
                                               uint32_t (&d)[K][W]) {
  const bool lane0 = (threadIdx.x & 31) == 0;
  uint32_t wrap = before;  // lane 0's left neighbour
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t from_lane = __shfl_up_sync(0xffffffffu, v[k][W - 1], 1);
    d[k][0] = v[k][0] - (lane0 ? wrap : from_lane);
#pragma unroll
    for (int e = 1; e < W; ++e) d[k][e] = v[k][e] - v[k][e - 1];
    if (k + 1 < K) wrap = __shfl_sync(0xffffffffu, v[k][W - 1], 31);
  }
}

// Raw diffs and their codes, the span's first n elements.
template <int K, int W>
__device__ __forceinline__ void span_store(int32_t* __restrict__ codes, int32_t* __restrict__ draw, int n,
                                           const uint32_t (&d)[K][W], int32_t radius) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t c[W];
#pragma unroll
    for (int e = 0; e < W; ++e) c[e] = static_cast<uint32_t>(code_of(d[k][e], radius));
    enc_store<W>(draw, (32 * k + lane) * W, n, d[k]);
    enc_store<W>(codes, (32 * k + lane) * W, n, c);
  }
}

// encode_1d: one warp per span of enc1d_span elements of one row, found by
// one division per warp.  Each element is loaded and prequantized once; lane
// 0 also reads the one element left of the span.
template <bool kVec>
__global__ void __launch_bounds__(32 * kEncWarps)
encode_1d_kernel(const float* __restrict__ x, int32_t* __restrict__ codes, int32_t* __restrict__ draw,
                 int64_t cols, int64_t spans_per_row, int64_t spans, float inv_two_eb, int32_t radius) {
  constexpr int kSpan = enc1d_span(kVec), W = kVec ? 4 : 1, K = kSpan / 32 / W;
  const int lane = threadIdx.x & 31;
  const int64_t span = static_cast<int64_t>(blockIdx.x) * kEncWarps + (threadIdx.x >> 5);
  if (span >= spans) return;  // the whole warp
  const int64_t row = span / spans_per_row;
  const int64_t c0 = (span - row * spans_per_row) * kSpan;
  const int64_t base = row * cols + c0;
  const int n = static_cast<int>(imin(kSpan, cols - c0));
  float xv[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k) enc_load<W>(x + base, (32 * k + lane) * W, n, xv[k]);
  const float xb = (lane == 0 && c0 > 0) ? x[base - 1] : 0.0f;
  uint32_t q[K][W], d[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < W; ++e) q[k][e] = prequant(xv[k][e], inv_two_eb);
  }
  span_left_diff(q, prequant(xb, inv_two_eb), d);
  span_store(codes + base, draw + base, n, d, radius);
}

// encode_2d, d = (q - up) - (left - upleft) = rd(c) - rd(c - 1) with
// rd = q - up: one warp per strip of H rows by kEnc2dCols columns, found by
// one division per warp.  The warp loads its strip, the row above it and
// (lane 0) the column left of it at once, then walks down the strip keeping
// the previous row's q in registers (the TPU kernel's VMEM row carry).
// Along a row, rd(c - 1) comes by span_left_diff; lane 0 carries the left
// column's q down the strip as well.
template <bool kVec, int H>
__global__ void __launch_bounds__(32 * kEncWarps)
encode_2d_kernel(const float* __restrict__ x, int32_t* __restrict__ codes, int32_t* __restrict__ draw,
                 int64_t rows, int64_t cols, int64_t segs, int64_t units, float inv_two_eb, int32_t radius) {
  constexpr int W = kVec ? 4 : 1, K = 4 / W;
  const int lane = threadIdx.x & 31;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kEncWarps + (threadIdx.x >> 5);
  if (unit >= units) return;  // the whole warp
  const int64_t strip = unit / segs;
  const int64_t r0 = strip * H, c0 = (unit - strip * segs) * kEnc2dCols;
  const int64_t base = r0 * cols + c0;
  const int n = static_cast<int>(imin(kEnc2dCols, cols - c0));
  const int h = static_cast<int>(imin(H, rows - r0));
  float xv[H][K][W], xa[K][W], xl[H + 1];
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) enc_load<W>(x + base + i * cols, (32 * k + lane) * W, i < h ? n : 0, xv[i][k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) enc_load<W>(x + (r0 > 0 ? base - cols : base), (32 * k + lane) * W, r0 > 0 ? n : 0, xa[k]);
  // xl[i]: column c0 - 1 of row r0 - 1 + i
#pragma unroll
  for (int i = 0; i <= H; ++i) {
    xl[i] = (lane == 0 && c0 > 0 && r0 + i > 0 && i <= h) ? x[base + (i - 1) * cols - 1] : 0.0f;
  }
  uint32_t up[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < W; ++e) up[k][e] = prequant(xa[k][e], inv_two_eb);
  }
  uint32_t up_left = prequant(xl[0], inv_two_eb);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (i >= h) break;  // the whole warp
    uint32_t q[K][W], rd[K][W], d[K][W];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        q[k][e] = prequant(xv[i][k][e], inv_two_eb);
        rd[k][e] = q[k][e] - up[k][e];
      }
    }
    const uint32_t q_left = prequant(xl[i + 1], inv_two_eb);
    span_left_diff(rd, q_left - up_left, d);
    span_store(codes + base + i * cols, draw + base + i * cols, n, d, radius);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < W; ++e) up[k][e] = q[k][e];
    }
    up_left = q_left;
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

// Shared-memory slot of tile element j: one pad word every 32 keeps both
// the coalesced phase and the thread-contiguous phase free of bank conflicts.
__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

// decode_1d: one launch, a chained scan with decoupled look-back (Merrill &
// Garland 2016).  A block takes the next tile from a global counter, so it
// only ever waits on tiles that already started; it publishes its tile's
// aggregate, looks back over its predecessors 32 at a time until one holds
// an inclusive prefix, publishes its own inclusive prefix, and writes its
// tile once.  Tiles never span rows: a row's first tile publishes its
// inclusive value at once and look-back stops at the row's start.
constexpr uint32_t kFlagAggregate = 1u, kFlagInclusive = 2u;
constexpr int kLbItems = 16;  // elements per thread (a multiple of 4; 32 ran no faster)
constexpr int kLbTile = kThreads * kLbItems;  // elements per tile

// Tile t's status word: 32 interleaved runs of `stride` words (a multiple of
// 16, so each run starts on its own 128-byte line), so the 32 predecessors a
// look-back step reads lie on 32 different lines, which the L2 serves in
// parallel; every walking warp reads the same recent tiles, and on one or
// two lines their requests would queue.
__device__ __forceinline__ int64_t status_slot(int64_t t, int64_t stride) {
  return (t & 31) * stride + (t >> 5);
}

// Flag and value in one 64-bit word: one store publishes both, one load
// reads both, so no fence orders them.
__device__ __forceinline__ void publish(unsigned long long* status, int64_t slot, uint32_t flag,
                                        uint32_t value) {
  *reinterpret_cast<volatile unsigned long long*>(status + slot) =
      (static_cast<unsigned long long>(flag) << 32) | value;
}

// Warp 0 of the block: the exclusive prefix of tile `tile` within its row,
// whose first tile is `row_first`.  Publishes the tile's inclusive prefix.
__device__ uint32_t look_back(unsigned long long* status, int64_t stride, int64_t tile,
                              int64_t row_first, uint32_t aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == row_first) {
    if (lane == 0) publish(status, status_slot(tile, stride), kFlagInclusive, aggregate);
    return 0u;
  }
  if (lane == 0) publish(status, status_slot(tile, stride), kFlagAggregate, aggregate);
  uint32_t exclusive = 0;
  for (int64_t base = tile - 1;; base -= 32) {
    const int64_t p = base - lane;  // lane l: the (l+1)-th nearest predecessor
    uint32_t flag = kFlagInclusive, value = 0u;  // before the row's start: nothing to add
    if (p >= row_first) {
      const volatile unsigned long long* w = status + status_slot(p, stride);
      unsigned long long v;
      do {  // until the predecessor has published
        v = *w;
        flag = static_cast<uint32_t>(v >> 32);
      } while (flag == 0u);
      value = static_cast<uint32_t>(v);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, flag == kFlagInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;  // the nearest inclusive predecessor
    uint32_t v = lane <= stop ? value : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    exclusive += v;
    if (incl) break;
  }
  if (lane == 0) publish(status, status_slot(tile, stride), kFlagInclusive, exclusive + aggregate);
  return exclusive;
}

// Loads this thread's share of a tile, kLbItems values, in the coalesced
// order: kVec (every tile starts 16-byte aligned: rows == 1 or cols % 4 == 0,
// and d 16-byte aligned) as int4 at elements (k * kThreads + tid) * 4 + e,
// otherwise element k * kThreads + tid; zeros past the tile's end.
template <bool kVec>
__device__ __forceinline__ void lb_load(const int32_t* __restrict__ src, int n_here, uint32_t* v) {
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kLbItems / 4; ++k) {
      const int j = (k * kThreads + threadIdx.x) * 4;
      int4 w = make_int4(0, 0, 0, 0);
      if (j + 4 <= n_here) {
        w = *reinterpret_cast<const int4*>(src + j);
      } else if (j < n_here) {
        w.x = src[j];
        if (j + 1 < n_here) w.y = src[j + 1];
        if (j + 2 < n_here) w.z = src[j + 2];
      }
      v[4 * k] = static_cast<uint32_t>(w.x);
      v[4 * k + 1] = static_cast<uint32_t>(w.y);
      v[4 * k + 2] = static_cast<uint32_t>(w.z);
      v[4 * k + 3] = static_cast<uint32_t>(w.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLbItems; ++k) {
      const int j = k * kThreads + threadIdx.x;
      v[k] = j < n_here ? static_cast<uint32_t>(src[j]) : 0u;
    }
  }
}

// The shared-memory slot of value k of lb_load's order.
template <bool kVec>
__device__ __forceinline__ int lb_slot(int k) {
  return kVec ? skew((k / 4 * kThreads + threadIdx.x) * 4 + k % 4) : skew(k * kThreads + threadIdx.x);
}

// One tile per block, taken from the counter: a block only ever waits on
// tiles that already started, so the scan cannot deadlock.  At most 40
// registers: six blocks per SM keep loads in flight while others look back.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
decode_1d_lookback_kernel(const int32_t* __restrict__ d, float* __restrict__ out,
                          unsigned* __restrict__ counter, unsigned long long* __restrict__ status,
                          int64_t stride, int64_t cols, int64_t tiles_per_row, float two_eb) {
  __shared__ uint32_t s[kLbTile + kLbTile / 32];
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t row = tile / tiles_per_row;
  const int64_t start = (tile - row * tiles_per_row) * kLbTile;
  const int64_t base_index = row * cols + start;
  const int n_here = static_cast<int>(imin(kLbTile, cols - start));
  {
    uint32_t v[kLbItems];
    lb_load<kVec>(d + base_index, n_here, v);
#pragma unroll
    for (int k = 0; k < kLbItems; ++k) s[lb_slot<kVec>(k)] = v[k];
  }
  __syncthreads();
  const int j0 = threadIdx.x * kLbItems;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kLbItems; ++k) acc += s[skew(j0 + k)];
  uint32_t total;
  const uint32_t within = block_exclusive_scan(acc, &total);
  if (threadIdx.x < 32) {
    const uint32_t ex = look_back(status, stride, tile, row * tiles_per_row, total);
    if (threadIdx.x == 0) s_prefix = ex;
  }
  __syncthreads();
  // this thread's values again, summed from its prefix in place (holding
  // them in registers through the scan would cost the occupancy)
  acc = s_prefix + within;
#pragma unroll
  for (int k = 0; k < kLbItems; ++k) {
    acc += s[skew(j0 + k)];
    s[skew(j0 + k)] = acc;
  }
  __syncthreads();
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kLbItems / 4; ++k) {
      const int j = (k * kThreads + threadIdx.x) * 4;
      const float4 v = make_float4(dequant(s[skew(j)], two_eb), dequant(s[skew(j + 1)], two_eb),
                                   dequant(s[skew(j + 2)], two_eb), dequant(s[skew(j + 3)], two_eb));
      if (j + 4 <= n_here) {
        *reinterpret_cast<float4*>(out + base_index + j) = v;
      } else if (j < n_here) {
        out[base_index + j] = v.x;
        if (j + 1 < n_here) out[base_index + j + 1] = v.y;
        if (j + 2 < n_here) out[base_index + j + 2] = v.z;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLbItems; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < n_here) out[base_index + j] = dequant(s[skew(j)], two_eb);
    }
  }
}

// decode_2d.  A tile is kT2Rows x kT2Cols: warp w holds rows 4w..4w+3 of
// it and lane l columns 4l..4l+3, so each row is one warp's 512 contiguous
// bytes.
constexpr int kT2Rows = 32;
constexpr int kT2Cols = 128;
constexpr int kT2RowsPerWarp = kT2Rows / kWarps;
static_assert(kT2Cols == 4 * 32 && kT2RowsPerWarp * kWarps == kT2Rows, "tile layout");

// Where launch 1 reads d: the L2 keeps these lines over others, so that
// launch 3 reads them again from L2 where d fits.
__device__ __forceinline__ int4 load_keep(const int32_t* p) {
  uint64_t policy;
  int4 w;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("ld.global.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
               : "l"(p), "l"(policy));
  return w;
}

// This thread's 4 x 4 values of tile (r0, c0); zeros outside the matrix.
// kVec: cols % 4 == 0 and d 16-byte aligned, so a row's 4 values are one
// int4.  kLast: the last read of d (streaming), else kept in L2.
template <bool kVec, bool kLast>
__device__ __forceinline__ void tile2_load(const int32_t* __restrict__ d, int64_t rows, int64_t cols,
                                           int64_t r0, int64_t c0,
                                           uint32_t (&v)[kT2RowsPerWarp][4]) {
  const int64_t c = c0 + 4 * (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < kT2RowsPerWarp; ++k) {
    const int64_t r = r0 + (threadIdx.x >> 5) * kT2RowsPerWarp + k;
    const int32_t* src = d + r * cols + c;
    if (kVec) {
      int4 w = make_int4(0, 0, 0, 0);
      if (r < rows && c < cols) w = kLast ? __ldcs(reinterpret_cast<const int4*>(src)) : load_keep(src);
      v[k][0] = static_cast<uint32_t>(w.x);
      v[k][1] = static_cast<uint32_t>(w.y);
      v[k][2] = static_cast<uint32_t>(w.z);
      v[k][3] = static_cast<uint32_t>(w.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[k][e] = (r < rows && c + e < cols) ? static_cast<uint32_t>(src[e]) : 0u;
    }
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Launch 1: each tile's row sums (row_sums[r * tiles_c + tj]), column sums
// (col_sums[c * tiles_r + ti]) and total (totals[ti * tiles_c + tj]).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tile2_sums_kernel(const int32_t* __restrict__ d, uint32_t* __restrict__ row_sums,
                  uint32_t* __restrict__ col_sums, uint32_t* __restrict__ totals, int64_t rows,
                  int64_t cols, int64_t tiles_r, int64_t tiles_c) {
  __shared__ uint4 s_col[kWarps][32];
  __shared__ uint32_t s_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t ti = blockIdx.x / tiles_c, tj = blockIdx.x - ti * tiles_c;
  const int64_t r0 = ti * kT2Rows, c0 = tj * kT2Cols;
  uint32_t v[kT2RowsPerWarp][4];
  tile2_load<kVec, false>(d, rows, cols, r0, c0, v);
  uint32_t tot = 0, col[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kT2RowsPerWarp; ++k) {
    const uint32_t rs = warp_sum(v[k][0] + v[k][1] + v[k][2] + v[k][3]);
    const int64_t r = r0 + warp * kT2RowsPerWarp + k;
    if (lane == 0 && r < rows) row_sums[r * tiles_c + tj] = rs;
    tot += rs;
#pragma unroll
    for (int e = 0; e < 4; ++e) col[e] += v[k][e];
  }
  s_col[warp][lane] = make_uint4(col[0], col[1], col[2], col[3]);
  if (lane == 0) s_tot[warp] = tot;
  __syncthreads();
  if (threadIdx.x < kT2Cols) {
    const int64_t c = c0 + threadIdx.x;
    const uint32_t* sc = reinterpret_cast<const uint32_t*>(s_col);
    uint32_t cs = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cs += sc[w * kT2Cols + threadIdx.x];
    if (c < cols) col_sums[c * tiles_r + ti] = cs;
  }
  if (threadIdx.x == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_tot[w];
    totals[blockIdx.x] = t;
  }
}

// Exclusive scan, in place, of p[0], p[stride], ..., p[(n - 1) * stride] by
// one warp, 32 words a step, the next step's words loaded before this
// step's scan.
__device__ void warp_exclusive_scan_line(uint32_t* p, int64_t n, int64_t stride) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = 0;
  uint32_t v = lane < n ? p[lane * stride] : 0u;
  for (int64_t base = 0; base < n; base += 32) {
    const int64_t i = base + lane, next = i + 32;
    const uint32_t v_next = next < n ? p[next * stride] : 0u;
    const uint32_t inc = warp_inclusive_scan(v);
    if (i < n) p[i * stride] = carry + inc - v;
    carry += __shfl_sync(0xffffffffu, inc, 31);
    v = v_next;
  }
}

// Where the corners come from.  Corner (I, J), the sum of every tile above
// and left of tile (I, J), is a 2-D exclusive scan of the tile totals.
// Launch 2 scans the totals along the shorter grid axis' lines (along each
// tile row when tiles_r <= tiles_c), and launch 3 sums the at most
// min(tiles_r, tiles_c) - 1 scanned totals above (or left of) its tile.
__host__ __device__ __forceinline__ bool corner_by_rows(int64_t tiles_r, int64_t tiles_c) {
  return tiles_r <= tiles_c;
}

// Launch 2, in place, one warp per line: each row's row sums become
// rowleft (the row's sum over the tiles to its left), each column's column
// sums colabove (the column over the tiles above), and the tile totals are
// scanned along the lines corner_by_rows picks.  Row lines exist when
// tiles_c > 1, column lines when tiles_r > 1, total lines when both: a
// first tile's carry is 0 and launch 3 does not read it.
__global__ void __launch_bounds__(kThreads)
tile2_carries_kernel(uint32_t* __restrict__ row_sums, uint32_t* __restrict__ col_sums,
                     uint32_t* __restrict__ totals, int64_t row_lines, int64_t col_lines,
                     int64_t total_lines, int64_t tiles_r, int64_t tiles_c) {
  int64_t line = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (line < total_lines) {
    if (corner_by_rows(tiles_r, tiles_c)) {
      warp_exclusive_scan_line(totals + line * tiles_c, tiles_c, 1);
    } else {
      warp_exclusive_scan_line(totals + line, tiles_r, tiles_c);
    }
    return;
  }
  line -= total_lines;
  if (line < row_lines) {
    warp_exclusive_scan_line(row_sums + line * tiles_c, tiles_c, 1);
  } else if (line - row_lines < col_lines) {
    warp_exclusive_scan_line(col_sums + (line - row_lines) * tiles_r, tiles_r, 1);
  }
}

// Whether launch 3 sums its carries from launch 1's sums itself, so that
// launch 2 is not needed: where that reads at most half a tile's 4096
// words more per tile on average (rowleft: 32 rows x tj sums, colabove:
// 128 columns x ti sums, corner: ti x tj totals), as on short, wide grids
// like the chunked engine's (291, 3600).  Elsewhere launch 2 scans them.
__host__ __device__ __forceinline__ bool direct_carries(int64_t tiles_r, int64_t tiles_c) {
  return 16 * tiles_c + 64 * tiles_r + tiles_r * tiles_c / 4 <= kT2Rows * kT2Cols / 2;
}

// p[0] + p[stride] + ... + p[(n - 1) * stride], by one thread.
__device__ __forceinline__ uint32_t sum_line(const uint32_t* __restrict__ p, int64_t n, int64_t stride) {
  uint32_t acc = 0;
#pragma unroll 8
  for (int64_t i = 0; i < n; ++i) acc += p[i * stride];
  return acc;
}

// Launch 3: each tile's 2-D inclusive scan from d, plus its carries,
// dequantized and stored.  Before the block's one barrier, warp 0 finds its
// rows' rowleft, warps 1-4 its columns' colabove and warp 5 its corner:
// read from launch 2's scans, or (kDirect) summed from launch 1's sums.
// Tiles run in reverse order of launch 1, so the lines launch 1 read last
// are read again first, before the L2 drops them; the output streams past
// the L2.
template <bool kVec, bool kDirect>
__global__ void __launch_bounds__(kThreads)
tile2_scan_kernel(const int32_t* __restrict__ d, float* __restrict__ out,
                  const uint32_t* __restrict__ row_sums, const uint32_t* __restrict__ col_sums,
                  const uint32_t* __restrict__ totals, int64_t rows, int64_t cols, int64_t tiles_r,
                  int64_t tiles_c, float two_eb) {
  __shared__ uint4 s_col[kWarps][32];  // column sums of each warp's 4 rows
  __shared__ uint32_t s_row_off[kT2Rows];
  __shared__ __align__(16) uint32_t s_col_above[kT2Cols];  // read as uint4
  __shared__ uint32_t s_corner;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = gridDim.x - 1 - static_cast<int64_t>(blockIdx.x);
  const int64_t ti = tile / tiles_c, tj = tile - ti * tiles_c;
  const int64_t r0 = ti * kT2Rows, c0 = tj * kT2Cols;
  uint32_t v[kT2RowsPerWarp][4];
  tile2_load<kVec, true>(d, rows, cols, r0, c0, v);
  if (warp == 0) {
    // row r0 + lane: the sum of rows r0..r0+lane left of the tile
    const int64_t r = r0 + lane;
    uint32_t left = 0;
    if (tj > 0 && r < rows) left = kDirect ? sum_line(row_sums + r * tiles_c, tj, 1) : row_sums[r * tiles_c + tj];
    s_row_off[lane] = warp_inclusive_scan(left);
  } else if (warp <= kT2Cols / 32) {
    // column c: its sum above the tile
    const int64_t c = c0 + 32 * (warp - 1) + lane;
    uint32_t above = 0;
    if (ti > 0 && c < cols) above = kDirect ? sum_line(col_sums + c * tiles_r, ti, 1) : col_sums[c * tiles_r + ti];
    s_col_above[32 * (warp - 1) + lane] = above;
  } else if (warp == kT2Cols / 32 + 1) {
    // the sum of every tile above and left of this one
    uint32_t corner = 0;
    if (ti > 0 && tj > 0) {
      if (kDirect) {
        for (int64_t k = lane; k < ti * tj; k += 32) corner += totals[(k / tj) * tiles_c + k % tj];
      } else {
        const bool by_rows = corner_by_rows(tiles_r, tiles_c);
        const int64_t n = by_rows ? ti : tj, stride = by_rows ? tiles_c : 1;
        const uint32_t* line = totals + (by_rows ? tj : ti * tiles_c);
        for (int64_t k = lane; k < n; k += 32) corner += line[k * stride];
      }
      corner = warp_sum(corner);
    }
    if (lane == 0) s_corner = corner;
  }
  // each row across the warp, then down this thread's rows
#pragma unroll
  for (int k = 0; k < kT2RowsPerWarp; ++k) {
    v[k][1] += v[k][0];
    v[k][2] += v[k][1];
    v[k][3] += v[k][2];
    const uint32_t pre = warp_inclusive_scan(v[k][3]) - v[k][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[k][e] += pre + (k > 0 ? v[k - 1][e] : 0u);
  }
  s_col[warp][lane] = make_uint4(v[kT2RowsPerWarp - 1][0], v[kT2RowsPerWarp - 1][1],
                                 v[kT2RowsPerWarp - 1][2], v[kT2RowsPerWarp - 1][3]);
  __syncthreads();
  // columns c0+4l..c0+4l+3: the sum above the tile of columns c0..c (every
  // warp scans the 128 values itself), plus the rows of earlier warps
  uint32_t off[4];
  const uint4 above = reinterpret_cast<const uint4*>(s_col_above)[lane];
  off[0] = above.x;
  off[1] = off[0] + above.y;
  off[2] = off[1] + above.z;
  off[3] = off[2] + above.w;
  const uint32_t pre = warp_inclusive_scan(off[3]) - off[3] + s_corner;
#pragma unroll
  for (int e = 0; e < 4; ++e) off[e] += pre;
  for (int w = 0; w < warp; ++w) {
    const uint4 t = s_col[w][lane];
    off[0] += t.x;
    off[1] += t.y;
    off[2] += t.z;
    off[3] += t.w;
  }
  const int64_t c = c0 + 4 * lane;
#pragma unroll
  for (int k = 0; k < kT2RowsPerWarp; ++k) {
    const int rl = warp * kT2RowsPerWarp + k;
    const int64_t r = r0 + rl;
    if (r >= rows) break;
    const uint32_t ro = s_row_off[rl];
    const float4 f = make_float4(dequant(v[k][0] + off[0] + ro, two_eb), dequant(v[k][1] + off[1] + ro, two_eb),
                                 dequant(v[k][2] + off[2] + ro, two_eb), dequant(v[k][3] + off[3] + ro, two_eb));
    float* dst = out + r * cols + c;
    if (kVec) {
      if (c < cols) __stcs(reinterpret_cast<float4*>(dst), f);
    } else {
      if (c < cols) __stcs(dst, f.x);
      if (c + 1 < cols) __stcs(dst + 1, f.y);
      if (c + 2 < cols) __stcs(dst + 2, f.z);
      if (c + 3 < cols) __stcs(dst + 3, f.w);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Words per interleaved run of decode_1d's status array (status_slot).
int64_t status_stride(int64_t n_tiles) { return ceil_div(ceil_div(n_tiles, 32), 16) * 16; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rows per encode_2d strip: the longest strip, at most kEnc2dMaxStrip, that
// still gives each SM 8 warps.  Longer strips re-read fewer rows above
// (1/H of x); a short chunk takes short strips, so that it spreads over
// the card rather than running as a few long ones.
int enc2d_strip_rows(int64_t rows, int64_t segs) {
  int dev = 0, sms = 132;  // a failed query is returned by cudaGetLastError
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int h = kEnc2dMaxStrip;
  while (h > 1 && ceil_div(rows, h) * segs < 8 * static_cast<int64_t>(sms)) h /= 2;
  return h;
}

template <bool kVec>
void enc2d_launch(int h, const float* x, int32_t* codes, int32_t* draw, int64_t rows, int64_t cols,
                  int64_t segs, float inv_two_eb, int32_t radius, cudaStream_t s) {
  const int64_t units = ceil_div(rows, h) * segs;
  const unsigned blocks = static_cast<unsigned>(ceil_div(units, kEncWarps));
  constexpr int threads = 32 * kEncWarps;
  switch (h) {
    case 8:
      encode_2d_kernel<kVec, 8><<<blocks, threads, 0, s>>>(x, codes, draw, rows, cols, segs, units, inv_two_eb, radius);
      break;
    case 4:
      encode_2d_kernel<kVec, 4><<<blocks, threads, 0, s>>>(x, codes, draw, rows, cols, segs, units, inv_two_eb, radius);
      break;
    case 2:
      encode_2d_kernel<kVec, 2><<<blocks, threads, 0, s>>>(x, codes, draw, rows, cols, segs, units, inv_two_eb, radius);
      break;
    default:
      encode_2d_kernel<kVec, 1><<<blocks, threads, 0, s>>>(x, codes, draw, rows, cols, segs, units, inv_two_eb, radius);
  }
}

// decode_2d's launches for rows, cols > 1: sums, then carries unless
// launch 3 sums them itself, then the rescan.
template <bool kVec>
void tile2_launch(const int32_t* d, float* out, uint32_t* row_sums, uint32_t* col_sums,
                  uint32_t* totals, int64_t rows, int64_t cols, float two_eb, cudaStream_t s) {
  const int64_t tiles_r = ceil_div(rows, kT2Rows), tiles_c = ceil_div(cols, kT2Cols);
  const unsigned tiles = static_cast<unsigned>(tiles_r * tiles_c);
  tile2_sums_kernel<kVec><<<tiles, kThreads, 0, s>>>(d, row_sums, col_sums, totals, rows, cols,
                                                     tiles_r, tiles_c);
  if (direct_carries(tiles_r, tiles_c)) {
    tile2_scan_kernel<kVec, true><<<tiles, kThreads, 0, s>>>(d, out, row_sums, col_sums, totals,
                                                             rows, cols, tiles_r, tiles_c, two_eb);
    return;
  }
  const int64_t row_lines = tiles_c > 1 ? rows : 0, col_lines = tiles_r > 1 ? cols : 0;
  const int64_t total_lines =
      (tiles_r > 1 && tiles_c > 1) ? (corner_by_rows(tiles_r, tiles_c) ? tiles_r : tiles_c) : 0;
  const unsigned carry_blocks = static_cast<unsigned>(ceil_div(total_lines + row_lines + col_lines, kWarps));
  if (carry_blocks > 0) {
    tile2_carries_kernel<<<carry_blocks, kThreads, 0, s>>>(row_sums, col_sums, totals, row_lines,
                                                           col_lines, total_lines, tiles_r, tiles_c);
  }
  tile2_scan_kernel<kVec, false><<<tiles, kThreads, 0, s>>>(d, out, row_sums, col_sums, totals, rows,
                                                            cols, tiles_r, tiles_c, two_eb);
}

}  // namespace

extern "C" {

// Words of uint32 scratch the decode entry points need for a (rows, cols)
// input; the caller allocates them.  decode_1d: the tile counter (2 words,
// keeping the status words 8-byte aligned) and the 64-bit status words,
// one per tile, interleaved (status_slot).  decode_2d: its tiles' row sums,
// column sums and totals, or decode_1d's words for (1, rows * cols) when
// rows or cols is 1.  The launch grids need rows * ceil(cols / 4096) (1d),
// and ceil(rows / 32) * ceil(cols / 128) and (rows + cols + min(tile rows,
// tile columns)) / 8 (2d), below 2^31.
int64_t lorenzo_decode_scratch_words(int64_t rows, int64_t cols, int two_d) {
  if (two_d && (rows == 1 || cols == 1)) return lorenzo_decode_scratch_words(1, rows * cols, 0);
  if (!two_d) return 2 + 2 * 32 * status_stride(rows * ceil_div(cols, kLbTile));
  const int64_t tiles_r = ceil_div(rows, kT2Rows), tiles_c = ceil_div(cols, kT2Cols);
  return rows * tiles_c + cols * tiles_r + tiles_r * tiles_c;
}

// The encodes take float4 loads and int4 stores where every span starts
// 16-byte aligned (x, codes and draw aligned, and rows == 1 or cols % 4 ==
// 0), else 4-byte ones in the same kernel.  The grids need rows *
// ceil(cols / 256 or 128) / 4 (1d) and ceil(rows / H) * ceil(cols / 128) / 4
// (2d) blocks, below 2^31.
int lorenzo_encode_1d(const float* x, int32_t* codes, int32_t* draw, int64_t rows,
                      int64_t cols, float inv_two_eb, int radius, void* stream) {
  if (rows * cols > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (rows == 1 || cols % 4 == 0) && aligned16(x) && aligned16(codes) && aligned16(draw);
    const int64_t spans_per_row = ceil_div(cols, enc1d_span(vec)), spans = rows * spans_per_row;
    const int64_t blocks = ceil_div(spans, kEncWarps);
    if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (vec) {
      encode_1d_kernel<true><<<static_cast<unsigned>(blocks), 32 * kEncWarps, 0, s>>>(
          x, codes, draw, cols, spans_per_row, spans, inv_two_eb, radius);
    } else {
      encode_1d_kernel<false><<<static_cast<unsigned>(blocks), 32 * kEncWarps, 0, s>>>(
          x, codes, draw, cols, spans_per_row, spans, inv_two_eb, radius);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int lorenzo_encode_2d(const float* x, int32_t* codes, int32_t* draw, int64_t rows,
                      int64_t cols, float inv_two_eb, int radius, void* stream) {
  if (rows * cols > 0 && (rows == 1 || cols == 1)) {
    // one row or column: the difference along the other axis is with zeros
    return lorenzo_encode_1d(x, codes, draw, 1, rows * cols, inv_two_eb, radius, stream);
  }
  if (rows * cols > 0) {
    const int64_t segs = ceil_div(cols, kEnc2dCols);
    const int h = enc2d_strip_rows(rows, segs);
    if (ceil_div(ceil_div(rows, h) * segs, kEncWarps) >= (int64_t{1} << 31)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cols % 4 == 0 && aligned16(x) && aligned16(codes) && aligned16(draw)) {
      enc2d_launch<true>(h, x, codes, draw, rows, cols, segs, inv_two_eb, radius, s);
    } else {
      enc2d_launch<false>(h, x, codes, draw, rows, cols, segs, inv_two_eb, radius, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// vec: rows == 1 or cols % 4 == 0, and d, out 16-byte aligned.  The
// scratch's counter and status words are zeroed on the stream first.
int lorenzo_decode_1d(const int32_t* d, float* out, uint32_t* scratch, int64_t rows,
                      int64_t cols, float two_eb, int vec, void* stream) {
  if (rows * cols > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t tiles = ceil_div(cols, kLbTile);
    const int64_t words = lorenzo_decode_scratch_words(rows, cols, 0);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    unsigned* counter = scratch;
    unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 2);
    const int64_t stride = status_stride(rows * tiles);
    const unsigned blocks = static_cast<unsigned>(rows * tiles);
    if (vec) {
      decode_1d_lookback_kernel<true><<<blocks, kThreads, 0, s>>>(d, out, counter, status, stride,
                                                                  cols, tiles, two_eb);
    } else {
      decode_1d_lookback_kernel<false><<<blocks, kThreads, 0, s>>>(d, out, counter, status, stride,
                                                                   cols, tiles, two_eb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int lorenzo_decode_2d(const int32_t* d, float* out, uint32_t* scratch, int64_t rows,
                      int64_t cols, float two_eb, void* stream) {
  const bool vec = aligned16(d) && aligned16(out);
  if (rows * cols > 0 && (rows == 1 || cols == 1)) {
    // a single row or column: the scan along the other axis is the identity
    return lorenzo_decode_1d(d, out, scratch, 1, rows * cols, two_eb, vec, stream);
  }
  if (rows * cols > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t tiles_r = ceil_div(rows, kT2Rows), tiles_c = ceil_div(cols, kT2Cols);
    uint32_t* row_sums = scratch;
    uint32_t* col_sums = row_sums + rows * tiles_c;
    uint32_t* totals = col_sums + cols * tiles_r;
    if (vec && cols % 4 == 0) {
      tile2_launch<true>(d, out, row_sums, col_sums, totals, rows, cols, two_eb, s);
    } else {
      tile2_launch<false>(d, out, row_sums, col_sums, totals, rows, cols, two_eb, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
