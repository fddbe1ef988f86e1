// KV-cache quantization kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/_build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/kvquant/kernel.py:
//   kvquant_absmax          <- absmax (:56, body _absmax_kernel :34)
//   kvquant_quantize        <- quantize_with_scale (:70, body _quant_kernel :49)
//   kvquant_dequant_matmul  <- dequant_matmul (:106, body :90)
//   kvquant_append          <- absmax (:56) + quantize_with_scale (:70), fused
//                              for the int8 decode append
//
// The TPU kernels carry the absmax and the matmul's partial sums in VMEM
// scratch along a grid that runs in order.  Blocks on Hopper run in no
// order, so:
//   * absmax: each block reduces a band of rows for 32 columns (each warp
//     reads 128 contiguous bytes of a row) and merges its per-column result
//     with atomicMax on the float's bit pattern.  For x >= 0 (and NaN with
//     its sign cleared by fabsf) the unsigned bit patterns order as the
//     floats do, with every NaN above +inf, so NaN propagates as jnp.max
//     propagates it.  max is order-exact: the result equals the plain
//     version bit for bit (any NaN for any NaN).  Bound: bytes (4 T C read).
//   * quantize: elementwise, q = clip(rint(x / s[c]), -127, 127) with an
//     IEEE divide (__fdiv_rn; no --use_fast_math, no __fdividef), rintf
//     (half to even), NaN -> 0; bit-identical to the plain version.
//     Bound: bytes (4 T C read, T C written).
//   * dequant_matmul: C = (sum_k a[i,k] * f32(q[k,j])) * s[j] on the tensor
//     cores, without loosening the float32 contract.  f32(q) for |q| <= 127
//     is exact in bf16; a float32 a splits exactly into three bf16 parts,
//     a = a0 + a1 + a2 (split3: a0 = a truncated to bf16, a1 the remainder
//     truncated, a2 what is left, at most 8 significant bits), for every
//     finite a whose lowest set bit is at or above 2^-133, bf16's subnormal
//     step: every |a| >= 2^-109 and every softmax row at these shapes.
//     Below that step a term loses under 2^-133 |q|.  A bf16 x bf16 product
//     is exact in float32, so the only rounding left is the float32
//     accumulation, as in the SIMT kernel this replaced.  Non-finite a: a0
//     carries it (a NaN stays NaN), a1 = a2 = 0, so the non-finite outputs
//     are the plain version's.
//     Design: wgmma m64n128k16 (bf16 x bf16 -> f32, A from registers, B
//     from shared memory), 128 x 128 CTA tiles (two warpgroups of 64 rows),
//     64-deep K steps in a 4-stage cp.async ring, q converted once per step
//     into a bf16 tile in wgmma's K-major core-matrix layout.  The register-A
//     form fits the split: each thread reads its A fragment as float32 and
//     splits it where it is used, so no bf16 copy of a goes through memory
//     (the transposed formulation, C^T = Q^T A^T, would convert q in
//     registers but store a's three parts in shared memory, three times the
//     bytes of the one int8 q tile).  Three wgmma per 16-deep slice against
//     the same B descriptor: the a0 products in one float32 accumulator,
//     the a1/a2 products (each under 2^-7 |a|) in a second; the split of
//     the next slice overlaps the wgmma of this one.  Every 128 of K the
//     a0 accumulator is added into a float32 register sum (promotion) and
//     restarts; at the end of the K slice, (sum + a0 acc) + a1/a2 acc.
//     Split-K as before: each split writes its partial tile, a second
//     kernel sums the splits in order (float4) and applies the scale;
//     deterministic, no atomics.
//     The accumulator does not round to nearest.  Measured on an H100:
//     each wgmma k16 step aligns the accumulator and its 16 exact products
//     to 2^E, the largest of their exponents (a product's taken as the sum
//     of its factors'), keeps the bits down to 2^(E-25), cuts the rest
//     toward zero, sums exactly and cuts the sum toward zero to float32.
//     ref.tensor_core_dequant_matmul models this, step by step, and equals
//     the card bit for bit (the cuda tests of tests/test_torch_kvquant.py
//     and chip_smoke.py hold it, on rows built to expose the rounding and
//     on random ones).  So a step with n addends, the largest M, the sum
//     R, errs by under (n - 1) 2^-25 M + 2^-23 R.  Worst case, with S = |a| @ |deq|
//     and units of 2^-24 S: a run of B of K in one accumulator errs by
//     under (B - 1)/2 + 2 ceil(B/16), which over K = 32768 in one run
//     would be 0.62 of the contract's K + 2 (on softmax rows against
//     positive codes the model reads 0.082 there, and 0.00063 with
//     promotion: test_promotion_holds_a_long_run_in_one_split).  With
//     promotion: 79.5 over all 128-deep runs of a0, ceil(kchunk/128) - 1
//     for adding them, 0.0098 K + 0.03 for the a1/a2 accumulator (2K
//     addends of at most 2^-7 S), 1 for hi + lo, splits - 1 for the
//     epilogue's sum and 1 for the scale: at most about 80 + K/128 +
//     0.0098 K + splits, within K + 2 for every K >= 4 (K = 1 is exact up
//     to the last two roundings; at K = 2 and 3 the count exceeds K + 2 by
//     under 1%, and only measurement holds them).  At 128 x 32768 x 1024
//     that is 0.013 of the contract.  chip_smoke.py reads the ratio to (K+2) 2^-24 (|a| @
//     |deq|) on every shape and fails above 1.
//     Bound on the H100: 3 * 2 M N K bf16 operations at 989 TFLOP/s
//     (0.02606 ms at 128 x 32768 x 1024; the bytes take 0.01518 ms).
//   * append: the int8 KV append of one attention layer's decode step, K
//     and V in one launch.  Per (tensor, b, h) row of hd values (the new
//     token after rope, float32 or bf16, read as it is: bf16 -> float32 is
//     exact): amax = max |x| (unsigned bit patterns, so NaN propagates),
//     s = max(amax / 127, 1e-8) with an IEEE divide and a floor that keeps
//     NaN, q = quant_one(x, s); codes go to cache[b, slot, h, :], s to
//     scale[b, slot, h], slot read on the device from the 1-element int64
//     tensor the decode step builds (no host sync).  Bit-identical to
//     ref.quantize_append, the reference's _quantize_token plus
//     dynamic_update_slice_in_dim.  At the decode shapes (at most 2 x 4 x
//     32 rows of at most 128 values) the bound is nanoseconds and the time
//     is the launch's, so the design serves one launch and no host glue:
//     a warp per row, lanes striding over hd, __reduce_max_sync for the
//     absmax, no memset, no atomics, no scratch.  Bound: bytes (k, v read,
//     codes and scales written).
//
// Every entry point checks nothing itself (the Python wrapper does), launches
// on the given stream, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int AM_COLS = 32;     // columns per absmax block (one warp's width)
constexpr int AM_LANES = 8;     // row lanes per absmax block
constexpr int AM_BAND = 512;    // rows per absmax block

__global__ void absmax_kernel(const float* __restrict__ x, unsigned* __restrict__ amax,
                              int64_t T, int64_t C) {
  const int64_t col = (int64_t)blockIdx.x * AM_COLS + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * AM_BAND;
  const int64_t r1 = imin(r0 + AM_BAND, T);
  unsigned m = 0u;  // +0.0f
  if (col < C) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += AM_LANES) {
      const unsigned b = __float_as_uint(fabsf(x[r * C + col]));
      m = b > m ? b : m;
    }
  }
  __shared__ unsigned part[AM_LANES][AM_COLS];
  part[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    for (int l = 1; l < AM_LANES; ++l) {
      const unsigned b = part[l][threadIdx.x];
      m = b > m ? b : m;
    }
    atomicMax(amax + col, m);
  }
}

__device__ __forceinline__ int8_t quant_one(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  if (isnan(r)) return 0;
  return (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// Each thread codes 4 consecutive elements.  vec: C % 4 == 0 and x, s, q
// 16/16/4-byte aligned, so the 4 elements lie in one row and load as one
// float4 (and one float4 of scales) and store as one char4.
__global__ void quantize_kernel(const float* __restrict__ x, const float* __restrict__ s,
                                int8_t* __restrict__ q, int64_t n, int64_t C, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < n; i += stride) {
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(x + i);
      const float4 sc = *reinterpret_cast<const float4*>(s + i % C);
      char4 out;
      out.x = quant_one(v.x, sc.x);
      out.y = quant_one(v.y, sc.y);
      out.z = quant_one(v.z, sc.z);
      out.w = quant_one(v.w, sc.w);
      *reinterpret_cast<char4*>(q + i) = out;
    } else {
      const int64_t end = imin(i + 4, n);
      for (int64_t j = i; j < end; ++j) q[j] = quant_one(x[j], s[j % C]);
    }
  }
}

// ---------------------------------------------------------------------------
// dequant_matmul on the tensor cores: wgmma m64n128k16, bf16 x bf16 -> f32,
// A from registers, B from shared memory.
//
// A CTA computes a 128 x 128 tile of one K slice with two warpgroups, one
// per 64 rows.  Per 64-deep K step:
//   * cp.async (16-byte chunks, zero-filled past the edges) brings the a
//     tile as float32 [128][64] and the q tile as int8 [64][128] into a
//     ring of TC_STAGES shared-memory stages, TC_STAGES - 2 steps ahead;
//   * the q tile of the next step is converted once into a bf16 tile in
//     wgmma's K-major core-matrix layout (two buffers): byte -> float by
//     the 2^23 magic number, exact, and transposed on the way;
//   * for each 16-deep slice, each thread reads its A fragment as float2,
//     splits every float into its three bf16 parts (split3) and runs
//     three wgmma against the same B descriptor: a0 into one accumulator,
//     a1 and a2 into the other.  The split of slice j+1 runs while the
//     wgmma of slice j do (double-buffered fragments, wait_group 1); the
//     loads of step kt+3 and the conversion of step kt+1 run while slice 0
//     of step kt does.  Each step starts with wait_group 0 and a barrier,
//     so no wgmma is in flight across the loop's back edge, and the first
//     wgmma of each accumulator overwrites it (scale-d 0): a register that
//     other instructions define while wgmma run makes ptxas serialize them.
//     Every TC_PROMOTE steps the a0 accumulator goes into its register sum
//     there, between wait_group 0 and the barrier, and its next wgmma
//     overwrites it.
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64;
constexpr int TC_PROMOTE = 2;  // K steps per promotion: 128 of K
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 256;
constexpr int TC_A_LD = TC_BK + 8;  // floats per a row: conflict-free float2 fragment reads
constexpr int TC_A_STAGE = TC_BM * TC_A_LD * 4;  // bytes
constexpr int TC_Q_STAGE = TC_BK * TC_BN;        // bytes
// B tile: byte (n, k) at (n / 8) TC_SBO + (k / 8) TC_LBO + (n % 8) 16 + (k % 8) 2,
// 8 x 8 core matrices of 128 contiguous bytes; the 16 bytes of padding per
// 8 columns spread the conversion's stores over the banks
constexpr int TC_LBO = 128;                      // next 8 k of the same 8 columns
constexpr int TC_SBO = (TC_BK / 8) * 128 + 16;   // next 8 columns
constexpr int TC_B_TILE = (TC_BN / 8) * TC_SBO;  // bytes
constexpr int TC_SMEM = TC_STAGES * (TC_A_STAGE + TC_Q_STAGE) + 2 * TC_B_TILE;
static_assert(TC_SMEM <= 232448, "a block's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = p0 + p1 + p2 with each part a bf16 (a float whose low 16 bits are 0):
// p0 = a truncated to bf16, p1 = the remainder truncated, p2 what is left
// (at most 8 significant bits, so exact in bf16 unless it has bits below
// bf16's subnormal step 2^-133).  Non-finite a: p0 carries it (a NaN whose
// payload lies only in the low 16 bits becomes a quiet NaN), p1 = p2 = 0.
// ref.split_bf16x3 is this function in torch.
__device__ __forceinline__ void split3(float a, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  const uint32_t b = __float_as_uint(a);
  if ((b & 0x7F800000u) == 0x7F800000u) {
    p0 = (b & 0xFFFF0000u) | ((b & 0x007FFFFFu) ? 0x00400000u : 0u);
    p1 = p2 = 0u;
    return;
  }
  p0 = b & 0xFFFF0000u;
  const float r = __fsub_rn(a, __uint_as_float(p0));  // exact
  p1 = __float_as_uint(r) & 0xFFFF0000u;
  p2 = __float_as_uint(__fsub_rn(r, __uint_as_float(p1))) & 0xFFFF0000u;  // exact
}

// The bf16 pair {lo element, hi element} of two bf16-valued floats' bits.
__device__ __forceinline__ uint32_t pack_bf16(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// Four int8 -> four exact floats: 2^23 + (q + 128), less 2^23 + 128.
__device__ __forceinline__ void int8x4_to_f32x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)), 8388736.0f);
  }
}

// d (64 floats of the m64n128 accumulator) += A (bf16 fragments in
// registers) x B (bf16, K-major core matrices in shared memory, `desc`).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// wgmma's shared-memory descriptor, no swizzle: start, LBO and SBO in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(TC_LBO >> 4) << 16) | (static_cast<uint64_t>(TC_SBO >> 4) << 32);
}

// Keeps the compiler from moving accumulator registers across a wgmma wait.
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Loads K step `kt` of this CTA's slice into stage `st`.  kVec: K % 4 == 0,
// N % 16 == 0 and a, q 16-byte aligned, so every 16-byte chunk lies wholly
// inside or outside the matrices and goes by cp.async; otherwise element by
// element, synchronously, with zeros past the edges.
template <bool kVec>
__device__ __forceinline__ void tc_load(unsigned char* smem, int st, const float* __restrict__ a,
                                        const int8_t* __restrict__ q, int64_t M, int64_t K,
                                        int64_t N, int64_t m0, int64_t n0, int64_t k0,
                                        int64_t kend) {
  float* As = reinterpret_cast<float*>(smem + st * TC_A_STAGE);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + TC_STAGES * TC_A_STAGE + st * TC_Q_STAGE);
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < TC_BM * TC_BK / 4 / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int row = c / (TC_BK / 4), col = (c % (TC_BK / 4)) * 4;
      const int64_t gm = m0 + row, gk = k0 + col;
      const bool ok = gm < M && gk < kend;
      cp_async16(As + row * TC_A_LD + col, ok ? a + gm * K + gk : a, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < TC_BK * TC_BN / 16 / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int row = c / (TC_BN / 16), col = (c % (TC_BN / 16)) * 16;
      const int64_t gk = k0 + row, gn = n0 + col;
      const bool ok = gk < kend && gn < N;
      cp_async16(Qs + row * TC_BN + col, ok ? q + gk * N + gn : q, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < TC_BM * TC_BK / TC_THREADS; ++i) {
      const int e = tid + i * TC_THREADS;
      const int row = e / TC_BK, col = e % TC_BK;
      const int64_t gm = m0 + row, gk = k0 + col;
      As[row * TC_A_LD + col] = (gm < M && gk < kend) ? a[gm * K + gk] : 0.0f;
    }
#pragma unroll 4
    for (int i = 0; i < TC_BK * TC_BN / TC_THREADS; ++i) {
      const int e = tid + i * TC_THREADS;
      const int row = e / TC_BN, col = e % TC_BN;
      const int64_t gk = k0 + row, gn = n0 + col;
      Qs[row * TC_BN + col] = (gk < kend && gn < N) ? q[gk * N + gn] : int8_t(0);
    }
  }
}

// The int8 q tile of stage `st` -> the bf16 B tile `buf`.  A thread takes 4
// columns x 4 k per pass; a warp reads 32 consecutive words of one k row.
// The fence makes the generic stores visible to wgmma's async proxy.
__device__ __forceinline__ void tc_convert(unsigned char* smem, int st, int buf) {
  const int8_t* Qs = reinterpret_cast<const int8_t*>(smem + TC_STAGES * TC_A_STAGE + st * TC_Q_STAGE);
  unsigned char* Bt = smem + TC_STAGES * (TC_A_STAGE + TC_Q_STAGE) + buf * TC_B_TILE;
  const int n0 = (threadIdx.x & 31) * 4;
#pragma unroll
  for (int pass = 0; pass < TC_BK / 32; ++pass) {
    const int k0 = pass * 32 + (threadIdx.x >> 5) * 4;
    float f[4][4];  // [k][n]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int8x4_to_f32x4(*reinterpret_cast<const uint32_t*>(Qs + (k0 + i) * TC_BN + n0), f[i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j;
      uint2 v;
      v.x = pack_bf16(__float_as_uint(f[0][j]), __float_as_uint(f[1][j]));
      v.y = pack_bf16(__float_as_uint(f[2][j]), __float_as_uint(f[3][j]));
      *reinterpret_cast<uint2*>(Bt + (n >> 3) * TC_SBO + (k0 >> 3) * TC_LBO + (n & 7) * 16 +
                                (k0 & 7) * 2) = v;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// This thread's A fragment of the 16-deep slice at `ks`, split in three:
// f[part][r], register r holding rows g (+8 for r odd), columns 2t, 2t+1
// (+8 for r >= 2) of the warp's 16 rows, as mma's m16k16 fragment.
__device__ __forceinline__ void tc_split(const float* As, int wrow, int ks, uint32_t (*f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 v = *reinterpret_cast<const float2*>(As + (wrow + g + (r & 1) * 8) * TC_A_LD +
                                                      ks + 2 * t + (r >> 1) * 8);
    uint32_t x0, x1, x2, y0, y1, y2;
    split3(v.x, x0, x1, x2);
    split3(v.y, y0, y1, y2);
    f[0][r] = pack_bf16(x0, y0);
    f[1][r] = pack_bf16(x1, y1);
    f[2][r] = pack_bf16(x2, y2);
  }
}

// ws[z] (M, N) = a[:, k0:k1] @ f32(q[k0:k1, :]) for split z = blockIdx.z,
// k0 = z * kchunk (kchunk a multiple of TC_BK).
template <bool kVec>
__global__ void __launch_bounds__(TC_THREADS, 1)
dequant_matmul_kernel(const float* __restrict__ a, const int8_t* __restrict__ q,
                      float* __restrict__ ws, int64_t M, int64_t K, int64_t N, int64_t kchunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // this warp's 16 rows of the tile
  const int64_t m0 = (int64_t)blockIdx.y * TC_BM, n0 = (int64_t)blockIdx.x * TC_BN;
  const int64_t kbeg = (int64_t)blockIdx.z * kchunk;
  const int64_t kend = imin(kbeg + kchunk, K);
  const int nk = (int)((kend - kbeg + TC_BK - 1) / TC_BK);

  // no zeroing: the first wgmma of each accumulator overwrites it (scale-d
  // 0), so no other instruction defines an accumulator register while the
  // wgmma pipeline runs (which would serialize it); sum_hi holds acc_hi's
  // promoted runs
  float acc_hi[64], acc_lo[64], sum_hi[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum_hi[i] = 0.0f;

  // prologue: steps 0 .. TC_STAGES-2 in flight, one commit group each
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) tc_load<kVec>(smem, s, a, q, M, K, N, m0, n0, kbeg + (int64_t)s * TC_BK, kend);
    cp_async_commit();
  }
  cp_async_wait<TC_STAGES - 2>();
  __syncthreads();
  tc_convert(smem, 0, 0);

  for (int kt = 0; kt < nk; ++kt) {
    // every wgmma of step kt-1 is done and step kt+1 has landed; past the
    // barrier every thread is done with step kt-1, so its stage and the B
    // tile it read are free
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc_hi);
    pin(acc_lo);
    if (kt > 0 && kt % TC_PROMOTE == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum_hi[i] = __fadd_rn(sum_hi[i], acc_hi[i]);
    }
    cp_async_wait<TC_STAGES - 3>();
    __syncthreads();
    const float* As = reinterpret_cast<const float*>(smem + (kt % TC_STAGES) * TC_A_STAGE);
    const unsigned char* Bt = smem + TC_STAGES * (TC_A_STAGE + TC_Q_STAGE) + (kt & 1) * TC_B_TILE;
    uint32_t af[2][3][4];  // two slices' fragments: [slice & 1][part][register]
    tc_split(As, wrow, 0, af[0]);
#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
      const uint64_t desc = wgmma_desc(Bt + 2 * j * TC_LBO);  // k = 16 j
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_m64n128k16(acc_hi, af[j & 1][0], desc, (kt % TC_PROMOTE != 0 || j > 0) ? 1 : 0);
      wgmma_m64n128k16(acc_lo, af[j & 1][1], desc, (kt > 0 || j > 0) ? 1 : 0);
      wgmma_m64n128k16(acc_lo, af[j & 1][2], desc, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (j == 0) {
        // while slice 0 multiplies: the loads of step kt+3, the bf16 B tile of step kt+1
        const int nxt = kt + TC_STAGES - 1;
        if (nxt < nk) {
          tc_load<kVec>(smem, nxt % TC_STAGES, a, q, M, K, N, m0, n0, kbeg + (int64_t)nxt * TC_BK,
                        kend);
        }
        cp_async_commit();
        if (kt + 1 < nk) tc_convert(smem, (kt + 1) % TC_STAGES, (kt + 1) & 1);
      }
      if (j + 1 < TC_BK / 16) {
        // slice j-1's wgmma are done: their fragments take slice j+1
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        pin(acc_hi);
        pin(acc_lo);
        tc_split(As, wrow, 16 * (j + 1), af[(j + 1) & 1]);
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(acc_hi);
  pin(acc_lo);
  cp_async_wait<0>();

  // accumulator register 4 j + 2 h + e: row g + 8 h, column 8 j + 2 t + e
  float* out = ws + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = m0 + wrow + g + h * 8;
      const int64_t gn = n0 + j * 8 + 2 * t;
      if (gm >= M) continue;
      const int r = 4 * j + 2 * h;
      const float v0 = __fadd_rn(__fadd_rn(sum_hi[r], acc_hi[r]), acc_lo[r]);
      const float v1 = __fadd_rn(__fadd_rn(sum_hi[r + 1], acc_hi[r + 1]), acc_lo[r + 1]);
      if (kVec) {
        if (gn < N) *reinterpret_cast<float2*>(out + gm * N + gn) = make_float2(v0, v1);
      } else {
        if (gn < N) out[gm * N + gn] = v0;
        if (gn + 1 < N) out[gm * N + gn + 1] = v1;
      }
    }
}

// out[i, j] = (ws[0][i, j] + ws[1][i, j] + ...) * s[j], splits in order.
// vec: N % 4 == 0 and s 16-byte aligned: four columns of one row per float4.
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                       float* __restrict__ out, int64_t M, int64_t N, int splits,
                                       int vec) {
  const int64_t mn = M * N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    for (int64_t e = first * 4; e < mn; e += stride * 4) {
      float4 acc = *reinterpret_cast<const float4*>(ws + e);
      for (int z = 1; z < splits; ++z) {
        const float4 v = *reinterpret_cast<const float4*>(ws + (int64_t)z * mn + e);
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      const float4 sc = *reinterpret_cast<const float4*>(s + e % N);
      *reinterpret_cast<float4*>(out + e) = make_float4(
          __fmul_rn(acc.x, sc.x), __fmul_rn(acc.y, sc.y), __fmul_rn(acc.z, sc.z), __fmul_rn(acc.w, sc.w));
    }
  } else {
    for (int64_t e = first; e < mn; e += stride) {
      float acc = ws[e];
      for (int z = 1; z < splits; ++z) acc = __fadd_rn(acc, ws[(int64_t)z * mn + e]);
      out[e] = __fmul_rn(acc, s[e % N]);
    }
  }
}

// ---------------------------------------------------------------------------
// append: one warp per (tensor, b, h) row; rows [0, R) are K's, [R, 2R) V's,
// R = B * KV, each row hd contiguous values of the (B, 1, KV, hd) input.
constexpr int QA_WARPS = 4;  // rows per block

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void append_kernel(const T* __restrict__ k, const T* __restrict__ v, int8_t* __restrict__ kc,
                              int8_t* __restrict__ vc, float* __restrict__ ks, float* __restrict__ vs,
                              const int64_t* __restrict__ slot_p, int64_t R, int64_t KV, int64_t W, int hd) {
  const int64_t row = (int64_t)blockIdx.x * QA_WARPS + threadIdx.y;
  const int64_t slot = *slot_p;
  // warp-uniform exits: every lane of a live warp reaches the shuffle
  if (row >= 2 * R || slot < 0 || slot >= W) return;
  const bool is_v = row >= R;
  const int64_t r = is_v ? row - R : row;
  const T* x = (is_v ? v : k) + r * hd;
  unsigned m = 0u;  // +0.0f
  for (int i = threadIdx.x; i < hd; i += 32) {
    const unsigned b = __float_as_uint(fabsf(as_f32(x[i])));
    m = b > m ? b : m;
  }
  m = __reduce_max_sync(0xffffffffu, m);
  float s = __fdiv_rn(__uint_as_float(m), 127.0f);
  s = s < 1e-8f ? 1e-8f : s;  // the floor; a NaN compares false and stays
  const int64_t b = r / KV;
  const int64_t dst = (b * W + slot) * KV + (r - b * KV);
  int8_t* q = (is_v ? vc : kc) + dst * hd;
  for (int i = threadIdx.x; i < hd; i += 32) q[i] = quant_one(as_f32(x[i]), s);
  if (threadIdx.x == 0) (is_v ? vs : ks)[dst] = s;
}

int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace

extern "C" {

// amax: (C,) uint32, zeroed by the caller; on return it holds the bit
// patterns of max |x[:, c]|.
int kvquant_absmax(const float* x, unsigned* amax, int64_t T, int64_t C, void* stream) {
  const dim3 block(AM_COLS, AM_LANES);
  const dim3 grid((unsigned)((C + AM_COLS - 1) / AM_COLS), (unsigned)((T + AM_BAND - 1) / AM_BAND));
  absmax_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, amax, T, C);
  return (int)cudaGetLastError();
}

int kvquant_quantize(const float* x, const float* s, int8_t* q, int64_t T, int64_t C, int vec,
                     void* stream) {
  const int64_t n = T * C;
  quantize_kernel<<<grid_for((n + 3) / 4, 256), 256, 0, (cudaStream_t)stream>>>(x, s, q, n, C, vec);
  return (int)cudaGetLastError();
}

// ws: (splits, M, N) float32 scratch; kchunk a multiple of TC_BK with
// splits = ceil(K / kchunk).  vec: K % 4 == 0, N % 16 == 0, a and q 16-byte
// aligned (the cp.async variant); evec: N % 4 == 0 and s 16-byte aligned
// (float4 epilogue).
int kvquant_dequant_matmul(const float* a, const int8_t* q, const float* s, float* ws, float* out,
                           int64_t M, int64_t K, int64_t N, int64_t kchunk, int splits, int vec,
                           int evec, void* stream) {
  const dim3 grid((unsigned)((N + TC_BN - 1) / TC_BN), (unsigned)((M + TC_BM - 1) / TC_BM),
                  (unsigned)splits);
  const cudaStream_t st = (cudaStream_t)stream;
  auto kernel = vec ? dequant_matmul_kernel<true> : dequant_matmul_kernel<false>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != 0) return err;
  kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(a, q, ws, M, K, N, kchunk);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t items = evec ? (M * N + 3) / 4 : M * N;
  splitk_epilogue_kernel<<<grid_for(items, 256), 256, 0, st>>>(ws, s, out, M, N, splits, evec);
  return (int)cudaGetLastError();
}

// k, v: (B, 1, KV, hd) float32 (bf16 = 0) or bf16 (bf16 = 1), contiguous;
// kc, vc: (B, W, KV, hd) int8 and ks, vs: (B, W, KV) float32, contiguous;
// slot: one int64 on the device.  A slot outside [0, W) writes nothing.
int kvquant_append(const void* k, const void* v, int8_t* kc, int8_t* vc, float* ks, float* vs,
                   const int64_t* slot, int64_t B, int64_t KV, int64_t W, int hd, int bf16, void* stream) {
  const int64_t R = B * KV;
  const dim3 block(32, QA_WARPS);
  const unsigned grid = (unsigned)((2 * R + QA_WARPS - 1) / QA_WARPS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    append_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, kc, vc, ks, vs, slot, R, KV, W, hd);
  } else {
    append_kernel<float><<<grid, block, 0, st>>>((const float*)k, (const float*)v, kc, vc, ks, vs, slot, R,
                                                 KV, W, hd);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
