// KV-cache quantization kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/_build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/kvquant/kernel.py:
//   kvquant_absmax          <- absmax (:56, body _absmax_kernel :34)
//   kvquant_quantize        <- quantize_with_scale (:70, body _quant_kernel :49)
//   kvquant_dequant_matmul  <- dequant_matmul (:106, body :90)
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
//   * dequant_matmul: C = (sum_k a[i,k] * f32(q[k,j])) * s[j].  64x64 output
//     tiles, 16-deep K steps through shared memory (int8 converted to f32
//     as it is stored there), 4x4 outputs per thread, float32 FMA
//     accumulation — no TF32 and no tensor cores, so the contract of the
//     oracle (IEEE float32 accumulation) holds.  With few output tiles the
//     K range is split over blocks (split-K): each split writes its partial
//     tile to a workspace and a second kernel sums the splits in order and
//     applies the per-column scale (the TPU kernel's epilogue).  Deterministic:
//     no atomics.  Bound: operations (2 M N K at the card's float32 rate).
//
// Every entry point checks nothing itself (the Python wrapper does), launches
// on the given stream, and returns cudaGetLastError().

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

constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 16;
constexpr int MM_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// ws[z] (M, N) = a[:, k0:k1] @ f32(q[k0:k1, :]) for split z = blockIdx.z,
// k0 = z * kchunk.  Out-of-range rows, columns and k are loaded as zeros.
__global__ void __launch_bounds__(MM_THREADS)
dequant_matmul_kernel(const float* __restrict__ a, const int8_t* __restrict__ q,
                      float* __restrict__ ws, int64_t M, int64_t K, int64_t N, int64_t kchunk) {
  __shared__ float As[MM_BK][MM_BM + 4];  // As[k][i] = a[i0+i, k0+k]
  __shared__ float Bs[MM_BK][MM_BN + 4];  // Bs[k][j] = f32(q[k0+k, j0+j])
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t i0 = (int64_t)blockIdx.y * MM_BM, j0 = (int64_t)blockIdx.x * MM_BN;
  const int64_t kbeg = (int64_t)blockIdx.z * kchunk;
  const int64_t kend = imin(kbeg + kchunk, K);
  float acc[4][4] = {};
  for (int64_t k0 = kbeg; k0 < kend; k0 += MM_BK) {
    // A tile: 64 rows x 16 k = 1024 floats, 4 per thread; consecutive
    // threads read consecutive k of a row
    for (int e = tid; e < MM_BM * MM_BK; e += MM_THREADS) {
      const int i = e / MM_BK, k = e % MM_BK;
      const int64_t gi = i0 + i, gk = k0 + k;
      As[k][i] = (gi < M && gk < kend) ? a[gi * K + gk] : 0.0f;
    }
    // Q tile: 16 k x 64 columns = 1024 int8, 4 per thread; consecutive
    // threads read consecutive columns of a row
    for (int e = tid; e < MM_BK * MM_BN; e += MM_THREADS) {
      const int k = e / MM_BN, j = e % MM_BN;
      const int64_t gk = k0 + k, gj = j0 + j;
      Bs[k][j] = (gk < kend && gj < N) ? (float)q[gk * N + gj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MM_BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[k][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[k][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = ws + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t gi = i0 + ty * 4 + r;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t gj = j0 + tx * 4 + c;
      if (gj < N) out[gi * N + gj] = acc[r][c];
    }
  }
}

// out[i, j] = (ws[0][i, j] + ws[1][i, j] + ...) * s[j], splits in order.
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                       float* __restrict__ out, int64_t M, int64_t N, int splits) {
  const int64_t mn = M * N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < mn; e += stride) {
    float acc = ws[e];
    for (int z = 1; z < splits; ++z) acc = __fadd_rn(acc, ws[(int64_t)z * mn + e]);
    out[e] = __fmul_rn(acc, s[e % N]);
  }
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

// ws: (splits, M, N) float32 scratch; kchunk a multiple of 16 with
// splits = ceil(K / kchunk).
int kvquant_dequant_matmul(const float* a, const int8_t* q, const float* s, float* ws, float* out,
                           int64_t M, int64_t K, int64_t N, int64_t kchunk, int splits,
                           void* stream) {
  const dim3 grid((unsigned)((N + MM_BN - 1) / MM_BN), (unsigned)((M + MM_BM - 1) / MM_BM),
                  (unsigned)splits);
  dequant_matmul_kernel<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(a, q, ws, M, K, N, kchunk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  splitk_epilogue_kernel<<<grid_for(M * N, 256), 256, 0, (cudaStream_t)stream>>>(ws, s, out, M, N,
                                                                                   splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
