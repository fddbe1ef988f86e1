// Blockwise 4-point DCT-II transform kernels for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// transform_rotate replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/transform/kernel.py (_call, via fwd and inv): each 4x4
// block of an (R, C) grid is rotated by a 4x4 basis, c = M b M^T, last axis
// first, then the rows ("2d" mode), or along the last axis only ("1d" mode).
// The caller passes MAT (forward) or MAT^T (inverse), rounded to float32 on
// the host.  As the TPU kernel casts its tile to float32 on load
// (x_ref[...].astype(jnp.float32)), this one reads float32 or float64 and
// rounds each float64 value to float32 on load (__double2float_rn, the
// rounding of Tensor.to(torch.float32)); it writes float32, or float64
// widened exactly, as the caller asks.  The coder hands it its float64 grid
// and takes float64 coefficients back in one launch, with no cast pass on
// either side.
//
// transform_axis_f64 has no TPU counterpart: it is the float64 product the
// JAX package's coder computes with numpy on the host
// (src/repro/core/transform.py:92, _apply_axis), done on the card so the
// coder's verification stays on the card.  It applies a 4x4 matrix along one
// axis of a contiguous array viewed as (outer, len, inner).
//
// Both are bound by device memory: 16 multiplies and 12 adds per 4 values
// and axis, against 8 to 16 bytes read and written per value.
//   * transform_rotate: a warp takes a strip of 4 rows x 128 columns ("2d":
//     32 4x4 blocks side by side; "1d": 4 runs of 32 4-groups), each lane
//     one 4x4 block or four 4-groups.  A float32 row of the strip is one
//     16-byte load per lane, 512 contiguous bytes per warp; a float64 row is
//     two such loads per lane, each 512 contiguous bytes, and lanes 2i and
//     2i+1 trade halves with one shuffle so that each holds a whole 4-group
//     (groups i and 16 + i); float64 stores trade back the same way.  The
//     grid is sized to the card (SMs x resident blocks, from the occupancy
//     API), each warp walks strips warp, warp + warps, ..., and it issues the
//     next strip's loads before it rotates and stores the current one, so
//     loads stay in flight through the arithmetic and the last wave is no
//     half-empty card of fresh warps.  Products stay in registers; no
//     shared memory.
//   * transform_axis_f64: one thread per group of 4 along the axis and
//     position in the inner dimension; neighbouring threads own neighbouring
//     inner positions (or, for the last axis, neighbouring groups).
//
// Rounding, as written, so that each kernel equals its plain version
// (../ref.py and numpy) bit for bit:
//   * transform_rotate: float64 inputs rounded to float32 first; every
//     output is ((m0*b0 + m1*b1) + m2*b2) + m3*b3 with __fmul_rn /
//     __fadd_rn, which the compiler never contracts into an FMA; a float64
//     output is the float32 result widened, which is exact.
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

struct Mat4f {
  float m[16];  // row-major: m[4 * k + j] multiplies input j into output k
};

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

// ---- transform_rotate ------------------------------------------------------

constexpr int kWarps = 8;  // warps per thread block of transform_rotate
constexpr int kRotateThreads = 32 * kWarps;
constexpr int kStripGroups = 32;  // 4-groups in a row of a strip: 128 values
constexpr unsigned kFull = 0xffffffffu;

// The 4-group of a strip row that lane l holds: lanes 2i and 2i+1 hold
// groups i and 16 + i, so that a float64 row loads and stores as two
// coalesced halves (see Row<double>).
__device__ __forceinline__ int owned_group(int lane) {
  return (lane & 1) ? kStripGroups / 2 + (lane >> 1) : (lane >> 1);
}

// One strip row's raw values in a lane: load() issues the loads, value()
// rounds them to the lane's 4-group in float32.  `valid` is how many of the
// row's 32 groups exist (the last column strip of a row, the end of "1d").
template <typename T>
struct Row;

template <>
struct Row<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* row, int lane, int valid) {
    const int g = owned_group(lane);
    v = g < valid ? __ldcs(reinterpret_cast<const float4*>(row) + g) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float4 value(int) const { return v; }
};

template <>
struct Row<double> {
  // the row's double2 number lane and 32 + lane: half (lane & 1) of groups
  // lane >> 1 and 16 + (lane >> 1)
  double2 lo, hi;
  __device__ __forceinline__ void load(const double* row, int lane, int valid) {
    const double2* r = reinterpret_cast<const double2*>(row);
    lo = lane < 2 * valid ? __ldcs(r + lane) : make_double2(0.0, 0.0);
    hi = kStripGroups + lane < 2 * valid ? __ldcs(r + kStripGroups + lane) : make_double2(0.0, 0.0);
  }
  // every lane of the warp calls this together (a shuffle)
  __device__ __forceinline__ float4 value(int lane) const {
    const bool odd = lane & 1;
    const double2 send = odd ? lo : hi;
    const double2 recv = make_double2(__shfl_xor_sync(kFull, send.x, 1), __shfl_xor_sync(kFull, send.y, 1));
    const double2 a = odd ? recv : lo;  // first half of the owned group
    const double2 b = odd ? hi : recv;  // second half
    return make_float4(__double2float_rn(a.x), __double2float_rn(a.y), __double2float_rn(b.x),
                       __double2float_rn(b.y));
  }
};

// Store the lane's rotated 4-group into a strip row; every lane of the warp
// calls it together (the float64 store trades halves back with a shuffle).
__device__ __forceinline__ void store_row(float* row, int lane, int valid, float4 o) {
  const int g = owned_group(lane);
  if (g < valid) reinterpret_cast<float4*>(row)[g] = o;
}

__device__ __forceinline__ void store_row(double* row, int lane, int valid, float4 o) {
  const bool odd = lane & 1;
  const float2 h0 = make_float2(o.x, o.y), h1 = make_float2(o.z, o.w);
  const float2 send = odd ? h0 : h1;
  const float2 recv = make_float2(__shfl_xor_sync(kFull, send.x, 1), __shfl_xor_sync(kFull, send.y, 1));
  const float2 lo = odd ? recv : h0;  // half (lane & 1) of group lane >> 1
  const float2 hi = odd ? h1 : recv;  // half (lane & 1) of group 16 + (lane >> 1)
  double2* r = reinterpret_cast<double2*>(row);
  if (lane < 2 * valid) r[lane] = make_double2(lo.x, lo.y);
  if (kStripGroups + lane < 2 * valid) r[kStripGroups + lane] = make_double2(hi.x, hi.y);
}

// The strips of an (R, C) grid: "2d", the 32 blocks of column strip cs in
// block row br (strip number br * col_strips + cs); "1d", 4 consecutive runs
// of 32 groups.  A warp walks strips warp, warp + warps, ...; `step_rows`
// and `step_cols` are that stride in block rows and column strips ("1d":
// step_cols is the stride in strips).
struct Strips {
  int64_t cols, cols4, col_strips, groups, count, step_rows, step_cols;
  bool two_d;

  Strips(int64_t rows, int64_t cols_, bool two_d_) : cols(cols_), cols4(cols_ / 4), two_d(two_d_) {
    col_strips = (cols4 + kStripGroups - 1) / kStripGroups;
    groups = rows * cols4;
    count = two_d ? (rows / 4) * col_strips : (groups + 4 * kStripGroups - 1) / (4 * kStripGroups);
    step_rows = step_cols = 0;
  }
  void set_stride(int64_t warps) {
    step_rows = two_d ? warps / col_strips : 0;
    step_cols = two_d ? warps % col_strips : warps;
  }
};

// One strip's place: where its row 0 starts (in values), how far apart its
// rows are, and how many of each row's groups exist; next() moves to the
// warp's following strip with no division.
struct StripAt {
  int64_t br, cs;  // "1d": cs is the strip number
  __device__ __forceinline__ StripAt(const Strips& st, int64_t s) {
    br = st.two_d ? s / st.col_strips : 0;
    cs = st.two_d ? s - br * st.col_strips : s;
  }
  __device__ __forceinline__ StripAt next(const Strips& st) const {
    StripAt n = *this;
    n.br += st.step_rows;
    n.cs += st.step_cols;
    if (st.two_d && n.cs >= st.col_strips) {
      n.cs -= st.col_strips;
      ++n.br;
    }
    return n;
  }
  __device__ __forceinline__ int64_t row_first(const Strips& st, int j) const {
    return st.two_d ? (4 * br + j) * st.cols + cs * 4 * kStripGroups
                    : (4 * cs + j) * 4 * kStripGroups;
  }
  __device__ __forceinline__ int valid(const Strips& st, int j) const {
    const int64_t v = st.two_d ? st.cols4 - cs * kStripGroups : st.groups - (4 * cs + j) * kStripGroups;
    return static_cast<int>(v < 0 ? 0 : (v < kStripGroups ? v : kStripGroups));
  }
};

template <typename In>
__device__ __forceinline__ void load_strip(const In* __restrict__ x, const Strips& st, const StripAt& at,
                                           int lane, Row<In> (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j].load(x + at.row_first(st, j), lane, at.valid(st, j));
}

template <typename In, typename Out, bool kTwoD>
__global__ void __launch_bounds__(kRotateThreads)
rotate_kernel(const In* __restrict__ x, Out* __restrict__ out, Strips st, Mat4f mat) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  if (warp >= st.count) return;
  Row<In> cur[4], next[4];
  StripAt at(st, warp);
  load_strip(x, st, at, lane, cur);
  for (int64_t s = warp; s < st.count; s += warps) {
    const StripAt after = at.next(st);
    if (s + warps < st.count) load_strip(x, st, after, lane, next);  // in flight meanwhile
    float4 t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = rotate4(mat, cur[j].value(lane));  // last axis first
    if constexpr (kTwoD) {  // then down the rows, column by column
      float4 o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = make_float4(dot4(mat, k, t[0].x, t[1].x, t[2].x, t[3].x),
                           dot4(mat, k, t[0].y, t[1].y, t[2].y, t[3].y),
                           dot4(mat, k, t[0].z, t[1].z, t[2].z, t[3].z),
                           dot4(mat, k, t[0].w, t[1].w, t[2].w, t[3].w));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] = o[k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) store_row(out + at.row_first(st, j), lane, at.valid(st, j), t[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = next[j];
    at = after;
  }
}

// Thread blocks for a launch over `strips` strips: one warp each, at most as
// many blocks as the card holds at once.  The count is taken once per device
// and kernel (a race writes the same value twice).
template <auto Kernel>
unsigned persistent_grid(int64_t strips) {
  static int64_t resident_of[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t resident = dev < 64 ? resident_of[dev] : 0;
  if (resident == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kRotateThreads, 0);
    resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident_of[dev] = resident;
  }
  const int64_t needed = (strips + kWarps - 1) / kWarps;
  return static_cast<unsigned>(needed < resident ? needed : resident);
}

template <auto Kernel, typename In, typename Out>
void launch_on(const void* x, void* out, Strips st, const Mat4f& mat, cudaStream_t s) {
  const unsigned grid = persistent_grid<Kernel>(st.count);
  st.set_stride(static_cast<int64_t>(grid) * kWarps);
  Kernel<<<grid, kRotateThreads, 0, s>>>(static_cast<const In*>(x), static_cast<Out*>(out), st, mat);
}

template <typename In, typename Out>
void launch_rotate(const void* x, void* out, const Strips& st, const Mat4f& mat, cudaStream_t s) {
  if (st.two_d) {
    launch_on<rotate_kernel<In, Out, true>, In, Out>(x, out, st, mat, s);
  } else {
    launch_on<rotate_kernel<In, Out, false>, In, Out>(x, out, st, mat, s);
  }
}

// ---- transform_axis_f64 ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int64_t kMaxGrid = 1 << 16;  // cap for grid-stride launches

struct Mat4d {
  double m[16];
};

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
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

// (rows, cols), cols % 4 == 0 (and rows % 4 == 0 when two_d), contiguous,
// both pointers 16-byte aligned; x float64 when in_f64 else float32, out
// float64 when out_f64 else float32; m_host: 16 floats, row-major, read at
// launch.
int transform_rotate(const void* x, void* out, int64_t rows, int64_t cols, const float* m_host,
                     int two_d, int in_f64, int out_f64, void* stream) {
  Mat4f mat;
  for (int i = 0; i < 16; ++i) mat.m[i] = m_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strips st(rows, cols, two_d != 0);
  if (st.count > 0) {
    if (in_f64 && out_f64) {
      launch_rotate<double, double>(x, out, st, mat, s);
    } else if (in_f64) {
      launch_rotate<double, float>(x, out, st, mat, s);
    } else if (out_f64) {
      launch_rotate<float, double>(x, out, st, mat, s);
    } else {
      launch_rotate<float, float>(x, out, st, mat, s);
    }
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
