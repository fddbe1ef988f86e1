// Huffman stream pack for Hopper (sm_90a), with a plain C interface for ctypes.
//
// It replaces no TPU kernel: the JAX package writes its Huffman streams on
// the host in numpy (src/repro/core/encoders.py), and so did the port
// (core/encoders.py, _encode_stream and _pack_codes).  It replaces that host
// numpy pack where the quantization codes already lie on the card, as the
// Lorenzo kernels leave them: the host pack made about eight fresh arrays of
// n elements, most of them int64, and was most of a compress.  It writes
// the same stream bytes, sync table and bit count as _encode_stream (the
// contract is stated in ../ref.py).
//
// Bound: bytes.  Each code is read once (4 or 8 B) and the stream written
// once (its length in bits / 8, under 2 B a code), beside one gather a code
// from a table of at most 2^22 entries whose used part, the quantizer's
// codes near its radius, stays in L1 and L2.
//
// Design: one launch, a chained scan with decoupled look-back (Merrill &
// Garland 2016; decode_1d_lookback_kernel in ../../lorenzo/csrc/lorenzo.cu)
// over segments of 1024 codes, the stream's sync interval, so a segment's
// exclusive prefix is exactly its sync offset.
//   * A block takes the next segment from a global counter, so it only ever
//     waits on segments that already started.  Its 256 threads load 4
//     consecutive codes each (one 16-byte load for int32, two for int64),
//     look up (code << 8) | length per value and scan the lengths across
//     the block: each code's bit offset within the segment.
//   * Warp 0 publishes the segment's bit count at once ({flag, value} in
//     one 64-bit word) and walks back 32 predecessors per round until one
//     holds an inclusive prefix; the other warps meanwhile OR their codes
//     into the segment's words in shared memory (at most 1024 x 16 bits =
//     256 words), laid out from the segment's bit 0.
//   * Once the prefix P is known, output word k is shared words k and k - 1
//     shifted by P mod 64, stored byte-swapped so that the buffer reads as
//     the big-endian byte stream.  Interior words are plain coalesced
//     stores; the first and last word, which the segment may share with its
//     neighbours, are one 64-bit atomicOr each into the zeroed buffer.  No
//     global atomic is taken per code.
//   * A value outside the table, or one whose entry has length 0 (not in
//     the alphabet) or above 16, sets a flag that the wrapper raises on.
//
// The entry point launches on the given stream, allocates nothing (the
// caller passes the output and the scratch, both zeroed here first) and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                        // codes per thread
constexpr int kSegment = kThreads * kItems;      // codes per segment: the stream's sync interval
constexpr int kMaxLen = 16;                      // longest code (encoders._MAXLEN)
constexpr int kSegWords = kSegment * kMaxLen / 64;  // most 64-bit words a segment's bits fill

// Status word of a segment: flag in the top two bits, bit count below.
constexpr u64 kFlagAggregate = 1ull << 62, kFlagInclusive = 2ull << 62;
constexpr u64 kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive scan of one value per thread across the block; *total gets the
// block's sum.
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    w = warp_inclusive_scan(w);
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t prefix = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[kWarps - 1];
  return prefix + inc - v;
}

// Segment t's status word: 32 interleaved runs of `stride` words (a multiple
// of 16), so the 32 predecessors of one look-back round lie on 32 lines.
__device__ __forceinline__ int64_t status_slot(int64_t t, int64_t stride) {
  return (t & 31) * stride + (t >> 5);
}

__device__ __forceinline__ void publish(u64* status, int64_t slot, u64 word) {
  *reinterpret_cast<volatile u64*>(status + slot) = word;
}

// Warp 0 of the block: the bits of every segment before `seg`.  Publishes
// the segment's aggregate first, its inclusive prefix last.
__device__ u64 look_back(u64* status, int64_t stride, int64_t seg, u64 aggregate) {
  const int lane = threadIdx.x & 31;
  if (seg == 0) {
    if (lane == 0) publish(status, status_slot(0, stride), kFlagInclusive | aggregate);
    return 0;
  }
  if (lane == 0) publish(status, status_slot(seg, stride), kFlagAggregate | aggregate);
  u64 exclusive = 0;
  for (int64_t base = seg - 1;; base -= 32) {
    const int64_t p = base - lane;  // lane l: the (l+1)-th nearest predecessor
    u64 flag = kFlagInclusive, value = 0;  // before the stream's start: nothing to add
    if (p >= 0) {
      const volatile u64* w = status + status_slot(p, stride);
      u64 v;
      do {  // until the predecessor has published
        v = *w;
        flag = v & ~kValueMask;
      } while (flag == 0);
      value = v & kValueMask;
    }
    const unsigned incl = __ballot_sync(0xffffffffu, flag == kFlagInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;  // the nearest inclusive predecessor
    u64 x = lane <= stop ? value : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    exclusive += x;
    if (incl) break;
  }
  if (lane == 0) publish(status, status_slot(seg, stride), kFlagInclusive | (exclusive + aggregate));
  return exclusive;
}

__device__ __forceinline__ u64 bswap64(u64 x) {
  const uint32_t hi = __byte_perm(static_cast<uint32_t>(x >> 32), 0u, 0x0123);
  const uint32_t lo = __byte_perm(static_cast<uint32_t>(x), 0u, 0x0123);
  return (static_cast<u64>(lo) << 32) | hi;
}

// This thread's kItems codes at segment offset j, zeros at and past n_here.
// kVec: the segment starts 16-byte aligned (values 16-byte aligned).
template <typename T, bool kVec>
__device__ __forceinline__ void load_values(const T* __restrict__ src, int j, int n_here,
                                            int64_t (&v)[kItems]) {
  if (kVec && j + kItems <= n_here) {
    if constexpr (sizeof(T) == 4) {
      const int4 w = *reinterpret_cast<const int4*>(src + j);
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    } else {
      const longlong2 a = *reinterpret_cast<const longlong2*>(src + j);
      const longlong2 b = *reinterpret_cast<const longlong2*>(src + j + 2);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = b.x;
      v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] = j + k < n_here ? static_cast<int64_t>(src[j + k]) : 0;
  }
}

// meta: [0] the stream's bit count (written by the last segment), [1] the
// fault flag, [2] the segment counter (as unsigned).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
huffman_pack_kernel(const T* __restrict__ values, int64_t n, const uint32_t* __restrict__ table,
                    int64_t table_size, u64* __restrict__ words, int64_t* __restrict__ sync,
                    u64* __restrict__ status, int64_t stride, int64_t* meta) {
  // s_words[1 + k] holds the segment's bits 64k .. 64k + 63; s_words[0] and
  // s_words[kSegWords + 1] stay zero for the shifted stores at both ends
  __shared__ u64 s_words[kSegWords + 2];
  __shared__ int64_t s_seg;
  __shared__ u64 s_prefix;
  if (threadIdx.x == 0) s_seg = atomicAdd(reinterpret_cast<unsigned*>(meta + 2), 1u);
  for (int k = threadIdx.x; k < kSegWords + 2; k += kThreads) s_words[k] = 0;
  __syncthreads();
  const int64_t seg = s_seg;
  const int64_t base = seg * kSegment;
  const int n_here = static_cast<int>(n - base < kSegment ? n - base : kSegment);
  const int j0 = threadIdx.x * kItems;
  int64_t v[kItems];
  load_values<T, kVec>(values + base, j0, n_here, v);
  uint32_t code[kItems], len[kItems];
  uint32_t bits = 0;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    code[k] = 0u;
    len[k] = 0u;
    if (j0 + k < n_here) {
      if (v[k] < 0 || v[k] >= table_size) {
        bad = true;
      } else {
        const uint32_t e = __ldg(table + v[k]);
        const uint32_t l = e & 0xffu;
        if (l == 0u || l > kMaxLen) {
          bad = true;
        } else {
          len[k] = l;
          code[k] = e >> 8;
        }
      }
    }
    bits += len[k];
  }
  if (bad) *reinterpret_cast<volatile int64_t*>(meta + 1) = 1;
  uint32_t total;
  const uint32_t within = block_exclusive_scan(bits, &total);
  if (threadIdx.x < 32) {
    const u64 ex = look_back(status, stride, seg, total);
    if (threadIdx.x == 0) s_prefix = ex;
  }
  // this thread's codes into the segment's words, MSB first from bit `within`
  uint32_t pos = within;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (len[k]) {
      const int w = 1 + static_cast<int>(pos >> 6);
      const int r = 64 - static_cast<int>(pos & 63u) - static_cast<int>(len[k]);  // in [-15, 63]
      const u64 c = code[k];
      if (r >= 0) {
        atomicOr(&s_words[w], c << r);
      } else {
        atomicOr(&s_words[w], c >> -r);
        atomicOr(&s_words[w + 1], c << (64 + r));
      }
      pos += len[k];
    }
  }
  __syncthreads();
  const u64 prefix = s_prefix;
  const int ph = static_cast<int>(prefix & 63u);
  const int64_t w0 = static_cast<int64_t>(prefix >> 6);
  const int nout = (ph + static_cast<int>(total) + 63) >> 6;  // output words the segment touches
  for (int k = threadIdx.x; k < nout; k += kThreads) {
    u64 x = s_words[1 + k] >> ph;
    if (ph) x |= s_words[k] << (64 - ph);
    x = bswap64(x);
    if (k == 0 || k == nout - 1) {
      if (x) atomicOr(words + w0 + k, x);  // shared with a neighbour
    } else {
      words[w0 + k] = x;
    }
  }
  if (threadIdx.x == 0) {
    sync[seg] = static_cast<int64_t>(prefix);
    if (base + n_here == n) meta[0] = static_cast<int64_t>(prefix + total);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t status_stride(int64_t segments) { return ceil_div(ceil_div(segments, 32), 16) * 16; }

template <typename T>
void launch(const void* values, int64_t n, const uint32_t* table, int64_t table_size, u64* words,
            int64_t* sync, u64* status, int64_t stride, int64_t* meta, cudaStream_t s) {
  const T* v = static_cast<const T*>(values);
  const unsigned blocks = static_cast<unsigned>(ceil_div(n, kSegment));
  if (reinterpret_cast<uintptr_t>(values) % 16 == 0) {
    huffman_pack_kernel<T, true><<<blocks, kThreads, 0, s>>>(v, n, table, table_size, words, sync,
                                                             status, stride, meta);
  } else {
    huffman_pack_kernel<T, false><<<blocks, kThreads, 0, s>>>(v, n, table, table_size, words, sync,
                                                              status, stride, meta);
  }
}

}  // namespace

extern "C" {

// int64 words of scratch for n codes: the status words, then meta.
int64_t huffman_pack_scratch_words(int64_t n) {
  return 32 * status_stride(ceil_div(n, kSegment)) + 4;
}

// values: n int32 (elem_bytes 4) or int64 (8) codes; table: table_size
// entries (code << 8) | length; words: n_words >= ceil(n / 4) outputs;
// sync: ceil(n / 1024) offsets; scratch: huffman_pack_scratch_words(n).
// Afterwards scratch holds, from 4 words before its end, the bit count and
// the fault flag.
int huffman_pack(const void* values, int elem_bytes, int64_t n, const uint32_t* table,
                 int64_t table_size, u64* words, int64_t n_words, int64_t* sync, int64_t* scratch,
                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t segments = ceil_div(n, kSegment);
  if (segments >= (int64_t{1} << 31) || n_words < ceil_div(n, 4) || (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t stride = status_stride(segments);
  cudaError_t err = cudaMemsetAsync(words, 0, n_words * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, huffman_pack_scratch_words(n) * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* status = reinterpret_cast<u64*>(scratch);
  int64_t* meta = scratch + 32 * stride;
  if (elem_bytes == 4) {
    launch<int32_t>(values, n, table, table_size, words, sync, status, stride, meta, s);
  } else {
    launch<int64_t>(values, n, table, table_size, words, sync, status, stride, meta, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
