// Sum-mode embedding bag (kernel B2) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas.
//
//   out[b, :] = sum over l of w[b, l] * table[clip(idx[b, l], 0, V-1), :]
//               for the l with idx[b, l] < V   (an id >= V is inert)
//
//   table  (V, d)   float32 or bfloat16, rows `ld` elements apart, unit
//                   column stride
//   idx    (B, L)   int32 or int64, any strides
//   w      (B, L)   float32, any strides, or null for ones
//   out    (B, d)   the table's dtype, contiguous
//
// Bound: bytes. A call must read each id once, each distinct valid row
// once and write the output once; there is one multiply-add per id and
// column, far below the card's arithmetic rate. MIND's lookups are
// one-id bags (L = 1), so the output (4 B per id and column) dominates.
//
// Design. The TPU kernel tiles the vocabulary through VMEM and turns the
// gather into a one-hot matrix product, and its wrapper pads V to 512, B
// to 8 and d to 128 (twice MIND's bytes at d = 64). Here rows are read
// by index directly and nothing is padded:
//   - one group of G = min(ceil(d / kVec), kThreads) threads owns one
//     bag, kVec = 16 / sizeof(T) columns per thread (4 float32, 8
//     bfloat16), so several bags share a warp when d <= 64 (float32);
//     for d > G * kVec a thread walks further column chunks;
//   - each thread keeps a float32 accumulator for its chunk, walks the
//     bag's L ids, skips an id >= V without reading its row, clips an id
//     < 0 to row 0 (as the reference's clip does), multiplies by the
//     weight when there is one, and writes its chunk in the table's dtype;
//   - a full chunk at a 16-byte aligned address is one 16-byte load (and
//     one 16-byte store); a partial chunk (d % kVec != 0) or an unaligned
//     row (odd d, a table view at an odd offset) goes value by value;
//   - every offset is 64-bit: MIND's 10M x 64 float32 table is 2.56 GB
//     and its serve_bulk output 838,860,800 values.
// The launch geometry is computed by the wrapper (kernel.py::geometry),
// which the CPU tests hold against a torch emulation of this loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes at a 16-byte aligned p into v[0..kVec)
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // the lower half holds the first value
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    words[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
               ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1]))
                << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2],
                                            words[3]);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, long long V, long long ld,
                     const I* __restrict__ idx, long long idx_sb,
                     long long idx_sl, const float* __restrict__ w,
                     long long w_sb, long long w_sl, T* __restrict__ out,
                     long long B, int L, int d, int group) {
  constexpr int kVec = 16 / sizeof(T);
  const int bags_per_block = kThreads / group;
  const int slot = threadIdx.x / group;
  const int t = threadIdx.x - slot * group;
  if (slot >= bags_per_block) return;
  const long long b = (long long)blockIdx.x * bags_per_block + slot;
  if (b >= B) return;
  const I* bag_idx = idx + b * idx_sb;
  const float* bag_w = w == nullptr ? nullptr : w + b * w_sb;
  T* out_row = out + b * (long long)d;

  for (int c0 = t * kVec; c0 < d; c0 += group * kVec) {
    const bool full = c0 + kVec <= d;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    for (int l = 0; l < L; ++l) {
      long long id = (long long)bag_idx[(long long)l * idx_sl];
      if (id >= V) continue;                 // pad: its row is never read
      if (id < 0) id = 0;
      const T* row = table + id * ld + c0;
      float v[kVec];
      if (full && aligned16(row)) {
        load16(row, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          v[j] = c0 + j < d ? to_float(row[j]) : 0.0f;
        }
      }
      if (bag_w != nullptr) {
        const float wt = bag_w[(long long)l * w_sl];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = fmaf(wt, v[j], acc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += v[j];
      }
    }
    T* o = out_row + c0;
    if (full && aligned16(o)) {
      store16(o, acc);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (c0 + j < d) store_one(o + j, acc[j]);
      }
    }
  }
}

// The launch's arguments, packed as int64 by kernel.py::launch_args in
// this order (tests/test_torch_embedding_bag.py reads this list).
enum Arg {
  kTableBf16,   // 0 float32, 1 bfloat16
  kIdx64,       // 0 int32, 1 int64
  kTable,       // (V, d), rows ld elements apart
  kV,
  kLd,
  kIdx,         // (B, L), strides idx_sb, idx_sl (elements)
  kIdxSb,
  kIdxSl,
  kW,           // (B, L) float32, strides w_sb, w_sl, or 0 for ones
  kWSb,
  kWSl,
  kOut,         // (B, d) contiguous, the table's dtype
  kB,
  kL,
  kD,
  kGroup,       // threads per bag (kernel.py::geometry)
  kBlocks,      // blocks of kThreads
  kNumArgs
};

template <typename T, typename I>
cudaError_t launch(const long long* a, cudaStream_t stream) {
  const long long B = a[kB], blocks = a[kBlocks];
  const int d = (int)a[kD], group = (int)a[kGroup];
  if (B <= 0 || d <= 0) return cudaSuccess;
  if (group < 1 || group > kThreads || blocks < 1 || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  embedding_bag_kernel<T, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(a[kTable]), a[kV], a[kLd],
      reinterpret_cast<const I*>(a[kIdx]), a[kIdxSb], a[kIdxSl],
      reinterpret_cast<const float*>(a[kW]), a[kWSb], a[kWSl],
      reinterpret_cast<T*>(a[kOut]), B, (int)a[kL], d, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: kNumArgs int64 values in the order of enum Arg (w may be 0: weights
// of one). Returns the cudaError_t of the launch.
int embedding_bag_fwd(const long long* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (a[kTableBf16]) {
    err = a[kIdx64] ? launch<__nv_bfloat16, long long>(a, s)
                    : launch<__nv_bfloat16, int>(a, s);
  } else {
    err = a[kIdx64] ? launch<float, long long>(a, s)
                    : launch<float, int>(a, s);
  }
  return (int)err;
}

}  // extern "C"
