// Sum-mode embedding bag (kernel B2) for NVIDIA Hopper (sm_90a), and its
// backward B2-bwd (the second half of the file, with its own note).
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


// ------------------------------------------------------------- backward
// B2-bwd: the gradient of the bag sums with respect to the table.
//
//   grad[r, :] = sum over the entries (b, l) with clip(idx[b, l]) == r and
//                idx[b, l] < V of w[b, l] * dout[b, :];  zero elsewhere
//
// Replaces no TPU kernel: the JAX package differentiates its XLA lookup
// (take + clip + mask). MIND's training step needs it for every table
// gradient, dense in (V, d) as the reference's optimizer reads it.
//
// Bound: bytes. A call must read each valid entry's dout row once, each id
// once, and write the (V, d) gradient once; at MIND's train_batch the
// gradient (2.56 GB) dominates.
//
// Design: deterministic, no float atomics. The wrapper sorts the entries
// stably by key (the row an entry reads; pads get the key V and sort
// last), so each row's entries form one run, in entry order. Then:
//   - bwd_chunk_kernel: one group of threads (kernel.py::geometry) walks
//     one fixed-size chunk of the sorted stream with a float32
//     accumulator per 16-byte column chunk, w * dout rounded before the
//     add (__fmul_rn, __fadd_rn: the CPU emulation's bits). A run that
//     lies inside the chunk is written to its row directly; a run that
//     crosses chunk edges leaves a partial: the chunk's first run, when it
//     began in an earlier chunk, in the chunk's "head" slot, and its last
//     run, when it goes on into the next chunk, in its "tail" slot. Every
//     row it sees gets its `present` byte set.
//   - bwd_combine_kernel: the chunk whose tail starts a crossing run adds
//     the following chunks' head partials to it in chunk order (eight
//     loads in flight at a time) and writes the row. A row of 300k entries
//     at chunk 256 is 1,172 chunks summed in parallel, then 1,171 adds.
//   - bwd_zero_kernel: writes zeros to every row whose `present` byte is
//     unset, so each gradient row is written once.
// The same inputs give the same bits on every call: no step depends on
// the order in which blocks run.

// one float32 chunk of kVec columns at c0 (elementwise: partials are
// float32 whatever T is, and their rows need not be 16-byte aligned)
template <int kVec>
__device__ __forceinline__ void store_f32(float* p, const float* v, int c0,
                                          int d) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (c0 + j < d) p[j] = v[j];
  }
}

template <typename T>
__device__ __forceinline__ void write_chunk(T* p, const float* v, int c0,
                                            int d) {
  constexpr int kVec = 16 / sizeof(T);
  if (c0 + kVec <= d && aligned16(p)) {
    store16(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (c0 + j < d) store_one(p + j, v[j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void read_chunk(const T* p, float* v, int c0,
                                           int d) {
  constexpr int kVec = 16 / sizeof(T);
  if (c0 + kVec <= d && aligned16(p)) {
    load16(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = c0 + j < d ? to_float(p[j]) : 0.0f;
    }
  }
}

// the group and chunk of a thread: false when its slot holds no chunk
struct Slot {
  long long c;    // chunk (or row, for the zero kernel)
  int t;          // thread within the group
};

__device__ __forceinline__ bool slot_of(int group, Slot* s) {
  const int per_block = kThreads / group;
  const int slot = threadIdx.x / group;
  if (slot >= per_block) return false;
  s->t = threadIdx.x - slot * group;
  s->c = (long long)blockIdx.x * per_block + slot;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_kernel(const T* __restrict__ dout, const int* __restrict__ keys,
                 const long long* __restrict__ perm,
                 const float* __restrict__ w, long long L, long long n,
                 long long V, int d, int group, int chunk,
                 T* __restrict__ grad, unsigned char* __restrict__ present,
                 float* __restrict__ partials) {
  constexpr int kVec = 16 / sizeof(T);
  Slot sl;
  if (!slot_of(group, &sl)) return;
  const long long s = sl.c * chunk;
  if (s >= n) return;
  const long long e_end = min(s + (long long)chunk, n);
  const int first = keys[s];
  if (first >= V) return;                    // pads only: they sort last
  const bool head_continues = s > 0 && keys[s - 1] == first;
  const int last = keys[e_end - 1];
  const bool tail_continues = last < V && e_end < n && keys[e_end] == last;
  float* head = partials + sl.c * 2 * (long long)d;
  float* tail = head + d;

  for (int c0 = sl.t * kVec; c0 < d; c0 += group * kVec) {
    const bool mark = c0 == sl.t * kVec && sl.t == 0;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    int run_key = first;
    long long run_start = s;
    long long e = s;
    for (; e < e_end; ++e) {
      const int k = keys[e];
      if (k >= V) break;
      if (k != run_key) {                    // the run [run_start, e) ends
        if (run_start == s && head_continues) {
          store_f32<kVec>(head + c0, acc, c0, d);
        } else {
          write_chunk(grad + (long long)run_key * d + c0, acc, c0, d);
        }
        if (mark) present[run_key] = 1;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
        run_key = k;
        run_start = e;
      }
      const long long p = perm[e];
      float v[kVec];
      read_chunk(dout + (p / L) * d + c0, v, c0, d);
      if (w != nullptr) {
        const float wt = w[p];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(wt, v[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
      }
    }
    // the last run, [run_start, e)
    if (run_start == s && head_continues) {
      store_f32<kVec>(head + c0, acc, c0, d);
    } else if (e == e_end && tail_continues) {
      store_f32<kVec>(tail + c0, acc, c0, d);
    } else {
      write_chunk(grad + (long long)run_key * d + c0, acc, c0, d);
    }
    if (mark) present[run_key] = 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_combine_kernel(const int* __restrict__ keys, long long n, long long V,
                   int d, int group, int chunk,
                   const float* __restrict__ partials, T* __restrict__ grad) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kAhead = 8;
  Slot sl;
  if (!slot_of(group, &sl)) return;
  const long long s = sl.c * chunk;
  if (s >= n) return;
  const long long e_end = min(s + (long long)chunk, n);
  const int last = keys[e_end - 1];
  if (last >= V || e_end >= n || keys[e_end] != last) return;
  // a chunk that is one piece of a run begun earlier holds a head partial
  if (s > 0 && keys[s] == last && keys[s - 1] == last) return;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const long long stride = 2 * (long long)d;
  for (int c0 = sl.t * kVec; c0 < d; c0 += group * kVec) {
    float acc[kVec];
    const float* tail = partials + sl.c * stride + d + c0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = c0 + j < d ? tail[j] : 0.0f;
    long long k = sl.c + 1;
    bool go = true;
    while (go) {
      float v[kAhead][kVec];
      bool more[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const long long kk = k + a;
        const bool in = kk < n_chunks;
        const float* head = partials + kk * stride + c0;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          v[a][j] = in && c0 + j < d ? head[j] : 0.0f;
        }
        const long long end = min((kk + 1) * chunk, n);
        more[a] = in && end < n && keys[end] == last;
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (go) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], v[a][j]);
          go = more[a];
        }
      }
      k += kAhead;
    }
    write_chunk(grad + (long long)last * d + c0, acc, c0, d);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_zero_kernel(const unsigned char* __restrict__ present, long long V,
                int d, int group, T* __restrict__ grad) {
  constexpr int kVec = 16 / sizeof(T);
  Slot sl;
  if (!slot_of(group, &sl)) return;
  const long long rows_per_grid = (long long)gridDim.x * (kThreads / group);
  float zero[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) zero[j] = 0.0f;
  for (long long r = sl.c; r < V; r += rows_per_grid) {
    if (present[r]) continue;
    for (int c0 = sl.t * kVec; c0 < d; c0 += group * kVec) {
      write_chunk(grad + r * d + c0, zero, c0, d);
    }
  }
}

// The backward launch's arguments, packed as int64 by
// kernel.py::bwd_launch_args in this order.
enum BwdArg {
  kBTableBf16,  // 0 float32, 1 bfloat16: dout's and grad's dtype
  kBDout,       // (B, d) contiguous
  kBKeys,       // (n,) int32 sorted keys, pads = V
  kBPerm,       // (n,) int64 entry positions b * L + l
  kBW,          // (B, L) float32 contiguous, or 0 for ones
  kBL,
  kBN,          // entries: B * L
  kBV,
  kBD,
  kBGrad,       // (V, d) contiguous
  kBPresent,    // (V,) uint8, zeroed
  kBPartials,   // (chunks, 2, d) float32
  kBChunk,      // entries per chunk
  kBGroup,      // threads per chunk or row (kernel.py::geometry)
  kBChunkBlocks,
  kBZeroBlocks,
  kBNumArgs
};

template <typename T>
cudaError_t launch_bwd(const long long* a, cudaStream_t stream) {
  const long long n = a[kBN], V = a[kBV];
  const int d = (int)a[kBD], group = (int)a[kBGroup];
  const int chunk = (int)a[kBChunk];
  const long long cb = a[kBChunkBlocks], zb = a[kBZeroBlocks];
  if (V <= 0 || d <= 0) return cudaSuccess;
  if (group < 1 || group > kThreads || chunk < 1 || zb < 1 ||
      zb > 0x7fffffffLL || cb > 0x7fffffffLL || (n > 0 && cb < 1)) {
    return cudaErrorInvalidValue;
  }
  const int* keys = reinterpret_cast<const int*>(a[kBKeys]);
  float* partials = reinterpret_cast<float*>(a[kBPartials]);
  T* grad = reinterpret_cast<T*>(a[kBGrad]);
  unsigned char* present = reinterpret_cast<unsigned char*>(a[kBPresent]);
  if (n > 0) {
    bwd_chunk_kernel<T><<<(unsigned)cb, kThreads, 0, stream>>>(
        reinterpret_cast<const T*>(a[kBDout]), keys,
        reinterpret_cast<const long long*>(a[kBPerm]),
        reinterpret_cast<const float*>(a[kBW]), a[kBL], n, V, d, group,
        chunk, grad, present, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_combine_kernel<T><<<(unsigned)cb, kThreads, 0, stream>>>(
        keys, n, V, d, group, chunk, partials, grad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bwd_zero_kernel<T><<<(unsigned)zb, kThreads, 0, stream>>>(present, V, d,
                                                             group, grad);
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

// a: kBNumArgs int64 values in the order of enum BwdArg. Launches the
// chunk, combine and zero kernels in that order on `stream`; returns the
// first cudaError_t that is not cudaSuccess.
int embedding_bag_bwd(const long long* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(a[kBTableBf16] ? launch_bwd<__nv_bfloat16>(a, s)
                              : launch_bwd<float>(a, s));
}

}  // extern "C"
