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
// column, far below the card's arithmetic rate. MIND's lookups and the
// GNNs' gathers are one-id bags (L = 1), so the output dominates.
//
// Design. The TPU kernel tiles the vocabulary through VMEM and turns the
// gather into a one-hot matrix product, and its wrapper pads V to 512, B
// to 8 and d to 128. Here rows are read by index directly and nothing is
// padded. A group of G = min(ceil(d / kVec), kThreads) threads owns a
// bag, kVec = 16 / sizeof(T) columns per thread, several bags to a warp
// when d <= 64 (float32); persistent blocks (as many as are resident)
// stride over the bags. A thread loads kSimtBatch ids (and weights), then
// requests their rows, before its first add (for L = 1, the ids of
// kSimtBatch bags), so neither an id nor a row load waits on the one
// before it; it sums in float32 in order of l with fmaf (weights) or
// adds. Full aligned chunks are one 16-byte load and store, a partial
// chunk (d % kVec != 0) or an unaligned row goes value by value. An id
// >= V is skipped without reading its row. Every offset is 64-bit:
// MIND's 10M x 64 float32 table is 2.56 GB and its serve_bulk output
// 838,860,800 values.
// The launch geometry is computed by the wrapper (kernel.py::geometry,
// persistent_blocks), which the CPU tests hold against a torch emulation
// of this loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 raw bytes as kVec values: float32 as they are, bfloat16 with the
// lower half of each word the first value
__device__ __forceinline__ void unpack16(const uint4 x, float* v,
                                         const float*) {
  v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack16(const uint4 x, float* v,
                                         const __nv_bfloat16*) {
  const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// the 16 bytes of columns [c0, c0 + kVec) of a row (p = row + c0): one
// load when they are all in the row and 16-byte aligned, else value by
// value, zeros past d
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int c0, int d) {
  constexpr int kVec = 16 / sizeof(T);
  if (c0 + kVec <= d && aligned16(p)) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  if constexpr (sizeof(T) == 4) {
    unsigned f[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < d) f[j] = __ldg(reinterpret_cast<const unsigned*>(p) + j);
    }
    return make_uint4(f[0], f[1], f[2], f[3]);
  } else {
    unsigned h[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < d) {
        h[j] = __ldg(reinterpret_cast<const unsigned short*>(p) + j);
      }
    }
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                      h[4] | (h[5] << 16), h[6] | (h[7] << 16));
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

// kVec values at p = row + c0 in T: one 16-byte store when full and
// aligned, else value by value up to d
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
  unpack16(load_raw(p, c0, d), v, p);
}

// ----------------------------------------- asynchronous copies (sm_90)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory above 48 KB, opted into once per kernel and
// process (the attribute stays set; a second call would only cost host
// time on every launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (err == cudaSuccess) *done = true;
  return err;
}

constexpr int kSimtBatch = 4;     // ids, and their rows, in flight a thread

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
  const long long first = (long long)blockIdx.x * bags_per_block + slot;
  const long long stride = (long long)gridDim.x * bags_per_block;

  for (int c0 = t * kVec; c0 < d; c0 += group * kVec) {
    if (L == 1) {
      // one id a bag: kSimtBatch bags' ids, then their rows, in flight
      for (long long b0 = first; b0 < B; b0 += kSimtBatch * stride) {
        long long id[kSimtBatch];
        float wt[kSimtBatch];
#pragma unroll
        for (int j = 0; j < kSimtBatch; ++j) {
          const long long b = b0 + j * stride;
          id[j] = b < B ? (long long)idx[b * idx_sb] : V;
          wt[j] = (w != nullptr && id[j] < V) ? w[b * w_sb] : 1.0f;
        }
        uint4 raw[kSimtBatch];
#pragma unroll
        for (int j = 0; j < kSimtBatch; ++j) {
          raw[j] = make_uint4(0u, 0u, 0u, 0u);
          if (id[j] < V) {
            raw[j] = load_raw(table + max(id[j], 0LL) * ld + c0, c0, d);
          }
        }
#pragma unroll
        for (int j = 0; j < kSimtBatch; ++j) {
          const long long b = b0 + j * stride;
          if (b >= B) break;
          float acc[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
          if (id[j] < V) {
            float v[kVec];
            unpack16(raw[j], v, table);
            if (w != nullptr) {
#pragma unroll
              for (int k = 0; k < kVec; ++k) acc[k] = fmaf(wt[j], v[k], acc[k]);
            } else {
#pragma unroll
              for (int k = 0; k < kVec; ++k) acc[k] += v[k];
            }
          }
          write_chunk(out + b * (long long)d + c0, acc, c0, d);
        }
      }
      continue;
    }
    for (long long b = first; b < B; b += stride) {
      const I* bag_idx = idx + b * idx_sb;
      const float* bag_w = w == nullptr ? nullptr : w + b * w_sb;
      float acc[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
      for (int l0 = 0; l0 < L; l0 += kSimtBatch) {
        long long id[kSimtBatch];
        float wt[kSimtBatch];
#pragma unroll
        for (int j = 0; j < kSimtBatch; ++j) {
          const int l = l0 + j;
          id[j] = l < L ? (long long)bag_idx[(long long)l * idx_sl] : V;
          wt[j] = (bag_w != nullptr && id[j] < V)
                      ? bag_w[(long long)l * w_sl] : 1.0f;
        }
        uint4 raw[kSimtBatch];
#pragma unroll
        for (int j = 0; j < kSimtBatch; ++j) {
          raw[j] = make_uint4(0u, 0u, 0u, 0u);
          if (id[j] < V) {                   // pad: its row is never read
            raw[j] = load_raw(table + max(id[j], 0LL) * ld + c0, c0, d);
          }
        }
#pragma unroll
        for (int j = 0; j < kSimtBatch; ++j) {
          if (id[j] >= V) continue;
          float v[kVec];
          unpack16(raw[j], v, table);
          if (bag_w != nullptr) {
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[k] = fmaf(wt[j], v[k], acc[k]);
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[k] += v[k];
          }
        }
      }
      write_chunk(out + b * (long long)d + c0, acc, c0, d);
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
  kBlocks,      // persistent blocks (kernel.py::persistent_blocks)
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
// (take + clip + mask), and its GNNs sum messages with
// jax.ops.segment_sum. MIND's training step needs it for every table
// gradient, dense in (V, d) as the reference's optimizer reads it; the
// GNNs for every aggregate and every gather's gradient.
//
// Bound: bytes. A call must read each valid entry's dout row once, each id
// once, and write the (V, d) gradient once.
//
// Design: deterministic, no float atomics. The wrapper sorts the entries
// stably by key (the row an entry reads; pads get the key V and sort
// last), so each row's entries form one run, in entry order. The sorted
// stream is cut into chunks of `chunk` entries, and the columns into
// slabs: a team of threads, one 16-byte column chunk each, owns one
// (chunk, slab). A slab is what one warp covers (256 bfloat16 or 128
// float32 columns); where d is narrower, a team is ceil(d / kVec) threads
// and several chunks share a warp. A block holds `cpb` chunks x `spb`
// slabs (kernel.py::bwd_geometry), a grid of chunk groups x slab groups.
//   - bwd_chunk_kernel: the block first copies its chunks' keys, the dout
//     row of each entry (perm / L) and its weight into shared memory, in
//     coalesced loads; each team then finds its chunk's valid end (pads
//     sort last: a binary search) and walks the entries in order, every
//     key and row index from shared memory, so no load of the walk waits
//     on another. The entries' dout slabs stream through a ring of kRing
//     slots in shared memory, kRing entries in flight, by 16-byte cp.async
//     copies per thread ("cp.async"), or, for rows that are not 16-byte
//     aligned, by synchronous loads ("sync"). Each column sums in float32, w * dout rounded before the
//     add (__fmul_rn, __fadd_rn: the CPU emulation's bits). A run that
//     lies inside the chunk is written to its row directly; a run that
//     crosses chunk edges leaves a partial: the chunk's first run, when it
//     began in an earlier chunk, in the chunk's "head" slot, and its last
//     run, when it goes on into the next chunk, in its "tail" slot. Slab
//     0 sets the `present` byte of every row it sees.
//   - bwd_combine_kernel: the chunk whose tail starts a crossing run adds
//     the following chunks' head partials to it in chunk order (eight
//     loads in flight at a time) and writes the row, slab by slab.
//   - bwd_zero_kernel: writes zeros to every row whose `present` byte is
//     unset, so each gradient row is written once.
// Splitting a chunk's columns over teams changes no column's order of
// sums. The same inputs give the same bits on every call: no step depends
// on the order in which blocks run.

constexpr int kRing = 8;      // ring slots of the walk: entries in flight

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

struct BwdParams {
  const void* dout;             // (B, d) contiguous
  const int* keys;              // (n,) sorted keys, pads = V
  const long long* perm;        // (n,) entry positions b * L + l
  const float* w;               // (B, L) contiguous, or null for ones
  long long L, n, V;
  int d;
  int chunk;                    // entries a chunk
  int team;                     // threads a (chunk, slab)
  int slab_cols;                // columns a slab: team * kVec
  int cpb, spb;                 // chunks and slabs a block
  void* grad;                   // (V, d) contiguous
  unsigned char* present;       // (V,) zeroed
  float* partials;              // (chunks, 2, d) float32
};

// the team of this thread: its chunk (or row) slot in the block, its
// slab, and its lane in the team; false for threads past the block's teams
struct Team {
  int cl;                       // chunk (row) slot within the block
  int slab;
  int lane;
};

__device__ __forceinline__ bool team_of(const BwdParams& p, Team* m) {
  const int tm = threadIdx.x / p.team;
  if (tm >= p.cpb * p.spb) return false;
  m->lane = threadIdx.x - tm * p.team;
  m->cl = tm / p.spb;
  m->slab = blockIdx.y * p.spb + tm % p.spb;
  return (long long)m->slab * p.slab_cols < p.d;
}

// shared memory of the chunk kernel: the staged keys (span + 2: the key
// before the block's first entry and after its last, or -1), row indices,
// weights, then the ring
struct BwdSmem {
  int span;
  size_t rows, weights, ring, total;
};

__host__ __device__ inline size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline BwdSmem bwd_smem(int span, bool weighted,
                                            int form, int threads) {
  BwdSmem s;
  s.span = span;
  s.rows = round_up((size_t)(span + 2) * 4, 16);
  s.weights = s.rows + round_up((size_t)span * 4, 16);
  s.ring = round_up(s.weights + (weighted ? (size_t)span * 4 : 0), 128);
  s.total = s.ring + (form ? (size_t)kRing * threads * 16 : 0);
  return s;
}

enum Form { kSync = 0, kCpAsync = 1 };

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_kernel(const BwdParams p) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int span = p.cpb * p.chunk;
  const BwdSmem sm = bwd_smem(span, p.w != nullptr, kForm, blockDim.x);
  int* ks = reinterpret_cast<int*>(smem);
  int* rows_s = reinterpret_cast<int*>(smem + sm.rows);
  float* ws = reinterpret_cast<float*>(smem + sm.weights);
  unsigned char* ring = smem + sm.ring;

  // stage the block's entries [S0, S1)
  const long long S0 = (long long)blockIdx.x * span;
  const long long S1 = min(S0 + span, p.n);
  for (int i = threadIdx.x; i < span + 2; i += blockDim.x) {
    const long long e = S0 - 1 + i;
    ks[i] = (e >= 0 && e < p.n && e <= S1) ? p.keys[e] : -1;
  }
  for (int i = threadIdx.x; i < (int)(S1 - S0); i += blockDim.x) {
    const long long pe = p.perm[S0 + i];
    rows_s[i] = (int)(pe / p.L);
    if (p.w != nullptr) ws[i] = p.w[pe];
  }
  __syncthreads();

  Team m;
  if (!team_of(p, &m)) return;
  const long long c = (long long)blockIdx.x * p.cpb + m.cl;
  const long long s = c * p.chunk;
  if (s >= p.n) return;
  const int base = (int)(s - S0);            // the chunk's first slot
  const int cnt = (int)(min(s + p.chunk, p.n) - s);
  const int first = ks[base + 1];
  if (first >= p.V) return;                  // pads only: they sort last
  int lo = 0, hi = cnt;                      // the first pad, or cnt
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ks[base + 1 + mid] < p.V) lo = mid + 1; else hi = mid;
  }
  const int nv = lo;
  const bool head_continues = ks[base] == first;
  const int last = ks[base + cnt];
  const bool tail_continues = last < p.V && ks[base + cnt + 1] == last;

  const int d = p.d;
  const int slab0 = m.slab * p.slab_cols;
  const int c0 = slab0 + m.lane * kVec;
  const bool active = c0 < d;
  const T* dout = static_cast<const T*>(p.dout);
  T* grad = static_cast<T*>(p.grad);
  float* head = p.partials + c * 2 * (long long)d;
  float* tail = head + d;
  const bool mark = m.slab == 0 && m.lane == 0;

  auto issue = [&](int e) {
    if constexpr (kForm == kCpAsync) {
      if (active && e < nv) {
        cp_async16(smem_u32(ring) +
                       16u * ((e % kRing) * blockDim.x + threadIdx.x),
                   dout + (long long)rows_s[base + e] * d + c0);
      }
      cp_async_commit();
    }
  };

  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  int run_key = first;
  int run_start = 0;
  for (int k = 0; k < kRing - 1; ++k) issue(k);
  for (int e = 0; e < nv; ++e) {
    float v[kVec];
    if constexpr (kForm == kSync) {
      if (active) {
        read_chunk(dout + (long long)rows_s[base + e] * d + c0, v, c0, d);
      }
    } else {
      issue(e + kRing - 1);
      cp_async_wait<kRing - 1>();            // entry e has landed
      if (active) {
        uint4 x;
        const uint32_t a = smem_u32(ring) +
                           16u * ((e % kRing) * blockDim.x + threadIdx.x);
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                     : "r"(a));
        unpack16(x, v, dout);
      }
    }
    const int k = ks[base + 1 + e];
    if (k != run_key) {                      // the run [run_start, e) ends
      if (active) {
        if (run_start == 0 && head_continues) {
          store_f32<kVec>(head + c0, acc, c0, d);
        } else {
          write_chunk(grad + (long long)run_key * d + c0, acc, c0, d);
        }
      }
      if (mark) p.present[run_key] = 1;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
      run_key = k;
      run_start = e;
    }
    if (active) {
      if (p.w != nullptr) {
        const float wt = ws[base + e];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(wt, v[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
      }
    }
  }
  if constexpr (kForm == kCpAsync) cp_async_wait<0>();
  // the last run, [run_start, nv)
  if (active) {
    if (run_start == 0 && head_continues) {
      store_f32<kVec>(head + c0, acc, c0, d);
    } else if (tail_continues) {
      store_f32<kVec>(tail + c0, acc, c0, d);
    } else {
      write_chunk(grad + (long long)run_key * d + c0, acc, c0, d);
    }
  }
  if (mark) p.present[run_key] = 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_combine_kernel(const BwdParams p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kAhead = 8;
  Team m;
  if (!team_of(p, &m)) return;
  const long long c = (long long)blockIdx.x * p.cpb + m.cl;
  const long long n = p.n;
  const int chunk = p.chunk, d = p.d;
  const long long s = c * chunk;
  if (s >= n) return;
  const long long e_end = min(s + (long long)chunk, n);
  const int last = p.keys[e_end - 1];
  if (last >= p.V || e_end >= n || p.keys[e_end] != last) return;
  // a chunk that is one piece of a run begun earlier holds a head partial
  if (s > 0 && p.keys[s] == last && p.keys[s - 1] == last) return;
  const int c0 = m.slab * p.slab_cols + m.lane * kVec;
  if (c0 >= d) return;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const long long stride = 2 * (long long)d;
  float acc[kVec];
  const float* tail = p.partials + c * stride + d + c0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = c0 + j < d ? tail[j] : 0.0f;
  long long k = c + 1;
  bool go = true;
  while (go) {
    float v[kAhead][kVec];
    bool more[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long kk = k + a;
      const bool in = kk < n_chunks;
      const float* head = p.partials + kk * stride + c0;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[a][j] = in && c0 + j < d ? head[j] : 0.0f;
      }
      const long long end = min((kk + 1) * chunk, n);
      more[a] = in && end < n && p.keys[end] == last;
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
  write_chunk(static_cast<T*>(p.grad) + (long long)last * d + c0, acc, c0,
              d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_zero_kernel(const BwdParams p) {
  constexpr int kVec = 16 / sizeof(T);
  Team m;
  if (!team_of(p, &m)) return;
  const int c0 = m.slab * p.slab_cols + m.lane * kVec;
  if (c0 >= p.d) return;
  const long long rows_per_grid = (long long)gridDim.x * p.cpb;
  float zero[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) zero[j] = 0.0f;
  T* grad = static_cast<T*>(p.grad);
  for (long long r = (long long)blockIdx.x * p.cpb + m.cl; r < p.V;
       r += rows_per_grid) {
    if (p.present[r]) continue;
    write_chunk(grad + r * p.d + c0, zero, c0, p.d);
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
  kBTeam,       // threads a (chunk, slab): one 16-byte column chunk each
  kBSlabCols,   // columns a slab
  kBChunksPerBlock,
  kBSlabsPerBlock,
  kBThreads,    // threads a block (a multiple of 32, <= kThreads)
  kBChunkBlocks,  // grid x of the chunk and combine kernels
  kBSlabBlocks,   // grid y of all three
  kBZeroBlocks,   // grid x of the zero kernel
  kBForm,       // 0 sync, 1 cp.async (kernel.py::bwd_form)
  kBNumArgs
};

template <typename T, int kForm>
cudaError_t launch_chunk(const BwdParams& p, dim3 grid, int threads,
                         cudaStream_t stream) {
  static bool opted_in = false;
  const size_t smem =
      bwd_smem(p.cpb * p.chunk, p.w != nullptr, kForm, threads).total;
  cudaError_t err = allow_smem(bwd_chunk_kernel<T, kForm>, &opted_in);
  if (err != cudaSuccess) return err;
  bwd_chunk_kernel<T, kForm><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const long long* a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  BwdParams p;
  p.dout = reinterpret_cast<const void*>(a[kBDout]);
  p.keys = reinterpret_cast<const int*>(a[kBKeys]);
  p.perm = reinterpret_cast<const long long*>(a[kBPerm]);
  p.w = reinterpret_cast<const float*>(a[kBW]);
  p.L = a[kBL];
  p.n = a[kBN];
  p.V = a[kBV];
  p.d = (int)a[kBD];
  p.chunk = (int)a[kBChunk];
  p.team = (int)a[kBTeam];
  p.slab_cols = (int)a[kBSlabCols];
  p.cpb = (int)a[kBChunksPerBlock];
  p.spb = (int)a[kBSlabsPerBlock];
  p.grad = reinterpret_cast<void*>(a[kBGrad]);
  p.present = reinterpret_cast<unsigned char*>(a[kBPresent]);
  p.partials = reinterpret_cast<float*>(a[kBPartials]);
  const int threads = (int)a[kBThreads], form = (int)a[kBForm];
  const long long cb = a[kBChunkBlocks], sb = a[kBSlabBlocks],
                  zb = a[kBZeroBlocks];
  if (p.V <= 0 || p.d <= 0) return cudaSuccess;
  if (p.team < 1 || p.team > 32 || p.slab_cols != p.team * kVec ||
      p.cpb < 1 || p.spb < 1 || p.chunk < 1 || p.L < 1 || threads < 32 ||
      threads > kThreads || threads % 32 ||
      p.cpb * p.spb * p.team > threads || form < kSync ||
      form > kCpAsync || sb < 1 ||
      sb > 65535 || (long long)p.spb * sb * p.slab_cols < p.d || zb < 1 ||
      zb > 0x7fffffffLL || cb > 0x7fffffffLL || (p.n > 0 && cb < 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (p.n > 0) {
    const dim3 grid((unsigned)cb, (unsigned)sb);
    err = form == kCpAsync
              ? launch_chunk<T, kCpAsync>(p, grid, threads, stream)
              : launch_chunk<T, kSync>(p, grid, threads, stream);
    if (err != cudaSuccess) return err;
    bwd_combine_kernel<T><<<grid, threads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bwd_zero_kernel<T><<<dim3((unsigned)zb, (unsigned)sb), threads, 0,
                       stream>>>(p);
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
