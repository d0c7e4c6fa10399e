// PCPM gather phase (paper alg. 5) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/pcpm_spmv/kernel.py::pcpm_gather_pallas.
//
//   out[p, j, :] = sum over e of row(p, edge_upd[p, e])
//                  for the edges e of partition p with edge_dst[p, e] == j
//
//   row(p, u) is bins[p, u, :] (the gather's own input), or, in the
//   fused form of the "warp" path, x[update_src[p, u], :]: the paper's
//   scatter phase read inside the gather, with no bins tensor at all
//   (the JAX package's `pcpm` engine with fused=True does the same).
//   The "warp" kernel always reads rows through update_src; its wrapper
//   gives bins as the rows of x (k * U, d) with the identity update_src.
//
//   bins      (k, U, d)       float32 or bfloat16 ("warp"); on the "tile"
//                             path ragged, (U,) with update_offsets (k + 1,)
//                             int32: partition p's updates from
//                             update_offsets[p] to update_offsets[p + 1]
//   x         (n, d)          float32 or bfloat16 (fused form)
//   update_src (k, U)         int32 rows of x (fused form)
//   edge_upd  (k, n_eb, Eb)   int32, pad = U  (adds nothing)
//   edge_dst  (k, n_eb, Eb)   int32, pad = P  (dropped)
//   acc       (k, P, d)       float32, zeroed by the caller
//
// An edge counts when 0 <= upd < U (on the "tile" path, below partition
// p's update count) and 0 <= dst < P (in the fused form also
// 0 <= update_src[p, upd] < n); any other edge is a pad, here and in
// the plain versions (kernels/pcpm_spmv/ref.py). Sums are float32;
// bfloat16 rows get a second pass that casts the float32 accumulator.
//
// Bound: bytes. Per call the work needs both index streams read once
// (8 B per edge), its row input read once (from bins, each real update's
// row; in the fused form each real update's update_src entry, 4 B, and x
// once, n rows) and the output written once; the adds are d per edge,
// far below the card's arithmetic rate. The fused form re-reads a row of
// x once per partition that it feeds (the PCPM layout's cost); the bound
// does not count that.
//
// Two paths, chosen by the wrapper from d and from whether the caller
// gives a gather order (kernel.py::b1_path):
//
//   "warp"  any d, any edge order, the blocked (k, n_eb, Eb) streams read
//           as one flat stream of k * n_eb * Eb slots (a slot's partition
//           is slot / (n_eb * Eb)). At the serving width (d = 16,
//           64-byte rows) each edge reads one random row of a partition's
//           update rows, which is too big for L1 but, at kron sizes, fits
//           the 50 MB L2 for one partition at a time; with that kept in
//           L2, what bounds the path is issuing the walk's instructions,
//           which the lanes of a group repeat for every slot, and the
//           scattered update_src reads (tools/b1_variants.py). The
//           design:
//           - lanes across the row: each edge is taken by a group of
//             `lanes` lanes, each lane one 16-byte slice of the row (4
//             float32 or 8 bfloat16; one value when d is not a multiple
//             of that or the rows are not 16-byte aligned), so a row is
//             one coalesced access; a d wider than the group's slices is
//             taken in column tiles;
//           - sums in registers along the stream: a group walks a
//             contiguous range of slots, keeps the current destination's
//             partial row in registers and adds it into acc once per run
//             (when the destination changes or the range ends), with
//             16-byte vector reductions (atomicAdd on float4). Any edge
//             order stays correct, an unsorted stream only has shorter
//             runs; pads are skipped without ending a run;
//           - rows in flight: a group's lanes fetch 4 * lanes slots of
//             both index streams with 16-byte loads (one int4 pair a
//             lane), the next fetch in flight while this one is summed,
//             and load up to 8 rows a lane before adding them;
//           - one wave, partition-major: the grid is the blocks the card
//             holds at once; in each round every group takes the next
//             `range` slots, so one round covers about one partition and
//             the rounds walk the stream in order: a partition's rows
//             (23 MB at kron-21, d = 16) stay in L2 while its edges are
//             summed.
//   "tile"  d = 1 and the port's gather order (ops.py::tile_schedule):
//           the paper's own gather. Within a partition the real edges are
//           ordered by (destination tile, update, destination), so the
//           bins values are read in order, each update once per tile it
//           feeds, and the only random access is the add into a
//           partition-resident accumulator, here a tile of `tile`
//           destinations in shared memory (a 65536-node partition at d = 1
//           is 256 KB, above the 227 KB a block may use, so it is cut into
//           tiles). A chunk table cuts the ordered stream into pieces that
//           each lie in one tile; block b walks chunks block_chunks[b] ..
//           block_chunks[b + 1] - 1 (equal edge counts per block, one wave
//           on the card), and for each: zeroes the tile, streams the
//           chunk's edges with 16-byte evict-first loads (a thread's next
//           pair in flight while it adds this one's four edges), reads
//           bins[update_offsets[p] + upd] and adds into the tile
//           with shared-memory atomics, except for the tile's 8 heaviest
//           destinations (its "hubs", chosen on the host), which each
//           thread sums in registers and each warp adds once per chunk:
//           the shared float atomicAdd compiles to a compare-and-swap loop
//           (ATOMS.CAST.SPIN) that serialises on a destination taking a
//           large share of the tile's edges, as Kronecker hubs do (up to
//           a third of a tile's). Then it flushes the tile into acc with
//           16-byte vector reductions (atomicAdd on float4), skipping
//           groups of four that stayed zero. An edge whose destination
//           lies outside its chunk's tile goes to a global atomicAdd, so
//           any order of the streams stays correct. No pad slot is in a
//           chunk, and the bins are the PNG's own updates, with no pad
//           either: a hub-first labeling makes the partitions' update
//           counts far from equal, and padding each to the heaviest would
//           read over ten times the real ones.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// --------------------------------------------------------------- "warp"
namespace warp {

constexpr int kThreads = 256;

// A lane's slice of a row: W values read with one load (`Raw`) and
// widened to float32 when summed.
template <typename T, int W>
struct Slice;

template <>
struct Slice<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ Raw zero() { return 0.0f; }
  static __device__ __forceinline__ void widen(Raw r, float (&f)[1]) {
    f[0] = r;
  }
};

template <>
struct Slice<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void widen(Raw r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

template <>
struct Slice<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return 0; }
  static __device__ __forceinline__ void widen(Raw r, float (&f)[1]) {
    f[0] = __uint_as_float((unsigned)r << 16);
  }
};

template <>
struct Slice<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void widen(Raw r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // the lower half is the first value
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Adds a run's W sums into acc: 16-byte vector reductions when W is a
// multiple of 4 (the slice is then 16-byte aligned), else one scalar add.
template <int W>
__device__ __forceinline__ void flush(float* p, const float (&sum)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W; q += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + q),
                make_float4(sum[q], sum[q + 1], sum[q + 2], sum[q + 3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) atomicAdd(p + q, sum[q]);
  }
}

// The launch's shapes: S slots in all, E a partition; a group takes
// `range` slots a round (a multiple of 4 * L).
struct Shape {
  int n, U, E, S, P, d, range;
};

// One kernel per (row type, slice width W, lanes per edge L). `rows` is
// x (n, d); the row of update p * U + u is update_src[p * U + u].
template <typename T, int W, int L>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const void* __restrict__ rows_v,
              const int* __restrict__ update_src,
              const int* __restrict__ edge_upd,
              const int* __restrict__ edge_dst, float* __restrict__ acc,
              Shape sh) {
  using S = Slice<T, W>;
  constexpr int kFetch = 4 * L;                 // slots of a group's fetch
  constexpr int kChunk = kFetch < 8 ? kFetch : 8;   // rows in flight a lane
  const T* rows = reinterpret_cast<const T*>(rows_v);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L - 1);                // lane in the group
  const unsigned gmask =
      L == 32 ? kFull : ((1u << L) - 1) << (lane & ~(L - 1));
  const int group = (int)((blockIdx.x * kThreads + threadIdx.x) / L);
  const long long window = (long long)gridDim.x * (kThreads / L) * sh.range;
  const int4* upd4 = reinterpret_cast<const int4*>(edge_upd);
  const int4* dst4 = reinterpret_cast<const int4*>(edge_dst);

  for (int c0 = 0; c0 < sh.d; c0 += L * W) {    // column tiles
    const int col = c0 + gl * W;
    const bool has_col = col < sh.d;
    for (long long r0 = (long long)group * sh.range; r0 < sh.S;
         r0 += window) {                        // rounds
      const int r1 = (int)min(r0 + sh.range, (long long)sh.S);
      int cur = -1;                             // the run's key
      float sum[W];
#pragma unroll
      for (int w = 0; w < W; ++w) sum[w] = 0.0f;
      // this lane's four slots of the fetch at s0: s0 + 4 * gl + 0..3
      int4 nu, nj;
      auto fetch = [&](int s0) {
        const int s = s0 + 4 * gl;
        if (s + 3 < r1) {
          nu = __ldcs(upd4 + s / 4);
          nj = __ldcs(dst4 + s / 4);
        } else {                                // the stream's ragged end
          nu = make_int4(sh.U, sh.U, sh.U, sh.U);
          nj = make_int4(sh.P, sh.P, sh.P, sh.P);
          if (s < r1) { nu.x = edge_upd[s]; nj.x = edge_dst[s]; }
          if (s + 1 < r1) { nu.y = edge_upd[s + 1]; nj.y = edge_dst[s + 1]; }
          if (s + 2 < r1) { nu.z = edge_upd[s + 2]; nj.z = edge_dst[s + 2]; }
        }
      };
      fetch((int)r0);
      for (int s0 = (int)r0; s0 < r1; s0 += kFetch) {
        const int u[4] = {nu.x, nu.y, nu.z, nu.w};
        const int j[4] = {nj.x, nj.y, nj.z, nj.w};
        if (s0 + kFetch < r1) fetch(s0 + kFetch);
        // each slot's key (partition * P + destination, -1 for a pad) and
        // row of x
        const int s = s0 + 4 * gl;
        int p = s / sh.E;
        long long p_end = (long long)(p + 1) * sh.E;
        int key[4], row[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          while (s + c >= p_end) {
            ++p;
            p_end += sh.E;
          }
          bool ok = (unsigned)u[c] < (unsigned)sh.U &&
                    (unsigned)j[c] < (unsigned)sh.P;
          int r = ok ? p * sh.U + u[c] : 0;     // p < k for a real edge
          r = ok ? __ldg(update_src + r) : 0;
          ok = ok && (unsigned)r < (unsigned)sh.n;     // else a pad
          key[c] = ok ? p * sh.P + j[c] : -1;
          row[c] = r;
        }
        // the group's kFetch slots in order, kChunk rows in flight a lane
#pragma unroll 1
        for (int t0 = 0; t0 < kFetch; t0 += kChunk) {
          typename S::Raw v[kChunk];
          int kk[kChunk];
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {    // slot t0 + q: t0 % 4 == 0
            const int src = (t0 + q) >> 2;
            kk[q] = __shfl_sync(gmask, key[q & 3], src, L);
            const int rq = __shfl_sync(gmask, row[q & 3], src, L);
            v[q] = kk[q] >= 0 && has_col
                       ? S::load(rows + (long long)rq * sh.d + col)
                       : S::zero();
          }
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            if (kk[q] < 0) continue;            // a pad ends no run
            float f[W];
            S::widen(v[q], f);
            if (kk[q] != cur) {
              if (cur >= 0 && has_col) {
                flush<W>(acc + (long long)cur * sh.d + col, sum);
              }
              cur = kk[q];
#pragma unroll
              for (int w = 0; w < W; ++w) sum[w] = f[w];
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) sum[w] += f[w];
            }
          }
        }
      }
      if (cur >= 0 && has_col) {
        flush<W>(acc + (long long)cur * sh.d + col, sum);
      }
    }
  }
}

using Kernel = void (*)(const void*, const int*, const int*, const int*,
                        float*, Shape);

template <typename T, int W>
Kernel pick_lanes(int lanes) {
  switch (lanes) {
    case 1: return gather_kernel<T, W, 1>;
    case 2: return gather_kernel<T, W, 2>;
    case 4: return gather_kernel<T, W, 4>;
    case 8: return gather_kernel<T, W, 8>;
    case 16: return gather_kernel<T, W, 16>;
    case 32: return gather_kernel<T, W, 32>;
    default: return nullptr;
  }
}

// The kernel of a launch, or nullptr for a combination it does not take
// (a float32 slice is 1 or 4 values, a bfloat16 one 1 or 8).
Kernel pick(bool bf16, int vec, int lanes) {
  if (!bf16) {
    if (vec == 1) return pick_lanes<float, 1>(lanes);
    if (vec == 4) return pick_lanes<float, 4>(lanes);
    return nullptr;
  }
  if (vec == 1) return pick_lanes<__nv_bfloat16, 1>(lanes);
  if (vec == 8) return pick_lanes<__nv_bfloat16, 8>(lanes);
  return nullptr;
}

}  // namespace warp

// --------------------------------------------------------------- "tile"
namespace tile {

constexpr int kThreads = 512;
constexpr int kUnroll = 1;    // int4 pairs a thread takes per step
constexpr int kEdges = 4 * kUnroll;
constexpr int kHubs = 8;      // a tile's destinations summed in registers

// One chunk-table entry: partition, tile index, first edge, end edge.
struct Chunk {
  int p, t, first, end;
};

// Adds v into destination j of partition p: into a register when j is
// one of its tile's hubs (the shared float atomicAdd is a compare-and-swap
// loop, ATOMS.CAST.SPIN, which serialises on a destination that takes a
// large share of a tile's edges, as Kronecker hubs do), into the shared
// tile when j lies in it, else into acc.
__device__ __forceinline__ void add_edge(float v, int j, int t0, int tn,
                                         const int (&hub)[kHubs],
                                         float (&hub_sum)[kHubs],
                                         float* sacc, float* pacc) {
  const int jt = j - t0;
  if ((unsigned)jt < (unsigned)tn) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < kHubs; ++q) {
      if (jt == hub[q]) {
        hub_sum[q] += v;
        hit = true;
      }
    }
    if (!hit) atomicAdd(sacc + jt, v);
  } else {
    atomicAdd(pacc + j, v);                      // outside the tile
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
gather_kernel(const T* __restrict__ bins, const int* __restrict__ upd,
              const int* __restrict__ dst, const int4* __restrict__ chunks,
              const int* __restrict__ block_chunks,
              const int4* __restrict__ hubs,
              const int* __restrict__ upd_off, float* __restrict__ acc,
              int P, int tile) {
  extern __shared__ float4 smem4[];
  float* sacc = reinterpret_cast<float*>(smem4);
  const int4* upd4 = reinterpret_cast<const int4*>(upd);
  const int4* dst4 = reinterpret_cast<const int4*>(dst);
  const int n_tiles = (P + tile - 1) / tile;
  const int lane = threadIdx.x & 31;
  const int c_end = block_chunks[blockIdx.x + 1];
  for (int c = block_chunks[blockIdx.x]; c < c_end; ++c) {
    const int4 raw = chunks[c];
    const Chunk ch{raw.x, raw.y, raw.z, raw.w};
    const int t0 = ch.t * tile;                  // the tile's first dst
    const int tn = max(0, min(tile, P - t0));    // destinations in it
    // the partition's bins and their count
    const int u0 = upd_off[ch.p];
    const int up = upd_off[ch.p + 1] - u0;
    const T* pb = bins + u0;
    float* pacc = acc + (long long)ch.p * P;
    // the tile's hubs (tile-local, -1 for none) and their sums
    const int4* tile_hubs = hubs + 2 * ((long long)ch.p * n_tiles + ch.t);
    const int4 h0 = tile_hubs[0], h1 = tile_hubs[1];
    const int hub[kHubs] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    float hub_sum[kHubs];
#pragma unroll
    for (int q = 0; q < kHubs; ++q) hub_sum[q] = 0.0f;
    // tile is a multiple of 4: zero it 16 bytes at a time
    for (int q = threadIdx.x; q < (tn + 3) / 4; q += kThreads) {
      smem4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();

    // up to 3 edges before the first 16-byte boundary and after the last
    const int a0 = min(ch.end, (ch.first + 3) & ~3);
    const int a1 = max(a0, ch.end & ~3);
    const int n_ragged = (a0 - ch.first) + (ch.end - a1);
    if ((int)threadIdx.x < n_ragged) {
      const int e = ch.first + threadIdx.x < a0
                        ? ch.first + threadIdx.x
                        : a1 + (threadIdx.x - (a0 - ch.first));
      const int u = upd[e], j = dst[e];
      if ((unsigned)u < (unsigned)up && (unsigned)j < (unsigned)P) {
        add_edge(load_value(pb + u), j, t0, tn, hub, hub_sum, sacc, pacc);
      }
    }
    // the aligned body, software-pipelined: the next step's int4 pairs
    // are in flight while this step's edges are added
    int4 nu[kUnroll], nj[kUnroll];
    auto fetch = [&](int i) {
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int ir = i + r * kThreads;
        nu[r] = make_int4(up, up, up, up);
        nj[r] = make_int4(P, P, P, P);
        if (ir < a1 / 4) {
          nu[r] = __ldcs(upd4 + ir);
          nj[r] = __ldcs(dst4 + ir);
        }
      }
    };
    fetch(a0 / 4 + threadIdx.x);
    for (int i = a0 / 4 + threadIdx.x; i < a1 / 4; i += kUnroll * kThreads) {
      int us[kEdges], js[kEdges];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        us[4 * r] = nu[r].x; us[4 * r + 1] = nu[r].y;
        us[4 * r + 2] = nu[r].z; us[4 * r + 3] = nu[r].w;
        js[4 * r] = nj[r].x; js[4 * r + 1] = nj[r].y;
        js[4 * r + 2] = nj[r].z; js[4 * r + 3] = nj[r].w;
      }
      fetch(i + kUnroll * kThreads);
      float vs[kEdges];
      bool ok[kEdges];
#pragma unroll
      for (int s = 0; s < kEdges; ++s) {
        ok[s] = (unsigned)us[s] < (unsigned)up && (unsigned)js[s] < (unsigned)P;
        vs[s] = ok[s] ? load_value(pb + us[s]) : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < kEdges; ++s) {
        if (ok[s]) add_edge(vs[s], js[s], t0, tn, hub, hub_sum, sacc, pacc);
      }
    }
    // each warp adds its hub sums into the tile, one atomic per hub
#pragma unroll
    for (int q = 0; q < kHubs; ++q) {
      float sum = hub_sum[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      if (lane == 0 && (unsigned)hub[q] < (unsigned)tn && sum != 0.0f) {
        atomicAdd(sacc + hub[q], sum);
      }
    }
    __syncthreads();

    // flush: scalar adds up to the first 16-byte boundary of acc, then
    // float4 reductions, then the scalar rest; zero groups are skipped
    float* g = pacc + t0;
    const long long base = (long long)ch.p * P + t0;
    const int lead = min(tn, (int)((4 - (base & 3)) & 3));
    const int nv = (tn - lead) / 4;
    for (int i = threadIdx.x; i < lead; i += kThreads) {
      if (sacc[i] != 0.0f) atomicAdd(g + i, sacc[i]);
    }
    for (int q = threadIdx.x; q < nv; q += kThreads) {
      const int i = lead + 4 * q;
      const float4 s = make_float4(sacc[i], sacc[i + 1], sacc[i + 2],
                                   sacc[i + 3]);
      if (s.x != 0.0f || s.y != 0.0f || s.z != 0.0f || s.w != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(g + i), s);
      }
    }
    for (int i = lead + 4 * nv + threadIdx.x; i < tn; i += kThreads) {
      if (sacc[i] != 0.0f) atomicAdd(g + i, sacc[i]);
    }
    __syncthreads();                             // before the next zeroing
  }
}

}  // namespace tile

__global__ void cast_to_bf16_kernel(const float* __restrict__ in,
                                    __nv_bfloat16* __restrict__ out,
                                    long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = __float2bfloat16(in[i]);
  }
}

// The launch's arguments, packed as int64 by kernel.py::launch_args in
// this order (tests/test_torch_pcpm_gather_paths.py reads this list).
enum Arg {
  kPath,          // 0 "warp", 1 "tile"
  kBf16,          // rows: 0 float32, 1 bfloat16
  kRows,          // "tile": ragged bins (U,); "warp": x (n, d)
  kUpdateSrc,     // "warp": (k, U) int32 rows of x
  kN,             // "warp": rows of x
  kEdgeUpd,       // "warp": (k, n_eb, Eb) int32, 16-B aligned
  kEdgeDst,       // "warp": (k, n_eb, Eb) int32, 16-B aligned
  kAcc,           // (k, P, d) float32, zeroed by the caller
  kOut,           // bfloat16 rows: (k, P, d) bfloat16 output, else 0
  kK,
  kU,
  kNEb,
  kEb,
  kP,
  kD,
  kVec,           // "warp": row values a lane reads at once (1, 4 or 8)
  kLanes,         // "warp": lanes per edge, a power of two <= 32
  kRange,         // "warp": slots a group takes a round, a multiple of
                  // 4 * lanes
  kTileUpd,       // "tile": (M,) int32 in the gather order, 16-B aligned
  kTileDst,       // "tile": (M,) int32, idem
  kChunks,        // "tile": (N, 4) int32 chunk table
  kBlockChunks,   // "tile": (blocks + 1,) int32
  kHubTable,      // "tile": (k * ceil(P / tile), 8) int32, tile-local or -1
  kTile,          // "tile": destinations per tile, a multiple of 4
  kBlocks,        // blocks of the launch
  kUpdateOffsets, // "tile": (k + 1,) int32 offsets of the ragged bins
  kNumArgs
};

cudaError_t launch_warp(const long long* a, cudaStream_t stream) {
  const long long k = a[kK], e = a[kNEb] * a[kEb];
  const warp::Shape sh{(int)a[kN], (int)a[kU], (int)e, (int)(k * e),
                       (int)a[kP], (int)a[kD], (int)a[kRange]};
  const int vec = (int)a[kVec], lanes = (int)a[kLanes];
  const int blocks = (int)a[kBlocks];
  const warp::Kernel kernel = warp::pick(a[kBf16] != 0, vec, lanes);
  if (kernel == nullptr || a[kUpdateSrc] == 0 || sh.range <= 0 ||
      sh.range % (4 * lanes) != 0 ||
      (vec > 1 && (sh.d % vec != 0 || a[kRows] % 16 != 0)) ||
      a[kEdgeUpd] % 16 != 0 || a[kEdgeDst] % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (sh.S <= 0 || blocks <= 0) return cudaSuccess;
  kernel<<<blocks, warp::kThreads, 0, stream>>>(
      reinterpret_cast<const void*>(a[kRows]),
      reinterpret_cast<const int*>(a[kUpdateSrc]),
      reinterpret_cast<const int*>(a[kEdgeUpd]),
      reinterpret_cast<const int*>(a[kEdgeDst]),
      reinterpret_cast<float*>(a[kAcc]), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const long long* a, cudaStream_t stream) {
  const int P = (int)a[kP];
  const T* bins = reinterpret_cast<const T*>(a[kRows]);
  float* acc = reinterpret_cast<float*>(a[kAcc]);
  const int tile = (int)a[kTile], blocks = (int)a[kBlocks];
  if (a[kD] != 1 || tile <= 0 || tile % 4 != 0 || a[kUpdateOffsets] == 0) {
    return cudaErrorInvalidValue;
  }
  if (blocks <= 0) return cudaSuccess;
  const int smem = tile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile::gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  tile::gather_kernel<T><<<blocks, tile::kThreads, smem, stream>>>(
      bins, reinterpret_cast<const int*>(a[kTileUpd]),
      reinterpret_cast<const int*>(a[kTileDst]),
      reinterpret_cast<const int4*>(a[kChunks]),
      reinterpret_cast<const int*>(a[kBlockChunks]),
      reinterpret_cast<const int4*>(a[kHubTable]),
      reinterpret_cast<const int*>(a[kUpdateOffsets]), acc, P, tile);
  return cudaGetLastError();
}

cudaError_t launch_gather(const long long* a, cudaStream_t stream) {
  if (a[kK] <= 0 || a[kD] <= 0 || a[kP] <= 0) return cudaSuccess;
  if (a[kPath] == 0) return launch_warp(a, stream);
  if (a[kPath] != 1) return cudaErrorInvalidValue;
  return a[kBf16] ? launch_tile<__nv_bfloat16>(a, stream)
                  : launch_tile<float>(a, stream);
}

}  // namespace

extern "C" {

// a: kNumArgs int64 values in the order of enum Arg. acc (k, P, d)
// float32 is zeroed by the caller; for float32 rows it is the output, for
// bfloat16 rows a second kernel casts it into out. Returns the
// cudaError_t of the launches.
int pcpm_gather(const long long* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_gather(a, s);
  if (err != cudaSuccess || !a[kBf16]) return (int)err;
  const long long n = a[kK] * a[kP] * a[kD];
  if (n <= 0) return (int)cudaSuccess;
  constexpr int kCastThreads = 256;
  long long blocks = (n + kCastThreads - 1) / kCastThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  cast_to_bf16_kernel<<<(unsigned)blocks, kCastThreads, 0, s>>>(
      reinterpret_cast<const float*>(a[kAcc]),
      reinterpret_cast<__nv_bfloat16*>(a[kOut]), n);
  return (int)cudaGetLastError();
}

// The "warp" kernel's resident blocks per SM for a row type (bf16 0/1),
// slice width and lanes per edge, into *blocks; the wrapper launches that
// many times the SMs (one wave). Returns the cudaError_t
// (cudaErrorInvalidValue for a combination without a kernel).
int pcpm_warp_occupancy(int bf16, int vec, int lanes, int* blocks) {
  const warp::Kernel kernel = warp::pick(bf16 != 0, vec, lanes);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, warp::kThreads, 0);
}

}  // extern "C"
