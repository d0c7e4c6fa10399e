// PCPM gather phase (paper alg. 5) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/pcpm_spmv/kernel.py::pcpm_gather_pallas.
//
//   out[p, j, :] = sum over e of bins[p, edge_upd[p, e], :]
//                  for the edges e of partition p with edge_dst[p, e] == j
//
//   bins      (k, U, d)       float32 or bfloat16
//   edge_upd  (k, n_eb, Eb)   int32, pad = U  (adds nothing)
//   edge_dst  (k, n_eb, Eb)   int32, pad = P  (dropped)
//   acc       (k, P, d)       float32, zeroed by the caller
//
// An edge counts when 0 <= upd < U and 0 <= dst < P; any other edge is a
// pad. Sums are float32; bfloat16 bins get a second pass that casts the
// float32 accumulator.
//
// Bound: bytes. Per call the work needs both index streams read once
// (8 B per edge), each real update's bins value read once and the output
// written once; the adds are d per edge, far below the card's arithmetic
// rate.
//
// Two paths, chosen by the wrapper from d and from whether the caller
// gives a gather order (kernel.py::b1_path):
//
//   "warp"  any d, any edge order, the blocked (k, n_eb, Eb) streams.
//           Grid (n_eb, k): one block per edge block of one partition; a
//           warp takes 32 consecutive edges, one a lane, and reads
//           bins[p, upd, :] by index. Lanes holding the same destination
//           in adjacent positions are merged by a segmented scan over the
//           warp (shuffles), and only the last lane of each run adds its
//           sum into the float32 accumulator with a global atomicAdd. On
//           the dst-sorted PNG stream runs are long; each lane's bins read
//           is a random 4-byte load from a partition slice too big for L1.
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
//           bins[p, upd] and adds into the tile
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
//           chunk.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ bins, const int* __restrict__ edge_upd,
              const int* __restrict__ edge_dst, float* __restrict__ acc,
              int U, int n_eb, int Eb, int P, int d) {
  const int p = blockIdx.y;
  const long long row = (long long)p * n_eb + blockIdx.x;
  const int* eu = edge_upd + row * Eb;
  const int* ed = edge_dst + row * Eb;
  const T* part_bins = bins + (long long)p * U * d;
  float* part_acc = acc + (long long)p * P * d;
  const int lane = threadIdx.x & 31;
  const unsigned upto_lane = kFull >> (31 - lane);   // bits 0..lane

  // e0 is the same for the 32 lanes of a warp: whole warps enter and
  // leave the loop together, as the shuffles below require
  for (int e0 = threadIdx.x - lane; e0 < Eb; e0 += kThreads) {
    const int e = e0 + lane;
    int u = U, j = P;
    if (e < Eb) {
      u = eu[e];
      j = ed[e];
    }
    const bool valid = u >= 0 && u < U && j >= 0 && j < P;
    const int key = valid ? j : -1;
    // runs of equal keys in adjacent lanes; h = first lane of my run
    const int key_before = __shfl_up_sync(kFull, key, 1);
    const int key_after = __shfl_down_sync(kFull, key, 1);
    const bool head = lane == 0 || key_before != key;
    const bool tail = lane == 31 || key_after != key;
    const unsigned heads = __ballot_sync(kFull, head);
    const int h = 31 - __clz(heads & upto_lane);
    const T* src = part_bins + (long long)(valid ? u : 0) * d;
    float* dst = part_acc + (long long)(valid ? j : 0) * d;
    for (int c = 0; c < d; ++c) {
      float v = valid ? load_value(src + c) : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(kFull, v, off);
        if (lane - off >= h) v += other;
      }
      if (valid && tail) atomicAdd(dst + c, v);
    }
  }
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
              const int4* __restrict__ hubs, float* __restrict__ acc,
              int U, int P, int tile) {
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
    const T* pb = bins + (long long)ch.p * U;
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
      if ((unsigned)u < (unsigned)U && (unsigned)j < (unsigned)P) {
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
        nu[r] = make_int4(U, U, U, U);
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
        ok[s] = (unsigned)us[s] < (unsigned)U && (unsigned)js[s] < (unsigned)P;
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
  kBf16,          // bins: 0 float32, 1 bfloat16
  kBins,          // (k, U, d)
  kEdgeUpd,       // "warp": (k, n_eb, Eb) int32
  kEdgeDst,       // "warp": (k, n_eb, Eb) int32
  kAcc,           // (k, P, d) float32, zeroed by the caller
  kOut,           // bfloat16 bins: (k, P, d) bfloat16 output, else 0
  kK,
  kU,
  kNEb,
  kEb,
  kP,
  kD,
  kTileUpd,       // "tile": (M,) int32 in the gather order, 16-B aligned
  kTileDst,       // "tile": (M,) int32, idem
  kChunks,        // "tile": (N, 4) int32 chunk table
  kBlockChunks,   // "tile": (blocks + 1,) int32
  kHubTable,      // "tile": (k * ceil(P / tile), 8) int32, tile-local or -1
  kTile,          // "tile": destinations per tile, a multiple of 4
  kBlocks,        // "tile": blocks of the launch
  kNumArgs
};

template <typename T>
cudaError_t launch_gather(const long long* a, cudaStream_t stream) {
  const int k = (int)a[kK], U = (int)a[kU], P = (int)a[kP], d = (int)a[kD];
  const T* bins = reinterpret_cast<const T*>(a[kBins]);
  float* acc = reinterpret_cast<float*>(a[kAcc]);
  if (k <= 0 || d <= 0 || P <= 0) return cudaSuccess;
  if (a[kPath] == 0) {
    const int n_eb = (int)a[kNEb], Eb = (int)a[kEb];
    if (n_eb <= 0 || Eb <= 0) return cudaSuccess;
    const dim3 grid((unsigned)n_eb, (unsigned)k);
    warp::gather_kernel<T><<<grid, warp::kThreads, 0, stream>>>(
        bins, reinterpret_cast<const int*>(a[kEdgeUpd]),
        reinterpret_cast<const int*>(a[kEdgeDst]), acc, U, n_eb, Eb, P, d);
    return cudaGetLastError();
  }
  const int tile = (int)a[kTile], blocks = (int)a[kBlocks];
  if (a[kPath] != 1 || d != 1 || tile <= 0 || tile % 4 != 0) {
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
      reinterpret_cast<const int4*>(a[kHubTable]), acc, U, P, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: kNumArgs int64 values in the order of enum Arg. acc (k, P, d)
// float32 is zeroed by the caller; for float32 bins it is the output, for
// bfloat16 bins a second kernel casts it into out. Returns the
// cudaError_t of the launches.
int pcpm_gather(const long long* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!a[kBf16]) return (int)launch_gather<float>(a, s);
  cudaError_t err = launch_gather<__nv_bfloat16>(a, s);
  if (err != cudaSuccess) return (int)err;
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

}  // extern "C"
