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
// Bound: bytes. Per call the work needs both index streams read once
// (8 B per edge), each real update's bins row read once (U*d values over
// all partitions) and the output written once (k*P*d values); the adds
// are d per edge, far below the card's arithmetic rate. The kernel also
// reads the pad slots of the edge streams, a cost of the blocked layout
// that the bound does not count.
//
// Design. The TPU kernel turns the update gather and the destination
// scatter into one-hot matrix products and carries the partition
// accumulator across sequential grid steps. On the card blocks run in
// parallel and in no order, so here:
//   - grid (n_eb, k): one block per edge block of one partition; a warp
//     takes 32 consecutive edges at a time, one edge per lane;
//   - each lane reads bins[p, upd, :] directly (a gather, no one-hot);
//   - lanes holding the same destination in adjacent positions are
//     merged by a segmented inclusive scan over the warp (shuffles), and
//     only the last lane of each run adds its sum into the float32
//     accumulator with atomicAdd. The PNG gather stream is sorted by
//     destination, so runs are long (the mean in-degree) and most
//     atomics disappear; on unsorted streams runs are short and the
//     result stays exact up to float32 rounding order;
//   - the accumulator lives in global memory (a 65536-node d = 1
//     partition is 256 KB, above the 227 KB of shared memory a block may
//     use) and stays resident in the 50 MB L2 at PageRank sizes.
// For bfloat16 bins a second pass casts the float32 accumulator.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pcpm_gather_kernel(const T* __restrict__ bins,
                   const int* __restrict__ edge_upd,
                   const int* __restrict__ edge_dst,
                   float* __restrict__ acc,
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

__global__ void __launch_bounds__(kThreads)
cast_to_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                    long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    out[i] = __float2bfloat16(in[i]);
  }
}

template <typename T>
cudaError_t launch_gather(const void* bins, const void* edge_upd,
                          const void* edge_dst, void* acc, int k, int U,
                          int n_eb, int Eb, int P, int d, cudaStream_t stream) {
  if (k <= 0 || n_eb <= 0 || Eb <= 0 || d <= 0) return cudaSuccess;
  const dim3 grid((unsigned)n_eb, (unsigned)k);
  pcpm_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(bins), static_cast<const int*>(edge_upd),
      static_cast<const int*>(edge_dst), static_cast<float*>(acc), U, n_eb,
      Eb, P, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 bins; out (k, P, d) float32 is the accumulator (zeroed by the
// caller). Returns the cudaError_t of the launch.
int pcpm_gather_f32(const void* bins, const void* edge_upd,
                    const void* edge_dst, void* out, int k, int U, int n_eb,
                    int Eb, int P, int d, void* stream) {
  return (int)launch_gather<float>(bins, edge_upd, edge_dst, out, k, U, n_eb,
                                   Eb, P, d, (cudaStream_t)stream);
}

// bfloat16 bins; acc (k, P, d) float32 scratch zeroed by the caller,
// out (k, P, d) bfloat16. Returns the cudaError_t of the launches.
int pcpm_gather_bf16(const void* bins, const void* edge_upd,
                     const void* edge_dst, void* acc, void* out, int k, int U,
                     int n_eb, int Eb, int P, int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_gather<__nv_bfloat16>(bins, edge_upd, edge_dst, acc,
                                                 k, U, n_eb, Eb, P, d, s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)k * P * d;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  cast_to_bf16_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
