// Flash attention forward (tiled online softmax) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h / group, :] / sqrt(D))
//                   * v[b, j, h / group, :]     over the keys j visible to i
//
//   q  (B, Sq, Hq, D)    float32 or bfloat16, any strides with d contiguous
//   k  (B, Skv, Hkv, D)  float32 or bfloat16 (k and v of one type; bfloat16
//                        when q is), idem
//   v  (B, Skv, Hkv, D)
//   o  (B, Sq, Hq, D)    bfloat16 when q and k/v are, else float32
//
// Key j is visible to query i (at key-aligned position i + Skv - Sq) when
// j < kv_len[b], j <= i + Skv - Sq under causal, and j > i + Skv - Sq -
// window under a window. A row with no visible key writes zeros. Sums and
// the running softmax state are float32.
//
// Bound. At prefill (Sq = Skv) the work is the 4*D operations of each
// visible (query, key) pair and the bound is the tensor cores' rate; at
// decode (Sq = 1) it is the bytes of the live K and V rows. This first
// version runs on the float32 cores (no mma/wgmma, no TMA): the design
// aims at being right and at reading the layout the model holds.
//
// Design.
//   - grid (row blocks, Hkv, B). The rows of one (b, kv head) are its
//     (query position, q head of the group) pairs, head fastest, so the
//     q heads that share a KV head share every K/V tile in shared memory
//     (GQA without materialising a repeat). A block holds kRows rows: 4
//     warps of 4 rows each.
//   - the block walks only the key tiles its rows can see: from the
//     window's start to min(kv_len, causal end). Tiles wholly outside
//     are skipped, as the TPU kernel's pl.when does
//     (kv_tile_range in kernels/flash_attention/kernel.py is the same rule).
//   - per tile of 32 keys, K and V are staged in shared memory as float32
//     (K rows padded by 4 floats so the float4 reads of 32 lanes hit
//     distinct banks); lane j scores key j against the warp's 4 rows,
//     the warp reduces max and sum with shuffles, and the probabilities
//     go through shared memory to the P.V product, where lane c owns
//     output columns c, c + 32, ...
//   - q, k and v are read through their strides in the (B, S, H, D)
//     layout: the KV cache is never transposed or copied.
//   - decode (Sq = 1) leaves the row block mostly idle (8 rows of 16 for
//     TinyLlama's group of 8) and runs one block per (b, kv head); a
//     split over keys is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;             // fixed: float4 over rows
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;                 // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;            // <= 0: no window
  int kv_len;            // used when kv_lens is null
  const int* kv_lens;    // (B,) int32 on the device, or null
  float scale;
};

template <typename TQ, typename TKV, typename TO, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int kPad = D + 4;
  constexpr int kCols = D / 32;
  __shared__ __align__(16) float Ks[kBlockK][kPad];
  __shared__ __align__(16) float Vs[kBlockK][D];
  __shared__ __align__(16) float Qs[D][kRows];   // row index fastest
  __shared__ __align__(16) float Ps[kWarps][kBlockK][kRowsPerWarp];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int group = p.Hq / p.Hkv;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, p.Sq * group - row0);
  const int q_offset = p.Skv - p.Sq;
  int kv_len = p.kv_lens != nullptr ? p.kv_lens[b] : p.kv_len;
  kv_len = max(0, min(kv_len, p.Skv));

  const TQ* qg = static_cast<const TQ*>(p.q) + b * p.q_sb;
  const TKV* kg = static_cast<const TKV*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const TKV* vg = static_cast<const TKV*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  TO* og = static_cast<TO*>(p.o) + b * p.o_sb;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.0f;
    if (r < nrows) {
      const int row = row0 + r;
      const int pos = row / group, h = kvh * group + row % group;
      x = to_float(qg[pos * p.q_ss + h * p.q_sh + d]);
    }
    Qs[d][r] = x;
  }

  // the key tiles any row of this block can see (kv_tile_range)
  const int pos_lo = row0 / group;
  const int pos_hi = (row0 + nrows - 1) / group;
  int k_end = kv_len;
  if (p.causal) k_end = min(k_end, pos_hi + q_offset + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, pos_lo + q_offset - p.window + 1);
  const int t_begin = k_begin / kBlockK;
  const int t_end = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr0 = warp * kRowsPerWarp;
  const bool warp_busy = wr0 < nrows;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int qpos[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    row_ok[r] = wr0 + r < nrows;
    qpos[r] = (row0 + wr0 + r) / group + q_offset;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // Qs written / the last tile's readers done
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int key = k0 + j;
      float kx = 0.0f, vx = 0.0f;   // keys past kv_len read as zeros
      if (key < kv_len) {
        kx = to_float(kg[key * p.k_ss + d]);
        vx = to_float(vg[key * p.v_ss + d]);
      }
      Ks[j][d] = kx;
      Vs[j][d] = vx;
    }
    __syncthreads();
    if (!warp_busy) continue;

    float s[kRowsPerWarp] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(&Ks[lane][d]);
      const float4 q0 = *reinterpret_cast<const float4*>(&Qs[d][wr0]);
      const float4 q1 = *reinterpret_cast<const float4*>(&Qs[d + 1][wr0]);
      const float4 q2 = *reinterpret_cast<const float4*>(&Qs[d + 2][wr0]);
      const float4 q3 = *reinterpret_cast<const float4*>(&Qs[d + 3][wr0]);
      s[0] += q0.x * kx.x + q1.x * kx.y + q2.x * kx.z + q3.x * kx.w;
      s[1] += q0.y * kx.x + q1.y * kx.y + q2.y * kx.z + q3.y * kx.w;
      s[2] += q0.z * kx.x + q1.z * kx.y + q2.z * kx.z + q3.z * kx.w;
      s[3] += q0.w * kx.x + q1.w * kx.y + q2.w * kx.z + q3.w * kx.w;
    }

    const int key = k0 + lane;
    float pr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      bool visible = row_ok[r] && key < kv_len;
      if (p.causal) visible = visible && key <= qpos[r];
      if (p.window > 0) visible = visible && key > qpos[r] - p.window;
      const float sc = visible ? s[r] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      pr[r] = visible ? expf(sc - m_new) : 0.0f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    *reinterpret_cast<float4*>(&Ps[warp][lane][0]) =
        make_float4(pr[0], pr[1], pr[2], pr[3]);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(&Ps[warp][j][0]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vx = Vs[j][lane + 32 * c];
        acc[0][c] += pj.x * vx;
        acc[1][c] += pj.y * vx;
        acc[2][c] += pj.z * vx;
        acc[3][c] += pj.w * vx;
      }
    }
    __syncwarp();   // Ps is rewritten by the next tile
  }

  if (!warp_busy) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!row_ok[r]) continue;
    const int row = row0 + wr0 + r;
    const int pos = row / group, h = kvh * group + row % group;
    const float inv = l[r] == 0.0f ? 0.0f : 1.0f / l[r];
    TO* out = og + pos * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(out + lane + 32 * c, acc[r][c] * inv);
  }
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch(const Params& p, int head_dim, cudaStream_t stream) {
  const long long rows = (long long)p.Sq * (p.Hq / p.Hkv);
  if (rows == 0 || p.B == 0) return cudaSuccess;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)p.Hkv,
                  (unsigned)p.B);
  switch (head_dim) {
    case 32:
      flash_fwd_kernel<TQ, TKV, TO, 32><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 64:
      flash_fwd_kernel<TQ, TKV, TO, 64><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 128:
      flash_fwd_kernel<TQ, TKV, TO, 128><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32; a bfloat16 q with
// float32 k/v is refused. o is bfloat16 when both are, else float32. Strides are in elements; d has stride 1.
// kv_lens: (B,) int32 on the device, or null to use kv_len for every
// batch row. window <= 0: no window. Returns the cudaError_t of the launch.
int flash_attention_fwd(int q_bf16, int kv_bf16, int head_dim,
                        const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int Hq, int Hkv,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        int causal, int window, int kv_len,
                        const void* kv_lens, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, Sq, Skv, Hq, Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, causal, window, kv_len,
           static_cast<const int*>(kv_lens), scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(p, head_dim, s);
  else if (q_bf16)
    err = cudaErrorInvalidValue;   // no caller passes bf16 q with f32 k/v
  else if (kv_bf16)
    err = launch<float, __nv_bfloat16, float>(p, head_dim, s);
  else
    err = launch<float, float, float>(p, head_dim, s);
  return (int)err;
}

}  // extern "C"
