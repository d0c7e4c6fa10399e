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
// the running softmax state are float32. Head sizes 32, 64 and 128.
//
// The rows of one (b, kv head) are its (query position, q head of the
// group) pairs, head fastest, so the q heads that share a KV head share
// every K/V tile (GQA without materialising a repeat). q, k and v are read
// through their strides in the (B, S, H, D) layout: the KV cache is never
// transposed or copied. A block walks only the key tiles its rows can see
// (kv_tile_range in kernels/flash_attention/kernel.py is the same rule),
// as the TPU kernel's pl.when skips them.
//
// Three paths, chosen by the wrapper from dtype and shape alone
// (kernel.py::b3_path); the entry point refuses a path its inputs do not
// fit.
//
//   "tc"    q, k, v bfloat16 and Sq > 1 (prefill, forward). Bound: the
//           4 D operations of every visible (query, key) pair at the
//           tensor cores' bfloat16 rate. Two consumer warpgroups of 64 rows
//           each (128 rows a block; one linear grid whose heaviest causal
//           row blocks start first); the Q tile is staged once in shared
//           memory with the hardware's 128-byte swizzle (64-byte at D 32);
//           K and V tiles of 64 keys fill a 3-stage ring (2 at D 128) by
//           16-byte cp.async, so the next tiles are in flight while one
//           computes. S = Q K^T is wgmma m64n64k16 with both operands in
//           shared memory (K stored (keys, D) is K-major for B); the online
//           softmax runs in registers on the accumulator fragment; P goes
//           to two bfloat16 parts in registers (truncated high part and
//           rounded remainder: P in bfloat16 alone moves o past its own
//           rounding where o cancels) and O += P V is wgmma with A from
//           registers and V read MN-major (the transpose bit), so no
//           transposed copy of V is made. Masks apply on boundary tiles
//           only. O is normalised, written as bfloat16 through shared
//           memory and stored 16 bytes at a time. What bounds it on this
//           card: the instruction rate and the exp unit in the softmax,
//           not the tensor cores (PERF.md).
//   "split" Sq == 1 (decode), every dtype pair. Bound: the bytes of the
//           live K and V rows. Flash-decoding: grid (splits, Hkv, B), one
//           split per 64 keys (split_plan in kernel.py); a block serves the
//           group's q heads of one (b, kv head), loads its chunk of K and V
//           with 16-byte cp.async (all in flight at once), and writes
//           float32 partials (acc, m, l) to a scratch tensor; a block whose
//           chunk holds no visible key (at or past kv_len[b]) exits at
//           once. A second kernel combines the splits by log-sum-exp, a
//           thread per (row, column). The lengths are read on the device:
//           no host read.
//   "simt"  float32 q with Sq > 1 (the float32-parameter runs, where tensor
//           cores would round to TF32): the first version of this kernel,
//           on the float32 cores. Grid (row blocks, Hkv, B), 16 rows a
//           block, 4 warps of 4 rows, 32-key tiles staged as float32.
//
// A view that is not 16-byte aligned (pointer or a stride) is loaded
// element by element on the "tc" and "split" paths.
//
// For training, "tc" and "simt" also write each row's log-sum-exp of its
// scaled scores (float32, (B, Hq, Sq)) when given a pointer for it: the
// row's running max and sum are in registers at the end, so it costs one
// store a row. The backward kernel (flash_attention_bwd.cu) recomputes
// the probabilities from it. "tc" can also write o in float32 before its
// rounding: the backward's rowsum(dO * O) from the bfloat16 o breaks
// sum_j dS[i, j] = 0 by 2^-9 of it, an error the keys' common component
// then multiplies (8.7e-2 relative L2 on a layer's wq gradient at
// tinyllama's width, measured). Without the pointers nothing else
// changes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
  int q_aligned;         // q's pointer and strides are 16-byte multiples
  int kv_aligned;        // idem for k and v
  float* lse;            // (B, Hq, Sq) float32 log-sum-exp of each row's
                         // scaled scores ("tc", "simt"), or null
  float* o32;            // "tc": (B, Sq, Hq, D) contiguous float32 copy of
                         // o before its rounding to bfloat16, or null
};

// The row (query pos, q head h)'s log-sum-exp, log sum_j exp(s_j * scale),
// from the natural-log running max m and sum l: +inf for a row that sees
// no key, so that the backward's exp(s * scale - lse) is 0 there.
__device__ __forceinline__ void store_lse(const Params& p, int b, int h,
                                          int pos, float m, float l) {
  p.lse[((long long)b * p.Hq + h) * p.Sq + pos] =
      l > 0.0f ? m + logf(l) : INFINITY;
}

__device__ __forceinline__ int row_kv_len(const Params& p, int b) {
  const int n = p.kv_lens != nullptr ? p.kv_lens[b] : p.kv_len;
  return max(0, min(n, p.Skv));
}

// The keys [k_begin, k_end) that some query position in pos_lo..pos_hi
// can see; k_end <= k_begin when none (kv_tile_range's rule).
__device__ __forceinline__ void visible_keys(const Params& p, int pos_lo,
                                             int pos_hi, int kv_len,
                                             int& k_begin, int& k_end) {
  const int q_offset = p.Skv - p.Sq;
  k_end = kv_len;
  if (p.causal) k_end = min(k_end, pos_hi + q_offset + 1);
  k_begin = 0;
  if (p.window > 0) k_begin = max(0, pos_lo + q_offset - p.window + 1);
}

__device__ __forceinline__ bool key_visible(const Params& p, int key,
                                            int qpos, int kv_len) {
  bool ok = key < kv_len;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window > 0) ok = ok && key > qpos - p.window;
  return ok;
}

// ------------------------------------------------ async copies, barriers
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory. Aligned: cp.async (zero-filled
// when !valid, the source then unread). Unaligned: element by element,
// synchronously. `base` is any readable address (the copy's source when
// !valid).
template <typename T>
__device__ __forceinline__ void copy16(uint32_t dst, const T* src,
                                       const T* base, bool valid,
                                       bool aligned) {
  if (aligned) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(valid ? src : base), "r"(valid ? 16 : 0)
                 : "memory");
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    if constexpr (sizeof(T) == 2) {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (uint32_t)s[2 * i] | ((uint32_t)s[2 * i + 1] << 16);
    } else {
      const unsigned int* s = reinterpret_cast<const unsigned int*>(src);
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = s[i];
    }
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier 1 + wg over the 128 threads of warpgroup wg
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// ------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers at this point of the program: wgmma writes
// them asynchronously, so no read or write may move across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as two bfloat16 pairs whose sum is (x, y) to ~2^-17: the high
// pair truncates (the top 16 bits of each float), the low pair rounds the
// exact remainder
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = pack_bf16(x - __uint_as_float(xb & 0xffff0000u),
                 y - __uint_as_float(yb & 0xffff0000u));
}

// 2^x in one MUFU instruction (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 64, float32) += A (64 x 16) * B (16 x 64), A and B from shared
// memory, both K-major (trans-a = trans-b = 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bfloat16 in registers) * B (16 x
// 64) from shared memory, MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32, float32) += A (64 x 16, bfloat16 in registers) * B (16 x
// 32) from shared memory, MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ================================================== path "simt"
namespace simt {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;             // fixed: float4 over rows
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;                 // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;

// Per tile of 32 keys, K and V are staged in shared memory as float32 (K
// rows padded by 4 floats so the float4 reads of 32 lanes hit distinct
// banks); lane j scores key j against the warp's 4 rows, the warp reduces
// max and sum with shuffles, and the probabilities go through shared
// memory to the P.V product, where lane c owns output columns c, c + 32...
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
    if (p.lse != nullptr && lane == 0) store_lse(p, b, h, pos, m[r], l[r]);
  }
}

}  // namespace simt

// ================================================== path "tc"
namespace tc {

constexpr int kWGRows = 64;                 // rows of one consumer warpgroup
constexpr int kWGs = 2;
constexpr int kRows = kWGRows * kWGs;       // rows per block (BLOCK_M)
constexpr int kKeys = 64;                   // keys per tile (BLOCK_N)
constexpr int kThreads = 128 * kWGs;

// Shared-memory layout of a (rows, D) bfloat16 tile: D is cut into atoms
// of kAtomCols columns (the swizzle width: 128 bytes, or 64 at D 32); an
// atom holds all the tile's rows, kAtomBytes apart; inside an atom the
// 16-byte chunk c of row r sits at chunk c ^ (row bits of the address),
// the hardware's swizzle, so wgmma reads what the copies wrote.
template <int D>
struct Cfg {
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kAtomBytes = kAtomCols * 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr uint32_t kSwMask = kAtomBytes / 16 - 1;
  static constexpr uint64_t kMode = kAtomBytes == 128 ? 1 : 2;
  static constexpr int kChunks = D / 8;     // 16-byte chunks per row
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
  static constexpr int kOCols = kAtomCols / 2;   // O floats per thread and atom

  // byte offset of element (row, col) in a tile of `rows` rows, swizzled
  static __device__ __forceinline__ uint32_t offset(int row, int col,
                                                    int rows) {
    const uint32_t off = (uint32_t)((col / kAtomCols) * rows * kAtomBytes +
                                    row * kAtomBytes + (col % kAtomCols) * 2);
    return off ^ (((off >> 7) & kSwMask) << 4);
  }
};

// Whether some row of positions pos_lo..pos_hi cannot see every key of
// the tile at k0 (kernel.py::tile_needs_mask is the same rule).
__device__ __forceinline__ bool needs_mask(const Params& p, int k0,
                                           int pos_lo, int pos_hi,
                                           int kv_len) {
  const int q_offset = p.Skv - p.Sq;
  bool full = k0 + kKeys <= kv_len;
  if (p.causal) full = full && k0 + kKeys - 1 <= pos_lo + q_offset;
  if (p.window > 0) full = full && k0 > pos_hi + q_offset - p.window;
  return !full;
}

// kStats: write the row's log-sum-exp and the float32 o (training); the
// inference instance compiles without that epilogue code, so its registers
// and timing are the forward's alone
template <int D, bool kStats>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
tc_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t s_raw = smem_u32(smem_raw);
  const uint32_t sQ = (s_raw + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;       // stage st: K, then V

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // one linear grid, (b, kv head) fastest: the row blocks that see the
  // most keys (causal) start first, across all heads, so light blocks,
  // not heavy ones, end the grid
  const int group = p.Hq / p.Hkv;
  const long long rows = (long long)p.Sq * group;
  const int heads = p.Hkv * p.B;
  const int hb = blockIdx.x % heads, rb = blockIdx.x / heads;
  const int b = hb / p.Hkv, kvh = hb % p.Hkv;
  const int n_rb = (int)((rows + kRows - 1) / kRows);
  const int row0 = (n_rb - 1 - rb) * kRows;
  const int nrows = (int)min((long long)kRows, rows - row0);
  const int q_offset = p.Skv - p.Sq;
  const int kv_len = row_kv_len(p, b);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb;
  const bool q_al = p.q_aligned, kv_al = p.kv_aligned;

  // the block's tiles, and the tiles of this warpgroup's rows
  int k_begin, k_end;
  visible_keys(p, row0 / group, (row0 + nrows - 1) / group, kv_len, k_begin,
               k_end);
  const int t_begin = k_begin / kKeys;
  const int t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;
  const int wrow0 = wg * kWGRows;
  const int wn = min(kWGRows, nrows - wrow0);   // <= 0: no rows
  const int wpos_lo = (row0 + wrow0) / group;
  const int wpos_hi = (row0 + wrow0 + max(wn, 1) - 1) / group;
  int wt_begin = 0, wt_end = 0;
  if (wn > 0) {
    int kb, ke;
    visible_keys(p, wpos_lo, wpos_hi, kv_len, kb, ke);
    if (ke > kb) {
      wt_begin = kb / kKeys;
      wt_end = (ke + kKeys - 1) / kKeys;
    }
  }

  // a thread copies the same 16-byte column chunk of kPer key rows of
  // every tile: their shared-memory offsets are fixed
  constexpr int kPer = kKeys * C::kChunks / kThreads;
  constexpr int kKeyStep = kThreads / C::kChunks;
  const int lc = tid % C::kChunks, lj = tid / C::kChunks;
  uint32_t kv_off[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    kv_off[u] = C::offset(lj + u * kKeyStep, lc * 8, kKeys);
  const bf16* kc = kg + lc * 8;
  const bf16* vc = vg + lc * 8;
  auto load_kv = [&](int tile, int stage) {
    const uint32_t sK = sKV + stage * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    if (kv_al) {   // one branch a tile, not one a copy
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int key = tile * kKeys + lj + u * kKeyStep;
        const bool valid = key < kv_len;   // keys past kv_len read as zeros
        copy16(sK + kv_off[u], kc + key * p.k_ss, kg, valid, true);
        copy16(sV + kv_off[u], vc + key * p.v_ss, vg, valid, true);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int key = tile * kKeys + lj + u * kKeyStep;
        const bool valid = key < kv_len;
        copy16(sK + kv_off[u], kc + key * p.k_ss, kg, valid, false);
        copy16(sV + kv_off[u], vc + key * p.v_ss, vg, valid, false);
      }
    }
  };

  // Q (all rows, one group with the first tile), then the ring's first
  // stages; one commit group per stage, empty past the last tile
  for (int i = tid; i < kRows * C::kChunks; i += kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = row0 + r;
    const int pos = row / group, h = kvh * group + row % group;
    copy16(sQ + C::offset(r, c * 8, kRows),
           qg + pos * p.q_ss + h * p.q_sh + c * 8, qg, r < nrows, q_al);
  }
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (t_begin + s < t_end) load_kv(t_begin + s, s);
    cp_async_commit();
  }

  float o[C::kAtoms][C::kOCols];
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int j = 0; j < C::kOCols; ++j) o[a][j] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  // this thread's two rows (g and g + 8 of its warp's 16)
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = (row0 + wrow0 + warp * 16 + g + 8 * h) / group + q_offset;
  const float scale_log2 = p.scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_async_wait<C::kStages - 2>();   // tile t (and Q) landed
    fence_async_smem();
    __syncthreads();                    // ... for every thread; tile t - 1 done
    if (t + C::kStages - 1 < t_end)
      load_kv(t + C::kStages - 1, (i + C::kStages - 1) % C::kStages);
    cp_async_commit();
    if (t < wt_begin || t >= wt_end) continue;   // warpgroup-uniform

    const uint32_t sK = sKV + (i % C::kStages) * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    const int k0 = t * kKeys;

    // S = Q K^T: D / 16 steps of m64n64k16
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int atom = kk * 16 / C::kAtomCols;
      const uint32_t within = (kk * 16 % C::kAtomCols) * 2;
      const uint64_t da = smem_desc(
          sQ + atom * kRows * C::kAtomBytes + wrow0 * C::kAtomBytes + within,
          16, 8 * C::kAtomBytes, C::kMode);
      const uint64_t db = smem_desc(
          sK + atom * kKeys * C::kAtomBytes + within, 16, 8 * C::kAtomBytes,
          C::kMode);
      wgmma_ss_n64(s, da, db);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // online softmax on the fragment: s[j] is row g + 8 * ((j >> 1) & 1)
    // of the warp's 16, key k0 + 8 * (j >> 2) + 2 * t4 + (j & 1); m is in
    // the log2 domain, and the max is taken on raw scores (scale > 0)
    if (needs_mask(p, k0, wpos_lo, wpos_hi, kv_len)) {   // boundary tile
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (!key_visible(p, k0 + 8 * (j >> 2) + 2 * t4 + (j & 1),
                         qpos[(j >> 1) & 1], kv_len))
          s[j] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float alpha[2], m_use[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      m_use[h] = m_new == -INFINITY ? 0.0f : m_new;   // no key seen yet
      alpha[h] = fast_exp2(m[h] - m_use[h]);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      s[j] = fast_exp2(fmaf(s[j], scale_log2, -m_use[h]));
      sum[h] += s[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
    // P as the A operand: the accumulator layout of keys 16 kk .. + 15 is
    // the register-A layout of one k16 step, so no shuffle is needed. P is
    // split into a bfloat16 high part and the bfloat16 of the remainder:
    // P V is then exact to ~2^-17 of P, where P in bfloat16 alone (2^-9)
    // moves o past its rounding wherever o cancels
    uint32_t pa[4][4], pb[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], pa[kk][e],
                   pb[kk][e]);
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
#pragma unroll
      for (int j = 0; j < C::kOCols; ++j) o[a][j] *= alpha[(j >> 1) & 1];
      fence_regs(o[a]);
    }

    // O += P V: 4 steps of 16 keys, per atom of D one instruction for
    // each part of P
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        const uint64_t dv = smem_desc(
            sV + a * kKeys * C::kAtomBytes + kk * 16 * C::kAtomBytes,
            kKeys * C::kAtomBytes, 8 * C::kAtomBytes, C::kMode);
        if constexpr (C::kAtomCols == 64) {
          wgmma_rs_n64(o[a], pa[kk], dv);
          wgmma_rs_n64(o[a], pb[kk], dv);
        } else {
          wgmma_rs_n32(o[a], pa[kk], dv);
          wgmma_rs_n32(o[a], pb[kk], dv);
        }
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) fence_regs(o[a]);
  }
  // nothing left in flight: when no tile ran, other threads' copies of Q
  // into the rows the epilogue reuses may still be landing
  cp_async_wait<0>();
  __syncthreads();
  if (wn <= 0) return;

  // O / l as bfloat16 into this warpgroup's rows of the Q tile (its own
  // wgmmas are done with them), then 16-byte stores
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    inv[h] = l[h] > 0.0f ? 1.0f / l[h] : 0.0f;
  }
  if (kStats && p.o32 != nullptr) {   // float32 o, two columns a store
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
#pragma unroll
      for (int j = 0; j < C::kOCols; j += 2) {
        const int h = (j >> 1) & 1;
        const int r = warp * 16 + g + 8 * h;
        if (r >= wn) continue;
        const int row = row0 + wrow0 + r;
        const int col = a * C::kAtomCols + 8 * (j >> 2) + 2 * t4;
        const long long at = (((long long)b * p.Sq + row / group) * p.Hq +
                              kvh * group + row % group) * D + col;
        *reinterpret_cast<float2*>(p.o32 + at) =
            make_float2(o[a][j] * inv[h], o[a][j + 1] * inv[h]);
      }
    }
  }
  if (kStats && t4 == 0) {   // m is in the log2 domain here
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      if (r >= wn) continue;
      const int row = row0 + wrow0 + r;
      store_lse(p, b, kvh * group + row % group, row / group,
                m[h] * 0.6931471805599453f, l[h]);
    }
  }
  uint8_t* smem_q = smem_raw + (sQ - s_raw);
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a) {
#pragma unroll
    for (int j = 0; j < C::kOCols; j += 2) {
      const int h = (j >> 1) & 1;
      const int r = wrow0 + warp * 16 + g + 8 * h;
      const int col = a * C::kAtomCols + 8 * (j >> 2) + 2 * t4;
      *reinterpret_cast<uint32_t*>(smem_q + C::offset(r, col, kRows)) =
          pack_bf16(o[a][j] * inv[h], o[a][j + 1] * inv[h]);
    }
  }
  warpgroup_barrier(wg);
  for (int i = wtid; i < kWGRows * C::kChunks; i += 128) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    if (r >= wn) break;
    const int row = row0 + wrow0 + r;
    const int pos = row / group, h = kvh * group + row % group;
    const uint4 val = *reinterpret_cast<const uint4*>(
        smem_q + C::offset(wrow0 + r, c * 8, kRows));
    *reinterpret_cast<uint4*>(og + pos * p.o_ss + h * p.o_sh + c * 8) = val;
  }
}

}  // namespace tc

// ================================================== path "split"
namespace split {

constexpr int kChunk = 64;                  // keys per split (SPLIT_CHUNK)
constexpr int kThreads = 128;

template <typename TKV, int D>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(TKV);     // elements per 16 B
  static constexpr int kKPitch = D + kVec;          // padded K row
  static constexpr int kRowChunks = D / kVec;
  static int smem(int group) {
    return (int)(kChunk * (kKPitch + D) * sizeof(TKV)) +
           group * (D + kChunk) * (int)sizeof(float);
  }
};

// The splits that hold a visible key of row b: [s_lo, s_hi).
__device__ __forceinline__ void live_splits(const Params& p, int kv_len,
                                            int& k_begin, int& k_end,
                                            int& s_lo, int& s_hi) {
  visible_keys(p, 0, 0, kv_len, k_begin, k_end);
  s_lo = k_begin / kChunk;
  s_hi = k_end > k_begin ? (k_end + kChunk - 1) / kChunk : s_lo;
}

// Offset of split s's partials of (b, kv head) in the scratch: acc
// (group, D), then m (group), then l (group).
__device__ __forceinline__ long long partial_offset(const Params& p,
                                                    int n_splits, int b,
                                                    int kvh, int s, int group,
                                                    int d) {
  return (((long long)b * p.Hkv + kvh) * n_splits + s) * group * (d + 2);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
split_partial_kernel(const Params p, float* part, int n_splits) {
  using C = Cfg<TKV, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  TKV* Ks = reinterpret_cast<TKV*>(smem);            // [kChunk][kKPitch]
  TKV* Vs = Ks + kChunk * C::kKPitch;                // [kChunk][D]
  float* Qs = reinterpret_cast<float*>(Vs + kChunk * D);   // [group][D]
  const int group = p.Hq / p.Hkv;
  float* Ps = Qs + group * D;                        // [group][kChunk]

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_len = row_kv_len(p, b);
  int k_begin, k_end, s_lo, s_hi;
  live_splits(p, kv_len, k_begin, k_end, s_lo, s_hi);
  if (s < s_lo || s >= s_hi) return;   // no visible key in this chunk
  const int c0 = s * kChunk;
  const int lo = max(c0, k_begin), hi = min(c0 + kChunk, k_end);

  const TQ* qg = static_cast<const TQ*>(p.q) + b * p.q_sb;
  const TKV* kg = static_cast<const TKV*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const TKV* vg = static_cast<const TKV*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const bool al = p.kv_aligned;

  // the chunk's K and V rows, every 16-byte copy in flight at once; keys
  // outside [lo, hi) read as zeros
  for (int i = tid; i < kChunk * C::kRowChunks; i += kThreads) {
    const int j = i / C::kRowChunks, c = i % C::kRowChunks;
    const int key = c0 + j;
    const bool valid = key >= lo && key < hi;
    copy16(smem_u32(Ks + j * C::kKPitch + c * C::kVec),
           kg + key * p.k_ss + c * C::kVec, kg, valid, al);
    copy16(smem_u32(Vs + j * D + c * C::kVec),
           vg + key * p.v_ss + c * C::kVec, vg, valid, al);
  }
  cp_async_commit();
  for (int i = tid; i < group * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[i] = to_float(qg[(kvh * group + r) * p.q_sh + d]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // scores: thread tid % kChunk takes key j against rows tid / kChunk +
  // 2 n, four rows at a time, each K chunk read once for the four
  {
    constexpr int kRowSets = kThreads / kChunk;
    const int j = tid % kChunk;
    const int key = c0 + j;
    const bool vis = key >= lo && key < hi;
    const TKV* kr = Ks + j * C::kKPitch;
    for (int r0 = tid / kChunk; r0 < group; r0 += 4 * kRowSets) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int c = 0; c < C::kRowChunks; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * C::kVec);
        const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* qr = Qs + min(r0 + u * kRowSets, group - 1) * D +
                            c * C::kVec;
#pragma unroll
          for (int w = 0; w < C::kVec; ++w) acc[u] += qr[w] * to_float(e[w]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + u * kRowSets < group)
          Ps[(r0 + u * kRowSets) * kChunk + j] =
              vis ? acc[u] * p.scale : -INFINITY;
    }
  }
  __syncthreads();

  // per row: max, exp, sum (warp w takes rows w, w + 4, ...); every live
  // split sees a key, so m is finite
  float* acc_out = part + partial_offset(p, n_splits, b, kvh, s, group, D);
  float* m_out = acc_out + group * D;
  float* l_out = m_out + group;
  for (int r = warp; r < group; r += kThreads / 32) {
    float* pr = Ps + r * kChunk;
    const float x0 = pr[lane], x1 = pr[lane + 32];
    const float mx = warp_max(fmaxf(x0, x1));
    const float p0 = expf(x0 - mx), p1 = expf(x1 - mx);
    const float sum = warp_sum(p0 + p1);
    pr[lane] = p0;
    pr[lane + 32] = p1;
    if (lane == 0) {
      m_out[r] = mx;
      l_out[r] = sum;
    }
  }
  __syncthreads();

  // acc = P V over the chunk's visible keys: thread tid % D takes column
  // d for rows tid / D + (kThreads / D) n, four rows at a time
  constexpr int kRowSets = kThreads / D;
  const int d = tid % D;
  for (int r0 = tid / D; r0 < group; r0 += 4 * kRowSets) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* pr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      pr[u] = Ps + min(r0 + u * kRowSets, group - 1) * kChunk;
    for (int jj = lo - c0; jj < hi - c0; ++jj) {
      const float vx = to_float(Vs[jj * D + d]);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += pr[u][jj] * vx;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (r0 + u * kRowSets < group)
        acc_out[(r0 + u * kRowSets) * D + d] = acc[u];
  }
}

// o = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) over the live
// splits of (b, kv head); zeros when there is none (kv_len 0). A block
// takes kThreads (row, column) elements, one a thread: a warp per row
// finds M and the denominator (lanes over splits), then each thread sums
// its element's weighted partials.
template <typename TO, int D>
__global__ void __launch_bounds__(kThreads)
split_combine_kernel(const Params p, const float* part, int n_splits) {
  constexpr int kRowsPerBlock = (kThreads + D - 1) / D;
  __shared__ float row_max[kRowsPerBlock], row_inv[kRowsPerBlock];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kThreads + threadIdx.x;   // (row, column)
  const int r0 = blockIdx.x * kThreads / D;            // first row
  int k_begin, k_end, s_lo, s_hi;
  live_splits(p, row_kv_len(p, b), k_begin, k_end, s_lo, s_hi);
  const long long stride = (long long)group * (D + 2);   // one split
  const float* base = part + partial_offset(p, n_splits, b, kvh, 0, group, D);
  for (int rr = warp; rr < kRowsPerBlock; rr += kThreads / 32) {
    const int r = min(r0 + rr, group - 1);
    float mx = -INFINITY;
    for (int s = s_lo + lane; s < s_hi; s += 32)
      mx = fmaxf(mx, base[s * stride + group * D + r]);
    mx = warp_max(mx);
    float den = 0.0f;
    for (int s = s_lo + lane; s < s_hi; s += 32)
      den += base[s * stride + group * D + group + r] *
             expf(base[s * stride + group * D + r] - mx);
    den = warp_sum(den);
    if (lane == 0) {
      row_max[rr] = mx;
      row_inv[rr] = den > 0.0f ? 1.0f / den : 0.0f;
    }
  }
  __syncthreads();
  if (i >= group * D) return;
  const int r = i / D, d = i % D;
  const float mx = row_max[r - r0];
  float num = 0.0f;
#pragma unroll 8
  for (int s = s_lo; s < s_hi; ++s)
    num += base[s * stride + r * D + d] *
           expf(base[s * stride + group * D + r] - mx);
  TO* og = static_cast<TO*>(p.o) + b * p.o_sb;
  store(og + (kvh * group + r) * p.o_sh + d, num * row_inv[r - r0]);
}

}  // namespace split

// ------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename TQ, typename TKV, typename TO, int D>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.Sq * (p.Hq / p.Hkv);
  const dim3 grid((unsigned)((rows + simt::kRows - 1) / simt::kRows),
                  (unsigned)p.Hkv, (unsigned)p.B);
  simt::flash_fwd_kernel<TQ, TKV, TO, D>
      <<<grid, simt::kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kStats>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.Sq * (p.Hq / p.Hkv);
  const int smem = tc::Cfg<D>::kSmem;
  cudaError_t err = allow_smem(tc::tc_fwd_kernel<D, kStats>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (rows + tc::kRows - 1) / tc::kRows * p.Hkv * p.B;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  tc::tc_fwd_kernel<D, kStats>
      <<<(unsigned)blocks, tc::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO, int D>
cudaError_t launch_split(const Params& p, float* part, int n_splits,
                         cudaStream_t stream) {
  const int smem = split::Cfg<TKV, D>::smem(p.Hq / p.Hkv);
  auto partial = split::split_partial_kernel<TQ, TKV, D>;
  cudaError_t err = allow_smem(partial, smem);
  if (err != cudaSuccess) return err;
  partial<<<dim3((unsigned)n_splits, (unsigned)p.Hkv, (unsigned)p.B),
            split::kThreads, smem, stream>>>(p, part, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int group = p.Hq / p.Hkv;
  split::split_combine_kernel<TO, D>
      <<<dim3((unsigned)((group * D + split::kThreads - 1) / split::kThreads),
              (unsigned)p.Hkv, (unsigned)p.B),
         split::kThreads, 0, stream>>>(p, part, n_splits);
  return cudaGetLastError();
}

enum Path { kSimt = 0, kTc = 1, kSplit = 2 };

template <typename TQ, typename TKV, typename TO, int D>
cudaError_t launch(int path, const Params& p, float* part, int n_splits,
                   cudaStream_t stream) {
  if (path == kSplit) return launch_split<TQ, TKV, TO, D>(p, part, n_splits,
                                                          stream);
  if (path == kSimt) return launch_simt<TQ, TKV, TO, D>(p, stream);
  if constexpr (sizeof(TQ) == 2 && sizeof(TKV) == 2)
    return p.lse != nullptr ? launch_tc<D, true>(p, stream)
                            : launch_tc<D, false>(p, stream);
  return cudaErrorInvalidValue;   // "tc" takes bfloat16 q, k and v only
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch_d(int path, int head_dim, const Params& p, float* part,
                     int n_splits, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<TQ, TKV, TO, 32>(path, p, part, n_splits, stream);
    case 64: return launch<TQ, TKV, TO, 64>(path, p, part, n_splits, stream);
    case 128: return launch<TQ, TKV, TO, 128>(path, p, part, n_splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, int elem, long long s0, long long s1,
               long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (s0 * elem) % 16 == 0 &&
         (s1 * elem) % 16 == 0 && (s2 * elem) % 16 == 0;
}

}  // namespace

extern "C" {

// path: 0 "simt", 1 "tc", 2 "split" (kernel.py::b3_path); a path the
// inputs do not fit is refused. q_bf16 / kv_bf16: 1 for bfloat16, 0 for
// float32; a bfloat16 q with float32 k/v is refused. o is bfloat16 when
// both are, else float32. Strides are in elements; d has stride 1.
// kv_lens: (B,) int32 on the device, or null to use kv_len for every
// batch row. window <= 0: no window. lse: a (B, Hq, Sq) float32 tensor
// that "tc" and "simt" fill with each row's log-sum-exp (the backward
// kernel's input), or null; "split" refuses one. o32: a contiguous
// (B, Sq, Hq, D) float32 tensor that "tc" fills with o before its
// rounding, given with lse, or null; the other paths refuse one. "split" needs Sq == 1 and a float32
// scratch of B * Hkv * n_splits * (Hq / Hkv) * (D + 2) values, n_splits =
// ceil(Skv / 64). Returns the cudaError_t of the launches.
int flash_attention_fwd(int path, int q_bf16, int kv_bf16, int head_dim,
                        const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int Hq, int Hkv,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        int causal, int window, int kv_len,
                        const void* kv_lens, float scale, void* scratch,
                        int n_splits, void* lse, void* o32, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (q_bf16 && !kv_bf16) return (int)cudaErrorInvalidValue;
  const int q_elem = q_bf16 ? 2 : 4, kv_elem = kv_bf16 ? 2 : 4;
  const int o_elem = q_bf16 && kv_bf16 ? 2 : 4;
  if (path == kTc) {
    if (!(q_bf16 && kv_bf16) || Sq <= 1 ||
        !aligned16(o, o_elem, o_sb, o_ss, o_sh))
      return (int)cudaErrorInvalidValue;
  } else if (path == kSplit) {
    if (Sq != 1 || lse != nullptr || (n_splits > 0 && scratch == nullptr) ||
        n_splits != (Skv + split::kChunk - 1) / split::kChunk)
      return (int)cudaErrorInvalidValue;
  } else if (path != kSimt) {
    return (int)cudaErrorInvalidValue;
  }
  if (o32 != nullptr && (path != kTc || lse == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)Sq * (Hq / Hkv) == 0 || B == 0) return (int)cudaSuccess;
  if (path == kSplit && n_splits == 0) {   // Skv 0: every row is zeros
    return (int)cudaMemsetAsync(o, 0, (size_t)B * o_sb * o_elem,
                                (cudaStream_t)stream);
  }
  Params p{q, k, v, o, B, Sq, Skv, Hq, Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, causal, window, kv_len,
           static_cast<const int*>(kv_lens), scale,
           aligned16(q, q_elem, q_sb, q_ss, q_sh),
           aligned16(k, kv_elem, k_sb, k_ss, k_sh) &&
               aligned16(v, kv_elem, v_sb, v_ss, v_sh),
           static_cast<float*>(lse), static_cast<float*>(o32)};
  cudaStream_t s = (cudaStream_t)stream;
  float* part = static_cast<float*>(scratch);
  cudaError_t err;
  if (q_bf16)
    err = launch_d<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        path, head_dim, p, part, n_splits, s);
  else if (kv_bf16)
    err = launch_d<float, __nv_bfloat16, float>(path, head_dim, p, part,
                                                n_splits, s);
  else
    err = launch_d<float, float, float>(path, head_dim, p, part, n_splits, s);
  return (int)err;
}

}  // extern "C"
