// Flash attention backward (kernel B3-bwd) for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package trains through XLA's
// autodiff of models/layers.py:47 chunked_attention (and :113
// dense_attention); the port's forward runs kernel B3
// (flash_attention.cu), which autograd cannot see through, so this kernel
// is its gradient, behind kernels/flash_attention/ops.py's
// torch.autograd.Function.
//
//   P[i, j]  = exp(q_i . k_j * scale - lse_i)     over the keys j visible to i
//   dV[j]    = sum_i P[i, j] dO_i
//   dP[i, j] = dO_i . v_j
//   dS[i, j] = P[i, j] (dP[i, j] - delta_i),       delta_i = dO_i . O_i
//   dQ[i]    = scale sum_j dS[i, j] k_j
//   dK[j]    = scale sum_i dS[i, j] q_i
//
// with B3's masks (causal at q_offset = Skv - Sq, a sliding window, an int
// kv_len) and its GQA mapping (q head h reads kv head h / (Hq / Hkv)); dK
// and dV sum over the q heads of each group. lse is the forward's per-row
// log-sum-exp (+inf for a row that sees no key) and o its output in
// float32 (before any rounding to bfloat16: delta from a rounded o breaks
// sum_j dS[i, j] = 0, and the keys' common component multiplies that).
// q, k, v, o and dO are read through their strides in the (B, S, H, D)
// layout; dq (B, Sq, Hq, D) and dk, dv (B, Skv, Hkv, D) are written
// contiguous, in the inputs' dtype (q, k, v and dO all float32, or all
// bfloat16). Head sizes 32, 64 and 128. Sums are float32.
//
// Two paths, chosen by dtype alone (kernel.py::b3_bwd_path), three kernels
// each, one launch each, on the caller's stream. Both start with
//   delta_kernel  delta_i = rowsum(dO_i * O_i), a warp per row, into a
//                 float32 (B, Hq, Sq) scratch,
// then sum dK and dV by key tile and dQ by query tile. Every output row is
// summed by one block in a fixed order: no atomics, so the result is the
// same bits run after run (a resumed training run equals an uninterrupted
// one). S and dP are computed in both kernels: 14 D operations a visible
// (query, key) pair ("tc": 16 D, below) against the 10 D that bound it.
//
//   "tc"    bfloat16 q, k, v and dO. Bound: those operations at the tensor
//           cores' bfloat16 rate (kernel.py::bwd_bound). wgmma throughout,
//           the tiles in shared memory in the forward's swizzled layout
//           (tc::Cfg, flash_attention.cu). A ring's tiles come by TMA, one
//           cp.async.bulk.tensor per tile and atom of D issued by one
//           thread and completing on the stage's mbarrier, where the view
//           allows a tensor map (16-byte aligned pointer and strides; the
//           maps are made on the host by cuTensorMapEncodeTiled); else,
//           and for what is staged once, by 16-byte cp.async from every
//           thread.
//   tc_dkv_kernel  one linear grid of key blocks (first keys first: under
//           causal they see the most rows). A block of two warpgroups
//           keeps 128 keys of K and V resident (64 a warpgroup) and walks
//           the group's q heads and, for each, the q tiles of 64 rows (32
//           at D 128) that bwd_q_tile_range names, Q, dO and the rows' lse
//           and delta through a 3-stage ring (2 at D 128). Per tile:
//           S^T = K Q^T and dP^T = V dO^T (m64nNk16, both operands from
//           shared memory, Q and dO K-major); P^T and dS^T in registers,
//           lse and delta read per column; then dV += P^T dO and dK += dS^T
//           Q with A from registers (the S^T accumulator is the register-A
//           layout of a k16 step over q rows) and Q, dO read MN-major (the
//           transpose bit), P and dS rounded to bfloat16. dK and dV stay
//           in float32 registers for the block's life.
//   tc_dq_kernel  the forward's "tc" loop: 128 (query position, q head of
//           the group) rows a block, heaviest causal row blocks first, Q
//           and dO staged once, K and V tiles of 64 keys through the ring
//           over the tiles kv_tile_range names. Per tile: S = Q K^T and dP =
//           dO V^T, P and dS in registers, dQ += dS K with K read
//           MN-major.
//           dS goes to the product as two bfloat16 parts (truncated high,
//           rounded remainder): sum_j dS[i, j] = 0 holds to ~2^-17 and the
//           keys' common component cancels, where dS in bfloat16 alone
//           (2^-9 per element, at random) puts ~10% relative error on dQ
//           when the keys share a large component (PERF.md). dK needs no
//           such identity, and dV sums P >= 0: one bfloat16 part each.
//           Masks apply on boundary tiles only (the forward's needs_mask
//           rule), in a loop of their own. What bounds "tc" on this card,
//           by a clock64 breakdown of a dK/dV tile (PERF.md): about a third
//           each for the span from the block's barrier to the first product
//           (where the ring's copies are issued), the softmax arithmetic,
//           and the four products; the exp unit alone is 5% of the call.
//   "simt"  float32 q, k, v and dO (the float32-parameter runs, which
//           tensor cores would round to TF32): the first version, on the
//           float32 cores.
//   dkv_kernel  grid (key tiles, Hkv, B): a block owns C keys of one kv
//           head (C = 64, 32 at D 128), keeps its K and V rows and its dK,
//           dV sums (registers) for its whole life, and walks the group's
//           q heads and, for each, the q tiles of R = 2048 / C rows that
//           can see one of its keys (the tile skip: the rows below the
//           causal diagonal of its first key and past the window of its
//           last are never loaded). A tile recomputes S and dP, then P and
//           dS through shared memory, then the two outer-product sums.
//   dq_kernel  grid (query tiles, Hq, B): a block owns R rows of one q
//           head (R = 64, 32 at D 128) and their dQ sums, and walks the
//           key tiles of C = 2048 / R keys they can see (kv_tile_range's
//           rule), recomputing S, dP and dS.
//           A thread owns a 4 x 4 block of the R x C score tile (strided
//           rows and keys, so the float4 reads of a warp hit distinct
//           banks) and a few rows of 4 output columns in the sums. Q, dO,
//           K and V are staged in shared memory as float32 rows padded by
//           4 floats.
//
// The helpers of the "tc" path (cp.async, wgmma, descriptors, the swizzle)
// are copies of flash_attention.cu's: each source builds alone.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// The packed arguments: int64 values in this order (kernel.py::BWD_ARGS).
enum Arg {
  kBf16,        // 0: q, k, v, dO float32, path "simt"; 1: bfloat16,
                // path "tc" (o is float32)
  kHeadDim,     // 32, 64 or 128
  kQ, kQSb, kQSs, kQSh,        // (B, Sq, Hq, D), strides in elements
  kK, kKSb, kKSs, kKSh,        // (B, Skv, Hkv, D)
  kV, kVSb, kVSs, kVSh,        // (B, Skv, Hkv, D)
  kO, kOSb, kOSs, kOSh,        // the forward's output, float32 (B, Sq, Hq, D)
  kDO, kDOSb, kDOSs, kDOSh,    // its gradient (B, Sq, Hq, D)
  kLse,         // (B, Hq, Sq) float32, from the forward
  kDelta,       // (B, Hq, Sq) float32 scratch
  kDQ,          // (B, Sq, Hq, D) contiguous
  kDK,          // (B, Skv, Hkv, D) contiguous
  kDV,          // (B, Skv, Hkv, D) contiguous
  kB, kSq, kSkv, kHq, kHkv,
  kCausal,
  kWindow,      // <= 0: no window
  kKvLen,       // keys at or past it are masked
  kNumArgs
};

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int B, Sq, Skv, Hq, Hkv, causal, window, kv_len;
  float scale;
  // "tc": the pointer and strides are 16-byte multiples (q; k and v; dO),
  // so 16-byte cp.async can load them
  int q_al, kv_al, do_al;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int key) {
  const int pos = qi + p.Skv - p.Sq;
  bool ok = qi < p.Sq && key < p.kv_len;
  if (p.causal) ok = ok && key <= pos;
  if (p.window > 0) ok = ok && key > pos - p.window;
  return ok;
}

// ROWS rows of D values from `base` (rows `stride` elements apart), rows
// first .. first + ROWS - 1, as float32 into `dst` (pitch D + 4); rows at
// or past `limit` read as zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long stride, int first,
                                          int limit) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = first + r;
    dst[r * (D + 4) + c] =
        row < limit ? to_float(base[(long long)row * stride + c]) : 0.0f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] = sum_d A[ra + i * rs][d] * B[cb + j * cs][d]: the thread's
// 4 x 4 block of an (rows of A) x (rows of B) product, both of pitch D + 4.
template <int D>
__device__ __forceinline__ void dot4x4(const float* A, int ra, int rs,
                                       const float* Bm, int cb, int cs,
                                       float acc[4][4]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ra + i * rs) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(Bm + (cb + j * cs) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                     a[i].w * b[j].w;
  }
}

// ------------------------------------------------------------ delta
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Params p) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Hq * p.Sq) return;
  const int pos = (int)(row % p.Sq);
  const long long bh = row / p.Sq;
  const int h = (int)(bh % p.Hq), b = (int)(bh / p.Hq);
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb +
                   pos * p.o_ss + h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + pos * p.do_ss +
               h * p.do_sh;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += o[c] * to_float(d[c]);
  s = warp_sum(s);
  if (lane == 0) p.delta[row] = s;
}

// Per-row lse and delta of q head h, rows first .. first + n - 1, into
// shared memory; rows past Sq get lse = +inf (P = 0).
__device__ __forceinline__ void load_row_stats(const Params& p, int b, int h,
                                               int first, int n,
                                               float* lse_s, float* delta_s) {
  const long long base = ((long long)b * p.Hq + h) * p.Sq;
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int qi = first + r;
    lse_s[r] = qi < p.Sq ? p.lse[base + qi] : INFINITY;
    delta_s[r] = qi < p.Sq ? p.delta[base + qi] : 0.0f;
  }
}

// -------------------------------------------------------------- dK, dV
template <int D>
struct KvCfg {
  static constexpr int C = D == 128 ? 32 : 64;   // keys a block owns
  static constexpr int R = 2048 / C;             // query rows a tile
  static constexpr int P = D + 4;
  static constexpr int PC = C + 4;
  static constexpr int NK = C * D / 512;         // keys a thread sums
  static constexpr int kSmemFloats = 2 * C * P + 2 * R * P + 2 * R * PC + 2 * R;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  using Cf = KvCfg<D>;
  constexpr int C = Cf::C, R = Cf::R, P = Cf::P, PC = Cf::PC, NK = Cf::NK;
  constexpr int CG = C / 4, RG = R / 4, DG = D / 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C * P;
  float* Qs = Vs + C * P;
  float* dOs = Qs + R * P;
  float* Ps = dOs + R * P;
  float* dSs = Ps + R * PC;
  float* lse_s = dSs + R * PC;
  float* delta_s = lse_s + R;

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * C;
  const int group = p.Hq / p.Hkv, q_offset = p.Skv - p.Sq;
  // the query rows that see some key of this block: [i_lo, i_hi)
  const int k_last = min(k0 + C, p.kv_len) - 1;
  int i_lo = 0, i_hi = 0;
  if (k_last >= k0) {
    i_lo = p.causal ? max(0, k0 - q_offset) : 0;
    i_hi = p.window > 0 ? min(p.Sq, k_last + p.window - q_offset) : p.Sq;
  }
  const int t_begin = i_lo / R;
  const int t_end = i_hi > i_lo ? (i_hi + R - 1) / R : t_begin;

  const int tid = threadIdx.x;
  const int tc = tid % CG, tr = tid / CG;       // score block: rows, keys
  const int dg = tid % DG, kg = tid / DG;       // sums: columns, keys
  float acc_k[NK][4], acc_v[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;

  if (t_end > t_begin) {
    const T* kg_ptr = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
    const T* vg_ptr = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
    load_rows<T, D, C>(Ks, kg_ptr, p.k_ss, k0, p.Skv);
    load_rows<T, D, C>(Vs, vg_ptr, p.v_ss, k0, p.Skv);
  }
  for (int gi = 0; gi < group && t_end > t_begin; ++gi) {
    const int h = kvh * group + gi;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * R;
      __syncthreads();   // the last tile's readers are done
      load_rows<T, D, R>(Qs, qg, p.q_ss, q0, p.Sq);
      load_rows<T, D, R>(dOs, dog, p.do_ss, q0, p.Sq);
      load_row_stats(p, b, h, q0, R, lse_s, delta_s);
      __syncthreads();

      float s[4][4], dp[4][4];
      dot4x4<D>(Qs, tr, RG, Ks, tc, CG, s);
      dot4x4<D>(dOs, tr, RG, Vs, tc, CG, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + i * RG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + j * CG;
          const float pr = visible(p, q0 + r, k0 + c)
                               ? expf(s[i][j] * p.scale - lse_s[r])
                               : 0.0f;
          Ps[r * PC + c] = pr;
          dSs[r * PC + c] = pr * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();

      // dV[key] += P[r, key] dO[r]; dK[key] += dS[r, key] Q[r]
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float4 o4 = ld4(dOs + r * P + dg * 4);
        const float4 q4 = ld4(Qs + r * P + dg * 4);
#pragma unroll
        for (int jj = 0; jj < NK / 4; ++jj) {
          const float4 pv = ld4(Ps + r * PC + kg * NK + 4 * jj);
          const float4 sv = ld4(dSs + r * PC + kg * NK + 4 * jj);
          const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
          const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float* av = acc_v[4 * jj + u];
            float* ak = acc_k[4 * jj + u];
            av[0] += pa[u] * o4.x; av[1] += pa[u] * o4.y;
            av[2] += pa[u] * o4.z; av[3] += pa[u] * o4.w;
            ak[0] += sa[u] * q4.x; ak[1] += sa[u] * q4.y;
            ak[2] += sa[u] * q4.z; ak[3] += sa[u] * q4.w;
          }
        }
      }
    }
  }

  // every key row of this block is written, zeros where no row sees it
  T* dk = static_cast<T*>(p.dk) + (((long long)b * p.Skv) * p.Hkv + kvh) * D;
  T* dv = static_cast<T*>(p.dv) + (((long long)b * p.Skv) * p.Hkv + kvh) * D;
  const long long row_stride = (long long)p.Hkv * D;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int key = k0 + kg * NK + j;
    if (key >= p.Skv) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store(dk + key * row_stride + dg * 4 + e, acc_k[j][e] * p.scale);
      store(dv + key * row_stride + dg * 4 + e, acc_v[j][e]);
    }
  }
}

// ------------------------------------------------------------------ dQ
template <int D>
struct QCfg {
  static constexpr int R = D == 128 ? 32 : 64;   // query rows a block owns
  static constexpr int C = 2048 / R;             // keys a tile
  static constexpr int P = D + 4;
  static constexpr int PR = R + 4;
  static constexpr int NR = R * D / 512;         // rows a thread sums
  static constexpr int kSmemFloats = 2 * R * P + 2 * C * P + C * PR + 2 * R;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  using Cf = QCfg<D>;
  constexpr int C = Cf::C, R = Cf::R, P = Cf::P, PR = Cf::PR, NR = Cf::NR;
  constexpr int CG = C / 4, RG = R / 4, DG = D / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + R * P;
  float* Ks = dOs + R * P;
  float* Vs = Ks + C * P;
  float* dSt = Vs + C * P;        // dS transposed: (keys, rows)
  float* lse_s = dSt + C * PR;
  float* delta_s = lse_s + R;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const int group = p.Hq / p.Hkv, kvh = h / group;
  const int q_offset = p.Skv - p.Sq;
  // the key tiles its rows can see (kernel.py::kv_tile_range)
  const int pos_hi = min(q0 + R, p.Sq) - 1;
  int k_end = p.kv_len;
  if (p.causal) k_end = min(k_end, pos_hi + q_offset + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 + q_offset - p.window + 1);
  const int t_begin = k_begin / C;
  const int t_end = k_end > k_begin ? (k_end + C - 1) / C : t_begin;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kg_ptr = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg_ptr = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  if (t_end > t_begin) {
    load_rows<T, D, R>(Qs, qg, p.q_ss, q0, p.Sq);
    load_rows<T, D, R>(dOs, dog, p.do_ss, q0, p.Sq);
    load_row_stats(p, b, h, q0, R, lse_s, delta_s);
  }

  const int tid = threadIdx.x;
  const int tc = tid % CG, tr = tid / CG;       // score block: rows, keys
  const int dg = tid % DG, rg = tid / DG;       // sums: columns, rows
  float acc[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * C;
    __syncthreads();   // Q and dO staged / the last tile's readers done
    load_rows<T, D, C>(Ks, kg_ptr, p.k_ss, k0, p.Skv);
    load_rows<T, D, C>(Vs, vg_ptr, p.v_ss, k0, p.Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot4x4<D>(Qs, tr, RG, Ks, tc, CG, s);
    dot4x4<D>(dOs, tr, RG, Vs, tc, CG, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + i * RG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + j * CG;
        const float pr = visible(p, q0 + r, k0 + c)
                             ? expf(s[i][j] * p.scale - lse_s[r])
                             : 0.0f;
        dSt[c * PR + r] = pr * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ[row] += dS[row, key] K[key]
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      const float4 k4 = ld4(Ks + c * P + dg * 4);
#pragma unroll
      for (int ii = 0; ii < NR / 4; ++ii) {
        const float4 sv = ld4(dSt + c * PR + rg * NR + 4 * ii);
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* a = acc[4 * ii + u];
          a[0] += sa[u] * k4.x; a[1] += sa[u] * k4.y;
          a[2] += sa[u] * k4.z; a[3] += sa[u] * k4.w;
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + ((long long)b * p.Sq * p.Hq + h) * D;
  const long long row_stride = (long long)p.Hq * D;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int qi = q0 + rg * NR + i;
    if (qi >= p.Sq) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(dq + qi * row_stride + dg * 4 + e, acc[i][e] * p.scale);
  }
}

// ================================================== path "tc"
namespace tc {

constexpr int kWGs = 2;                     // consumer warpgroups a block
constexpr int kThreads = 128 * kWGs;
constexpr int kKeys = 64;                   // keys: a dK/dV warpgroup's; a dQ tile's
constexpr int kBlockKeys = kKeys * kWGs;    // keys a dK/dV block owns
constexpr int kWGRows = 64;                 // dQ rows of one warpgroup
constexpr int kRows = kWGRows * kWGs;       // dQ rows a block owns
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of a (rows, D) bfloat16 tile, as flash_attention.cu's
// tc::Cfg: D is cut into atoms of kAtomCols columns (the swizzle width: 128
// bytes, or 64 at D 32); an atom holds all the tile's rows, kAtomBytes
// apart; inside an atom the 16-byte chunk c of row r sits at chunk c ^ (row
// bits of the address), the hardware's swizzle, so wgmma reads what the
// copies wrote.
template <int D>
struct Cfg {
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kAtomBytes = kAtomCols * 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr uint32_t kSwMask = kAtomBytes / 16 - 1;
  static constexpr uint64_t kMode = kAtomBytes == 128 ? 1 : 2;
  static constexpr int kChunks = D / 8;     // 16-byte chunks per row
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kOCols = kAtomCols / 2;   // sum floats per thread and atom
  // dK/dV: q rows a tile (the N of S^T = K Q^T; 32 at D 128 keeps dK, dV,
  // S^T and dP^T in registers); K and V of the block, then per stage a Q
  // and a dO tile, then per stage the tile's lse and delta
  static constexpr int kQRows = D == 128 ? 32 : 64;
  static constexpr int kKVBytes = kBlockKeys * D * 2;
  static constexpr int kQTileBytes = kQRows * D * 2;
  static constexpr int kDkvSmem = 2 * kKVBytes + kStages * 2 * kQTileBytes +
                                  kStages * 2 * kQRows * 4 + kStages * 8 + 1024;
  // dQ: the block's Q and dO rows, then per stage a K and a V tile
  static constexpr int kRowBytes = kRows * D * 2;
  static constexpr int kKTileBytes = kKeys * D * 2;
  static constexpr int kDqSmem =
      2 * kRowBytes + kStages * 2 * kKTileBytes + kStages * 8 + 1024;

  // byte offset of element (row, col) in a tile of `rows` rows, swizzled
  static __device__ __forceinline__ uint32_t offset(int row, int col,
                                                    int rows) {
    const uint32_t off = (uint32_t)((col / kAtomCols) * rows * kAtomBytes +
                                    row * kAtomBytes + (col % kAtomCols) * 2);
    return off ^ (((off >> 7) & kSwMask) << 4);
  }
};

// ------------------------------------------- async copies, wgmma helpers
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory. Aligned: cp.async (zero-filled
// when !valid, the source then unread). Unaligned: element by element,
// synchronously. `base` is any readable address.
__device__ __forceinline__ void copy16(uint32_t dst, const __nv_bfloat16* src,
                                       const __nv_bfloat16* base, bool valid,
                                       bool aligned) {
  if (aligned) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(valid ? src : base), "r"(valid ? 16 : 0)
                 : "memory");
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)s[2 * i] | ((uint32_t)s[2 * i + 1] << 16);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}
// 4 bytes (one float) by cp.async, zero-filled when !valid
__device__ __forceinline__ void copy4(uint32_t dst, const float* src,
                                      const float* base, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(valid ? src : base), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers, one per ring stage, completed by the bytes of its TMA copies
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// One box of a 4-d tensor map (D, heads, rows, batch) into shared memory,
// swizzled as the map says, completing on `bar`. Rows past the map's
// extent read as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, uint64_t map,
                                         uint32_t bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(map), "r"(col), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}
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

// D (64 x N, float32) += A (64 x 16) * B (16 x N), A and B from shared
// memory, both K-major (trans-a = trans-b = 0); N = 64 or 32.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
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
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x N, float32) += A (64 x 16, bfloat16 in registers) * B (16 x N)
// from shared memory, MN-major (trans-b = 1); N = 64 or 32.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
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

// K-major operand: k16 step kk of the `rows`-row tile at `tile`, from
// its row `row0` (a multiple of 8)
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                          int kk) {
  using C = Cfg<D>;
  const int atom = kk * 16 / C::kAtomCols;
  const uint32_t within = (kk * 16 % C::kAtomCols) * 2;
  return smem_desc(tile + atom * rows * C::kAtomBytes + row0 * C::kAtomBytes +
                       within,
                   16, 8 * C::kAtomBytes, C::kMode);
}
// MN-major operand: rows 16 kk .. 16 kk + 15 of the `rows`-row tile at
// `tile` as K, atom a of its columns as N
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk,
                                           int a) {
  using C = Cfg<D>;
  return smem_desc(tile + a * rows * C::kAtomBytes + kk * 16 * C::kAtomBytes,
                   rows * C::kAtomBytes, 8 * C::kAtomBytes, C::kMode);
}

__device__ __forceinline__ bool key_visible(const Params& p, int key,
                                            int qpos) {
  bool ok = key < p.kv_len;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window > 0) ok = ok && key > qpos - p.window;
  return ok;
}

// Whether some row of query positions pos_lo..pos_hi cannot see every
// one of the kKeys keys at k0 (kernel.py::tile_needs_mask, the forward's
// needs_mask rule).
__device__ __forceinline__ bool needs_mask(const Params& p, int k0,
                                           int pos_lo, int pos_hi) {
  const int q_offset = p.Skv - p.Sq;
  bool full = k0 + kKeys <= p.kv_len;
  if (p.causal) full = full && k0 + kKeys - 1 <= pos_lo + q_offset;
  if (p.window > 0) full = full && k0 > pos_hi + q_offset - p.window;
  return !full;
}

// The q tiles of `rows` rows holding a row that sees one of the keys
// k0 .. k0 + n - 1: [t_begin, t_end) (kernel.py::bwd_q_tile_range).
__device__ __forceinline__ void q_tiles(const Params& p, int k0, int n,
                                        int rows, int& t_begin, int& t_end) {
  const int q_offset = p.Skv - p.Sq;
  const int k_last = min(k0 + n, p.kv_len) - 1;
  t_begin = t_end = 0;
  if (k_last < k0) return;
  const int i_lo = p.causal ? max(0, k0 - q_offset) : 0;
  const int i_hi =
      p.window > 0 ? min(p.Sq, k_last + p.window - q_offset) : p.Sq;
  if (i_hi <= i_lo) return;
  t_begin = i_lo / rows;
  t_end = (i_hi + rows - 1) / rows;
}

// ------------------------------------------------------------- dK, dV
// tq, tdo: TMA maps of q and dO (rows: Sq; boxes of kQRows rows) when
// `tma`, else unused and the ring is filled by cp.async.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tc_dkv_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo, bool tma) {
  using C = Cfg<D>;
  using bf16 = __nv_bfloat16;
  constexpr int NQ = C::kQRows;
  constexpr int kSteps = NQ / 16;            // k16 steps of dV, dK
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t s_raw = smem_u32(smem_raw);
  const uint32_t sK = (s_raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::kKVBytes;
  const uint32_t sRing = sV + C::kKVBytes;   // stage st: Q, then dO
  const uint32_t sStats = sRing + C::kStages * 2 * C::kQTileBytes;
  const uint32_t sBar = sStats + C::kStages * 2 * NQ * 4;   // per stage
  const float* stats = reinterpret_cast<const float*>(smem_raw +
                                                      (sStats - s_raw));

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // one linear grid, (b, kv head) fastest, first keys first
  const int group = p.Hq / p.Hkv;
  const int heads = p.Hkv * p.B;
  const int hb = blockIdx.x % heads, kb = blockIdx.x / heads;
  const int b = hb / p.Hkv, kvh = hb % p.Hkv;
  const int k0 = kb * kBlockKeys, wk0 = k0 + wg * kKeys;

  // the block's q tiles (per q head), and this warpgroup's
  int t_begin, t_end, wt_begin, wt_end;
  q_tiles(p, k0, kBlockKeys, NQ, t_begin, t_end);
  q_tiles(p, wk0, kKeys, NQ, wt_begin, wt_end);
  const int nt = t_end - t_begin;
  const int items = nt > 0 ? group * nt : 0;   // (q head, q tile), tile fastest

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_sb;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  const uint64_t map_q = reinterpret_cast<uint64_t>(&tq);
  const uint64_t map_do = reinterpret_cast<uint64_t>(&tdo);
  if (tma && tid == 0) {
    for (int st = 0; st < C::kStages; ++st) mbar_init(sBar + 8 * st);
    mbar_init_fence();
  }
  __syncthreads();

  // Q and dO of item `it` (rows past Sq read as zeros): one TMA box per
  // tensor and atom of D, issued by one thread, or 16-byte copies by all
  auto load_item = [&](int it, int stage) {
    const int h = kvh * group + it / nt, q0 = (t_begin + it % nt) * NQ;
    const uint32_t sQ = sRing + stage * 2 * C::kQTileBytes;
    const uint32_t sdO = sQ + C::kQTileBytes;
    if (tma) {
      if (tid == 0) {
        const uint32_t bar = sBar + 8 * stage;
        mbar_expect_tx(bar, 2 * C::kQTileBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          const uint32_t at = a * NQ * C::kAtomBytes;
          tma_load(sQ + at, map_q, bar, a * C::kAtomCols, h, q0, b);
          tma_load(sdO + at, map_do, bar, a * C::kAtomCols, h, q0, b);
        }
      }
    } else {
      const bf16* qh = qg + h * p.q_sh;
      const bf16* doh = dog + h * p.do_sh;
      for (int i = tid; i < NQ * C::kChunks; i += kThreads) {
        const int r = i / C::kChunks, c = i % C::kChunks;
        const int row = q0 + r;
        const bool valid = row < p.Sq;
        const uint32_t off = C::offset(r, c * 8, NQ);
        copy16(sQ + off, qh + row * p.q_ss + c * 8, qg, valid, p.q_al);
        copy16(sdO + off, doh + row * p.do_ss + c * 8, dog, valid, p.do_al);
      }
    }
    if (tid < 2 * NQ) {                   // the rows' lse, then delta
      const float* src = (tid < NQ ? p.lse : p.delta) +
                         ((long long)b * p.Hq + h) * p.Sq;
      const int row = q0 + tid % NQ;
      copy4(sStats + (stage * 2 * NQ + tid) * 4, src + row, src,
            row < p.Sq);
    }
  };

  // K and V (keys past kv_len read as zeros) with the ring's first item,
  // one commit group per stage, empty past the last item
  if (items > 0) {
    for (int i = tid; i < kBlockKeys * C::kChunks; i += kThreads) {
      const int r = i / C::kChunks, c = i % C::kChunks;
      const int key = k0 + r;
      const bool valid = key < p.kv_len;
      const uint32_t off = C::offset(r, c * 8, kBlockKeys);
      copy16(sK + off, kg + key * p.k_ss + c * 8, kg, valid, p.kv_al);
      copy16(sV + off, vg + key * p.v_ss + c * 8, vg, valid, p.kv_al);
    }
  }
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < items) load_item(s, s);
    cp_async_commit();
  }

  float dk[C::kAtoms][C::kOCols], dv[C::kAtoms][C::kOCols];
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int j = 0; j < C::kOCols; ++j) dk[a][j] = dv[a][j] = 0.0f;
  const float scale_log2 = p.scale * kLog2e;
  const int key_base = wk0 + warp * 16 + g;   // this thread's keys: + 0, + 8

  for (int it = 0; it < items; ++it) {
    cp_async_wait<C::kStages - 2>();   // item it (and K, V) landed
    if (tma) mbar_wait(sBar + 8 * (it % C::kStages), (it / C::kStages) & 1);
    fence_async_smem();
    __syncthreads();                    // ... for every thread; item it - 1 done
    if (it + C::kStages - 1 < items)
      load_item(it + C::kStages - 1, (it + C::kStages - 1) % C::kStages);
    cp_async_commit();
    const int t = t_begin + it % nt;
    if (t < wt_begin || t >= wt_end) continue;   // warpgroup-uniform

    const int stage = it % C::kStages;
    const uint32_t sQ = sRing + stage * 2 * C::kQTileBytes;
    const uint32_t sdO = sQ + C::kQTileBytes;
    const float* lse_s = stats + stage * 2 * NQ;
    const float* delta_s = lse_s + NQ;
    const int q0 = t * NQ;

    // S^T = K Q^T and dP^T = V dO^T: D / 16 steps of m64nNQk16. s[j] is
    // key key_base + 8 * ((j >> 1) & 1), q row q0 + 8 * (j >> 2) + 2 * t4
    // + (j & 1)
    float s[NQ / 2], dp[NQ / 2];
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) s[j] = dp[j] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, kmajor<D>(sK, kBlockKeys, wg * kKeys, kk),
               kmajor<D>(sQ, NQ, 0, kk));
      wgmma_ss(dp, kmajor<D>(sV, kBlockKeys, wg * kKeys, kk),
               kmajor<D>(sdO, NQ, 0, kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T, then (boundary tiles only, in a loop of its own: the test per
    // entry costs more than the exponential) masked entries set to 0,
    // whatever lse holds there (+inf, or zeros past Sq), then dS^T. lse
    // and delta are per column: s[4 c + e] is column 8 c + 2 t4 + (e & 1)
#pragma unroll
    for (int c = 0; c < NQ / 8; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * c + e] = fast_exp2(fmaf(s[4 * c + e], scale_log2,
                                      -((e & 1) ? l2.y : l2.x) * kLog2e));
    }
    if (q0 + NQ > p.Sq || needs_mask(p, wk0, q0, q0 + NQ - 1)) {
      const int q_offset = p.Skv - p.Sq;
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        const int qi = q0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
        if (qi >= p.Sq || !key_visible(p, key_base + 8 * ((j >> 1) & 1),
                                       qi + q_offset))
          s[j] = 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < NQ / 8; ++c) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(delta_s + 8 * c + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * c + e] = s[4 * c + e] * (dp[4 * c + e] - ((e & 1) ? d2.y : d2.x));
    }
    // as A operands: the accumulator layout of q rows 16 kk .. + 15 is the
    // register-A layout of one k16 step
    uint32_t pa[kSteps][4], sa[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        sa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }

    // dV += P^T dO, dK += dS^T Q: per k16 step and atom of D, Q and dO
    // read MN-major
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
      fence_regs(dk[a]);
      fence_regs(dv[a]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        wgmma_rs(dv[a], pa[kk], mnmajor<D>(sdO, NQ, kk, a));
        wgmma_rs(dk[a], sa[kk], mnmajor<D>(sQ, NQ, kk, a));
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
      fence_regs(dk[a]);
      fence_regs(dv[a]);
    }
  }
  cp_async_wait<0>();

  // every key row below Skv is written, zeros where no row sees it
  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int j = 0; j < C::kOCols; j += 2) {
      const int key = key_base + 8 * ((j >> 1) & 1);
      if (key >= p.Skv) continue;
      const int col = a * C::kAtomCols + 8 * (j >> 2) + 2 * t4;
      const long long at =
          (((long long)b * p.Skv + key) * p.Hkv + kvh) * D + col;
      *reinterpret_cast<uint32_t*>(dkg + at) =
          pack_bf16(dk[a][j] * p.scale, dk[a][j + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + at) =
          pack_bf16(dv[a][j], dv[a][j + 1]);
    }
}

// ------------------------------------------------------------------ dQ
// tk, tv: TMA maps of k and v (rows: kv_len, so keys past it read as
// zeros; boxes of kKeys rows) when `tma`, else unused and the ring is
// filled by cp.async.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tc_dq_kernel(const Params p, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bool tma) {
  using C = Cfg<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_raw = smem_u32(smem_raw);
  const uint32_t sQ = (s_raw + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::kRowBytes;
  const uint32_t sKV = sdO + C::kRowBytes;   // stage st: K, then V
  const uint32_t sBar = sKV + C::kStages * 2 * C::kKTileBytes;   // per stage

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the forward's grid: (query position, q head of the group) rows, head
  // fastest; (b, kv head) fastest in the linear grid, heaviest causal row
  // blocks first
  const int group = p.Hq / p.Hkv;
  const long long rows = (long long)p.Sq * group;
  const int heads = p.Hkv * p.B;
  const int hb = blockIdx.x % heads, rb = blockIdx.x / heads;
  const int b = hb / p.Hkv, kvh = hb % p.Hkv;
  const int n_rb = (int)((rows + kRows - 1) / kRows);
  const int row0 = (n_rb - 1 - rb) * kRows;
  const int nrows = (int)min((long long)kRows, rows - row0);
  const int q_offset = p.Skv - p.Sq;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_sb;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the key tiles of the block's rows, and of this warpgroup's
  // (kernel.py::kv_tile_range)
  auto key_tiles = [&](int pos_lo, int pos_hi, int& t0, int& t1) {
    int k_end = p.kv_len;
    if (p.causal) k_end = min(k_end, pos_hi + q_offset + 1);
    const int k_begin =
        p.window > 0 ? max(0, pos_lo + q_offset - p.window + 1) : 0;
    t0 = k_begin / kKeys;
    t1 = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t0;
  };
  int t_begin, t_end;
  key_tiles(row0 / group, (row0 + nrows - 1) / group, t_begin, t_end);
  const int wrow0 = wg * kWGRows;
  const int wn = min(kWGRows, nrows - wrow0);   // <= 0: no rows
  const int wpos_lo = (row0 + wrow0) / group;
  const int wpos_hi = (row0 + wrow0 + max(wn, 1) - 1) / group;
  int wt_begin = 0, wt_end = 0;
  if (wn > 0) key_tiles(wpos_lo, wpos_hi, wt_begin, wt_end);

  // a thread copies the same 16-byte column chunk of kPer key rows of
  // every tile: their shared-memory offsets are fixed
  constexpr int kPer = kKeys * C::kChunks / kThreads;
  constexpr int kKeyStep = kThreads / C::kChunks;
  const int lc = tid % C::kChunks, lj = tid / C::kChunks;
  uint32_t kv_off[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    kv_off[u] = C::offset(lj + u * kKeyStep, lc * 8, kKeys);
  const uint64_t map_k = reinterpret_cast<uint64_t>(&tk);
  const uint64_t map_v = reinterpret_cast<uint64_t>(&tv);
  if (tma && tid == 0) {
    for (int st = 0; st < C::kStages; ++st) mbar_init(sBar + 8 * st);
    mbar_init_fence();
  }
  __syncthreads();
  // K and V of a tile (keys past kv_len read as zeros): one TMA box per
  // tensor and atom of D, issued by one thread, or 16-byte copies by all
  auto load_kv = [&](int tile, int stage) {
    const uint32_t sK = sKV + stage * 2 * C::kKTileBytes;
    const uint32_t sV = sK + C::kKTileBytes;
    if (tma) {
      if (tid == 0) {
        const uint32_t bar = sBar + 8 * stage;
        mbar_expect_tx(bar, 2 * C::kKTileBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          const uint32_t at = a * kKeys * C::kAtomBytes;
          tma_load(sK + at, map_k, bar, a * C::kAtomCols, kvh, tile * kKeys, b);
          tma_load(sV + at, map_v, bar, a * C::kAtomCols, kvh, tile * kKeys, b);
        }
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int key = tile * kKeys + lj + u * kKeyStep;
      const bool valid = key < p.kv_len;
      copy16(sK + kv_off[u], kg + key * p.k_ss + lc * 8, kg, valid, p.kv_al);
      copy16(sV + kv_off[u], vg + key * p.v_ss + lc * 8, vg, valid, p.kv_al);
    }
  };

  // Q and dO (all rows, one group with the first tile), then the ring's
  // first stages
  for (int i = tid; i < kRows * C::kChunks; i += kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = row0 + r;
    const int pos = row / group, h = kvh * group + row % group;
    const uint32_t off = C::offset(r, c * 8, kRows);
    copy16(sQ + off, qg + pos * p.q_ss + h * p.q_sh + c * 8, qg, r < nrows,
           p.q_al);
    copy16(sdO + off, dog + pos * p.do_ss + h * p.do_sh + c * 8, dog,
           r < nrows, p.do_al);
  }
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (t_begin + s < t_end) load_kv(t_begin + s, s);
    cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of its warp's 16): position, head,
  // lse in the log2 domain (+inf past the block's rows: P = 0) and delta
  int qpos[2], qhead[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow0 + warp * 16 + g + 8 * h;
    const int row = row0 + r;
    qpos[h] = row / group;
    qhead[h] = kvh * group + row % group;
    const long long at = ((long long)b * p.Hq + qhead[h]) * p.Sq + qpos[h];
    lse2[h] = r < nrows ? p.lse[at] * kLog2e : INFINITY;
    delta[h] = r < nrows ? p.delta[at] : 0.0f;
  }
  float dq[C::kAtoms][C::kOCols];
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int j = 0; j < C::kOCols; ++j) dq[a][j] = 0.0f;
  const float scale_log2 = p.scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_async_wait<C::kStages - 2>();   // tile t (and Q, dO) landed
    if (tma) mbar_wait(sBar + 8 * (i % C::kStages), (i / C::kStages) & 1);
    fence_async_smem();
    __syncthreads();                    // ... for every thread; tile t - 1 done
    if (t + C::kStages - 1 < t_end)
      load_kv(t + C::kStages - 1, (i + C::kStages - 1) % C::kStages);
    cp_async_commit();
    if (t < wt_begin || t >= wt_end) continue;   // warpgroup-uniform

    const uint32_t sK = sKV + (i % C::kStages) * 2 * C::kKTileBytes;
    const uint32_t sV = sK + C::kKTileBytes;
    const int k0 = t * kKeys;

    // S = Q K^T and dP = dO V^T: D / 16 steps of m64n64k16. s[j] is row
    // g + 8 * ((j >> 1) & 1) of the warp's 16, key k0 + 8 * (j >> 2) + 2 *
    // t4 + (j & 1)
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, kmajor<D>(sQ, kRows, wrow0, kk), kmajor<D>(sK, kKeys, 0, kk));
      wgmma_ss(dp, kmajor<D>(sdO, kRows, wrow0, kk),
               kmajor<D>(sV, kKeys, 0, kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P, then masked entries set to 0 (boundary tiles only, in a loop of
    // its own), then dS, split into two bfloat16 parts as A operands (the
    // accumulator layout of keys 16 kk .. + 15 is the register-A layout of
    // one k16 step)
#pragma unroll
    for (int j = 0; j < 32; ++j)
      s[j] = fast_exp2(fmaf(s[j], scale_log2, -lse2[(j >> 1) & 1]));
    if (needs_mask(p, k0, wpos_lo, wpos_hi)) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (!key_visible(p, k0 + 8 * (j >> 2) + 2 * t4 + (j & 1),
                         qpos[(j >> 1) & 1] + q_offset))
          s[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - delta[(j >> 1) & 1]);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1], hi[kk][e],
                   lo[kk][e]);

    // dQ += dS K: 4 steps of 16 keys, per atom of D one instruction for
    // each part of dS, K read MN-major
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) fence_regs(dq[a]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        const uint64_t dk = mnmajor<D>(sK, kKeys, kk, a);
        wgmma_rs(dq[a], hi[kk], dk);
        wgmma_rs(dq[a], lo[kk], dk);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) fence_regs(dq[a]);
  }
  cp_async_wait<0>();
  if (wn <= 0) return;

  bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int j = 0; j < C::kOCols; j += 2) {
      const int h = (j >> 1) & 1;
      if (warp * 16 + g + 8 * h >= wn) continue;
      const int col = a * C::kAtomCols + 8 * (j >> 2) + 2 * t4;
      const long long at =
          (((long long)b * p.Sq + qpos[h]) * p.Hq + qhead[h]) * D + col;
      *reinterpret_cast<uint32_t*>(dqg + at) =
          pack_bf16(dq[a][j] * p.scale, dq[a][j + 1] * p.scale);
    }
}

}  // namespace tc

// ------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  delta_kernel<T, D><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(p, stream);
  if (err != cudaSuccess) return err;

  const int kv_smem = KvCfg<D>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(dkv_kernel<float, D>, kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((unsigned)((p.Skv + KvCfg<D>::C - 1) / KvCfg<D>::C),
                     (unsigned)p.Hkv, (unsigned)p.B);
  dkv_kernel<float, D><<<kv_grid, kThreads, kv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int q_smem = QCfg<D>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(dq_kernel<float, D>, q_smem);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((unsigned)((p.Sq + QCfg<D>::R - 1) / QCfg<D>::R),
                    (unsigned)p.Hq, (unsigned)p.B);
  dq_kernel<float, D><<<q_grid, kThreads, q_smem, stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up once through the runtime (so the
// library links no libcuda); null when it cannot be had.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A TMA map of the first `rows` rows of a bfloat16 (B, S, H, D) view with
// element strides sb, ss, sh, as dims (D, H, rows, B), in boxes of one
// swizzle atom of D, one head and `box_rows` rows, swizzled as tc::Cfg
// lays tiles out; rows past `rows` read as zeros. False when the encoder
// refuses it (e.g. a stride it cannot take): the kernel then loads by
// cp.async.
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int B, int rows, int H,
              long long sb, long long ss, long long sh, int box_rows) {
  using C = tc::Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || rows <= 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kAtomCols, 1,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::kAtomBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<__nv_bfloat16, D>(p, stream);
  if (err != cudaSuccess) return err;
  const long long heads = (long long)p.Hkv * p.B;
  const long long kv_blocks =
      (p.Skv + tc::kBlockKeys - 1) / tc::kBlockKeys * heads;
  const long long q_blocks =
      ((long long)p.Sq * (p.Hq / p.Hkv) + tc::kRows - 1) / tc::kRows * heads;
  if (kv_blocks >= (1LL << 31) || q_blocks >= (1LL << 31))
    return cudaErrorInvalidValue;

  // the rings' tiles by TMA where the views allow it
  using C = tc::Cfg<D>;
  CUtensorMap m_q{}, m_do{}, m_k{}, m_v{};
  const bool dkv_tma =
      p.q_al && p.do_al &&
      tile_map<D>(&m_q, p.q, p.B, p.Sq, p.Hq, p.q_sb, p.q_ss, p.q_sh,
                  C::kQRows) &&
      tile_map<D>(&m_do, p.dout, p.B, p.Sq, p.Hq, p.do_sb, p.do_ss, p.do_sh,
                  C::kQRows);
  const bool dq_tma =
      p.kv_al &&
      tile_map<D>(&m_k, p.k, p.B, p.kv_len, p.Hkv, p.k_sb, p.k_ss, p.k_sh,
                  tc::kKeys) &&
      tile_map<D>(&m_v, p.v, p.B, p.kv_len, p.Hkv, p.v_sb, p.v_ss, p.v_sh,
                  tc::kKeys);

  const int kv_smem = C::kDkvSmem;
  err = allow_smem(tc::tc_dkv_kernel<D>, kv_smem);
  if (err != cudaSuccess) return err;
  tc::tc_dkv_kernel<D><<<(unsigned)kv_blocks, tc::kThreads, kv_smem, stream>>>(
      p, m_q, m_do, dkv_tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int q_smem = C::kDqSmem;
  err = allow_smem(tc::tc_dq_kernel<D>, q_smem);
  if (err != cudaSuccess) return err;
  tc::tc_dq_kernel<D><<<(unsigned)q_blocks, tc::kThreads, q_smem, stream>>>(
      p, m_k, m_v, dq_tma);
  return cudaGetLastError();
}

// bfloat16: "tc"; float32: "simt" (kernel.py::b3_bwd_path)
cudaError_t launch_d(bool bf16, int head_dim, const Params& p,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32: return bf16 ? launch_tc<32>(p, stream) : launch_simt<32>(p, stream);
    case 64: return bf16 ? launch_tc<64>(p, stream) : launch_simt<64>(p, stream);
    case 128:
      return bf16 ? launch_tc<128>(p, stream) : launch_simt<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(long long ptr, int elem, long long s0, long long s1,
               long long s2) {
  return ptr % 16 == 0 && (s0 * elem) % 16 == 0 && (s1 * elem) % 16 == 0 &&
         (s2 * elem) % 16 == 0;
}

}  // namespace

extern "C" {

// a: kNumArgs int64 values in the order of enum Arg; scale: the forward's
// 1/sqrt(D). Hkv must divide Hq; B, Hq, Hkv at most 65535. bfloat16 inputs
// run the "tc" kernels, float32 ones the "simt" kernels. Returns the
// cudaError_t of the three launches (the first that failed).
int flash_attention_bwd(const long long* a, float scale, void* stream) {
  if (a[kHkv] <= 0 || a[kHq] % a[kHkv] != 0 || a[kB] > 65535 ||
      a[kHq] > 65535)
    return (int)cudaErrorInvalidValue;
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const int elem = a[kBf16] ? 2 : 4;
  Params p{ptr(kQ), ptr(kK), ptr(kV), ptr(kO), ptr(kDO),
           static_cast<const float*>(ptr(kLse)),
           static_cast<float*>(ptr(kDelta)),
           ptr(kDQ), ptr(kDK), ptr(kDV),
           a[kQSb], a[kQSs], a[kQSh], a[kKSb], a[kKSs], a[kKSh],
           a[kVSb], a[kVSs], a[kVSh], a[kOSb], a[kOSs], a[kOSh],
           a[kDOSb], a[kDOSs], a[kDOSh],
           (int)a[kB], (int)a[kSq], (int)a[kSkv], (int)a[kHq], (int)a[kHkv],
           (int)a[kCausal], (int)a[kWindow],
           (int)(a[kKvLen] < 0 ? 0 : (a[kKvLen] > a[kSkv] ? a[kSkv]
                                                          : a[kKvLen])),
           scale,
           aligned16(a[kQ], elem, a[kQSb], a[kQSs], a[kQSh]),
           aligned16(a[kK], elem, a[kKSb], a[kKSs], a[kKSh]) &&
               aligned16(a[kV], elem, a[kVSb], a[kVSs], a[kVSh]),
           aligned16(a[kDO], elem, a[kDOSb], a[kDOSs], a[kDOSh])};
  if (p.B == 0 || p.Sq == 0 || p.Skv == 0) return (int)cudaSuccess;
  return (int)launch_d(a[kBf16] != 0, (int)a[kHeadDim], p,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
