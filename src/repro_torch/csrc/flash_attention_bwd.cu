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
// Three kernels, one launch each, on the caller's stream:
//   delta_kernel  delta_i = rowsum(dO_i * O_i), a warp per row, into a
//                 float32 (B, Hq, Sq) scratch.
//   dkv_kernel    grid (key tiles, Hkv, B): a block owns C keys of one kv
//                 head (C = 64, 32 at D 128), keeps its K and V rows and its
//                 dK, dV sums (registers) for its whole life, and walks the
//                 group's q heads and, for each, the q tiles of R = 2048 / C
//                 rows that can see one of its keys (the tile skip: the rows
//                 below the causal diagonal of its first key and past the
//                 window of its last are never loaded). A tile recomputes S
//                 and dP, then P and dS through shared memory, then the two
//                 outer-product sums.
//   dq_kernel     grid (query tiles, Hq, B): a block owns R rows of one q
//                 head (R = 64, 32 at D 128) and their dQ sums, and walks
//                 the key tiles of C = 2048 / R keys they can see
//                 (kv_tile_range's rule), recomputing S, dP and dS.
// Every output row is summed by one block in a fixed order: no atomics, so
// the result is the same bits run after run (a resumed training run equals
// an uninterrupted one).
//
// What bounds it: the 10 D operations of a visible (query, key) pair at the
// tensor cores' bfloat16 rate (kernel.py::bwd_bound). This first version
// runs on the float32 cores (SIMT) and does 14 D, since S and dP are
// computed in both kernels: a thread owns a 4 x 4 block of the R x C
// score tile (strided rows and keys, so the float4 reads of a warp hit
// distinct banks) and a few rows of 4 output columns in the sums. Q, dO, K
// and V are staged in shared memory as float32 rows padded by 4 floats. The
// tensor-core version is the next item of ROADMAP Queue B.

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
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The packed arguments: int64 values in this order (kernel.py::BWD_ARGS).
enum Arg {
  kBf16,        // 0: q, k, v, dO float32; 1: bfloat16 (o is float32)
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

// ------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  delta_kernel<T, D><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int kv_smem = KvCfg<D>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(dkv_kernel<T, D>, kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((unsigned)((p.Skv + KvCfg<D>::C - 1) / KvCfg<D>::C),
                     (unsigned)p.Hkv, (unsigned)p.B);
  dkv_kernel<T, D><<<kv_grid, kThreads, kv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int q_smem = QCfg<D>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(dq_kernel<T, D>, q_smem);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((unsigned)((p.Sq + QCfg<D>::R - 1) / QCfg<D>::R),
                    (unsigned)p.Hq, (unsigned)p.B);
  dq_kernel<T, D><<<q_grid, kThreads, q_smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// a: kNumArgs int64 values in the order of enum Arg; scale: the forward's
// 1/sqrt(D). Hkv must divide Hq; B, Hq, Hkv at most 65535. Returns the
// cudaError_t of the three launches (the first that failed).
int flash_attention_bwd(const long long* a, float scale, void* stream) {
  if (a[kHkv] <= 0 || a[kHq] % a[kHkv] != 0 || a[kB] > 65535 ||
      a[kHq] > 65535)
    return (int)cudaErrorInvalidValue;
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
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
           scale};
  if (p.B == 0 || p.Sq == 0 || p.Skv == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a[kBf16] ? launch_d<__nv_bfloat16>((int)a[kHeadDim], p, s)
                        : launch_d<float>((int)a[kHeadDim], p, s));
}

}  // extern "C"
