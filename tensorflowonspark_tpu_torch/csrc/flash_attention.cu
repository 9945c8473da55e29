// Flash attention forward and backward (FlashAttention-2 split), for
// Hopper (sm_90a). Three kernels, each replacing one Pallas TPU kernel of
// tensorflowonspark_tpu/ops/flash_attention.py:
//
//   tfos_flash_fwd  <- _fwd_kernel (wrapper _flash_fwd): out and the row
//                      logsumexp lse, online softmax over KV tiles;
//   tfos_flash_dq   <- _dq_kernel (wrapper _flash_bwd): dQ, recomputing P
//                      from the saved lse, looping over KV tiles;
//   tfos_flash_dkv  <- _dkv_kernel (wrapper _flash_bwd): dK and dV,
//                      recomputing P, looping over Q tiles.
//
// What they compute, per (batch b, head h), with s = scale * Q K^T
// + bias[b] (causal: -inf above the diagonal), lse = logsumexp_k s,
// P = exp(s - lse) (0 where s is -inf):
//
//   out = P V / rowsum(P)          (a row with no visible key: out 0, lse -inf)
//   dS  = P * (dO V^T - delta)     (delta = rowsum(dO * O) - g_lse, given)
//   dQ  = scale * dS K,  dK = dS^T (scale * Q),  dV = P^T dO
//
// Layout: q/out/dO/dQ [B, S_q, N, D], k/v/dK/dV [B, S_k, N, D], read and
// written in place through strides (the Pallas wrapper's transposed fold
// to [B*N, S, D] is not needed); lse and delta [B*N, S_q] float32; the
// key-mask bias [B, S_k] float32 (0 / -inf), read at row b = bh / N and
// never repeated per head. D in {16, 32, 64, 128} is a template
// parameter; q/k/v are float32 or bfloat16, every product, statistic
// and accumulator is float32, and outputs take the input dtype.
//
// Shared by all three. The TPU kernels run a sequential grid and keep
// whole K/V (or Q/dO) rows of one head in VMEM; here a CTA owns one
// 64-row tile and loops over the other operand's tiles itself. Ragged
// tile edges are masked in the kernel, so any S runs. Under causal
// masking the KV tiles wholly above the diagonal are skipped (the TPU
// kernel computes them fully masked): the forward and dQ loops stop at
// the diagonal tile, the dK/dV loop starts at it. CTAs with the most
// tiles are scheduled first. No atomics: dQ and dK/dV each have one
// writer per output tile, so the result is deterministic. The -inf
// rules are selects, never products with a mask: masked P entries are
// 0 and a -inf lse is read as 0.
//
// What bounds them on the H100. At the training shape (B 8, S 1024,
// N 12, D 64, causal) each kernel does ~130-170 flop per byte it must
// move, above the ridge of every float32 route (67 TFLOP/s of CUDA-core
// FMAs, or 165 TFLOP/s of float32-accurate tensor-core math, over 3.35
// TB/s), so the bound is OPERATIONS.
//
// All three run their seven products on the tensor cores,
// float32-accurate:
//   forward: S = scale (Q K^T), out = P V;
//   backward: S^T/S = scale (Q K^T), dP = dO V^T, dQ = scale (dS K),
//             dK = scale (dS^T Q), dV = P^T dO.
// Q enters unscaled and the scale multiplies the float32 product, where
// the TPU forward scales Q first. A bfloat16 Q then stays exact in TF32
// (a scaled one is not, at D 32 or 128), and the forward's scores are the
// same float32 numbers the backward recomputes P from, so P = exp(s -
// lse) there sums to 1 as closely as the forward's row sum l.
// - mma.sync.m16n8k8 TF32 with the 3xTF32 split: each float32 operand is
//   x = hi + lo, hi = x rounded to TF32 as cvt.rna.tf32.f32 rounds (done
//   in two integer operations), lo = x - hi (exact; the mma reads its
//   TF32 part, ignoring the low 13 bits), and a b is accumulated in
//   float32 as lo.hi + hi.lo first and hi.hi last. A bfloat16 input is
//   exact in TF32 (lo = 0), so those passes are dropped at compile time:
//   one pass for Q K^T and dO V^T, two for the products with dS or the
//   backward's P. The backward's P and dS stay float32 operands, as in
//   the TPU kernels (FlashAttention-2 rounds them to 16 bits; this does
//   not). The forward's P enters P V in V's dtype, as the TPU kernel
//   casts it: float32 P is split like any float32 operand; bfloat16 P is
//   exact in TF32, so P V is one pass. P = 2^((s - m) log2 e) through
//   ex2.approx (2 ulp), m the running row max (forward) or lse.
// - The passes run pass-major: all 8 lo.hi mmas of an 8-wide k step over
//   a warp's 8 independent accumulators, then all hi.lo, then all hi.hi,
//   so back-to-back mmas never wait on each other's accumulator (issued
//   accumulator by accumulator, the three passes form a dependent chain,
//   which ran markedly slower on the card).
// - A CTA of 4 warps owns 64 rows (query rows in the forward and dQ, key
//   rows in dK/dV), a warp 16 of them. dK/dV computes S^T = K Q^T
//   directly, so P^T and dS^T come out with the warp's key rows. A sum
//   over k takes its terms in any order A and B share: within each
//   8-wide k step, k slot t is column 2t and slot t + 4 column 2t + 1. A
//   lane's two slots are then adjacent in a shared-memory row (one 8-byte
//   read of Q, K, V or dO), and a product's C fragment (P, dS) is already
//   the next product's A fragment, with no data moved between lanes.
// - The resident tile (Q in the forward; Q, dO in dQ; K, V in dK/dV) and
//   a two-stage ring of streamed tiles (K/V in the forward and dQ; Q/dO
//   with their lse/delta slices in dK/dV) are filled by 16-byte cp.async
//   copies (4-byte for lse and delta); the next tile's copy overlaps this
//   tile's products, and rows past S are zero-filled by the copy. Tiles
//   keep the input dtype in shared memory, rows of D elements whose
//   16-byte chunks are XOR-swizzled by the row (sw() in tc_common.cuh):
//   the pair reads along rows and the 4-byte reads down columns (the B
//   operand of P V, dS K, P^T dO, dS^T Q) both hit distinct banks at D >= 32
//   (float32) or D >= 64 (bfloat16).
// - Streamed tiles have 64 rows, or 32 at D 128: there the 16 x 128
//   accumulators per warp leave too few registers for 64-wide score
//   tiles, and two 32-row stages keep shared memory at 128 KB. At D 64,
//   float32: 80 KB (forward), 96 KB (dQ) and 97 KB (dK/dV) of shared
//   memory, two CTAs per SM; tfos_flash_budget reads back every
//   instantiation's registers, spills and CTAs per SM. (32-row tiles at
//   D 64 fit three dQ CTAs per SM but ran no faster on the card, and
//   dK/dV slower.)
// - The forward keeps its online softmax in registers: row g of a C
//   fragment lies on the 4 lanes of a quad, so a row max takes two
//   __shfl_xor_sync steps; the accumulator is rescaled by the running
//   max's correction, each lane sums l over its own columns (the quad's
//   sum is taken once, at the end), and P goes from C fragment to A
//   fragment in registers, never through shared memory.
// - Under causal masking a warp also skips the 8-column score tiles that
//   lie wholly on the masked side of its own 16 rows.
//
// More than 48 KB of dynamic shared memory is requested through
// cudaFuncSetAttribute before each launch. Plain C interface, loaded
// through ctypes by ops/_build.py; each entry point returns the CUDA
// error of the attribute call or of the launch (0 when accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

// split, mma_tf32, the swizzled fragment loads, mma3_rows, rows_by_rows,
// a_by_cols, c_to_a and the cp.async copies
#include "tc_common.cuh"

namespace {

// -- CTA shape and the cp.async ring --

constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int BWD_ROWS = 16 * BWD_WARPS;  // rows a CTA owns, 16 per warp

// rows of a streamed tile (keys in dQ, queries in dK/dV)
template <int D>
__host__ __device__ constexpr int stream_rows() { return D > 64 ? 32 : 64; }

// Start copying rows [r0, r0 + ROWS) of one (batch, head) slice of a
// [B, S, N, D] tensor (``src`` at row 0 of the slice, rows ``stride``
// elements apart) into a swizzled tile; rows past S are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int r0, int S, int stride) {
  constexpr int E = 16 / sizeof(T);
  constexpr int NC = D / E;
  for (int i = threadIdx.x; i < ROWS * NC; i += BWD_THREADS) {
    const int r = i / NC;
    const int c = (i % NC) * E;
    const bool ok = r0 + r < S;
    cp_async16(dst + sw<T, D>(r, c),
               src + (size_t)(ok ? r0 + r : 0) * stride + c, ok);
  }
}

// Start copying entries [r0, r0 + ROWS) of a float row (lse, delta); 0
// past S
template <int ROWS>
__device__ __forceinline__ void stage_row(float* dst,
                                          const float* __restrict__ src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < ROWS; i += BWD_THREADS) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x,
                                                      float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// p as P V takes it: in V's dtype, as the reference casts P before P V
template <typename T>
__device__ __forceinline__ float in_dtype(float p) {
  return is_f32<T>() ? p : __bfloat162float(__float2bfloat16(p));
}

// shared memory of the forward: the resident 64-row Q tile and two
// stages of the streamed K and V tiles
template <typename T, int D>
constexpr size_t fwd_smem() {
  return (size_t)(BWD_ROWS * D + 4 * stream_rows<D>() * D) * sizeof(T);
}

// The forward shares the backward's CTA shape (BWD_WARPS warps of 16
// query rows) and the dQ kernel's loop over streamed K/V tiles.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int S_q,
                 int S_k, int N, int causal, float scale) {
  constexpr int BM = BWD_ROWS;            // query rows of the CTA
  constexpr int BN = stream_rows<D>();    // keys of a streamed tile
  constexpr int NT = BN / 8;              // 8-key score tiles
  constexpr int DT = D / 8;               // 8-wide steps over D
  constexpr bool F32 = is_f32<T>();
  extern __shared__ __align__(16) unsigned char fwd_smem_buf[];
  T* Qs = reinterpret_cast<T*>(fwd_smem_buf);  // [BM][D], resident
  T* Ks = Qs + BM * D;                         // [2][BN][D], ring
  T* Vs = Ks + 2 * BN * D;                     // [2][BN][D], ring

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // most KV tiles first
  const int b = bh / N;
  const int h = bh % N;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int i0 = qt * BM;
  const int wr = 16 * warp;                // the warp's first row in the tile
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + BM - 1) / BN + 1) : n_all;

  stage<T, D, BM>(Qs, q + ((size_t)b * S_q * N + h) * D, i0, S_q, stride);
  stage<T, D, BN>(Ks, kb, 0, S_k, stride);
  stage<T, D, BN>(Vs, vb, 0, S_k, stride);
  cp_commit();

  // online softmax of rows g and g + 8 of the warp's 16: the running max
  // m is shared by the row's quad (lanes 4g..4g + 3); l is this lane's
  // share of the row sum, over its own columns, reduced at the end
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int last_row = i0 + wr + 15;
  float acc[DT][4];
  zero4(acc);

  for (int kt = 0; kt < n_kv; ++kt) {
    if (kt + 1 < n_kv) {
      const int nxt = (kt + 1) & 1;
      stage<T, D, BN>(Ks + nxt * BN * D, kb, (kt + 1) * BN, S_k, stride);
      stage<T, D, BN>(Vs + nxt * BN * D, vb, (kt + 1) * BN, S_k, stride);
      cp_commit();
      cp_wait<1>();                        // tile kt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = kt * BN;
    const T* Kt = Ks + (kt & 1) * BN * D;
    const T* Vt = Vs + (kt & 1) * BN * D;
    // causal: score tiles whose keys all follow the warp's last row are
    // masked whole
    const int nt =
        !causal ? NT : (last_row < j0 ? 0 : min(NT, (last_row - j0) / 8 + 1));
    if (nt > 0) {
      float s[NT][4];
      zero4(s);
      rows_by_rows<T, D, NT>(s, Qs, Kt, wr, 0, nt, g, t);    // Q K^T
      // s = scale S + bias, -inf where masked; the tile's row maxima
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = i0 + wr + g + 8 * (e >> 1);
          const int col = j0 + 8 * j + 2 * t + (e & 1);
          const bool kin = col < S_k;
          const bool ok = kin && (!causal || col <= row);
          const float sv =
              ok ? s[j][e] * scale + ((brow != nullptr) ? brow[col] : 0.f)
                 : -INFINITY;
          s[j][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      }
      float safe[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
        corr[i] = (m[i] == -INFINITY) ? 0.f : ex2((m[i] - safe[i]) * LOG2E);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // P in place in s: l sums the float32 P, P V takes it in V's dtype
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = s[j][e];
          const float p = (sv == -INFINITY)
                              ? 0.f
                              : ex2((sv - safe[e >> 1]) * LOG2E);
          l[e >> 1] += p;
          s[j][e] = in_dtype<T>(p);
        }
      }
      // acc += P V: the 8 keys of score tile j are one k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          c_to_a(s[j], ah, al);
          a_by_cols<T, D, F32>(acc, ah, al, Vt, 8 * j, g, t);
        }
      }
    }
    __syncthreads();                       // stage kt & 1 is refilled next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const int row = i0 + wr + g + 8 * i;
    if (row >= S_q) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    T* o = out + (((size_t)b * S_q + row) * N + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2<T>(o + 8 * n, acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    if (t == 0)
      lse[(size_t)bh * S_q + row] = (l[i] == 0.f) ? -INFINITY : m[i] + logf(ls);
  }
}

// shared memory of the backward kernels: the resident 64-row tiles (2),
// two stages of the two streamed tiles, and (dK/dV) their lse/delta
template <typename T, int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BWD_ROWS * D + 4 * stream_rows<D>() * D) * sizeof(T);
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return dq_smem<T, D>() + 4 * stream_rows<D>() * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S_q,
                int S_k, int N, int causal, float scale) {
  constexpr int BM = BWD_ROWS;            // query rows of the CTA
  constexpr int BN = stream_rows<D>();    // keys of a streamed tile
  constexpr int NT = BN / 8;              // 8-key score tiles
  constexpr int DT = D / 8;               // 8-wide steps over D
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* Qs = reinterpret_cast<T*>(bwd_smem);  // [BM][D], resident
  T* dOs = Qs + BM * D;                    // [BM][D], resident
  T* Ks = dOs + BM * D;                    // [2][BN][D], ring
  T* Vs = Ks + 2 * BN * D;                 // [2][BN][D], ring

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // most KV tiles first
  const int b = bh / N;
  const int h = bh % N;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int i0 = qt * BM;
  const int wr = 16 * warp;                // the warp's first row in the tile
  const size_t qoff = ((size_t)b * S_q * N + h) * D;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + BM - 1) / BN + 1) : n_all;

  stage<T, D, BM>(Qs, q + qoff, i0, S_q, stride);
  stage<T, D, BM>(dOs, dout + qoff, i0, S_q, stride);
  stage<T, D, BN>(Ks, kb, 0, S_k, stride);
  stage<T, D, BN>(Vs, vb, 0, S_k, stride);
  cp_commit();

  // rows g and g + 8 of the warp's 16
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + wr + g + 8 * i;
    const float L = row < S_q ? lse[(size_t)bh * S_q + row] : 0.f;
    lse_r[i] = isfinite(L) ? L : 0.f;
    del_r[i] = row < S_q ? delta[(size_t)bh * S_q + row] : 0.f;
  }
  const int last_row = i0 + wr + 15;
  float acc[DT][4];
  zero4(acc);

  for (int kt = 0; kt < n_kv; ++kt) {
    if (kt + 1 < n_kv) {
      const int nxt = (kt + 1) & 1;
      stage<T, D, BN>(Ks + nxt * BN * D, kb, (kt + 1) * BN, S_k, stride);
      stage<T, D, BN>(Vs + nxt * BN * D, vb, (kt + 1) * BN, S_k, stride);
      cp_commit();
      cp_wait<1>();                        // tile kt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = kt * BN;
    const T* Kt = Ks + (kt & 1) * BN * D;
    const T* Vt = Vs + (kt & 1) * BN * D;
    // causal: score tiles whose keys all follow the warp's last row are 0
    const int nt =
        !causal ? NT : (last_row < j0 ? 0 : min(NT, (last_row - j0) / 8 + 1));
    if (nt > 0) {
      float s[NT][4], dp[NT][4];
      zero4(s);
      zero4(dp);
      rows_by_rows<T, D, NT>(s, Qs, Kt, wr, 0, nt, g, t);    // Q K^T
      rows_by_rows<T, D, NT>(dp, dOs, Vt, wr, 0, nt, g, t);  // dO V^T
      // P from the saved lse, then dS = P (dP - delta), in place in s
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = i0 + wr + g + 8 * (e >> 1);
          const int col = j0 + 8 * j + 2 * t + (e & 1);
          const bool kin = col < S_k;
          const bool ok = kin && (!causal || col <= row);
          const float sv =
              s[j][e] * scale + ((brow != nullptr && kin) ? brow[col] : 0.f);
          const float p = (!ok || sv == -INFINITY)
                              ? 0.f
                              : ex2((sv - lse_r[e >> 1]) * LOG2E);
          s[j][e] = p * (dp[j][e] - del_r[e >> 1]);
        }
      }
      // dQ += dS K: the 8 keys of score tile j are one k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          c_to_a(s[j], ah, al);
          a_by_cols<T, D>(acc, ah, al, Kt, 8 * j, g, t);
        }
      }
    }
    __syncthreads();                       // stage kt & 1 is refilled next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + wr + g + 8 * i;
    if (row >= S_q) continue;
    T* o = dq + (((size_t)b * S_q + row) * N + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2<T>(o + 8 * n, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S_q, int S_k, int N, int causal,
                 float scale) {
  constexpr int BK = BWD_ROWS;            // key rows of the CTA
  constexpr int BQ = stream_rows<D>();    // queries of a streamed tile
  constexpr int NT = BQ / 8;              // 8-query score tiles
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* Ks = reinterpret_cast<T*>(bwd_smem);  // [BK][D], resident
  T* Vs = Ks + BK * D;                     // [BK][D], resident
  T* Qs = Vs + BK * D;                     // [2][BQ][D], ring
  T* dOs = Qs + 2 * BQ * D;                // [2][BQ][D], ring
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * D);  // [2][BQ] lse
  float* Es = Ls + 2 * BQ;                                 // [2][BQ] delta

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;               // low tiles see the most queries
  const int b = bh / N;
  const int h = bh % N;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int j0 = kt * BK;
  const int wr = 16 * warp;
  const size_t koff = ((size_t)b * S_k * N + h) * D;
  const T* qb = q + ((size_t)b * S_q * N + h) * D;
  const T* db = dout + ((size_t)b * S_q * N + h) * D;
  const float* lrow = lse + (size_t)bh * S_q;
  const float* drow = delta + (size_t)bh * S_q;
  const int n_q = (S_q + BQ - 1) / BQ;
  // causal: query tiles that end before this KV tile starts see none of it
  const int qt0 = causal ? j0 / BQ : 0;

  stage<T, D, BK>(Ks, k + koff, j0, S_k, stride);
  stage<T, D, BK>(Vs, v + koff, j0, S_k, stride);
  stage<T, D, BQ>(Qs, qb, qt0 * BQ, S_q, stride);
  stage<T, D, BQ>(dOs, db, qt0 * BQ, S_q, stride);
  stage_row<BQ>(Ls, lrow, qt0 * BQ, S_q);
  stage_row<BQ>(Es, drow, qt0 * BQ, S_q);
  cp_commit();

  // key rows g and g + 8 of the warp's 16
  bool kin[2];
  float bk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + wr + g + 8 * i;
    kin[i] = key < S_k;
    bk[i] = (bias != nullptr && kin[i]) ? bias[(size_t)b * S_k + key] : 0.f;
  }
  const int first_key = j0 + wr;
  float dk_acc[DT][4], dv_acc[DT][4];
  zero4(dk_acc);
  zero4(dv_acc);

  for (int qt = qt0; qt < n_q; ++qt) {
    const int cur = (qt - qt0) & 1;
    if (qt + 1 < n_q) {
      const int nxt = cur ^ 1;
      const int r1 = (qt + 1) * BQ;
      stage<T, D, BQ>(Qs + nxt * BQ * D, qb, r1, S_q, stride);
      stage<T, D, BQ>(dOs + nxt * BQ * D, db, r1, S_q, stride);
      stage_row<BQ>(Ls + nxt * BQ, lrow, r1, S_q);
      stage_row<BQ>(Es + nxt * BQ, drow, r1, S_q);
      cp_commit();
      cp_wait<1>();                        // tile qt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int i0 = qt * BQ;
    const T* Qt = Qs + cur * BQ * D;
    const T* dOt = dOs + cur * BQ * D;
    const float* Lt = Ls + cur * BQ;
    const float* Et = Es + cur * BQ;
    // causal: score tiles whose queries all precede the warp's first key
    // are 0 (first_key - i0 is a multiple of 8)
    const int lead = first_key - i0;
    const int j_lo = (!causal || lead <= 0) ? 0 : min(NT, lead / 8);
    if (j_lo < NT) {
      float st[NT][4], dpt[NT][4];
      zero4(st);
      zero4(dpt);
      rows_by_rows<T, D, NT>(st, Ks, Qt, wr, j_lo, NT, g, t);   // K Q^T
      rows_by_rows<T, D, NT>(dpt, Vs, dOt, wr, j_lo, NT, g, t);  // V dO^T
      // P^T in st, dS^T = P^T (dP^T - delta) in dpt
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = e >> 1;
          const int key = j0 + wr + g + 8 * ki;
          const int c = 8 * j + 2 * t + (e & 1);
          const int query = i0 + c;
          const float L = Lt[c];
          const float lsafe = isfinite(L) ? L : 0.f;
          const bool ok = query < S_q && kin[ki] && (!causal || key <= query);
          const float sv = st[j][e] * scale + bk[ki];
          const float p =
              (!ok || sv == -INFINITY) ? 0.f : ex2((sv - lsafe) * LOG2E);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Et[c]);
        }
      }
      // dV += P^T dO, dK += dS^T Q: the 8 queries of score tile j are one
      // k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= j_lo) {
          uint32_t ah[4], al[4];
          c_to_a(st[j], ah, al);
          a_by_cols<T, D>(dv_acc, ah, al, dOt, 8 * j, g, t);
          c_to_a(dpt[j], ah, al);
          a_by_cols<T, D>(dk_acc, ah, al, Qt, 8 * j, g, t);
        }
      }
    }
    __syncthreads();                       // stage cur is refilled next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kin[i]) continue;
    const int key = j0 + wr + g + 8 * i;
    const size_t base = (((size_t)b * S_k + key) * N + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      store2<T>(dk + base + 8 * n, dk_acc[n][2 * i] * scale,
                dk_acc[n][2 * i + 1] * scale);
      store2<T>(dv + base + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename K>
int prepare(K kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int S_q, int S_k, int N, int causal,
        float scale, cudaStream_t st) {
  const size_t smem = fwd_smem<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid(B * N, (S_q + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, S_q, S_k, N,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const float* bias,
       const void* dout, const float* lse, const float* delta, void* dq_out,
       int B, int S_q, int S_k, int N, int causal, float scale,
       cudaStream_t st) {
  const size_t smem = dq_smem<T, D>();
  auto kern = flash_dq_kernel<T, D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid(B * N, (S_q + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq_out), S_q, S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const float* bias,
        const void* dout, const float* lse, const float* delta, void* dk_out,
        void* dv_out, int B, int S_q, int S_k, int N, int causal, float scale,
        cudaStream_t st) {
  const size_t smem = dkv_smem<T, D>();
  auto kern = flash_dkv_kernel<T, D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid(B * N, (S_k + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), S_q, S_k, N, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// out = {CTAs per SM, registers per thread, local (spill) bytes per
// thread, dynamic shared bytes} of one kernel instantiation
template <typename K>
int budget(K kern, size_t smem, int* out) {
  if (int e = prepare(kern, smem)) return e;
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kern))
    return static_cast<int>(e);
  int ctas = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kern, BWD_THREADS, smem))
    return static_cast<int>(e);
  out[0] = ctas;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(smem);
  return 0;
}

template <typename T, int D>
int fwd_budget(int* out) {
  return budget(flash_fwd_kernel<T, D>, fwd_smem<T, D>(), out);
}

template <typename T, int D>
int dq_budget(int* out) {
  return budget(flash_dq_kernel<T, D>, dq_smem<T, D>(), out);
}

template <typename T, int D>
int dkv_budget(int* out) {
  return budget(flash_dkv_kernel<T, D>, dkv_smem<T, D>(), out);
}

// head_dim and dtype dispatch: D is a template parameter of every kernel
#define TFOS_FLASH_DISPATCH(FN, BF16, D, ...)                                \
  do {                                                                       \
    if (BF16) {                                                              \
      switch (D) {                                                           \
        case 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                  \
        case 32: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                  \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                  \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                \
      }                                                                      \
    } else {                                                                 \
      switch (D) {                                                           \
        case 16: return FN<float, 16>(__VA_ARGS__);                          \
        case 32: return FN<float, 32>(__VA_ARGS__);                          \
        case 64: return FN<float, 64>(__VA_ARGS__);                          \
        case 128: return FN<float, 128>(__VA_ARGS__);                        \
      }                                                                      \
    }                                                                        \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  } while (0)

}  // namespace

// Launch on ``stream``; each returns 0 when the launch was accepted, else
// the CUDA error. The caller checks devices, shapes, dtypes, contiguity
// and D. ``bias`` may be null; ``bf16`` selects bfloat16 q/k/v/dO/outputs.
extern "C" int tfos_flash_fwd(const void* q, const void* k, const void* v,
                              const float* bias, void* out, float* lse, int B,
                              int S_q, int S_k, int N, int D, int causal,
                              float scale, int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_FLASH_DISPATCH(fwd, bf16, D, q, k, v, bias, out, lse, B, S_q, S_k, N,
                      causal, scale, st);
}

extern "C" int tfos_flash_dq(const void* q, const void* k, const void* v,
                             const float* bias, const void* dout,
                             const float* lse, const float* delta, void* dq_out,
                             int B, int S_q, int S_k, int N, int D, int causal,
                             float scale, int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_FLASH_DISPATCH(dq, bf16, D, q, k, v, bias, dout, lse, delta, dq_out, B,
                      S_q, S_k, N, causal, scale, st);
}

extern "C" int tfos_flash_dkv(const void* q, const void* k, const void* v,
                              const float* bias, const void* dout,
                              const float* lse, const float* delta,
                              void* dk_out, void* dv_out, int B, int S_q,
                              int S_k, int N, int D, int causal, float scale,
                              int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_FLASH_DISPATCH(dkv, bf16, D, q, k, v, bias, dout, lse, delta, dk_out,
                      dv_out, B, S_q, S_k, N, causal, scale, st);
}

// The resource budget of the dQ (``kernel`` 0), dK/dV (1) or forward (2)
// kernel for head dim D and dtype: out[4] = {CTAs per SM, registers per
// thread, local (spill) bytes per thread, dynamic shared-memory bytes}.
extern "C" int tfos_flash_budget(int kernel, int D, int bf16, int* out) {
  if (kernel == 0) TFOS_FLASH_DISPATCH(dq_budget, bf16, D, out);
  if (kernel == 1) TFOS_FLASH_DISPATCH(dkv_budget, bf16, D, out);
  TFOS_FLASH_DISPATCH(fwd_budget, bf16, D, out);
}
