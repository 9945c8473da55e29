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
// Design. The TPU kernels run a sequential grid and keep whole K/V (or
// Q/dO) rows of one head in VMEM; here a CTA of 256 threads owns one
// 64-row tile and loops over the other operand's 64-row tiles itself,
// staging each through shared memory as float32. Every product is a
// shared-memory GEMM in which a thread owns a 4 x (cols/16) register
// block (rows ty + 16 i, columns tx + 16 j: broadcast reads of A, and
// padded rows so transposed reads of B hit distinct banks). Row
// statistics reduce over the 16 lanes that share a row. Ragged tile
// edges are masked in the kernel, so any S runs. Under causal masking
// the KV tiles wholly above the diagonal are skipped (the TPU kernel
// computes them fully masked): the forward and dQ loops stop at the
// diagonal tile, the dK/dV loop starts at it, and the diagonal tile is
// masked element by element. CTAs with the most tiles are scheduled
// first. No atomics: dQ and dK/dV each have one writer per tile, so the
// result is deterministic.
//
// What bounds it on the H100. At the training shape (B 8, S 1024, N 12,
// D 64, causal) each kernel does ~130-170 flop per byte it must move,
// far above the ~20 flop/byte ridge of float32 CUDA-core math (67
// TFLOP/s over 3.35 TB/s), so the bound is OPERATIONS. This first version does
// float32 FMAs on CUDA cores, two shared-memory loads per four FMAs,
// without tensor cores, TMA or a software pipeline; a bfloat16 path on
// wgmma is the way to the tensor cores (PERF.md has its measured share
// of the bound).
//
// More than 48 KB of dynamic shared memory is requested through
// cudaFuncSetAttribute before each launch. Plain C interface, loaded
// through ctypes by ops/_build.py; each entry point returns the CUDA
// error of the attribute call or of the launch (0 when accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int TILE = 64;             // rows of a Q tile and of a KV tile
constexpr int TX = 16;               // threads across a tile's columns
constexpr int TY = 16;               // threads across a tile's rows
constexpr int THREADS = TX * TY;
constexpr int RM = TILE / TY;        // tile rows per thread
constexpr int RN = TILE / TX;        // score columns per thread
constexpr int LP = TILE + 1;         // padded row of a score tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes that hold one tile row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Rows [r0, r0 + TILE) of one (batch, head) slice of a [B, S, N, D]
// tensor (``src`` at row 0 of that slice, rows ``stride`` apart) into
// shared memory [TILE][LD] as float32 times ``mul``; rows past S read 0.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int S, int stride, float mul) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int s = r0 + r;
    dst[r * LD + d] = s < S ? to_f(src[(size_t)s * stride + d]) * mul : 0.f;
  }
}

// c[i][j] += sum_k A(ty + TY i, k) * B(k, tx + TX j) over shared memory,
// with A(m, k) = A[m * AM + k * AK] and B(k, n) = B[k * BKS + n * BN].
template <int NI, int NJ, int K, int AM, int AK, int BKS, int BN>
__device__ __forceinline__ void mma(float (&c)[NI][NJ], const float* A,
                                    const float* B) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[(ty + TY * i) * AM + k * AK];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * BKS + (tx + TX * j) * BN];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void zero(float (&c)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[i][j] = 0.f;
}

// KV tiles a Q tile starting at row i0 must visit
__device__ __forceinline__ int kv_tiles(int i0, int S_k, int causal) {
  const int n = (S_k + TILE - 1) / TILE;
  return causal ? min(n, (i0 + TILE - 1) / TILE + 1) : n;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int S_q,
                 int S_k, int N, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [TILE][LD], scaled
  float* Ks = Qs + TILE * LD;        // [TILE][LD]
  float* Vs = Ks + TILE * LD;        // [TILE][LD]
  float* Ps = Vs + TILE * LD;        // [TILE][LP]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int stride = N * D;
  const int i0 = qt * TILE;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;

  load_tile<T, D, LD>(Qs, q + ((size_t)b * S_q * N + h) * D, i0, S_q, stride,
                      scale);
  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero(acc);

  const int n_kv = kv_tiles(i0, S_k, causal);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * TILE;
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D, LD>(Ks, kb, j0, S_k, stride, 1.f);
    load_tile<T, D, LD>(Vs, vb, j0, S_k, stride, 1.f);
    __syncthreads();
    float s[RM][RN];
    zero(s);
    mma<RM, RN, D, LD, 1, 1, LD>(s, Qs, Ks);
    float bj[RN];
    bool kin[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = j0 + tx + TX * j;
      kin[j] = col < S_k;
      bj[j] = (brow != nullptr && kin[j]) ? brow[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = i0 + ty + TY * i;
      float mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = j0 + tx + TX * j;
        const bool ok = kin[j] && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] + bj[j] : -INFINITY;
        mb = fmaxf(mb, s[i][j]);
      }
      mb = row_max(mb);
      const float m_new = fmaxf(m[i], mb);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m[i] == -INFINITY) ? 0.f : expf(m[i] - safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - safe);
        ps += p;
        // P enters the P V product in V's dtype, as in the TPU kernel
        Ps[(ty + TY * i) * LP + tx + TX * j] = to_f(from_f<T>(p));
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mma<RM, NJ, TILE, LP, 1, LD, 1>(acc, Ps, Vs);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ty + TY * i;
    if (row >= S_q) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    T* o = out + (((size_t)b * S_q + row) * N + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + TX * j] = from_f<T>(acc[i][j] / ls);
    if (tx == 0)
      lse[(size_t)bh * S_q + row] = (l[i] == 0.f) ? -INFINITY : m[i] + logf(ls);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S_q,
                int S_k, int N, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [TILE][LD], scaled
  float* dOs = Qs + TILE * LD;       // [TILE][LD]
  float* Ks = dOs + TILE * LD;       // [TILE][LD]
  float* Vs = Ks + TILE * LD;        // [TILE][LD]
  float* Ss = Vs + TILE * LD;        // [TILE][LP], dS

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int stride = N * D;
  const int i0 = qt * TILE;
  const size_t qoff = ((size_t)b * S_q * N + h) * D;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;

  load_tile<T, D, LD>(Qs, q + qoff, i0, S_q, stride, scale);
  load_tile<T, D, LD>(dOs, dout + qoff, i0, S_q, stride, 1.f);
  float lse_r[RM], del_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ty + TY * i;
    const float L = row < S_q ? lse[(size_t)bh * S_q + row] : 0.f;
    lse_r[i] = isfinite(L) ? L : 0.f;
    del_r[i] = row < S_q ? delta[(size_t)bh * S_q + row] : 0.f;
  }
  float acc[RM][NJ];
  zero(acc);

  const int n_kv = kv_tiles(i0, S_k, causal);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * TILE;
    __syncthreads();
    load_tile<T, D, LD>(Ks, kb, j0, S_k, stride, 1.f);
    load_tile<T, D, LD>(Vs, vb, j0, S_k, stride, 1.f);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    zero(s);
    zero(dp);
    mma<RM, RN, D, LD, 1, 1, LD>(s, Qs, Ks);
    mma<RM, RN, D, LD, 1, 1, LD>(dp, dOs, Vs);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = j0 + tx + TX * j;
      const bool kin = col < S_k;
      const float bj = (brow != nullptr && kin) ? brow[col] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = i0 + ty + TY * i;
        const bool ok = kin && (!causal || col <= row);
        const float sv = s[i][j] + bj;
        const float p = (!ok || sv == -INFINITY) ? 0.f : expf(sv - lse_r[i]);
        Ss[(ty + TY * i) * LP + tx + TX * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();
    mma<RM, NJ, TILE, LP, 1, LD, 1>(acc, Ss, Ks);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ty + TY * i;
    if (row >= S_q) continue;
    T* o = dq + (((size_t)b * S_q + row) * N + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + TX * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S_q, int S_k, int N, int causal,
                 float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / TX;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [TILE][LD]
  float* Vs = Ks + TILE * LD;        // [TILE][LD]
  float* Qs = Vs + TILE * LD;        // [TILE][LD], scaled
  float* dOs = Qs + TILE * LD;       // [TILE][LD]
  float* Ps = dOs + TILE * LD;       // [TILE][LP], P^T (key rows)
  float* Ss = Ps + TILE * LP;        // [TILE][LP], dS^T

  const int kt = blockIdx.x;         // low tiles see the most queries
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int stride = N * D;
  const int j0 = kt * TILE;
  const size_t koff = ((size_t)b * S_k * N + h) * D;
  const T* qb = q + ((size_t)b * S_q * N + h) * D;
  const T* db = dout + ((size_t)b * S_q * N + h) * D;

  load_tile<T, D, LD>(Ks, k + koff, j0, S_k, stride, 1.f);
  load_tile<T, D, LD>(Vs, v + koff, j0, S_k, stride, 1.f);
  bool kin[RM];
  float bi[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = j0 + ty + TY * i;
    kin[i] = key < S_k;
    bi[i] = (bias != nullptr && kin[i]) ? bias[(size_t)b * S_k + key] : 0.f;
  }
  float dk_acc[RM][NJ], dv_acc[RM][NJ];
  zero(dk_acc);
  zero(dv_acc);

  const int n_q = (S_q + TILE - 1) / TILE;
  // causal: query tiles that end before this KV tile starts see none of it
  for (int qt = causal ? j0 / TILE : 0; qt < n_q; ++qt) {
    const int i0 = qt * TILE;
    __syncthreads();
    load_tile<T, D, LD>(Qs, qb, i0, S_q, stride, scale);
    load_tile<T, D, LD>(dOs, db, i0, S_q, stride, 1.f);
    __syncthreads();
    float st[RM][RN], dpt[RM][RN];
    zero(st);
    zero(dpt);
    mma<RM, RN, D, LD, 1, 1, LD>(st, Ks, Qs);
    mma<RM, RN, D, LD, 1, 1, LD>(dpt, Vs, dOs);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = i0 + tx + TX * j;  // query
      const bool qin = col < S_q;
      const float L = qin ? lse[(size_t)bh * S_q + col] : 0.f;
      const float lsafe = isfinite(L) ? L : 0.f;
      const float del = qin ? delta[(size_t)bh * S_q + col] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int key = j0 + ty + TY * i;
        const bool ok = qin && kin[i] && (!causal || key <= col);
        const float sv = st[i][j] + bi[i];
        const float p = (!ok || sv == -INFINITY) ? 0.f : expf(sv - lsafe);
        const int e = (ty + TY * i) * LP + tx + TX * j;
        Ps[e] = p;
        Ss[e] = p * (dpt[i][j] - del);
      }
    }
    __syncthreads();
    mma<RM, NJ, TILE, LP, 1, LD, 1>(dv_acc, Ps, dOs);
    mma<RM, NJ, TILE, LP, 1, LD, 1>(dk_acc, Ss, Qs);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = j0 + ty + TY * i;
    if (!kin[i]) continue;
    const size_t base = (((size_t)b * S_k + key) * N + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[base + tx + TX * j] = from_f<T>(dk_acc[i][j]);
      dv[base + tx + TX * j] = from_f<T>(dv_acc[i][j]);
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
  const size_t smem = (size_t)(3 * TILE * (D + 1) + TILE * LP) * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid((S_q + TILE - 1) / TILE, B * N);
  kern<<<grid, THREADS, smem, st>>>(
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
  const size_t smem = (size_t)(4 * TILE * (D + 1) + TILE * LP) * sizeof(float);
  auto kern = flash_dq_kernel<T, D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid((S_q + TILE - 1) / TILE, B * N);
  kern<<<grid, THREADS, smem, st>>>(
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
  const size_t smem =
      (size_t)(4 * TILE * (D + 1) + 2 * TILE * LP) * sizeof(float);
  auto kern = flash_dkv_kernel<T, D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid((S_k + TILE - 1) / TILE, B * N);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), S_q, S_k, N, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
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
