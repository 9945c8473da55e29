// Attention at head dims above 256, for Hopper (sm_90a): paged attention
// (decode, the verify window, prefill tails and cold prompts) and the
// three flash-attention kernels (forward, dQ, dK/dV) at any D > 256. They
// replace, at those widths, the Pallas TPU kernels
//
//   tensorflowonspark_tpu/ops/paged_attention.py:210  _paged_kernel
//   tensorflowonspark_tpu/ops/flash_attention.py:83   _fwd_kernel
//   tensorflowonspark_tpu/ops/flash_attention.py:137  _dq_kernel
//   tensorflowonspark_tpu/ops/flash_attention.py:186  _dkv_kernel
//
// which block only the sequence and hold whole rows of any D. The
// kernels of paged_attention.cu and flash_attention.cu keep every head dim
// up to 256; these take the rest, with the same contracts (the header of
// each of those sources).
//
// One idea serves every D: OUTPUT COLUMNS ARE A GRID AXIS. A CTA owns one
// chunk of DC = 128 output columns (the tensor-core kernels) or 1024 (the
// split-KV kernel), so its accumulators stay the size they are at D 128 or
// below, whatever D is. The scores (and the backward's dP = dO V^T) need
// the whole of D: every CTA sums them over D in chunks of DK = 32 columns,
// staged through shared memory one chunk at a time, then runs its softmax
// and its products on its own output columns. The cost is that each column
// chunk recomputes the scores: K (and V in the backward) is read once per
// output chunk. Simple and right at 257, 576, 1024 and everything
// between; the schedule is modelled on the CPU by
// tests/test_torch_wide_heads.py.
//
// - flash_wide_fwd_kernel<T>, flash_wide_dq_kernel<T>,
//   flash_wide_dkv_kernel<T> (T float or bfloat16): one CTA of 4 warps over
//   64 query rows (forward, dQ) or 64 keys (dK/dV), 16 a warp, and a
//   128-column chunk of out, dQ, dK or dV (dK and dV in CTAs of their
//   own); 32-key (32-query) tiles streamed. Products on mma.sync m16n8k8
//   TF32 (tc_common.cuh). Every operand lands in shared memory as
//   float32; a float32 operand is split
//   3xTF32 (hi + lo, float32-accurate), a bfloat16 one is exact in TF32
//   (its lo part is 0 and its passes are dropped). The forward rounds P to
//   bfloat16 before P V at bfloat16, as the reference casts P to V's
//   dtype. D is a multiple of 128 here: the wrapper zero-pads q, k, v and
//   dO to it (flash_attention.py ``padded_head_dim``), which leaves the
//   scores and lse unchanged.
// - paged_wide_tiled_kernel<QUANT>: the forward's schedule with its K/V
//   rows reached through the block table, one row offset a key looked up
//   once a tile; int8 codes dequantized (times their row's scale) on the
//   way into shared memory; any D: columns past D are predicated off
//   (zero in, not stored), and loads are 4 bytes (float32) or 1 byte
//   (int8), so a D whose rows break 16-byte alignment (300 at int8) runs
//   as is. The pool is never copied or padded.
// - paged_wide_split_kernel<QUANT, QN> + paged_wide_combine_kernel: 1 to 4
//   queries a row (decode, the verify window), on the CUDA cores: a CTA of
//   8 warps per split of WIDE_SPLIT_KEYS logical keys of one (row, head)
//   and a 1024-column chunk; a warp a key at a time for the scores (lanes
//   across D, reduced by shuffles), a thread four columns of P V; each
//   split's (acc, m, l) to a float32 workspace, merged in split order by
//   the combine kernel, so the result is deterministic.
//
// All of them read only live keys (a paged row's live blocks; dead pool
// rows are never loaded), mask by selects (never a product with a mask),
// give a row with no visible key out 0 and lse -inf, and use no atomics
// on their outputs.
//
// What bounds them on the H100: BYTES at decode and the verify window
// (the live K/V over 3.35 TB/s), OPERATIONS at prefill tails and in
// training (scores, P V and the backward's products at the
// float32-accurate tensor-core rate). This first design is far from
// either: every tile goes through shared memory in 32-column chunks
// behind two barriers with no copy in flight, and each column chunk
// repeats the scores. The measured shares are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int THREADS = 128;  // a tensor-core CTA: 4 warps
constexpr int ROWS = 64;      // its rows: queries (fwd, dQ, tiled), keys (dK/dV)
constexpr int KEYS = 32;      // keys of a streamed tile (fwd, dQ, tiled)
constexpr int QUERIES = 32;   // queries of a streamed tile (dK/dV)
constexpr int DK = 32;        // columns of a contraction chunk (S, dP)
constexpr int DC = 128;       // output columns of a CTA (grid z)
constexpr int NB = DC / 8;    // its 8-column accumulator blocks
constexpr int ST = KEYS / 8;  // 8-key (8-query) score blocks of a tile
static_assert(KEYS == QUERIES, "score tiles are 16 x 32 in every kernel");

constexpr int SPLIT_THREADS = 256;  // the split-KV CTA: 8 warps
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int SPLIT_KEYS = 256;     // logical keys of a split (WIDE_SPLIT_KEYS)
constexpr int SPLIT_COLS = 4;       // output columns a thread owns
constexpr int SPLIT_DC = SPLIT_THREADS * SPLIT_COLS;  // a CTA's chunk

constexpr float LN2 = 0.6931471805599453f;

template <typename T>
struct IsBf16 : std::false_type {};
template <>
struct IsBf16<__nv_bfloat16> : std::true_type {};

// four consecutive elements (16-byte aligned float32, 8-byte bfloat16)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + R) of one (batch, head) slice of a [B, S, N, D] tensor
// (``src`` at row 0 of the slice, rows ``stride`` elements apart), columns
// [c0, c0 + W), into a swizzled float32 tile of rows of W; rows past S are
// zero. D is a multiple of DC, so every column is in range and 4 columns
// are one aligned load.
template <int R, int W, typename T>
__device__ __forceinline__ void fill(float* dst, const T* __restrict__ src,
                                     int r0, int S, int stride, int c0) {
  constexpr int NC = W / 4;
  for (int i = threadIdx.x; i < R * NC; i += THREADS) {
    const int r = i / NC;
    const int c = (i % NC) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load4(src + (size_t)(r0 + r) * stride + c0 + c, x);
    *reinterpret_cast<float4*>(dst + sw<W>(r, c)) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// c[j] += A B^T over one DK-column chunk: A rows r0..r0 + 15 of tile A,
// the NT 8-row blocks j of tile B (both rows of DK). ALO / BLO: whether
// A's / B's lo part can be nonzero (float32; a bfloat16 value's is 0).
// The chunk sums into fresh registers and is then added to c in float32:
// the tensor core's accumulation error is relative to the accumulator it
// adds into, and a chunk's partial sum is a fraction of a whole score at
// D 1024.
template <bool ALO, bool BLO, int NT>
__device__ __forceinline__ void chunk_scores(float (&c)[NT][4], const float* A,
                                             const float* B, int r0, int g,
                                             int t) {
  float part[NT][4];
  zero4(part);
#pragma unroll
  for (int ks = 0; ks < DK / 8; ++ks) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    load_a<DK>(ah, al, A, r0, 8 * ks, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      load_b_rows<DK>(bh[j], bl[j], B, 8 * j, 8 * ks, g, t);
    mma3_rows<ALO, BLO>(part, ah, al, bh, bl, 0, NT);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += part[j][e];
}

// acc[n] += A B[n] for the NB 8-column blocks of tile B (rows of DC),
// whose rows k0..k0 + 7 are the contraction (A from a C fragment), CH
// blocks' B fragments at a time, pass-major within them
template <bool ALO, bool BLO, int CH>
__device__ __forceinline__ void by_cols(float (&acc)[NB][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float* B, int k0, int g, int t) {
#pragma unroll
  for (int n0 = 0; n0 < NB; n0 += CH) {
    uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
    for (int n = 0; n < CH; ++n)
      load_b_cols<DC>(bh[n], bl[n], B, k0, 8 * (n0 + n), g, t);
    if (ALO) {
#pragma unroll
      for (int n = 0; n < CH; ++n) mma_tf32(acc[n0 + n], al, bh[n]);
    }
    if (BLO) {
#pragma unroll
      for (int n = 0; n < CH; ++n) mma_tf32(acc[n0 + n], ah, bl[n]);
    }
#pragma unroll
    for (int n = 0; n < CH; ++n) mma_tf32(acc[n0 + n], ah, bh[n]);
  }
}

// acc += P V (or dS K, P^T dO, dS^T Q): each 8-wide block j of the C
// fragments s is one k step of the product with tile B's rows 8j..8j + 7
template <bool ALO, bool BLO, int CH>
__device__ __forceinline__ void frag_by_cols(float (&acc)[NB][4],
                                             const float (&s)[ST][4],
                                             const float* B, int g, int t) {
#pragma unroll
  for (int j = 0; j < ST; ++j) {
    uint32_t ah[4], al[4];
    c_to_a(s[j], ah, al);
    by_cols<ALO, BLO, CH>(acc, ah, al, B, 8 * j, g, t);
  }
}

// One key tile of the online softmax for rows g and g + 8 of a warp's 16,
// in the C fragments s of Q K^T (unscaled) against keys j0 + 8 j + 2 t + e
// % 2: ``bias(i, key)`` (i 0 for row g, 1 for g + 8) is the key's additive
// term in log2 units, -inf where the key is masked. s becomes
// P = 2^(s qk + bias - m) (0 where masked); the running max m (log2 units,
// shared by the row's quad) and this lane's row sums l move on, and acc is
// rescaled by the max's correction.
template <class Bias>
__device__ __forceinline__ void softmax_step(float (&s)[ST][4],
                                             float (&acc)[NB][4],
                                             float (&m)[2], float (&l)[2],
                                             float qk, const Bias& bias,
                                             int j0, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < ST; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float add = bias(e >> 1, j0 + 8 * j + 2 * t + (e & 1));
      const float sv = (add == -INFINITY) ? -INFINITY : s[j][e] * qk + add;
      s[j][e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  }
  float safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
    const float corr = (m[i] == -INFINITY) ? 0.f : ex2(m[i] - safe[i]);
    m[i] = m_new;
    l[i] *= corr;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      acc[n][2 * i] *= corr;
      acc[n][2 * i + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < ST; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = s[j][e];
      const float p = (sv == -INFINITY) ? 0.f : ex2(sv - safe[e >> 1]);
      l[e >> 1] += p;
      s[j][e] = p;
    }
  }
}

// The quad's row sums l of rows g and g + 8; returns them
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
}

// lse of a row from its max m (log2 units) and sum l: -inf with no key
__device__ __forceinline__ float row_lse(float m, float l) {
  return (l == 0.f) ? -INFINITY : (m + log2f(l)) * LN2;
}

// -- flash attention ------------------------------------------------------

// The forward: out[:, c0:c0 + 128] and (chunk 0) lse of 64 query rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, float* __restrict__ lse, int S_q,
                      int S_k, int N, int D, int causal, float scale) {
  constexpr bool BF = IsBf16<T>::value;
  __shared__ __align__(16) float Qs[ROWS * DK];
  __shared__ __align__(16) float Ks[KEYS * DK];
  __shared__ __align__(16) float Vs[KEYS * DC];

  const int qt = gridDim.x - 1 - blockIdx.x;  // most key tiles first
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int i0 = qt * ROWS;
  const int wr = 16 * warp;
  const T* qb = q + ((size_t)b * S_q * N + h) * D;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + KEYS - 1) / KEYS;
  const int n_kv = causal ? min(n_all, (i0 + ROWS - 1) / KEYS + 1) : n_all;
  const int row[2] = {i0 + wr + g, i0 + wr + g + 8};
  const float qk = scale * LOG2E;
  auto visible = [&](int i, int key) -> float {
    if (key >= S_k || (causal && key > row[i])) return -INFINITY;
    return brow ? brow[key] * LOG2E : 0.f;
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
  zero4(acc);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * KEYS;
    float s[ST][4];
    zero4(s);
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // every warp is done with the last chunk (and P V)
      fill<ROWS, DK>(Qs, qb, i0, S_q, stride, d0);
      fill<KEYS, DK>(Ks, kb, j0, S_k, stride, d0);
      __syncthreads();
      chunk_scores<!BF, !BF>(s, Qs, Ks, wr, g, t);
    }
    fill<KEYS, DC>(Vs, vb, j0, S_k, stride, c0);
    __syncthreads();
    softmax_step(s, acc, m, l, qk, visible, j0, t);
    if (BF) {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = bf16_round(s[j][e]);
    }
    frag_by_cols<!BF, !BF, 4>(acc, s, Vs, g, t);
  }
  quad_sum(l);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S_q) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    T* o = out + (((size_t)b * S_q + row[i]) * N + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store2(o + 8 * n, acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    if (blockIdx.z == 0 && t == 0)
      lse[(size_t)bh * S_q + row[i]] = row_lse(m[i], l[i]);
  }
}

// dQ[:, c0:c0 + 128] of 64 query rows: per key tile S = Q K^T and dP =
// dO V^T over all of D, P from the saved lse, dS = P (dP - delta), then
// dQ += dS K[:, c0:c0 + 128]; scaled once at the end.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int S_q, int S_k, int N, int D, int causal, float scale) {
  constexpr bool BF = IsBf16<T>::value;
  __shared__ __align__(16) float Qs[ROWS * DK];
  __shared__ __align__(16) float Os[ROWS * DK];
  __shared__ __align__(16) float Ks[KEYS * DK];
  __shared__ __align__(16) float Vs[KEYS * DK];
  __shared__ __align__(16) float Kc[KEYS * DC];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int i0 = qt * ROWS;
  const int wr = 16 * warp;
  const size_t qoff = ((size_t)b * S_q * N + h) * D;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + KEYS - 1) / KEYS;
  const int n_kv = causal ? min(n_all, (i0 + ROWS - 1) / KEYS + 1) : n_all;
  const int row[2] = {i0 + wr + g, i0 + wr + g + 8};
  const float qk = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float x = row[i] < S_q ? lse[(size_t)bh * S_q + row[i]] : 0.f;
    lse2[i] = isfinite(x) ? x * LOG2E : 0.f;  // a -inf lse reads as 0
    dl[i] = row[i] < S_q ? delta[(size_t)bh * S_q + row[i]] : 0.f;
  }

  float acc[NB][4];
  zero4(acc);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * KEYS;
    float s[ST][4], dp[ST][4];
    zero4(s);
    zero4(dp);
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();
      fill<ROWS, DK>(Qs, q + qoff, i0, S_q, stride, d0);
      fill<ROWS, DK>(Os, dout + qoff, i0, S_q, stride, d0);
      fill<KEYS, DK>(Ks, kb, j0, S_k, stride, d0);
      fill<KEYS, DK>(Vs, vb, j0, S_k, stride, d0);
      __syncthreads();
      chunk_scores<!BF, !BF>(s, Qs, Ks, wr, g, t);
      chunk_scores<!BF, !BF>(dp, Os, Vs, wr, g, t);
    }
    fill<KEYS, DC>(Kc, kb, j0, S_k, stride, c0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = j0 + 8 * j + 2 * t + (e & 1);
        const bool ok = key < S_k && !(causal && key > row[i]);
        const float add = (ok && brow) ? brow[key] * LOG2E : 0.f;
        const float p = (!ok || add == -INFINITY)
                            ? 0.f
                            : ex2(s[j][e] * qk + add - lse2[i]);
        s[j][e] = p * (dp[j][e] - dl[i]);
      }
    }
    frag_by_cols<true, !BF, 2>(acc, s, Kc, g, t);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S_q) continue;
    T* o = dq + (((size_t)b * S_q + row[i]) * N + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store2(o + 8 * n, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// dK or dV [:, c0:c0 + 128] of 64 keys: grid z is 2 x the column chunks,
// its low bit the CTA's role, so a thread holds one 16 x 128 accumulator
// (both took 255 registers and spilled). Per query tile S^T = K Q^T over
// all of D and P^T from the saved lse; the dV CTA adds P^T dO[:, c0:],
// the dK CTA also forms dP^T = V dO^T over all of D and dS^T = P^T (dP^T
// - delta) and adds dS^T Q[:, c0:], scaled at the end.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S_q, int S_k, int N, int D,
                      int causal, float scale) {
  constexpr bool BF = IsBf16<T>::value;
  __shared__ __align__(16) float Ks[ROWS * DK];
  __shared__ __align__(16) float Vs[ROWS * DK];
  __shared__ __align__(16) float Qs[QUERIES * DK];
  __shared__ __align__(16) float Os[QUERIES * DK];
  __shared__ __align__(16) float Bc[QUERIES * DC];  // Q (dK) or dO (dV)
  __shared__ float lse_s[QUERIES];                   // log2 units
  __shared__ float dl_s[QUERIES];

  const int kt = blockIdx.x;  // the first key tiles have the most queries
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const bool dk_role = blockIdx.z & 1;
  const int c0 = (blockIdx.z >> 1) * DC;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int k0 = kt * ROWS;
  const int wr = 16 * warp;
  const size_t qoff = ((size_t)b * S_q * N + h) * D;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const T* bsrc = (dk_role ? q : dout) + qoff;
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  const float qk = scale * LOG2E;
  float add[2];  // the key's bias in log2 units; -inf: masked or past S_k
#pragma unroll
  for (int i = 0; i < 2; ++i)
    add[i] = key[i] >= S_k ? -INFINITY
             : bias       ? bias[(size_t)b * S_k + key[i]] * LOG2E
                          : 0.f;
  const int n_q = (S_q + QUERIES - 1) / QUERIES;
  const int q_first = causal ? k0 / QUERIES : 0;

  float acc[NB][4];
  zero4(acc);
  for (int qt = q_first; qt < n_q; ++qt) {
    const int q0 = qt * QUERIES;
    float s[ST][4], dp[ST][4];
    zero4(s);
    zero4(dp);
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();
      fill<ROWS, DK>(Ks, kb, k0, S_k, stride, d0);
      fill<QUERIES, DK>(Qs, q + qoff, q0, S_q, stride, d0);
      if (dk_role) {
        fill<ROWS, DK>(Vs, vb, k0, S_k, stride, d0);
        fill<QUERIES, DK>(Os, dout + qoff, q0, S_q, stride, d0);
      }
      __syncthreads();
      chunk_scores<!BF, !BF>(s, Ks, Qs, wr, g, t);
      if (dk_role) chunk_scores<!BF, !BF>(dp, Vs, Os, wr, g, t);
    }
    fill<QUERIES, DC>(Bc, bsrc, q0, S_q, stride, c0);
    if (threadIdx.x < QUERIES) {
      const int r = q0 + threadIdx.x;
      const float x = r < S_q ? lse[(size_t)bh * S_q + r] : 0.f;
      lse_s[threadIdx.x] = isfinite(x) ? x * LOG2E : 0.f;
      dl_s[threadIdx.x] = r < S_q ? delta[(size_t)bh * S_q + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = 8 * j + 2 * t + (e & 1);
        const int query = q0 + c;
        const bool ok = query < S_q && add[i] != -INFINITY &&
                        !(causal && key[i] > query);
        const float p = ok ? ex2(s[j][e] * qk + add[i] - lse_s[c]) : 0.f;
        s[j][e] = dk_role ? p * (dp[j][e] - dl_s[c]) : p;
      }
    }
    frag_by_cols<true, !BF, 4>(acc, s, Bc, g, t);
  }
  T* dst = dk_role ? dk : dv;
  const float mul = dk_role ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S_k) continue;
    T* o = dst + (((size_t)b * S_k + key[i]) * N + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store2(o + 8 * n, acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// -- paged attention ------------------------------------------------------

template <bool QUANT>
using PoolT = typename std::conditional<QUANT, int8_t, float>::type;

// The row's live keys: blocks enough to cover its highest position,
// clamped to the table (paged_attention.py ``_nblocks``), times bs
__device__ __forceinline__ int live_keys(int pmax, int bs, int MB) {
  return min((pmax + bs) / bs, MB) * bs;
}

// Pool element offset of logical key ``kk`` of row b, head h
__device__ __forceinline__ long long key_offset(const int* __restrict__ table,
                                                int b, int kk, int h, int N,
                                                int D, int bs, int MB,
                                                long long* prow) {
  const long long r =
      (long long)table[(size_t)b * MB + kk / bs] * bs + kk % bs;
  *prow = r;
  return (r * N + h) * D;
}

// R key rows (offsets ``off``, -1: not live, zero) of a pool, columns
// [c0, c0 + W) (zero past D), times their row's scale, into a swizzled
// float32 tile. One element a load: any D, any alignment.
template <int R, int W, bool QUANT>
__device__ __forceinline__ void fill_keys(float* dst, const void* pool,
                                          const long long* off,
                                          const float* mul, int c0, int D) {
  const PoolT<QUANT>* p = static_cast<const PoolT<QUANT>*>(pool);
  for (int i = threadIdx.x; i < R * W; i += THREADS) {
    const int r = i / W;
    const int c = i % W;
    const long long o = off[r];
    float x = 0.f;
    if (o >= 0 && c0 + c < D) x = static_cast<float>(p[o + c0 + c]) * mul[r];
    dst[sw<W>(r, c)] = x;
  }
}

// Prefill tails and cold prompts at D > 256: out[:, c0:c0 + 128] of 64
// query rows of one (row, head), the keys through the table.
template <bool QUANT>
__global__ void __launch_bounds__(THREADS, 1)
paged_wide_tiled_kernel(const float* __restrict__ q, const void* k_pool,
                        const void* v_pool, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, float* __restrict__ out,
                        int S_q, int N, int D, int bs, int MB, float scale) {
  __shared__ __align__(16) float Qs[ROWS * DK];
  __shared__ __align__(16) float Ks[KEYS * DK];
  __shared__ __align__(16) float Vs[KEYS * DC];
  __shared__ long long koff[KEYS];
  __shared__ float kmul[KEYS], vmul[KEYS];
  __shared__ int qpos[ROWS];
  __shared__ int pmax_row, pmax_cta;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the deepest queries first
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int i0 = qt * ROWS;
  const int wr = 16 * warp;
  const int* prow_pos = pos + (size_t)b * S_q;

  if (threadIdx.x == 0) {
    pmax_row = 0;
    pmax_cta = -1;
  }
  __syncthreads();
  int mx = 0;
  for (int i = threadIdx.x; i < S_q; i += THREADS) mx = max(mx, prow_pos[i]);
  atomicMax(&pmax_row, mx);
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int p = i0 + r < S_q ? prow_pos[i0 + r] : -1;
    qpos[r] = p;
    atomicMax(&pmax_cta, p);
  }
  __syncthreads();
  const int live = live_keys(pmax_row, bs, MB);
  const int kend = min(live, pmax_cta + 1);  // keys some row here sees
  const int n_kv = kend > 0 ? (kend + KEYS - 1) / KEYS : 0;
  const int myq[2] = {qpos[wr + g], qpos[wr + g + 8]};
  const float qk = scale * LOG2E;
  auto visible = [&](int i, int key) -> float {
    return (key < kend && key <= myq[i]) ? 0.f : -INFINITY;
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
  zero4(acc);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * KEYS;
    // (every thread passed the last tile's barrier after its V fill)
    if (threadIdx.x < KEYS) {
      const int kk = j0 + threadIdx.x;
      long long off = -1, prow = 0;
      if (kk < kend) off = key_offset(table, b, kk, h, N, D, bs, MB, &prow);
      koff[threadIdx.x] = off;
      kmul[threadIdx.x] = (QUANT && off >= 0) ? k_scale[prow * N + h] : 1.f;
      vmul[threadIdx.x] = (QUANT && off >= 0) ? v_scale[prow * N + h] : 1.f;
    }
    float s[ST][4];
    zero4(s);
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();
      for (int i = threadIdx.x; i < ROWS * DK; i += THREADS) {
        const int r = i / DK;
        const int c = i % DK;
        float x = 0.f;
        if (i0 + r < S_q && d0 + c < D)
          x = q[(((size_t)b * S_q + i0 + r) * N + h) * D + d0 + c];
        Qs[sw<DK>(r, c)] = x;
      }
      fill_keys<KEYS, DK, QUANT>(Ks, k_pool, koff, kmul, d0, D);
      __syncthreads();
      chunk_scores<true, true>(s, Qs, Ks, wr, g, t);
    }
    fill_keys<KEYS, DC, QUANT>(Vs, v_pool, koff, vmul, c0, D);
    __syncthreads();
    softmax_step(s, acc, m, l, qk, visible, j0, t);
    frag_by_cols<true, true, 4>(acc, s, Vs, g, t);
  }
  quad_sum(l);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + wr + g + 8 * i;
    if (row >= S_q) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    float* o = out + (((size_t)b * S_q + row) * N + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * t + e;
        if (col < D) o[col] = acc[n][2 * i + e] / ls;
      }
    }
  }
}

// Decode and the verify window at D > 256: one split of SPLIT_KEYS logical
// keys of one (row, head), its partial (acc over a 1024-column chunk, m in
// log2 units, l) for each of the row's S_q <= QN queries into ``ws`` [B,
// N, S_q, splits, D + 2]. A split past the row's live keys writes an empty
// partial (m -inf, l 0, acc 0).
template <bool QUANT, int QN>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_wide_split_kernel(const float* __restrict__ q, const void* k_pool,
                        const void* v_pool, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, float* __restrict__ ws,
                        int S_q, int N, int D, int bs, int MB, int splits,
                        float scale) {
  __shared__ float p_s[QN][SPLIT_KEYS];
  __shared__ long long off_s[SPLIT_KEYS];
  __shared__ float kmul_s[SPLIT_KEYS], vmul_s[SPLIT_KEYS];
  __shared__ float m_s[QN], l_s[QN];
  const PoolT<QUANT>* kp = static_cast<const PoolT<QUANT>*>(k_pool);
  const PoolT<QUANT>* vp = static_cast<const PoolT<QUANT>*>(v_pool);

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / N;
  const int h = bh % N;
  const int cc0 = blockIdx.z * SPLIT_DC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int myq[QN];
  int pmax = 0;
#pragma unroll
  for (int qi = 0; qi < QN; ++qi) {
    myq[qi] = qi < S_q ? pos[(size_t)b * S_q + qi] : -1;
    pmax = max(pmax, myq[qi]);
  }
  const int live = live_keys(pmax, bs, MB);
  const int k_lo = split * SPLIT_KEYS;
  const int nk = max(0, min(min(live, pmax + 1), k_lo + SPLIT_KEYS) - k_lo);
  for (int i = threadIdx.x; i < nk; i += SPLIT_THREADS) {
    long long prow = 0;
    off_s[i] = key_offset(table, b, k_lo + i, h, N, D, bs, MB, &prow);
    kmul_s[i] = QUANT ? k_scale[prow * N + h] : 1.f;
    vmul_s[i] = QUANT ? v_scale[prow * N + h] : 1.f;
  }
  __syncthreads();

  // scores, a warp a key: lanes across D, reduced by shuffles
  const float qk = scale * LOG2E;
  for (int i = warp; i < nk; i += SPLIT_WARPS) {
    const PoolT<QUANT>* kr = kp + off_s[i];
    float dot[QN];
#pragma unroll
    for (int qi = 0; qi < QN; ++qi) dot[qi] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kv = static_cast<float>(kr[d]);
#pragma unroll
      for (int qi = 0; qi < QN; ++qi)
        if (qi < S_q)
          dot[qi] += __ldg(q + (((size_t)b * S_q + qi) * N + h) * D + d) * kv;
    }
#pragma unroll
    for (int qi = 0; qi < QN; ++qi) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot[qi] += __shfl_xor_sync(FULL, dot[qi], o);
      if (lane == 0)
        p_s[qi][i] = (k_lo + i <= myq[qi]) ? dot[qi] * kmul_s[i] * qk
                                           : -INFINITY;
    }
  }
  __syncthreads();

  // each query's max and sum over the split (warp qi), P in place
  if (warp < QN) {
    const int qi = warp;
    float mx = -INFINITY;
    for (int i = lane; i < nk; i += 32) mx = fmaxf(mx, p_s[qi][i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float safe = (mx == -INFINITY) ? 0.f : mx;
    float sum = 0.f;
    for (int i = lane; i < nk; i += 32) {
      const float sv = p_s[qi][i];
      const float p = (sv == -INFINITY) ? 0.f : ex2(sv - safe);
      sum += p;
      p_s[qi][i] = p * vmul_s[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      m_s[qi] = mx;
      l_s[qi] = sum;
    }
  }
  __syncthreads();

  // acc = P V over this thread's columns of the chunk
  float acc[QN][SPLIT_COLS];
#pragma unroll
  for (int qi = 0; qi < QN; ++qi)
#pragma unroll
    for (int j = 0; j < SPLIT_COLS; ++j) acc[qi][j] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const PoolT<QUANT>* vr = vp + off_s[i];
#pragma unroll
    for (int j = 0; j < SPLIT_COLS; ++j) {
      const int col = cc0 + threadIdx.x + SPLIT_THREADS * j;
      if (col < D) {
        const float vv = static_cast<float>(vr[col]);
#pragma unroll
        for (int qi = 0; qi < QN; ++qi) acc[qi][j] += p_s[qi][i] * vv;
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < QN; ++qi) {
    if (qi >= S_q) continue;
    float* w = ws + ((((size_t)b * N + h) * S_q + qi) * splits + split) *
                        (size_t)(D + 2);
#pragma unroll
    for (int j = 0; j < SPLIT_COLS; ++j) {
      const int col = cc0 + threadIdx.x + SPLIT_THREADS * j;
      if (col < D) w[col] = acc[qi][j];
    }
    if (blockIdx.z == 0 && threadIdx.x == 0) {
      w[D] = m_s[qi];
      w[D + 1] = l_s[qi];
    }
  }
}

// Merge one (row, head, query)'s splits in split order: out = sum_s acc_s
// 2^(m_s - M) / sum_s l_s 2^(m_s - M); 0 where no split saw a key.
__global__ void __launch_bounds__(THREADS)
paged_wide_combine_kernel(const float* __restrict__ ws,
                          float* __restrict__ out, int S_q, int N, int D,
                          int splits) {
  const int item = blockIdx.x;  // ((b N + h) S_q + qi)
  const int qi = item % S_q;
  const int bh = item / S_q;
  const int b = bh / N;
  const int h = bh % N;
  const float* w = ws + (size_t)item * splits * (D + 2);
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, w[(size_t)s * (D + 2) + D]);
  const float safe = (M == -INFINITY) ? 0.f : M;
  float L = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float m = w[(size_t)s * (D + 2) + D];
    if (m != -INFINITY) L += w[(size_t)s * (D + 2) + D + 1] * ex2(m - safe);
  }
  const float inv = (L == 0.f) ? 0.f : 1.f / L;
  float* o = out + (((size_t)b * S_q + qi) * N + h) * D;
  for (int col = threadIdx.x; col < D; col += THREADS) {
    float x = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float m = w[(size_t)s * (D + 2) + D];
      if (m != -INFINITY) x += w[(size_t)s * (D + 2) + col] * ex2(m - safe);
    }
    o[col] = x * inv;
  }
}

// -- launches -------------------------------------------------------------

// the query count a window call's kernel is instantiated for
inline int split_queries(int S_q) { return S_q <= 1 ? 1 : S_q <= 2 ? 2 : 4; }

template <bool QUANT, int QN>
auto split_kernel() {
  return paged_wide_split_kernel<QUANT, QN>;
}

template <bool QUANT, int QN>
int split_launch(const float* q, const void* kp, const void* vp,
                 const float* ks, const float* vs, const int* table,
                 const int* pos, float* ws, float* out, int B, int S_q, int N,
                 int D, int bs, int MB, int splits, float scale,
                 cudaStream_t st) {
  const dim3 grid(splits, B * N, (D + SPLIT_DC - 1) / SPLIT_DC);
  paged_wide_split_kernel<QUANT, QN><<<grid, SPLIT_THREADS, 0, st>>>(
      q, kp, vp, ks, vs, table, pos, ws, S_q, N, D, bs, MB, splits, scale);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  paged_wide_combine_kernel<<<B * N * S_q, THREADS, 0, st>>>(ws, out, S_q, N,
                                                             D, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int S_q, int S_k, int N, int D,
        int causal, float scale, cudaStream_t st) {
  const dim3 grid((S_q + ROWS - 1) / ROWS, B * N, D / DC);
  flash_wide_fwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, S_q, S_k, N,
      D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const float* bias,
       const void* dout, const float* lse, const float* delta, void* dq_out,
       int B, int S_q, int S_k, int N, int D, int causal, float scale,
       cudaStream_t st) {
  const dim3 grid((S_q + ROWS - 1) / ROWS, B * N, D / DC);
  flash_wide_dq_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq_out), S_q, S_k, N, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const float* bias,
        const void* dout, const float* lse, const float* delta, void* dk_out,
        void* dv_out, int B, int S_q, int S_k, int N, int D, int causal,
        float scale, cudaStream_t st) {
  const dim3 grid((S_k + ROWS - 1) / ROWS, B * N, 2 * (D / DC));
  flash_wide_dkv_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), S_q, S_k, N, D, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// out = {CTAs per SM, registers per thread, local (spill) bytes per
// thread, shared bytes} of one kernel (every one's shared memory static)
template <typename K>
int budget(K kern, int threads, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kern))
    return static_cast<int>(e);
  int ctas = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kern, threads, 0))
    return static_cast<int>(e);
  out[0] = ctas;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

bool flash_dims_ok(int D) { return D > 256 && D % DC == 0; }

}  // namespace

// Launch on ``stream``; each returns 0 when every launch was accepted,
// else the first CUDA error. The callers (ops/flash_attention.py,
// ops/paged_attention.py) check devices, shapes, dtypes, contiguity and
// alignment.
//
// Flash: the contract of tfos_flash_fwd / _dq / _dkv (flash_attention.cu)
// at D > 256, a multiple of 128 (the caller zero-pads).
extern "C" int tfos_wide_flash_fwd(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   void* out, float* lse, int B, int S_q,
                                   int S_k, int N, int D, int causal,
                                   float scale, int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  if (!flash_dims_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(q, k, v, bias, out, lse, B, S_q, S_k, N,
                                   D, causal, scale, st)
              : fwd<float>(q, k, v, bias, out, lse, B, S_q, S_k, N, D, causal,
                           scale, st);
}

extern "C" int tfos_wide_flash_dq(const void* q, const void* k, const void* v,
                                  const float* bias, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq_out, int B, int S_q, int S_k,
                                  int N, int D, int causal, float scale,
                                  int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  if (!flash_dims_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dq<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq_out, B,
                                  S_q, S_k, N, D, causal, scale, st)
              : dq<float>(q, k, v, bias, dout, lse, delta, dq_out, B, S_q,
                          S_k, N, D, causal, scale, st);
}

extern "C" int tfos_wide_flash_dkv(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk_out,
                                   void* dv_out, int B, int S_q, int S_k,
                                   int N, int D, int causal, float scale,
                                   int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  if (!flash_dims_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dkv<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk_out,
                                   dv_out, B, S_q, S_k, N, D, causal, scale,
                                   st)
              : dkv<float>(q, k, v, bias, dout, lse, delta, dk_out, dv_out, B,
                           S_q, S_k, N, D, causal, scale, st);
}

// Paged, 1 to 4 queries a row (decode, the verify window): the split
// kernel over ``splits`` splits of WIDE_SPLIT_KEYS logical keys a row,
// through the float32 workspace ``ws`` [B, N, S_q, splits, D + 2], then
// the combine kernel into ``out``.
extern "C" int tfos_wide_paged_split(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* ws, float* out, int B, int S_q, int N, int D,
    int bs, int MB, int splits, float scale, int quantized, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (S_q < 1 || S_q > 4 || D <= 0 || bs <= 0 || MB <= 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TFOS_WIDE_SPLIT(QUANT, QN)                                          \
  return split_launch<QUANT, QN>(q, k_pool, v_pool, k_scale, v_scale, table, \
                                 pos, ws, out, B, S_q, N, D, bs, MB, splits, \
                                 scale, st)
  switch (split_queries(S_q)) {
    case 1:
      if (quantized) TFOS_WIDE_SPLIT(true, 1);
      TFOS_WIDE_SPLIT(false, 1);
    case 2:
      if (quantized) TFOS_WIDE_SPLIT(true, 2);
      TFOS_WIDE_SPLIT(false, 2);
    default:
      if (quantized) TFOS_WIDE_SPLIT(true, 4);
      TFOS_WIDE_SPLIT(false, 4);
  }
#undef TFOS_WIDE_SPLIT
}

// Paged, any other call (prefill tails, cold prompts): the tensor-core
// tiled kernel, any block size.
extern "C" int tfos_wide_paged_tiled(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* out, int B, int S_q, int N, int D, int bs, int MB,
    float scale, int quantized, void* stream) {
  if (B <= 0 || S_q <= 0 || N <= 0) return 0;
  if (D <= 0 || bs <= 0 || MB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S_q + ROWS - 1) / ROWS, B * N, (D + DC - 1) / DC);
  if (quantized)
    paged_wide_tiled_kernel<true><<<grid, THREADS, 0, st>>>(
        q, k_pool, v_pool, k_scale, v_scale, table, pos, out, S_q, N, D, bs,
        MB, scale);
  else
    paged_wide_tiled_kernel<false><<<grid, THREADS, 0, st>>>(
        q, k_pool, v_pool, k_scale, v_scale, table, pos, out, S_q, N, D, bs,
        MB, scale);
  return static_cast<int>(cudaGetLastError());
}

// The resource budget of one kernel (none depends on D): ``kernel`` 0 the
// paged tiled kernel, 1 the paged split kernel at ``queries`` queries a
// row (its instantiation: 1, 2 or 4), 2 the flash forward, 3 dQ, 4 dK/dV;
// ``variant``: int8 pools (paged) or bfloat16 (flash). out[4] = {CTAs per
// SM, registers per thread, local (spill) bytes per thread, shared bytes}.
extern "C" int tfos_wide_budget(int kernel, int variant, int queries,
                                int* out) {
  const bool v = variant != 0;
  switch (kernel) {
    case 0:
      return v ? budget(paged_wide_tiled_kernel<true>, THREADS, out)
               : budget(paged_wide_tiled_kernel<false>, THREADS, out);
    case 1:
      switch (split_queries(queries)) {
        case 1:
          return v ? budget(split_kernel<true, 1>(), SPLIT_THREADS, out)
                   : budget(split_kernel<false, 1>(), SPLIT_THREADS, out);
        case 2:
          return v ? budget(split_kernel<true, 2>(), SPLIT_THREADS, out)
                   : budget(split_kernel<false, 2>(), SPLIT_THREADS, out);
        default:
          return v ? budget(split_kernel<true, 4>(), SPLIT_THREADS, out)
                   : budget(split_kernel<false, 4>(), SPLIT_THREADS, out);
      }
    case 2:
      return v ? budget(flash_wide_fwd_kernel<__nv_bfloat16>, THREADS, out)
               : budget(flash_wide_fwd_kernel<float>, THREADS, out);
    case 3:
      return v ? budget(flash_wide_dq_kernel<__nv_bfloat16>, THREADS, out)
               : budget(flash_wide_dq_kernel<float>, THREADS, out);
    case 4:
      return v ? budget(flash_wide_dkv_kernel<__nv_bfloat16>, THREADS, out)
               : budget(flash_wide_dkv_kernel<float>, THREADS, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
