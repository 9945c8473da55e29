// Paged causal attention through a block table, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// tensorflowonspark_tpu/ops/paged_attention.py::_paged_kernel (wrapper
// _pallas). What it computes, for every (row b, head h, query i):
//
//   out[b,i,h,:] = softmax_k( q[b,i,h,:] . K[k,h,:] * scale ) @ V[k,h,:]
//
// over the key positions k <= pos[b,i] of row b's LIVE blocks, where
// logical block j of row b is pool row table[b,j] and the row occupies
// nblk(b) = min((max_i pos[b,i] + bs) / bs, MB) blocks. int8 pools are
// dequantized right after the load (code * per-row-per-head scale).
//
// Two routes, one source. The TPU kernel walks a sequential grid axis
// over table slots and carries its online-softmax state in VMEM from one
// grid step to the next; CUDA blocks run in no order, so each route
// loops over live blocks inside a CTA, reads the table and positions
// from global memory in place of scalar prefetch, keeps the softmax
// state in float32 with the reference's -inf guards, and never reads a
// pool row outside the live set.
//
// What bounds it on the H100: BYTES at decode. A decode step (S_q = 1)
// does ~2 flop per live K/V byte, far below the ridge of any route, so
// the floor is the live K/V (+ scales) over 3.35 TB/s.
//
// - Split-KV (tfos_paged_attention_split; S_q = 1, decode): the
//   flash-decoding schedule. Grid (splits, N, B), one CTA per C
//   consecutive pool blocks of one (row, head), so every SM streams K/V
//   even at 8 rows x 12 heads. A CTA whose split starts at or past the
//   row's live blocks returns before it reads the table. Its 4 warps
//   take the split's blocks in turn; a key row of one head (D elements)
//   is read by D / VEC lanes with 16-byte ld.global.nc loads straight
//   into registers (VEC = 4 float32 or 16 int8 codes, dequantized right
//   after the load), several keys per warp-wide load, the query held
//   in registers. A dot reduces over the lanes that share its key with
//   __shfl_xor_sync; each group of lanes carries its own online-softmax
//   state over its keys, the groups are merged by shuffles and the warps
//   through shared memory in a fixed order, and the CTA writes (m, l,
//   acc[D]) to a float32 workspace. A second small kernel merges each
//   (row, head)'s live splits in split order: M = max m_s, out =
//   sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s. Every launched split
//   holds a visible key (its first key sits at or below the query's
//   position); a row with no visible key launches no split and gives 0.
//   No atomics: two calls on the same inputs are bitwise equal. Only
//   decode takes this route: a window of several queries per row (as a
//   speculative verify step would send) goes to the query-tiled kernel.
// - Query-tiled (tfos_paged_attention; prefill tails): one CTA per
//   (16-query tile, head, row) walks the row's live blocks in order.
//   Each iteration stages one pool block of K and V in shared memory
//   (dequantized on load), and each warp folds it into the running
//   state of its query rows, on CUDA cores. A block is read once per
//   query tile rather than once per query.
//
// Plain C interface, loaded through ctypes by ops/_build.py.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QT = 16;               // query rows per CTA
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = QT / WARPS;      // query rows per warp
constexpr int MAX_DC = 8;            // head_dim / 32, rounded up (D <= 256)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// floor division (Python's //) for a positive divisor
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ table,
                       const int* __restrict__ pos,
                       float* __restrict__ out,
                       int S_q, int N, int D, int P, int bs, int MB,
                       float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;              // padded rows: column reads hit distinct banks
  float* Ks = smem;                  // [bs][D + 1]
  float* Vs = Ks + bs * dp;          // [bs][D + 1]
  float* Qs = Vs + bs * dp;          // [QT][D]
  __shared__ int s_rowmax;
  __shared__ int s_tilemax;

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = tile * QT;
  const int rows_here = min(QT, S_q - i0);
  const int* prow_ptr = pos + (size_t)b * S_q;

  if (tid == 0) {
    s_rowmax = INT_MIN;
    s_tilemax = INT_MIN;
  }
  __syncthreads();
  // the row's depth comes from ALL of its queries, as in the reference;
  // the tile's own highest position bounds the blocks it can see
  int pmax = INT_MIN, tmax = INT_MIN;
  for (int i = tid; i < S_q; i += THREADS) {
    const int p = prow_ptr[i];
    pmax = max(pmax, p);
    if (i >= i0 && i < i0 + rows_here) tmax = max(tmax, p);
  }
  atomicMax(&s_rowmax, pmax);
  atomicMax(&s_tilemax, tmax);
  for (int e = tid; e < QT * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    float v = 0.f;
    if (r < rows_here) v = q[(((size_t)b * S_q + i0 + r) * N + h) * D + d];
    Qs[e] = v;
  }
  __syncthreads();
  const int nblk = min(floordiv(s_rowmax + bs, bs), MB);
  // blocks past the tile's highest position hold no key any of its
  // rows may see: skipping them leaves the recurrence unchanged
  const int limit = max(0, min(nblk, floordiv(s_tilemax + bs, bs)));

  float m[RPW], l[RPW], acc[RPW][MAX_DC];
  int prow[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + r * WARPS;
    m[r] = -INFINITY;
    l[r] = 0.f;
    prow[r] = row < rows_here ? prow_ptr[i0 + row] : INT_MIN;
#pragma unroll
    for (int c = 0; c < MAX_DC; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < limit; ++j) {
    const int bid = table[(size_t)b * MB + j];
    if (bid < 0 || bid >= P) __trap();   // a table entry outside the pool
    __syncthreads();                     // last block's readers are done
    for (int e = tid; e < bs * D; e += THREADS) {
      const int t = e / D;
      const int d = e - t * D;
      const size_t row = ((size_t)bid * bs + t) * N + h;
      const size_t src = row * D + d;
      float kv, vv;
      if (QUANT) {
        kv = (float)static_cast<const int8_t*>(k_pool)[src] * k_scale[row];
        vv = (float)static_cast<const int8_t*>(v_pool)[src] * v_scale[row];
      } else {
        kv = static_cast<const float*>(k_pool)[src];
        vv = static_cast<const float*>(v_pool)[src];
      }
      Ks[t * dp + d] = kv;
      Vs[t * dp + d] = vv;
    }
    __syncthreads();
    const int kpos = j * bs + lane;      // lane t scores key t of the block
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + r * WARPS;
      if (row >= rows_here) break;       // warp-uniform
      float s = -INFINITY;
      if (lane < bs && kpos <= prow[r]) {
        const float* qr = Qs + row * D;
        const float* kr = Ks + lane * dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_blk = warp_max(s);
      const float m_new = fmaxf(m[r], m_blk);
      const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
      const float p = (s == -INFINITY) ? 0.f : expf(s - safe_m);
      const float corr = (m[r] == -INFINITY) ? 0.f : expf(m[r] - safe_m);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      float pv[MAX_DC];
#pragma unroll
      for (int c = 0; c < MAX_DC; ++c) pv[c] = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float pt = __shfl_sync(FULL, p, t);
#pragma unroll
        for (int c = 0; c < MAX_DC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) pv[c] = fmaf(pt, Vs[t * dp + d], pv[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < MAX_DC; ++c) acc[r][c] = acc[r][c] * corr + pv[c];
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + r * WARPS;
    if (row >= rows_here) break;
    const float lsafe = (l[r] == 0.f) ? 1.f : l[r];
    float* o = out + (((size_t)b * S_q + i0 + row) * N + h) * D;
#pragma unroll
    for (int c = 0; c < MAX_DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[r][c] / lsafe;
    }
  }
}

// -- split-KV route ------------------------------------------------------

constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;

// pool blocks [0, n) a decode row's one query at position p can see
__device__ __forceinline__ int live_blocks(int p, int bs, int MB) {
  return max(0, min(floordiv(p + bs, bs), MB));
}

// one 16-byte vector of a key row as float32: VEC = 4 float32 values,
// or 16 int8 codes times their (token, head) scale
template <bool QUANT>
struct KVec {
  static constexpr int VEC = QUANT ? 16 : 4;
  int4 raw;
  float sc;
  __device__ __forceinline__ void load(const void* pool, const float* scales,
                                       size_t row, int D, int d0, bool ok) {
    if (!ok) {
      raw = make_int4(0, 0, 0, 0);
      sc = 0.f;
      return;
    }
    const size_t e = row * D + d0;
    if (QUANT) {
      raw = __ldg(reinterpret_cast<const int4*>(
          static_cast<const int8_t*>(pool) + e));
      sc = __ldg(scales + row);
    } else {
      raw = __ldg(reinterpret_cast<const int4*>(
          static_cast<const float*>(pool) + e));
      sc = 1.f;
    }
  }
  // element e of the vector, dequantized
  __device__ __forceinline__ float at(int e) const {
    const int w = e < VEC / 4     ? raw.x
                  : e < VEC / 2   ? raw.y
                  : e < 3 * VEC / 4 ? raw.z
                                    : raw.w;
    if (QUANT) {
      const int8_t c = static_cast<int8_t>(
          static_cast<unsigned>(w) >> (8 * (e % 4)));
      return static_cast<float>(c) * sc;
    }
    return __int_as_float(w);
  }
};

// fold state (m2, l2, a2) into (m, l, a): the reference's -inf guards
template <int VEC>
__device__ __forceinline__ void merge(float& m, float& l, float (&a)[VEC],
                                      float m2, float l2,
                                      const float (&a2)[VEC]) {
  const float mn = fmaxf(m, m2);
  const float safe = (mn == -INFINITY) ? 0.f : mn;
  const float c1 = (m == -INFINITY) ? 0.f : expf(m - safe);
  const float c2 = (m2 == -INFINITY) ? 0.f : expf(m2 - safe);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = a[e] * c1 + a2[e] * c2;
  m = mn;
}

// One CTA per (split, head, row): the row's one query against its pool
// blocks [sp C, min((sp + 1) C, live)); writes (acc[D], m, l) to
// ws[(b N + h) splits + sp][D + 2].
template <bool QUANT, int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_split_kernel(const float* __restrict__ q,
                   const void* __restrict__ k_pool,
                   const void* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   float* __restrict__ ws, int N, int P, int bs, int MB, int C,
                   float scale) {
  constexpr int VEC = KVec<QUANT>::VEC;
  constexpr int LPK = D / VEC;             // lanes that share one key row
  constexpr int KPL = 32 / LPK;            // keys of one warp-wide load
  constexpr int U = QUANT ? 2 : 8;         // loads in flight per operand
  static_assert(D % VEC == 0 && LPK <= 32 && 32 % LPK == 0,
                "a key row must split into a power-of-two of 16-byte lanes");
  __shared__ float s_m[SPLIT_WARPS];
  __shared__ float s_l[SPLIT_WARPS];
  __shared__ float s_acc[SPLIT_WARPS][D];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pq = pos[b];
  const int j_lo = sp * C;
  const int live = live_blocks(pq, bs, MB);
  if (j_lo >= live) return;                // CTA-uniform: no table read
  const int j_hi = min(j_lo + C, live);

  const int kg = lane / LPK;               // the lane's key within a load
  const int d0 = (lane % LPK) * VEC;       // the lane's dims d0..d0 + VEC
  const float* qr = q + ((size_t)b * N + h) * D;
  float qv[VEC], acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    qv[e] = qr[d0 + e];
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j = j_lo + warp; j < j_hi; j += SPLIT_WARPS) {
    const int bid = table[(size_t)b * MB + j];
    if (bid < 0 || bid >= P) __trap();     // a table entry outside the pool
    for (int t0 = 0; t0 < bs; t0 += U * KPL) {
      KVec<QUANT> kx[U], vx[U];
      float s[U];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        const bool ok = tok < bs;
        const size_t row = ((size_t)bid * bs + (ok ? tok : 0)) * N + h;
        kx[u].load(k_pool, k_scale, row, D, d0, ok);
        vx[u].load(v_pool, v_scale, row, D, d0, ok);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], kx[u].at(e), dot);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1) dot += __shfl_xor_sync(FULL, dot, o);
        s[u] = (tok < bs && j * bs + tok <= pq) ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m, mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m == -INFINITY) ? 0.f : expf(m - safe);
      l *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = (s[u] == -INFINITY) ? 0.f : expf(s[u] - safe);
        l += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vx[u].at(e), acc[e]);
      }
      m = m_new;
    }
  }

  // the warp's key groups hold the same dims: merge them by shuffles
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    float a2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) a2[e] = __shfl_xor_sync(FULL, acc[e], o);
    const float m2 = __shfl_xor_sync(FULL, m, o);
    const float l2 = __shfl_xor_sync(FULL, l, o);
    merge<VEC>(m, l, acc, m2, l2, a2);
  }
  if (kg == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_acc[warp][d0 + e] = acc[e];
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  // the warps merged in order 0..3; entry D of a slot is m, D + 1 is l
  float* slot = ws + (((size_t)b * N + h) * gridDim.x + sp) * (D + 2);
  for (int d = threadIdx.x; d < D; d += SPLIT_THREADS) {
    float mm = s_m[0], ll = s_l[0];
    float aa[1] = {s_acc[0][d]};
#pragma unroll
    for (int w = 1; w < SPLIT_WARPS; ++w) {
      const float a2[1] = {s_acc[w][d]};
      merge<1>(mm, ll, aa, s_m[w], s_l[w], a2);
    }
    slot[d] = aa[0];
    if (d == 0) {
      slot[D] = mm;
      slot[D + 1] = ll;
    }
  }
}

// One warp per (row, head): merge its live splits in split order.
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_combine_kernel(const float* __restrict__ ws, const int* __restrict__ pos,
                     float* __restrict__ out, int N, int bs, int MB, int C,
                     int splits, int items) {
  constexpr int DC = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * SPLIT_WARPS + (threadIdx.x >> 5);
  if (item >= items) return;               // warp-uniform
  // the splits the split kernel wrote: the same count from the same pos
  const int live = live_blocks(pos[item / N], bs, MB);
  const int ns = (live + C - 1) / C;
  const float* w = ws + (size_t)item * splits * (D + 2);
  float M = -INFINITY;
  for (int s = lane; s < ns; s += 32) M = fmaxf(M, w[(size_t)s * (D + 2) + D]);
  M = warp_max(M);
  const float safe = (M == -INFINITY) ? 0.f : M;
  float L = 0.f, A[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) A[c] = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* slot = w + (size_t)s * (D + 2);
    const float ms = slot[D];
    const float cs = (ms == -INFINITY) ? 0.f : expf(ms - safe);
    L += cs * slot[D + 1];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) A[c] += cs * slot[d];
    }
  }
  const float ls = (L == 0.f) ? 1.f : L;
  float* o = out + (size_t)item * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) o[d] = A[c] / ls;
  }
}

template <bool QUANT, int D>
int split_launch(const float* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale, const int* table,
                 const int* pos, float* ws, float* out, int B, int N, int P,
                 int bs, int MB, int C, float scale, cudaStream_t st) {
  const int splits = (MB + C - 1) / C;
  paged_split_kernel<QUANT, D><<<dim3(splits, N, B), SPLIT_THREADS, 0, st>>>(
      q, k_pool, v_pool, k_scale, v_scale, table, pos, ws, N, P, bs, MB, C,
      scale);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int items = B * N;
  paged_combine_kernel<D>
      <<<(items + SPLIT_WARPS - 1) / SPLIT_WARPS, SPLIT_THREADS, 0, st>>>(
          ws, pos, out, N, bs, MB, C, splits, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the query-tiled kernel on ``stream``; returns
// cudaGetLastError() (0 when the launch was accepted). The caller checks
// shapes, dtypes and contiguity.
extern "C" int tfos_paged_attention(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* out, int B, int S_q, int N, int D, int P,
    int bs, int MB, float scale, int quantized, void* stream) {
  if (B <= 0 || S_q <= 0 || N <= 0) return 0;
  const dim3 grid((S_q + QT - 1) / QT, N, B);
  const size_t smem = (size_t)(2 * bs * (D + 1) + QT * D) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    paged_attention_kernel<true><<<grid, THREADS, smem, st>>>(
        q, k_pool, v_pool, k_scale, v_scale, table, pos, out, S_q, N, D, P,
        bs, MB, scale);
  } else {
    paged_attention_kernel<false><<<grid, THREADS, smem, st>>>(
        q, k_pool, v_pool, k_scale, v_scale, table, pos, out, S_q, N, D, P,
        bs, MB, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the split-KV route on ``stream`` for one query per row
// (decode: q [B, 1, N, D], pos [B, 1]): the split kernel, C pool blocks
// per split, into the float32 workspace ``ws`` [B, N, ceil(MB / C),
// D + 2], then the combine kernel into ``out``. D in {16, 32, 64, 128},
// pools 16-byte aligned (the caller checks). Returns the first launch's
// CUDA error (0 when both were accepted).
extern "C" int tfos_paged_attention_split(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* ws, float* out, int B, int N, int D, int P,
    int bs, int MB, int C, float scale, int quantized, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (C <= 0 || MB <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TFOS_SPLIT(QUANT, DD)                                               \
  return split_launch<QUANT, DD>(q, k_pool, v_pool, k_scale, v_scale, table, \
                                 pos, ws, out, B, N, P, bs, MB, C, scale, st)
  if (quantized) {
    switch (D) {
      case 16: TFOS_SPLIT(true, 16);
      case 32: TFOS_SPLIT(true, 32);
      case 64: TFOS_SPLIT(true, 64);
      case 128: TFOS_SPLIT(true, 128);
    }
  } else {
    switch (D) {
      case 16: TFOS_SPLIT(false, 16);
      case 32: TFOS_SPLIT(false, 32);
      case 64: TFOS_SPLIT(false, 64);
      case 128: TFOS_SPLIT(false, 128);
    }
  }
#undef TFOS_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}
