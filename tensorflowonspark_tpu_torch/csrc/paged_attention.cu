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
// Design. The TPU kernel walks a sequential grid axis over table slots
// and carries its online-softmax state in VMEM from one grid step to
// the next; CUDA blocks run in no order, so here one CTA owns a whole
// (query tile, head, row) and loops over the row's live blocks itself,
// reading the table and positions from global memory in place of
// scalar prefetch. Each iteration stages one pool block of K and V in
// shared memory (dequantized on load), and each warp folds it into the
// running max / denominator / accumulator of its query rows, all in
// fp32, with the same -inf guards as the reference. Pool rows outside
// the live set are never read. The work is bound by the bytes of live
// K/V; this first version uses CUDA cores only (no wgmma, no TMA, no
// split-KV), see PERF.md for its measured share of that bound.
//
// Plain C interface, loaded through ctypes by ops/_build.py.

#include <climits>
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

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 when the launch
// was accepted). The caller checks shapes, dtypes and contiguity.
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
