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
// nblk(b) = min((max_i pos[b,i] + bs) / bs, MB) blocks. int8 pools hold
// codes with one float32 scale per (token row, head); K = codes * scale.
//
// Three routes, one source. The TPU kernel walks a sequential grid axis
// over table slots and carries its online-softmax state in VMEM from one
// grid step to the next; CUDA blocks run in no order, so each route
// loops over live keys inside a CTA, reads the table and positions from
// global memory in place of scalar prefetch, keeps the softmax state in
// float32 with the reference's -inf guards, and never reads a pool row
// outside the live set. No atomics on the data: two calls on the same
// inputs are bitwise equal.
//
// What bounds it on the H100: BYTES at decode. A decode step (S_q = 1)
// does ~2 flop per live K/V byte, far below the ridge of any route, so
// the floor is the live K/V (+ scales) over 3.35 TB/s. A prefill tail of
// a few hundred queries reuses each key that often, and is bound by
// OPERATIONS: 4 D flop per visible (query, key) pair at the
// float32-accurate tensor-core rate.
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
//   At D 256 decode runs a kernel of its own (paged_split256_kernel):
//   8 keys in flight a warp (16 at int8; the D <= 128 shape held 4 at
//   float32), exp on ex2, the position and the first table entry read
//   together, a grid with the split slowest (every row's first split is
//   dispatched first, the dead splits of short rows last), and no
//   combine kernel: the CTA that publishes a (row, head)'s last partial
//   merges them all (last_to_publish, merge_splits: a ticket per (row,
//   head) counted by atomics, the partials in split order, so the result
//   stays deterministic), which saved the combine kernel's launch and
//   its one L2 round trip a split.
// - Window (tfos_paged_attention_window; 2 <= S_q <= 4 queries a row at
//   those D: the speculative verify window). The split route's schedule
//   for several queries: one CTA per (head, row, split of C = 8 blocks),
//   each key row read from device memory once, into registers (4-element
//   vectors: 16 bytes of float32, 4 of int8 codes), and dotted with
//   every query of the row (Q from shared memory); each query keeps its
//   own mask (key <= pos[b, i], positions not assumed consecutive) and
//   online-softmax state, so a query that sees no key of a split carries
//   m = -inf, l = 0 there and the merge skips it; a split launches iff
//   its first key is at or below the row's highest position. The merge
//   is folded into the last CTA as at D 256. Its cost grows with the
//   queries a row (a dot's lanes reduce by shuffles per query), so past
//   4 the tiled kernel, whose 16-row tile costs the same at 2 or 16, is
//   faster (profile_paged.py --crossover; PERF.md).
// - Query-tiled on the tensor cores (tfos_paged_attention_tiled; every
//   other call, D <= 256: prefill tails, cold prompts, verify windows,
//   decode at a D the split kernel is not built for). One CTA of 4 warps
//   per (16-query tile, head, row); the query tile is the grid's slowest
//   dimension, so every head's and row's deepest tile is dispatched
//   before any shallower one (the longest CTAs first, also where a head
//   has more tiles than one CTA an SM can hold at once: at D 256). The 16
//   queries are one mma row block; the 4 warps split the keys instead, so
//   a 256-token tail at 12 heads is 192 CTAs on the 132 SMs. Keys come in
//   tiles of BN (64, or 32 at D 128 and 256); warp w takes keys [w BN/4,
//   (w + 1) BN/4) of every tile and streams that slice itself through its
//   own part of a two-stage cp.async ring, waiting with __syncwarp, never
//   for the other warps. Key j's row is pool row table[b, j / bs], token
//   j % bs, so a tile crosses pool blocks freely and any block size
//   works; lanes lie side by side along the rows, so one warp-wide copy
//   moves whole rows. The CTA of query tile x takes its key tiles
//   starting at tile x mod (its tiles) and wraps around, so the 16 query
//   tiles of a head, which run side by side, do not all ask the same L2
//   lines at once (the same keys in the same order ran ~15% slower). The keys stop at the tile's key limit,
//   min(nblk bs, its highest position + 1): keys past it are zero-filled
//   by the copy (src-size 0), never read, and masked. Each warp keeps
//   its own online softmax on C fragments, as the flash forward does
//   (row max by two quad shuffles, l per lane, P from C fragment to A
//   fragment in registers); at the end the 4 warps' (m, l, acc) merge
//   through shared memory in warp order. S = Q K^T and acc += P V are
//   mma.sync m16n8k8 TF32 with the 3xTF32 split (tc_common.cuh),
//   float32-accurate; Q enters unscaled and the scale multiplies the
//   float32 product. Each (query, key) pair is masked by key <= pos[b, i]
//   with per-query positions (not assumed consecutive); 8-key score
//   tiles past the limit are skipped; pad rows past S_q load zeros and
//   store nothing. int8 pools are staged as codes, a quarter of the
//   bytes, and converted in the fragment loads: codes are exact in TF32,
//   so Q codes^T and P' codes take 2 passes (Q_hi c + Q_lo c), with
//   k_scale folded into S column by column and v_scale into P's columns
//   (P') before P' V. Head dims are instantiated at DP in {16, 32, 64,
//   128, 256}; a D below one is zero-padded in shared memory (Q and K pad
//   columns are 0; V's pad columns are dropped at the store). Copies are
//   16-byte where a row's bytes and the pointers allow, else 4-byte,
//   else (int8 rows of D % 4 != 0) byte by byte. At the prefill shapes
//   the copies, not the products, take the most time (PERF.md).
//   tfos_paged_budget reads back registers, spills, shared memory and
//   CTAs per SM.
//   At DP 256 a warp's 16 x 256 float32 accumulator takes 128 registers a
//   lane, so: key tiles of 32 (8 keys, one score tile a warp); the 32 k
//   steps of S = Q K^T feed four partial sums in turn, unrolled 8 at a
//   time (one accumulator would make a chain of 96 dependent mmas, and
//   all 32 steps unrolled hoist loads past the registers); P V takes its
//   B fragments 2 column blocks at a time. A float32 ring of 2 stages x
//   (K + V) x 32 rows of 1 KB is 128 KB, 144 KB with the Q tile: one CTA
//   an SM (int8: 80.5 KB, the 4-warp merge, 66 KB, being the larger use of
//   the ring's space). A 256-token tail at 8 heads is 128 CTAs.
//
// Plain C interface, loaded through ctypes by ops/_build.py.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

// split, mma_tf32, the swizzled fragment loads, mma3_rows, c_to_a, ex2
// and the cp.async copies
#include "tc_common.cuh"

namespace {

// CTA stamps for profile_paged.py --trace (built with -DTFOS_PAGED_TRACE
// only): per CTA of the traced kernels, in launch order of its linear
// block index, the globaltimer (ns) at its start and end and its SM.
// Compiled out otherwise.
#ifdef TFOS_PAGED_TRACE
constexpr int TRACE_CTAS = 16384;
__device__ unsigned long long tfos_trace[TRACE_CTAS][3];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int trace_cta() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
#define TFOS_TRACE_START const unsigned long long trace_t0 = trace_now()
#define TFOS_TRACE_END                                                        \
  do {                                                                        \
    __syncthreads();                                                          \
    if (threadIdx.x == 0 && trace_cta() < TRACE_CTAS) {                       \
      unsigned smid;                                                          \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));                       \
      tfos_trace[trace_cta()][0] = trace_t0;                                  \
      tfos_trace[trace_cta()][1] = trace_now();                               \
      tfos_trace[trace_cta()][2] = smid;                                      \
    }                                                                         \
  } while (0)
#else
#define TFOS_TRACE_START
#define TFOS_TRACE_END
#endif

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// floor division (Python's //) for a positive divisor
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
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

// fold state (m2, l2, a2) into (m, l, a): the reference's -inf guards;
// LOG2: m in log2 units, weights on ex2 (the window and D-256 kernels)
template <int VEC, bool LOG2 = false>
__device__ __forceinline__ void merge(float& m, float& l, float (&a)[VEC],
                                      float m2, float l2,
                                      const float (&a2)[VEC]) {
  const float mn = fmaxf(m, m2);
  const float safe = (mn == -INFINITY) ? 0.f : mn;
  const float c1 = (m == -INFINITY) ? 0.f
                   : LOG2           ? ex2(m - safe)
                                    : expf(m - safe);
  const float c2 = (m2 == -INFINITY) ? 0.f
                   : LOG2            ? ex2(m2 - safe)
                                     : expf(m2 - safe);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = a[e] * c1 + a2[e] * c2;
  m = mn;
}

// How the split kernel lays a key row of D <= 128 elements over a warp:
// LPK lanes share a row, each carrying NV 16-byte vectors of it (vector v
// of the lane holds dims v LPK VEC + (lane % LPK) VEC .., so the row's
// lanes read neighbouring 16 bytes); KPL keys per warp-wide load; U loads
// in flight per operand. (A row wider than 32 vectors would put NV = 2 on
// each lane; D 256 has a kernel of its own, paged_split256_kernel.)
template <bool QUANT, int D>
struct SplitShape {
  static constexpr int VEC = KVec<QUANT>::VEC;
  static constexpr int NV = D / VEC > 32 ? D / VEC / 32 : 1;
  static constexpr int LPK = D / (VEC * NV);
  static constexpr int KPL = 32 / LPK;
  static constexpr int U = (QUANT ? 2 : 8) / NV > 0 ? (QUANT ? 2 : 8) / NV : 1;
  static_assert(D % (VEC * NV) == 0 && LPK <= 32 && 32 % LPK == 0,
                "a key row must split into a power-of-two of 16-byte lanes");
};

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
  TFOS_TRACE_START;
  using SS = SplitShape<QUANT, D>;
  constexpr int VEC = SS::VEC;
  constexpr int NV = SS::NV;               // vectors a lane carries per row
  constexpr int LPK = SS::LPK;             // lanes that share one key row
  constexpr int KPL = SS::KPL;             // keys of one warp-wide load
  constexpr int U = SS::U;                 // loads in flight per operand
  constexpr int E = NV * VEC;              // dims a lane holds
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
  const int d0 = (lane % LPK) * VEC;       // its dims in vector 0: d0..d0 + VEC
  const float* qr = q + ((size_t)b * N + h) * D;
  float qv[E], acc[E];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[v * VEC + e] = qr[v * LPK * VEC + d0 + e];
      acc[v * VEC + e] = 0.f;
    }
  float m = -INFINITY, l = 0.f;

  for (int j = j_lo + warp; j < j_hi; j += SPLIT_WARPS) {
    const int bid = table[(size_t)b * MB + j];
    if (bid < 0 || bid >= P) __trap();     // a table entry outside the pool
    for (int t0 = 0; t0 < bs; t0 += U * KPL) {
      KVec<QUANT> kx[U][NV], vx[U][NV];
      float s[U];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        const bool ok = tok < bs;
        const size_t row = ((size_t)bid * bs + (ok ? tok : 0)) * N + h;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kx[u][v].load(k_pool, k_scale, row, D, v * LPK * VEC + d0, ok);
          vx[u][v].load(v_pool, v_scale, row, D, v * LPK * VEC + d0, ok);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(qv[v * VEC + e], kx[u][v].at(e), dot);
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
      for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = (s[u] == -INFINITY) ? 0.f : expf(s[u] - safe);
        l += p;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[v * VEC + e] = fmaf(p, vx[u][v].at(e), acc[v * VEC + e]);
      }
      m = m_new;
    }
  }

  // the warp's key groups hold the same dims: merge them by shuffles
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    float a2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) a2[e] = __shfl_xor_sync(FULL, acc[e], o);
    const float m2 = __shfl_xor_sync(FULL, m, o);
    const float l2 = __shfl_xor_sync(FULL, l, o);
    merge<E>(m, l, acc, m2, l2, a2);
  }
  if (kg == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[warp][v * LPK * VEC + d0 + e] = acc[v * VEC + e];
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
  TFOS_TRACE_END;
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

// -- folded merge (window route; split-KV decode at D 256) -----------------

// The CTA that publishes a (row, head)'s last partial merges them all:
// every thread fences the partial it wrote; then one thread adds one to
// the pair's ticket with acquire-release semantics (so the CTA that
// takes the count to ``ns``, the splits the row launched, sees every
// other CTA's partial after the barrier) and, in that CTA, puts the
// ticket back to 0 for the next call (the wrapper hands each call
// tickets of its own, all 0). Which CTA merges depends on timing; what
// it computes does not (the splits merge in split order), so two calls
// on the same inputs are bitwise equal.
__device__ __forceinline__ bool last_to_publish(int* ticket, int ns) {
  __shared__ int s_last;
  __threadfence();                         // this thread's partial, published
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    s_last = old == ns - 1;
    if (s_last) *reinterpret_cast<volatile int*>(ticket) = 0;
  }
  __syncthreads();
  return s_last;
}

// Merge the ``ns`` partials (acc[D], m, l; m in log2 units) of each of
// the S_q <= QN queries of one (row, head) — query i's at w + i splits
// (D + 2), split s at + s (D + 2) — in split order: M = max m_s, out =
// sum 2^(m_s - M) acc_s / sum 2^(m_s - M) l_s (a split with m = -inf adds
// nothing; no visible key at all gives 0). A thread owns K output
// elements; it loads their acc from the first SR splits into registers
// while the (query, split) pairs' m and l go to shared memory (up to
// ``MERGE_PAIRS`` of them; past that, from L2 in the loop), so a merge of
// up to SR splits waits on one L2 round trip. Partials are read through
// L2 (``__ldcg``): other SMs wrote them. Query i's output goes to out + i
// qstride.
constexpr int MERGE_PAIRS = 256;

template <int D, int QN>
__device__ __forceinline__ void merge_splits(const float* __restrict__ w,
                                             int S_q, int splits, int ns,
                                             float* __restrict__ out,
                                             size_t qstride) {
  constexpr int K = (QN * D + SPLIT_THREADS - 1) / SPLIT_THREADS;
  constexpr int SR = K >= 32 ? 1 : 32 / K;
  __shared__ float s_m[MERGE_PAIRS];
  __shared__ float s_l[MERGE_PAIRS];
  const bool staged = S_q * ns <= MERGE_PAIRS;   // CTA-uniform
  if (staged)
    for (int t = threadIdx.x; t < S_q * ns; t += SPLIT_THREADS) {
      const int i = t / ns;
      const float* slot = w + ((size_t)i * splits + (t - i * ns)) * (D + 2);
      s_m[t] = __ldcg(slot + D);
      s_l[t] = __ldcg(slot + D + 1);
    }
  float a[K][SR];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int x = threadIdx.x + k * SPLIT_THREADS;
    const int i = x / D;
    const float* col = w + (size_t)i * splits * (D + 2) + (x - i * D);
#pragma unroll
    for (int s = 0; s < SR; ++s)
      a[k][s] = (x < S_q * D && s < ns) ? __ldcg(col + (size_t)s * (D + 2))
                                         : 0.f;
  }
  if (staged) __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int x = threadIdx.x + k * SPLIT_THREADS;
    if (x >= S_q * D) break;
    const int i = x / D;
    const float* wi = w + (size_t)i * splits * (D + 2);
    const float* col = wi + (x - i * D);
    float M = -INFINITY;
    for (int s = 0; s < ns; ++s)
      M = fmaxf(M, staged ? s_m[i * ns + s]
                          : __ldcg(wi + (size_t)s * (D + 2) + D));
    const float safe = (M == -INFINITY) ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < SR; ++s) {
      if (s < ns) {
        const float ms = staged ? s_m[i * ns + s]
                                : __ldcg(wi + (size_t)s * (D + 2) + D);
        const float ls = staged ? s_l[i * ns + s]
                                : __ldcg(wi + (size_t)s * (D + 2) + D + 1);
        const float c = (ms == -INFINITY) ? 0.f : ex2(ms - safe);
        L += c * ls;
        A += c * a[k][s];
      }
    }
    for (int s = SR; s < ns; ++s) {
      const float ms = staged ? s_m[i * ns + s]
                              : __ldcg(wi + (size_t)s * (D + 2) + D);
      const float ls = staged ? s_l[i * ns + s]
                              : __ldcg(wi + (size_t)s * (D + 2) + D + 1);
      const float c = (ms == -INFINITY) ? 0.f : ex2(ms - safe);
      L += c * ls;
      A += c * __ldcg(col + (size_t)s * (D + 2));
    }
    out[i * qstride + (x - i * D)] = A / (L == 0.f ? 1.f : L);
  }
}

// -- split-KV decode at D 256 ----------------------------------------------

// How the D-256 decode kernel lays a key row over a warp: float32 rows of
// 1 KB are read by the whole warp, two 16-byte vectors a lane (one key a
// warp-wide load, 8 in flight); int8 rows of 256 codes by 16 lanes, one
// 16-byte vector a lane (two keys a load, 8 loads in flight).
template <bool QUANT>
struct Split256 {
  static constexpr int VEC = KVec<QUANT>::VEC;
  static constexpr int NV = QUANT ? 1 : 2;
  static constexpr int LPK = 256 / (VEC * NV);
  static constexpr int KPL = 32 / LPK;
  static constexpr int U = 8;
  static constexpr int E = NV * VEC;
};

// One CTA per (split, head, row) of a D-256 decode step: the row's one
// query against its pool blocks [sp C, min((sp + 1) C, live)), warp w the
// blocks j_lo + w, j_lo + w + 4, .. of them, 8 keys (int8: 16) in flight
// a round (float32: two rounds a block of 16, where the D <= 128 kernel's
// shape held 4 at D 256 and took 4).
// are read together; the softmax runs on ex2. Each CTA writes its partial
// (acc[256], m, l) to ws[(b N + h) splits + sp][258], and the last CTA of
// the (row, head) to publish merges them into out (last_to_publish): no
// combine kernel.
template <bool QUANT>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_split256_kernel(const float* __restrict__ q,
                      const void* __restrict__ k_pool,
                      const void* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ table,
                      const int* __restrict__ pos, float* __restrict__ ws,
                      float* __restrict__ out, int* __restrict__ tickets,
                      int N, int P, int bs, int MB, int C, float scale) {
  TFOS_TRACE_START;
  constexpr int D = 256;
  using SS = Split256<QUANT>;
  constexpr int VEC = SS::VEC, NV = SS::NV, LPK = SS::LPK, KPL = SS::KPL;
  constexpr int U = SS::U, E = SS::E;
  __shared__ float s_m[SPLIT_WARPS];
  __shared__ float s_l[SPLIT_WARPS];
  __shared__ float s_acc[SPLIT_WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j_lo = sp * C;
  // the position and the warp's first table entry, read together (a
  // table entry is read only when its block turns out live)
  const int pq = pos[b];
  const int jw = min(j_lo + warp, MB - 1);
  int bid = table[(size_t)b * MB + jw];
  const int live = live_blocks(pq, bs, MB);
  if (j_lo >= live) return;                // CTA-uniform
  const int j_hi = min(j_lo + C, live);
  const float sl = scale * LOG2E;          // scores in log2 units

  const int kg = lane / LPK;
  const int d0 = (lane % LPK) * VEC;
  const float* qr = q + ((size_t)b * N + h) * D;
  float qv[E], acc[E];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[v * VEC + e] = qr[v * LPK * VEC + d0 + e];
      acc[v * VEC + e] = 0.f;
    }
  float m = -INFINITY, l = 0.f;

  for (int j = j_lo + warp; j < j_hi; j += SPLIT_WARPS) {
    if (j != jw) bid = table[(size_t)b * MB + j];
    if (bid < 0 || bid >= P) __trap();     // a table entry outside the pool
    for (int t0 = 0; t0 < bs; t0 += U * KPL) {
      KVec<QUANT> kx[U][NV], vx[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        const bool ok = tok < bs;
        const size_t row = ((size_t)bid * bs + (ok ? tok : 0)) * N + h;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kx[u][v].load(k_pool, k_scale, row, D, v * LPK * VEC + d0, ok);
          vx[u][v].load(v_pool, v_scale, row, D, v * LPK * VEC + d0, ok);
        }
      }
      float s[U];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(qv[v * VEC + e], kx[u][v].at(e), dot);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1) dot += __shfl_xor_sync(FULL, dot, o);
        s[u] = (tok < bs && j * bs + tok <= pq) ? dot * sl : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m, mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m == -INFINITY) ? 0.f : ex2(m - safe);
      l *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = (s[u] == -INFINITY) ? 0.f : ex2(s[u] - safe);
        l += p;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[v * VEC + e] = fmaf(p, vx[u][v].at(e), acc[v * VEC + e]);
      }
      m = m_new;
    }
  }

  // key groups (int8: two a load) merge by shuffles, the warps in order
  // 0..3 through shared memory (m in log2 units throughout)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    float a2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) a2[e] = __shfl_xor_sync(FULL, acc[e], o);
    const float m2 = __shfl_xor_sync(FULL, m, o);
    const float l2 = __shfl_xor_sync(FULL, l, o);
    merge<E, true>(m, l, acc, m2, l2, a2);
  }
  if (kg == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[warp][v * LPK * VEC + d0 + e] = acc[v * VEC + e];
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  float* slot = ws + (((size_t)b * N + h) * gridDim.z + sp) * (D + 2);
  for (int d = threadIdx.x; d < D; d += SPLIT_THREADS) {
    float mm = s_m[0], ll = s_l[0];
    float aa[1] = {s_acc[0][d]};
#pragma unroll
    for (int w = 1; w < SPLIT_WARPS; ++w) {
      const float a2[1] = {s_acc[w][d]};
      merge<1, true>(mm, ll, aa, s_m[w], s_l[w], a2);
    }
    slot[d] = aa[0];
    if (d == 0) {
      slot[D] = mm;
      slot[D + 1] = ll;
    }
  }
  const int bh = b * N + h;
  if (last_to_publish(tickets + bh, (live + C - 1) / C))
    merge_splits<D, 1>(ws + (size_t)bh * gridDim.z * (D + 2), 1, gridDim.z,
                       (live + C - 1) / C, out + (size_t)bh * D, 0);
  TFOS_TRACE_END;
}

template <bool QUANT>
int split256_launch(const float* q, const void* k_pool, const void* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* table, const int* pos, float* ws, float* out,
                    int* tickets, int B, int N, int P, int bs, int MB, int C,
                    float scale, cudaStream_t st) {
  const int splits = (MB + C - 1) / C;
  paged_split256_kernel<QUANT><<<dim3(N, B, splits), SPLIT_THREADS, 0, st>>>(
      q, k_pool, v_pool, k_scale, v_scale, table, pos, ws, out, tickets, N, P,
      bs, MB, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- window route (2 <= S_q <= WINDOW_MAX_QUERIES) -------------------------

// How the window kernel lays a key row over a warp: 4-element vectors
// (16 bytes of float32, 4 bytes of int8 codes, so both dtypes share one
// shape and a lane's share of a key row stays 4 or 8 registers), LPK
// lanes a row, NV vectors a lane (2 at D 256), KPL keys a warp-wide load.
template <int D>
struct WinShape {
  static constexpr int NV = D / 4 > 32 ? D / 128 : 1;
  static constexpr int LPK = D / (4 * NV);
  static constexpr int KPL = 32 / LPK;
  static constexpr int E = 4 * NV;         // dims a lane holds
  static_assert(D % (4 * NV) == 0 && LPK <= 32 && 32 % LPK == 0,
                "a key row must split into a power-of-two of lanes");
};

// keys a lane holds in flight per operand (U, a power of two up to 8):
// what is left of ~160 registers once its QN accumulators of E floats
// and their (m, l) are counted, at 8 NV registers a key (K and V)
template <int D, int QN>
__host__ __device__ constexpr int win_loads() {
  constexpr int u =
      (160 - QN * (WinShape<D>::E + 2)) / (8 * WinShape<D>::NV);
  return u >= 8 ? 8 : u >= 4 ? 4 : u >= 2 ? 2 : 1;
}

// one 4-element vector of a key row: float32 values, or int8 codes as
// floats (the scale is applied to the dot, and to p, outside)
template <bool QUANT>
__device__ __forceinline__ float4 win_load(const void* pool, size_t e,
                                           bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (QUANT) {
    const char4 c =
        __ldg(reinterpret_cast<const char4*>(static_cast<const int8_t*>(pool) +
                                             e));
    return make_float4(c.x, c.y, c.z, c.w);
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(pool) +
                                               e));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// dynamic shared memory of one window CTA: the QN x D query tile, whose
// space the 4 warps' (acc[D], m, l) per query reuse for their merge
template <int D, int QN>
__host__ __device__ constexpr size_t win_smem() {
  return (size_t)SPLIT_WARPS * QN * (D + 2) * sizeof(float);
}

// One CTA per (split, head, row): the row's S_q <= QN queries against its
// pool blocks [sp C, min((sp + 1) C, live)), live from the row's highest
// position. Each key row is loaded once, into registers, and dotted with
// every query (Q from shared memory); each query keeps its own mask (key
// <= pos[b, i]) and online-softmax state (in log2 units, on ex2). The
// positions, the query tile and the warp's first table entry are read
// together. Writes (acc[D], m, l) of query i to ws[((b N + h) S_q + i)
// splits + sp][D + 2] (a query with no visible key in the split: m =
// -inf, l = 0), and the last CTA of the (row, head) to publish merges
// them into out (last_to_publish). The launch bound's 2 CTAs an SM keep
// ptxas from capping some instantiations at 128 registers and spilling.
template <bool QUANT, int D, int QN>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
paged_window_kernel(const float* __restrict__ q,
                    const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, float* __restrict__ ws,
                    float* __restrict__ out, int* __restrict__ tickets,
                    int S_q, int N, int P, int bs, int MB, int C,
                    float scale) {
  TFOS_TRACE_START;
  using WS = WinShape<D>;
  constexpr int NV = WS::NV, LPK = WS::LPK, KPL = WS::KPL, E = WS::E;
  constexpr int U = win_loads<D, QN>();
  extern __shared__ __align__(16) float win_buf[];
  __shared__ int s_pos[QN];
  __shared__ int s_pmax[SPLIT_WARPS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j_lo = sp * C;
  // the positions (one a thread), the query tile (pad queries are zero
  // and see no key) and the warp's first table entry, read together
  const int* prow = pos + (size_t)b * S_q;
  const int pt = threadIdx.x < S_q ? prow[threadIdx.x] : INT_MIN;
  const int jw = min(j_lo + warp, MB - 1);
  int bid = table[(size_t)b * MB + jw];
  for (int e = threadIdx.x; e < QN * D; e += SPLIT_THREADS) {
    const int i = e / D;
    win_buf[e] = i < S_q ? q[(((size_t)b * S_q + i) * N + h) * D + e % D]
                         : 0.f;
  }
  if (threadIdx.x < QN) s_pos[threadIdx.x] = pt;
  int pw = pt;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pw = max(pw, __shfl_xor_sync(FULL, pw, o));
  if (lane == 0) s_pmax[warp] = pw;
  __syncthreads();
  int pmax = s_pmax[0];
#pragma unroll
  for (int w = 1; w < SPLIT_WARPS; ++w) pmax = max(pmax, s_pmax[w]);
  const int live = live_blocks(pmax, bs, MB);
  if (j_lo >= live) return;                // CTA-uniform
  const int j_hi = min(j_lo + C, live);
  const float sl = scale * LOG2E;          // scores in log2 units

  const int kg = lane / LPK;               // the lane's key within a load
  const int d0 = (lane % LPK) * 4;         // its dims in vector 0
  float acc[QN][E], m[QN], l[QN];
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int j = j_lo + warp; j < j_hi; j += SPLIT_WARPS) {
    if (j != jw) bid = table[(size_t)b * MB + j];
    if (bid < 0 || bid >= P) __trap();     // a table entry outside the pool
    for (int t0 = 0; t0 < bs; t0 += U * KPL) {
      float4 kx[U][NV], vx[U][NV];
      float ksc[U], vsc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = t0 + u * KPL + kg;
        const bool ok = tok < bs;
        const size_t row = ((size_t)bid * bs + (ok ? tok : 0)) * N + h;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kx[u][v] = win_load<QUANT>(k_pool, row * D + v * LPK * 4 + d0, ok);
          vx[u][v] = win_load<QUANT>(v_pool, row * D + v * LPK * 4 + d0, ok);
        }
        ksc[u] = QUANT && ok ? __ldg(k_scale + row) * sl : sl;
        vsc[u] = QUANT && ok ? __ldg(v_scale + row) : 1.f;
      }
#pragma unroll
      for (int i = 0; i < QN; ++i) {
        float qi[E];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 x = *reinterpret_cast<const float4*>(
              win_buf + i * D + v * LPK * 4 + d0);
          qi[v * 4] = x.x;
          qi[v * 4 + 1] = x.y;
          qi[v * 4 + 2] = x.z;
          qi[v * 4 + 3] = x.w;
        }
        const int pi = s_pos[i];
        float s[U];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tok = t0 + u * KPL + kg;
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dot = fmaf(qi[v * 4 + e], comp(kx[u][v], e), dot);
#pragma unroll
          for (int o = 1; o < LPK; o <<= 1)
            dot += __shfl_xor_sync(FULL, dot, o);
          s[u] = (tok < bs && j * bs + tok <= pi) ? dot * ksc[u] : -INFINITY;
          mx = fmaxf(mx, s[u]);
        }
        const float m_new = fmaxf(m[i], mx);
        const float safe = (m_new == -INFINITY) ? 0.f : m_new;
        const float corr = (m[i] == -INFINITY) ? 0.f : ex2(m[i] - safe);
        l[i] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = (s[u] == -INFINITY) ? 0.f : ex2(s[u] - safe);
          l[i] += p;
          const float pv = p * vsc[u];
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][v * 4 + e] =
                  fmaf(pv, comp(vx[u][v], e), acc[i][v * 4 + e]);
        }
        m[i] = m_new;
      }
    }
  }

  // the warp's key groups hold the same dims: merge them by shuffles
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      float a2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) a2[e] = __shfl_xor_sync(FULL, acc[i][e], o);
      const float m2 = __shfl_xor_sync(FULL, m[i], o);
      const float l2 = __shfl_xor_sync(FULL, l[i], o);
      merge<E, true>(m[i], l[i], acc[i], m2, l2, a2);
    }
  }
  __syncthreads();                         // every warp is done with Q
  // warp w's state of query i at win_buf[(w QN + i) (D + 2)]: acc, m, l
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      float* st = win_buf + (warp * QN + i) * (D + 2);
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[v * LPK * 4 + d0 + e] = acc[i][v * 4 + e];
      if (lane == 0) {
        st[D] = m[i];
        st[D + 1] = l[i];
      }
    }
  }
  __syncthreads();
  // the warps merged in order 0..3, per query
  const int bh = b * N + h;
  for (int x = threadIdx.x; x < S_q * D; x += SPLIT_THREADS) {
    const int i = x / D;
    const int d = x - i * D;
    const float* st = win_buf + i * (D + 2);
    float mm = st[D], ll = st[D + 1];
    float aa[1] = {st[d]};
#pragma unroll
    for (int w = 1; w < SPLIT_WARPS; ++w) {
      const float* s2 = win_buf + (w * QN + i) * (D + 2);
      const float a2[1] = {s2[d]};
      merge<1, true>(mm, ll, aa, s2[D], s2[D + 1], a2);
    }
    float* slot = ws + (((size_t)bh * S_q + i) * gridDim.z + sp) * (D + 2);
    slot[d] = aa[0];
    if (d == 0) {
      slot[D] = mm;
      slot[D + 1] = ll;
    }
  }
  if (last_to_publish(tickets + bh, (live + C - 1) / C))
    merge_splits<D, QN>(ws + (size_t)bh * S_q * gridDim.z * (D + 2), S_q,
                        gridDim.z, (live + C - 1) / C,
                        out + ((size_t)b * S_q * N + h) * D, (size_t)N * D);
  TFOS_TRACE_END;
}

template <bool QUANT, int D, int QN>
int window_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      paged_window_kernel<QUANT, D, QN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)win_smem<D, QN>()));
}

template <bool QUANT, int D, int QN>
int window_launch(const float* q, const void* k_pool, const void* v_pool,
                  const float* k_scale, const float* v_scale,
                  const int* table, const int* pos, float* ws, float* out,
                  int* tickets, int B, int S_q, int N, int P, int bs, int MB,
                  int C, float scale, cudaStream_t st) {
  if (int e = window_prepare<QUANT, D, QN>()) return e;
  const int splits = (MB + C - 1) / C;
  paged_window_kernel<QUANT, D, QN>
      <<<dim3(N, B, splits), SPLIT_THREADS, win_smem<D, QN>(), st>>>(
          q, k_pool, v_pool, k_scale, v_scale, table, pos, ws, out, tickets,
          S_q, N, P, bs, MB, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- query-tiled route on the tensor cores (D <= 256) ----------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16;  // query rows of a CTA: one mma row block

// keys of a staged tile (BN): 64, or 32 at DP 128 and 256, where two
// stages of 64 float32 K and V rows would take 128 KB (256 KB at DP 256)
template <int DP>
__host__ __device__ constexpr int tc_keys() { return DP > 64 ? 32 : 64; }

// bytes of one staged K or V row: float32 rows are DP elements, their
// 16-byte chunks swizzled by sw<DP>; int8 rows are DP codes and 16
// pad bytes, which put the 8 rows of a fragment read on distinct banks
template <bool QUANT, int DP>
__host__ __device__ constexpr int tc_row_bytes() {
  return QUANT ? DP + 16 : DP * 4;
}

// dynamic shared memory: the Q tile, then the ring (K and V, two stages,
// and with int8 pools their scales), whose space the 4 warps' (m, l,
// acc) reuse for the final merge
template <bool QUANT, int DP>
__host__ __device__ constexpr size_t tc_smem() {
  constexpr size_t ring =
      4 * (size_t)tc_keys<DP>() * tc_row_bytes<QUANT, DP>() +
      (QUANT ? 4 * tc_keys<DP>() * sizeof(float) : 0);
  constexpr size_t merge =
      (size_t)TC_WARPS * TC_ROWS * (DP + 2) * sizeof(float);
  return TC_ROWS * DP * sizeof(float) + (ring > merge ? ring : merge);
}

// c[n0 + n] += A B[n] for n < NB, pass by pass as mma3_rows takes them
// (BLO: B has a lo part; an int8 code has none)
template <bool BLO, int NB, int NC>
__device__ __forceinline__ void mma3_at(float (&c)[NC][4], int n0,
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const uint32_t (&bh)[NB][2],
                                        const uint32_t (&bl)[NB][2]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) mma_tf32(c[n0 + n], al, bh[n]);
  if (BLO) {
#pragma unroll
    for (int n = 0; n < NB; ++n) mma_tf32(c[n0 + n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) mma_tf32(c[n0 + n], ah, bh[n]);
}

// fragment loads of a staged K or V tile (load_b_rows / load_b_cols of
// tc_common.cuh); an int8 code is exact in TF32, so its lo part is 0
template <int DP>
__device__ __forceinline__ void kv_rows(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                        const float* s, int n0, int k0, int g,
                                        int t) {
  load_b_rows<DP>(hi, lo, s, n0, k0, g, t);
}
template <int DP>
__device__ __forceinline__ void kv_rows(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                        const int8_t* s, int n0, int k0, int g,
                                        int t) {
  constexpr int RB = tc_row_bytes<true, DP>();
  const char2 x =
      *reinterpret_cast<const char2*>(s + (n0 + g) * RB + k0 + 2 * t);
  hi[0] = __float_as_uint(static_cast<float>(x.x));
  hi[1] = __float_as_uint(static_cast<float>(x.y));
  lo[0] = lo[1] = 0u;
}
template <int DP>
__device__ __forceinline__ void kv_cols(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                        const float* s, int k0, int n0, int g,
                                        int t) {
  load_b_cols<DP>(hi, lo, s, k0, n0, g, t);
}
template <int DP>
__device__ __forceinline__ void kv_cols(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                        const int8_t* s, int k0, int n0, int g,
                                        int t) {
  constexpr int RB = tc_row_bytes<true, DP>();
  hi[0] = __float_as_uint(static_cast<float>(s[(k0 + 2 * t) * RB + n0 + g]));
  hi[1] =
      __float_as_uint(static_cast<float>(s[(k0 + 2 * t + 1) * RB + n0 + g]));
  lo[0] = lo[1] = 0u;
}

// Start copying one warp's KW keys [key0, key0 + KW) of (row b, head h)
// into rows [r0, r0 + KW) of a ring stage: key j is pool row
// trow[j / bs], token j % bs, D elements of ES bytes. Lanes lie side by
// side along the rows, so a warp-wide copy covers whole rows (two float32
// rows of 256 bytes, eight int8 rows of 64); lane r < KW reads row r's
// table entry (one outside [0, P) traps) and the others take its address
// by shuffle. ``vec`` bytes a copy (16 or 4; 1: int8 rows copied byte by
// byte, synchronously); columns D..DP and keys at or past n_keys are
// zero-filled without a read (src-size 0).
template <bool QUANT, int DP>
__device__ __forceinline__ void stage_slice(
    unsigned char* Kd, unsigned char* Vd, float* KSd, float* VSd,
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* __restrict__ trow, int r0, int key0,
    int n_keys, int N, int h, int D, int P, int bs, int vec, int lane) {
  constexpr int KW = tc_keys<DP>() / TC_WARPS;
  constexpr int ES = QUANT ? 1 : 4;  // bytes per element
  constexpr int RB = tc_row_bytes<QUANT, DP>();
  unsigned long long mine = 0;  // lane r < KW: ((pool row) bs + token) N + h
  const bool live = lane < KW && key0 + lane < n_keys;
  if (live) {
    const int key = key0 + lane;
    const int bid = trow[key / bs];
    if (bid < 0 || bid >= P) __trap();  // a table entry outside the pool
    mine = ((unsigned long long)bid * bs + key % bs) * N + h;
  }
  if (QUANT && lane < KW) {
    cp_async4(KSd + r0 + lane, k_scale + mine, live);
    cp_async4(VSd + r0 + lane, v_scale + mine, live);
  }
  const unsigned char* kb = static_cast<const unsigned char*>(k_pool);
  const unsigned char* vb = static_cast<const unsigned char*>(v_pool);
  const int nch = DP * ES / vec;  // pieces of a staged row (a power of 2)
  const int shift = __ffs(nch) - 1;
  for (int base = 0; base < KW * nch; base += 32) {
    const int i = base + lane;
    const int r = i < KW * nch ? i >> shift : 0;
    const size_t row = __shfl_sync(FULL, mine, r);  // every lane shuffles
    if (i >= KW * nch) continue;
    const int c = (i & (nch - 1)) * vec;            // byte in the row
    const bool ok = key0 + r < n_keys && c < D * ES;
    const size_t src = row * D * ES + (ok ? c : 0);
    if (QUANT && vec == 1) {
      Kd[(r0 + r) * RB + c] = ok ? kb[src] : 0;
      Vd[(r0 + r) * RB + c] = ok ? vb[src] : 0;
      continue;
    }
    const int dst =
        QUANT ? (r0 + r) * RB + c : sw<DP>(r0 + r, c / 4) * 4;
    if (vec == 16) {
      cp_async16(Kd + dst, kb + src, ok);
      cp_async16(Vd + dst, vb + src, ok);
    } else {
      cp_async4(Kd + dst, kb + src, ok);
      cp_async4(Vd + dst, vb + src, ok);
    }
  }
}

template <bool QUANT, int DP>
__global__ void __launch_bounds__(TC_THREADS)
paged_tiled_kernel(const float* __restrict__ q, const void* __restrict__ k_pool,
                   const void* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   float* __restrict__ out, int S_q, int N, int D, int P,
                   int bs, int MB, float scale, int kv_vec, int q_vec) {
  using KT = typename std::conditional<QUANT, int8_t, float>::type;
  constexpr int BN = tc_keys<DP>();
  constexpr int KW = BN / TC_WARPS;  // keys of a tile one warp takes
  constexpr int NTW = KW / 8;        // its 8-key score tiles
  constexpr int DT = DP / 8;         // 8-wide steps over DP
  constexpr int RB = tc_row_bytes<QUANT, DP>();
  // DP 256 (the 128-register accumulator): S's k steps into NS partial
  // sums, unrolled 8 steps (KU outer iterations) at a time, and P V's B
  // fragments CH column blocks at a time; at DP <= 128 one sum, every
  // step and block at once
  constexpr int NS = DP > 128 ? 4 : 1;
  constexpr int KU = DP > 128 ? 8 / NS : DT;
  constexpr int CH = DP > 128 ? 2 : DT;
  extern __shared__ __align__(16) unsigned char tc_buf[];
  float* Qs = reinterpret_cast<float*>(tc_buf);     // [16][DP], swizzled
  unsigned char* ring = tc_buf + TC_ROWS * DP * sizeof(float);
  unsigned char* Ks = ring;                         // [2][BN] rows of RB bytes
  unsigned char* Vs = ring + 2 * BN * RB;           // [2][BN] rows
  float* KSs = reinterpret_cast<float*>(ring + 4 * BN * RB);  // [2][BN]
  float* VSs = KSs + 2 * BN;                                  // [2][BN]
  __shared__ int s_rowmax;
  __shared__ int s_tilemax;

  const int qt = gridDim.z - 1 - blockIdx.z;  // deepest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int i0 = qt * TC_ROWS;
  const int* prow = pos + (size_t)b * S_q;
  const int* trow = table + (size_t)b * MB;

  // the Q tile, unscaled; rows past S_q and columns past D are zero
  {
    const int nch = DP * 4 / q_vec;
    for (int i = threadIdx.x; i < TC_ROWS * nch; i += TC_THREADS) {
      const int r = i / nch;
      const int c = (i % nch) * q_vec;  // byte in the row
      const bool ok = i0 + r < S_q && c < D * 4;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(
              q + (((size_t)b * S_q + (ok ? i0 + r : 0)) * N + h) * D) +
          (ok ? c : 0);
      float* dst = Qs + sw<DP>(r, c / 4);
      if (q_vec == 16)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
    cp_commit();
  }

  // the row's depth comes from ALL of its queries, as in the reference;
  // the tile's own highest position bounds the keys it can see
  if (threadIdx.x == 0) {
    s_rowmax = INT_MIN;
    s_tilemax = INT_MIN;
  }
  __syncthreads();
  int pmax = INT_MIN, tmax = INT_MIN;
  for (int i = threadIdx.x; i < S_q; i += TC_THREADS) {
    const int p = prow[i];
    pmax = max(pmax, p);
    if (i >= i0 && i < i0 + TC_ROWS) tmax = max(tmax, p);
  }
  atomicMax(&s_rowmax, pmax);  // a max: the same in any order
  atomicMax(&s_tilemax, tmax);
  __syncthreads();
  const int nblk = min(floordiv(s_rowmax + bs, bs), MB);
  const long long lim =
      min((long long)nblk * bs, (long long)s_tilemax + 1);
  const int n_keys = (int)max(0LL, lim);  // keys [0, n_keys) are read
  const int n_kv = (n_keys + BN - 1) / BN;

  // positions of rows g and g + 8; a pad row sees nothing
  int pr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + g + 8 * i;
    pr[i] = row < S_q ? prow[row] : INT_MIN;
  }

  // each warp stages, waits for and reads only its own slice of every
  // tile: rows [kw0, kw0 + KW) of both ring stages, keys kt BN + kw0 ..
  // The CTA takes its key tiles in the order rot, rot + 1, .., wrapping
  // around: the query tiles of one head then ask different L2 lines at
  // the same moment instead of all the same ones. Every thread commits
  // one copy group per tile, empty or not, so cp_wait<1> always means
  // "the tile before the newest has landed".
  const int kw0 = KW * warp;
  const int lane = threadIdx.x % 32;
  const int rot = n_kv > 0 ? blockIdx.z % n_kv : 0;
  auto stage = [&](int it) {  // the it-th tile into stage it & 1
    if (it < n_kv) {
      const int k0 = ((it + rot) % n_kv) * BN + kw0;
      if (k0 < n_keys)
        stage_slice<QUANT, DP>(Ks + (it & 1) * BN * RB,
                               Vs + (it & 1) * BN * RB, KSs + (it & 1) * BN,
                               VSs + (it & 1) * BN, k_pool, v_pool, k_scale,
                               v_scale, trow, kw0, k0, n_keys, N, h, D, P, bs,
                               kv_vec, lane);
    }
    cp_commit();
  };
  stage(0);
  cp_wait<1>();      // this thread's part of the Q tile has landed
  __syncthreads();   // and every thread's

  // this warp's online softmax over its keys of every tile: running max
  // m shared by a row's quad, l this lane's share of the row sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
  zero4(acc);

  for (int it = 0; it < n_kv; ++it) {
    stage(it + 1);
    cp_wait<1>();   // the it-th tile has landed
    __syncwarp();   // for every lane of the warp
    const int kt = (it + rot) % n_kv;
    const int key0 = kt * BN + kw0;
    const int cur = it & 1;
    if (key0 < n_keys) {  // warp-uniform
      const KT* Kt = reinterpret_cast<const KT*>(Ks + cur * BN * RB);
      const KT* Vt = reinterpret_cast<const KT*>(Vs + cur * BN * RB);
      const float* KSt = KSs + cur * BN;
      const float* VSt = VSs + cur * BN;
      // 8-key score tiles wholly past the key limit are skipped
      const int ntw = min(NTW, (n_keys - key0 + 7) / 8);
      // S = Q K^T (float32: 3 passes; int8 codes: Q_lo c + Q_hi c), k
      // step ks into partial sum ks % NS
      float sp[NS][NTW][4];
#pragma unroll
      for (int u = 0; u < NS; ++u) zero4(sp[u]);
#pragma unroll KU
      for (int k0 = 0; k0 < DT; k0 += NS) {
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          const int ks = k0 + u;
          uint32_t ah[4], al[4], bh[NTW][2], bl[NTW][2];
          load_a<DP>(ah, al, Qs, 0, 8 * ks, g, t);
#pragma unroll
          for (int j = 0; j < NTW; ++j)
            if (j < ntw)
              kv_rows<DP>(bh[j], bl[j], Kt, kw0 + 8 * j, 8 * ks, g, t);
          mma3_rows<true, !QUANT>(sp[u], ah, al, bh, bl, 0, ntw);
        }
      }
      float s[NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = sp[0][j][e];
#pragma unroll
          for (int u = 1; u < NS; ++u) s[j][e] += sp[u][j][e];
        }
      // s = S (k_scale) scale, -inf where masked; the rows' maxima
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = kw0 + 8 * j + 2 * t + (e & 1);  // key in the tile
          const int key = kt * BN + kc;
          const bool ok = key < n_keys && key <= pr[e >> 1];
          float sv = s[j][e];
          if (QUANT) sv *= KSt[kc];
          sv = ok ? sv * scale : -INFINITY;
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
      // P in place in s; l sums P, P V takes P' = P v_scale (int8)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = s[j][e];
          const float p =
              (sv == -INFINITY) ? 0.f : ex2((sv - safe[e >> 1]) * LOG2E);
          l[e >> 1] += p;
          s[j][e] = QUANT ? p * VSt[kw0 + 8 * j + 2 * t + (e & 1)] : p;
        }
      }
      // acc += P V: the 8 keys of score tile j are one k step; V's B
      // fragments CH column blocks at a time
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (j < ntw) {
          uint32_t ah[4], al[4];
          c_to_a(s[j], ah, al);
#pragma unroll
          for (int n0 = 0; n0 < DT; n0 += CH) {
            uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
            for (int n = 0; n < CH; ++n)
              kv_cols<DP>(bh[n], bl[n], Vt, kw0 + 8 * j, 8 * (n0 + n), g, t);
            mma3_at<!QUANT>(acc, n0, ah, al, bh, bl);
          }
        }
      }
    }
    __syncwarp();   // the warp's slice of stage it & 1 is refilled next
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the warps' states merge there

  float* Ms = reinterpret_cast<float*>(ring);  // [W][16] running max
  float* Ls = Ms + TC_WARPS * TC_ROWS;         // [W][16] row sum
  float* As = Ls + TC_WARPS * TC_ROWS;         // [W][16][DP] accumulator
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const int r = warp * TC_ROWS + g + 8 * i;
    if (t == 0) {
      Ms[r] = m[i];
      Ls[r] = l[i];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(As + r * DP + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
  __syncthreads();
  // out = sum_w e^(m_w - M) acc_w / sum_w e^(m_w - M) l_w, warps in order
  for (int e = threadIdx.x; e < TC_ROWS * D; e += TC_THREADS) {
    const int r = e / D;
    const int c = e - r * D;
    if (i0 + r >= S_q) break;  // rows only grow with e
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) M = fmaxf(M, Ms[w * TC_ROWS + r]);
    const float safe = (M == -INFINITY) ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float mw = Ms[w * TC_ROWS + r];
      const float cw = (mw == -INFINITY) ? 0.f : ex2((mw - safe) * LOG2E);
      L += cw * Ls[w * TC_ROWS + r];
      A += cw * As[(w * TC_ROWS + r) * DP + c];
    }
    out[(((size_t)b * S_q + i0 + r) * N + h) * D + c] =
        A / (L == 0.f ? 1.f : L);
  }
}

template <bool QUANT, int DP>
int tiled_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      paged_tiled_kernel<QUANT, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc_smem<QUANT, DP>()));
}

template <bool QUANT, int DP>
int tiled_launch(const float* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale, const int* table,
                 const int* pos, float* out, int B, int S_q, int N, int D,
                 int P, int bs, int MB, float scale, int kv_vec, int q_vec,
                 cudaStream_t st) {
  if (int e = tiled_prepare<QUANT, DP>()) return e;
  const dim3 grid(N, B, (S_q + TC_ROWS - 1) / TC_ROWS);
  paged_tiled_kernel<QUANT, DP><<<grid, TC_THREADS, tc_smem<QUANT, DP>(), st>>>(
      q, k_pool, v_pool, k_scale, v_scale, table, pos, out, S_q, N, D, P, bs,
      MB, scale, kv_vec, q_vec);
  return static_cast<int>(cudaGetLastError());
}

// out = {CTAs per SM, registers per thread, local (spill) bytes per
// thread, dynamic shared bytes} of one instantiation
template <bool QUANT, int DP>
int tiled_budget(int* out) {
  if (int e = tiled_prepare<QUANT, DP>()) return e;
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, paged_tiled_kernel<QUANT, DP>))
    return static_cast<int>(e);
  int ctas = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, paged_tiled_kernel<QUANT, DP>, TC_THREADS,
          tc_smem<QUANT, DP>()))
    return static_cast<int>(e);
  out[0] = ctas;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(tc_smem<QUANT, DP>());
  return 0;
}

// {CTAs per SM, registers per thread, local (spill) bytes per thread,
// shared bytes (static + dynamic)} of ``kern`` launched with ``threads``
// threads and ``dyn`` dynamic shared bytes
template <typename K>
int kernel_budget(K kern, int threads, size_t dyn, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kern))
    return static_cast<int>(e);
  int ctas = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kern, threads, dyn))
    return static_cast<int>(e);
  out[0] = ctas;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(a.sharedSizeBytes + dyn);
  return 0;
}

template <bool QUANT, int D>
int split_budget(int* out) {
  if constexpr (D == 256)
    return kernel_budget(paged_split256_kernel<QUANT>, SPLIT_THREADS, 0, out);
  else
    return kernel_budget(paged_split_kernel<QUANT, D>, SPLIT_THREADS, 0, out);
}

template <bool QUANT, int D, int QN>
int window_budget(int* out) {
  if (int e = window_prepare<QUANT, D, QN>()) return e;
  return kernel_budget(paged_window_kernel<QUANT, D, QN>, SPLIT_THREADS,
                       win_smem<D, QN>(), out);
}

// the window instantiation S_q queries take: QN = S_q rounded up to 2 or
// 4, the route's widest (ops/paged_attention.py WINDOW_MAX_QUERIES: the
// window kernel loses to the tiled one above; 0 above 4). A build with
// -DTFOS_WINDOW_WIDE (profile_paged.py --crossover) also has 8 and 16,
// to time that crossover.
inline int window_queries(int S_q) {
#ifdef TFOS_WINDOW_WIDE
  if (S_q > 4) return S_q <= 8 ? 8 : S_q <= 16 ? 16 : 0;
#endif
  return S_q <= 2 ? 2 : S_q <= 4 ? 4 : 0;
}

#ifdef TFOS_WINDOW_WIDE
#define TFOS_WINDOW_WIDE_CASES(FN, QUANT, D, ...)                             \
  case 8: TFOS_WINDOW_D(FN, QUANT, D, 8, __VA_ARGS__); break;                 \
  case 16: TFOS_WINDOW_D(FN, QUANT, D, 16, __VA_ARGS__); break;
#else
#define TFOS_WINDOW_WIDE_CASES(FN, QUANT, D, ...)
#endif

#define TFOS_WINDOW_DISPATCH(FN, QUANT, D, QN, ...)                           \
  do {                                                                        \
    switch (QN) {                                                             \
      case 2: TFOS_WINDOW_D(FN, QUANT, D, 2, __VA_ARGS__); break;             \
      case 4: TFOS_WINDOW_D(FN, QUANT, D, 4, __VA_ARGS__); break;             \
      TFOS_WINDOW_WIDE_CASES(FN, QUANT, D, __VA_ARGS__)                       \
    }                                                                         \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  } while (0)
#define TFOS_WINDOW_D(FN, QUANT, D, QN, ...)                                  \
  switch (D) {                                                                \
    case 16: return QUANT ? FN<true, 16, QN>(__VA_ARGS__)                     \
                          : FN<false, 16, QN>(__VA_ARGS__);                   \
    case 32: return QUANT ? FN<true, 32, QN>(__VA_ARGS__)                     \
                          : FN<false, 32, QN>(__VA_ARGS__);                   \
    case 64: return QUANT ? FN<true, 64, QN>(__VA_ARGS__)                     \
                          : FN<false, 64, QN>(__VA_ARGS__);                   \
    case 128: return QUANT ? FN<true, 128, QN>(__VA_ARGS__)                   \
                           : FN<false, 128, QN>(__VA_ARGS__);                 \
    case 256: return QUANT ? FN<true, 256, QN>(__VA_ARGS__)                   \
                           : FN<false, 256, QN>(__VA_ARGS__);                 \
  }

// the instantiation a head dim takes: D rounded up to 16, 32, 64, 128 or
// 256 (0 above 256)
inline int padded_dim(int D) {
  return D <= 16    ? 16
         : D <= 32  ? 32
         : D <= 64  ? 64
         : D <= 128 ? 128
         : D <= 256 ? 256
                    : 0;
}

#define TFOS_TILED_DISPATCH(FN, QUANT, DP, ...)                               \
  do {                                                                        \
    if (QUANT) {                                                              \
      switch (DP) {                                                           \
        case 16: return FN<true, 16>(__VA_ARGS__);                            \
        case 32: return FN<true, 32>(__VA_ARGS__);                            \
        case 64: return FN<true, 64>(__VA_ARGS__);                            \
        case 128: return FN<true, 128>(__VA_ARGS__);                          \
        case 256: return FN<true, 256>(__VA_ARGS__);                          \
      }                                                                       \
    } else {                                                                  \
      switch (DP) {                                                           \
        case 16: return FN<false, 16>(__VA_ARGS__);                           \
        case 32: return FN<false, 32>(__VA_ARGS__);                           \
        case 64: return FN<false, 64>(__VA_ARGS__);                           \
        case 128: return FN<false, 128>(__VA_ARGS__);                         \
        case 256: return FN<false, 256>(__VA_ARGS__);                         \
      }                                                                       \
    }                                                                         \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  } while (0)

}  // namespace

// Launch the split-KV route on ``stream`` for one query per row
// (decode: q [B, 1, N, D], pos [B, 1]), C pool blocks per split, through
// the float32 workspace ``ws`` [B, N, ceil(MB / C), D + 2] into ``out``:
// at D in {16, 32, 64, 128} the split kernel, then the combine kernel; at
// D 256 the D-256 kernel alone, its last CTA of each (row, head) merging
// (``tickets``: B N ints, all 0, left 0). Pools 16-byte aligned (the
// caller checks). Returns the first launch's CUDA error (0 when every
// launch was accepted).
extern "C" int tfos_paged_attention_split(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* ws, float* out, int* tickets, int B, int N, int D,
    int P, int bs, int MB, int C, float scale, int quantized, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (C <= 0 || MB <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return quantized
               ? split256_launch<true>(q, k_pool, v_pool, k_scale, v_scale,
                                       table, pos, ws, out, tickets, B, N, P,
                                       bs, MB, C, scale, st)
               : split256_launch<false>(q, k_pool, v_pool, k_scale, v_scale,
                                        table, pos, ws, out, tickets, B, N, P,
                                        bs, MB, C, scale, st);
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

// Launch the window route on ``stream`` for 2 <= S_q <= 4 queries per row
// (q [B, S_q, N, D], pos [B, S_q]): the window kernel, C pool blocks per
// split, through the float32 workspace ``ws`` [B, N, S_q, ceil(MB / C),
// D + 2] into ``out``, the last CTA of each (row, head) merging
// (``tickets``: B N ints, all 0, left 0). D in {16, 32, 64, 128, 256},
// pools 16-byte aligned (the caller checks). Returns the CUDA error of
// the shared-memory attribute call or of the launch (0 when accepted).
extern "C" int tfos_paged_attention_window(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* ws, float* out, int* tickets, int B, int S_q,
    int N, int D, int P, int bs, int MB, int C, float scale, int quantized,
    void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (C <= 0 || MB <= 0 || S_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_WINDOW_DISPATCH(window_launch, quantized, D, window_queries(S_q), q,
                       k_pool, v_pool, k_scale, v_scale, table, pos, ws, out,
                       tickets, B, S_q, N, P, bs, MB, C, scale, st);
}

// Launch the query-tiled tensor-core kernel on ``stream`` (D <= 256, any
// block size); returns the CUDA error of the shared-memory attribute
// call or of the launch (0 when accepted). Copies are 16-byte where D's
// row bytes and the pointers allow, else narrower. The caller checks
// shapes, dtypes and contiguity.
extern "C" int tfos_paged_attention_tiled(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* pos, float* out, int B, int S_q, int N, int D, int P,
    int bs, int MB, float scale, int quantized, void* stream) {
  if (B <= 0 || S_q <= 0 || N <= 0) return 0;
  if (D <= 0 || bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = D * (quantized ? 1 : 4);
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k_pool) |
                       reinterpret_cast<uintptr_t>(v_pool);
  const int kv_vec = (row_bytes % 16 == 0 && kv % 16 == 0)  ? 16
                     : (row_bytes % 4 == 0 && kv % 4 == 0) ? 4
                                                           : 1;
  const int q_vec =
      (D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) ? 16 : 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_TILED_DISPATCH(tiled_launch, quantized, padded_dim(D), q, k_pool,
                      v_pool, k_scale, v_scale, table, pos, out, B, S_q, N,
                      D, P, bs, MB, scale, kv_vec, q_vec, st);
}

// The resource budget of one route's kernel for head dim D and pool
// dtype: route 0 the query-tiled tensor-core kernel (its instantiation:
// D rounded up to 16, 32, 64, 128 or 256), 1 the split-KV kernel (D in
// {16, 32, 64, 128, 256}), 2 the window kernel at ``queries`` queries a
// row (its instantiation: rounded up to 2 or 4). out[4] = {CTAs
// per SM, registers per thread, local (spill) bytes per thread,
// shared-memory bytes}.
extern "C" int tfos_paged_budget(int route, int D, int quantized,
                                 int queries, int* out) {
  if (route == 2)
    TFOS_WINDOW_DISPATCH(window_budget, quantized, D, window_queries(queries),
                         out);
  if (route == 1) {
#define TFOS_SPLIT_BUDGET(DD)                                               \
  case DD:                                                                  \
    return quantized ? split_budget<true, DD>(out) : split_budget<false, DD>(out)
    switch (D) {
      TFOS_SPLIT_BUDGET(16);
      TFOS_SPLIT_BUDGET(32);
      TFOS_SPLIT_BUDGET(64);
      TFOS_SPLIT_BUDGET(128);
      TFOS_SPLIT_BUDGET(256);
    }
#undef TFOS_SPLIT_BUDGET
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TFOS_TILED_DISPATCH(tiled_budget, quantized, padded_dim(D), out);
}

#ifdef TFOS_PAGED_TRACE
// Copy the first ``n`` CTA stamps {start ns, end ns, SM} out (``out`` on
// the host, 3 n values) and clear them for the next traced call.
extern "C" int tfos_paged_trace(unsigned long long* out, int n) {
  if (n < 0 || n > TRACE_CTAS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(unsigned long long) * 3 * n;
  if (cudaError_t e = cudaMemcpyFromSymbol(out, tfos_trace, bytes))
    return static_cast<int>(e);
  static unsigned long long zeros[TRACE_CTAS][3];
  return static_cast<int>(cudaMemcpyToSymbol(tfos_trace, zeros, bytes));
}
#endif
