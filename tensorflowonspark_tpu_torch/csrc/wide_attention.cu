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
// Two ideas. The backward and decode kernels make OUTPUT COLUMNS A GRID
// AXIS: a CTA owns one chunk of DC = 128 output columns (dQ, dK/dV) or
// 1024 (the split-KV kernel), so its accumulators stay the size they are
// at D 128 or below, and every CTA sums its scores (and dP = dO V^T) over
// all of D in chunks of DK = 32 columns staged through shared memory. The
// cost is that each column chunk recomputes the scores. The forward
// kernels (the flash forward and the paged tiled kernel) instead COMPUTE
// EACH SCORE ONCE PER CTA: the four warps of a row block split the
// contraction of S = Q K^T into quarters and sum their partial scores
// through shared memory, so one CTA owns GW = 512 output columns (128 a
// warp). Above 512 the grid keeps an axis over groups of 512, and the
// scores repeat once per group. The schedules are modelled on the CPU by
// tests/test_torch_wide_heads.py.
//
// - flash_wide_fwd_kernel<T> (T float or bfloat16): one CTA of 8 warps
//   over 32 query rows, two row blocks of 16 times four column warps;
//   32-key tiles. Warp (r, c) takes contraction columns [c sl, (c + 1)
//   sl) of each 512-column chunk (sl = a quarter of the chunk's width,
//   rounded up to 16) for S, and output columns [c 128, (c + 1) 128) of
//   its group for P V. Its 16 x 32 partial scores go to shared memory;
//   each warp of the row block sums the four in warp order, so the four
//   hold the same scores bit for bit and run the same online softmax.
//   float32: mma.sync m16n8k8 TF32 with the 3xTF32 split (tc_common.cuh),
//   float32-accurate. bfloat16: staged as bfloat16, fragments by
//   ldmatrix, mma.sync m16n8k16 bf16 with float32 accumulators; P is
//   rounded to bfloat16 for P V, as the reference casts P to V's dtype.
//   D is a multiple of 128: the wrapper zero-pads q, k, v to it
//   (flash_attention.py ``padded_head_dim``), which leaves the scores and
//   lse unchanged. Grid (B N, query tiles, groups), the deepest query
//   tiles first: B 2 x S 1024 x 8 heads of 512 is 512 CTAs, one an SM
//   (bfloat16's 112 KB of shared memory would fit two, but at the 128
//   registers a thread that leaves, it spills).
// - paged_wide_tiled_kernel<QUANT>: the same scheme over 16 query rows of
//   one (row, head): one row block, and the 8 warps as two key groups of
//   four column warps, each group taking 16 keys of every 32-key tile
//   with its own online softmax; at the end group 1 hands its (m, l,
//   acc) to group 0 through shared memory, which merges them in that
//   order. K/V rows come through the block table, looked up once per key
//   a tile; int8 pools are staged as codes and converted in the fragment
//   loads (exact in TF32), k_scale folded into S after the partial sums
//   and v_scale into P. Any D: columns past D are zero-filled by the
//   copy (src-size 0) and not stored; copies are 16 bytes where the
//   row's bytes and the pointers allow, else 4 bytes, else (int8 rows of
//   D % 4 != 0) byte by byte. Grid (N groups, B, query tiles), the
//   deepest tiles first: a 256-token tail at 8 heads of 512 is 128 CTAs,
//   a cold 512-token prompt 256, one an SM at float32.
//
//   Both stream their tiles through a two-stage cp.async ring whose
//   items are, per key tile, each 512-column chunk of K (the scores'
//   contraction) and then the group's V: the next item is in flight while
//   the tensor cores work on the current one, with one barrier an item.
//   Q stays in shared memory for the whole CTA where it fits with the
//   ring (float32 flash up to D 640, bfloat16 to 2304, paged float32 to
//   1440 and int8 to 2944); above that each item carries its 256-column
//   chunk of Q beside the K chunk's.
//   Shared memory is dynamic (fwd_layout: Q, the ring, the partial-score
//   exchange, the int8 scales of the last two tiles) and depends on D.
// - flash_wide_dq_kernel<T>, flash_wide_dkv_kernel<T>: one CTA of 4 warps
//   over 64 query rows (dQ) or 64 keys (dK/dV), 16 a warp, and a
//   128-column chunk of dQ, dK or dV (dK and dV in CTAs of their own);
//   32-query (32-key) tiles streamed. Products on mma.sync m16n8k8 TF32;
//   every operand lands in shared memory as float32; a float32 operand is
//   split 3xTF32 (hi + lo), a bfloat16 one is exact in TF32 (its lo part
//   is 0 and its passes are dropped).
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
// on their outputs: a repeat is bitwise.
//
// What bounds them on the H100: BYTES at decode and the verify window
// (the live K/V over 3.35 TB/s), OPERATIONS at prefill tails and in
// training (scores, P V and the backward's products at the
// float32-accurate tensor-core rate, or the bf16 rate). The backward and
// split-KV kernels are far from either: chunk copies behind two barriers
// with no copy in flight, and scores repeated per column chunk. The
// measured shares are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int THREADS = 128;  // a backward CTA: 4 warps
constexpr int ROWS = 64;      // its rows: queries (dQ), keys (dK/dV)
constexpr int KEYS = 32;      // keys of a streamed tile (dQ)
constexpr int QUERIES = 32;   // queries of a streamed tile (dK/dV)
constexpr int DK = 32;        // columns of a contraction chunk (S, dP)
constexpr int DC = 128;       // output columns of a CTA (grid z) or a warp
constexpr int NB = DC / 8;    // its 8-column accumulator blocks
constexpr int ST = KEYS / 8;  // 8-key (8-query) score blocks of a tile
static_assert(KEYS == QUERIES, "score tiles are 16 x 32 in every kernel");

constexpr int FWD_THREADS = 256;     // a forward CTA: 8 warps
constexpr int COL_WARPS = 4;         // warps across a row block's columns
constexpr int GW = COL_WARPS * DC;   // output columns a forward CTA owns
constexpr int FT = 32;               // keys of a forward tile (a ring item)
constexpr int FLASH_ROWS = 32;       // query rows of a flash forward CTA
constexpr int PAGED_ROWS = 16;       // query rows of a paged tiled CTA
// dynamic shared memory a forward CTA may take: the card's 227 KB less
// room for its few static words
constexpr int MAX_DYN_SMEM = 232448 - 1024;

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
// in the C fragments s (NT blocks of 8 keys) of Q K^T (unscaled) against
// keys j0 + 8 j + 2 t + e % 2: ``bias(i, key)`` (i 0 for row g, 1 for
// g + 8) is the key's additive term in log2 units, -inf where the key
// is masked. s becomes
// P = 2^(s qk + bias - m) (0 where masked); the running max m (log2 units,
// shared by the row's quad) and this lane's row sums l move on, and acc is
// rescaled by the max's correction.
template <int NT, class Bias>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4],
                                             float (&acc)[NB][4],
                                             float (&m)[2], float (&l)[2],
                                             float qk, const Bias& bias,
                                             int j0, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
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
  for (int j = 0; j < NT; ++j) {
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

// -- the forward kernels' building blocks ----------------------------------

// Element (r, c) of a float32 tile with rows of ld floats (ld % 32 == 0):
// tc_common.cuh's swizzle (``sw``) at a row length known at run time
__device__ __forceinline__ int swf(int r, int c, int ld) {
  const int f = ((r & 3) ^ ((r >> 2) & 1)) << 1;
  return r * ld + (((c >> 2) ^ f) << 2) + (c & 3);
}

// Element (r, c) of a bfloat16 tile with rows of ld elements (ld % 64 ==
// 0): 16-byte chunk c / 8 of row r at chunk (c / 8) ^ (r % 8), so the 8
// rows of an ldmatrix read lie on distinct banks
__device__ __forceinline__ int swb(int r, int c, int ld) {
  return r * ld + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

__device__ __forceinline__ int swz(const float*, int r, int c, int ld) {
  return swf(r, c, ld);
}
__device__ __forceinline__ int swz(const __nv_bfloat16*, int r, int c,
                                   int ld) {
  return swb(r, c, ld);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A = rows r0..r0 + 15, columns k..k + 7 of a float32 tile, split 3xTF32
// (tc_common.cuh ``load_a`` at a run-time row length)
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* s, int ld, int r0, int k,
                                       int g, int t) {
  const float2 x =
      *reinterpret_cast<const float2*>(s + swf(r0 + g, k + 2 * t, ld));
  const float2 y =
      *reinterpret_cast<const float2*>(s + swf(r0 + g + 8, k + 2 * t, ld));
  split(x.x, hi[0], lo[0]);
  split(y.x, hi[1], lo[1]);
  split(x.y, hi[2], lo[2]);
  split(y.y, hi[3], lo[3]);
}

// B(k, n) = tile[n0 + n][k0 + k] (K^T): a float32 tile, or int8 codes in
// rows of ld bytes (exact in TF32: lo 0)
__device__ __forceinline__ void frag_b_rows(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2], const float* s,
                                            int ld, int n0, int k, int g,
                                            int t) {
  const float2 x =
      *reinterpret_cast<const float2*>(s + swf(n0 + g, k + 2 * t, ld));
  split(x.x, hi[0], lo[0]);
  split(x.y, hi[1], lo[1]);
}
__device__ __forceinline__ void frag_b_rows(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2],
                                            const int8_t* s, int ld, int n0,
                                            int k, int g, int t) {
  const char2 x =
      *reinterpret_cast<const char2*>(s + (n0 + g) * ld + k + 2 * t);
  hi[0] = __float_as_uint(static_cast<float>(x.x));
  hi[1] = __float_as_uint(static_cast<float>(x.y));
  lo[0] = lo[1] = 0u;
}

// B(k, n) = tile[k0 + k][n0 + n] (V): slot t is row k0 + 2t, slot t + 4
// row k0 + 2t + 1
__device__ __forceinline__ void frag_b_cols(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2], const float* s,
                                            int ld, int k, int n0, int g,
                                            int t) {
  split(s[swf(k + 2 * t, n0 + g, ld)], hi[0], lo[0]);
  split(s[swf(k + 2 * t + 1, n0 + g, ld)], hi[1], lo[1]);
}
__device__ __forceinline__ void frag_b_cols(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2],
                                            const int8_t* s, int ld, int k,
                                            int n0, int g, int t) {
  hi[0] = __float_as_uint(static_cast<float>(s[(k + 2 * t) * ld + n0 + g]));
  hi[1] =
      __float_as_uint(static_cast<float>(s[(k + 2 * t + 1) * ld + n0 + g]));
  lo[0] = lo[1] = 0u;
}

// c[j] += A B^T, float32 A (rows ar..ar + 15, columns ka..ka + n) and B
// (rows br + 8 j, columns kb..kb + n; float32, or int8 codes when BLO is
// false), 3xTF32 (2 passes on codes). The k steps alternate between two
// fresh partial sums, added into c at the end: no chain of more than
// half the steps, and c gains one rounded term per call. A slice of DC
// columns (every warp's at D 512) runs unrolled whole, any other in
// ceil(n / 8) steps at run time.
template <bool BLO, int NT, typename BT>
__device__ __forceinline__ void scores_tf32(float (&c)[NT][4],
                                            const float* A, int lda, int ar,
                                            int ka, const BT* B, int ldb,
                                            int br, int kb, int n, int g,
                                            int t) {
  float p[2][NT][4];
  zero4(p[0]);
  zero4(p[1]);
  auto step = [&](float (&q)[NT][4], int k) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    frag_a(ah, al, A, lda, ar, ka + k, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      frag_b_rows(bh[j], bl[j], B, ldb, br + 8 * j, kb + k, g, t);
    mma3_rows<true, BLO>(q, ah, al, bh, bl, 0, NT);
  };
  if (n == DC) {
#pragma unroll
    for (int s = 0; s < DC / 8; ++s) step(p[s & 1], 8 * s);
  } else {
    const int steps = (n + 7) >> 3;
#pragma unroll 2
    for (int s = 0; s < steps; s += 2) {
      step(p[0], 8 * s);
      if (s + 1 < steps) step(p[1], 8 * s + 8);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += p[0][j][e] + p[1][j][e];
}

// acc[n] += P V for the NB 8-column blocks from column c0 of a V tile
// (float32, or int8 codes when BLO is false), each 8-key block j of the
// C fragments p one k step against V's rows kr + 8 j..; B fragments 4
// column blocks at a time, pass by pass
template <bool BLO, int NT, typename VT>
__device__ __forceinline__ void pv_tf32(float (&acc)[NB][4],
                                        const float (&p)[NT][4], const VT* V,
                                        int ld, int kr, int c0, int g,
                                        int t) {
  constexpr int CH = 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    c_to_a(p[j], ah, al);
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += CH) {
      uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
      for (int n = 0; n < CH; ++n)
        frag_b_cols(bh[n], bl[n], V, ld, kr + 8 * j, c0 + 8 * (n0 + n), g, t);
#pragma unroll
      for (int n = 0; n < CH; ++n) mma_tf32(acc[n0 + n], al, bh[n]);
      if (BLO) {
#pragma unroll
        for (int n = 0; n < CH; ++n) mma_tf32(acc[n0 + n], ah, bl[n]);
      }
#pragma unroll
      for (int n = 0; n < CH; ++n) mma_tf32(acc[n0 + n], ah, bh[n]);
    }
  }
}

// ldmatrix: four 8 x 8 matrices of 16-bit elements, lanes 8 i..8 i + 7
// giving the row addresses of matrix i; .trans hands each lane the
// transposed elements
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b on the tensor cores, m16n8k16, bfloat16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c[j] += A B^T on bfloat16 tiles (A rows ar..ar + 15, B rows br + 8 j,
// columns ka / kb on, n of them, in k steps of 16), fragments by
// ldmatrix, every step straight into c: bfloat16 operands make the
// products exact in float32, and the sum's rounding stays far inside
// bfloat16's
template <int NT>
__device__ __forceinline__ void scores_bf16(float (&c)[NT][4],
                                            const __nv_bfloat16* A, int lda,
                                            int ar, int ka,
                                            const __nv_bfloat16* B, int ldb,
                                            int br, int kb, int n, int lane) {
  static_assert(NT % 2 == 0, "B fragments come two key blocks at a time");
  const int mi = lane >> 3, rr = lane & 7;
  const int steps = (n + 15) >> 4;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    const int k = 16 * s;
    uint32_t a[4];
    ldsm4(a, A + swb(ar + (mi & 1) * 8 + rr, ka + k + (mi >> 1) * 8, lda));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4(b, B + swb(br + 8 * j + (mi >> 1) * 8 + rr,
                       kb + k + (mi & 1) * 8, ldb));
      mma_bf16(c[j], a, b[0], b[1]);
      mma_bf16(c[j + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += P V on a bfloat16 V tile (rows kr.., columns c0..c0 + 127): P
// rounded to bfloat16 from the C fragments p, 16 keys a k step, V's B
// fragments by ldmatrix.trans two column blocks at a time
template <int NT>
__device__ __forceinline__ void pv_bf16(float (&acc)[NB][4],
                                        const float (&p)[NT][4],
                                        const __nv_bfloat16* V, int ld,
                                        int kr, int c0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  uint32_t a[NT / 2][4];  // all of P packed first: half the registers
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t b[4];
      ldsm4_t(b, V + swb(kr + 16 * kk + (mi & 1) * 8 + rr,
                         c0 + 8 * n + (mi >> 1) * 8, ld));
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// The partial scores of the four column warps of a row block (or key
// group), ``base`` the first of them, summed in warp order: every warp of
// the four gets the same float32 numbers. ``ex``: [8 warps][NT][32 lanes]
template <int NT>
__device__ __forceinline__ void sum_partials(float (&s)[NT][4],
                                             const float4* ex, int base,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 x = ex[(base * NT + j) * 32 + lane];
    s[j][0] = x.x;
    s[j][1] = x.y;
    s[j][2] = x.z;
    s[j][3] = x.w;
#pragma unroll
    for (int c = 1; c < COL_WARPS; ++c) {
      const float4 y = ex[((base + c) * NT + j) * 32 + lane];
      s[j][0] += y.x;
      s[j][1] += y.y;
      s[j][2] += y.z;
      s[j][3] += y.w;
    }
  }
}

template <int NT>
__device__ __forceinline__ void put_partials(float4* ex, int warp,
                                             const float (&s)[NT][4],
                                             int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    ex[(warp * NT + j) * 32 + lane] =
        make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
}

// The columns of contraction chunk ``w`` wide that column warp ``c``
// takes: [*lo, *lo + *n), n <= 0 for none. A quarter of the chunk each,
// rounded up to 16 columns (a bfloat16 k step; two TF32 ones).
__device__ __forceinline__ void warp_slice(int w, int c, int* lo, int* n) {
  const int sl = round_up((w + COL_WARPS - 1) / COL_WARPS, 16);
  *lo = c * sl;
  *n = min(sl, w - *lo);
}

// Shared-memory layout of a forward CTA, in bytes from the dynamic base:
// the resident Q tile (at 0; none when Q streams), the ring of two
// items (ring_off), the partial-score exchange (exch_off) and per-tile
// scales (meta_off). An item holds one K chunk of FT rows of ``cw``
// columns (row stride ldk elements) and, when Q streams, Q's chunk of
// the same columns after it (row stride cw); or the group's V (FT rows
// of GW columns, row stride ldv).
struct FwdLayout {
  int cw, nj, resident, ldq, ldk, ldv, item;
  int ring_off, exch_off, meta_off, total;
};

// ``rows`` query rows, Q elements of ``qes`` bytes in rows of ``ldq``
// when resident; K/V elements of ``kes`` bytes with ``pad`` elements past
// each staged row (int8: 16 bytes, which put a fragment read's 8 rows on
// distinct banks); ``exch`` and ``meta`` bytes. Q stays resident where
// that fits in MAX_DYN_SMEM, else each K chunk item carries Q's chunk of
// 256 columns.
__host__ __device__ inline FwdLayout fwd_layout(int D, int rows, int qes,
                                                int ldq, int kes, int pad,
                                                int exch, int meta) {
  FwdLayout L{};
  for (int res = 1; res >= 0; --res) {
    L.resident = res;
    L.cw = res ? GW : GW / 2;
    L.nj = (D + L.cw - 1) / L.cw;
    L.ldq = res ? ldq : L.cw;
    L.ldk = L.cw + pad;
    L.ldv = GW + pad;
    const int kb = FT * L.ldk * kes;
    const int qc = res ? 0 : rows * L.cw * qes;
    const int vb = FT * L.ldv * kes;
    L.item = round_up(kb + qc > vb ? kb + qc : vb, 128);
    L.ring_off = res ? round_up(rows * ldq * qes, 128) : 0;
    L.exch_off = L.ring_off + 2 * L.item;
    L.meta_off = L.exch_off + exch;
    L.total = L.meta_off + meta;
    if (L.total <= MAX_DYN_SMEM) break;
  }
  return L;
}

template <typename T>
__host__ __device__ inline FwdLayout flash_layout(int D) {
  constexpr int es = sizeof(T);
  return fwd_layout(D, FLASH_ROWS, es, D, es, 0,
                    COL_WARPS * 2 * (FT / 8) * 32 * 16, 0);
}

template <bool QUANT>
__host__ __device__ inline FwdLayout paged_layout(int D) {
  return fwd_layout(D, PAGED_ROWS, 4, round_up(D, 32), QUANT ? 1 : 4,
                    QUANT ? 16 : 0, COL_WARPS * 2 * (FT / 16) * 32 * 16,
                    QUANT ? 4 * FT * 4 : 0);
}

// Copy rows [r0, r0 + R) of one (batch, head) slice of a [B, S, N, D]
// tensor (rows ``stride`` elements apart; zero past S), columns [c0, c0 +
// span) (span a multiple of 16 elements, in range), into a swizzled tile
// with rows of ``ld``, 16 bytes a cp.async, every thread of the CTA
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int r0, int R, int S, int stride,
                                           int c0, int span, int ld) {
  constexpr int EPC = 16 / sizeof(T);
  const int npc = span / EPC;
  for (int i = threadIdx.x; i < R * npc; i += FWD_THREADS) {
    const int r = i / npc;
    const int col = (i - r * npc) * EPC;
    const bool ok = r0 + r < S;
    const T* s = src + (ok ? (size_t)(r0 + r) * stride + c0 + col : 0);
    cp_async16(dst + swz(dst, r, col, ld), s, ok);
  }
}

// -- flash attention ------------------------------------------------------

// The forward: out[:, g 512 : (g + 1) 512] and (group 0) lse of 32 query
// rows, every score computed once (the header).
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, float* __restrict__ lse, int S_q,
                      int S_k, int N, int D, int causal, float scale,
                      FwdLayout L) {
  constexpr bool BF = IsBf16<T>::value;
  constexpr int R = FLASH_ROWS;
  constexpr int NT = FT / 8;  // 8-key blocks of a tile
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  T* Qs = reinterpret_cast<T*>(fwd_smem);
  unsigned char* ring = fwd_smem + L.ring_off;
  float4* ex = reinterpret_cast<float4*>(fwd_smem + L.exch_off);

  const int bh = blockIdx.x;
  const int b = bh / N;
  const int h = bh % N;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the deepest tiles first
  const int c0 = blockIdx.z * GW;             // the group's first column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cw = warp % COL_WARPS;            // column warp
  const int rb = warp / COL_WARPS;            // row block
  const int stride = N * D;
  const int i0 = qt * R;
  const T* qb = q + ((size_t)b * S_q * N + h) * D;
  const T* kb = k + ((size_t)b * S_k * N + h) * D;
  const T* vb = v + ((size_t)b * S_k * N + h) * D;
  const int n_all = (S_k + FT - 1) / FT;
  const int n_kv = causal ? min(n_all, (i0 + R - 1) / FT + 1) : n_all;
  const int nj = L.nj;
  const int items = n_kv * (nj + 1);
  const float qk = scale * LOG2E;
  auto visible = [&](int i, int key) -> float {
    if (key >= S_k || (causal && key > i0 + 16 * rb + g + 8 * i))
      return -INFINITY;
    return bias ? bias[(size_t)b * S_k + key] * LOG2E : 0.f;
  };

  // Items in order: for each key tile, its K chunk j (with Q's chunk
  // when Q streams) for every j, then its V over this CTA's group.
  // (ikt, ij): the next to issue.
  int ikt = 0, ij = 0;
  auto issue_next = [&](int stage) {
    T* dst = reinterpret_cast<T*>(ring + stage * L.item);
    const int j0 = ikt * FT;
    if (ij < nj) {
      const int k0 = ij * L.cw;
      const int span = round_up(min(L.cw, D - k0), 16);
      stage_rows(dst, kb, j0, FT, S_k, stride, k0, span, L.ldk);
      if (!L.resident)
        stage_rows(dst + FT * L.ldk, qb, i0, R, S_q, stride, k0, span, L.cw);
    } else {
      stage_rows(dst, vb, j0, FT, S_k, stride, c0,
                 round_up(min(GW, D - c0), 16), L.ldv);
    }
    if (++ij > nj) {
      ij = 0;
      ++ikt;
    }
  };
  // at the top of item it: its copies have landed for every thread, and
  // every warp is done with item it - 1, whose stage takes item it + 1
  // while the tensor cores work on item it; one copy group an item
  int it = 0;
  auto advance = [&]() -> const T* {
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < items) issue_next((it + 1) & 1);
    cp_commit();
    return reinterpret_cast<const T*>(ring + (it++ & 1) * L.item);
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
  zero4(acc);
  if (L.resident)
    stage_rows(Qs, q + ((size_t)b * S_q * N + h) * D, i0, R, S_q, stride, 0,
               D, L.ldq);
  issue_next(0);  // one copy group with the resident Q
  cp_commit();
  for (int kt = 0; kt < n_kv; ++kt) {
    float s[NT][4];
    zero4(s);
    for (int j = 0; j < nj; ++j) {
      // this warp's quarter of contraction chunk j
      const int k0 = j * L.cw;
      int lo, n;
      warp_slice(min(L.cw, D - k0), cw, &lo, &n);
      const T* cur = advance();
      if (n > 0) {
        const T* A = L.resident ? Qs : cur + FT * L.ldk;
        const int lda = L.resident ? L.ldq : L.cw;
        const int ka = L.resident ? k0 + lo : lo;
        if constexpr (BF) {
          scores_bf16(s, A, lda, 16 * rb, ka, cur, L.ldk, 0, lo, n, lane);
        } else {
          scores_tf32<true>(s, A, lda, 16 * rb, ka, cur, L.ldk, 0, lo, n, g,
                            t);
        }
      }
    }
    put_partials(ex, warp, s, lane);
    const T* cur = advance();  // (its barrier publishes the partials)
    sum_partials(s, ex, COL_WARPS * rb, lane);
    softmax_step(s, acc, m, l, qk, visible, kt * FT, t);
    if (c0 + DC * cw < D) {
      if constexpr (BF)
        pv_bf16(acc, s, cur, L.ldv, 0, DC * cw, lane);
      else
        pv_tf32<true>(acc, s, cur, L.ldv, 0, DC * cw, g, t);
    }
  }
  cp_wait<0>();
  quad_sum(l);
  const int oc = c0 + DC * cw;  // this warp's first output column
  const bool has_out = oc < D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row[2] = {i0 + 16 * rb + g, i0 + 16 * rb + g + 8};
    if (row[i] >= S_q) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    if (has_out) {
      T* o = out + (((size_t)b * S_q + row[i]) * N + h) * D + oc + 2 * t;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        store2(o + 8 * n, acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    }
    if (blockIdx.z == 0 && cw == 0 && t == 0)
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

// Copy bytes [c0 es, (c0 + span) es) of one pool row (``off``: its first
// element; -1: not live, zero) into row r of a staged tile: float32 rows
// swizzled with row stride ``ld`` floats, int8 rows of ``ld`` bytes.
// ``vec`` bytes a copy (16 or 4 by cp.async; 1: int8 rows of D % 4 != 0,
// byte by byte and synchronously); a copy lies wholly below D or wholly
// past it, and past D it is zero-filled without a read. The 8 threads of
// a row take its copies in turn (``sub``).
template <bool QUANT>
__device__ __forceinline__ void stage_key_row(unsigned char* dst,
                                              const void* pool, long long off,
                                              int r, int sub, int c0, int span,
                                              int D, int ld, int vec) {
  constexpr int ES = QUANT ? 1 : 4;
  const unsigned char* src = static_cast<const unsigned char*>(pool);
  const int nbytes = span * ES;
  const int dend = (D - c0) * ES;  // bytes of the row from c0 to D
  for (int p = sub * vec; p < nbytes; p += 8 * vec) {
    const bool ok = off >= 0 && p < dend;
    const size_t at = ok ? (size_t)(off + c0) * ES + p : 0;
    if (QUANT) {
      unsigned char* d = dst + r * ld + p;
      if (vec == 1)
        *d = ok ? src[at] : 0;
      else if (vec == 16)
        cp_async16(d, src + at, ok);
      else
        cp_async4(d, src + at, ok);
    } else {
      float* d = reinterpret_cast<float*>(dst) + swf(r, p >> 2, ld);
      if (vec == 16)
        cp_async16(d, src + at, ok);
      else
        cp_async4(d, src + at, ok);
    }
  }
}

// Q rows [i0, i0 + 16) of (row b, head h), columns [c0, c0 + span) (zero
// past D and past S_q), into a swizzled float32 tile with rows of ld: 16
// threads a row, ``vec`` bytes a copy (16, or 4 when rows break 16-byte
// alignment)
__device__ __forceinline__ void stage_q_rows(float* dst,
                                             const float* __restrict__ q,
                                             int b, int i0, int h, int S_q,
                                             int N, int D, int c0, int span,
                                             int ld, int vec) {
  const int r = threadIdx.x >> 4;
  const int sub = threadIdx.x & 15;
  const bool live = i0 + r < S_q;
  const float* src = q + (((size_t)b * S_q + (live ? i0 + r : 0)) * N + h) * D;
  const int per = vec / 4;  // floats a copy
  for (int c = sub * per; c < span; c += 16 * per) {
    const bool ok = live && c0 + c < D;
    float* d = dst + swf(r, c, ld);
    if (vec == 16)
      cp_async16(d, src + (ok ? c0 + c : 0), ok);
    else
      cp_async4(d, src + (ok ? c0 + c : 0), ok);
  }
}

// Prefill tails and cold prompts at D > 256: out[:, g 512 : (g + 1) 512]
// of 16 query rows of one (row, head), the keys through the table (the
// header).
template <bool QUANT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
paged_wide_tiled_kernel(const float* __restrict__ q, const void* k_pool,
                        const void* v_pool, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, float* __restrict__ out,
                        int S_q, int N, int D, int bs, int MB, float scale,
                        int kv_vec, int q_vec, FwdLayout L) {
  using KT = typename std::conditional<QUANT, int8_t, float>::type;
  constexpr int R = PAGED_ROWS;
  constexpr int KW = FT / 2;   // keys of a tile one key group takes
  constexpr int NT = KW / 8;   // their 8-key blocks
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  float* Qs = reinterpret_cast<float*>(fwd_smem);
  unsigned char* ring = fwd_smem + L.ring_off;
  float4* ex = reinterpret_cast<float4*>(fwd_smem + L.exch_off);
  float* kmul = reinterpret_cast<float*>(fwd_smem + L.meta_off);  // [2][FT]
  float* vmul = kmul + 2 * FT;                                     // [2][FT]
  __shared__ int qpos[R];
  __shared__ int pmax_row, pmax_cta;

  const int h = blockIdx.x % N;
  const int c0 = (blockIdx.x / N) * GW;       // the group's first column
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the deepest queries first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cw = warp % COL_WARPS;  // column warp
  const int kg = warp / COL_WARPS;  // key group: keys [16 kg, 16 kg + 16)
  const int i0 = qt * R;
  const int* prow_pos = pos + (size_t)b * S_q;

  // the row's depth comes from ALL of its queries, as in the reference;
  // the tile's own highest position bounds the keys it can see
  if (threadIdx.x == 0) {
    pmax_row = 0;
    pmax_cta = -1;
  }
  __syncthreads();
  int mx = 0;
  for (int i = threadIdx.x; i < S_q; i += FWD_THREADS)
    mx = max(mx, prow_pos[i]);
  atomicMax(&pmax_row, mx);  // a max: the same in any order
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const int p = i0 + r < S_q ? prow_pos[i0 + r] : -1;
    qpos[r] = p;
    atomicMax(&pmax_cta, p);
  }
  __syncthreads();
  const int live = live_keys(pmax_row, bs, MB);
  const int kend = min(live, pmax_cta + 1);  // keys some row here sees
  const int n_kv = kend > 0 ? (kend + FT - 1) / FT : 0;
  const int nj = L.nj;
  const int items = n_kv * (nj + 1);
  const int myq[2] = {qpos[g], qpos[g + 8]};
  const int oc = c0 + DC * cw;  // this warp's first output column
  const bool has_out = oc < D;
  const float qk = scale * LOG2E;
  auto visible = [&](int i, int key) -> float {
    return (key < kend && key <= myq[i]) ? 0.f : -INFINITY;
  };

  // the staging thread of key row kr (8 a row): the row's pool element
  // offset (-1: past kend), looked up once a tile, when its first item
  // is issued
  const int kr = threadIdx.x >> 3;
  const int sub = threadIdx.x & 7;
  long long koff = -1;
  auto issue = [&](int ikt, int ij, int stage) {
    unsigned char* dst = ring + stage * L.item;
    if (ij == 0) {
      const int key = ikt * FT + kr;
      long long prow = 0;
      koff = -1;
      if (key < kend) {
        prow = (long long)table[(size_t)b * MB + key / bs] * bs + key % bs;
        koff = (prow * N + h) * D;
      }
      if (QUANT && sub == 0) {
        const size_t at = koff >= 0 ? (size_t)(prow * N + h) : 0;
        cp_async4(kmul + (ikt & 1) * FT + kr, k_scale + at, koff >= 0);
        cp_async4(vmul + (ikt & 1) * FT + kr, v_scale + at, koff >= 0);
      }
    }
    if (ij < nj) {
      const int k0 = ij * L.cw;
      const int span = round_up(min(L.cw, D - k0), 16);
      stage_key_row<QUANT>(dst, k_pool, koff, kr, sub, k0, span, D, L.ldk,
                           kv_vec);
      if (!L.resident)
        stage_q_rows(reinterpret_cast<float*>(dst + FT * L.ldk * sizeof(KT)),
                     q, b, i0, h, S_q, N, D, k0, span, L.cw, q_vec);
    } else {
      stage_key_row<QUANT>(dst, v_pool, koff, kr, sub, c0,
                           round_up(min(GW, D - c0), 16), D, L.ldv, kv_vec);
    }
    cp_commit();
  };

  // at the top of item it: its copies have landed for every thread, and
  // every warp is done with item it - 1, whose stage takes item it + 1;
  // one copy group an item
  int it = 0, ikt = 0, ij = 0;
  auto advance = [&]() -> const KT* {
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < items) {
      if (++ij > nj) {
        ij = 0;
        ++ikt;
      }
      issue(ikt, ij, (it + 1) & 1);
    }
    return reinterpret_cast<const KT*>(ring + (it++ & 1) * L.item);
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
  zero4(acc);
  if (items > 0) {
    if (L.resident)
      stage_q_rows(Qs, q, b, i0, h, S_q, N, D, 0, round_up(D, 16), L.ldq,
                   q_vec);
    issue(0, 0, 0);  // one copy group with the resident Q
  }
  for (int kt = 0; kt < n_kv; ++kt) {
    float s[NT][4];
    zero4(s);
    for (int j = 0; j < nj; ++j) {
      const int k0 = j * L.cw;
      int lo, n;
      warp_slice(min(L.cw, D - k0), cw, &lo, &n);
      const KT* cur = advance();
      if (n > 0) {
        const float* A =
            L.resident ? Qs
                       : reinterpret_cast<const float*>(cur + FT * L.ldk);
        const int lda = L.resident ? L.ldq : L.cw;
        const int ka = L.resident ? k0 + lo : lo;
        scores_tf32<!QUANT>(s, A, lda, 0, ka, cur, L.ldk, KW * kg, lo, n,
                            g, t);
      }
    }
    put_partials(ex, warp, s, lane);
    const KT* cur = advance();  // (its barrier publishes the partials)
    sum_partials(s, ex, COL_WARPS * kg, lane);
    const int j0 = kt * FT + KW * kg;  // this group's first key
    if (QUANT) {
      const float* km = kmul + (kt & 1) * FT + KW * kg;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] *= km[8 * jj + 2 * t + (e & 1)];
    }
    softmax_step(s, acc, m, l, qk, visible, j0, t);
    if (QUANT) {  // P' = P v_scale: l summed P itself
      const float* vm = vmul + (kt & 1) * FT + KW * kg;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] *= vm[8 * jj + 2 * t + (e & 1)];
    }
    if (has_out) pv_tf32<!QUANT>(acc, s, cur, L.ldv, KW * kg, DC * cw, g, t);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: key group 1 hands over through it
  quad_sum(l);
  float4* ab = reinterpret_cast<float4*>(ring);  // [4 cw][16 n][32 lanes]
  float* ml = reinterpret_cast<float*>(ex);      // [4 cw][4][32 lanes]
  if (kg == 1) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
      ab[(cw * NB + n) * 32 + lane] =
          make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    ml[(cw * 4 + 0) * 32 + lane] = m[0];
    ml[(cw * 4 + 1) * 32 + lane] = m[1];
    ml[(cw * 4 + 2) * 32 + lane] = l[0];
    ml[(cw * 4 + 3) * 32 + lane] = l[1];
  }
  __syncthreads();
  if (kg == 1) return;
  // out = (acc_0 2^(m_0 - M) + acc_1 2^(m_1 - M)) / (l_0 2^(m_0 - M) + l_1
  // 2^(m_1 - M)), the groups in that order; 0 where neither saw a key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + g + 8 * i;
    const float m1 = ml[(cw * 4 + i) * 32 + lane];
    const float l1 = ml[(cw * 4 + 2 + i) * 32 + lane];
    const float M = fmaxf(m[i], m1);
    const float safe = (M == -INFINITY) ? 0.f : M;
    const float w0 = (m[i] == -INFINITY) ? 0.f : ex2(m[i] - safe);
    const float w1 = (m1 == -INFINITY) ? 0.f : ex2(m1 - safe);
    const float den = l[i] * w0 + l1 * w1;
    const float inv = 1.f / (den == 0.f ? 1.f : den);
    if (row >= S_q || !has_out) continue;
    float* o = out + (((size_t)b * S_q + row) * N + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float4 a1 = ab[(cw * NB + n) * 32 + lane];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = oc + 8 * n + 2 * t + e;
        const float x1 = e == 0 ? (i == 0 ? a1.x : a1.z)
                                : (i == 0 ? a1.y : a1.w);
        if (col < D) o[col] = (acc[n][2 * i + e] * w0 + x1 * w1) * inv;
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
  const FwdLayout L = flash_layout<T>(D);
  if (cudaError_t e = cudaFuncSetAttribute(
          flash_wide_fwd_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, L.total))
    return static_cast<int>(e);
  const dim3 grid(B * N, (S_q + FLASH_ROWS - 1) / FLASH_ROWS,
                  (D + GW - 1) / GW);
  flash_wide_fwd_kernel<T><<<grid, FWD_THREADS, L.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, S_q, S_k, N,
      D, causal, scale, L);
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
// thread, shared bytes (static and ``dyn`` dynamic)} of one kernel
// launched with ``threads`` threads
template <typename K>
int budget(K kern, int threads, int* out, int dyn = 0) {
  if (dyn > 0) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn))
      return static_cast<int>(e);
  }
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
  out[3] = static_cast<int>(a.sharedSizeBytes) + dyn;
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
  const int row_bytes = D * (quantized ? 1 : 4);
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k_pool) |
                       reinterpret_cast<uintptr_t>(v_pool);
  const int kv_vec = (row_bytes % 16 == 0 && kv % 16 == 0)  ? 16
                     : (row_bytes % 4 == 0 && kv % 4 == 0) ? 4
                                                           : 1;
  const int q_vec =
      (D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) ? 16 : 4;
  const dim3 grid(N * ((D + GW - 1) / GW), B,
                  (S_q + PAGED_ROWS - 1) / PAGED_ROWS);
#define TFOS_WIDE_TILED(QUANT)                                               \
  {                                                                          \
    const FwdLayout L = paged_layout<QUANT>(D);                              \
    if (cudaError_t e = cudaFuncSetAttribute(                                \
            paged_wide_tiled_kernel<QUANT>,                                  \
            cudaFuncAttributeMaxDynamicSharedMemorySize, L.total))           \
      return static_cast<int>(e);                                            \
    paged_wide_tiled_kernel<QUANT><<<grid, FWD_THREADS, L.total, st>>>(      \
        q, k_pool, v_pool, k_scale, v_scale, table, pos, out, S_q, N, D, bs, \
        MB, scale, kv_vec, q_vec, L);                                        \
  }
  if (quantized)
    TFOS_WIDE_TILED(true)
  else
    TFOS_WIDE_TILED(false)
#undef TFOS_WIDE_TILED
  return static_cast<int>(cudaGetLastError());
}

// The resource budget of one kernel: ``kernel`` 0 the paged tiled
// kernel, 1 the paged split kernel at ``shape`` queries a row (its
// instantiation: 1, 2 or 4), 2 the flash forward, 3 dQ, 4 dK/dV;
// ``variant``: int8 pools (paged) or bfloat16 (flash). The forward kernels
// (0 and 2) take their shared memory from the head dim, ``shape`` (512
// when it is 256 or less); the others are the same at every D. out[4] =
// {CTAs per SM, registers per thread, local (spill) bytes per thread,
// shared bytes}.
extern "C" int tfos_wide_budget(int kernel, int variant, int shape,
                                int* out) {
  const bool v = variant != 0;
  const int D = shape > 256 ? shape : GW;
  switch (kernel) {
    case 0:
      return v ? budget(paged_wide_tiled_kernel<true>, FWD_THREADS, out,
                        paged_layout<true>(D).total)
               : budget(paged_wide_tiled_kernel<false>, FWD_THREADS, out,
                        paged_layout<false>(D).total);
    case 1:
      switch (split_queries(shape)) {
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
      return v ? budget(flash_wide_fwd_kernel<__nv_bfloat16>, FWD_THREADS,
                        out, flash_layout<__nv_bfloat16>(D).total)
               : budget(flash_wide_fwd_kernel<float>, FWD_THREADS, out,
                        flash_layout<float>(D).total);
    case 3:
      return v ? budget(flash_wide_dq_kernel<__nv_bfloat16>, THREADS, out)
               : budget(flash_wide_dq_kernel<float>, THREADS, out);
    case 4:
      return v ? budget(flash_wide_dkv_kernel<__nv_bfloat16>, THREADS, out)
               : budget(flash_wide_dkv_kernel<float>, THREADS, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
