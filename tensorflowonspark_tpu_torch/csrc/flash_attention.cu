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
// never repeated per head. D in {16, 32, 64, 128, 256} is a template
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
// writer per output tile, so the result is deterministic (FA3's dQ
// accumulated in float32 atomics inside dK/dV would not be). The -inf
// rules are selects, never products with a mask: masked P entries are
// 0 and a -inf lse is read as 0.
//
// What bounds them on the H100. At the training shape (B 8, S 1024,
// N 12, D 64, causal) each kernel does ~130-170 flop per byte it must
// move, above the ridge of every float32 route (67 TFLOP/s of CUDA-core
// FMAs, or 165 TFLOP/s of float32-accurate tensor-core math, over 3.35
// TB/s), so the bound is OPERATIONS.
//
// Two designs. The float32 kernels: mma.sync with the 3xTF32 split,
// below. The bfloat16 kernels (BERT-base's attention: B 32, S 384, N 12,
// D 64, a key mask): wgmma with TMA, at the end of this header.
//
// mma.sync: all three run their seven products on the tensor cores,
// float32-accurate:
//   forward: S = scale (Q K^T), out = P V;
//   backward: S^T/S = scale (Q K^T), dP = dO V^T, dQ = scale (dS K),
//             dK = scale (dS^T Q), dV = P^T dO.
// Q enters unscaled and the scale multiplies the float32 product, where
// the TPU forward scales Q first: the forward's scores are then the same
// float32 numbers the backward recomputes P from, so P = exp(s - lse)
// there sums to 1 as closely as the forward's row sum l.
// - mma.sync.m16n8k8 TF32 with the 3xTF32 split: each float32 operand is
//   x = hi + lo, hi = x rounded to TF32 as cvt.rna.tf32.f32 rounds (done
//   in two integer operations), lo = x - hi (exact; the mma reads its
//   TF32 part, ignoring the low 13 bits), and a b is accumulated in
//   float32 as lo.hi + hi.lo first and hi.hi last. P and dS stay float32
//   operands, as in the TPU kernels (FlashAttention-2 rounds them to 16
//   bits; this does not), split like any float32 operand. P = 2^((s - m)
//   log2 e) through ex2.approx (2 ulp), m the running row max (forward)
//   or lse.
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
//   are rows of D floats whose 16-byte chunks are XOR-swizzled by the row
//   (sw() in tc_common.cuh): the pair reads along rows and the 4-byte
//   reads down columns (the B operand of P V, dS K, P^T dO, dS^T Q) both
//   hit distinct banks at D >= 32.
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
// wgmma (flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel,
// flash_dkv_wgmma_kernel: tfos_flash_fwd, tfos_flash_dq and
// tfos_flash_dkv with bf16 = 1; they replace the same _fwd_kernel,
// _dq_kernel and _dkv_kernel). At BERT's shape they do ~160, ~185 and
// ~205 flop per byte they must move (10.6, 16 and 21 GFLOP on a 73%-live
// key mask, against 66, 85 and 104 MB with K and V read at the live keys
// only), under the bfloat16 ridge (989 TFLOP/s over 3.35 TB/s, ~295):
// the bound is BYTES, 0.020, 0.025 and 0.031 ms. On mma.sync the
// forward and dK/dV ran at a tenth of it, dQ at a ninth: every bfloat16
// product went through TF32 m16n8k8 at half the bfloat16 rate, B
// operands were read down columns 2 bytes at a time, and the products
// with the float32 P or dS took two TF32 passes. Here:
// - wgmma.mma_async m64nNk16 with bfloat16 operands and a float32
//   accumulator, a warpgroup per 64 rows (query rows in the forward and
//   dQ, key rows in dK/dV). S = Q K^T, dP = dO V^T, S^T = K Q^T and
//   dP^T = V dO^T read both operands from shared memory (K-major); P
//   (forward), dS (dQ), P^T and dS^T (dK/dV) go from the accumulator
//   into bfloat16 A registers, never through shared memory; the B of
//   P V, dS K, P^T dO and dS^T Q is the staged V, K, dO or Q tile read
//   MN-major through the transpose bit, with no transposed copy
//   (wgmma_bf16.cuh has the layouts).
// - Tiles are copied by TMA (a tensor map per operand and launch, its
//   encoder reached through cudaGetDriverEntryPoint) into the swizzled
//   layout wgmma's descriptors read, rows past S zero-filled; a ring of
//   two stages completes on mbarriers. There is no producer warp: the
//   last warp to finish with a stage refills it (ring_free), because a
//   fifth warp per warpgroup fits fewer CTAs into each quadrant of the
//   register file (the D-256 forward, one CTA an SM, has one: below).
//   Key-mask, lse and delta slices ride with their tiles.
// - The grid runs a head's row tiles side by side (blockIdx.x the tile),
//   so the CTAs that read one head's K/V (forward) or Q/dO (dK/dV) run
//   together and share it in L2 (with the head fastest they ran a wave
//   apart, and slower). A CTA is one warpgroup: two sharing a ring ran
//   slower at BERT's shape than four one-warpgroup CTAs per SM (PERF.md
//   has the A/B). The forward's online softmax stays in registers (quad
//   shuffles, as in mma.sync's C layout, which the accumulator repeats
//   per 8 columns); P is rounded to bfloat16 for P V, as the reference
//   casts it.
// - dK/dV keeps at most 168 registers a thread so three CTAs share an SM.
//   dS (dQ), P^T and dS^T (dK/dV) are split into bfloat16 hi + lo A
//   operands and dQ, dV, dK take two wgmma passes each (lo first): one
//   rounding to bfloat16 misses the bfloat16 limits
//   (tests/test_torch_flash_attention.py emulates both), and two passes
//   cost what one TF32 pass did. A dK/dV CTA none of whose keys is live
//   writes zeros and loads nothing; dQ lists its row's live KV tiles
//   once (a tile whose keys are all masked adds nothing to dQ) and walks
//   only those, and with none it writes zeros. At D 128 the backward
//   streams 32-row tiles (its 64-column accumulators leave room for
//   32-wide score tiles only).
// - Tiles with no mask to apply (no key masked or past S_k, and wholly
//   on the visible side of the diagonal) skip the per-entry mask and take
//   2^(s scale log2 e - m) in one FMA; a masked entry is -inf and 2^-inf
//   is 0, so the -inf rules above hold without selects on P.
// - Kept: one writer per output tile (deterministic, no atomics), CTAs
//   with the most tiles first, KV tiles past the diagonal skipped under
//   causal, a fully masked row gives out 0 and lse -inf.
//
// Head dim 256 (Gemma-2B's 8 heads x 256; the wrapper zero-pads 129-255
// to it). A warp's 16 rows x 256 columns of float32 accumulator take 128
// registers a thread, and a 64-row float32 tile 64 KB, so:
// - mma.sync (float32): the k loop of rows_by_rows is unrolled 8 steps
//   at a time, and a_by_cols takes V, K, dO or Q's B fragments 2 column
//   blocks at a time (pass-major within them) instead of all at once.
//   Each kernel runs one CTA of 8 warps a 64-row tile, two warps a
//   16-row block, so no warp holds more than one 16 x 128 or 16 x 256
//   accumulator:
//   - the forward (flash_fwd_kernel<256>): each warp of a pair owns one
//     128-column half of out; the pair sums its halves' partial scores
//     through shared memory and both run the same online softmax over
//     32-key tiles (two stages, 212 KB). With one 4-warp CTA over all
//     256 columns (128 accumulator registers a thread) key tiles had to
//     be 8 wide to fit two CTAs an SM, and every 8 keys paid a barrier
//     and a rescale of 128 registers: 0.62 ms against 0.46 at B 4 x S
//     1024 x 8 x 256;
//   - dQ (flash_dq_kernel<256>): warp w computes S and P, warp w + 4 dP,
//     both form dS from the swapped tiles and each adds dS K into one
//     column half of dQ, over 32-key tiles (one stage, 212 KB): 0.65 ms
//     against the 4-warp CTA's 1.29 (16-key tiles, each warp all three
//     products);
//   - dK/dV (flash_dkv_kernel<256>), whose two accumulators would need
//     256 registers a thread, one CTA per 64-key tile (dkv_pair): warps
//     0-3 own dV's 16-key row blocks, computing S^T, P^T and P^T dO, and
//     leave P^T in shared memory; warps 4-7 own dK's, computing dP^T,
//     then dS^T from that P^T, and dS^T Q. Each half does two of the
//     four products on one staged copy of K, V and the 16-query Q/dO
//     ring.
// - wgmma (bfloat16): tiles of four 64-column blocks, m64n256k16 for the
//   products into a 64 x 256 accumulator (128 registers a thread). All
//   three kernels run one CTA of two computing warpgroups (one CTA an SM:
//   wg_pair; the forward adds a third that only copies), so that one
//   warpgroup's elementwise work runs while the other's wgmmas issue,
//   and lay their grids out heads fastest, every
//   head's deepest tiles first (with a head's tiles side by side, the
//   longest CTAs of the last heads ran in the last wave: 16% slower in
//   the backward); the unmasked-tile test is taken once a tile, outside
//   the element loops (inside them, each element compiled to a branch:
//   10%):
//   - the forward (flash_fwd_wgmma_pair_kernel), one CTA a 128-query
//     tile: each computing warpgroup its own 64 rows over one shared ring
//     of 64-key K/V tiles, K and V on barriers of their own,
//     software-pipelined so that P V of one tile runs under the softmax
//     of the next, and a third warpgroup whose one warp refills the ring
//     (FA3's layout, without its ping-pong). At B 4 x S 1024 x 8 x 256,
//     causal, it ran [0.0462] ms against [0.0903] for the one-warpgroup
//     CTA over 64 rows and 32-key tiles, two CTAs an SM, it replaced,
//     whose every CTA staged its own copy of K/V and whose tensor cores
//     idled through each softmax. With the last computing warp to free a
//     stage refilling it (ring_free, as dQ and dK/dV do) it ran [0.0507]:
//     a clock64 trace of the deepest CTA showed the warpgroup that freed
//     last (and so refilled) spending 2090 cycles a tile in its softmax
//     against the other's 965, ~4000 cycles a 64-key tile in all; with
//     the producer both take ~3430 (~640 TFLOP/s in the loop; the K/V
//     stream then draws ~4.9 TB/s from L2), plus ~8300 cycles waiting
//     for the first Q, K and V (the first wave's Q reads come from DRAM
//     together) and ~3000 storing O. Tried and dropped (device ms, each
//     against its base in the same call): the warpgroups taking turns to
//     issue at named barriers (FA3's ping-pong: 0.0466 against 0.0468;
//     before the producer 0.0513-0.0516 against 0.0508-0.0511), with the
//     turn passed once S had completed and O rescaled between S's and P
//     V's issue (0.0512-0.0522 against 0.0516), a Q barrier per
//     warpgroup (0.0517), skipping the rescale when no row max moved
//     (0.0518), O stored from registers (0.0562 against 0.0511) and other
//     tile shapes and ring depths (FWD256_KEYS_BF16);
//   - dK/dV (flash_dkv_wgmma_pair_kernel), one CTA a 64-key tile:
//     warpgroup 0 computes S^T = K Q^T and P^T, leaves P^T in its stage's
//     float32 exchange tile and adds P^T dO into dV; warpgroup 1 computes
//     dP^T = V dO^T, takes P^T at a named barrier to form dS^T and adds
//     dS^T Q into dK. Each holds one 64 x 256 accumulator (128 registers
//     a thread) over a two-stage ring of 64-query Q/dO tiles
//     (DKV256_QUERIES; 32-query tiles ran 15% slower), 226 KB. Every
//     product is computed once: the two CTAs a key tile it replaced each
//     wrote half of dK's and dV's columns and both computed S^T and dP^T
//     over all 256 (4.2 M MACs a 32-query tile against 3.1 M), one
//     warpgroup an SM;
//   - dQ (flash_dq_wgmma_pair_kernel), one CTA a 128-query tile: each
//     warpgroup runs flash_dq_wgmma_kernel's loop on its own 64 rows
//     (32-key tiles, a 64 x 256 accumulator) over one shared K/V ring, so
//     every K/V byte serves 128 rows and the two need nothing from each
//     other. Splitting 64 rows' products between them instead (S and P on
//     one, dP and dS on the other, handed over through shared memory, each
//     adding into one 128-column half of dQ over 64-key tiles) ran 17%
//     slower: the hand-overs left the tensor cores idle.
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
// TMA, mbarriers, wgmma descriptors and wgmma.mma_async for bfloat16
#include "wgmma_bf16.cuh"

namespace {

// -- CTA shape and the cp.async ring --

constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int BWD_ROWS = 16 * BWD_WARPS;  // rows a CTA owns, 16 per warp

// rows of a streamed tile (keys in dQ, queries in dK/dV): 64, 32 at D
// 128, 16 at D 256, where the two resident 64-row tiles of the backward
// alone take 128 KB
template <int D>
__host__ __device__ constexpr int stream_rows() {
  return D > 128 ? 16 : D > 64 ? 32 : 64;
}

// D 256, float32: the forward and dQ run one CTA of 8 warps over 64
// query rows, two warps a 16-row block, each warp owning one 128-column
// half of the block's out or dQ (flash_fwd_kernel<256>,
// flash_dq_kernel<256>). Keys of a streamed K/V tile: the forward's ring
// has two stages, dQ's one (two of 32 keys do not fit beside resident Q
// and dO). The fastest of the tiles tried at B 4 x S 1024 x 8 x 256,
// causal (forward: 16 keys x 2 stages 0.67 ms, 24 x 2 0.49, 32 x 2 0.46,
// 32 x 1 0.47, 48 x 1 0.46, 8 x 2 with two CTAs an SM 0.74 and
// spilling; dQ: 16 x 2 0.95, 32 x 1 0.65):
constexpr int FWD256_KEYS = 32;
constexpr int DQ256_KEYS = 32;

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// row stride, in floats, of a score tile of BN columns that the two warps
// of a pair exchange through shared memory: a multiple of 16 plus 8, so a
// quad's 8-byte accesses to 4 rows land on distinct banks
__host__ __device__ constexpr int xchg_stride(int bn) {
  return (bn + 15) / 16 * 16 + 8;
}

// named barrier ``id`` (1..4; 0 is __syncthreads) of the 64 threads of one
// warp pair (warps w and w + 4)
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// The swap of a warp pair's score tiles: this warp's C fragments x of
// rows r0..r0 + 15 (score tiles j < nt) go to its buffer ``mine`` (rows
// of XS floats), the pair meets at barrier ``id``, and y gets the
// partner's from ``other``. The caller keeps both buffers unwritten until
// a later barrier of the whole CTA.
template <int NT, int XS>
__device__ __forceinline__ void pair_swap(const float (&x)[NT][4],
                                          float (&y)[NT][4], float* mine,
                                          const float* other, int r0, int nt,
                                          int id, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store2(mine + (r0 + g + 8 * i) * XS + 8 * j + 2 * t, x[j][2 * i],
               x[j][2 * i + 1]);
  pair_sync(id);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 o = *reinterpret_cast<const float2*>(
            other + (r0 + g + 8 * i) * XS + 8 * j + 2 * t);
        y[j][2 * i] = o.x;
        y[j][2 * i + 1] = o.y;
      }
}

// At D 256 a warp's dK and dV accumulators over all 256 columns would
// take 256 registers a thread. float32 (dkv_pair): a key tile's CTA has
// 8 warps, a dV half (S^T, P^T, P^T dO) and a dK half (dP^T, dS^T from
// the dV half's P^T through shared memory, dS^T Q), each warp one
// accumulator: the four products once, against 5 of 4 for the two role
// CTAs a key tile it replaced (each computed S^T and staged its own
// operands, 1.52 ms at B 4 x S 1024 x 8 x 256) and 6 of 4 for column
// halves (1.71 ms). bfloat16: the same split between two warpgroups
// (flash_dkv_wgmma_pair_kernel).
template <int D>
__host__ __device__ constexpr bool dkv_pair() { return D > 128; }

// threads of a dK/dV CTA: 4 warps, or 8 as two halves (dkv_pair)
template <int D>
__host__ __device__ constexpr int dkv_threads() {
  return dkv_pair<D>() ? 2 * BWD_THREADS : BWD_THREADS;
}

// Start copying rows [r0, r0 + ROWS) of one (batch, head) slice of a
// [B, S, N, D] tensor (``src`` at row 0 of the slice, rows ``stride``
// elements apart) into a swizzled tile; rows past S are zero-filled.
// THREADS: the CTA's threads, which share the copies.
template <int D, int ROWS, int THREADS = BWD_THREADS>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int S, int stride) {
  constexpr int E = 4;                     // floats in 16 bytes
  constexpr int NC = D / E;
  for (int i = threadIdx.x; i < ROWS * NC; i += THREADS) {
    const int r = i / NC;
    const int c = (i % NC) * E;
    const bool ok = r0 + r < S;
    cp_async16(dst + sw<D>(r, c),
               src + (size_t)(ok ? r0 + r : 0) * stride + c, ok);
  }
}

// Start copying entries [r0, r0 + ROWS) of a float row (lse, delta); 0
// past S
template <int ROWS, int THREADS = BWD_THREADS>
__device__ __forceinline__ void stage_row(float* dst,
                                          const float* __restrict__ src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

// shared memory of the forward: the resident 64-row Q tile and two
// stages of the streamed K and V tiles, and at D 256 the pairs' two
// halves of the partial scores
template <int D>
constexpr size_t fwd_smem() {
  const size_t floats =
      D > 128 ? BWD_ROWS * D + 4 * FWD256_KEYS * D +
                    2 * BWD_ROWS * xchg_stride(FWD256_KEYS)
              : BWD_ROWS * D + 4 * stream_rows<D>() * D;
  return floats * sizeof(float);
}

// threads of a forward or dQ CTA: 4 warps, 8 (two a row block) at D 256
template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return D > 128 ? 2 * BWD_THREADS : BWD_THREADS;
}

// One key tile of the forward's online softmax, for rows g and g + 8 of a
// warp's 16 (the first at query row0) over the NT 8-key score tiles from
// key j0, in the C fragments s (Q K^T): s = scale S + bias, -inf where
// masked (key past S_k; causal: key after the row); the running max m
// (shared by the row's quad) and this lane's row sums l move on, the NB
// accumulator blocks are rescaled by the max's correction, and s becomes
// P = 2^((s - m) log2 e), 0 where masked
template <int NT, int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4],
                                             float (&acc)[NB][4],
                                             float (&m)[2], float (&l)[2],
                                             int row0, int j0, int S_k,
                                             int causal,
                                             const float* __restrict__ brow,
                                             float scale, int g, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
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
  for (int n = 0; n < NB; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = s[j][e];
      const float p =
          (sv == -INFINITY) ? 0.f : ex2((sv - safe[e >> 1]) * LOG2E);
      l[e >> 1] += p;
      s[j][e] = p;
    }
  }
}

// The end of the forward for rows g and g + 8 of a warp's 16 (the first
// at query row0): the quad's row sums, out = acc / l at the NB 8-column
// blocks from column c0 of each row below S_q, and (write_lse, from lane
// t 0) lse = m + log l, -inf for a row with no visible key (out 0)
template <int NB>
__device__ __forceinline__ void store_out(const float (&acc)[NB][4],
                                          const float (&m)[2], float (&l)[2],
                                          float* __restrict__ out,
                                          float* __restrict__ lse, int row0,
                                          int S_q, int N, int b, int h, int bh,
                                          int D, int c0, bool write_lse,
                                          int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const int row = row0 + g + 8 * i;
    if (row >= S_q) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    float* o = out + (((size_t)b * S_q + row) * N + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store2(o + 8 * n, acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    if (write_lse && t == 0)
      lse[(size_t)bh * S_q + row] = (l[i] == 0.f) ? -INFINITY : m[i] + logf(ls);
  }
}

// The forward shares the backward's CTA shape (BWD_WARPS warps of 16
// query rows) and the dQ kernel's loop over streamed K/V tiles.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int S_q,
                 int S_k, int N, int causal, float scale) {
  constexpr int BM = BWD_ROWS;            // query rows of the CTA
  constexpr int BN = stream_rows<D>();    // keys of a streamed tile
  constexpr int NT = BN / 8;              // 8-key score tiles
  constexpr int DT = D / 8;               // 8-wide steps over D
  extern __shared__ __align__(16) unsigned char fwd_smem_buf[];
  float* Qs = reinterpret_cast<float*>(fwd_smem_buf);  // [BM][D], resident
  float* Ks = Qs + BM * D;                             // [2][BN][D], ring
  float* Vs = Ks + 2 * BN * D;                         // [2][BN][D], ring

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
  const float* kb = k + ((size_t)b * S_k * N + h) * D;
  const float* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + BM - 1) / BN + 1) : n_all;

  stage<D, BM>(Qs, q + ((size_t)b * S_q * N + h) * D, i0, S_q, stride);
  stage<D, BN>(Ks, kb, 0, S_k, stride);
  stage<D, BN>(Vs, vb, 0, S_k, stride);
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
      stage<D, BN>(Ks + nxt * BN * D, kb, (kt + 1) * BN, S_k, stride);
      stage<D, BN>(Vs + nxt * BN * D, vb, (kt + 1) * BN, S_k, stride);
      cp_commit();
      cp_wait<1>();                        // tile kt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = kt * BN;
    const float* Kt = Ks + (kt & 1) * BN * D;
    const float* Vt = Vs + (kt & 1) * BN * D;
    // causal: score tiles whose keys all follow the warp's last row are
    // masked whole
    const int nt =
        !causal ? NT : (last_row < j0 ? 0 : min(NT, (last_row - j0) / 8 + 1));
    if (nt > 0) {
      float s[NT][4];
      zero4(s);
      rows_by_rows<D, NT>(s, Qs, Kt, wr, 0, nt, g, t);    // Q K^T
      softmax_tile(s, acc, m, l, i0 + wr, j0, S_k, causal, brow, scale, g,
                   t);
      // acc += P V: the 8 keys of score tile j are one k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          c_to_a(s[j], ah, al);
          a_by_cols<D, DT>(acc, ah, al, Vt, 8 * j, 0, g, t);
        }
      }
    }
    __syncthreads();                       // stage kt & 1 is refilled next
  }
  store_out(acc, m, l, out, lse, i0 + wr, S_q, N, b, h, bh, D, 0, true, g, t);
}

// D 256: one CTA of 8 warps over 64 query rows. Warps w and w + 4 share
// rows 16 w .. 16 w + 15; warp w takes columns 0-127 of D and warp w + 4
// columns 128-255. Per streamed key tile each computes its half's partial
// scores Q[:, half] K[:, half]^T, the pair swaps them through shared memory
// (one named barrier of the pair), and both add the two halves (a + b and
// b + a are the same float), so both hold the same S and run the same
// online softmax; each then adds P V[:, half] into a 16 x 128 accumulator
// (64 registers a thread, where one warp over all 256 columns took 128).
// No product is repeated.
template <>
__global__ void __launch_bounds__(2 * BWD_THREADS, 1)
flash_fwd_kernel<256>(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ lse, int S_q, int S_k, int N,
                      int causal, float scale) {
  constexpr int D = 256;
  constexpr int T = fwd_threads<D>();     // 8 warps
  constexpr int BM = BWD_ROWS;            // query rows of the CTA
  constexpr int BN = FWD256_KEYS;         // keys of a streamed tile
  constexpr int NT = BN / 8;              // 8-key score tiles
  constexpr int HD = D / 2;               // a warp's columns
  constexpr int HT = HD / 8;              // its 8-column blocks
  constexpr int XS = xchg_stride(BN);
  extern __shared__ __align__(16) unsigned char fwd_smem_buf[];
  float* Qs = reinterpret_cast<float*>(fwd_smem_buf);  // [BM][D], resident
  float* Ks = Qs + BM * D;                             // [2][BN][D], ring
  float* Vs = Ks + 2 * BN * D;                         // [2][BN][D], ring
  float* Xs = Vs + 2 * BN * D;                         // [2][BM][XS] partial S

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // most KV tiles first
  const int b = bh / N;
  const int h = bh % N;
  const int warp = threadIdx.x / 32;
  const int half = warp / BWD_WARPS;       // warp-uniform
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int i0 = qt * BM;
  const int wr = 16 * (warp % BWD_WARPS);  // the pair's first row in the tile
  const int c0 = HD * half;                // the warp's first column
  const float* kb = k + ((size_t)b * S_k * N + h) * D;
  const float* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + BM - 1) / BN + 1) : n_all;
  float* mine = Xs + half * BM * XS;
  const float* other = Xs + (1 - half) * BM * XS;

  stage<D, BM, T>(Qs, q + ((size_t)b * S_q * N + h) * D, i0, S_q, stride);
  stage<D, BN, T>(Ks, kb, 0, S_k, stride);
  stage<D, BN, T>(Vs, vb, 0, S_k, stride);
  cp_commit();

  // online softmax of rows g and g + 8 of the pair's 16, the same in both
  // warps of the pair
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int last_row = i0 + wr + 15;
  float acc[HT][4];
  zero4(acc);

  for (int kt = 0; kt < n_kv; ++kt) {
    cp_wait<0>();                          // tile kt has landed
    __syncthreads();                       // and tile kt - 1 is done with
    if (kt + 1 < n_kv) {                   // into the other stage
      const int nxt = (kt + 1) & 1;
      stage<D, BN, T>(Ks + nxt * BN * D, kb, (kt + 1) * BN, S_k, stride);
      stage<D, BN, T>(Vs + nxt * BN * D, vb, (kt + 1) * BN, S_k, stride);
      cp_commit();
    }
    const int j0 = kt * BN;
    const float* Kt = Ks + (kt & 1) * BN * D;
    const float* Vt = Vs + (kt & 1) * BN * D;
    // causal: score tiles whose keys all follow the pair's last row are
    // masked whole
    const int nt =
        !causal ? NT : (last_row < j0 ? 0 : min(NT, (last_row - j0) / 8 + 1));
    if (nt > 0) {
      float s[NT][4];
      zero4(s);
      rows_by_rows<D, NT, HD>(s, Qs, Kt, wr, 0, nt, g, t, c0);  // half of S
      float o[NT][4];
      pair_swap<NT, XS>(s, o, mine, other, wr, nt, 1 + warp % BWD_WARPS, g,
                        t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += o[j][e];
      softmax_tile(s, acc, m, l, i0 + wr, j0, S_k, causal, brow, scale, g,
                   t);
      // acc += P V[:, half]: the 8 keys of score tile j are one k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          c_to_a(s[j], ah, al);
          a_by_cols<D, HT>(acc, ah, al, Vt, 8 * j, c0, g, t);
        }
      }
    }
  }
  store_out(acc, m, l, out, lse, i0 + wr, S_q, N, b, h, bh, D, c0, half == 0,
            g, t);
}

// shared memory of the backward kernels: the resident 64-row tiles (2),
// two stages of the two streamed tiles, and (dK/dV) their lse/delta
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BWD_ROWS * D + 4 * stream_rows<D>() * D) * sizeof(float);
}

// the key tile's P^T (dkv_pair): 64 key rows of the streamed tile's
// queries, rows padded by 8 floats so a quad's 8-byte reads and writes of
// 4 rows land on distinct banks
template <int D>
__host__ __device__ constexpr int pt_stride() { return stream_rows<D>() + 8; }

template <int D>
constexpr size_t dkv_smem() {
  return dq_smem<D>() + 4 * stream_rows<D>() * sizeof(float) +
         (dkv_pair<D>() ? (size_t)BWD_ROWS * pt_stride<D>() * sizeof(float)
                        : 0);
}

// P = 2^((scale S + bias - lse) log2 e) in place of the C fragments x
// (Q K^T) of rows g and g + 8 of a warp's 16 (the first at query row0)
// over the NT 8-key score tiles from key j0; 0 where masked (key past
// S_k; causal: key after the row) and where the score is -inf. lse_r
// holds the rows' lse, a -inf one read as 0.
template <int NT>
__device__ __forceinline__ void p_from_lse(float (&x)[NT][4],
                                           const float (&lse_r)[2], int row0,
                                           int j0, int S_k, int causal,
                                           const float* __restrict__ brow,
                                           float scale, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = j0 + 8 * j + 2 * t + (e & 1);
      const bool kin = col < S_k;
      const bool ok = kin && (!causal || col <= row);
      const float sv =
          x[j][e] * scale + ((brow != nullptr && kin) ? brow[col] : 0.f);
      x[j][e] =
          (!ok || sv == -INFINITY) ? 0.f : ex2((sv - lse_r[e >> 1]) * LOG2E);
    }
  }
}

// dQ = scale acc for rows g and g + 8 of a warp's 16 (the first at query
// row0) below S_q, at the NB 8-column blocks from column c0
template <int NB>
__device__ __forceinline__ void store_dq(const float (&acc)[NB][4],
                                         float* __restrict__ dq, int row0,
                                         int S_q, int N, int b, int h, int D,
                                         int c0, float scale, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S_q) continue;
    float* o = dq + (((size_t)b * S_q + row) * N + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store2(o + 8 * n, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int S_q, int S_k, int N, int causal, float scale) {
  constexpr int BM = BWD_ROWS;            // query rows of the CTA
  constexpr int BN = stream_rows<D>();    // keys of a streamed tile
  constexpr int NT = BN / 8;              // 8-key score tiles
  constexpr int DT = D / 8;               // 8-wide steps over D
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);  // [BM][D], resident
  float* dOs = Qs + BM * D;                        // [BM][D], resident
  float* Ks = dOs + BM * D;                        // [2][BN][D], ring
  float* Vs = Ks + 2 * BN * D;                     // [2][BN][D], ring

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
  const float* kb = k + ((size_t)b * S_k * N + h) * D;
  const float* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + BM - 1) / BN + 1) : n_all;

  stage<D, BM>(Qs, q + qoff, i0, S_q, stride);
  stage<D, BM>(dOs, dout + qoff, i0, S_q, stride);
  stage<D, BN>(Ks, kb, 0, S_k, stride);
  stage<D, BN>(Vs, vb, 0, S_k, stride);
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
      stage<D, BN>(Ks + nxt * BN * D, kb, (kt + 1) * BN, S_k, stride);
      stage<D, BN>(Vs + nxt * BN * D, vb, (kt + 1) * BN, S_k, stride);
      cp_commit();
      cp_wait<1>();                        // tile kt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = kt * BN;
    const float* Kt = Ks + (kt & 1) * BN * D;
    const float* Vt = Vs + (kt & 1) * BN * D;
    // causal: score tiles whose keys all follow the warp's last row are 0
    const int nt =
        !causal ? NT : (last_row < j0 ? 0 : min(NT, (last_row - j0) / 8 + 1));
    if (nt > 0) {
      float s[NT][4], dp[NT][4];
      zero4(s);
      zero4(dp);
      rows_by_rows<D, NT>(s, Qs, Kt, wr, 0, nt, g, t);    // Q K^T
      rows_by_rows<D, NT>(dp, dOs, Vt, wr, 0, nt, g, t);  // dO V^T
      // P from the saved lse, then dS = P (dP - delta), in place in s
      p_from_lse(s, lse_r, i0 + wr, j0, S_k, causal, brow, scale, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (dp[j][e] - del_r[e >> 1]);
      // dQ += dS K: the 8 keys of score tile j are one k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          c_to_a(s[j], ah, al);
          a_by_cols<D, DT>(acc, ah, al, Kt, 8 * j, 0, g, t);
        }
      }
    }
    __syncthreads();                       // stage kt & 1 is refilled next
  }
  store_dq(acc, dq, i0 + wr, S_q, N, b, h, D, 0, scale, g, t);
}

// shared memory of a dQ launch: at D 256 Q and dO resident, one stage of
// K and V, and the pairs' P and dP tiles
template <int D>
constexpr size_t dq_launch_smem() {
  return D > 128 ? (size_t)(2 * BWD_ROWS * D + 2 * DQ256_KEYS * D +
                            2 * BWD_ROWS * xchg_stride(DQ256_KEYS)) *
                       sizeof(float)
                 : dq_smem<D>();
}

// D 256: one CTA of 8 warps over 64 query rows, split by role. Warps w
// and w + 4 share rows 16 w .. 16 w + 15: per streamed key tile warp w
// computes S = Q K^T and P from the saved lse, warp w + 4 dP = dO V^T;
// each leaves its tile in shared memory, the pair meets at one named
// barrier, and both form dS = P (dP - delta) from the same two operands
// (so the same bits). Then warp w adds dS K[:, 0:128] and warp w + 4 dS
// K[:, 128:256] into a 16 x 128 accumulator (64 registers a thread, where
// one warp doing all three products over 256 columns took 128). S and dP
// are computed once each and the dQ product is split, not repeated.
template <>
__global__ void __launch_bounds__(2 * BWD_THREADS, 1)
flash_dq_kernel<256>(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int S_q, int S_k, int N, int causal, float scale) {
  constexpr int D = 256;
  constexpr int T = fwd_threads<D>();     // 8 warps
  constexpr int BM = BWD_ROWS;            // query rows of the CTA
  constexpr int BN = DQ256_KEYS;          // keys of a streamed tile
  constexpr int NT = BN / 8;              // 8-key score tiles
  constexpr int HD = D / 2;               // a warp's columns of dQ
  constexpr int HT = HD / 8;
  constexpr int XS = xchg_stride(BN);
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);  // [BM][D], resident
  float* dOs = Qs + BM * D;                        // [BM][D], resident
  float* Ks = dOs + BM * D;                        // [BN][D], one stage
  float* Vs = Ks + BN * D;                         // [BN][D], one stage
  float* Ps = Vs + BN * D;                         // [BM][XS] P
  float* Gs = Ps + BM * XS;                        // [BM][XS] dP

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // most KV tiles first
  const int b = bh / N;
  const int h = bh % N;
  const int warp = threadIdx.x / 32;
  const bool dp_half = warp >= BWD_WARPS;  // warp-uniform
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int i0 = qt * BM;
  const int wr = 16 * (warp % BWD_WARPS);  // the pair's first row in the tile
  const int c0 = dp_half ? HD : 0;         // the warp's first column of dQ
  const size_t qoff = ((size_t)b * S_q * N + h) * D;
  const float* kb = k + ((size_t)b * S_k * N + h) * D;
  const float* vb = v + ((size_t)b * S_k * N + h) * D;
  const float* brow = bias ? bias + (size_t)b * S_k : nullptr;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + BM - 1) / BN + 1) : n_all;
  float* mine = dp_half ? Gs : Ps;
  const float* other = dp_half ? Ps : Gs;

  stage<D, BM, T>(Qs, q + qoff, i0, S_q, stride);
  stage<D, BM, T>(dOs, dout + qoff, i0, S_q, stride);
  stage<D, BN, T>(Ks, kb, 0, S_k, stride);
  stage<D, BN, T>(Vs, vb, 0, S_k, stride);
  cp_commit();

  // rows g and g + 8 of the pair's 16
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + wr + g + 8 * i;
    const float L = row < S_q ? lse[(size_t)bh * S_q + row] : 0.f;
    lse_r[i] = isfinite(L) ? L : 0.f;
    del_r[i] = row < S_q ? delta[(size_t)bh * S_q + row] : 0.f;
  }
  const int last_row = i0 + wr + 15;
  float acc[HT][4];
  zero4(acc);

  for (int kt = 0; kt < n_kv; ++kt) {
    cp_wait<0>();                          // tile kt has landed
    __syncthreads();
    const int j0 = kt * BN;
    // causal: score tiles whose keys all follow the pair's last row are 0
    const int nt =
        !causal ? NT : (last_row < j0 ? 0 : min(NT, (last_row - j0) / 8 + 1));
    if (nt > 0) {
      // P (warp w) or dP (warp w + 4)
      float x[NT][4];
      zero4(x);
      if (!dp_half) {
        rows_by_rows<D, NT>(x, Qs, Ks, wr, 0, nt, g, t);    // Q K^T
        p_from_lse(x, lse_r, i0 + wr, j0, S_k, causal, brow, scale, g, t);
      } else {
        rows_by_rows<D, NT>(x, dOs, Vs, wr, 0, nt, g, t);   // dO V^T
      }
      float o[NT][4];
      pair_swap<NT, XS>(x, o, mine, other, wr, nt, 1 + warp % BWD_WARPS, g,
                        t);
      // dS = P (dP - delta), in place in x
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = dp_half ? o[j][e] : x[j][e];
            const float d = dp_half ? x[j][e] : o[j][e];
            x[j][e] = p * (d - del_r[e >> 1]);
          }
      // dQ[:, half] += dS K[:, half]: the 8 keys of score tile j are one k
      // step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          c_to_a(x[j], ah, al);
          a_by_cols<D, HT>(acc, ah, al, Ks, 8 * j, c0, g, t);
        }
      }
    }
    __syncthreads();                       // the stage is refilled next
    if (kt + 1 < n_kv) {
      stage<D, BN, T>(Ks, kb, (kt + 1) * BN, S_k, stride);
      stage<D, BN, T>(Vs, vb, (kt + 1) * BN, S_k, stride);
      cp_commit();
    }
  }
  store_dq(acc, dq, i0 + wr, S_q, N, b, h, D, c0, scale, g, t);
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S_q, int S_k, int N, int causal,
                 float scale) {
  constexpr int BK = BWD_ROWS;            // key rows of the CTA
  constexpr int BQ = stream_rows<D>();    // queries of a streamed tile
  constexpr int NT = BQ / 8;              // 8-query score tiles
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* Ks = reinterpret_cast<float*>(bwd_smem);  // [BK][D], resident
  float* Vs = Ks + BK * D;                         // [BK][D], resident
  float* Qs = Vs + BK * D;                         // [2][BQ][D], ring
  float* dOs = Qs + 2 * BQ * D;                    // [2][BQ][D], ring
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
  const float* qb = q + ((size_t)b * S_q * N + h) * D;
  const float* db = dout + ((size_t)b * S_q * N + h) * D;
  const float* lrow = lse + (size_t)bh * S_q;
  const float* drow = delta + (size_t)bh * S_q;
  const int n_q = (S_q + BQ - 1) / BQ;
  // causal: query tiles that end before this KV tile starts see none of it
  const int qt0 = causal ? j0 / BQ : 0;

  stage<D, BK>(Ks, k + koff, j0, S_k, stride);
  stage<D, BK>(Vs, v + koff, j0, S_k, stride);
  stage<D, BQ>(Qs, qb, qt0 * BQ, S_q, stride);
  stage<D, BQ>(dOs, db, qt0 * BQ, S_q, stride);
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
  float acc[DT][4], dk_acc[DT][4];   // dV, dK
  zero4(acc);
  zero4(dk_acc);

  for (int qt = qt0; qt < n_q; ++qt) {
    const int cur = (qt - qt0) & 1;
    if (qt + 1 < n_q) {
      const int nxt = cur ^ 1;
      const int r1 = (qt + 1) * BQ;
      stage<D, BQ>(Qs + nxt * BQ * D, qb, r1, S_q, stride);
      stage<D, BQ>(dOs + nxt * BQ * D, db, r1, S_q, stride);
      stage_row<BQ>(Ls + nxt * BQ, lrow, r1, S_q);
      stage_row<BQ>(Es + nxt * BQ, drow, r1, S_q);
      cp_commit();
      cp_wait<1>();                        // tile qt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int i0 = qt * BQ;
    const float* Qt = Qs + cur * BQ * D;
    const float* dOt = dOs + cur * BQ * D;
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
      rows_by_rows<D, NT>(st, Ks, Qt, wr, j_lo, NT, g, t);     // K Q^T
      rows_by_rows<D, NT>(dpt, Vs, dOt, wr, j_lo, NT, g, t);   // V dO^T
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
          a_by_cols<D, DT>(acc, ah, al, dOt, 8 * j, 0, g, t);
          c_to_a(dpt[j], ah, al);
          a_by_cols<D, DT>(dk_acc, ah, al, Qt, 8 * j, 0, g, t);
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
      store2(dk + base + 8 * n, dk_acc[n][2 * i] * scale,
                dk_acc[n][2 * i + 1] * scale);
      store2(dv + base + 8 * n, acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// D 256 (dkv_pair): one CTA of 8 warps per 64-key tile. Warp w < 4 owns
// key rows 16 w .. 16 w + 15 for dV, warp w + 4 the same rows for dK; each
// keeps one 16 x 256 accumulator (128 registers a thread). Per streamed
// query tile: the dV warp computes S^T = K Q^T and P^T, writes P^T to
// shared memory and adds P^T dO; its dK partner computes dP^T = V dO^T,
// reads P^T after the barrier and adds dS^T Q with dS^T = P^T (dP^T -
// delta). K, V and the Q/dO ring are staged once for both halves.
template <>
__global__ void __launch_bounds__(2 * BWD_THREADS, 1)
flash_dkv_kernel<256>(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S_q, int S_k, int N,
                      int causal, float scale) {
  constexpr int D = 256;
  constexpr int T = dkv_threads<D>();     // 8 warps
  constexpr int BK = BWD_ROWS;            // key rows of the CTA
  constexpr int BQ = stream_rows<D>();    // queries of a streamed tile
  constexpr int NT = BQ / 8;              // 8-query score tiles
  constexpr int DT = D / 8;
  constexpr int PS = pt_stride<D>();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* Ks = reinterpret_cast<float*>(bwd_smem);  // [BK][D], resident
  float* Vs = Ks + BK * D;                         // [BK][D], resident
  float* Qs = Vs + BK * D;                         // [2][BQ][D], ring
  float* dOs = Qs + 2 * BQ * D;                    // [2][BQ][D], ring
  float* Ls = dOs + 2 * BQ * D;                    // [2][BQ] lse
  float* Es = Ls + 2 * BQ;                         // [2][BQ] delta
  float* Ps = Es + 2 * BQ;                         // [BK][PS] P^T

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;               // low tiles see the most queries
  const int b = bh / N;
  const int h = bh % N;
  const int warp = threadIdx.x / 32;
  const bool dk_half = warp >= BWD_WARPS;  // warp-uniform
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int stride = N * D;
  const int j0 = kt * BK;
  const int wr = 16 * (warp % BWD_WARPS);  // the pair's first key row
  const size_t koff = ((size_t)b * S_k * N + h) * D;
  const float* qb = q + ((size_t)b * S_q * N + h) * D;
  const float* db = dout + ((size_t)b * S_q * N + h) * D;
  const float* lrow = lse + (size_t)bh * S_q;
  const float* drow = delta + (size_t)bh * S_q;
  const int n_q = (S_q + BQ - 1) / BQ;
  // causal: query tiles that end before this KV tile starts see none of it
  const int qt0 = causal ? j0 / BQ : 0;

  stage<D, BK, T>(Ks, k + koff, j0, S_k, stride);
  stage<D, BK, T>(Vs, v + koff, j0, S_k, stride);
  stage<D, BQ, T>(Qs, qb, qt0 * BQ, S_q, stride);
  stage<D, BQ, T>(dOs, db, qt0 * BQ, S_q, stride);
  stage_row<BQ, T>(Ls, lrow, qt0 * BQ, S_q);
  stage_row<BQ, T>(Es, drow, qt0 * BQ, S_q);
  cp_commit();

  // key rows g and g + 8 of the pair's 16
  bool kin[2];
  float bk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + wr + g + 8 * i;
    kin[i] = key < S_k;
    bk[i] = (bias != nullptr && kin[i]) ? bias[(size_t)b * S_k + key] : 0.f;
  }
  const int first_key = j0 + wr;
  float acc[DT][4];                        // dV (dV half) or dK (dK half)
  zero4(acc);

  for (int qt = qt0; qt < n_q; ++qt) {
    const int cur = (qt - qt0) & 1;
    if (qt + 1 < n_q) {
      const int nxt = cur ^ 1;
      const int r1 = (qt + 1) * BQ;
      stage<D, BQ, T>(Qs + nxt * BQ * D, qb, r1, S_q, stride);
      stage<D, BQ, T>(dOs + nxt * BQ * D, db, r1, S_q, stride);
      stage_row<BQ, T>(Ls + nxt * BQ, lrow, r1, S_q);
      stage_row<BQ, T>(Es + nxt * BQ, drow, r1, S_q);
      cp_commit();
      cp_wait<1>();                        // tile qt has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int i0 = qt * BQ;
    const float* Qt = Qs + cur * BQ * D;
    const float* dOt = dOs + cur * BQ * D;
    const float* Lt = Ls + cur * BQ;
    const float* Et = Es + cur * BQ;
    // causal: score tiles whose queries all precede the pair's first key
    // are 0 (first_key - i0 is a multiple of 8); the same for both halves
    const int lead = first_key - i0;
    const int j_lo = (!causal || lead <= 0) ? 0 : min(NT, lead / 8);
    const bool live = j_lo < NT;
    // P^T (dV half) or dP^T, then dS^T (dK half)
    float x[NT][4];
    zero4(x);
    if (live) {
      if (!dk_half) {
        rows_by_rows<D, NT>(x, Ks, Qt, wr, j_lo, NT, g, t);   // K Q^T
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
            const bool ok =
                query < S_q && kin[ki] && (!causal || key <= query);
            const float sv = x[j][e] * scale + bk[ki];
            x[j][e] =
                (!ok || sv == -INFINITY) ? 0.f : ex2((sv - lsafe) * LOG2E);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
            store2(Ps + (wr + g + 8 * i) * PS + 8 * j + 2 * t, x[j][2 * i],
                   x[j][2 * i + 1]);
        }
      } else {
        rows_by_rows<D, NT>(x, Vs, dOt, wr, j_lo, NT, g, t);  // V dO^T
      }
    }
    __syncthreads();                       // P^T is in Ps
    if (live) {
      if (dk_half) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 p = *reinterpret_cast<const float2*>(
                Ps + (wr + g + 8 * i) * PS + 8 * j + 2 * t);
            const int c = 8 * j + 2 * t;
            x[j][2 * i] = p.x * (x[j][2 * i] - Et[c]);
            x[j][2 * i + 1] = p.y * (x[j][2 * i + 1] - Et[c + 1]);
          }
      }
      // dV += P^T dO, or dK += dS^T Q: the 8 queries of score tile j are
      // one k step
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= j_lo) {
          uint32_t ah[4], al[4];
          c_to_a(x[j], ah, al);
          a_by_cols<D, DT>(acc, ah, al, dk_half ? Qt : dOt, 8 * j, 0, g, t);
        }
      }
    }
    __syncthreads();                       // stage cur and Ps are refilled
  }

  const float m = dk_half ? scale : 1.f;
  float* o = dk_half ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kin[i]) continue;
    const int key = j0 + wr + g + 8 * i;
    float* r = o + (((size_t)b * S_k + key) * N + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(r + 8 * n, acc[n][2 * i] * m, acc[n][2 * i + 1] * m);
  }
}

// -- the bfloat16 forward and dK/dV: wgmma, TMA and mbarriers --

constexpr int WG_THREADS = 128;   // a CTA: one wgmma warpgroup
constexpr int WG_WARPS = WG_THREADS / 32;
constexpr int WG_ROWS = 64;  // its rows: queries (forward, dQ), keys (dK/dV)
constexpr int WG_FWD_STAGES = 2;  // the forward's K/V ring
constexpr int WG_DKV_STAGES = 2;  // dK/dV's Q/dO ring
constexpr int WG_DQ_STAGES = 2;   // dQ's K/V ring
constexpr float LN2 = 0.6931471805599453f;

// rows of a tile the backward streams (queries in dK/dV, keys in dQ): at
// D 128 the wide accumulators leave room for 32-wide score tiles only
template <int D>
__host__ __device__ constexpr int wg_stream_rows() { return D > 64 ? 32 : 64; }

// D 256: the backward runs two warpgroups a CTA (wg_pair), one CTA an SM.
// Queries of dK/dV's streamed Q/dO tiles (64 x 64 scores take 32
// registers a thread beside the accumulator's 128; 32-query tiles ran 15%
// slower) and keys of dQ's streamed K/V tiles (S and dP take 16 each):
constexpr int DKV256_QUERIES = 64;
constexpr int DQ256_KEYS_BF16 = 32;

template <int D>
__host__ __device__ constexpr bool wg_pair() { return D > 128; }

// threads of a bfloat16 dQ or dK/dV CTA
template <int D>
__host__ __device__ constexpr int wg_bwd_threads() {
  return wg_pair<D>() ? 2 * WG_THREADS : WG_THREADS;
}

// D 256: the forward too runs two warpgroups a CTA, over 128 query rows
// (flash_fwd_wgmma_pair_kernel). Keys of its K/V tiles and stages of its
// K and V rings (64 keys: 32 score registers a thread beside the
// accumulator's 128, and S = Q K^T as m64n64k16, which reads as many B
// bytes as A bytes from shared memory; two stages of each with the two Q
// tiles take 193 KB). Tried at B 4 x S 1024 x 8 x 256, causal (device
// ms; before the producer warp, the kernel 0.0511-0.0516 in the same
// calls: 32 keys x 4 stages 0.0705, 48 x 2 0.0606, 80 x 2 0.0527 with 32
// bytes of spills, 3 K or 3 V stages 0.0515 each; with it, 0.0468: 3 K
// stages 0.0475, 3 V stages 0.0463):
constexpr int FWD256_KEYS_BF16 = 64;
constexpr int FWD256_STAGES_BF16 = 2;
// its third warpgroup only copies: registers a thread of the two that
// compute and of the one that copies (2 x 128 x 240 + 128 x 24 of the
// SM's 65536)
constexpr int FWD256_CONSUMER_REGS = 240;
constexpr int FWD256_PRODUCER_REGS = 24;

// named barrier ``id`` (1..15) of a CTA's two warpgroups: the warpgroup
// that hands a tile over arrives when it has written it (bar.arrive
// orders its shared-memory writes before the other's bar.sync returns),
// the one that takes it waits
__device__ __forceinline__ void wg_hand_over(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * WG_THREADS)
               : "memory");
}
__device__ __forceinline__ void wg_take_over(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * WG_THREADS)
               : "memory");
}

// The float32 exchange tile of a warpgroup's C fragments: rows of 2 NC
// floats, unpadded, each row's 8-column blocks XOR-swizzled by the row's
// low two bits, so the 8-byte accesses of a half-warp (rows g = 0..3 of a
// quad's columns) land on distinct banks. Offset of (row r, score tile
// j, lane t):
template <int NC>
__device__ __forceinline__ int xchg_at(int r, int j, int t) {
  static_assert(NC >= 16, "a row has at least 4 score tiles");
  return r * 2 * NC + 8 * (j ^ (r & 3)) + 2 * t;
}

// store a warpgroup's float32 C fragments x (rows 16 w + g, + 8 of its
// warp w; score tiles of 8 columns) into the exchange tile X, or load
// them back from it
template <int NC>
__device__ __forceinline__ void xchg_store(float* X, const float (&x)[NC],
                                           int w, int g, int t) {
#pragma unroll
  for (int j = 0; j < NC / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      store2(X + xchg_at<NC>(16 * w + g + 8 * i, j, t), x[4 * j + 2 * i],
             x[4 * j + 2 * i + 1]);
}
template <int NC>
__device__ __forceinline__ void xchg_load(const float* X, float (&x)[NC],
                                          int w, int g, int t) {
#pragma unroll
  for (int j = 0; j < NC / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 p = *reinterpret_cast<const float2*>(
          X + xchg_at<NC>(16 * w + g + 8 * i, j, t));
      x[4 * j + 2 * i] = p.x;
      x[4 * j + 2 * i + 1] = p.y;
    }
}

// Shared memory of the forward up to D 128: the resident Q tile, a ring
// of 64-key K and V tiles with the key-mask slice of each (times log2 e)
// and whether it is all 0, the full barriers, the resident tile's
// barrier and the ring's free counts. Every tile is a multiple of 1024
// bytes, so each starts on the swizzle's period; the base is rounded up
// to 1024 inside the kernel.
template <int D>
struct FwdLayout {
  static constexpr int STAGES = WG_FWD_STAGES;
  static constexpr int BN = 64;
  static constexpr bool FLAGS = true;     // the ring carries the flags
  using QT = Tile<D, WG_ROWS>;
  using KT = Tile<D, BN>;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + QT::BYTES;
  static constexpr size_t V = K + STAGES * KT::BYTES;
  static constexpr size_t BIAS = V + STAGES * KT::BYTES;
  static constexpr size_t BAR = BIAS + STAGES * BN * 4;
  static constexpr size_t CNT = BAR + (STAGES + 1) * 8;
  static constexpr size_t NOMASK = CNT + STAGES * 4;
  static constexpr size_t BYTES = NOMASK + STAGES * 4 + 1024;
};

// Shared memory of the forward at D 256 (flash_fwd_wgmma_pair_kernel):
// a resident Q tile per warpgroup, rings of K and V tiles on barriers of
// their own (a stage's K is free once both warpgroups' scores are, its V
// only once their P V is), the key-mask slices and flags riding with K,
// then K's full barriers, V's, K's empty barriers, V's, and Q's
template <int D>
struct FwdPairLayout {
  static constexpr int STAGES = FWD256_STAGES_BF16;
  static constexpr int BN = FWD256_KEYS_BF16;
  static constexpr bool FLAGS = true;
  using QT = Tile<D, WG_ROWS>;
  using KT = Tile<D, BN>;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + 2 * QT::BYTES;
  static constexpr size_t V = K + STAGES * KT::BYTES;
  static constexpr size_t BIAS = V + STAGES * KT::BYTES;
  static constexpr size_t BAR = BIAS + STAGES * BN * 4;
  static constexpr size_t NOMASK = BAR + (4 * STAGES + 1) * 8;
  static constexpr size_t BYTES = NOMASK + STAGES * 4 + 1024;
};

// the forward's layout at head dim D
template <int D>
using FwdWgLayout = typename std::conditional<wg_pair<D>(), FwdPairLayout<D>,
                                              FwdLayout<D>>::type;

// Shared memory of dK/dV: the resident K and V tiles, a ring of Q and dO
// tiles (wg_pair: with each stage's P^T exchange tile, 64 x BQ floats)
// with their lse (times log2 e, 0 where not finite) and delta slices, the
// barriers and free counts
template <int D>
struct DkvLayout {
  static constexpr int STAGES = WG_DKV_STAGES;
  static constexpr int BQ = wg_pair<D>() ? DKV256_QUERIES : wg_stream_rows<D>();
  using KT = Tile<D, WG_ROWS>;
  using QT = Tile<D, BQ>;
  static constexpr size_t K = 0;
  static constexpr size_t V = K + KT::BYTES;
  static constexpr size_t Q = V + KT::BYTES;
  static constexpr size_t DO = Q + STAGES * QT::BYTES;
  static constexpr size_t XCHG = DO + STAGES * QT::BYTES;
  static constexpr size_t LSE =
      XCHG + (wg_pair<D>() ? STAGES * WG_ROWS * BQ * 4 : 0);
  static constexpr size_t DELTA = LSE + STAGES * BQ * 4;
  static constexpr size_t BAR = DELTA + STAGES * BQ * 4;
  static constexpr size_t CNT = BAR + (STAGES + 1) * 8;
  static constexpr size_t BYTES = CNT + STAGES * 4 + 1024;
};

// Shared memory of dQ: the resident Q and dO tiles (a 64-row tile of each
// per warpgroup), the forward's ring of K and V tiles with their key-mask
// slices (whether a slice is all 0 rides in the list instead), the
// barriers and free counts, the number of live KV tiles and, last, their
// list: one int per KV tile of the row (dq_wg_smem adds it to BYTES)
template <int D>
struct DqLayout {
  static constexpr int STAGES = WG_DQ_STAGES;
  static constexpr int BN =
      wg_pair<D>() ? DQ256_KEYS_BF16 : wg_stream_rows<D>();
  static constexpr int WGS = wg_pair<D>() ? 2 : 1;  // warpgroups of the CTA
  static constexpr bool FLAGS = false;
  using QT = Tile<D, WG_ROWS>;
  using KT = Tile<D, BN>;
  static constexpr size_t Q = 0;
  static constexpr size_t DO = Q + WGS * QT::BYTES;
  static constexpr size_t K = DO + WGS * QT::BYTES;
  static constexpr size_t V = K + STAGES * KT::BYTES;
  static constexpr size_t BIAS = V + STAGES * KT::BYTES;
  static constexpr size_t BAR = BIAS + STAGES * BN * 4;
  static constexpr size_t CNT = BAR + (STAGES + 1) * 8;
  static constexpr size_t NLIVE = CNT + STAGES * 4;
  static constexpr size_t LIST = NLIVE + 4;
  static constexpr size_t BYTES = LIST + 1024;
};

// dQ's dynamic shared memory for S_k keys: the layout and the list
template <int D>
constexpr size_t dq_wg_smem(int S_k) {
  using L = DqLayout<D>;
  return L::BYTES + 4 * (size_t)((S_k + L::BN - 1) / L::BN);
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Set up the ring: full[s] completes on two arrives, one with the TMA
// bytes of stage s and one when its float slices are written (the copy
// starts first, so the slices' global loads overlap it); ``once`` on
// the resident tiles' bytes; cnt[s] counts the warps done with stage s.
template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* once,
                                          int* cnt) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);
      cnt[s] = 0;
    }
    mbar_init(once, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// Warp-wide: this warp is done with stage s (its wgmmas have completed,
// its reads of the stage's float slices are done). The CTA's last warp
// (of WARPS) to say so calls ``refill()`` with the whole warp, which
// starts the next tile's copies (lane 0 arrives on full[s] with their
// bytes), writes its float slices and arrives again. No producer warp: a
// fifth warp would leave room in the register file for fewer CTAs per SM
// (each of an SM's four quadrants holds a quarter of its warps'
// registers).
template <int WARPS = WG_WARPS, typename F>
__device__ __forceinline__ void ring_free(int* cnt, int s, F&& refill) {
  __syncwarp();
  int last = 0;
  if (threadIdx.x % 32 == 0) {
    __threadfence_block();
    last = atomicAdd(&cnt[s], 1) == WARPS - 1;
    if (last) cnt[s] = 0;
    __threadfence_block();
  }
  if (__shfl_sync(FULL, last, 0)) {
    __syncwarp();
    refill();
  }
}

// The query tile of a forward or dQ CTA. A head's query tiles are
// neighbours in the launch (x fastest), so they read its K/V from L2
// together; most KV tiles first. It visits n_kv KV tiles of BN keys
// (causal: up to the diagonal tile).
struct QueryTile {
  int bh, b, h, i0, n_kv;
};

template <int BN>
__device__ __forceinline__ QueryTile query_tile(int S_k, int N, int causal) {
  QueryTile c;
  c.bh = blockIdx.y;
  c.b = c.bh / N;
  c.h = c.bh % N;
  c.i0 = (gridDim.x - 1 - blockIdx.x) * WG_ROWS;
  const int n_all = (S_k + BN - 1) / BN;
  c.n_kv = causal ? min(n_all, (c.i0 + WG_ROWS - 1) / BN + 1) : n_all;
  return c;
}

// The K/V ring of the forward and dQ, in layout L: stages of L::BN keys
// of K and V, each with its key-mask slice (times log2 e, -inf past S_k)
// and, where L::FLAGS, whether all of that slice is 0. A stage's full
// barrier completes on two arrives: load() with the copies' bytes and
// slice() when the slice is written. Thread 0 starts the first stages'
// copies (their start is what the CTA first waits on; issued by one
// warp each, the forward ran slower) and warps 0 .. STAGES - 1 write
// their slices; then the last warp to free a stage refills it
// (ring_free).
template <int D, class L>
struct KvRing {
  unsigned char* sm;          // the 1024-aligned base of L
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const float* brow;          // the batch row's key mask, or null
  int S_k, b, h;

  // one thread: start the copies of KV tile kt into stage s
  __device__ __forceinline__ void load(int s, int kt) const {
    constexpr int BN = L::BN;
    using KT = typename L::KT;
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR) + s;
    mbar_arrive_tx(full, 2 * KT::BYTES);
    tma_tile<D, BN>(sm + L::K + s * KT::BYTES, kmap, full, kt * BN, b, h);
    tma_tile<D, BN>(sm + L::V + s * KT::BYTES, vmap, full, kt * BN, b, h);
  }

  // one thread, where K and V complete on barriers of their own (K's
  // STAGES at L::BAR, then V's): start the copy of KV tile kt's K, or V,
  // into stage s
  __device__ __forceinline__ void load_k(int s, int kt) const {
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR) + s;
    mbar_arrive_tx(full, L::KT::BYTES);
    tma_tile<D, L::BN>(sm + L::K + s * L::KT::BYTES, kmap, full, kt * L::BN,
                       b, h);
  }
  __device__ __forceinline__ void load_v(int s, int kt) const {
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR) + L::STAGES + s;
    mbar_arrive_tx(full, L::KT::BYTES);
    tma_tile<D, L::BN>(sm + L::V + s * L::KT::BYTES, vmap, full, kt * L::BN,
                       b, h);
  }

  // warp-wide: write KV tile kt's slice (and flag) into stage s
  __device__ __forceinline__ void slice(int s, int kt) const {
    constexpr int BN = L::BN;
    static_assert(BN % 32 == 0, "a lane writes BN / 32 entries");
    float* bs = reinterpret_cast<float*>(sm + L::BIAS) + s * BN;
    const int lane = threadIdx.x % 32;
    bool zero = true;
#pragma unroll
    for (int r = 0; r < BN / 32; ++r) {    // (unrolled: the loads overlap)
      const int i = lane + 32 * r;
      const int col = kt * BN + i;
      const float x = col < S_k
                          ? (brow != nullptr ? brow[col] * LOG2E : 0.f)
                          : -INFINITY;
      bs[i] = x;
      zero = zero && x == 0.f;
    }
    if constexpr (L::FLAGS) {
      zero = __all_sync(FULL, zero);
      if (lane == 0) reinterpret_cast<int*>(sm + L::NOMASK)[s] = zero;
    }
    __syncwarp();                          // the slice is written
    if (lane == 0) mbar_arrive(reinterpret_cast<uint64_t*>(sm + L::BAR) + s);
  }
};

// The online softmax of one warpgroup's score tile (the forward):
// sc holds this lane's entries of S = Q K^T for the tile of keys col0 ..
// col0 + BN - 1 (rows row0 and row0 + 8, columns 8 j + 2 t + e), bs its
// key-mask slice (times log2 e). An unmasked tile (``plain``: no key
// masked or past S_k, none past the warp's rows under causal) takes the
// row max on the raw products and folds the scale into 2^(s scale log2 e
// - m); others mask each entry to -inf. Leaves P = 2^(s - m) in sc (2^-inf
// is 0: a masked entry gives 0), m the new row max (shared by the row's
// quad), l this lane's share of the row sum rescaled and added to, and
// corr the factor the accumulator must be rescaled by (0 while m was
// -inf). The test is taken once, outside the element loops.
template <int BN>
__device__ __forceinline__ void wg_softmax(float (&sc)[BN / 2], float (&m)[2],
                                           float (&l)[2], float (&corr)[2],
                                           const float* bs, bool plain,
                                           int causal, int col0, int row0,
                                           int t, float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (plain) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
    mx[0] *= scale2;
    mx[1] *= scale2;
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = col0 + 8 * j + 2 * t + (e & 1);
        const bool ok = !causal || col <= row;
        const float sv =
            ok ? fmaf(sc[4 * j + e], scale2, (e & 1) ? bb.y : bb.x)
               : -INFINITY;
        sc[4 * j + e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
  }
  float safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
    corr[i] = ex2(m[i] - safe[i]);
    m[i] = m_new;
    l[i] *= corr[i];
  }
  if (plain) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int i = (j >> 1) & 1;
      sc[j] = ex2(fmaf(sc[j], scale2, -safe[i]));
      l[i] += sc[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int i = (j >> 1) & 1;
      sc[j] = ex2(sc[j] - safe[i]);
      l[i] += sc[j];
    }
  }
}

// The forward at bfloat16, up to D 128 (BERT's path). A wgmma warpgroup
// owns 64 query rows (warp w rows 16 w .. 16 w + 15) and streams 64-key
// K/V tiles through its ring. Per KV tile: S = Q K^T in D / 16 wgmmas
// (both operands K-major in shared memory), the online softmax in
// registers on the accumulator (a row lies on the 4 lanes of a quad), P
// rounded to bfloat16 straight into A registers, O += P V in 4 wgmmas (V
// through the transpose bit).
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ bias,
                       float* __restrict__ lse, int S_q, int S_k, int N,
                       int causal, float scale) {
  using L = FwdLayout<D>;
  using KT = typename L::KT;
  constexpr int BM = WG_ROWS;
  constexpr int BN = L::BN;
  constexpr int STAGES = L::STAGES;
  static_assert(STAGES <= WG_WARPS, "a warp fills each first stage");
  extern __shared__ __align__(1024) unsigned char wg_fwd_smem[];
  unsigned char* sm = align_1k(wg_fwd_smem);
  unsigned char* Qs = sm + L::Q;
  float* Bs = reinterpret_cast<float*>(sm + L::BIAS);         // [STAGES][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [STAGES]
  uint64_t* qbar = full + STAGES;
  int* cnt = reinterpret_cast<int*>(sm + L::CNT);             // [STAGES]
  int* nomask = reinterpret_cast<int*>(sm + L::NOMASK);       // [STAGES]

  const QueryTile tile = query_tile<BN>(S_k, N, causal);
  const int bh = tile.bh, b = tile.b, h = tile.h, i0 = tile.i0;
  const int n_kv = tile.n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const KvRing<D, L> ring{sm, &kmap, &vmap,
                          bias ? bias + (size_t)b * S_k : nullptr, S_k, b, h};
  ring_init<STAGES>(full, qbar, cnt);
  if (threadIdx.x == 0) {
    mbar_arrive_tx(qbar, L::QT::BYTES);
    tma_tile<D, BM>(Qs, &qmap, qbar, i0, b, h);
    for (int s = 0; s < STAGES && s < n_kv; ++s) ring.load(s, s);
  }
  if (warp < STAGES && warp < n_kv) ring.slice(warp, warp);

  // rows g and g + 8 of warp w's 16; scores in log2 units (s scale
  // log2 e + bias log2 e); m the running row max, shared by the row's
  // quad; l this lane's share of the row sum
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = i0 + 16 * warp;         // the warp's first row
  const int row0 = wrow + g;
  const float scale2 = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* Kt = sm + L::K + s * KT::BYTES;
    const unsigned char* Vt = sm + L::V + s * KT::BYTES;
    const float* bs = Bs + s * BN;
    float sc[BN / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)        // S = Q K^T
      wgmma_ss<BN>(sc, desc_k<D, BM>(Qs, ks), desc_k<D, BN>(Kt, ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    pin(sc);
    // P in sc: l sums the float32 P, P V takes it in bfloat16, as the
    // reference casts P to V's dtype
    const bool plain = nomask[s] && scale2 > 0.f &&
                       (!causal || kt * BN + BN - 1 <= wrow);
    float corr[2];
    wg_softmax<BN>(sc, m, l, corr, bs, plain, causal, kt * BN, row0, t,
                   scale2);
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int k = 0; k < BN / 16; ++k) acc_to_a(sc, k, pa[k]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
    pin(acc);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int k = 0; k < BN / 16; ++k)          // O += P V
      wgmma_rs<D>(acc, pa[k], desc_mn<D, BN>(Vt, k), 1);
    wg_commit();
    wg_wait<0>();
    pin(acc);
    ring_free(cnt, s, [&] {                    // refill with tile kt + STAGES
      const int nk = kt + STAGES;
      if (nk >= n_kv) return;
      if (lane == 0) ring.load(s, nk);
      ring.slice(s, nk);
    });
  }

  // O / l in bfloat16 goes where Q was (every wgmma reading it has
  // completed), in the tile's swizzled layout, and one TMA store writes
  // the CTA's rows that exist
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    const float inv = 1.f / ls;
    const int r = row0 - i0 + 8 * i;      // the row in the tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int off = tile_offset<D, BM>(r, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(Qs + off) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
    if (t == 0 && i0 + r < S_q)
      lse[(size_t)bh * S_q + i0 + r] =
          (l[i] == 0.f) ? -INFINITY : m[i] * LN2 + logf(ls);
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) tma_store_tile<D, BM>(Qs, &omap, i0, b, h);
}

// registers a thread of this warpgroup holds from here on: fewer (dec)
// returns them to the CTA's pool, more (inc) waits until the pool has
// them (sm_90a)
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barrier ``id`` of the 128 threads of one warpgroup
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG_THREADS) : "memory");
}

// The forward at bfloat16, D 256: one CTA of two warpgroups that
// compute, over 128 query rows, and a third that only copies. Computing
// warpgroup w owns rows 64 w .. 64 w + 63 with its own Q tile and 64 x
// 256 float32 accumulator (128 registers a thread), over one ring of
// 64-key K/V tiles both read, so every K/V byte staged from L2 serves
// 128 rows. Each runs its tiles software-pipelined: it issues S(kt) = Q
// K(kt)^T and then O += P(kt - 1) V(kt - 1), waits for S(kt) only, and
// computes the softmax of kt while P V runs on the tensor cores,
// rescaling O once P V has completed (P(kt - 1) waits in bfloat16 A
// registers, so this costs no second score tile). A warp frees a stage's
// K once its scores of it are masked and its V once its P V has
// completed, by one arrive on the stage's empty barrier; one warp of the
// third warpgroup (setmaxnreg: 24 registers a thread there, 240 in the
// other two) starts the Q copies and every K/V refill once all 8
// computing warps have freed the stage, and writes the key-mask slices,
// so no computing warp waits on another's progress to refill. Under
// causal the first warpgroup computes no key tile wholly past its rows
// (the second's diagonal tile) and only frees its stages; a warpgroup
// with no rows (S_q <= 64 past i0) computes none. Each computing
// warpgroup writes its rows through its Q tile and one TMA store.
template <int D>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
flash_fwd_wgmma_pair_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap omap,
                            const float* __restrict__ bias,
                            float* __restrict__ lse, int S_q, int S_k, int N,
                            int causal, float scale) {
  using L = FwdPairLayout<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  constexpr int BM = WG_ROWS;
  constexpr int ROWS = 2 * BM;             // query rows of the CTA
  constexpr int BN = L::BN;
  constexpr int KS = BN / 16;              // k steps of P V
  constexpr int STAGES = L::STAGES;
  constexpr int WARPS = 2 * WG_WARPS;      // the consumers'
  static_assert(wg_pair<D>(), "two consumer warpgroups");
  extern __shared__ __align__(1024) unsigned char wg_fwd_pair_smem[];
  unsigned char* sm = align_1k(wg_fwd_pair_smem);
  const float* Bs = reinterpret_cast<const float*>(sm + L::BIAS);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [STAGES]
  uint64_t* vfull = kfull + STAGES;                             // [STAGES]
  uint64_t* kempty = vfull + STAGES;                            // [STAGES]
  uint64_t* vempty = kempty + STAGES;                           // [STAGES]
  uint64_t* qbar = vempty + STAGES;
  const int* nomask = reinterpret_cast<const int*>(sm + L::NOMASK);

  // heads fastest, the deepest row tiles first: with one CTA an SM the
  // longest CTAs of every head start in the first wave
  const int bh = blockIdx.x;
  const int b = bh / N;
  const int h = bh % N;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / WG_WARPS;          // 0, 1: rows 64 wg ..; 2: copies
  const int wq = warp % WG_WARPS;          // the warp in its warpgroup
  const int wfirst = i0 + BM * wg;         // a consumer's first row
  const bool rows1 = i0 + BM < S_q;        // the second consumer has rows
  // key tiles of rows from ``first`` on: causal stops at the tile of the
  // last row's diagonal
  const int n_all = (S_k + BN - 1) / BN;
  const auto tiles_from = [&](int first) {
    return causal ? min(n_all, (first + BM - 1) / BN + 1) : n_all;
  };
  const int n_kv = tiles_from(rows1 ? i0 + BM : i0);   // the ring's
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 2);             // the copy's bytes and the slice
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], WARPS);
      mbar_init(&vempty[s], WARPS);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one warp starts every copy and writes every key-mask
    // slice, refilling a stage once all 8 consumer warps have freed it
    reg_dealloc<FWD256_PRODUCER_REGS>();
    if (wq != 0) return;
    const KvRing<D, L> ring{sm, &kmap, &vmap,
                            bias ? bias + (size_t)b * S_k : nullptr, S_k, b,
                            h};
    if (lane == 0) {
      mbar_arrive_tx(qbar, (rows1 ? 2 : 1) * QT::BYTES);
      tma_tile<D, BM>(sm + L::Q, &qmap, qbar, i0, b, h);
      if (rows1)
        tma_tile<D, BM>(sm + L::Q + QT::BYTES, &qmap, qbar, i0 + BM, b, h);
    }
    for (int kt = 0; kt < n_kv; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&kempty[s], (kt / STAGES + 1) & 1);
      if (lane == 0) ring.load_k(s, kt);
      ring.slice(s, kt);
      if (kt >= STAGES) mbar_wait(&vempty[s], (kt / STAGES + 1) & 1);
      if (lane == 0) ring.load_v(s, kt);
    }
    return;
  }
  reg_alloc<FWD256_CONSUMER_REGS>();
  const int n_mine = (wg == 0 || rows1) ? tiles_from(wfirst) : 0;

  // the ring, by KV tile: a stage's data, waiting for it, and freeing it
  // (each warp arrives once on the stage's empty barrier)
  const auto k_at = [&](int kt) {
    return sm + L::K + (kt % STAGES) * KT::BYTES;
  };
  const auto v_at = [&](int kt) {
    return sm + L::V + (kt % STAGES) * KT::BYTES;
  };
  const auto wait_k = [&](int kt) {
    mbar_wait(&kfull[kt % STAGES], (kt / STAGES) & 1);
  };
  const auto wait_v = [&](int kt) {
    mbar_wait(&vfull[kt % STAGES], (kt / STAGES) & 1);
  };
  const auto free_k = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&kempty[kt % STAGES]);
  };
  const auto free_v = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&vempty[kt % STAGES]);
  };

  // rows g and g + 8 of warp wq's 16 in the warpgroup's 64; scores in
  // log2 units (s scale log2 e + bias log2 e); m the running row max,
  // shared by the row's quad; l this lane's share of the row sum
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = wfirst + 16 * wq;       // the warp's first row
  const int row0 = wrow + g;
  const float scale2 = scale * LOG2E;
  unsigned char* Qs = sm + L::Q + wg * QT::BYTES;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float corr[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2];
  uint32_t pa[KS][4];                      // P of the previous tile
  mbar_wait(qbar, 0);
  // the softmax of tile kt, whose scores are in sc, and the release of
  // its K stage (its slice and flag are read)
  const auto softmax = [&](int kt) {
    const int s = kt % STAGES;
    const bool plain = nomask[s] && scale2 > 0.f &&
                       (!causal || kt * BN + BN - 1 <= wrow);
    wg_softmax<BN>(sc, m, l, corr, Bs + s * BN, plain, causal, kt * BN, row0,
                   t, scale2);
    free_k(kt);
  };

  if (n_mine > 0) {                        // S(0) alone
    wait_k(0);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BN>(sc, desc_k<D, BM>(Qs, ks), desc_k<D, BN>(k_at(0), ks),
                   ks > 0);
    wg_commit();
    wg_wait<0>();
    pin(sc);
    softmax(0);                            // (O is 0: nothing to rescale)
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_to_a(sc, k, pa[k]);
  }
  for (int kt = 1; kt < n_mine; ++kt) {    // S(kt), then P V of kt - 1
    wait_k(kt);
    wait_v(kt - 1);
    pin(acc);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BN>(sc, desc_k<D, BM>(Qs, ks), desc_k<D, BN>(k_at(kt), ks),
                   ks > 0);
    wg_commit();
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(acc, pa[k], desc_mn<D, BN>(v_at(kt - 1), k), 1);
    wg_commit();
    wg_wait<1>();                          // S(kt) has completed
    pin(sc);
    softmax(kt);
    wg_wait<0>();                          // and P V of kt - 1
    pin(acc);
    free_v(kt - 1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_to_a(sc, k, pa[k]);
  }
  if (n_mine > 0) {                        // P V of the last tile
    wait_v(n_mine - 1);
    pin(acc);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(acc, pa[k], desc_mn<D, BN>(v_at(n_mine - 1), k), 1);
    wg_commit();
    wg_wait<0>();
    pin(acc);
    free_v(n_mine - 1);
  }
  // the tiles this warpgroup does not compute, freed in order once they
  // have landed (so no stage is counted free twice before its refill)
  for (int kt = n_mine; kt < n_kv; ++kt) {
    wait_k(kt);
    wait_v(kt);
    free_k(kt);
    free_v(kt);
  }
  if (n_mine == 0) return;

  // O / l in bfloat16 goes where the warpgroup's Q was (only it read that
  // tile, and its wgmmas have completed), in the tile's swizzled layout,
  // and one TMA store a warpgroup writes its rows that exist
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    const float inv = 1.f / ls;
    const int r = 16 * wq + g + 8 * i;     // the row in the tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int off = tile_offset<D, BM>(r, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(Qs + off) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
    if (t == 0 && wfirst + r < S_q)
      lse[(size_t)bh * S_q + wfirst + r] =
          (l[i] == 0.f) ? -INFINITY : m[i] * LN2 + logf(ls);
  }
  fence_async_smem();
  wg_sync(3 + wg);
  if (threadIdx.x % WG_THREADS == 0)
    tma_store_tile<D, BM>(Qs, &omap, wfirst, b, h);
}

// the bfloat16 forward kernel a head dim launches, and its threads
template <int D>
auto fwd_wg_kernel() {
  if constexpr (wg_pair<D>())
    return flash_fwd_wgmma_pair_kernel<D>;
  else
    return flash_fwd_wgmma_kernel<D>;
}
template <int D>
constexpr int fwd_wg_threads() {
  return wg_pair<D>() ? 3 * WG_THREADS : WG_THREADS;
}

// dK/dV at bfloat16. A wgmma warpgroup owns 64 key rows and streams Q/dO
// tiles with their lse and delta slices through its ring. Per Q
// tile: S^T = K Q^T and dP^T = V dO^T (K-major operands in shared
// memory), P^T and dS^T = P^T (dP^T - delta) in registers, each split
// into bfloat16 hi + lo A operands (one rounding to bfloat16 misses the
// bfloat16 limits: tests/test_torch_flash_attention.py), then dV += P^T
// dO and dK += dS^T Q, lo pass first, with dO and Q through the
// transpose bit. Up to D 128: at most 168 registers a thread (no spills
// at D <= 64), so three warps fit one quadrant of the register file and
// two CTAs share an SM (at 172, the compiler's own count, one did).
template <int D>
__global__ void __maxnreg__(168)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const __grid_constant__ CUtensorMap dkmap,
                       const __grid_constant__ CUtensorMap dvmap,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int S_q, int S_k,
                       int N, int causal, float scale) {
  using L = DkvLayout<D>;
  using QT = typename L::QT;
  constexpr int BK = WG_ROWS;
  constexpr int BQ = L::BQ;
  constexpr int NT = BQ / 8;               // 8-query column blocks of S^T
  constexpr int KS = BQ / 16;              // k steps of dV and dK
  constexpr int STAGES = L::STAGES;
  static_assert(STAGES <= WG_WARPS, "a warp fills each first stage");
  extern __shared__ __align__(1024) unsigned char wg_dkv_smem[];
  unsigned char* sm = align_1k(wg_dkv_smem);
  float* Ls = reinterpret_cast<float*>(sm + L::LSE);          // [STAGES][BQ]
  float* Es = reinterpret_cast<float*>(sm + L::DELTA);        // [STAGES][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [STAGES]
  uint64_t* kvbar = full + STAGES;
  int* cnt = reinterpret_cast<int*>(sm + L::CNT);             // [STAGES]

  // a head's key tiles are neighbours in the launch (x fastest), so they
  // read its Q/dO from L2 together; low tiles see the most queries
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int b = bh / N;
  const int h = bh % N;
  const int j0 = kt * BK;
  const int n_q = (S_q + BQ - 1) / BQ;
  // causal: query tiles that end before this KV tile starts see none of it
  const int qt0 = causal ? j0 / BQ : 0;
  const float* lrow = lse + (size_t)bh * S_q;
  const float* drow = delta + (size_t)bh * S_q;
  // the lse (times log2 e, 0 where not finite) and delta slices of Q
  // tile qt
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // warp-wide
  auto row_slices = [&](int s, int qt) {
    for (int i = lane; i < BQ; i += 32) {
      const int r = qt * BQ + i;
      const float x = r < S_q ? lrow[r] : 0.f;
      Ls[s * BQ + i] = isfinite(x) ? x * LOG2E : 0.f;
      Es[s * BQ + i] = r < S_q ? drow[r] : 0.f;
    }
  };
  auto load_q = [&](int s, int qt) {
    mbar_arrive_tx(&full[s], 2 * QT::BYTES);
    tma_tile<D, BQ>(sm + L::Q + s * QT::BYTES, &qmap, &full[s], qt * BQ, b,
                    h);
    tma_tile<D, BQ>(sm + L::DO + s * QT::BYTES, &dmap, &full[s], qt * BQ, b,
                    h);
  };
  // key rows g and g + 8 of warp w's 16
  const int g = lane / 4;
  const int t = lane % 4;
  const unsigned char* Ks = sm + L::K;
  const unsigned char* Vs = sm + L::V;
  const float scale2 = scale * LOG2E;
  int key[2];
  bool kin[2];
  float bk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = j0 + 16 * warp + g + 8 * i;
    kin[i] = key[i] < S_k;
    bk[i] = (bias != nullptr && kin[i])
                ? bias[(size_t)b * S_k + key[i]] * LOG2E
                : 0.f;
  }
  // a CTA none of whose keys is live (masked or past S_k) has dK = dV = 0
  // and loads nothing; one whose keys are all live and unmasked skips the
  // mask on the Q tiles that need none either
  const bool live = __syncthreads_or((kin[0] && bk[0] != -INFINITY) ||
                                     (kin[1] && bk[1] != -INFINITY));
  const bool nomask_keys = __syncthreads_and(kin[0] && kin[1] &&
                                             bk[0] == 0.f && bk[1] == 0.f);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  ring_init<STAGES>(full, kvbar, cnt);
  if (live && threadIdx.x == 0) {
    mbar_arrive_tx(kvbar, 2 * L::KT::BYTES);
    tma_tile<D, BK>(sm + L::K, &kmap, kvbar, j0, b, h);
    tma_tile<D, BK>(sm + L::V, &vmap, kvbar, j0, b, h);
    for (int s = 0; s < STAGES && qt0 + s < n_q; ++s) load_q(s, qt0 + s);
  }
  if (live && warp < STAGES && qt0 + warp < n_q) {
    row_slices(warp, qt0 + warp);
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[warp]);
  }
  if (live) mbar_wait(kvbar, 0);

  for (int qt = live ? qt0 : n_q; qt < n_q; ++qt) {
    const int it = qt - qt0;
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* Qt = sm + L::Q + s * QT::BYTES;
    const unsigned char* dOt = sm + L::DO + s * QT::BYTES;
    const float* Lt = Ls + s * BQ;
    const float* Et = Es + s * BQ;
    const int i0 = qt * BQ;
    float st[BQ / 2], dpt[BQ / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)        // S^T = K Q^T
      wgmma_ss<BQ>(st, desc_k<D, BK>(Ks, ks), desc_k<D, BQ>(Qt, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)        // dP^T = V dO^T
      wgmma_ss<BQ>(dpt, desc_k<D, BK>(Vs, ks), desc_k<D, BQ>(dOt, ks),
                   ks > 0);
    wg_commit();
    wg_wait<0>();
    pin(st);
    pin(dpt);
    // P^T in st, dS^T = P^T (dP^T - delta) in dpt (2^-inf is 0: a masked
    // key gives 0); an unmasked tile (every key live and unmasked, every
    // query before S_q and, under causal, after the CTA's last key) skips
    // the mask
    const bool plain = nomask_keys && i0 + BQ <= S_q &&
                       (!causal || j0 + BK - 1 <= i0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
      const float2 ev = *reinterpret_cast<const float2*>(Et + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = e >> 1;
        const int query = i0 + 8 * j + 2 * t + (e & 1);
        const float L2 = (e & 1) ? lv.y : lv.x;
        float p;
        if (plain) {
          p = ex2(fmaf(st[4 * j + e], scale2, -L2));
        } else {
          const bool ok =
              query < S_q && kin[ki] && (!causal || key[ki] <= query);
          p = ok ? ex2(fmaf(st[4 * j + e], scale2, bk[ki]) - L2) : 0.f;
        }
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? ev.y : ev.x));
      }
    }
    uint32_t ph[KS][4], pl[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_to_a2(st, k, ph[k], pl[k]);
    pin(dv_acc);
    pin(ph);
    pin(pl);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)               // dV += P^T dO, lo then hi
      wgmma_rs<D>(dv_acc, pl[k], desc_mn<D, BQ>(dOt, k), 1);
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(dv_acc, ph[k], desc_mn<D, BQ>(dOt, k), 1);
    wg_commit();
    uint32_t dh[KS][4], dl[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_to_a2(dpt, k, dh[k], dl[k]);
    pin(dk_acc);
    pin(dh);
    pin(dl);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)               // dK += dS^T Q, lo then hi
      wgmma_rs<D>(dk_acc, dl[k], desc_mn<D, BQ>(Qt, k), 1);
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(dk_acc, dh[k], desc_mn<D, BQ>(Qt, k), 1);
    wg_commit();
    wg_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
    ring_free(cnt, s, [&] {                    // refill with tile qt + STAGES
      const int nq = qt + STAGES;
      if (nq >= n_q) return;
      if (lane == 0) load_q(s, nq);
      row_slices(s, nq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    });
  }

  // dK and dV in bfloat16 go where K and V were (every wgmma reading
  // them has completed), in the tiles' swizzled layout, and two TMA
  // stores write the CTA's keys that exist
  unsigned char* dKs = sm + L::K;          // K's place
  unsigned char* dVs = sm + L::V;          // V's place
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key[i] - j0;             // the row in the tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int off = tile_offset<D, BK>(r, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(dKs + off) = __floats2bfloat162_rn(
          dk_acc[4 * n + 2 * i] * scale, dk_acc[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dVs + off) = __floats2bfloat162_rn(
          dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store_tile<D, BK>(dKs, &dkmap, j0, b, h);
    tma_store_tile<D, BK>(dVs, &dvmap, j0, b, h);
  }
}

// dK/dV at bfloat16, D 256: one CTA of two warpgroups a 64-key tile,
// each holding one 64 x 256 accumulator (128 registers a thread; both
// would not fit one warpgroup), over one ring of Q/dO tiles. Per Q tile
// both run the same wgmma stream on their own operands: warpgroup 0 S^T =
// K Q^T, then dV += P^T dO; warpgroup 1 dP^T = V dO^T, then dK += dS^T Q
// (hi + lo passes, lo first, as above). Between them warpgroup 0 forms
// P^T and leaves it, float32, in the stage's exchange tile (named barrier
// 1 + s); warpgroup 1 takes it to form dS^T = P^T (dP^T - delta). The
// stage's exchange tile is written again only after the ring has
// refilled the stage, which waits for both warpgroups to free it, so
// each barrier has one hand-over in flight.
template <int D>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
flash_dkv_wgmma_pair_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const __grid_constant__ CUtensorMap dkmap,
                            const __grid_constant__ CUtensorMap dvmap,
                            const float* __restrict__ bias,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, int S_q,
                            int S_k, int N, int causal, float scale) {
  using L = DkvLayout<D>;
  using QT = typename L::QT;
  constexpr int BK = WG_ROWS;
  constexpr int BQ = L::BQ;
  constexpr int NT = BQ / 8;               // 8-query column blocks of S^T
  constexpr int KS = BQ / 16;              // k steps of dV and dK
  constexpr int STAGES = L::STAGES;
  constexpr int WARPS = 2 * WG_WARPS;
  static_assert(wg_pair<D>() && STAGES <= WG_WARPS,
                "warps of warpgroup 0 fill the first stages");
  extern __shared__ __align__(1024) unsigned char wg_dkv_pair_smem[];
  unsigned char* sm = align_1k(wg_dkv_pair_smem);
  float* Ls = reinterpret_cast<float*>(sm + L::LSE);          // [STAGES][BQ]
  float* Es = reinterpret_cast<float*>(sm + L::DELTA);        // [STAGES][BQ]
  float* Xs = reinterpret_cast<float*>(sm + L::XCHG);  // [STAGES][BK][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [STAGES]
  uint64_t* kvbar = full + STAGES;
  int* cnt = reinterpret_cast<int*>(sm + L::CNT);             // [STAGES]

  // heads fastest, every head's low key tiles (which see the most
  // queries) first: with one CTA an SM the longest CTAs of every head
  // start in the first wave
  const int bh = blockIdx.x;
  const int b = bh / N;
  const int h = bh % N;
  const int j0 = blockIdx.y * BK;
  const int n_q = (S_q + BQ - 1) / BQ;
  // causal: query tiles that end before this KV tile starts see none of it
  const int qt0 = causal ? j0 / BQ : 0;
  const float* lrow = lse + (size_t)bh * S_q;
  const float* drow = delta + (size_t)bh * S_q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool dk_wg = warp >= WG_WARPS;     // warpgroup 1: dP^T, dS^T, dK
  const int wq = warp % WG_WARPS;          // the warp in its warpgroup
  // warp-wide: this lane's entries of the lse (times log2 e, 0 where not
  // finite) and delta slices of Q tile qt, read from global memory, and
  // their store into stage s
  static_assert(BQ % 32 == 0, "a lane holds BQ / 32 entries");
  constexpr int NR = BQ / 32;
  auto read_slices = [&](int qt, float (&l)[NR], float (&d)[NR]) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = qt * BQ + lane + 32 * i;
      const float x = r < S_q ? lrow[r] : 0.f;
      l[i] = isfinite(x) ? x * LOG2E : 0.f;
      d[i] = r < S_q ? drow[r] : 0.f;
    }
  };
  auto write_slices = [&](int s, const float (&l)[NR], const float (&d)[NR]) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      Ls[s * BQ + lane + 32 * i] = l[i];
      Es[s * BQ + lane + 32 * i] = d[i];
    }
  };
  auto load_q = [&](int s, int qt) {
    mbar_arrive_tx(&full[s], 2 * QT::BYTES);
    tma_tile<D, BQ>(sm + L::Q + s * QT::BYTES, &qmap, &full[s], qt * BQ, b,
                    h);
    tma_tile<D, BQ>(sm + L::DO + s * QT::BYTES, &dmap, &full[s], qt * BQ, b,
                    h);
  };
  // key rows g and g + 8 of warp wq's 16, in both warpgroups
  const int g = lane / 4;
  const int t = lane % 4;
  // the resident A operand of this warpgroup's scores: K (S^T) or V (dP^T)
  const unsigned char* As = sm + (dk_wg ? L::V : L::K);
  const float scale2 = scale * LOG2E;
  int key[2];
  bool kin[2];
  float bk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = j0 + 16 * wq + g + 8 * i;
    kin[i] = key[i] < S_k;
    bk[i] = (bias != nullptr && kin[i])
                ? bias[(size_t)b * S_k + key[i]] * LOG2E
                : 0.f;
  }
  // a CTA none of whose keys is live (masked or past S_k) has dK = dV = 0
  // and loads nothing; one whose keys are all live and unmasked skips the
  // mask on the Q tiles that need none either
  const bool live = __syncthreads_or((kin[0] && bk[0] != -INFINITY) ||
                                     (kin[1] && bk[1] != -INFINITY));
  const bool nomask_keys = __syncthreads_and(kin[0] && kin[1] &&
                                             bk[0] == 0.f && bk[1] == 0.f);
  float acc[D / 2];                        // dV (warpgroup 0) or dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  ring_init<STAGES>(full, kvbar, cnt);
  if (live && threadIdx.x == 0) {
    mbar_arrive_tx(kvbar, 2 * L::KT::BYTES);
    tma_tile<D, BK>(sm + L::K, &kmap, kvbar, j0, b, h);
    tma_tile<D, BK>(sm + L::V, &vmap, kvbar, j0, b, h);
    for (int s = 0; s < STAGES && qt0 + s < n_q; ++s) load_q(s, qt0 + s);
  }
  if (live && warp < STAGES && qt0 + warp < n_q) {
    float l[NR], d[NR];
    read_slices(qt0 + warp, l, d);
    write_slices(warp, l, d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[warp]);
  }
  if (live) mbar_wait(kvbar, 0);

  for (int qt = live ? qt0 : n_q; qt < n_q; ++qt) {
    const int it = qt - qt0;
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* Qt = sm + L::Q + s * QT::BYTES;
    const unsigned char* dOt = sm + L::DO + s * QT::BYTES;
    float* Xt = Xs + s * BK * BQ;            // the stage's exchange tile
    const int i0 = qt * BQ;
    // the slices of the tile that refills this stage, read while this
    // tile's products run: whichever warp refills writes them without
    // waiting on global memory
    float lnext[NR], dnext[NR];
    read_slices(qt + STAGES, lnext, dnext);
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    const unsigned char* Bt = dk_wg ? dOt : Qt;
    float x[BQ / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BQ>(x, desc_k<D, BK>(As, ks), desc_k<D, BQ>(Bt, ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    pin(x);
    if (!dk_wg) {
      // P^T (2^-inf is 0: a masked key gives 0); an unmasked tile (every
      // key live and unmasked, every query before S_q and, under causal,
      // after the CTA's last key) skips the mask, a test taken once a tile
      // so the element loops compile to straight-line code
      const float* Lt = Ls + s * BQ;
      const bool plain = nomask_keys && i0 + BQ <= S_q &&
                         (!causal || j0 + BK - 1 <= i0);
      if (plain) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 lv =
              *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] =
                ex2(fmaf(x[4 * j + e], scale2, (e & 1) ? -lv.y : -lv.x));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 lv =
              *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ki = e >> 1;
            const int query = i0 + 8 * j + 2 * t + (e & 1);
            const float L2 = (e & 1) ? lv.y : lv.x;
            const bool ok =
                query < S_q && kin[ki] && (!causal || key[ki] <= query);
            x[4 * j + e] =
                ok ? ex2(fmaf(x[4 * j + e], scale2, bk[ki]) - L2) : 0.f;
          }
        }
      }
      xchg_store<BQ / 2>(Xt, x, wq, g, t);
      wg_hand_over(1 + s);
    } else {
      // dS^T = P^T (dP^T - delta)
      const float* Et = Es + s * BQ;
      float p[BQ / 2];
      wg_take_over(1 + s);
      xchg_load<BQ / 2>(Xt, p, wq, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ev =
            *reinterpret_cast<const float2*>(Et + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = p[4 * j + e] *
                         (x[4 * j + e] - ((e & 1) ? ev.y : ev.x));
      }
    }
    // dV += P^T dO or dK += dS^T Q, lo then hi, dO or Q through the
    // transpose bit
    const unsigned char* Ct = dk_wg ? Qt : dOt;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_to_a2(x, k, ah[k], al[k]);
    pin(acc);
    pin(ah);
    pin(al);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(acc, al[k], desc_mn<D, BQ>(Ct, k), 1);
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(acc, ah[k], desc_mn<D, BQ>(Ct, k), 1);
    wg_commit();
    wg_wait<0>();
    pin(acc);
    ring_free<WARPS>(cnt, s, [&] {             // refill with tile qt + STAGES
      const int nq = qt + STAGES;
      if (nq >= n_q) return;
      if (lane == 0) load_q(s, nq);
      write_slices(s, lnext, dnext);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    });
  }

  // dV (warpgroup 0) goes where V was and dK scale where K was, in
  // bfloat16 and the tiles' swizzled layout, once both warpgroups' last
  // products (which read K and V) have completed; two TMA stores write
  // the CTA's keys that exist
  __syncthreads();
  unsigned char* Os = sm + (dk_wg ? L::K : L::V);
  const float m = dk_wg ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key[i] - j0;             // the row in the tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int off = tile_offset<D, BK>(r, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(Os + off) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] * m, acc[4 * n + 2 * i + 1] * m);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store_tile<D, BK>(sm + L::K, &dkmap, j0, b, h);
    tma_store_tile<D, BK>(sm + L::V, &dvmap, j0, b, h);
  }
}

// the bfloat16 dK/dV kernel a head dim launches
template <int D>
auto dkv_wg_kernel() {
  if constexpr (wg_pair<D>())
    return flash_dkv_wgmma_pair_kernel<D>;
  else
    return flash_dkv_wgmma_kernel<D>;
}

// dQ at bfloat16. A wgmma warpgroup owns 64 query rows, with Q and dO
// resident, and streams the K/V tiles of its live-tile list through the
// forward's ring (KvRing). While Q and dO land, the warps scan the batch
// row's key mask once: a KV tile whose keys are all masked or past S_k
// adds nothing to dQ and is neither loaded nor computed (with padding
// masks such tiles end the row). The ring walks the list, so a stage's
// barrier parity follows the position in the list, not the tile number.
// Per live tile: S = Q K^T and dP = dO V^T (K-major operands in shared
// memory), P and dS = P (dP - delta) in registers, dS split into
// bfloat16 hi + lo A operands (one rounding misses the bfloat16 limits:
// tests/test_torch_flash_attention.py), then dQ += dS K, lo pass first,
// with the staged K read MN-major through the transpose bit.
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap dqmap,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int S_q, int S_k,
                      int N, int causal, float scale) {
  using L = DqLayout<D>;
  using KT = typename L::KT;
  constexpr int BM = WG_ROWS;
  constexpr int BN = L::BN;
  constexpr int NT = BN / 8;               // 8-key column blocks of S
  constexpr int KS = BN / 16;              // k steps of dS K
  constexpr int STAGES = L::STAGES;
  static_assert(STAGES <= WG_WARPS, "a warp fills each first stage");
  extern __shared__ __align__(1024) unsigned char wg_dq_smem[];
  unsigned char* sm = align_1k(wg_dq_smem);
  unsigned char* Qs = sm + L::Q;
  unsigned char* dOs = sm + L::DO;
  float* Bs = reinterpret_cast<float*>(sm + L::BIAS);         // [STAGES][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [STAGES]
  uint64_t* qbar = full + STAGES;
  int* cnt = reinterpret_cast<int*>(sm + L::CNT);             // [STAGES]
  int* nlive = reinterpret_cast<int*>(sm + L::NLIVE);
  int* list = reinterpret_cast<int*>(sm + L::LIST);           // [n_kv]

  const QueryTile tile = query_tile<BN>(S_k, N, causal);
  const int bh = tile.bh, b = tile.b, h = tile.h, i0 = tile.i0;
  const int n_kv = tile.n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const KvRing<D, L> ring{sm, &kmap, &vmap,
                          bias ? bias + (size_t)b * S_k : nullptr, S_k, b, h};
  ring_init<STAGES>(full, qbar, cnt);
  if (threadIdx.x == 0) {
    mbar_arrive_tx(qbar, 2 * L::QT::BYTES);
    tma_tile<D, BM>(Qs, &qmap, qbar, i0, b, h);
    tma_tile<D, BM>(dOs, &dmap, qbar, i0, b, h);
  }
  // rows g and g + 8 of warp w's 16: lse times log2 e (0 where not
  // finite) and delta
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = i0 + 16 * warp;         // the warp's first row
  const int row0 = wrow + g;
  float lse2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float x = row < S_q ? lse[(size_t)bh * S_q + row] : 0.f;
    lse2[i] = isfinite(x) ? x * LOG2E : 0.f;
    del[i] = row < S_q ? delta[(size_t)bh * S_q + row] : 0.f;
  }
  // the live-tile list, while Q and dO land: warp w marks KV tiles w,
  // w + 4, ... (2 kt + 1 when no key of the tile is masked or past S_k,
  // 2 kt when some are, -1 when all are); warp 0 then compacts the marks
  // in place (a chunk's writes land at or below the entries it read)
  for (int kt = warp; kt < n_kv; kt += WG_WARPS) {
    bool live = false, zero = true;
    for (int i = lane; i < BN; i += 32) {
      const int col = kt * BN + i;
      const float x = col < S_k ? (ring.brow != nullptr ? ring.brow[col] : 0.f)
                                : -INFINITY;
      live = live || x != -INFINITY;
      zero = zero && x == 0.f;
    }
    live = __any_sync(FULL, live);
    zero = __all_sync(FULL, zero);
    if (lane == 0) list[kt] = live ? 2 * kt + zero : -1;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int c = 0; c < n_kv; c += 32) {
      const int e = c + lane < n_kv ? list[c + lane] : -1;
      const unsigned m = __ballot_sync(FULL, e >= 0);
      if (e >= 0) list[n + __popc(m & ((1u << lane) - 1u))] = e;
      n += __popc(m);
    }
    if (lane == 0) *nlive = n;
  }
  __syncthreads();
  const int n_live = *nlive;
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES && s < n_live; ++s) ring.load(s, list[s] >> 1);
  if (warp < STAGES && warp < n_live) ring.slice(warp, list[warp] >> 1);

  const float scale2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_live; ++it) {
    const int s = it % STAGES;
    const int kt = list[it] >> 1;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* Kt = sm + L::K + s * KT::BYTES;
    const unsigned char* Vt = sm + L::V + s * KT::BYTES;
    const float* bs = Bs + s * BN;
    float sc[BN / 2], dp[BN / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)        // S = Q K^T
      wgmma_ss<BN>(sc, desc_k<D, BM>(Qs, ks), desc_k<D, BN>(Kt, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)        // dP = dO V^T
      wgmma_ss<BN>(dp, desc_k<D, BM>(dOs, ks), desc_k<D, BN>(Vt, ks),
                   ks > 0);
    wg_commit();
    wg_wait<0>();
    pin(sc);
    pin(dp);
    // P, then dS = P (dP - delta) in place in sc (2^-inf is 0: a masked
    // key gives 0); an unmasked tile (no key masked or past S_k, none
    // past the warp's rows under causal) skips the mask
    const bool plain =
        (list[it] & 1) && (!causal || kt * BN + BN - 1 <= wrow);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p;
        if (plain) {
          p = ex2(fmaf(sc[4 * j + e], scale2, -lse2[i]));
        } else {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool ok = !causal || kt * BN + c <= row0 + 8 * i;
          p = ok ? ex2(fmaf(sc[4 * j + e], scale2, bs[c]) - lse2[i]) : 0.f;
        }
        sc[4 * j + e] = p * (dp[4 * j + e] - del[i]);
      }
    }
    uint32_t dh[KS][4], dl[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k) acc_to_a2(sc, k, dh[k], dl[k]);
    pin(acc);
    pin(dh);
    pin(dl);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)               // dQ += dS K, lo then hi
      wgmma_rs<D>(acc, dl[k], desc_mn<D, BN>(Kt, k), 1);
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_rs<D>(acc, dh[k], desc_mn<D, BN>(Kt, k), 1);
    wg_commit();
    wg_wait<0>();
    pin(acc);
    ring_free(cnt, s, [&] {                    // refill with list[it + STAGES]
      const int nx = it + STAGES;
      if (nx >= n_live) return;
      if (lane == 0) ring.load(s, list[nx] >> 1);
      ring.slice(s, list[nx] >> 1);
    });
  }

  // dQ scale in bfloat16 goes where Q was (every wgmma reading it has
  // completed; with no live tile, Q's copy has landed), in the tile's
  // swizzled layout, and one TMA store writes the CTA's rows that exist
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 - i0 + 8 * i;      // the row in the tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int off = tile_offset<D, BM>(r, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(Qs + off) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) tma_store_tile<D, BM>(Qs, &dqmap, i0, b, h);
}

// dQ at bfloat16, D 256: one CTA of two warpgroups over 128 query rows,
// warpgroup w rows 64 w .. 64 w + 63, each doing flash_dq_wgmma_kernel's
// work on its own rows (a 64 x 256 accumulator, 128 registers a thread,
// 32-key tiles) over one ring of K/V tiles they share: every K/V byte
// read from L2 serves both, and as they need nothing from each other,
// one's elementwise work runs while the other's wgmmas issue. The
// live-tile list and the ring are flash_dq_wgmma_kernel's, over the
// CTA's 128 rows; under causal the first warpgroup skips the key tiles
// wholly past its rows (the second's diagonal tiles) and only frees their
// stages.
template <int D>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
flash_dq_wgmma_pair_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const __grid_constant__ CUtensorMap dqmap,
                           const float* __restrict__ bias,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int S_q,
                           int S_k, int N, int causal, float scale) {
  using L = DqLayout<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  constexpr int BM = WG_ROWS;
  constexpr int ROWS = L::WGS * BM;        // query rows of the CTA
  constexpr int BN = L::BN;
  constexpr int NT = BN / 8;               // 8-key column blocks of S
  constexpr int KS = BN / 16;              // k steps of dS K
  constexpr int STAGES = L::STAGES;
  constexpr int WARPS = L::WGS * WG_WARPS;
  static_assert(wg_pair<D>() && L::WGS == 2 && STAGES <= WARPS,
                "two warpgroups; a warp fills each first stage");
  extern __shared__ __align__(1024) unsigned char wg_dq_pair_smem[];
  unsigned char* sm = align_1k(wg_dq_pair_smem);
  float* Bs = reinterpret_cast<float*>(sm + L::BIAS);         // [STAGES][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [STAGES]
  uint64_t* qbar = full + STAGES;
  int* cnt = reinterpret_cast<int*>(sm + L::CNT);             // [STAGES]
  int* nlive = reinterpret_cast<int*>(sm + L::NLIVE);
  int* list = reinterpret_cast<int*>(sm + L::LIST);           // [n_kv]

  // heads fastest, the deepest row tiles first: with one CTA an SM the
  // longest CTAs of every head start in the first wave
  const int bh = blockIdx.x;
  const int b = bh / N;
  const int h = bh % N;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int n_all = (S_k + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (i0 + ROWS - 1) / BN + 1) : n_all;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / WG_WARPS;          // the warpgroup: rows 64 wg ..
  const int wq = warp % WG_WARPS;          // the warp in its warpgroup
  const KvRing<D, L> ring{sm, &kmap, &vmap,
                          bias ? bias + (size_t)b * S_k : nullptr, S_k, b, h};
  ring_init<STAGES>(full, qbar, cnt);
  if (threadIdx.x == 0) {
    mbar_arrive_tx(qbar, 2 * L::WGS * QT::BYTES);
    for (int w = 0; w < L::WGS; ++w) {
      tma_tile<D, BM>(sm + L::Q + w * QT::BYTES, &qmap, qbar, i0 + BM * w, b,
                      h);
      tma_tile<D, BM>(sm + L::DO + w * QT::BYTES, &dmap, qbar, i0 + BM * w,
                      b, h);
    }
  }
  // rows g and g + 8 of warp wq's 16 in the warpgroup's 64: lse times
  // log2 e (0 where not finite) and delta
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = i0 + BM * wg + 16 * wq;  // the warp's first row
  const int row0 = wrow + g;
  const int wlast = i0 + BM * wg + BM - 1;   // the warpgroup's last row
  float lse2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float x = row < S_q ? lse[(size_t)bh * S_q + row] : 0.f;
    lse2[i] = isfinite(x) ? x * LOG2E : 0.f;
    del[i] = row < S_q ? delta[(size_t)bh * S_q + row] : 0.f;
  }
  // the live-tile list, as flash_dq_wgmma_kernel's, marked by all 8 warps
  for (int kt = warp; kt < n_kv; kt += WARPS) {
    bool live = false, zero = true;
    for (int i = lane; i < BN; i += 32) {
      const int col = kt * BN + i;
      const float x = col < S_k ? (ring.brow != nullptr ? ring.brow[col] : 0.f)
                                : -INFINITY;
      live = live || x != -INFINITY;
      zero = zero && x == 0.f;
    }
    live = __any_sync(FULL, live);
    zero = __all_sync(FULL, zero);
    if (lane == 0) list[kt] = live ? 2 * kt + zero : -1;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int c = 0; c < n_kv; c += 32) {
      const int e = c + lane < n_kv ? list[c + lane] : -1;
      const unsigned m = __ballot_sync(FULL, e >= 0);
      if (e >= 0) list[n + __popc(m & ((1u << lane) - 1u))] = e;
      n += __popc(m);
    }
    if (lane == 0) *nlive = n;
  }
  __syncthreads();
  const int n_live = *nlive;
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES && s < n_live; ++s) ring.load(s, list[s] >> 1);
  if (warp < STAGES && warp < n_live) ring.slice(warp, list[warp] >> 1);

  // this warpgroup's resident Q and dO tiles
  unsigned char* Qs = sm + L::Q + wg * QT::BYTES;
  const unsigned char* dOs = sm + L::DO + wg * QT::BYTES;
  const float scale2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_live; ++it) {
    const int s = it % STAGES;
    const int kt = list[it] >> 1;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* Kt = sm + L::K + s * KT::BYTES;
    const unsigned char* Vt = sm + L::V + s * KT::BYTES;
    // under causal a key tile wholly past this warpgroup's rows adds
    // nothing to its dQ
    if (!causal || kt * BN <= wlast) {
      const float* bs = Bs + s * BN;
      float sc[BN / 2], dp[BN / 2];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)      // S = Q K^T
        wgmma_ss<BN>(sc, desc_k<D, BM>(Qs, ks), desc_k<D, BN>(Kt, ks),
                     ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)      // dP = dO V^T
        wgmma_ss<BN>(dp, desc_k<D, BM>(dOs, ks), desc_k<D, BN>(Vt, ks),
                     ks > 0);
      wg_commit();
      wg_wait<0>();
      pin(sc);
      pin(dp);
      // P, then dS = P (dP - delta) in place in sc (2^-inf is 0: a masked
      // key gives 0); an unmasked tile (no key masked or past S_k, none
      // past the warp's rows under causal) skips the mask, a test taken
      // once a tile so the element loops compile to straight-line code
      const bool plain =
          (list[it] & 1) && (!causal || kt * BN + BN - 1 <= wrow);
      if (plain) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int i = (j >> 1) & 1;
          sc[j] = ex2(fmaf(sc[j], scale2, -lse2[i])) * (dp[j] - del[i]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = 8 * j + 2 * t + (e & 1);
            const bool ok = !causal || kt * BN + c <= row0 + 8 * i;
            const float p =
                ok ? ex2(fmaf(sc[4 * j + e], scale2, bs[c]) - lse2[i])
                   : 0.f;
            sc[4 * j + e] = p * (dp[4 * j + e] - del[i]);
          }
        }
      }
      uint32_t dh[KS][4], dl[KS][4];
#pragma unroll
      for (int k = 0; k < KS; ++k) acc_to_a2(sc, k, dh[k], dl[k]);
      pin(acc);
      pin(dh);
      pin(dl);
      wg_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k)             // dQ += dS K, lo then hi
        wgmma_rs<D>(acc, dl[k], desc_mn<D, BN>(Kt, k), 1);
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_rs<D>(acc, dh[k], desc_mn<D, BN>(Kt, k), 1);
      wg_commit();
      wg_wait<0>();
      pin(acc);
    }
    ring_free<WARPS>(cnt, s, [&] {             // refill with list[it + STAGES]
      const int nx = it + STAGES;
      if (nx >= n_live) return;
      if (lane == 0) ring.load(s, list[nx] >> 1);
      ring.slice(s, list[nx] >> 1);
    });
  }

  // dQ scale in bfloat16 goes where the warpgroup's Q was (only it read
  // that tile; with no live tile, Q's copy has landed), in the tile's
  // swizzled layout; two TMA stores write the CTA's rows that exist
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * wq + g + 8 * i;     // the row in the tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int off = tile_offset<D, BM>(r, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(Qs + off) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 0; w < L::WGS; ++w)
      tma_store_tile<D, BM>(sm + L::Q + w * QT::BYTES, &dqmap, i0 + BM * w, b,
                            h);
}

// the bfloat16 dQ kernel a head dim launches
template <int D>
auto dq_wg_kernel() {
  if constexpr (wg_pair<D>())
    return flash_dq_wgmma_pair_kernel<D>;
  else
    return flash_dq_wgmma_kernel<D>;
}

template <typename K>
int prepare(K kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int S_q, int S_k, int N, int causal,
        float scale, cudaStream_t st) {
  const size_t smem = fwd_smem<D>();
  auto kern = flash_fwd_kernel<D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid(B * N, (S_q + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, fwd_threads<D>(), smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), lse, S_q,
      S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq(const void* q, const void* k, const void* v, const float* bias,
       const void* dout, const float* lse, const float* delta, void* dq_out,
       int B, int S_q, int S_k, int N, int causal, float scale,
       cudaStream_t st) {
  const size_t smem = dq_launch_smem<D>();
  auto kern = flash_dq_kernel<D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid(B * N, (S_q + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, fwd_threads<D>(), smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq_out), S_q, S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const float* bias,
        const void* dout, const float* lse, const float* delta, void* dk_out,
        void* dv_out, int B, int S_q, int S_k, int N, int causal, float scale,
        cudaStream_t st) {
  const size_t smem = dkv_smem<D>();
  auto kern = flash_dkv_kernel<D>;
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid(B * N, (S_k + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, dkv_threads<D>(), smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk_out), static_cast<float*>(dv_out),
      S_q, S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// the bfloat16 forward: tensor maps of q, out (64-row boxes, one a
// warpgroup) and k, v (the layout's key tiles), passed by value in the
// kernel's parameters; at D 256 (wg_pair) two warpgroups a CTA, the grid
// heads fastest
template <int D>
int fwd_wg(const void* q, const void* k, const void* v, const float* bias,
           void* out, float* lse, int B, int S_q, int S_k, int N, int causal,
           float scale, cudaStream_t st) {
  using L = FwdWgLayout<D>;
  CUtensorMap qm, km, vm, om;
  if (int e = tile_map<D, WG_ROWS>(&qm, q, B, S_q, N)) return e;
  if (int e = tile_map<D, L::BN>(&km, k, B, S_k, N)) return e;
  if (int e = tile_map<D, L::BN>(&vm, v, B, S_k, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&om, out, B, S_q, N)) return e;
  const size_t smem = L::BYTES;
  auto kern = fwd_wg_kernel<D>();
  if (int e = prepare(kern, smem)) return e;
  constexpr int ROWS = 2 * WG_ROWS;        // query rows of a pair's CTA
  const dim3 grid = wg_pair<D>() ? dim3(B * N, (S_q + ROWS - 1) / ROWS)
                                 : dim3((S_q + WG_ROWS - 1) / WG_ROWS, B * N);
  kern<<<grid, fwd_wg_threads<D>(), smem, st>>>(
      qm, km, vm, om, bias, lse, S_q, S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV at bfloat16: tensor maps of k, v (64-key boxes) and q, dO
template <int D>
int dkv_wg(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* delta,
           void* dk_out, void* dv_out, int B, int S_q, int S_k, int N,
           int causal, float scale, cudaStream_t st) {
  constexpr int BQ = DkvLayout<D>::BQ;
  CUtensorMap qm, km, vm, dm, dkm, dvm;
  if (int e = tile_map<D, BQ>(&qm, q, B, S_q, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&km, k, B, S_k, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&vm, v, B, S_k, N)) return e;
  if (int e = tile_map<D, BQ>(&dm, dout, B, S_q, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&dkm, dk_out, B, S_k, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&dvm, dv_out, B, S_k, N)) return e;
  const size_t smem = DkvLayout<D>::BYTES;
  auto kern = dkv_wg_kernel<D>();
  if (int e = prepare(kern, smem)) return e;
  const dim3 grid = wg_pair<D>() ? dim3(B * N, (S_k + WG_ROWS - 1) / WG_ROWS)
                                   : dim3((S_k + WG_ROWS - 1) / WG_ROWS, B * N);
  kern<<<grid, wg_bwd_threads<D>(), smem, st>>>(
      qm, km, vm, dm, dkm, dvm, bias, lse, delta, S_q, S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// dQ at bfloat16: tensor maps of q, dO, dQ (64-row boxes) and k, v
template <int D>
int dq_wg(const void* q, const void* k, const void* v, const float* bias,
          const void* dout, const float* lse, const float* delta,
          void* dq_out, int B, int S_q, int S_k, int N, int causal,
          float scale, cudaStream_t st) {
  constexpr int BN = DqLayout<D>::BN;
  CUtensorMap qm, km, vm, dm, dqm;
  if (int e = tile_map<D, WG_ROWS>(&qm, q, B, S_q, N)) return e;
  if (int e = tile_map<D, BN>(&km, k, B, S_k, N)) return e;
  if (int e = tile_map<D, BN>(&vm, v, B, S_k, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&dm, dout, B, S_q, N)) return e;
  if (int e = tile_map<D, WG_ROWS>(&dqm, dq_out, B, S_q, N)) return e;
  const size_t smem = dq_wg_smem<D>(S_k);
  auto kern = dq_wg_kernel<D>();
  if (int e = prepare(kern, smem)) return e;
  constexpr int ROWS = DqLayout<D>::WGS * WG_ROWS;   // query rows of a CTA
  const dim3 grid = wg_pair<D>() ? dim3(B * N, (S_q + ROWS - 1) / ROWS)
                                 : dim3((S_q + ROWS - 1) / ROWS, B * N);
  kern<<<grid, wg_bwd_threads<D>(), smem, st>>>(
      qm, km, vm, dm, dqm, bias, lse, delta, S_q, S_k, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// out = {CTAs per SM, registers per thread, local (spill) bytes per
// thread, dynamic shared bytes} of one kernel instantiation
template <typename K>
int budget(K kern, size_t smem, int* out, int threads = BWD_THREADS) {
  if (int e = prepare(kern, smem)) return e;
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kern))
    return static_cast<int>(e);
  int ctas = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kern, threads, smem))
    return static_cast<int>(e);
  out[0] = ctas;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(smem);
  return 0;
}

template <int D>
int fwd_budget(int* out) {
  return budget(flash_fwd_kernel<D>, fwd_smem<D>(), out, fwd_threads<D>());
}

template <int D>
int fwd_wg_budget(int* out) {
  return budget(fwd_wg_kernel<D>(), FwdWgLayout<D>::BYTES, out,
                fwd_wg_threads<D>());
}

template <int D>
int dq_budget(int* out) {
  return budget(flash_dq_kernel<D>, dq_launch_smem<D>(), out,
                fwd_threads<D>());
}

// (the live-tile list sized for 512 keys, BERT's positions)
template <int D>
int dq_wg_budget(int* out) {
  return budget(dq_wg_kernel<D>(), dq_wg_smem<D>(512), out,
                wg_bwd_threads<D>());
}

template <int D>
int dkv_budget(int* out) {
  return budget(flash_dkv_kernel<D>, dkv_smem<D>(), out, dkv_threads<D>());
}

template <int D>
int dkv_wg_budget(int* out) {
  return budget(dkv_wg_kernel<D>(), DkvLayout<D>::BYTES, out,
                wg_bwd_threads<D>());
}

// head_dim and dtype dispatch (D is a template parameter of every
// kernel): bfloat16 takes the wgmma kernel FN_WG<D>, float32 the
// tensor-core mma.sync kernel FN<D>
#define TFOS_FLASH_DISPATCH_WG(FN, FN_WG, BF16, D, ...)                     \
  do {                                                                       \
    switch (D) {                                                             \
      case 16:                                                               \
        return BF16 ? FN_WG<16>(__VA_ARGS__) : FN<16>(__VA_ARGS__);   \
      case 32:                                                               \
        return BF16 ? FN_WG<32>(__VA_ARGS__) : FN<32>(__VA_ARGS__);   \
      case 64:                                                               \
        return BF16 ? FN_WG<64>(__VA_ARGS__) : FN<64>(__VA_ARGS__);   \
      case 128:                                                              \
        return BF16 ? FN_WG<128>(__VA_ARGS__) : FN<128>(__VA_ARGS__); \
      case 256:                                                              \
        return BF16 ? FN_WG<256>(__VA_ARGS__) : FN<256>(__VA_ARGS__); \
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
  TFOS_FLASH_DISPATCH_WG(fwd, fwd_wg, bf16, D, q, k, v, bias, out, lse, B,
                         S_q, S_k, N, causal, scale, st);
}

extern "C" int tfos_flash_dq(const void* q, const void* k, const void* v,
                             const float* bias, const void* dout,
                             const float* lse, const float* delta, void* dq_out,
                             int B, int S_q, int S_k, int N, int D, int causal,
                             float scale, int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_FLASH_DISPATCH_WG(dq, dq_wg, bf16, D, q, k, v, bias, dout, lse, delta,
                         dq_out, B, S_q, S_k, N, causal, scale, st);
}

extern "C" int tfos_flash_dkv(const void* q, const void* k, const void* v,
                              const float* bias, const void* dout,
                              const float* lse, const float* delta,
                              void* dk_out, void* dv_out, int B, int S_q,
                              int S_k, int N, int D, int causal, float scale,
                              int bf16, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TFOS_FLASH_DISPATCH_WG(dkv, dkv_wg, bf16, D, q, k, v, bias, dout, lse,
                         delta, dk_out, dv_out, B, S_q, S_k, N, causal, scale,
                         st);
}

// The resource budget of the dQ (``kernel`` 0), dK/dV (1) or forward (2)
// kernel for head dim D and dtype: out[4] = {CTAs per SM, registers per
// thread, local (spill) bytes per thread, dynamic shared-memory bytes}.
extern "C" int tfos_flash_budget(int kernel, int D, int bf16, int* out) {
  if (kernel == 0)
    TFOS_FLASH_DISPATCH_WG(dq_budget, dq_wg_budget, bf16, D, out);
  if (kernel == 1)
    TFOS_FLASH_DISPATCH_WG(dkv_budget, dkv_wg_budget, bf16, D, out);
  TFOS_FLASH_DISPATCH_WG(fwd_budget, fwd_wg_budget, bf16, D, out);
}
