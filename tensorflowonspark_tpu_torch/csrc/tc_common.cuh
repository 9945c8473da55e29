// Tensor-core building blocks shared by the port's kernels
// (flash_attention.cu, paged_attention.cu): the 3xTF32 split, mma.sync
// m16n8k8 TF32 with its fragment loads from swizzled shared-memory tiles,
// and the cp.async copies that fill those tiles. Each source is compiled
// on its own and includes this header; everything here has internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// x = hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero) in two integer operations; lo = x - hi is
// exact in float32, and the tensor core reads its TF32 part (an mma on
// .tf32 operands ignores the low 13 bits of each register)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// an input element's TF32 parts: a bfloat16 value is exact in TF32
template <typename T>
__device__ __forceinline__ void parts(float x, uint32_t& hi, uint32_t& lo) {
  if (is_f32<T>()) {
    split(x, hi, lo);
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// 2^x (ex2.approx: 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// c += a b on the tensor cores, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Element (r, c) of a shared-memory tile with rows of D elements: the
// 16-byte chunks of row r are XOR-swizzled (by fewer bits where a row has
// fewer than 8 chunks). bfloat16: chunk c ^ (r % 8). float32: chunk
// c ^ 2 ((r % 4) ^ (r / 4 % 2)), which keeps both the 8-byte pair reads of
// load_a / load_b_rows (a half warp over 4 rows x 2 chunks) and the
// 4-byte reads of load_b_cols (4 even or 4 odd rows x 2 chunks) on
// distinct banks.
template <typename T, int D>
__device__ __forceinline__ int sw(int r, int c) {
  constexpr int E = 16 / sizeof(T);
  constexpr int NC = D / E;
  constexpr int M = NC < 8 ? NC - 1 : 7;
  const int f = is_f32<T>() ? 2 * ((r & 3) ^ ((r >> 2) & 1)) : r & 7;
  return r * D + (((c / E) ^ (f & M)) * E) + c % E;
}

template <typename T, int D>
__device__ __forceinline__ float at(const T* s, int r, int c) {
  return to_f(s[sw<T, D>(r, c)]);
}

// elements (r, c) and (r, c + 1) of a tile, c even: one 8-byte (float32)
// or 4-byte (bfloat16) read
template <int D>
__device__ __forceinline__ float2 at2(const float* s, int r, int c) {
  return *reinterpret_cast<const float2*>(s + sw<float, D>(r, c));
}
template <int D>
__device__ __forceinline__ float2 at2(const __nv_bfloat16* s, int r, int c) {
  const int e = sw<__nv_bfloat16, D>(r, c);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + e));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fragment layouts of mma.m16n8k8 (PTX ISA; lane = 4 g + t):
//   A 16 x 8:  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8:   b0 (k t, n g), b1 (k t + 4, n g)
//   C 16 x 8:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A sum over k may take its 8 terms in any order that A and B share.
// Every k step here puts k slot t at column 2t and slot t + 4 at column
// 2t + 1 of its 8: then a lane's two slots are adjacent elements of a
// shared-memory row (one read), and a C fragment is already an A.

// A = tile rows r0..r0 + 15, columns k0..k0 + 7
template <typename T, int D>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const T* s, int r0, int k0, int g, int t) {
  const float2 x = at2<D>(s, r0 + g, k0 + 2 * t);
  const float2 y = at2<D>(s, r0 + g + 8, k0 + 2 * t);
  parts<T>(x.x, hi[0], lo[0]);
  parts<T>(y.x, hi[1], lo[1]);
  parts<T>(x.y, hi[2], lo[2]);
  parts<T>(y.y, hi[3], lo[3]);
}

// B(k, n) = tile[n0 + n][k0 + k]: the tile's rows are B's columns (K^T)
template <typename T, int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                            const T* s, int n0, int k0, int g,
                                            int t) {
  const float2 x = at2<D>(s, n0 + g, k0 + 2 * t);
  parts<T>(x.x, hi[0], lo[0]);
  parts<T>(x.y, hi[1], lo[1]);
}

// B(k, n) = tile[k0 + k][n0 + n]: slot t is row k0 + 2t, slot t + 4 row
// k0 + 2t + 1
template <typename T, int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                            const T* s, int k0, int n0, int g,
                                            int t) {
  parts<T>(at<T, D>(s, k0 + 2 * t, n0 + g), hi[0], lo[0]);
  parts<T>(at<T, D>(s, k0 + 2 * t + 1, n0 + g), hi[1], lo[1]);
}

// The A fragment whose k is the 8 columns of a C fragment of the same 16
// rows, with no data moved between lanes. Split 3xTF32.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// c[j] += A B[j] for j in [j_lo, j_hi) to float32 accuracy (3xTF32),
// pass by pass: lo.hi, hi.lo, then hi.hi over every j, so that
// back-to-back mmas never wait on each other; a pass whose lo part is
// exactly 0 (a bfloat16 operand) is dropped
template <bool ALO, bool BLO, int NJ>
__device__ __forceinline__ void mma3_rows(float (&c)[NJ][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[NJ][2],
                                          const uint32_t (&bl)[NJ][2], int j_lo,
                                          int j_hi) {
  if (ALO) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j >= j_lo && j < j_hi) mma_tf32(c[j], al, bh[j]);
  }
  if (BLO) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j >= j_lo && j < j_hi) mma_tf32(c[j], ah, bl[j]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j >= j_lo && j < j_hi) mma_tf32(c[j], ah, bh[j]);
}

// c[j] = A B^T for 8-row blocks j in [j_lo, j_hi) of tile B: A rows
// r0..r0 + 15 of tile A, both tiles' columns (D of them) the contraction
template <typename T, int D, int NT>
__device__ __forceinline__ void rows_by_rows(float (&c)[NT][4], const T* A,
                                             const T* B, int r0, int j_lo,
                                             int j_hi, int g, int t) {
  constexpr bool F32 = is_f32<T>();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    load_a<T, D>(ah, al, A, r0, 8 * ks, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j >= j_lo && j < j_hi)
        load_b_rows<T, D>(bh[j], bl[j], B, 8 * j, 8 * ks, g, t);
    mma3_rows<F32, F32>(c, ah, al, bh, bl, j_lo, j_hi);
  }
}

// c[n] += A B[n] for every 8-column block n of the D columns of tile B,
// whose rows k0..k0 + 7 are the contraction (A from a C fragment; ALO
// false: A is exact in TF32, its lo pass is dropped)
template <typename T, int D, bool ALO = true>
__device__ __forceinline__ void a_by_cols(float (&c)[D / 8][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const T* B,
                                          int k0, int g, int t) {
  uint32_t bh[D / 8][2], bl[D / 8][2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    load_b_cols<T, D>(bh[n], bl[n], B, k0, 8 * n, g, t);
  mma3_rows<ALO, is_f32<T>()>(c, ah, al, bh, bl, 0, D / 8);
}

template <int NI>
__device__ __forceinline__ void zero4(float (&c)[NI][4]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

}  // namespace
