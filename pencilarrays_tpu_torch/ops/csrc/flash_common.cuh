// Shared pieces of the flash-attention kernels K2 (flash_fwd.cu) and K3/K4
// (flash_bwd.cu): element access in float32 or bfloat16, tile loads into
// padded shared memory, and the two small tile products every kernel is
// built from.
//
// Layout: every q/k/v/do/out tensor is the folded (S, N, D) layout, row
// major, N = heads x batch.  A CTA works on one head·batch slice `hb` and
// one tile of rows; it reads its rows with stride N * D.  Tiles live in
// shared memory as float32 with a row pitch of DMAX + 1 words: the odd
// pitch puts the rows of a column on distinct banks, and the columns
// d..DMAX-1 hold zeros, so a product over DMAX equals one over d.
//
// Thread layout: NT = TR x TC threads, thread (ty, tx) = (t / TC, t % TC).
// A thread owns rows ty + TR*i and columns tx + TC*j of a tile (strided, so
// neighbouring threads read neighbouring columns); the TC threads of a row
// sit in one half-warp, so a row reduction is a shuffle over TC lanes.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pa_flash {

// finfo(float32).min / 2, flash_pallas._NEG: a masked score that keeps
// exp(NEG - m) finite (0 for any real running max m).
constexpr float kNeg = -FLT_MAX * 0.5f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_elem(const void* p, size_t i, int dt) {
  return dt == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_elem(void* p, size_t i, float x,
                                           int dt) {
  if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + ROWS) of slice hb of an (s, n, d) tensor into dst
// (pitch DMAX + 1); rows past s and columns past d are zero.
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          int dt, int n, int hb, int s,
                                          int d, long long r0) {
  constexpr int LD = DMAX + 1;
  for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += NT) {
    const int r = idx / DMAX, c = idx % DMAX;
    const long long row = r0 + r;
    float x = 0.f;
    if (row < s && c < d)
      x = load_elem(src, ((size_t)row * n + hb) * d + c, dt);
    dst[r * LD + c] = x;
  }
}

// Entries [r0, r0 + ROWS) of row hb of an (n, s) float32 array; `pad`
// past s.
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int hb, int s, long long r0,
                                          float pad) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const long long row = r0 + r;
    dst[r] = row < s ? src[(size_t)hb * s + row] : pad;
  }
}

// out[i][j] = sum_x A[(ty + TR*i) * LD + x] * B[(tx + TC*j) * LD + x],
// x < DMAX: a (rows x cols) block of A·Bᵀ, both operands row tiles.
template <int RI, int CJ, int TR, int TC, int DMAX>
__device__ __forceinline__ void dot_rows(float (&out)[RI][CJ],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = DMAX + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int x = 0; x < DMAX; ++x) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + TR * i) * LD + x];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[(tx + TC * j) * LD + x];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// acc[i][j] += sum_{x < X} A(ty + TR*i, x) * B[x * LD + col0 + tx + TC*j],
// with A(r, x) = A[r * LA + x], or A[x * LA + r] when A_T (A read
// transposed).  The (P·V, dS·K, Pᵀ·dO, dSᵀ·Q) products.
template <int RI, int DJ, int TR, int TC, int X, int LA, int LD, bool A_T>
__device__ __forceinline__ void acc_rows(float (&acc)[RI][DJ],
                                         const float* A, const float* B,
                                         int ty, int tx, int col0) {
#pragma unroll 2
  for (int x = 0; x < X; ++x) {
    float a[RI], b[DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TR * i;
      a[i] = A_T ? A[x * LA + r] : A[r * LA + x];
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) b[j] = B[x * LD + col0 + tx + TC * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Whether a (BQ x BK) tile at rows r0 / keys c0 holds a visible key under
// the start-aligned causal mask (flash_pallas.py:148-157): its last row
// must reach its first key.
__device__ __forceinline__ bool tile_visible(int causal, long long q_off,
                                             long long r0, int bq,
                                             long long kv_off,
                                             long long c0) {
  return !causal || q_off + r0 + bq - 1 >= kv_off + c0;
}

// Key tiles of BK a CTA at q rows [r0, r0 + bq) visits: all of them, or
// under the causal mask those up to the last one tile_visible admits (the
// loop ends there: the predicate only gets harder as keys advance).
__device__ __forceinline__ int visible_tiles(int skv, int causal,
                                             long long q_off,
                                             long long kv_off, long long r0,
                                             int bq, int bk) {
  const int all = (skv + bk - 1) / bk;
  if (!causal) return all;
  const long long lim = q_off + r0 + bq - 1 - kv_off;
  if (lim < 0) return 0;
  return (int)min((long long)all, lim / bk + 1);
}

// The (q tile, head·batch slice) of a CTA of a grid (q tiles, n).  CTAs
// start in the order of their linear index: the last q tiles of every
// slice, which see the most keys under a causal mask, go first, so the
// short ones fill in last.
__device__ __forceinline__ void cta_tile(int n, int bq, long long& r0,
                                         int& hb) {
  const long long lin = blockIdx.x + (long long)blockIdx.y * gridDim.x;
  hb = (int)(lin % n);
  r0 = (gridDim.x - 1 - lin / n) * bq;
}

// Tile sizes of one kernel instance (see the per-kernel tables).
template <int BQ_, int BK_, int DMAX_, int DCOL_ = DMAX_>
struct Tiles {
  static constexpr int BQ = BQ_, BK = BK_, DMAX = DMAX_, DCOL = DCOL_;
  static constexpr int TR = 8, TC = 16, NT = TR * TC;
  static constexpr int LD = DMAX + 1, LS = BK + 1;
  static_assert(BQ % TR == 0 && BK % TC == 0 && BK % TR == 0, "tiles");
  static_assert(DMAX % TC == 0 && DCOL % TC == 0 && DMAX % DCOL == 0,
                "head-dim tiles");
};

// Launch `kernel` with `smem` bytes of dynamic shared memory (opting in
// above 48 KB) and return the launch's error code.
template <typename Kernel, typename Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                  void* stream, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace pa_flash
