// Shared pieces of the flash-attention kernels K2 (flash_fwd.cu) and K3/K4
// (flash_bwd.cu, flash_bwd_tf32.cu): the masked score, dtype codes and the
// bf16 rounding, the K3/K4 arguments and fragment store, cp.async tile
// loads into padded shared memory with bf16 widened after arrival (K2's
// and K3/K4's tf32x3 instances up to D = 256, K2's retired simt one), the
// causal tile predicates, the CTA order and the launch.
//
// Layout: every q/k/v/do/out tensor is the folded (S, N, D) layout, row
// major, N = heads x batch.  A CTA works on one head·batch slice `hb` and
// one tile of rows; it reads its rows with stride N * D.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pa_flash {

// finfo(float32).min / 2, flash_pallas._NEG: a masked score that keeps
// exp(NEG - m) finite (0 for any real running max m).
constexpr float kNeg = -FLT_MAX * 0.5f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Arguments of every K3/K4 kernel (flash_bwd.cu, flash_bwd_tf32.cu).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  int q_dt, k_dt, v_dt, do_dt;
  const float* L;  // (n, sq) logsumexp rows, +inf where l == 0
  const float* D;  // (n, sq) rowsum(dO * O)
  void* g0;        // K3: dq (sq, n, d); K4: dk (skv, n, d)
  void* g1;        // K4: dv (skv, n, d)
  int g_dt;
  int n, sq, skv, d;
  float scale;
  int causal;
  long long q_off, kv_off;
};

// mul·acc, a warp's accumulator fragment of a 16 x N block (rows row0 and
// row0 + 8, columns col0 + 8 j + 2 t (+1) at acc[4 j + 2 h (+1)]: the
// layout of a wgmma m64 fragment and of N / 8 mma.sync m16n8 ones), into
// the (s, n, d) tensor g of dtype dt: rows < s and columns < d only
// (d % 8 == 0, so col < d implies col + 1 < d).
template <int N>
__device__ __forceinline__ void store_frag(void* g, int dt,
                                           const float (&acc)[N / 2],
                                           long long row0, int s, int n,
                                           int hb, int d, int col0, int t,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    if (row >= s) continue;
    const size_t base = ((size_t)row * n + hb) * d;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      if (col >= d) continue;
      const float x0 = acc[4 * j + 2 * h] * mul;
      const float x1 = acc[4 * j + 2 * h + 1] * mul;
      if (dt == kBF16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(g) +
                                           base + col) =
            __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(g) + base + col) =
            make_float2(x0, x1);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;   // log2(e)

// ---------------------------------------------------------------------------
// cp.async tile loads: 16 bytes a thread, into f32 tiles of pitch DMAX + 4
// words (16-byte rows; the rows of a quarter-warp's 16-byte loads on
// distinct banks)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (src-size 0 reads nothing)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of rows [r0, r0 + ROWS) of slice hb of an (s, n, d) tensor
// into dst (pitch DMAX + 4); rows past s and columns past d arrive as
// zeros.  f32 goes in place; bf16 raw into the upper half of each row.
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void start_tile(float* dst, const void* src,
                                           int dt, int n, int hb, int s,
                                           int d, long long r0) {
  constexpr int LD = DMAX + 4;
  const int es = dt == kBF16 ? 2 : 4;   // bytes an element
  const int per = 16 / es;              // elements a 16-byte chunk
  const int ch = DMAX / per;            // chunks a row
  for (int idx = threadIdx.x; idx < ROWS * ch; idx += NT) {
    const int r = idx / ch, c = (idx % ch) * per;
    const long long row = r0 + r;
    const bool valid = row < s && c < d;
    const char* g = static_cast<const char*>(src);
    if (valid) g += (((size_t)row * n + hb) * d + c) * es;
    char* sm = reinterpret_cast<char*>(dst + r * LD);
    cp_async16(sm + (es == 2 ? 2 * DMAX + 16 : 0) + c * es, g, valid);
  }
}

// Widen a landed bf16 tile to f32 in place, a few whole rows a pass: every
// chunk of a pass's rows is read into registers before any is written.
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void widen_tile(float* dst) {
  constexpr int LD = DMAX + 4, CH = DMAX / 8;
  constexpr int RP = (4 * NT / CH) < 1 ? 1
                     : (4 * NT / CH) > ROWS ? ROWS : (4 * NT / CH);
  constexpr int PER = (RP * CH + NT - 1) / NT;
  for (int r0 = 0; r0 < ROWS; r0 += RP) {
    uint4 raw[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, r = r0 + idx / CH;
      if (idx < RP * CH && r < ROWS)
        raw[i] = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const char*>(dst + r * LD) + 2 * DMAX + 16 +
            (idx % CH) * 16);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, r = r0 + idx / CH;
      if (idx < RP * CH && r < ROWS) {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
        float* f = dst + r * LD + (idx % CH) * 8;
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
        *reinterpret_cast<float4*>(f) = make_float4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<float4*>(f + 4) = make_float4(c.x, c.y, e.x, e.y);
      }
    }
    __syncthreads();
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
