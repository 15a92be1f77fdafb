// K2 — forward flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel pencilarrays_tpu/ops/flash_pallas.py::_flash_kernel
// (launched by pallas_flash_attention, pallas_call at :287).  One CTA per
// (head·batch slice, q tile).  The TPU kernel carried the online-softmax
// state (running max m, denominator l, f32 accumulator) in VMEM across the
// sequential key-block grid dimension; here a loop over key tiles inside
// the CTA takes that dimension's place, m and l live in registers of the
// TC threads that own a row, and the accumulator in registers.
//
// Bound: operations.  4·Sq·Skv·D FLOPs per slice (halved when causal) over
// q/k/v reads of (Sq + 2·Skv)·D elements; at S = 4096, D = 128 that is
// ~1000 FLOPs per byte, far above the card's balance point.  float32
// inputs run on the CUDA cores with float32 FMA (no TF32); bfloat16 inputs
// are widened to float32 in shared memory and use the same FMA path.  This
// first version keeps tiles in padded shared memory and does not use
// wgmma or TMA.
//
// Conventions kept from the TPU kernel: masked scores are NEG =
// finfo(f32).min / 2; the key tail is masked by position; the causal mask
// is start-aligned by global position with per-call q/kv offsets; key
// tiles wholly above the diagonal are skipped (the loop ends there, since
// the predicate only gets harder as keys advance); l == 0 -> 1 in the
// final division; for bf16 v the probabilities are rounded to bf16 before
// P·V (the denominator sums them unrounded).
//
// Outputs, each optional (null pointer = not written): `out` = acc / l in
// out_dt, folded (Sq, N, D); `acc` = raw f32 accumulator (Sq, N, D);
// `m`, `l` = f32 row statistics (N, Sq).
#include "flash_common.cuh"

namespace pa_flash {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  int q_dt, k_dt, v_dt;
  void* out;
  int out_dt;
  float* acc;
  float* m;
  float* l;
  int n, sq, skv, d;
  float scale;
  int causal;
  long long q_off, kv_off;
};

template <int TC>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TC>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <class T>
__global__ void __launch_bounds__(T::NT) flash_fwd_kernel(FwdArgs a) {
  constexpr int BQ = T::BQ, BK = T::BK, DMAX = T::DMAX, TR = T::TR,
                TC = T::TC, NT = T::NT, LD = T::LD, LS = T::LS;
  constexpr int RI = BQ / TR;    // q rows per thread
  constexpr int CJ = BK / TC;    // keys per thread
  constexpr int DJ = DMAX / TC;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x, ty = tid / TC, tx = tid % TC;
  const int hb = blockIdx.y;
  // the last q tiles see the most keys under a causal mask: start them first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * BQ;
  load_tile<BQ, DMAX, NT>(Qs, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const bool round_p = a.v_dt == kBF16;
  const int nk = (a.skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const long long c0 = (long long)kt * BK;
    if (!tile_visible(a.causal, a.q_off, r0, BQ, a.kv_off, c0)) break;
    __syncthreads();  // the previous tile's readers are done
    load_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, c0);
    load_tile<BK, DMAX, NT>(Vs, a.v, a.v_dt, a.n, hb, a.skv, a.d, c0);
    __syncthreads();

    float s[RI][CJ];
    dot_rows<RI, CJ, TR, TC, DMAX>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TR * i;
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const long long col = c0 + tx + TC * j;
        const bool valid =
            col < a.skv && (!a.causal || a.q_off + r0 + r >= a.kv_off + col);
        s[i][j] = valid ? s[i][j] * a.scale : kNeg;
        bm = fmaxf(bm, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max<TC>(bm));
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        Ps[r * LS + tx + TC * j] = round_p ? round_bf16(p) : p;
      }
      l[i] = l[i] * corr + row_sum<TC>(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    acc_rows<RI, DJ, TR, TC, BK, LS, LD, false>(acc, Ps, Vs, ty, tx, 0);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long row = r0 + ty + TR * i;
    if (row >= a.sq) continue;
    const size_t base = ((size_t)row * a.n + hb) * a.d;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + TC * j;
      if (col >= a.d) continue;
      if (a.out) store_elem(a.out, base + col, acc[i][j] / den, a.out_dt);
      if (a.acc) a.acc[base + col] = acc[i][j];
    }
    if (a.m && tx == 0) {
      a.m[(size_t)hb * a.sq + row] = m[i];
      a.l[(size_t)hb * a.sq + row] = l[i];
    }
  }
}

// Tiles by head dim (BQ, BK), all within the 227 KB a CTA may use:
// shared = (BQ + 2·BK)·(DMAX + 1)·4 + BQ·(BK + 1)·4 bytes.
//   DMAX   64: 64 x 64  ( 66.6 KB)      DMAX 512:  16 x 16 ( 99.6 KB)
//   DMAX  128: 64 x 32  ( 74.5 KB)      DMAX 1024:  8 x 16 (164.5 KB)
//   DMAX  256: 32 x 32  (103.0 KB)
template <class T>
int run(const FwdArgs& a, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(T::BQ + 2 * T::BK) * T::LD + T::BQ * T::LS);
  dim3 grid((a.sq + T::BQ - 1) / T::BQ, a.n);
  return launch(flash_fwd_kernel<T>, grid, T::NT, smem, stream, a);
}

}  // namespace pa_flash

extern "C" int pa_flash_fwd(const void* q, const void* k, const void* v,
                            int q_dt, int k_dt, int v_dt, void* out,
                            int out_dt, float* acc, float* m, float* l, int n,
                            int sq, int skv, int d, float scale, int causal,
                            long long q_off, long long kv_off, void* stream) {
  using namespace pa_flash;
  const FwdArgs a{q,  k,  v,   q_dt, k_dt,  v_dt,   out,   out_dt, acc,
                  m,  l,  n,   sq,   skv,   d,      scale, causal, q_off,
                  kv_off};
  if (d <= 64) return run<Tiles<64, 64, 64>>(a, stream);
  if (d <= 128) return run<Tiles<64, 32, 128>>(a, stream);
  if (d <= 256) return run<Tiles<32, 32, 256>>(a, stream);
  if (d <= 512) return run<Tiles<16, 16, 512>>(a, stream);
  if (d <= 1024) return run<Tiles<8, 16, 1024>>(a, stream);
  return (int)cudaErrorInvalidValue;
}
