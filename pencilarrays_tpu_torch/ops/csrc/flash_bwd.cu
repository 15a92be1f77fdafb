// K3 and K4 — the flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replace the TPU kernels pencilarrays_tpu/ops/flash_pallas.py::
// _flash_bwd_dq_kernel (K3, pallas_call at :589) and _flash_bwd_dkv_kernel
// (K4, pallas_call at :609), both launched by _bwd_folded (:550).  The
// standard two-pass flash backward: every (q tile x key tile) block is
// rebuilt from q, k and the saved per-row logsumexp L = m + log l, never
// stored:
//
//   P = exp(mask(scale · q kᵀ) - L)      dP = dO vᵀ      dS = P ∘ (dP - D)
//   K3:  dQ = scale · Σ_key-tiles dS k          (one CTA per q tile)
//   K4:  dV = Σ_q-tiles Pᵀ dO,  dK = scale · Σ_q-tiles dSᵀ q
//                                                (one CTA per key tile)
//
// with D = rowsum(dO ∘ O) computed by the wrapper.  The TPU kernels carried
// each accumulator in VMEM across a sequential grid dimension; here a loop
// inside the CTA replaces it, so each CTA owns its rows of dQ (K3) or dK/dV
// (K4) outright: no atomics, and the result does not depend on scheduling.
// Both kernels share `rebuild_block`, the TPU kernels' _bwd_common
// (:348-383): the score is masked BEFORE the exp, then the masked entries
// of P are set to 0, so no intermediate inf exists even on rows whose L is
// garbage; padded rows carry L = +inf (P = 0) and D = 0; every operand is
// widened to float32 (:399-402).  Causal tiles wholly above the diagonal
// are skipped by the forward's predicate.
//
// Bound: operations (6·Sq·Skv·D FLOPs per slice for K3, 8·Sq·Skv·D for K4,
// halved when causal), on the CUDA cores in float32 FMA.  This first
// version uses padded shared-memory tiles, no wgmma or TMA.
#include "flash_common.cuh"

namespace pa_flash {

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

// One (BQ x BK) block at q rows r0 and keys c0: P and dS in registers, for
// rows ty + TR*i and keys tx + TC*j.  Ls/Ds hold the tile's L and D rows.
template <class T>
__device__ __forceinline__ void rebuild_block(
    float (&p)[T::BQ / T::TR][T::BK / T::TC],
    float (&ds)[T::BQ / T::TR][T::BK / T::TC], const float* Qs,
    const float* dOs, const float* Ks, const float* Vs, const float* Ls,
    const float* Ds, const BwdArgs& a, long long r0, long long c0, int ty,
    int tx) {
  constexpr int RI = T::BQ / T::TR, CJ = T::BK / T::TC;
  float dp[RI][CJ];
  dot_rows<RI, CJ, T::TR, T::TC, T::DMAX>(p, Qs, Ks, ty, tx);
  dot_rows<RI, CJ, T::TR, T::TC, T::DMAX>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + T::TR * i;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const long long col = c0 + tx + T::TC * j;
      const bool valid =
          col < a.skv && (!a.causal || a.q_off + r0 + r >= a.kv_off + col);
      const float s = valid ? p[i][j] * a.scale : kNeg;
      const float pij = valid ? expf(s - Ls[r]) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - Ds[r]);
    }
  }
}

// K3: one CTA per (slice, q tile), key tiles inner.
template <class T>
__global__ void __launch_bounds__(T::NT) flash_dq_kernel(BwdArgs a) {
  constexpr int BQ = T::BQ, BK = T::BK, DMAX = T::DMAX, TR = T::TR,
                TC = T::TC, NT = T::NT, LD = T::LD, LS = T::LS;
  constexpr int RI = BQ / TR, CJ = BK / TC, DJ = DMAX / TC;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* DSs = Vs + BK * LD;
  float* Ls = DSs + BQ * LS;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, ty = tid / TC, tx = tid % TC;
  const int hb = blockIdx.y;
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * BQ;
  load_tile<BQ, DMAX, NT>(Qs, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);
  load_tile<BQ, DMAX, NT>(dOs, a.dout, a.do_dt, a.n, hb, a.sq, a.d, r0);
  load_rows<BQ, NT>(Ls, a.L, hb, a.sq, r0, INFINITY);
  load_rows<BQ, NT>(Ds, a.D, hb, a.sq, r0, 0.f);

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  const int nk = (a.skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const long long c0 = (long long)kt * BK;
    if (!tile_visible(a.causal, a.q_off, r0, BQ, a.kv_off, c0)) break;
    __syncthreads();
    load_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, c0);
    load_tile<BK, DMAX, NT>(Vs, a.v, a.v_dt, a.n, hb, a.skv, a.d, c0);
    __syncthreads();
    float p[RI][CJ], ds[RI][CJ];
    rebuild_block<T>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, a, r0, c0, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        DSs[(ty + TR * i) * LS + tx + TC * j] = ds[i][j];
    __syncthreads();
    acc_rows<RI, DJ, TR, TC, BK, LS, LD, false>(acc, DSs, Ks, ty, tx, 0);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long row = r0 + ty + TR * i;
    if (row >= a.sq) continue;
    const size_t base = ((size_t)row * a.n + hb) * a.d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + TC * j;
      if (col < a.d) store_elem(a.g0, base + col, acc[i][j] * a.scale, a.g_dt);
    }
  }
}

// K4: one CTA per (slice, key tile, DCOL columns of dk/dv), q tiles inner.
template <class T>
__global__ void __launch_bounds__(T::NT) flash_dkv_kernel(BwdArgs a) {
  constexpr int BQ = T::BQ, BK = T::BK, DMAX = T::DMAX, DCOL = T::DCOL,
                TR = T::TR, TC = T::TC, NT = T::NT, LD = T::LD, LS = T::LS;
  constexpr int RK = BK / TR, DJ = DCOL / TC;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* DSs = Ps + BQ * LS;
  float* Ls = DSs + BQ * LS;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, ty = tid / TC, tx = tid % TC;
  const int hb = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * BK;
  const int col0 = blockIdx.z * DCOL;
  load_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, c0);
  load_tile<BK, DMAX, NT>(Vs, a.v, a.v_dt, a.n, hb, a.skv, a.d, c0);

  float dk[RK][DJ], dv[RK][DJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int nq = (a.sq + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const long long r0 = (long long)qt * BQ;
    if (!tile_visible(a.causal, a.q_off, r0, BQ, a.kv_off, c0)) continue;
    __syncthreads();
    load_tile<BQ, DMAX, NT>(Qs, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);
    load_tile<BQ, DMAX, NT>(dOs, a.dout, a.do_dt, a.n, hb, a.sq, a.d, r0);
    load_rows<BQ, NT>(Ls, a.L, hb, a.sq, r0, INFINITY);
    load_rows<BQ, NT>(Ds, a.D, hb, a.sq, r0, 0.f);
    __syncthreads();
    constexpr int RI = BQ / TR, CJ = BK / TC;
    float p[RI][CJ], ds[RI][CJ];
    rebuild_block<T>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, a, r0, c0, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int at = (ty + TR * i) * LS + tx + TC * j;
        Ps[at] = p[i][j];
        DSs[at] = ds[i][j];
      }
    __syncthreads();
    // rows of dk/dv are keys: read P and dS transposed
    acc_rows<RK, DJ, TR, TC, BQ, LS, LD, true>(dv, Ps, dOs, ty, tx, col0);
    acc_rows<RK, DJ, TR, TC, BQ, LS, LD, true>(dk, DSs, Qs, ty, tx, col0);
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const long long row = c0 + ty + TR * i;
    if (row >= a.skv) continue;
    const size_t base = ((size_t)row * a.n + hb) * a.d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = col0 + tx + TC * j;
      if (col >= a.d) continue;
      store_elem(a.g0, base + col, dk[i][j] * a.scale, a.g_dt);
      store_elem(a.g1, base + col, dv[i][j], a.g_dt);
    }
  }
}

// K3 tiles (BQ, BK) by head dim; shared = (2·BQ + 2·BK)·(DMAX + 1)·4 +
// BQ·(BK + 1)·4 + 2·BQ·4 bytes:
//   DMAX   64: 64 x 64  ( 83.7 KB)      DMAX 512:  16 x 16 (132.4 KB)
//   DMAX  128: 64 x 32  (107.9 KB)      DMAX 1024:  8 x 16 (197.4 KB)
//   DMAX  256: 32 x 16  (101.1 KB)
template <class T>
int run_dq(const BwdArgs& a, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)(2 * T::BQ + 2 * T::BK) *
                                           T::LD +
                                       T::BQ * T::LS + 2 * T::BQ);
  dim3 grid((a.sq + T::BQ - 1) / T::BQ, a.n);
  return launch(flash_dq_kernel<T>, grid, T::NT, smem, stream, a);
}

// K4 tiles (BQ, BK, DCOL) by head dim; shared = (2·BQ + 2·BK)·(DMAX + 1)·4
// + 2·BQ·(BK + 1)·4 + 2·BQ·4 bytes; DCOL < DMAX splits dk/dv's columns
// over gridDim.z (each CTA recomputes P and dS) to keep the two
// accumulators at 64 registers:
//   DMAX   64: 64 x 64, 64  (100.4 KB)  DMAX 512:  8 x 16, 256 ( 99.6 KB)
//   DMAX  128: 32 x 32, 128 ( 74.8 KB)  DMAX 1024: 8 x 16, 256 (197.9 KB)
//   DMAX  256: 32 x 16, 256 (103.3 KB)
template <class T>
int run_dkv(const BwdArgs& a, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)(2 * T::BQ + 2 * T::BK) *
                                           T::LD +
                                       2 * T::BQ * T::LS + 2 * T::BQ);
  dim3 grid((a.skv + T::BK - 1) / T::BK, a.n, T::DMAX / T::DCOL);
  return launch(flash_dkv_kernel<T>, grid, T::NT, smem, stream, a);
}

}  // namespace pa_flash

extern "C" int pa_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, int q_dt, int k_dt, int v_dt,
                               int do_dt, const float* L, const float* D,
                               void* dq, int dq_dt, int n, int sq, int skv,
                               int d, float scale, int causal, long long q_off,
                               long long kv_off, void* stream) {
  using namespace pa_flash;
  const BwdArgs a{q,     k,       v,    dout, q_dt, k_dt,  v_dt,
                  do_dt, L,       D,    dq,   nullptr, dq_dt, n,
                  sq,    skv,     d,    scale, causal, q_off, kv_off};
  if (d <= 64) return run_dq<Tiles<64, 64, 64>>(a, stream);
  if (d <= 128) return run_dq<Tiles<64, 32, 128>>(a, stream);
  if (d <= 256) return run_dq<Tiles<32, 16, 256>>(a, stream);
  if (d <= 512) return run_dq<Tiles<16, 16, 512>>(a, stream);
  if (d <= 1024) return run_dq<Tiles<8, 16, 1024>>(a, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, int q_dt, int k_dt,
                                int v_dt, int do_dt, const float* L,
                                const float* D, void* dk, void* dv,
                                int dkv_dt, int n, int sq, int skv, int d,
                                float scale, int causal, long long q_off,
                                long long kv_off, void* stream) {
  using namespace pa_flash;
  const BwdArgs a{q,     k,   v,   dout, q_dt,   k_dt,  v_dt,  do_dt,
                  L,     D,   dk,  dv,   dkv_dt, n,     sq,    skv,
                  d,     scale, causal, q_off, kv_off};
  if (d <= 64) return run_dkv<Tiles<64, 64, 64>>(a, stream);
  if (d <= 128) return run_dkv<Tiles<32, 32, 128>>(a, stream);
  if (d <= 256) return run_dkv<Tiles<32, 16, 256>>(a, stream);
  if (d <= 512) return run_dkv<Tiles<8, 16, 512, 256>>(a, stream);
  if (d <= 1024) return run_dkv<Tiles<8, 16, 1024, 256>>(a, stream);
  return (int)cudaErrorInvalidValue;
}
