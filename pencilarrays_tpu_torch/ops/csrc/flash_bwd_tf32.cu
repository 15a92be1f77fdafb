// K3 and K4, tf32x3 instance: the flash-attention backward on Hopper's
// tensor cores at float32 accuracy (sm_90a, mma.sync), for every call with
// a float32 operand, D <= 1024 (ops/flash.py::bwd_instance); above 256 by
// the wide kernels at the end of this file.
//
// Replaces, as flash_bwd.cu's wgmma instance does, the TPU kernels
// pencilarrays_tpu/ops/flash_pallas.py::_flash_bwd_dq_kernel (K3,
// pallas_call at :589) and _flash_bwd_dkv_kernel (K4, :609), computing
// every operand in f32 as the TPU kernels do (:399-402), with the
// conventions of flash_bwd.cu's header: masked before the exp, masked
// P = 0; L = +inf and D = 0 on padded rows; a start-aligned causal mask
// with per-call offsets; tiles wholly above the diagonal skipped; every
// output row owned by one CTA (no atomics); rows >= S and columns >= D
// never written; grads in g_dt.
//
// Bound: operations.  K3 does 6·Sq·Skv·D FLOPs a slice and K4 8·Sq·Skv·D
// (halved when causal), ~1000 FLOPs a byte at S = 4096, D = 128.  The CUDA
// cores give 67 TFLOP/s in f32, the tensor cores 495 TFLOP/s in TF32, whose
// 10-bit mantissa alone misses the f32 tolerance.  So each f32 product is
// three TF32 ones (3xTF32, as CUTLASS's OpMultiplyAddFastF32): x = big +
// small with big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
// a·b = big_a·big_b + big_a·small_b + small_a·big_b accumulated in f32 (the
// dropped small·small term is at most 2^-24 of the product): a ceiling of
// 495 / 3 = 165 TFLOP/s of f32 work.
//
// Design:
// * mma.sync m16n8k8 TF32, not wgmma: the threads load the fragments from
//   f32 tiles, so the split costs no shared memory and an operand may be
//   read in either orientation (wgmma's TF32 form takes both shared
//   operands K-major only, which dS·K, Pᵀ·dO and dSᵀ·Q are not).
// * A warp owns 16 rows of the CTA's resident tile (K3: q rows; K4: keys)
//   against every row of the streamed tile, so its score blocks (K3: S and
//   dP; K4: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, keys on the fragment rows, L and D
//   read per column) stay in registers.  The m16n8 accumulator (rows g,
//   g + 8; columns 2t, 2t + 1 of each 8-column step) is the k8 A fragment
//   of the next product (columns t, t + 4) once A's k slots t and t + 4
//   stand for the keys (K4: q rows) 2t and 2t + 1 and B's rows are read in
//   that order: dQ += dS·K (K3), dV += Pᵀ·dO and dK += dSᵀ·Q (K4).  P and
//   dS never touch shared memory.
// * Feeding: 16-byte cp.async copies into f32 tiles of pitch DMAX + 4
//   words, bf16 operands of a mix landed raw and widened in place
//   (flash_common.cuh).  The streamed pair (K3: K and V tiles; K4: Q and dO
//   tiles with their L and D rows) goes through a two-stage ring: the copy
//   of tile i + 1 flies while tile i is computed.  A pitch of 4 mod 32
//   words puts every fragment load of a warp on 32 distinct banks: row
//   loads at g·pitch + t (bank 4g + t), the permuted B loads at
//   2t·pitch + g (bank 8t + g).
// * Sums: the tensor cores round their f32 accumulation toward zero, so a
//   sum carried in one accumulator over a whole sequence drifts.  Each
//   key (K4: q) tile's products go to a fresh accumulator that an f32 add
//   moves into dQ (dK, dV), and the score blocks sum D in 32-column chunks.
// * Causal: K3 ends its key loop at the last visible tile and K4 starts
//   its q loop at the first; a warp whose 16 rows see nothing of a tile
//   skips its products; only tiles that cross the diagonal or the key tail
//   are masked; CTAs start longest-first.
// * Above D = 256 (the wide kernels): f32 rows of pitch DMAX + 4 do not
//   fit (K4's K and V tiles of 64 keys at D = 512 are 264 KB; a block gets
//   227 KB) and a warp's accumulators of 16 rows x D do not either.  So
//   nothing is resident: thread 0 streams every operand through one ring
//   of TMA boxes (32 f32 columns, 128-byte swizzle, read back by the
//   fragment loads through the same XOR), the score products reduce over
//   D one 32-column box at a time (the chunks above), and the output
//   columns are split as in flash_bwd.cu's wide kernels: between two
//   groups of four warps over the same 64 rows (K3: S and P in group 0,
//   dP in group 1, swapped through shared memory, dQ over 256 columns
//   each; K4: group 0 Sᵀ, Pᵀ and dV, group 1 dPᵀ and dK), and between CTAs
//   where 512 (K3) or 256 (K4) columns do not cover D.  FLOPs executed
//   per (q row, key) pair as there: K3 6·D up to D = 512 and 10·D at
//   1024, K4 12·D at 512 and 20·D at 1024, against the bound's 6·D and
//   8·D.  TMA takes the loads off the warps that multiply: fed by their
//   own cp.async copies (every tile re-reads its Q and dO), the loads and
//   the products ran one after the other, 1.7x the TMA-fed time at
//   D = 512 (PERF.md).  TMA copies bytes as they are, so these kernels
//   read f32 operands only: ops/flash.py widens a bf16 operand of a mix
//   first.  The 3xTF32 split, the box products and the wide tiles are in
//   flash_wide.cuh, which K2's wide tf32x3 kernel uses too.
#include "flash_wide.cuh"

namespace pa_flash {

// out (16 x 8·NJ; n-tile j at out[4 j ..]) += A·Bᵀ over k in [k0, k1): A
// the 16 rows at As, B the 8·NJ rows at Bs, both f32 tiles of pitch LD.
// Lane (g, t) reads A at rows g and g + 8 and B at row 8 j + g, each at
// columns t and t + 4 of every 8-column step.
template <int NJ, int LD, int K0, int K1>
__device__ __forceinline__ void score_steps(float (&out)[4 * NJ],
                                            const float* As, const float* Bs,
                                            int g, int t) {
  const float* a = As + g * LD + t;
  const float* b = Bs + g * LD + t;
#pragma unroll 2
  for (int k = K0; k < K1; k += 8) {
    uint32_t ab[4], as[4];
    split(a[k], ab[0], as[0]);
    split(a[8 * LD + k], ab[1], as[1]);
    split(a[k + 4], ab[2], as[2]);
    split(a[8 * LD + k + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb0, bs0, bb1, bs1;
      split(b[8 * j * LD + k], bb0, bs0);
      split(b[8 * j * LD + k + 4], bb1, bs1);
      mma3(out, j, ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// out (16 x 8·NJ) = A·Bᵀ over DMAX (see score_steps), 32 columns a chunk:
// each chunk's products go to a fresh accumulator that one f32 add (round
// to nearest) moves into out, so the tensor cores' accumulation, which
// rounds toward zero, never runs over more than 32 terms.
template <int NJ, int DMAX>
__device__ __forceinline__ void score_block(float (&out)[4 * NJ],
                                            const float* As, const float* Bs,
                                            int g, int t) {
  constexpr int LD = DMAX + 4, CH = 32;
#pragma unroll
  for (int i = 0; i < 4 * NJ; ++i) out[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DMAX; k0 += CH) {
    float part[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) part[i] = 0.f;
    score_steps<NJ, LD, 0, CH>(part, As + k0, Bs + k0, g, t);
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) out[i] += part[i];
  }
}

// acc (16 x 8·NC; n-tile c at acc[4 c ..]) += X·B: X (16 x 8·NK) a score
// block's accumulator fragment (n-tile j at x[4 j ..]) as the A operand,
// whose k slots t and t + 4 of step j are its columns 8 j + 2 t and
// 8 j + 2 t + 1; B the rows 8 j + 2 t (+ 1) of the tile at Bs (pitch LD),
// columns col0 + 8 c + g.  Each n-tile's products over the block go to a
// fresh accumulator that one f32 add (round to nearest) then moves into
// acc: the tensor cores' accumulation, which rounds toward zero, never
// runs over more than the block's 8·NK terms of a sum whose length is the
// sequence.
template <int NK, int NC, int LD>
__device__ __forceinline__ void acc_block(float (&acc)[4 * NC],
                                          const float (&x)[4 * NK],
                                          const float* Bs, int col0, int g,
                                          int t) {
  uint32_t ab[NK][4], as[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    split(x[4 * j], ab[j][0], as[j][0]);      // (g, 2t)      -> (g, t)
    split(x[4 * j + 2], ab[j][1], as[j][1]);  // (g + 8, 2t)  -> (g + 8, t)
    split(x[4 * j + 1], ab[j][2], as[j][2]);  // (g, 2t + 1)  -> (g, t + 4)
    split(x[4 * j + 3], ab[j][3], as[j][3]);  // (g + 8, 2t + 1)
  }
  const float* b = Bs + 2 * t * LD + col0 + g;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t bb0, bs0, bb1, bs1;
      split(b[8 * j * LD + 8 * c], bb0, bs0);
      split(b[(8 * j + 1) * LD + 8 * c], bb1, bs1);
      mma3(part, 0, ab[j], as[j], bb0, bb1, bs0, bs1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * c + i] += part[i];
  }
}

// 4 bytes by cp.async (K4's L and D rows, which need not sit on 16 bytes).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Tiles of one head-dim class: a CTA of NW = RES / 16 warps keeps RES rows
// of its resident pair (K3: Q, dO; K4: K, V) and streams STR rows of the
// other pair (K3: K, V; K4: Q, dO and STR floats each of L and D) through
// two stages; it writes DCOL output columns (gridDim.z = DMAX / DCOL).
template <int DMAX_, int RES_, int STR_, int DCOL_ = DMAX_>
struct Tf32Tiles {
  static constexpr int DMAX = DMAX_, RES = RES_, STR = STR_, DCOL = DCOL_;
  static constexpr int LD = DMAX + 4, NT = 32 * (RES / 16);
  static constexpr size_t SMEM_DQ =
      sizeof(float) * (size_t)(2 * RES + 4 * STR) * LD;
  static constexpr size_t SMEM_DKV = SMEM_DQ + sizeof(float) * 4 * STR;
  static_assert(RES % 16 == 0 && STR % 8 == 0 && DMAX % DCOL == 0 &&
                    DCOL % 8 == 0,
                "tiles");
  static_assert(SMEM_DKV <= 232448, "shared memory");
};

// K3: one CTA per (q tile, slice), key tiles inner; warp w owns q rows
// [16 w, 16 w + 16) of the tile.
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dq_tf32x3_kernel(BwdArgs a) {
  constexpr int BQ = T::RES, BK = T::STR, DMAX = T::DMAX, LD = T::LD,
                NT = T::NT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;   // stage st at st * BK * LD
  float* Vs = Ks + 2 * BK * LD;

  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, BQ, BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
  const long long rw = r0 + 16 * warp;   // the warp's first row
  const float sl2 = a.scale * kLog2e;
  float lrow[2], drow[2];   // L·log2(e) and D of the lane's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = rw + g + 8 * h;
    const bool in = row < a.sq;
    lrow[h] = in ? a.L[(size_t)hb * a.sq + row] * kLog2e : INFINITY;
    drow[h] = in ? a.D[(size_t)hb * a.sq + row] : 0.f;
  }
  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  if (nk > 0) {
    start_tile<BQ, DMAX, NT>(Qs, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);
    start_tile<BQ, DMAX, NT>(dOs, a.dout, a.do_dt, a.n, hb, a.sq, a.d, r0);
    cp_async_commit();
    start_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, 0);
    start_tile<BK, DMAX, NT>(Vs, a.v, a.v_dt, a.n, hb, a.skv, a.d, 0);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    const long long c0 = (long long)kt * BK;
    float* Kt = Ks + st * BK * LD;
    float* Vt = Vs + st * BK * LD;
    if (kt + 1 < nk) {   // K/V(kt + 1) fly while tile kt is computed
      start_tile<BK, DMAX, NT>(Ks + (st ^ 1) * BK * LD, a.k, a.k_dt, a.n, hb,
                               a.skv, a.d, c0 + BK);
      start_tile<BK, DMAX, NT>(Vs + (st ^ 1) * BK * LD, a.v, a.v_dt, a.n, hb,
                               a.skv, a.d, c0 + BK);
    }
    cp_async_commit();
    cp_async_wait<1>();   // Q, dO and K/V(kt) landed
    __syncthreads();
    if (kt == 0) {
      if (a.q_dt == kBF16) widen_tile<BQ, DMAX, NT>(Qs);
      if (a.do_dt == kBF16) widen_tile<BQ, DMAX, NT>(dOs);
    }
    if (a.k_dt == kBF16) widen_tile<BK, DMAX, NT>(Kt);
    if (a.v_dt == kBF16) widen_tile<BK, DMAX, NT>(Vt);
    if (!a.causal || a.q_off + rw + 15 >= a.kv_off + c0) {
      float s[BK / 2], dp[BK / 2];
      score_block<BK / 8, DMAX>(s, Qs + 16 * warp * LD, Kt, g, t);
      score_block<BK / 8, DMAX>(dp, dOs + 16 * warp * LD, Vt, g, t);
      // P = exp(scale·S - L), dS = P∘(dP - D) on the fragment; masks only
      // where the tile crosses the key tail or the warp's diagonal
      const bool edge =
          c0 + BK > a.skv ||
          (a.causal && a.q_off + rw < a.kv_off + c0 + BK - 1);
      // keys left in the tile, and the lane's row 0 minus the tile's first
      // key by global position (clamped: only its sign near 0 matters)
      const int left = (int)min((long long)BK, a.skv - c0);
      const int diag = (int)max(-(long long)BK - 16,
                                min((long long)BK + 16, a.q_off + rw + g -
                                                            a.kv_off - c0));
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        bool valid = true;
        if (edge) {
          const int col = 8 * (i / 4) + 2 * t + (i & 1);
          valid = col < left && (!a.causal || diag + 8 * h >= col);
        }
        const float p = valid ? exp2f(fmaf(s[i], sl2, -lrow[h])) : 0.f;
        dp[i] = p * (dp[i] - drow[h]);
      }
      acc_block<BK / 8, DMAX / 8, LD>(acc, dp, Kt, 0, g, t);   // dQ += dS·K
    }
    __syncthreads();   // stage st read before K/V(kt + 2) land in it
  }
  cp_async_wait<0>();
  store_frag<DMAX>(a.g0, a.g_dt, acc, rw + g, a.sq, a.n, hb, a.d, 0, t,
                   a.scale);
}

// Start the copies of K4's stage st: Q and dO rows [r0, r0 + BQ) and their
// L and D entries (L = +inf, D = 0 past Sq, stored directly).
template <int BQ, int DMAX, int NT>
__device__ __forceinline__ void start_q_stage(float* Qt, float* dOt,
                                              float* Lt, float* Dt,
                                              const BwdArgs& a, int hb,
                                              long long r0) {
  start_tile<BQ, DMAX, NT>(Qt, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);
  start_tile<BQ, DMAX, NT>(dOt, a.dout, a.do_dt, a.n, hb, a.sq, a.d, r0);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const long long row = r0 + i;
    if (row < a.sq) {
      cp_async4(Lt + i, a.L + (size_t)hb * a.sq + row);
      cp_async4(Dt + i, a.D + (size_t)hb * a.sq + row);
    } else {
      Lt[i] = INFINITY;
      Dt[i] = 0.f;
    }
  }
}

// K4: one CTA per (key tile, slice, DCOL columns of dk/dv), q tiles inner;
// warp w owns keys [16 w, 16 w + 16) of the tile.
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dkv_tf32x3_kernel(BwdArgs a) {
  constexpr int BK = T::RES, BQ = T::STR, DMAX = T::DMAX, DCOL = T::DCOL,
                LD = T::LD, NT = T::NT;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;        // stage st at st * BQ * LD
  float* dOs = Qs + 2 * BQ * LD;
  float* Ls = dOs + 2 * BQ * LD;   // stage st at st * BQ
  float* Ds = Ls + 2 * BQ;

  // CTAs in the order of their linear index, key tiles outer: under a
  // causal mask the first key tiles see the most q rows and start first
  const long long lin = blockIdx.x + (long long)blockIdx.y * gridDim.x;
  const int hb = (int)(lin % a.n);
  const long long c0 = lin / a.n * BK;
  const int col0 = blockIdx.z * DCOL;
  const int nq = (a.sq + BQ - 1) / BQ;
  int q0 = 0;   // the first q tile whose last row reaches key c0
  if (a.causal) {
    const long long lim = a.kv_off + c0 - a.q_off - (BQ - 1);
    if (lim > 0) q0 = (int)min((long long)nq, (lim + BQ - 1) / BQ);
  }
  const int nt = nq - q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
  const long long kw = c0 + 16 * warp;   // the warp's first key
  const float sl2 = a.scale * kLog2e;
  float dk[DCOL / 2], dv[DCOL / 2];
#pragma unroll
  for (int i = 0; i < DCOL / 2; ++i) dk[i] = dv[i] = 0.f;
  if (nt > 0) {
    start_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, c0);
    start_tile<BK, DMAX, NT>(Vs, a.v, a.v_dt, a.n, hb, a.skv, a.d, c0);
    cp_async_commit();
    start_q_stage<BQ, DMAX, NT>(Qs, dOs, Ls, Ds, a, hb,
                                (long long)q0 * BQ);
    cp_async_commit();
  }

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    const long long r0 = (long long)(q0 + it) * BQ;
    float* Qt = Qs + st * BQ * LD;
    float* dOt = dOs + st * BQ * LD;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    if (it + 1 < nt)   // the next q stage flies while this one is computed
      start_q_stage<BQ, DMAX, NT>(Qs + (st ^ 1) * BQ * LD,
                                  dOs + (st ^ 1) * BQ * LD,
                                  Ls + (st ^ 1) * BQ, Ds + (st ^ 1) * BQ, a,
                                  hb, r0 + BQ);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and stage st landed
    __syncthreads();
    if (it == 0) {
      if (a.k_dt == kBF16) widen_tile<BK, DMAX, NT>(Ks);
      if (a.v_dt == kBF16) widen_tile<BK, DMAX, NT>(Vs);
    }
    if (a.q_dt == kBF16) widen_tile<BQ, DMAX, NT>(Qt);
    if (a.do_dt == kBF16) widen_tile<BQ, DMAX, NT>(dOt);
    // the tile's last q row reaches the warp's first key
    if (!a.causal || a.q_off + r0 + BQ - 1 >= a.kv_off + kw) {
      float s[BQ / 2], dp[BQ / 2];
      score_block<BQ / 8, DMAX>(s, Ks + 16 * warp * LD, Qt, g, t);
      score_block<BQ / 8, DMAX>(dp, Vs + 16 * warp * LD, dOt, g, t);
      // Pᵀ and dSᵀ on the fragment, L and D per column (q row); rows past
      // Sq have L = +inf, so P = 0 there without a mask; the causal mask
      // only where the tile crosses the warp's diagonal
      const bool edge = a.causal && a.q_off + r0 < a.kv_off + kw + 15;
      // the tile's first q row minus the lane's key 0 by global position
      // (clamped: only its sign near 0 matters)
      const int diag = (int)max(-(long long)BQ - 16,
                                min((long long)BQ + 16, a.q_off + r0 -
                                                            a.kv_off - kw -
                                                            g));
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i / 4) + 2 * t + (i & 1);
        const bool valid = !edge || diag + c >= 8 * h;
        const float p =
            valid ? exp2f(fmaf(s[i], sl2, -Lt[c] * kLog2e)) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - Dt[c]);
      }
      acc_block<BQ / 8, DCOL / 8, LD>(dv, s, dOt, col0, g, t);  // Pᵀ·dO
      acc_block<BQ / 8, DCOL / 8, LD>(dk, dp, Qt, col0, g, t);  // dSᵀ·Q
    }
    __syncthreads();   // stage st read before the stage after next lands
  }
  cp_async_wait<0>();
  store_frag<DCOL>(a.g0, a.g_dt, dk, kw + g, a.skv, a.n, hb, a.d, col0, t,
                   a.scale);
  store_frag<DCOL>(a.g1, a.g_dt, dv, kw + g, a.skv, a.n, hb, a.d, col0, t,
                   1.f);
}

// K3 tiles (DMAX, BQ resident q rows, BK streamed keys); shared =
// (2·BQ + 4·BK)·(DMAX + 4)·4 bytes; registers a thread, floats: DMAX / 2
// (dQ) + BK (S, dP) + 4·BK / 8 (the score chunk's partial sums) + the
// split fragments (2·BK of dS's), within the 255 a thread that
// __launch_bounds__(NT, 1) allows (ptxas's count: chip_smoke.py phase 1):
//   DMAX  64: 128 x 32, 256 threads (104.4 KB; 32 + 32)
//   DMAX 128: 128 x 32, 256 threads (202.8 KB; 64 + 32)
//   DMAX 256:  64 x 16, 128 threads (199.7 KB; 128 + 16)
template <class T>
int run_dq_tf32(const BwdArgs& a, void* stream) {
  dim3 grid((a.sq + T::RES - 1) / T::RES, a.n);
  return launch(flash_dq_tf32x3_kernel<T>, grid, T::NT, T::SMEM_DQ, stream,
                a);
}

// K4 tiles (DMAX, BK resident keys, BQ streamed q rows, DCOL); shared =
// (2·BK + 4·BQ)·(DMAX + 4)·4 + 16·BQ bytes; registers a thread, floats:
// DCOL (dK, dV) + BQ (Sᵀ, dPᵀ) + the chunk's partial sums + the split
// fragments; D = 256 splits the columns over gridDim.z (each CTA
// rebuilding Sᵀ and dPᵀ over all 256).  At DMAX 128 ptxas spills a few
// registers (chip_smoke.py phase 1 prints how many): halving the q rows a
// pass to free them cost more time than the spill.
//   DMAX  64: 128 x 32, DCOL  64, 256 threads (104.9 KB;  64 + 32)
//   DMAX 128: 128 x 32, DCOL 128, 256 threads (203.3 KB; 128 + 32)
//   DMAX 256:  64 x 16, DCOL 128, 128 threads (199.9 KB; 128 + 16)
template <class T>
int run_dkv_tf32(const BwdArgs& a, void* stream) {
  dim3 grid((a.skv + T::RES - 1) / T::RES, a.n, T::DMAX / T::DCOL);
  return launch(flash_dkv_tf32x3_kernel<T>, grid, T::NT, T::SMEM_DKV,
                stream, a);
}

// ---------------------------------------------------------------------------
// above D = 256 (Tf32WideTiles and the box products: flash_wide.cuh)
// ---------------------------------------------------------------------------

// Arguments of the wide kernels: f32 tensor maps of q, k, v and dO, boxes
// of 32 columns (128-byte rows, written with the 128-byte swizzle) and the
// rows of one tile, and the call's arguments.
struct Tf32WideArgs {
  CUtensorMap tq, tk, tv, tdo;
  BwdArgs a;
};

// Thread 0's loads of a score step: its boxes at column c (two of each
// operand, or one where the second starts past d: the A operands of the
// two groups by maps a0/a1 at rows ra, the B operands by b0/b1 at rows
// rb).  An output step's loads are flash_wide.cuh's wide_out_load.
template <class T>
__device__ __forceinline__ void wide_score_load(
    uint8_t* dst, uint64_t* bar, const CUtensorMap* a0, const CUtensorMap* b0,
    const CUtensorMap* a1, const CUtensorMap* b1, int c, int hb, int ra,
    int rb, int d) {
  using namespace pa_sm90;
  const int nbx = c + 32 < d ? 2 : 1;
  mbar_arrive_expect_tx(bar, nbx * T::GRP);
  for (int h = 0; h < nbx; ++h) {
    const int col = c + 32 * h;
    tma_load_3d(dst + h * T::RBOX, a0, bar, col, hb, ra);
    tma_load_3d(dst + 2 * T::RBOX + h * T::SBOX, b0, bar, col, hb, rb);
    tma_load_3d(dst + T::GRP + h * T::RBOX, a1, bar, col, hb, ra);
    tma_load_3d(dst + T::GRP + 2 * T::RBOX + h * T::SBOX, b1, bar, col, hb,
                rb);
  }
}

// K3 above D = 256: one CTA per (64 q rows, slice, 512 columns of dq), key
// tiles of STR inner.  Group 0 builds S = Q·Kᵀ and P, group 1 dP = dO·Vᵀ;
// they swap P and dP through shared memory, each forms dS = P∘(dP - D)
// and accumulates dQ += dS·K over its own 256 columns (group G: col0 +
// 256 G ..).
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dq_tf32x3_wide_kernel(const __grid_constant__ Tf32WideArgs w) {
  using namespace pa_sm90;
  constexpr int RES = T::RES, STR = T::STR, ST = T::STAGES;
  const BwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* xch = reinterpret_cast<float*>(ring + ST * T::STAGE);

  int hb;
  long long r0;
  cta_tile(a.n, RES, r0, hb);
  const int col0 = blockIdx.z * T::DQ_COLS;
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, RES, STR);
  const int nb = (a.d + 63) / 64;               // score steps a tile
  const int na = col0 + 128 < a.d ? 2 : 1;      // output steps a tile
  const int per = nb + na, total = nk * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = warp / 4,
            wq = warp % 4, g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const long long rw = r0 + 16 * wq;   // the warp's first row
  const float sl2 = a.scale * kLog2e;
  float lrow[2], drow[2];   // L·log2(e) and D of the lane's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = rw + g + 8 * h;
    const bool in = row < a.sq;
    lrow[h] = in ? a.L[(size_t)hb * a.sq + row] * kLog2e : INFINITY;
    drow[h] = in ? a.D[(size_t)hb * a.sq + row] : 0.f;
  }

  // step s (thread 0): Q/K/dO/V boxes of a score step, or K's boxes at the
  // two groups' 128 columns of an output step
  auto issue = [&](int s) {
    if (s >= total) return;
    const int kt = s / per, j = s % per, st = s % ST;
    uint8_t* dst = ring + st * T::STAGE;
    if (j < nb)
      wide_score_load<T>(dst, &full[st], &w.tq, &w.tk, &w.tdo, &w.tv, 64 * j,
                         hb, (int)r0, kt * STR, a.d);
    else
      wide_out_load<T>(dst, &full[st], &w.tk, &w.tk, col0 + 128 * (j - nb),
                       256, hb, kt * STR, a.d);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
    for (int i = 0; i < ST; ++i) issue(i);
  }
  __syncthreads();

  float acc0[64], acc1[64], sc[STR / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  int s = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const long long c0 = (long long)kt * STR;
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) sc[i] = 0.f;
    // S (group 0: Q, K) or dP (group 1: dO, V), a slab a step
    for (int j = 0; j < nb; ++j, ++s) {
      const int st = s % ST;
      mbar_wait(&full[st], (s / ST) & 1);
      wide_score_step<T>(sc, ring + st * T::STAGE + grp * T::GRP, 16 * wq,
                         64 * j + 32 < a.d, g, t);
      __syncthreads();   // stage st read: it takes step s + ST
      if (threadIdx.x == 0) issue(s + ST);
    }
    float* mine = xch + (2 * (kt & 1) + grp) * T::XCH;
    const float* other = xch + (2 * (kt & 1) + (grp ^ 1)) * T::XCH;
    if (grp == 0) {
      // P = exp(scale·S - L), masked only where the tile crosses the key
      // tail or the CTA's diagonal
      const bool edge =
          c0 + STR > a.skv ||
          (a.causal && a.q_off + r0 < a.kv_off + c0 + STR - 1);
#pragma unroll
      for (int i = 0; i < STR / 2; ++i) {
        const int h = (i >> 1) & 1;
        bool valid = true;
        if (edge) {
          const long long col = c0 + 8 * (i / 4) + 2 * t + (i & 1);
          valid = col < a.skv &&
                  (!a.causal || a.q_off + rw + g + 8 * h >= a.kv_off + col);
        }
        sc[i] = valid ? exp2f(fmaf(sc[i], sl2, -lrow[h])) : 0.f;
      }
    }
    // swap P and dP (same fragment layout in both groups), then dS = P∘(dP
    // - D) in both
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) mine[i * 128 + tid] = sc[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) {
      const float o = other[i * 128 + tid], dr = drow[(i >> 1) & 1];
      sc[i] = grp == 0 ? sc[i] * (o - dr) : o * (sc[i] - dr);
    }
    // dQ += dS·K over the group's 256 columns, 128 a step
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= na) continue;
      const int st = s % ST;
      mbar_wait(&full[st], (s / ST) & 1);
      if (col0 + 256 * grp + 128 * j < a.d) {
        const float* B = reinterpret_cast<const float*>(
            ring + st * T::STAGE + grp * 4 * T::SBOX);
        if (j == 0)
          box_outputs<STR / 8, STR>(acc0, sc, B, g, t);
        else
          box_outputs<STR / 8, STR>(acc1, sc, B, g, t);
      }
      __syncthreads();
      if (threadIdx.x == 0) issue(s + ST);
      ++s;
    }
  }
  const int c = col0 + 256 * grp;
  store_frag<128>(a.g0, a.g_dt, acc0, rw + g, a.sq, a.n, hb, a.d, c, t,
                  a.scale);
  store_frag<128>(a.g0, a.g_dt, acc1, rw + g, a.sq, a.n, hb, a.d, c + 128, t,
                  a.scale);
}

// K4 above D = 256: one CTA per (64 keys, slice, 256 columns of dk and
// dv), q tiles of STR inner.  Group 0 builds Sᵀ = K·Qᵀ and Pᵀ and
// accumulates dV += Pᵀ·dO; group 1 builds dPᵀ = V·dOᵀ, takes Pᵀ from
// group 0 through shared memory, forms dSᵀ and accumulates dK += dSᵀ·Q.
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dkv_tf32x3_wide_kernel(const __grid_constant__ Tf32WideArgs w) {
  using namespace pa_sm90;
  constexpr int RES = T::RES, STR = T::STR, ST = T::STAGES;
  const BwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* xch = reinterpret_cast<float*>(ring + ST * T::STAGE);

  // CTAs in the order of their linear index, key tiles outer: under a
  // causal mask the first key tiles see the most q rows and start first
  const long long lin = blockIdx.x + (long long)blockIdx.y * gridDim.x;
  const int hb = (int)(lin % a.n);
  const long long c0 = lin / a.n * RES;
  const int col0 = blockIdx.z * T::DKV_COLS;
  const int nq = (a.sq + STR - 1) / STR;
  int q0 = 0;   // the first q tile whose last row reaches key c0
  if (a.causal) {
    const long long lim = a.kv_off + c0 - a.q_off - (STR - 1);
    if (lim > 0) q0 = (int)min((long long)nq, (lim + STR - 1) / STR);
  }
  const int nt = nq - q0;
  const int nb = (a.d + 63) / 64;
  const int na = col0 + 128 < a.d ? 2 : 1;
  const int per = nb + na, total = nt * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = warp / 4,
            wq = warp % 4, g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const long long kw = c0 + 16 * wq;   // the warp's first key
  const float sl2 = a.scale * kLog2e;

  // step s (thread 0): K/Q/V/dO boxes of a score step, or the q tile's
  // rows of dO and of Q at the CTA's columns c .. c + 128 (output step)
  auto issue = [&](int s) {
    if (s >= total) return;
    const int it = s / per, j = s % per, st = s % ST;
    const int r0 = (q0 + it) * STR;
    uint8_t* dst = ring + st * T::STAGE;
    if (j < nb)
      wide_score_load<T>(dst, &full[st], &w.tk, &w.tq, &w.tv, &w.tdo, 64 * j,
                         hb, (int)c0, r0, a.d);
    else
      wide_out_load<T>(dst, &full[st], &w.tdo, &w.tq, col0 + 128 * (j - nb),
                       0, hb, r0, a.d);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
    for (int i = 0; i < ST; ++i) issue(i);
  }
  __syncthreads();

  float acc0[64], acc1[64], sc[STR / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  int s = 0;
  for (int it = 0; it < nt; ++it) {
    const long long r0 = (long long)(q0 + it) * STR;
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) sc[i] = 0.f;
    // Sᵀ (group 0: K, Q) or dPᵀ (group 1: V, dO), a slab a step
    for (int j = 0; j < nb; ++j, ++s) {
      const int st = s % ST;
      mbar_wait(&full[st], (s / ST) & 1);
      wide_score_step<T>(sc, ring + st * T::STAGE + grp * T::GRP, 16 * wq,
                         64 * j + 32 < a.d, g, t);
      __syncthreads();
      if (threadIdx.x == 0) issue(s + ST);
    }
    float* pbuf = xch + (it & 1) * T::XCH;
    if (grp == 0) {
      // Pᵀ with L per column (q row; +inf past Sq, so P = 0 there without
      // a mask); the causal mask only where the tile crosses the diagonal
      const bool edge = a.causal && a.q_off + r0 < a.kv_off + c0 + RES - 1;
#pragma unroll
      for (int i = 0; i < STR / 2; ++i) {
        const int h = (i >> 1) & 1;
        const long long row = r0 + 8 * (i / 4) + 2 * t + (i & 1);
        const float lc = row < a.sq ? a.L[(size_t)hb * a.sq + row] * kLog2e
                                    : INFINITY;
        const bool valid =
            !edge || a.q_off + row >= a.kv_off + kw + g + 8 * h;
        sc[i] = valid ? exp2f(fmaf(sc[i], sl2, -lc)) : 0.f;
        pbuf[i * 128 + tid] = sc[i];
      }
    }
    __syncthreads();
    if (grp == 1) {
      // dSᵀ = Pᵀ∘(dPᵀ - D), D per column
#pragma unroll
      for (int i = 0; i < STR / 2; ++i) {
        const long long row = r0 + 8 * (i / 4) + 2 * t + (i & 1);
        const float dc = row < a.sq ? a.D[(size_t)hb * a.sq + row] : 0.f;
        sc[i] = pbuf[i * 128 + tid] * (sc[i] - dc);
      }
    }
    // group 0: dV += Pᵀ·dO; group 1: dK += dSᵀ·Q; 128 columns a step
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= na) continue;
      const int st = s % ST;
      mbar_wait(&full[st], (s / ST) & 1);
      if (col0 + 128 * j < a.d) {
        const float* B = reinterpret_cast<const float*>(
            ring + st * T::STAGE + grp * 4 * T::SBOX);
        if (j == 0)
          box_outputs<STR / 8, STR>(acc0, sc, B, g, t);
        else
          box_outputs<STR / 8, STR>(acc1, sc, B, g, t);
      }
      __syncthreads();
      if (threadIdx.x == 0) issue(s + ST);
      ++s;
    }
  }
  void* out = grp == 0 ? a.g1 : a.g0;
  const float mul = grp == 0 ? 1.f : a.scale;
  store_frag<128>(out, a.g_dt, acc0, kw + g, a.skv, a.n, hb, a.d, col0, t,
                  mul);
  store_frag<128>(out, a.g_dt, acc1, kw + g, a.skv, a.n, hb, a.d, col0 + 128,
                  t, mul);
}

// The wide kernels' tensor maps: q and dO with boxes of `qrows` rows, k and
// v of `krows` (with no rows on one side nothing is loaded, and that
// side's maps describe the other's tensors).  Every operand must be f32.
inline int wide_tf32_maps(Tf32WideArgs& w, int qrows, int krows) {
  using pa_sm90::encode_rows_f32;
  const BwdArgs& a = w.a;
  if (a.q_dt != kF32 || a.k_dt != kF32 || a.v_dt != kF32 || a.do_dt != kF32)
    return (int)cudaErrorInvalidValue;
  const bool keys = a.skv > 0, rows = a.sq > 0;
  const bool ok =
      encode_rows_f32(&w.tq, rows ? a.q : a.k, rows ? a.sq : a.skv, a.n, a.d,
                      qrows) &&
      encode_rows_f32(&w.tdo, rows ? a.dout : a.k, rows ? a.sq : a.skv, a.n,
                      a.d, qrows) &&
      encode_rows_f32(&w.tk, keys ? a.k : a.q, keys ? a.skv : a.sq, a.n, a.d,
                      krows) &&
      encode_rows_f32(&w.tv, keys ? a.v : a.q, keys ? a.skv : a.sq, a.n, a.d,
                      krows);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

int run_dq_tf32_wide(const BwdArgs& a, void* stream) {
  using T = Tf32WideTiles;
  Tf32WideArgs w{};
  w.a = a;
  if (const int err = wide_tf32_maps(w, T::RES, T::STR)) return err;
  dim3 grid((a.sq + T::RES - 1) / T::RES, a.n,
            (a.d + T::DQ_COLS - 1) / T::DQ_COLS);
  return launch(flash_dq_tf32x3_wide_kernel<T>, grid, T::NT, T::SMEM, stream,
                w);
}

int run_dkv_tf32_wide(const BwdArgs& a, void* stream) {
  using T = Tf32WideTiles;
  Tf32WideArgs w{};
  w.a = a;
  if (const int err = wide_tf32_maps(w, T::STR, T::RES)) return err;
  dim3 grid((a.skv + T::RES - 1) / T::RES, a.n,
            (a.d + T::DKV_COLS - 1) / T::DKV_COLS);
  return launch(flash_dkv_tf32x3_wide_kernel<T>, grid, T::NT, T::SMEM,
                stream, w);
}

}  // namespace pa_flash

// q, k, v, dout each f32 or bf16, d <= 1024; dq in dq_dt.
extern "C" int pa_flash_bwd_dq_tf32x3(
    const void* q, const void* k, const void* v, const void* dout, int q_dt,
    int k_dt, int v_dt, int do_dt, const float* L, const float* D, void* dq,
    int dq_dt, int n, int sq, int skv, int d, float scale, int causal,
    long long q_off, long long kv_off, void* stream) {
  using namespace pa_flash;
  const BwdArgs a{q,     k,       v,    dout, q_dt, k_dt,  v_dt,
                  do_dt, L,       D,    dq,   nullptr, dq_dt, n,
                  sq,    skv,     d,    scale, causal, q_off, kv_off};
  if (d <= 64) return run_dq_tf32<Tf32Tiles<64, 128, 32>>(a, stream);
  if (d <= 128) return run_dq_tf32<Tf32Tiles<128, 128, 32>>(a, stream);
  if (d <= 256) return run_dq_tf32<Tf32Tiles<256, 64, 16>>(a, stream);
  if (d <= 1024) return run_dq_tf32_wide(a, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout each f32 or bf16, d <= 1024; dk and dv in dkv_dt.
extern "C" int pa_flash_bwd_dkv_tf32x3(
    const void* q, const void* k, const void* v, const void* dout, int q_dt,
    int k_dt, int v_dt, int do_dt, const float* L, const float* D, void* dk,
    void* dv, int dkv_dt, int n, int sq, int skv, int d, float scale,
    int causal, long long q_off, long long kv_off, void* stream) {
  using namespace pa_flash;
  const BwdArgs a{q,     k,   v,   dout, q_dt,   k_dt,  v_dt,  do_dt,
                  L,     D,   dk,  dv,   dkv_dt, n,     sq,    skv,
                  d,     scale, causal, q_off, kv_off};
  if (d <= 64) return run_dkv_tf32<Tf32Tiles<64, 128, 32>>(a, stream);
  if (d <= 128) return run_dkv_tf32<Tf32Tiles<128, 128, 32>>(a, stream);
  if (d <= 256)
    return run_dkv_tf32<Tf32Tiles<256, 64, 16, 128>>(a, stream);
  if (d <= 1024) return run_dkv_tf32_wide(a, stream);
  return (int)cudaErrorInvalidValue;
}
