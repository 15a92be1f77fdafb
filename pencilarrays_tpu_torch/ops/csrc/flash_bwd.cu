// K3 and K4 — the flash-attention backward for Hopper (sm_90a), CUDA C++:
// the wgmma instance of each that ops/flash.py::bwd_instance picks for
// all-bf16 calls (the tf32x3 instance, for any f32 operand, is
// flash_bwd_tf32.cu).
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
//
// Bound: operations.  6·Sq·Skv·D FLOPs per slice for K3 (S = Q·Kᵀ,
// dP = dO·Vᵀ, dS·K) and 8·Sq·Skv·D for K4 (S, dP, Pᵀ·dO, dSᵀ·Q), halved
// when causal, over reads of 5 (K3) or 6 (K4) (S, D) operands: ~1000
// FLOPs a byte at S = 4096, D = 128, far above the card's balance point.
// The least time is the FLOPs over 989 TFLOP/s (bf16, tensor cores) or,
// for f32, 165 TFLOP/s (three TF32 tensor-core products per f32 product,
// which beats the CUDA cores' 67).  Rebuilding S and dP in both
// kernels does 14·S²·D of work where a fused backward with atomic dQ does
// 10: the price of owning every output row.
//
// * wgmma instance (q, k, v and dO all bf16), D <= 256: tensor cores.  A
//   producer warp TMA-loads the CTA's two resident tiles once (K3: Q and
//   dO of its q tile; K4: K and V of its key tile) and streams the other
//   two through a two-stage ring on mbarriers (K3: K and V tiles; K4: Q
//   and dO tiles with their L and D rows); 128-byte-swizzled boxes,
//   zero-filled past the tensor.  Two consumer warpgroups of 64 rows each
//   compute the two score blocks as shared-shared wgmma — in K4 directly
//   transposed, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that Pᵀ and dSᵀ come out in
//   accumulator layout with keys as rows and L, D are read per column —
//   build P and dS on the accumulator fragment, and accumulate the
//   register-shared products (K3: dQ += dS·K; K4: dV += Pᵀ·dO,
//   dK += dSᵀ·Q) with P and dS packed to bf16 A fragments in registers and
//   K, dO, Q read as MN-major B operands from the same boxes the score
//   products read K-major.  The bf16 rounding of P and dS is that packing
//   (FlashAttention-2/3 practice; the TPU kernels and the plain version
//   keep them in f32).
// * wgmma instance, 256 < D <= 1024 (the wide kernels): the tiles above
//   do not fit there (Q and dO of 128 rows at D = 512 are 256 KB of bf16,
//   a block gets 227 KB; K4's f32 dK and dV of 64 keys x 512 columns are
//   the whole register file; a wgmma accumulator is at most 256 wide).
//   So nothing is resident: a producer warp streams every operand through
//   one ring of 64-row x 64-column TMA boxes, the score products reduce
//   over D one box a step, and the output columns are split twice.
//   Between the two consumer warpgroups, which hold the same 64 rows: in
//   K3 warpgroup 0 builds S and P and warpgroup 1 dP, they swap P and dP
//   through shared memory and each accumulates dQ over its own 256
//   columns (512 a CTA); in K4 warpgroup 0 builds Sᵀ and Pᵀ and
//   accumulates dV, warpgroup 1 builds dPᵀ, takes Pᵀ and accumulates dK,
//   256 columns each.  Between CTAs (gridDim.z) when a CTA's columns do
//   not cover D; each such CTA rebuilds the score blocks.  FLOPs executed
//   per (q row, key) pair, against the bound's 6·D (K3) and 8·D (K4):
//   K3 (4·z + 2)·D with z = ceil(D / 512): 6·D up to D = 512, 10·D at
//   1024; K4 (4·z + 4)·D with z = ceil(D / 256): 12·D at 512, 20·D at
//   1024.  Splitting K4 across warpgroups alone would need dK and dV of
//   64 x 512 in registers; splitting it across CTAs alone (four of 128
//   columns at D = 512) would execute 20·D.  The ring's shared pieces
//   (WideTiles, the output steps, the producer's stage claim) are in
//   flash_wide.cuh, which K2's wide kernel uses too.
//
// Conventions of the TPU kernels' _bwd_common (:348-383), kept by every
// kernel of K3 and K4:
// the score is masked BEFORE the exp and the masked entries of P are 0, so
// no intermediate inf exists even on rows whose L is garbage; padded rows
// carry L = +inf (P = 0) and D = 0; the causal mask is start-aligned by
// global position with per-call offsets; tiles wholly above the diagonal
// are skipped (K3 ends its key loop there, K4 starts its q loop at the
// first visible tile); only tiles that cross the key tail or the diagonal
// are masked, and starts the longest CTAs first.  Rows >= S
// and columns >= D are never written; columns D..64·ceil(D/64) arrive as
// zeros (TMA's fill past the tensor), and a box wholly past D is neither
// loaded nor multiplied.
#include "flash_wide.cuh"

namespace pa_flash {

// ---------------------------------------------------------------------------
// wgmma instance
// ---------------------------------------------------------------------------

struct BwdWgArgs {
  CUtensorMap tq, tk, tv, tdo;  // bf16 (s, n, d) maps, boxes {64, 1, rows}
  BwdArgs a;
};

// Tiles by head-dim class DP (D rounded up to 64, 128 or 256): a CTA owns
// BM = 128 rows (two consumer warpgroups of 64: q rows in K3, keys in K4),
// whose two tiles stay resident (K3: Q, dO; K4: K, V); a ring stage
// streams BN rows of the other two (K3: K, V; K4: Q, dO with BN floats
// each of L and D); the CTA writes DCOL output columns (gridDim.z =
// DP / DCOL, each CTA rebuilding the score blocks over the full DP).  A
// third warpgroup is the producer, of which one warp loads and which hands
// its registers to the consumers: setmaxnreg moves registers only between
// the CTA's own warps, so 128·PREG + 256·CREG stays within the 384·168
// the CTA starts with (asking for more leaves the consumers waiting).
// Shared memory = 2·NB·BM·128 + 4·NB·BN·128 + 16·BN bytes + 1 KB of
// alignment slack; registers a consumer thread, floats and bf16x2 words:
// K3 DCOL/2 (dQ) + BN (S, dP) + BN/8 (dS); K4 DCOL (dK, dV) + BN (Sᵀ, dPᵀ)
// + BN/4 (Pᵀ, dSᵀ).
//   K3:  DP  64: BN 64 ( 66 KB)   DP 128: BN 64 (130 KB)
//        DP 256: BN 32 (194 KB)
//   K4:  DP  64: BN 64 ( 66 KB)   DP 128: BN 64 (130 KB)
//        DP 256: BN 32, DCOL 128 (194 KB: dK and dV of 256 columns would be
//        256 registers)
template <int DP_, int BN_, int DCOL_ = DP_>
struct BwdTiles {
  static constexpr int DP = DP_, BM = 128, BN = BN_, DCOL = DCOL_;
  static constexpr int NB = DP / 64, STAGES = 2, NT = 384;
  static constexpr int PREG = 24, CREG = 240;
  static_assert(128 * PREG + 256 * CREG <= NT * 168, "register budget");
  static constexpr int FIX_BYTES = NB * BM * 128;   // one resident tile
  static constexpr int RING_BYTES = NB * BN * 128;  // one streamed tile
  static constexpr int SMEM = 2 * FIX_BYTES + STAGES * 2 * RING_BYTES +
                              STAGES * 2 * BN * 4 + 1024;
  static_assert(DP % DCOL == 0 && DCOL % 64 == 0, "output column split");
};

// acc (64 x BN) = A·Bᵀ over DP, both K-major: A the warpgroup's 64 rows of
// a tile whose boxes hold RA rows, B a tile of BN rows.
template <int DP, int RA, int BN>
__device__ __forceinline__ void ss_block(float (&acc)[BN / 2],
                                         const uint8_t* A, const uint8_t* B) {
  using namespace pa_sm90;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    // 16 of the depth a step: 32 bytes inside a 128-byte box row
    const int off = (kc % 4) * 32;
    const uint64_t da = wgmma_desc(A + (kc / 4) * RA * 128 + off, 16, 1024);
    const uint64_t db = wgmma_desc(B + (kc / 4) * BN * 128 + off, 16, 1024);
    if constexpr (BN == 64)
      wgmma_ss_n64(acc, da, db, kc > 0);
    else
      wgmma_ss_n32(acc, da, db, kc > 0);
  }
}

// K3: one CTA per (q tile, slice, DCOL columns of dq), key tiles inner.
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ BwdWgArgs w) {
  using namespace pa_sm90;
  constexpr int BQ = T::BM, BK = T::BN, DP = T::DP, NB = T::NB,
                ST = T::STAGES, DCOL = T::DCOL;
  const BwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[ST], bar_v[ST], bar_free[ST];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + T::FIX_BYTES;
  uint8_t* Ks = dOs + T::FIX_BYTES;          // stage st at st * RING_BYTES
  uint8_t* Vs = Ks + ST * T::RING_BYTES;

  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
  const int col0 = blockIdx.z * DCOL;
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, BQ, BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: Q and dO once, then K/V tiles through the two-stage ring
    setmaxnreg_dec<T::PREG>();
    if (warp == 8 && lane == 0 && nk > 0) {
      mbar_arrive_expect_tx(&bar_q, 2 * T::FIX_BYTES);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(Qs + b * BQ * 128, &w.tq, &bar_q, b * 64, hb, (int)r0);
        tma_load_3d(dOs + b * BQ * 128, &w.tdo, &bar_q, b * 64, hb,
                    (int)r0);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST, u = kt / ST;
        if (u > 0) mbar_wait(&bar_free[st], (u - 1) & 1);
        uint8_t* kd = Ks + st * T::RING_BYTES;
        uint8_t* vd = Vs + st * T::RING_BYTES;
        mbar_arrive_expect_tx(&bar_k[st], T::RING_BYTES);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(kd + b * BK * 128, &w.tk, &bar_k[st], b * 64, hb,
                      kt * BK);
        mbar_arrive_expect_tx(&bar_v[st], T::RING_BYTES);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(vd + b * BK * 128, &w.tv, &bar_v[st], b * 64, hb,
                      kt * BK);
      }
    }
  } else {
    setmaxnreg_inc<T::CREG>();
    // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile;
    // lane (g, t) of warp wq holds rows 16 wq + g (+ 8) of each fragment
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
    const long long rw = r0 + wg * 64;          // first row of the group
    const long long row0 = rw + wq * 16 + g;    // tile row of half 0
    const long long qpos[2] = {a.q_off + row0, a.q_off + row0 + 8};
    const float sl2 = a.scale * kLog2e;
    float lrow[2], drow[2];   // L·log2(e) and D of the fragment's two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      const bool in = row < a.sq;
      lrow[h] = in ? a.L[(size_t)hb * a.sq + row] * kLog2e : INFINITY;
      drow[h] = in ? a.D[(size_t)hb * a.sq + row] : 0.f;
    }
    float acc[DCOL / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < DCOL / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    if (nk > 0) mbar_wait(&bar_q, 0);
    const uint8_t* Qw = Qs + wg * 64 * 128;
    const uint8_t* dOw = dOs + wg * 64 * 128;

    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST, u = kt / ST;
      const long long c0 = (long long)kt * BK;
      const uint8_t* Kt = Ks + st * T::RING_BYTES;
      const uint8_t* Vt = Vs + st * T::RING_BYTES;
      mbar_wait(&bar_k[st], u & 1);
      mbar_wait(&bar_v[st], u & 1);
      // the CTA's last rows may see a tile its first warpgroup does not
      const bool live = !a.causal || a.q_off + rw + 63 >= a.kv_off + c0;
      if (live) {
        wgmma_fence();
        ss_block<DP, BQ, BK>(s, Qw, Kt);      // S = Q·Kᵀ
        ss_block<DP, BQ, BK>(dp, dOw, Vt);    // dP = dO·Vᵀ
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // P = exp(scale·S - L) and dS = P∘(dP - D) on the fragment; masks
        // only where the tile crosses the key tail or the diagonal, and a
        // masked entry never reaches the exp
        const bool edge =
            c0 + BK > a.skv ||
            (a.causal && a.q_off + rw < a.kv_off + c0 + BK - 1);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int h = (i >> 1) & 1;
          bool valid = true;
          if (edge) {
            const long long col = c0 + 8 * (i / 4) + 2 * t + (i & 1);
            valid = col < a.skv && (!a.causal || qpos[h] >= a.kv_off + col);
          }
          const float p = valid ? exp2f(fmaf(s[i], sl2, -lrow[h])) : 0.f;
          dp[i] = p * (dp[i] - drow[h]);
        }
        uint32_t pa[BK / 16][4];
        pack_a<BK>(pa, dp);
        // dQ += dS·K: K is the MN-major B operand, from column box col0/64
        wgmma_fence();
        rs_block<BK, DCOL>(acc, pa, Kt + (col0 / 64) * BK * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }
    store_frag<DCOL>(a.g0, a.g_dt, acc, row0, a.sq, a.n, hb, a.d, col0, t,
                     a.scale);
  }  // consumers
}

// K4: one CTA per (key tile, slice, DCOL columns of dk/dv), q tiles inner.
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ BwdWgArgs w) {
  using namespace pa_sm90;
  constexpr int BK = T::BM, BQ = T::BN, DP = T::DP, NB = T::NB,
                ST = T::STAGES, DCOL = T::DCOL;
  const BwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_q[ST], bar_do[ST],
      bar_free[ST];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + T::FIX_BYTES;
  uint8_t* Qs = Vs + T::FIX_BYTES;           // stage st at st * RING_BYTES
  uint8_t* dOs = Qs + ST * T::RING_BYTES;
  float* Ls = reinterpret_cast<float*>(dOs + ST * T::RING_BYTES);
  float* Ds = Ls + ST * BQ;                  // stage st at st * BQ

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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_q[s], 1);
      mbar_init(&bar_do[s], 33);   // the TMA arrival + one per producer lane
      mbar_init(&bar_free[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warp: K and V once, then Q/dO tiles through the two-stage
    // ring, each with its L·log2(e) and D rows (L = +inf, D = 0 past Sq)
    setmaxnreg_dec<T::PREG>();
    if (warp == 8 && nt > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&bar_kv, 2 * T::FIX_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(Ks + b * BK * 128, &w.tk, &bar_kv, b * 64, hb,
                      (int)c0);
          tma_load_3d(Vs + b * BK * 128, &w.tv, &bar_kv, b * 64, hb,
                      (int)c0);
        }
      }
      for (int it = 0; it < nt; ++it) {
        const int st = it % ST, u = it / ST;
        const long long r0 = (long long)(q0 + it) * BQ;
        if (u > 0) mbar_wait(&bar_free[st], (u - 1) & 1);
        if (lane == 0) {
          uint8_t* qd = Qs + st * T::RING_BYTES;
          uint8_t* dd = dOs + st * T::RING_BYTES;
          mbar_arrive_expect_tx(&bar_q[st], T::RING_BYTES);
          for (int b = 0; b < NB; ++b)
            tma_load_3d(qd + b * BQ * 128, &w.tq, &bar_q[st], b * 64, hb,
                        (int)r0);
          mbar_arrive_expect_tx(&bar_do[st], T::RING_BYTES);
          for (int b = 0; b < NB; ++b)
            tma_load_3d(dd + b * BQ * 128, &w.tdo, &bar_do[st], b * 64, hb,
                        (int)r0);
        }
        for (int i = lane; i < BQ; i += 32) {
          const long long row = r0 + i;
          const bool in = row < a.sq;
          Ls[st * BQ + i] =
              in ? a.L[(size_t)hb * a.sq + row] * kLog2e : INFINITY;
          Ds[st * BQ + i] = in ? a.D[(size_t)hb * a.sq + row] : 0.f;
        }
        mbar_arrive(&bar_do[st]);
      }
    }
  } else {
    setmaxnreg_inc<T::CREG>();
    // consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) of the tile;
    // in the transposed blocks lane (g, t) of warp wq holds keys
    // 16 wq + g (+ 8) and q columns 8 j + 2 t (+ 1)
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
    const long long kw = c0 + wg * 64;          // first key of the group
    const long long krow0 = kw + wq * 16 + g;   // key of row half 0
    const long long kpos[2] = {a.kv_off + krow0, a.kv_off + krow0 + 8};
    const float sl2 = a.scale * kLog2e;
    float dk[DCOL / 2], dv[DCOL / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < DCOL / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    if (nt > 0) mbar_wait(&bar_kv, 0);
    const uint8_t* Kw = Ks + wg * 64 * 128;
    const uint8_t* Vw = Vs + wg * 64 * 128;

    for (int it = 0; it < nt; ++it) {
      const int st = it % ST, u = it / ST;
      const long long r0 = (long long)(q0 + it) * BQ;
      const uint8_t* Qt = Qs + st * T::RING_BYTES;
      const uint8_t* dOt = dOs + st * T::RING_BYTES;
      const float* Lt = Ls + st * BQ;
      const float* Dt = Ds + st * BQ;
      mbar_wait(&bar_q[st], u & 1);
      mbar_wait(&bar_do[st], u & 1);
      // the tile's last q row reaches this warpgroup's first key
      const bool live = !a.causal || a.q_off + r0 + BQ - 1 >= a.kv_off + kw;
      if (live) {
        wgmma_fence();
        ss_block<DP, BK, BQ>(s, Kw, Qt);      // Sᵀ = K·Qᵀ
        ss_block<DP, BK, BQ>(dp, Vw, dOt);    // dPᵀ = V·dOᵀ
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // Pᵀ and dSᵀ on the fragment, L and D per column (q row); rows
        // past Sq have L = +inf, so P = 0 there without a mask; the causal
        // mask only where the tile crosses the diagonal
        const bool edge =
            a.causal && a.q_off + r0 < a.kv_off + kw + 63;
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int h = (i >> 1) & 1;
          const int c = 8 * (i / 4) + 2 * t + (i & 1);
          const bool valid = !edge || a.q_off + r0 + c >= kpos[h];
          const float p = valid ? exp2f(fmaf(s[i], sl2, -Lt[c])) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - Dt[c]);
        }
        uint32_t pp[BQ / 16][4], pd[BQ / 16][4];
        pack_a<BQ>(pp, s);
        pack_a<BQ>(pd, dp);
        // dV += Pᵀ·dO, dK += dSᵀ·Q: dO and Q as MN-major B operands
        wgmma_fence();
        rs_block<BQ, DCOL>(dv, pp, dOt + (col0 / 64) * BQ * 128);
        rs_block<BQ, DCOL>(dk, pd, Qt + (col0 / 64) * BQ * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }
    store_frag<DCOL>(a.g0, a.g_dt, dk, krow0, a.skv, a.n, hb, a.d, col0, t,
                     a.scale);
    store_frag<DCOL>(a.g1, a.g_dt, dv, krow0, a.skv, a.n, hb, a.d, col0, t,
                     1.f);
  }  // consumers
}

template <class T>
int run_dq_wgmma(BwdWgArgs& w, void* stream) {
  using pa_sm90::encode_rows_bf16;
  const BwdArgs& a = w.a;
  // with no keys nothing is loaded; k/v maps then describe q
  const bool keys = a.skv > 0;
  if (!encode_rows_bf16(&w.tq, a.q, a.sq, a.n, a.d, T::BM) ||
      !encode_rows_bf16(&w.tdo, a.dout, a.sq, a.n, a.d, T::BM) ||
      !encode_rows_bf16(&w.tk, keys ? a.k : a.q, keys ? a.skv : a.sq, a.n,
                        a.d, T::BN) ||
      !encode_rows_bf16(&w.tv, keys ? a.v : a.q, keys ? a.skv : a.sq, a.n,
                        a.d, T::BN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.sq + T::BM - 1) / T::BM, a.n, T::DP / T::DCOL);
  return launch(flash_dq_wgmma_kernel<T>, grid, T::NT, T::SMEM, stream, w);
}

template <class T>
int run_dkv_wgmma(BwdWgArgs& w, void* stream) {
  using pa_sm90::encode_rows_bf16;
  const BwdArgs& a = w.a;
  // with no q rows nothing is streamed; q/dO maps then describe k
  const bool rows = a.sq > 0;
  if (!encode_rows_bf16(&w.tk, a.k, a.skv, a.n, a.d, T::BM) ||
      !encode_rows_bf16(&w.tv, a.v, a.skv, a.n, a.d, T::BM) ||
      !encode_rows_bf16(&w.tq, rows ? a.q : a.k, rows ? a.sq : a.skv, a.n,
                        a.d, T::BN) ||
      !encode_rows_bf16(&w.tdo, rows ? a.dout : a.k, rows ? a.sq : a.skv,
                        a.n, a.d, T::BN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.skv + T::BM - 1) / T::BM, a.n, T::DP / T::DCOL);
  return launch(flash_dkv_wgmma_kernel<T>, grid, T::NT, T::SMEM, stream, w);
}

// ---------------------------------------------------------------------------
// wgmma instance above D = 256 (WideTiles, output steps: flash_wide.cuh)
// ---------------------------------------------------------------------------

// The score steps of one tile: acc (64 x BN) = A·Bᵀ over the nb column
// boxes of ring steps [step, step + nb), A the box at `aoff` bytes into
// each stage and B the next one, both K-major.  Each step's products are
// one commit group; a stage is released once the group after it is issued
// and its own has completed.  Returns with every group complete.
template <class T>
__device__ __forceinline__ void wide_scores(float (&acc)[T::BN / 2],
                                            uint8_t* ring, uint64_t* full,
                                            uint64_t* bar_free, int step,
                                            int nb, int aoff, int lane) {
  using namespace pa_sm90;
  constexpr int ST = T::STAGES;
  for (int b = 0; b < nb; ++b) {
    const int st = (step + b) % ST;
    mbar_wait(&full[st], ((step + b) / ST) & 1);
    const uint8_t* A = ring + st * T::STAGE + aoff;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss_n64(acc, wgmma_desc(A + 32 * kc, 16, 1024),
                   wgmma_desc(A + T::BOX + 32 * kc, 16, 1024),
                   b > 0 || kc > 0);
    wgmma_commit();
    if (b > 0) {
      wgmma_wait<1>();
      release_stage(bar_free, (step + b - 1) % ST, lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_stage(bar_free, (step + nb - 1) % ST, lane);
}

// The producer's loads of a score step: four boxes at column c, maps a0,
// b0, a1, b1 at rows ra, rb, ra, rb.
__device__ __forceinline__ void wide_load_scores(
    uint8_t* ring, uint64_t* full, uint64_t* bar_free, int step,
    const CUtensorMap* a0, const CUtensorMap* b0, const CUtensorMap* a1,
    const CUtensorMap* b1, int c, int hb, int ra, int rb) {
  using namespace pa_sm90;
  constexpr int BOX = WideTiles::BOX;
  uint64_t* bar = &full[step % WideTiles::STAGES];
  uint8_t* dst = wide_stage(ring, full, bar_free, step, 4 * BOX);
  tma_load_3d(dst, a0, bar, c, hb, ra);
  tma_load_3d(dst + BOX, b0, bar, c, hb, rb);
  tma_load_3d(dst + 2 * BOX, a1, bar, c, hb, ra);
  tma_load_3d(dst + 3 * BOX, b1, bar, c, hb, rb);
}

// K3 above D = 256: one CTA per (64 q rows, slice, 512 columns of dq), key
// tiles inner.  Warpgroup 0 builds S = Q·Kᵀ and P, warpgroup 1 dP = dO·Vᵀ
// (each score step one column box of Q and K, or of dO and V); they swap P
// and dP through shared memory, each forms dS = P∘(dP - D) and accumulates
// dQ += dS·K over its own 256 columns (warpgroup w: col0 + 256 w ..).
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dq_wgmma_wide_kernel(const __grid_constant__ BwdWgArgs w) {
  using namespace pa_sm90;
  constexpr int BQ = T::BM, BK = T::BN, ST = T::STAGES, BOX = T::BOX;
  const BwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_full[ST], bar_free[ST];
  uint8_t* ring = align1024(smem_raw);
  float* xch = reinterpret_cast<float*>(ring + ST * T::STAGE);

  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
  const int col0 = blockIdx.z * T::DQ_COLS;
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, BQ, BK);
  const int nb = (a.d + 63) / 64;                // score steps a tile
  const int na = col0 + 128 < a.d ? 2 : 1;       // output steps a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: per key tile, Q/K/dO/V box b for each score step, then K's
    // boxes of the output steps (warpgroup 0's two, warpgroup 1's two)
    setmaxnreg_dec<T::PREG>();
    if (warp == 8 && lane == 0) {
      int step = 0;
      for (int kt = 0; kt < nk; ++kt) {
        const int c0 = kt * BK;
        for (int b = 0; b < nb; ++b, ++step)
          wide_load_scores(ring, bar_full, bar_free, step, &w.tq, &w.tk,
                           &w.tdo, &w.tv, 64 * b, hb, (int)r0, c0);
        for (int j = 0; j < na; ++j, ++step)
          wide_load_outputs(ring, bar_full, bar_free, step, &w.tk, &w.tk,
                            col0 + 128 * j, 256, hb, c0, a.d);
      }
    }
  } else {
    setmaxnreg_inc<T::CREG>();
    // consumers: both warpgroups hold the tile's 64 q rows; lane (g, t) of
    // warp wq holds rows 16 wq + g (+ 8) of each fragment
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
    const int tid = threadIdx.x % 128;
    const long long row0 = r0 + wq * 16 + g;
    const long long qpos[2] = {a.q_off + row0, a.q_off + row0 + 8};
    const float sl2 = a.scale * kLog2e;
    float lrow[2], drow[2];   // L·log2(e) and D of the fragment's two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      const bool in = row < a.sq;
      lrow[h] = in ? a.L[(size_t)hb * a.sq + row] * kLog2e : INFINITY;
      drow[h] = in ? a.D[(size_t)hb * a.sq + row] : 0.f;
    }
    float acc0[64], acc1[64], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    int step = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const long long c0 = (long long)kt * BK;
      // S (warpgroup 0: boxes Q, K) or dP (warpgroup 1: dO, V)
      wide_scores<T>(sc, ring, bar_full, bar_free, step, nb, 2 * wg * BOX,
                     lane);
      step += nb;
      float* mine = xch + (2 * (kt & 1) + wg) * T::XCH;
      const float* other = xch + (2 * (kt & 1) + (wg ^ 1)) * T::XCH;
      if (wg == 0) {
        // P = exp(scale·S - L), masked only where the tile crosses the key
        // tail or the diagonal; a masked entry never reaches the exp
        const bool edge =
            c0 + BK > a.skv ||
            (a.causal && a.q_off + r0 < a.kv_off + c0 + BK - 1);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int h = (i >> 1) & 1;
          bool valid = true;
          if (edge) {
            const long long col = c0 + 8 * (i / 4) + 2 * t + (i & 1);
            valid = col < a.skv && (!a.causal || qpos[h] >= a.kv_off + col);
          }
          sc[i] = valid ? exp2f(fmaf(sc[i], sl2, -lrow[h])) : 0.f;
        }
      }
      // swap P and dP (same fragment layout in both warpgroups), then
      // dS = P∘(dP - D) in both
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mine[i * 128 + tid] = sc[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float o = other[i * 128 + tid], dr = drow[(i >> 1) & 1];
        sc[i] = wg == 0 ? sc[i] * (o - dr) : o * (sc[i] - dr);
      }
      uint32_t pa[BK / 16][4];
      pack_a<BK>(pa, sc);
      // dQ += dS·K over this warpgroup's 256 columns
      wide_outputs<T>(acc0, acc1, pa, ring, bar_full, bar_free, step, na,
                      2 * wg * BOX, col0 + 256 * wg, a.d, lane);
      step += na;
    }
    const int c = col0 + 256 * wg;
    store_frag<128>(a.g0, a.g_dt, acc0, row0, a.sq, a.n, hb, a.d, c, t,
                    a.scale);
    store_frag<128>(a.g0, a.g_dt, acc1, row0, a.sq, a.n, hb, a.d, c + 128,
                    t, a.scale);
  }  // consumers
}

// K4 above D = 256: one CTA per (64 keys, slice, 256 columns of dk and
// dv), q tiles inner.  Warpgroup 0 builds Sᵀ = K·Qᵀ and Pᵀ and accumulates
// dV += Pᵀ·dO; warpgroup 1 builds dPᵀ = V·dOᵀ, takes Pᵀ from warpgroup 0
// through shared memory, forms dSᵀ and accumulates dK += dSᵀ·Q.
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_dkv_wgmma_wide_kernel(const __grid_constant__ BwdWgArgs w) {
  using namespace pa_sm90;
  constexpr int BK = T::BM, BQ = T::BN, ST = T::STAGES, BOX = T::BOX;
  const BwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_full[ST], bar_free[ST];
  uint8_t* ring = align1024(smem_raw);
  float* xch = reinterpret_cast<float*>(ring + ST * T::STAGE);

  // CTAs in the order of their linear index, key tiles outer: under a
  // causal mask the first key tiles see the most q rows and start first
  const long long lin = blockIdx.x + (long long)blockIdx.y * gridDim.x;
  const int hb = (int)(lin % a.n);
  const long long c0 = lin / a.n * BK;
  const int col0 = blockIdx.z * T::DKV_COLS;
  const int nq = (a.sq + BQ - 1) / BQ;
  int q0 = 0;   // the first q tile whose last row reaches key c0
  if (a.causal) {
    const long long lim = a.kv_off + c0 - a.q_off - (BQ - 1);
    if (lim > 0) q0 = (int)min((long long)nq, (lim + BQ - 1) / BQ);
  }
  const int nt = nq - q0;
  const int nb = (a.d + 63) / 64;
  const int na = col0 + 128 < a.d ? 2 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: per q tile, K/Q/V/dO box b for each score step, then the
    // boxes of the output steps (dO's two for warpgroup 0, Q's two for 1)
    setmaxnreg_dec<T::PREG>();
    if (warp == 8 && lane == 0) {
      int step = 0;
      for (int it = 0; it < nt; ++it) {
        const int r0 = (q0 + it) * BQ;
        for (int b = 0; b < nb; ++b, ++step)
          wide_load_scores(ring, bar_full, bar_free, step, &w.tk, &w.tq,
                           &w.tv, &w.tdo, 64 * b, hb, (int)c0, r0);
        for (int j = 0; j < na; ++j, ++step)
          wide_load_outputs(ring, bar_full, bar_free, step, &w.tdo, &w.tq,
                            col0 + 128 * j, 0, hb, r0, a.d);
      }
    }
  } else {
    setmaxnreg_inc<T::CREG>();
    // consumers: both warpgroups hold the CTA's 64 keys; in the transposed
    // blocks lane (g, t) of warp wq holds keys 16 wq + g (+ 8) and q
    // columns 8 j + 2 t (+ 1)
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
    const int tid = threadIdx.x % 128;
    const long long krow0 = c0 + wq * 16 + g;
    const long long kpos[2] = {a.kv_off + krow0, a.kv_off + krow0 + 8};
    const float sl2 = a.scale * kLog2e;
    float acc0[64], acc1[64], sc[BQ / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = 0.f;
    int step = 0;
    for (int it = 0; it < nt; ++it) {
      const long long r0 = (long long)(q0 + it) * BQ;
      // Sᵀ (warpgroup 0: boxes K, Q) or dPᵀ (warpgroup 1: V, dO)
      wide_scores<T>(sc, ring, bar_full, bar_free, step, nb, 2 * wg * BOX,
                     lane);
      step += nb;
      float* pbuf = xch + (it & 1) * T::XCH;
      if (wg == 0) {
        // Pᵀ with L per column (q row; +inf past Sq, so P = 0 there
        // without a mask); the causal mask only where the tile crosses
        // the diagonal
        const bool edge =
            a.causal && a.q_off + r0 < a.kv_off + c0 + BK - 1;
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int h = (i >> 1) & 1;
          const int c = 8 * (i / 4) + 2 * t + (i & 1);
          const long long row = r0 + c;
          const float lc = row < a.sq
                               ? a.L[(size_t)hb * a.sq + row] * kLog2e
                               : INFINITY;
          const bool valid = !edge || a.q_off + row >= kpos[h];
          sc[i] = valid ? exp2f(fmaf(sc[i], sl2, -lc)) : 0.f;
          pbuf[i * 128 + tid] = sc[i];
        }
      }
      named_bar_sync(1, 256);
      if (wg == 1) {
        // dSᵀ = Pᵀ∘(dPᵀ - D), D per column
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const long long row = r0 + 8 * (i / 4) + 2 * t + (i & 1);
          const float dc = row < a.sq ? a.D[(size_t)hb * a.sq + row] : 0.f;
          sc[i] = pbuf[i * 128 + tid] * (sc[i] - dc);
        }
      }
      uint32_t pa[BQ / 16][4];
      pack_a<BQ>(pa, sc);
      // warpgroup 0: dV += Pᵀ·dO; warpgroup 1: dK += dSᵀ·Q
      wide_outputs<T>(acc0, acc1, pa, ring, bar_full, bar_free, step, na,
                      2 * wg * BOX, col0, a.d, lane);
      step += na;
    }
    void* out = wg == 0 ? a.g1 : a.g0;
    const float mul = wg == 0 ? 1.f : a.scale;
    store_frag<128>(out, a.g_dt, acc0, krow0, a.skv, a.n, hb, a.d, col0, t,
                    mul);
    store_frag<128>(out, a.g_dt, acc1, krow0, a.skv, a.n, hb, a.d,
                    col0 + 128, t, mul);
  }  // consumers
}

// Tensor maps of every operand with 64-row boxes (rows past a tensor
// arrive as zeros; with no rows on one side nothing is loaded, and that
// side's maps describe the other's tensors).
inline bool wide_maps(BwdWgArgs& w) {
  using pa_sm90::encode_rows_bf16;
  const BwdArgs& a = w.a;
  const bool keys = a.skv > 0, rows = a.sq > 0;
  return encode_rows_bf16(&w.tq, rows ? a.q : a.k, rows ? a.sq : a.skv, a.n,
                          a.d, 64) &&
         encode_rows_bf16(&w.tdo, rows ? a.dout : a.k, rows ? a.sq : a.skv,
                          a.n, a.d, 64) &&
         encode_rows_bf16(&w.tk, keys ? a.k : a.q, keys ? a.skv : a.sq, a.n,
                          a.d, 64) &&
         encode_rows_bf16(&w.tv, keys ? a.v : a.q, keys ? a.skv : a.sq, a.n,
                          a.d, 64);
}

int run_dq_wgmma_wide(BwdWgArgs& w, void* stream) {
  using T = WideTiles;
  const BwdArgs& a = w.a;
  if (!wide_maps(w)) return (int)cudaErrorInvalidValue;
  dim3 grid((a.sq + T::BM - 1) / T::BM, a.n,
            (a.d + T::DQ_COLS - 1) / T::DQ_COLS);
  return launch(flash_dq_wgmma_wide_kernel<T>, grid, T::NT, T::SMEM, stream,
                w);
}

int run_dkv_wgmma_wide(BwdWgArgs& w, void* stream) {
  using T = WideTiles;
  const BwdArgs& a = w.a;
  if (!wide_maps(w)) return (int)cudaErrorInvalidValue;
  dim3 grid((a.skv + T::BM - 1) / T::BM, a.n,
            (a.d + T::DKV_COLS - 1) / T::DKV_COLS);
  return launch(flash_dkv_wgmma_wide_kernel<T>, grid, T::NT, T::SMEM, stream,
                w);
}

}  // namespace pa_flash

// q, k, v and dout bf16 with d <= 1024; dq in dq_dt.
extern "C" int pa_flash_bwd_dq_wgmma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* L, const float* D, void* dq,
                                     int dq_dt, int n, int sq, int skv, int d,
                                     float scale, int causal, long long q_off,
                                     long long kv_off, void* stream) {
  using namespace pa_flash;
  BwdWgArgs w{};
  w.a = BwdArgs{q,     k,   v,   dout, kBF16, kBF16, kBF16,
                kBF16, L,   D,   dq,   nullptr, dq_dt, n,
                sq,    skv, d,   scale, causal, q_off, kv_off};
  if (d <= 64) return run_dq_wgmma<BwdTiles<64, 64>>(w, stream);
  if (d <= 128) return run_dq_wgmma<BwdTiles<128, 64>>(w, stream);
  if (d <= 256) return run_dq_wgmma<BwdTiles<256, 32>>(w, stream);
  if (d <= 1024) return run_dq_wgmma_wide(w, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k, v and dout bf16 with d <= 1024; dk and dv in dkv_dt.
extern "C" int pa_flash_bwd_dkv_wgmma(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* L, const float* D,
                                      void* dk, void* dv, int dkv_dt, int n,
                                      int sq, int skv, int d, float scale,
                                      int causal, long long q_off,
                                      long long kv_off, void* stream) {
  using namespace pa_flash;
  BwdWgArgs w{};
  w.a = BwdArgs{q,     k,   v,  dout, kBF16,  kBF16, kBF16,
                kBF16, L,   D,  dk,   dv,     dkv_dt, n,
                sq,    skv, d,  scale, causal, q_off, kv_off};
  if (d <= 64) return run_dkv_wgmma<BwdTiles<64, 64>>(w, stream);
  if (d <= 128) return run_dkv_wgmma<BwdTiles<128, 64>>(w, stream);
  if (d <= 256) return run_dkv_wgmma<BwdTiles<256, 32, 128>>(w, stream);
  if (d <= 1024) return run_dkv_wgmma_wide(w, stream);
  return (int)cudaErrorInvalidValue;
}
