// K2 — forward flash attention for Hopper (sm_90a), CUDA C++: two
// instances, picked per call by ops/flash.py::fwd_instance, and the
// retired simt one.
//
// Replaces the TPU kernel pencilarrays_tpu/ops/flash_pallas.py::_flash_kernel
// (launched by pallas_flash_attention, pallas_call at :287).  The TPU kernel
// carried the online-softmax state (running max m, denominator l, f32
// accumulator) in VMEM across the sequential key-block grid dimension;
// here one CTA owns a (head·batch slice, q tile) and a loop over key tiles
// inside it takes that dimension's place, with m, l and the accumulator in
// registers.
//
// Bound: operations.  4·Sq·Skv·D FLOPs per slice (halved when causal) over
// q/k/v reads of (Sq + 2·Skv)·D elements: at S = 4096, D = 128 about 1000
// FLOPs a byte, far above the card's balance point.  The least time is the
// FLOPs over 989 TFLOP/s (bf16, tensor cores) or, for f32, 165 TFLOP/s
// (three TF32 tensor-core products per f32 product, which beats the CUDA
// cores' 67).
//
// * wgmma instance (q, k, v all bf16, every D <= 1024): tensor cores.
//   Up to D = 256 one producer warp loads Q once and keeps a ring of two
//   K/V stages in flight with TMA (128-byte swizzled boxes, zero-filled
//   past the tensor) on mbarriers; two consumer warpgroups of 64 q rows
//   each run S = Q·Kᵀ as a shared-shared wgmma and O += P·V as a
//   register-shared wgmma, P going from the S accumulator to the A
//   fragment in registers (the bf16 rounding of P is that conversion).
//   The softmax runs on the accumulator fragment: a row lives in the 4
//   lanes of a quad.
// * tf32x3 instance (any f32 operand, D <= 256): tensor cores at f32
//   accuracy, mma.sync m16n8k8 TF32 with three products per f32 product
//   (flash_bwd_tf32.cu's header says why).  K3's tf32x3 tiles: a CTA of
//   BQ / 16 warps, warp w owning q rows [16 w, 16 w + 16), streams key
//   tiles of BK; the m16n8 S accumulator is P's A fragment (its k slots
//   t and t + 4 standing for keys 2t and 2t + 1), so P stays in
//   registers.  K3's kernel splits every fragment value in every warp
//   (two roundings, four integer operations).  Here every tile is split
//   once a CTA, when it lands: cp.async copies the raw tile (a bf16
//   operand of a mix raw, widened in the split pass) into a landing
//   buffer, and one pass of all threads writes it as (big, big, small,
//   small) units of two columns, so a fragment load is one 16-byte load
//   that carries both parts of two k slots.  Q is split once into a resident tile; the copy
//   of K/V tile i + 1 flies under tile i.  The mma's k slots are permuted
//   within each k8 step (slots t, t + 4 = columns 2t, 2t + 1) for S, and
//   O's n index g of n-tile c stands for column 16 (c / 2) + 2 g + c % 2,
//   so the V loads are units too and a lane's O columns come out as four
//   consecutive floats.  Units sit at u ^ swz(row) (split_tile), which
//   puts the quarter-warp of every 16-byte fragment load on 32 distinct
//   banks.  At D = 256 two groups of warps hold the same rows and split
//   the head dim (O of 16 rows x 256 columns would take 128 registers a
//   thread): each reduces S over its 128 columns, they swap the partial
//   S through shared memory and add it in one order, and each accumulates
//   its 128 columns of O.  Sums: a fresh accumulator for every 32 columns
//   of S and for each key tile's P·V, moved into the running value by an
//   f32 add (the tensor cores round their accumulation toward zero; see
//   below).  On an H100 it does about 40 TFLOP/s of f32 work at D = 128,
//   as K3's kernel does with its per-fragment split: a tile's phases
//   (split, S, softmax, P·V) run one after another in every warp between
//   the tile's barriers, and neither more accumulator chains nor S on
//   wgmma's TF32 form moved it; overlapping the phases is the next step
//   (ROADMAP Queue 2).
// * simt instance (retired: only launch_fwd(..., instance="simt") runs
//   it, so chip_smoke.py's phase 9 times it beside tf32x3): CUDA-core f32
//   FMA, register-blocked, D <= 256.  Each thread computes an RI x CJ
//   block of S and an RI x DJ block of O from 16-byte shared loads; K and
//   V tiles arrive by cp.async, bf16 operands of a mix widened in shared
//   memory after they land.
// * the wide kernels, 256 < D <= 1024, wgmma (all bf16) and tf32x3 (any
//   f32 operand): a Q tile, a K/V stage and the O accumulator of a row
//   tile do not fit there (O of 64 rows x 512 columns is 128 f32 registers
//   a thread across two warpgroups; a wgmma accumulator is at most 256
//   wide).  So K and V stream through one ring of TMA boxes
//   (flash_wide.cuh), and two groups of warps hold the same 64 q rows.
//   Each reduces S = Q·Kᵀ over half of the column boxes (the boxes
//   alternate between the groups), they swap the f32 partial S through
//   shared memory, and each adds the two partials in the same f32 sum
//   (a + b == b + a), so both run the identical online softmax and hold
//   bit-identical m and l; each then accumulates O over its own 256
//   columns from V's boxes.  Above 512 columns the CTAs of gridDim.z
//   split the output columns, each rebuilding S.  FLOPs executed per
//   (q row, key) pair, against the bound's 4·D: (2·z + 2)·D with
//   z = ceil(D / 512), so 4·D up to D = 512 and 6·D at 1024.
//   - wgmma: a producer warp feeds 64-row x 64-column bf16 boxes, four a
//     stage; S as shared-shared wgmma m64n64, O += P·V register-shared
//     from MN-major V boxes (flash_bwd.cu's wide K3 is the same ring).
//     Up to D = 512 Q's boxes (64 KB) stay resident and a score step
//     carries four K boxes; above, Q streams beside K, two boxes each a
//     step (resident, the ring moves a third less a tile: faster in
//     short calls on the card).  Each warpgroup's score block has one
//     buffer, written again only once the other warpgroup has read it
//     (an mbarrier, which a second named barrier would make lockstep).
//   - tf32x3: nothing resident (Q of 64 rows x 512 f32 columns is 128
//     KB); thread 0 streams boxes of 32 f32 columns, 64 q rows and 32
//     keys a tile; mma.sync TF32 with three products per f32 product
//     (flash_bwd_tf32.cu's header says why).  The tensor cores round their
//     accumulation toward zero, and K2's f32 bar is 1e-5: each 32-column
//     box of S and each key tile's P·V go to a fresh accumulator that an
//     f32 add, rounding to nearest, moves into the running value
//     (tests/test_torch_flash.py emulates this arithmetic: about 1.6e-6
//     of a row's scale; one accumulator over D = 1024, or over 8192 keys,
//     misses 1e-5, and over D = 512 reaches 1.1e-5).  TMA copies
//     bytes as they are, so the kernel reads f32 q, k and v: ops/flash.py
//     widens a bf16 operand first and passes v's own dtype, so that P is
//     rounded to bf16 before P·V when v was bf16.
//
// Conventions kept from the TPU kernel: masked scores are NEG =
// finfo(f32).min / 2; the key tail is masked by position; the causal mask
// is start-aligned by global position with per-call q/kv offsets; key
// tiles wholly above the diagonal are skipped (the loop ends there, since
// the predicate only gets harder as keys advance); l == 0 -> 1 in the
// final division; for bf16 v the probabilities are rounded to bf16 before
// P·V (the denominator sums them unrounded); the last q tiles, which see
// the most keys under a causal mask, start first (cta_tile).
//
// Outputs, each optional (null pointer = not written): `out` = acc / l in
// out_dt, folded (Sq, N, D); `acc` = raw f32 accumulator (Sq, N, D);
// `m`, `l` = f32 row statistics (N, Sq).  Rows >= Sq and columns >= D are
// never written.
#include "flash_wide.cuh"

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

// ---------------------------------------------------------------------------
// wgmma instance
// ---------------------------------------------------------------------------

struct WgArgs {
  CUtensorMap tq, tk, tv;  // bf16 (s, n, d) maps, boxes {64, 1, rows}
  FwdArgs a;
};

// Tiles by head-dim class DP (D rounded up to 64, 128 or 256): BQ = 128
// (two consumer warpgroups), BK keys a stage, two stages; a third
// warpgroup is the producer, of which one thread starts the loads and which
// hands its registers to the consumers (24 left; 240 a consumer thread).
// Shared memory = NB·(BQ + 4·BK)·128 bytes + 1 KB of alignment slack;
// registers a consumer thread: DP/2 (O) + BK/2 (S) + BK/4 (P) floats and
// words.
//   DP  64: BK 128 ( 81 KB)    DP 128: BK 128 (161 KB)
//   DP 256: BK  64 (193 KB)
template <int DP_, int BK_>
struct WgTiles {
  static constexpr int DP = DP_, BK = BK_, BQ = 128, NB = DP / 64;
  static constexpr int STAGES = 2, NT = 384;  // 2 consumer + 1 producer
  static constexpr int Q_BYTES = NB * BQ * 128, KV_BYTES = NB * BK * 128;
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ WgArgs w) {
  using namespace pa_sm90;
  constexpr int BQ = T::BQ, BK = T::BK, DP = T::DP, NB = T::NB,
                ST = T::STAGES;
  constexpr float kLog2e = 1.4426950408889634f;
  const FwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[ST], bar_v[ST], bar_free[ST];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + T::Q_BYTES;           // stage st at st * KV_BYTES
  uint8_t* Vs = Ks + ST * T::KV_BYTES;

  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
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
    // producer: Q once, then K/V tiles through the two-stage ring
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0 && nk > 0) {
      mbar_arrive_expect_tx(&bar_q, T::Q_BYTES);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(Qs + b * BQ * 128, &w.tq, &bar_q, b * 64, hb, (int)r0);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST, u = kt / ST;
        if (u > 0) mbar_wait(&bar_free[st], (u - 1) & 1);
        uint8_t* kd = Ks + st * T::KV_BYTES;
        uint8_t* vd = Vs + st * T::KV_BYTES;
        mbar_arrive_expect_tx(&bar_k[st], T::KV_BYTES);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(kd + b * BK * 128, &w.tk, &bar_k[st], b * 64, hb,
                      kt * BK);
        mbar_arrive_expect_tx(&bar_v[st], T::KV_BYTES);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(vd + b * BK * 128, &w.tv, &bar_v[st], b * 64, hb,
                      kt * BK);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile;
    // in the m64 accumulator fragment, lane (g, t) = (lane / 4, lane % 4) of
    // warp wq holds rows 16 wq + g (+ 8) and columns 8 j + 2 t (+ 1):
    // register 4 j + e is row half e >> 1, column 8 j + 2 t + (e & 1).
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
    const long long row0 = r0 + wg * 64 + wq * 16 + g;  // tile row of half 0
    const long long qpos[2] = {a.q_off + row0, a.q_off + row0 + 8};
    float o[DP / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
    if (nk > 0) mbar_wait(&bar_q, 0);
    const uint8_t* Qw = Qs + wg * 64 * 128;

    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST, u = kt / ST;
      const long long c0 = (long long)kt * BK;
      const uint8_t* Kt = Ks + st * T::KV_BYTES;
      const uint8_t* Vt = Vs + st * T::KV_BYTES;

      // S = Q·Kᵀ over DP in steps of 16 (32 bytes inside a 128-byte box row)
      mbar_wait(&bar_k[st], u & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const int off = (kc % 4) * 32;
        const uint64_t da =
            wgmma_desc(Qw + (kc / 4) * BQ * 128 + off, 16, 1024);
        const uint64_t db =
            wgmma_desc(Kt + (kc / 4) * BK * 128 + off, 16, 1024);
        if constexpr (BK == 128)
          wgmma_ss_n128(s, da, db, kc > 0);
        else
          wgmma_ss_n64(s, da, db, kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax on the fragment; masks only where the tile crosses
      // the key tail or the diagonal
      const bool edge =
          c0 + BK > a.skv ||
          (a.causal && a.q_off + r0 + wg * 64 < a.kv_off + c0 + BK - 1);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        float x = s[i] * a.scale;
        if (edge) {
          const long long col = c0 + 8 * (i / 4) + 2 * t + (i & 1);
          const bool valid =
              col < a.skv && (!a.causal || qpos[h] >= a.kv_off + col);
          x = valid ? x : kNeg;
        }
        s[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float corr[2], mscaled[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(mrow[h], row_max<4>(mx[h]));
        corr[h] = exp2f((mrow[h] - mn) * kLog2e);
        mrow[h] = mn;
        mscaled[h] = mn * kLog2e;
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = exp2f(fmaf(s[i], kLog2e, -mscaled[h]));
        rs[h] += s[i];
      }
      pack_a<BK>(pa, s);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lrow[h] = lrow[h] * corr[h] + row_sum<4>(rs[h]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P·V: V is the MN-major B operand; 16 key rows (2048 bytes) a
      // step, its 64-column boxes BK·128 bytes apart
      mbar_wait(&bar_v[st], u & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = wgmma_desc(Vt + kk * 16 * 128, BK * 128, 1024);
        if constexpr (DP == 256)
          wgmma_rs_n256(o, pa[kk], db);
        else if constexpr (DP == 128)
          wgmma_rs_n128(o, pa[kk], db);
        else
          wgmma_rs_n64(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      if (row >= a.sq) continue;
      const size_t base = ((size_t)row * a.n + hb) * a.d;
      const float den = lrow[h] == 0.f ? 1.f : lrow[h];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;  // d % 8 == 0: col < d => col + 1 < d
        if (col >= a.d) continue;
        const float x0 = o[4 * j + 2 * h], x1 = o[4 * j + 2 * h + 1];
        if (a.out) {
          if (a.out_dt == kBF16)
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.out) + base + col) =
                __floats2bfloat162_rn(x0 / den, x1 / den);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base +
                                       col) = make_float2(x0 / den, x1 / den);
        }
        if (a.acc)
          *reinterpret_cast<float2*>(a.acc + base + col) = make_float2(x0, x1);
      }
      if (a.m && t == 0) {
        a.m[(size_t)hb * a.sq + row] = mrow[h];
        a.l[(size_t)hb * a.sq + row] = lrow[h];
      }
    }
  }  // consumers
}

template <class T>
int run_wgmma(WgArgs& w, void* stream) {
  using pa_sm90::encode_rows_bf16;
  const FwdArgs& a = w.a;
  // with no keys nothing is loaded; k/v maps then describe q
  const bool keys = a.skv > 0;
  if (!encode_rows_bf16(&w.tq, a.q, a.sq, a.n, a.d, T::BQ) ||
      !encode_rows_bf16(&w.tk, keys ? a.k : a.q, keys ? a.skv : a.sq, a.n,
                        a.d, T::BK) ||
      !encode_rows_bf16(&w.tv, keys ? a.v : a.q, keys ? a.skv : a.sq, a.n,
                        a.d, T::BK))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.sq + T::BQ - 1) / T::BQ, a.n);
  return launch(flash_fwd_wgmma_kernel<T>, grid, T::NT, T::SMEM, stream, w);
}

// ---------------------------------------------------------------------------
// the wide kernels (256 < D <= 1024): shared pieces
// ---------------------------------------------------------------------------

// out = o / l in out_dt, acc = o raw, for the 16 x N fragment o of a warp
// (rows row0 and row0 + 8, columns col0 + 8 j + 2 t (+1) at o[4 j + 2 h
// (+1)]: a wgmma m64 fragment or N / 8 mma.sync m16n8 ones); rows < sq and
// columns < d only (d % 8 == 0: col < d implies col + 1 < d).
template <int N>
__device__ __forceinline__ void store_rows(const FwdArgs& a,
                                           const float (&o)[N / 2],
                                           long long row0, int hb, int col0,
                                           int t, const float (&lrow)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    if (row >= a.sq) continue;
    const size_t base = ((size_t)row * a.n + hb) * a.d;
    const float den = lrow[h] == 0.f ? 1.f : lrow[h];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      if (col >= a.d) continue;
      const float x0 = o[4 * j + 2 * h], x1 = o[4 * j + 2 * h + 1];
      if (a.out) {
        if (a.out_dt == kBF16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + base + col) =
              __floats2bfloat162_rn(x0 / den, x1 / den);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base +
                                     col) = make_float2(x0 / den, x1 / den);
      }
      if (a.acc)
        *reinterpret_cast<float2*>(a.acc + base + col) = make_float2(x0, x1);
    }
  }
}

// One tile's online-softmax update on the summed score fragment s (a
// warp's 16 rows x NC keys: register i is row half (i >> 1) & 1, key
// c0 + 8 (i / 4) + 2 t + (i & 1)): scale, mask where the tile crosses the
// key tail or the diagonal (`edge`), the new running max m, the
// correction corr[h] = exp(m_old - m), P = exp(scale·S - m) into s,
// rounded to bf16 when round_p (the denominator sums it unrounded), and
// l = l·corr + rowsum(P).  Both groups of warps run it on the same values.
template <int NC>
__device__ __forceinline__ void online_softmax(float (&s)[NC / 2],
                                               float (&mrow)[2],
                                               float (&lrow)[2],
                                               float (&corr)[2],
                                               const FwdArgs& a, bool edge,
                                               long long c0,
                                               const long long (&qpos)[2],
                                               int t, bool round_p) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int h = (i >> 1) & 1;
    float x = s[i] * a.scale;
    if (edge) {
      const long long col = c0 + 8 * (i / 4) + 2 * t + (i & 1);
      const bool valid =
          col < a.skv && (!a.causal || qpos[h] >= a.kv_off + col);
      x = valid ? x : kNeg;
    }
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float mscaled[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(mrow[h], row_max<4>(mx[h]));
    corr[h] = exp2f((mrow[h] - mn) * kLog2e);
    mrow[h] = mn;
    mscaled[h] = mn * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(fmaf(s[i], kLog2e, -mscaled[h]));
    rs[h] += p;
    s[i] = round_p ? round_bf16(p) : p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) lrow[h] = lrow[h] * corr[h] + row_sum<4>(rs[h]);
}

// ---------------------------------------------------------------------------
// wgmma instance above D = 256
// ---------------------------------------------------------------------------

// The producer's loads of a score step, into the stage's four slots: with
// Q streamed (QRES 0), Q's and K's boxes at column c (rows rq and rk),
// and at c + 64 unless that is past d; with Q resident (QRES 1), K's boxes
// at columns c + 64 i (i < 4), none past d.
template <int QRES>
__device__ __forceinline__ void fwd_load_scores(
    uint8_t* ring, uint64_t* full, uint64_t* bar_free, int step,
    const CUtensorMap* tq, const CUtensorMap* tk, int c, int hb, int rq,
    int rk, int d) {
  using namespace pa_sm90;
  constexpr int BOX = WideTiles::BOX;
  uint64_t* bar = &full[step % WideTiles::STAGES];
  int live = 0;
  for (int i = 0; i < (QRES ? 4 : 2); ++i) live += c + 64 * i < d;
  uint8_t* dst =
      wide_stage(ring, full, bar_free, step, (QRES ? 1 : 2) * live * BOX);
  for (int i = 0; i < live; ++i) {
    if (QRES) {
      tma_load_3d(dst + i * BOX, tk, bar, c + 64 * i, hb, rk);
    } else {
      tma_load_3d(dst + 2 * i * BOX, tq, bar, c + 64 * i, hb, rq);
      tma_load_3d(dst + (2 * i + 1) * BOX, tk, bar, c + 64 * i, hb, rk);
    }
  }
}

// A warpgroup's part of one tile's scores: acc (64 x BN) = Q·Kᵀ over its
// column boxes of ring steps [step, step + ns), both operands K-major.
// Q streamed: box 2 s + wg of nb, Q's at slot 2 wg of the stage, K's at
// 2 wg + 1.  Q resident (at Qs): boxes 4 s + wg and 4 s + 2 + wg, K's at
// slots wg and 2 + wg.  A warpgroup may have none in the last step.  Each
// box's products are one commit group, issued whole or not at all (a
// group whose wgmma ops sit in a branch of their own keeps ptxas from
// serializing them); a stage is released once its groups have completed.
// Returns with every group complete.
template <class T, int QRES>
__device__ __forceinline__ void fwd_scores(float (&acc)[T::BN / 2],
                                           const uint8_t* Qs, uint8_t* ring,
                                           uint64_t* full, uint64_t* bar_free,
                                           int step, int ns, int nb, int wg,
                                           int lane) {
  using namespace pa_sm90;
  constexpr int ST = T::STAGES, BOX = T::BOX;
  for (int s = 0; s < ns; ++s) {
    const int st = (step + s) % ST;
    mbar_wait(&full[st], ((step + s) / ST) & 1);
    const uint8_t* stage = ring + st * T::STAGE;
    const int b0 = QRES ? 4 * s + wg : 2 * s + wg;
    const bool live0 = b0 < nb, live1 = QRES && b0 + 2 < nb;
    if (live0) {
      const uint8_t* A = QRES ? Qs + b0 * BOX : stage + 2 * wg * BOX;
      const uint8_t* B = QRES ? stage + wg * BOX : A + BOX;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_ss_n64(acc, wgmma_desc(A + 32 * kc, 16, 1024),
                     wgmma_desc(B + 32 * kc, 16, 1024), s > 0 || kc > 0);
      wgmma_commit();
    }
    if (live1) {
      const uint8_t* A = Qs + (b0 + 2) * BOX;
      const uint8_t* B = stage + (2 + wg) * BOX;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_ss_n64(acc, wgmma_desc(A + 32 * kc, 16, 1024),
                     wgmma_desc(B + 32 * kc, 16, 1024), 1);
      wgmma_commit();
    }
    if (s > 0) {   // this step's groups may stay in flight
      if (live1)
        wgmma_wait<2>();
      else if (live0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      release_stage(bar_free, (step + s - 1) % ST, lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_stage(bar_free, (step + ns - 1) % ST, lane);
}

// Shared memory of the wide wgmma kernel: Q's boxes when resident (D <=
// 512: 64 KB), the ring (4 x 32 KB) and one f32 score block a warpgroup
// (2 x 16 KB), + 1 KB of alignment slack: 225 KB resident, 161 streamed.
template <int QRES>
struct FwdWide {
  using T = WideTiles;
  static constexpr int Q_BYTES = QRES ? 8 * T::BOX : 0;
  static constexpr int SMEM =
      Q_BYTES + T::STAGES * T::STAGE + 2 * T::XCH * 4 + 1024;
  static_assert(SMEM + 128 <= 232448, "shared memory");
};

// One CTA per (64 q rows, slice, 512 columns of out), key tiles of 64
// inner.  Per tile the producer streams ns score steps (QRES 0: column
// boxes 2 s and 2 s + 1 of Q and K; QRES 1: boxes 4 s .. 4 s + 3 of K,
// against Q loaded once) and one or two output steps (V's boxes at
// warpgroup 0's and warpgroup 1's 128 columns).
template <class T, int QRES>
__global__ void __launch_bounds__(T::NT, 1)
    flash_fwd_wgmma_wide_kernel(const __grid_constant__ WgArgs w) {
  using namespace pa_sm90;
  constexpr int BQ = T::BM, BK = T::BN, ST = T::STAGES, BOX = T::BOX;
  const FwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[ST], bar_free[ST],
      bar_read[2];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* ring = Qs + FwdWide<QRES>::Q_BYTES;
  float* xch = reinterpret_cast<float*>(ring + ST * T::STAGE);

  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
  const int col0 = blockIdx.z * T::FWD_COLS;
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, BQ, BK);
  const int nb = (a.d + 63) / 64;                  // column boxes of S
  const int ns = QRES ? (nb + 3) / 4 : (nb + 1) / 2;   // score steps a tile
  const int na = col0 + 128 < a.d ? 2 : 1;         // output steps a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);   // one arrival per consumer warp
    }
    mbar_init(&bar_read[0], 4);     // one arrival per warp of the reader
    mbar_init(&bar_read[1], 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    setmaxnreg_dec<T::PREG>();
    if (warp == 8 && lane == 0) {
      if (QRES && nk > 0) {
        mbar_arrive_expect_tx(&bar_q, nb * BOX);
        for (int b = 0; b < nb; ++b)
          tma_load_3d(Qs + b * BOX, &w.tq, &bar_q, 64 * b, hb, (int)r0);
      }
      int step = 0;
      for (int kt = 0; kt < nk; ++kt) {
        const int c0 = kt * BK;
        for (int s = 0; s < ns; ++s, ++step)
          fwd_load_scores<QRES>(ring, bar_full, bar_free, step, &w.tq,
                                &w.tk, (QRES ? 256 : 128) * s, hb, (int)r0,
                                c0, a.d);
        for (int j = 0; j < na; ++j, ++step)
          wide_load_outputs(ring, bar_full, bar_free, step, &w.tv, &w.tv,
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
    float acc0[64], acc1[64], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
    if (QRES && nk > 0) mbar_wait(&bar_q, 0);
    float* mine = xch + wg * T::XCH;
    const float* other = xch + (wg ^ 1) * T::XCH;
    int step = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const long long c0 = (long long)kt * BK;
      fwd_scores<T, QRES>(sc, Qs, ring, bar_full, bar_free, step, ns, nb,
                          wg, lane);
      step += ns;
      // swap the partial scores; S = S0 + S1 in both warpgroups.  A
      // warpgroup writes its block again only once the other has read
      // the last one (bar_read[wg], passed long before in practice), so
      // neither waits for the other past the exchange.
      if (kt > 0) mbar_wait(&bar_read[wg], (kt - 1) & 1);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mine[i * 128 + tid] = sc[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] += other[i * 128 + tid];
      release_stage(bar_read, wg ^ 1, lane);
      const bool edge =
          c0 + BK > a.skv ||
          (a.causal && a.q_off + r0 < a.kv_off + c0 + BK - 1);
      float corr[2];
      online_softmax<BK>(sc, mrow, lrow, corr, a, edge, c0, qpos, t, false);
      uint32_t pa[BK / 16][4];
      pack_a<BK>(pa, sc);   // P to bf16: the rounding of the bf16 rule
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc0[i] *= corr[(i >> 1) & 1];
        acc1[i] *= corr[(i >> 1) & 1];
      }
      // O += P·V over this warpgroup's 256 columns
      wide_outputs<T>(acc0, acc1, pa, ring, bar_full, bar_free, step, na,
                      2 * wg * BOX, col0 + 256 * wg, a.d, lane);
      step += na;
    }
    const int c = col0 + 256 * wg;
    store_rows<128>(a, acc0, row0, hb, c, t, lrow);
    store_rows<128>(a, acc1, row0, hb, c + 128, t, lrow);
    if (a.m && t == 0 && wg == 0 && blockIdx.z == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + 8 * h;
        if (row >= a.sq) continue;
        a.m[(size_t)hb * a.sq + row] = mrow[h];
        a.l[(size_t)hb * a.sq + row] = lrow[h];
      }
    }
  }  // consumers
}

// Tensor maps of q, k and v with 64-row boxes (with no keys nothing is
// loaded, and the k/v maps describe q); Q resident up to D = 512.
template <int QRES>
int run_wgmma_wide(WgArgs& w, void* stream) {
  using pa_sm90::encode_rows_bf16;
  using T = WideTiles;
  const FwdArgs& a = w.a;
  const bool keys = a.skv > 0;
  if (!encode_rows_bf16(&w.tq, a.q, a.sq, a.n, a.d, T::BM) ||
      !encode_rows_bf16(&w.tk, keys ? a.k : a.q, keys ? a.skv : a.sq, a.n,
                        a.d, T::BN) ||
      !encode_rows_bf16(&w.tv, keys ? a.v : a.q, keys ? a.skv : a.sq, a.n,
                        a.d, T::BN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.sq + T::BM - 1) / T::BM, a.n,
            (a.d + T::FWD_COLS - 1) / T::FWD_COLS);
  return launch(flash_fwd_wgmma_wide_kernel<T, QRES>, grid, T::NT,
                FwdWide<QRES>::SMEM, stream, w);
}

// ---------------------------------------------------------------------------
// tf32x3 instance up to D = 256
// ---------------------------------------------------------------------------

// The unit position of a split tile's row r: unit u (columns 2u, 2u + 1)
// sits at u ^ swz(r).  A quarter-warp's 16-byte fragment loads read rows
// g, g + 1 (g even) at units u0 + t (S's operands: swz(g) and swz(g + 1)
// differ by 4, which maps the two rows' four units to the two halves of
// a 128-byte line) or rows 2t + e at units 8 c + g (V: swz(2t + e) takes
// the four even values over t, which keeps g's parity): 32 banks either
// way.
__device__ __forceinline__ int swz(int r) {
  return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2);
}

// Split ROWS landed rows (start_tile's layout, pitch DMAX + 4 words; bf16
// raw in the upper half of each row) into dst: pitch 2·DMAX words, unit u
// = (big(2u), big(2u + 1), small(2u), small(2u + 1)) at u ^ swz(r).
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void split_tile(uint32_t* dst, const float* src,
                                           int dt) {
  constexpr int LD = DMAX + 4, Q4 = DMAX / 4;   // 4-column groups a row
  for (int idx = threadIdx.x; idx < ROWS * Q4; idx += NT) {
    const int r = idx / Q4, c = (idx % Q4) * 4;
    float x[4];
    if (dt == kBF16) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(
          reinterpret_cast<const char*>(src + r * LD) + 2 * DMAX + 16 +
          2 * c);
      const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
      x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(src + r * LD + c);
      x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    }
    uint32_t b[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], b[e], s[e]);
    uint4* row = reinterpret_cast<uint4*>(dst + r * 2 * DMAX);
    const int u = c / 2, sw = swz(r);
    row[u ^ sw] = make_uint4(b[0], b[1], s[0], s[1]);
    row[(u + 1) ^ sw] = make_uint4(b[2], b[3], s[2], s[3]);
  }
}

// s (16 x 8·NJ; n-tile j at s[4 j ..]) = A·Bᵀ over units [U0, U0 + NU)
// of rows of LU units: A the warp's 16 rows of a split tile (from A), B
// the 8·NJ rows of another (from B).  Per k8 step (four units) lane (g, t)
// reads unit t of rows g, g + 8 (A) and 8 j + g (B): k slots t and t + 4
// are columns 2t and 2t + 1.  32 columns (16 units) a chunk, each chunk's
// products a fresh accumulator that one f32 add (round to nearest) moves
// into s: the tensor cores' accumulation, which rounds toward zero, never
// runs over more than 32 terms.
template <int NJ, int LU, int NU>
__device__ __forceinline__ void split_scores(float (&s)[4 * NJ],
                                             const uint32_t* A,
                                             const uint32_t* B, int U0,
                                             int g, int t) {
  const uint4* a0 = reinterpret_cast<const uint4*>(A) + g * LU;
  const uint4* a1 = a0 + 8 * LU;
  const uint4* b = reinterpret_cast<const uint4*>(B) + g * LU;
  const int sw = swz(g);   // rows g, g + 8 and 8 j + g alike
#pragma unroll
  for (int i = 0; i < 4 * NJ; ++i) s[i] = 0.f;
#pragma unroll
  for (int u0 = 0; u0 < NU; u0 += 16) {
    float part[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) part[i] = 0.f;
#pragma unroll
    for (int u = u0; u < u0 + 16; u += 4) {
      const int x = U0 + ((u + t) ^ sw);   // U0 % 8 == 0
      const uint4 r0 = a0[x], r8 = a1[x];
      const uint32_t ab[4] = {r0.x, r8.x, r0.y, r8.y};
      const uint32_t as[4] = {r0.z, r8.z, r0.w, r8.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint4 kb = b[8 * j * LU + x];
        mma3(part, j, ab, as, kb.x, kb.y, kb.z, kb.w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) s[i] += part[i];
  }
}

// o (16 x 16·NCP; n-tile c at o[4 c ..], its n index g standing for
// column 16 (c / 2) + 2 g + c % 2 past the group's first) += P·V: P (16 x
// 8·NJ) the score fragment p as the A operand, whose k slots t and t + 4
// of step j are keys 8 j + 2 t and 8 j + 2 t + 1; V the split tile at B
// (rows of LU units), lane (g, t) reading unit U0 + 8 (c / 2) + g of rows
// 8 j + 2 t (+ 1), which carries n-tiles c and c + 1.  Each n-tile's
// products over the tile's keys go to a fresh accumulator that one f32
// add (round to nearest) then moves into o.
template <int NJ, int LU, int NCP>
__device__ __forceinline__ void split_outputs(float (&o)[8 * NCP],
                                              const float (&p)[4 * NJ],
                                              const uint32_t* B, int U0,
                                              int g, int t) {
  uint32_t ab[NJ][4], as[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split(p[4 * j], ab[j][0], as[j][0]);      // (g, 2t)      -> (g, t)
    split(p[4 * j + 2], ab[j][1], as[j][1]);  // (g + 8, 2t)  -> (g + 8, t)
    split(p[4 * j + 1], ab[j][2], as[j][2]);  // (g, 2t + 1)  -> (g, t + 4)
    split(p[4 * j + 3], ab[j][3], as[j][3]);  // (g + 8, 2t + 1)
  }
  const uint4* b0 = reinterpret_cast<const uint4*>(B) + 2 * t * LU + U0;
  const uint4* b1 = b0 + LU;
  const int x0 = swz(2 * t), x1 = swz(2 * t + 1);
#pragma unroll
  for (int cp = 0; cp < NCP; ++cp) {
    float pe[4] = {0.f, 0.f, 0.f, 0.f}, po[4] = {0.f, 0.f, 0.f, 0.f};
    const int u = 8 * cp + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint4 v0 = b0[8 * j * LU + (u ^ x0)];
      const uint4 v1 = b1[8 * j * LU + (u ^ x1)];
      mma3(pe, 0, ab[j], as[j], v0.x, v1.x, v0.z, v1.z);
      mma3(po, 0, ab[j], as[j], v0.y, v1.y, v0.w, v1.w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[8 * cp + i] += pe[i];
      o[8 * cp + 4 + i] += po[i];
    }
  }
}

// Tiles of one head-dim class: a CTA keeps BQ q rows split (Q) and
// streams BK keys a tile: K and V land raw (pitch DMAX + 4 words) and are
// split into one tile each (pitch 2·DMAX); Q lands once over the K/V area
// before the first tile.  NG groups of BQ / 16 warps hold the same rows
// and split the head dim: group G reduces S over columns [G·DG, G·DG + DG)
// and accumulates O there (DG = DMAX / NG); with NG = 2 the two partial S
// blocks are swapped through K's split tile once every warp has read it.
template <int DMAX_, int BQ_, int BK_, int NG_>
struct Tf32FwdTiles {
  static constexpr int DMAX = DMAX_, BQ = BQ_, BK = BK_, NG = NG_;
  static constexpr int NT = 32 * (BQ / 16) * NG, DG = DMAX / NG;
  static constexpr int LD = DMAX + 4, LS = 2 * DMAX;
  static constexpr size_t Q_SPLIT = sizeof(float) * (size_t)BQ * LS;
  static constexpr size_t KV_SPLIT = sizeof(float) * (size_t)BK * LS;
  static constexpr size_t KV_LAND = sizeof(float) * (size_t)BK * LD;
  static constexpr size_t SMEM = Q_SPLIT + 2 * KV_SPLIT + 2 * KV_LAND;
  static_assert(BQ % 16 == 0 && BK % 8 == 0 && DG % 32 == 0 &&
                    (NG == 1 || NG == 2),
                "tiles");
  static_assert(sizeof(float) * (size_t)BQ * LD <= 2 * (KV_SPLIT + KV_LAND),
                "Q's landing fits the K/V area");
  static_assert(NG == 1 || sizeof(float) * (size_t)NT * BK / 2 <= KV_SPLIT,
                "the S exchange fits K's split tile");
  static_assert(SMEM <= 232448, "shared memory");
};

// One CTA per (q tile, slice), key tiles inner; warp w owns q rows
// [16 r, 16 r + 16) of the tile, r = w % (BQ / 16), in group w / (BQ / 16).
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_fwd_tf32x3_kernel(FwdArgs a) {
  constexpr int BQ = T::BQ, BK = T::BK, DMAX = T::DMAX, LS = T::LS,
                NT = T::NT, NG = T::NG, DG = T::DG, NJ = BK / 8;
  extern __shared__ float4 smem4[];
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* Ks = Qs + BQ * LS;
  uint32_t* Vs = Ks + BK * LS;
  float* Kl = reinterpret_cast<float*>(Vs + BK * LS);
  float* Vl = Kl + BK * T::LD;
  float* Ql = reinterpret_cast<float*>(Ks);   // Q lands over the K/V area

  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, BQ, BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4, rg = warp % (BQ / 16), grp = warp / (BQ / 16);
  const int U0 = grp * DG / 2;            // the group's first unit
  const long long rw = r0 + 16 * rg;      // the warp's first row
  const long long qpos[2] = {a.q_off + rw + g, a.q_off + rw + g + 8};
  const bool round_p = a.v_dt == kBF16;
  float o[DG / 2];
#pragma unroll
  for (int i = 0; i < DG / 2; ++i) o[i] = 0.f;
  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
  if (nk > 0) {
    start_tile<BQ, DMAX, NT>(Ql, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_tile<BQ, DMAX, NT>(Qs, Ql, a.q_dt);
    __syncthreads();   // Q's landing read: K/V(0) land over it
    start_tile<BK, DMAX, NT>(Kl, a.k, a.k_dt, a.n, hb, a.skv, a.d, 0);
    start_tile<BK, DMAX, NT>(Vl, a.v, a.v_dt, a.n, hb, a.skv, a.d, 0);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const long long c0 = (long long)kt * BK;
    cp_async_wait<0>();
    __syncthreads();   // K/V(kt) landed; tile kt - 1's split K/V read
    split_tile<BK, DMAX, NT>(Ks, Kl, a.k_dt);
    split_tile<BK, DMAX, NT>(Vs, Vl, a.v_dt);
    __syncthreads();   // split: the landing buffers take K/V(kt + 1)
    if (kt + 1 < nk) {   // K/V(kt + 1) fly while tile kt is computed
      start_tile<BK, DMAX, NT>(Kl, a.k, a.k_dt, a.n, hb, a.skv, a.d,
                               c0 + BK);
      start_tile<BK, DMAX, NT>(Vl, a.v, a.v_dt, a.n, hb, a.skv, a.d,
                               c0 + BK);
    }
    cp_async_commit();
    // a warp whose rows see no key of the tile skips its products (every
    // later tile's too): for a row that saw a key, such a tile adds
    // exp(NEG - m) = 0 to l and O
    const bool live = !a.causal || a.q_off + rw + 15 >= a.kv_off + c0;
    float s[BK / 2];
    if (live)
      split_scores<NJ, DMAX / 2, DG / 2>(s, Qs + 16 * rg * LS, Ks, U0, g,
                                         t);
    if constexpr (NG == 2) {
      // S = S0 + S1 in both groups (a + b == b + a: both run the
      // identical softmax), swapped through K's split tile once every
      // warp has read it; the next tile's split waits for this read
      float* xch = reinterpret_cast<float*>(Ks);
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) xch[i * NT + threadIdx.x] = s[i];
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          s[i] += xch[i * NT + (threadIdx.x ^ (NT / 2))];
      }
    }
    if (!live) continue;
    // masks only where the tile crosses the key tail or the warp's
    // diagonal
    const bool edge = c0 + BK > a.skv ||
                      (a.causal && a.q_off + rw < a.kv_off + c0 + BK - 1);
    float corr[2];
    online_softmax<BK>(s, mrow, lrow, corr, a, edge, c0, qpos, t, round_p);
#pragma unroll
    for (int i = 0; i < DG / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    split_outputs<NJ, DMAX / 2, DG / 16>(o, s, Vs, U0, g, t);
  }
  cp_async_wait<0>();

  // out = o / l in out_dt, acc = o raw: the lane's columns of n-tiles
  // 2 cp and 2 cp + 1 are 16 cp + 4 t .. + 3 past the group's first (n
  // indices 2t and 2t + 1, even and odd n-tile in turn)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = rw + g + 8 * h;
    if (row >= a.sq) continue;
    const size_t base = ((size_t)row * a.n + hb) * a.d;
    const float den = lrow[h] == 0.f ? 1.f : lrow[h];
#pragma unroll
    for (int cp = 0; cp < DG / 16; ++cp) {
      // d % 8 == 0: col < d => col + 3 < d
      const int col = grp * DG + 16 * cp + 4 * t;
      if (col >= a.d) continue;
      const float x[4] = {o[8 * cp + 2 * h], o[8 * cp + 4 + 2 * h],
                          o[8 * cp + 2 * h + 1], o[8 * cp + 4 + 2 * h + 1]};
      if (a.out) {
        if (a.out_dt == kBF16) {
          __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + base + col);
          y[0] = __floats2bfloat162_rn(x[0] / den, x[1] / den);
          y[1] = __floats2bfloat162_rn(x[2] / den, x[3] / den);
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(a.out) + base +
                                     col) =
              make_float4(x[0] / den, x[1] / den, x[2] / den, x[3] / den);
        }
      }
      if (a.acc)
        *reinterpret_cast<float4*>(a.acc + base + col) =
            make_float4(x[0], x[1], x[2], x[3]);
    }
    if (a.m && t == 0 && grp == 0) {
      a.m[(size_t)hb * a.sq + row] = mrow[h];
      a.l[(size_t)hb * a.sq + row] = lrow[h];
    }
  }
}

// Tiles (DMAX, BQ resident q rows, BK streamed keys, NG column groups):
// K3's tf32x3 classes, but 64 keys a tile at D = 64 (half the tiles'
// syncs and split passes: 0.90 against 1.04 ms for 32 keys on an H100 at
// S = 4096, H = 8) and D = 256 in two column groups (O of 16 rows x 256
// columns alone is 128 registers a thread: with one group ptxas spilled
// at 255 registers, and 4 warps an SM left the tensor cores idle); shared =
// BQ·2·DMAX·4 (Q split) + 2·BK·2·DMAX·4 (K, V split) + 2·BK·(DMAX + 4)·4
// (their landing) bytes; registers a thread, floats: DG / 2 (O) + BK (S
// and a chunk's partial sums) + the split P fragments (BK / 8 steps x 8
// words) + the loaded units (ptxas's count and spills: chip_smoke.py
// phase 1):
//   DMAX  64: 128 x 64, 1 group,  256 threads (162.0 KB)
//   DMAX 128: 128 x 32, 1 group,  256 threads (225.0 KB)
//   DMAX 256:  64 x 16, 2 groups, 256 threads (224.5 KB)
template <class T>
int run_tf32(const FwdArgs& a, void* stream) {
  dim3 grid((a.sq + T::BQ - 1) / T::BQ, a.n);
  return launch(flash_fwd_tf32x3_kernel<T>, grid, T::NT, T::SMEM, stream,
                a);
}

// ---------------------------------------------------------------------------
// simt instance (retired)
// ---------------------------------------------------------------------------

// Tiles of the simt instance: NT = TY x 16 threads, thread (ty, tx) =
// (t / 16, t % 16) owns q rows ty + TY·i (i < RI), keys tx + 16·j (j < CJ)
// of S, and columns 4·(tx + 16·c) + e (c < DJ / 4, e < 4) of O.  A row's
// 16 threads sit in one half-warp.  f32 tiles in shared memory with a row
// pitch of DMAX + 4 words (16-byte rows, and the rows of a quarter-warp's
// 16-byte loads on distinct banks); a bf16 tile is first copied raw into
// the upper half of each row.
template <int TY_, int RI_, int CJ_, int DMAX_, int MINB_>
struct SimtTiles {
  static constexpr int TX = 16, TY = TY_, RI = RI_, CJ = CJ_, DMAX = DMAX_;
  static constexpr int NT = TX * TY, BQ = TY * RI, BK = TX * CJ;
  static constexpr int DJ = DMAX / TX, LD = DMAX + 4, LP = BK + 4;
  static constexpr int MINB = MINB_;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * LP);
  static_assert(DJ % 4 == 0, "O columns go in float4 groups");
};

template <class T>
__global__ void __launch_bounds__(T::NT, T::MINB)
    flash_fwd_simt_kernel(FwdArgs a) {
  constexpr int BQ = T::BQ, BK = T::BK, DMAX = T::DMAX, TY = T::TY,
                TX = T::TX, RI = T::RI, CJ = T::CJ, DJ = T::DJ, NT = T::NT,
                LD = T::LD, LP = T::LP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  int hb;
  long long r0;
  cta_tile(a.n, BQ, r0, hb);
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, BQ, BK);
  start_tile<BQ, DMAX, NT>(Qs, a.q, a.q_dt, a.n, hb, a.sq, a.d, r0);
  cp_async_commit();
  if (nk > 0) start_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, 0);
  cp_async_commit();

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const bool round_p = a.v_dt == kBF16;
  for (int kt = 0; kt < nk; ++kt) {
    const long long c0 = (long long)kt * BK;
    // V(kt) flies while S(kt) is computed
    start_tile<BK, DMAX, NT>(Vs, a.v, a.v_dt, a.n, hb, a.skv, a.d, c0);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K(kt) landed
    __syncthreads();
    if (kt == 0 && a.q_dt == kBF16) widen_tile<BQ, DMAX, NT>(Qs);
    if (a.k_dt == kBF16) widen_tile<BK, DMAX, NT>(Ks);

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int x = 0; x < DMAX; x += 4) {
      float4 qa[RI], kb[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * LD + x);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * LD + x);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const long long col = c0 + tx + TX * j;
        const bool valid =
            col < a.skv && (!a.causal || a.q_off + r0 + r >= a.kv_off + col);
        s[i][j] = valid ? s[i][j] * a.scale : kNeg;
        bm = fmaxf(bm, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max<TX>(bm));
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        Ps[r * LP + tx + TX * j] = round_p ? round_bf16(p) : p;
      }
      l[i] = l[i] * corr + row_sum<TX>(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // K(kt) read, P written
    // K(kt + 1) flies while P(kt)·V(kt) is computed
    if (kt + 1 < nk)
      start_tile<BK, DMAX, NT>(Ks, a.k, a.k_dt, a.n, hb, a.skv, a.d, c0 + BK);
    cp_async_commit();
    cp_async_wait<1>();  // V(kt) landed
    __syncthreads();
    if (a.v_dt == kBF16) widen_tile<BK, DMAX, NT>(Vs);

#pragma unroll 2
    for (int k = 0; k < BK; k += 4) {
      float4 pr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + TY * i) * LP + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 vb[DJ / 4];
#pragma unroll
        for (int c = 0; c < DJ / 4; ++c)
          vb[c] = *reinterpret_cast<const float4*>(Vs + (k + kk) * LD +
                                                   4 * (tx + TX * c));
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float p = kk == 0   ? pr[i].x
                          : kk == 1 ? pr[i].y
                          : kk == 2 ? pr[i].z
                                    : pr[i].w;
#pragma unroll
          for (int c = 0; c < DJ / 4; ++c) {
            acc[i][4 * c] = fmaf(p, vb[c].x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(p, vb[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vb[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vb[c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // V(kt) and P read before the next V lands
  }
  cp_async_wait<0>();  // nothing in flight at exit (nk == 0)

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long row = r0 + ty + TY * i;
    if (row >= a.sq) continue;
    const size_t base = ((size_t)row * a.n + hb) * a.d;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DJ / 4; ++c) {
      const int col = 4 * (tx + TX * c);  // d % 8 == 0: col < d => col+3 < d
      if (col >= a.d) continue;
      const float x[4] = {acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                          acc[i][4 * c + 3]};
      if (a.out) {
        if (a.out_dt == kBF16) {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + base + col);
          o[0] = __floats2bfloat162_rn(x[0] / den, x[1] / den);
          o[1] = __floats2bfloat162_rn(x[2] / den, x[3] / den);
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(a.out) + base +
                                     col) =
              make_float4(x[0] / den, x[1] / den, x[2] / den, x[3] / den);
        }
      }
      if (a.acc)
        *reinterpret_cast<float4*>(a.acc + base + col) =
            make_float4(x[0], x[1], x[2], x[3]);
    }
    if (a.m && tx == 0) {
      a.m[(size_t)hb * a.sq + row] = m[i];
      a.l[(size_t)hb * a.sq + row] = l[i];
    }
  }
}

// Tiles by head-dim class (TY, RI, CJ -> BQ x BK, threads), shared memory
// (BQ + 2·BK)·(DMAX + 4)·4 + BQ·(BK + 4)·4 bytes, at most 113 KB where two
// CTAs share an SM:
//   DMAX   64: 64 x 64, 256 threads ( 68.0 KB)
//   DMAX  128: 64 x 48, 256 threads ( 95.5 KB)
//   DMAX  256: 32 x 32, 256 threads (102.0 KB)
template <class T>
int run_simt(const FwdArgs& a, void* stream) {
  dim3 grid((a.sq + T::BQ - 1) / T::BQ, a.n);
  return launch(flash_fwd_simt_kernel<T>, grid, T::NT, T::SMEM, stream, a);
}

// ---------------------------------------------------------------------------
// tf32x3 instance above D = 256
// ---------------------------------------------------------------------------

// Arguments of the wide tf32x3 kernel: f32 tensor maps of q (boxes of 32
// columns x RES rows), k and v (32 columns x STR rows), and the call's.
struct Tf32FwdArgs {
  CUtensorMap tq, tk, tv;
  FwdArgs a;
};

// Thread 0's loads of a score step: Q's and K's boxes at columns c + 32 i
// (i < 4; none past d), i = 0, 1 into group 0's half of the stage and
// i = 2, 3 into group 1's (each: its Q boxes, then its K boxes, the layout
// wide_score_step reads).
template <class T>
__device__ __forceinline__ void fwd_tf32_load_scores(
    uint8_t* dst, uint64_t* bar, const CUtensorMap* tq, const CUtensorMap* tk,
    int c, int hb, int rq, int rk, int d) {
  using namespace pa_sm90;
  int live = 0;
  for (int i = 0; i < 4; ++i) live += c + 32 * i < d;
  mbar_arrive_expect_tx(bar, live * (T::RBOX + T::SBOX));
  for (int i = 0; i < live; ++i) {
    uint8_t* grp = dst + (i / 2) * T::GRP;
    tma_load_3d(grp + (i % 2) * T::RBOX, tq, bar, c + 32 * i, hb, rq);
    tma_load_3d(grp + 2 * T::RBOX + (i % 2) * T::SBOX, tk, bar, c + 32 * i,
                hb, rk);
  }
}

// One CTA per (64 q rows, slice, 512 columns of out), key tiles of STR
// inner; warp w of group G = w / 4 holds q rows 16 (w % 4) ...  Per tile
// the ring carries ns = ceil(d / 128) score steps (boxes 4 s, 4 s + 1 of
// Q and K for group 0, 4 s + 2, 4 s + 3 for group 1) and one or two
// output steps (V's rows of the tile at the two groups' 128 columns).
template <class T>
__global__ void __launch_bounds__(T::NT, 1)
    flash_fwd_tf32x3_wide_kernel(const __grid_constant__ Tf32FwdArgs w) {
  using namespace pa_sm90;
  constexpr int RES = T::RES, STR = T::STR, ST = T::STAGES;
  const FwdArgs& a = w.a;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  uint8_t* ring = align1024(smem_raw);
  float* xch = reinterpret_cast<float*>(ring + ST * T::STAGE);

  int hb;
  long long r0;
  cta_tile(a.n, RES, r0, hb);
  const int col0 = blockIdx.z * T::FWD_COLS;
  const int nk =
      visible_tiles(a.skv, a.causal, a.q_off, a.kv_off, r0, RES, STR);
  const int ns = (a.d + 127) / 128;             // score steps a tile
  const int na = col0 + 128 < a.d ? 2 : 1;      // output steps a tile
  const int per = ns + na, total = nk * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = warp / 4,
            wq = warp % 4, g = lane / 4, t = lane % 4, tid = threadIdx.x % 128;
  const long long row0 = r0 + 16 * wq + g;   // the lane's row of half 0
  const long long qpos[2] = {a.q_off + row0, a.q_off + row0 + 8};

  // step s (thread 0): Q/K boxes of a score step, or V's boxes at the two
  // groups' 128 columns of an output step
  auto issue = [&](int s) {
    if (s >= total) return;
    const int kt = s / per, j = s % per, st = s % ST;
    uint8_t* dst = ring + st * T::STAGE;
    if (j < ns)
      fwd_tf32_load_scores<T>(dst, &full[st], &w.tq, &w.tk, 128 * j, hb,
                              (int)r0, kt * STR, a.d);
    else
      wide_out_load<T>(dst, &full[st], &w.tv, &w.tv, col0 + 128 * (j - ns),
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
  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
  const bool round_p = a.v_dt == kBF16;
  int s = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const long long c0 = (long long)kt * STR;
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) sc[i] = 0.f;
    // this group's part of S = Q·Kᵀ: its boxes of each score step
    for (int j = 0; j < ns; ++j, ++s) {
      const int st = s % ST, c = 128 * j + 64 * grp;
      mbar_wait(&full[st], (s / ST) & 1);
      if (c < a.d)
        wide_score_step<T>(sc, ring + st * T::STAGE + grp * T::GRP, 16 * wq,
                           c + 32 < a.d, g, t);
      __syncthreads();   // stage st read: it takes step s + ST
      if (threadIdx.x == 0) issue(s + ST);
    }
    // swap the partial scores; S = S0 + S1 in both groups
    float* mine = xch + (2 * (kt & 1) + grp) * T::XCH;
    const float* other = xch + (2 * (kt & 1) + (grp ^ 1)) * T::XCH;
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) mine[i * 128 + tid] = sc[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < STR / 2; ++i) sc[i] += other[i * 128 + tid];
    const bool edge =
        c0 + STR > a.skv ||
        (a.causal && a.q_off + r0 < a.kv_off + c0 + STR - 1);
    float corr[2];
    online_softmax<STR>(sc, mrow, lrow, corr, a, edge, c0, qpos, t,
                        round_p);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] *= corr[(i >> 1) & 1];
      acc1[i] *= corr[(i >> 1) & 1];
    }
    // O += P·V over the group's 256 columns, 128 a step
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
  store_rows<128>(a, acc0, row0, hb, c, t, lrow);
  store_rows<128>(a, acc1, row0, hb, c + 128, t, lrow);
  if (a.m && t == 0 && grp == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      if (row >= a.sq) continue;
      a.m[(size_t)hb * a.sq + row] = mrow[h];
      a.l[(size_t)hb * a.sq + row] = lrow[h];
    }
  }
}

// Registers a thread, floats: 128 (O over 256 columns) + STR / 2 (S) + the
// split P fragments (2·STR / 2) + the box products' operands; ptxas's
// count and spills: chip_smoke.py phase 1.  Shared memory: Tf32WideTiles.
int run_tf32_wide(const FwdArgs& a, void* stream) {
  using pa_sm90::encode_rows_f32;
  using T = Tf32WideTiles;
  Tf32FwdArgs w{};
  w.a = a;
  // with no keys nothing is loaded; the k/v maps then describe q
  const bool keys = a.skv > 0;
  if (!encode_rows_f32(&w.tq, a.q, a.sq, a.n, a.d, T::RES) ||
      !encode_rows_f32(&w.tk, keys ? a.k : a.q, keys ? a.skv : a.sq, a.n,
                       a.d, T::STR) ||
      !encode_rows_f32(&w.tv, keys ? a.v : a.q, keys ? a.skv : a.sq, a.n,
                       a.d, T::STR))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.sq + T::RES - 1) / T::RES, a.n,
            (a.d + T::FWD_COLS - 1) / T::FWD_COLS);
  return launch(flash_fwd_tf32x3_wide_kernel<T>, grid, T::NT, T::SMEM,
                stream, w);
}

}  // namespace pa_flash

// The retired simt instance, launched only by a caller that names it: q,
// k, v each f32 or bf16, d <= 256; out in out_dt.
extern "C" int pa_flash_fwd_simt(const void* q, const void* k, const void* v,
                                 int q_dt, int k_dt, int v_dt, void* out,
                                 int out_dt, float* acc, float* m, float* l,
                                 int n, int sq, int skv, int d, float scale,
                                 int causal, long long q_off,
                                 long long kv_off, void* stream) {
  using namespace pa_flash;
  const FwdArgs a{q,  k,  v,   q_dt, k_dt,  v_dt,   out,   out_dt, acc,
                  m,  l,  n,   sq,   skv,   d,      scale, causal, q_off,
                  kv_off};
  if (d <= 64) return run_simt<SimtTiles<16, 4, 4, 64, 2>>(a, stream);
  if (d <= 128) return run_simt<SimtTiles<16, 4, 3, 128, 2>>(a, stream);
  if (d <= 256) return run_simt<SimtTiles<16, 2, 2, 256, 2>>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k, v bf16 with d <= 1024 (above 256 the wide kernel); out in out_dt.
extern "C" int pa_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                  void* out, int out_dt, float* acc, float* m,
                                  float* l, int n, int sq, int skv, int d,
                                  float scale, int causal, long long q_off,
                                  long long kv_off, void* stream) {
  using namespace pa_flash;
  WgArgs w{};
  w.a = FwdArgs{q,     k,      v,     kBF16, kBF16, kBF16, out,
                out_dt, acc,   m,     l,     n,     sq,    skv,
                d,     scale,  causal, q_off, kv_off};
  if (d <= 64) return run_wgmma<WgTiles<64, 128>>(w, stream);
  if (d <= 128) return run_wgmma<WgTiles<128, 128>>(w, stream);
  if (d <= 256) return run_wgmma<WgTiles<256, 64>>(w, stream);
  if (d <= 512) return run_wgmma_wide<1>(w, stream);
  if (d <= 1024) return run_wgmma_wide<0>(w, stream);
  return (int)cudaErrorInvalidValue;
}

// Any f32 operand, d <= 1024; out in out_dt.  Up to d = 256 q, k and v
// each f32 or bf16, read in their own dtypes (q_dt, k_dt, v_dt).  Above,
// the wide kernel reads f32 by TMA: q and k must be f32, and v's data f32
// with v_dt its dtype before the caller widened it (bf16 rounds P before
// P·V).
extern "C" int pa_flash_fwd_tf32x3(const void* q, const void* k,
                                   const void* v, int q_dt, int k_dt,
                                   int v_dt, void* out, int out_dt,
                                   float* acc, float* m, float* l, int n,
                                   int sq, int skv, int d, float scale,
                                   int causal, long long q_off,
                                   long long kv_off, void* stream) {
  using namespace pa_flash;
  const FwdArgs a{q,  k,  v,   q_dt, k_dt,  v_dt,   out,   out_dt, acc,
                  m,  l,  n,   sq,   skv,   d,      scale, causal, q_off,
                  kv_off};
  if (d <= 64) return run_tf32<Tf32FwdTiles<64, 128, 64, 1>>(a, stream);
  if (d <= 128) return run_tf32<Tf32FwdTiles<128, 128, 32, 1>>(a, stream);
  if (d <= 256) return run_tf32<Tf32FwdTiles<256, 64, 16, 2>>(a, stream);
  if (d <= 1024 && q_dt == kF32 && k_dt == kF32)
    return run_tf32_wide(a, stream);
  return (int)cudaErrorInvalidValue;
}
