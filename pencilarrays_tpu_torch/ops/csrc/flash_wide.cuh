// The pieces of the flash kernels above D = 256 (the "wide" kernels) that
// K2 (flash_fwd.cu) and K3/K4 (flash_bwd.cu, flash_bwd_tf32.cu) share.
// At such head dims no tile of a whole row fits a CTA (64 rows of 512 bf16
// columns are 64 KB, of f32 128 KB; an accumulator of 64 rows x 512 f32
// columns is the whole register file of a warpgroup), so the operands
// stream through one ring of TMA boxes a column block at a time (K2's
// wgmma kernel alone keeps Q resident, up to D = 512), and the
// output columns are split between two groups of warps that hold the same
// rows, and between CTAs (gridDim.z).
//
// * wgmma (bf16): boxes of 64 rows x 64 columns (128-byte swizzle), a ring
//   stage of four; an output step accumulates 128 columns a warpgroup from
//   two boxes of its own, the A operand a packed fragment in registers.
// * tf32x3 (f32): boxes of 32 f32 columns (128-byte swizzle, read back by
//   the fragment loads through a per-lane XOR), mma.sync m16n8k8 TF32 with
//   three products per f32 product; each box's (score) or each key tile's
//   (output) products go to a fresh accumulator that an f32 add, rounding
//   to nearest, moves into the running value.
#pragma once

#include "flash_common.cuh"
#include "sm90.cuh"

namespace pa_flash {

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// acc (64 x N) += A·B over RB: A the packed fragment (64 x RB), B the N
// columns of a tile of RB rows starting at B, read MN-major: the depth
// runs down the rows (16 rows, 2048 bytes, a step), 64-column boxes
// RB·128 bytes apart.
template <int RB, int N>
__device__ __forceinline__ void rs_block(float (&acc)[N / 2],
                                         const uint32_t (&pa)[RB / 16][4],
                                         const uint8_t* B) {
  using namespace pa_sm90;
#pragma unroll
  for (int kk = 0; kk < RB / 16; ++kk) {
    const uint64_t db = wgmma_desc(B + kk * 16 * 128, RB * 128, 1024);
    if constexpr (N == 256)
      wgmma_rs_n256(acc, pa[kk], db);
    else if constexpr (N == 128)
      wgmma_rs_n128(acc, pa[kk], db);
    else
      wgmma_rs_n64(acc, pa[kk], db);
  }
}

// ---------------------------------------------------------------------------
// wgmma (bf16)
// ---------------------------------------------------------------------------

// Tiles of the wgmma instance for 256 < D <= 1024: a CTA owns BM = 64 rows
// (K2, K3: q rows; K4: keys) and streams BN = 64 rows a tile of the other
// side; its two consumer warpgroups cover the same 64 rows and split the
// work (see the kernels).  In K3 and K4 nothing is resident: every
// operand arrives through one ring of STAGES stages, each four 64-row x
// 64-column boxes (32 KB), in the order the consumers take them: per
// tile, the score steps (column boxes of the score product's operands),
// then one or two output steps (the boxes of the B operand of the
// accumulating products, 128 columns a warpgroup a step).  Four f32 score
// blocks, two a warpgroup double-buffered by tile, carry a block from one
// warpgroup to the other.  Shared memory: 4·32 + 4·16 KB + 1 KB of
// alignment slack.  K2 uses the same ring and boxes with a layout of its
// own (flash_fwd.cu's FwdWide: Q's boxes resident up to D = 512, one
// score block a warpgroup).
struct WideTiles {
  static constexpr int BM = 64, BN = 64, STAGES = 4, NT = 384;
  static constexpr int PREG = 24, CREG = 240;
  static_assert(128 * PREG + 256 * CREG <= NT * 168, "register budget");
  static constexpr int BOX = 64 * 128;       // one box, bytes
  static constexpr int STAGE = 4 * BOX;      // one ring stage
  static constexpr int XCH = BM * BN;        // one f32 score block, words
  static constexpr int SMEM = STAGES * STAGE + 4 * XCH * 4 + 1024;
  static constexpr int FWD_COLS = 512;       // columns of out a K2 CTA writes
  static constexpr int DQ_COLS = 512;        // columns of dq a CTA writes
  static constexpr int DKV_COLS = 256;       // columns of dk and dv a CTA
};

// The consumer warps' release of ring stage `st`: one arrival a warp.
__device__ __forceinline__ void release_stage(uint64_t* bar_free, int st,
                                              int lane) {
  __syncwarp();
  if (lane == 0) pa_sm90::mbar_arrive(&bar_free[st]);
}

// The output steps of one tile: acc0 (columns c, c + 128) and acc1 (c + 128,
// c + 256) of a warpgroup's 64 x 256 accumulator += X·B, X the packed
// fragment (64 x BN) and B the warpgroup's two boxes at `boff` bytes into
// the stages of ring steps step, step + 1 (na of them), read MN-major; a
// step whose first column `c + 128 j` is past d holds none of this
// warpgroup's boxes and is skipped.
template <class T>
__device__ __forceinline__ void wide_outputs(
    float (&acc0)[64], float (&acc1)[64], const uint32_t (&x)[T::BN / 16][4],
    uint8_t* ring, uint64_t* full, uint64_t* bar_free, int step, int na,
    int boff, int c, int d, int lane) {
  using namespace pa_sm90;
  constexpr int ST = T::STAGES;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j >= na) continue;
    const int st = (step + j) % ST;
    mbar_wait(&full[st], ((step + j) / ST) & 1);
    if (c + 128 * j >= d) continue;
    wgmma_fence();
    if (j == 0)
      rs_block<T::BN, 128>(acc0, x, ring + st * T::STAGE + boff);
    else
      rs_block<T::BN, 128>(acc1, x, ring + st * T::STAGE + boff);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  for (int j = 0; j < na; ++j)
    release_stage(bar_free, (step + j) % ST, lane);
}

// The producer's claim of ring step `step`: once its stage's previous use
// is released, `bytes` of TMA transactions are announced on its barrier;
// returns the stage.
__device__ __forceinline__ uint8_t* wide_stage(uint8_t* ring, uint64_t* full,
                                               uint64_t* bar_free, int step,
                                               uint32_t bytes) {
  using namespace pa_sm90;
  constexpr int ST = WideTiles::STAGES;
  const int st = step % ST, u = step / ST;
  if (u > 0) mbar_wait(&bar_free[st], (u - 1) & 1);
  mbar_arrive_expect_tx(&full[st], bytes);
  return ring + st * WideTiles::STAGE;
}

// The producer's loads of an output step: boxes at columns c, c + 64 (map
// o0) and c + cg, c + cg + 64 (map o1), all at rows rb; a box whose first
// column is past d is not loaded (its consumer skips it).
__device__ __forceinline__ void wide_load_outputs(
    uint8_t* ring, uint64_t* full, uint64_t* bar_free, int step,
    const CUtensorMap* o0, const CUtensorMap* o1, int c, int cg, int hb,
    int rb, int d) {
  using namespace pa_sm90;
  constexpr int BOX = WideTiles::BOX;
  uint64_t* bar = &full[step % WideTiles::STAGES];
  const int live = (c < d) + (c + 64 < d) + (c + cg < d) + (c + cg + 64 < d);
  uint8_t* dst = wide_stage(ring, full, bar_free, step, live * BOX);
  for (int i = 0; i < 4; ++i) {
    const int col = c + (i >= 2 ? cg : 0) + 64 * (i & 1);
    if (col < d)
      tma_load_3d(dst + i * BOX, i >= 2 ? o1 : o0, bar, col, hb, rb);
  }
}

// ---------------------------------------------------------------------------
// tf32x3 (f32)
// ---------------------------------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the low 13 bits zero) for every finite x, by two integer
// operations: half an ulp added to the magnitude, then the low bits
// cleared.  sm_90 has no instruction for the cvt: its PTX form compiles to
// a longer sequence that guards inf and NaN, which made K3 + K4 markedly
// slower, two roundings of every operand value being on the hot path.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// (d0..d3) += a·b: one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n-tile j of acc (acc[4 j .. 4 j + 3]) += a·b in 3xTF32, small terms first.
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N], int j,
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  float &d0 = acc[4 * j], &d1 = acc[4 * j + 1], &d2 = acc[4 * j + 2],
        &d3 = acc[4 * j + 3];
  mma_tf32(d0, d1, d2, d3, as, bb0, bb1);
  mma_tf32(d0, d1, d2, d3, ab, bs0, bs1);
  mma_tf32(d0, d1, d2, d3, ab, bb0, bb1);
}

// Tiles above D = 256: a CTA of 8 warps owns RES = 64 rows (K2, K3: q rows;
// K4: keys) and streams STR rows a tile of the other side.  Its two groups
// of four warps cover the same 64 rows (warp w: rows 16 (w % 4) ..) and
// split the work (see the kernels).  Nothing is resident: thread 0 feeds
// one ring of STAGES stages by TMA, in the order the warps take them: per
// tile, the score steps (32-column boxes of the score products' operands:
// RES rows of the A operands, STR of the B ones, up to two of each a
// group), then one or two output steps (the B operand's rows of the tile,
// four boxes, 128 columns, for each group).  Four f32 score blocks, two a
// group double-buffered by tile, carry a block from one group to the
// other.
struct Tf32WideTiles {
  static constexpr int RES = 64, STR = 32, STAGES = 4, NT = 256;
  static constexpr int RBOX = RES * 128, SBOX = STR * 128;   // box bytes
  static constexpr int GRP = 2 * RBOX + 2 * SBOX;   // a group's score boxes
  static constexpr int SLAB = 2 * GRP;              // a score step
  static constexpr int OUTB = 8 * SBOX;             // an output step
  static constexpr int STAGE = SLAB > OUTB ? SLAB : OUTB;
  static constexpr int XCH = RES * STR;             // one score block, words
  static constexpr int SMEM = STAGES * STAGE + 4 * XCH * 4 + 1024;
  static constexpr int FWD_COLS = 512, DQ_COLS = 512, DKV_COLS = 256;
  static_assert(STR % 8 == 0 && STAGE % 1024 == 0 && SMEM + 64 <= 232448,
                "tiles");
};

// Boxes of 32 f32 columns are written with the 128-byte swizzle: 16-byte
// chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8), so element (r, c)
// is word r·32 + ((c & ~3) ^ 4·(r % 8)) + c % 4.  For the fragment loads
// that is a row offset plus a column offset XOR a lane constant: lane
// (g, t) reads rows r ≡ g (mod 8) at columns k + t (k a multiple of 4),
// word r·32 + (k ^ (4 g + t)), and rows 2 t + e (mod 8) at columns
// 8 m + g, word r·32 + (8 m ^ y_e) with y_e = 4·((g / 4) ^ (2 t + e)) +
// g % 4.  Either way a warp's 32 loads fall on 32 distinct banks.

// out (16 x 8·NJ) += A·Bᵀ over one 32-column box each: A at the lane's
// row (g of a 16-row group; rows g + 8 are 256 words on), B at its row g
// of rows 0 .. 8·NJ - 1; x = 4 g + t.  Lane (g, t) reads A at rows g and
// g + 8 and B at row 8 j + g, each at columns t and t + 4 of every 8-column
// step.
template <int NJ>
__device__ __forceinline__ void box_scores(float (&out)[4 * NJ],
                                           const float* A, const float* B,
                                           int x) {
#pragma unroll 2
  for (int k = 0; k < 32; k += 8) {
    const int o0 = k ^ x, o1 = (k + 4) ^ x;
    uint32_t ab[4], as[4];
    split(A[o0], ab[0], as[0]);
    split(A[256 + o0], ab[1], as[1]);
    split(A[o1], ab[2], as[2]);
    split(A[256 + o1], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb0, bs0, bb1, bs1;
      split(B[256 * j + o0], bb0, bs0);
      split(B[256 * j + o1], bb1, bs1);
      mma3(out, j, ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// acc (16 x 128; n-tile c at acc[4 c ..]) += X·B: X (16 x 8·NK) a score
// block's accumulator fragment (n-tile j at x[4 j ..]) as the A operand,
// whose k slots t and t + 4 of step j are its columns 8 j + 2 t and
// 8 j + 2 t + 1; B the ROWS rows of four consecutive 32-column boxes at
// Bs, rows 8 j + 2 t (+ 1) at columns 8 c + g.  Each n-tile's products
// over the block go to a fresh accumulator that one f32 add (round to
// nearest) then moves into acc: the tensor cores' accumulation, which
// rounds toward zero, never runs over more than the block's 8·NK terms of
// a sum whose length is the sequence.
template <int NK, int ROWS>
__device__ __forceinline__ void box_outputs(float (&acc)[64],
                                            const float (&x)[4 * NK],
                                            const float* Bs, int g, int t) {
  uint32_t ab[NK][4], as[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    split(x[4 * j], ab[j][0], as[j][0]);      // (g, 2t)      -> (g, t)
    split(x[4 * j + 2], ab[j][1], as[j][1]);  // (g + 8, 2t)  -> (g + 8, t)
    split(x[4 * j + 1], ab[j][2], as[j][2]);  // (g, 2t + 1)  -> (g, t + 4)
    split(x[4 * j + 3], ab[j][3], as[j][3]);  // (g + 8, 2t + 1)
  }
  // rows 2 t (+ 1) of each 8-row group, and their lane constants y_e
  const float* b0 = Bs + 2 * t * 32;
  const int y0 = 4 * ((g >> 2) ^ (2 * t)) + (g & 3);
  const int y1 = 4 * ((g >> 2) ^ (2 * t + 1)) + (g & 3);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float* b = b0 + (c >> 2) * ROWS * 32;
    const int m = 8 * (c & 3);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t bb0, bs0, bb1, bs1;
      split(b[256 * j + (m ^ y0)], bb0, bs0);
      split(b[256 * j + 32 + (m ^ y1)], bb1, bs1);
      mma3(part, 0, ab[j], as[j], bb0, bb1, bs0, bs1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * c + i] += part[i];
  }
}

// The score step of a group: out (16 x STR) += A·Bᵀ over up to two
// 32-column boxes (A's rows from ar, a multiple of 8; the group's A boxes
// at A, A + RBOX, its B boxes after them), a fresh accumulator for each
// box that one f32 add moves into out, so the tensor cores' accumulation,
// which rounds toward zero, never runs over more than 32 terms; a second
// box wholly past d was not loaded and is skipped (`two` false).
template <class T>
__device__ __forceinline__ void wide_score_step(float (&out)[T::STR / 2],
                                                const uint8_t* A, int ar,
                                                bool two, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !two) break;
    float part[T::STR / 2];
#pragma unroll
    for (int i = 0; i < T::STR / 2; ++i) part[i] = 0.f;
    box_scores<T::STR / 8>(
        part,
        reinterpret_cast<const float*>(A + h * T::RBOX) + (ar + g) * 32,
        reinterpret_cast<const float*>(A + 2 * T::RBOX + h * T::SBOX) +
            g * 32,
        4 * g + t);
#pragma unroll
    for (int i = 0; i < T::STR / 2; ++i) out[i] += part[i];
  }
}

// Thread 0's loads of an output step: boxes of map o0 at columns c + 32 i
// and of map o1 at c + cg + 32 i (i < 4), all at rows rb; none past d.
template <class T>
__device__ __forceinline__ void wide_out_load(uint8_t* dst, uint64_t* bar,
                                              const CUtensorMap* o0,
                                              const CUtensorMap* o1, int c,
                                              int cg, int hb, int rb, int d) {
  using namespace pa_sm90;
  int live = 0;
  for (int i = 0; i < 8; ++i) live += c + (i >= 4 ? cg : 0) + 32 * (i & 3) < d;
  mbar_arrive_expect_tx(bar, live * T::SBOX);
  for (int i = 0; i < 8; ++i) {
    const int col = c + (i >= 4 ? cg : 0) + 32 * (i & 3);
    if (col < d)
      tma_load_3d(dst + i * T::SBOX, i >= 4 ? o1 : o0, bar, col, hb, rb);
  }
}

}  // namespace pa_flash
