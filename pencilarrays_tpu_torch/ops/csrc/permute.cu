// K1 on Hopper: the gather-with-zero-fill permute behind every pencil hop.
//
// Replaces pencilarrays_tpu/ops/pallas_kernels.py:98 (pallas_permute, the
// JAX package's VMEM-tiled jnp.transpose).  On the TPU the permute was
// folded into lax.all_to_all(split_axis, concat_axis); NCCL only splits a
// contiguous leading dimension, so on the GPU every hop makes two real
// memory passes, and both are this kernel:
//   pack   : input memory order -> (P tiles of dim b, output memory order),
//            zero-filling the tail padding of dim b;
//   unpack : concatenate the received tiles along dim a, drop its tail
//            padding and store in the output memory order;
//   local  : a plain permute (same decomposition, new memory order), and
//            the move of the extra dims (3 or 6 vector components) to and
//            from the front around each FFT stage.
//
// What it computes: an index space of nd dims (ext[]) where element I
// reads in[sum I_k si_k] and writes out[sum I_k so_k].  Two linear masks
// make pack and unpack one kernel: where sum I_k zc_k >= zbound the input
// element does not exist and 0 is written; where sum I_k sc_k >= sbound the
// output element does not exist and nothing is written.  The planner
// (ops/permute.py, plan_copy) merges dims that stay adjacent on both sides,
// folds a run contiguous on both sides into one wider element, and picks
// the instance.  Elements move as opaque words (1, 2, 4, 8 or 16 bytes, wn
// words each), so every dtype, NaN payloads included, is copied bit for
// bit.  Offsets are 64-bit (a 6-component 1024^3 field has 6.4e9
// elements); indices inside a tile or a 32-bit-sized copy are decoded with
// precomputed multiply-shift division (FastDiv).
//
// Bound: device memory.  The least time is 2 x bytes / 3.35 TB/s on an
// H100 SXM (each element read once, written once).  To reach it a copy
// needs whole 32-byte sectors on both sides, 16-byte accesses, and enough
// bytes in flight per SM (about 25 KB at 3.35 TB/s and ~1 us latency).
// The instances (measured against dst.copy_(x) on the card, PERF.md):
//   copy   : no transpose (the same dim contiguous on both sides, or
//            elements of 128 bytes and more).  A flat copy (ext = (1,):
//            the unpack on a size-1 axis) moves 16-byte words, four in
//            flight a thread, one block per 4 x 256 words; otherwise a
//            grid-stride walk over words.
//   narrow : a transpose one of whose contiguous dims is short (2 <= C <=
//            16 elements of 4, 8 or 16 bytes, e.g. the NS step's 3 or 6
//            components) and dense with the long one: (N, C) <-> (C, N).
//            A warp moves 32 groups of P = 16 / E positions: the
//            interleaved side (32 x C contiguous 16-byte chunks) through
//            the warp's shared buffer in 512-byte warp instructions, the C
//            x P <-> P x C transpose in registers (C a template argument,
//            so no lane rounds C up), the planar side as C rows of 16-byte
//            chunks.  No block-wide barrier, and as many warps as tiles,
//            so every SM keeps loads in flight.  Its first form, persistent
//            CTAs over a shared-memory ring of C x T tiles (still the
//            tiled instance's ring, timed beside it by chip_smoke.py), ran
//            well behind dst.copy_(x); this one runs at its time.
//   tiled  : any other transpose.  Whole tiles, unmasked and 16-byte
//            aligned, go one warp a tile in the same way: rows of 128 bytes
//            in and out (32 x 32 in f32) through the warp's swizzled shared
//            tile, or, for elements of 2 to 7 16-byte words (the 6 c64
//            components riding a hop), 8 x 8 elements moved chunk by chunk.
//            The rest (ragged or masked tiles, misaligned data, 1- and
//            2-byte or other wide elements, a short dim that narrow does
//            not take) goes in
//            TI x TO tiles (64 x 64 in f32) whose rows are contiguous on
//            each side, in 16-byte chunks where they are aligned: CTAs walk
//            the tiles through a PA_STAGES-deep ring in shared memory, the
//            cp.async loads of the next tiles in flight while this one is
//            stored (16-byte stores gathered from shared memory).  PA_PAD
//            bytes after every 2^seg_shift of a stage, and store chunks
//            that interleave lane_rows rows across a warp, spread the
//            gathers over banks.  A tile whose masks are not uniform over
//            it (pack's padding edge, unpack's dropped tail) takes a
//            word-by-word path through the same stage.
//
// No library call replaces it: x.permute(axes).contiguous() (the
// yardstick chip_smoke.py times, never called by the port) has no zero
// fill, no dropped padding, and no tile split.

#include <cuda_runtime.h>
#include <stdint.h>

#define PA_MAX_DIMS 8
#define PA_PAD 16
#define PA_THREADS 256
#define PA_STAGES 3          // tiles in the tiled instance's ring
#define PA_WAVES 16          // tiled grid: resident CTAs x PA_WAVES
#define PA_NARROW_THREADS 128
#define PA_NARROW_GROUPS 32   // 16-byte groups a narrow warp tile

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1).
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

static FastDiv make_fastdiv(uint32_t d) {
  FastDiv f;
  f.d = d;
  f.s = 0;
  while ((1ull << f.s) < d) ++f.s;
  f.m = (uint32_t)(((1ull << 32) * ((1ull << f.s) - d)) / d + 1);
  return f;
}

struct PermuteDesc {
  int nd;
  int dI, dO;              // input- and output-contiguous dims (2-D)
  int TI, TO;              // tile extents in elements
  int wn;                  // words per element (2-D instances)
  int cin, cout;           // chunk bytes on each side (16 or the word)
  int flat_in, flat_out;   // the tile is one block on that side
  int nouter;              // 2-D: the dims other than dI and dO
  int64_t ext[PA_MAX_DIMS], si[PA_MAX_DIMS], so[PA_MAX_DIMS];
  int64_t zc[PA_MAX_DIMS], sc[PA_MAX_DIMS];
  int64_t zbound, sbound;
  int64_t tilesI, tilesO, ntiles;
  int tile_bytes;          // one ring stage, padded
  int seg_shift;           // PA_PAD bytes after every 2^seg_shift
  int lane_rows;           // rows a warp's store chunks interleave
  int big;                 // ntiles >= 2^31: decode in 64 bits
  int warp_tiles;          // tiled: one warp a full 128-byte-row tile
  FastDiv fd_wn, fd_TI, fd_TO, fd_rin, fd_rl, fd_grp;
  FastDiv fd_tilesI, fd_tilesO, fd_outer[PA_MAX_DIMS];
  FastDiv fd_ext[PA_MAX_DIMS];  // copy instance, 32-bit walk
};

// ---------------------------------------------------------------------------
// copy instance
// ---------------------------------------------------------------------------

// ext = (1,): one element of n words, both sides contiguous.  One block
// per 4 x PA_THREADS words, four in flight a thread; no division.
template <typename W>
__global__ void __launch_bounds__(PA_THREADS)
permute_flat_kernel(const W* __restrict__ in, W* __restrict__ out,
                    const int64_t n) {
  const int64_t f = (int64_t)blockIdx.x * 4 * PA_THREADS + threadIdx.x;
  W v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (f + k * PA_THREADS < n) v[k] = in[f + k * PA_THREADS];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (f + k * PA_THREADS < n) out[f + k * PA_THREADS] = v[k];
}

template <typename W>
__device__ __forceinline__ W zero_word() { return W(0); }
template <>
__device__ __forceinline__ uint4 zero_word<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// Grid-stride walk over words in output order.  I is uint32_t (FastDiv
// decode) when the index space has fewer than 2^31 words, else int64_t.
template <typename W, typename I>
__global__ void __launch_bounds__(PA_THREADS)
permute_copy_kernel(const W* __restrict__ in, W* __restrict__ out,
                    const PermuteDesc d, const int64_t wn,
                    const int64_t total) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       f < total; f += step) {
    I e, w = 0;
    if constexpr (sizeof(I) == 4) {
      e = (I)f;
      if (wn != 1) {
        e = d.fd_wn.div((uint32_t)f);
        w = (I)f - e * (I)wn;
      }
    } else {
      e = f;
      if (wn != 1) {
        e = f / wn;
        w = f - e * wn;
      }
    }
    int64_t ioff = 0, ooff = 0, zl = 0, sl = 0;
#pragma unroll
    for (int k = PA_MAX_DIMS - 1; k >= 0; --k) {
      if (k < d.nd) {
        I q;
        if constexpr (sizeof(I) == 4) q = d.fd_ext[k].div(e);
        else q = e / d.ext[k];
        const int64_t i = (int64_t)(e - q * (I)d.ext[k]);
        e = q;
        ioff += i * d.si[k];
        ooff += i * d.so[k];
        zl += i * d.zc[k];
        sl += i * d.sc[k];
      }
    }
    if (sl >= d.sbound) continue;
    W v = zero_word<W>();
    if (zl < d.zbound) v = in[ioff * wn + w];
    out[ooff * wn + w] = v;
  }
}

// ---------------------------------------------------------------------------
// 2-D instances (narrow, tiled)
// ---------------------------------------------------------------------------

// shared-memory byte of logical tile byte b: PA_PAD bytes of padding
// after every 2^seg_shift (16-byte chunks stay whole and aligned)
__device__ __forceinline__ uint32_t phys(uint32_t b, int seg_shift) {
  return b + (b >> seg_shift) * PA_PAD;
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes) : "memory");
  else if constexpr (B == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chunk of a tile into shared memory: 16 bytes (of which `bytes` are
// read, the rest zero-filled) or one word.
template <typename W>
__device__ __forceinline__ void load_chunk(char* dst, const char* src,
                                           int chunk, int bytes) {
  if (chunk == 16) {
    cp_async<16>(dst, src, bytes);
  } else if constexpr (sizeof(W) >= 4) {
    cp_async<(int)sizeof(W)>(dst, src, (int)sizeof(W));
  } else {
    *reinterpret_cast<W*>(dst) = *reinterpret_cast<const W*>(src);
  }
}

struct Tile {
  int64_t ib, ob, zb, sb;  // element offsets of the tile's (0, 0)
  int nI, nO;
  int load;                // 0 all present, 1 none, 2 mixed
  int store;               // 0 all stored, 1 none, 2 mixed
};

__device__ __forceinline__ Tile decode(const PermuteDesc& d, int64_t t) {
  Tile r;
  int64_t to, ti, rem = t;
  if (!d.big) {  // every thread decodes: 32-bit multiply-shift division
    uint32_t u = (uint32_t)t, q = d.fd_tilesO.div(u);
    to = u - q * (uint32_t)d.tilesO;
    u = q;
    q = d.fd_tilesI.div(u);
    ti = u - q * (uint32_t)d.tilesI;
    rem = q;
  } else {
    to = rem % d.tilesO;
    rem /= d.tilesO;
    ti = rem % d.tilesI;
    rem /= d.tilesI;
  }
  const int dI = d.dI, dO = d.dO;
  const int64_t i0 = ti * d.TI, o0 = to * d.TO;
  r.ib = i0 * d.si[dI] + o0 * d.si[dO];
  r.ob = i0 * d.so[dI] + o0 * d.so[dO];
  r.zb = i0 * d.zc[dI] + o0 * d.zc[dO];
  r.sb = i0 * d.sc[dI] + o0 * d.sc[dO];
  for (int k = d.nouter - 1; k >= 0; --k) {  // outer dims sit at 0..nouter-1
    int64_t q;
    if (!d.big) q = d.fd_outer[k].div((uint32_t)rem);
    else q = rem / d.ext[k];
    const int64_t i = rem - q * d.ext[k];
    rem = q;
    r.ib += i * d.si[k];
    r.ob += i * d.so[k];
    r.zb += i * d.zc[k];
    r.sb += i * d.sc[k];
  }
  r.nI = (int)min((int64_t)d.TI, d.ext[dI] - i0);
  r.nO = (int)min((int64_t)d.TO, d.ext[dO] - o0);
  // the masks are linear with coefficients >= 0: their extremes over the
  // tile are at its corners
  const int64_t zmax = r.zb + (r.nI - 1) * d.zc[dI] + (r.nO - 1) * d.zc[dO];
  const int64_t smax = r.sb + (r.nI - 1) * d.sc[dI] + (r.nO - 1) * d.sc[dO];
  r.load = zmax < d.zbound ? 0 : (r.zb >= d.zbound ? 1 : 2);
  r.store = smax < d.sbound ? 0 : (r.sb >= d.sbound ? 1 : 2);
  return r;
}

// Start tile t's way into the stage at `st` (logical layout [o][i][w]).
template <typename W>
__device__ __forceinline__ void issue(const PermuteDesc& d, const char* in,
                                      char* st, int64_t t) {
  if (t >= d.ntiles) return;
  const Tile T = decode(d, t);
  const int wb = (int)sizeof(W) * d.wn;          // element bytes
  if (T.load == 0) {
    const int cb = d.cin;
    if (d.flat_in) {                              // one block
      const int bytes = T.nO * d.TI * wb;
      const char* g = in + T.ib * wb;
      const int n = (bytes + cb - 1) / cb;
      for (int c = threadIdx.x; c < n; c += blockDim.x)
        load_chunk<W>(st + phys(c * cb, d.seg_shift), g + (int64_t)c * cb, cb,
                      min(cb, bytes - c * cb));
    } else {                                      // nO rows of nI elements
      const int row = T.nI * wb, pitch = d.TI * wb;
      const int per = (pitch + cb - 1) / cb;      // chunks a full row
      const int64_t siO = d.si[d.dO];
      for (int f = threadIdx.x; f < T.nO * per; f += blockDim.x) {
        const int o = (int)d.fd_rin.div(f);
        const int c = f - o * per;
        if (c * cb >= row) continue;
        load_chunk<W>(st + phys(o * pitch + c * cb, d.seg_shift),
                      in + (T.ib + o * siO) * wb + (int64_t)c * cb, cb,
                      min(cb, row - c * cb));
      }
    }
  } else {                                        // word by word, masked
    const int wn = d.wn, TI = d.TI;
    const int64_t zcI = d.zc[d.dI], zcO = d.zc[d.dO], siO = d.si[d.dO];
    const W* src = reinterpret_cast<const W*>(in);
    const int n = d.TO * TI * wn;
    for (int f = threadIdx.x; f < n; f += blockDim.x) {
      const int e = (int)d.fd_wn.div(f), w = f - e * wn;
      const int o = (int)d.fd_TI.div(e), i = e - o * TI;
      if (o >= T.nO || i >= T.nI) continue;
      W v = zero_word<W>();
      if (T.load == 2 && T.zb + i * zcI + o * zcO < d.zbound)
        v = src[(T.ib + i + o * siO) * wn + w];
      *reinterpret_cast<W*>(st + phys(f * (int)sizeof(W), d.seg_shift)) = v;
    }
  }
}

// Store tile t from the stage at `st`.
template <typename W>
__device__ __forceinline__ void drain(const PermuteDesc& d, char* out,
                                      const char* st, int64_t t) {
  const Tile T = decode(d, t);
  if (T.store == 1) return;
  constexpr int WB = (int)sizeof(W);
  constexpr int PER = 16 / WB;                    // words a 16-byte chunk
  const int wn = d.wn, TI = d.TI, TO = d.TO;
  W* dst = reinterpret_cast<W*>(out);
  if (T.store == 2) {                             // word by word, masked
    const int64_t scI = d.sc[d.dI], scO = d.sc[d.dO], soI = d.so[d.dI];
    const int n = TI * TO * wn;
    for (int f = threadIdx.x; f < n; f += blockDim.x) {
      const int e = (int)d.fd_wn.div(f), w = f - e * wn;
      const int i = (int)d.fd_TO.div(e), o = e - i * TO;
      if (o >= T.nO || i >= T.nI || T.sb + i * scI + o * scO >= d.sbound)
        continue;
      dst[(T.ob + o + i * soI) * wn + w] = *reinterpret_cast<const W*>(
          st + phys(((o * TI + i) * wn + w) * WB, d.seg_shift));
    }
    return;
  }
  const int cw = d.cout / WB;                     // words a chunk
  // flat: one row of the whole block; else rows i < nI of nO elements,
  // lane_rows of them interleaved across consecutive chunks (f -> row
  // f % lane_rows of its group, chunk f / lane_rows) so that a warp's
  // gathers spread over banks
  int n_f, per, row;                              // row: words a row
  if (d.flat_out) {
    row = T.nI * TO * wn;
    per = (row + cw - 1) / cw;
    n_f = per;
  } else {
    row = T.nO * wn;
    per = (TO * wn + cw - 1) / cw;                // chunks a full row
    n_f = (T.nI + d.lane_rows - 1) / d.lane_rows * d.lane_rows * per;
  }
  const int64_t soI = d.so[d.dI];
  for (int f = threadIdx.x; f < n_f; f += blockDim.x) {
    int r = 0, c = f;
    if (!d.flat_out) {
      const int g = (int)d.fd_grp.div(f), h = f - g * d.lane_rows * per;
      c = (int)d.fd_rl.div(h);
      r = g * d.lane_rows + (h - c * d.lane_rows);
      if (r >= T.nI) continue;
    }
    const int u0 = c * cw;
    if (u0 >= row) continue;
    // word u0 of row r: element e = u0 / wn (o along the row; flat: i, o)
    int e = (int)d.fd_wn.div(u0), w = u0 - e * wn;
    int i = r, o = e;
    if (d.flat_out) {
      i = (int)d.fd_TO.div(e);
      o = e - i * TO;
    }
    const int64_t g = (T.ob + (int64_t)r * soI) * wn + u0;
    const int n = min(cw, row - u0);
    union { uint4 v; W x[PER]; } buf;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (k < n) {
        buf.x[k] = *reinterpret_cast<const W*>(
            st + phys(((o * TI + i) * wn + w) * WB, d.seg_shift));
        if (++w == wn) {
          w = 0;
          if (++o == TO) {
            o = 0;
            ++i;
          }
        }
      }
    }
    if (n == PER && cw == PER) {
      *reinterpret_cast<uint4*>(dst + g) = buf.v;
    } else {
      for (int k = 0; k < n; ++k) dst[g + k] = buf.x[k];
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(PA_THREADS)
permute_tiled_kernel(const char* __restrict__ in, char* __restrict__ out,
                     const PermuteDesc d) {
  extern __shared__ __align__(128) char smem[];
  const int64_t first = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int s = 0; s < PA_STAGES - 1; ++s) {
    issue<W>(d, in, smem + s * d.tile_bytes, first + s * step);
    cp_async_commit();
  }
  int s = 0;
  for (int64_t t = first; t < d.ntiles; t += step) {
    cp_async_wait<PA_STAGES - 2>();
    __syncthreads();  // tile t landed; the stage it frees was drained
    const int sn = (s + PA_STAGES - 1) % PA_STAGES;
    issue<W>(d, in, smem + sn * d.tile_bytes, t + (PA_STAGES - 1) * step);
    cp_async_commit();
    drain<W>(d, out, smem + s * d.tile_bytes, t);
    s = s + 1 == PA_STAGES ? 0 : s + 1;
  }
  cp_async_wait<0>();
}

// narrow: one warp moves one tile of 32 groups of P = 16 / sizeof(W)
// positions by C components.  The interleaved side (the tile's 32 x C
// 16-byte chunks, contiguous) goes through the warp's shared buffer in
// 512-byte warp instructions; each lane holds one group's C chunks in
// registers and transposes them there (P x C <-> C x P words); the planar
// side moves as C rows of 16-byte chunks, 512 bytes a row a warp
// instruction.  IN: the input is the interleaved side.
template <typename W, int C, bool IN>
__global__ void __launch_bounds__(PA_NARROW_THREADS)
permute_narrow_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                      const PermuteDesc d) {
  constexpr int P = 16 / (int)sizeof(W);
  constexpr int E = (int)sizeof(W);
  constexpr int WARPS = PA_NARROW_THREADS / 32;
  __shared__ uint4 buf[WARPS][32 * C];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * WARPS + wp;
  if (t >= d.ntiles) return;                      // warp-uniform
  int64_t ib, ob;
  int n;                                          // positions in the tile
  if (d.nouter == 0) {  // one slice: the tile is t along the long dim
    const int64_t p0 = t * 32 * P, N = d.ext[IN ? d.dO : d.dI];
    ib = IN ? p0 * C : p0;
    ob = IN ? p0 : p0 * C;
    n = (int)min((int64_t)32 * P, N - p0);
  } else {
    const Tile T = decode(d, t);
    ib = T.ib;
    ob = T.ob;
    n = IN ? T.nO : T.nI;
  }
  const int ng = n / P;                           // groups in this tile
  const int64_t i16 = ib * E / 16, o16 = ob * E / 16;
  const int64_t rs = (IN ? d.so[d.dI] : d.si[d.dO]) * E / 16;  // planar row
  uint4* b = buf[wp];
  uint4 v[C];
  if constexpr (IN) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int q = lane + 32 * k;
      if (q < ng * C) b[q] = in[i16 + q];
    }
    __syncwarp();
    if (lane < ng) {
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = b[lane * C + j];
      const W* w = reinterpret_cast<const W*>(v);   // w[p * C + c]
#pragma unroll
      for (int c = 0; c < C; ++c) {
        union { uint4 q; W x[P]; } o;
#pragma unroll
        for (int p = 0; p < P; ++p) o.x[p] = w[p * C + c];
        out[o16 + c * rs + lane] = o.q;
      }
    }
  } else {
    if (lane < ng) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = in[i16 + c * rs + lane];
      const W* w = reinterpret_cast<const W*>(v);   // w[c * P + p]
#pragma unroll
      for (int j = 0; j < C; ++j) {
        union { uint4 q; W x[P]; } o;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int e = j * P + k;                    // interleaved word
          o.x[k] = w[(e % C) * P + e / C];
        }
        b[lane * C + j] = o.q;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int q = lane + 32 * k;
      if (q < ng * C) out[o16 + q] = b[q];
    }
  }
}

// tiled, warp form (full tiles, unmasked, 16-byte aligned, elements of 4,
// 8 or 16 bytes): one warp moves one R x R tile, R = 128 / sizeof(W), whose
// rows are 128 bytes (one cache line) on both sides: 4 rows of 8 16-byte
// chunks a warp instruction in, the same out.  In the warp's shared tile,
// chunk c of row o sits at c ^ ((o / Q) & 7) (Q elements a chunk), so that
// the 32 gathers of a store instruction hit 32 banks.
template <typename W>
__global__ void __launch_bounds__(PA_NARROW_THREADS)
permute_tiled_warp_kernel(const uint4* __restrict__ in,
                          uint4* __restrict__ out, const PermuteDesc d) {
  constexpr int E = (int)sizeof(W);
  constexpr int Q = 16 / E;                       // elements a chunk
  constexpr int R = 8 * Q;                        // tile side, elements
  constexpr int WARPS = PA_NARROW_THREADS / 32;
  __shared__ uint4 buf[WARPS][R * 8];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * WARPS + wp;
  if (t >= d.ntiles) return;                      // warp-uniform
  const Tile T = decode(d, t);
  const int64_t i16 = T.ib * E / 16, o16 = T.ob * E / 16;
  const int64_t siO = d.si[d.dO] * E / 16;        // input row, in chunks
  const int64_t soI = d.so[d.dI] * E / 16;        // output row, in chunks
  uint4* b = buf[wp];
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {               // rows o along dO
    const int o = 4 * k + (lane >> 3), c = lane & 7;
    b[o * 8 + (c ^ ((o / Q) & 7))] = in[i16 + o * siO + c];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {               // rows i along dI
    const int i = 4 * k + (lane >> 3), j = lane & 7;
    union { uint4 q; W x[Q]; } v;
#pragma unroll
    for (int p = 0; p < Q; ++p) {
      const int o = j * Q + p;                    // (o / Q) & 7 == j
      v.x[p] = reinterpret_cast<const W*>(b + o * 8)[((i / Q) ^ j) * Q +
                                                     i % Q];
    }
    out[o16 + i * soI + j] = v.q;
  }
}

// tiled, warp form for elements of WN 16-byte words (32 to 112 bytes: the
// vector components riding a hop, e.g. 6 c64 = 48 bytes): one warp moves
// one 8 x 8-element tile.  Every 16-byte chunk is one word of one element,
// so the warp walks the tile's input rows chunk by chunk into its shared
// tile ([o][i][w]) and the output rows chunk by chunk out of it, 512
// contiguous-in-row bytes a warp instruction, no gather.
template <int WN>
__global__ void __launch_bounds__(PA_NARROW_THREADS)
permute_tiled_wide_kernel(const uint4* __restrict__ in,
                          uint4* __restrict__ out, const PermuteDesc d) {
  constexpr int R = 8, ROW = R * WN, N = R * ROW;  // chunks a row, a tile
  constexpr int WARPS = PA_NARROW_THREADS / 32;
  __shared__ uint4 buf[WARPS][N];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * WARPS + wp;
  if (t >= d.ntiles) return;                      // warp-uniform
  const Tile T = decode(d, t);
  const int64_t i16 = T.ib * WN, o16 = T.ob * WN;
  const int64_t siO = d.si[d.dO] * WN, soI = d.so[d.dI] * WN;  // chunks
  uint4* b = buf[wp];
#pragma unroll
  for (int q = lane; q < N; q += 32) {            // input rows o along dO
    const int o = q / ROW, c = q - o * ROW;
    b[q] = in[i16 + o * siO + c];
  }
  __syncwarp();
#pragma unroll
  for (int q = lane; q < N; q += 32) {            // output rows i along dI
    const int i = q / ROW, r = q - i * ROW;
    const int o = r / WN, w = r - o * WN;
    out[o16 + i * soI + r] = b[(o * R + i) * WN + w];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename W>
static int launch_tiled(const void* in, void* out, PermuteDesc& d, int sms,
                        cudaStream_t stream) {
  auto kernel = permute_tiled_kernel<W>;
  const size_t smem = (size_t)PA_STAGES * d.tile_bytes;
  // the shared-memory opt-in and the occupancy it gives, per size (asked
  // once: they cost host time on every launch otherwise)
  static size_t last_smem = 0;
  static int last_per_sm = 0;
  if (last_smem != smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        PA_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_smem = smem;
    last_per_sm = per_sm;
  }
  const int64_t cap = (int64_t)sms * last_per_sm * PA_WAVES;
  const int blocks = (int)(d.ntiles < cap ? d.ntiles : cap);
  kernel<<<blocks, PA_THREADS, smem, stream>>>(
      static_cast<const char*>(in), static_cast<char*>(out), d);
  return 0;
}

template <typename W, int C>
static int launch_narrow_c(const void* in, void* out, const PermuteDesc& d,
                           cudaStream_t stream) {
  const int64_t warps = PA_NARROW_THREADS / 32;
  const int64_t blocks = (d.ntiles + warps - 1) / warps;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  const uint4* src = static_cast<const uint4*>(in);
  uint4* dst = static_cast<uint4*>(out);
  if (d.flat_in)
    permute_narrow_kernel<W, C, true><<<(int)blocks, PA_NARROW_THREADS, 0,
                                        stream>>>(src, dst, d);
  else
    permute_narrow_kernel<W, C, false><<<(int)blocks, PA_NARROW_THREADS, 0,
                                         stream>>>(src, dst, d);
  return 0;
}

template <typename W>
static int launch_narrow(const void* in, void* out, const PermuteDesc& d,
                         int C, cudaStream_t stream) {
  switch (C) {
#define PA_NARROW_CASE(n) \
    case n: return launch_narrow_c<W, n>(in, out, d, stream);
    PA_NARROW_CASE(2) PA_NARROW_CASE(3) PA_NARROW_CASE(4) PA_NARROW_CASE(5)
    PA_NARROW_CASE(6) PA_NARROW_CASE(7) PA_NARROW_CASE(8) PA_NARROW_CASE(9)
    PA_NARROW_CASE(10) PA_NARROW_CASE(11) PA_NARROW_CASE(12)
    PA_NARROW_CASE(13) PA_NARROW_CASE(14) PA_NARROW_CASE(15)
    PA_NARROW_CASE(16)
#undef PA_NARROW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename W>
static int launch(const void* in, void* out, PermuteDesc& d, int instance,
                  int64_t wn, int64_t total, int sms, cudaStream_t stream) {
  const W* src = static_cast<const W*>(in);
  W* dst = static_cast<W*>(out);
  if (instance == 0) {
    const int64_t words = total * wn;
    if (d.nd == 1 && d.ext[0] == 1) {
      const int64_t blocks = (words + 4 * PA_THREADS - 1) / (4 * PA_THREADS);
      if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
      permute_flat_kernel<W><<<(int)blocks, PA_THREADS, 0, stream>>>(
          src, dst, words);
      return 0;
    }
    const int64_t need = (words + PA_THREADS - 1) / PA_THREADS;
    const int64_t cap = (int64_t)sms * 32;
    const int blocks = (int)(need < cap ? need : cap);
    if (words < (1ll << 31)) {
      d.fd_wn = make_fastdiv((uint32_t)wn);
      for (int k = 0; k < PA_MAX_DIMS; ++k)
        d.fd_ext[k] = make_fastdiv((uint32_t)d.ext[k]);
      permute_copy_kernel<W, uint32_t><<<blocks, PA_THREADS, 0, stream>>>(
          src, dst, d, wn, words);
    } else {
      permute_copy_kernel<W, int64_t><<<blocks, PA_THREADS, 0, stream>>>(
          src, dst, d, wn, words);
    }
    return 0;
  }
  if constexpr (sizeof(W) >= 4) {
    if (instance == 1)
      return launch_narrow<W>(in, out, d, d.flat_in ? d.TI : d.TO, stream);
    if (d.warp_tiles) {
      const int64_t warps = PA_NARROW_THREADS / 32;
      const int64_t blocks = (d.ntiles + warps - 1) / warps;
      if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
      const uint4* src4 = static_cast<const uint4*>(in);
      uint4* dst4 = static_cast<uint4*>(out);
      const int g = (int)blocks;
      if (wn == 1) {
        permute_tiled_warp_kernel<W><<<g, PA_NARROW_THREADS, 0, stream>>>(
            src4, dst4, d);
        return 0;
      }
      if constexpr (sizeof(W) == 16) {
        switch (wn) {
#define PA_WIDE_CASE(n)                                                    \
          case n:                                                          \
            permute_tiled_wide_kernel<n><<<g, PA_NARROW_THREADS, 0,        \
                                           stream>>>(src4, dst4, d);       \
            return 0;
          PA_WIDE_CASE(2) PA_WIDE_CASE(3) PA_WIDE_CASE(4) PA_WIDE_CASE(5)
          PA_WIDE_CASE(6) PA_WIDE_CASE(7)
#undef PA_WIDE_CASE
          default: break;
        }
      }
      return (int)cudaErrorInvalidValue;
    }
  }
  if (instance == 1 || d.warp_tiles) return (int)cudaErrorInvalidValue;
  return launch_tiled<W>(in, out, d, sms, stream);
}

extern "C" int pa_permute(const void* in, void* out, int instance,
                          int word_bytes, int64_t wn, int nd,
                          const int64_t* ext, const int64_t* si,
                          const int64_t* so, const int64_t* zc,
                          int64_t zbound, const int64_t* sc, int64_t sbound,
                          int dI, int dO, int TI, int TO, int vec_in,
                          int vec_out, int flat_in, int flat_out,
                          int lane_rows, int seg_shift, int warp_tiles,
                          void* stream) {
  if (nd < 1 || nd > PA_MAX_DIMS || wn < 1 || instance < 0 || instance > 2)
    return (int)cudaErrorInvalidValue;
  PermuteDesc d = {};
  d.nd = nd;
  d.zbound = zbound;
  d.sbound = sbound;
  int64_t total = 1;
  for (int k = 0; k < nd; ++k) total *= ext[k];
  if (total == 0) return 0;
  if (instance == 0) {
    for (int k = 0; k < PA_MAX_DIMS; ++k) {
      const bool live = k < nd;
      d.ext[k] = live ? ext[k] : 1;
      d.si[k] = live ? si[k] : 0;
      d.so[k] = live ? so[k] : 0;
      d.zc[k] = live ? zc[k] : 0;
      d.sc[k] = live ? sc[k] : 0;
    }
  } else {
    // outer dims first (in order, innermost last), then dI, dO
    if (dI < 0 || dO < 0 || dI == dO || TI < 1 || TO < 1 || wn > 1024 ||
        (vec_in != 16 && vec_in != word_bytes) ||
        (vec_out != 16 && vec_out != word_bytes))
      return (int)cudaErrorInvalidValue;
    int j = 0;
    for (int k = 0; k < nd; ++k) {
      if (k == dI || k == dO) continue;
      d.ext[j] = ext[k];
      d.si[j] = si[k];
      d.so[j] = so[k];
      d.zc[j] = zc[k];
      d.sc[j] = sc[k];
      ++j;
    }
    d.nouter = j;
    const int ks[2] = {dI, dO};
    for (int m = 0; m < 2; ++m, ++j) {
      d.ext[j] = ext[ks[m]];
      d.si[j] = si[ks[m]];
      d.so[j] = so[ks[m]];
      d.zc[j] = zc[ks[m]];
      d.sc[j] = sc[ks[m]];
    }
    d.dI = d.nouter;
    d.dO = d.nouter + 1;
    d.TI = TI;
    d.TO = TO;
    d.wn = (int)wn;
    d.cin = vec_in;
    d.cout = vec_out;
    d.flat_in = flat_in;
    d.flat_out = flat_out;
    d.tilesI = (ext[dI] + TI - 1) / TI;
    d.tilesO = (ext[dO] + TO - 1) / TO;
    d.ntiles = total / (ext[dI] * ext[dO]) * d.tilesI * d.tilesO;
    const int64_t raw = ((int64_t)TI * TO * wn * word_bytes + 15) / 16 * 16;
    if (lane_rows < 1 || lane_rows > TI || seg_shift < 4 || seg_shift > 12)
      return (int)cudaErrorInvalidValue;
    const int64_t padded = raw + (raw >> seg_shift) * PA_PAD;
    // narrow: a warp tile of PA_NARROW_GROUPS groups of 16 bytes by C,
    // unmasked, in
    // 16-byte chunks on both sides
    if (instance == 1 &&
        (vec_in != 16 || vec_out != 16 || word_bytes < 4 ||
         zbound != INT64_MAX || sbound != INT64_MAX ||
         !(flat_in ? TO == PA_NARROW_GROUPS * 16 / word_bytes &&
                         TI == ext[dI]
                   : flat_out && TI == PA_NARROW_GROUPS * 16 / word_bytes &&
                         TO == ext[dO])))
      return (int)cudaErrorInvalidValue;
    // tiled in warp tiles: full R x R tiles (R = 128 / element bytes, or 8
    // elements of 2 to 7 16-byte words), unmasked, in 16-byte chunks on
    // both sides
    if (warp_tiles &&
        (instance != 2 || vec_in != 16 || vec_out != 16 || word_bytes < 4 ||
         (wn == 1 ? TI != 128 / word_bytes
                  : word_bytes != 16 || wn > 7 || TI != 8) ||
         TO != TI || ext[dI] % TI || ext[dO] % TO || zbound != INT64_MAX ||
         sbound != INT64_MAX))
      return (int)cudaErrorInvalidValue;
    d.warp_tiles = warp_tiles;
    if (padded * PA_STAGES > 227 * 1024 ||
        (int64_t)TI * TO * wn >= (1ll << 31) / 16)
      return (int)cudaErrorInvalidValue;
    d.tile_bytes = (int)padded;
    d.fd_wn = make_fastdiv((uint32_t)wn);
    d.fd_TI = make_fastdiv((uint32_t)TI);
    d.fd_TO = make_fastdiv((uint32_t)TO);
    const int pin = (TI * (int)wn * word_bytes + vec_in - 1) / vec_in;
    const int cw = vec_out / word_bytes;          // words a store chunk
    const int pout = (TO * (int)wn + cw - 1) / cw;
    d.fd_rin = make_fastdiv((uint32_t)pin);
    d.seg_shift = seg_shift;
    d.lane_rows = lane_rows;
    d.fd_rl = make_fastdiv((uint32_t)lane_rows);
    d.fd_grp = make_fastdiv((uint32_t)(lane_rows * pout));
    d.big = d.ntiles >= (1ll << 31);
    if (!d.big) {
      d.fd_tilesI = make_fastdiv((uint32_t)d.tilesI);
      d.fd_tilesO = make_fastdiv((uint32_t)d.tilesO);
      for (int k = 0; k < d.nouter; ++k)
        d.fd_outer[k] = make_fastdiv((uint32_t)d.ext[k]);
    }
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (word_bytes) {
    case 1: err = launch<uint8_t>(in, out, d, instance, wn, total, sms, s); break;
    case 2: err = launch<uint16_t>(in, out, d, instance, wn, total, sms, s); break;
    case 4: err = launch<uint32_t>(in, out, d, instance, wn, total, sms, s); break;
    case 8: err = launch<unsigned long long>(in, out, d, instance, wn, total, sms, s); break;
    case 16: err = launch<uint4>(in, out, d, instance, wn, total, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
