// K1 on Hopper: the gather-with-zero-fill permute behind every pencil hop.
//
// Replaces ops/pallas_kernels.py::pallas_permute (_permute_kernel), the
// JAX package's VMEM-tiled jnp.transpose.  On the TPU the permute was
// folded into lax.all_to_all(split_axis, concat_axis); NCCL only splits a
// contiguous leading dimension, so on the GPU every hop makes two real
// memory passes, and both are this kernel:
//   pack   : input memory order -> (P tiles of dim b, output memory order),
//            zero-filling the tail padding of dim b;
//   unpack : concatenate the received tiles along dim a, drop its tail
//            padding and store in the output memory order;
//   local  : a plain permute (same decomposition, new memory order).
//
// What it computes: an index space of nd dims (ext[]) where element I
// reads in[sum I_k si_k] and writes out[sum I_k so_k].  Two linear masks
// make pack and unpack one kernel: where sum I_k zc_k >= zbound the input
// element does not exist and 0 is written; where sum I_k sc_k >= sbound the
// output element does not exist and nothing is written.  The Python
// wrapper merges dimensions that stay adjacent on both sides and folds a
// run that is contiguous on both sides (the trailing extra dims, e.g. the
// 3 or 6 velocity components) into one wider element before launching.
// Elements move as opaque words (1, 2, 4, 8 or 16 bytes, wn words each),
// so every dtype, NaN payloads included, is copied bit for bit.  Offsets
// are 64-bit: a 6-component 1024^3 field has 6.4e9 elements.
//
// Bound: device memory.  The least time is 2 x bytes / bandwidth (each
// element read once and written once; 3.35 TB/s on an H100 SXM).  When the
// input's contiguous dimension differs from the output's, a naive copy
// coalesces only one side and wastes most of every 32-byte sector on the
// other.  The tiled path therefore stages a TI x TO tile in shared memory:
// consecutive threads read along the input-contiguous dim and write along
// the output-contiguous dim, so both sides move whole sectors; the row
// pitch is padded by one word against bank conflicts.  Tiles are folded
// into a 1-D grid-stride loop (gridDim.y/z are never used).  This is the
// simple, correct version: TMA tile copies and fusing pack into the
// neighbouring FFT stage are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define PA_MAX_DIMS 8

struct PermuteDesc {
  int nd;
  int dI, dO;          // input- and output-contiguous dims (tiled path)
  int TI, TO;          // tile extents, powers of two
  int logTI, logTO;
  int64_t wn;          // words per element
  int64_t ext[PA_MAX_DIMS];
  int64_t si[PA_MAX_DIMS];
  int64_t so[PA_MAX_DIMS];
  int64_t zc[PA_MAX_DIMS];
  int64_t sc[PA_MAX_DIMS];
  int64_t zbound, sbound;
};

template <typename W>
__device__ __forceinline__ W zero_word() { return W(0); }
template <>
__device__ __forceinline__ uint4 zero_word<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// Straight grid-stride copy: output-major walk over words, used when the
// input and output share their contiguous dimension (or have none).
template <typename W>
__global__ void __launch_bounds__(256)
permute_copy_kernel(const W* __restrict__ in, W* __restrict__ out,
                    const PermuteDesc d, const int64_t total_words) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       f < total_words; f += step) {
    int64_t e = f, w = 0;
    if (d.wn != 1) {
      e = f / d.wn;
      w = f - e * d.wn;
    }
    int64_t ioff = 0, ooff = 0, zl = 0, sl = 0;
#pragma unroll
    for (int k = PA_MAX_DIMS - 1; k >= 0; --k) {
      if (k < d.nd) {
        const int64_t n = d.ext[k];
        const int64_t q = e / n;
        const int64_t i = e - q * n;
        e = q;
        ioff += i * d.si[k];
        ooff += i * d.so[k];
        zl += i * d.zc[k];
        sl += i * d.sc[k];
      }
    }
    if (sl >= d.sbound) continue;
    W v = zero_word<W>();
    if (zl < d.zbound) v = in[ioff * d.wn + w];
    out[ooff * d.wn + w] = v;
  }
}

// Shared-memory tiled copy: one TI x TO tile of (input-contiguous dim dI,
// output-contiguous dim dO) per loop trip; the other dims index the tile.
template <typename W>
__global__ void __launch_bounds__(256)
permute_tiled_kernel(const W* __restrict__ in, W* __restrict__ out,
                     const PermuteDesc d, const int64_t ntiles,
                     const int64_t tilesI, const int64_t tilesO) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* tile = reinterpret_cast<W*>(smem_raw);
  const int wn = (int)d.wn;
  const int rowI = d.TI * wn;  // words of one tile row (fixed o)
  const int rowO = d.TO * wn;  // words of one output run (fixed i)
  const int pitch = rowI + 1;
  const int nwords = d.TI * d.TO * wn;
  const int dI = d.dI, dO = d.dO;
  const int64_t eI = d.ext[dI], eO = d.ext[dO];
  const int64_t siI = d.si[dI], siO = d.si[dO];
  const int64_t soI = d.so[dI], soO = d.so[dO];
  const int64_t zcI = d.zc[dI], zcO = d.zc[dO];
  const int64_t scI = d.sc[dI], scO = d.sc[dO];
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int64_t rem = t;
    const int64_t to = rem % tilesO;
    rem /= tilesO;
    const int64_t ti = rem % tilesI;
    rem /= tilesI;
    const int64_t i0 = ti * d.TI, o0 = to * d.TO;
    int64_t ib = i0 * siI + o0 * siO, ob = i0 * soI + o0 * soO;
    int64_t zb = i0 * zcI + o0 * zcO, sb = i0 * scI + o0 * scO;
#pragma unroll
    for (int k = PA_MAX_DIMS - 1; k >= 0; --k) {
      if (k < d.nd && k != dI && k != dO) {
        const int64_t n = d.ext[k];
        const int64_t q = rem / n;
        const int64_t i = rem - q * n;
        rem = q;
        ib += i * d.si[k];
        ob += i * d.so[k];
        zb += i * d.zc[k];
        sb += i * d.sc[k];
      }
    }
    const int nI = (int)min((int64_t)d.TI, eI - i0);
    const int nO = (int)min((int64_t)d.TO, eO - o0);
    // load: consecutive threads walk dI (and the words of one element)
    for (int f = threadIdx.x; f < nwords; f += blockDim.x) {
      int ol, r;
      if (wn == 1) {
        ol = f >> d.logTI;
        r = f & (d.TI - 1);
      } else {
        ol = f / rowI;
        r = f - ol * rowI;
      }
      const int il = (wn == 1) ? r : r / wn;
      const int w = r - il * wn;
      if (ol < nO && il < nI) {
        W v = zero_word<W>();
        if (zb + il * zcI + ol * zcO < d.zbound)
          v = in[(ib + (int64_t)il * siI + (int64_t)ol * siO) * wn + w];
        tile[ol * pitch + r] = v;
      }
    }
    __syncthreads();
    // store: consecutive threads walk dO (and the words of one element)
    for (int f = threadIdx.x; f < nwords; f += blockDim.x) {
      int il, r;
      if (wn == 1) {
        il = f >> d.logTO;
        r = f & (d.TO - 1);
      } else {
        il = f / rowO;
        r = f - il * rowO;
      }
      const int ol = (wn == 1) ? r : r / wn;
      const int w = r - ol * wn;
      if (ol < nO && il < nI && sb + il * scI + ol * scO < d.sbound)
        out[(ob + (int64_t)il * soI + (int64_t)ol * soO) * wn + w] =
            tile[ol * pitch + il * wn + w];
    }
    __syncthreads();
  }
}

template <typename W>
static void launch(const void* in, void* out, const PermuteDesc& d,
                   int64_t total, int sms, cudaStream_t stream) {
  const int threads = 256;
  const W* src = static_cast<const W*>(in);
  W* dst = static_cast<W*>(out);
  if (d.dI >= 0) {
    const int64_t eI = d.ext[d.dI], eO = d.ext[d.dO];
    const int64_t tilesI = (eI + d.TI - 1) / d.TI;
    const int64_t tilesO = (eO + d.TO - 1) / d.TO;
    const int64_t ntiles = total / (eI * eO) * tilesI * tilesO;
    const int64_t cap = (int64_t)sms * 16;
    const int blocks = (int)(ntiles < cap ? ntiles : cap);
    const size_t smem = (size_t)d.TO * (size_t)(d.TI * d.wn + 1) * sizeof(W);
    permute_tiled_kernel<W><<<blocks, threads, smem, stream>>>(
        src, dst, d, ntiles, tilesI, tilesO);
  } else {
    const int64_t words = total * d.wn;
    const int64_t need = (words + threads - 1) / threads;
    const int64_t cap = (int64_t)sms * 32;
    const int blocks = (int)(need < cap ? need : cap);
    permute_copy_kernel<W><<<blocks, threads, 0, stream>>>(src, dst, d, words);
  }
}

extern "C" int pa_permute(const void* in, void* out, int word_bytes,
                          int64_t wn, int nd, const int64_t* ext,
                          const int64_t* si, const int64_t* so,
                          const int64_t* zc, int64_t zbound,
                          const int64_t* sc, int64_t sbound, int dI, int dO,
                          int TI, int TO, void* stream) {
  if (nd < 1 || nd > PA_MAX_DIMS || wn < 1) return (int)cudaErrorInvalidValue;
  PermuteDesc d;
  d.nd = nd;
  d.dI = dI;
  d.dO = dO;
  d.TI = TI;
  d.TO = TO;
  d.logTI = 0;
  while ((1 << d.logTI) < TI) ++d.logTI;
  d.logTO = 0;
  while ((1 << d.logTO) < TO) ++d.logTO;
  d.wn = wn;
  d.zbound = zbound;
  d.sbound = sbound;
  int64_t total = 1;
  for (int k = 0; k < PA_MAX_DIMS; ++k) {
    const bool live = k < nd;
    d.ext[k] = live ? ext[k] : 1;
    d.si[k] = live ? si[k] : 0;
    d.so[k] = live ? so[k] : 0;
    d.zc[k] = live ? zc[k] : 0;
    d.sc[k] = live ? sc[k] : 0;
    total *= d.ext[k];
  }
  if (total == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 1: launch<uint8_t>(in, out, d, total, sms, s); break;
    case 2: launch<uint16_t>(in, out, d, total, sms, s); break;
    case 4: launch<uint32_t>(in, out, d, total, sms, s); break;
    case 8: launch<unsigned long long>(in, out, d, total, sms, s); break;
    case 16: launch<uint4>(in, out, d, total, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
