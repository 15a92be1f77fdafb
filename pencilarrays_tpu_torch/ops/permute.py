"""K1 — the permute behind every pencil hop, and its plain versions.

Port of ``ops/pallas_kernels.py::pallas_permute`` (the JAX package's
VMEM-tiled ``jnp.transpose``).  On the TPU the permute folds into
``lax.all_to_all(split_axis=b, concat_axis=a)``; NCCL's
``all_to_all_single`` only splits a contiguous leading dimension, so on
the GPU each hop makes two real memory passes around the exchange, and
both are this kernel (``csrc/permute.cu``):

* :func:`permute` — ``x.permute(axes).contiguous()`` (the local path);
* :func:`pack` — permute, zero-pad dim ``dim`` to ``P * ceil(n / P)`` and
  lay its ``P`` tiles out as a new leading dimension (what
  ``all_to_all_single`` splits);
* :func:`unpack` — concatenate the ``P`` received tiles along ``dim``,
  drop its tail padding down to ``n``, then permute.

Each reads any view (a strided chunk of a block, at any storage offset)
and writes a new contiguous tensor or, given ``out=``, a view of a larger
one: a :class:`~pencilarrays_tpu_torch.parallel.transpositions.Pipelined`
hop packs each chunk straight out of the block and unpacks it straight
into its slice of the output, moving the bytes of the unchunked hop.

For a tensor on the CPU each function runs its plain PyTorch version
(``*_plain``: ``permute``/``cat``/``reshape``/``narrow``/``contiguous``,
then ``out.copy_``); for a CUDA tensor it launches the kernel or raises —
there is no fallback, and a copy the kernel cannot plan raises.  On the
card :func:`permute` is an autograd function whose backward is K1 with
the inverse axes; :func:`pack` and :func:`unpack` have no gradient of
their own (a hop's, ``transpositions._Hop``, is the inverse hop) and
raise on an input that wants one.

All three share one description of the copy (:class:`CopyPlan`): an index
space whose element ``I`` reads ``in[sum I_k si_k]`` and writes
``out[sum I_k so_k]``, with a zero-fill mask (pack's padding) and a skip
mask (unpack's dropped padding); the strides are the views' own.
:func:`plan_copy` simplifies it — drops unit dims, merges dims that stay
adjacent on both sides, folds a run that is contiguous on both sides (or
its largest part dividing every other stride) into a wider element — and
picks the instance (``copy``, ``narrow`` or ``tiled``, see
:class:`CopyPlan`), the word size and the tile, from the merged shape, the
strides, the element size and the address alignment alone.  Every launch
adds one to :data:`launches` and to its instance's
:data:`launches_by_instance`, and its bytes to :data:`bytes_moved`.
:func:`emulate` executes a plan on the CPU as its instance walks it, so
the CPU tests check every plan the card would run against the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "permute", "pack", "unpack",
    "permute_plain", "pack_plain", "unpack_plain",
    "CopyPlan", "plan_copy", "emulate", "run_plan",
]

launches = 0
"""Kernel launches since the last reset (``permute.launches = 0``)."""

INSTANCES = ("copy", "narrow", "tiled")
launches_by_instance = {i: 0 for i in INSTANCES}
"""Launches of each instance (reset each entry to 0)."""

bytes_moved = 0
"""Bytes the launches since the last reset read and wrote, each input and
output element once (``permute.bytes_moved = 0``)."""

recorded = None
"""When a dict, every launch adds one under its class ``(kind, shape,
axes, dtype, dim, P or n)``: the launches a run makes, to be timed alone
(``chip_smoke.py``)."""

_MAX_DIMS = 8          # PA_MAX_DIMS in csrc/permute.cu
_NARROW_MAX = 16       # a narrow (or flat) tile's short dim, in elements
_NARROW_GROUPS = 32    # 16-byte groups a narrow warp tile (PA_NARROW_GROUPS)
_WIDE_ELEM = 128       # elements this wide move as rows: no transpose
_TILE_BYTES = 16384    # one stage of a 2-D instance's ring
_NO_MASK = (1 << 63) - 1


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick the kernel is held to)
# ---------------------------------------------------------------------------

def permute_plain(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    return x.permute(tuple(axes)).contiguous()


def pack_plain(x: torch.Tensor, axes: Sequence[int], dim: int,
               P: int) -> torch.Tensor:
    y = x.permute(tuple(axes))
    n = y.shape[dim]
    blk = -(-n // P)
    if P * blk != n:
        zshape = list(y.shape)
        zshape[dim] = P * blk - n
        y = torch.cat([y, y.new_zeros(zshape)], dim=dim)
    shape = list(y.shape)
    shape[dim:dim + 1] = [P, blk]
    return y.reshape(shape).movedim(dim, 0).contiguous()


def unpack_plain(x: torch.Tensor, axes: Sequence[int], dim: int,
                 n: int) -> torch.Tensor:
    P, tile = x.shape[0], list(x.shape[1:])
    y = x.movedim(0, dim)
    tile[dim] = P * tile[dim]
    y = y.reshape(tile).narrow(dim, 0, n)
    return y.permute(tuple(axes)).contiguous()


# ---------------------------------------------------------------------------
# copy descriptions
# ---------------------------------------------------------------------------

def _contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= int(n)
    return tuple(reversed(out))


def _describe_permute(shape, axes, ist=None, ost=None):
    """``ist``/``ost``: element strides of the input and of the output
    (default contiguous); the output's follow its own (permuted) dims."""
    ist = _contiguous_strides(shape) if ist is None else tuple(ist)
    out_shape = tuple(shape[a] for a in axes)
    ost = _contiguous_strides(out_shape) if ost is None else tuple(ost)
    K = len(axes)
    return (out_shape, out_shape, tuple(ist[a] for a in axes), ost,
            (0,) * K, _NO_MASK, (0,) * K, _NO_MASK)


def _describe_pack(shape, axes, dim, P, ist=None, ost=None):
    ist = _contiguous_strides(shape) if ist is None else tuple(ist)
    tile = [shape[a] for a in axes]
    n = tile[dim]
    blk = -(-n // P)
    tile[dim] = blk
    out_shape = (P,) + tuple(tile)
    K = len(out_shape)
    si = (blk * ist[axes[dim]],) + tuple(ist[a] for a in axes)
    ost = _contiguous_strides(out_shape) if ost is None else tuple(ost)
    # input element exists iff j * blk + i_dim < n
    zc = (blk,) + tuple(1 if k == dim else 0 for k in range(K - 1))
    return (out_shape, out_shape, si, ost, zc, n, (0,) * K, _NO_MASK)


def _describe_unpack(shape, axes, dim, n, ist=None, ost=None):
    P, tile = shape[0], list(shape[1:])
    blk = tile[dim]
    out_tile = list(tile)
    out_tile[dim] = n
    out_shape = tuple(out_tile[a] for a in axes)
    ost = _contiguous_strides(out_shape) if ost is None else tuple(ost)
    pos = {a: i for i, a in enumerate(axes)}
    so_tile = tuple(ost[pos[k]] for k in range(len(tile)))
    K = len(shape)
    so = (blk * so_tile[dim],) + so_tile
    ist = _contiguous_strides(shape) if ist is None else tuple(ist)
    # output element exists iff s * blk + i_dim < n
    sc = (blk,) + tuple(1 if k == dim else 0 for k in range(K - 1))
    return (out_shape, tuple(shape), ist, so, (0,) * K, _NO_MASK, sc, n)


@dataclass(frozen=True)
class CopyPlan:
    """One simplified K1 launch.

    ``ext``/``si``/``so``/``zc``/``sc`` per index dim (strides in elements
    of ``elem_bytes``), the two mask bounds, and the word (``word_bytes``,
    the widest power of two dividing the element and both addresses).
    ``instance`` is the kernel that runs it:

    * ``"copy"``: no transpose (both sides contiguous along the same dim,
      or elements of at least ``_WIDE_ELEM`` bytes); a flat copy when
      ``ext == (1,)``, else a grid-stride walk over words;
    * ``"narrow"``: a 2-D transpose whose input-contiguous dim ``dI``
      (``flat_in``) or output-contiguous dim ``dO`` (``flat_out``) has
      ``C <= _NARROW_MAX`` elements of 4, 8 or 16 bytes and is dense with
      the long dim, unmasked, in whole 16-byte groups and 16-byte aligned:
      one warp per tile of ``C`` by ``_NARROW_GROUPS * 16 / elem_bytes``
      positions, one contiguous block on the interleaved side, ``C`` rows
      on the other;
    * ``"tiled"``: any other 2-D transpose, in ``TI x TO`` tiles whose
      rows are contiguous on each side.  With ``warp_tiles`` (full tiles,
      unmasked, 16-byte aligned, elements of 4, 8 or 16 bytes, or 2 to 7
      16-byte words) one warp moves each tile of ``128 / elem_bytes``
      squared elements (rows of one cache line), or 8 x 8 elements of 2
      to 7 words; otherwise CTAs walk the tiles (the whole tile one
      block on a side that is ``flat``) through a ring of tiles in shared
      memory, padded after every ``2**seg_shift`` bytes, a warp's store
      chunks interleaving ``lane_rows`` rows, so that its gathers spread
      over banks.

    A 2-D instance moves its tile in chunks of ``vec_in`` bytes on the
    input side and ``vec_out`` on the output side (16, or the word where a
    16-byte chunk would not be aligned)."""

    out_shape: Tuple[int, ...]
    ext: Tuple[int, ...]
    si: Tuple[int, ...]
    so: Tuple[int, ...]
    zc: Tuple[int, ...]
    zbound: int
    sc: Tuple[int, ...]
    sbound: int
    elem_bytes: int
    word_bytes: int
    instance: str = "copy"
    dI: int = -1
    dO: int = -1
    TI: int = 0
    TO: int = 0
    vec_in: int = 0
    vec_out: int = 0
    flat_in: bool = False
    flat_out: bool = False
    lane_rows: int = 1
    seg_shift: int = 7
    warp_tiles: bool = False

    @property
    def words_per_elem(self) -> int:
        return self.elem_bytes // self.word_bytes


def _pow2_dividing(n: int, cap: int = 16) -> int:
    w = cap
    while n % w:
        w //= 2
    return w


def _merge(desc):
    """Drop unit dims and unreachable masks, merge dims adjacent on both
    sides, and fold a run contiguous on both sides into the element."""
    out_shape, ext, si, so, zc, zbound, sc, sbound = desc
    # a mask no index reaches (e.g. no padding at all) is dropped, which
    # also lets its dims merge
    if sum((e - 1) * c for e, c in zip(ext, zc)) < zbound:
        zc, zbound = (0,) * len(ext), _NO_MASK
    if sum((e - 1) * c for e, c in zip(ext, sc)) < sbound:
        sc, sbound = (0,) * len(ext), _NO_MASK
    dims = [k for k in range(len(ext)) if ext[k] != 1]
    dims.sort(key=lambda k: -so[k])  # output-major walk
    merged = []
    for k in dims:
        cur = [ext[k], si[k], so[k], zc[k], sc[k]]
        if merged:
            e, a, b, c, d = merged[-1]
            n = cur[0]
            if (a == n * cur[1] and b == n * cur[2] and c == n * cur[3]
                    and d == n * cur[4]):
                merged[-1] = [e * n, cur[1], cur[2], cur[3], cur[4]]
                continue
        merged.append(cur)
    run = 1
    # fold a run contiguous on both sides (and unmasked) into the element:
    # all of it, or (a chunk's rows, whose strides it does not divide) the
    # largest part dividing every other stride, so the copy still moves
    # wide words
    if merged and merged[-1][1] == 1 and merged[-1][2] == 1 \
            and merged[-1][3] == 0 and merged[-1][4] == 0:
        n = merged[-1][0]
        rest = merged[:-1]
        r = n
        for m in rest:
            r = math.gcd(r, m[1], m[2])
        if r > 1:
            run = r
            merged = [[m[0], m[1] // r, m[2] // r, m[3], m[4]] for m in rest]
            if r < n:
                merged.append([n // r, 1, 1, 0, 0])
    if not merged:
        merged = [[1, 0, 0, 0, 0]]
    if len(merged) > _MAX_DIMS:
        raise ValueError(f"permute needs {len(merged)} index dims after "
                         f"merging; the kernel takes at most {_MAX_DIMS}")
    return merged, run, int(zbound), int(sbound)


def _tile_shape(eI: int, eO: int, E: int) -> Tuple[int, int]:
    """A tiled instance's tile: rows of up to 256 bytes along dI, about
    ``_TILE_BYTES`` in all; a short side leaves its room to the other.
    A side cut short of its extent keeps its rows 16-byte multiples."""
    m = 16 // _pow2_dividing(E)        # elements of a 16-byte multiple

    def cut(t, e):
        t = min(t, e, 1024)
        return t - t % m if t < e and t >= m else t

    line = 128 // math.gcd(E, 128)     # elements of a 128-byte multiple
    TI = max(1, min(128, 256 // E))
    if TI < line and line * E <= 1024:
        TI = line                      # whole cache lines per row
    TI = cut(TI, eI)
    TO = cut(max(1, min(256, _TILE_BYTES // (TI * E))), eO)
    if TI == eI:
        TO = cut(max(TO, _TILE_BYTES // (TI * E)), eO)
    elif TO == eO:
        TI = cut(max(TI, _TILE_BYTES // (TO * E)), eI)
    return TI, TO


def _run(T: int, other: int, E: int) -> int:
    """A flat tile's run along its long dim: about ``_TILE_BYTES`` per
    tile, a multiple of 32 positions."""
    return min(T, max(32, _TILE_BYTES // (other * E) // 32 * 32))


def _chunk(align: int, E: int, word: int, offsets) -> int:
    """16 when every offset (in elements) a side's chunks start from is a
    multiple of 16 bytes, else the word."""
    if align % 16 == 0 and all((o * E) % 16 == 0 for o in offsets):
        return 16
    return word


def _chunks(align, E, word, merged, outer, dI, dO, TI, TO, flat_in,
            flat_out):
    """(vec_in, vec_out) of a 2-D plan: where each side's chunks start are
    the other dims' offsets and the tile's rows (or, flat, the tile)
    along the contiguous dim."""
    siO, soI = merged[dO][1], merged[dI][2]
    vin = _chunk(align, E, word, [merged[k][1] for k in outer] + (
        [TO * siO] if flat_in else [siO, TI]))
    vout = _chunk(align, E, word, [merged[k][2] for k in outer] + (
        [TI * soI] if flat_out else [soI] + (
            [TO] if TO < merged[dO][0] else [])))
    return vin, vout


@functools.lru_cache(maxsize=256)
def plan_copy(desc, itemsize: int, align: int = 16) -> CopyPlan:
    """Simplify a raw description (from ``_describe_*``) into a launch and
    pick its instance — a deterministic function of the merged shape, the
    strides, the element size and ``align``, the largest power of two
    dividing both buffer addresses (the word size divides it).  Cached:
    a launch's host time is mostly this."""
    merged, run, zbound, sbound = _merge(desc)
    E = itemsize * run
    word = _pow2_dividing(E, _pow2_dividing(align))
    cols = list(zip(*merged))
    plan = dict(out_shape=tuple(desc[0]), ext=cols[0], si=cols[1],
                so=cols[2], zc=cols[3], zbound=zbound, sc=cols[4],
                sbound=sbound, elem_bytes=E, word_bytes=word)
    dO = next((k for k, m in enumerate(merged) if m[2] == 1), -1)
    dI = next((k for k, m in enumerate(merged) if m[1] == 1), -1)
    if dI < 0 or dO < 0 or dI == dO or E >= _WIDE_ELEM:
        return CopyPlan(instance="copy", vec_in=word, vec_out=word,
                        flat_in=plan["ext"] == (1,),
                        flat_out=plan["ext"] == (1,), **plan)
    eI, eO = merged[dI][0], merged[dO][0]
    flat_in = eI <= _NARROW_MAX and merged[dO][1] == eI
    flat_out = not flat_in and eO <= _NARROW_MAX and merged[dI][2] == eO
    outer = [k for k in range(len(merged)) if k not in (dI, dO)]
    P = 16 // E if E in (4, 8, 16) else 0     # positions a 16-byte group
    if (flat_in or flat_out) and P and (eO if flat_in else eI) % P == 0 \
            and zbound == sbound == _NO_MASK:
        # narrow: a warp's tile is _NARROW_GROUPS groups of P positions
        TI, TO = ((eI, _NARROW_GROUPS * P) if flat_in
                  else (_NARROW_GROUPS * P, eO))
        if _chunks(align, E, word, merged, outer, dI, dO, TI, TO, flat_in,
                   flat_out) == (16, 16):
            return CopyPlan(instance="narrow", dI=dI, dO=dO, TI=TI, TO=TO,
                            vec_in=16, vec_out=16, flat_in=flat_in,
                            flat_out=flat_out, **plan)
    # a warp tile's side: rows of 128 bytes, or 8 elements of 2 to 7
    # 16-byte words
    R = 128 // E if E in (4, 8, 16) else 8 if E % 16 == 0 else 0
    if (R and eI % R == 0 and eO % R == 0 and zbound == sbound == _NO_MASK
            and _chunks(align, E, word, merged, outer, dI, dO, R, R, False,
                        False) == (16, 16)):
        return CopyPlan(instance="tiled", dI=dI, dO=dO, TI=R, TO=R,
                        vec_in=16, vec_out=16, warp_tiles=True, **plan)
    if flat_in:
        TI, TO = eI, _run(eO, eI, E)
    elif flat_out:
        TI, TO = _run(eI, eO, E), eO
    else:
        TI, TO = _tile_shape(eI, eO, E)
    vin, vout = _chunks(align, E, word, merged, outer, dI, dO, TI, TO,
                        flat_in, flat_out)
    # store chunks of a warp interleave rows: all C of a flat-in tile, 16
    # of another, whose rows are padded every 256 bytes
    lane_rows = TI if flat_in else 1 if flat_out else min(16, TI)
    return CopyPlan(instance="tiled",
                    dI=dI, dO=dO, TI=TI, TO=TO, vec_in=vin,
                    vec_out=vout, flat_in=flat_in, flat_out=flat_out,
                    lane_rows=lane_rows,
                    seg_shift=7 if flat_in or flat_out else 8, **plan)


def _address_align(*tensors: torch.Tensor) -> int:
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _span(t: torch.Tensor) -> torch.Tensor:
    """The elements of ``t``'s storage from its first to its last
    element, as a 1-D view (a strided view's holes included)."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride())) \
        if t.numel() else -1
    return t.as_strided((last + 1,), (1,), t.storage_offset())


def emulate(plan: CopyPlan, x: torch.Tensor, dtype: torch.dtype,
            fill: int = 0xA5, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Execute ``plan`` on the CPU as its instance walks it, bytes in,
    bytes out: the copy instance element by element (one block when
    flat), a 2-D instance tile by tile, taking each tile's fast path (whole
    rows or, flat, the whole tile as one block, in chunks that must start
    on ``vec_in``/``vec_out`` boundaries) where its masks are uniform over
    the tile, else element by element.  The plan's strides count from
    ``x``'s first element (a view's storage offset and holes included),
    and from ``out``'s when one is given: the result is written into
    ``out``, holes keeping their bytes.  Without ``out``, output bytes the
    plan does not write keep ``fill``.  Any read or write outside the span
    of a buffer or off its chunk boundary raises, so a test comparing the
    result with the plain version checks that the plan covers every
    output element and stays inside both buffers."""
    eb = plan.elem_bytes
    src = _span(x).contiguous().view(torch.uint8).numpy()
    if out is None:
        n_out = int(np.prod(plan.out_shape)) * torch.empty(
            (), dtype=dtype).element_size()
        dst = np.full(n_out, fill, np.uint8)
    else:
        dst = _span(out).contiguous().view(torch.uint8).numpy().copy()
    if plan.instance == "copy":
        _emulate_copy(plan, src.reshape(-1, eb), dst.reshape(-1, eb))
    else:
        _emulate_tiles(plan, src, dst)
    if out is None:
        return torch.from_numpy(dst).view(dtype).reshape(plan.out_shape)
    _span(out).copy_(torch.from_numpy(dst).view(dtype))
    return out


def _emulate_copy(plan: CopyPlan, src: np.ndarray, dst: np.ndarray) -> None:
    if plan.flat_in:
        if src.shape[0] != 1 or dst.shape[0] != 1:
            raise IndexError("a flat copy moves one element")
        dst[:] = src
        return
    idx = np.indices(plan.ext, dtype=np.int64).reshape(len(plan.ext), -1)

    def lin(coefs):
        return sum(i * c for i, c in zip(idx, coefs))

    ioff, ooff = lin(plan.si), lin(plan.so)
    keep = lin(plan.sc) < plan.sbound
    have = lin(plan.zc) < plan.zbound
    if np.any(ooff[keep] < 0) or np.any(ooff[keep] >= dst.shape[0]):
        raise IndexError("plan writes outside the output")
    read = keep & have
    if np.any(ioff[read] < 0) or np.any(ioff[read] >= src.shape[0]):
        raise IndexError("plan reads outside the input")
    dst[ooff[keep & ~have]] = 0
    dst[ooff[read]] = src[ioff[read]]


def _chunk_span(buf: np.ndarray, start: int, length: int, chunk: int,
                what: str):
    if start % chunk or start < 0 or start + length > buf.size:
        raise IndexError(f"{what} [{start}, {start + length}) is outside "
                         f"the buffer or off a {chunk}-byte boundary")
    return slice(start, start + length)


def _emulate_tiles(plan: CopyPlan, src: np.ndarray, dst: np.ndarray) -> None:
    E, dI, dO, TI, TO = (plan.elem_bytes, plan.dI, plan.dO, plan.TI,
                         plan.TO)
    ext, si, so = plan.ext, plan.si, plan.so
    eI, eO = ext[dI], ext[dO]
    if plan.flat_in and (TI != eI or si[dO] != eI):
        raise ValueError("flat_in needs whole dense input rows")
    if plan.flat_out and (TO != eO or so[dI] != eO):
        raise ValueError("flat_out needs whole dense output rows")
    outer = [k for k in range(len(ext)) if k not in (dI, dO)]
    eb = np.arange(E)
    for idx in np.ndindex(*[ext[k] for k in outer]):
        base = [sum(i * c[k] for i, k in zip(idx, outer))
                for c in (si, so, plan.zc, plan.sc)]
        for i0 in range(0, eI, TI):
            for o0 in range(0, eO, TO):
                nI, nO = min(TI, eI - i0), min(TO, eO - o0)
                il = np.arange(nI)[None, :]
                ol = np.arange(nO)[:, None]

                def at(k, c):
                    return (base[k] + (i0 + il) * c[dI] + (o0 + ol) * c[dO]
                            ) * np.ones_like(il * ol)

                tile = np.zeros((nO, nI, E), np.uint8)      # [o][i]
                z = at(2, plan.zc)
                if z.max() < plan.zbound:                   # all present
                    ib = base[0] + i0 + o0 * si[dO]
                    if plan.flat_in:
                        tile[:] = src[_chunk_span(
                            src, ib * E, nO * nI * E, plan.vec_in,
                            "load")].reshape(nO, nI, E)
                    else:
                        if (TI * E) % plan.vec_in:
                            raise IndexError("tile rows off chunk boundary")
                        for o in range(nO):
                            tile[o] = src[_chunk_span(
                                src, (ib + o * si[dO]) * E, nI * E,
                                plan.vec_in, "load row")].reshape(nI, E)
                elif z.min() < plan.zbound:                 # some present
                    have = z < plan.zbound
                    off = at(0, si)[have] * E
                    _chunk_span(src, int(off.min(initial=0)), 0, 1,
                                "load")
                    _chunk_span(src, int(off.max(initial=0)) + E, 0, 1,
                                "load")
                    tile[have] = src[off[:, None] + eb]
                s = at(3, plan.sc)
                if s.min() >= plan.sbound:                  # none stored
                    continue
                ob = base[1] + o0 + i0 * so[dI]
                if s.max() < plan.sbound:                   # all stored
                    if plan.flat_out:
                        dst[_chunk_span(
                            dst, ob * E, nO * nI * E, plan.vec_out,
                            "store")] = tile.transpose(1, 0, 2).reshape(-1)
                    else:
                        for i in range(nI):
                            dst[_chunk_span(
                                dst, (ob + i * so[dI]) * E, nO * E,
                                plan.vec_out, "store row")] = \
                                tile[:, i].reshape(-1)
                else:
                    keep = s < plan.sbound
                    off = at(1, so)[keep] * E
                    _chunk_span(dst, int(off.min()), 0, 1, "store")
                    _chunk_span(dst, int(off.max()) + E, 0, 1, "store")
                    dst[off[:, None] + eb] = tile[keep]


_argtypes_set = False


def _lib():
    from . import _build

    global _argtypes_set
    lib = _build.load("permute")
    if not _argtypes_set:
        i64p = ctypes.POINTER(ctypes.c_int64)
        i = ctypes.c_int
        lib.pa_permute.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i, i, ctypes.c_int64, i, i64p,
            i64p, i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64, i, i, i,
            i, i, i, i, i, i, i, i, ctypes.c_void_p]
        lib.pa_permute.restype = ctypes.c_int
        _argtypes_set = True
    return lib


@functools.lru_cache(maxsize=256)
def _plan_args(plan: CopyPlan) -> tuple:
    """The C arguments of a plan after the two pointers (built once)."""
    K = len(plan.ext)

    def arr(vals):
        return (ctypes.c_int64 * K)(*vals)

    return (INSTANCES.index(plan.instance), plan.word_bytes,
            plan.words_per_elem, K, arr(plan.ext), arr(plan.si),
            arr(plan.so), arr(plan.zc), plan.zbound, arr(plan.sc),
            plan.sbound, plan.dI, plan.dO, plan.TI, plan.TO, plan.vec_in,
            plan.vec_out, int(plan.flat_in), int(plan.flat_out),
            plan.lane_rows, plan.seg_shift, int(plan.warp_tiles))


def _layout(x: torch.Tensor, out: Optional[torch.Tensor]):
    """``None`` for a contiguous input at the start of its storage into a
    fresh output; else the strides of both sides and where each starts
    within 256 bytes (what decides its alignment): a recorded class's
    views can then be made again (``chip_smoke.py``)."""
    if out is None and x.is_contiguous() and x.storage_offset() == 0:
        return None
    m = max(1, 256 // x.element_size())
    o = (None, None) if out is None else (tuple(out.stride()),
                                         out.storage_offset() % m)
    return (tuple(x.stride()), x.storage_offset() % m) + o


def _launch(desc, x: torch.Tensor, key: tuple,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    layout = _layout(x, out) if recorded is not None else None
    if out is None:
        out = torch.empty(desc[0], dtype=x.dtype, device=x.device)
    plan = plan_copy(desc, x.element_size(), _address_align(x, out))
    if out.numel() == 0:
        return out
    run_plan(plan, x, out)
    if recorded is not None:
        key = key + (str(x.dtype).split(".")[-1],)
        if layout is not None:
            key = key + (layout,)
        recorded[key] = recorded.get(key, 0) + 1
    return out


_count_lock = threading.Lock()


def run_plan(plan: CopyPlan, x: torch.Tensor, out: torch.Tensor) -> None:
    """Launch ``plan`` from ``x`` into ``out`` (CUDA tensors the plan was
    made for) and count it."""
    global launches, bytes_moved
    args = (ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            *_plan_args(plan),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    lib = _lib()
    if torch.cuda.current_device() == x.device.index:
        err = lib.pa_permute(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.pa_permute(*args)
    if err != 0:
        raise RuntimeError(f"permute kernel launch failed: CUDA error {err}")
    with _count_lock:   # the engine's consumer and host workers launch too
        launches += 1
        launches_by_instance[plan.instance] += 1
        bytes_moved += (x.numel() + out.numel()) * x.element_size()


def _check(x: torch.Tensor, out: Optional[torch.Tensor] = None,
           out_shape=None) -> str:
    """``"cpu"``, ``"cuda"``, or raise for anything the kernel refuses.
    ``x`` may be any view with non-negative strides; ``out``, a view to
    write into, must match ``out_shape``, ``x``'s dtype and device, and
    have positive strides."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if out is not None:
        if out.device != x.device or out.dtype != x.dtype:
            raise ValueError(f"permute: out is {out.dtype} on {out.device}, "
                             f"the input {x.dtype} on {x.device}")
        if tuple(out.shape) != tuple(out_shape):
            raise ValueError(f"permute: out has shape {tuple(out.shape)}, "
                             f"the result {tuple(out_shape)}")
        if any(st <= 0 for n, st in zip(out.shape, out.stride()) if n > 1):
            raise ValueError("permute: out needs positive strides")
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"permute: unsupported device {x.device}")
    if x.element_size() not in (1, 2, 4, 8, 16):
        raise TypeError(f"permute: unsupported dtype {x.dtype}")
    if any(st < 0 for st in x.stride()):
        raise ValueError("permute: the CUDA kernel takes no negative "
                         "strides")
    return "cuda"


def _plain_into(y: torch.Tensor, out: Optional[torch.Tensor]):
    if out is None:
        return y
    out.copy_(y)
    return out


def _strides(t: Optional[torch.Tensor]):
    return None if t is None else tuple(t.stride())


def _check_axes(x: torch.Tensor, axes: Sequence[int]) -> Tuple[int, ...]:
    axes = tuple(int(a) for a in axes)
    if sorted(axes) != list(range(x.dim())):
        raise ValueError(f"axes {axes} are not a permutation of "
                         f"{x.dim()} dims")
    return axes


def _wants_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


class _Permute(torch.autograd.Function):
    """K1's permute under autograd: forward one launch, backward one
    launch of the inverse permute on the cotangent (the JAX package's
    ``pallas_permute`` is differentiated by JAX as the transpose it
    computes)."""

    @staticmethod
    def forward(ctx, x, axes, desc):
        ctx.axes = axes
        return _launch(desc, x, ("permute", tuple(x.shape), axes))

    @staticmethod
    def backward(ctx, g):
        inv = tuple(ctx.axes.index(i) for i in range(len(ctx.axes)))
        return permute(g.contiguous(), inv), None, None


def _no_grad_out(what: str, x: torch.Tensor, out) -> None:
    if out is not None and _wants_grad(x):
        raise RuntimeError(
            f"K1 {what} into out= has no gradient: autograd cannot see a "
            f"write into a view; call it without out= or under "
            f"torch.no_grad()")


def permute(x: torch.Tensor, axes: Sequence[int],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x.permute(axes)`` materialized contiguously, or written into the
    view ``out``.  Differentiable: on the card, an input that requires
    grad (grad mode on) goes through :class:`_Permute`, whose backward
    is K1 again with the inverse axes; such a call with ``out=`` raises.
    """
    axes = _check_axes(x, axes)
    desc = _describe_permute(tuple(x.shape), axes, _strides(x),
                             _strides(out))
    if _check(x, out, desc[0]) == "cpu":
        return _plain_into(permute_plain(x, axes), out)
    if _wants_grad(x):
        _no_grad_out("permute", x, out)
        return _Permute.apply(x, axes, desc)
    return _launch(desc, x, ("permute", tuple(x.shape), axes), out)


def _no_grad_hop(what: str, x: torch.Tensor) -> None:
    if _wants_grad(x):
        raise RuntimeError(
            f"K1 {what} has no gradient of its own: differentiate through "
            f"the hop that runs it (parallel.transpositions._Hop)")


def pack(x: torch.Tensor, axes: Sequence[int], dim: int, P: int,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x.permute(axes)``, with dim ``dim`` zero-padded to ``P*ceil(n/P)``
    and split into ``P`` tiles laid out as a new leading dimension (a new
    contiguous tensor, or the view ``out``)."""
    axes = _check_axes(x, axes)
    if P < 1:
        raise ValueError(f"P must be positive, got {P}")
    desc = _describe_pack(tuple(x.shape), axes, dim, P, _strides(x),
                          _strides(out))
    if _check(x, out, desc[0]) == "cpu":
        return _plain_into(pack_plain(x, axes, dim, P), out)
    _no_grad_hop("pack", x)
    return _launch(desc, x, ("pack", tuple(x.shape), axes, dim, P), out)


def unpack(x: torch.Tensor, axes: Sequence[int], dim: int, n: int,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse layout of :func:`pack`: the ``P`` leading tiles concatenated
    along tile dim ``dim``, cut to ``n``, then permuted by ``axes`` (a new
    contiguous tensor, or the view ``out``)."""
    if x.dim() < 2:
        raise ValueError("unpack needs a leading tile dimension")
    axes = tuple(int(a) for a in axes)
    if sorted(axes) != list(range(x.dim() - 1)):
        raise ValueError(f"axes {axes} do not permute the tile dims")
    if not 0 <= n <= x.shape[0] * x.shape[dim + 1]:
        raise ValueError(f"n={n} exceeds the concatenated extent")
    desc = _describe_unpack(tuple(x.shape), axes, dim, n, _strides(x),
                            _strides(out))
    if _check(x, out, desc[0]) == "cpu":
        return _plain_into(unpack_plain(x, axes, dim, n), out)
    _no_grad_hop("unpack", x)
    return _launch(desc, x, ("unpack", tuple(x.shape), axes, dim, n), out)
