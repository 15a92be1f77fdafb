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

For a tensor on the CPU each function runs its plain PyTorch version
(``*_plain``: ``permute``/``cat``/``reshape``/``narrow``/``contiguous``);
for a CUDA tensor it launches the kernel or raises — there is no fallback.
Every launch adds one to :data:`launches`.

All three share one description of the copy (:class:`CopyPlan`): an index
space whose element ``I`` reads ``in[sum I_k si_k]`` and writes
``out[sum I_k so_k]``, with a zero-fill mask (pack's padding) and a skip
mask (unpack's dropped padding).  :func:`plan_copy` simplifies it — drops
unit dims, merges dims that stay adjacent on both sides, folds a run that
is contiguous on both sides into a wider element, and picks the word size
and tile — and :func:`emulate` executes a plan on the CPU, so the CPU
tests check every plan the card would run against the plain versions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "permute", "pack", "unpack",
    "permute_plain", "pack_plain", "unpack_plain",
    "CopyPlan", "plan_copy", "emulate",
]

launches = 0
"""Kernel launches since the last reset (``permute.launches = 0``)."""

_MAX_DIMS = 8          # PA_MAX_DIMS in csrc/permute.cu
_THREADS_TILE = 1024   # elements per tile (TI * TO)
_SMEM_LIMIT = 48 * 1024
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


def _describe_permute(shape, axes):
    ist = _contiguous_strides(shape)
    out_shape = tuple(shape[a] for a in axes)
    K = len(axes)
    return (out_shape, out_shape, tuple(ist[a] for a in axes),
            _contiguous_strides(out_shape), (0,) * K, _NO_MASK,
            (0,) * K, _NO_MASK)


def _describe_pack(shape, axes, dim, P):
    ist = _contiguous_strides(shape)
    tile = [shape[a] for a in axes]
    n = tile[dim]
    blk = -(-n // P)
    tile[dim] = blk
    out_shape = (P,) + tuple(tile)
    K = len(out_shape)
    si = (blk * ist[axes[dim]],) + tuple(ist[a] for a in axes)
    # input element exists iff j * blk + i_dim < n
    zc = (blk,) + tuple(1 if k == dim else 0 for k in range(K - 1))
    return (out_shape, out_shape, si, _contiguous_strides(out_shape), zc, n,
            (0,) * K, _NO_MASK)


def _describe_unpack(shape, axes, dim, n):
    P, tile = shape[0], list(shape[1:])
    blk = tile[dim]
    out_tile = list(tile)
    out_tile[dim] = n
    out_shape = tuple(out_tile[a] for a in axes)
    ost = _contiguous_strides(out_shape)
    pos = {a: i for i, a in enumerate(axes)}
    so_tile = tuple(ost[pos[k]] for k in range(len(tile)))
    K = len(shape)
    so = (blk * so_tile[dim],) + so_tile
    # output element exists iff s * blk + i_dim < n
    sc = (blk,) + tuple(1 if k == dim else 0 for k in range(K - 1))
    return (out_shape, tuple(shape), _contiguous_strides(shape), so,
            (0,) * K, _NO_MASK, sc, n)


@dataclass(frozen=True)
class CopyPlan:
    """One simplified K1 launch: ``ext``/``si``/``so``/``zc``/``sc`` per
    index dim (strides in elements of ``elem_bytes``), the two mask
    bounds, the word size, and the tile (``dI``/``dO`` = -1: straight
    grid-stride copy)."""

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
    dI: int = -1
    dO: int = -1
    TI: int = 0
    TO: int = 0

    @property
    def words_per_elem(self) -> int:
        return self.elem_bytes // self.word_bytes


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def plan_copy(desc, itemsize: int, align: int = 16) -> CopyPlan:
    """Simplify a raw description (from ``_describe_*``) into a launch.

    ``align`` is the largest power of two dividing both buffer addresses;
    the word size divides it."""
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
    elem = itemsize
    # fold a run contiguous on both sides (and unmasked) into the element
    if merged and merged[-1][1] == 1 and merged[-1][2] == 1 \
            and merged[-1][3] == 0 and merged[-1][4] == 0:
        run = merged[-1][0]
        rest = merged[:-1]
        if all(m[1] % run == 0 and m[2] % run == 0 for m in rest):
            elem = itemsize * run
            merged = [[m[0], m[1] // run, m[2] // run, m[3], m[4]]
                      for m in rest]
    if not merged:
        merged = [[1, 0, 0, 0, 0]]
    if len(merged) > _MAX_DIMS:
        raise ValueError(f"permute needs {len(merged)} index dims after "
                         f"merging; the kernel takes at most {_MAX_DIMS}")
    word = 16
    while elem % word or align % word:
        word //= 2
    cols = list(zip(*merged))
    plan = dict(out_shape=tuple(out_shape), ext=cols[0], si=cols[1],
                so=cols[2], zc=cols[3], zbound=int(zbound), sc=cols[4],
                sbound=int(sbound), elem_bytes=elem, word_bytes=word)
    dO = next((k for k, m in enumerate(merged) if m[2] == 1), -1)
    dI = next((k for k, m in enumerate(merged) if m[1] == 1), -1)
    if dI >= 0 and dO >= 0 and dI != dO:
        wn = elem // word
        TI = min(_pow2_at_least(merged[dI][0]), 256)
        TO = min(_pow2_at_least(merged[dO][0]), 256)
        while TI * TO > _THREADS_TILE or TO * (TI * wn + 1) * word > _SMEM_LIMIT:
            if TI >= TO and TI > 1:
                TI //= 2
            elif TO > 1:
                TO //= 2
            else:
                break
        if TO * (TI * wn + 1) * word <= _SMEM_LIMIT:
            plan.update(dI=dI, dO=dO, TI=TI, TO=TO)
    return CopyPlan(**plan)


def _address_align(*tensors: torch.Tensor) -> int:
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def emulate(plan: CopyPlan, x: torch.Tensor, dtype: torch.dtype,
            fill: int = 0xA5) -> torch.Tensor:
    """Execute ``plan`` on the CPU with NumPy index arithmetic, exactly as
    the kernel walks it (bytes in, bytes out).  Output bytes the plan does
    not write keep ``fill``, and any out-of-range offset raises, so a test
    comparing the result with the plain version checks that the plan
    covers every output element once and stays inside both buffers."""
    eb = plan.elem_bytes
    src = x.contiguous().reshape(-1).view(torch.uint8).numpy()
    src = src.reshape(-1, eb)
    n_out = int(np.prod(plan.out_shape)) * torch.empty(
        (), dtype=dtype).element_size() // eb
    dst = np.full((n_out, eb), fill, np.uint8)
    idx = np.indices(plan.ext, dtype=np.int64).reshape(len(plan.ext), -1)

    def lin(coefs):
        return sum(i * c for i, c in zip(idx, coefs))

    ioff, ooff = lin(plan.si), lin(plan.so)
    keep = lin(plan.sc) < plan.sbound
    have = lin(plan.zc) < plan.zbound
    if np.any(ooff[keep] < 0) or np.any(ooff[keep] >= n_out):
        raise IndexError("plan writes outside the output")
    read = keep & have
    if np.any(ioff[read] < 0) or np.any(ioff[read] >= src.shape[0]):
        raise IndexError("plan reads outside the input")
    dst[ooff[keep & ~have]] = 0
    dst[ooff[read]] = src[ioff[read]]
    out = torch.from_numpy(dst.reshape(-1))
    return out.view(dtype).reshape(plan.out_shape)


_argtypes_set = False


def _lib():
    from . import _build

    global _argtypes_set
    lib = _build.load("permute")
    if not _argtypes_set:
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pa_permute.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, i64p, i64p, i64p, i64p, ctypes.c_int64, i64p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.pa_permute.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def _launch(desc, x: torch.Tensor) -> torch.Tensor:
    global launches
    out = torch.empty(desc[0], dtype=x.dtype, device=x.device)
    plan = plan_copy(desc, x.element_size(), _address_align(x, out))
    if out.numel() == 0:
        return out
    lib = _lib()
    K = len(plan.ext)

    def arr(vals):
        return (ctypes.c_int64 * K)(*vals)

    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.pa_permute(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            plan.word_bytes, plan.words_per_elem, K, arr(plan.ext),
            arr(plan.si), arr(plan.so), arr(plan.zc), plan.zbound,
            arr(plan.sc), plan.sbound, plan.dI, plan.dO, plan.TI, plan.TO,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"permute kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _check(x: torch.Tensor) -> Optional[str]:
    """``"cpu"``, ``"cuda"``, or raise for anything the kernel refuses."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"permute: unsupported device {x.device}")
    if x.element_size() not in (1, 2, 4, 8, 16):
        raise TypeError(f"permute: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("permute: the CUDA kernel takes contiguous input")
    return "cuda"


def _check_axes(x: torch.Tensor, axes: Sequence[int]) -> Tuple[int, ...]:
    axes = tuple(int(a) for a in axes)
    if sorted(axes) != list(range(x.dim())):
        raise ValueError(f"axes {axes} are not a permutation of "
                         f"{x.dim()} dims")
    return axes


def permute(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """``x.permute(axes)`` materialized contiguously."""
    axes = _check_axes(x, axes)
    if _check(x) == "cpu":
        return permute_plain(x, axes)
    return _launch(_describe_permute(tuple(x.shape), axes), x)


def pack(x: torch.Tensor, axes: Sequence[int], dim: int,
         P: int) -> torch.Tensor:
    """``x.permute(axes)``, with dim ``dim`` zero-padded to ``P*ceil(n/P)``
    and split into ``P`` tiles laid out as a new leading dimension."""
    axes = _check_axes(x, axes)
    if P < 1:
        raise ValueError(f"P must be positive, got {P}")
    if _check(x) == "cpu":
        return pack_plain(x, axes, dim, P)
    return _launch(_describe_pack(tuple(x.shape), axes, dim, P), x)


def unpack(x: torch.Tensor, axes: Sequence[int], dim: int,
           n: int) -> torch.Tensor:
    """Inverse layout of :func:`pack`: the ``P`` leading tiles concatenated
    along tile dim ``dim``, cut to ``n``, then permuted by ``axes``."""
    if x.dim() < 2:
        raise ValueError("unpack needs a leading tile dimension")
    axes = tuple(int(a) for a in axes)
    if sorted(axes) != list(range(x.dim() - 1)):
        raise ValueError(f"axes {axes} do not permute the tile dims")
    if not 0 <= n <= x.shape[0] * x.shape[dim + 1]:
        raise ValueError(f"n={n} exceeds the concatenated extent")
    if _check(x) == "cpu":
        return unpack_plain(x, axes, dim, n)
    return _launch(_describe_unpack(tuple(x.shape), axes, dim, n), x)
