"""PencilArray — this rank's block of a distributed array.

PyTorch counterpart of the JAX package's ``parallel/arrays.py`` (reference
``src/arrays.jl``).  The JAX package wraps one global sharded ``jax.Array``;
the port runs one process per device, as the Julia reference does, so a
:class:`PencilArray` holds this rank's local tensor plus its pencil.

Storage contract (checked at construction):

``data.shape == pencil.padded_size_local(MemoryOrder) + extra_dims``

i.e. the local block in *memory order*, every decomposed dim at its padded
(ceil-block) extent, plus trailing *extra dims* — component axes that are
never permuted nor decomposed (``arrays.jl:34-47``).  Tail padding is
zero-filled by constructors; reductions mask it and transposes slice it
off, exactly as in the JAX package, so each rank's tensor is bit-identical
to the JAX shard of the same pencil.

Arithmetic runs on the local tensors.  Raw (non-PencilArray) operands are
interpreted against the LOGICAL global shape with right-aligned
broadcasting, like the JAX package's ``_align_to_parent``: this rank's
slice of each non-singleton dim is taken, zero-padded to the padded
extent and permuted into memory order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.permutations import NO_PERMUTATION
from .pencil import IndexOrder, LogicalOrder, MemoryOrder, Pencil

__all__ = ["PencilArray", "as_torch_dtype", "numpy_to_torch"]


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, NumPy dtype or type, or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bfloat16":
        return torch.bfloat16
    try:
        return getattr(torch, np.dtype(name).name)
    except (TypeError, AttributeError):
        raise TypeError(f"no torch dtype for {dtype!r}") from None


def numpy_to_torch(a) -> torch.Tensor:
    """A fresh CPU tensor holding the values of ``a`` (NumPy array, torch
    tensor or nested sequence).  NumPy ``bfloat16`` (``ml_dtypes``) moves
    through its 16-bit pattern, since torch cannot read it directly."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16), copy=True, order="C")
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _fwd_axes(pencil: Pencil, extra_ndims: int) -> Tuple[int, ...]:
    """Axes converting logical -> memory order: ``x.permute(axes)`` has
    shape ``perm.apply(x.shape)`` (extra dims ride along)."""
    perm = pencil.permutation
    if perm is NO_PERMUTATION or perm.is_identity():
        return tuple(range(pencil.ndims + extra_ndims))
    return perm.append(extra_ndims).axes()


def _inv_axes(pencil: Pencil, extra_ndims: int) -> Tuple[int, ...]:
    """Axes converting memory order -> logical order (extra dims kept)."""
    perm = pencil.permutation
    if perm is NO_PERMUTATION or perm.is_identity():
        return tuple(range(pencil.ndims + extra_ndims))
    return perm.inverse().append(extra_ndims).axes()


class PencilArray:
    """This rank's block of an N-dim array over a :class:`Pencil`."""

    __slots__ = ("_pencil", "_data", "_extra_dims")

    def __init__(self, pencil: Pencil, data: torch.Tensor,
                 extra_dims: Optional[Tuple[int, ...]] = None):
        expected_space = pencil.padded_size_local(MemoryOrder)
        if extra_dims is None:
            extra_dims = tuple(int(d) for d in data.shape[len(expected_space):])
        extra_dims = tuple(int(d) for d in extra_dims)
        expected = expected_space + extra_dims
        if tuple(data.shape) != expected:
            raise ValueError(
                f"data shape {tuple(data.shape)} does not match pencil's "
                f"padded local memory-order shape {expected_space} + extra "
                f"dims {extra_dims} (= {expected})")
        self._pencil = pencil
        self._data = data
        self._extra_dims = extra_dims

    # -- constructors -----------------------------------------------------
    @classmethod
    def zeros(cls, pencil: Pencil, extra_dims: Tuple[int, ...] = (),
              dtype=torch.float32) -> "PencilArray":
        shape = pencil.padded_size_local(MemoryOrder) + tuple(extra_dims)
        data = torch.zeros(shape, dtype=as_torch_dtype(dtype),
                           device=pencil.topology.device)
        return cls(pencil, data, tuple(extra_dims))

    @classmethod
    def from_global(cls, pencil: Pencil, array,
                    extra_ndims: Optional[int] = None) -> "PencilArray":
        """Build this rank's block from a true-shape, *logical-order*
        global array (NumPy or torch) held by every rank."""
        arr = numpy_to_torch(array)
        N = pencil.ndims
        if extra_ndims is None:
            extra_ndims = arr.dim() - N
        if extra_ndims != arr.dim() - N or extra_ndims < 0:
            raise ValueError(
                f"extra_ndims={extra_ndims} inconsistent with array rank "
                f"{arr.dim()} and pencil rank {N}")
        if tuple(arr.shape[:N]) != pencil.size_global(LogicalOrder):
            raise ValueError(
                f"array spatial shape {tuple(arr.shape[:N])} != pencil "
                f"global shape {pencil.size_global(LogicalOrder)}")
        extra_dims = tuple(arr.shape[N:])
        block = arr[tuple(slice(r.start, r.stop)
                          for r in pencil.range_local())]
        block = _pad_to(block, pencil.padded_size_local(LogicalOrder))
        block = block.permute(_fwd_axes(pencil, extra_ndims)).contiguous()
        return cls(pencil, block.to(pencil.topology.device), extra_dims)

    # -- accessors --------------------------------------------------------
    @property
    def pencil(self) -> Pencil:
        return self._pencil

    @property
    def data(self) -> torch.Tensor:
        """This rank's memory-order padded block (reference ``parent``)."""
        return self._data

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def extra_dims(self) -> Tuple[int, ...]:
        return self._extra_dims

    @property
    def ndims_extra(self) -> int:
        return len(self._extra_dims)

    @property
    def ndims_space(self) -> int:
        return self._pencil.ndims

    @property
    def ndim(self) -> int:
        return self._pencil.ndims + len(self._extra_dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        """True global logical shape + extra dims (as in the JAX package)."""
        return self.size_global()

    def size_global(self, order: IndexOrder = LogicalOrder) -> Tuple[int, ...]:
        return self._pencil.size_global(order) + self._extra_dims

    def size_local(self, coords=None, order: IndexOrder = LogicalOrder):
        return self._pencil.size_local(coords, order) + self._extra_dims

    def range_local(self, coords=None, order: IndexOrder = LogicalOrder):
        return self._pencil.range_local(coords, order) + tuple(
            range(0, d) for d in self._extra_dims)

    def length_global(self) -> int:
        return math.prod(self.size_global())

    # -- extra-dims components -------------------------------------------
    def component(self, *idx: int) -> "PencilArray":
        """The spatial field at extra-dims index ``idx`` (a strided view)."""
        if len(idx) != len(self._extra_dims):
            raise ValueError(
                f"component expects {len(self._extra_dims)} indices, got "
                f"{len(idx)}")
        data = self._data[(Ellipsis,) + tuple(int(i) for i in idx)]
        return PencilArray(self._pencil, data, ())

    @classmethod
    def stack(cls, components: Sequence["PencilArray"]) -> "PencilArray":
        """Stack same-pencil arrays along a NEW trailing extra dim."""
        first = components[0]
        for c in components[1:]:
            if c._pencil != first._pencil or c._extra_dims != first._extra_dims:
                raise ValueError("stack: pencil/extra_dims mismatch")
        data = torch.stack([c._data for c in components], dim=-1)
        return cls(first._pencil, data, first._extra_dims + (len(components),))

    # -- arithmetic (memory order, on the local blocks) -------------------
    def align(self, arr) -> torch.Tensor:
        """A raw operand broadcastable against the LOGICAL global shape,
        as this rank's memory-order, zero-padded local operand (the JAX
        package's ``_align_to_parent``, per rank)."""
        arr = numpy_to_torch(arr).to(self._data.device)
        pen = self._pencil
        N = pen.ndims
        logical = pen.size_global(LogicalOrder) + self._extra_dims
        if arr.dim() > len(logical):
            raise ValueError(
                f"operand rank {arr.dim()} exceeds array rank {len(logical)}")
        shape = (1,) * (len(logical) - arr.dim()) + tuple(arr.shape)
        for s, n in zip(shape, logical):
            if s not in (1, n):
                raise ValueError(
                    f"operand shape {tuple(arr.shape)} not broadcastable to "
                    f"logical shape {logical}")
        arr = arr.reshape(shape)
        ranges = pen.range_local()
        padded = pen.padded_size_local(LogicalOrder)
        target = []
        for d in range(N):
            if shape[d] != 1:
                arr = arr.narrow(d, ranges[d].start, len(ranges[d]))
                target.append(padded[d])
            else:
                target.append(1)
        arr = _pad_to(arr, tuple(target))
        return arr.permute(_fwd_axes(pen, len(self._extra_dims)))

    @staticmethod
    def _is_scalar(x) -> bool:
        return isinstance(x, (int, float, complex, bool, np.generic)) or (
            isinstance(x, torch.Tensor) and x.dim() == 0)

    def _binop(self, other, op):
        if isinstance(other, PencilArray):
            if other._pencil != self._pencil:
                raise ValueError("operands live on different pencils; "
                                 "transpose first")
            if other._extra_dims != self._extra_dims:
                raise ValueError(f"extra_dims mismatch: {self._extra_dims} "
                                 f"vs {other._extra_dims}")
            return PencilArray(self._pencil, op(self._data, other._data),
                               self._extra_dims)
        if self._is_scalar(other):
            return PencilArray(self._pencil, op(self._data, other),
                               self._extra_dims)
        if isinstance(other, (torch.Tensor, np.ndarray, list, tuple)):
            return PencilArray(self._pencil, op(self._data, self.align(other)),
                               self._extra_dims)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a**b)

    def __neg__(self):
        return PencilArray(self._pencil, -self._data, self._extra_dims)

    def __abs__(self):
        return PencilArray(self._pencil, self._data.abs(), self._extra_dims)

    def astype(self, dtype) -> "PencilArray":
        return PencilArray(self._pencil,
                           self._data.to(as_torch_dtype(dtype)),
                           self._extra_dims)

    def __repr__(self) -> str:
        return (f"PencilArray(shape={self.shape}, dtype={self.dtype}, "
                f"pencil={self._pencil!r}, extra_dims={self._extra_dims})")


def _pad_to(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the leading ``len(shape)`` dims of ``x`` at their tails."""
    if tuple(x.shape[:len(shape)]) == tuple(shape):
        return x
    out = x.new_zeros(tuple(shape) + tuple(x.shape[len(shape):]))
    out[tuple(slice(0, n) for n in x.shape[:len(shape)])] = x
    return out
