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

Global views are collectives.  The JAX package's wrapper IS the global
array, so ``x[i, j, k]``, :meth:`PencilArray.logical`, ``np.asarray(x)``
and :meth:`PencilArray.local_block` of any block read it directly.  Here
each rank holds one block, so those calls return the same global answer
on every rank by communicating: every rank of the topology must call
them, with the same arguments.  Indexing writes the elements a rank owns
into a zero buffer and sums the buffers' bytes over the ranks (each
element has exactly one owner, so the sum is the owner's bits);
``local_block(coords)`` broadcasts the block from its owner.  Reductions
(``np.sum(x)``, ``ops.reductions``) and ``equals``/``allclose`` all-reduce
a local result.  Elementwise arithmetic and ``np.<ufunc>(x)`` never
communicate.

The JAX-only hooks have no counterpart: ``tree_flatten``/
``tree_unflatten`` (pytrees), ``__jax_array__`` and its unwrap policy,
and ``sharding``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.permutations import NO_PERMUTATION
from . import collectives as _collectives
from .pencil import IndexOrder, LogicalOrder, MemoryOrder, Pencil

__all__ = ["PencilArray", "as_torch_dtype", "global_view", "numpy_to_torch"]


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
    def full(cls, pencil: Pencil, fill_value, extra_dims: Tuple[int, ...] = (),
             dtype=None) -> "PencilArray":
        """Every element ``fill_value``, tail padding included (as the JAX
        package fills it; reductions mask it)."""
        shape = pencil.padded_size_local(MemoryOrder) + tuple(extra_dims)
        data = torch.full(shape, fill_value,
                          dtype=None if dtype is None else as_torch_dtype(dtype),
                          device=pencil.topology.device)
        return cls(pencil, data, tuple(extra_dims))

    def similar(self, pencil: Optional[Pencil] = None, dtype=None,
                extra_dims: Optional[Tuple[int, ...]] = None) -> "PencilArray":
        """A zero array, possibly over another pencil, dtype or extra dims
        (the cross-pencil ``similar`` of ``arrays.jl:287-303``)."""
        return PencilArray.zeros(
            self._pencil if pencil is None else pencil,
            self._extra_dims if extra_dims is None else tuple(extra_dims),
            self._data.dtype if dtype is None else dtype)

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
        if self._data is None:
            raise RuntimeError("this array's storage was donated to a "
                               "transpose (ManyPencilArray donate=True)")
        return self._data

    def is_deleted(self) -> bool:
        """Whether the storage was donated (the analog of a deleted
        ``jax.Array`` after buffer donation)."""
        return self._data is None

    def _donate(self) -> None:
        self._data = None

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

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 0

    def sizeof_global(self) -> int:
        """Total global size in bytes, padding excluded (reference
        ``sizeof_global``, ``arrays.jl:428``)."""
        return self.length_global() * self._data.element_size()

    # -- global views (collectives: every rank calls them) ----------------
    def _reduce_group(self):
        """The topology's process group when a view must communicate."""
        topo = self._pencil.topology
        return topo.group if topo.connected and len(topo) > 1 else None

    def _normalize_index(self, key) -> Tuple:
        """Each axis's key as an int or a ``range`` of global indices,
        resolved against the TRUE sizes (padding is never addressed)."""
        nd = self.ndim
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            n_missing = nd - (len(key) - 1)
            out = []
            for k in key:
                out.extend([slice(None)] * n_missing if k is Ellipsis
                           else [k])
            key = tuple(out)
        if len(key) < nd:
            key = key + (slice(None),) * (nd - len(key))
        if len(key) != nd:
            raise IndexError(f"too many indices ({len(key)}) for rank {nd}")
        resolved = []
        for k, n in zip(key, self.size_global()):
            if isinstance(k, slice):
                resolved.append(range(*k.indices(n)))
            elif isinstance(k, (int, np.integer)):
                kk = int(k)
                if kk < -n or kk >= n:
                    raise IndexError(f"index {kk} out of bounds for size {n}")
                resolved.append(kk % n)
            else:
                raise NotImplementedError(
                    "PencilArray indexing supports int/slice/Ellipsis only; "
                    "for fancy indexing use .logical()")
        return tuple(resolved)

    def __getitem__(self, key) -> torch.Tensor:
        """Global *logical* basic indexing, as the JAX package's wrapper
        indexes (the reference's ``getindex`` takes local indices,
        ``arrays.jl:327-337``).  A collective: every rank calls it with
        the same key and gets the same tensor.  Each rank writes the
        elements it owns into a zero buffer of the result's shape; one
        all-reduce of the bytes (a SUM where every element has exactly one
        owner) gives every rank the owners' bits."""
        key = self._normalize_index(key)
        pen = self._pencil
        local = self._data.permute(_inv_axes(pen, len(self._extra_dims)))
        owned = self.range_local()
        shape, pos, loc = [], [], []
        for k, r in zip(key, owned):
            sel = np.asarray([k] if isinstance(k, int) else k, dtype=np.int64)
            mine = (sel >= r.start) & (sel < r.stop)
            shape.append(len(sel))
            pos.append(torch.from_numpy(np.nonzero(mine)[0]))
            loc.append(torch.from_numpy(sel[mine] - r.start))
        out = torch.zeros(shape, dtype=self._data.dtype,
                          device=self._data.device)
        if all(len(p) for p in pos):
            sub = local
            for d, idx in enumerate(loc):
                sub = sub.index_select(d, idx.to(sub.device))
            nd = len(pos)
            out[tuple(p.to(out.device).reshape(
                [-1 if i == d else 1 for i in range(nd)])
                for d, p in enumerate(pos))] = sub
        group = self._reduce_group()
        if group is not None and out.numel():
            dist.all_reduce(out.reshape(-1).view(torch.uint8),
                            op=dist.ReduceOp.SUM, group=group)
            _collectives.note("all-reduce", out.numel() * out.element_size(),
                              group=group, shape=out.shape, dtype=out.dtype)
        return out.reshape([n for n, k in zip(shape, key)
                            if not isinstance(k, int)])

    def logical(self) -> torch.Tensor:
        """The true-shape global array in logical order, on every rank (a
        collective; one rank returns its block without communicating)."""
        if self._reduce_group() is None:
            local = self._data.permute(_inv_axes(self._pencil,
                                                 len(self._extra_dims)))
            return local[tuple(slice(0, n) for n in self.size_global())]
        return self[(slice(None),) * self.ndim]

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """The global logical array as NumPy on every rank (a collective;
        ``bfloat16`` comes back as ``float32``)."""
        t = self.logical().detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def local_block(self, coords=None,
                    order: IndexOrder = LogicalOrder) -> torch.Tensor:
        """The true-size block of topology ``coords`` (default: this
        rank's own, the reference's local array, with no communication).
        With ``coords`` it is a collective: every rank calls it with the
        same coords, and the owner broadcasts its block."""
        pen = self._pencil
        topo = pen.topology
        nx = len(self._extra_dims)
        true = pen.size_local(coords, MemoryOrder) + self._extra_dims
        group = self._reduce_group()
        owner = (topo.rank_local if coords is None
                 else topo.rank(tuple(coords)))
        if coords is None or group is None or owner == topo.rank_local:
            if owner != topo.rank_local:
                raise ValueError(f"coords {tuple(coords)} name no block of "
                                 f"this one-rank topology")
            block = self._data[tuple(slice(0, n) for n in true)]
            if coords is not None and group is not None:
                buf = block.contiguous()
                if buf.numel():
                    dist.broadcast(buf.reshape(-1).view(torch.uint8),
                                   src=topo.global_rank(owner), group=group)
                block = buf
        else:
            block = torch.empty(true, dtype=self._data.dtype,
                                device=self._data.device)
            if block.numel():
                dist.broadcast(block.reshape(-1).view(torch.uint8),
                               src=topo.global_rank(owner), group=group)
        if order is LogicalOrder:
            block = block.permute(_inv_axes(pen, nx))
        return block

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

    def unstack(self) -> Tuple["PencilArray", ...]:
        """Split the trailing extra dim into a tuple of components (the
        inverse of :meth:`stack`; strided views)."""
        if not self._extra_dims:
            raise ValueError("unstack: array has no extra dims")
        return tuple(PencilArray(self._pencil, self._data[..., i],
                                 self._extra_dims[:-1])
                     for i in range(self._extra_dims[-1]))

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

    def map(self, f, *others: "PencilArray") -> "PencilArray":
        """Elementwise ``f`` over the memory-order blocks (the analog of
        the reference's broadcasting on parents, ``broadcast.jl:31-57``)."""
        for o in others:
            if o._pencil != self._pencil:
                raise ValueError("pencil mismatch in map")
        return PencilArray(self._pencil,
                           f(self._data, *(o._data for o in others)),
                           self._extra_dims)

    def _like(self, data: torch.Tensor) -> "PencilArray":
        return PencilArray(self._pencil, data, self._extra_dims)

    @property
    def real(self) -> "PencilArray":
        return self._like(self._data.real)

    @property
    def imag(self) -> "PencilArray":
        return self._like(self._data.imag if self._data.is_complex()
                          else torch.zeros_like(self._data))

    def conj(self) -> "PencilArray":
        return self._like(torch.conj_physical(self._data))

    def copy(self) -> "PencilArray":
        return self._like(self._data.clone())

    def fill(self, value) -> "PencilArray":
        """A copy with every element ``value``, padding included (reference
        ``fill!``, ``arrays.jl:494-526``)."""
        return self._like(torch.full_like(self._data, value))

    # -- NumPy protocols (reference broadcast.jl:15-89) -------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """``np.cos(x)``, ``np.add(raw, x)``: elementwise single-output
        ufuncs run the torch function of the same name on the memory-order
        blocks (raw operands aligned as in :meth:`align`) and return a
        PencilArray; no communication."""
        if method != "__call__" or kwargs.pop("out", None) is not None \
                or kwargs:
            return NotImplemented
        if getattr(ufunc, "signature", None) is not None or ufunc.nout != 1:
            # a gufunc (np.matmul) would contract over a MEMORY axis,
            # padding included; nout > 1 (np.modf) has no single result
            return NotImplemented
        f = torch_elementwise(ufunc.__name__)
        if f is None:
            return NotImplemented
        args = []
        for x in inputs:
            if isinstance(x, PencilArray):
                if x._pencil != self._pencil or \
                        x._extra_dims != self._extra_dims:
                    raise ValueError("operands live on different pencils; "
                                     "transpose first")
                args.append(x._data)
            elif self._is_scalar(x):
                args.append(torch.as_tensor(x, device=self._data.device))
            elif isinstance(x, (np.ndarray, torch.Tensor, list, tuple)):
                args.append(self.align(x))
            else:
                return NotImplemented
        return self._like(f(*args))

    def __array_function__(self, func, types, args, kwargs):
        """``np.sum(x)`` and the other whitelisted NumPy reductions forward
        to the padding-masked global reductions of ``ops.reductions``."""
        from ..ops import reductions

        table = {np.sum: reductions.sum, np.prod: reductions.prod,
                 np.mean: reductions.mean, np.min: reductions.minimum,
                 np.max: reductions.maximum, np.all: reductions.all,
                 np.any: reductions.any,
                 np.count_nonzero: reductions.count_nonzero}
        f = table.get(func)
        if (f is None or kwargs or len(args) != 1
                or not isinstance(args[0], PencilArray)):
            return NotImplemented
        return f(args[0])

    # -- comparison -------------------------------------------------------
    def _true_block(self) -> torch.Tensor:
        return self._data[tuple(
            slice(0, n) for n in self._pencil.size_local(order=MemoryOrder))]

    def _all_ranks(self, flag: bool) -> torch.Tensor:
        """``flag`` and-ed over the ranks, as a 0-dim bool tensor."""
        t = torch.tensor(int(flag), dtype=torch.uint8,
                         device=self._data.device)
        group = self._reduce_group()
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            _collectives.note("all-reduce", t.element_size(), group=group,
                              shape=t.shape, dtype=t.dtype)
        return t.bool()

    def equals(self, other: "PencilArray") -> torch.Tensor:
        """Whether the logical (true-shape) values are equal everywhere, as
        a 0-dim bool tensor on every rank (a collective).  Tail padding is
        storage detail and may differ."""
        if not isinstance(other, PencilArray):
            raise TypeError(f"equals() expects a PencilArray, got "
                            f"{type(other).__name__}")
        same = (self._pencil == other._pencil
                and self._extra_dims == other._extra_dims)
        if not same:
            return torch.tensor(False, device=self._data.device)
        return self._all_ranks(torch.equal(self._true_block(),
                                           other._true_block()))

    def __eq__(self, other):
        if isinstance(other, PencilArray):
            return bool(self.equals(other))
        return NotImplemented

    __hash__ = None

    def allclose(self, other: "PencilArray", **kw) -> bool:
        """``torch.allclose`` of the logical values on every rank (a
        collective)."""
        if self._pencil != other._pencil:
            raise ValueError("pencil mismatch")
        return bool(self._all_ranks(torch.allclose(
            self._true_block(), other._true_block(), **kw)))

    def __repr__(self) -> str:
        return (f"PencilArray(shape={self.shape}, dtype={self.dtype}, "
                f"pencil={self._pencil!r}, extra_dims={self._extra_dims})")


def global_view(x: PencilArray) -> PencilArray:
    """Reference ``global_view`` (``global_view.jl``): an object indexed
    by global indices.  ``PencilArray`` indexing is already global (and
    collective), so this is the identity."""
    return x


# NumPy elementwise names whose torch function has another name, or whose
# torch namesake means something else (torch.equal compares whole tensors)
_TORCH_ALIASES = {
    "equal": torch.eq, "not_equal": torch.ne, "power": torch.pow,
    "conjugate": torch.conj_physical, "conj": torch.conj_physical,
    "invert": torch.bitwise_not, "degrees": torch.rad2deg,
    "radians": torch.deg2rad, "rint": torch.round, "fabs": torch.abs,
    "mod": torch.remainder, "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
}


def torch_elementwise(name: str):
    """The torch function computing NumPy's elementwise ufunc ``name``
    (None if torch has none)."""
    return _TORCH_ALIASES.get(name) or getattr(torch, name, None)


def _pad_to(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the leading ``len(shape)`` dims of ``x`` at their tails."""
    if tuple(x.shape[:len(shape)]) == tuple(shape):
        return x
    out = x.new_zeros(tuple(shape) + tuple(x.shape[len(shape):]))
    out[tuple(slice(0, n) for n in x.shape[:len(shape)])] = x
    return out
