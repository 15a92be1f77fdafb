"""Global transpose between pencil configurations — the hot path.

PyTorch counterpart of the JAX package's ``parallel/transpositions.py``
(reference ``src/Transpositions/Transpositions.jl``).  One hop changes the
decomposition in at most one slot ``R`` (``assert_compatible``):

* ``R is None`` — only the memory order changes: one local permute
  (kernel K1, :func:`~pencilarrays_tpu_torch.ops.permute.permute`);
* otherwise :class:`AllToAll`: **pack** (K1: input memory order -> the
  ``P`` tiles of dim ``b`` in the output's memory order, tail-padded with
  zeros) -> ``all_to_all_single`` on the sub-group of topology axis ``R``
  -> **unpack** (K1: concatenate the tiles along dim ``a``, cut its tail
  padding).  The JAX package lets ``lax.all_to_all(split_axis=b,
  concat_axis=a)`` absorb both permutes; NCCL only splits a contiguous
  leading dimension, so here they are two real memory passes.

The pack lays each tile out in the OUTPUT pencil's memory order, so unpack
only moves the tile axis next to dim ``a`` — a straight copy whenever ``a``
leads the output's memory order.  A hop on a size-1 topology axis still
runs pack -> exchange -> unpack, as the JAX package does.

A hop is differentiable: for a tensor that requires grad, :func:`transpose`
runs inside a ``torch.autograd.Function`` whose backward is the inverse hop
back to the source pencil.  Unpack drops padding where pack zero-fills it,
so the inverse hop is the exact adjoint.  :func:`ring_shift` is the
``lax.ppermute`` ring step of the sequence-parallel attention schedules.

Ring/PointToPoint, Pipelined, Auto, Gspmd, ``reshard`` and reduced-
precision wire formats are not ported yet: they raise ``NotImplementedError``
naming the ROADMAP item that queues them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import permute as k1
from .arrays import PencilArray, _fwd_axes, _inv_axes
from .pencil import Pencil
from .topology import Topology

__all__ = [
    "AllToAll",
    "Alltoallv",
    "Auto",
    "Gspmd",
    "Pipelined",
    "PointToPoint",
    "Ring",
    "Transposition",
    "assert_compatible",
    "hop_operand_bytes",
    "reshard",
    "ring_shift",
    "transpose",
    "transpose_cost",
]

_LATER = ("not ported yet: ROADMAP.md Queue 1, item 'Transpose methods and "
          "plan options beyond the first slice'")


class AbstractTransposeMethod:
    pass


@dataclass(frozen=True)
class AllToAll(AbstractTransposeMethod):
    """Pack -> ``all_to_all_single`` on one topology axis -> unpack.
    ``wire_dtype`` (reduced-precision payloads) is not ported yet."""

    wire_dtype: Optional[str] = None

    def __post_init__(self):
        if self.wire_dtype is not None:
            raise NotImplementedError(f"AllToAll(wire_dtype=...) is {_LATER}")


Alltoallv = AllToAll


def _not_ported(name):
    def factory(*args, **kwargs):
        raise NotImplementedError(f"{name} is {_LATER}")

    factory.__name__ = name
    factory.__doc__ = f"The JAX package's ``{name}`` method ({_LATER})."
    return factory


Ring = _not_ported("Ring")
PointToPoint = Ring
Pipelined = _not_ported("Pipelined")
Auto = _not_ported("Auto")
Gspmd = _not_ported("Gspmd")


def reshard(*args, **kwargs):
    """Unrestricted redistribution (the JAX package's route planner)."""
    raise NotImplementedError(f"reshard is {_LATER}")


def assert_compatible(pin: Pencil, pout: Pencil) -> Optional[int]:
    """Check transposability and return the differing decomposition slot
    ``R`` (or ``None`` if decompositions are identical) — same topology,
    same global size, decompositions differing in at most one slot
    (``Transpositions.jl:182-199``)."""
    if pin.topology != pout.topology:
        raise ValueError("transpose: pencil topologies differ")
    if pin.size_global() != pout.size_global():
        raise ValueError(
            f"transpose: global shapes differ "
            f"({pin.size_global()} vs {pout.size_global()})")
    diff = [i for i, (a, b) in enumerate(zip(pin.decomposition,
                                             pout.decomposition)) if a != b]
    if len(diff) > 1:
        raise ValueError(
            f"transpose: decompositions {pin.decomposition} -> "
            f"{pout.decomposition} differ in more than one slot; chain "
            f"transposes (x->y->z)")
    return diff[0] if diff else None


def _itemsize(dtype) -> int:
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _exchange_operand_extents(pin: Pencil, pout: Pencil, R: int
                              ) -> Tuple[int, ...]:
    """Logical extents of the exchanged operand: the local block with
    the to-be-split dim ``b`` padded to its post-exchange padded extent
    (the JAX package's definition, shared with its cost model)."""
    b = pout.decomposition[R]
    ext = []
    for i in range(pin.ndims):
        if i == b:
            ext.append(pout.padded_global_shape[b])
        elif i in pin.decomposition:
            j = pin.decomposition.index(i)
            ext.append(pin.padded_global_shape[i] // pin.topology.dims[j])
        else:
            ext.append(pin.size_global()[i])
    return tuple(ext)


def hop_operand_bytes(pin: Pencil, pout: Pencil,
                      extra_dims: Tuple[int, ...] = (), dtype=None) -> int:
    """Bytes of the operand one exchange hop moves per rank (0 for a local
    permute).  :func:`transpose_cost` prices exactly this operand, and
    prices nothing on a size-1 axis, where nothing crosses a link."""
    R = assert_compatible(pin, pout)
    if R is None:
        return 0
    shape = _exchange_operand_extents(pin, pout, R) + tuple(extra_dims)
    return math.prod(shape) * _itemsize(dtype)


def transpose_cost(pin: Pencil, pout: Pencil, extra_dims: Tuple[int, ...] = (),
                   dtype=None, method=AllToAll()) -> dict:
    """Predicted per-rank collective cost of one hop in the JAX package's
    ``{op: {"count", "bytes"}}`` schema (``AllToAll`` only)."""
    if not isinstance(method, AllToAll):
        raise NotImplementedError(f"transpose_cost for {method!r} is {_LATER}")
    R = assert_compatible(pin, pout)
    if R is None or pin.topology.dims[R] == 1:
        return {}
    return {"all-to-all": {"count": 1, "bytes": hop_operand_bytes(
        pin, pout, extra_dims, dtype)}}


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange equal leading tiles of ``x`` within ``group``, as raw bytes
    (every dtype moves bit for bit, whatever the backend supports)."""
    src = x.reshape(-1).view(torch.uint8)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=group)
    return dst.view(x.dtype).reshape(x.shape)


def _transpose_local(data: torch.Tensor, pin: Pencil, pout: Pencil,
                     extra_ndims: int) -> torch.Tensor:
    """Same decomposition, new memory order: one K1 permute."""
    rel = pout.permutation / pin.permutation
    if rel.is_identity():
        return data
    to_out = _fwd_axes(pout, extra_ndims)
    in_to_logical = _inv_axes(pin, extra_ndims)
    axes = tuple(in_to_logical[i] for i in to_out)
    return k1.permute(data, axes)


def _exchange_transpose(data: torch.Tensor, pin: Pencil, pout: Pencil, R: int,
                        extra_ndims: int) -> torch.Tensor:
    topo = pin.topology
    P = topo.dims[R]
    a = pin.decomposition[R]   # decomposed in input, local in output
    b = pout.decomposition[R]  # local in input, decomposed in output
    n_a = pin.size_global()[a]
    to_out = _fwd_axes(pout, extra_ndims)       # tile dim k = logical to_out[k]
    in_to_logical = _inv_axes(pin, extra_ndims)
    pack_axes = tuple(in_to_logical[d] for d in to_out)
    tiles = k1.pack(data, pack_axes, to_out.index(b), P)
    if topo.connected:
        tiles = _all_to_all(tiles, topo.subcomm(R))
    elif P != 1:
        raise RuntimeError("transpose across ranks needs torch.distributed")
    return k1.unpack(tiles, tuple(range(len(to_out))), to_out.index(a), n_a)


def _hop(data: torch.Tensor, pin: Pencil, pout: Pencil,
         extra_ndims: int) -> torch.Tensor:
    R = assert_compatible(pin, pout)
    if R is None:
        return _transpose_local(data, pin, pout, extra_ndims)
    return _exchange_transpose(data, pin, pout, R, extra_ndims)


class _Hop(torch.autograd.Function):
    """One hop with the inverse hop as its backward (the exact adjoint:
    both are pack -> exchange -> unpack, and each drops the padding the
    other zero-fills)."""

    @staticmethod
    def forward(ctx, data, pin, pout, extra_ndims):
        ctx.hop = (pout, pin, extra_ndims)
        return _hop(data, pin, pout, extra_ndims)

    @staticmethod
    def backward(ctx, grad):
        return _hop(grad.contiguous(), *ctx.hop), None, None, None


def transpose(src: PencilArray, dest: Pencil, *,
              method: AbstractTransposeMethod = AllToAll()) -> PencilArray:
    """Redistribute ``src`` into the ``dest`` pencil configuration
    (reference ``transpose!``, ``Transpositions.jl:161-180``).  Every rank
    of the topology calls it; returns a new array.  Differentiable: the
    gradient runs the inverse hop (every rank must then call backward)."""
    if not isinstance(method, AllToAll):
        raise NotImplementedError(f"transpose method {method!r} is {_LATER}")
    pin = src.pencil
    nx = src.ndims_extra
    if src.data.requires_grad and torch.is_grad_enabled():
        out = _Hop.apply(src.data, pin, dest, nx)
    else:
        out = _hop(src.data, pin, dest, nx)
    return PencilArray(dest, out, src.extra_dims)


def ring_shift(tensors: Sequence[torch.Tensor], topology: Topology,
               axis: int = 0) -> List[torch.Tensor]:
    """Send each tensor one step around the ring of topology axis ``axis``
    and return what arrives from the previous rank: the ``lax.ppermute``
    with ``perm = [(i, (i + 1) % P)]``.  One batched set of point-to-point
    calls moves all tensors, as raw bytes.  For ``P == 1`` the inputs come
    back and nothing is sent."""
    P = topology.dims[axis]
    if P == 1:
        return list(tensors)
    coords = list(topology.coords_local)
    me = coords[axis]
    coords[axis] = (me + 1) % P
    dst = topology.global_rank(topology.rank(coords))
    coords[axis] = (me - 1) % P
    src = topology.global_rank(topology.rank(coords))
    group = topology.subcomm(axis)
    ops, outs = [], []
    for t in tensors:
        send = t.contiguous().reshape(-1).view(torch.uint8)
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        outs.append(recv.view(t.dtype).reshape(t.shape))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class Transposition:
    """Object API for parity with the reference's two-step
    ``Transposition(Ao, Ai)`` + ``transpose!(t)`` + ``MPI.Waitall(t)``
    (``Transpositions.jl:70-131``).  The exchange is blocking on the
    stream, so :meth:`waitall` only makes sure it ran."""

    def __init__(self, dest: Pencil, src: PencilArray,
                 method: AbstractTransposeMethod = AllToAll()):
        self.dest_pencil = dest
        self.src = src
        self.method = method
        self.dim = assert_compatible(src.pencil, dest)
        self._result: Optional[PencilArray] = None

    def execute(self) -> PencilArray:
        if self._result is None:
            self._result = transpose(self.src, self.dest_pencil,
                                     method=self.method)
        return self._result

    def waitall(self) -> None:
        self.execute()
