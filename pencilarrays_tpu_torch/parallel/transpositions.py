"""Global transpose between pencil configurations — the hot path.

PyTorch counterpart of the JAX package's ``parallel/transpositions.py``
(reference ``src/Transpositions/Transpositions.jl``).  One hop changes the
decomposition in at most one slot ``R`` (``assert_compatible``):

* ``R is None`` — only the memory order changes: one local permute
  (kernel K1, :func:`~pencilarrays_tpu_torch.ops.permute.permute`);
* otherwise **pack** (K1: input memory order -> the ``P`` tiles of dim
  ``b`` in the output's memory order, tail-padded with zeros) -> an
  exchange among the ranks of topology axis ``R`` -> **unpack** (K1:
  concatenate the tiles along dim ``a``, cut its tail padding).  The JAX
  package lets ``lax.all_to_all(split_axis=b, concat_axis=a)`` absorb
  both permutes; NCCL only splits a contiguous leading dimension, so here
  they are two real memory passes.

The exchange is the method's:

* :class:`AllToAll` — one ``all_to_all_single`` on the axis' sub-group;
* :class:`Ring` (``PointToPoint``) — ``G - 1`` rounds of one
  ``batch_isend_irecv`` each among the ``G`` ranks whose ceil-rule
  blocks hold data (round ``r``: participant ``i`` sends tile
  ``(i + r) % G`` to peer ``(i + r) % G``); the other ranks take part in
  no round, and destinations that hold only padding are zero-filled, so
  the result is bit-identical to :class:`AllToAll`;
* :class:`Pipelined` — the base method once per chunk of a dimension the
  exchange does not touch; each chunk's pack reads its slice of the block
  and each chunk's unpack writes its slice of the output (K1 takes and
  writes strided views), so the K1 bytes equal the unchunked hop's.
  Chunk ``k + 1``'s exchange is issued (``async_op``) before chunk ``k``
  is unpacked, and every rank issues them in chunk order;
* :class:`Auto` — :func:`resolve_method` picks ``AllToAll`` or ``Ring``
  from :func:`transpose_cost` (``mode="estimate"``).

The pack lays each tile out in the OUTPUT pencil's memory order, so unpack
only moves the tile axis next to dim ``a`` — a straight copy whenever ``a``
leads the output's memory order.  A hop on a size-1 topology axis still
runs pack -> unpack, with one exchange call under ``AllToAll`` (as the
JAX package's program does) and none under ``Ring``.

A hop is differentiable: for a tensor that requires grad, :func:`transpose`
runs inside a ``torch.autograd.Function`` whose backward is the inverse hop
back to the source pencil, by the same method.  Unpack drops padding where
pack zero-fills it, so the inverse hop is the exact adjoint.
:func:`ring_shift` is the ``lax.ppermute`` ring step of the
sequence-parallel attention schedules.  :data:`exchange_calls` counts the
exchange calls this process makes, under the op names of
:func:`transpose_cost`.

``Auto(mode="measure")``, Gspmd, ``reshard`` and reduced-precision wire
formats are not ported yet: they raise ``NotImplementedError`` naming the
ROADMAP item that queues them.
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
from .pencil import MemoryOrder, Pencil
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
    "exchange_calls",
    "hop_operand_bytes",
    "resolve_method",
    "reshard",
    "ring_shift",
    "transpose",
    "transpose_cost",
]

_LATER = ("not ported yet: ROADMAP.md Queue 1, item 'Transpose methods and "
          "plan options beyond the first slice'")

exchange_calls = {"all-to-all": 0, "collective-permute": 0}
"""Exchange calls this process made since the last reset (set each entry
to 0): ``all_to_all_single`` calls and ``batch_isend_irecv`` rounds, under
the op names :func:`transpose_cost` counts them by."""


class AbstractTransposeMethod:
    pass


def _no_wire(method) -> None:
    if method.wire_dtype is not None:
        raise NotImplementedError(
            f"{type(method).__name__}(wire_dtype=...) is {_LATER}")


@dataclass(frozen=True)
class AllToAll(AbstractTransposeMethod):
    """Pack -> ``all_to_all_single`` on one topology axis -> unpack.
    ``wire_dtype`` (reduced-precision payloads) is not ported yet."""

    wire_dtype: Optional[str] = None

    def __post_init__(self):
        _no_wire(self)


@dataclass(frozen=True)
class Ring(AbstractTransposeMethod):
    """Staged point-to-point exchange, ragged-aware: ``G - 1`` rounds of
    one ``batch_isend_irecv`` among the ``G = max(S_a, S_b)`` ranks whose
    ceil-rule blocks hold data, each round moving one tile per rank (the
    reference's ``PointToPoint()``, ``Transpositions.jl:61-65``).
    Bit-identical to :class:`AllToAll`.  ``wire_dtype`` is not ported
    yet."""

    wire_dtype: Optional[str] = None

    def __post_init__(self):
        _no_wire(self)


# reference method-name aliases (Transpositions.jl:17-24)
PointToPoint = Ring
Alltoallv = AllToAll


@dataclass(frozen=True)
class Pipelined(AbstractTransposeMethod):
    """Chunked exchange: the hop in ``chunks`` ceil-sized pieces along the
    largest dimension the exchange does not touch (extra dims included),
    one ``base`` exchange (``AllToAll()`` or ``Ring()``) per piece.  Each
    piece's pack reads its slice of the block and its unpack writes its
    slice of the output, so K1 moves the bytes of the unchunked hop;
    chunk ``k + 1``'s exchange is in flight while chunk ``k`` is unpacked.
    ``chunks=1``, or a block with nothing to chunk, is ``base``.
    Bit-identical to ``base`` for every ``chunks``."""

    chunks: int = 4
    base: AbstractTransposeMethod = AllToAll()

    def __post_init__(self):
        if not isinstance(self.chunks, int) or self.chunks < 1:
            raise ValueError(
                f"Pipelined chunks must be a positive int, got "
                f"{self.chunks!r}")
        if not isinstance(self.base, (AllToAll, Ring)):
            raise ValueError(
                f"Pipelined base must be AllToAll() or Ring() (explicit "
                f"single-axis exchanges), got {self.base!r}")


@dataclass(frozen=True)
class Auto(AbstractTransposeMethod):
    """Pick the exchange method per hop (:func:`resolve_method`).
    ``mode="estimate"``: :class:`Ring` exactly when its rounds, each
    charged a latency toll of ``latency_bytes``, cost less than one
    ``all_to_all``: ``(G-1) * (latency_bytes + tile) < latency_bytes +
    (P-1) * tile``.  ``mode="measure"`` and ``wire_dtype`` are not ported
    yet."""

    mode: str = "estimate"
    latency_bytes: int = 128 * 1024
    wire_dtype: Optional[str] = None

    def __post_init__(self):
        if self.mode not in ("estimate", "measure"):
            raise ValueError(
                f"Auto mode must be 'estimate' or 'measure', got "
                f"{self.mode!r}")
        if self.mode == "measure":
            raise NotImplementedError(f"Auto(mode='measure') is {_LATER}")
        _no_wire(self)


def _not_ported(name):
    def factory(*args, **kwargs):
        raise NotImplementedError(f"{name} is {_LATER}")

    factory.__name__ = name
    factory.__doc__ = f"The JAX package's ``{name}`` method ({_LATER})."
    return factory


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


def _chunk_bounds(n: int, K: int) -> Tuple[Tuple[int, int], ...]:
    """Chunk boundaries for extent ``n`` in at most ``K`` ceil-sized
    pieces, the last one short where ``K`` does not divide ``n``."""
    K = max(1, min(int(K), int(n)))
    step = -(-n // K)
    return tuple((s0, min(s0 + step, n)) for s0 in range(0, n, step))


def _pipeline_chunk_axis(shape: Tuple[int, ...], a: int, b: int,
                         exclude: Tuple[int, ...] = ()) -> Optional[int]:
    """The chunk axis of a logical-order block: the largest-extent axis
    other than ``a``, ``b`` and ``exclude`` (ties to the lowest index);
    ``None`` when nothing is chunkable."""
    best = None
    for c, n in enumerate(shape):
        if c == a or c == b or c in exclude or n < 2:
            continue
        if best is None or n > shape[best]:
            best = c
    return best


def _exchange_operand_extents(pin: Pencil, pout: Pencil, R: int
                              ) -> Tuple[int, ...]:
    """Logical extents of the exchanged operand: the local block with
    the to-be-split dim ``b`` padded to its post-exchange padded extent
    (the JAX package's definition, shared with its cost model and the
    chunk-axis choice)."""
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


def _ring_participants(pin: Pencil, pout: Pencil, R: int
                       ) -> Tuple[int, int]:
    """``(G, S_b)``: the ring's participants ``G = max(S_a, S_b)`` and the
    destinations ``S_b`` that own data, with ``S`` the ceil-rule blocks of
    a dim that hold any of its ``n`` elements."""
    P = pin.topology.dims[R]
    a, b = pin.decomposition[R], pout.decomposition[R]
    a_blk = pin.padded_global_shape[a] // P
    b_blk = pout.padded_global_shape[b] // P
    S_a = -(-pin.size_global()[a] // a_blk)
    S_b = -(-pin.size_global()[b] // b_blk)
    return max(S_a, S_b), S_b


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
                   dtype=None, method=AllToAll(), *, chunk=None) -> dict:
    """Predicted per-rank collective cost of one hop in the JAX package's
    ``{op: {"count", "bytes"}}`` schema.  ``AllToAll`` prices one
    ``all-to-all`` of the whole operand; ``Ring`` ``G - 1``
    ``collective-permute`` rounds of one ``b``-block tile each;
    ``Pipelined`` (and ``chunk=(dim, bounds)``, a caller's own chunking)
    multiplies the count by the number of chunks and leaves the bytes; a
    size-1 axis, or a ring of one participant, is priced ``{}``."""
    R = assert_compatible(pin, pout)
    if isinstance(method, Auto):
        method = resolve_method(pin, pout, extra_dims, dtype, method)
    if R is None:
        return {}
    P = pin.topology.dims[R]
    if P == 1:
        return {}
    a, b = pin.decomposition[R], pout.decomposition[R]
    shape = _exchange_operand_extents(pin, pout, R) + tuple(extra_dims)
    itemsize = _itemsize(dtype)

    def base_cost(m) -> dict:
        if isinstance(m, AllToAll):
            return {"all-to-all": {"count": 1,
                                   "bytes": math.prod(shape) * itemsize}}
        if isinstance(m, Ring):
            G, _ = _ring_participants(pin, pout, R)
            if G <= 1:
                return {}
            b_blk = pout.padded_global_shape[b] // P
            tile = math.prod(shape[:b] + (b_blk,) + shape[b + 1:]) * itemsize
            return {"collective-permute": {"count": G - 1,
                                           "bytes": (G - 1) * tile}}
        raise ValueError(f"no analytic cost model for method {m!r}")

    def chunked_cost(m, k_eff) -> dict:
        # ceil chunks partition the operand: the count multiplies, the
        # bytes stay
        return {op: {"count": v["count"] * k_eff, "bytes": v["bytes"]}
                for op, v in base_cost(m).items()}

    if isinstance(method, Pipelined):
        c = _pipeline_chunk_axis(shape, a, b)
        if c is None:
            return base_cost(method.base)
        return chunked_cost(method.base,
                            len(_chunk_bounds(shape[c], method.chunks)))
    if chunk is not None and len(chunk[1]) > 1:
        return chunked_cost(method, len(chunk[1]))
    return base_cost(method)


def resolve_method(pin: Pencil, pout: Pencil,
                   extra_dims: Tuple[int, ...] = (), dtype=None,
                   method: AbstractTransposeMethod = Auto()
                   ) -> AbstractTransposeMethod:
    """Resolve :class:`Auto` to ``AllToAll()`` or ``Ring()`` for one hop
    (concrete methods pass through): the ring wins exactly when
    ``(G-1) * (latency_bytes + tile) < latency_bytes + (P-1) * tile``,
    with its tile and rounds from :func:`transpose_cost`.  A local
    permute, a size-1 axis or a ring of one participant resolve to
    ``AllToAll()``."""
    if not isinstance(method, Auto):
        return method
    R = assert_compatible(pin, pout)
    if R is None or pin.topology.dims[R] == 1:
        return AllToAll()
    P = pin.topology.dims[R]
    ring = transpose_cost(pin, pout, tuple(extra_dims), dtype, Ring())
    if not ring:
        return AllToAll()
    rc = ring["collective-permute"]
    tile = rc["bytes"] // rc["count"]
    L = method.latency_bytes
    if rc["count"] * (L + tile) < L + (P - 1) * tile:
        return Ring()
    return AllToAll()


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


class _Exchange:
    """One exchange hop ``pin -> pout`` on topology axis ``R`` by an
    explicit method (``AllToAll`` or ``Ring``), in the pieces a chunked
    or fused hop is built from: :meth:`pack` (K1), :meth:`start` (the
    exchange, issued asynchronously), :meth:`finish` (its wait) and
    :meth:`unpack` (K1).  Every piece takes any chunk of the block along
    a dim other than ``a`` and ``b``."""

    def __init__(self, pin: Pencil, pout: Pencil, extra_ndims: int,
                 method: AbstractTransposeMethod):
        R = assert_compatible(pin, pout)
        if R is None or not isinstance(method, (AllToAll, Ring)):
            raise ValueError(f"no exchange for {method!r} on R={R}")
        topo = pin.topology
        self.pin, self.pout, self.R, self.method = pin, pout, R, method
        self.topo, self.P = topo, topo.dims[R]
        a, b = pin.decomposition[R], pout.decomposition[R]
        self.n_a = pin.size_global()[a]
        self.fwd_in = _fwd_axes(pin, extra_ndims)
        self.fwd_out = _fwd_axes(pout, extra_ndims)  # tile dim k = logical
        in_to_logical = _inv_axes(pin, extra_ndims)
        self.pack_axes = tuple(in_to_logical[d] for d in self.fwd_out)
        self.tile_b = self.fwd_out.index(b)
        self.tile_a = self.fwd_out.index(a)
        self.ident = tuple(range(len(self.fwd_out)))
        if self.P != 1 and not topo.connected:
            raise RuntimeError("transpose across ranks needs "
                               "torch.distributed")
        self.ring = (_ring_participants(pin, pout, R)
                     if isinstance(method, Ring) else None)

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        return k1.pack(x, self.pack_axes, self.tile_b, self.P)

    def start(self, tiles: torch.Tensor):
        """Issue the exchange of ``tiles`` (``(P, tile...)``, contiguous);
        returns a handle that holds both buffers until :meth:`finish`."""
        if not self.topo.connected:
            return tiles, [], tiles
        group = self.topo.subcomm(self.R)
        if self.ring is None:
            src = tiles.reshape(-1).view(torch.uint8)
            dst = torch.empty_like(src)
            work = dist.all_to_all_single(dst, src, group=group,
                                          async_op=True)
            exchange_calls["all-to-all"] += 1
            return dst.view(tiles.dtype).reshape(tiles.shape), [work], tiles
        G, S_b = self.ring
        me = self.topo.coords_local[self.R]
        if me >= G:
            return None, [], tiles   # holds only padding: no round
        if G <= 1:
            return tiles, [], tiles
        recv = torch.empty_like(tiles)
        recv[me].copy_(tiles[me])
        coords = list(self.topo.coords_local)

        def peer(i):
            coords[self.R] = i
            return self.topo.global_rank(self.topo.rank(coords))

        works = []
        for r in range(1, G):
            to, frm = (me + r) % G, (me - r) % G
            ops = [dist.P2POp(dist.isend, tiles[to].reshape(-1).view(
                       torch.uint8), peer(to), group),
                   dist.P2POp(dist.irecv, recv[frm].reshape(-1).view(
                       torch.uint8), peer(frm), group)]
            works += dist.batch_isend_irecv(ops)
            exchange_calls["collective-permute"] += 1
        return recv, works, tiles

    def finish(self, handle) -> Optional[torch.Tensor]:
        """Wait for an exchange; the received tiles, or ``None`` where
        this rank's output block holds only padding (a ring destination
        past ``S_b``)."""
        recv, works, _ = handle
        for w in works:
            w.wait()
        if self.ring is not None and \
                self.topo.coords_local[self.R] >= self.ring[1]:
            return None
        return recv

    def unpack(self, recv: Optional[torch.Tensor],
               out: Optional[torch.Tensor] = None,
               like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Received tiles -> the output block (or ``out``, a view of it);
        zeros where ``recv`` is ``None``."""
        if recv is None:
            if out is None:
                shape = list(like.shape[1:])
                shape[self.tile_a] = self.n_a
                return like.new_zeros(shape)
            return out.zero_()
        return k1.unpack(recv, self.ident, self.tile_a, self.n_a, out=out)


def _run_pipeline(n: int, produce, exchange: _Exchange, consume) -> None:
    """Software pipeline over ``n`` chunks: ``produce(k)`` gives chunk
    ``k``'s packed tiles, whose exchange is issued at once; chunk ``k``'s
    ``consume(k, tiles, received)`` runs after chunk ``k + 1``'s exchange
    was issued, so on the card NCCL moves ``k + 1`` while the compute
    stream works on ``k``.  Every rank issues the exchanges in chunk
    order; each handle keeps its buffers alive until its wait."""
    pending = None
    for k in range(n):
        tiles = produce(k)
        handle = exchange.start(tiles)
        if pending is not None:
            consume(pending[0], pending[1], exchange.finish(pending[2]))
        pending = (k, tiles, handle)
    if pending is not None:
        consume(pending[0], pending[1], exchange.finish(pending[2]))


def _exchange_transpose(data: torch.Tensor, pin: Pencil, pout: Pencil,
                        R: int, extra_ndims: int,
                        method: AbstractTransposeMethod) -> torch.Tensor:
    base = method.base if isinstance(method, Pipelined) else method
    ex = _Exchange(pin, pout, extra_ndims, base)
    bounds, c = None, None
    if isinstance(method, Pipelined):
        a, b = pin.decomposition[R], pout.decomposition[R]
        shape = _exchange_operand_extents(pin, pout, R) + tuple(
            data.shape[pin.ndims:])
        c = _pipeline_chunk_axis(shape, a, b)
        if c is not None:
            bounds = _chunk_bounds(shape[c], method.chunks)
    if bounds is None or len(bounds) == 1:
        tiles = ex.pack(data)
        return ex.unpack(ex.finish(ex.start(tiles)), like=tiles)
    mi, mo = ex.fwd_in.index(c), ex.fwd_out.index(c)
    out = data.new_empty(pout.padded_size_local(MemoryOrder)
                         + tuple(data.shape[pin.ndims:]))

    def produce(k):
        s0, s1 = bounds[k]
        return ex.pack(data.narrow(mi, s0, s1 - s0))

    def consume(k, tiles, recv):
        s0, s1 = bounds[k]
        ex.unpack(recv, out=out.narrow(mo, s0, s1 - s0))

    _run_pipeline(len(bounds), produce, ex, consume)
    return out


def _hop(data: torch.Tensor, pin: Pencil, pout: Pencil, extra_ndims: int,
         method: AbstractTransposeMethod) -> torch.Tensor:
    R = assert_compatible(pin, pout)
    if R is None:
        return _transpose_local(data, pin, pout, extra_ndims)
    return _exchange_transpose(data, pin, pout, R, extra_ndims, method)


class _Hop(torch.autograd.Function):
    """One hop with the inverse hop, by the same method, as its backward
    (the exact adjoint: both are pack -> exchange -> unpack, and each
    drops the padding the other zero-fills)."""

    @staticmethod
    def forward(ctx, data, pin, pout, extra_ndims, method):
        ctx.hop = (pout, pin, extra_ndims, method)
        return _hop(data, pin, pout, extra_ndims, method)

    @staticmethod
    def backward(ctx, grad):
        return _hop(grad.contiguous(), *ctx.hop), None, None, None, None


def transpose(src: PencilArray, dest: Pencil, *,
              method: AbstractTransposeMethod = AllToAll()) -> PencilArray:
    """Redistribute ``src`` into the ``dest`` pencil configuration
    (reference ``transpose!``, ``Transpositions.jl:161-180``).  Every rank
    of the topology calls it; returns a new array.  ``method`` is
    ``AllToAll()``, ``Ring()``, ``Pipelined(...)`` or ``Auto()``; all move
    the same bits.  Differentiable: the gradient runs the inverse hop
    (every rank must then call backward)."""
    pin = src.pencil
    nx = src.ndims_extra
    if isinstance(method, Auto):
        method = resolve_method(pin, dest, src.extra_dims, src.dtype, method)
    if not isinstance(method, (AllToAll, Ring, Pipelined)):
        raise TypeError(f"unknown transpose method {method!r}")
    if src.data.requires_grad and torch.is_grad_enabled():
        out = _Hop.apply(src.data, pin, dest, nx, method)
    else:
        out = _hop(src.data, pin, dest, nx, method)
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
    (``Transpositions.jl:70-131``), by any method :func:`transpose`
    takes.  The hop completes inside :meth:`execute`, so :meth:`waitall`
    only makes sure it ran."""

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
