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
  from :func:`transpose_cost` (``mode="estimate"``);
* :class:`Gspmd` — any pair of pencils on one topology, any number of
  differing slots: each rank sends the intersection of its block with
  every destination block (the reference's ``Alltoallv``,
  ``Transpositions.jl:383-388``) in one ``all_to_all_single`` with
  per-peer split sizes, each piece packed and unpacked by K1; on one
  rank it is one K1 permute.  :func:`reshard` uses it where the route
  planner (``parallel/routing.py``) finds no cheaper chain of hops.

``wire_dtype`` on ``AllToAll``, ``Ring`` and ``Auto`` (``Pipelined``
inherits its base's) casts each exchange's payload to a reduced-precision
wire format just before the exchange call and back just after
(``parallel/wire.py``): per chunk, per ring round, in fused FFT hops, and
on a size-1 axis too, where nothing crosses a link (the JAX package's
program wraps the exchange whatever ``P`` is).  The fp8 windows lie along
JAX's tile axis of each exchanged operand, so the values are JAX's.

The pack lays each tile out in the OUTPUT pencil's memory order, so unpack
only moves the tile axis next to dim ``a`` — a straight copy whenever ``a``
leads the output's memory order.  A hop on a size-1 topology axis still
runs pack -> unpack, with one exchange call under ``AllToAll`` (as the
JAX package's program does) and none under ``Ring``.

A hop is differentiable: for a tensor that requires grad, :func:`transpose`
runs inside a ``torch.autograd.Function`` whose backward is the inverse hop
back to the source pencil, by the same method.  Unpack drops padding where
pack zero-fills it, so the inverse hop is the exact adjoint.  A wired hop
raises instead: the JAX package's gradient through the wire's integer
bitcast is zero.  :func:`ring_shift` is the ``lax.ppermute`` ring step of
the sequence-parallel attention schedules.  :data:`exchange_calls` and
:data:`exchange_bytes` count the exchange calls this process makes and
the bytes it hands them, under the op names of :func:`transpose_cost`.

With observability on (``obs/``), each call journals a ``hop`` record,
meters ``transpose.dispatches`` / ``predicted_bytes`` /
``dispatch_seconds`` and feeds the drift tracker a ``dispatch`` sample
(the host time of the call: on the card a lower bound, since a dispatch
returns once its kernels are enqueued).  With the integrity guard on
(``guard/``), each call runs between two invariant probes, one before
K1's pack and one after K1's unpack, under the hang watchdog until the
probes are fetched (:func:`_dispatch_guarded_hop`); the hop itself is
the unguarded one, so it moves the same bits with the same K1 launches.
With both off a call pays one cached probe of each gate.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import guard, obs
from ..ops import permute as k1
from ..resilience import faults
from . import collectives as _collectives
from . import wire as _wire
from .arrays import PencilArray, _fwd_axes, _inv_axes, as_torch_dtype
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
    "exchange_bytes",
    "exchange_calls",
    "gspmd_reshard_cost",
    "hop_operand_bytes",
    "last_measure_reports",
    "resolve_method",
    "reshard",
    "ring_shift",
    "strip_wire",
    "transpose",
    "transpose_cost",
    "with_wire",
]

exchange_calls = {"all-to-all": 0, "collective-permute": 0}
"""Exchange calls this process made since the last reset (set each entry
to 0): ``all_to_all_single`` calls and ``batch_isend_irecv`` rounds, under
the op names :func:`transpose_cost` counts them by."""

exchange_bytes = {"all-to-all": 0, "collective-permute": 0}
"""Bytes this process handed to its exchange calls since the last reset
(the packed wire bytes of a wired hop): the measured counterpart of
:func:`transpose_cost`'s bytes."""

def _count(op: str, nbytes: int, crosses: bool, *, group=None,
           shape=(), dtype=None, pair=None, buffer=None) -> None:
    """Count one exchange call (:data:`exchange_calls`) and, where it
    crosses ranks, report it to the collective recorder
    (``parallel/collectives.py``): a one-rank all-to-all is a device
    copy, priced at nothing (the JAX package's compiled programs hold
    no collective there)."""
    exchange_calls[op] += 1
    exchange_bytes[op] += nbytes
    if crosses:
        _collectives.note(op, nbytes, group=group, shape=shape,
                          dtype=dtype, async_start=True, pair=pair,
                          buffer=buffer)


class AbstractTransposeMethod:
    pass


def _canon_wire_field(method) -> None:
    """Normalize a frozen method's ``wire_dtype`` at construction, so
    spellings never split method equality."""
    object.__setattr__(method, "wire_dtype",
                       _wire.canonical_wire_dtype(method.wire_dtype))


@dataclass(frozen=True)
class AllToAll(AbstractTransposeMethod):
    """Pack -> ``all_to_all_single`` on one topology axis -> unpack.
    ``wire_dtype="bf16" | "f16" | "fp8_e4m3" | "fp8_e5m2"`` moves the
    payload in a reduced-precision wire format (``parallel/wire.py``)."""

    wire_dtype: Optional[str] = None

    def __post_init__(self):
        _canon_wire_field(self)


@dataclass(frozen=True)
class Gspmd(AbstractTransposeMethod):
    """The unrestricted exchange: any two pencils on one topology, by
    per-peer block intersections in one ``all_to_all_single`` (the JAX
    package's partitioner-scheduled reshard)."""


@dataclass(frozen=True)
class Ring(AbstractTransposeMethod):
    """Staged point-to-point exchange, ragged-aware: ``G - 1`` rounds of
    one ``batch_isend_irecv`` among the ``G = max(S_a, S_b)`` ranks whose
    ceil-rule blocks hold data, each round moving one tile per rank (the
    reference's ``PointToPoint()``, ``Transpositions.jl:61-65``).
    Bit-identical to :class:`AllToAll`.  ``wire_dtype`` as on
    :class:`AllToAll`: every round's tile moves packed."""

    wire_dtype: Optional[str] = None

    def __post_init__(self):
        _canon_wire_field(self)


# reference method-name aliases (Transpositions.jl:17-24)
PointToPoint = Ring
Alltoallv = AllToAll


@dataclass(frozen=True)
class Pipelined(AbstractTransposeMethod):
    """Chunked exchange: the hop in ``chunks`` ceil-sized pieces along the
    largest dimension the exchange does not touch (extra dims included),
    one ``base`` exchange (``AllToAll()`` or ``Ring()``, with its wire)
    per piece.  Each piece's pack reads its slice of the block and its
    unpack writes its slice of the output, so K1 moves the bytes of the
    unchunked hop; chunk ``k``'s exchange is in flight while chunk
    ``k + 1`` is packed, and chunk ``k + 1``'s while chunk ``k`` is
    unpacked.  ``chunks=1``, or a block with nothing to chunk, is
    ``base``.  Bit-identical to ``base`` for every ``chunks``."""

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
    (P-1) * tile``.  ``wire_dtype`` rides the winner.
    ``mode="measure"`` times every explicit candidate on the actual
    configuration (:func:`last_measure_reports`) and keeps the winner;
    on several ranks rank 0's verdict is broadcast over the topology."""

    mode: str = "estimate"
    latency_bytes: int = 128 * 1024
    wire_dtype: Optional[str] = None

    def __post_init__(self):
        if self.mode not in ("estimate", "measure"):
            raise ValueError(
                f"Auto mode must be 'estimate' or 'measure', got "
                f"{self.mode!r}")
        _canon_wire_field(self)


def _method_wire(method) -> Optional[str]:
    """The wire dtype a method puts on its exchanges (``None``: full
    precision); ``Pipelined`` carries its base's, ``Gspmd`` none."""
    if isinstance(method, (AllToAll, Ring, Auto)):
        return method.wire_dtype
    if isinstance(method, Pipelined):
        return _method_wire(method.base)
    return None


def with_wire(method: AbstractTransposeMethod,
              wire_dtype) -> AbstractTransposeMethod:
    """``method`` carrying ``wire_dtype`` on its exchanges; ``None``
    passes it through, a different wire already on it is a conflict."""
    wire = _wire.canonical_wire_dtype(wire_dtype)
    if wire is None:
        return method
    cur = _method_wire(method)
    if cur is not None and cur != wire:
        raise ValueError(
            f"method {method!r} already carries wire_dtype={cur!r}; "
            f"conflicting wire_dtype={wire!r} requested")
    if isinstance(method, (AllToAll, Ring, Auto)):
        return replace(method, wire_dtype=wire)
    if isinstance(method, Pipelined):
        return replace(method, base=with_wire(method.base, wire))
    raise ValueError(
        f"wire_dtype is only supported on explicit exchange methods "
        f"(AllToAll/Ring/Pipelined) and Auto; got {method!r} (a Gspmd "
        f"exchange has no single-axis payload to pack)")


def strip_wire(method: AbstractTransposeMethod) -> AbstractTransposeMethod:
    """``method`` with its ``wire_dtype`` removed throughout (the inverse
    of :func:`with_wire`)."""
    if isinstance(method, (AllToAll, Ring, Auto)):
        return (replace(method, wire_dtype=None)
                if method.wire_dtype is not None else method)
    if isinstance(method, Pipelined):
        return replace(method, base=strip_wire(method.base))
    return method


def _method_label(m: AbstractTransposeMethod) -> str:
    """Stable label of a method, its wire included
    (``AllToAll[wire=bf16]``); the JAX package's spelling."""
    if isinstance(m, Pipelined):
        return f"Pipelined(chunks={m.chunks}, base={_method_label(m.base)})"
    wire = _method_wire(m) if isinstance(m, (AllToAll, Ring, Auto)) else None
    if wire is not None:
        return f"{type(m).__name__}[wire={wire}]"
    return type(m).__name__


def _dtype_name(dtype) -> str:
    if dtype is None:
        return "float32"
    return str(as_torch_dtype(dtype)).split(".")[-1]


def _hop_label(pin: Pencil, pout: Pencil, method: AbstractTransposeMethod,
               dtype=None) -> str:
    """Stable key of one hop configuration: global shape, topology,
    decomposition change, method and dtype (the JAX package's)."""
    return (f"{pin.size_global()}@{pin.topology.dims} "
            f"{pin.decomposition}->{pout.decomposition} "
            f"{_method_label(method)} {_dtype_name(dtype)}")


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
            f"transposes (x->y->z) or use reshard()")
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
    (the JAX package's definition, shared with its cost model, the chunk
    axis and the fp8 tile axis)."""
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
    multiplies the count by the number of chunks and leaves the bytes,
    except on an fp8 wire, where each chunk carries its own scales and the
    per-chunk bytes are summed; ``Gspmd`` is :func:`gspmd_reshard_cost`.
    A wired method is priced at :func:`~.wire.wire_bytes`.  A size-1 axis,
    or a ring of one participant, is priced ``{}``."""
    R = assert_compatible(pin, pout)
    if isinstance(method, Auto):
        method = resolve_method(pin, pout, extra_dims, dtype, method)
    if R is None:
        return {}
    P = pin.topology.dims[R]
    if P == 1:
        return {}
    if isinstance(method, Gspmd):
        return gspmd_reshard_cost(pin, pout, extra_dims, dtype)
    a, b = pin.decomposition[R], pout.decomposition[R]
    shape = _exchange_operand_extents(pin, pout, R) + tuple(extra_dims)
    wire = _method_wire(method)

    def operand_bytes(s):
        return _wire.wire_bytes(dtype, wire, s, axes=(a, b))

    def base_cost(m, s) -> dict:
        if isinstance(m, AllToAll):
            return {"all-to-all": {"count": 1, "bytes": operand_bytes(s)}}
        if isinstance(m, Ring):
            G, _ = _ring_participants(pin, pout, R)
            if G <= 1:
                return {}
            b_blk = pout.padded_global_shape[b] // P
            tile = operand_bytes(s[:b] + (b_blk,) + s[b + 1:])
            return {"collective-permute": {"count": G - 1,
                                           "bytes": (G - 1) * tile}}
        raise ValueError(f"no analytic cost model for method {m!r}")

    def chunked_cost(m, c, bounds) -> dict:
        if wire not in _wire.FP8_WIRE_DTYPES or len(bounds) == 1:
            # ceil chunks partition the operand: the count multiplies,
            # the bytes stay
            return {op: {"count": v["count"] * len(bounds),
                         "bytes": v["bytes"]}
                    for op, v in base_cost(m, shape).items()}
        out: dict = {}
        for s0, s1 in bounds:
            cs = shape[:c] + (s1 - s0,) + shape[c + 1:]
            for op, v in base_cost(m, cs).items():
                e = out.setdefault(op, {"count": 0, "bytes": 0})
                e["count"] += v["count"]
                e["bytes"] += v["bytes"]
        return out

    if isinstance(method, Pipelined):
        c = _pipeline_chunk_axis(shape, a, b)
        if c is None:
            return base_cost(method.base, shape)
        return chunked_cost(method.base, c,
                            _chunk_bounds(shape[c], method.chunks))
    if chunk is not None and len(chunk[1]) > 1:
        return chunked_cost(method, chunk[0], tuple(chunk[1]))
    return base_cost(method, shape)


_MEASURE_REPORTS: dict = {}
_MEASURE_TIMINGS: dict = {}
_MEASURE_LOGGED: set = set()


def last_measure_reports() -> list:
    """The audit trail of every ``Auto(mode='measure')`` decision this
    process took (the JAX package's schema): per candidate the seconds
    of a forward + back pair and the k1-arm spread of its measurement,
    the winner, and ``margin_over_noise``, the runner-up/winner time
    ratio over the noise (< 1: the decision is a coin flip)."""
    return list(_MEASURE_REPORTS.values())


@lru_cache(maxsize=512)
def _measured_choice(pin: Pencil, pout: Pencil, R: int, extra_dims: tuple,
                     dtype: torch.dtype, wire: Optional[str] = None
                     ) -> AbstractTransposeMethod:
    """Time every explicit candidate on the configuration and cache the
    winner (FFTW_MEASURE's analog): ``AllToAll``, ``Ring`` and, where the
    hop has a chunkable dim, ``Pipelined(K)`` for K in {2, 4, 8}, each
    carrying ``wire``.  The timed body is a forward + back pair
    (``utils/benchtime.py``).  Every rank of the topology times; rank
    0's winner is broadcast over the topology's group, so all ranks run
    the same exchange."""
    from ..utils.benchtime import device_seconds_per_iter, last_spread

    nx = len(extra_dims)
    x0 = PencilArray.zeros(pin, extra_dims, dtype).data
    a, b = pin.decomposition[R], pout.decomposition[R]
    blk = tuple(pin.padded_size_local()) + tuple(extra_dims)
    c = _pipeline_chunk_axis(blk, a, b)
    candidates = [AllToAll(wire_dtype=wire), Ring(wire_dtype=wire)]
    if c is not None:
        candidates += [
            Pipelined(chunks=k, base=AllToAll(wire_dtype=wire))
            for k in (2, 4, 8) if len(_chunk_bounds(blk[c], k)) > 1]
    best, best_t = 0, float("inf")
    times, spreads = [], []
    for i, cand in enumerate(candidates):
        def pair(d, cand=cand):
            return _hop(_hop(d, pin, pout, nx, cand), pout, pin, nx, cand)

        t = device_seconds_per_iter(pair, x0, k0=1, k1=8, repeats=5)
        times.append(t)
        spreads.append(last_spread()["k1_worst_over_best"])
        if t < best_t:
            best, best_t = i, t
    loser_t = min(t for i, t in enumerate(times) if i != best) \
        if len(times) > 1 else best_t
    noise = max(s for s in spreads if s is not None) if any(
        s is not None for s in spreads) else None
    dname = _dtype_name(dtype)
    try:
        dstr = np.dtype(dname).str      # the JAX package's spelling
    except TypeError:
        dstr = dname
    topo = pin.topology
    if topo.connected and math.prod(topo.dims) > 1:
        # ranks time independently and may disagree; a split verdict
        # would issue all-to-alls on one rank and ring rounds on another
        verdict = torch.tensor([best], dtype=torch.int64,
                               device=topo.device)
        dist.broadcast(verdict, src=topo.global_rank(0), group=topo.group)
        best = int(verdict.item())
    _MEASURE_TIMINGS[(pin, pout, R, extra_dims, dname, wire)] = list(
        zip(candidates, times))
    _MEASURE_REPORTS[(pin, pout, R, extra_dims, dname, wire)] = {
        "config": f"{pin.size_global()}@{pin.topology.dims} R={R} "
                  f"{dstr}" + (f" wire={wire}" if wire else ""),
        "candidates": [_method_label(m) for m in candidates],
        "seconds": times,
        "k1_spreads": spreads,
        "winner": _method_label(candidates[best]),
        "margin_over_noise": (round((loser_t / best_t) / noise, 3)
                              if noise and best_t > 0 else None),
    }
    return candidates[best]


def _journal_measure_verdict(key: tuple) -> None:
    """Journal a measured verdict and feed its candidate timings to the
    drift tracker as ``auto_measure`` samples, once per (obs run,
    configuration), from the cached report, so late-armed observability
    journals configurations measured earlier in the process."""
    report = _MEASURE_REPORTS.get(key)
    if report is None:
        return
    dedup = (obs.run_id(), report["config"])
    if dedup in _MEASURE_LOGGED:
        return
    _MEASURE_LOGGED.add(dedup)
    obs.record_event("auto.verdict", mode="measure", **report)
    pin, pout, _, extra_dims, dname, _ = key
    for cand, t in _MEASURE_TIMINGS.get(key, ()):
        # candidate timings are forward + back pairs of the same hop:
        # halved to one hop's seconds
        cost = transpose_cost(pin, pout, extra_dims, dname, cand)
        obs.record_hop_sample(
            _hop_label(pin, pout, cand, dname),
            sum(v["bytes"] for v in cost.values()), t / 2.0,
            source="auto_measure")


def resolve_method(pin: Pencil, pout: Pencil,
                   extra_dims: Tuple[int, ...] = (), dtype=None,
                   method: AbstractTransposeMethod = Auto()
                   ) -> AbstractTransposeMethod:
    """Resolve :class:`Auto` to a concrete method for one hop, carrying
    Auto's wire (concrete methods pass through).  ``mode="estimate"``: the
    ring wins exactly when ``(G-1) * (latency_bytes + tile) <
    latency_bytes + (P-1) * tile``, with its tile and rounds from
    :func:`transpose_cost`; ``mode="measure"``: the fastest measured
    candidate (a collective: every rank of the topology resolves it).  A
    local permute, a size-1 axis or a ring of one participant resolve
    to ``AllToAll()`` without measuring."""
    if not isinstance(method, Auto):
        return method
    R = assert_compatible(pin, pout)
    wire = method.wire_dtype
    if R is None or pin.topology.dims[R] == 1:
        return AllToAll(wire_dtype=wire)
    if method.mode == "measure":
        dt = as_torch_dtype(dtype if dtype is not None else torch.float32)
        key = (pin, pout, R, tuple(extra_dims), dt, wire)
        choice = _measured_choice(*key)
        if obs.enabled():
            _journal_measure_verdict(key[:4] + (_dtype_name(dt), wire))
        return choice
    P = pin.topology.dims[R]
    ring = transpose_cost(pin, pout, tuple(extra_dims), dtype,
                          Ring(wire_dtype=wire))
    if not ring:
        return AllToAll(wire_dtype=wire)
    rc = ring["collective-permute"]
    tile = rc["bytes"] // rc["count"]
    L = method.latency_bytes
    if rc["count"] * (L + tile) < L + (P - 1) * tile:
        return Ring(wire_dtype=wire)
    return AllToAll(wire_dtype=wire)


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


def _take(x):
    """The tensor of ``x``, taking it out of a one-element list: a caller
    that passes ``[tensor]`` and keeps no other reference lets the hop
    free its input once the input is packed."""
    return x.pop() if isinstance(x, list) else x


class _Exchange:
    """One exchange hop ``pin -> pout`` on topology axis ``R`` by an
    explicit method (``AllToAll`` or ``Ring``, with its wire), in the
    pieces a chunked or fused hop is built from: :meth:`pack` (K1),
    :meth:`start` (the exchange, issued asynchronously), :meth:`finish`
    (its wait) and :meth:`unpack` (K1).  Every piece takes any chunk of the
    block along a dim other than ``a`` and ``b``; :meth:`pack` and
    :meth:`unpack` take their tensor as ``[tensor]`` too, and then free it
    as soon as they are done with it.

    A 16-bit wire's casts are elementwise, so they commute with K1's
    moves: :meth:`pack` casts the block into its wire buffer before K1
    packs it, and :meth:`unpack` widens after K1 unpacks, K1 moving the
    2-byte words (4 for a complex element) and the exchange sending what
    it would send anyway.  An fp8 wire's scales run along a tile axis of
    the exchange layout, so :meth:`start` packs K1's tiles and
    :meth:`finish` unpacks them."""

    def __init__(self, pin: Pencil, pout: Pencil, extra_ndims: int,
                 method: AbstractTransposeMethod):
        R = assert_compatible(pin, pout)
        if R is None or not isinstance(method, (AllToAll, Ring)):
            raise ValueError(f"no exchange for {method!r} on R={R}")
        topo = pin.topology
        self.pin, self.pout, self.R, self.method = pin, pout, R, method
        self.topo, self.P = topo, topo.dims[R]
        self.a, self.b = pin.decomposition[R], pout.decomposition[R]
        self.n_a = pin.size_global()[self.a]
        self.fwd_in = _fwd_axes(pin, extra_ndims)
        self.fwd_out = _fwd_axes(pout, extra_ndims)  # tile dim k = logical
        in_to_logical = _inv_axes(pin, extra_ndims)
        self.pack_axes = tuple(in_to_logical[d] for d in self.fwd_out)
        self.tile_b = self.fwd_out.index(self.b)
        self.tile_a = self.fwd_out.index(self.a)
        self.ident = tuple(range(len(self.fwd_out)))
        self.wire = method.wire_dtype
        self.wire16 = (self.wire is not None
                       and self.wire not in _wire.FP8_WIRE_DTYPES)
        self.dtype = None       # the payload's, set by pack
        if self.P != 1 and not topo.connected:
            raise RuntimeError("transpose across ranks needs "
                               "torch.distributed")
        self.ring = (_ring_participants(pin, pout, R)
                     if isinstance(method, Ring) else None)

    def pack(self, x) -> torch.Tensor:
        x = _take(x)
        self.dtype = x.dtype
        if self.wire16:
            bits = _wire.pack_axis(x, self.wire).contiguous()
            del x
            # a complex element's two words move as one 4-byte word
            x = (bits.view(torch.int32).squeeze(-1) if self.dtype.is_complex
                 else bits.view(torch.int16))
            del bits
        return k1.pack(x, self.pack_axes, self.tile_b, self.P)

    def _tile_axis(self, tiles: torch.Tensor) -> Tuple[int, int]:
        """``(position in tiles, extent)`` of JAX's fp8 tile axis: the
        largest free axis of the logical operand this chunk of tiles
        holds (dim ``b`` at its padded extent ``P * tile``)."""
        logical = [tiles.shape[1 + self.fwd_out.index(d)]
                   for d in range(len(self.fwd_out))]
        logical[self.b] *= self.P
        t = _wire.fp8_tile_axis(logical, self.a, self.b)
        return 1 + self.fwd_out.index(t), logical[t]

    def start(self, tiles) -> dict:
        """Issue the exchange of ``tiles`` (``(P, tile...)``, contiguous;
        passed as ``[tiles]``, an fp8 wire's full-precision tiles are
        freed once wire-packed); the handle holds every buffer until
        :meth:`finish`."""
        tiles = _take(tiles)
        h = {"shape": tuple(tiles.shape), "dtype": self.dtype,
             "axis": None}
        send = tiles
        if self.wire is not None and not self.wire16:
            h["axis"] = self._tile_axis(tiles)
            send = _wire.pack_axis(tiles, self.wire, h["axis"][0])
            del tiles
        h["send"], h["works"] = send, []
        if not self.topo.connected:
            h["recv"] = send
            return h
        group = self.topo.subcomm(self.R)
        if self.ring is None:
            src = send.reshape(-1).view(torch.uint8)
            dst = torch.empty_like(src)
            h["works"] = [dist.all_to_all_single(dst, src, group=group,
                                                 async_op=True)]
            _count("all-to-all", src.numel(), self.P > 1, group=group,
                   shape=send.shape, dtype=send.dtype, buffer=send)
            h["recv"] = dst.view(send.dtype).reshape(send.shape)
            return h
        G, S_b = self.ring
        me = self.topo.coords_local[self.R]
        if me >= G:
            h["recv"] = None   # holds only padding: no round
            return h
        if G <= 1:
            h["recv"] = send
            return h
        recv = torch.empty_like(send)
        recv[me].copy_(send[me])
        coords = list(self.topo.coords_local)

        def peer(i):
            coords[self.R] = i
            return self.topo.global_rank(self.topo.rank(coords))

        for r in range(1, G):
            to, frm = (me + r) % G, (me - r) % G
            out_t = send[to].reshape(-1).view(torch.uint8)
            ops = [dist.P2POp(dist.isend, out_t, peer(to), group),
                   dist.P2POp(dist.irecv, recv[frm].reshape(-1).view(
                       torch.uint8), peer(frm), group)]
            h["works"] += dist.batch_isend_irecv(ops)
            _count("collective-permute", out_t.numel(), True,
                   shape=send[to].shape, dtype=send.dtype, buffer=send,
                   pair=(self.topo.global_rank(self.topo.rank_local),
                         peer(to)))
        h["recv"] = recv
        return h

    def finish(self, h: dict) -> Optional[torch.Tensor]:
        """Wait for an exchange and release its send buffer; the received
        tiles (an fp8 wire's back at full precision, a 16-bit wire's
        still its bits), or ``None`` where this rank's output block holds
        only padding (a ring destination past ``S_b``)."""
        for w in h.pop("works"):
            w.wait()
        del h["send"]
        recv = h.pop("recv")
        if self.ring is not None and \
                self.topo.coords_local[self.R] >= self.ring[1]:
            return None
        if self.wire is None or self.wire16:
            return recv
        axis = h["axis"]
        return _wire.unpack_axis(recv, h["dtype"], self.wire, axis[0],
                                 axis[1])

    def unpack(self, recv, h: dict,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Received tiles -> the output block (or ``out``, a view of it);
        zeros where ``recv`` is ``None``."""
        recv = _take(recv)
        if recv is None:
            if out is None:
                shape = list(h["shape"][1:])
                shape[self.tile_a] = self.n_a
                return torch.zeros(shape, dtype=h["dtype"],
                                   device=self.topo.device)
            return out.zero_()
        if not self.wire16:
            return k1.unpack(recv, self.ident, self.tile_a, self.n_a,
                             out=out)
        bits = k1.unpack(recv, self.ident, self.tile_a, self.n_a)
        del recv
        if h["dtype"].is_complex:
            bits = bits.unsqueeze(-1)
        full = _wire.unpack_axis(bits.view(torch.int16), h["dtype"],
                                 self.wire)
        del bits
        if out is None:
            return full
        return out.copy_(full)


def _run_pipeline(n: int, produce, exchange: _Exchange, consume) -> None:
    """Software pipeline over ``n`` chunks: ``produce(k)`` gives chunk
    ``k``'s packed tiles; chunk ``k``'s exchange is waited for after
    chunk ``k + 1``'s pack and ``consume(k, handle, received)`` runs after
    chunk ``k + 1``'s exchange was issued, so on the card NCCL moves chunk
    ``k`` while the compute stream packs ``k + 1``, and ``k + 1`` while it
    unpacks ``k``.  Waiting before the next issue drops chunk ``k``'s send
    buffer first (NCCL runs one group's calls in order anyway).  Every
    rank issues the exchanges in chunk order."""
    pending = None
    for k in range(n):
        tiles = produce(k)
        received = (None if pending is None
                    else exchange.finish(pending[1]))
        handle = exchange.start([tiles])
        del tiles
        if pending is not None:
            consume(pending[0], pending[1], received)
            del received
        pending = (k, handle)
    if pending is not None:
        consume(pending[0], pending[1], exchange.finish(pending[1]))


def _exchange_transpose(data, pin: Pencil, pout: Pencil, R: int,
                        extra_ndims: int,
                        method: AbstractTransposeMethod) -> torch.Tensor:
    """One exchange hop of ``data`` (a tensor, or ``[tensor]`` to let the
    hop free it): whole, or in a ``Pipelined`` method's chunks."""
    base = method.base if isinstance(method, Pipelined) else method
    ex = _Exchange(pin, pout, extra_ndims, base)
    extra = tuple((data[0] if isinstance(data, list) else data)
                  .shape[pin.ndims:])
    bounds, c = None, None
    if isinstance(method, Pipelined):
        a, b = pin.decomposition[R], pout.decomposition[R]
        shape = _exchange_operand_extents(pin, pout, R) + extra
        c = _pipeline_chunk_axis(shape, a, b)
        if c is not None:
            bounds = _chunk_bounds(shape[c], method.chunks)
    if bounds is None or len(bounds) == 1:
        # the input goes once packed (on a 16-bit wire, once cast), and
        # the received tiles once unpacked, so the input, the tiles and
        # the receive buffer never coexist
        h = ex.start([ex.pack(data)])
        return ex.unpack([ex.finish(h)], h)
    src = [_take(data)]
    del data
    mi, mo = ex.fwd_in.index(c), ex.fwd_out.index(c)
    out = []

    def produce(k):
        s0, s1 = bounds[k]
        tiles = ex.pack(src[0].narrow(mi, s0, s1 - s0))
        if k == len(bounds) - 1:
            src.clear()  # the input goes after the last chunk's pack
        return tiles

    def consume(k, h, recv):
        if not out:     # allocated at the first unpack
            out.append(torch.empty(
                pout.padded_size_local(MemoryOrder) + extra,
                dtype=ex.dtype, device=ex.topo.device))
        s0, s1 = bounds[k]
        ex.unpack(recv, h, out=out[0].narrow(mo, s0, s1 - s0))

    _run_pipeline(len(bounds), produce, ex, consume)
    return out[0]


# -- the unrestricted exchange (Gspmd) --------------------------------------


def _blocks(pen: Pencil):
    """Every rank's true (unpadded) logical block ranges, rank order."""
    topo = pen.topology
    return [pen.range_local(topo.coords(r)) for r in range(len(topo))]


def _intersect(r1, r2) -> Optional[Tuple[range, ...]]:
    out = []
    for x, y in zip(r1, r2):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if hi <= lo:
            return None
        out.append(range(lo, hi))
    return tuple(out)


def _gspmd_plan(pin: Pencil, pout: Pencil):
    """``cross[r][s]``: the logical ranges rank ``r`` sends rank ``s``
    (``None`` where the blocks do not meet)."""
    src, dst = _blocks(pin), _blocks(pout)
    return [[_intersect(a, b) for b in dst] for a in src]


def _numel(ranges) -> int:
    return 0 if ranges is None else math.prod(len(r) for r in ranges)


def gspmd_reshard_cost(pin: Pencil, pout: Pencil,
                       extra_dims: Tuple[int, ...] = (), dtype=None) -> dict:
    """Per-rank collective cost of the :class:`Gspmd` exchange
    ``pin -> pout`` (any number of differing slots), in the
    :func:`transpose_cost` schema: one ``all-to-all`` carrying the
    largest send buffer of any rank, so that every rank prices it alike
    (the JAX package measures its partitioner's HLO instead).  ``{}``
    where no element changes ranks."""
    if pin.topology != pout.topology:
        raise ValueError("gspmd_reshard_cost: pencil topologies differ")
    if pin.size_global() != pout.size_global():
        raise ValueError("gspmd_reshard_cost: global shapes differ")
    cross = _gspmd_plan(pin, pout)
    if all(_numel(row[s]) == 0 for r, row in enumerate(cross)
           for s in range(len(row)) if s != r):
        return {}
    per_elem = math.prod(int(e) for e in extra_dims) * _itemsize(dtype)
    nbytes = max(sum(_numel(x) for x in row) for row in cross) * per_elem
    return {"all-to-all": {"count": 1, "bytes": nbytes}}


def _gspmd_exchange(data, pin: Pencil, pout: Pencil,
                    extra_ndims: int) -> torch.Tensor:
    """The :class:`Gspmd` exchange on this rank: K1 packs each destination's
    piece of the block, in the destination's memory order, into one send
    buffer; one ``all_to_all_single`` with per-peer split sizes moves the
    bytes; K1 writes each received piece into its place in the output,
    whose padding is zero."""
    data = _take(data)
    topo = pin.topology
    fwd_out = _fwd_axes(pout, extra_ndims)
    in_to_logical = _inv_axes(pin, extra_ndims)
    axes = tuple(in_to_logical[i] for i in fwd_out)
    extra = tuple(data.shape[pin.ndims:])
    if len(topo) == 1:
        return k1.permute(data, axes)
    cross = _gspmd_plan(pin, pout)
    me = topo.rank_local
    my_in = pin.range_local()
    my_out = pout.range_local()

    def mem_view(t, pen, ranges, origin):
        # the logical ranges of a block, as a view of its memory order
        perm = _fwd_axes(pen, extra_ndims)
        for m, d in enumerate(perm[:pen.ndims]):
            t = t.narrow(m, ranges[d].start - origin[d].start,
                         len(ranges[d]))
        return t

    def out_shape(ranges):
        logical = tuple(len(r) for r in ranges) + extra
        return tuple(logical[d] for d in fwd_out)

    out = data.new_zeros(pout.padded_size_local(MemoryOrder) + extra)
    local_only = all(_numel(row[s]) == 0 for r, row in enumerate(cross)
                     for s in range(len(row)) if s != r)
    if local_only or not topo.connected:
        piece = cross[me][me]
        if piece is not None:
            k1.permute(mem_view(data, pin, piece, my_in), axes,
                       out=mem_view(out, pout, piece, my_out))
        return out
    sizes_out = [_numel(cross[me][s]) for s in range(len(topo))]
    sizes_in = [_numel(cross[r][me]) for r in range(len(topo))]
    esize = math.prod(extra) * data.element_size()
    send = torch.empty(sum(sizes_out) * math.prod(extra), dtype=data.dtype,
                       device=data.device)
    off = 0
    for s, piece in enumerate(cross[me]):
        if piece is None:
            continue
        n = _numel(piece) * math.prod(extra)
        k1.permute(mem_view(data, pin, piece, my_in), axes,
                   out=send[off:off + n].view(out_shape(piece)))
        off += n
    del data
    recv = torch.empty(sum(sizes_in) * math.prod(extra), dtype=send.dtype,
                       device=send.device)
    src8, dst8 = send.view(torch.uint8), recv.view(torch.uint8)
    dist.all_to_all_single(dst8, src8,
                           output_split_sizes=[n * esize for n in sizes_in],
                           input_split_sizes=[n * esize for n in sizes_out],
                           group=topo.group)
    _count("all-to-all", src8.numel(), True, group=topo.group,
           shape=send.shape, dtype=send.dtype, buffer=send)
    del send, src8
    ident = tuple(range(out.dim()))
    off = 0
    for r in range(len(topo)):
        piece = cross[r][me]
        if piece is None:
            continue
        n = _numel(piece) * math.prod(extra)
        k1.permute(recv[off:off + n].view(out_shape(piece)), ident,
                   out=mem_view(out, pout, piece, my_out))
        off += n
    return out


def _hop(data, pin: Pencil, pout: Pencil, extra_ndims: int,
         method: AbstractTransposeMethod) -> torch.Tensor:
    if isinstance(method, Gspmd):
        return _gspmd_exchange(data, pin, pout, extra_ndims)
    R = assert_compatible(pin, pout)
    if R is None:
        return _transpose_local(_take(data), pin, pout, extra_ndims)
    return _exchange_transpose(data, pin, pout, R, extra_ndims, method)


class _Hop(torch.autograd.Function):
    """One hop with the inverse hop, by the same method, as its backward
    (the exact adjoint: both are pack -> exchange -> unpack, and each
    drops the padding the other zero-fills).  The backward is itself
    differentiable (``create_graph=True``), so a double backward gives
    the hop's JVP: the hop applied to the tangent."""

    @staticmethod
    def forward(ctx, data, pin, pout, extra_ndims, method):
        ctx.hop = (pout, pin, extra_ndims, method)
        return _hop(data, pin, pout, extra_ndims, method)

    @staticmethod
    def backward(ctx, grad):
        return (_dispatch(grad.contiguous(), *ctx.hop), None, None, None,
                None)


def _no_wired_grad(method) -> None:
    if _method_wire(method) is not None:
        raise RuntimeError(
            f"a hop by {_method_label(method)} has no gradient: the wire "
            f"moves integer bit patterns, and the JAX package's gradient "
            f"through them is zero; differentiate a full-precision hop")


def hop_fault(**ctx) -> Optional[str]:
    """The ``hop.exchange`` fault point of the JAX package: consulted once
    per ``transpose``, per routed ``reshard`` and per Gspmd ``reshard``,
    only where ``faults.armed("hop.exchange")`` (so an unarmed hop pays
    one cached check).  ``error`` raises, ``delay`` stalls, ``kill`` (and
    ``torn``, which a hop cannot tear) kills; returns ``"corrupt"`` for
    the caller to poke the hop's output (``guard/integrity.py``)."""
    act = faults.fire("hop.exchange", **ctx)
    if act == "torn":
        faults.kill_now()
    return act


def _dispatch(data: torch.Tensor, pin: Pencil, pout: Pencil, nx: int,
              method: AbstractTransposeMethod) -> torch.Tensor:
    if data.requires_grad and torch.is_grad_enabled():
        _no_wired_grad(method)
        return _Hop.apply(data, pin, pout, nx, method)
    return _hop(data, pin, pout, nx, method)


# ---------------------------------------------------------------------------
# observability taps and the guarded hop
# ---------------------------------------------------------------------------


@lru_cache(maxsize=512)
def _cached_hop_cost(pin: Pencil, pout: Pencil, extra_dims: tuple,
                     dtype: torch.dtype,
                     method: AbstractTransposeMethod) -> dict:
    """:func:`transpose_cost` cached per configuration, so an observed
    dispatch never prices a hop twice."""
    return transpose_cost(pin, pout, extra_dims, dtype, method)


def _obs_record_hop(pin: Pencil, pout: Pencil, R, method:
                    AbstractTransposeMethod, extra_dims: tuple, dtype,
                    dispatch_s: float, fused_k: int = 0) -> None:
    """Journal and meter one dispatched hop (observability on only), as
    the JAX package's tap does.  ``fused_k > 0`` marks a pipelined hop
    fused with its transform stage (``ops/fft.py``): its time includes
    the stage, so its drift key carries a ``fused(K=..)`` suffix."""
    label = _method_label(method)
    chunks = fused_k or (method.chunks if isinstance(method, Pipelined)
                         else 1)
    try:
        cost = (_cached_hop_cost(pin, pout, tuple(extra_dims),
                                 as_torch_dtype(dtype), method)
                if R is not None else {})
    except (TypeError, ValueError):
        cost = {}
    nbytes = sum(v["bytes"] for v in cost.values())
    hop = _hop_label(pin, pout, method, dtype)
    if fused_k:
        hop += f" fused(K={fused_k})"
    obs.counter("transpose.dispatches", method=label).inc()
    obs.counter("transpose.predicted_bytes").inc(nbytes)
    obs.histogram("transpose.dispatch_seconds", method=label).observe(
        dispatch_s)
    # the host time of the call: free, a lower bound on the card; local
    # permutes (no bytes) are recorded too, for the straggler detector
    obs.record_hop_sample(hop, nbytes, dispatch_s, source="dispatch")
    obs.record_event(
        "hop", method=label, hop=hop, r=R, chunks=chunks,
        fused=bool(fused_k), predicted_bytes=nbytes, predicted=cost,
        dispatch_s=dispatch_s,
        shape=list(pin.size_global()), topo=list(pin.topology.dims))


def _probe_group(topology: Topology):
    """The group a probe pair is summed over: every rank of the topology
    (each rank probes its own block; the invariant holds for the global
    array, as the JAX package's probe sees it)."""
    return topology.group if topology.connected else None


def _dispatch_guarded_hop(pin: Pencil, pout: Pencil, R, method:
                          AbstractTransposeMethod, data, extra_dims: tuple,
                          corrupt_hit: Optional[int] = None
                          ) -> torch.Tensor:
    """One hop through the guard: an invariant probe of the input before
    the hop (before K1's pack), the unguarded hop itself, a probe of the
    output after it (after K1's unpack), both summed over the topology's
    ranks and fetched to the host, and the host-side check (raising
    :class:`~pencilarrays_tpu_torch.guard.IntegrityError` on mismatch),
    all under the hang watchdog: the fetch waits for the card, so a
    hung kernel or exchange parks there, inside the armed deadline.
    ``data`` is a tensor, or ``[tensor]`` for the hop to take out of the
    list once packed.  ``corrupt_hit`` is the drill: the hop's output is
    poked (the JAX package's element) between the hop and the second
    probe."""
    from ..guard import integrity as gi

    x = data[0] if isinstance(data, list) else data
    dtype, ptr = x.dtype, x.data_ptr()
    finite = guard.finite_tick()
    hop = _hop_label(pin, pout, method, dtype)
    count = x.numel() * len(pin.topology)
    with guard.watchdog(f"hop:{_method_label(method)}", kind="hop",
                        hop=hop):
        pre = gi.probe_stats(x, finite)
        del x
        out = _plain_hop(data, pin, pout, len(extra_dims), method)
        if corrupt_hit is not None:
            out = _poke(out, ptr, pout, extra_dims, corrupt_hit)
        post = gi.probe_stats(out, finite)
        pre_h, post_h = gi.reduce_probes([pre, post], dtype,
                                         _probe_group(pin.topology))
        gi.check_hop_probes(hop, pre_h, post_h, count, dtype,
                            finite=finite, wire_dtype=_method_wire(method),
                            ctx={"r": R, "method": _method_label(method)})
    return out


def _poke(out: torch.Tensor, ptr: int, pout: Pencil, extra_dims: tuple,
          hit: int) -> torch.Tensor:
    """The ``corrupt`` drill's poke of a hop's output for fault hit
    ``hit`` (the JAX package's element of the global array), on a copy
    where the hop moved nothing and returned its input (``ptr``)."""
    from ..guard import integrity as gi

    if out.data_ptr() == ptr:
        out = out.clone()
    gi.corrupt_array(pout, out, extra_dims, max(0, hit - 1))
    return out


def _plain_hop(data, pin: Pencil, pout: Pencil, nx: int,
               method: AbstractTransposeMethod) -> torch.Tensor:
    """The unguarded hop: ``[tensor]`` gives the tensor up to the hop,
    a tensor goes through :func:`_dispatch` (autograd included)."""
    if isinstance(data, list):
        return _hop(data, pin, pout, nx, method)
    return _dispatch(data, pin, pout, nx, method)


def _run_hop(pin: Pencil, dest: Pencil, R, method:
             AbstractTransposeMethod, data, extra_dims: tuple,
             ctx: dict) -> torch.Tensor:
    """The eager dispatch of one hop, as the JAX package's ``transpose``
    and Gspmd ``reshard`` make it: the clock (observability on) starts
    before the ``hop.exchange`` fault point, so an injected delay is part
    of the measured dispatch; then the guarded hop, or the plain one
    (where a ``corrupt`` drill's poke flows through undetected).
    ``data`` as in :func:`_dispatch_guarded_hop`."""
    x = data[0] if isinstance(data, list) else data
    dtype, ptr = x.dtype, x.data_ptr()
    del x
    t0 = time.perf_counter() if obs.enabled() else None
    act = hop_fault(**ctx) if faults.armed("hop.exchange") else None
    hit = faults.hit_count("hop.exchange") if act == "corrupt" else None
    if guard.enabled():
        out = _dispatch_guarded_hop(pin, dest, R, method, data, extra_dims,
                                    corrupt_hit=hit)
    else:
        out = _plain_hop(data, pin, dest, len(extra_dims), method)
        if hit is not None:
            out = _poke(out, ptr, dest, extra_dims, hit)
    if t0 is not None:
        _obs_record_hop(pin, dest, R, method, extra_dims, dtype,
                        time.perf_counter() - t0)
    return out


def transpose(src: PencilArray, dest: Pencil, *,
              method: AbstractTransposeMethod = AllToAll()) -> PencilArray:
    """Redistribute ``src`` into the ``dest`` pencil configuration
    (reference ``transpose!``, ``Transpositions.jl:161-180``).  Every rank
    of the topology calls it; returns a new array.  ``method`` is
    ``AllToAll()``, ``Ring()``, ``Pipelined(...)``, ``Auto()`` or
    ``Gspmd()``; all move the same bits, and a wired method moves them
    through its wire format.  Differentiable without a wire: the gradient
    runs the inverse hop (every rank must then call backward)."""
    pin = src.pencil
    if isinstance(method, Gspmd):
        if pin.topology != dest.topology:
            raise ValueError("transpose: pencil topologies differ")
        if pin.size_global() != dest.size_global():
            raise ValueError("transpose: global shapes differ")
        # any pair of pencils: the slot where one differs, else "gspmd"
        diff = [i for i, (a, b) in enumerate(zip(pin.decomposition,
                                                 dest.decomposition))
                if a != b]
        R = diff[0] if len(diff) == 1 else (None if not diff else "gspmd")
    else:
        R = assert_compatible(pin, dest)
    if isinstance(method, Auto):
        method = resolve_method(pin, dest, src.extra_dims, src.dtype, method)
    if not isinstance(method, (AllToAll, Ring, Pipelined, Gspmd)):
        raise TypeError(f"unknown transpose method {method!r}")
    out = _run_hop(pin, dest, R, method, src.data, src.extra_dims,
                   {"r": R, "method": _method_label(method)})
    return PencilArray(dest, out, src.extra_dims)


def reshard(src: PencilArray, dest: Pencil, *,
            method: AbstractTransposeMethod = Auto(),
            donate: bool = False,
            hbm_limit: Optional[int] = None) -> PencilArray:
    """Redistribute between *any* two pencils sharing a topology and
    global shape (the JAX package's unrestricted ``reshard``).

    By default the route planner (``parallel/routing.py``) searches for a
    chain of single-slot hops its cost model prices below the one
    :class:`Gspmd` exchange and runs it hop by hop, freeing each
    intermediate as the next hop packs it; else the Gspmd exchange runs.
    ``method=Gspmd()`` forces that exchange; an explicit exchange method
    (``AllToAll()``, ``Ring()``, ``Pipelined(...)``, wired or not)
    forces the routed path with that method on every hop.  Every path
    moves the same bits (through the wire format where one is asked for).

    ``donate=True`` gives up ``src``'s storage (``src.is_deleted()``
    afterwards), which the planner counts when it bounds the peak.
    ``hbm_limit`` bounds every hop's per-rank peak: over-budget hops are
    time-sliced into ``Pipelined`` chunks, and where no admissible route
    exists :class:`~pencilarrays_tpu_torch.analysis.errors.HbmBoundError`
    is raised instead of running the unbounded Gspmd exchange."""
    from .routing import (_obs_record_route_plan, execute_route,
                          plan_reshard_route)

    pin = src.pencil
    if pin.topology != dest.topology:
        raise ValueError("reshard: pencil topologies differ")
    if pin.size_global() != dest.size_global():
        raise ValueError("reshard: global shapes differ")
    if hbm_limit is not None and isinstance(method, Gspmd):
        raise ValueError(
            "reshard(hbm_limit=) cannot bound method=Gspmd(): its peak is "
            "not modeled; use Auto() or an explicit exchange method")
    if pin == dest:
        return src
    if not isinstance(method, Gspmd):
        route = plan_reshard_route(pin, dest, src.extra_dims, src.dtype,
                                   method=method, hbm_limit=hbm_limit,
                                   donate=donate)
        if obs.enabled():
            _obs_record_route_plan(route, src.extra_dims, src.dtype)
        if route.use_route:
            if obs.enabled():
                obs.counter("reshard.dispatches", path="routed").inc()
            return execute_route(src, route, donate=donate)
        if hbm_limit is not None:
            from ..analysis.errors import HbmBoundError

            unbounded = plan_reshard_route(pin, dest, src.extra_dims,
                                           src.dtype, method=method,
                                           donate=donate)
            raise HbmBoundError(
                "reshard", f"{pin.decomposition}->{dest.decomposition}",
                unbounded.peak_hbm_bytes or 0, int(hbm_limit))
    if obs.enabled():
        obs.counter("reshard.dispatches", path="gspmd").inc()
    ctx = {"kind": "reshard-gspmd"}
    if donate and not (src.data.requires_grad and torch.is_grad_enabled()):
        held = [src.data]
        src._donate()
        out = _run_hop(pin, dest, "gspmd", Gspmd(), held, src.extra_dims,
                       ctx)
    else:
        out = _run_hop(pin, dest, "gspmd", Gspmd(), src.data,
                       src.extra_dims, ctx)
        if donate:
            src._donate()
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
    me_global = topology.global_rank(topology.rank_local)
    for t in tensors:
        send = t.contiguous().reshape(-1).view(torch.uint8)
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        outs.append(recv.view(t.dtype).reshape(t.shape))
        _collectives.note("collective-permute", send.numel(),
                          shape=t.shape, dtype=t.dtype, async_start=True,
                          pair=(me_global, dst))
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
