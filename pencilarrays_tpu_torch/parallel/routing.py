"""Cost-driven reshard route planner — searched single-axis hop chains.

PyTorch counterpart of the JAX package's ``parallel/routing.py``; the
planner is the JAX package's, so a route is JAX's route:

* **nodes** — every valid decomposition assignment on the topology:
  ordered tuples ``(d_0, ..., d_{M-1})`` of distinct logical dims, slot
  ``i`` riding topology axis ``i``;
* **edges** — single-slot hops (what :func:`~.transpositions.transpose`
  runs), priced by :func:`~.transpositions.transpose_cost` in the
  bytes-equivalent score of ``Auto`` (``count * latency_bytes + bytes``,
  plus the wire's cast toll);
* **search** — Dijkstra from ``src.decomposition`` to
  ``dest.decomposition`` under an optional per-hop peak-memory bound
  (``hbm_limit``): an edge over the bound is first time-sliced into the
  smallest fitting ``Pipelined(chunks=K)`` (:func:`_synthesize_chunked`),
  and pruned only when no chunking fits.  A caller that donates its
  source is not charged the resident source on every edge;
* **baseline** — the :class:`~.transpositions.Gspmd` exchange, priced by
  :func:`~.transpositions.gspmd_reshard_cost`.  Under ``Auto`` the route
  runs only where it scores below that; an explicit method forces the
  route, and a bounded plan never falls back (the Gspmd peak is not
  modeled).

The JAX package prices its baseline from the partitioner's compiled HLO;
the port prices its own exchange analytically, from the two pencils alone
(the largest per-rank send), so every rank plans the same route.  Where
the two baselines differ, so may the verdicts, never the routes.

The JAX package corrects edge prices by its drift tracker's timings
(``obs/``), except across processes, where the plan must be a pure
function of the static configuration on every process.  The port runs
one process per device and has no drift tracker, so its plan is always
that pure function: :func:`trusted_drift_hops` returns ``{}``.

:func:`execute_route` runs the hops one after another (the JAX package
traces them into one jitted program), each hop taking its input out of
the chain so that an intermediate is freed once the next hop has packed
it.  A run of unwired hops that cross no rank (over a size-1 topology
axis, where the JAX package's program holds no collective, and XLA owns
the intermediates) runs as one K1 permute.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import warnings
from dataclasses import dataclass, replace
from functools import lru_cache
from itertools import permutations as _iperms
from typing import Dict, Optional, Tuple

import torch

from ..resilience import faults
from . import wire as _wire
from .arrays import PencilArray, as_torch_dtype
from .pencil import Pencil
from .transpositions import (
    AbstractTransposeMethod,
    AllToAll,
    Auto,
    Gspmd,
    Pipelined,
    Ring,
    _chunk_bounds,
    _dispatch,
    _dtype_name,
    _exchange_operand_extents,
    _hop,
    _method_label,
    _method_wire,
    _pipeline_chunk_axis,
    _take,
    _transpose_local,
    assert_compatible,
    gspmd_reshard_cost,
    hop_fault,
    resolve_method,
    transpose_cost,
)

__all__ = [
    "ReshardRoute",
    "RouteHop",
    "execute_route",
    "plan_fingerprint",
    "plan_reshard_route",
    "reshard_key",
    "trusted_drift_hops",
]


def plan_fingerprint(summary) -> str:
    """12 hex characters of the sha256 of a summary's sorted JSON (the
    JAX package's ``obs.correlate.plan_fingerprint``)."""
    try:
        blob = json.dumps(summary, sort_keys=True, default=str)
    except (TypeError, ValueError):
        blob = repr(summary)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def reshard_key(pin: Pencil, dest: Pencil, dtype=None, method=None,
                extra_dims: Tuple[int, ...] = ()) -> str:
    """Stable fingerprint of one reshard configuration: global shape,
    topology, both decompositions and memory orders, dtype, method and
    extra dims — the same summary, so the same key, as the JAX
    package's."""
    summary = {
        "kind": "reshard",
        "shape": list(pin.size_global()),
        "topo": list(pin.topology.dims),
        "src": [list(pin.decomposition),
                list(pin.permutation.apply(tuple(range(pin.ndims))))],
        "dest": [list(dest.decomposition),
                 list(dest.permutation.apply(tuple(range(dest.ndims))))],
        "dtype": _dtype_name(dtype),
        "method": _method_label(method) if method is not None else "Auto",
        "extra_dims": list(extra_dims),
    }
    return plan_fingerprint(summary)


def trusted_drift_hops() -> Dict[str, dict]:
    """Measured drift per hop for cost-model correction: always ``{}``
    here, so edges are priced by the model alone.  The port has no drift tracker, and it runs one process per
    device, where the JAX package disables the correction anyway so that
    every process plans from the same static configuration."""
    return {}


@dataclass(frozen=True)
class RouteHop:
    """One edge of a planned route: a single-slot hop ``src -> dest`` by
    ``method``, its priced cost, its score and its charged per-rank peak
    device bytes."""

    src: Pencil
    dest: Pencil
    method: AbstractTransposeMethod
    cost: dict
    score_bytes: int
    peak_hbm_bytes: int


@dataclass(frozen=True)
class ReshardRoute:
    """A planning verdict: the best hop chain found (empty when none is
    admissible), the Gspmd baseline's price, and whether :func:`reshard`
    runs the route (``use_route``).  ``verdict`` is ``"routed"``,
    ``"routed:forced"`` (an explicit method), ``"routed:hbm"`` (a bounded
    plan), ``"gspmd"`` (the route is not cheaper), ``"gspmd:no-route"``
    or ``"gspmd:unpriced"``, as in the JAX package."""

    src: Pencil
    dest: Pencil
    hops: Tuple[RouteHop, ...]
    score_bytes: Optional[int]
    peak_hbm_bytes: Optional[int]
    gspmd_cost: Optional[dict]
    gspmd_score_bytes: Optional[int]
    use_route: bool
    verdict: str
    searched_nodes: int
    donate: bool = False
    hbm_limit: Optional[int] = None

    @property
    def pencils(self) -> Tuple[Pencil, ...]:
        """The configuration chain, ``src`` first, ``dest`` last."""
        return (self.src,) + tuple(h.dest for h in self.hops)


def _score(cost: dict, latency_bytes: int, dtype=None,
           wire_dtype: Optional[str] = None) -> int:
    """Bytes-equivalent score of one priced hop: ``latency_bytes`` per
    collective call, the bytes, and a wired hop's cast toll
    (:func:`~.wire.cast_score_bytes`)."""
    count = sum(v["count"] for v in cost.values())
    nbytes = sum(v["bytes"] for v in cost.values())
    return int(count * latency_bytes + nbytes
               + _wire.cast_score_bytes(nbytes, dtype, wire_dtype))


def _hop_peak_bytes(pin: Pencil, pout: Pencil, R: Optional[int],
                    extra_dims: Tuple[int, ...], dtype,
                    method: Optional[AbstractTransposeMethod] = None, *,
                    chunk_dim: Optional[int] = None,
                    bounds: Optional[Tuple[Tuple[int, int], ...]] = None
                    ) -> int:
    """Per-rank peak device bytes of one hop, the JAX package's model: an
    exchange charges one full-precision operand (the result plus the
    retiring input) and one packed chunk in flight (at the wire's
    bytes); a local permute its input and output blocks.  The port's
    eager hops can exceed it; ``PERF.md`` records by how much."""
    isize = _wire._kind_itemsize(dtype)[1]
    if R is None:
        return (pin.bytes_per_device(extra_dims, isize=isize)
                + pout.bytes_per_device(extra_dims, isize=isize))
    a, b = pin.decomposition[R], pout.decomposition[R]
    shape = tuple(_exchange_operand_extents(pin, pout, R)) + tuple(extra_dims)
    elems = 1
    for n in shape:
        elems *= int(n)
    if bounds is None and isinstance(method, Pipelined):
        chunk_dim = _pipeline_chunk_axis(shape, a, b)
        if chunk_dim is not None:
            bounds = _chunk_bounds(shape[chunk_dim], method.chunks)
    chunk_shape = shape
    if chunk_dim is not None and bounds is not None and len(bounds) > 1:
        widest = max(s1 - s0 for s0, s1 in bounds)
        chunk_shape = shape[:chunk_dim] + (widest,) + shape[chunk_dim + 1:]
    packed = _wire.wire_bytes(dtype, _method_wire(method), chunk_shape,
                              axes=(a, b))
    return elems * isize + packed


def _synthesize_chunked(psrc: Pencil, pdst: Pencil, R: int,
                        extra_dims: Tuple[int, ...], dtype,
                        m: AbstractTransposeMethod, budget: int):
    """The smallest ``Pipelined(chunks=K)`` variant of an over-budget hop
    (K doubling, then the chunk dim's full extent) whose footprint fits
    ``budget``: ``(method, peak)``, or ``(None, 0)``."""
    base = m.base if isinstance(m, Pipelined) else m
    shape = (tuple(_exchange_operand_extents(psrc, pdst, R))
             + tuple(extra_dims))
    c = _pipeline_chunk_axis(shape, psrc.decomposition[R],
                             pdst.decomposition[R])
    if c is None or budget <= 0:
        return None, 0
    n = int(shape[c])
    ks = []
    k = (m.chunks if isinstance(m, Pipelined) else 1) * 2
    while k < n:
        ks.append(k)
        k *= 2
    ks.append(n)
    for k in ks:
        if len(_chunk_bounds(n, k)) <= 1:
            continue
        cand = Pipelined(chunks=k, base=base)
        peak = _hop_peak_bytes(psrc, pdst, R, extra_dims, dtype, cand)
        if peak <= budget:
            return cand, peak
    return None, 0


def _node_pencil(node: Tuple[int, ...], pin: Pencil, dest: Pencil) -> Pencil:
    """A graph node as a pencil: the endpoints keep their own (memory
    order included), intermediates take the default memory order."""
    if node == dest.decomposition:
        return dest
    if node == pin.decomposition:
        return pin
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Pencil(pin.topology, pin.size_global(), node)


@lru_cache(maxsize=512)
def _plan_cached(pin: Pencil, dest: Pencil, extra_dims: Tuple[int, ...],
                 dtype: torch.dtype, method: AbstractTransposeMethod,
                 latency_bytes: int, hbm_limit: Optional[int],
                 donate: bool) -> ReshardRoute:
    N = pin.ndims
    M = pin.topology.ndims
    # a source the caller keeps stays resident under the whole chain
    pinned = 0 if donate else pin.bytes_per_device(extra_dims, dtype)

    def edge(psrc: Pencil, pdst: Pencil, first: bool = False):
        m = resolve_method(psrc, pdst, extra_dims, dtype, method)
        R = assert_compatible(psrc, pdst)
        surcharge = 0 if (first and R is None) else pinned
        peak = _hop_peak_bytes(psrc, pdst, R, extra_dims, dtype, m) \
            + surcharge
        if (hbm_limit is not None and peak > hbm_limit and R is not None
                and psrc.topology.dims[R] > 1
                and isinstance(m, (AllToAll, Ring, Pipelined))):
            m2, p2 = _synthesize_chunked(psrc, pdst, R, extra_dims, dtype,
                                         m, hbm_limit - surcharge)
            if m2 is not None:
                m, peak = m2, p2 + surcharge
        cost = transpose_cost(psrc, pdst, extra_dims, dtype, m)
        return RouteHop(psrc, pdst, m, cost,
                        _score(cost, latency_bytes, dtype, _method_wire(m)),
                        peak)

    hops: Tuple[RouteHop, ...] = ()
    searched = 0
    if pin.decomposition == dest.decomposition:
        hops = (edge(pin, dest, first=True),)
        searched = 1
    else:
        nodes = set(_iperms(range(N), M))
        start, goal = pin.decomposition, dest.decomposition
        best_score: Dict[tuple, int] = {start: 0}
        prev: Dict[tuple, Tuple[tuple, RouteHop]] = {}
        heap = [(0, start)]
        done = set()
        while heap:
            d, u = heapq.heappop(heap)
            if u in done:
                continue
            done.add(u)
            searched += 1
            if u == goal:
                break
            pu = _node_pencil(u, pin, dest)
            for slot in range(M):
                for nd in range(N):
                    v = u[:slot] + (nd,) + u[slot + 1:]
                    if nd == u[slot] or v not in nodes or v in done:
                        continue
                    h = edge(pu, _node_pencil(v, pin, dest),
                             first=u == start)
                    if hbm_limit is not None and h.peak_hbm_bytes > hbm_limit:
                        continue
                    nd_score = d + h.score_bytes
                    if nd_score < best_score.get(v, 2 ** 62):
                        best_score[v] = nd_score
                        prev[v] = (u, h)
                        heapq.heappush(heap, (nd_score, v))
        if goal in best_score:
            chain = []
            u = goal
            while u != start:
                u, h = prev[u]
                chain.append(h)
            hops = tuple(reversed(chain))

    if not hops or (hbm_limit is not None
                    and max(h.peak_hbm_bytes for h in hops) > hbm_limit):
        return ReshardRoute(pin, dest, (), None, None, None, None, False,
                            "gspmd:no-route", searched, donate, hbm_limit)
    score = sum(h.score_bytes for h in hops)
    peak = max(h.peak_hbm_bytes for h in hops)
    if hbm_limit is not None:
        return ReshardRoute(pin, dest, hops, score, peak, None, None, True,
                            "routed:hbm", searched, donate, hbm_limit)
    if not isinstance(method, Auto):
        return ReshardRoute(pin, dest, hops, score, peak, None, None, True,
                            "routed:forced", searched, donate, hbm_limit)
    gcost = gspmd_reshard_cost(pin, dest, extra_dims, dtype)
    gscore = _score(gcost, latency_bytes)
    use = score < gscore
    return ReshardRoute(pin, dest, hops, score, peak, gcost, gscore, use,
                        "routed" if use else "gspmd", searched, donate,
                        hbm_limit)


def plan_reshard_route(pin: Pencil, dest: Pencil,
                       extra_dims: Tuple[int, ...] = (), dtype=None, *,
                       method: AbstractTransposeMethod = Auto(),
                       hbm_limit: Optional[int] = None,
                       donate: bool = False) -> ReshardRoute:
    """Plan the redistribution ``pin -> dest``: the cheapest admissible
    single-slot hop chain and the :class:`Gspmd` baseline's price (see
    the module docstring).  ``method`` resolves each edge; ``hbm_limit``
    bounds each hop's charged peak (time-slicing over-budget hops);
    ``donate`` drops the resident-source charge."""
    if pin.topology != dest.topology:
        raise ValueError("plan_reshard_route: pencil topologies differ")
    if pin.size_global() != dest.size_global():
        raise ValueError("plan_reshard_route: global shapes differ")
    if isinstance(method, Gspmd):
        raise ValueError("plan_reshard_route prices Gspmd as the baseline; "
                         "pass an explicit exchange method or Auto()")
    if isinstance(method, Auto) and method.mode == "measure":
        method = replace(method, mode="estimate")
    latency = method.latency_bytes if isinstance(method, Auto) \
        else Auto().latency_bytes
    dt = as_torch_dtype(dtype if dtype is not None else torch.float32)
    return _plan_cached(pin, dest, tuple(int(e) for e in extra_dims), dt,
                        method, int(latency),
                        int(hbm_limit) if hbm_limit is not None else None,
                        bool(donate))


def execute_route(src: PencilArray, route: ReshardRoute, *,
                  donate: bool = False) -> PencilArray:
    """Run a planned route hop by hop.  ``donate=True`` gives up ``src``'s
    storage, freed once the first hop has packed it; every intermediate
    is freed the same way.  Differentiable through its hops when no hop
    carries a wire."""
    if src.pencil != route.src:
        raise ValueError(
            f"array lives on {src.pencil!r}, route starts at {route.src!r}")
    if not route.hops:
        raise ValueError("route has no hops (planner fell back to Gspmd)")
    if faults.armed("hop.exchange"):
        hop_fault(kind="route", hops=len(route.hops))
    nx = src.ndims_extra
    if src.data.requires_grad and torch.is_grad_enabled():
        data = src.data
        for h in route.hops:
            data = _dispatch(data, h.src, h.dest, nx, h.method)
        if donate:
            src._donate()
        return PencilArray(route.dest, data, src.extra_dims)
    held = [src.data]
    if donate:
        src._donate()
    for pin, pout, method in _stages(route):
        held = [_transpose_local(_take(held), pin, pout, nx)
                if method is None else _hop(held, pin, pout, nx, method)]
    return PencilArray(route.dest, held.pop(), src.extra_dims)


def _stages(route: ReshardRoute) -> list:
    """``(pin, pout, method)`` per step :func:`execute_route` runs: each
    run of unwired hops that cross no rank (a size-1 topology axis, or a
    memory order alone) becomes one local permute (``method`` None) from
    its first layout to its last, moving every element once; on such a
    run every block holds the same logical extents.  Other hops run as
    planned."""
    stages = []
    for h in route.hops:
        R = assert_compatible(h.src, h.dest)
        local = _method_wire(h.method) is None and (
            R is None or h.src.topology.dims[R] == 1)
        if local and stages and stages[-1][2] is None:
            stages[-1] = (stages[-1][0], h.dest, None)
        else:
            stages.append((h.src, h.dest, None if local else h.method))
    return stages
