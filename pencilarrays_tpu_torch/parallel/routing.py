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

Edge prices are corrected by the drift tracker's trusted timings
(``obs/drift.py``: ``benchtime`` and ``auto_measure`` samples, never
dispatch times), a hop measured at twice its modeled time having its
bytes doubled, as in the JAX package.  Across processes the plan must be
a pure function of the static configuration on every process, so the
JAX package drops the correction when ``jax.process_count() > 1``; the
port runs one process per device, so its rule is ``cluster.world_size()
> 1``, and drift steers plans only in a one-process world
(:func:`trusted_drift_hops`).  Cached plans are keyed on the tracker's
version, so a new trusted sample replans.

:func:`execute_route` runs the hops one after another (the JAX package
traces them into one jitted program), each hop taking its input out of
the chain so that an intermediate is freed once the next hop has packed
it.  A run of unwired hops that cross no rank (over a size-1 topology
axis, where the JAX package's program holds no collective, and XLA owns
the intermediates) runs as one K1 permute.  With the integrity guard or
observability on (the JAX package's rule), the route runs between
invariant probes: one before the first stage and one after each stage,
each compared with the first, under the hang watchdog.
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

from .. import guard, obs
from ..obs.drift import drift_tracker
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
    _hop_label,
    _method_label,
    _method_wire,
    _pipeline_chunk_axis,
    _probe_group,
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
    "trusted_drift",
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


def _drift_allowed() -> bool:
    """Drift steers plans only in a one-process world: every process of
    a job must plan the same collectives from the same static inputs
    (the JAX package's ``process_count() > 1`` rule; the port runs one
    process per device)."""
    from .. import cluster

    return cluster.world_size() <= 1


def trusted_drift_hops() -> Dict[str, dict]:
    """The drift tracker's per-hop report, for cost-model correction, or
    ``{}`` when no trusted sample exists yet or the world has more than
    one process.  Shared by the route planner and the FFT planner's
    slab/pencil verdict (``ops/fft.py``), so the two pricers agree on
    which measurements steer plans."""
    if not _drift_allowed() or not drift_tracker.version():
        return {}
    return drift_tracker.report()["hops"]


def trusted_drift(drift_hops: Dict[str, dict], label: str) -> float:
    """Observed drift ratio of one hop (1.0 when unmeasured), from
    trusted samples only: dispatch times are lower bounds and must not
    flip planning decisions."""
    e = drift_hops.get(label)
    if e and e.get("drift") and e.get("source") != "dispatch":
        return float(e["drift"])
    return 1.0


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


def _score(cost: dict, latency_bytes: int, drift: float = 1.0, dtype=None,
           wire_dtype: Optional[str] = None) -> int:
    """Bytes-equivalent score of one priced hop: ``latency_bytes`` per
    collective call, the bytes scaled by the hop's drift ratio, and a
    wired hop's cast toll (:func:`~.wire.cast_score_bytes`)."""
    count = sum(v["count"] for v in cost.values())
    nbytes = sum(v["bytes"] for v in cost.values())
    return int(count * latency_bytes + nbytes * drift
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
                 donate: bool, _drift_v: int) -> ReshardRoute:
    """The search, cached per configuration.  ``_drift_v`` is the drift
    tracker's version (0: no drift): a new trusted sample replans."""
    return _plan(pin, dest, extra_dims, dtype, method, latency_bytes,
                 hbm_limit, donate,
                 drift_tracker.report()["hops"] if _drift_v else {})


def _plan(pin: Pencil, dest: Pencil, extra_dims: Tuple[int, ...],
          dtype: torch.dtype, method: AbstractTransposeMethod,
          latency_bytes: int, hbm_limit: Optional[int], donate: bool,
          drift_hops: Dict[str, dict]) -> ReshardRoute:
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
        drift = trusted_drift(drift_hops, _hop_label(psrc, pdst, m, dtype))
        return RouteHop(psrc, pdst, m, cost,
                        _score(cost, latency_bytes, drift, dtype,
                               _method_wire(m)),
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
                       donate: bool = False,
                       _drift: Optional[Dict[str, dict]] = None
                       ) -> ReshardRoute:
    """Plan the redistribution ``pin -> dest``: the cheapest admissible
    single-slot hop chain and the :class:`Gspmd` baseline's price (see
    the module docstring).  ``method`` resolves each edge; ``hbm_limit``
    bounds each hop's charged peak (time-slicing over-budget hops);
    ``donate`` drops the resident-source charge.  ``_drift`` (private)
    prices the edges by the given drift report's hops instead of the
    tracker's, uncached: the parity tests hold the steering to the JAX
    package's with it."""
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
    args = (pin, dest, tuple(int(e) for e in extra_dims), dt, method,
            int(latency), int(hbm_limit) if hbm_limit is not None else None,
            bool(donate))
    if _drift is not None:
        return _plan(*args, _drift)
    return _plan_cached(*args, drift_tracker.version()
                        if _drift_allowed() else 0)


def execute_route(src: PencilArray, route: ReshardRoute, *,
                  donate: bool = False) -> PencilArray:
    """Run a planned route hop by hop.  ``donate=True`` gives up ``src``'s
    storage, freed once the first hop has packed it; every intermediate
    is freed the same way.  Differentiable through its hops when no hop
    carries a wire.  With the integrity guard or observability on, the
    stages run between invariant probes (:func:`_run_stages`)."""
    if src.pencil != route.src:
        raise ValueError(
            f"array lives on {src.pencil!r}, route starts at {route.src!r}")
    if not route.hops:
        raise ValueError("route has no hops (planner fell back to Gspmd)")
    # the drill point fires for every routed dispatch, guard on or off,
    # so the hit counter addresses the same dispatches either way
    act = (hop_fault(kind="route", hops=len(route.hops))
           if faults.armed("hop.exchange") else None)
    hit = faults.hit_count("hop.exchange") if act == "corrupt" else None
    probed = obs.enabled() or guard.enabled()
    if probed:
        # one summary feeds both digests: the journal's plan_fp is a
        # prefix of the crash bundle's schedule_sha256
        summary = {
            "route": [list(h.dest.decomposition) for h in route.hops],
            "methods": [_method_label(h.method) for h in route.hops],
            "verdict": route.verdict,
            "shape": list(route.src.size_global()),
            "topo": list(route.src.topology.dims)}
        if obs.enabled():
            from ..obs import correlate

            correlate.set_plan(correlate.plan_fingerprint(summary))
        if guard.enabled():
            guard.note_plan("reshard_route", summary)
    nx = src.ndims_extra
    grad = src.data.requires_grad and torch.is_grad_enabled()
    stages = ([(h.src, h.dest, h.method) for h in route.hops] if grad
              else _stages(route))
    held = [src.data]
    if donate:
        src._donate()
    out = _run_stages(held, route, stages, nx, src.extra_dims, grad,
                      probed, hit)
    return PencilArray(route.dest, out, src.extra_dims)


def _run_stages(held: list, route: ReshardRoute, stages: list, nx: int,
                extra_dims: tuple, grad: bool, probed: bool,
                corrupt_hit: Optional[int]) -> torch.Tensor:
    """Run ``stages`` on the tensor in ``held`` (taken out of the list by
    the first stage, so a donated source is freed once packed).  With
    ``probed``, an invariant probe before the first stage and one after
    each stage, each compared with the first on the host (the JAX
    package compares every hop's probe with the source's), under the
    hang watchdog; a wired stage widens the tolerance from there on.
    ``corrupt_hit`` pokes the first stage's output (the drill)."""
    from ..guard import integrity as gi

    def step(pin, pout, method, data):
        if method is None:
            return _transpose_local(_take(data), pin, pout, nx)
        if grad:
            return _dispatch(_take(data), pin, pout, nx, method)
        return _hop(data, pin, pout, nx, method)

    def poke(k, out):
        if k == 0 and corrupt_hit is not None:
            gi.corrupt_array(stages[0][1], out, extra_dims,
                             max(0, corrupt_hit - 1))

    if not probed:
        for k, (pin, pout, method) in enumerate(stages):
            held = [step(pin, pout, method, held)]
            poke(k, held[0])
        return held.pop()
    finite = guard.finite_tick()
    x = held[0]
    dtype = x.dtype
    count = x.numel() * len(route.src.topology)
    group = _probe_group(route.src.topology)
    with guard.watchdog("route", kind="route", hops=len(route.hops)):
        probes = [gi.probe_stats(x, finite)]
        del x
        for k, (pin, pout, method) in enumerate(stages):
            held = [step(pin, pout, method, held)]
            poke(k, held[0])
            probes.append(gi.probe_stats(held[0], finite))
        host = gi.reduce_probes(probes, dtype, group)
        wired, wire_hops = None, 0
        for k, ((pin, pout, method), last) in enumerate(
                zip(stages, _last_hops(route, stages))):
            hop_wire = _method_wire(method) if method is not None else None
            if hop_wire is not None:
                # mixed-wire chains are bound by the coarsest format seen
                wired = ("bf16" if "bf16" in (wired, hop_wire)
                         else hop_wire)
                wire_hops += 1
            h = route.hops[last]
            gi.check_hop_probes(
                f"route[{last}] {_hop_label(h.src, h.dest, h.method, dtype)}",
                host[0], host[k + 1], count, dtype, finite=finite,
                wire_dtype=wired, wire_hops=wire_hops,
                ctx={"hop_index": last, "hops": len(route.hops)})
    return held.pop()


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


def _last_hops(route: ReshardRoute, stages: list) -> list:
    """The index in ``route.hops`` of each stage's last hop (a stage ends
    where its hop lands; a route visits no layout twice)."""
    dests = [h.dest for h in route.hops]
    out, k = [], 0
    for _, pout, _ in stages:
        k = dests.index(pout, k)
        out.append(k)
        k += 1
    return out


# ---------------------------------------------------------------------------
# observability tap
# ---------------------------------------------------------------------------


_ROUTE_LOGGED: set = set()


def _obs_record_route_plan(route: ReshardRoute, extra_dims: tuple,
                           dtype) -> None:
    """Journal one planning verdict per (obs run, configuration), the
    ``route.plan`` event: every candidate with its predicted bytes and
    score, and which one :func:`~.transpositions.reshard` runs."""
    dt = _dtype_name(dtype)
    config = (f"{route.src.size_global()}@{route.src.topology.dims} "
              f"{route.src.decomposition}->{route.dest.decomposition} "
              f"{dt} extra={tuple(extra_dims)}"
              + (f" hbm={route.hbm_limit} donate={route.donate}"
                 if route.hbm_limit is not None else ""))
    key = (obs.run_id(), config)
    if key in _ROUTE_LOGGED:
        return
    _ROUTE_LOGGED.add(key)
    candidates = []
    if route.hops:
        candidates.append({
            "kind": "routed",
            "route": [list(h.dest.decomposition) for h in route.hops],
            "methods": [_method_label(h.method) for h in route.hops],
            "chunks": [h.method.chunks
                       if isinstance(h.method, Pipelined) else 1
                       for h in route.hops],
            "hop_peak_hbm_bytes": [h.peak_hbm_bytes for h in route.hops],
            "predicted_bytes": sum(
                v["bytes"] for h in route.hops for v in h.cost.values()),
            "score_bytes": route.score_bytes,
            "peak_hbm_bytes": route.peak_hbm_bytes,
        })
    if route.gspmd_cost is not None:
        candidates.append({
            "kind": "gspmd",
            "predicted_bytes": sum(
                v["bytes"] for v in route.gspmd_cost.values()),
            "score_bytes": route.gspmd_score_bytes,
            "cost": route.gspmd_cost,
        })
    winner = candidates[0] if route.use_route else (
        candidates[-1] if candidates else None)
    obs.record_event(
        "route.plan", src=str(route.src.decomposition),
        dest=str(route.dest.decomposition),
        shape=list(route.src.size_global()),
        topo=list(route.src.topology.dims), dtype=dt,
        verdict=route.verdict, candidates=candidates,
        predicted_bytes=(winner or {}).get("predicted_bytes", 0),
        peak_hbm_bytes=route.peak_hbm_bytes,
        hbm_limit=route.hbm_limit, donate=route.donate,
        searched_nodes=route.searched_nodes)
    obs.counter("route.plans", verdict=route.verdict).inc()
