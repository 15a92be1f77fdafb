"""Static SPMD program verifier — prove the collective schedule (the JAX
package's ``analysis/spmd.py``, ported).

The library's correctness on a mesh hinges on every rank issuing the
*same ordered sequence of collectives* (the global-transpose schedule).
This module checks it against the plan's own prediction: extract a typed
:class:`CollectiveTrace` from a program — a plan's chain, a resident
:class:`~pencilarrays_tpu_torch.ops.fft.CompiledPlan`, a routed reshard,
one transpose hop — and compare it op for op with the plan's
``collective_costs``, with a sibling configuration that must agree, or
with a static peak-memory bound.  :meth:`~pencilarrays_tpu_torch.serve.
service.PlanService.certify` runs it pre-flight over a service's
resident plans, and :func:`verify_dispatch_log` proves an engine's
issue order.

Where the port differs from the JAX package:

* **The trace is a record, not a parse.**  The JAX package reads the
  collectives out of compiled HLO (``trace_hlo``, lowering on abstract
  values, nothing executed).  The port has no compiled program text: a
  ``trace_*`` call RUNS the program once, on zeros, on every rank of its
  topology (each rank must call it, as for any collective), with the
  recorder of ``parallel/collectives.py`` armed, and the trace is the
  collectives the program issued, in order.  ``trace_hlo`` has no
  counterpart.  Bytes are per rank per application, as ``utils/hlo.py``
  ``collective_stats`` prices them (the all-to-all's operand, a ring
  round's tile, a reduction's buffer); ``shape``, ``replica_groups``
  (the issuing group's global ranks; a ring round's ``(source,
  target)`` pair) and ``async_start`` describe the call the port made.
* **Donation is a fact about storage.**  XLA's input/output aliasing
  has no counterpart; :func:`verify_donation` checks the fact the
  ``donate=`` pricing of a route assumed (``parallel/routing.py``: no
  resident-source charge): the donated operand's storage was released
  before the route's first exchange, where its peak begins.
* **A resident executable** on the card is a CUDA graph: its trace is
  the collectives recorded while that direction was captured (the calls
  the graph replays); a direction not captured yet is traced by running
  the plan's chain, the calls a capture would record.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from ..parallel.collectives import EXCHANGE_KINDS as _EXCHANGE_KINDS
from .errors import (
    DispatchOrderError,
    DonationError,
    HbmBoundError,
    ScheduleMismatchError,
    TraceDivergenceError,
)

__all__ = [
    "CollectiveOp",
    "CollectiveTrace",
    "COLLECTIVE_OPS",
    "EXCHANGE_KINDS",
    "trace_fn",
    "trace_transpose",
    "trace_plan",
    "trace_compiled_plan",
    "trace_route",
    "verify_plan",
    "verify_route",
    "verify_consistent",
    "verify_hbm",
    "verify_donation",
    "verify_dispatch_log",
    "certify_plan",
    "predicted_peak_hbm",
    "step_hop_peak",
]

# the op names a trace and a prediction use (``utils/hlo.py``'s)
COLLECTIVE_OPS: Tuple[str, ...] = (
    "all-to-all", "all-gather", "reduce-scatter", "all-reduce",
    "collective-permute")

# The data-movement collectives a transpose schedule owns
# (``parallel/collectives.py``).  Guard probes (content sums of the
# guarded hop) legitimately add ``all-reduce`` ops, so consistency
# checks between guard-on and guard-off programs compare this subset.
EXCHANGE_KINDS: Tuple[str, ...] = _EXCHANGE_KINDS


@dataclass(frozen=True)
class CollectiveOp:
    """One collective *application* in program order (``bytes``: per
    rank, the ``utils/hlo.py`` pricing)."""

    index: int                      # position among the collectives
    kind: str                       # "all-to-all" | "all-gather" | ...
    bytes: int                      # per-rank bytes
    shape: str                      # dtype[dims] of what it moved
    replica_groups: Optional[str]   # the group's ranks, {{...}}
    async_start: bool               # issued asynchronously

    @property
    def label(self) -> str:
        return f"[{self.index}] {self.kind} {self.shape}"


@dataclass(frozen=True)
class CollectiveTrace:
    """The ordered collective schedule of ONE program run, plus its
    donation facts — everything the static checks consume."""

    source: str                     # human label ("plan fwd", "route", ...)
    ops: Tuple[CollectiveOp, ...]
    donated_params: Tuple[int, ...]  # donated arguments released in time

    def stats(self, kinds: Optional[Sequence[str]] = None) -> dict:
        """Aggregate ``{op: {"count", "bytes"}}`` — the
        ``utils/hlo.py`` ``collective_stats`` schema, optionally
        restricted to ``kinds`` (e.g. :data:`EXCHANGE_KINDS`)."""
        out: dict = {}
        for op in self.ops:
            if kinds is not None and op.kind not in kinds:
                continue
            e = out.setdefault(op.kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += op.bytes
        return out

    def counts(self, kinds: Optional[Sequence[str]] = None
               ) -> Dict[str, int]:
        return {k: v["count"] for k, v in self.stats(kinds).items()}

    @property
    def total_bytes(self) -> int:
        return sum(op.bytes for op in self.ops)

    def __len__(self) -> int:
        return len(self.ops)


# ---------------------------------------------------------------------------
# extractors
# ---------------------------------------------------------------------------


def _trace_of(rec: dict, source: str, donated=()) -> CollectiveTrace:
    ops = tuple(CollectiveOp(index=i, kind=o["kind"], bytes=o["bytes"],
                             shape=o["shape"],
                             replica_groups=o["replica_groups"],
                             async_start=o["async_start"])
                for i, o in enumerate(rec["ops"]))
    return CollectiveTrace(source=source, ops=ops,
                           donated_params=tuple(donated))


def trace_fn(fn, *args, source: str = "fn", donate_argnums=()
             ) -> CollectiveTrace:
    """Trace a callable: run ``fn(*args)`` once with the collective
    recorder armed (every rank of the program's topology must call it).
    An argument in ``donate_argnums`` is handed to ``fn`` as a
    one-element list ``[x]`` it may take the value out of (the port's
    donation convention); it counts as donated when nothing kept it
    alive up to the first collective (or to the end, without one)."""
    from ..parallel import collectives

    args = list(args)
    watched = {}
    for i in donate_argnums:
        held = args[i]
        data = getattr(held, "data", held)
        watched[i] = weakref.ref(data)
        args[i] = [held]
        del held, data
    watch = watched[min(watched)] if watched else None
    with collectives.recording(watch=watch) as rec:
        fn(*args)
    args.clear()
    donated = []
    for i, ref in sorted(watched.items()):
        released = rec["released"] if (ref is watch and rec["ops"]) \
            else ref() is None
        if released:
            donated.append(i)
    return _trace_of(rec, source, donated)


def _zeros_input(pencil, extra_dims: Tuple[int, ...], dtype):
    from ..parallel.arrays import PencilArray

    return PencilArray.zeros(pencil, tuple(extra_dims), dtype)


def _hop_dtype(dtype):
    import torch

    from ..parallel.arrays import as_torch_dtype

    return as_torch_dtype(dtype if dtype is not None else torch.float32)


def trace_transpose(pin, pout, extra_dims: Tuple[int, ...] = (),
                    dtype=None, method=None, *, donate: bool = False
                    ) -> CollectiveTrace:
    """Trace one transpose hop ``pin -> pout``:
    ``trace_transpose(...).stats()`` is pin-compatible with
    ``transpose_cost(...)``."""
    from ..parallel.transpositions import AllToAll, transpose

    m = method if method is not None else AllToAll()
    x = _zeros_input(pin, tuple(extra_dims), _hop_dtype(dtype))

    def hop(arg):
        u = arg.pop() if isinstance(arg, list) else arg
        return transpose(u, pout, method=m)

    return trace_fn(hop, x, source=f"transpose {pin.decomposition}->"
                                   f"{pout.decomposition}",
                    donate_argnums=(0,) if donate else ())


def _direction(direction: str) -> bool:
    if direction not in ("forward", "backward"):
        raise ValueError(f"direction must be 'forward' or 'backward', "
                         f"got {direction!r}")
    return direction == "forward"


def trace_plan(plan, extra_dims: Optional[Tuple[int, ...]] = None,
               direction: str = "forward", *, donate: bool = False
               ) -> CollectiveTrace:
    """Trace a :class:`~pencilarrays_tpu_torch.ops.fft.PencilFFTPlan`'s
    full chain in ``direction`` (``extra_dims`` defaults to the plan's
    ``batch_dims``, like every plan method)."""
    fwd = _direction(direction)
    if extra_dims is None:
        extra_dims = plan.batch_dims
    extra = tuple(int(e) for e in extra_dims)
    pen = plan.input_pencil if fwd else plan.output_pencil
    dt = plan.dtype_physical if fwd else plan.dtype_spectral
    run = plan.forward if fwd else plan.backward

    def chain(arg):
        return run(arg.pop() if isinstance(arg, list) else arg)

    return trace_fn(chain, _zeros_input(pen, extra, dt),
                    source=f"plan.{direction} extra={extra}",
                    donate_argnums=(0,) if donate else ())


def trace_compiled_plan(cp, direction: str = "forward"
                        ) -> CollectiveTrace:
    """Trace a resident :class:`~pencilarrays_tpu_torch.ops.fft.
    CompiledPlan` — the registry-sweep entry point.  On the card a
    captured direction answers with the collectives recorded while its
    graph was captured (what every replay issues); otherwise the
    executable's own call runs once (the eager chain on the CPU), or,
    for a direction not captured yet, the plan's chain the capture would
    record."""
    fwd = _direction(direction)
    plan = cp.plan
    source = f"compiled.{direction} extra={cp.extra_dims}"
    captured = cp.graph_info(direction)
    if captured is not None and "collectives" in captured:
        return _trace_of({"ops": captured["collectives"]}, source)
    pen = plan.input_pencil if fwd else plan.output_pencil
    dt = plan.dtype_physical if fwd else plan.dtype_spectral
    x = _zeros_input(pen, cp.extra_dims, dt)
    if cp.graphed:
        run = plan.forward if fwd else plan.backward
        return trace_fn(run, x, source=source)
    return trace_fn(cp.forward if fwd else cp.backward, x, source=source)


def trace_route(route, extra_dims: Tuple[int, ...] = (), dtype=None, *,
                donate: bool = False) -> CollectiveTrace:
    """Trace a planned reshard route as ``execute_route`` runs it
    (``donate=True``: the source handed over, as a donating caller
    does)."""
    from ..parallel.routing import execute_route

    if not route.hops:
        raise ValueError("route has no hops (planner fell back to Gspmd)")
    extra = tuple(int(e) for e in extra_dims)
    x = _zeros_input(route.src, extra, _hop_dtype(dtype))

    def run(arg):
        if isinstance(arg, list):
            return execute_route(arg.pop(), route, donate=True)
        return execute_route(arg, route)

    return trace_fn(run, x, source=f"route {route.src.decomposition}->"
                                   f"{route.dest.decomposition}",
                    donate_argnums=(0,) if donate else ())


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _check_stats(source: str, predicted: dict, observed: dict) -> None:
    """Op-for-op comparison; raises :class:`ScheduleMismatchError`
    naming the first diverging collective kind."""
    for op in COLLECTIVE_OPS:
        p, o = predicted.get(op), observed.get(op)
        if p != o:
            raise ScheduleMismatchError(source, op, p, o)
    # non-standard kinds can only come from the prediction side
    for op in sorted(set(predicted) | set(observed)):
        if predicted.get(op) != observed.get(op):
            raise ScheduleMismatchError(source, op, predicted.get(op),
                                        observed.get(op))


def verify_plan(plan, extra_dims: Optional[Tuple[int, ...]] = None,
                direction: str = "forward",
                trace: Optional[CollectiveTrace] = None
                ) -> CollectiveTrace:
    """Check (a): the program's trace matches the plan's
    ``collective_costs`` prediction op-for-op (count AND bytes).
    Returns the verified trace; raises
    :class:`~pencilarrays_tpu_torch.analysis.errors.ScheduleMismatchError`
    naming the offending op.  Pass ``trace`` to verify an
    already-extracted program (e.g. a ``trace_compiled_plan`` of the
    resident executable)."""
    if extra_dims is None:
        extra_dims = plan.batch_dims
    extra = tuple(int(e) for e in extra_dims)
    if trace is None:
        trace = trace_plan(plan, extra, direction)
    predicted = plan.collective_costs(extra)
    _check_stats(trace.source, predicted, trace.stats())
    return trace


def verify_route(route, extra_dims: Tuple[int, ...] = (), dtype=None,
                 trace: Optional[CollectiveTrace] = None
                 ) -> CollectiveTrace:
    """Check (a) for a routed reshard: the route's trace equals the sum
    of the planner's per-hop priced costs."""
    if trace is None:
        trace = trace_route(route, extra_dims, dtype)
    predicted: dict = {}
    for h in route.hops:
        for op, c in h.cost.items():
            e = predicted.setdefault(op, {"count": 0, "bytes": 0})
            e["count"] += c["count"]
            e["bytes"] += c["bytes"]
    _check_stats(trace.source, predicted, trace.stats())
    return trace


def verify_consistent(a: CollectiveTrace, b: CollectiveTrace, *,
                      kinds: Optional[Sequence[str]] = EXCHANGE_KINDS,
                      bytes_ratio: Optional[float] = 1.0) -> None:
    """Check (b): two programs that must agree issue consistent
    traces — per-kind collective COUNTS equal, and per-kind bytes of
    ``b`` equal to ``bytes_ratio x a`` (``None`` skips the byte check;
    ``B`` proves batched-vs-unbatched amortization: count x1, bytes
    xB).  ``kinds`` restricts the comparison (default
    :data:`EXCHANGE_KINDS`, so guard probes' ``all-reduce`` additions
    do not fail a guard-on-vs-off check).  Raises
    :class:`TraceDivergenceError` naming the first diverging op."""
    sa, sb = a.stats(kinds), b.stats(kinds)
    for op in sorted(set(sa) | set(sb)):
        ca = sa.get(op, {}).get("count")
        cb = sb.get(op, {}).get("count")
        if ca != cb:
            raise TraceDivergenceError(a.source, b.source, op, "count",
                                       ca, cb)
        if bytes_ratio is not None:
            ba = sa.get(op, {}).get("bytes", 0)
            bb = sb.get(op, {}).get("bytes", 0)
            if int(round(ba * bytes_ratio)) != bb:
                raise TraceDivergenceError(
                    a.source, b.source, op,
                    f"bytes (expected x{bytes_ratio:g})", ba, bb)


def step_hop_peak(step, extra_dims: Tuple[int, ...], *, method=None,
                  wire_dtype=None) -> int:
    """Peak device bytes per rank of one plan step (a ``"t"`` hop or a
    fused ``"ft"`` hop), by the route planner's one footprint model
    (``routing._hop_peak_bytes``): a chunked hop is charged its
    time-sliced footprint, a wired hop its packed in-flight share."""
    from ..parallel.routing import _hop_peak_bytes
    from ..parallel.transpositions import (AllToAll, Pipelined, Ring,
                                           _method_wire, assert_compatible)

    if step[0] not in ("t", "ft"):
        raise ValueError(f"not an exchange step: {step[0]!r}")
    src, dst, hop_dtype = step[1], step[2], step[3]
    R = assert_compatible(src, dst)
    if step[0] == "ft":
        base, c, bounds = step[7], step[8], step[9]
        return _hop_peak_bytes(src, dst, R, tuple(extra_dims), hop_dtype,
                               base, chunk_dim=c, bounds=bounds)
    m = step[4] if len(step) > 4 else method
    if not isinstance(m, (AllToAll, Ring, Pipelined)):
        # Auto-planned hops bound at the unchunked model with the wire
        m = AllToAll(wire_dtype=_method_wire(m) if m is not None
                     else wire_dtype)
    return _hop_peak_bytes(src, dst, R, tuple(extra_dims), hop_dtype, m)


def predicted_peak_hbm(plan_or_route,
                       extra_dims: Optional[Tuple[int, ...]] = None,
                       dtype=None) -> Tuple[int, str]:
    """Static per-rank peak device-memory prediction of a plan's or
    route's worst exchange: ``(peak_bytes, hop_label)``.  The EXACT
    accounting the route planner's ``hbm_limit`` admission charges
    (``routing._hop_peak_bytes`` — chunk-aware time-sliced footprints,
    wire-packed in-flight bytes, and for routes the pinned-source
    surcharge the route's recorded ``donate`` assumption implies), so
    a planned route's per-hop ``peak_hbm_bytes`` and this prediction
    can never disagree."""
    from ..parallel.routing import _hop_peak_bytes
    from ..parallel.transpositions import assert_compatible

    peak, label = 0, "<empty>"
    if hasattr(plan_or_route, "hops"):          # ReshardRoute
        route = plan_or_route
        extra = tuple(int(e) for e in (extra_dims or ()))
        dt = _hop_dtype(dtype)
        # donation accounting mirrors the planner: a non-donated source
        # block is resident under the whole chain and charged on every
        # edge (except a first-hop local permute, which counts it as
        # its own input already)
        pinned = 0 if getattr(route, "donate", False) else \
            route.src.bytes_per_device(extra, dt)
        for k, h in enumerate(route.hops):
            R = assert_compatible(h.src, h.dest)
            surcharge = 0 if (k == 0 and R is None) else pinned
            p = _hop_peak_bytes(h.src, h.dest, R, extra, dt,
                                h.method) + surcharge
            if p > peak:
                peak, label = p, f"route[{k}] {h.src.decomposition}->" \
                                 f"{h.dest.decomposition}"
        return peak, label
    plan = plan_or_route
    if extra_dims is None:
        extra_dims = plan.batch_dims
    extra = tuple(int(e) for e in extra_dims)
    plan_wire = getattr(plan, "wire_dtype", None)
    k = 0
    for s in plan._steps:
        if s[0] not in ("t", "ft"):
            continue
        p = step_hop_peak(s, extra, method=getattr(plan, "method", None),
                          wire_dtype=plan_wire)
        if p > peak:
            peak, label = p, f"hop[{k}] {s[1].decomposition}->" \
                             f"{s[2].decomposition}"
        k += 1
    return peak, label


def verify_hbm(plan_or_route, hbm_limit: int,
               extra_dims: Optional[Tuple[int, ...]] = None,
               dtype=None, *, source: str = "program") -> int:
    """Check (c): the program's static peak-memory prediction is within
    ``hbm_limit`` bytes per rank.  Returns the predicted peak; raises
    :class:`HbmBoundError` naming the offending hop."""
    peak, label = predicted_peak_hbm(plan_or_route, extra_dims, dtype)
    if peak > int(hbm_limit):
        raise HbmBoundError(source, label, peak, int(hbm_limit))
    return peak


def verify_donation(trace: CollectiveTrace, *,
                    expected_params: Sequence[int] = (0,)) -> None:
    """Check (c), donation half: a program priced with donation must
    have released the donated operands' storage before its first
    exchange (the fact the router's ``donate=`` pricing assumed: no
    resident-source charge).  Raises :class:`DonationError`."""
    missing = [p for p in expected_params
               if p not in trace.donated_params]
    if missing:
        raise DonationError(
            trace.source,
            f"argument(s) {missing} still held at the first exchange "
            f"(donated_params={list(trace.donated_params)}): donation "
            f"did not release the buffer the pricing assumed")


def _verify_partial_order(records: Sequence, source: str
                          ) -> Tuple[int, int, int]:
    """The partial-order walk: recompute dependence edges from the
    declared resource sets in enqueue order, fold in each record's own
    recorded ``deps``, and prove every edge respects issue order.
    Returns ``(chains, edges, reordered)``; raises
    :class:`DispatchOrderError` on the first violated chain edge.

    The barrier rule is positional, not edge-enumerated (a barrier
    touching N earlier records would otherwise cost O(N) edges each):
    a barrier's issue position must exceed EVERY earlier-enqueued
    record's, and every later-enqueued record must exceed the last
    barrier's — together exactly "conflicts with everything, both
    directions"."""
    pos_of: Dict[int, int] = {}
    for pos, r in enumerate(records):
        seq = r.enqueue_seq
        if seq in pos_of:
            raise DispatchOrderError(
                source, pos, r.label, expected_seq=seq,
                observed_seq=seq,
                detail=f"duplicate enqueue seq {seq} in one log — two "
                       f"dispatches cannot share an enqueue slot")
        pos_of[seq] = pos
    by_enqueue = sorted(records, key=lambda r: r.enqueue_seq)
    writer: Dict[str, int] = {}      # resource -> last writer seq
    readers: Dict[str, set] = {}     # resource -> reader seqs since
    barrier_seq = None               # last barrier's enqueue seq
    barrier_pos = -1
    max_prev_pos = -1                # max issue pos among earlier-enqueued
    max_prev_seq = None              # a seq attaining it (edge naming)
    chain_ids = set()
    edges = reordered = 0
    for r in by_enqueue:
        seq, pos = r.enqueue_seq, pos_of[r.enqueue_seq]
        deps: Dict[int, str] = {}    # dep seq -> chain label of the edge
        if getattr(r, "barrier", True):
            if pos < max_prev_pos:
                raise DispatchOrderError(
                    source, pos, r.label, expected_seq=max_prev_seq,
                    observed_seq=seq, chain="*", dep_seq=max_prev_seq,
                    detail="a barrier issued before an earlier-enqueued "
                           "dispatch it must wait out")
            barrier_seq, barrier_pos = seq, pos
            # the barrier resets resource history: every later task
            # orders against the barrier itself, not pre-barrier writers
            writer.clear()
            readers.clear()
            edges += 1 if max_prev_seq is not None else 0
        else:
            if barrier_seq is not None:
                deps[barrier_seq] = "*"
            reads = frozenset(getattr(r, "reads", ()) or ())
            writes = frozenset(getattr(r, "writes", ()) or ())
            for res in reads | writes:
                w = writer.get(res)
                if w is not None:
                    deps[w] = res                      # RAW / WAW
            for res in writes:
                for s in readers.get(res, ()):
                    deps.setdefault(s, res)            # WAR
            for d in getattr(r, "deps", ()) or ():
                # the engine's own recorded edges (includes after= —
                # invisible to the resource recompute); edges landing
                # outside this log slice (other clients' traffic) are
                # unprovable here and skipped
                if d in pos_of:
                    deps.setdefault(d, getattr(r, "chain", "*"))
            for d, chain in sorted(deps.items()):
                edges += 1
                if pos_of[d] > pos:
                    raise DispatchOrderError(
                        source, pos, r.label, expected_seq=d,
                        observed_seq=seq, chain=chain, dep_seq=d)
            for res in writes:
                writer[res] = seq
                readers.pop(res, None)
            for res in reads - writes:
                readers.setdefault(res, set()).add(seq)
            chain_ids.add(getattr(r, "chain", "*"))
        if pos > max_prev_pos:
            max_prev_pos, max_prev_seq = pos, seq
    # the barrier floor forward: every record enqueued after the LAST
    # barrier was already edge-checked against it above; nothing more
    # to do — but count the cross-chain reorders for the report
    issued_max = -1
    for r in records:
        if r.enqueue_seq < issued_max:
            reordered += 1
        else:
            issued_max = r.enqueue_seq
    return len(chain_ids) + (1 if barrier_pos >= 0 else 0), edges, \
        reordered


def _check_resource_declarations(records: Sequence, source: str) -> None:
    """The forged-resource check: a non-barrier ``"ok"`` record that
    dispatched a plan must have DECLARED the matching ``plan:<fp>``
    write — the resource token the serve layer stamps — else its chain
    membership was a lie and the partial-order proof above proved the
    wrong graph.  Raises :class:`ScheduleMismatchError`
    (op ``"resource-set"``)."""
    for r in records:
        if getattr(r, "barrier", True) or getattr(r, "outcome", "ok") \
                != "ok":
            continue
        meta = getattr(r, "meta", None) or {}
        plan = meta.get("plan")
        if plan is None:
            continue
        want = f"plan:{plan.plan_key()}"
        writes = tuple(getattr(r, "writes", ()) or ())
        if want not in writes:
            raise ScheduleMismatchError(
                f"{source} [{r.label}]", "resource-set",
                {"writes": [want]}, {"writes": list(writes)})


def _predicted(plan, extra: tuple) -> dict:
    """The plan's nonzero collective ops at ``extra``."""
    return {op: {"count": int(v["count"]), "bytes": int(v["bytes"])}
            for op, v in plan.collective_costs(extra).items()
            if v["count"] or v["bytes"]}


def verify_dispatch_log(records: Sequence, *, source: str = "engine",
                        verify_traces: bool = True,
                        mode: str = "auto") -> dict:
    """An engine's issued dispatch sequence equals the serialized
    schedule: per dependency chain for the DAG, totally for an all-barrier
    log (the JAX package's check (d)).

    ``records`` are :class:`~pencilarrays_tpu_torch.engine.
    DispatchRecord` s in issue order.  ``mode``:

    * ``"total"`` — issue order == enqueue order (gaps are fine, an
      inversion raises :class:`DispatchOrderError` naming the first
      diverging dispatch);
    * ``"partial"`` — dependence edges are recomputed from each record's
      declared ``reads``/``writes`` in enqueue order (a barrier conflicts
      with everything before and after it), the engine's own recorded
      ``deps`` are added, and every edge must respect issue order; a
      non-barrier ``"ok"`` record that dispatched a plan
      (``meta["plan"]``) must declare the matching ``"plan:<key>"``
      write, else :class:`ScheduleMismatchError` (op ``"resource-set"``);
    * ``"auto"`` (default) — ``"partial"`` iff any record is
      non-barrier.

    With ``verify_traces``, each ``"ok"`` record that carries a plan is
    checked twice: ``meta["wire_bytes"]`` against the plan's priced
    bytes at the record's ``extra_dims`` (op ``"wire-bytes"``), and the
    collective calls it counted (``meta["collectives"]``, ``{op: {count,
    bytes}}``) against ``collective_costs`` op for op.  A record without
    counted collectives counts as unverified.

    Returns ``{"dispatches", "order_ok", "mode", "chains", "edges",
    "reordered", "verified_traces", "unverified", "wire_checked",
    "ops"}``."""
    records = list(records)
    if mode not in ("auto", "total", "partial"):
        raise ValueError(f"unknown dispatch-log mode {mode!r}")
    if mode == "auto":
        mode = "partial" if any(
            not getattr(r, "barrier", True) for r in records) else "total"
    chains, edges, reordered = 0, 0, 0
    if mode == "total":
        prev_seq = None
        for pos, r in enumerate(records):
            seq = r.enqueue_seq
            if prev_seq is not None and seq <= prev_seq:
                raise DispatchOrderError(source, pos, r.label,
                                         expected_seq=prev_seq + 1,
                                         observed_seq=seq)
            prev_seq = seq
        chains = 1 if records else 0
        edges = max(0, len(records) - 1)
    else:
        chains, edges, reordered = _verify_partial_order(records, source)
        _check_resource_declarations(records, source)
    verified, unverified, total_ops, wire_checked = 0, 0, 0, 0
    if not verify_traces:
        unverified = len(records)
    for r in records if verify_traces else ():
        meta = getattr(r, "meta", None) or {}
        plan = meta.get("plan")
        if plan is None or getattr(r, "outcome", "ok") != "ok":
            unverified += 1
            continue
        extra = tuple(meta.get("extra_dims", ()))
        want = _predicted(plan, extra)
        if meta.get("wire_bytes") is not None:
            priced = sum(v["bytes"] for v in want.values())
            if int(meta["wire_bytes"]) != priced:
                raise ScheduleMismatchError(
                    f"{source} [{r.label}]", "wire-bytes",
                    {"bytes": priced}, {"bytes": int(meta["wire_bytes"])})
            wire_checked += 1
        got = meta.get("collectives")
        if got is None:
            unverified += 1
            continue
        for op in sorted(set(want) | set(got)):
            if want.get(op) != got.get(op):
                raise ScheduleMismatchError(
                    f"{source} [{r.label}]", op, want.get(op), got.get(op))
        total_ops += len(want)
        verified += 1
    return {"dispatches": len(records), "order_ok": True,
            "mode": mode, "chains": chains, "edges": edges,
            "reordered": reordered,
            "verified_traces": verified, "unverified": unverified,
            "wire_checked": wire_checked, "ops": total_ops}


# ---------------------------------------------------------------------------
# certification (the pre-flight sweep unit)
# ---------------------------------------------------------------------------


def certify_plan(plan, extra_dims: Optional[Tuple[int, ...]] = None, *,
                 compiled=None, hbm_limit: Optional[int] = None,
                 target: str = "plan", _journal: bool = True) -> dict:
    """Certify ONE plan: forward AND backward traces match the
    ``collective_costs`` prediction (on the resident executable when
    ``compiled`` is passed), optionally bounded by ``hbm_limit``.
    Journals one ``analysis.check`` event (outcome ``ok`` or the typed
    error's class name — non-ok is fsync-critical) and returns the
    check record; raises the typed error after journaling."""
    from .. import obs

    if extra_dims is None:
        extra_dims = plan.batch_dims
    extra = tuple(int(e) for e in extra_dims)
    t0 = time.perf_counter()
    record = {"target": target, "extra_dims": list(extra),
              "plan_fp": plan.plan_key()}
    try:
        traces = {}
        for direction in ("forward", "backward"):
            if compiled is not None:
                tr = trace_compiled_plan(compiled, direction)
            else:
                tr = trace_plan(plan, extra, direction)
            traces[direction] = verify_plan(plan, extra, direction,
                                            trace=tr)
        if hbm_limit is not None:
            record["peak_hbm_bytes"] = verify_hbm(
                plan, hbm_limit, extra, source=target)
        record.update(
            outcome="ok",
            ops=len(traces["forward"]),
            predicted_bytes=traces["forward"].total_bytes,
            seconds=time.perf_counter() - t0)
        if _journal and obs.enabled():
            obs.record_event("analysis.check", **record)
            obs.counter("analysis.checks", outcome="ok").inc()
        return record
    except Exception as e:
        record.update(outcome=type(e).__name__, error=str(e),
                      seconds=time.perf_counter() - t0)
        if _journal and obs.enabled():
            obs.record_event("analysis.check", _fsync=True, **record)
            obs.counter("analysis.checks",
                        outcome=type(e).__name__).inc()
        raise
