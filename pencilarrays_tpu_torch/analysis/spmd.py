"""Static checks of schedules (the JAX package's ``analysis/spmd.py``):
the peak-memory accounting of one FFT-plan step, and the proof that an
engine's dispatch log respects its enqueue order (``verify_dispatch_log``
and its partial-order walk).  The JAX package re-extracts each
dispatched plan's collective trace from compiled HLO; the port has no
compiled program to read, so a dispatch that counted its own exchange
calls (``meta["collectives"]``, as ``PencilFFTPlan.forward_async``
does) is held to the plan's ``collective_costs`` instead.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .errors import DispatchOrderError, ScheduleMismatchError


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
