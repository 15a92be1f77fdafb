"""Journal event schema and lint (a copy of the JAX package's
``obs/schema.py``): every record type either package emits is registered
here with its required payload fields, so a journal lints alike under
both packages' :func:`lint_journal`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple, Union

from .events import SCHEMA_VERSION

__all__ = ["COMMON_FIELDS", "EVENT_TYPES", "V4_EVENT_FIELDS",
           "V5_EVENT_FIELDS", "V6_EVENT_FIELDS", "V7_EVENT_FIELDS",
           "V8_EVENT_FIELDS", "lint_event", "lint_journal"]

# fields every record carries (written by events.record_event itself)
COMMON_FIELDS: Tuple[str, ...] = (
    "v", "ev", "run", "proc", "seq", "t_wall", "t_mono")

# correlation keys stamped into every record since schema v2
# (obs/correlate.py): the cross-rank join key.  ``plan_fp`` is only
# present once a plan exists, so it is not required.
V2_STAMP_FIELDS: Tuple[str, ...] = ("step_idx", "epoch")

# per-event fields required since schema v3 (the batched-throughput
# mode): a v3 ``plan.build`` record must journal the batch it prices
# its schedule at (``extra_dims``) and its slab/pencil decomposition
# verdict (``{"mode": "fixed", ...}`` for plans built on a caller-fixed
# topology).  v1/v2 journals stay lint-clean — the requirement is
# versioned, like the v2 correlation stamps.
V3_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "plan.build": ("extra_dims", "decomposition"),
}

# per-event fields required since schema v4 (memory-bounded
# redistribution synthesis): a v4 ``route.plan`` record must carry the
# footprint verdict pa-obs renders — the charged peak-HBM bytes, the
# bound the route was admitted under (``None`` = unbounded), and the
# donation assumption the pricing charged (the pinned-source
# surcharge).  Per-candidate ``chunks`` ride the candidates payload.
# v1-v3 journals stay lint-clean, as with the v2/v3 stamps.
V4_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "route.plan": ("peak_hbm_bytes", "hbm_limit", "donate"),
}

# per-event fields required since schema v5 (the DAG engine): a v5
# ``serve.dispatch`` record must carry the engine priority lane it was
# submitted on and the dependency chain it orders within (the declared
# write set, joined) — what pa-obs' per-lane timeline tracks and the
# partial-order certification render from.  v1-v4 journals stay
# lint-clean, as with the earlier versioned stamps.
V5_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "serve.dispatch": ("lane", "chain"),
}

# per-event fields required since schema v6 (the request-flow plane):
# every record on a request's path carries the trace id minted once at
# admission (obs/requestflow.py) — the key ``pa-obs request`` joins
# one ticket's causal timeline across router + N mesh journals by.  A
# coalesced batch's formation record additionally journals the B-way
# fan-in (``traces``: every member's id) so one dispatch span is
# attributable to each member request.  v1-v5 journals stay
# lint-clean, as with every earlier versioned stamp.
V6_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "fleet.route": ("trace",),
    "serve.request": ("trace",),
    "serve.coalesce": ("trace", "traces"),
    "serve.dispatch": ("trace", "traces"),
    "serve.complete": ("trace",),
}

# per-event fields required since schema v7 (the precision-downgrade
# rung): a ``serve.precision`` record — a sheddable request
# served on a cheaper wire format instead of shed — must journal the
# full contract the degradation was admitted under: the wire precision
# it moved from and to, the calibrated worst-case relative-l2 envelope
# promised for that rung (``serve/precision.py`` / ``BENCH_WIRE.json``)
# and the tenant-declared ``max_rel_l2`` budget the envelope fit
# inside, plus the trace id so ``pa-obs request`` reconstructs WHICH
# answers were degraded.  v1-v6 journals stay lint-clean, as with
# every earlier versioned stamp.
V7_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "serve.precision": ("trace", "wire_from", "wire_to", "envelope",
                        "max_rel_l2"),
}

# per-event fields required since schema v8 (the partition-tolerant
# control plane): a ``cluster.quorum`` record must carry the
# full gate arithmetic the post-mortem re-checks — the voter set
# actually read, the strict-majority threshold and the denominator it
# was computed over (the last-agreed membership minus confirmed-gone
# ranks); a ``cluster.fence`` record names the stale token and the
# published fence that rejected it; a ``fleet.wal`` record summarizes
# a recover/replay pass (how many tickets were re-parked vs already
# resolved).  v1-v7 journals stay lint-clean, as with every earlier
# versioned stamp.
V8_EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "cluster.quorum": ("have", "need", "of"),
    "cluster.fence": ("fence_gen", "fence_epoch"),
    "fleet.wal": ("outcome", "replayed", "resolved"),
}

# ev -> required payload fields (extra fields are allowed; missing ones
# and unknown event types are lint errors)
EVENT_TYPES: Dict[str, Tuple[str, ...]] = {
    # run boundaries
    "run.start": ("pid",),
    "run.stop": (),
    # planner / transpose engine
    "plan.build": ("shape", "transforms", "topo", "pipeline", "steps"),
    "auto.verdict": ("mode", "winner", "config"),
    "route.plan": ("src", "dest", "verdict", "candidates",
                   "predicted_bytes"),
    "hop": ("method", "r", "chunks", "predicted_bytes", "dispatch_s"),
    # I/O drivers
    "io.open": ("path", "mode"),
    "io.write": ("path", "dataset", "bytes", "seconds"),
    "io.read": ("path", "dataset", "seconds"),
    # checkpoint lifecycle
    "ckpt.save": ("step", "status"),
    "ckpt.commit": ("step",),
    "ckpt.restore": ("step", "dataset", "seconds"),
    "ckpt.verify": ("step", "ok"),
    "ckpt.gc": ("removed",),
    # resilience
    "retry": ("label", "attempt", "max_attempts", "delay_s", "error"),
    "fault": ("point", "mode", "hit"),
    "dist.init": ("status",),
    # runtime integrity guard (guard/)
    "guard.sdc": ("hop", "kind", "predicted", "observed"),
    "guard.hang": ("label", "timeout_s"),
    "guard.recover": ("label", "stage"),
    "guard.bundle": ("path", "reason"),
    "guard.epoch": ("epoch", "reason"),
    # mesh coordination layer (cluster/)
    "cluster.lease": ("rank", "status"),
    "cluster.verdict": ("label", "action", "epoch"),
    # elastic mesh reformation (cluster/elastic.py): the reformation
    # timeline (stages begin/view/membership/mesh/replan/restore/
    # complete/failed, plus join-request/join) and membership changes
    # (leave/left/drop/join)
    "cluster.reform": ("gen", "stage"),
    "cluster.member": ("rank", "change"),
    # the partition-tolerant control plane (schema v8): one
    # fsync-critical record per quorum-gate evaluation (verdict
    # pass/fail/bypass — the v8 fields carry the full arithmetic) and
    # per rejected zombie write (the stale token vs the published
    # fence)
    "cluster.quorum": ("gen", "rank", "verdict"),
    "cluster.fence": ("key", "gen", "epoch"),
    # mesh observability plane
    "cluster.straggler": ("rank", "hop", "excess_s", "baseline_s"),
    "clock.sync": ("ref_rank", "offset_s", "method"),
    "obs.agg": ("status",),
    # multi-tenant plan service (serve/): the request lifecycle —
    # admission (serve.request), batch formation (serve.coalesce),
    # the single coalesced dispatch (serve.dispatch) and the
    # per-request resolution (serve.complete; non-ok outcomes are
    # fsync-critical via record_event's per-record override)
    "serve.request": ("tenant", "req", "kind", "key", "nbytes"),
    "serve.coalesce": ("key", "n", "reqs", "reason", "wait_s"),
    "serve.dispatch": ("key", "n", "tenants", "score_bytes", "reason"),
    "serve.complete": ("tenant", "req", "outcome", "seconds", "key"),
    # the overload-survival plane (serve/slo.py, shed.py, autoscale.py):
    # a completion that busted its tenant's SLO deadline (the answer
    # was returned, the violation is on the record — fsync-critical),
    # a pressure-gate state transition with the projection that drove
    # it, and an autoscaler grow/shrink decision with its inputs
    "serve.slo_violation": ("tenant", "req", "deadline_s", "late_s"),
    "serve.pressure": ("state", "prev", "drain_s"),
    "serve.scale": ("direction", "reason", "projection"),
    # the SLO error-budget burn-rate monitor (serve/slo.py): a
    # tenant's budget is burning faster than the alert threshold —
    # always fsync-critical, the record must outlive the overload
    # that tripped it
    "serve.burn_alert": ("tenant", "burn_rate", "threshold",
                         "window_s"),
    # the precision-downgrade rung (serve/precision.py, schema v7):
    # one fsync-critical record per request served on a cheaper wire
    # format under pressure — v7 requires the full degradation
    # contract (V7_EVENT_FIELDS)
    "serve.precision": ("tenant", "req", "key", "gate"),
    # per-mesh task-graph executor (engine/): one record per engine
    # reformation boundary (queued dispatches dropped typed, fresh
    # RuntimeConfig snapshot, new generation)
    "engine.reform": ("gen", "stage"),
    # multi-mesh fleet federation (fleet/): a placement/rebind
    # decision with its bytes-equivalent score (fleet.route), a mesh
    # health-lease transition (fleet.lease — acquired/expired/left;
    # expiry rides record_event's per-record fsync override), a
    # whole-mesh failover sweep (fleet.failover — always
    # fsync-critical: the router may be about to re-bind onto a mesh
    # that dies too) and a supervisor scaling action (fleet.scale)
    "fleet.route": ("ticket", "tenant", "mesh", "reason",
                    "score_bytes"),
    "fleet.lease": ("mesh", "status"),
    "fleet.failover": ("mesh", "tickets", "detect_s"),
    "fleet.scale": ("action", "reason"),
    # durable router WAL (fleet/wal.py, schema v8): one fsync-critical
    # record per recover/replay pass — how the restarted router
    # reconciled its log (re-parked vs already-resolved tickets)
    "fleet.wal": ("dir",),
    # static analysis (analysis/): one record per certification —
    # ``PlanService.certify()`` registry sweeps, pa-lint SPMD runs and
    # direct ``certify_plan`` calls; non-ok outcomes are fsync-critical
    # via record_event's per-record override
    "analysis.check": ("target", "outcome", "seconds"),
    # profiling / drift
    "profile": ("dir", "status"),
    "drift.sample": ("hop", "predicted_bytes", "measured_s", "source"),
}


def lint_event(e: dict) -> List[str]:
    """Schema errors of one record ([] = clean)."""
    errors = []
    if not isinstance(e, dict):
        return [f"record is not an object: {e!r}"]
    for f in COMMON_FIELDS:
        if f not in e:
            errors.append(f"missing common field {f!r}: {e!r}")
    v = e.get("v")
    if v is not None and not isinstance(v, (int, float)):
        errors.append(f"schema version is not a number: {v!r}")
    elif v is not None and v > SCHEMA_VERSION:
        errors.append(f"schema version {v} is newer than supported "
                      f"{SCHEMA_VERSION}")
    if isinstance(v, (int, float)) and v >= 2:
        for f in V2_STAMP_FIELDS:
            if f not in e:
                errors.append(
                    f"v{v} record missing correlation key {f!r} "
                    f"(stamped by obs/correlate.py): {e!r}")
    ev = e.get("ev")
    if ev is None:
        return errors
    req = EVENT_TYPES.get(ev)
    if req is None:
        errors.append(f"unknown event type {ev!r} (register it in "
                      f"obs/schema.py EVENT_TYPES)")
        return errors
    for f in req:
        if f not in e:
            errors.append(f"event {ev!r} missing required field {f!r}: {e!r}")
    if isinstance(v, (int, float)) and v >= 3:
        for f in V3_EVENT_FIELDS.get(ev, ()):
            if f not in e:
                errors.append(
                    f"v{v} event {ev!r} missing required field {f!r} "
                    f"(batched-throughput fields, schema v3): {e!r}")
    if isinstance(v, (int, float)) and v >= 4:
        for f in V4_EVENT_FIELDS.get(ev, ()):
            if f not in e:
                errors.append(
                    f"v{v} event {ev!r} missing required field {f!r} "
                    f"(memory-bounded routing fields, schema v4): {e!r}")
    if isinstance(v, (int, float)) and v >= 5:
        for f in V5_EVENT_FIELDS.get(ev, ()):
            if f not in e:
                errors.append(
                    f"v{v} event {ev!r} missing required field {f!r} "
                    f"(DAG-engine lane fields, schema v5): {e!r}")
    if isinstance(v, (int, float)) and v >= 6:
        for f in V6_EVENT_FIELDS.get(ev, ()):
            if f not in e:
                errors.append(
                    f"v{v} event {ev!r} missing required field {f!r} "
                    f"(request-trace fields, schema v6): {e!r}")
    if isinstance(v, (int, float)) and v >= 7:
        for f in V7_EVENT_FIELDS.get(ev, ()):
            if f not in e:
                errors.append(
                    f"v{v} event {ev!r} missing required field {f!r} "
                    f"(precision-downgrade fields, schema v7): {e!r}")
    if isinstance(v, (int, float)) and v >= 8:
        for f in V8_EVENT_FIELDS.get(ev, ()):
            if f not in e:
                errors.append(
                    f"v{v} event {ev!r} missing required field {f!r} "
                    f"(partition-tolerance fields, schema v8): {e!r}")
    return errors


def lint_journal(events_or_dir: Union[str, Iterable[dict]]) -> List[str]:
    """Lint a whole journal (a directory path or an event iterable).
    Returns every error found; [] means the timeline is schema-clean."""
    if isinstance(events_or_dir, str):
        from .events import read_journal

        events = read_journal(events_or_dir)
    else:
        events = list(events_or_dir)
    errors = []
    for e in events:
        errors.extend(lint_event(e))
    return errors
