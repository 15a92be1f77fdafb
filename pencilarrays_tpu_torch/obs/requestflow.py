"""Request-scoped trace context (the context half of the JAX package's
``obs/requestflow.py``).

A trace id (16 hex chars, :func:`mint_trace`) is minted once per request
at an admission point and carried in the engine task's ``meta["trace"]``;
:meth:`~pencilarrays_tpu_torch.engine.Engine._run_task` installs it as
the consumer thread's ambient context for the whole dispatch
(:func:`installed`), and :func:`stamp` folds it into every journal
record written meanwhile (an explicitly passed ``trace=`` wins).

Reconstruction (:func:`reconstruct_request`, :func:`list_requests` and
``python -m pencilarrays_tpu_torch.obs request`` / ``requests``) rides
:func:`~pencilarrays_tpu_torch.obs.timeline.merge_journals`: causal
order across every journal under a directory, with missing ranks, torn
tails and older journals degrading to warnings.  The critical-path
decomposition names where a request's wall time went (wire, admission
wait, coalesce wait, lane wait, compute, failover), as in the JAX
package.
"""

from __future__ import annotations

import threading
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "mint_trace",
    "current_trace",
    "installed",
    "stamp",
    "RequestTrace",
    "reconstruct_request",
    "list_requests",
    "render_request",
    "render_index",
]

_lock = threading.Lock()
_tls = threading.local()


def mint_trace() -> str:
    """Mint a fresh request trace id (16 hex chars)."""
    return uuid.uuid4().hex[:16]


def current_trace() -> Optional[str]:
    """The thread's ambient trace context (None = no request in flight
    on this thread)."""
    return getattr(_tls, "trace", None)


@contextmanager
def installed(trace: Optional[str]):
    """Install ``trace`` as this thread's ambient context for the
    duration.  ``None`` installs nothing but still restores cleanly (an
    untraced task must not inherit the previous one's context)."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


def stamp() -> dict:
    """The ambient trace field :func:`~pencilarrays_tpu_torch.obs.events.
    record_event` folds into every record (empty when no context is
    ambient)."""
    t = getattr(_tls, "trace", None)
    return {"trace": t} if t else {}


def _reset_for_tests() -> None:
    with _lock:
        _tls.trace = None


# ---------------------------------------------------------------------------
# per-request reconstruction (pa-obs request / requests)
# ---------------------------------------------------------------------------


def _t(e: dict) -> float:
    """Causal timestamp: the skew-corrected ``t_corr`` the timeline
    merger annotates, falling back to raw wall time for events read
    outside a merge."""
    v = e.get("t_corr", e.get("t_wall", 0.0))
    return float(v) if isinstance(v, (int, float)) else 0.0


def _matches(e: dict, trace: str) -> bool:
    if e.get("trace") == trace:
        return True
    traces = e.get("traces")
    return isinstance(traces, (list, tuple)) and trace in traces


@dataclass
class RequestTrace:
    """One request's reconstructed causal timeline.

    ``events`` is the causally ordered record list (router + every
    mesh the request touched, ``t_corr``-annotated); ``critical_path``
    decomposes the end-to-end wall time into the named phases that
    could be derived from the records present — a torn or missing
    journal shrinks the decomposition and grows ``warnings``, it never
    raises."""

    trace: str
    tenant: Optional[str] = None
    events: List[dict] = field(default_factory=list)
    ranks: List[int] = field(default_factory=list)
    outcome: Optional[str] = None
    total_s: Optional[float] = None
    fan_in: Optional[int] = None
    rebinds: int = 0
    critical_path: Dict[str, float] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)


def _critical_path(evs: List[dict]) -> Tuple[Dict[str, float], List[str]]:
    """Decompose one request's records into the phases of its journey.
    Every phase is best-effort: a missing stage record (dead mesh,
    torn tail, pre-v6 journal) drops that phase and appends a warning."""
    warns: List[str] = []

    def first(ev: str, **match):
        for e in evs:
            if e.get("ev") == ev and all(e.get(k) == v
                                         for k, v in match.items()):
                return e
        return None

    def last(ev: str):
        for e in reversed(evs):
            if e.get("ev") == ev:
                return e
        return None

    route = first("fleet.route", reason="placed")
    req = first("serve.request")
    coal = first("serve.coalesce")
    disp = first("serve.dispatch")
    done = last("serve.complete")
    rebinds = [e for e in evs if e.get("ev") == "fleet.route"
               and e.get("reason") == "rebind"]
    failovers = [e for e in evs if e.get("ev") == "fleet.failover"]

    cp: Dict[str, float] = {}
    if route is not None and req is not None:
        # router commit -> mesh admission: KV wire + worker poll (and,
        # after a failover, the whole park-and-rebind detour)
        cp["wire_s"] = max(0.0, _t(req) - _t(route))
    elif route is not None:
        warns.append(
            f"trace {route.get('trace')}: fleet-routed but no "
            f"serve.request record — the placed mesh's journal is "
            f"missing/torn, or the mesh died before admission")
    if req is not None and disp is not None:
        cp["admission_wait_s"] = max(0.0, _t(disp) - _t(req))
    if coal is not None and isinstance(coal.get("wait_s"), (int, float)):
        cp["coalesce_wait_s"] = float(coal["wait_s"])
    if done is not None and isinstance(done.get("seconds"), (int, float)):
        cp["compute_s"] = float(done["seconds"])
        if disp is not None:
            cp["lane_wait_s"] = max(
                0.0, (_t(done) - float(done["seconds"])) - _t(disp))
    elif done is None:
        warns.append(
            "no serve.complete record — the request may still be in "
            "flight, or the resolving mesh's journal tail is torn")
    if failovers:
        cp["failover_s"] = sum(
            float(e.get("detect_s", 0.0)) for e in failovers
            if isinstance(e.get("detect_s"), (int, float)))
    return cp, warns


def reconstruct_request(directory: str, trace: str, *,
                        correct_skew: bool = True
                        ) -> Tuple[Optional[RequestTrace], List[str]]:
    """Rebuild one request's causal timeline from every journal under
    ``directory``.  Returns ``(trace_or_None, warnings)`` — ``None``
    means no record carries the id; warnings carry the merger's
    missing-rank / torn-tail / skew diagnostics plus any phases the
    decomposition could not derive.  Never raises on wreckage."""
    from .timeline import merge_journals

    mt = merge_journals(directory, correct_skew=correct_skew)
    warnings = list(mt.warnings)
    evs = sorted((e for e in mt.events if _matches(e, trace)), key=_t)
    if not evs:
        return None, warnings
    rt = RequestTrace(trace=trace, events=evs,
                      ranks=sorted({int(e.get("proc", 0)) for e in evs}))
    for e in evs:
        if rt.tenant is None and isinstance(e.get("tenant"), str):
            rt.tenant = e["tenant"]
    for e in reversed(evs):
        if e.get("ev") == "serve.complete":
            rt.outcome = e.get("outcome")
            break
    for e in evs:
        if e.get("ev") in ("serve.coalesce", "serve.dispatch") \
                and isinstance(e.get("n"), int):
            rt.fan_in = max(rt.fan_in or 0, e["n"])
    rt.rebinds = sum(1 for e in evs if e.get("ev") == "fleet.route"
                     and e.get("reason") == "rebind")
    rt.total_s = max(0.0, _t(evs[-1]) - _t(evs[0]))
    rt.critical_path, cp_warns = _critical_path(evs)
    warnings.extend(cp_warns)
    rt.warnings = warnings
    return rt, warnings


def list_requests(directory: str, *, correct_skew: bool = True
                  ) -> Tuple[List[dict], List[str]]:
    """Index every traced request under ``directory``: one summary
    dict per trace id, causally ordered by first appearance.  Shared
    fan-in records (``traces``) count toward every member.  Returns
    ``(summaries, warnings)``; wreckage degrades to warnings."""
    from .timeline import merge_journals

    mt = merge_journals(directory, correct_skew=correct_skew)
    index: Dict[str, dict] = {}
    for e in mt.events:
        ids = []
        if isinstance(e.get("trace"), str):
            ids.append(e["trace"])
        if isinstance(e.get("traces"), (list, tuple)):
            ids.extend(t for t in e["traces"] if isinstance(t, str))
        # a batch leader appears in BOTH trace and traces: one record
        # is still one event of its timeline, not two
        for tid in dict.fromkeys(ids):
            s = index.setdefault(tid, {
                "trace": tid, "tenant": None, "events": 0,
                "ranks": set(), "outcome": None, "rebinds": 0,
                "t_first": _t(e), "t_last": _t(e),
            })
            s["events"] += 1
            s["ranks"].add(int(e.get("proc", 0)))
            s["t_first"] = min(s["t_first"], _t(e))
            s["t_last"] = max(s["t_last"], _t(e))
            if s["tenant"] is None and isinstance(e.get("tenant"), str):
                s["tenant"] = e["tenant"]
            if e.get("ev") == "serve.complete" and e.get("trace") == tid:
                s["outcome"] = e.get("outcome")
            if e.get("ev") == "fleet.route" \
                    and e.get("reason") == "rebind" \
                    and e.get("trace") == tid:
                s["rebinds"] += 1
    out = []
    for s in sorted(index.values(), key=lambda s: s["t_first"]):
        s["ranks"] = sorted(s["ranks"])
        s["total_s"] = max(0.0, s["t_last"] - s["t_first"])
        out.append(s)
    return out, list(mt.warnings)


# ---------------------------------------------------------------------------
# text rendering (the pa-obs request / requests commands)
# ---------------------------------------------------------------------------

# the payload fields worth a column on a one-line event rendering
_RENDER_FIELDS = ("tenant", "mesh", "reason", "status", "key", "n",
                  "outcome", "seconds", "wait_s", "lane", "point",
                  "mode", "error", "tickets", "detect_s", "stage",
                  "burn_rate")


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_request(rt: RequestTrace) -> str:
    """One request's causal timeline + critical-path table as text."""
    lines = [
        f"trace {rt.trace}"
        + (f"  tenant={rt.tenant}" if rt.tenant else "")
        + f"  ranks={rt.ranks}"
        + (f"  fan_in={rt.fan_in}" if rt.fan_in else "")
        + (f"  rebinds={rt.rebinds}" if rt.rebinds else "")
        + (f"  outcome={rt.outcome}" if rt.outcome else ""),
    ]
    t0 = _t(rt.events[0]) if rt.events else 0.0
    for e in rt.events:
        extras = "  ".join(
            f"{k}={_fmt_val(e[k])}" for k in _RENDER_FIELDS if k in e)
        lines.append(f"  +{_t(e) - t0:9.4f}s  r{e.get('proc', 0)}  "
                     f"{e.get('ev', '?'):<18} {extras}".rstrip())
    if rt.critical_path:
        lines.append("critical path:")
        for k, v in rt.critical_path.items():
            lines.append(f"  {k:<18} {v:.4f}s")
    if rt.total_s is not None:
        lines.append(f"  {'total_s':<18} {rt.total_s:.4f}s")
    return "\n".join(lines)


def render_index(summaries: List[dict]) -> str:
    """The ``pa-obs requests`` listing as text."""
    if not summaries:
        return "no traced requests (v6 journals carry a 'trace' field)"
    lines = [f"{'trace':<18} {'tenant':<10} {'events':>6} "
             f"{'ranks':<10} {'rebinds':>7} {'total_s':>9} outcome"]
    for s in summaries:
        lines.append(
            f"{s['trace']:<18} {str(s['tenant'] or '-'):<10} "
            f"{s['events']:>6} {','.join(map(str, s['ranks'])):<10} "
            f"{s['rebinds']:>7} {s['total_s']:>9.4f} "
            f"{s['outcome'] or '-'}")
    return "\n".join(lines)
