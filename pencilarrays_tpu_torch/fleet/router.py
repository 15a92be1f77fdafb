"""The fleet front-end: admission, two-tier placement, failover.

:class:`FleetRouter` owns client admission for a federation of
:class:`~pencilarrays_tpu_torch.serve.PlanService` back-ends and talks to
them exclusively over the KV wire (:mod:`~pencilarrays_tpu_torch.fleet.wire`).
Placement scores every live candidate mesh in bytes-equivalent through
the two-tier intra-mesh/DCN model (:mod:`~pencilarrays_tpu_torch.fleet.cost`):
plan-fingerprint affinity (compile-cache locality via ``plan_key()``),
projected drain (each mesh's exported
:class:`~pencilarrays_tpu_torch.serve.slo.LoadTracker` snapshot) and the
tenant's SLO class.  Every decision is journaled as ``fleet.route``.

The robustness core mirrors the PR-15 park/resubmit machinery one
level up: a mesh whose health lease expires
(:class:`~pencilarrays_tpu_torch.fleet.health.MeshBoard`, typed
:class:`~pencilarrays_tpu_torch.fleet.errors.MeshFailureError` in ~ttl
seconds) has its pending tickets *parked* and re-bound to a sibling
mesh (``fleet.failover``, fsync-critical — the journal record must
survive whatever happens next).  Tickets re-bind at most
``max_rebinds`` times; requests cross the wire in the host-array
global-logical form, so a re-bound request re-scatters onto whatever
topology the sibling runs — the same rebind-safe form elastic
reformation already requires.

The exactly-once contract: every submitted ticket resolves exactly
once — a result, a typed
:class:`~pencilarrays_tpu_torch.serve.errors.DeadlineError`, or a typed
:class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError`
(``reason="no-mesh"`` when no live mesh remains,
``"rebind-exhausted"`` past the rebind bound) — under whole-mesh
loss included.  A mesh that published its result and THEN died
resolves from the result (checked before every re-bind); duplicate
results for an already-resolved ticket are ignored, never re-raised.

That contract now survives the router's OWN death: constructed with a
``wal_dir``, the router write-AHEAD logs every admission, placement
and completion (:mod:`~pencilarrays_tpu_torch.fleet.wal` — fsync'd,
CRC-framed, torn-tail tolerant) *before* the matching wire write.  A
restarted router calls :meth:`FleetRouter.recover`: completions seed
the dedup set (a mesh re-answering an already-answered ticket is
counted and dropped), every unresolved ticket is re-parked exactly as
a dead mesh's tickets are — so the next pump resolves it from a
published result when one exists and re-binds it otherwise.
Execution stays at-least-once; *resolution* is exactly-once.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import wal as _walmod
from . import wire
from ..obs import requestflow
from .cost import FleetCost
from .health import MeshBoard

__all__ = ["FleetRouter"]


class _Pending:
    """Router-side state of one unresolved ticket (internal)."""

    __slots__ = ("ticket", "tid", "tenant", "name", "direction",
                 "payload", "nbytes", "deadline_s", "t_submit",
                 "mesh", "rebinds", "trace")

    def __init__(self, ticket, tid, tenant, name, direction, payload,
                 nbytes, deadline_s, trace=None):
        self.ticket = ticket
        self.tid = tid
        self.tenant = tenant
        self.name = name
        self.direction = direction
        self.payload = payload
        self.nbytes = nbytes
        self.deadline_s = deadline_s
        self.t_submit = time.time()
        self.mesh: Optional[int] = None     # None = parked
        self.rebinds = 0
        self.trace = trace                  # minted ONCE at admission


class FleetRouter:
    """Front-end admission + placement across N mesh back-ends."""

    def __init__(self, kv, *, namespace: str = "pa", ttl: float = 5.0,
                 join_grace: Optional[float] = None,
                 cost: Optional[FleetCost] = None,
                 slos: Optional[dict] = None, max_rebinds: int = 4,
                 load_max_age_s: float = 0.25,
                 wal_dir: Optional[str] = None):
        self.kv = kv
        # durability is opt-in per router: no wal_dir = the pre-WAL
        # in-memory router (tests that don't exercise restart)
        self._wal = (_walmod.RouterWAL(wal_dir)
                     if wal_dir is not None else None)
        self.ns = namespace
        self.cost = cost if cost is not None else FleetCost.from_env()
        self.board = MeshBoard(kv, ttl=ttl, join_grace=join_grace,
                               namespace=namespace)
        self.slos = dict(slos or {})
        self.max_rebinds = int(max_rebinds)
        self.load_max_age_s = float(load_max_age_s)
        self._lock = threading.Lock()
        self._meshes: Dict[int, dict] = {}      # id -> {"tier", "dead"}
        self._pending: Dict[str, _Pending] = {}
        self._resolved: set = set()
        self._closed = False
        self._stop = threading.Event()
        self._thread = None
        self._load_cache: Dict[int, tuple] = {}  # mesh -> (t, state)
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "rebound": 0, "duplicates": 0, "expired": 0}

    # -- membership ---------------------------------------------------------
    def register_mesh(self, mesh: int, *, tier: str = "dcn") -> None:
        """Declare a candidate back-end (``tier="colo"`` = the
        router's own failure domain, DCN-toll-free)."""
        with self._lock:
            self._meshes[int(mesh)] = {"tier": tier, "dead": None}

    def discover(self, *, tier: str = "dcn") -> List[int]:
        """Register every mesh with a published load export (the
        supervisor's spawned joiners enter here)."""
        found = []
        prefix = f"{wire.fleet_ns(self.ns)}/load"
        for key in self.kv.list_dir(prefix):
            seg = key.rsplit("/", 1)[-1]
            if seg.startswith("m"):
                try:
                    mesh = int(seg[1:])
                except ValueError:
                    continue
                if mesh not in self._meshes:
                    self.register_mesh(mesh, tier=tier)
                    found.append(mesh)
        return found

    def meshes(self) -> List[int]:
        with self._lock:
            return sorted(self._meshes)

    def live_meshes(self) -> List[int]:
        with self._lock:
            cands = [m for m, st in self._meshes.items()
                     if st["dead"] is None]
        return self.board.live_meshes(cands)

    # -- placement ----------------------------------------------------------
    def _mesh_state(self, mesh: int) -> dict:
        """The mesh's load export, cached ``load_max_age_s`` (placement
        is per-request; the export changes at worker-poll cadence)."""
        now = time.monotonic()
        hit = self._load_cache.get(mesh)
        if hit is not None and now - hit[0] <= self.load_max_age_s:
            return hit[1]
        state = {"plans": {}, "warm": [], "projection": None,
                 "tier": None}
        raw = self.kv.try_get(wire.load_key(self.ns, mesh))
        if raw is not None:
            try:
                state.update(json.loads(raw))
            except ValueError:      # pragma: no cover - torn export:
                pass                # score conservatively-blind
        self._load_cache[mesh] = (now, state)
        return state

    def _backlog(self, state: dict) -> float:
        p = state.get("projection") or {}
        q = p.get("queued_cost_bytes") or 0
        i = p.get("inflight_cost_bytes") or 0
        return float(q) + float(i)

    def _place(self, name: str, nbytes: int,
               deadline_s: Optional[float],
               exclude: Optional[set] = None) -> Optional[tuple]:
        """Score every live candidate; returns ``(mesh, score_parts)``
        or None when no live mesh remains."""
        exclude = exclude or set()
        with self._lock:
            cands = [m for m, st in self._meshes.items()
                     if st["dead"] is None and m not in exclude]
        best = None
        for mesh in self.board.live_meshes(cands):
            state = self._mesh_state(mesh)
            fp = (state.get("plans") or {}).get(name)
            warm = fp is not None and fp in (state.get("warm") or [])
            with self._lock:
                tier = self._meshes[mesh]["tier"]
            score = self.cost.score(
                nbytes_in=nbytes, nbytes_out=nbytes, tier=tier,
                warm=warm, backlog=self._backlog(state),
                deadline_s=deadline_s)
            if best is None or score["total"] < best[1]["total"]:
                best = (mesh, score)
        return best

    # -- admission ----------------------------------------------------------
    def submit(self, tenant: str, u, *, name: str,
               direction: str = "forward"):
        """Admit one request into the fleet: place, publish on the
        wire, return the :class:`~pencilarrays_tpu_torch.serve.queue.Ticket`.
        No live placeable mesh fails typed
        (``AdmissionError(reason="no-mesh")``) — admission never
        silently queues against a dead fleet."""
        from ..resilience import faults
        from ..serve.errors import AdmissionError
        from ..serve.queue import Ticket

        if self._closed:
            from ..serve.errors import ServiceClosedError

            raise ServiceClosedError("fleet router is closed")
        faults.fire("fleet.route", tenant=tenant, name=name)
        payload = np.asarray(u)
        nbytes = int(payload.nbytes)
        slo = self.slos.get(tenant)
        deadline_s = slo.deadline_s if slo is not None else None
        ticket = Ticket(tenant, "fleet", f"fleet:{name}:{direction}")
        tid = str(ticket.id)
        # the request's trace context, minted ONCE here at fleet
        # admission and propagated through every re-encode/rebind
        # (obs/requestflow.py; the trace-ctx lint audits the path)
        trace = requestflow.mint_trace()
        placed = self._place(name, nbytes, deadline_s)
        if placed is None:
            self._journal_route(tid, tenant, -1, "no-mesh", None, trace)
            raise AdmissionError(
                f"tenant {tenant!r}: no live mesh can take "
                f"{name!r} (fleet has {len(self.meshes())} registered, "
                f"0 placeable)", tenant=tenant, reason="no-mesh")
        mesh, score = placed
        p = _Pending(ticket, tid, tenant, name, direction, payload,
                     nbytes, deadline_s, trace)
        p.mesh = mesh
        req = wire.encode_request(
            tid, tenant=tenant, name=name, direction=direction,
            payload=payload, t_submit=p.t_submit,
            deadline_s=deadline_s, trace=trace)
        # write-AHEAD: the admission is durable BEFORE the wire sees
        # the request — a router killed between these two writes
        # recovers a parked ticket, never a ghost execution; one that
        # published and then died recovers the same ticket and finds
        # the mesh's result.  An unappendable WAL fails the admission
        # (OSError propagates) rather than accepting an un-logged
        # ticket.
        if self._wal is not None:
            self._wal.append({"op": "admit", "tid": tid, "req": req})
            self._wal.append({"op": "place", "tid": tid, "mesh": mesh,
                              "rebinds": 0})
        with self._lock:
            self._pending[tid] = p
            self._stats["submitted"] += 1
        # kv-unfenced: ticket-unique wire key; the WAL append above is
        # the durability gate, and duplicate results dedup in _resolve
        self.kv.set(wire.req_key(self.ns, mesh, tid), req)
        self._journal_route(tid, tenant, mesh, "placed", score, trace)
        return ticket

    def _journal_route(self, tid, tenant, mesh, reason, score,
                       trace) -> None:
        from .. import obs

        if not obs.enabled():
            return
        fields = {"ticket": tid, "tenant": tenant, "mesh": mesh,
                  "reason": reason, "trace": trace,
                  "score_bytes": (score["total"] if score else None)}
        if score:
            fields.update(wire_bytes=score["wire"],
                          affinity_bytes=score["affinity"],
                          backlog_bytes=score["backlog"])
        obs.record_event("fleet.route", **fields)

    # -- resolution (exactly-once) -----------------------------------------
    def _resolve(self, tid: str, *, value=None, error=None) -> bool:
        """Resolve a ticket EXACTLY once; late duplicates are counted
        and dropped.  GCs the ticket's wire keys."""
        with self._lock:
            if tid in self._resolved:
                self._stats["duplicates"] += 1
                return False
            self._resolved.add(tid)
            p = self._pending.pop(tid, None)
            self._stats["completed" if error is None else "failed"] += 1
        if self._wal is not None:
            # after the dedup gate: exactly one complete per ticket
            # per router life; replay dedups across lives
            self._wal.append({
                "op": "complete", "tid": tid,
                "outcome": ("ok" if error is None
                            else type(error).__name__)})
        if p is not None:
            if error is None:
                p.ticket._fulfill(value)
            else:
                p.ticket._fail(error)
            if p.mesh is not None:
                # kv-unfenced: GC of this ticket's own wire keys after
                # the exactly-once gate above admitted the resolution
                self.kv.delete(wire.req_key(self.ns, p.mesh, p.tid))
        self.kv.delete(wire.res_key(self.ns, tid))  # kv-unfenced: GC
        return True

    def _try_result(self, tid: str) -> bool:
        raw = self.kv.try_get(wire.res_key(self.ns, tid))
        if raw is None:
            return False
        try:
            _meta, value, err = wire.decode_result(raw)
        except Exception:       # pragma: no cover - torn publish:
            return False        # the next pump retries
        return self._resolve(tid, value=value, error=err)

    # -- the pump -----------------------------------------------------------
    def pump(self) -> dict:
        """One router round: harvest results, expire deadlines, detect
        dead meshes, re-bind their tickets.  Returns a summary dict."""
        from ..serve.errors import DeadlineError

        summary = {"resolved": 0, "rebound": 0, "dead": []}
        with self._lock:
            tids = list(self._pending)
        for tid in tids:
            if self._try_result(tid):
                summary["resolved"] += 1
        # deadline safety net: a ticket whose budget lapsed while its
        # mesh sat dead (or its request sat unread) fails typed here —
        # the worker-side service owns the projected/expired paths for
        # requests it actually saw
        now = time.time()
        with self._lock:
            expired = [p for p in self._pending.values()
                       if p.deadline_s is not None
                       and now - p.t_submit > p.deadline_s]
        for p in expired:
            if self._try_result(p.tid):
                summary["resolved"] += 1
                continue
            with self._lock:
                self._stats["expired"] += 1
            self._journal_route(p.tid, p.tenant, p.mesh
                                if p.mesh is not None else -1,
                                "expired", None, p.trace)
            self._resolve(p.tid, error=DeadlineError(
                f"tenant {p.tenant!r}: request {p.tid} missed its "
                f"{p.deadline_s}s deadline in the fleet queue",
                tenant=p.tenant, reason="expired",
                deadline_s=p.deadline_s))
        summary["dead"] = self._sweep_health()
        summary["rebound"] = self._flush_parked()
        return summary

    def _sweep_health(self) -> List[int]:
        """Detect newly-dead meshes; park their pending tickets."""
        from .. import obs

        with self._lock:
            alive = [m for m, st in self._meshes.items()
                     if st["dead"] is None]
        newly_dead = []
        for mesh, err in self.board.dead_meshes(alive):
            with self._lock:
                self._meshes[mesh]["dead"] = err
                parked = [p for p in self._pending.values()
                          if p.mesh == mesh]
                for p in parked:
                    p.mesh = None
            newly_dead.append(mesh)
            detect_s = getattr(err, "age_s", None)
            if obs.enabled():
                # the parked tickets' trace ids ride the failover
                # record: pa-obs request joins each affected request's
                # timeline to the ONE sweep that re-bound it
                obs.record_event(
                    "fleet.failover", mesh=mesh, tickets=len(parked),
                    detect_s=detect_s, error=type(err).__name__,
                    traces=[p.trace for p in parked
                            if p.trace is not None],
                    _fsync=True)
        return newly_dead

    def _flush_parked(self) -> int:
        """Re-bind every parked ticket to a sibling mesh (the PR-15
        park/resubmit discipline at mesh granularity).  A parked
        ticket whose dead mesh already published its result resolves
        from the result instead — never a wasted re-execution, never
        a duplicate resolution."""
        from ..serve.errors import AdmissionError

        with self._lock:
            parked = [p for p in self._pending.values()
                      if p.mesh is None]
        rebound = 0
        for p in parked:
            if self._try_result(p.tid):
                continue
            p.rebinds += 1
            if p.rebinds > self.max_rebinds:
                self._journal_route(p.tid, p.tenant, -1,
                                    "rebind-exhausted", None, p.trace)
                self._resolve(p.tid, error=AdmissionError(
                    f"tenant {p.tenant!r}: request {p.tid} re-bound "
                    f"{self.max_rebinds}x and still found no stable "
                    f"mesh", tenant=p.tenant,
                    reason="rebind-exhausted"))
                continue
            placed = self._place(p.name, p.nbytes, p.deadline_s)
            if placed is None:
                self._journal_route(p.tid, p.tenant, -1, "no-mesh",
                                    None, p.trace)
                self._resolve(p.tid, error=AdmissionError(
                    f"tenant {p.tenant!r}: request {p.tid} lost its "
                    f"mesh and no live sibling remains",
                    tenant=p.tenant, reason="no-mesh"))
                continue
            mesh, score = placed
            p.mesh = mesh
            req = wire.encode_request(
                p.tid, tenant=p.tenant, name=p.name,
                direction=p.direction, payload=p.payload,
                t_submit=p.t_submit, deadline_s=p.deadline_s,
                rebinds=p.rebinds, trace=p.trace)
            if self._wal is not None:
                # write-AHEAD again: the re-bind is durable before the
                # sibling mesh can see (and answer) the request
                self._wal.append({"op": "place", "tid": p.tid,
                                  "mesh": mesh, "rebinds": p.rebinds})
            # kv-unfenced: ticket-unique wire key (WAL-logged above);
            # a double-publish resolves once via the _resolved dedup
            self.kv.set(wire.req_key(self.ns, mesh, p.tid), req)
            self._journal_route(p.tid, p.tenant, mesh, "rebind", score,
                                p.trace)
            with self._lock:
                self._stats["rebound"] += 1
            rebound += 1
        return rebound

    # -- recovery -----------------------------------------------------------
    def recover(self, wal_dir: Optional[str] = None) -> dict:
        """Replay a WAL into this (fresh) router: seed the dedup set
        from every logged completion, re-park every unresolved ticket.
        Call once, after construction and mesh registration, before
        the first pump — the pump then resolves each recovered ticket
        from its mesh's published result when one exists and re-binds
        it otherwise (exactly-once resolution, at-least-once
        execution).

        Read-only on the log (replaying a replayed WAL is a no-op for
        an empty router and skips already-known tickets otherwise).
        Recovered tickets keep their original ``t_submit`` — a
        deadline that lapsed while the router sat dead still fails
        typed, never silently extends — and their logged rebind count,
        so the ``max_rebinds`` budget spans router lives.  Returns a
        summary dict; journals ``fleet.wal`` (fsync-critical) and
        bumps ``fleet.wal_replays{outcome}``.
        """
        from .. import obs
        from ..serve.queue import Ticket

        d = wal_dir if wal_dir is not None else (
            self._wal.dir if self._wal is not None else None)
        if d is None:
            raise ValueError(
                "recover() needs a WAL: pass wal_dir or construct "
                "the router with one")
        records, skipped = _walmod.read_wal(d)
        state = _walmod.replay(records)
        with self._lock:
            self._resolved |= state["resolved"]
        reparked = undecodable = 0
        for tid, ent in state["pending"].items():
            with self._lock:
                if tid in self._pending or tid in self._resolved:
                    continue
            try:
                req = wire.decode_request(ent["req"])
                payload = req["payload"]
                p = _Pending(None, tid, req["tenant"], req["name"],
                             req["direction"], payload,
                             int(payload.nbytes), req.get("deadline_s"),
                             req.get("trace"))
            except Exception:
                # a committed admit we cannot decode is forensics, not
                # a crash loop — count it and keep recovering the rest
                undecodable += 1
                continue
            p.ticket = Ticket(p.tenant, "fleet",
                              f"fleet:{p.name}:{p.direction}")
            # the WAL tid is the wire identity; the fresh Ticket's own
            # id is irrelevant (nobody held the old Ticket object —
            # its waiter died with the old router)
            p.t_submit = float(req["t_submit"])
            p.rebinds = int(ent.get("rebinds") or 0)
            p.mesh = None       # re-parked: same path as a dead mesh
            with self._lock:
                self._pending[tid] = p
                self._stats["submitted"] += 1
            reparked += 1
        outcome = "clean" if skipped == 0 and undecodable == 0 \
            else "torn-tail"
        if obs.enabled():
            obs.counter("fleet.wal_replays", outcome=outcome).inc()
            obs.record_event(
                "fleet.wal", dir=d, outcome=outcome,
                replayed=len(records), resolved=len(state["resolved"]),
                reparked=reparked, skipped=skipped,
                undecodable=undecodable,
                duplicates=state["duplicates"], _fsync=True)
        return {"outcome": outcome, "replayed": len(records),
                "resolved": len(state["resolved"]),
                "reparked": reparked, "skipped": skipped,
                "undecodable": undecodable,
                "duplicates": state["duplicates"]}

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: float, *, poll_s: float = 0.005) -> int:
        """Pump until every pending ticket resolved (or ``timeout``).
        Returns the number still pending."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.pump()
            with self._lock:
                if not self._pending:
                    return 0
            time.sleep(poll_s)
        with self._lock:
            return len(self._pending)

    def start(self, *, interval_s: float = 0.02) -> None:
        """Pump from a daemon thread (tests and drills mostly pump
        explicitly; a deployment wants the background sweep)."""
        if self._thread is not None:
            return
        from ..engine.threads import spawn_thread

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.pump()
                except Exception:   # pragma: no cover - the pump must
                    pass            # outlive KV weather

        self._thread = spawn_thread(_loop, name="pa-fleet-router")

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self._closed = True
        self.stop()
        if self._wal is not None:
            self._wal.close()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["pending"] = len(self._pending)
            out["meshes"] = len(self._meshes)
            out["dead_meshes"] = sorted(
                m for m, st in self._meshes.items()
                if st["dead"] is not None)
        return out
