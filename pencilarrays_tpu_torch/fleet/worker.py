"""The mesh-side fleet back-end: one PlanService behind the KV wire (the
JAX package's ``fleet/worker.py``, ported).

A :class:`MeshWorker` is what a back-end mesh's coordinator process
runs: it heartbeats the mesh's health lease
(:class:`~pencilarrays_tpu_torch.fleet.health.MeshLease`), exports its
service's :class:`~pencilarrays_tpu_torch.serve.slo.LoadTracker`
projection and warm plan fingerprints for the router's placement
scoring, polls its ``req/m<k>`` directory for routed requests, executes
them through the wrapped :class:`~pencilarrays_tpu_torch.serve.
PlanService`, and publishes results.

The worker consults the ``fleet.route`` fault point once per routed
request it takes — with ``PENCILARRAYS_TPU_FLEET_MESH`` set in the
worker's environment, a single shared spec like
``fleet.route:kill%mesh1@4`` SIGKILLs exactly mesh 1's admission path
on its 4th routed request and nobody else's (the whole-mesh chaos
drill).

Request keys are deleted only AFTER the result is published (the
result key is the commit point): a worker that dies between the two
leaves a request whose result already exists, and both the router and
a replacement worker treat the published result as authoritative —
execution is at-least-once under failover (FFT dispatch is pure), but
every ticket *resolves* exactly once on the router side.

A mesh of several ranks (the port's own layout): in the JAX package one
mesh is one process; here a mesh of P ranks is P processes, each running
a worker over its own :class:`~pencilarrays_tpu_torch.serve.PlanService`
(the serve determinism contract).  The mesh's rank 0 speaks for it on
the wire: it beats the lease, exports the load, lists ``req/m<k>`` and
decides each take, which every rank receives
(:func:`~pencilarrays_tpu_torch.parallel.distributed.agree`: the ticket
ids in order, and the stop signal), so every rank submits the same
requests in the same order and drains at the same point.  Each rank
reads the requests it was given from the KV itself (they stay there
until rank 0 publishes their results); results are gathered to rank 0,
which publishes them, as the JAX package's ``_publish`` gathers.  The
ranks agree on every outcome as well (:func:`~pencilarrays_tpu_torch.
parallel.distributed.agree_all`): a request stays admitted only if every
rank admitted it, and its result is gathered only if every rank's
succeeded; otherwise rank 0 publishes the first rank's error, so the
queues never diverge and no rank waits alone in a gather.  The mesh's
topology is that of its registered plans.
"""

from __future__ import annotations

import json
import time
from typing import Iterable, Optional

import numpy as np

from ..parallel.distributed import agree, agree_all
from . import wire
from .health import MeshLease

__all__ = ["MeshWorker"]


class MeshWorker:
    """One mesh's back-end loop (owns nothing it was not given: the
    ``service`` — and through it the engine/topology — is built by the
    caller so drills, benches and deployments control their own mesh
    shape)."""

    def __init__(self, kv, mesh: int, *, service, namespace: str = "pa",
                 ttl: float = 5.0, interval: Optional[float] = None,
                 tier: str = "dcn", result_timeout_s: float = 60.0,
                 load_every_s: float = 0.05):
        self.kv = kv
        self.mesh = int(mesh)
        self.service = service
        self.ns = namespace
        self.tier = tier
        self.result_timeout_s = float(result_timeout_s)
        self.load_every_s = float(load_every_s)
        self.lease = MeshLease(kv, self.mesh, ttl=ttl,
                               interval=interval, namespace=namespace)
        self._warm: set = set()     # plan names executed at least once
        self._handled = 0
        self._stopped = False
        self._t_load = 0.0
        self._halt_at: Optional[float] = None   # run()'s max_seconds
        self._halted = False

    # -- the mesh's ranks ---------------------------------------------------
    def _topology(self):
        """The mesh's topology when it spans several ranks (that of the
        first such registered plan), else None: one rank, no agreement."""
        for plan in list(getattr(self.service, "_named", {}).values()):
            topo = plan.topology
            if len(topo) > 1 and topo.connected:
                return topo
        return None

    def _speaks(self) -> bool:
        """Whether this process speaks for the mesh on the wire (its
        rank 0, or the only rank)."""
        topo = self._topology()
        return topo is None or topo.rank_local == 0

    # -- placement inputs ---------------------------------------------------
    def prewarm(self, names: Iterable[str]) -> None:
        """Mark plan names as compile-warm without executing them —
        what a mesh restored from a compile cache (or deliberately
        prewarmed, see ``Autoscaler.prewarm_plans``) advertises."""
        self._warm.update(names)

    def publish_load(self, *, force: bool = False) -> None:
        """Export this mesh's placement inputs: the service's live
        load projection plus the name->fingerprint map and the warm
        set (``plan_key()`` strings — the compile-cache locality term
        of the router's scoring).  Rank 0 of the mesh exports."""
        now = time.time()
        if not force and now - self._t_load < self.load_every_s:
            return
        self._t_load = now
        if not self._speaks():
            return
        plans = {}
        for name, plan in getattr(self.service, "_named", {}).items():
            try:
                plans[name] = plan.plan_key()
            except Exception:   # pragma: no cover - a broken plan must
                continue        # not unpublish the healthy ones
        warm = sorted(plans[n] for n in self._warm if n in plans)
        # kv-unfenced: own-mesh telemetry export, overwrite-latest —
        # a stale export only mis-scores placement for one cache age
        self.kv.set(wire.load_key(self.ns, self.mesh), json.dumps({
            "t": now, "mesh": self.mesh, "tier": self.tier,
            "projection": self.service.load_projection(),
            "plans": plans, "warm": warm,
        }))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """First beat + load export synchronously (the router must be
        able to place onto this mesh the moment ``start`` returns),
        then heartbeat from a daemon thread (rank 0 of the mesh)."""
        if self._speaks():
            self.lease.start()
        self.publish_load(force=True)

    def stop(self) -> None:
        self._stopped = True
        self.lease.stop()

    def leave(self) -> None:
        """Graceful retire: durable leave record, then stop."""
        if self._speaks():
            self.lease.leave()
        self._stopped = True

    def close(self) -> None:
        self.stop()
        self.service.close(drain=False)

    @property
    def stopped(self) -> bool:
        return self._stopped

    @property
    def handled(self) -> int:
        return self._handled

    # -- the wire loop ------------------------------------------------------
    def _poll(self, reqs: dict) -> dict:
        """Rank 0's take: the stop signal, or the pending routed
        requests in key order (decoded into ``reqs``); or
        the end of :meth:`run`'s ``max_seconds``, by rank 0's clock."""
        if self._halt_at is not None and time.monotonic() > self._halt_at:
            return {"stop": False, "halt": True, "take": []}
        if self.kv.try_get(wire.stop_key(self.ns, self.mesh)) is not None:
            return {"stop": True, "take": []}
        take = []
        for key in sorted(self.kv.list_dir(wire.req_dir(self.ns,
                                                        self.mesh))):
            tid = wire.ticket_id_of(key)
            if self.kv.try_get(wire.res_key(self.ns, tid)) is not None:
                # a predecessor died between publish and req-GC: the
                # result is authoritative, never re-execute
                # kv-unfenced: consuming a request addressed to this
                # mesh whose result already exists
                self.kv.delete(key)
                continue
            raw = self.kv.try_get(key)
            if raw is None:
                continue        # router re-bound it away mid-listing
            try:
                reqs[key] = wire.decode_request(raw)
            except Exception:   # pragma: no cover - a torn publish is
                continue        # retried by the next poll
            take.append([key, tid])
        return {"stop": False, "take": take}

    def step(self) -> int:
        """One poll round: honor a stop signal, take every pending
        routed request, execute through the service, publish results.
        Returns the number of requests completed this round."""
        if self._stopped:
            return 0
        reqs: dict = {}
        topo = self._topology()
        if topo is None:
            decision = self._poll(reqs)
        else:
            decision = agree(topo, f"fleet-take-m{self.mesh}",
                             lambda: self._poll(reqs))
        if decision["stop"]:
            self.leave()
            return 0
        if decision.get("halt"):
            self._halted = True
            return 0
        taken: list = []
        for key, tid in decision["take"]:
            req = reqs.get(key)
            if req is None:
                # a rank other than 0 reads the request itself: it stays
                # on the wire until rank 0 publishes its result
                raw = self.kv.try_get(key)
                if raw is None:
                    raise RuntimeError(
                        f"mesh {self.mesh}: rank 0 took {key}, which this "
                        f"rank cannot read from the KV")
                req = wire.decode_request(raw)
            refusal = self._take(tid, req, several=topo is not None)
            if topo is not None:
                # one outcome on every rank (admitted where every rank
                # admitted it): a rank that admitted a request another
                # refused withdraws it, one that refused spends its
                # admission number, so the queues stay equal
                outs = agree_all(topo, f"fleet-admit-m{self.mesh}",
                                 refusal)
                refusal = next((o for o in outs if o is not None), None)
                if refusal is not None and None in outs:
                    self.service.queue.cancel_split(
                        req.pop("_ticket", None),
                        wire.decode_result(refusal)[2])
            if refusal is None:
                taken.append((key, tid, req))
            else:
                self._answer(key, tid, refusal)
        done = 0
        if taken:
            self.service.drain()
            self._publish(topo, taken)
            done = len(taken)
        self.publish_load(force=bool(taken))
        return done

    def _take(self, tid: str, req: dict, several: bool = False
              ) -> Optional[str]:
        """Admit one routed request into the service (the mesh's
        admission path — the ``fleet.route`` injection point fires
        here, addressable per mesh via ``%mesh<k>``).  Returns None, or
        the encoded result of a request that resolved typed at
        admission.  On a mesh of ``several`` ranks a request refused
        here still goes to the service, which refuses it on every rank
        (the other ranks' admissions wait for this rank's vote)."""
        from ..obs import requestflow
        from ..resilience import faults
        from ..serve.errors import ServeError

        self._handled += 1
        try:
            # install the inbound trace as ambient context: the serve
            # layer adopts it (never re-mints — trace-ctx lint) and a
            # fault fired HERE journals under the dying request's id
            with requestflow.installed(req.get("trace")):
                refused = None
                try:
                    faults.fire("fleet.route", mesh=self.mesh, ticket=tid,
                                tenant=req["tenant"])
                except faults.InjectedFault as e:
                    if not several:
                        raise
                    refused = e
                ticket = self.service.submit(
                    req["tenant"], np.ascontiguousarray(req["payload"]),
                    name=req["name"], direction=req["direction"],
                    _refusal=refused)
        except Exception as e:
            if not isinstance(e, (ServeError, faults.InjectedFault)):
                raise
            return wire.encode_result(tid, error=e, mesh=self.mesh)
        req["_ticket"] = ticket
        req["_t0"] = time.monotonic()
        self._warm.add(req["name"])
        return None

    def _answer(self, key: str, tid: str, payload: str) -> None:
        """Rank 0 publishes one request's result: the result first, then
        the request's deletion (the result key is the commit point)."""
        if not self._speaks():
            return
        # kv-unfenced: ticket-unique result key — a duplicate
        # publication (re-bound ticket, two answering meshes) is
        # deduped by the router's _resolved set, never re-raised
        self.kv.set(wire.res_key(self.ns, tid), payload)
        self.kv.delete(key)  # kv-unfenced: consume own request

    def _publish(self, topo, taken: list) -> None:
        """Publish the results of the requests a step executed.  On a
        mesh of several ranks the ranks first agree on each request's
        outcome: where every rank succeeded they gather the result to
        rank 0 (a collective), else rank 0 publishes the first rank's
        error, so no rank waits alone in a gather."""
        failures = []
        for _, tid, req in taken:
            ticket = req["_ticket"]
            if not ticket.done():   # drain() returned without resolving
                try:                # it (a reform mid-batch): wait it out
                    ticket.result(self.result_timeout_s)
                except Exception:
                    pass
            req["_s"] = time.monotonic() - req["_t0"]
            err = ticket.error()
            if err is None and not ticket.done():
                err = TimeoutError(
                    f"mesh {self.mesh}: request {tid} did not resolve "
                    f"within {self.result_timeout_s}s")
            failures.append(None if err is None else wire.encode_result(
                tid, error=err, seconds=req["_s"], mesh=self.mesh))
        if topo is not None:
            failures = [next((o for o in outs if o is not None), None)
                        for outs in zip(*agree_all(
                            topo, f"fleet-result-m{self.mesh}", failures))]
        for (key, tid, req), failure in zip(taken, failures):
            if failure is None:
                from ..parallel.gather import gather

                # every rank of the mesh gathers; rank 0 holds the result
                value = gather(req["_ticket"].result(0))
                failure = wire.encode_result(
                    tid, value=np.asarray(value), seconds=req["_s"],
                    mesh=self.mesh) if self._speaks() else None
            self._answer(key, tid, failure)

    def run(self, *, poll_s: float = 0.01,
            max_seconds: Optional[float] = None) -> None:
        """The subprocess main loop: poll until a stop signal (or
        ``max_seconds``, a drill safety net, by the clock of the mesh's
        rank 0, so every rank leaves the loop at the same step)."""
        self._halted = False
        self._halt_at = (time.monotonic() + max_seconds
                         if max_seconds is not None else None)
        try:
            while not (self._stopped or self._halted):
                self.step()
                time.sleep(poll_s)
        finally:
            self._halt_at = None
