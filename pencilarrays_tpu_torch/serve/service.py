"""The multi-tenant plan service — concurrent FFT/reshard workloads on
one resident mesh (the JAX package's ``serve/service.py``, ported).

Every ingredient exists in the layers below; this module is the thin,
deterministic loop that composes them into a *service*:

* the **registry** (:mod:`~pencilarrays_tpu_torch.serve.registry`) resolves
  each request's plan fingerprint to ONE resident
  :class:`~pencilarrays_tpu_torch.ops.fft.CompiledPlan` executable, shared
  across tenants (``compile.cache_*{cache="serve"}`` counters);
* the **admission queue** (:mod:`~pencilarrays_tpu_torch.serve.queue`)
  enforces per-tenant quotas, coalesces same-fingerprint requests
  along ``extra_dims`` into one batched dispatch (bytes ×B, collective
  count ×1 — the batched plan's amortization applied to live traffic),
  and
  orders mixed-plan batches by their ``collective_costs`` price so
  small requests are not starved behind huge ones;
* every batch dispatch runs under
  :func:`~pencilarrays_tpu_torch.guard.recover.guarded_step` — the
  **isolation path**: a detected corruption (SDC probe mismatch, hang
  watchdog) inside one batch surfaces as a typed
  :class:`~pencilarrays_tpu_torch.guard.IntegrityError` on THAT batch's
  tickets, after the ladder's retries; queued batches — other
  tenants' or the same tenant's later traffic — dispatch next,
  unpoisoned.  With the integrity guard armed
  (``PENCILARRAYS_TPU_GUARD``), dispatch takes the *eager* schedule
  (per-hop invariant probes, the instrumented path); with it off, the
  registry's single-dispatch compiled executable (the fast path);
* execution rides the per-mesh **engine**
  (:mod:`~pencilarrays_tpu_torch.engine`): every batch becomes one ordered
  dispatch-queue task — the batch's host-side packing (the numpy
  stack of host payloads) runs on the engine's host pool, OVERLAPPED
  with the previous batch's device compute, and the device program is
  issued by the engine's single consumer thread in take-order, so the
  SPMD collective-ordering invariant holds by construction
  (``certify(engine=True)`` proves it post-hoc via
  :func:`~pencilarrays_tpu_torch.analysis.spmd.verify_dispatch_log`).
  Streaming mode (:meth:`PlanService.start`) is an engine timer tick
  honoring the coalescing deadlines — no polling thread of its own.

Determinism contract (multi-controller meshes): one service instance
runs per rank; batching and ordering decisions are pure functions of
the submission sequence and of rank 0's clock, whose take every rank
applies (see :class:`~pencilarrays_tpu_torch.serve.queue.
AdmissionQueue`), so ranks that submit identically and drain at the
same points dispatch identical collective programs in identical order.

Elastic interop: plans registered by *name* via :meth:`PlanService.
register_plan` re-register their factory with
:func:`~pencilarrays_tpu_torch.cluster.elastic.register_plan` — after a mesh
reformation the factory re-runs, the registry entry is swapped (stale
executables dropped), queued host-payload requests re-bind to the
rebuilt plan, and the service resumes draining its queue.  Queued
*device* payloads bound to the dead mesh fail typed
(:class:`~pencilarrays_tpu_torch.serve.errors.StaleRequestError`).

The full request lifecycle is journaled (``serve.request`` →
``serve.coalesce`` → ``serve.dispatch`` → ``serve.complete``,
schema-registered in ``obs/schema.py``) and metered per tenant
(``serve.*`` counters/histograms/gauges), so ``pa-obs timeline``
renders a served run end to end.  Every record on one request's path
carries its **trace context** (schema v6, ``obs/requestflow.py``):
admission ADOPTS an inbound ambient trace (a fleet worker installs
the routed request's id — the trace-ctx lint forbids re-minting
mid-path) and mints one only for direct submissions, so ``pa-obs
request <trace_id>`` reconstructs the causal timeline across the
router's and every mesh's journals — coalesced batches journal the
B-way fan-in (``traces``) so one shared dispatch span is attributable
to each member request.  Completions also feed the per-tenant SLO
error-budget :class:`~pencilarrays_tpu_torch.serve.slo.BurnRateMonitor`:
when a tenant's budget burns faster than the alert threshold, ONE
fsync-critical ``serve.burn_alert`` record fires per overload episode
(edge-triggered with hysteresis).

On the card (the port's own layout of the batch): a coalesced batch of
device payloads is stacked by K1 (``ops/permute.py``) writing each
sample into the batch operand's ``[..., i]`` view; a host-payload batch
is stacked by numpy on the engine's host pool and copied to the card in
one ``from_global`` on the consumer thread; every result is split out by
K1 reading the batch's ``[..., i]`` view into storage of its own, so no
tenant's result keeps the whole batch alive.  The registry's compiled
executables are CUDA graphs, one pool per plan
(:class:`~pencilarrays_tpu_torch.ops.fft.CompiledPlan`).  Each batch's
host pack and host-to-device seconds are kept in
:meth:`PlanService.batch_timings`.
"""

from __future__ import annotations

import collections
import itertools
import math
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

from functools import lru_cache

from .errors import (AdmissionError, DeadlineError, ServeError,
                     ServiceClosedError, StaleRequestError)
from .queue import AdmissionQueue, Batch, TenantQuota, Ticket, _Entry
from .registry import PlanRegistry
from .shed import PressureGate, PressurePolicy
from .slo import SLO, BurnRateMonitor

__all__ = ["PlanService"]

_solo_ids = itertools.count(1)      # per-request coalesce-key suffixes
# for hbm-bounded reshards (admitted at B=1, served at B=1)
_service_ids = itertools.count(1)   # dispatch-log attribution tokens:
# NEVER id(self) — a recycled address would pull a dead service's
# records into another service's certify(engine=True)


def _topology_of(entry: _Entry):
    """The topology a request runs on: its plan's, or its reshard
    payload's."""
    if entry.plan is not None:
        return entry.plan.topology
    return entry.payload.pencil.topology


@lru_cache(maxsize=64)
def _split_fn(B: int):
    """The B-way trailing-dim splitter: sample ``i`` of a batch block
    copied by K1 out of the ``[..., i]`` view into storage of its own (a
    view would keep the whole B-sample block alive while any one tenant
    holds its result).  On the CPU K1's plain version makes the copy."""
    from ..ops import permute as k1

    def split(data):
        axes = tuple(range(data.dim() - 1))
        return tuple(k1.permute(data[..., i], axes) for i in range(B))

    return split


def _np_dtype(dtype):
    """The numpy dtype of a torch dtype (host payloads are cast with
    numpy on the host pool)."""
    import torch

    return torch.empty((), dtype=dtype).numpy().dtype


class PlanService:
    """Accept concurrent FFT/reshard requests from logical tenants and
    execute them on the resident mesh (module docstring).

    Parameters
    ----------
    max_batch, max_wait_s, starve_after_s, quota, quotas:
        Queue knobs (:class:`~pencilarrays_tpu_torch.serve.queue.
        AdmissionQueue`): coalescing width, partial-batch deadline,
        anti-starvation age, default and per-tenant admission quotas.
        ``max_batch=1`` is the serialized per-request baseline (the
        benchmark's control arm).
    retry:
        :class:`~pencilarrays_tpu_torch.resilience.retry.RetryPolicy` for the
        per-batch ``guarded_step`` ladder (default: env-tuned
        ``from_env()`` — ``PENCILARRAYS_TPU_RETRIES`` etc.).
    registry:
        Share a :class:`~pencilarrays_tpu_torch.serve.registry.PlanRegistry`
        across services (default: a private one, whose executables and
        their CUDA graphs :meth:`close` frees).
    engine:
        Explicit :class:`~pencilarrays_tpu_torch.engine.Engine` to dispatch
        through (default: the process's shared ``"default"`` engine —
        one mesh, ONE ordered dispatch queue, so concurrent services
        and app step loops cannot interleave collective launches).
    hbm_limit:
        Per-chip peak-HBM bound (bytes) the service's reshard traffic
        must fit under.  Whale requests whose every single-shot route
        busts the bound are no longer rejected: the route planner
        *synthesizes* a time-sliced chunked route
        (memory-bounded redistribution, arXiv:2112.01075 — see
        ``parallel/routing.py``) at admission, and the dispatch
        executes it.  Only a request for which even maximal chunking
        finds no admissible route fails, typed
        (:class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError`,
        ``reason="hbm-limit"``) at submit — never after queuing.
        ``None`` (default) keeps admission unbounded.
    slos:
        Per-tenant :class:`~pencilarrays_tpu_torch.serve.slo.SLO` objectives
        (also settable later via :meth:`set_slo`).  A tenant with a
        ``deadline_s`` gets all three enforcement points (admission
        projection, take-point expiry shed, completion violation
        journaling — ``docs/Serving.md``); ``shed_priority`` orders the
        overload gate's sacrifices.  With no SLOs and no ``pressure``
        policy the service behaves exactly as before (the disabled
        path: no per-request pricing, no projections —
        the service's serving without SLOs, unchanged).
    pressure:
        A :class:`~pencilarrays_tpu_torch.serve.shed.PressurePolicy` arming
        the load-shedding gate (water marks on the projected queue
        drain time).  With ``degrade_water_s`` set, the gate's first
        rung serves sheddable traffic on a cheaper wire precision
        (full -> bf16 -> fp8) inside each tenant's declared
        ``SLO.max_rel_l2`` envelope instead of shedding it
        (``serve/precision.py``; every applied downgrade journals a
        fsync-critical ``serve.precision`` record, schema v7).
        ``None`` (default): no shedding, quota-only admission.
    burn:
        A :class:`~pencilarrays_tpu_torch.serve.slo.BurnRateMonitor` for
        per-tenant SLO error-budget burn tracking (default: one with
        the monitor's own defaults).  Only tenants with a
        ``deadline_s`` SLO feed it; a threshold crossing journals ONE
        fsync-critical ``serve.burn_alert`` per overload episode.
    """

    def __init__(self, *, max_batch: int = 8, max_wait_s: float = 0.002,
                 starve_after_s: float = 1.0,
                 quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 retry=None, registry: Optional[PlanRegistry] = None,
                 engine=None, hbm_limit: Optional[int] = None,
                 slos: Optional[Dict[str, SLO]] = None,
                 pressure: Optional[PressurePolicy] = None,
                 burn: Optional[BurnRateMonitor] = None):
        self._own_registry = registry is None
        self.registry = registry or PlanRegistry()
        self.hbm_limit = int(hbm_limit) if hbm_limit is not None else None
        self.queue = AdmissionQueue(
            max_batch=max_batch, max_wait_s=max_wait_s,
            starve_after_s=starve_after_s, default_quota=quota,
            quotas=quotas, hbm_limit=self.hbm_limit)
        self.retry = retry
        self._lock = threading.Lock()
        self._named: Dict[str, object] = {}
        self._elastic_names: set = set()
        self._closed = False
        self._slos: Dict[str, SLO] = dict(slos or {})
        for t, s in self._slos.items():
            if not isinstance(s, SLO):
                raise TypeError(f"slos[{t!r}] is not an SLO: {s!r}")
        self._gate = PressureGate(pressure) if pressure is not None \
            else None
        self.burn = burn if burn is not None else BurnRateMonitor()
        self._force_priced = False      # ensure_priced(): an attached
        # Autoscaler needs the projection even with no SLOs/gate
        self._protected = max(
            (s.shed_priority for s in self._slos.values()), default=0)
        # batches taken from the queue but not yet finished: an elastic
        # rebind must re-point THESE plan references too (a reformation
        # can interrupt a batch mid-dispatch and rerun it)
        self._inflight: List[Batch] = []
        # batches dropped typed by an engine reformation, awaiting
        # resubmission onto the reformed engine — flushed only from
        # safe points (a finished dispatch, an explicit step/drain, the
        # engine's own post-reform hook off the consumer thread), so a
        # resubmitted batch can never dispatch concurrently with an
        # in-flight one (see _park_or_finish)
        self._parked: List[Batch] = []
        self._sid = next(_service_ids)
        self._engine_obj = engine
        self._streaming = False
        self._pump_scheduled = False
        self._pump_token = None     # (engine, generation) the pending
        # tick was scheduled against — a reform drops timers, so a
        # stale token means "scheduled" is a lie and must re-arm (the
        # ENGINE OBJECT, not id(): a recycled address on a swapped
        # engine must never collide into a false dedup)
        self._pump_deadline = 0.0   # when the armed tick fires — an
        # URGENT re-arm (full batch ready) may undercut it
        self._hooked_engines = weakref.WeakSet()    # engines whose
        # on_reform hook already re-arms this service's pump
        self._unhooks: List[Callable] = []  # their unsubscribes,
        # called at close() so a shared long-lived engine never
        # accumulates dead services' hooks
        self._dispatches = 0
        self._completed: Dict[str, int] = {}
        self._slo_violations = 0
        self._timings = collections.deque(maxlen=1024)

    def engine(self):
        """The engine this service dispatches through (the explicit
        one, else the process's shared default — resolved per call so
        an elastic reformation's fresh engine is picked up without
        re-plumbing)."""
        if self._engine_obj is not None:
            return self._engine_obj
        from ..engine import get_engine

        return get_engine()

    # -- named (elastic-rebindable) plans ----------------------------------
    def register_plan(self, name: str, factory: Callable):
        """Build and register a named plan: ``factory(ctx)`` must return
        a :class:`~pencilarrays_tpu_torch.ops.fft.PencilFFTPlan` (``ctx`` is
        ``None`` now, and the
        :class:`~pencilarrays_tpu_torch.cluster.elastic.ReformContext` when a
        reformation re-invokes it).  The factory is re-registered with
        the elastic layer as ``serve:<name>`` so a reformed mesh
        rebuilds the plan, swaps the registry entry (stale executables
        dropped) and re-binds queued host-payload requests — the
        service then resumes draining its queue.  Returns the built
        plan."""
        plan = factory(None)
        with self._lock:
            self._named[name] = plan
        self.registry.register(plan, replace=True)

        from ..cluster import elastic

        def _rebuild(ctx=None):
            p = factory(ctx)
            self._rebind(name, p)
            return p

        elastic.register_plan(f"serve:{name}", _rebuild)
        with self._lock:
            self._elastic_names.add(f"serve:{name}")
        return plan

    def _rebind(self, name: str, plan) -> None:
        with self._lock:
            self._named[name] = plan
        self.registry.register(plan, replace=True)
        # the reformed mesh's rank 0 decides the takes from now on (its
        # clock alone on one rank)
        self.queue.agree_on(plan.topology)
        # re-point EVERY queued entry of this fingerprint, not just the
        # name= submissions: a plan= submission resolves to the same
        # canonical object (registry dedupe) and shares the coalesce
        # key, so leaving it on the dead-mesh plan would poison the
        # whole post-reform batch.  In-flight and reformation-parked
        # batches re-bind too: an elastic reformation can interrupt a
        # batch mid-dispatch and rerun it (elastic_step's reform rung),
        # and the rerun must execute on the rebuilt plan
        key = plan.plan_key()
        with self._lock:
            taken = [e for b in self._inflight for e in b.entries] + \
                    [e for b in self._parked for e in b.entries]
        for e in self.queue.pending_entries() + taken:
            if e.plan is not None and (
                    e.plan_name == name or e.plan.plan_key() == key):
                e.plan = plan

    def plan(self, name: str):
        """The current plan registered under ``name`` (post-reform this
        is the rebuilt one)."""
        return self._named.get(name)

    # -- SLOs + the load projection ----------------------------------------
    def set_slo(self, tenant: str, slo: SLO) -> None:
        """Attach (or replace) one tenant's
        :class:`~pencilarrays_tpu_torch.serve.slo.SLO` — deadlines enforce
        from the next submission on."""
        if not isinstance(slo, SLO):
            raise TypeError(f"set_slo needs an SLO, got {slo!r}")
        with self._lock:
            self._slos[tenant] = slo
            self._protected = max(
                s.shed_priority for s in self._slos.values())

    def slo(self, tenant: str) -> Optional[SLO]:
        return self._slos.get(tenant)

    @property
    def _slo_armed(self) -> bool:
        """Any SLO, a pressure policy, or :meth:`ensure_priced` arms
        the projection machinery; without them, submissions skip
        pricing entirely (the disabled path — quota-only behavior and
        overhead, bit-for-bit)."""
        return (bool(self._slos) or self._gate is not None
                or self._force_priced)

    def ensure_priced(self) -> None:
        """Arm request pricing + the load projection even with no SLOs
        and no pressure gate — the :class:`~pencilarrays_tpu_torch.serve.
        autoscale.Autoscaler` calls this at attach: a controller
        watching a projection that is never fed would be permanently
        blind to overload (it could scale down but never up)."""
        self._force_priced = True

    def load_projection(self) -> dict:
        """The queue's live load projection (serve/slo.py snapshot plus
        the gate state) — what the shedding gate and the autoscaler
        read, exposed for operators and the bench."""
        snap = self.queue.load.snapshot()
        snap["queue_depth"] = self.queue.depth()
        snap["pressure"] = (self._gate.state if self._gate is not None
                            else None)
        snap["burn"] = self.burn.snapshot()
        return snap

    # -- submission --------------------------------------------------------
    def submit(self, tenant: str, u, *, plan=None, name: Optional[str] = None,
               direction: str = "forward", _refusal=None) -> Ticket:
        """Submit one single-sample FFT request.

        ``u`` is the sample: a host array in the plan's *global logical*
        shape (scattered onto the mesh at dispatch — the rebind-safe
        form), or a :class:`~pencilarrays_tpu_torch.parallel.arrays.
        PencilArray` already living on the plan's input (forward) /
        output (backward) pencil with ``extra_dims == ()``.  Pass the
        plan directly or by registered ``name``.  Returns a
        :class:`~pencilarrays_tpu_torch.serve.queue.Ticket`; same-fingerprint
        submissions coalesce into one batched dispatch, bit-identical
        to sequential per-request execution (test-pinned).

        ``_refusal`` (the port's fleet worker): an error this rank
        already refused the request with before the service; its
        admission vote carries it, so every rank refuses."""
        if direction not in ("forward", "backward"):
            raise ValueError(
                f"direction must be 'forward' or 'backward', "
                f"got {direction!r}")
        plan_name = None
        if name is not None:
            if plan is not None:
                raise ValueError("pass plan= or name=, not both")
            plan = self._named.get(name)
            if plan is None:
                raise ServeError(f"no plan registered under {name!r}")
            plan_name = name
        if plan is None:
            raise ValueError("submit needs plan= or name=")
        plan = self.registry.register(plan)
        self._check_payload(u)
        self._check_fft_shape(plan, direction, u)
        key = f"fft:{plan.plan_key()}:{direction}"
        nbytes = self._fft_nbytes(plan, direction)
        ticket = Ticket(tenant, "fft", key)
        entry = _Entry(ticket=ticket, plan=plan, direction=direction,
                       payload=u, nbytes=nbytes, plan_name=plan_name)
        self._stamp_slo(entry)
        self._admit(entry, direction=direction, refusal=_refusal)
        return ticket

    def submit_reshard(self, tenant: str, u, dest, *,
                       method=None) -> Ticket:
        """Submit one reshard request: redistribute ``u`` (a
        :class:`PencilArray`, ``extra_dims == ()``) onto pencil
        ``dest`` via the cost-driven route planner (``method`` defaults
        to :class:`~pencilarrays_tpu_torch.parallel.transpositions.Auto`).
        Same-route submissions coalesce like FFT traffic.

        With a service ``hbm_limit``, admission prices the request
        against the memory-bounded route planner: a whale whose
        single-shot routes all bust the bound is admitted on its
        *synthesized* chunked route; only a request with no admissible
        route at all (even maximally time-sliced) is rejected typed
        (:class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError`,
        ``reason="hbm-limit"``).  hbm-bounded reshards dispatch one
        per batch (no coalescing): a coalesced stack would multiply
        the un-chunkable footprint floor by B and could bust at
        dispatch what each request fit at admission."""
        from .. import obs
        from ..parallel.arrays import PencilArray
        from ..parallel.routing import reshard_key
        from ..parallel.transpositions import Auto, Gspmd

        if not isinstance(u, PencilArray):
            raise ServeError(
                "submit_reshard needs a PencilArray payload (a reshard "
                "is defined by where the data currently lives)")
        self._check_payload(u)
        method = method if method is not None else Auto()
        if self.hbm_limit is not None:
            from ..parallel.routing import plan_reshard_route

            if isinstance(method, Gspmd):
                raise ServeError(
                    "hbm-limited services cannot take method=Gspmd() "
                    "reshards: the partitioner's peak allocation is "
                    "unboundable")
            route = plan_reshard_route(u.pencil, dest, (), u.dtype,
                                       method=method,
                                       hbm_limit=self.hbm_limit)
            if not route.use_route:
                if obs.enabled():
                    obs.counter("serve.rejected", tenant=tenant,
                                reason="hbm-limit").inc()
                raise AdmissionError(
                    f"tenant {tenant!r}: no admissible reshard route "
                    f"under hbm_limit={self.hbm_limit} (even maximal "
                    f"time-slicing busts the bound)", tenant=tenant,
                    reason="hbm-limit")
        key = f"reshard:{reshard_key(u.pencil, dest, u.dtype, method)}"
        if self.hbm_limit is not None:
            # hbm-bounded reshards never coalesce: stacking B samples
            # multiplies the un-chunkable ``elems x itemsize`` floor by
            # B, so a batch of individually-admissible whales could
            # bust the bound at DISPATCH — violating the "rejected
            # typed at submit, never after queuing" contract the
            # admission check above just enforced.  One whale, one
            # batch (the key stays fingerprint-prefixed for journals)
            key += f"#solo{next(_solo_ids)}"
        nbytes = (math.prod(u.pencil.size_global())
                  * u.dtype.itemsize)
        ticket = Ticket(tenant, "reshard", key)
        entry = _Entry(ticket=ticket, plan=None, direction="forward",
                       payload=u, nbytes=nbytes, plan_name=None,
                       dest=dest, method=method)
        self._stamp_slo(entry)
        self._admit(entry)
        return ticket

    def _stamp_slo(self, entry: _Entry) -> None:
        slo = self._slos.get(entry.ticket.tenant)
        if slo is None:
            return
        entry.shed_priority = slo.shed_priority
        if slo.deadline_s is not None:
            # the admission-time deadline every later enforcement point
            # (take shed, completion accounting) measures against; the
            # budget is kept as set: ``deadline - t_submit`` rounds off
            # an ulp where the sum crosses a power of two
            entry.deadline = entry.ticket.t_submit + slo.deadline_s
            entry.deadline_s = slo.deadline_s

    @staticmethod
    def _check_payload(u) -> None:
        from ..parallel.arrays import PencilArray

        if isinstance(u, PencilArray) and u.extra_dims != ():
            raise ServeError(
                f"serve requests are single-sample (extra_dims=(), got "
                f"{u.extra_dims}); coalescing owns the batch dimension — "
                f"declare caller-side batches with PencilFFTPlan(batch=B) "
                f"instead")

    @staticmethod
    def _check_fft_shape(plan, direction: str, u) -> None:
        """Host payloads are shape-checked AT SUBMIT: a malformed
        sample must be a typed error on its own submitter, never a
        stack failure inside a coalesced batch that poisons other
        tenants' tickets."""
        import numpy as np

        from ..parallel.arrays import PencilArray

        if isinstance(u, PencilArray):
            return      # device payloads are validated per entry at
            # dispatch (the pencil may legitimately rebind by then)
        expected = tuple(plan.shape_physical if direction == "forward"
                         else plan.shape_spectral)
        got = tuple(np.shape(u))
        if got != expected:
            raise ServeError(
                f"payload shape {got} does not match the plan's "
                f"{'physical' if direction == 'forward' else 'spectral'} "
                f"global shape {expected}")
        dt = (plan.dtype_physical if direction == "forward"
              else plan.dtype_spectral)
        if np.iscomplexobj(u) and not dt.is_complex:
            raise ServeError(
                f"complex payload submitted where the plan expects "
                f"{str(dt).split('.')[-1]} — the coalesced cast would "
                f"silently discard the imaginary part")

    @staticmethod
    def _fft_nbytes(plan, direction: str) -> int:
        if direction == "forward":
            return (math.prod(plan.shape_physical)
                    * plan.dtype_physical.itemsize)
        return (math.prod(plan.shape_spectral)
                * plan.dtype_spectral.itemsize)

    def _admit(self, entry: _Entry, *, direction: Optional[str] = None,
               refusal: Optional[BaseException] = None) -> None:
        from .. import obs
        from ..obs import requestflow

        t = entry.ticket.tenant
        # trace context: ADOPT the ambient inbound trace (a fleet
        # worker installed the routed request's id — re-minting here
        # would shear the cross-mesh causal chain; the trace-ctx lint
        # audits this site), mint only for direct submissions — the
        # serve layer is the second of the two admission points
        entry.trace = (requestflow.current_trace()
                       or requestflow.mint_trace())
        topo = _topology_of(entry)
        self._agreed_refusal(topo, entry, refusal)
        # one clock, rank 0's, decides every take on several ranks
        self.queue.agree_on(topo)
        try:
            self._agreed_slo(entry)
            full = self.queue.offer(entry)
        except ServeError as e:
            if obs.enabled():
                obs.counter("serve.rejected", tenant=t,
                            reason=getattr(e, "reason", "error")).inc()
            raise
        if obs.enabled():
            obs.counter("serve.requests", tenant=t,
                        kind=entry.ticket.kind).inc()
            obs.gauge("serve.queue_depth", tenant=t).set(
                self.queue.depth(t))
            fields = dict(tenant=t, req=entry.ticket.id,
                          kind=entry.ticket.kind, key=entry.ticket.key,
                          nbytes=entry.nbytes, trace=entry.trace)
            if direction is not None:
                fields["direction"] = direction
            obs.record_event("serve.request", **fields)
        # streaming mode: EVERY admission (re)schedules the pump tick —
        # a request landing on an idle queue must not wait for a tick
        # that was never armed (an idle tick does not reschedule itself,
        # and an engine reform drops pending timers).  An admission
        # that COMPLETED a batch ticks at the minimum spacing: a full
        # batch gains nothing by waiting out the coalescing deadline
        if self._streaming:
            if full:
                self._schedule_pump(
                    delay_s=getattr(self, "_min_tick_s", 0.001))
            else:
                self._schedule_pump()

    def _agreed_refusal(self, topo, entry: _Entry,
                        mine: Optional[BaseException] = None) -> None:
        """The refusals before the SLO as one outcome on the ranks of
        ``topo``: a closed service, and the admission-boundary injection
        point (overload and flaky-client drills inject here like at
        every other layer: error raises ``InjectedFault`` to the
        submitter, delay drags the admission path —
        docs/Resilience.md).  Each rank publishes its own refusal
        (``agree_all``, label ``serve-refuse``) and every rank refuses
        when one does: its own error (``mine``, one it refused with
        before the service, or the two above), else the same type as the
        first refusing rank's.  A refusal on one rank alone would skip a
        ``serve-admit`` decision the other ranks number, and each later
        admission there would apply the verdict of another request."""
        from ..parallel.distributed import agree_all
        from ..resilience import InjectedFault, faults

        if mine is None:
            try:
                if self._closed:
                    raise ServiceClosedError("service is closed")
                faults.fire("serve.submit", tenant=entry.ticket.tenant,
                            kind=entry.ticket.kind)
            except Exception as e:
                mine = e
        votes = agree_all(topo, "serve-refuse", None if mine is None
                          else [type(mine).__name__, str(mine)])
        if mine is not None:
            raise mine
        for rank, vote in zip(topo._global_ranks, votes):
            if vote is None:
                continue
            name, msg = vote
            msg = f"refused on rank {rank}: {msg}"
            if name == "InjectedFault":
                raise InjectedFault(msg, point="serve.submit")
            if name == "ServiceClosedError":
                raise ServiceClosedError(msg)
            raise ServeError(f"{msg} ({name})")

    # -- SLO / pressure enforcement ----------------------------------------
    def _agreed_slo(self, entry: _Entry) -> None:
        """:meth:`_enforce_slo` as one decision on several ranks: rank 0
        decides by its own gate and load and every other rank applies
        its verdict (the rung it degraded to, or its typed error), as
        the take applies rank 0's take: the JAX package's one
        controller.  Each rank deciding by its own load admits a
        request on one rank that another rejects, and the ranks' batches
        then differ."""
        topo = self.queue._agree_topo
        if topo is None or not self._slo_armed:
            self._enforce_slo(entry)
            return
        from ..parallel.distributed import agree

        decided = []

        def decide():
            # every outcome is published, a failure too: the other
            # ranks wait for it; so is the gate feed it made, if any
            try:
                rung = self._enforce_slo(entry)
            except Exception as e:
                decided.append(e)
                return {"feed": entry.feed, "error": [
                    type(e).__name__, str(e), {
                        k: getattr(e, k) for k in (
                            "tenant", "reason", "deadline_s", "projected_s")
                        if hasattr(e, k)}]}
            decided.append(None)
            return {"feed": entry.feed,
                    "rung": None if rung is None else list(rung)}

        verdict = agree(topo, "serve-admit", decide)
        if decided:             # rank 0: applied (or raised) already
            if decided[0] is not None:
                raise decided[0]
            return
        if verdict["feed"] is not None:
            # the gate steps, and evicts, as rank 0's did
            self._feed_gate(verdict["feed"])
        if "error" in verdict:
            name, msg, fields = verdict["error"]
            cls = {"AdmissionError": AdmissionError,
                   "DeadlineError": DeadlineError}.get(name)
            if cls is None:
                raise ServeError(f"rank 0 failed the admission: {name}: "
                                 f"{msg}")
            raise cls(msg, **fields)
        if verdict["rung"] is not None:
            self._maybe_degrade(entry, tuple(verdict["rung"]))
        entry.cost_bytes = self.queue.entry_cost(entry)

    def _enforce_slo(self, entry: _Entry):
        """The admission enforcement point (raises typed): feed the
        pressure gate, downgrade wire precision under its first rung
        (a sheddable tenant with an ``SLO.max_rel_l2`` budget
        is SERVED on a cheaper wire instead of rejected), evict under
        its last rung, shed sheddable priorities, and reject requests
        whose projected wait already busts their deadline.  A no-SLO
        no-pressure service returns on the first line — the disabled
        path does no pricing at all.  Returns the rung of a downgrade
        (:meth:`_maybe_degrade`), else None."""
        if not self._slo_armed:
            return None
        t = entry.ticket.tenant
        degraded = None
        if self._gate is not None:
            entry.feed = self._feed_gate()
            degraded = (
                self._gate.degrades(entry.shed_priority, self._protected)
                and self._maybe_degrade(entry))
            if not degraded and self._gate.sheds(
                    entry.shed_priority, self._protected):
                raise AdmissionError(
                    f"tenant {t!r}: shed under load (priority "
                    f"{entry.shed_priority} below the protected tier "
                    f"{self._protected}, gate {self._gate.state!r})",
                    tenant=t, reason="shed")
        # priced AFTER any downgrade: the projection must charge the
        # wire the request will actually move, or the autoscaler and
        # the gate would keep seeing the full-precision queue
        entry.cost_bytes = self.queue.entry_cost(entry)
        load = self.queue.load
        if entry.deadline is not None:
            projected = load.projected_wait_s()
            budget = entry.deadline_s
            # boundary contract (test-pinned): a projection EQUAL to
            # the deadline still admits — only a wait the model says
            # is strictly too long is rejected up front
            if projected is not None and projected > budget:
                raise DeadlineError(
                    f"tenant {t!r}: projected wait {projected:.3f}s "
                    f"exceeds the {budget:.3f}s deadline — rejected at "
                    f"admission, not answered late", tenant=t,
                    reason="projected", deadline_s=budget,
                    projected_s=projected)
        return degraded or None

    def _maybe_degrade(self, entry: _Entry, rung=None):
        """The precision-downgrade rung: swap a sheddable fft entry onto
        the deepest wire-precision plan variant whose
        CALIBRATED error envelope (``serve/precision.py``,
        ``BENCH_WIRE.json``) fits under the tenant's declared
        ``SLO.max_rel_l2`` (or onto ``rung``, another rank's choice).
        Returns the rung ``(wire, envelope)`` when a downgrade was
        applied — the caller then skips the shed rung: served degraded
        beats shed.

        The swap happens BEFORE the entry is priced or queued: the
        coalesce key is rebuilt from the variant's ``plan_key()`` (wire
        dtype is part of schedule identity, so full/bf16/fp8 traffic
        can never coalesce into one batch), the registry holds the
        variant's own compiled executable, and the load projection
        charges the cheaper wire.  A reshard entry (the port's rung goes
        further than the JAX package's, which leaves reshards alone)
        moves onto its method carrying the rung's wire, its key rebuilt
        from ``reshard_key`` with that method: on one card an FFT plan
        makes no hop and so no wire, and reshard traffic is where the
        rung changes bytes.  Tenants with no ``max_rel_l2``, and
        reshards on a method that carries no wire (``Gspmd``), fall
        through untouched to the shed rung.  (An elastic
        reformation re-binds named-plan entries to the rebuilt FULL
        plan: a degraded-then-reformed request is served at better
        precision than promised, never worse.)"""
        from .. import obs
        from ..parallel import transpositions as tr
        from .precision import select_rung

        t = entry.ticket.tenant
        slo = self._slos.get(t)
        if slo is None or slo.max_rel_l2 is None:
            return None
        if entry.ticket.kind == "fft" and entry.plan is not None:
            cur = entry.plan.wire_dtype
        elif (entry.ticket.kind == "reshard"
              and isinstance(entry.method, (tr.AllToAll, tr.Ring,
                                            tr.Auto, tr.Pipelined))):
            cur = tr._method_wire(entry.method)
        else:
            return None
        if rung is None:
            rung = select_rung(slo.max_rel_l2, cur)
        if rung is None:
            return None
        wire, envelope = rung
        wire_from = cur or "full"
        if entry.plan is not None:
            plan = self.registry.register(entry.plan.with_wire_dtype(wire))
            entry.plan = plan
            entry.ticket.key = f"fft:{plan.plan_key()}:{entry.direction}"
        else:
            from ..parallel.routing import reshard_key

            # an Auto reshard may plan the Gspmd exchange, which carries
            # no wire: the degraded one forces the routed path
            entry.method = (tr.AllToAll(wire_dtype=wire)
                            if isinstance(entry.method, tr.Auto) else
                            tr.with_wire(tr.strip_wire(entry.method), wire))
            solo = entry.ticket.key.partition("#solo")[1:]
            entry.ticket.key = (
                "reshard:" + reshard_key(entry.payload.pencil, entry.dest,
                                         entry.payload.dtype, entry.method)
                + "".join(solo))
        if obs.enabled():
            obs.counter("serve.degraded", tenant=t, wire=wire).inc()
            # fsync-critical: a precision decision changes the answer a
            # client receives — it must survive a crash, like the shed
            # and burn-alert records it sits between
            obs.record_event(
                "serve.precision", _fsync=True, tenant=t,
                req=entry.ticket.id, key=entry.ticket.key,
                trace=entry.trace, wire_from=wire_from, wire_to=wire,
                envelope=envelope, max_rel_l2=slo.max_rel_l2,
                gate=self._gate.state)
        return rung

    def _slo_maintenance(self) -> None:
        """The take-side enforcement: re-feed the gate (pressure can
        cross a mark between admissions), run the evict rung, and fail
        take-point-expired entries typed.  Called by every dispatch
        path (step / streaming pump) around ``take_ready``."""
        if not self._slo_armed or self._gate is None:
            return
        topo = self.queue._agree_topo
        if topo is None:
            self._feed_gate()
            return
        from ..parallel.distributed import agree

        fed = []

        def decide():
            # a failure is published too: the other ranks wait for it
            try:
                feed = self._feed_gate()
            except Exception as e:
                fed.append(e)
                return {"error": [type(e).__name__, str(e)]}
            fed.append(None)
            return feed

        feed = agree(topo, "serve-evict", decide)
        if fed:                 # rank 0: applied (or raised) already
            if fed[0] is not None:
                raise fed[0]
            return
        if "error" in feed:
            name, msg = feed["error"]
            raise ServeError(f"rank 0 failed the gate feed: {name}: {msg}")
        self._feed_gate(feed)

    def _feed_gate(self, feed: Optional[dict] = None) -> dict:
        """THE one gate-feed sequence (admission and take enforcement
        points must never diverge): update with the live drain
        projection, then run the evict rung if the gate escalated.
        Returns the feed as a JSON value (the projection and the
        evicted admission numbers).  On several ranks rank 0 feeds and
        every other rank applies its ``feed``: its gate steps by rank
        0's projection and evicts exactly rank 0's entries, as the JAX
        package's one gate does.  Evicting by its own load, a rank
        would fail tickets that rank 0 still queues."""
        load = self.queue.load
        if feed is None:
            drain = load.drain_s()
            self._gate.update(drain, load.snapshot)
            evicted = (self._evict_sheddable() if self._gate.evicting()
                       else [])
            return {"drain_s": drain, "evicted": evicted}
        self._gate.update(feed["drain_s"], load.snapshot)
        if feed["evicted"]:
            self._evict_sheddable(feed["evicted"])
        return feed

    def _shed_expired(self) -> None:
        """Fail every entry ``take_ready`` shed as deadline-expired:
        typed ``DeadlineError(reason="expired")`` on its own ticket —
        never a silent late answer, never a dispatched corpse."""
        from .. import obs

        for e in self.queue.pop_expired():
            budget = e.deadline_s if e.deadline is not None else 0.0
            if obs.enabled():
                obs.counter("serve.shed", tenant=e.ticket.tenant,
                            reason="expired").inc()
            self._finish_one(
                e.ticket.key, e, error=DeadlineError(
                    f"tenant {e.ticket.tenant!r}: deadline "
                    f"({budget:.3f}s) expired while queued — shed "
                    f"before dispatch", tenant=e.ticket.tenant,
                    reason="expired", deadline_s=budget))

    def _evict_sheddable(self, seqs: Optional[List[int]] = None
                         ) -> List[int]:
        """The pressure gate's second rung: evict queued sheddable
        entries (admission-sequence order, deterministic), or the
        entries ``seqs`` names (rank 0's eviction), and fail their
        tickets typed ``AdmissionError(reason="shed")``.  Returns the
        evicted entries' admission numbers."""
        from .. import obs

        evicted = self.queue.evict_sheddable(self._protected, seqs)
        for e in evicted:
            if obs.enabled():
                obs.counter("serve.shed", tenant=e.ticket.tenant,
                            reason="evicted").inc()
            self._finish_one(
                e.ticket.key, e, error=AdmissionError(
                    f"tenant {e.ticket.tenant!r}: evicted from the "
                    f"queue under overload (priority {e.shed_priority} "
                    f"below the protected tier {self._protected})",
                    tenant=e.ticket.tenant, reason="shed"))
        return [e.seq - self.queue._seq_base for e in evicted]

    # -- dispatch ----------------------------------------------------------
    def step(self, *, flush: bool = False) -> int:
        """Dispatch every ready batch through the engine (coalescing
        deadlines honored; ``flush=True`` takes partial groups too —
        the ragged final batch) and block until their futures resolve.
        Returns the number of batches TAKEN — dispatched, or failed
        typed at submission (a batch that left the queue always
        resolves its tickets, one way or the other).  Batches are
        submitted in take-order and the engine's single consumer issues
        them in submission order, so the dispatched collective sequence
        is identical to the pre-engine serialized loop (certifiable:
        :meth:`certify` with ``engine=True``).  Client-thread API —
        never call from inside engine-executed work."""
        self._slo_maintenance()
        taken = self.queue.take_ready(flush=flush)
        self._shed_expired()
        # batches dropped typed by an engine reformation resubmit ahead
        # of fresh traffic (they are older) — not re-counted: they were
        # already counted by the step/pump that first took them
        batches = self._take_parked() + taken
        futs = []
        interrupt = None
        for b in batches:
            f, err = self._submit_or_fail(b)
            futs.append(f)
            if interrupt is None and isinstance(
                    err, (KeyboardInterrupt, SystemExit)):
                interrupt = err
        for f in futs:
            if f is None:
                continue    # every entry failed validation: no dispatch
            f._event.wait()
            err = f.error()
            if interrupt is None and isinstance(
                    err, (KeyboardInterrupt, SystemExit)):
                # the tickets are failed (nobody waits on a dead
                # future) but the interrupt itself must reach the
                # caller — the pre-engine contract, preserved
                interrupt = err
        if interrupt is not None:
            raise interrupt
        return len(taken)

    def drain(self) -> int:
        """Flush-dispatch until the queue AND the reformation-parked
        backlog are empty; returns batches taken (see :meth:`step`).
        The deterministic entry point: tests and multi-controller
        meshes submit, then drain.  Parked batches count: a batch
        dropped typed by an engine reformation still holds unresolved
        tickets, and drain()'s contract is that nobody waits forever
        after it returns."""
        n = 0
        while True:
            with self._lock:
                parked = bool(self._parked)
            if not (self.queue.depth() or parked):
                break
            n += self.step(flush=True)
        return n

    def start(self, poll_s: float = 0.001) -> None:
        """Arm streaming mode (single-controller meshes only;
        multi-controller ranks must drain at agreed points, see the
        determinism contract): every admission schedules an engine
        timer honoring the coalescing deadline, whose tick takes ready
        batches into the ordered dispatch queue.  No thread is created
        and nothing polls (no private loop contending with the main
        thread for every dispatch); ``poll_s`` is the minimum tick
        spacing."""
        self._min_tick_s = float(poll_s)
        self._streaming = True
        self._schedule_pump()

    def stop(self) -> None:
        """Disarm streaming mode: queued work stays queued for an
        explicit :meth:`step`/:meth:`drain`.  A scheduled tick may
        still fire once but dispatches NOTHING once streaming is off —
        stop() means no further implicit dispatch, period."""
        self._streaming = False

    def _schedule_pump(self, *, delay_s: Optional[float] = None) -> None:
        """Schedule ONE pending pump tick (collapsing duplicates) at
        the coalescing deadline — or immediately when a full batch is
        already ready.  Never raises: the caller is the admission path
        (the request is already queued — a scheduling failure must not
        strip the submitter of a ticket that may still dispatch) or the
        pump tick itself."""
        from .. import obs

        if not self._streaming or self._closed:
            return
        eng = self.engine()
        self._hook_reform(eng)
        if not eng.accepting:
            return      # quiesced/reforming: the engine's reform/
            # resume hook (or the next submit) re-pumps
        if delay_s is None:
            # the deadline-aware tick: bound by the oldest pending
            # group's coalescing deadline AND any queued SLO deadline
            # (next_ready_in folds both) — a request whose deadline is
            # far inside the coalesce window must be shed at ITS
            # deadline, not discovered expired a full window later
            wait = self.queue.next_ready_in()
            delay_s = self.queue.max_wait_s if wait is None else wait
            delay_s = max(delay_s, getattr(self, "_min_tick_s", 0.001))
        token = (eng, eng.generation)
        now = time.monotonic()
        with self._lock:
            if (self._pump_scheduled and self._pump_token == token
                    and now + delay_s >= self._pump_deadline - 1e-4):
                return      # an armed tick already fires soon enough
            # re-arm when: the token is stale (the engine reformed —
            # dropping its timers — or was swapped, so "scheduled" is
            # a lie), OR an urgent deadline (a full batch) undercuts
            # the armed tick.  The superseded tick still fires and
            # drains harmlessly (take_ready dedups the work)
            self._pump_scheduled = True
            self._pump_token = token
            self._pump_deadline = now + delay_s
        try:
            eng.call_later(delay_s, self._pump, label="serve-pump")
        except Exception:
            # engine closed/reformed between the accepting check and
            # the call: queued work is NOT lost — the next admission
            # (or an explicit step/drain) re-pumps.  Clear the flag
            # only if OUR token still owns it: a concurrent admission
            # may have legitimately re-armed on the live generation
            with self._lock:
                if self._pump_token == token:
                    self._pump_scheduled = False
            if obs.enabled():
                obs.counter("serve.pump_schedule_errors").inc()

    def _hook_reform(self, eng) -> None:
        """Register (once per engine) a post-reform hook that re-arms
        the pump: a reform drops the armed tick, and ALREADY-QUEUED
        streaming traffic must drain even if no further admission ever
        arrives to notice the stale token.  The hook holds only a
        weakref to the service so a long-lived shared engine never
        keeps a closed service alive."""
        with self._lock:
            if eng in self._hooked_engines:
                return
            self._hooked_engines.add(eng)
        ref = weakref.ref(self)

        def _rearm(_eng):
            svc = ref()
            if svc is None:
                return
            # NOTHING dispatches from this hook while it runs on the
            # engine's own consumer thread (an elastic_step reforming
            # from inside an in-flight dispatch): neither a parked
            # flush nor a pump tick may put the new generation to work
            # concurrently with the old consumer's still-rerunning
            # interrupted batch — that dispatch's completion (_finish)
            # flushes and re-arms instead
            if _eng.on_consumer_thread():
                return
            svc._flush_parked()
            if svc._streaming and not svc._closed and svc.queue.depth():
                svc._schedule_pump()

        unhook = eng.on_reform(_rearm)
        with self._lock:
            # close() may have swapped _unhooks out while we were
            # registering: our entry would land in a list nobody ever
            # drains, leaving a dead service's hook on a shared engine
            late = self._closed
            if not late:
                self._unhooks.append(unhook)
        if late:
            unhook()

    def _pump(self) -> None:
        """The streaming tick (runs on the engine consumer thread):
        submit every ready batch, then reschedule while traffic
        remains.  Must never raise — a scheduling bug costs one tick,
        never the engine."""
        from .. import obs

        now = time.monotonic()
        with self._lock:
            # only the OWNING tick clears the flag: a superseded
            # later-deadline tick firing while a live one is still
            # armed (deadline in the future) must not clear it, or
            # every admission until that live tick re-arms redundantly
            if now >= self._pump_deadline - 1e-4:
                self._pump_scheduled = False
        if not self._streaming or self._closed:
            return
        try:
            self._slo_maintenance()
            batches = self.queue.take_ready()
            self._shed_expired()
        except Exception:
            batches = []
            if obs.enabled():
                obs.counter("serve.loop_errors").inc()
        for b in self._take_parked() + batches:
            self._submit_or_fail(b)
        if self.queue.depth():
            # re-arm at the oldest pending group's own deadline — a
            # fresh full max_wait_s from now would make a group that
            # just missed this tick wait up to ~2x its deadline
            wait = self.queue.next_ready_in()
            self._schedule_pump(delay_s=None if wait is None else max(
                wait, getattr(self, "_min_tick_s", 0.001)))

    def close(self, *, drain: bool = True) -> None:
        """Stop accepting work; by default drain what is queued.  The
        admission gate closes BEFORE the final drain and atomically
        with the queue's own offer lock, so a submit racing close() is
        a typed rejection — never a ticket stranded in a service nobody
        will ever drain again.  Elastic factories registered through
        :meth:`register_plan` are unregistered so a later reformation
        does not rebuild plans for (and keep alive) a dead service.  A
        private registry's executables are dropped, their CUDA graphs and
        graph pools freed: the engine's dispatch log may keep the plans
        alive, so nothing else would free them."""
        self.stop()
        self._closed = True             # fast-path rejection
        self.queue.close_gate()         # the airtight one
        if drain:
            self.drain()
        # reformation-parked batches must not strand their tickets in a
        # dead service: resubmit (or fail typed, if the engine is gone)
        self._flush_parked()
        from ..cluster import elastic
        with self._lock:
            names, self._elastic_names = self._elastic_names, set()
            unhooks, self._unhooks = self._unhooks, []
        for n in names:
            elastic.unregister_plan(n)
        for u in unhooks:       # drop our reform hooks from engines
            try:                # that outlive this service
                u()
            except Exception:
                pass
        if self._own_registry:
            self.registry.drop_executables()

    # -- the batch executor ------------------------------------------------
    def _dispatch(self, batch: Batch) -> None:
        """Submit one batch through the engine and wait for it — the
        synchronous per-batch unit (callers that drive ``take_ready``
        themselves; :meth:`step` is the batched form).  A submission
        failure fails the batch's tickets typed (interrupts still
        propagate)."""
        fut, serr = self._submit_or_fail(batch)
        if isinstance(serr, (KeyboardInterrupt, SystemExit)):
            raise serr
        if fut is None:
            return
        fut._event.wait()
        err = fut.error()
        if isinstance(err, (KeyboardInterrupt, SystemExit)):
            raise err

    def _submit_or_fail(self, batch: Batch):
        """:meth:`_submit_batch`, but a submission failure (engine
        closed/reformed between ``take_ready`` and submit, a scheduling
        bug) fails THIS batch's tickets typed instead of propagating —
        once a batch left the queue, nobody but us will ever resolve
        its tickets.  NEVER raises (the streaming pump runs on the
        engine consumer thread, where an escaped exception kills the
        consumer and strands every queued future).  Returns ``(future,
        error)``: the future is ``None`` when nothing dispatched, the
        error is the submission failure so synchronous callers can
        re-raise interrupts after the tickets are failed."""
        from .. import obs

        try:
            return self._submit_batch(batch), None
        except BaseException as e:
            try:
                self._finish(batch, None, e, 0.0)
            except Exception:
                pass
            if obs.enabled():
                obs.counter("serve.submit_errors").inc()
            return None, e

    def _submit_batch(self, batch: Batch):
        """Turn one ready batch into one ordered engine dispatch.

        Runs on the submitting thread (a :meth:`step` caller or the
        streaming pump tick): journals the batch formation, fails
        blame-one validation losers typed, then submits ONE engine
        task — host-payload packing (the numpy stack) as the task's
        ``pack`` stage on the host pool (overlapped with earlier
        batches' device compute), the ``guarded_step``-wrapped device
        dispatch as its ``run`` stage on the consumer thread.  Returns
        the batch's :class:`~pencilarrays_tpu_torch.engine.StepFuture` (or
        ``None`` when every entry failed validation and nothing
        dispatches).  Tickets are fulfilled by the future's completion
        callback, so streaming mode needs no waiter."""
        from .. import obs
        from ..guard.recover import elastic_step

        B = len(batch.entries)
        resubmit = batch.resubmits > 0
        t_dispatch = time.monotonic()
        for e in batch.entries:
            e.ticket.t_dispatch = t_dispatch
        wait_s = t_dispatch - batch.entries[0].ticket.t_submit
        if obs.enabled() and not resubmit:
            # the formation record: what the queue coalesced (validation
            # losses below journal their own non-ok serve.complete).
            # ONE logical dispatch = one coalesce/dispatch record —
            # a reformation-parked resubmission re-enters here but
            # must not double-journal or double-count
            # the fan-in record: the leader's trace plus every
            # member's (one dispatch span is SHARED by B requests —
            # pa-obs request finds this record through either field)
            obs.record_event(
                "serve.coalesce", key=batch.key, n=B,
                reqs=[e.ticket.id for e in batch.entries],
                reason=batch.reason, wait_s=wait_s,
                trace=batch.entries[0].trace,
                traces=[e.trace for e in batch.entries])
            obs.histogram("serve.batch_size", kind=batch.kind).observe(B)
        # per-entry payload validation BEFORE the shared dispatch: a
        # problem only one request can be blamed for (a stale device
        # payload after an elastic rebuild) fails THAT ticket typed and
        # the rest of the batch proceeds — the isolation contract holds
        # inside a batch too, for every blame-one failure we can detect
        # up front (host payload shapes were already checked at submit)
        survivors = []
        for e in batch.entries:
            err = self._validate_entry(batch, e)
            if err is None:
                survivors.append(e)
            else:
                # take_ready counted this entry in flight: clear it
                # (no rate sample — nothing dispatched for it), or the
                # drain projection inflates forever and the pressure
                # gate / autoscaler wedge on phantom load
                self.queue.note_entry_done(e)
                self._finish_one(batch.key, e, error=err)
        if not survivors:
            return None     # nothing actually dispatches: no
            # serve.dispatch record, no dispatch count
        batch.entries = survivors
        tenants = sorted({e.ticket.tenant for e in survivors})
        writes = self._batch_resources(batch)
        lane = self._lane_for(batch)
        if obs.enabled() and not resubmit:
            obs.record_event(
                "serve.dispatch", key=batch.key, n=len(survivors),
                tenants=tenants, score_bytes=batch.cost,
                reason=batch.reason, lane=lane,
                chain="|".join(writes) if writes else "*",
                trace=survivors[0].trace,
                traces=[e.trace for e in survivors])
        with self._lock:
            if not resubmit:
                self._dispatches += 1
            self._inflight.append(batch)
        pack = self._host_pack_fn(batch)
        timing = {"s": 0.0}
        meta = self._dispatch_meta(batch)

        def counted(host_operand):
            # the collectives this dispatch issued across ranks (a graph
            # replay's included), what certify(engine=True) holds to the
            # plan's prediction; the attempt that succeeded sets them
            from ..parallel import collectives

            with collectives.recording() as rec:
                out = self._run_batch(batch, host_operand)
            if batch.kind == "fft":
                meta["collectives"] = collectives.stats(
                    rec["ops"], collectives.EXCHANGE_KINDS)
            return out

        def run(host_operand=None):
            # elastic_step, not guarded_step: when the elastic layer is
            # armed a PeerFailureError/PeerLeftError mid-batch reforms
            # the mesh (the service's registered factories rebuild its
            # plans, _rebind re-points this batch's entries) and the
            # batch reruns under the reformed mesh — with the gate off
            # this IS guarded_step, bit-for-bit (elastic test pin)
            t0 = time.perf_counter()
            try:
                return elastic_step(
                    lambda: counted(host_operand),
                    retry=self.retry, label=f"serve:{batch.key}",
                    meta={"tenants": tenants,
                          "reqs": [e.ticket.id for e in batch.entries]})
            finally:
                timing["s"] = time.perf_counter() - t0

        fut = self.engine().submit(
            run, pack=pack, label=f"serve:{batch.key}", meta=meta,
            writes=writes, lane=lane)
        fut.add_done_callback(
            lambda f: self._complete_or_park(batch, f, timing))
        return fut

    def _batch_resources(self, batch: Batch) -> tuple:
        """The batch's declared engine write set — its dependency
        chain.  One fingerprint = one chain: every dispatch of the
        same plan (either direction — a backward may consume a
        forward's output, so they are conservatively chained) orders
        FIFO, while different tenants' different plans overlap.
        Reshard batches chain on their coalesce route key (the
        ``#solo`` suffix stripped: a solo-cost split still contends
        for the same route).

        On a topology of several ranks (the port runs one process, one
        service and one engine per rank) every batch also writes one
        shared ``serve-mesh`` resource: the engine may issue disjoint
        tasks in the order their host packs finish, which differs from
        rank to rank, and ranks that issue their collectives in
        different orders deadlock.  Chained on it, the batches issue in
        take order on every rank (the JAX package's single controller
        has one order by construction)."""
        e0 = batch.entries[0]
        if batch.kind == "fft":
            own = f"plan:{e0.plan.plan_key()}"
        else:
            own = "route:" + batch.key.split("#solo", 1)[0]
        return (own, "serve-mesh") if len(_topology_of(e0)) > 1 \
            else (own,)

    def _lane_for(self, batch: Batch) -> int:
        """The batch's engine priority lane: the max ``shed_priority``
        among its entries' SLOs (the tier the shedding gate already
        protects), plus one **urgency boost** when any member's
        remaining deadline slack is under the queue's projected wait —
        the batch that will MISS its SLO if it queues normally jumps
        first.  Unpriced traffic (no SLOs armed) rides lane 0, where
        the engine's FIFO tiebreak is exactly the submission order."""
        if not self._slo_armed:
            return 0
        lane = max((e.shed_priority for e in batch.entries), default=0)
        deadlines = [e.deadline for e in batch.entries
                     if e.deadline is not None]
        if deadlines:
            slack = min(deadlines) - time.monotonic()
            projected = self.queue.load.projected_wait_s()
            # projected is None until the tracker has a completion rate
            # — no projection, no urgency verdict, no boost
            if projected is not None and slack < projected:
                lane += 1
        return lane

    def _complete_or_park(self, batch: Batch, f, timing: dict) -> None:
        """A batch whose queued engine task was dropped typed by an
        engine reformation (:class:`EngineReformedError`) is PARKED for
        resubmission onto the reformed engine instead of failing its
        tickets — host payloads re-bind to the rebuilt plans, so the
        program it will dispatch is a live-mesh one.  Parked batches
        are flushed only from safe points (a finished dispatch's
        completion, an explicit step/drain, the engine's post-reform
        hook off the consumer thread), so a resubmission can never
        dispatch concurrently with a still-running in-flight batch.
        Bounded: the 4th consecutive reformation drop fails the batch
        typed — reformation storms must not hide tickets forever."""
        from .. import obs
        from ..engine.errors import EngineReformedError

        err = f.error()
        if (isinstance(err, EngineReformedError) and not self._closed
                and batch.resubmits < 3):
            batch.resubmits += 1
            with self._lock:
                # parked ≠ in flight: resubmission re-appends it, and
                # _rebind already walks _parked separately
                self._inflight = [b for b in self._inflight
                                  if b is not batch]
                self._parked.append(batch)
            if obs.enabled():
                obs.counter("serve.reform_requeues").inc()
            return
        self._finish(batch, f._result, err, timing["s"])

    def _take_parked(self) -> List[Batch]:
        with self._lock:
            out, self._parked = self._parked, []
        return out

    def _flush_parked(self) -> None:
        for b in self._take_parked():
            self._submit_or_fail(b)

    def _host_pack_fn(self, batch: Batch):
        """The batch's host-pool pack stage: for an all-host FFT batch,
        the numpy dtype-cast + stack (ONE ``from_global`` scatter later
        on the consumer — the coalescing shape, overlapped with the
        previous dispatch's compute).  The pack touches no CUDA tensor:
        all device work stays on the consumer thread.  Device payloads have
        nothing to pack on the host (``None``: materialize + stack run
        on the consumer thread with the device program — device work
        never leaves the ordered queue)."""
        import numpy as np

        from ..parallel.arrays import PencilArray

        if batch.kind != "fft" or any(
                isinstance(e.payload, PencilArray)
                for e in batch.entries):
            return None
        e0 = batch.entries[0]
        plan, direction = e0.plan, e0.direction
        entries = list(batch.entries)

        def pack():
            t0 = time.perf_counter()
            dt = _np_dtype(plan.dtype_physical if direction == "forward"
                           else plan.dtype_spectral)
            if len(entries) == 1:
                out = np.asarray(entries[0].payload, dtype=dt)
            else:
                out = np.stack(
                    [np.asarray(e.payload, dtype=dt) for e in entries],
                    axis=-1)
            batch.timings["pack_s"] = time.perf_counter() - t0
            return out

        return pack

    def _dispatch_meta(self, batch: Batch) -> dict:
        """What ``certify(engine=True)`` needs to re-verify this
        dispatch against its ``collective_costs`` prediction — wire
        dtype and priced wire bytes included, so a dispatch whose
        logged payload size disagrees with the plan's (possibly
        reduced-precision) schedule fails ``verify_dispatch_log``
        typed instead of certifying cleanly, and mixed-precision
        traffic is auditable per dispatch."""
        B = len(batch.entries)
        # "trace" (the leader's) rides the engine task meta: the
        # executor installs it as ambient context around the dispatch,
        # so engine/guard/retry records journal under the request's id
        # (trace-ctx lint: this dict must carry the inbound trace)
        meta = {"service": self._sid, "kind": batch.kind,
                "key": batch.key, "n": B, "cost": batch.cost,
                "trace": batch.entries[0].trace}
        if batch.kind == "fft":
            e0 = batch.entries[0]
            extra = (B,) if B > 1 else ()
            meta.update(plan=e0.plan, direction=e0.direction,
                        extra_dims=extra,
                        wire_dtype=e0.plan.wire_dtype,
                        wire_bytes=e0.plan.predicted_wire_bytes(extra))
        return meta

    def _validate_entry(self, batch: Batch, entry: _Entry
                        ) -> Optional[BaseException]:
        from ..parallel.arrays import PencilArray

        u = entry.payload
        if not isinstance(u, PencilArray):
            return None
        if batch.kind == "fft":
            e0 = batch.entries[0]
            pen = (e0.plan.input_pencil if e0.direction == "forward"
                   else e0.plan.output_pencil)
            if u.pencil != pen:
                return StaleRequestError(
                    f"request {entry.ticket.id}: payload lives on "
                    f"{u.pencil!r}, plan expects {pen!r} (a device "
                    f"payload cannot follow a rebuilt plan; submit "
                    f"host arrays against a named plan to survive "
                    f"reformation)")
        elif u.pencil != batch.entries[0].payload.pencil:
            # reshard coalescing stacks payloads: every member must
            # live on the SAME pencil (same mesh incarnation)
            return StaleRequestError(
                f"request {entry.ticket.id}: reshard payload pencil "
                f"differs from its coalesce group's")
        return None

    def _run_batch(self, batch: Batch,
                   host_operand=None) -> List[object]:
        """Build the coalesced operand, execute ONE dispatch, split the
        results per request.  Runs inside ``guarded_step`` on the
        engine's consumer thread — re-runnable by construction (inputs
        are never donated on the serve path, and ``host_operand`` — the
        pool-packed host stack, when the batch had one — re-scatters
        cleanly on every retry)."""
        from .. import guard

        entries = batch.entries
        B = len(entries)
        if batch.kind == "reshard":
            from ..parallel.transpositions import reshard

            xs = [self._materialize_reshard(e) for e in entries]
            arr = xs[0] if B == 1 else self._stack(xs, batch)
            # the service's hbm_limit rides the dispatch: a coalesced
            # whale batch replans at its coalesced extra_dims, so the
            # synthesized chunking scales with the batch (and a batch
            # for which nothing fits fails THESE tickets typed — the
            # isolation contract, not an unbounded dispatch)
            out = reshard(arr, entries[0].dest, method=entries[0].method,
                          hbm_limit=self.hbm_limit)
            return self._split(out, B, batch)
        e0 = entries[0]
        plan, direction = e0.plan, e0.direction
        arr = self._coalesce_fft(plan, direction, entries,
                                 host_operand=host_operand, batch=batch)
        if guard.enabled():
            # isolation path: the EAGER schedule — per-hop invariant
            # probes inside each exchange, hang watchdog per dispatch; a
            # corrupted hop raises typed IntegrityError scoped to this
            # batch (the fast path below replays the whole chain as one
            # CUDA graph the probes cannot see into)
            out = (plan.forward(arr) if direction == "forward"
                   else plan.backward(arr))
            return self._split(out, B, batch)
        cp = self.registry.compiled(
            plan, arr.extra_dims,
            tenants=[e.ticket.tenant for e in entries])
        # the result sits in the graph's static output (on the card),
        # which the next replay of the plan's pool overwrites: the split
        # copies every sample out of it, B = 1 included, before the
        # replay lets go of the pool
        return cp.replay(arr, direction, lambda out: self._split(
            out, B, batch, copy=cp.graphed))

    @staticmethod
    def _stack(xs, batch: Optional[Batch] = None) -> object:
        """Coalesce B single-sample arrays along one trailing batch dim
        (``extra_dims == (B,)``) — each hop's single collective then
        carries the whole batch (bytes ×B, count ×1).  K1 writes each
        sample straight into the batch operand's ``[..., i]`` view (no
        intermediate stack)."""
        import torch

        from ..ops import permute as k1
        from ..parallel.arrays import PencilArray

        t0 = time.perf_counter()
        pen = xs[0].pencil
        x0 = xs[0].data
        data = torch.empty(tuple(x0.shape) + (len(xs),), dtype=x0.dtype,
                           device=x0.device)
        axes = tuple(range(x0.dim()))
        for i, x in enumerate(xs):
            k1.permute(x.data, axes, out=data[..., i])
        if batch is not None:
            batch.timings["stack_s"] = time.perf_counter() - t0
        return PencilArray(pen, data, (len(xs),))

    @staticmethod
    def _split(out, B: int, batch: Optional[Batch] = None, *,
               copy: bool = False) -> List[object]:
        """The batch result as B single-sample arrays, each in storage of
        its own (K1 reads the ``[..., i]`` view into a new tensor).  With
        B = 1 the result is returned as is, unless ``copy`` (it lives in
        a buffer the next dispatch overwrites): then K1 copies it."""
        from ..ops import permute as k1
        from ..parallel.arrays import PencilArray

        if B == 1 and not copy:
            return [out]
        t0 = time.perf_counter()
        if B == 1:
            parts = [k1.permute(out.data, tuple(range(out.data.dim())))]
        else:
            parts = _split_fn(B)(out.data)
        if batch is not None:
            batch.timings["split_s"] = time.perf_counter() - t0
        return [PencilArray(out.pencil, p, ()) for p in parts]

    def _coalesce_fft(self, plan, direction: str, entries: List[_Entry],
                      *, host_operand=None, batch: Optional[Batch] = None):
        """The batch operand: an all-host batch is stacked ON THE HOST
        (by the engine's host pool — ``host_operand``, built while the
        previous batch's device program ran — or inline on a cold
        path) and scattered in ONE ``from_global`` (one host-to-device
        copy for the whole batch — B per-sample scatters plus a
        device-side restack would eat the coalescing win); any device
        payload in the batch falls back to per-sample materialize + K1
        stack."""
        import numpy as np

        from ..parallel.arrays import PencilArray

        pen = (plan.input_pencil if direction == "forward"
               else plan.output_pencil)
        dt = (plan.dtype_physical if direction == "forward"
              else plan.dtype_spectral)
        B = len(entries)
        if host_operand is None and not any(
                isinstance(e.payload, PencilArray) for e in entries):
            ndt = _np_dtype(dt)
            host_operand = (
                np.asarray(entries[0].payload, dtype=ndt) if B == 1 else
                np.stack([np.asarray(e.payload, dtype=ndt)
                          for e in entries], axis=-1))
        if host_operand is not None:
            t0 = time.perf_counter()
            arr = PencilArray.from_global(
                pen, host_operand, extra_ndims=0 if B == 1 else 1)
            if arr.data.is_cuda:
                import torch

                torch.cuda.current_stream(arr.device).synchronize()
            if batch is not None:
                batch.timings["h2d_s"] = time.perf_counter() - t0
            return arr
        xs = [self._materialize_fft(plan, pen, dt, e) for e in entries]
        return xs[0] if B == 1 else self._stack(xs, batch)

    def _materialize_fft(self, plan, pen, dt, entry: _Entry):
        # stale-pencil detection lives in _validate_entry (the
        # per-entry pre-dispatch check) — by here every device payload
        # was validated against this batch's pencil
        from ..parallel.arrays import PencilArray

        u = entry.payload
        if isinstance(u, PencilArray):
            if u.dtype != dt:
                u = PencilArray(u.pencil, u.data.to(dt), u.extra_dims)
            return u
        import numpy as np

        return PencilArray.from_global(
            pen, np.asarray(u, dtype=_np_dtype(dt)))

    @staticmethod
    def _materialize_reshard(entry: _Entry):
        return entry.payload

    def _finish(self, batch: Batch, outs: Optional[List[object]],
                err: Optional[BaseException], execute_s: float) -> None:
        from .. import obs

        with self._lock:
            self._inflight = [b for b in self._inflight
                              if b is not batch]
        for i, e in enumerate(batch.entries):
            self._finish_one(batch.key, e,
                             result=None if err is not None else outs[i],
                             error=err)
        with self._lock:
            self._timings.append(dict(
                key=batch.key, kind=batch.kind, n=len(batch.entries),
                ok=err is None, execute_s=execute_s, **batch.timings))
        # feed the load tracker: the dispatch's measured wall time IS
        # the service-rate sample every projection reads (ok or failed
        # — the time was equally real)
        self.queue.note_batch_done(batch, execute_s)
        if obs.enabled():
            obs.histogram("serve.execute_seconds",
                          kind=batch.kind).observe(execute_s)
        # a reformation may have parked dropped batches while this one
        # was in flight: with the dispatch done, resubmission is safe —
        # and a streaming pump disarmed by a consumer-thread
        # self-reform (the _rearm hook refuses to act there) is
        # re-armed HERE, where the in-flight dispatch provably ended
        self._flush_parked()
        if self._streaming and not self._closed and self.queue.depth():
            self._schedule_pump()

    def _finish_one(self, batch_key: str, e: _Entry, *, result=None,
                    error: Optional[BaseException] = None) -> None:
        from .. import obs

        outcome = "ok" if error is None else type(error).__name__
        self.queue.release(e)
        t = e.ticket
        if error is None:
            t._fulfill(result)
        else:
            t._fail(error)
        late = (error is None and e.deadline is not None
                and t.t_done > e.deadline)
        if obs.enabled():
            obs.counter("serve.completed", tenant=t.tenant,
                        outcome=outcome).inc()
            obs.histogram("serve.wait_seconds", tenant=t.tenant).observe(
                max(0.0, (t.t_dispatch or t.t_submit) - t.t_submit))
            obs.gauge("serve.queue_depth", tenant=t.tenant).set(
                self.queue.depth(t.tenant))
            # a non-ok completion gates a client-visible failure:
            # fsync-critical via the per-record override
            obs.record_event(
                "serve.complete", _fsync=(error is not None),
                tenant=t.tenant, req=t.id, outcome=outcome,
                seconds=t.t_done - t.t_submit, key=batch_key,
                trace=e.trace,
                **({"error": str(error)} if error is not None else {}))
            if late:
                # the completion enforcement point: the answer is
                # returned (the work is done) but the violation is on
                # the record, fsync-critical — an SLO breach must
                # survive even a crash right after it
                obs.counter("serve.slo_violations",
                            tenant=t.tenant).inc()
                obs.record_event(
                    "serve.slo_violation", tenant=t.tenant, req=t.id,
                    deadline_s=e.deadline_s,
                    late_s=t.t_done - e.deadline, key=batch_key,
                    trace=e.trace)
        slo = self._slos.get(t.tenant)
        if slo is not None and slo.deadline_s is not None:
            # every deadline-carrying completion is a burn sample: a
            # late answer and a deadline-typed failure (expired /
            # projected shed) both spend the tenant's error budget
            alert = self.burn.note(
                t.tenant, late or isinstance(error, DeadlineError))
            if obs.enabled():
                obs.gauge("serve.burn_rate", tenant=t.tenant).set(
                    self.burn.burn_rate(t.tenant) or 0.0)
                if alert is not None:
                    # the page: the budget is burning threshold-x too
                    # fast — fsync-critical (an overload episode must
                    # be on the record even if the process dies in it)
                    obs.counter("serve.burn_alerts",
                                tenant=t.tenant).inc()
                    obs.record_event("serve.burn_alert", _fsync=True,
                                     **alert)
        with self._lock:
            self._completed[outcome] = self._completed.get(outcome, 0) + 1
            if late:
                self._slo_violations += 1

    # -- pre-flight certification ------------------------------------------
    def certify(self, *, hbm_limit: Optional[int] = None,
                raise_on_error: bool = True, engine: bool = False) -> dict:
        """Certify every resident plan BEFORE it serves traffic: each
        registered fingerprint's resident executables (forward AND
        backward, every resident ``extra_dims``/donate variant — or the
        plan's default batch when nothing has compiled yet) are traced
        with :mod:`pencilarrays_tpu_torch.analysis.spmd` and proved
        equal, op for op, to the plan's ``collective_costs``
        prediction; ``hbm_limit`` additionally bounds each certified
        variant's static peak memory at that variant's OWN
        ``extra_dims`` (a coalesced-batch executable is priced at its
        batch).  A trace runs the program once on zeros, so on a
        topology of several ranks every rank's service certifies
        together, in the same order.

        One ``analysis.check`` journal record per certified target
        (non-ok fsync-critical).  Returns the sweep report; with
        ``raise_on_error`` the first divergence re-raises its typed
        error (:class:`~pencilarrays_tpu_torch.analysis.errors.
        ScheduleMismatchError` naming the offending op, ...) after the
        report entry is journaled — the pre-flight gate.

        ``engine=True`` additionally certifies the pipelined execution
        this service actually ran: the engine's issued dispatch log
        (filtered to this service's batches) is proved equal to the
        serialized schedule (:func:`~pencilarrays_tpu_torch.analysis.
        spmd.verify_dispatch_log`; typed :class:`~pencilarrays_tpu_torch.
        analysis.errors.DispatchOrderError` /
        :class:`~pencilarrays_tpu_torch.analysis.errors.
        ScheduleMismatchError` naming the first divergence).  The
        result rides the report under ``"engine"``."""
        from ..analysis.errors import AnalysisError
        from ..analysis.spmd import certify_plan

        t0 = time.perf_counter()
        report: dict = {"plans": [], "ok": True}
        for key in self.registry.keys():
            plan = self.registry.plan(key)
            if plan is None:
                continue
            compiled = self.registry.executables(key)
            targets = ([(cp, cp.extra_dims) for cp in compiled]
                       or [(None, None)])
            for cp, extra in targets:
                # hbm_limit rides each variant's certification: a
                # resident coalesced-batch executable is bounded at ITS
                # extra_dims, not the plan's default batch
                try:
                    rec = certify_plan(plan, extra, compiled=cp,
                                       hbm_limit=hbm_limit,
                                       target=f"serve:{key}")
                except AnalysisError as e:
                    if raise_on_error:
                        raise
                    rec = {"target": f"serve:{key}",
                           "outcome": type(e).__name__,
                           "error": str(e),
                           "extra_dims": list(
                               extra if extra is not None
                               else plan.batch_dims)}
                    report["ok"] = False
                report["plans"].append(rec)
        if engine:
            from ..analysis.spmd import verify_dispatch_log

            eng = self.engine()
            mine = [r for r in eng.dispatch_log()
                    if r.meta.get("service") == self._sid]
            try:
                report["engine"] = verify_dispatch_log(
                    mine, source=f"serve-engine:{eng.name}")
                # the log is a bounded window: a certification that did
                # not see the whole run must say so, never imply it did
                report["engine"]["log_truncated"] = \
                    eng.stats()["log_truncated"]
            except AnalysisError as e:
                if raise_on_error:
                    raise
                report["engine"] = {"outcome": type(e).__name__,
                                    "error": str(e)}
                report["ok"] = False
        report["seconds"] = time.perf_counter() - t0
        report["certified"] = len(report["plans"])
        return report

    # -- introspection -----------------------------------------------------
    def batch_timings(self) -> List[dict]:
        """The last 1024 finished dispatches, oldest first: ``{key, kind,
        n, ok, execute_s}`` plus the host seconds of the parts that ran —
        ``pack_s`` (the host-pool numpy stack), ``h2d_s`` (the one
        ``from_global`` copy to the device), ``stack_s`` (K1 stacking
        device payloads), ``split_s`` (K1 splitting the result)."""
        with self._lock:
            return list(self._timings)

    def stats(self) -> dict:
        """Service snapshot: registry hit/miss, per-tenant accounting,
        queue depth, dispatch/completion counts, SLO violation count
        and the pressure-gate state (``None`` when no gate is
        armed)."""
        with self._lock:
            completed = dict(self._completed)
            violations = self._slo_violations
        return {"registry": self.registry.stats(),
                "tenants": self.queue.tenants(),
                "queue_depth": self.queue.depth(),
                "dispatches": self._dispatches,
                "completed": completed,
                "slo_violations": violations,
                "pressure": (self._gate.state
                             if self._gate is not None else None)}
