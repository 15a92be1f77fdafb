"""Admission + coalescing queue — the service's scheduling brain (a copy
of the JAX package's ``serve/queue.py``).

Three responsibilities, all deterministic (a multi-controller mesh runs
one service instance per rank, and every rank must make IDENTICAL
batching and ordering decisions from the same submission sequence —
wall clocks only gate *when* a batch becomes ready, never how batches
are formed or ordered relative to each other):

* **admission** — per-tenant quotas (queue depth, in-flight logical
  bytes) checked at :meth:`offer`; violations raise typed
  :class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError` and never
  enter the queue;
* **coalescing** — same-fingerprint requests (same ``plan_key`` ×
  direction, or same reshard route) group along ``extra_dims`` into
  one batched dispatch: bytes ×B, collective count ×1 — the
  batched-plan amortization, applied to *traffic* instead of a
  caller-declared batch.  A group dispatches when it reaches
  ``max_batch`` or its oldest request has waited ``max_wait_s``
  (a flush takes everything, ragged final batch included);
* **cost ordering** — ready batches dispatch cheapest-first in the
  ``collective_costs`` currency (``count * latency_bytes + bytes``,
  the Auto/route-planner score), so a small tenant's request is never
  starved behind a huge plan's traffic.  Anti-starvation: a batch
  whose oldest request has waited ``starve_after_s`` jumps the cost
  order (FIFO among the starved), so expensive batches are delayed,
  never parked forever.

A take is a decision that changes nothing (which queued entries
expired, which batches are due, in what order, all by one clock) and
one step that applies it.  On a topology of several ranks (the port
runs one process, one queue, per rank) the clock is rank 0's: rank 0
decides and publishes the decision (:func:`~pencilarrays_tpu_torch.
parallel.distributed.agree`, the entries named by their admission
number since that topology took over), and every rank, rank 0 too,
applies it to its own queue by the same code, so every rank sheds the
same entries and issues the same batches in the same order, as the JAX
package's one controller does with its one clock.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .errors import AdmissionError, ServiceClosedError
from .slo import LoadTracker

__all__ = ["Ticket", "TenantQuota", "Batch", "AdmissionQueue"]

_ids = itertools.count(1)


class Ticket:
    """A submitted request's future: :meth:`result` blocks until the
    service fulfilled or failed it (typed errors re-raise here — an
    :class:`~pencilarrays_tpu_torch.guard.IntegrityError` detected inside
    this request's batch surfaces on THIS ticket, nobody else's)."""

    def __init__(self, tenant: str, kind: str, key: str):
        self.id = next(_ids)
        self.tenant = tenant
        self.kind = kind
        self.key = key
        self.t_submit = time.monotonic()
        self.t_dispatch: Optional[float] = None
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """The request's output array; raises the request's typed error
        (or ``TimeoutError`` if the service has not resolved it yet)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} (tenant {self.tenant!r}) not done")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        """The failure, if the request failed (None while pending/ok)."""
        return self._error

    def _fulfill(self, result) -> None:
        self.t_done = time.monotonic()
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self.t_done = time.monotonic()
        self._error = error
        self._event.set()


@dataclass(frozen=True)
class TenantQuota:
    """Admission limits of one tenant: pending+executing request count
    and pending+executing logical payload bytes (global, unpadded —
    what the tenant asked to move, not what the mesh pads it to)."""

    max_requests: int = 1024
    max_bytes: int = 1 << 34    # 16 GiB of queued traffic per tenant


@dataclass
class _Entry:
    """One queued request (internal)."""

    ticket: Ticket
    plan: object                  # PencilFFTPlan, or None for reshard
    direction: str                # "forward" | "backward" (fft)
    payload: object               # PencilArray | host array
    nbytes: int
    plan_name: Optional[str]      # named (elastic-rebindable) plans
    dest: object = None           # reshard destination Pencil
    method: object = None         # reshard method
    seq: int = 0                  # admission order (deterministic ties)
    deadline: Optional[float] = None  # absolute monotonic SLO deadline
    deadline_s: Optional[float] = None  # its budget, the SLO's own value
    shed_priority: int = 0        # the tenant's SLO shed tier
    cost_bytes: int = 0           # priced B=1 cost (projection currency)
    departed: bool = False        # left _pending (lazy SLO-heap skip)
    trace: Optional[str] = None   # request trace context (schema v6)
    feed: Optional[dict] = None   # the gate feed its admission made


@dataclass
class Batch:
    """A ready-to-dispatch coalesced group."""

    key: str
    kind: str                     # "fft" | "reshard"
    entries: List[_Entry]
    reason: str                   # "full" | "deadline" | "flush"
    cost: int = 0                 # bytes-equivalent score (set by queue)
    seq: int = 0                  # first entry's admission order
    resubmits: int = 0            # engine-reformation resubmission count
    # (a taken batch dropped typed by Engine.reform re-enters the
    # reformed engine instead of stranding its tickets — bounded)
    timings: dict = field(default_factory=dict)   # host seconds of the
    # dispatch's parts (pack_s, h2d_s, stack_s, split_s), set as they run

    @property
    def tickets(self) -> List[Ticket]:
        return [e.ticket for e in self.entries]


class AdmissionQueue:
    """The deterministic admission/coalescing/ordering core (see module
    docstring).  Thread-safe; scheduling state never leaves the lock."""

    def __init__(self, *, max_batch: int = 8, max_wait_s: float = 0.002,
                 starve_after_s: float = 1.0,
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 hbm_limit: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.starve_after_s = float(starve_after_s)
        # per-chip peak-HBM bound the service's reshard traffic is
        # planned under (PlanService(hbm_limit=)): batch pricing plans
        # with it so the cost the scheduler orders by is the cost of
        # the route that will actually dispatch (chunk-synthesized
        # whale routes price their count xK)
        self.hbm_limit = int(hbm_limit) if hbm_limit is not None else None
        self.default_quota = default_quota or TenantQuota()
        self.quotas = dict(quotas or {})
        self._lock = threading.Lock()
        self._closed = False
        self._last_seq = 0     # the last admission's number
        # coalesce key -> entries in admission order
        self._pending: Dict[str, List[_Entry]] = {}
        # per-tenant accounting: requests/bytes admitted and not yet
        # completed (queued + executing)
        self._tenant_requests: Dict[str, int] = {}
        self._tenant_bytes: Dict[str, int] = {}
        # the queue's own arrival/cost/service history — THE load
        # projection admission deadlines, the shedding gate and the
        # autoscaler all read (serve/slo.py)
        self.load = LoadTracker()
        # per-coalesce-key B=1 price cache (the projection currency is
        # priced once per distinct traffic shape, not once per request)
        self._key_cost: Dict[str, int] = {}
        # entries shed at the take point (SLO deadline expired while
        # queued) — the service pops these and fails their tickets typed
        self._expired: List[_Entry] = []
        # -- the take-path index --
        # A take path that rescans EVERY pending group per tick is
        # O(groups) per call, superlinear across a burst (pinned by
        # tests/test_torch_slo.py's depth cases).  The take touches
        # only groups that can actually yield work:
        # _full — groups at max_batch (maintained at offer/take);
        # _due_heap — (coalesce deadline, tiebreak, key), lazily
        # validated (a popped key whose LIVE head is due later is
        # re-pushed, a dead key is dropped); _slo_heap — (SLO deadline,
        # seq, entry), lazily skipping departed entries.  Batch
        # formation and dispatch order are untouched — the index
        # changes WHAT is scanned, never what is taken or how it sorts.
        self._full: set = set()
        self._due_heap: list = []
        self._slo_heap: list = []
        self._heap_seq = itertools.count(1)
        # scan accounting (the scaling assertion's deterministic pin)
        self._take_calls = 0
        self._groups_scanned = 0
        # -- the depth index --
        # depth() sits on the fleet worker's 50ms load-export path
        # (service.load_projection -> publish_load): re-counting every
        # queued entry per call would be O(depth) per export,
        # superlinear across a burst.  Queued-entry counts (distinct
        # from _tenant_requests/_bytes, which also cover EXECUTING
        # work and release at completion) are now maintained at offer
        # and at every _pending departure; depth() just reads them.
        # depth_entries_scanned stays 0 on the O(1) path — the
        # scaling assertion's pin (reintroducing a scan must bump it).
        self._depth_total = 0
        self._depth_tenant: Dict[str, int] = {}
        self._depth_entries_scanned = 0
        # queued entries by admission sequence (maintained at offer and
        # at every departure); a take decision names an entry by its
        # number counted from _seq_base, the last admission before the
        # deciding topology took over, so a rank that joined with a
        # fresh queue names it alike
        self._by_seq: Dict[int, _Entry] = {}
        self._seq_base = 0
        # the topology whose rank 0 decides every take (None: this
        # queue's own clock decides — one rank); a take, and anything
        # else that removes queued entries, holds _take_lock from the
        # decision to its application
        self._agree_topo = None
        self._take_lock = threading.Lock()

    def agree_on(self, topology) -> None:
        """Take by the decision of ``topology``'s rank 0 from now on, or
        by this queue's own clock when ``topology`` has one rank (the
        service calls this at every admission, and when a reformation
        re-plans: the newest topology decides)."""
        want = topology if len(topology) > 1 else None
        if want is not self._agree_topo:
            with self._take_lock, self._lock:
                self._agree_topo = want
                self._seq_base = self._last_seq

    # -- admission ---------------------------------------------------------
    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def offer(self, entry: _Entry) -> bool:
        """Admit one request or raise typed
        :class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError`.
        Returns True when this admission brought its coalesce group to
        a full ``max_batch`` — the streaming pump's fast-path signal
        (a full batch gains nothing by waiting out the deadline),
        known for free at append time."""
        t = entry.ticket.tenant
        q = self.quota_for(t)
        with self._lock:
            if self._closed:
                # checked under the SAME lock close_gate() takes, so a
                # submit racing close() is rejected typed — it can
                # never land after the service's final drain pass
                raise ServiceClosedError("service is closed")
            n = self._tenant_requests.get(t, 0)
            b = self._tenant_bytes.get(t, 0)
            if n + 1 > q.max_requests:
                raise AdmissionError(
                    f"tenant {t!r}: queue depth {n} at quota "
                    f"({q.max_requests} requests)", tenant=t,
                    reason="queue-depth")
            if b + entry.nbytes > q.max_bytes:
                raise AdmissionError(
                    f"tenant {t!r}: {b + entry.nbytes} in-flight bytes "
                    f"would exceed quota ({q.max_bytes})", tenant=t,
                    reason="inflight-bytes")
            self._last_seq += 1
            entry.seq = self._last_seq
            entry.departed = False
            self._by_seq[entry.seq] = entry
            self._tenant_requests[t] = n + 1
            self._tenant_bytes[t] = b + entry.nbytes
            self._depth_total += 1
            self._depth_tenant[t] = self._depth_tenant.get(t, 0) + 1
            group = self._pending.setdefault(entry.ticket.key, [])
            group.append(entry)
            if len(group) == 1:
                # the group's coalescing deadline enters the index once,
                # at formation; a remainder left by a take re-pushes
                heapq.heappush(self._due_heap, (
                    entry.ticket.t_submit + self.max_wait_s,
                    next(self._heap_seq), entry.ticket.key))
            if entry.deadline is not None:
                heapq.heappush(self._slo_heap,
                               (entry.deadline, entry.seq, entry))
            self.load.note_arrival(entry.cost_bytes)
            full = len(group) >= self.max_batch
            if full:
                self._full.add(entry.ticket.key)
            return full

    def close_gate(self) -> None:
        """Refuse all future :meth:`offer` calls (atomic with the offer
        path's lock — nothing can slip in after this returns)."""
        with self._lock:
            self._closed = True

    def _depart_locked(self, entry: _Entry) -> None:
        """One entry leaves ``_pending`` (taken, shed or evicted):
        flag it for the lazy heaps and settle the depth index.  Every
        departure path MUST come through here — the depth counters are
        only as honest as their bookkeeping.  Caller holds the lock."""
        entry.departed = True
        self._by_seq.pop(entry.seq, None)
        t = entry.ticket.tenant
        self._depth_total -= 1
        left = self._depth_tenant.get(t, 0) - 1
        if left > 0:
            self._depth_tenant[t] = left
        else:
            self._depth_tenant.pop(t, None)

    def cancel_split(self, ticket: Optional[Ticket],
                     error: BaseException) -> None:
        """Undo one admission on which the ranks of a mesh split (some
        admitted the request, others refused it): ``ticket``'s request,
        admitted here, leaves the queue, returns its quota and fails
        with ``error``; with ``ticket=None`` (refused here) this queue
        spends the admission number the others gave it, so the ranks
        keep naming their entries alike."""
        with self._take_lock, self._lock:
            if ticket is None:
                self._last_seq += 1
                return
            group = self._pending.get(ticket.key, [])
            entry = next((e for e in group if e.ticket is ticket), None)
            if entry is None:
                raise RuntimeError(
                    f"request {ticket.id} left the queue before the ranks "
                    f"agreed on its admission")
            self._depart_locked(entry)
            group.remove(entry)
            if not group:
                del self._pending[ticket.key]
            if len(group) < self.max_batch:
                self._full.discard(ticket.key)
            self._clean_heaps_locked()
            self.load.note_removed(entry.cost_bytes)
        self.release(entry)
        ticket._fail(error)

    def release(self, entry: _Entry) -> None:
        """Return one request's quota (called at completion, ok or
        failed — the quota covers queued *and* executing work)."""
        t = entry.ticket.tenant
        with self._lock:
            self._tenant_requests[t] = max(
                0, self._tenant_requests.get(t, 0) - 1)
            self._tenant_bytes[t] = max(
                0, self._tenant_bytes.get(t, 0) - entry.nbytes)

    # -- batching ----------------------------------------------------------
    def take_ready(self, *, flush: bool = False,
                   now: Optional[float] = None) -> List[Batch]:
        """Pop every ready batch, ordered for dispatch.

        Readiness: a full ``max_batch`` group is always ready; a
        partial group is ready once its oldest member waited
        ``max_wait_s`` (or immediately under ``flush`` — the ragged
        final batch of a drain).  Ordering: starved batches first (in
        admission order), then ascending priced cost, admission order
        breaking ties — deterministic for identical submission
        sequences regardless of wall clocks.

        SLO take-point enforcement: entries whose deadline expired
        while queued are shed BEFORE batch formation (an expired
        request must not burn mesh time that makes its neighbors late
        too) — the service pops them via :meth:`pop_expired` and fails
        their tickets typed ``DeadlineError(reason="expired")``.

        A take is a decision (:meth:`_decide`, which changes nothing)
        and its one application (:meth:`_apply`).  On a topology of
        several ranks (:meth:`agree_on`) the decision is rank 0's, by
        its clock, and every rank applies it (module docstring)."""
        with self._take_lock:
            topo = self._agree_topo
            if topo is None:
                decision = self._decide(flush, now)
            else:
                from ..parallel.distributed import agree

                decision = agree(topo, "serve-take",
                                 lambda: self._decide(flush, now))
            return self._apply(decision)

    def _decide(self, flush: bool, now: Optional[float]) -> dict:
        """The take by this queue's clock, as a JSON decision: the
        entries it sheds as expired and the batches it forms
        (``[reason, entries, cost]``, in dispatch order), every entry
        named by its admission number since the deciding topology took
        over.  Reads the queue, changes nothing (the caller holds
        ``_take_lock``)."""
        now = time.monotonic() if now is None else now
        expired: List[_Entry] = []
        formed: List[Batch] = []
        with self._lock:
            keys = (list(self._pending) if flush
                    else self._due_keys_locked(now))
            for key in keys:
                live = []
                for e in self._pending.get(key, ()):
                    if e.deadline is not None and now > e.deadline:
                        expired.append(e)
                    else:
                        live.append(e)
                while len(live) >= self.max_batch:
                    formed.append(self._mk_batch(
                        key, live[: self.max_batch], "full"))
                    live = live[self.max_batch:]
                if live and (flush or now - live[0].ticket.t_submit
                             >= self.max_wait_s):
                    formed.append(self._mk_batch(
                        key, live, "flush" if flush else "deadline"))
        for b in formed:
            b.cost = self._batch_cost(b)

        def order(b: Batch):
            starved = (now - b.entries[0].ticket.t_submit
                       >= self.starve_after_s)
            return (0, b.seq) if starved else (1, b.cost, b.seq)

        formed.sort(key=order)
        base = self._seq_base
        return {"expired": [e.seq - base for e in expired],
                "batches": [[b.reason, [e.seq - base for e in b.entries],
                             b.cost] for b in formed]}

    def _apply(self, decision: dict) -> List[Batch]:
        """Carry out a take decision, this queue's own or rank 0's (its
        entries are the same admissions on every rank that submitted
        the same requests in the same order): the one path by which a
        take changes the queue.  Returns the batches in dispatch
        order."""
        out: List[Batch] = []
        with self._lock:
            self._take_calls += 1
            touched: Dict[str, None] = {}

            def pull(seq: int) -> _Entry:
                e = self._by_seq.get(seq + self._seq_base)
                if e is None:
                    raise RuntimeError(
                        f"the take names request #{seq}, which is not "
                        f"queued here: the ranks did not submit the same "
                        f"requests in the same order before this take")
                self._depart_locked(e)
                touched[e.ticket.key] = None
                return e

            for seq in decision["expired"]:
                e = pull(seq)
                self._expired.append(e)
                self.load.note_removed(e.cost_bytes)
            for reason, seqs, cost in decision["batches"]:
                entries = [pull(s) for s in seqs]
                b = self._mk_batch(entries[0].ticket.key, entries, reason)
                b.cost = cost
                out.append(b)
            self._groups_scanned += len(touched)
            for key in touched:
                left = [e for e in self._pending[key] if not e.departed]
                if left:
                    # the survivors' coalescing deadline re-enters the
                    # index (the one that surfaced this key is stale)
                    self._pending[key] = left
                    heapq.heappush(self._due_heap, (
                        left[0].ticket.t_submit + self.max_wait_s,
                        next(self._heap_seq), key))
                else:
                    del self._pending[key]
                if len(left) < self.max_batch:
                    self._full.discard(key)
            self._clean_heaps_locked()
        for b in out:
            for e in b.entries:
                self.load.note_taken(e.cost_bytes)
        return out

    def _clean_heaps_locked(self) -> None:
        """Pop the stale entries off the heaps' tops: departed SLO
        entries, and coalescing deadlines of groups that left or whose
        head changed (such a group is re-indexed at its live head's
        deadline).  A stale entry below a live top waits until it
        surfaces (the heaps are lazy).  Caller holds the lock."""
        while self._slo_heap and self._slo_heap[0][2].departed:
            heapq.heappop(self._slo_heap)
        while self._due_heap:
            d, _, k = self._due_heap[0]
            group = self._pending.get(k)
            actual = (group[0].ticket.t_submit + self.max_wait_s
                      if group else None)
            if actual is not None and actual <= d:
                break
            heapq.heappop(self._due_heap)
            if actual is not None:
                heapq.heappush(self._due_heap,
                               (actual, next(self._heap_seq), k))

    @staticmethod
    def _heap_upto(heap: list, bound: float) -> list:
        """The entries of ``heap`` keyed at or before ``bound``, without
        popping them: a heap's children never precede their parent, so
        the walk visits only those entries and their children."""
        out, stack = [], [0]
        while stack:
            i = stack.pop()
            if i < len(heap) and heap[i][0] <= bound:
                out.append(heap[i])
                stack += (2 * i + 1, 2 * i + 2)
        return out

    def _due_keys_locked(self, now: float) -> List[str]:
        """Every key that can yield work at ``now``: full groups,
        groups whose coalescing deadline passed, and groups holding an
        SLO-expired entry (the take-point shed must fire even when the
        group itself is not due).  O(due + full), NOT O(groups); reads
        the heaps without popping them (:meth:`_apply` cleans them).
        Caller holds the lock."""
        keys: List[str] = []
        seen = set()

        def add(k: str) -> None:
            if k not in seen:
                seen.add(k)
                keys.append(k)

        for _, _, entry in self._heap_upto(self._slo_heap, now):
            if not entry.departed and entry.ticket.key in self._pending:
                add(entry.ticket.key)
        for k in self._full:
            add(k)
        for _, _, k in self._heap_upto(self._due_heap, now):
            group = self._pending.get(k)
            if group and group[0].ticket.t_submit + self.max_wait_s <= now:
                add(k)
        return keys

    def scan_stats(self) -> dict:
        """Take-path scan accounting — ``groups_scanned`` across
        ``take_calls`` is what the depth-stress scaling assertion pins
        (it must track DUE work, not queue breadth).
        ``depth_entries_scanned`` pins the depth-index fix the same
        way: it must stay 0 no matter how often :meth:`depth` is
        polled at depth (the load-export path reads counters, never
        rescans the queue)."""
        with self._lock:
            return {"take_calls": self._take_calls,
                    "groups_scanned": self._groups_scanned,
                    "depth_entries_scanned": self._depth_entries_scanned}

    @staticmethod
    def _mk_batch(key: str, entries: List[_Entry], reason: str) -> Batch:
        e0 = entries[0]
        kind = "reshard" if e0.plan is None else "fft"
        return Batch(key=key, kind=kind, entries=list(entries),
                     reason=reason, seq=e0.seq)

    def pop_expired(self) -> List[_Entry]:
        """Entries shed at the take point since the last pop (admission
        order) — the service fails their tickets typed."""
        with self._lock:
            out, self._expired = self._expired, []
        out.sort(key=lambda e: e.seq)
        return out

    def evict_sheddable(self, protected_priority: int,
                        seqs: Optional[List[int]] = None) -> List[_Entry]:
        """The pressure gate's second rung: remove every queued entry
        whose ``shed_priority`` is strictly below the protected tier
        and return them in admission-sequence order — deterministic in
        the submission sequence (identical submissions evict identical
        sets; the clock only gates WHEN the rung fires).  With ``seqs``
        (rank 0's eviction, its entries named by admission number since
        the deciding topology took over) exactly those entries.  The
        service fails their tickets typed
        ``AdmissionError(reason="shed")``."""
        evicted: List[_Entry] = []
        with self._take_lock, self._lock:
            if seqs is None:
                def goes(e):
                    return e.shed_priority < protected_priority
            else:
                named = {s + self._seq_base for s in seqs}
                missing = named - set(self._by_seq)
                if missing:
                    raise RuntimeError(
                        f"the eviction names requests "
                        f"{sorted(s - self._seq_base for s in missing)}, "
                        f"which are not queued here: the ranks did not "
                        f"submit the same requests in the same order")

                def goes(e):
                    return e.seq in named
            for key in list(self._pending):
                entries = self._pending[key]
                keep = [e for e in entries if not goes(e)]
                if len(keep) != len(entries):
                    for e in entries:
                        if goes(e):
                            self._depart_locked(e)
                            evicted.append(e)
                            self.load.note_removed(e.cost_bytes)
                    if keep:
                        self._pending[key] = keep
                    else:
                        del self._pending[key]
                    if len(keep) < self.max_batch:
                        self._full.discard(key)
        evicted.sort(key=lambda e: e.seq)
        return evicted

    def note_batch_done(self, batch: Batch, execute_s: float) -> None:
        """Feed one finished dispatch into the load tracker (ok or
        failed — the wall time was equally real either way)."""
        cost = sum(e.cost_bytes for e in batch.entries)
        self.load.note_completed(cost, len(batch.entries), execute_s)

    def note_entry_done(self, entry: _Entry) -> None:
        """Clear ONE taken entry's in-flight accounting without a rate
        sample (a validation loser fails before any device time is
        spent; leaving its cost in flight would inflate every drain
        projection forever)."""
        self.load.note_completed(entry.cost_bytes, 1, 0.0)

    def entry_cost(self, entry: _Entry) -> int:
        """Price one request in the projection currency (the B=1 batch
        score), cached per coalesce key — hbm-bounded solo reshards
        share their fingerprint prefix's price.  Traffic the router
        prices at zero (a single-device mesh moves no wire bytes)
        falls back to the logical payload bytes: the PROJECTION must
        stay meaningful on any mesh, while dispatch ordering keeps the
        router score untouched (zero-cost batches still tie
        head-of-line there)."""
        key = entry.ticket.key.split("#solo", 1)[0]
        with self._lock:
            cached = self._key_cost.get(key)
        if cached is not None:
            return cached
        cost = self._batch_cost(self._mk_batch(
            entry.ticket.key, [entry], "price"))
        if cost <= 0:
            cost = max(1, entry.nbytes)
        with self._lock:
            self._key_cost[key] = cost
        return cost

    # -- pricing -----------------------------------------------------------
    def _batch_cost(self, batch: Batch) -> int:
        """Bytes-equivalent dispatch cost of the whole batch — the
        mixed-traffic ordering currency (the route-planner score at the
        coalesced ``extra_dims``: ``count * latency_bytes +
        drift-corrected bytes``, for fft and reshard alike).  NEVER
        raises: unpriceable
        batches (Gspmd hops, any pricing failure) cost 0 and dispatch
        first — the model cannot rank what it cannot see, head-of-line
        is the safe default, and a pricing bug must not wedge the
        dispatch loop (``take_ready`` is on the service's only
        scheduling path)."""
        try:
            return self._batch_cost_inner(batch)
        except Exception:
            return 0

    def _batch_cost_inner(self, batch: Batch) -> int:
        from ..parallel.transpositions import Auto

        B = len(batch.entries)
        extra = (B,) if B > 1 else ()
        e0 = batch.entries[0]
        if batch.kind == "fft":
            # price with the decomposition scorer — the SAME
            # drift-corrected route-planner currency the reshard branch
            # gets from plan_reshard_route, at the plan's own configured
            # method latency; fft and reshard batches must sort in one
            # currency or cheapest-first inverts on mixed traffic
            from ..ops.fft import _schedule_score
            from ..parallel.routing import trusted_drift_hops

            method = e0.plan.method
            latency = (method.latency_bytes if isinstance(method, Auto)
                       else Auto().latency_bytes)
            entry = _schedule_score(e0.plan, extra, latency,
                                    trusted_drift_hops())
            return int(entry["score_bytes"])
        # reshard: the route planner's own score (drift-corrected,
        # HBM-bounded when the service carries a limit — a whale
        # batch's chunk-synthesized route prices its count xK), or the
        # priced GSPMD baseline on fallback
        from ..parallel.routing import plan_reshard_route

        route = plan_reshard_route(e0.payload.pencil, e0.dest, extra,
                                   e0.payload.dtype, method=e0.method,
                                   hbm_limit=self.hbm_limit)
        if route.use_route and route.score_bytes is not None:
            return int(route.score_bytes)
        return int(route.gspmd_score_bytes or 0)

    # -- introspection -----------------------------------------------------
    def next_ready_in(self, now: Optional[float] = None
                      ) -> Optional[float]:
        """Seconds until the OLDEST pending group's coalescing
        deadline (0.0 when already due; None when nothing is
        pending) — the streaming pump re-arms at this instead of a
        fresh full ``max_wait_s``, so a group admitted just after a
        tick never waits ~2x its deadline.  SLO deadlines feed the
        same bound (the deadline-aware pump tick): a queued entry
        about to expire wakes the pump so the take-point shed fails
        its ticket promptly instead of after a full coalescing wait."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._pending:
                return None
            due = None
            while self._due_heap:
                d, _, k = self._due_heap[0]
                group = self._pending.get(k)
                if not group:
                    heapq.heappop(self._due_heap)
                    continue
                actual = group[0].ticket.t_submit + self.max_wait_s
                if actual > d:
                    # stale head: re-index at the live head's deadline
                    heapq.heappop(self._due_heap)
                    heapq.heappush(self._due_heap,
                                   (actual, next(self._heap_seq), k))
                    continue
                due = d
                break
            while self._slo_heap and self._slo_heap[0][2].departed:
                heapq.heappop(self._slo_heap)
            if self._slo_heap:
                sd = self._slo_heap[0][0]
                due = sd if due is None else min(due, sd)
        # every nonempty group holds a due-heap entry (pushed at
        # formation and at every remainder), so due is None only when
        # _pending emptied between the check and the walk — impossible
        # under the lock; the guard is belt-and-braces
        return max(0.0, due - now) if due is not None else None

    def depth(self, tenant: Optional[str] = None) -> int:
        """Queued entries, total or for one tenant — O(1) from the
        depth index (this sits on the fleet load-export path, polled
        every 50ms per mesh; see ``_depart_locked``)."""
        with self._lock:
            if tenant is None:
                return self._depth_total
            return self._depth_tenant.get(tenant, 0)

    def tenants(self) -> Dict[str, dict]:
        """Per-tenant accounting snapshot (admitted, not yet done)."""
        with self._lock:
            names = set(self._tenant_requests) | set(self._tenant_bytes)
            return {t: {"requests": self._tenant_requests.get(t, 0),
                        "bytes": self._tenant_bytes.get(t, 0)}
                    for t in sorted(names)}

    def pending_entries(self) -> List[_Entry]:
        """Snapshot of queued entries (rebind support)."""
        with self._lock:
            return [e for v in self._pending.values() for e in v]
