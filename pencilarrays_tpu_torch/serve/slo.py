"""Service-level objectives — per-tenant deadlines, priorities, and the
load projection they are enforced against (a copy of the JAX package's
``serve/slo.py``: pure Python).

A tenant with a latency budget has, until now, no way to express it:
an overload storm just grows the admission queue until quota rejections,
and a request that will *obviously* miss its deadline still burns a
dispatch.  This module adds the vocabulary:

* :class:`SLO` — what a tenant declares at registration
  (:meth:`~pencilarrays_tpu_torch.serve.PlanService.set_slo`): a per-request
  completion ``deadline_s``, an advisory ``p99_budget_s``, and the
  ``shed_priority`` the load-shedding gate
  (:mod:`~pencilarrays_tpu_torch.serve.shed`) orders sacrifices by;
* :class:`LoadTracker` — the admission queue's own arrival / cost /
  service history in the router's **bytes-equivalent currency** (the
  same ``count x latency_bytes + bytes`` score the cost-ordered
  scheduler already prices batches with).  Everything downstream — the
  admission-time deadline projection, the shedding gate's drain
  estimate, the autoscaler's grow/shrink windows — reads ONE
  projection, so they can never disagree about how loaded the service
  is.

Deadlines are enforced at THREE points (see ``docs/Serving.md``):

1. **admission** — a request whose *projected* wait (queued cost ahead
   of it divided by the measured service rate) already exceeds its
   deadline is rejected typed
   (:class:`~pencilarrays_tpu_torch.serve.errors.DeadlineError`,
   ``reason="projected"``) — never a silent late answer;
2. **take** — entries that expired while queued are shed before
   dispatch (``reason="expired"``): an expired request must not burn
   the mesh time that would make its *neighbors* late too;
3. **completion** — a request that was dispatched in time but finished
   late journals a fsync-critical ``serve.slo_violation`` record and
   ticks ``serve.slo_violations{tenant=}`` — the result is still
   returned (the work is done), but the violation is on the record.

The tracker is deliberately conservative while blind: with no completed
dispatch in its window it projects ``None`` and admission lets
everything through — a service that has never measured itself has no
basis to reject, and the completion-point accounting will seed the
window within one batch.

:class:`BurnRateMonitor` is — the SLO **error-budget burn
rate**: each tenant's budget allows a fraction of completions to bust
their deadline (``budget``, e.g. 0.01 = 1%); the monitor tracks the
observed violation fraction over a sliding time window and reports it
as a multiple of the budget (burn rate 1.0 = burning exactly at
budget; 4.0 = the budget will be gone in a quarter of the period).
``PlanService`` feeds it at completion, exports per-tenant
``serve.burn_rate`` gauges into the metrics snapshot (and so the
mesh/fleet fold), and journals a fsync-critical ``serve.burn_alert``
the moment a tenant crosses the alert threshold — edge-triggered with
hysteresis, so an overload window produces ONE durable alert record,
not one per completion.

Every projection here is O(1) per call: the arrival window keeps a
running cost sum (maintained against the deque's own evictions) and
the burn windows keep running violation counts — at 10⁴–10⁵ queued
requests a per-call window scan would quietly turn the admission hot
path superlinear (``scan_stats`` pins that in
``tests/test_torch_slo.py``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["SLO", "LoadTracker", "BurnRateMonitor"]


@dataclass(frozen=True)
class SLO:
    """One tenant's service-level objective.

    Parameters
    ----------
    deadline_s:
        Per-request completion budget, measured from admission
        (``None``: no deadline — the tenant is served best-effort).
    p99_budget_s:
        Advisory p99 latency budget.  Not enforced per request (a p99
        is a population property); it rides the tenant's
        ``serve.slo_violation`` accounting and the autoscale bench
        report so operators can tune capacity against it.
    shed_priority:
        Load-shedding order: under pressure the gate sheds lower
        priorities first, and tenants of the HIGHEST registered
        priority are never shed (see
        :class:`~pencilarrays_tpu_torch.serve.shed.PressureGate`).  Default 0
        — an SLO-less tenant is maximally sheddable.
    max_rel_l2:
        Accuracy floor for the precision-downgrade rung: the
        worst relative l2 error this tenant tolerates on a served
        result.  Under ``degrade`` pressure the service may swap a
        sheddable tenant's plan to a cheaper wire precision, but only
        onto rungs whose *calibrated* error envelope
        (``BENCH_WIRE.json``) fits under this bound — served degraded
        beats shed, but never silently out of tolerance.  ``None``
        (default): the tenant opted out; its requests are never
        downgraded (and so reach the shed rung first under pressure).
    """

    deadline_s: Optional[float] = None
    p99_budget_s: Optional[float] = None
    shed_priority: int = 0
    max_rel_l2: Optional[float] = None

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")
        if self.p99_budget_s is not None and self.p99_budget_s <= 0:
            raise ValueError(
                f"p99_budget_s must be positive, got {self.p99_budget_s}")
        if self.max_rel_l2 is not None and self.max_rel_l2 <= 0:
            raise ValueError(
                f"max_rel_l2 must be positive, got {self.max_rel_l2}")


class LoadTracker:
    """Arrival / cost / service history in the bytes-equivalent
    currency — THE load projection every overload decision reads.

    Thread-safe.  ``window`` bounds the completion history (service
    rate = total priced cost / total measured seconds over the
    window — a ratio of sums, so one tiny batch cannot dominate the
    estimate the way a mean-of-ratios would let it)."""

    def __init__(self, window: int = 64):
        self._lock = threading.Lock()
        self._completions: deque = deque(maxlen=max(1, int(window)))
        self._arrivals: deque = deque(maxlen=max(1, int(window)))
        self._queued_cost = 0       # admitted, not yet taken
        self._inflight_cost = 0     # taken, not yet completed
        self._queued_n = 0
        self._inflight_n = 0
        # running sum of the arrival window — arrival_cost_per_s is
        # read on the load-export path (every 50 ms under a fleet
        # router), so it must not re-scan the window per call
        self._arrival_cost_sum = 0
        self._arrivals_scanned = 0  # scan_stats: pins the O(1) claim
        # the rate is read on EVERY admission (hot path) but changes
        # only at completions: cache it per completion-window version
        self._version = 0
        self._rate_cache = (-1, None)

    # -- feeding (the queue's accounting hooks) ----------------------------
    def note_arrival(self, cost_bytes: int,
                     now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            # the deque evicts its oldest element when appended at
            # capacity: the running sum must shed that element first
            if len(self._arrivals) == self._arrivals.maxlen:
                self._arrival_cost_sum -= self._arrivals[0][1]
            self._arrivals.append((now, int(cost_bytes)))
            self._arrival_cost_sum += int(cost_bytes)
            self._queued_cost += int(cost_bytes)
            self._queued_n += 1

    def note_taken(self, cost_bytes: int) -> None:
        """An entry left the queue for dispatch (still counts toward
        drain until its batch completes)."""
        with self._lock:
            self._queued_cost = max(0, self._queued_cost - int(cost_bytes))
            self._queued_n = max(0, self._queued_n - 1)
            self._inflight_cost += int(cost_bytes)
            self._inflight_n += 1

    def note_removed(self, cost_bytes: int) -> None:
        """An entry left the queue WITHOUT dispatching (expired shed,
        pressure eviction): its cost stops weighing on the drain
        projection immediately."""
        with self._lock:
            self._queued_cost = max(0, self._queued_cost - int(cost_bytes))
            self._queued_n = max(0, self._queued_n - 1)

    def note_completed(self, cost_bytes: int, n: int,
                       execute_s: float) -> None:
        """One dispatched batch finished: ``cost_bytes`` priced cost,
        ``n`` requests, ``execute_s`` measured wall seconds.  Failed
        dispatches feed the window too — their time was just as real."""
        with self._lock:
            self._inflight_cost = max(
                0, self._inflight_cost - int(cost_bytes))
            self._inflight_n = max(0, self._inflight_n - int(n))
            if execute_s > 0:
                self._completions.append((int(cost_bytes),
                                          float(execute_s)))
                self._version += 1

    # -- the projection ----------------------------------------------------
    def rate_bytes_per_s(self) -> Optional[float]:
        """Measured service rate (priced cost per wall second) over the
        completion window; ``None`` until the first measurable
        completion — a never-measured service projects nothing."""
        with self._lock:
            ver, cached = self._rate_cache
            if ver == self._version:
                return cached
            if not self._completions:
                rate = None
            else:
                cost = sum(c for c, _ in self._completions)
                secs = sum(s for _, s in self._completions)
                rate = (cost / secs if secs > 0 and cost > 0 else None)
            self._rate_cache = (self._version, rate)
        return rate

    def projected_wait_s(self, ahead_cost_bytes: Optional[int] = None
                         ) -> Optional[float]:
        """Seconds a request admitted NOW would wait before its own
        dispatch completes: everything queued and in flight (or the
        explicit ``ahead_cost_bytes``) divided by the measured rate.
        ``None`` while the tracker is blind."""
        rate = self.rate_bytes_per_s()
        if rate is None:
            return None
        if ahead_cost_bytes is None:
            with self._lock:
                ahead_cost_bytes = self._queued_cost + self._inflight_cost
        return ahead_cost_bytes / rate

    def drain_s(self) -> Optional[float]:
        """Projected time to drain everything queued + in flight — the
        shedding gate's water-mark currency."""
        return self.projected_wait_s()

    def arrival_cost_per_s(self) -> Optional[float]:
        """Offered load over the arrival window (bytes-equivalent per
        second); ``None`` with fewer than two arrivals.  O(1): the
        window sum is maintained at arrival, never re-scanned — this
        is on the 50 ms load-export path a fleet router polls."""
        with self._lock:
            if len(self._arrivals) < 2:
                return None
            t0, _ = self._arrivals[0]
            t1, _ = self._arrivals[-1]
            cost = self._arrival_cost_sum
        if t1 <= t0:
            return None
        return cost / (t1 - t0)

    def scan_stats(self) -> dict:
        """Work counters for the scaling-pin tests
        (``tests/test_serve_depth.py``): ``arrivals_scanned`` counts
        arrival-window elements walked by the projection — the fixed
        running-sum path never walks any, so it stays 0 at any
        depth."""
        with self._lock:
            return {"arrivals_scanned": self._arrivals_scanned}

    def snapshot(self) -> dict:
        """The projection record journaled with every pressure
        transition and scale decision — the inputs, so ``pa-obs
        timeline`` can render WHY."""
        with self._lock:
            queued = self._queued_cost
            inflight = self._inflight_cost
            queued_n = self._queued_n
            inflight_n = self._inflight_n
        rate = self.rate_bytes_per_s()
        drain = (None if rate is None
                 else (queued + inflight) / rate)
        return {
            "queued_cost_bytes": queued,
            "inflight_cost_bytes": inflight,
            "queued_requests": queued_n,
            "inflight_requests": inflight_n,
            "rate_bytes_per_s": rate,
            "arrival_cost_per_s": self.arrival_cost_per_s(),
            "drain_s": drain,
        }

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._completions.clear()
            self._arrivals.clear()
            self._queued_cost = self._inflight_cost = 0
            self._queued_n = self._inflight_n = 0
            self._arrival_cost_sum = 0
            self._arrivals_scanned = 0
            self._version += 1
            self._rate_cache = (-1, None)


class BurnRateMonitor:
    """Per-tenant SLO error-budget burn rate over a sliding window.

    ``budget`` is the violation fraction a tenant's error budget
    allows (0.01 = 1% of completions may bust their deadline).  The
    observed violation fraction over the trailing ``window_s`` seconds,
    divided by the budget, is the **burn rate**: 1.0 = burning exactly
    at budget, ``threshold`` (default 4x) = alert.  Below
    ``min_events`` completions in the window the monitor reports
    ``None`` — a two-request sample must not page anyone.

    Alerts are edge-triggered with 2x hysteresis: :meth:`note` returns
    the alert payload exactly once when a tenant's rate crosses the
    threshold, and re-arms only after the rate falls below half of it
    — an overload window produces ONE durable ``serve.burn_alert``
    record, not one per completion.  Thread-safe; every operation is
    O(1) amortized (running counts, each window element evicted once).
    """

    def __init__(self, budget: float = 0.01, threshold: float = 4.0,
                 window_s: float = 30.0, min_events: int = 16):
        if budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        if threshold <= 0:
            raise ValueError(
                f"threshold must be positive, got {threshold}")
        self.budget = float(budget)
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.min_events = max(1, int(min_events))
        self._lock = threading.Lock()
        self._win: Dict[str, deque] = {}      # tenant -> (t, violated)
        self._n: Dict[str, int] = {}
        self._viol: Dict[str, int] = {}
        self._alerting: Dict[str, bool] = {}

    def _evict_locked(self, tenant: str, now: float) -> None:
        win = self._win[tenant]
        cutoff = now - self.window_s
        while win and win[0][0] < cutoff:
            _, violated = win.popleft()
            self._n[tenant] -= 1
            if violated:
                self._viol[tenant] -= 1

    def _rate_locked(self, tenant: str) -> Optional[float]:
        n = self._n.get(tenant, 0)
        if n < self.min_events:
            return None
        return (self._viol.get(tenant, 0) / n) / self.budget

    def note(self, tenant: str, violated: bool,
             now: Optional[float] = None) -> Optional[dict]:
        """Feed one completion.  Returns the ``serve.burn_alert``
        payload exactly once per threshold crossing, else ``None``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            win = self._win.setdefault(tenant, deque())
            win.append((now, bool(violated)))
            self._n[tenant] = self._n.get(tenant, 0) + 1
            if violated:
                self._viol[tenant] = self._viol.get(tenant, 0) + 1
            self._evict_locked(tenant, now)
            rate = self._rate_locked(tenant)
            if rate is None:
                return None
            if not self._alerting.get(tenant, False) \
                    and rate >= self.threshold:
                self._alerting[tenant] = True
                return {"tenant": tenant, "burn_rate": rate,
                        "threshold": self.threshold,
                        "window_s": self.window_s}
            if self._alerting.get(tenant, False) \
                    and rate < 0.5 * self.threshold:
                self._alerting[tenant] = False
        return None

    def burn_rate(self, tenant: str,
                  now: Optional[float] = None) -> Optional[float]:
        """The tenant's current burn rate (``None``: unknown tenant or
        too few completions in the window)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if tenant not in self._win:
                return None
            self._evict_locked(tenant, now)
            return self._rate_locked(tenant)

    def snapshot(self, now: Optional[float] = None
                 ) -> Dict[str, Optional[float]]:
        """Every tracked tenant's burn rate — what the service folds
        into its stats and the per-tenant gauges ride."""
        now = time.monotonic() if now is None else now
        with self._lock:
            out = {}
            for t in list(self._win):
                self._evict_locked(t, now)
                out[t] = self._rate_locked(t)
            return out

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._win.clear()
            self._n.clear()
            self._viol.clear()
            self._alerting.clear()
