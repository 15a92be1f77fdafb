"""Load shedding + backpressure — the overload gate (a copy of the JAX
package's ``serve/shed.py``: pure Python).

When offered load exceeds service capacity, SOMETHING gives.  Without
this module it was the admission queue (growing until per-tenant quota
rejections hit arbitrary tenants) and every tenant's latency (the queue
drains in cost order, so the storm's own traffic starves everyone).
The pressure gate makes the sacrifice explicit, ordered, and journaled:

* the gate watches the ONE load projection
  (:class:`~pencilarrays_tpu_torch.serve.slo.LoadTracker`): the projected
  **queue drain time** in the router's bytes-equivalent currency;
* one rung BEFORE shedding (``degrade_water_s``, opt-in): the
  gate enters ``degrade`` — sheddable-tier requests from tenants that
  declared an accuracy budget (:class:`~pencilarrays_tpu_torch.serve.slo.
  SLO.max_rel_l2`) are still served, on a cheaper wire precision
  (full -> bf16 -> fp8) within that budget; served degraded beats
  shed, and tenants without a budget fall through untouched;
* when drain crosses ``high_water_s`` the gate enters ``shed``:
  requests from tenants below the protected priority tier (the highest
  ``shed_priority`` among registered SLOs) are rejected typed at
  submit (:class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError`,
  ``reason="shed"``) — the cheapest possible rejection, one counter
  bump and a typed exception, nothing queued;
* one rung further (``evict_water_s``, default ``2 x high_water_s``)
  the gate enters ``evict``: already-queued sheddable entries are
  evicted — failed typed with the same ``reason="shed"`` — in
  admission-sequence order (deterministic: identical submission
  sequences evict identical sets, wall clocks only gate *when* the
  rung fires);
* recovery is **hysteretic**: the gate returns to ``ok`` only when
  drain falls below ``low_water_s`` — a storm hovering at the high
  water mark must not flap the gate open/shut per request;
* every state transition journals ``serve.pressure`` (fsync-critical —
  a shedding decision gates client-visible failures) with the full
  projection snapshot, so ``pa-obs timeline`` renders why.

The gate only arms when at least one registered SLO declares a
non-default ``shed_priority`` tier *below* another — with no SLOs (or
one uniform tier) nothing is sheddable and the service keeps its
ungated behavior bit-for-bit.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

__all__ = ["PressurePolicy", "PressureGate"]


@dataclass(frozen=True)
class PressurePolicy:
    """The gate's water marks (seconds of projected queue drain).

    ``low_water_s < high_water_s <= evict_water_s`` is enforced;
    ``evict_water_s=None`` defaults to ``2 x high_water_s``.
    ``degrade_water_s`` (optional) arms the precision-downgrade
    rung strictly between the hysteresis band's low mark and the shed
    mark: ``low_water_s < degrade_water_s < high_water_s``.  ``None``
    (default) keeps the three-state machine bit-for-bit."""

    high_water_s: float = 1.0
    low_water_s: float = 0.5
    evict_water_s: Optional[float] = None
    degrade_water_s: Optional[float] = None

    def __post_init__(self):
        if self.high_water_s <= 0:
            raise ValueError(
                f"high_water_s must be positive, got {self.high_water_s}")
        if not (0 <= self.low_water_s < self.high_water_s):
            raise ValueError(
                f"hysteresis needs 0 <= low_water_s < high_water_s, got "
                f"low={self.low_water_s} high={self.high_water_s}")
        evict = self.evict_water_s
        if evict is not None and evict < self.high_water_s:
            raise ValueError(
                f"evict_water_s ({evict}) below high_water_s "
                f"({self.high_water_s}): the evict rung is an escalation")
        deg = self.degrade_water_s
        if deg is not None and not (
                self.low_water_s < deg < self.high_water_s):
            raise ValueError(
                f"degrade_water_s ({deg}) must sit strictly inside the "
                f"hysteresis band (low_water_s={self.low_water_s}, "
                f"high_water_s={self.high_water_s}): the downgrade rung "
                f"fires BEFORE shedding and recovers with it")

    @property
    def evict_at(self) -> float:
        return (self.evict_water_s if self.evict_water_s is not None
                else 2.0 * self.high_water_s)


class PressureGate:
    """The hysteretic overload state machine (module docstring).

    States: ``ok`` -> ``degrade`` (serve sheddable on a cheaper wire
    precision, when armed) -> ``shed`` (reject sheddable at submit) ->
    ``evict`` (also evict queued sheddable); back to ``ok`` only below
    the low water mark.  Thread-safe; :meth:`update` is called with a
    fresh drain projection on every admission and every take."""

    STATES = ("ok", "degrade", "shed", "evict")

    def __init__(self, policy: Optional[PressurePolicy] = None):
        self.policy = policy or PressurePolicy()
        self._lock = threading.Lock()
        self._state = "ok"
        self._transitions = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def transitions(self) -> int:
        """How many state changes the gate has made (the no-flap
        drill's assertion: storm -> recover is exactly two)."""
        with self._lock:
            return self._transitions

    def update(self, drain_s: Optional[float],
               projection=None) -> str:
        """Feed one drain projection; returns the (possibly new) state
        and journals the transition when it changed.  ``None`` (a blind
        tracker) never changes state: no measurement, no verdict.
        ``projection`` may be a dict OR a zero-arg callable producing
        one — called only when a transition actually journals, so the
        per-admission hot path never builds the full snapshot."""
        if drain_s is None:
            return self.state
        p = self.policy
        with self._lock:
            prev = self._state
            if drain_s >= p.evict_at:
                nxt = "evict"
            elif drain_s >= p.high_water_s:
                # escalation is immediate; de-escalation from evict to
                # shed happens here too (the evict rung fired, queued
                # sheddable work is gone, drain fell between the marks)
                nxt = "shed"
            elif (p.degrade_water_s is not None
                  and drain_s >= p.degrade_water_s):
                # the downgrade rung: an open gate escalates to
                # "degrade"; a gate already shedding HOLDS (shed
                # recovers through the full hysteresis at low water,
                # not at the degrade mark — no shed/degrade flap) and
                # evict de-escalates one rung (drain provably < high)
                nxt = ("degrade" if prev == "ok"
                       else "shed" if prev == "evict" else prev)
            elif drain_s <= p.low_water_s:
                # at-or-below low water recovers: a fully-drained queue
                # projects EXACTLY 0.0, which must reopen a gate even
                # when low_water_s is 0 (legal per the policy check)
                nxt = "ok"
            else:
                # the hysteresis band (below high water, at/above low):
                # hold the current state — an "ok" gate stays open
                # until HIGH water, a shedding gate stays shut until
                # LOW water, and an "evict" gate de-escalates to shed
                # (its drain is provably below high, hence below evict)
                nxt = "shed" if prev == "evict" else prev
            changed = nxt != prev
            if changed:
                self._state = nxt
                self._transitions += 1
        if changed:
            self._journal(prev, nxt, drain_s, projection)
        return nxt

    @staticmethod
    def _journal(prev: str, state: str, drain_s: float,
                 projection) -> None:
        from .. import obs

        if not obs.enabled():
            return
        if callable(projection):
            projection = projection()
        obs.counter("serve.pressure_transitions", state=state).inc()
        obs.record_event("serve.pressure", state=state, prev=prev,
                         drain_s=drain_s,
                         **({"projection": projection}
                            if projection else {}))

    def sheds(self, shed_priority: int, protected_priority: int) -> bool:
        """Would the gate reject a request of ``shed_priority`` right
        now?  Sheddable = strictly below the protected tier (the
        highest registered priority — with one uniform tier nothing is
        ever shed).  The ``degrade`` state does NOT shed: its whole
        point is serving sheddable traffic (cheaper) instead."""
        if shed_priority >= protected_priority:
            return False
        return self.state in ("shed", "evict")

    def degrades(self, shed_priority: int,
                 protected_priority: int) -> bool:
        """Would the gate downgrade a request of ``shed_priority`` to a
        cheaper wire precision right now?  Same sheddability rule as
        :meth:`sheds`; true in EVERY pressure state — under ``shed`` /
        ``evict`` the downgrade rung is what keeps a budget-declaring
        tenant (:class:`~pencilarrays_tpu_torch.serve.slo.SLO.max_rel_l2`)
        served where a budget-less one is rejected."""
        if shed_priority >= protected_priority:
            return False
        return self.state != "ok"

    def evicting(self) -> bool:
        return self.state == "evict"

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._state = "ok"
            self._transitions = 0
