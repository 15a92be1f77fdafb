"""The serve↔elastic autoscaler — demand in, capacity out (the JAX
package's ``serve/autoscale.py``, ported).

Everything this module composes already exists: the admission queue
meters load (:class:`~pencilarrays_tpu_torch.serve.slo.LoadTracker` — the
ONE projection the shedding gate reads too), the elastic layer can
shrink (``announce_leave`` → reform) and grow (``request_join`` →
reform admits the joiner), and a joiner can warm its plans before it
joins.  Without a controller an overload storm just grows the queue
until quota rejections.  The :class:`Autoscaler` is that connection:

* :meth:`Autoscaler.tick` is called by the application at **step /
  reformation boundaries only** (never mid-dispatch: mesh membership
  may only change where the elastic layer already changes it);
* a window is classified against the projection: **overload** when the
  projected queue drain time exceeds ``overload_drain_s``, **idle**
  when nothing is queued or in flight, **normal** otherwise;
* decisions require ``windows`` CONSECUTIVE classifications (a single
  spike never scales) and are rate-limited by ``cooldown_s`` (scaling
  is expensive — a reformation — and an oscillating controller is
  worse than none: no flapping, by construction);
* **sustained overload** → scale **up**: if a pre-warmed joiner is
  waiting (``request_join`` published under the base namespace), run a
  reformation with ``reason="scale-up"`` — the join-admission path the
  elastic layer already drills; with no joiner waiting the decision is
  still journaled (``acted=false``) as the demand signal an operator
  (or a joiner-spawning supervisor) acts on;
* **sustained idle** → scale **down**: the highest-rank member — the
  one whose departure keeps surviving ranks dense — calls
  ``announce_leave()``; the NEXT step boundary publishes the planned
  departure, survivors reform smaller, the leaver exits clean.  Every
  rank runs the same controller over the same projection inputs and
  journals the same decision; only the designated leaver acts;
* every decision journals fsync-critical ``serve.scale{direction,
  reason, projection}`` WITH the projection inputs, so ``pa-obs
  timeline`` can render *why* capacity moved.

Pre-warmed joining (:func:`join_prewarmed`): a replacement rank builds
its registered plans and runs each compiled executable once BEFORE
publishing its join request — the K1 library (built once per checkout
into ``ops/_build/``), cuFFT's plans and, on the card, the CUDA graphs
are then ready when the reformation admits it.  Warm-up is measured and
journaled.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

__all__ = ["AutoscalePolicy", "ScaleDecision", "Autoscaler",
           "prewarm_plans", "join_prewarmed"]


@dataclass(frozen=True)
class AutoscalePolicy:
    """The controller's knobs.

    ``overload_drain_s``: projected drain above this classifies the
    window as overloaded.  ``windows``: consecutive windows required
    before a decision (no single-spike scaling).  ``cooldown_s``:
    minimum spacing between decisions.  ``min_world``/``max_world``:
    capacity bounds (``max_world=None``: unbounded growth requests)."""

    overload_drain_s: float = 1.0
    windows: int = 3
    cooldown_s: float = 30.0
    min_world: int = 1
    max_world: Optional[int] = None

    def __post_init__(self):
        if self.overload_drain_s <= 0:
            raise ValueError("overload_drain_s must be positive")
        if self.windows < 1:
            raise ValueError("windows must be >= 1")
        if self.min_world < 1:
            raise ValueError("min_world must be >= 1")


@dataclass
class ScaleDecision:
    """One tick's verdict.  ``direction`` ``"hold"`` means no decision
    fired (insufficient windows, cooldown, or nothing to do);
    ``acted`` says whether capacity actually moved from THIS process
    (an ``up`` with no joiner waiting, or a ``down`` on a non-leaver
    rank, journals but does not act)."""

    direction: str                  # "up" | "down" | "hold"
    reason: str
    projection: dict = field(default_factory=dict)
    acted: bool = False
    detail: Optional[str] = None
    gen: Optional[int] = None       # reformation generation, when acted


class Autoscaler:
    """The boundary-driven controller (module docstring).

    Parameters
    ----------
    service:
        The :class:`~pencilarrays_tpu_torch.serve.PlanService` whose load
        projection drives decisions.
    coordinator:
        Explicit cluster coordinator (default: the process-global one
        at each tick — so a reformation's fresh coordinator is picked
        up without re-plumbing).
    policy:
        :class:`AutoscalePolicy` (default: defaults above).
    ckpt_mgr / restore:
        Passed through to the scale-up reformation so the join
        admission restores the agreed checkpoint across the grown
        decomposition, exactly like a failure reformation.
    """

    def __init__(self, service, *, coordinator=None,
                 policy: Optional[AutoscalePolicy] = None,
                 ckpt_mgr=None, restore: Optional[Callable] = None):
        self.service = service
        # a controller needs the projection FED: an SLO-less service
        # skips pricing entirely, which would leave this autoscaler
        # permanently blind to overload (down-only scaling)
        service.ensure_priced()
        self.policy = policy or AutoscalePolicy()
        self._coordinator = coordinator
        self.ckpt_mgr = ckpt_mgr
        self.restore = restore
        self._over = 0
        self._idle = 0
        self._last_decision = -float("inf")
        self._decisions = 0

    def coordinator(self):
        if self._coordinator is not None:
            return self._coordinator
        from .. import cluster

        return cluster.coordinator()

    @property
    def decisions(self) -> int:
        return self._decisions

    # -- the controller ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> ScaleDecision:
        """Feed one boundary window; returns the decision (and acts on
        it).  Call ONLY at step/reformation boundaries — an acted
        ``up`` runs a reformation right here."""
        now = time.monotonic() if now is None else now
        p = self.policy
        proj = self.service.load_projection()
        drain = proj.get("drain_s")
        overloaded = drain is not None and drain > p.overload_drain_s
        idle = (not overloaded and proj.get("queue_depth", 0) == 0
                and proj.get("inflight_requests", 0) == 0)
        if overloaded:
            self._over += 1
            self._idle = 0
        elif idle:
            self._idle += 1
            self._over = 0
        else:
            self._over = self._idle = 0
        if now - self._last_decision < p.cooldown_s:
            return ScaleDecision("hold", "cooldown", proj)
        if self._over >= p.windows:
            return self._decide(self._scale_up(proj), now)
        if self._idle >= p.windows:
            return self._decide(self._scale_down(proj), now)
        return ScaleDecision("hold", "window", proj)

    def _decide(self, d: ScaleDecision, now: float) -> ScaleDecision:
        # K consecutive windows CONSUMED by a decision (acted or not):
        # the streak restarts, so an unactionable overload journals
        # once per cooldown instead of once per tick
        self._over = self._idle = 0
        self._last_decision = now
        self._decisions += 1
        self._journal(d)
        return d

    def _scale_up(self, proj: dict) -> ScaleDecision:
        from ..cluster import elastic

        coord = self.coordinator()
        if coord is None or not elastic.enabled():
            return ScaleDecision(
                "up", "overload", proj, acted=False,
                detail="no-coordinator" if coord is None else
                "elastic-off")
        p = self.policy
        if p.max_world is not None and coord.world >= p.max_world:
            return ScaleDecision("up", "overload", proj, acted=False,
                                 detail="at-max-world")
        pending = self.pending_joiners(coord)
        if not pending:
            # the demand signal: journaled for the operator / the
            # joiner-spawning supervisor — nothing to admit yet
            return ScaleDecision("up", "overload", proj, acted=False,
                                 detail="no-joiner")
        r = elastic.reform(coord, reason="scale-up",
                           ckpt_mgr=self.ckpt_mgr, restore=self.restore)
        if self._coordinator is not None:
            self._coordinator = r.coordinator
        return ScaleDecision("up", "overload", proj, acted=True,
                             detail=f"admitted={pending}",
                             gen=r.membership.gen)

    def _scale_down(self, proj: dict) -> ScaleDecision:
        coord = self.coordinator()
        if coord is None:
            return ScaleDecision("down", "idle", proj, acted=False,
                                 detail="no-coordinator")
        floor = max(self.policy.min_world, 1)
        if coord.world <= floor:
            return ScaleDecision("down", "idle", proj, acted=False,
                                 detail="at-min-world")
        # the designated leaver: the HIGHEST rank — its departure keeps
        # the survivors' dense reindex an identity map.  Every rank
        # computes the same decision from the same projection; only the
        # leaver flags itself (announce_leave publishes the planned
        # departure at ITS next step boundary)
        if coord.rank != coord.world - 1:
            return ScaleDecision("down", "idle", proj, acted=False,
                                 detail="not-leaver")
        coord.announce_leave()
        return ScaleDecision("down", "idle", proj, acted=True,
                             detail=f"leaving-rank={coord.rank}")

    def pending_joiners(self, coord=None) -> list:
        """Join slots waiting under the base namespace (the
        ``request_join`` queue the next reformation admits — parsed by
        the elastic layer's ONE key parser)."""
        from ..cluster.elastic import pending_join_slots

        coord = coord if coord is not None else self.coordinator()
        if coord is None:
            return []
        try:
            return pending_join_slots(coord.kv, coord.ns)
        except Exception:
            return []

    @staticmethod
    def _journal(d: ScaleDecision) -> None:
        from .. import obs

        if not obs.enabled():
            return
        obs.counter("serve.scale_decisions", direction=d.direction,
                    acted=str(bool(d.acted)).lower()).inc()
        obs.record_event(
            "serve.scale", direction=d.direction, reason=d.reason,
            projection=d.projection, acted=d.acted,
            **({"detail": d.detail} if d.detail else {}),
            **({"gen": d.gen} if d.gen is not None else {}))

    def _reset_for_tests(self) -> None:
        self._over = self._idle = 0
        self._last_decision = -float("inf")
        self._decisions = 0


# ---------------------------------------------------------------------------
# pre-warmed joining
# ---------------------------------------------------------------------------

def prewarm_plans(factories: Dict[str, Callable],
                  extra_dims: tuple = ()) -> dict:
    """Build every factory's plan and run its compiled executable once
    (a forward of zeros and its backward: the K1 library, cuFFT's plans
    and, on the card, the CUDA graphs), so a joiner arrives warm.
    Returns the measured warm-up report (also journaled as
    ``serve.scale{reason="prewarm"}`` — capacity preparation is a
    scaling event); ``compile_cache`` reports
    ``PENCILARRAYS_TPU_COMPILE_CACHE`` as the JAX package's does."""
    import os

    from .. import obs

    t0 = time.perf_counter()
    per_plan = {}
    for name, factory in factories.items():
        t1 = time.perf_counter()
        plan = factory(None)
        cp = plan.compile(extra_dims)
        cp.backward(cp.forward(plan.allocate_input(extra_dims)))
        per_plan[name] = time.perf_counter() - t1
    report = {
        "plans": len(factories),
        "warm_s": time.perf_counter() - t0,
        "per_plan_s": per_plan,
        "compile_cache": os.environ.get(
            "PENCILARRAYS_TPU_COMPILE_CACHE") or None,
    }
    if obs.enabled():
        obs.record_event("serve.scale", direction="up", reason="prewarm",
                         projection=report, acted=False)
    return report


def join_prewarmed(kv, slot: str, *,
                   factories: Optional[Dict[str, Callable]] = None,
                   namespace: str = "pa",
                   timeout: Optional[float] = None):
    """The joiner-side flow: pre-warm the registered plans, publish the
    join request, block until a reformation admits this slot, and
    re-register the factories with the elastic layer so every LATER
    reformation rebuilds them too.  Returns ``(Reformation, warm
    report)`` — the reformation's coordinator is live and installed,
    ready for ``elastic_step``/``PlanService`` traffic."""
    from ..cluster import elastic

    warm = prewarm_plans(factories) if factories else None
    r = elastic.request_join(kv, slot, namespace=namespace,
                             timeout=timeout)
    if factories:
        for name, factory in factories.items():
            elastic.register_plan(name, factory)
    return r, warm
