"""Typed errors of the plan-service layer (a copy of the JAX package's
``serve/errors.py``).

The serve contract mirrors the guard's: failures surface as *typed*
errors scoped to the narrowest unit they poison — an admission decision
rejects ONE tenant's request, a detected corruption fails ONE batch's
tickets — never as a torn service or an unattributed exception on some
other tenant's future.
"""

from __future__ import annotations

__all__ = ["ServeError", "AdmissionError", "DeadlineError",
           "StaleRequestError", "ServiceClosedError"]


class ServeError(RuntimeError):
    """Base class of every serve-layer error."""


class AdmissionError(ServeError):
    """A tenant's request was rejected at admission (quota exceeded).

    Carries ``tenant`` and ``reason`` (``"queue-depth"``,
    ``"inflight-bytes"``, ``"hbm-limit"`` — a whale reshard for
    which even the chunk-synthesized route planner found no admissible
    route under the service's per-chip peak-HBM bound — or ``"shed"``:
    the overload gate sacrificed this sheddable-priority request, at
    submit or by evicting it from the queue, see
    :mod:`~pencilarrays_tpu_torch.serve.shed`) so a client can
    distinguish back-off from a bug.  Admission rejections never enter
    the queue: they cost the service one counter bump and the caller
    one typed exception.  The one exception is ``reason="shed"`` on an
    *evicted* request, which WAS queued — its ticket fails typed with
    this error instead of ever dispatching.
    """

    def __init__(self, msg: str, *, tenant: str, reason: str):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason


class DeadlineError(ServeError):
    """A request cannot (or could not) meet its tenant's SLO deadline
    (:class:`~pencilarrays_tpu_torch.serve.slo.SLO`).

    ``reason`` says which enforcement point fired:

    * ``"projected"`` — at admission: the queue's own load projection
      (measured service rate over the priced cost queued ahead) says
      the request would complete after its deadline, so it is rejected
      up front — never a silent late answer;
    * ``"expired"`` — at take: the request's deadline passed while it
      sat in the queue; it is shed before dispatch (its ticket fails
      with this error) instead of burning mesh time on an answer
      nobody can use.

    Carries ``tenant``, ``reason``, ``deadline_s`` (the tenant's
    budget) and ``projected_s`` (the projection that condemned it;
    ``None`` on the expired path)."""

    def __init__(self, msg: str, *, tenant: str, reason: str,
                 deadline_s: float, projected_s=None):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason
        self.deadline_s = deadline_s
        self.projected_s = projected_s


class StaleRequestError(ServeError):
    """A queued request's device payload is bound to a mesh that no
    longer backs its plan — e.g. the plan was rebuilt by an elastic
    reformation while the request sat in the queue.  Host-array
    payloads submitted against a *named* plan re-bind and survive
    (see :meth:`~pencilarrays_tpu_torch.serve.PlanService.register_plan`);
    device arrays cannot, and fail typed instead of dispatching onto
    dead devices."""


class ServiceClosedError(ServeError):
    """Submit after :meth:`~pencilarrays_tpu_torch.serve.PlanService.close`."""
