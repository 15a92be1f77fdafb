"""serve/ — the multi-tenant plan service (the JAX package's ``serve/``,
ported: the same admission, coalescing, SLO, shedding, precision and
autoscaling decisions over the port's plans, engine and K1).

The transpose engine, the batched plan layer, the guard's recovery
ladder and the obs plane all exist to be *used* — this package is the
layer that serves them: concurrent FFT/reshard requests from multiple
logical tenants, executed on one resident mesh.

* :class:`PlanService` — submit/coalesce/dispatch loop with per-tenant
  quotas and typed isolation (``docs/Serving.md``);
* :class:`PlanRegistry` — fingerprint-keyed resident executables
  (keys are :meth:`~pencilarrays_tpu_torch.ops.fft.PencilFFTPlan.plan_key`,
  deterministic across processes and restarts);
* :class:`AdmissionQueue` / :class:`TenantQuota` / :class:`Ticket` —
  the scheduling core and the client-side future;
* the overload-survival plane: :class:`SLO` (per-tenant deadlines +
  shed priorities + the ``max_rel_l2`` accuracy budget, enforced
  at admission/take/completion), :class:`PressurePolicy` + the
  hysteretic load-shedding gate (``serve/shed.py``) with its
  precision-downgrade rung (``serve/precision.py``: sheddable traffic
  served on a cheaper wire — full -> bf16 -> fp8 — inside each
  tenant's calibrated error envelope, instead of shed), and the
  :class:`Autoscaler` closing the serve↔elastic loop (grow/shrink the
  mesh from the queue's own load projection — ``serve/autoscale.py``);
* typed errors: :class:`ServeError`, :class:`AdmissionError`,
  :class:`DeadlineError`, :class:`StaleRequestError`,
  :class:`ServiceClosedError`.

Everything here is plain Python over the public plan APIs: importing
the package is cheap (torch work starts only when a request dispatches),
and a process that never serves pays nothing.
"""

from .autoscale import Autoscaler, AutoscalePolicy, ScaleDecision  # noqa: F401
from .errors import (  # noqa: F401
    AdmissionError,
    DeadlineError,
    ServeError,
    ServiceClosedError,
    StaleRequestError,
)
from .precision import (  # noqa: F401
    PRECISION_LADDER,
    select_rung,
    wire_error_envelope,
)
from .queue import AdmissionQueue, Batch, TenantQuota, Ticket  # noqa: F401
from .registry import PlanRegistry  # noqa: F401
from .service import PlanService  # noqa: F401
from .shed import PressureGate, PressurePolicy  # noqa: F401
from .slo import SLO, LoadTracker  # noqa: F401

__all__ = [
    "PlanService",
    "PlanRegistry",
    "AdmissionQueue",
    "TenantQuota",
    "Ticket",
    "Batch",
    "SLO",
    "LoadTracker",
    "PressurePolicy",
    "PressureGate",
    "PRECISION_LADDER",
    "select_rung",
    "wire_error_envelope",
    "Autoscaler",
    "AutoscalePolicy",
    "ScaleDecision",
    "ServeError",
    "AdmissionError",
    "DeadlineError",
    "StaleRequestError",
    "ServiceClosedError",
]
