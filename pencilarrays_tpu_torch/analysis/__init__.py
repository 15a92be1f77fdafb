"""Static analysis: SPMD schedule verification + repo invariant linting
(the JAX package's ``analysis/``, ported).

Two pillars, one CLI (``python -m pencilarrays_tpu_torch.analysis``, the
port's ``pa-lint``):

* :mod:`~pencilarrays_tpu_torch.analysis.spmd` — record a typed
  :class:`~pencilarrays_tpu_torch.analysis.spmd.CollectiveTrace` of a
  program as it runs (a plan's chain, a resident ``CompiledPlan``, a
  routed reshard, one transpose hop) and *prove* static properties
  about it: the trace matches the ``collective_costs`` prediction
  op-for-op, sibling configurations issue consistent schedules, peak
  device memory stays in bound, donation released the operand.  The
  analyzer behind ``PlanService.certify()``'s pre-flight registry sweep
  and the engine's dispatch-log proof.
* :mod:`~pencilarrays_tpu_torch.analysis.lint` — AST-based cross-file
  invariant checks over the port's tree (journal-event registration,
  env-knob documentation, plan-cache registration, fault-point docs,
  lock-guarded daemon state, ...), gated on the committed, commented
  allowlist ``pa-lint-torch.allow``.

See ``docs/StaticAnalysis.md``.
"""

from .errors import (
    AnalysisError,
    DispatchOrderError,
    DonationError,
    HbmBoundError,
    ScheduleMismatchError,
    TraceDivergenceError,
)
from .spmd import (
    CollectiveOp,
    CollectiveTrace,
    EXCHANGE_KINDS,
    certify_plan,
    predicted_peak_hbm,
    step_hop_peak,
    trace_compiled_plan,
    trace_fn,
    trace_plan,
    trace_route,
    trace_transpose,
    verify_consistent,
    verify_dispatch_log,
    verify_donation,
    verify_hbm,
    verify_plan,
    verify_route,
)

__all__ = [
    "AnalysisError",
    "ScheduleMismatchError",
    "TraceDivergenceError",
    "HbmBoundError",
    "DonationError",
    "DispatchOrderError",
    "CollectiveOp",
    "CollectiveTrace",
    "EXCHANGE_KINDS",
    "trace_fn",
    "trace_transpose",
    "trace_plan",
    "trace_compiled_plan",
    "trace_route",
    "verify_plan",
    "verify_route",
    "verify_consistent",
    "verify_hbm",
    "verify_donation",
    "verify_dispatch_log",
    "certify_plan",
    "predicted_peak_hbm",
    "step_hop_peak",
]
