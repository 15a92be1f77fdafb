"""Static checks of schedules (the JAX package's ``analysis/``): the typed
errors, the peak-memory accounting of one plan step, and the proof that
an engine's dispatch log respects its enqueue order."""

from .errors import (  # noqa: F401
    AnalysisError,
    DispatchOrderError,
    DonationError,
    HbmBoundError,
    ScheduleMismatchError,
    TraceDivergenceError,
)
from .spmd import step_hop_peak, verify_dispatch_log  # noqa: F401
