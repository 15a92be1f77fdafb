"""Static checks of schedules (the JAX package's ``analysis/``): so far the
typed errors and the peak-memory accounting of one plan step."""

from .errors import AnalysisError, HbmBoundError  # noqa: F401
from .spmd import step_hop_peak  # noqa: F401
