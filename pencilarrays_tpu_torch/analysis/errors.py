"""Typed errors of the static checks (the JAX package's
``analysis/errors.py``, the parts the port raises)."""


class AnalysisError(Exception):
    """Base of every static-analysis failure."""


class HbmBoundError(AnalysisError):
    """A schedule's predicted per-rank peak device memory exceeds the
    caller's ``hbm_limit``.  ``hop`` names the offending exchange."""

    def __init__(self, source: str, hop: str, peak_bytes: int,
                 limit_bytes: int):
        self.source = source
        self.hop = hop
        self.peak_bytes = int(peak_bytes)
        self.limit_bytes = int(limit_bytes)
        super().__init__(
            f"{source}: hop {hop} needs {peak_bytes} peak HBM bytes "
            f"per chip, over the {limit_bytes}-byte limit")
