"""Typed failure taxonomy of the runtime integrity guard (the JAX
package's ``guard/errors.py``, the same classes and attributes).

Every failure the guard can surface derives from :class:`GuardError`,
so a drill asserts "typed guard error, never garbage" with one
``except`` clause.
"""

from __future__ import annotations

__all__ = ["GuardError", "IntegrityError", "WirePrecisionError",
           "HangTimeoutError"]


class GuardError(Exception):
    """Base of every error raised by ``pencilarrays_tpu_torch.guard``."""


class IntegrityError(GuardError):
    """An exchange invariant probe mismatched: the data that came out of
    a pure-data-movement hop (transpose, reshard route, restore) does
    not carry the content that went in — silent data corruption caught
    in flight.  ``hop`` names the instrumented operation, ``predicted``
    / ``observed`` carry the probe values that disagreed, ``kind`` is
    ``"sum"`` (content-sum mismatch) or ``"nonfinite"`` (NaN/Inf born
    inside the guarded section), ``bundle`` is the crash-bundle
    directory written for the post-mortem (None when bundle writing
    itself failed)."""

    def __init__(self, message: str, *, hop=None, predicted=None,
                 observed=None, kind: str = "sum", bundle=None):
        super().__init__(message)
        self.hop = hop
        self.predicted = predicted
        self.observed = observed
        self.kind = kind
        self.bundle = bundle


class WirePrecisionError(IntegrityError):
    """A reduced-precision (``wire_dtype``) hop's restored payload
    drifted from its source beyond the wire format's modeled
    quantization tolerance (``parallel/wire.py`` ``wire_rtol``; scaled
    by the number of packed exchanges crossed, override
    ``PENCILARRAYS_TPU_GUARD_WIRE_RTOL``).  Either the tolerance model
    is wrong for this workload (raise the knob, or use full precision)
    or the wire corrupted data — both are typed failures, never a
    silent wrong answer.  Subclasses :class:`IntegrityError`, so every
    existing chaos-drill ``except`` clause still catches it;
    ``wire_dtype`` carries the offending format."""

    def __init__(self, message: str, *, wire_dtype=None, **kw):
        super().__init__(message, **kw)
        self.wire_dtype = wire_dtype


class HangTimeoutError(GuardError, TimeoutError):
    """A watchdog-armed section (collective dispatch, barrier,
    ``distributed.initialize``) outlived its deadline.  The monitor
    thread wrote the crash bundle (``bundle``) *while the section was
    still stuck*, so the post-mortem exists even if the process never
    returns; the typed error surfaces once (if) the blocked call
    unwinds.  Subclasses ``TimeoutError``, so
    :func:`~pencilarrays_tpu_torch.resilience.retry.is_transient` retries it
    — a hung coordinator connection is backed off against, bounded by
    the retry deadline."""

    def __init__(self, message: str, *, label=None, timeout_s=None,
                 bundle=None):
        super().__init__(message)
        self.label = label
        self.timeout_s = timeout_s
        self.bundle = bundle
