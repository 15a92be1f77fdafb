"""Typed failure taxonomy of the resilience subsystem (a copy of the JAX
package's ``resilience/errors.py``).

Every failure the checkpoint/restore and fault-injection machinery can
surface derives from :class:`ResilienceError`, so callers (and the
truncation fuzz test) can assert "typed resilience error, never garbage
data" with a single ``except`` clause.  The I/O-shaped members also
derive from the matching builtin (``OSError``/``ValueError``) so
pre-existing handlers keep working.
"""

from __future__ import annotations

__all__ = [
    "ResilienceError",
    "CorruptCheckpointError",
    "CorruptSidecarError",
    "CheckpointNotFoundError",
    "InjectedFault",
    "RetryDeadlineExceeded",
]


class ResilienceError(Exception):
    """Base of every error raised by ``pencilarrays_tpu_torch.resilience``."""


class CorruptCheckpointError(ResilienceError):
    """A checkpoint failed validation: missing COMMIT marker, unreadable
    manifest, or a dataset block whose bytes do not match the manifest
    checksum.  ``step``/``dataset``/``block`` pinpoint the failure."""

    def __init__(self, message: str, *, step=None, dataset=None, block=None,
                 path=None):
        super().__init__(message)
        self.step = step
        self.dataset = dataset
        self.block = block
        self.path = path


class CorruptSidecarError(ResilienceError, ValueError):
    """A driver's sidecar metadata (e.g. the binary driver's ``.json``)
    is truncated or corrupt — the data file is unreadable without it."""

    def __init__(self, message: str, *, path=None):
        super().__init__(message)
        self.path = path


class CheckpointNotFoundError(ResilienceError, FileNotFoundError):
    """No committed checkpoint exists at the requested step (or at all)."""


class InjectedFault(ResilienceError, OSError):
    """The deterministic error raised by a ``faults`` rule in ``error``
    mode — an ``OSError`` (errno EIO) so it walks the same transient-I/O
    retry paths a real filesystem error would."""

    def __init__(self, message: str, *, point=None, hit=None):
        import errno

        super().__init__(errno.EIO, message)
        self.point = point
        self.hit = hit


class RetryDeadlineExceeded(ResilienceError, TimeoutError):
    """A retried operation did not succeed within the policy deadline
    (or exhausted its attempts); ``__cause__`` is the last error."""
