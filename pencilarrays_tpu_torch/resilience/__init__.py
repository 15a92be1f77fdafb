"""Resilience subsystem: crash-safe checkpoints, fault injection,
retry/backoff — the PyTorch counterpart of the JAX package's
``resilience/``.

Three cooperating pieces:

* :class:`CheckpointManager` — atomic, checksummed, GC'd checkpoints
  layered over the I/O drivers (``checkpoint.py``);
* :mod:`~pencilarrays_tpu_torch.resilience.faults` — deterministic named
  injection points consulted by the drivers, the distributed runtime and
  the transpose (``faults.py``);
* :class:`RetryPolicy` — exponential backoff + jitter + deadline for
  every cross-process rendezvous (``retry.py``).

``checkpoint`` is imported lazily: the drivers and
``parallel/distributed.py`` import this package for its errors/faults/
retry pieces, before ``pencilarrays_tpu_torch.io`` exists.
"""

from .errors import (  # noqa: F401
    CheckpointNotFoundError,
    CorruptCheckpointError,
    CorruptSidecarError,
    InjectedFault,
    ResilienceError,
    RetryDeadlineExceeded,
)
from . import faults  # noqa: F401
from .retry import RetryPolicy, is_transient  # noqa: F401

__all__ = [
    "CheckpointManager",
    "Checkpoint",
    "CheckpointNotFoundError",
    "CorruptCheckpointError",
    "CorruptSidecarError",
    "InjectedFault",
    "ResilienceError",
    "RetryDeadlineExceeded",
    "RetryPolicy",
    "is_transient",
    "faults",
]

_LAZY = ("CheckpointManager", "Checkpoint")


def __getattr__(name):
    if name in _LAZY:
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
