"""Request-scoped trace context (the context half of the JAX package's
``obs/requestflow.py``).

A trace id (16 hex chars, :func:`mint_trace`) is minted once per request
at an admission point and carried in the engine task's ``meta["trace"]``;
:meth:`~pencilarrays_tpu_torch.engine.Engine._run_task` installs it as
the consumer thread's ambient context for the whole dispatch
(:func:`installed`), and :func:`stamp` folds it into every journal
record written meanwhile (an explicitly passed ``trace=`` wins).  The
per-request reconstruction (``reconstruct_request``, ``list_requests``)
rides the timeline merger, which is not ported yet.
"""

from __future__ import annotations

import threading
import uuid
from contextlib import contextmanager
from typing import Optional

__all__ = [
    "mint_trace",
    "current_trace",
    "installed",
    "stamp",
    "reconstruct_request",
    "list_requests",
]

_LATER = ("not ported yet: ROADMAP.md Queue 1, item 7(b), the rest of obs/ "
          "(timeline)")

_lock = threading.Lock()
_tls = threading.local()


def mint_trace() -> str:
    """Mint a fresh request trace id (16 hex chars)."""
    return uuid.uuid4().hex[:16]


def current_trace() -> Optional[str]:
    """The thread's ambient trace context (None = no request in flight
    on this thread)."""
    return getattr(_tls, "trace", None)


@contextmanager
def installed(trace: Optional[str]):
    """Install ``trace`` as this thread's ambient context for the
    duration.  ``None`` installs nothing but still restores cleanly (an
    untraced task must not inherit the previous one's context)."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


def stamp() -> dict:
    """The ambient trace field :func:`~pencilarrays_tpu_torch.obs.events.
    record_event` folds into every record (empty when no context is
    ambient)."""
    t = getattr(_tls, "trace", None)
    return {"trace": t} if t else {}


def reconstruct_request(directory: str, trace: str, **kwargs):
    raise NotImplementedError(f"reconstruct_request() is {_LATER}")


def list_requests(directory: str, **kwargs):
    raise NotImplementedError(f"list_requests() is {_LATER}")


def _reset_for_tests() -> None:
    with _lock:
        _tls.trace = None
