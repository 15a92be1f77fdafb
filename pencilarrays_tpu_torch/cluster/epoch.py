"""Recovery epochs, the cross-rank timeline marker (a copy of the JAX
package's ``cluster/epoch.py``).

Every agreed recovery action advances a monotonic epoch, identically on
every rank; the journal stamps it into every record (``obs/correlate``)
so that N ranks' journals line up without trusting wall clocks.  Epoch 0
is a job that never recovered; the port has no recovery ladder yet
(``guard/``, ``cluster/``), so its runs stay at the epoch they are at.
"""

from __future__ import annotations

import threading

__all__ = ["current", "advance", "set_current"]

_lock = threading.Lock()
_epoch = 0


def current() -> int:
    """The recovery epoch this process is in (0 = never recovered)."""
    return _epoch


def set_current(value: int, reason: str, **fields) -> int:
    """Raise the epoch to ``value`` (monotonic: a smaller value is a
    no-op).  On an increase, journals a ``guard.epoch`` record carrying
    ``reason`` and mirrors the value into the ``cluster.epoch`` gauge."""
    global _epoch
    with _lock:
        if value <= _epoch:
            return _epoch
        _epoch = value
    from .. import obs

    if obs.enabled():
        obs.gauge("cluster.epoch").set(value)
        obs.record_event("guard.epoch", epoch=value, reason=reason, **fields)
    return value


def advance(reason: str, **fields) -> int:
    """Enter the next recovery epoch."""
    return set_current(current() + 1, reason, **fields)


def _reset_for_tests() -> None:
    global _epoch
    with _lock:
        _epoch = 0
