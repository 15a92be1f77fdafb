"""Correlation keys, the fields that join N ranks' journals (a copy of the
JAX package's ``obs/correlate.py``).

Stamped by :mod:`~pencilarrays_tpu_torch.obs.events` into every record:

* ``step_idx`` — a monotonic per-process step index advanced by
  :func:`next_step` / the :func:`step` context manager; every rank runs
  the same collective step sequence, so the counters align without
  communication;
* ``epoch`` — the recovery epoch (:mod:`~pencilarrays_tpu_torch.cluster.
  epoch`);
* ``plan_fp`` — a short fingerprint of the most recently built plan,
  once any plan exists.

Everything here is communication-free and runs with observability
disabled too, so late-armed ranks journal aligned indices.
"""

from __future__ import annotations

import hashlib
import json
import threading
from contextlib import contextmanager
from typing import Optional

__all__ = [
    "current_step",
    "next_step",
    "step",
    "current_plan",
    "set_plan",
    "plan_fingerprint",
    "stamp",
]

_lock = threading.Lock()
_step = 0
_plan_fp: Optional[str] = None


def current_step() -> int:
    """The step index records are being stamped with (0 = before any
    step boundary)."""
    return _step


def next_step(label: Optional[str] = None) -> int:
    """Advance the monotonic step index (one collective step boundary)
    and return the new value; application loops call it per
    iteration."""
    global _step
    with _lock:
        _step += 1
        return _step


@contextmanager
def step(label: Optional[str] = None):
    """Scope one application step: advances the index on entry, yields
    it.  (There is nothing to restore on exit — the index is monotonic;
    the context-manager shape just marks the step's extent in code.)"""
    yield next_step(label)


def current_plan() -> Optional[str]:
    """Fingerprint of the most recently built/dispatched plan, if any."""
    return _plan_fp


def set_plan(fingerprint: Optional[str]) -> None:
    """Install the plan fingerprint subsequent records are stamped with
    (``None`` clears it)."""
    global _plan_fp
    _plan_fp = fingerprint


def plan_fingerprint(summary) -> str:
    """Short stable fingerprint (12 hex chars of sha256) of a plan
    summary dict (the JAX package's digest)."""
    try:
        blob = json.dumps(summary, sort_keys=True, default=str)
    except Exception:
        blob = repr(summary)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _epoch_current() -> int:
    """The recovery epoch, without importing anything heavy (the
    cluster package imports nothing heavy)."""
    try:
        from ..cluster import epoch

        return epoch.current()
    except Exception:   # pragma: no cover - never break the recorder
        return 0


def stamp() -> dict:
    """The correlation fields :func:`~pencilarrays_tpu_torch.obs.events.
    record_event` folds into every record."""
    out = {"step_idx": _step, "epoch": _epoch_current()}
    if _plan_fp is not None:
        out["plan_fp"] = _plan_fp
    return out


def _reset_for_tests() -> None:
    global _step, _plan_fp
    with _lock:
        _step = 0
        _plan_fp = None
