"""Typed errors of the fleet federation layer.

The fleet contract extends the serve contract one level up: a whole
mesh dying is a *typed, attributed* event scoped to that mesh — never
a hung router, never an unattributed exception on some other mesh's
tickets.  Client-visible resolution stays the serve triad: every
submitted fleet ticket ends in exactly one of result / typed
:class:`~pencilarrays_tpu_torch.serve.errors.DeadlineError` / typed
:class:`~pencilarrays_tpu_torch.serve.errors.AdmissionError` — mesh failure
is an *internal* signal that triggers failover, not a client outcome.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["FleetError", "MeshFailureError", "MeshLeftError"]


class FleetError(RuntimeError):
    """Base class of every fleet-layer error."""


class MeshFailureError(FleetError):
    """A mesh's health lease expired (or the mesh never joined within
    the grace window): the whole back-end is presumed dead or wedged.

    Carries ``mesh`` (the dead back-end's id) and ``age_s`` (seconds
    since its last known lease renewal; ``None`` when it never
    published one).  Raised by
    :meth:`~pencilarrays_tpu_torch.fleet.health.MeshBoard.check` and
    surfaced internally by the router's failover sweep — clients never
    see it on a ticket: their requests re-bind to a sibling mesh."""

    def __init__(self, msg: str, *, mesh: int,
                 age_s: Optional[float] = None):
        super().__init__(msg)
        self.mesh = mesh
        self.age_s = age_s


class MeshLeftError(FleetError):
    """A mesh departed *cleanly* (it published a durable leave record
    before its lease lapsed): planned scale-down, not a failure — no
    mesh-failure counter bump, but its pending tickets still re-bind.

    Carries ``mesh``."""

    def __init__(self, msg: str, *, mesh: int):
        super().__init__(msg)
        self.mesh = mesh
