"""Typed failure taxonomy of the cluster layer (a copy of the JAX
package's ``cluster/errors.py``): every failure it can surface derives
from :class:`ClusterError`, so the two packages name failures alike and a
drill can assert "typed cluster error, never a silent hang" with one
``except`` clause."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

__all__ = [
    "ClusterError",
    "PeerFailureError",
    "PeerLeftError",
    "ClusterAbortError",
    "ConsensusTimeoutError",
    "ReformError",
    "QuorumLossError",
    "FencedWriteError",
]


class ClusterError(Exception):
    """Base of every error raised by ``pencilarrays_tpu_torch.cluster``."""


class PeerFailureError(ClusterError):
    """A peer rank's health lease expired (SIGKILLed, wedged, or
    partitioned) or it never joined the mesh within the grace window.
    Surviving ranks raise this *instead of hanging in the next
    collective* until a watchdog fires.  ``rank`` names the dead peer,
    ``age_s`` is how stale its lease was at detection, ``bundle`` is
    the crash-bundle directory written for the post-mortem."""

    def __init__(self, message: str, *, rank: Optional[int] = None,
                 age_s: Optional[float] = None, bundle: Optional[str] = None):
        super().__init__(message)
        self.rank = rank
        self.age_s = age_s
        self.bundle = bundle


class PeerLeftError(ClusterError):
    """A peer rank left the mesh *cleanly*: it published a
    ``cluster.leave`` record before letting its lease lapse, so this is
    planned scale-down, not a crash — no crash bundle is written and
    ``cluster.peer_failures`` does not tick (the false-alarm fix).
    With the elastic layer armed this triggers mesh reformation exactly
    like a :class:`PeerFailureError`; without it, callers see a typed,
    attributable departure instead of a fabricated failure."""

    def __init__(self, message: str, *, rank: Optional[int] = None):
        super().__init__(message)
        self.rank = rank


class ReformError(ClusterError):
    """Elastic mesh reformation failed: the membership consensus did
    not converge (live-set views kept diverging, or a timeout expired),
    or the post-agreement rebuild/restore raised.  ``stage`` names the
    reformation stage that failed; the original recovery error (if the
    reformation was failure-triggered) should be chained as the
    cause."""

    def __init__(self, message: str, *, stage: Optional[str] = None,
                 gen: Optional[int] = None):
        super().__init__(message)
        self.stage = stage
        self.gen = gen


class QuorumLossError(ReformError):
    """This rank sits on the MINORITY side of a partitioned mesh: the
    membership consensus could not assemble a strict majority of the
    *last-agreed* membership, so forming generation N+1 here would
    create a rival mesh (split brain) — two generations both believing
    they own the namespace, double-executing work and double-writing
    checkpoints.  The only safe action on this side is a typed exit;
    the majority side (if one exists) reforms without this rank.
    ``have`` is the voter set this side could assemble, ``need`` the
    strict-majority threshold, ``of`` the last-agreed membership it is
    computed over.  ``ELASTIC_QUORUM=off``
    (``PENCILARRAYS_TPU_ELASTIC_QUORUM``) disables the gate for an
    intentional shrink below majority."""

    def __init__(self, message: str, *, gen: Optional[int] = None,
                 have: Sequence[int] = (), need: Optional[int] = None,
                 of: Sequence[int] = ()):
        super().__init__(message, stage="quorum", gen=gen)
        self.have = tuple(have)
        self.need = need
        self.of = tuple(of)


class FencedWriteError(ClusterError):
    """A recovery-path KV write carried a stale fencing token: the
    writer's ``(generation, epoch)`` is behind the namespace's
    published fence, i.e. the mesh reformed (or recovered) past this
    writer — a zombie rank waking up after eviction.  The write was
    rejected *before* touching the store; the correct reaction is to
    stop, never to retry (the fence only ever moves further away).
    ``token`` is the writer's stale token, ``fence`` the published
    one."""

    def __init__(self, message: str, *, key: Optional[str] = None,
                 token: Optional[tuple] = None,
                 fence: Optional[tuple] = None):
        super().__init__(message)
        self.key = key
        self.token = token
        self.fence = fence


class ClusterAbortError(ClusterError):
    """The mesh agreed to abort: another rank hit an unrecoverable
    failure (its error string is in ``errors``), and this rank — which
    may itself be healthy — re-raises *by consensus* so every rank
    exits the step together instead of deadlocking in a half-abandoned
    collective.  ``ranks`` lists the ranks that reported failure."""

    def __init__(self, message: str, *,
                 ranks: Sequence[int] = (),
                 errors: Optional[Dict[int, str]] = None):
        super().__init__(message)
        self.ranks = tuple(ranks)
        self.errors = dict(errors or {})


class ConsensusTimeoutError(ClusterError, TimeoutError):
    """A KV consensus round did not complete within the verdict
    timeout and no peer lease had expired to explain it (a live-but-
    diverged peer, or a too-small ``PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT``).
    Subclasses ``TimeoutError`` so retry policies classify it as
    transient."""

    def __init__(self, message: str, *, key: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        super().__init__(message)
        self.key = key
        self.timeout_s = timeout_s
