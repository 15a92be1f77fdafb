"""Detect-and-recover execution: the guard's escalation ladder (the JAX
package's ``guard/recover.py``, its local ladder).

A detected corruption (:class:`IntegrityError`) is transient by
construction: the data that went into the hop was fine, so re-running
the step usually succeeds, and when it does not, the last committed
checkpoint restores known-good state.  :func:`guarded_step` encodes the
ladder once:

1. run the step (under the hang watchdog);
2. on :class:`IntegrityError`, retry under the
   :class:`~pencilarrays_tpu_torch.resilience.retry.RetryPolicy` backoff
   (the same env knobs: ``PENCILARRAYS_TPU_RETRIES`` etc.), escalating at
   once when the next delay (jitter included) would overrun the policy's
   deadline;
3. attempts exhausted: restore ``ckpt_mgr.latest_valid()`` through the
   caller's ``restore`` callback and run the step once more;
4. still failing (or no checkpoint to restore): re-raise the typed
   error.

Every rung journals a ``guard.recover`` event (stages ``error`` /
``retry`` / ``restore`` / ``recovered`` / ``failed``).

**Mesh mode**: when the cluster coordination layer is armed
(``PENCILARRAYS_TPU_CLUSTER``, or an explicit ``coordinator=``) and the
mesh has more than one process, the ladder becomes *collective*: no rank
acts on a local verdict alone.  At every step boundary all ranks exchange
a status blob (a small KV allgather, never a bare one-sided raise) and
the deterministic merge in
:mod:`~pencilarrays_tpu_torch.cluster.consensus` picks ONE action for the
whole mesh — all-retry, all-restore (of the SAME agreed step, elected by
``CheckpointManager.common_latest_valid``) or all-re-raise.  A
``HangTimeoutError`` enters the same ladder in mesh mode (a hang on one
rank is a mesh event), peers are lease-checked before each attempt
(:class:`~pencilarrays_tpu_torch.cluster.PeerFailureError` instead of a
stall), and every agreed non-``ok`` verdict advances the shared recovery
epoch.  :func:`elastic_step` adds the reformation rung.  With the layer
off or one rank the local ladder runs bit-for-bit unchanged.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from .errors import HangTimeoutError, IntegrityError

__all__ = ["guarded_step", "elastic_step"]

# caller-supplied attribution fields (guarded_step's ``meta=``) folded
# into every guard.recover record of the CURRENT step — thread-local so
# concurrent steps (e.g. a serve dispatch thread next to an app loop)
# never cross-stamp each other's ladders
_meta_local = threading.local()


@contextmanager
def _step_meta(meta: Optional[dict]):
    prev = getattr(_meta_local, "meta", None)
    _meta_local.meta = meta
    try:
        yield
    finally:
        _meta_local.meta = prev


def _journal(stage: str, label: str, **fields) -> None:
    from .. import obs

    if not obs.enabled():
        return
    obs.counter("guard.recoveries", stage=stage).inc()
    meta = getattr(_meta_local, "meta", None)
    if meta:
        for k, v in meta.items():
            # "label"/"stage" are the record's own explicit kwargs and
            # "ev"/"_fsync" are record_event's positional/keyword
            # parameters: a caller meta key with any of these names must
            # not become a duplicate-kwarg crash in the middle of a
            # recovery ladder (nor silently act as the fsync override)
            if k not in ("label", "stage", "ev", "_fsync"):
                fields.setdefault(k, v)
    obs.record_event("guard.recover", label=label, stage=stage, **fields)


def guarded_step(fn: Callable, *, ckpt_mgr=None,
                 restore: Optional[Callable] = None, retry=None,
                 label: str = "step",
                 watchdog_timeout: Optional[float] = None,
                 coordinator=None, meta: Optional[dict] = None):
    """Run one unit of work with detect-and-recover semantics.

    Parameters
    ----------
    fn:
        Zero-argument callable performing the step (typically a closure
        over the caller's state).  Only :class:`IntegrityError` enters
        the recovery ladder (plus :class:`HangTimeoutError` in mesh
        mode); every other exception propagates untouched.  ``fn`` must
        be re-runnable: retries (and, on a mesh, *agreed* retries that
        rerun even ranks whose local copy succeeded) call it again.
    ckpt_mgr:
        A :class:`~pencilarrays_tpu_torch.resilience.CheckpointManager`; with
        ``restore`` it enables the escalation rung.
    restore:
        ``restore(checkpoint)`` callback reloading the caller's state
        from an opened
        :class:`~pencilarrays_tpu_torch.resilience.checkpoint.Checkpoint`
        (the step's inputs live with the caller, so only the caller can
        put restored data back where ``fn`` reads it).
    retry:
        :class:`~pencilarrays_tpu_torch.resilience.retry.RetryPolicy`
        (default: env-tuned ``from_env()``).  ``max_attempts`` bounds
        the pre-escalation retries; backoff/jitter/deadline apply as in
        any other retried operation.
    label:
        Journal/watchdog label of this step.
    watchdog_timeout:
        Per-attempt hang deadline override (None: the guard env
        default).
    coordinator:
        An explicit :class:`~pencilarrays_tpu_torch.cluster.consensus.
        Coordinator` (default: ``cluster.coordinator()``, which is
        ``None`` — the local ladder — unless the cluster layer is armed
        on more than one rank).
    meta:
        Optional attribution fields folded into every ``guard.recover``
        record this step journals (e.g. the serve layer's tenant and
        request ids), so a post-mortem ties a recovery ladder to the
        workload that rode it.  Explicit payload fields win on
        collision.

    Returns ``fn()``'s value.  Raises the last :class:`IntegrityError`
    when the full ladder fails, or
    :class:`~pencilarrays_tpu_torch.resilience.errors.CheckpointNotFoundError`
    semantics are folded into the same re-raise (a missing valid
    checkpoint cannot recover anything)."""
    from ..obs import correlate
    from ..resilience.retry import RetryPolicy

    # one guarded_step call == one collective step: advance the
    # correlation step index (obs/correlate.py) unconditionally — every
    # rank executes the same step sequence, so the per-process counters
    # align across ranks by construction.  Retries stay in the same step.
    correlate.next_step(label)
    policy = retry or RetryPolicy.from_env()
    if coordinator is None:
        from .. import cluster

        coordinator = cluster.coordinator()
    with _step_meta(meta):
        if coordinator is not None:
            return _mesh_guarded_step(coordinator, fn, ckpt_mgr, restore,
                                      policy, label, watchdog_timeout)
        return _local_guarded_step(fn, ckpt_mgr, restore, policy, label,
                                   watchdog_timeout)


def _local_guarded_step(fn, ckpt_mgr, restore, policy, label,
                        watchdog_timeout):
    """The single-process ladder (the JAX package's mesh layer degrades
    to exactly this when ``world == 1``)."""
    from .watchdog import watchdog

    start = time.monotonic()
    last: Optional[IntegrityError] = None
    attempts = max(1, policy.max_attempts)
    for attempt in range(1, attempts + 1):
        try:
            with watchdog(label, watchdog_timeout, kind="step"):
                out = fn()
            if attempt > 1:
                _journal("recovered", label, attempt=attempt, via="retry")
            return out
        except IntegrityError as e:
            last = e
            _journal("error", label, attempt=attempt, kind=e.kind,
                     hop=e.hop, error=str(e))
            if attempt >= attempts:
                break
            delay = policy.delay_for(attempt)
            if time.monotonic() - start + delay > policy.deadline:
                break   # deadline exhausted: escalate now, not later
            _journal("retry", label, attempt=attempt, delay_s=delay)
            time.sleep(delay)

    if ckpt_mgr is None or restore is None:
        _journal("failed", label, error=str(last), escalation="none")
        raise last
    step = ckpt_mgr.latest_valid()
    if step is None:
        _journal("failed", label, error=str(last),
                 escalation="no-valid-checkpoint")
        raise last
    _journal("restore", label, step=step)
    restore(ckpt_mgr.restore(step))
    try:
        with watchdog(label, watchdog_timeout, kind="step"):
            out = fn()
    except IntegrityError as e:
        _journal("failed", label, step=step, error=str(e),
                 escalation="restore")
        raise
    _journal("recovered", label, step=step, via="restore")
    return out


def _mesh_guarded_step(coord, fn, ckpt_mgr, restore, policy, label,
                      watchdog_timeout):
    """The collective ladder: every attempt ends in a status allgather
    and ONE agreed action executed by every rank (module docstring).
    Mirrors the local ladder's shape — ``max_attempts`` retries, one
    restore escalation, then raise — but each rung is mesh-wide."""
    from ..cluster import ClusterAbortError, epoch as _epoch
    from .watchdog import watchdog

    start = time.monotonic()
    attempts = max(1, policy.max_attempts)
    attempt = 0
    restored_step: Optional[int] = None
    last: Optional[Exception] = None
    while True:
        attempt += 1
        coord.check_peers()     # a dead peer fails typed, up front
        err: Optional[Exception] = None
        out = None
        try:
            with watchdog(label, watchdog_timeout, kind="step"):
                out = fn()
        except (IntegrityError, HangTimeoutError) as e:
            err = last = e
            _journal("error", label, attempt=attempt, rank=coord.rank,
                     epoch=_epoch.current(),
                     kind=getattr(e, "kind", "hang"),
                     hop=getattr(e, "hop", None), error=str(e))
        except BaseException as e:
            # NOT part of the recovery ladder (app bug, OOM, interrupt):
            # the contract is passthrough — but never a SILENT one-sided
            # exit.  Publish a fatal status for this round (no waiting),
            # so peers get an agreed `raise` instead of burning the
            # verdict timeout, and the round counters stay aligned for
            # whatever the caller does next.
            coord.post_abort(label, f"{type(e).__name__}: {e}")
            _journal("failed", label, attempt=attempt, rank=coord.rank,
                     epoch=_epoch.current(), error=str(e),
                     escalation="passthrough")
            raise
        # the step boundary: publish local status, read the mesh's, and
        # let the deterministic merge pick the ONE action every rank
        # takes — the all-retry budget and deadline accounting are part
        # of the exchanged status, so the verdict never depends on
        # another rank's clock
        delay = (policy.delay_for(attempt) if attempt < attempts else None)
        can_retry = (restored_step is None and delay is not None
                     and time.monotonic() - start + delay <= policy.deadline)
        # a rank flagged via announce_leave() publishes its departure AT
        # the boundary (only from a CLEAN attempt: a failing leaver must
        # not masquerade as a planned departure)
        leaving = err is None and getattr(coord, "leaving", False)
        verdict = coord.agree(label, {
            "status": ("leave" if leaving else
                       "ok" if err is None else
                       "hang" if isinstance(err, HangTimeoutError)
                       else "integrity"),
            "error": f"{type(err).__name__}: {err}" if err else None,
            "can_retry": bool(can_retry) and not leaving,
            "can_restore": (not leaving and restored_step is None
                            and ckpt_mgr is not None
                            and restore is not None),
        })
        action = verdict["action"]
        if action == "ok":
            if attempt > 1 or restored_step is not None:
                _journal("recovered", label, attempt=attempt,
                         rank=coord.rank, epoch=verdict["epoch"],
                         via="retry" if restored_step is None else "restore",
                         step=restored_step)
            return out
        if action == "retry":
            _journal("retry", label, attempt=attempt, rank=coord.rank,
                     epoch=verdict["epoch"], delay_s=delay)
            time.sleep(delay)   # can_retry was AND-merged: delay is set
            continue
        if action == "leave":
            # planned departures announced at the boundary: the leavers
            # exit the step cleanly with their result; survivors raise
            # the typed departure (no bundle, no peer_failures) that
            # elastic_step turns into a reformation
            from ..cluster import PeerLeftError

            if coord.rank in verdict["ranks"]:
                return out
            raise PeerLeftError(
                f"{label}: rank(s) {verdict['ranks']} announced a clean "
                f"departure at the step boundary", rank=verdict["ranks"][0])
        if action == "restore":
            # the coordinated restore runs under the same watchdog
            # discipline as the step: a rank wedged in election I/O or
            # the checkpoint read leaves a bundle and a typed
            # HangTimeoutError, never an unattributed stall (its
            # heartbeat would otherwise keep the lease fresh forever)
            with watchdog(f"{label}:restore", watchdog_timeout,
                          kind="restore"):
                step = ckpt_mgr.common_latest_valid(coordinator=coord)
                if step is None:
                    _journal("failed", label, rank=coord.rank,
                             epoch=verdict["epoch"], error=str(last),
                             escalation="no-common-checkpoint")
                    raise last if last is not None else ClusterAbortError(
                        f"{label}: mesh agreed to restore but no "
                        f"checkpoint step is valid on every rank",
                        ranks=verdict["ranks"],
                        errors=verdict.get("errors"))
                _journal("restore", label, step=step, rank=coord.rank,
                         epoch=verdict["epoch"])
                restore(ckpt_mgr.restore(step))
            restored_step = step
            continue
        # action == "raise": the mesh exits the step TOGETHER — failing
        # ranks with their own typed error, healthy ranks with a typed
        # abort naming the peers (never a bare hang in a collective)
        _journal("failed", label, rank=coord.rank, epoch=verdict["epoch"],
                 error=str(last) if last is not None else None,
                 escalation="mesh", ranks=verdict["ranks"])
        if last is not None:
            raise last
        raise ClusterAbortError(
            f"{label}: mesh consensus aborted the step — rank(s) "
            f"{verdict['ranks']} failed unrecoverably "
            f"({verdict.get('errors')})",
            ranks=verdict["ranks"], errors=verdict.get("errors"))


def elastic_step(fn: Callable, *, ckpt_mgr=None,
                 restore: Optional[Callable] = None, retry=None,
                 label: str = "step",
                 watchdog_timeout: Optional[float] = None,
                 coordinator=None, rebuild: Optional[Callable] = None,
                 max_reforms: int = 4, meta: Optional[dict] = None):
    """:func:`guarded_step` plus the elastic rung: retry → restore →
    **reform+restore** → re-raise.

    When the mesh ladder ends in a peer-loss error —
    :class:`~pencilarrays_tpu_torch.cluster.PeerFailureError` (a SIGKILLed or
    wedged rank) or :class:`~pencilarrays_tpu_torch.cluster.PeerLeftError`
    (planned scale-down) — and the elastic layer is armed
    (``PENCILARRAYS_TPU_ELASTIC``), the survivors run
    :func:`~pencilarrays_tpu_torch.cluster.elastic.reform`: membership
    consensus, a reformed (smaller or re-grown) coordinator, plan
    rebuild (registered factories + ``rebuild`` callback), and a
    coordinated restore of the agreed checkpoint across the changed
    decomposition — then the step reruns under the reformed mesh.  Up
    to ``max_reforms`` reformations are attempted per call (a cascade
    of failures shrinks the mesh repeatedly until the
    ``ELASTIC_MIN_WORLD`` floor).

    With the gate off (the shipped default) — or no active coordinator
    — this function IS :func:`guarded_step`: the peer-loss error
    propagates exactly as from the mesh ladder (test-pinned), and the
    single-process local ladder is untouched.  A failed reformation journals
    ``guard.recover`` stage ``failed`` and re-raises the ORIGINAL
    peer-loss error with the reformation failure chained as context."""
    from .. import cluster
    from ..cluster import PeerFailureError, PeerLeftError, elastic

    coord = coordinator
    if coord is None:
        coord = cluster.coordinator()
    reforms = 0
    reformed = None
    while True:
        t_attempt = time.monotonic()
        try:
            out = guarded_step(fn, ckpt_mgr=ckpt_mgr, restore=restore,
                               retry=retry, label=label,
                               watchdog_timeout=watchdog_timeout,
                               coordinator=coord, meta=meta)
            if reformed is not None:
                with _step_meta(meta):
                    _journal("recovered", label, rank=coord.rank,
                             via="reform", step=reformed.restored_step,
                             epoch=reformed.membership.epoch,
                             gen=reformed.membership.gen)
            return out
        except (PeerFailureError, PeerLeftError) as e:
            if not elastic.enabled() or coord is None:
                raise           # the mesh ladder's semantics, bit-for-bit
            if reforms >= max_reforms:
                _journal("failed", label, rank=coord.rank, error=str(e),
                         escalation="max-reforms", reforms=reforms)
                raise
            reforms += 1
            planned = isinstance(e, PeerLeftError)
            # NOT detection latency: this spans the whole attempt (step
            # compute + retries + the boundary exchange).  True detect
            # time is bounded by the lease ttl and measured as such by
            # the elastic drills; mislabeling this as detect_s
            # would corrupt the MTTR breakdown operators tune against.
            failed_after_s = time.monotonic() - t_attempt
            _journal("reform", label, rank=coord.rank,
                     peer=getattr(e, "rank", None), planned=planned,
                     failed_after_s=failed_after_s, error=str(e))
            try:
                r = elastic.reform(
                    coord, reason="leave" if planned else "peer-failure",
                    ckpt_mgr=ckpt_mgr, restore=restore, rebuild=rebuild)
            except BaseException as re:
                _journal("failed", label, rank=coord.rank,
                         escalation="reform",
                         error=f"{type(re).__name__}: {re}")
                raise e from re
            coord = r.coordinator
            reformed = r
            # rerun the step under the reformed mesh (the restore rung
            # already reloaded the agreed checkpoint); "recovered" is
            # journaled only once the rerun actually succeeds
            continue
