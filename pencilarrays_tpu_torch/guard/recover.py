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

The JAX package's mesh ladder (a status agreement among the ranks at
every step boundary, over the cluster coordinator) and
:func:`elastic_step` wait for ``cluster/`` (ROADMAP.md Queue 1 item 7(d)):
with a coordinator they raise.  With the cluster layer off or one rank,
``cluster.coordinator()`` is ``None`` and the local ladder runs, as in
the JAX package.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from .errors import IntegrityError

__all__ = ["guarded_step", "elastic_step"]

_LATER = "not ported yet: ROADMAP.md Queue 1, item 7(d) (cluster/)"

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
        the recovery ladder; every other exception (a
        ``HangTimeoutError`` of the step's watchdog too) propagates
        untouched.  ``fn`` must be re-runnable: retries call it again.
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
        An explicit cluster coordinator (default: ``cluster.
        coordinator()``, which is ``None`` — the local ladder — unless
        the cluster layer is armed on more than one rank).  The mesh
        ladder is not ported yet: a coordinator raises.
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
    """The JAX package's collective ladder (one agreed action per step
    boundary over the cluster coordinator).  Not ported yet."""
    raise NotImplementedError(f"guarded_step's mesh ladder is {_LATER}")


def elastic_step(fn: Callable, **kwargs):
    """The JAX package's :func:`guarded_step` plus the elastic rung
    (retry, restore, reform and restore, re-raise).  Not ported yet."""
    raise NotImplementedError(f"guard.elastic_step() is {_LATER}")
