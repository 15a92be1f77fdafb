"""Hang watchdog: a host-side deadline around blocking runtime calls (the
JAX package's ``guard/watchdog.py``).

A wedged collective, a dead rendezvous peer or a stuck barrier does not
raise: it blocks.  Entering :class:`watchdog` arms a deadline on one
shared monitor thread (daemonic, started lazily through
``engine/threads.py``); leaving in time costs two lock acquisitions.  On
expiry the monitor, running outside the stuck call, journals
``guard.hang``, writes a crash bundle while the section is still
blocked, and then signals the main thread; the context manager turns
the interrupt into a typed :class:`~pencilarrays_tpu_torch.guard.errors.
HangTimeoutError` carrying the bundle's path.

The interrupt reaches only the main thread, and only where the blocked
call returns to Python or checks signals: a wait inside the CUDA runtime
(a stream synchronize behind a hung kernel or NCCL call) stays stuck,
but the bundle and the journal record exist regardless, so the
post-mortem does not depend on the process returning.  The guarded hop
keeps its section armed until its probe fetch returns, which waits for
the card's stream, so a hang on the card is seen, not only one on the
host.  Sections armed from other threads get the bundle and the record
but no interrupt.

Deadline: the ``timeout`` argument, else
``PENCILARRAYS_TPU_GUARD_TIMEOUT`` (default 300 s; ``0`` disables).  With
the guard off, :class:`watchdog` costs one cached probe.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .errors import HangTimeoutError

__all__ = ["watchdog", "active_count"]


class _Entry:
    __slots__ = ("label", "timeout", "deadline", "ctx", "fired", "bundle",
                 "done", "main_thread")

    def __init__(self, label: str, timeout: float, ctx: dict):
        self.label = label
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self.ctx = ctx
        self.fired = False
        self.bundle: Optional[str] = None
        self.done = threading.Event()
        self.main_thread = (threading.current_thread()
                            is threading.main_thread())


_cv = threading.Condition()
_entries: dict = {}
_next_id = 0
_monitor_started = False


def active_count() -> int:
    """Currently-armed watchdog sections (introspection for tests)."""
    with _cv:
        return len(_entries)


def _ensure_monitor() -> None:
    global _monitor_started
    if _monitor_started:
        return
    _monitor_started = True
    from ..engine.threads import spawn_thread

    spawn_thread(_monitor_loop, name="pa-guard-watchdog")


def _monitor_loop() -> None:
    while True:
        with _cv:
            now = time.monotonic()
            due = [e for e in _entries.values()
                   if not e.fired and e.deadline <= now]
            for e in due:
                e.fired = True
            if not due:
                pending = [e.deadline for e in _entries.values()
                           if not e.fired]
                _cv.wait(timeout=(max(0.005, min(pending) - now)
                                  if pending else None))
                continue
        for e in due:   # outside the lock: bundle writes are slow
            _fire(e)


def _fire(e: _Entry) -> None:
    """Expiry path, on the monitor thread: journal, write the bundle
    while the guarded section is still stuck, then interrupt main.
    Both records carry the recovery epoch."""
    from ..cluster import epoch as _epoch
    from ..obs import counter, enabled as obs_enabled, record_event

    if obs_enabled():
        counter("guard.hangs").inc()
        record_event("guard.hang", label=e.label, timeout_s=e.timeout,
                     epoch=_epoch.current(), **e.ctx)
    try:
        from .bundle import write_crash_bundle

        e.bundle = write_crash_bundle(
            "hang", e.label,
            error=f"no progress within {e.timeout:.1f}s",
            extra={"timeout_s": e.timeout, "ctx": e.ctx})
    except Exception:   # pragma: no cover - the bundle is best-effort
        e.bundle = None
    e.done.set()
    if e.main_thread:
        # deliver a real signal to the main thread: interrupt_main()
        # only sets a flag checked between bytecodes, which never wakes
        # a thread parked inside a blocking C call (sem_wait, a sleep) —
        # pthread_kill EINTRs the call so Python's SIGINT handler can
        # raise in the stuck thread
        try:
            import signal as _signal

            _signal.pthread_kill(threading.main_thread().ident,
                                 _signal.SIGINT)
        except Exception:   # pragma: no cover - exotic platforms
            import _thread

            _thread.interrupt_main()


def _absorb_pending_interrupt() -> None:
    """The guarded section finished in the narrow window between expiry
    and disarm: the monitor's interrupt may still be pending delivery.
    Give it a delivery point and swallow it, so it cannot detonate in
    unrelated user code after we raise the typed error instead."""
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        time.sleep(0.05)
    except KeyboardInterrupt:
        pass


class watchdog:
    """Context manager arming a hang deadline around its body.

    ::

        with guard.watchdog("hop:AllToAll", kind="hop"):
            out = hop(data)           # a hang here -> bundle + typed error

    No-op (one env probe) when the guard is disabled or the resolved
    timeout is ``<= 0``.  Extra keyword context rides the ``guard.hang``
    journal record and the bundle manifest."""

    def __init__(self, label: str, timeout: Optional[float] = None, **ctx):
        self.label = label
        self._timeout = timeout
        self._ctx = ctx
        self._entry: Optional[_Entry] = None
        self._id = None

    def __enter__(self):
        from . import enabled, hang_timeout

        if not enabled():
            return self
        t = hang_timeout() if self._timeout is None else float(self._timeout)
        if t <= 0:
            return self
        global _next_id
        e = _Entry(self.label, t, self._ctx)
        with _cv:
            _ensure_monitor()
            _next_id += 1
            self._id = _next_id
            _entries[self._id] = e
            _cv.notify()
        self._entry = e
        return self

    def __exit__(self, exc_type, exc, tb):
        e = self._entry
        if e is None:
            return False
        with _cv:
            _entries.pop(self._id, None)
        if not e.fired:
            return False
        # the deadline expired: wait for the monitor to finish the
        # bundle (it sets done after writing), then surface the typed
        # error — replacing the KeyboardInterrupt the monitor used to
        # unblock us, or absorbing it if it has not been delivered yet
        e.done.wait(30.0)
        err = HangTimeoutError(
            f"{self.label}: no progress within {e.timeout:.1f}s deadline "
            f"(crash bundle: {e.bundle or 'unavailable'})",
            label=self.label, timeout_s=e.timeout, bundle=e.bundle)
        if exc_type is KeyboardInterrupt:
            raise err from None
        # clean completion OR a real error racing the expiry: the
        # monitor's SIGINT may still be pending delivery — absorb it
        # before raising/propagating, so it cannot detonate later in
        # unrelated code
        _absorb_pending_interrupt()
        if exc_type is None:
            raise err
        return False   # a real error beat the watchdog: let it through
