"""Retry/timeout/backoff policy for cross-process rendezvous and I/O.

PyTorch counterpart of the JAX package's ``resilience/retry.py``.  Every
cross-process rendezvous in the runtime — the process-group rendezvous in
``distributed.initialize``, a driver ``open`` racing file creation on a
shared filesystem, a sidecar flush hitting a transient ``EIO`` — needs
*bounded retries, not hangs and not crashes*.  :class:`RetryPolicy` is the
one knob set: exponential backoff with jitter under an overall wall-clock
deadline.

Each retry is logged through the ``pencilarrays_tpu_torch.resilience``
logger (a visible warning naming the operation, attempt and delay), and
the backoff sleep is wrapped in
:func:`~pencilarrays_tpu_torch.utils.timers.timeit`, so retries show up in
``TimerOutput`` reports and as ``torch.profiler`` ranges like any other
instrumented section.  (The JAX package also journals each retry through
its ``obs`` flight recorder, which the port has not ported yet.)

Environment knobs (read by :meth:`RetryPolicy.from_env`), the JAX
package's names:

=================================  =======  ==============================
``PENCILARRAYS_TPU_RETRIES``       5        max attempts
``PENCILARRAYS_TPU_RETRY_BASE``    0.05     first backoff delay (s)
``PENCILARRAYS_TPU_RETRY_MAX``     2.0      per-retry delay ceiling (s)
``PENCILARRAYS_TPU_RETRY_DEADLINE``  30.0   overall wall-clock budget (s)
=================================  =======  ==============================
"""

from __future__ import annotations

import errno
import logging
import os
import random
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

from .errors import InjectedFault, RetryDeadlineExceeded

__all__ = ["RetryPolicy", "is_transient"]

logger = logging.getLogger("pencilarrays_tpu_torch.resilience")

# OSError errnos worth retrying: resource pressure / interruption /
# shared-FS weather.  ENOENT and EACCES are deliberately NOT here — a
# missing file or bad permission is a program error, and retrying it
# would only turn a clear failure into a slow one.
_TRANSIENT_ERRNOS = frozenset({
    errno.EAGAIN, errno.EINTR, errno.EBUSY, errno.EIO, errno.ENOSPC,
    errno.ESTALE, errno.ETIMEDOUT, errno.ECONNREFUSED, errno.ECONNRESET,
    errno.EADDRINUSE,
})


def is_transient(e: BaseException) -> bool:
    """Default retryability test: connection/timeout errors, injected
    faults, and ``OSError`` with a transient errno."""
    if isinstance(e, (ConnectionError, TimeoutError, InterruptedError,
                      InjectedFault)):
        return True
    if isinstance(e, OSError):
        return e.errno in _TRANSIENT_ERRNOS
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + deadline.

    Delay before retry *n* (1-based) is
    ``min(base_delay * 2**(n-1), max_delay)`` scaled by a uniform jitter
    in ``[1 - jitter, 1 + jitter]``; the whole operation must land
    within ``deadline`` seconds of the first attempt or
    :class:`RetryDeadlineExceeded` is raised (chaining the last error).
    ``max_attempts=1`` disables retries entirely.
    """

    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: float = 30.0
    jitter: float = 0.25
    retry_on: Optional[Tuple[type, ...]] = None  # None -> is_transient()

    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        env = os.environ.get
        kw = dict(
            max_attempts=int(env("PENCILARRAYS_TPU_RETRIES", 5)),
            base_delay=float(env("PENCILARRAYS_TPU_RETRY_BASE", 0.05)),
            max_delay=float(env("PENCILARRAYS_TPU_RETRY_MAX", 2.0)),
            deadline=float(env("PENCILARRAYS_TPU_RETRY_DEADLINE", 30.0)),
        )
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)

    def _retryable(self, e: BaseException) -> bool:
        if self.retry_on is not None:
            return isinstance(e, self.retry_on)
        return is_transient(e)

    def delay_for(self, attempt: int) -> float:
        """Jittered backoff delay before the retry following ``attempt``
        (1-based) — THE one definition of the backoff curve."""
        delay = min(self.base_delay * 2 ** (attempt - 1), self.max_delay)
        return delay * (1 + self.jitter * (2 * random.random() - 1))

    def call(self, fn: Callable, *args, label: str = "operation",
             timer=None, **kw):
        """Run ``fn(*args, **kw)`` under this policy.  Non-retryable
        errors propagate untouched on the first attempt; retryable ones
        are re-raised as-is once attempts are exhausted, or wrapped in
        :class:`RetryDeadlineExceeded` when the deadline cuts the loop
        short."""
        from ..utils.timers import timeit

        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kw)
            except Exception as e:
                if not self._retryable(e) or attempt >= self.max_attempts:
                    raise
                delay = self.delay_for(attempt)
                elapsed = time.monotonic() - start
                if elapsed + delay > self.deadline:
                    raise RetryDeadlineExceeded(
                        f"{label}: attempt {attempt} failed and the "
                        f"{self.deadline:.1f}s retry deadline is exhausted "
                        f"({elapsed:.2f}s elapsed): {e}") from e
                from ..obs import enabled as _obs_enabled

                if _obs_enabled():
                    from ..obs import counter, record_event

                    counter("retry.attempts", label=label).inc()
                    record_event(
                        "retry", label=label, attempt=attempt,
                        max_attempts=self.max_attempts, delay_s=delay,
                        error=f"{type(e).__name__}: {e}")
                logger.warning(
                    "%s failed (attempt %d/%d): %s — retrying in %.3fs",
                    label, attempt, self.max_attempts, e, delay)
                with timeit(timer, f"retry {label}"):
                    time.sleep(delay)
