"""Runtime integrity guard: silent-corruption probes, the hang watchdog,
crash bundles and detect-and-recover (the JAX package's ``guard/``).

Four cooperating pieces:

* :mod:`~pencilarrays_tpu_torch.guard.integrity` — exchange invariant
  probes: a transpose, a reshard route and a restore only move data, so a
  content sum and an absolute-value sum of the operand taken before and
  after the hop must agree.  The port takes them as reductions on the
  card around the hop (before K1's pack, after K1's unpack), sums them
  over the topology's ranks, and compares them on the host after one
  fetch; a mismatch journals ``guard.sdc``, writes a crash bundle and
  raises :class:`IntegrityError`;
* :mod:`~pencilarrays_tpu_torch.guard.watchdog` — a monitor thread arms
  a deadline around hop dispatch with its probe fetch (so a hang on the
  card is seen, not only one on the host), ``distributed.initialize``
  and ``sync_global_devices``; on expiry it writes a crash bundle and the
  section raises :class:`HangTimeoutError`;
* :mod:`~pencilarrays_tpu_torch.guard.bundle` — the crash bundle (the
  journal, the metrics snapshot, every thread's stack, recent plan
  fingerprints, the environment);
* :mod:`~pencilarrays_tpu_torch.guard.recover` — :func:`guarded_step`:
  retry a step on :class:`IntegrityError` under a ``RetryPolicy``, then
  restore from a ``CheckpointManager``.

Off by default, and one cached probe per dispatch when off: the guarded
call sites test :func:`enabled` first and otherwise run the unguarded
code unchanged.  Enable with ``PENCILARRAYS_TPU_GUARD=1`` (any other
value that is not an off token is the bundle directory) or with
:func:`enable`.  The knobs are the JAX package's, parsed in
``engine/config.py``:

================================  =========  ==========================
``PENCILARRAYS_TPU_GUARD``        unset      off / ``1`` on / a path
                                             (on + bundle dir)
``PENCILARRAYS_TPU_GUARD_DIR``    pa_guard   crash-bundle directory
``PENCILARRAYS_TPU_GUARD_TIMEOUT``  300      watchdog deadline (s);
                                             ``0`` disables the
                                             watchdog only
``PENCILARRAYS_TPU_GUARD_RTOL``   auto       content-sum relative
                                             tolerance override
``PENCILARRAYS_TPU_GUARD_WIRE_RTOL`` auto    the wire formats' tolerance
                                             override (``parallel/
                                             wire.py`` ``wire_rtol``)
``PENCILARRAYS_TPU_GUARD_FINITE``  0         finiteness-tap sampling:
                                             probe every Nth guarded
                                             dispatch (``0`` off)
================================  =========  ==========================
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .errors import (  # noqa: F401
    GuardError,
    HangTimeoutError,
    IntegrityError,
    WirePrecisionError,
)

__all__ = [
    "ENV_VAR",
    "DIR_VAR",
    "TIMEOUT_VAR",
    "RTOL_VAR",
    "FINITE_VAR",
    "GuardError",
    "IntegrityError",
    "WirePrecisionError",
    "HangTimeoutError",
    "enabled",
    "enable",
    "disable",
    "bundle_dir",
    "hang_timeout",
    "finite_every",
    "finite_tick",
    "watchdog",
    "guarded_step",
    "elastic_step",
    "write_crash_bundle",
    "note_plan",
]

ENV_VAR = "PENCILARRAYS_TPU_GUARD"
DIR_VAR = "PENCILARRAYS_TPU_GUARD_DIR"
TIMEOUT_VAR = "PENCILARRAYS_TPU_GUARD_TIMEOUT"
RTOL_VAR = "PENCILARRAYS_TPU_GUARD_RTOL"
FINITE_VAR = "PENCILARRAYS_TPU_GUARD_FINITE"
DEFAULT_DIR = "pa_guard"
DEFAULT_TIMEOUT = 300.0

_OFF_VALUES = ("", "0", "off", "false")

_lock = threading.Lock()
_override: Optional[bool] = None      # programmatic enable()/disable()
_override_dir: Optional[str] = None
_finite_counter = 0


def enabled() -> bool:
    """The gate every guarded call site probes first: one branch and one
    cached snapshot probe when off.  The environment value rides the
    engine's :class:`~pencilarrays_tpu_torch.engine.config.RuntimeConfig`
    snapshot, which re-resolves when it changes (workers arm late)."""
    if _override is not None:
        return _override
    from ..engine import config as _rtc

    return _rtc.current().guard_on


def enable(bundle_directory: Optional[str] = None) -> None:
    """Programmatic enable (wins over the environment until
    :func:`disable`); ``bundle_directory`` overrides the crash-bundle
    location."""
    global _override, _override_dir
    with _lock:
        _override = True
        _override_dir = (os.fspath(bundle_directory)
                         if bundle_directory else None)


def disable() -> None:
    """Programmatic disable: wins over the environment until the next
    :func:`enable`."""
    global _override, _override_dir
    with _lock:
        _override = False
        _override_dir = None


def _reset_for_tests() -> None:
    """Drop the overrides, the finite-tap counter, the shared config
    snapshot and the crash-bundle cap (tests toggle the environment
    between cases)."""
    global _override, _override_dir, _finite_counter
    with _lock:
        _override = None
        _override_dir = None
        _finite_counter = 0
    from ..engine import config as _rtc
    from . import bundle as _bundle

    _rtc._reset_for_tests()
    _bundle._reset_for_tests()


def bundle_dir() -> str:
    """The crash-bundle directory: the :func:`enable` argument, else a
    gate value that is not ``1``/``on``/``true``, else
    ``PENCILARRAYS_TPU_GUARD_DIR``."""
    if _override_dir:
        return _override_dir
    from ..engine import config as _rtc

    cfg = _rtc.current()
    if cfg.guard_env not in _OFF_VALUES + ("1", "on", "true"):
        return cfg.guard_env
    return cfg.guard_dir_env


def hang_timeout() -> float:
    """Watchdog deadline in seconds (``0`` disables the watchdog and
    leaves the probes armed)."""
    from ..engine import config as _rtc

    return _rtc.current().guard_timeout


def finite_every() -> int:
    """Finiteness-tap sampling period: every Nth guarded dispatch (``0``:
    tap off; the content-sum probe still sees a NaN born in a pure
    movement hop, since it poisons the sum after the hop)."""
    from ..engine import config as _rtc

    return _rtc.current().guard_finite_every


def finite_tick() -> bool:
    """Counter-based sampling decision for one guarded dispatch: True on
    every Nth call when the tap is armed (deterministic)."""
    n = finite_every()
    if n <= 0:
        return False
    global _finite_counter
    with _lock:
        _finite_counter += 1
        return _finite_counter % n == 0


def __getattr__(name):
    # the heavy pieces load lazily, so the gate stays import-light
    if name in ("guarded_step", "elastic_step"):
        from . import recover as _recover

        return getattr(_recover, name)
    if name in ("write_crash_bundle", "note_plan"):
        from . import bundle as _bundle

        return getattr(_bundle, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# bound eagerly and last: importing the submodule sets a ``watchdog``
# attribute on this package, which this import then rebinds to the class
from .watchdog import watchdog  # noqa: E402,F401
