"""Coordinated mesh-wide recovery — consensus, health leases, epochs,
elastic reformation (the JAX package's ``cluster/``).

On a multi-process pencil mesh every recovery decision must be *agreed*,
because the step being guarded is collective: a rank that restores while
its peers retry (or raises while its peers block in an exchange) turns one
detected fault into a mesh-wide deadlock.  The pieces:

* :mod:`~pencilarrays_tpu_torch.cluster.kv` — the wire: a
  ``torch.distributed`` store (:class:`~.kv.StoreKV`), or a shared
  directory (:class:`~.kv.FileKV`) for local multi-process drills and
  tests; keys and values are the JAX package's, so one KV directory
  serves both packages;
* :mod:`~pencilarrays_tpu_torch.cluster.consensus` — the status allgather
  and deterministic verdict merge behind the mesh ``guarded_step`` (one
  agreed action: all-retry / all-restore / all-re-raise), and the
  agreed-checkpoint election behind
  ``CheckpointManager.common_latest_valid()``;
* :mod:`~pencilarrays_tpu_torch.cluster.health` — per-rank heartbeat
  leases: a SIGKILLed or wedged peer surfaces as a typed
  :class:`PeerFailureError` (with a crash bundle) instead of a collective
  stall;
* :mod:`~pencilarrays_tpu_torch.cluster.epoch` — the monotonic recovery
  epoch stamped into journals, bundles and checkpoint manifests;
* :mod:`~pencilarrays_tpu_torch.cluster.elastic` — membership consensus,
  reformation around the survivors, re-planning and the coordinated
  restore behind ``guard.elastic_step``.

Everything is **off by default** (one cached env probe on the disabled
path, env re-read on change so a worker can arm late), and with one rank
and no explicit world the layer degrades to the local ladder — single
process behavior is bit-for-bit unchanged.  Identity: the
``PENCILARRAYS_TPU_CLUSTER_RANK`` / ``_WORLD`` overrides first, then the
``torch.distributed`` default group (in place of ``jax.distributed``),
else 0 and 1.

Environment knobs (the JAX package's):

====================================  ========  ==========================
``PENCILARRAYS_TPU_CLUSTER``          unset     off / ``1`` (the default
                                                group's store) / a shared
                                                directory (``FileKV``)
``PENCILARRAYS_TPU_CLUSTER_RANK``     group     this process's mesh rank
``PENCILARRAYS_TPU_CLUSTER_WORLD``    group     mesh size
``PENCILARRAYS_TPU_CLUSTER_LEASE_TTL``    15    lease staleness bound (s)
``PENCILARRAYS_TPU_CLUSTER_LEASE_INTERVAL``  ttl/3  heartbeat period (s)
``PENCILARRAYS_TPU_CLUSTER_JOIN_GRACE``   max(2*ttl, 20)  never-joined
                                                window (s)
``PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT`` 120  consensus-round wait (s)
====================================  ========  ==========================
"""

from __future__ import annotations

import threading
from typing import Optional

from .errors import (  # noqa: F401
    ClusterAbortError,
    ClusterError,
    ConsensusTimeoutError,
    FencedWriteError,
    PeerFailureError,
    PeerLeftError,
    QuorumLossError,
    ReformError,
)

__all__ = [
    "ENV_VAR",
    "RANK_VAR",
    "WORLD_VAR",
    "LEASE_TTL_VAR",
    "LEASE_INTERVAL_VAR",
    "JOIN_GRACE_VAR",
    "VERDICT_TIMEOUT_VAR",
    "ClusterError",
    "PeerFailureError",
    "PeerLeftError",
    "ClusterAbortError",
    "ConsensusTimeoutError",
    "ReformError",
    "QuorumLossError",
    "FencedWriteError",
    "enabled",
    "enable",
    "disable",
    "rank",
    "world_size",
    "coordinator",
    "current_epoch",
    "elastic",
]

ENV_VAR = "PENCILARRAYS_TPU_CLUSTER"
RANK_VAR = "PENCILARRAYS_TPU_CLUSTER_RANK"
WORLD_VAR = "PENCILARRAYS_TPU_CLUSTER_WORLD"
LEASE_TTL_VAR = "PENCILARRAYS_TPU_CLUSTER_LEASE_TTL"
LEASE_INTERVAL_VAR = "PENCILARRAYS_TPU_CLUSTER_LEASE_INTERVAL"
JOIN_GRACE_VAR = "PENCILARRAYS_TPU_CLUSTER_JOIN_GRACE"
VERDICT_TIMEOUT_VAR = "PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT"

DEFAULT_LEASE_TTL = 15.0
DEFAULT_VERDICT_TIMEOUT = 120.0

_OFF_VALUES = ("", "0", "off", "false")

_lock = threading.Lock()
_override: Optional[object] = None   # programmatic Coordinator (or False)
_coord = None                        # env-built Coordinator singleton
_coord_key = None                    # (env value, rank, world) it was built for


def _env_value() -> str:
    from ..engine import config as _rtc

    return _rtc.current().cluster_env


def enabled() -> bool:
    """THE gate: one cached snapshot probe on the disabled path (no
    coordinator is built, no thread started, nothing allocated unless
    this is True).  Off tokens match case-insensitively (``OFF`` is
    off, not a FileKV directory named ``OFF``)."""
    if _override is not None:
        return _override is not False
    from ..engine import config as _rtc

    return _rtc.current().cluster_on


def rank() -> int:
    """This process's mesh rank: the ``PENCILARRAYS_TPU_CLUSTER_RANK``
    override (the FileKV drill identity), else the default process
    group's rank, else 0.  THE one identity-resolution rule — the
    ``%rank`` fault selector and obs journal attribution delegate
    here."""
    from ..engine import config as _rtc

    r = _rtc.current().cluster_rank
    if r is not None:
        return r
    return _dist_identity()[0]


def world_size() -> int:
    """Mesh size under the same resolution order as :func:`rank`."""
    from ..engine import config as _rtc

    w = _rtc.current().cluster_world
    if w is not None:
        return w
    return _dist_identity()[1]


def _dist_identity():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def lease_ttl() -> float:
    from ..engine import config as _rtc

    return _rtc.current().lease_ttl


def lease_interval() -> Optional[float]:
    from ..engine import config as _rtc

    return _rtc.current().lease_interval


def join_grace() -> Optional[float]:
    """Override for the never-joined window (``None``: the lease
    board's ``max(2*ttl, 20s)`` default) — raise it on pods whose
    containers start far apart, without inflating ``ttl`` (which would
    also slow real-death detection).  Parsing lives in
    ``engine/config.py`` with every other runtime knob."""
    from ..engine import config as _rtc

    return _rtc.current().join_grace


def verdict_timeout() -> float:
    from ..engine import config as _rtc

    return _rtc.current().verdict_timeout


def coordinator():
    """The process's active :class:`~pencilarrays_tpu_torch.cluster.
    consensus.Coordinator`, or ``None`` when the layer is off *or* the mesh is a
    single process (the degrade-to-local contract).  Built lazily on
    first use (starting the heartbeat), rebuilt if the gate value or
    identity changes (workers arm late, like faults/obs), and cheap on
    the disabled path — one env probe, no locking."""
    global _coord, _coord_key
    if _override is not None:
        return _override or None     # False -> disabled -> None
    env = _env_value()
    if env.strip().lower() in _OFF_VALUES:
        return None
    r, w = rank(), world_size()
    if w <= 1:
        return None                  # degrade to the local ladder
    key = (env, r, w)
    with _lock:
        if _coord is not None and _coord_key == key:
            return _coord
        if _coord is not None:
            _coord.shutdown()
        from .consensus import Coordinator
        from .kv import resolve_kv

        _coord = Coordinator(resolve_kv(env), r, w,
                             lease_ttl=lease_ttl(),
                             lease_interval=lease_interval(),
                             join_grace=join_grace(),
                             verdict_timeout=verdict_timeout())
        _coord_key = key
        return _coord


def enable(coordinator_obj) -> None:
    """Programmatic arm: install an explicit ``Coordinator`` (tests
    build thread-local ones over a shared ``FileKV``); wins over the
    environment until :func:`disable`.  Any env-built coordinator is
    shut down first — its heartbeat must not keep renewing a lease in
    a namespace nobody coordinates over anymore."""
    global _override, _coord, _coord_key
    with _lock:
        if _coord is not None and _coord is not coordinator_obj:
            _coord.shutdown()
            _coord = None
            _coord_key = None
        _override = coordinator_obj


def disable() -> None:
    """Programmatic disarm: wins over the environment until the next
    :func:`enable` (the running heartbeat of an env-built coordinator,
    if any, is stopped)."""
    global _override, _coord, _coord_key
    with _lock:
        _override = False
        if _coord is not None:
            _coord.shutdown()
        _coord = None
        _coord_key = None


def _reset_for_tests() -> None:
    """Full gate reset (tests toggle env/overrides between cases).
    An installed reformed coordinator (elastic) counts as an override
    and is shut down; elastic membership/registry state is cleared so
    reformation drills cannot leak generations into later tests."""
    global _override, _coord, _coord_key
    with _lock:
        if _override is not None and _override is not False:
            try:
                _override.shutdown()
            except Exception:
                pass
        _override = None
        if _coord is not None:
            _coord.shutdown()
        _coord = None
        _coord_key = None
    from . import elastic as _elastic
    from . import epoch as _epoch

    _epoch._reset_for_tests()
    _elastic._reset_for_tests()


def current_epoch() -> int:
    """The recovery epoch (see :mod:`~pencilarrays_tpu_torch.cluster.
    epoch`)."""
    from . import epoch as _epoch

    return _epoch.current()


# elastic mesh reformation (import-light: the gate is one env probe and
# nothing heavy loads until a reformation actually runs)
from . import elastic  # noqa: E402,F401
