"""RuntimeConfig: one snapshot of every env-gated runtime knob (a copy of
the JAX package's ``engine/config.py``, with the same variable names, so
one environment arms both packages alike).

:class:`RuntimeConfig` holds every ``PENCILARRAYS_TPU_*`` knob as a typed
field, :meth:`RuntimeConfig.resolve` reads the environment once, and
:func:`current` keeps one process-global snapshot that re-resolves only
when a watched variable changes (a worker that arms observability after
import is picked up at the next probe).  An
:class:`~pencilarrays_tpu_torch.engine.Engine` captures ``current()`` once
at construction and reads its own frozen snapshot on the hot path;
re-arming it is an explicit :meth:`~pencilarrays_tpu_torch.engine.Engine.
reform`.  Fault injection (``resilience/faults.py``) keeps its own
per-call read by design.  Knobs of layers the port has not reached yet
(guard, cluster leases, elastic, fleet) parse as in the JAX package so
that a snapshot compares field by field.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["RuntimeConfig", "current", "WATCHED_VARS",
           "ENGINE_WORKERS_VAR", "ENGINE_QUIESCE_VAR",
           "ENGINE_DAG_VAR", "ENGINE_STARVE_VAR"]

ENGINE_WORKERS_VAR = "PENCILARRAYS_TPU_ENGINE_WORKERS"
ENGINE_QUIESCE_VAR = "PENCILARRAYS_TPU_ENGINE_QUIESCE_S"
ENGINE_DAG_VAR = "PENCILARRAYS_TPU_ENGINE_DAG"
ENGINE_STARVE_VAR = "PENCILARRAYS_TPU_ENGINE_STARVE_S"

# gate off-tokens: guard/obs match exactly (an env value of "OFF" is a
# bundle/journal *directory* for them), cluster/elastic case-fold
_OFF = ("", "0", "off", "false")

# every variable a snapshot depends on — current() re-resolves when any
# of these changes value (the late-arming contract, centralized)
WATCHED_VARS: Tuple[str, ...] = (
    # guard/
    "PENCILARRAYS_TPU_GUARD",
    "PENCILARRAYS_TPU_GUARD_DIR",
    "PENCILARRAYS_TPU_GUARD_TIMEOUT",
    "PENCILARRAYS_TPU_GUARD_RTOL",
    "PENCILARRAYS_TPU_GUARD_WIRE_RTOL",
    "PENCILARRAYS_TPU_GUARD_FINITE",
    # obs/
    "PENCILARRAYS_TPU_OBS",
    "PENCILARRAYS_TPU_OBS_DIR",
    "PENCILARRAYS_TPU_OBS_FSYNC",
    "PENCILARRAYS_TPU_OBS_MAX_MB",
    "PENCILARRAYS_TPU_OBS_AGG_S",
    # cluster/
    "PENCILARRAYS_TPU_CLUSTER",
    "PENCILARRAYS_TPU_CLUSTER_RANK",
    "PENCILARRAYS_TPU_CLUSTER_WORLD",
    "PENCILARRAYS_TPU_CLUSTER_LEASE_TTL",
    "PENCILARRAYS_TPU_CLUSTER_LEASE_INTERVAL",
    "PENCILARRAYS_TPU_CLUSTER_JOIN_GRACE",
    "PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT",
    # cluster/elastic.py
    "PENCILARRAYS_TPU_ELASTIC",
    "PENCILARRAYS_TPU_ELASTIC_TIMEOUT",
    "PENCILARRAYS_TPU_ELASTIC_ROUNDS",
    "PENCILARRAYS_TPU_ELASTIC_MIN_WORLD",
    "PENCILARRAYS_TPU_ELASTIC_JOIN_TIMEOUT",
    "PENCILARRAYS_TPU_ELASTIC_QUORUM",
    # fleet/
    "PENCILARRAYS_TPU_FLEET_WAL_MAX_MB",
    # engine/
    ENGINE_WORKERS_VAR,
    ENGINE_QUIESCE_VAR,
    ENGINE_DAG_VAR,
    ENGINE_STARVE_VAR,
)

# ``current()`` probes every watched var on EVERY call — it sits under
# ``obs.enabled()``/``guard`` gates on per-dispatch hot paths.
# ``os.environ.get`` pays a raised-and-caught KeyError per MISSING var
# (Mapping.get over __getitem__), which at 27 mostly-unset vars is
# tens of microseconds per probe.  Probing the backing dict with its
# encoded keys is exception-free and ~15x cheaper; the values are only
# compared for equality, so bytes vs str never matters.  Falls back to
# the portable path when the private mapping is absent (non-CPython).
try:
    _ENV_DATA = os.environ._data
    _ENC_KEYS: Tuple = tuple(
        os.environ.encodekey(v) for v in WATCHED_VARS)

    def _env_key() -> Tuple:
        d = _ENV_DATA
        return tuple(d.get(k) for k in _ENC_KEYS)

    # one import-time probe: a mutation through os.environ must be
    # visible to the fast path, or a late-armed var would silently
    # never re-resolve — on any disagreement fall back wholesale
    _k, _saved = WATCHED_VARS[0], os.environ.get(WATCHED_VARS[0])
    os.environ[_k] = "_pa_cfg_probe"
    _seen = _ENV_DATA.get(os.environ.encodekey(_k))
    if _saved is None:
        del os.environ[_k]
    else:
        os.environ[_k] = _saved
    if _seen != os.environ.encodevalue("_pa_cfg_probe"):
        raise AttributeError("os.environ._data not authoritative")
except (AttributeError, TypeError, KeyError):
    def _env_key() -> Tuple:
        return tuple(os.environ.get(v) for v in WATCHED_VARS)


def _float(raw: Optional[str], default: float) -> float:
    try:
        return float(raw) if raw is not None else default
    except ValueError:
        return default


def _opt_float(raw: Optional[str]) -> Optional[float]:
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


def _opt_int(raw: Optional[str]) -> Optional[int]:
    try:
        return int(raw) if raw is not None else None
    except ValueError:
        return None


@dataclass(frozen=True)
class RuntimeConfig:
    """Typed snapshot of every env-gated runtime knob (module
    docstring).  Frozen: an engine holds one for its whole generation;
    a changed environment produces a NEW snapshot, never a mutation."""

    # guard/ — raw gate value kept because a non-"1" on-value IS the
    # crash-bundle directory (guard.bundle_dir()'s contract)
    guard_env: str = ""
    guard_on: bool = False
    guard_dir_env: str = "pa_guard"
    guard_timeout: float = 300.0
    guard_rtol: Optional[float] = None
    guard_wire_rtol: Optional[float] = None
    guard_finite_every: int = 0
    # obs/ — same raw-value convention (the value can be the journal dir)
    obs_env: str = ""
    obs_on: bool = False
    obs_dir_env: str = "pa_obs"
    obs_fsync: str = "critical"
    obs_max_bytes: Optional[int] = None
    obs_agg_cadence: float = 10.0
    # cluster/
    cluster_env: str = ""
    cluster_on: bool = False
    cluster_rank: Optional[int] = None
    cluster_world: Optional[int] = None
    lease_ttl: float = 15.0
    lease_interval: Optional[float] = None
    join_grace: Optional[float] = None
    verdict_timeout: float = 120.0
    # cluster/elastic.py
    elastic_on: bool = False
    elastic_timeout: float = 60.0
    elastic_rounds: int = 8
    elastic_min_world: int = 1
    elastic_join_timeout: float = 600.0
    # the split-brain gate — default ON; "0"/"off"/"false" disables the
    # strict-majority requirement (the documented escape hatch for an
    # intentional shrink below majority)
    elastic_quorum: bool = True
    # fleet/ — router WAL segment rotation threshold (None = no cap)
    fleet_wal_max_bytes: Optional[int] = None
    # engine/
    engine_workers: int = 2
    engine_quiesce_s: float = 30.0
    # out-of-order issue among resource-disjoint tasks — default ON;
    # "0"/"off"/"false" restores the v1 strict total order (the
    # multi-controller escape hatch: cross-chain issue order is a
    # property of THIS process's single consumer, not of the fleet)
    engine_dag: bool = True
    # lane-starvation bound: a queued task older than this issues next
    # regardless of lane or pack readiness
    engine_starve_s: float = 1.0

    @classmethod
    def resolve(cls, environ=None) -> "RuntimeConfig":
        """Parse one snapshot from ``environ`` (default
        ``os.environ``).  Pure: no caching, no side effects — the unit
        the tests pin each knob's semantics against."""
        env = os.environ if environ is None else environ
        g = env.get

        guard_env = g("PENCILARRAYS_TPU_GUARD", "")
        obs_env = g("PENCILARRAYS_TPU_OBS", "")
        cluster_env = g("PENCILARRAYS_TPU_CLUSTER", "")

        max_mb = _opt_float(g("PENCILARRAYS_TPU_OBS_MAX_MB"))
        wal_mb = _opt_float(g("PENCILARRAYS_TPU_FLEET_WAL_MAX_MB"))
        rounds = _opt_int(g("PENCILARRAYS_TPU_ELASTIC_ROUNDS"))
        min_world = _opt_int(g("PENCILARRAYS_TPU_ELASTIC_MIN_WORLD"))
        finite = _opt_int(g("PENCILARRAYS_TPU_GUARD_FINITE"))
        workers = _opt_int(g(ENGINE_WORKERS_VAR))

        return cls(
            guard_env=guard_env,
            guard_on=guard_env not in _OFF,
            guard_dir_env=g("PENCILARRAYS_TPU_GUARD_DIR", "pa_guard"),
            guard_timeout=_float(g("PENCILARRAYS_TPU_GUARD_TIMEOUT"),
                                 300.0),
            guard_rtol=_opt_float(g("PENCILARRAYS_TPU_GUARD_RTOL")),
            guard_wire_rtol=_opt_float(
                g("PENCILARRAYS_TPU_GUARD_WIRE_RTOL")),
            guard_finite_every=max(0, finite if finite is not None else 0),
            obs_env=obs_env,
            obs_on=obs_env not in _OFF,
            obs_dir_env=g("PENCILARRAYS_TPU_OBS_DIR", "pa_obs"),
            obs_fsync=g("PENCILARRAYS_TPU_OBS_FSYNC", "critical"),
            obs_max_bytes=(int(max_mb * 1024 * 1024)
                           if max_mb is not None and max_mb > 0 else None),
            obs_agg_cadence=_float(g("PENCILARRAYS_TPU_OBS_AGG_S"), 10.0),
            cluster_env=cluster_env,
            cluster_on=cluster_env.strip().lower() not in _OFF,
            cluster_rank=_opt_int(g("PENCILARRAYS_TPU_CLUSTER_RANK")),
            cluster_world=_opt_int(g("PENCILARRAYS_TPU_CLUSTER_WORLD")),
            lease_ttl=_float(g("PENCILARRAYS_TPU_CLUSTER_LEASE_TTL"),
                             15.0),
            lease_interval=_opt_float(
                g("PENCILARRAYS_TPU_CLUSTER_LEASE_INTERVAL")),
            join_grace=_opt_float(
                g("PENCILARRAYS_TPU_CLUSTER_JOIN_GRACE")),
            verdict_timeout=_float(
                g("PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT"), 120.0),
            elastic_on=(g("PENCILARRAYS_TPU_ELASTIC", "")
                        .strip().lower() not in _OFF),
            elastic_timeout=_float(
                g("PENCILARRAYS_TPU_ELASTIC_TIMEOUT"), 60.0),
            elastic_rounds=max(1, rounds if rounds is not None else 8),
            elastic_min_world=max(
                1, min_world if min_world is not None else 1),
            elastic_join_timeout=_float(
                g("PENCILARRAYS_TPU_ELASTIC_JOIN_TIMEOUT"), 600.0),
            elastic_quorum=(g("PENCILARRAYS_TPU_ELASTIC_QUORUM", "")
                            .strip().lower()
                            not in ("0", "off", "false")),
            fleet_wal_max_bytes=(int(wal_mb * 1024 * 1024)
                                 if wal_mb is not None and wal_mb > 0
                                 else None),
            engine_workers=max(1, workers if workers is not None else 2),
            engine_quiesce_s=_float(g(ENGINE_QUIESCE_VAR), 30.0),
            engine_dag=(g(ENGINE_DAG_VAR, "")
                        .strip().lower() not in ("0", "off", "false")),
            engine_starve_s=max(0.0, _float(g(ENGINE_STARVE_VAR), 1.0)),
        )


_lock = threading.Lock()
# ONE atomic (key, config) pair: readers take no lock — the pair is
# replaced wholesale, both halves are immutable, and the hot callers
# (obs.enabled()/guard.enabled() on every instrumented call, from the
# engine consumer, pool workers and client threads at once) must not
# serialize on a process-global lock just to read a cached snapshot
_cache_pair: Optional[Tuple[Tuple[Optional[str], ...],
                            RuntimeConfig]] = None


def current() -> RuntimeConfig:
    """The process-global snapshot, re-resolved when any watched env
    var changed since the last probe (the centralized late-arming
    contract).  Steady path: one tuple of getenv reads, one compare,
    no lock."""
    global _cache_pair
    key = _env_key()
    pair = _cache_pair
    if pair is not None and pair[0] == key:
        return pair[1]
    with _lock:
        pair = _cache_pair
        if pair is not None and pair[0] == key:
            return pair[1]
        cfg = RuntimeConfig.resolve()
        _cache_pair = (key, cfg)
        return cfg


def _reset_for_tests() -> None:
    """Drop the snapshot cache (tests toggle env vars between cases)."""
    global _cache_pair
    with _lock:
        _cache_pair = None
