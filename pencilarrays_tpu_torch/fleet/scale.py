"""Fleet-level scaling: the joiner-spawning supervisor.

The per-mesh :class:`~pencilarrays_tpu_torch.serve.autoscale.Autoscaler`
deliberately stops at *signaling*: when its windowed controller wants
capacity but no joiner is pending, it journals ``serve.scale`` with
``acted=false, detail="no-joiner"`` — a demand signal with nobody
listening.  :class:`FleetSupervisor` is the listener: it consumes
those journaled signals (and live
:class:`~pencilarrays_tpu_torch.serve.autoscale.ScaleDecision` objects) and
— behind an explicit flag — actually launches mesh workers through a
caller-provided ``spawn`` callback, graduating the autoscaler from
grow-my-mesh to fleet-level placement.

Spawning real capacity is a deployment decision, so it is **flagged**:
pass ``enabled=True`` or set ``PENCILARRAYS_TPU_FLEET_SPAWN=1``; when
the flag is off the supervisor still journals every demand signal it
saw (``fleet.scale`` with ``acted=false``) so a dry-run drill shows
exactly what WOULD have been launched.  Every consumed signal is
deduplicated by its journal identity ``(proc, seq)`` — replaying a
journal never double-spawns — and spawns are rate-limited by
``cooldown_s`` and capped at ``max_meshes``.

Scale-down is :meth:`retire`: a stop signal on the mesh's wire key;
the worker sees it at its next poll, publishes a durable leave record
(clean departure, no failure alarm) and exits — the router re-binds
any in-flight tickets exactly as in failover, minus the alarm.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

from . import wire

__all__ = ["FleetSupervisor", "SPAWN_VAR"]

SPAWN_VAR = "PENCILARRAYS_TPU_FLEET_SPAWN"


def _flag_enabled() -> bool:
    return os.environ.get(SPAWN_VAR, "").strip().lower() in (
        "1", "on", "true")


class FleetSupervisor:
    """Consumes ``acted=false`` demand signals; launches workers."""

    def __init__(self, *, spawn: Callable[[int], object],
                 enabled: Optional[bool] = None,
                 cooldown_s: float = 5.0, max_meshes: int = 8,
                 next_mesh: int = 1, kv=None, namespace: str = "pa"):
        self.spawn = spawn
        self._enabled = enabled
        self.cooldown_s = float(cooldown_s)
        self.max_meshes = int(max_meshes)
        self.kv = kv
        self.ns = namespace
        self._lock = threading.Lock()
        self._next_mesh = int(next_mesh)
        self._spawned: List[int] = []
        self._retired: List[int] = []
        self._seen: set = set()     # (proc, seq) of consumed signals
        self._t_last_spawn = 0.0

    @property
    def enabled(self) -> bool:
        return self._enabled if self._enabled is not None \
            else _flag_enabled()

    @property
    def spawned(self) -> List[int]:
        with self._lock:
            return list(self._spawned)

    # -- the demand-signal consumer ----------------------------------------
    def _is_demand(self, record: dict) -> bool:
        return (record.get("direction") == "up"
                and not record.get("acted")
                and record.get("detail") == "no-joiner")

    def observe(self, record: dict) -> bool:
        """One ``serve.scale``-shaped record (a journal line or a
        ``ScaleDecision.__dict__``).  Returns True when a worker was
        actually launched."""
        from .. import obs

        if not self._is_demand(record):
            return False
        reason = record.get("reason", "demand")
        if not self.enabled:
            if obs.enabled():
                obs.record_event("fleet.scale", action="spawn",
                                 reason=reason, acted=False,
                                 detail="flag-off")
            return False
        now = time.monotonic()
        with self._lock:
            if now - self._t_last_spawn < self.cooldown_s:
                skip = "cooldown"
            elif len(self._spawned) >= self.max_meshes:
                skip = "at-capacity"
            else:
                skip = None
                self._t_last_spawn = now
                mesh = self._next_mesh
                self._next_mesh += 1
                self._spawned.append(mesh)
        if skip is not None:
            if obs.enabled():
                obs.record_event("fleet.scale", action="spawn",
                                 reason=reason, acted=False,
                                 detail=skip)
            return False
        if obs.enabled():
            obs.record_event("fleet.scale", action="spawn",
                             reason=reason, acted=True, mesh=mesh,
                             _fsync=True)
        self.spawn(mesh)
        return True

    def scan(self, journal_dir: Optional[str] = None) -> int:
        """Consume every un-seen journaled demand signal under
        ``journal_dir`` (default: the active journal).  Idempotent:
        signals are deduplicated by ``(proc, seq)``, so replaying the
        same journal never double-spawns.  Returns launches."""
        from ..obs.events import read_journal

        launched = 0
        for e in read_journal(journal_dir):
            if e.get("ev") != "serve.scale":
                continue
            key = (e.get("proc"), e.get("seq"))
            with self._lock:
                if key in self._seen:
                    continue
                self._seen.add(key)
            if self.observe(e):
                launched += 1
        return launched

    # -- scale-down ---------------------------------------------------------
    def retire(self, mesh: int) -> None:
        """Publish the mesh's stop signal (needs ``kv``); the worker
        leaves cleanly at its next poll."""
        from .. import obs

        if self.kv is None:
            raise ValueError("retire() needs the supervisor's kv")
        # kv-unfenced: idempotent single-writer retire signal — the
        # supervisor owns the stop keys; re-writing "stop" is harmless
        self.kv.set(wire.stop_key(self.ns, mesh), "stop")
        with self._lock:
            self._retired.append(mesh)
        if obs.enabled():
            obs.record_event("fleet.scale", action="retire",
                             reason="supervisor", mesh=mesh,
                             _fsync=True)

    def stats(self) -> dict:
        with self._lock:
            return {"spawned": list(self._spawned),
                    "retired": list(self._retired),
                    "signals_seen": len(self._seen),
                    "enabled": self.enabled}
