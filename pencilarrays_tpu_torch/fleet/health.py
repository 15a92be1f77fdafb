"""Mesh health leases — whole-mesh death detection over the KV wire.

:class:`~pencilarrays_tpu_torch.cluster.health.LeaseBoard` generalized from
rank to MESH granularity: each back-end mesh runs ONE
:class:`MeshLease` heartbeat (its coordinator process renews it), and
the fleet router runs ONE :class:`MeshBoard` checker across all of
them.  A SIGKILLed or wedged mesh — coordinator dead, KV namespace
unreachable from inside, whole slice preempted — is detected in ~ttl
seconds as a typed, attributed
:class:`~pencilarrays_tpu_torch.fleet.errors.MeshFailureError`, which the
router turns into failover, never into a client-visible error.

Two deliberate departures from the rank board:

* **Sequence-numbered beats with one-round-lag GC.**  A renewal
  writes a fresh ``beat/m<k>/b<n>`` key and deletes ``b<n-2>`` — the
  same discipline as PR-6 consensus rounds: the previous beat is kept
  one round so a reader mid-listing never sees an empty directory on
  a live mesh (StoreKV renews via delete+set; an overwritten single key
  has a read-nothing window).  A fleet that heartbeats for a week
  holds <= 2 live beat keys per mesh — the KV store cannot grow
  unboundedly (regression-counted in ``tests/test_fleet.py``).
* **Collect, don't abort.**  :meth:`MeshBoard.dead_meshes` returns
  every newly-dead mesh as a typed error *value* so the router can
  fail over all of them in one sweep; :meth:`MeshBoard.check` keeps
  the raise-first semantics for callers that want the rank-board
  contract.

Wall-clock caveats and ttl tuning are identical to the rank board —
see ``docs/Fleet.md``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

from . import wire
from .errors import MeshFailureError, MeshLeftError

__all__ = ["MeshLease", "MeshBoard"]


class MeshLease:
    """One mesh's heartbeat publisher (run by the mesh's worker/
    coordinator process)."""

    def __init__(self, kv, mesh: int, *, ttl: float,
                 interval: Optional[float] = None,
                 namespace: str = "pa"):
        self.kv = kv
        self.mesh = int(mesh)
        self.ttl = float(ttl)
        self.interval = float(interval) if interval else max(
            0.05, self.ttl / 3.0)
        self.ns = namespace
        self._stop = threading.Event()
        self._thread = None
        self._n = 0

    def renew(self) -> None:
        """Publish beat ``n`` and GC beat ``n-2`` (one-round lag: the
        previous beat stays readable while this one lands)."""
        self._n += 1
        # kv-unfenced: this mesh's own liveness beat — the evidence
        # the router's failover detection reads; per-mesh keys only
        self.kv.set(wire.beat_key(self.ns, self.mesh, self._n),
                    json.dumps({"t": time.time(), "pid": os.getpid(),
                                "n": self._n}))
        if self._n >= 3:
            # kv-unfenced: GC of this mesh's own stale beat
            self.kv.delete(wire.beat_key(self.ns, self.mesh,
                                         self._n - 2))

    @property
    def renewals(self) -> int:
        return self._n

    def start(self) -> None:
        """Publish the first beat synchronously (the router must see
        this mesh as alive the moment its worker exists), then renew
        from a daemon thread every ``interval`` seconds."""
        if self._thread is not None:
            return
        self.renew()
        from .. import obs

        if obs.enabled():
            obs.record_event("fleet.lease", mesh=self.mesh,
                             status="acquired", ttl_s=self.ttl,
                             interval_s=self.interval)
        from ..engine.threads import spawn_thread

        self._thread = spawn_thread(
            self._loop, name=f"pa-fleet-lease-m{self.mesh}")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.renew()
            except Exception:   # pragma: no cover - KV weather must not
                pass            # kill the heartbeat; the next tick retries

    def stop(self) -> None:
        """Stop renewing: the lease then expires naturally after
        ``ttl`` (no 'release' — a vanished beat is indistinguishable
        from a crash, so expiry is the one signal)."""
        self._stop.set()

    def leave(self) -> None:
        """Graceful departure: publish the durable leave record BEFORE
        the lease can lapse, then stop.  The router surfaces this mesh
        as :class:`MeshLeftError` — planned scale-down, its pending
        tickets re-bind without a failure alarm."""
        from .. import obs

        # kv-unfenced: own departure record (planned scale-down)
        self.kv.set(wire.left_key(self.ns, self.mesh),
                    json.dumps({"t": time.time(), "pid": os.getpid()}))
        if obs.enabled():
            obs.record_event("fleet.lease", mesh=self.mesh,
                             status="left", ttl_s=self.ttl)
        self.stop()


class MeshBoard:
    """The router-side expiry detector across every registered mesh."""

    def __init__(self, kv, *, ttl: float,
                 join_grace: Optional[float] = None,
                 namespace: str = "pa"):
        self.kv = kv
        self.ttl = float(ttl)
        # same floor rationale as the rank board: a mesh that has not
        # published ANY beat may still be importing torch
        self.join_grace = (float(join_grace) if join_grace
                           else max(2 * self.ttl, 20.0))
        self.ns = namespace
        self._start = time.time()
        # last successfully READ beat timestamp per mesh: a transiently
        # unreadable beat (mid-GC listing) must not fabricate a death
        self._last_seen: Dict[int, float] = {}
        self._left: set = set()

    def mesh_age(self, mesh: int, now: Optional[float] = None
                 ) -> Optional[float]:
        """Seconds since ``mesh``'s last KNOWN beat; None when never
        seen.  Reads the newest live beat key; a failed or torn read
        falls back to the remembered timestamp."""
        beats = self.kv.list_dir(wire.beat_dir(self.ns, mesh))
        if beats:
            newest = max(beats)     # zero-padded keys: lexical = numeric
            try:
                self._last_seen[mesh] = float(
                    json.loads(beats[newest])["t"])
            except (ValueError, KeyError, TypeError):
                pass
        t = self._last_seen.get(mesh)
        if t is None:
            return None
        return (time.time() if now is None else now) - t

    def mesh_left(self, mesh: int) -> bool:
        """Did ``mesh`` publish a clean-departure record?  (cached —
        a leave never un-happens within one namespace)"""
        if mesh in self._left:
            return True
        if self.kv.try_get(wire.left_key(self.ns, mesh)) is not None:
            self._left.add(mesh)
            return True
        return False

    def dead_meshes(self, meshes: Iterable[int]
                    ) -> List[Tuple[int, Union[MeshFailureError,
                                               MeshLeftError]]]:
        """Every mesh in ``meshes`` whose lease is expired (or that
        never joined within ``join_grace``), as ``(mesh, typed error)``
        pairs — journaled ``fleet.lease`` fsync-critically per death
        (the record must survive whatever failover does next)."""
        from .. import obs

        now = time.time()
        out: List[Tuple[int, Union[MeshFailureError, MeshLeftError]]] = []
        for mesh in meshes:
            age = self.mesh_age(mesh, now)
            if age is None:
                if now - self._start <= self.join_grace:
                    continue    # join grace: the mesh may still be booting
            elif age <= self.ttl:
                continue
            if self.mesh_left(mesh):
                err: Union[MeshFailureError, MeshLeftError] = \
                    MeshLeftError(
                        f"mesh {mesh} left the fleet cleanly "
                        f"(fleet leave record found)", mesh=mesh)
                status = "left"
            else:
                what = (f"lease expired ({age:.2f}s old > ttl "
                        f"{self.ttl:.2f}s)" if age is not None
                        else f"never joined within the "
                             f"{self.join_grace:.2f}s grace window")
                err = MeshFailureError(
                    f"mesh {mesh} is gone: {what}", mesh=mesh,
                    age_s=age)
                status = "expired"
            if obs.enabled():
                if status == "expired":
                    obs.counter("fleet.mesh_failures").inc()
                obs.record_event("fleet.lease", mesh=mesh,
                                 status=status, age_s=age,
                                 ttl_s=self.ttl, _fsync=True)
            out.append((mesh, err))
        return out

    def check(self, meshes: Iterable[int]) -> None:
        """Raise the first dead mesh's typed error (the rank-board
        contract, for callers outside the router's failover sweep)."""
        dead = self.dead_meshes(meshes)
        if dead:
            raise dead[0][1]

    def live_meshes(self, meshes: Iterable[int],
                    now: Optional[float] = None) -> List[int]:
        """The subset of ``meshes`` with a fresh (``<= ttl``) beat and
        no leave record — the candidate set placement scores over.
        Never-seen meshes are excluded (a booting mesh enters through
        its first beat, not by being presumed alive)."""
        now = time.time() if now is None else now
        live = []
        for mesh in meshes:
            if self.mesh_left(mesh):
                continue
            age = self.mesh_age(mesh, now)
            if age is not None and age <= self.ttl:
                live.append(mesh)
        return sorted(live)
