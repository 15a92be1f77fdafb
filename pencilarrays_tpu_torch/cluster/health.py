"""Peer health leases — dead-rank detection without a collective (the JAX
package's ``cluster/health.py``).

A SIGKILLed or wedged peer does not raise anywhere: the survivors'
next collective simply never completes, and only the (five-minute)
hang watchdog eventually names the symptom, not the cause.  The lease
board turns peer death into a *typed, attributed* failure within
seconds:

* every rank runs a daemon **heartbeat thread** renewing its own
  ``lease/r<rank>`` KV record (wall timestamp + pid + epoch) every
  ``interval`` seconds;
* :meth:`LeaseBoard.check_peers` — called before each guarded step and
  between consensus polls — reads the peers' leases; a lease older
  than ``ttl`` (or a peer that never appeared within the join grace
  window) raises
  :class:`~pencilarrays_tpu_torch.cluster.errors.PeerFailureError` naming
  the dead rank, after journaling ``cluster.lease`` (fsync-critical),
  bumping ``cluster.peer_failures`` and writing a crash bundle.

Leases use *wall-clock* timestamps (the KV store has no server-side
clock), so ``ttl`` must comfortably exceed cross-host clock skew plus
one renewal interval.  The board
never auto-removes leases: a KV namespace is one job incarnation, and
drills/tests give each phase a fresh namespace.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .errors import PeerFailureError, PeerLeftError

__all__ = ["LeaseBoard"]


class LeaseBoard:
    """Heartbeat + expiry detection over a KV backend (one per
    :class:`~pencilarrays_tpu_torch.cluster.consensus.Coordinator`)."""

    def __init__(self, kv, rank: int, world: int, *,
                 ttl: float, interval: Optional[float] = None,
                 join_grace: Optional[float] = None,
                 namespace: str = "pa"):
        self.kv = kv
        self.rank = int(rank)
        self.world = int(world)
        self.ttl = float(ttl)
        self.interval = float(interval) if interval else max(
            0.05, self.ttl / 3.0)
        self.ns = namespace
        # a peer that has not published ANY lease yet may simply still
        # be importing torch: give it a generous join window (floored, so
        # a drill's tiny ttl does not turn staggered worker boot into a
        # false positive; tunable for pods whose containers start far
        # apart — PENCILARRAYS_TPU_CLUSTER_JOIN_GRACE); once it HAS a
        # lease, ttl alone governs
        self.join_grace = (float(join_grace) if join_grace
                           else max(2 * self.ttl, 20.0))
        self._start = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._renewals = 0
        # last successfully READ renewal timestamp per peer: one
        # transiently unreadable lease (KV weather, or a delete+set
        # renewal caught mid-flight) must not read as death —
        # staleness is judged against the last KNOWN renewal, and
        # "never joined" only ever fires for a peer we have never seen
        self._last_seen: dict = {}
        # ranks with a published cluster.leave record: a clean departure
        # is remembered (a leave never un-happens within one namespace),
        # and each is journaled as an observed departure exactly once
        self._left: set = set()
        self._left_journaled: set = set()

    def _key(self, rank: int) -> str:
        return f"{self.ns}/lease/r{rank}"

    def _leave_key(self, rank: int) -> str:
        return f"{self.ns}/leave/r{rank}"

    # -- heartbeat ---------------------------------------------------------
    def renew(self) -> None:
        """Publish/refresh this rank's lease (one KV set)."""
        from . import epoch

        self._renewals += 1
        # kv-unfenced: the lease IS the liveness evidence the quorum
        # gate reads — fencing it would blind the majority to exactly
        # the rank it must evict; a zombie's heartbeat only keeps its
        # own per-rank key fresh, it cannot overwrite anyone's state
        self.kv.set(self._key(self.rank), json.dumps({
            "t": time.time(), "pid": os.getpid(),
            "epoch": epoch.current(), "n": self._renewals}))

    def start(self) -> None:
        """Publish the first lease synchronously (peers must see this
        rank as alive the moment the coordinator exists), then renew
        from a daemon thread every ``interval`` seconds."""
        if self._thread is not None:
            return
        self.renew()
        from .. import obs

        if obs.enabled():
            obs.record_event("cluster.lease", rank=self.rank,
                             status="acquired", ttl_s=self.ttl,
                             interval_s=self.interval)
        from ..engine.threads import spawn_thread

        self._thread = spawn_thread(self._loop,
                                    name=f"pa-cluster-lease-r{self.rank}")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.renew()
            except Exception:   # pragma: no cover - KV weather must not
                pass            # kill the heartbeat; the next tick retries

    def stop(self) -> None:
        """Stop renewing (the lease then expires naturally after
        ``ttl`` — there is deliberately no 'release': a vanished key is
        indistinguishable from a crash, so expiry is the one signal)."""
        self._stop.set()

    def leave(self) -> None:
        """Graceful departure: publish a durable ``leave`` record BEFORE
        the lease can lapse, then stop the heartbeat.  Peers that later
        see this rank's lease expire find the record and surface a typed
        :class:`PeerLeftError` — planned scale-down, no crash bundle, no
        ``cluster.peer_failures`` false alarm — which the elastic layer
        turns into a reformation instead of an abort."""
        from . import epoch
        from .. import obs

        # kv-unfenced: own departure record — gone-evidence for the
        # quorum gate, written exactly when membership is being shed
        self.kv.set(self._leave_key(self.rank), json.dumps({
            "t": time.time(), "pid": os.getpid(),
            "epoch": epoch.current()}))
        if obs.enabled():
            obs.record_event("cluster.member", rank=self.rank,
                             change="leave", world=self.world)
        self.stop()

    def peer_left(self, rank: int) -> bool:
        """Did ``rank`` publish a clean-departure record?  Positive
        answers are cached (a leave is permanent within a namespace)."""
        if rank in self._left:
            return True
        if self.kv.try_get(self._leave_key(rank)) is not None:
            self._left.add(rank)
            return True
        return False

    # -- expiry detection --------------------------------------------------
    def peer_age(self, rank: int, now: Optional[float] = None
                 ) -> Optional[float]:
        """Seconds since ``rank``'s last KNOWN renewal; None when the
        peer has never been seen.  A read that fails or parses badly
        falls back to the remembered renewal timestamp — a dead peer's
        age still grows past ``ttl``, while a single unreadable read of
        a live peer's lease does not fabricate a death."""
        raw = self.kv.try_get(self._key(rank))
        if raw is not None:
            try:
                self._last_seen[rank] = float(json.loads(raw)["t"])
            except (ValueError, KeyError, TypeError):
                pass
        t = self._last_seen.get(rank)
        if t is None:
            return None
        return (time.time() if now is None else now) - t

    def check_peers(self) -> None:
        """Raise :class:`PeerFailureError` if any peer's lease is
        expired (or the peer never joined within ``join_grace`` of this
        board's start).  The error carries a crash bundle; detection is
        journaled fsync-critically *before* the raise so the record
        survives whatever the caller does next."""
        now = time.time()
        for rank in range(self.world):
            if rank == self.rank:
                continue
            age = self.peer_age(rank, now)
            if age is None:
                if now - self._start <= self.join_grace:
                    continue    # join grace: the peer may still be booting
                if self.peer_left(rank):
                    self._peer_departed(rank)
                self._peer_failed(rank, None)
            elif age > self.ttl:
                # an expired lease with a leave record is planned
                # scale-down, not a death: typed PeerLeftError, no
                # crash bundle, no peer_failures counter
                if self.peer_left(rank):
                    self._peer_departed(rank)
                self._peer_failed(rank, age)

    def live_ranks(self, now: Optional[float] = None) -> list:
        """Ranks this board currently believes are members: self, plus
        every peer with a fresh (``<= ttl``) lease and no leave record —
        the local input to the elastic membership consensus.  Peers
        never seen at all are excluded (a booting replacement enters
        through the join path, not by being presumed alive)."""
        now = time.time() if now is None else now
        live = [self.rank]
        for rank in range(self.world):
            if rank == self.rank:
                continue
            if self.peer_left(rank):
                continue
            age = self.peer_age(rank, now)
            if age is not None and age <= self.ttl:
                live.append(rank)
        return sorted(live)

    def _peer_departed(self, rank: int) -> None:
        from .. import obs

        if obs.enabled() and rank not in self._left_journaled:
            self._left_journaled.add(rank)
            obs.record_event("cluster.member", rank=rank, change="left",
                             observed_by=self.rank, world=self.world)
        raise PeerLeftError(
            f"peer rank {rank} left the mesh cleanly (cluster.leave "
            f"record found; observed by rank {self.rank})", rank=rank)

    def _peer_failed(self, rank: int, age: Optional[float]) -> None:
        from .. import obs

        what = (f"lease expired ({age:.2f}s old > ttl {self.ttl:.2f}s)"
                if age is not None
                else f"never joined within the {self.join_grace:.2f}s "
                     f"grace window")
        if obs.enabled():
            obs.counter("cluster.peer_failures").inc()
            obs.record_event("cluster.lease", rank=rank, status="expired",
                             age_s=age, ttl_s=self.ttl,
                             detected_by=self.rank)
        bundle = None
        try:
            from ..guard.bundle import write_crash_bundle

            bundle = write_crash_bundle(
                "peer-failure", f"rank{rank}",
                error=f"peer rank {rank}: {what}",
                extra={"peer_rank": rank, "age_s": age, "ttl_s": self.ttl,
                       "detected_by": self.rank})
        except Exception:   # pragma: no cover - bundle is best-effort
            pass
        raise PeerFailureError(
            f"peer rank {rank} is gone: {what} (detected by rank "
            f"{self.rank}; crash bundle: {bundle or 'unavailable'})",
            rank=rank, age_s=age, bundle=bundle)
