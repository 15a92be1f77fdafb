"""Recovery consensus — one agreed action per step boundary, mesh-wide
(the JAX package's ``cluster/consensus.py``).

The deadlock this module exists to kill: rank 0 detects an
``IntegrityError`` and restores a checkpoint while rank 1 — whose copy
of the step looked fine — blocks forever in the next collective waiting
for a peer that already abandoned it.  Any *one-sided* recovery
decision on a mesh is a deadlock or a divergence; the fix is that
**nobody acts alone**:

1. at the step boundary every rank publishes a small status blob
   (ok / integrity / hang, plus what it *could* do next) under a
   round-numbered KV key — a cheap status allgather, never a bare raise;
2. every rank reads all ``world`` blobs (waits are lease-checked, so a
   dead peer surfaces as :class:`PeerFailureError`, not a stall);
3. every rank runs the same pure :func:`merge_statuses` over the same
   inputs, so the mesh atomically picks ONE action:

   * ``ok`` — nobody failed, proceed;
   * ``retry`` — someone failed and every rank still has retry budget:
     ALL ranks rerun the step (a half-mesh rerun would deadlock its
     collectives);
   * ``restore`` — retry budget exhausted but every rank can restore:
     ALL ranks restore the SAME agreed checkpoint step (elected by
     :meth:`Coordinator.agree_steps` — newest step valid on *every*
     rank) and rerun;
   * ``raise`` — nothing left: ALL ranks raise together (the failing
     ranks their own typed error, the healthy ones
     :class:`ClusterAbortError` naming the failures).

Each non-``ok`` verdict advances the shared recovery epoch
(:mod:`~pencilarrays_tpu_torch.cluster.epoch`) — identically everywhere,
because the advance is a function of the agreed verdict.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from .errors import ConsensusTimeoutError
from .health import LeaseBoard

__all__ = ["Coordinator", "merge_statuses"]


def merge_statuses(statuses: Sequence[dict]) -> dict:
    """THE verdict function: deterministic over the rank-ordered status
    list, run identically by every rank (pure — no clock, no rank
    identity, no I/O).  Status blobs carry ``status`` ("ok" or a
    failure kind), ``can_retry`` and ``can_restore`` booleans, and an
    optional ``error`` string."""
    failing = [(r, s) for r, s in enumerate(statuses)
               if s.get("status", "ok") != "ok"]
    if not failing:
        return {"action": "ok", "ranks": []}
    ranks = [r for r, _ in failing]
    errors = {r: s.get("error") for r, s in failing}
    # planned departures announced AT the step boundary: when every
    # non-ok status is a clean "leave", nothing failed — the agreed
    # action is "leave" (the elastic layer reforms the mesh around the
    # departing ranks; leavers exit the step cleanly).  A leave mixed
    # with a real failure falls through to the recovery merge below,
    # where the leaver's can_retry=False forbids a half-mesh rerun.
    if all(s.get("status") == "leave" for _, s in failing):
        return {"action": "leave", "ranks": ranks, "errors": errors}
    if all(s.get("can_retry") for s in statuses):
        return {"action": "retry", "ranks": ranks, "errors": errors}
    if all(s.get("can_restore") for s in statuses):
        return {"action": "restore", "ranks": ranks, "errors": errors}
    return {"action": "raise", "ranks": ranks, "errors": errors}


class Coordinator:
    """One process's handle on the mesh coordination state.

    Owns the KV backend, the rank/world identity, the lease board
    (heartbeat started on construction) and the consensus round
    counter.  Rounds are collective by construction: every rank calls
    the same sequence of :meth:`allgather`/:meth:`agree` calls, so the
    per-process counters stay aligned without communication; the round
    ``tag`` is baked into the key, so a *diverged* call sequence shows
    up as a verdict timeout instead of silently mixing two rounds'
    data."""

    def __init__(self, kv, rank: int, world: int, *,
                 lease_ttl: float = 15.0,
                 lease_interval: Optional[float] = None,
                 join_grace: Optional[float] = None,
                 verdict_timeout: float = 120.0,
                 namespace: str = "pa"):
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} outside world of {world}")
        self.kv = kv
        self.rank = int(rank)
        self.world = int(world)
        self.verdict_timeout = float(verdict_timeout)
        self.ns = namespace
        self.leases = LeaseBoard(kv, rank, world, ttl=lease_ttl,
                                 interval=lease_interval,
                                 join_grace=join_grace,
                                 namespace=namespace)
        self._round = 0
        self._prev_key: Optional[str] = None
        # set by announce_leave(): the next step boundary publishes
        # status "leave" instead of "ok" (planned scale-down announced
        # AT the boundary — see merge_statuses and guard/recover.py)
        self.leaving = False
        self.leases.start()
        # mesh observability plane: with obs armed, every rank
        # publishes its metrics snapshot on a cadence and rank 0 folds
        # the mesh view + runs straggler detection; the same loop runs
        # the clock-offset exchange the timeline merger corrects skew
        # with.  PENCILARRAYS_TPU_OBS_AGG_S=0 disables.
        self.aggregator = None
        from .. import obs
        from ..obs.aggregate import MeshAggregator, agg_cadence

        if obs.enabled() and agg_cadence() > 0:
            self.aggregator = MeshAggregator(kv, self.rank, self.world,
                                             namespace=namespace)
            self.aggregator.start()

    # -- health ------------------------------------------------------------
    def check_peers(self) -> None:
        """Typed-raise if any peer's lease is gone (see ``health.py``)."""
        self.leases.check_peers()

    # -- consensus primitives ---------------------------------------------
    def allgather(self, tag: str, payload: dict) -> List[dict]:
        """One KV round: publish ``payload`` under this rank's key, read
        every rank's.  Returns the rank-ordered list.  Waits are
        lease-checked (a dead peer raises :class:`PeerFailureError`
        long before the verdict timeout)."""
        self._round += 1
        prefix = f"{self.ns}/round/{self._round:06d}/{tag}"
        own = f"{prefix}/r{self.rank}"
        # kv-unfenced: own per-round key in this generation's ns — a
        # zombie's round lives in a namespace no survivor reads
        self.kv.set(own, json.dumps(payload))
        out: List[dict] = []
        for rank in range(self.world):
            if rank == self.rank:
                out.append(payload)
                continue
            raw = self.kv.get(f"{prefix}/r{rank}", self.verdict_timeout,
                              on_wait=self.check_peers)
            try:
                out.append(json.loads(raw))
            except ValueError as e:
                raise ConsensusTimeoutError(
                    f"unparseable consensus payload from rank {rank} at "
                    f"{prefix}: {e}", key=f"{prefix}/r{rank}") from e
        # GC with a one-round lag so the KV store stays bounded (two
        # keys per rank, not one per step boundary forever).  Safe by
        # the round protocol: a peer publishes its round-R key only
        # AFTER it finished reading every round-(R-1) key, so once WE
        # have read everyone's round-R keys, our round-(R-1) key is
        # globally dead.  Our round-R key may still be mid-read by a
        # slower peer — it is deleted at the END of round R+1.
        if self._prev_key is not None:
            self.kv.delete(self._prev_key)  # kv-unfenced: GC of own key
        self._prev_key = own
        return out

    def agree(self, label: str, status: dict) -> dict:
        """The step-boundary verdict: allgather ``status``, merge, and
        journal the agreed action (fsync-critical ``cluster.verdict`` +
        ``cluster.verdicts{action}`` counter).  A non-``ok`` action
        advances the recovery epoch — identically on every rank,
        because the new epoch is computed from the *exchanged* statuses
        (max of the mesh's reported epochs, +1), never from a local
        counter alone; a rank that joined late or missed an advance
        re-synchronizes in one round."""
        from . import epoch
        from .. import obs

        status = dict(status)
        status["epoch"] = epoch.current()
        statuses = self.allgather(f"verdict.{_keyify(label)}", status)
        verdict = merge_statuses(statuses)
        base = max(int(s.get("epoch", 0)) for s in statuses)
        if verdict["action"] != "ok":
            verdict["epoch"] = epoch.set_current(
                base + 1, f"verdict:{verdict['action']}", label=label,
                ranks=verdict["ranks"])
        else:
            verdict["epoch"] = epoch.set_current(base, "verdict:sync",
                                                 label=label)
        verdict["round"] = self._round
        if obs.enabled():
            obs.counter("cluster.verdicts", action=verdict["action"]).inc()
            # only non-ok verdicts gate recovery: a routine ok fires
            # once per step boundary and must not cost an fsync there
            obs.record_event("cluster.verdict",
                             _fsync=verdict["action"] != "ok",
                             label=label, action=verdict["action"],
                             epoch=verdict["epoch"], round=self._round,
                             ranks=verdict["ranks"],
                             errors=verdict.get("errors"))
        return verdict

    def post_abort(self, label: str, error: str) -> None:
        """One-way fatal status for the CURRENT round: published under
        the same verdict tag peers are (or will be) waiting on, without
        reading anything back — the escape hatch for an exception that
        is not part of the recovery ladder.  The dying rank does not
        block on its peers, the peers' merge sees a non-ok,
        cannot-retry, cannot-restore status (action ``raise``) instead
        of burning the verdict timeout, and every rank's round counter
        still advances exactly once — no cross-step consensus mixing
        after the caller handles the error."""
        self._round += 1
        key = (f"{self.ns}/round/{self._round:06d}/"
               f"verdict.{_keyify(label)}/r{self.rank}")
        try:
            # kv-unfenced: the dying rank's last words — fencing the
            # abort broadcast would silence exactly the failure report
            # the survivors' verdict round is waiting on
            self.kv.set(key, json.dumps({
                "status": "fatal", "error": error,
                "can_retry": False, "can_restore": False}))
        except Exception:   # pragma: no cover - best-effort: the
            pass            # original error must still propagate
        if self._prev_key is not None:
            try:
                # kv-unfenced: GC of own key on the dying path
                self.kv.delete(self._prev_key)
            except Exception:   # pragma: no cover
                pass
        self._prev_key = key

    def agree_steps(self, label: str, steps: Sequence[int]) -> List[int]:
        """Checkpoint election support: allgather each rank's valid-step
        list and return their intersection, ascending — the steps that
        are restorable *everywhere*.  The caller takes ``max()`` of the
        result (the agreed newest common step)."""
        gathered = self.allgather(f"elect.{_keyify(label)}",
                                  {"steps": sorted(int(s) for s in steps)})
        common = set(gathered[0]["steps"])
        for blob in gathered[1:]:
            common &= set(blob["steps"])
        return sorted(common)

    def announce_leave(self) -> None:
        """Flag this rank as departing: its NEXT ``guarded_step``
        boundary publishes status ``"leave"``, so the mesh agrees the
        action ``leave`` AT the boundary — the departing rank exits the
        step cleanly with its result, survivors get a prompt typed
        ``PeerLeftError`` (and, with elastic armed, reform) instead of
        waiting out a lease ttl.  Call :meth:`leave` after the step
        returns to publish the durable record and stop heartbeating."""
        self.leaving = True

    def leave(self) -> None:
        """Graceful departure from the mesh: publish the durable
        ``cluster.leave`` record (peers see planned scale-down, not a
        crash — see :meth:`LeaseBoard.leave`), then shut down."""
        self.leases.leave()
        self.shutdown()

    def shutdown(self) -> None:
        """Stop the heartbeat (the lease then expires after ttl) and
        the metrics aggregation loop, if one runs."""
        self.leases.stop()
        if self.aggregator is not None:
            self.aggregator.stop()


def _keyify(label: str) -> str:
    """Labels are free-form; KV key segments are not."""
    return "".join(c if c.isalnum() or c in "._-" else "-"
                   for c in label)[:64] or "x"
