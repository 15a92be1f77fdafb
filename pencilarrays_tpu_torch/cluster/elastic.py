"""Elastic mesh reformation — survive rank loss by shrinking and resuming
(the JAX package's ``cluster/elastic.py``).

The lease board makes failure *detection* mesh-wide: a SIGKILLed or wedged peer
surfaces on every survivor as a typed
:class:`~pencilarrays_tpu_torch.cluster.errors.PeerFailureError` within ~TTL
seconds.  But detection alone ends in a coordinated abort — on a
production mesh one dead host should cost seconds of degraded capacity,
not the job.  This module composes the pieces the tree already has into
true graceful degradation:

1. **membership consensus** — survivors agree on who is still here
   (:func:`agree_membership`): each publishes its lease-derived live
   view under a generation-numbered KV key, views are gathered and
   intersected, and a confirm round checks every survivor computed the
   SAME member set (diverging views advance the generation and try
   again, bounded by rounds and a timeout — never a hang);
2. **mesh reformation** — a NEW
   :class:`~pencilarrays_tpu_torch.cluster.consensus.Coordinator` is built for
   the surviving world under a generation-suffixed namespace, with
   survivors densely reindexed ``0..world'-1`` (old identities keep
   their journals: obs attribution is deliberately NOT renumbered);
3. **re-planning** — every compiled hop/route/FFT executable cache is
   cleared and every factory registered via :func:`register_plan` is
   re-invoked for the new topology (plans are fingerprint-keyed, so
   this is a rebuild-and-reregister pass);
4. **restore** — the new mesh elects
   ``CheckpointManager.common_latest_valid()`` and the caller's restore
   callback reloads the agreed step; the checkpoint manifest keys
   blocks by logical-order global corner (decomposition-independent by
   design), so the restore maps the OLD run's blocks onto the NEW
   mesh's local extents, checksum-verified
   (``Checkpoint.read(..., verify="local")``).

:func:`~pencilarrays_tpu_torch.guard.recover.elastic_step` extends the
guard's recovery ladder with the new rung — retry → restore →
**reform+restore** → re-raise — and :func:`request_join` lets a
replacement rank enter at the next reformation boundary (grow back to
full capacity).  A rank shutting down cleanly calls
``Coordinator.leave()`` first, so planned scale-down reforms without a
``PeerFailureError``/crash-bundle false alarm
(:class:`~pencilarrays_tpu_torch.cluster.errors.PeerLeftError`).

**Convergence honesty**: the membership round is a best-effort group
protocol over a plain KV store, not Paxos.  The common cases — one
failed rank, a clean leave, a join at a boundary — agree in one round.
A *cascade* of deaths racing the round can leave a stale member in the
agreed set (its missing heartbeat in the new namespace triggers the
NEXT reformation) or split a straggler off (it gets a typed
:class:`ReformError` and should rejoin); every path is bounded by
timeouts and surfaces typed errors, never a silent stall — reformation
itself runs under the hang watchdog.

**The quorum gate (split-brain protection)**: before a rank
may act on any membership round it must assemble a strict majority of
the *last-agreed* membership (the current coordinator's world).  The
voters are ranks whose view blobs were actually **read** this round;
the denominator excludes only ranks with *fresh-read* evidence of
departure — a readable ``cluster.leave`` record, or a readable lease
whose own timestamp is stale beyond ttl.  Absence of information is
never evidence: a partitioned rank reads nothing, so it can neither
collect voters nor shrink the denominator, and it exits with typed
:class:`~pencilarrays_tpu_torch.cluster.errors.QuorumLossError` instead of
forming a rival mesh.  (A missing lease key counts as gone only when
this rank just proved the store answers in both directions — its own
lease reads back fresh — so "authoritative absence" can admit a
never-booted rank's eviction without ever helping a partitioned
minority.)  ``PENCILARRAYS_TPU_ELASTIC_QUORUM=off`` is the documented
escape hatch for an intentional shrink below majority: the gate is
evaluated, journaled with ``verdict="bypass"`` and warned about, but
never raises.  The gate advances the **write fence** too: the agreed
new generation's rank 0 publishes ``(gen, epoch)`` at
``<base>/fence`` (:class:`~pencilarrays_tpu_torch.cluster.kv.FencedKV`), so
a zombie rank that slept through the reformation gets a typed
:class:`~pencilarrays_tpu_torch.cluster.errors.FencedWriteError` on its
next recovery-path write instead of corrupting the live namespace.

Everything is **off by default**: ``PENCILARRAYS_TPU_ELASTIC`` unset
means :func:`~pencilarrays_tpu_torch.guard.recover.elastic_step` degrades to
``guarded_step`` exactly (test-pinned) and nothing here ever runs.

Environment knobs:

=========================================  =======  ====================
``PENCILARRAYS_TPU_ELASTIC``               unset    off / ``1`` on
``PENCILARRAYS_TPU_ELASTIC_TIMEOUT``       60       membership-gather
                                                    wait (s)
``PENCILARRAYS_TPU_ELASTIC_ROUNDS``        8        max membership
                                                    rounds per attempt
``PENCILARRAYS_TPU_ELASTIC_MIN_WORLD``     1        refuse to reform
                                                    below this world
``PENCILARRAYS_TPU_ELASTIC_JOIN_TIMEOUT``  600      ``request_join``
                                                    wait (s)
``PENCILARRAYS_TPU_ELASTIC_QUORUM``        on       ``off`` disables the
                                                    split-brain quorum
                                                    gate (loud bypass)
=========================================  =======  ====================
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from .errors import ConsensusTimeoutError, QuorumLossError, ReformError

__all__ = [
    "ENV_VAR",
    "TIMEOUT_VAR",
    "ROUNDS_VAR",
    "MIN_WORLD_VAR",
    "JOIN_TIMEOUT_VAR",
    "QUORUM_VAR",
    "Membership",
    "ReformContext",
    "Reformation",
    "enabled",
    "enable",
    "disable",
    "agree_membership",
    "pending_join_slots",
    "reform",
    "request_join",
    "register_plan",
    "unregister_plan",
    "plan",
    "plans",
    "clear_plan_caches",
]

ENV_VAR = "PENCILARRAYS_TPU_ELASTIC"
TIMEOUT_VAR = "PENCILARRAYS_TPU_ELASTIC_TIMEOUT"
ROUNDS_VAR = "PENCILARRAYS_TPU_ELASTIC_ROUNDS"
MIN_WORLD_VAR = "PENCILARRAYS_TPU_ELASTIC_MIN_WORLD"
JOIN_TIMEOUT_VAR = "PENCILARRAYS_TPU_ELASTIC_JOIN_TIMEOUT"
QUORUM_VAR = "PENCILARRAYS_TPU_ELASTIC_QUORUM"

DEFAULT_TIMEOUT = 60.0
DEFAULT_ROUNDS = 8
DEFAULT_JOIN_TIMEOUT = 600.0

_OFF_VALUES = ("", "0", "off", "false")

_lock = threading.Lock()
_override: Optional[bool] = None
_gen = 0                              # last generation seen/completed
_registry: "Dict[str, Callable]" = {}  # plan name -> factory(ctx)
_plans: Dict[str, object] = {}         # plan name -> last built object
_last: Optional["Reformation"] = None  # most recent completed reformation


def enabled() -> bool:
    """THE elastic gate (one cached snapshot probe when off): with this
    False the recovery ladder is the mesh ladder alone, bit-for-bit."""
    if _override is not None:
        return _override
    from ..engine import config as _rtconfig

    return _rtconfig.current().elastic_on


def enable() -> None:
    """Programmatic arm (wins over the environment until
    :func:`disable`)."""
    global _override
    _override = True


def disable() -> None:
    global _override
    _override = False


def last_reformation() -> Optional["Reformation"]:
    """The most recent completed reformation in this process (None if
    never reformed) — how a caller that went through ``elastic_step``
    reaches the reformed coordinator when it was not installed
    globally."""
    return _last


def _reset_for_tests() -> None:
    """Clear gate override, generation counter, plan registry AND the
    last reformation (its coordinator's heartbeat/aggregator threads
    are stopped) — drills must not leak membership state, lease
    renewals or metric folds into later tests."""
    global _override, _gen, _last
    with _lock:
        _override = None
        _gen = 0
        _registry.clear()
        _plans.clear()
        last, _last = _last, None
    if last is not None:
        try:
            last.coordinator.shutdown()
        except Exception:
            pass


def _timeout() -> float:
    from ..engine import config as _rtconfig

    return _rtconfig.current().elastic_timeout


def _max_rounds() -> int:
    from ..engine import config as _rtconfig

    return _rtconfig.current().elastic_rounds


def _min_world() -> int:
    from ..engine import config as _rtconfig

    return _rtconfig.current().elastic_min_world


def _join_timeout() -> float:
    from ..engine import config as _rtconfig

    return _rtconfig.current().elastic_join_timeout


def _base_ns(ns: str) -> str:
    """The generation-independent namespace root: ``pa.g3`` -> ``pa``.
    Join requests and reform rounds live under the BASE namespace, so a
    joiner needs no knowledge of the current generation."""
    return ns.split(".g", 1)[0]


def pending_join_slots(kv, namespace: str = "pa") -> List[str]:
    """Join slots currently waiting under the base namespace — the
    ``request_join`` queue the next reformation admits.  THE one
    parser of the ``<base>/join/s<slot>`` key shape (the membership
    round and the autoscaler's scale-up probe must never disagree
    about what a pending joiner looks like)."""
    base = _base_ns(namespace)
    return sorted(k.rsplit("/", 1)[1][1:]
                  for k in kv.list_dir(f"{base}/join"))


def _gen_of(ns: str) -> int:
    if ".g" not in ns:
        return 0
    try:
        return int(ns.split(".g", 1)[1])
    except ValueError:
        return 0


def _note_gen(gen: int) -> None:
    global _gen
    with _lock:
        _gen = max(_gen, gen)


# ---------------------------------------------------------------------------
# plan registry: rebuild-and-reregister on reformation
# ---------------------------------------------------------------------------

def register_plan(name: str, factory: Callable) -> None:
    """Register ``factory(ctx)`` to be re-invoked at every reformation
    (``ctx`` is a :class:`ReformContext`).  The factory should rebuild
    whatever plan object (``PencilFFTPlan``, reshard route, pencil set)
    the application needs for the post-reform topology; the built
    object is retrievable via :func:`plan`.  Re-registering a name
    replaces its factory."""
    with _lock:
        _registry[name] = factory


def unregister_plan(name: str) -> None:
    with _lock:
        _registry.pop(name, None)
        _plans.pop(name, None)


def plan(name: str):
    """The most recently (re)built object of a registered plan, or
    ``None`` if its factory has not run yet."""
    return _plans.get(name)


def plans() -> Dict[str, object]:
    return dict(_plans)


def clear_plan_caches() -> int:
    """Drop every plan cache keyed by pencils (their topology died with
    the old mesh) and return how many cached entries were discarded.  Safe
    to call any time — the caches refill on demand.

    The port's caches: the hop cost and ``Auto(measure)`` verdicts
    (``parallel/transpositions.py``), the route planner's
    (``parallel/routing.py``), K1's copy plans and launch arguments
    (``ops/permute.py``) and the FFT planner's refactored topologies
    (``ops/fft.py``), the one cache holding process groups of the old
    mesh, and the serve layer's B-way splitters (``serve/service.py``
    ``_split_fn``, as the JAX package registers its own).  The JAX
    package's shape-keyed ``guard`` jit wrappers have no counterpart here
    (``guard/integrity.py`` caches nothing)."""
    cleared = 0
    from ..ops import fft as _fft
    from ..ops import permute as _permute
    from ..parallel import routing as _routing
    from ..parallel import transpositions as _tr
    from ..serve import service as _serve

    for mod, names in (
            (_tr, ("_cached_hop_cost", "_measured_choice")),
            (_routing, ("_plan_cached",)),
            (_permute, ("plan_copy", "_plan_args")),
            (_serve, ("_split_fn",))):
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None or not hasattr(fn, "cache_clear"):
                continue
            cleared += fn.cache_info().currsize
            fn.cache_clear()
    cleared += len(_fft._REFACTORED)
    _fft._REFACTORED.clear()
    return cleared


# ---------------------------------------------------------------------------
# membership consensus
# ---------------------------------------------------------------------------

@dataclass
class Membership:
    """The agreed post-reform world."""

    gen: int                       # reformation generation (monotonic)
    members: List[int]             # surviving OLD ranks, sorted
    joiners: List[str]             # accepted join slots, sorted
    epoch: int                     # agreed recovery epoch
    base_ns: str                   # generation-independent namespace
    old_rank: int
    new_rank: int                  # dense index in the new world
    new_world: int

    @property
    def namespace(self) -> str:
        return f"{self.base_ns}.g{self.gen}"

    @property
    def rank_map(self) -> Dict[int, int]:
        """old surviving rank -> new dense rank."""
        return {old: i for i, old in enumerate(self.members)}


class _MemberDied(Exception):
    """Internal: a rank we were waiting on during the round died/left."""

    def __init__(self, rank: int):
        super().__init__(f"rank {rank} died mid-reform")
        self.rank = rank


def _fetch(kv, key: str, deadline: float, leases, rank: int):
    """One membership-round read: bounded by ``deadline``, with the
    awaited rank's OWN health checked between polls (a second death
    mid-reform surfaces as :class:`_MemberDied`, not a timeout burn)."""
    def on_wait():
        if leases.peer_left(rank):
            raise _MemberDied(rank)
        age = leases.peer_age(rank)
        if age is not None and age > leases.ttl:
            raise _MemberDied(rank)

    remaining = deadline - time.monotonic()
    if remaining <= 0:
        raise ConsensusTimeoutError(
            f"membership key {key!r} did not appear before the reform "
            f"deadline", key=key)
    return json.loads(kv.get(key, remaining, on_wait=on_wait))


def _journal_reform(stage: str, gen: int, **fields) -> None:
    from .. import obs

    if obs.enabled():
        obs.record_event("cluster.reform", gen=gen, stage=stage, **fields)


def _quorum_gone(kv, leases, rank: int, absence_ok: bool) -> bool:
    """Fresh-read evidence that ``rank`` has durably left the
    last-agreed membership: a readable ``cluster.leave`` record, a
    readable lease whose OWN parsed timestamp is stale beyond ttl, or
    — only when ``absence_ok``, i.e. the caller just proved the store
    answers from here (see :func:`_check_quorum`) — an authoritative
    miss on both keys (the rank never published into this namespace at
    all).  An unreadable store yields NO evidence: under a partition
    every ``try_get`` comes back ``None``, and a minority that treated
    that as death would vote its healthy peers out of the denominator
    and form a rival mesh.  Deliberately does NOT reuse
    ``LeaseBoard.peer_age``: its ``_last_seen`` fallback *ages locally*
    without fresh reads — exactly the fabricated evidence the quorum
    gate exists to refuse."""
    if kv.try_get(leases._leave_key(rank)) is not None:
        return True
    raw = kv.try_get(leases._key(rank))
    if raw is None:
        return absence_ok
    try:
        t = float(json.loads(raw)["t"])
    except (ValueError, KeyError, TypeError):
        return False
    return (time.time() - t) > leases.ttl


def _check_quorum(coord, gen: int, voters, *, reason: str,
                  cause: Optional[BaseException] = None) -> None:
    """The split-brain gate (module docstring): the round's voters —
    ranks whose blobs were actually READ this round, self included —
    must form a strict majority of the last-agreed membership
    (``coord.world``) minus confirmed-gone ranks.  Every evaluation is
    journaled (``cluster.quorum``, fsync-critical); below majority the
    gate raises typed :class:`QuorumLossError`, unless
    ``PENCILARRAYS_TPU_ELASTIC_QUORUM=off`` turned it into a loud
    bypass."""
    from .. import obs
    from ..engine import config as _rtconfig

    voters = set(voters) | {coord.rank}
    # absence-as-evidence needs proof the store answers in BOTH
    # directions from here: this rank's OWN lease must read back fresh
    # (its heartbeat wrote it within ~interval).  A partitioned rank
    # cannot read its lease back (read cut) or keep it fresh (write
    # cut), so for it a missing peer key stays "no information".
    self_raw = coord.kv.try_get(coord.leases._key(coord.rank))
    absence_ok = False
    if self_raw is not None:
        try:
            t = float(json.loads(self_raw)["t"])
            absence_ok = (time.time() - t) <= coord.leases.ttl
        except (ValueError, KeyError, TypeError):
            pass
    gone: Set[int] = {
        r for r in range(coord.world)
        if r not in voters
        and _quorum_gone(coord.kv, coord.leases, r, absence_ok)}
    of = sorted(set(range(coord.world)) - gone)
    need = len(of) // 2 + 1
    have = sorted(voters)
    ok = len(have) >= need
    gate_on = _rtconfig.current().elastic_quorum
    verdict = "pass" if ok else ("fail" if gate_on else "bypass")
    if obs.enabled():
        obs.record_event("cluster.quorum", gen=gen, rank=coord.rank,
                         verdict=verdict, have=have, need=need, of=of,
                         gone=sorted(gone), reason=reason)
    if ok:
        return
    if not gate_on:
        warnings.warn(
            f"{QUORUM_VAR}=off: acting on membership round g{gen} with "
            f"only {len(have)} voter(s) {have} of {len(of)} (strict "
            f"majority needs {need}) — split-brain protection is "
            f"DISABLED; safe only for an intentional shrink below "
            f"majority", RuntimeWarning, stacklevel=3)
        return
    raise QuorumLossError(
        f"quorum lost at membership round g{gen}: only {len(have)} "
        f"voter(s) {have} of last-agreed membership {of} (strict "
        f"majority needs {need}) — this rank is on the minority side "
        f"of a partition and must NOT form a rival mesh; exit and "
        f"rejoin via request_join(), or set {QUORUM_VAR}=off for an "
        f"intentional shrink below majority",
        gen=gen, have=have, need=need, of=of) from cause


def agree_membership(coord, *, reason: str = "reform",
                     timeout: Optional[float] = None,
                     max_rounds: Optional[int] = None) -> Membership:
    """Run the membership consensus over ``coord``'s KV wire and return
    the agreed :class:`Membership`.  See the module docstring for the
    protocol; raises :class:`ReformError` when the round budget or the
    per-gather timeout runs out, or when the agreed set evicts this
    rank (it should :func:`request_join` instead)."""
    from . import epoch as _epoch

    kv = coord.kv
    leases = coord.leases
    base = _base_ns(coord.ns)
    timeout = _timeout() if timeout is None else float(timeout)
    rounds = _max_rounds() if max_rounds is None else int(max_rounds)
    gen = max(_gen, _gen_of(coord.ns))
    live = set(leases.live_ranks())
    last_err: Optional[str] = None
    for _ in range(rounds):
        gen += 1
        prefix = f"{base}/reform/g{gen:06d}"
        my_joiners = pending_join_slots(kv, base)
        view = {"rank": coord.rank, "live": sorted(live),
                "joiners": my_joiners, "epoch": _epoch.current(),
                "reason": reason}
        try:
            # kv-unfenced: pre-agreement — gen N+1's fence does not
            # exist yet; the quorum gate below is THE guard here
            kv.set(f"{prefix}/view/r{coord.rank}", json.dumps(view))
        except ConsensusTimeoutError as e:
            # the store is unreachable for writes from this rank: it
            # cannot even cast its vote.  Run the quorum gate over the
            # one view it holds (its own) so the wire-level timeout
            # surfaces as a typed QuorumLossError instead of burning
            # the round budget against a dead wire.
            _check_quorum(coord, gen, {coord.rank}, reason=reason,
                          cause=e)
            last_err = str(e)
            live = set(leases.live_ranks())
            continue
        _journal_reform("view", gen, rank=coord.rank, live=sorted(live),
                        joiners=my_joiners, reason=reason)
        deadline = time.monotonic() + timeout
        views = {coord.rank: view}
        dead: set = set()
        try:
            for r in sorted(live - {coord.rank}):
                try:
                    views[r] = _fetch(kv, f"{prefix}/view/r{r}",
                                      deadline, leases, r)
                except _MemberDied as e:
                    # drop from THIS round's wait set (the common
                    # lease-skew race: a peer still listed the victim
                    # as live when we snapshotted) — the intersection
                    # below removes it from the member set
                    dead.add(e.rank)
        except ConsensusTimeoutError as e:
            _check_quorum(coord, gen, set(views), reason=reason,
                          cause=e)
            last_err = str(e)
            live = set(leases.live_ranks())
            continue
        # the gate: the views actually read this round are the voters
        # (a _MemberDied exclusion is NOT a vote — peer_age's local
        # fallback can age a healthy-but-unreachable peer, and the
        # denominator only shrinks on _quorum_gone's fresh evidence)
        _check_quorum(coord, gen, set(views), reason=reason)
        tentative = set(live)
        for v in views.values():
            tentative &= set(v.get("live", []))
        tentative -= dead
        if coord.rank not in tentative:
            raise ReformError(
                f"membership round g{gen} evicted this rank "
                f"(rank {coord.rank}; agreed set {sorted(tentative)}) — "
                f"the mesh reformed without us; rejoin via "
                f"request_join()", stage="membership", gen=gen)
        joiners: set = set()
        for v in views.values():
            joiners.update(v.get("joiners", []))
        members = sorted(tentative)
        confirm = {"members": members, "joiners": sorted(joiners),
                   "epoch": max(int(v.get("epoch", 0))
                                for v in views.values()) + 1}
        try:
            # kv-unfenced: still pre-agreement (the confirm IS the
            # agreement); quorum-gated on timeout below
            kv.set(f"{prefix}/confirm/r{coord.rank}", json.dumps(confirm))
        except ConsensusTimeoutError as e:
            # partition onset between the view and confirm publishes
            _check_quorum(coord, gen, {coord.rank}, reason=reason,
                          cause=e)
            last_err = str(e)
            live = set(leases.live_ranks())
            continue
        deadline = time.monotonic() + timeout
        confirms = {coord.rank: confirm}
        try:
            for r in members:
                if r == coord.rank:
                    continue
                confirms[r] = _fetch(kv, f"{prefix}/confirm/r{r}",
                                     deadline, leases, r)
        except _MemberDied as e:
            live = set(members) - {e.rank}
            last_err = f"rank {e.rank} died during the confirm round"
            continue
        except ConsensusTimeoutError as e:
            _check_quorum(coord, gen, set(confirms), reason=reason,
                          cause=e)
            last_err = str(e)
            live = set(leases.live_ranks())
            continue
        if all(c == confirm for c in confirms.values()):
            _note_gen(gen)
            return Membership(
                gen=gen, members=members,
                joiners=confirm["joiners"], epoch=confirm["epoch"],
                base_ns=base, old_rank=coord.rank,
                new_rank=members.index(coord.rank),
                new_world=len(members) + len(confirm["joiners"]))
        # views diverged: next round over the narrowed set
        nxt = set(members)
        for c in confirms.values():
            nxt &= set(c.get("members", []))
        live = nxt | {coord.rank}
        last_err = "confirm sets diverged"
    raise ReformError(
        f"membership consensus did not converge within "
        f"{rounds} round(s) (last: {last_err})",
        stage="membership", gen=gen)


# ---------------------------------------------------------------------------
# the reformation itself
# ---------------------------------------------------------------------------

@dataclass
class ReformContext:
    """What a registered plan factory (and the ``rebuild`` callback)
    receives: the agreed membership plus the already-running new
    coordinator."""

    membership: Membership
    coordinator: object


@dataclass
class Reformation:
    """Everything one completed reformation produced."""

    membership: Membership
    coordinator: object
    restored_step: Optional[int] = None
    timings: Dict[str, float] = field(default_factory=dict)


def reform(coordinator=None, *, reason: str = "reform",
           ckpt_mgr=None, restore: Optional[Callable] = None,
           rebuild: Optional[Callable] = None,
           install: Optional[bool] = None,
           timeout: Optional[float] = None,
           detect_s: Optional[float] = None) -> Reformation:
    """Reform the mesh around the current survivors: membership
    consensus → new coordinator (dense reindex, generation-suffixed
    namespace) → epoch advance → re-plan (cache clear + registered
    factories + ``rebuild`` callback) → coordinated restore of the
    agreed checkpoint (when ``ckpt_mgr``/``restore`` are given).

    The whole sequence runs under the hang watchdog — a survivor wedged
    in mesh rebuild or restore I/O leaves a crash bundle and a typed
    ``HangTimeoutError``, never a silent stall (its heartbeat would
    otherwise keep its lease fresh forever).  ``install`` (default:
    auto — install exactly when the coordinator being reformed IS the
    process-global one) makes ``cluster.coordinator()`` return the new
    coordinator afterwards; in-process multi-rank tests pass explicit
    coordinators and must not fight over the one global slot.
    ``detect_s`` (how long detection took, supplied by the caller)
    rides the journal/timings for the MTTR breakdown."""
    from . import enable as _install_coord
    from . import coordinator as _current
    from .. import obs
    from ..guard.watchdog import watchdog as _watchdog

    coord = coordinator if coordinator is not None else _current()
    if install is None:
        install = coordinator is None or coordinator is _current()
    if coord is None:
        raise ReformError("no active coordinator: reformation needs the "
                          "cluster layer armed on a multi-process mesh",
                          stage="begin")
    t_begin = time.monotonic()
    timings: Dict[str, float] = {}
    if detect_s is not None:
        timings["detect_s"] = float(detect_s)
    _journal_reform("begin", _gen + 1, rank=coord.rank, world=coord.world,
                    reason=reason, detect_s=detect_s)
    new_coord = None
    from .. import engine as _engine

    try:
        with _watchdog(f"reform:{reason}", kind="reform"):
            # -- engine quiesce: BEFORE the membership changes, every
            # registered engine pauses at its next task boundary and
            # the in-flight dispatch (if any) completes — no device
            # program may be mid-issue while the mesh reforms under it.
            # Queued dispatches are HELD here (a failed reformation
            # resumes them untouched); they are only dropped typed when
            # the reformation actually commits below.
            t0 = time.monotonic()
            quiesced = _engine.quiesce_all()
            timings["engine_quiesce_s"] = time.monotonic() - t0
            if not quiesced:
                # an in-flight dispatch outlived the quiesce budget (a
                # wedged collective — often the very failure being
                # reformed around).  Proceeding is safe-by-generation:
                # reform_all below retires the old consumer, so the
                # stuck thread can never issue ANOTHER program — but
                # the broken invariant must be on the record, not
                # silent (the watchdog/crash-bundle path owns killing
                # the stuck call itself)
                _journal_reform("engine-quiesce-timeout", _gen + 1,
                                rank=coord.rank,
                                waited_s=timings["engine_quiesce_s"])
            t0 = time.monotonic()
            m = agree_membership(coord, reason=reason, timeout=timeout)
            timings["membership_s"] = time.monotonic() - t0
            if m.new_world < _min_world():
                raise ReformError(
                    f"agreed world {m.new_world} is below the "
                    f"PENCILARRAYS_TPU_ELASTIC_MIN_WORLD floor "
                    f"({_min_world()})", stage="membership", gen=m.gen)
            if obs.enabled():
                for r in range(coord.world):
                    if r != coord.rank and r not in m.members:
                        obs.record_event(
                            "cluster.member", rank=r, change="drop",
                            gen=m.gen, observed_by=coord.rank)
            _journal_reform("membership", m.gen, rank=coord.rank,
                            members=m.members, joiners=m.joiners,
                            epoch=m.epoch, new_rank=m.new_rank,
                            new_world=m.new_world)

            # -- mesh rebuild: a fresh coordinator in the new namespace
            t0 = time.monotonic()
            from . import epoch as _epoch
            from .consensus import Coordinator

            _epoch.set_current(m.epoch, f"reform:{reason}", gen=m.gen)
            new_coord = Coordinator(
                coord.kv, m.new_rank, m.new_world,
                lease_ttl=coord.leases.ttl,
                lease_interval=coord.leases.interval,
                join_grace=coord.leases.join_grace,
                verdict_timeout=coord.verdict_timeout,
                namespace=m.namespace)
            if m.new_rank == 0:
                # the agreed new generation's rank 0 advances the
                # write fence FIRST: from here on, any writer still
                # holding a pre-reform (gen, epoch) token is a zombie
                # and its recovery-path writes are rejected typed
                from .kv import FencedKV

                fenced = FencedKV(coord.kv, namespace=m.base_ns,
                                  generation=m.gen, epoch=m.epoch)
                fence = fenced.advance(m.gen, m.epoch)
                _journal_reform("fence", m.gen, rank=m.new_rank,
                                fence_gen=fence[0],
                                fence_epoch=fence[1])
                # the single deterministic writer publishes each
                # accepted joiner's assignment (rank/world/namespace)
                # and consumes the request keys — through the fence,
                # so a zombie rank 0 of a dead generation can never
                # hand out assignments into the live namespace
                for i, slot in enumerate(m.joiners):
                    fenced.set(
                        f"{m.base_ns}/reform/assign/s{slot}",
                        json.dumps({
                            "gen": m.gen, "slot": slot,
                            "rank": len(m.members) + i,
                            "world": m.new_world, "ns": m.namespace,
                            "epoch": m.epoch, "members": m.members,
                            "joiners": m.joiners,
                            "lease_ttl": coord.leases.ttl,
                            "verdict_timeout": coord.verdict_timeout}))
                    fenced.delete(f"{m.base_ns}/join/s{slot}")
            timings["mesh_s"] = time.monotonic() - t0
            _journal_reform("mesh", m.gen, rank=m.new_rank,
                            namespace=m.namespace)

            # -- re-plan: every fingerprint-keyed executable is stale
            t0 = time.monotonic()
            ctx = ReformContext(membership=m, coordinator=new_coord)
            dropped = clear_plan_caches()
            with _lock:
                factories = list(_registry.items())
            for name, factory in factories:
                _plans[name] = factory(ctx)
            if rebuild is not None:
                rebuild(ctx)
            timings["replan_s"] = time.monotonic() - t0
            _journal_reform("replan", m.gen, rank=m.new_rank,
                            plans=sorted(n for n, _ in factories),
                            dropped_executables=dropped)

            # -- restore: the agreed step, across the changed world
            restored: Optional[int] = None
            if ckpt_mgr is not None and restore is not None:
                t0 = time.monotonic()
                # the election runs over the NEW coordinator; a world
                # of one elects its own newest valid step directly
                # (common_latest_valid(None) would consult the
                # process-global coordinator — the OLD, dead world)
                restored = (ckpt_mgr.common_latest_valid(
                                coordinator=new_coord)
                            if m.new_world > 1
                            else ckpt_mgr.latest_valid())
                if restored is None:
                    raise ReformError(
                        "mesh reformed but no checkpoint step is valid "
                        "on every surviving rank", stage="restore",
                        gen=m.gen)
                restore(ckpt_mgr.restore(restored))
                timings["restore_s"] = time.monotonic() - t0
                _journal_reform("restore", m.gen, rank=m.new_rank,
                                step=restored)

            # -- engine reform: ONLY after the restore rung committed —
            # the quiesce site above HELD every queued dispatch with
            # the promise that a failed reformation resumes them
            # untouched, and the restore rung is the last stage that
            # can fail.  Reforming here keeps that promise: on success
            # the reindexed coordinator gets fresh engines (held
            # dispatches fail typed EngineReformedError — the programs
            # they would issue target the dead mesh — timers drop, a
            # fresh RuntimeConfig snapshot is taken, a new generation
            # of consumer/pool threads starts on demand); on a
            # restore-stage failure the old mesh resumes with its held
            # queue intact (drill-pinned: a held dispatch survives the
            # failed reformation and executes on resume).
            t0 = time.monotonic()
            reformed_engines = _engine.reform_all()
            timings["engine_s"] = time.monotonic() - t0
            _journal_reform("engine", m.gen, rank=m.new_rank,
                            engines=reformed_engines)
        # success: only NOW retire the old coordinator — until here it
        # kept heartbeating, so a FAILED reformation leaves the caller
        # with a live coordinator (and cluster.coordinator()'s cache
        # valid) instead of a heartbeat-dead ghost whose peers would
        # declare this healthy rank failed after one ttl
        coord.shutdown()
        if install:
            _install_coord(new_coord)
        timings["total_s"] = time.monotonic() - t_begin
        global _last
        if obs.enabled():
            obs.counter("cluster.reforms", outcome="ok").inc()
        _journal_reform("complete", m.gen, rank=m.new_rank,
                        new_world=m.new_world, epoch=m.epoch,
                        step=restored, **{f"t_{k}": v
                                          for k, v in timings.items()})
        result = Reformation(membership=m, coordinator=new_coord,
                             restored_step=restored, timings=timings)
        _last = result
        return result
    except BaseException as e:
        # a failed reformation must not leak the half-built new world:
        # its heartbeat would renew a lease in the reformed namespace
        # forever, and the next reform attempt (or a joiner) would see
        # a ghost member that never coordinates
        if new_coord is not None:
            try:
                new_coord.shutdown()
            except Exception:
                pass
        # the old mesh is still the live one: un-pause the engines so
        # their held queues dispatch again (the quiesce above must not
        # outlive a FAILED reformation as a silent wedge)
        try:
            _engine.resume_all()
        except Exception:
            pass
        if obs.enabled():
            obs.counter("cluster.reforms", outcome="failed").inc()
        _journal_reform("failed", _gen, rank=coord.rank,
                        error=f"{type(e).__name__}: {e}")
        raise


# ---------------------------------------------------------------------------
# rejoin: grow back to full capacity
# ---------------------------------------------------------------------------

def request_join(kv, slot: str, *, namespace: str = "pa",
                 timeout: Optional[float] = None) -> Reformation:
    """Ask to join the mesh as a replacement rank.  Publishes a join
    request under the BASE namespace and blocks until the survivors'
    next reformation assigns this slot a rank (or ``timeout`` expires
    → :class:`ReformError`).  Returns a :class:`Reformation` whose
    coordinator is already heartbeating in the reformed namespace —
    hand it to ``guarded_step``/``elastic_step`` via ``coordinator=``
    (or rely on the installed global).  ``slot`` is any stable id
    (``[A-Za-z0-9._=-]``) unique to this replacement."""
    slot = str(slot)
    base = _base_ns(namespace)
    timeout = _join_timeout() if timeout is None else float(timeout)
    # a previous incarnation of this slot may have timed out AFTER the
    # survivors published its assignment: consume any stale record
    # first, so the assignment we read below was provably published in
    # response to THIS request (joining a dead generation's namespace
    # would heartbeat into a world that no longer exists)
    # kv-unfenced: the joiner holds no fencing token by definition —
    # it is not a member of ANY generation yet; rank 0 answers through
    # FencedKV, so a dead generation's survivor cannot assign it
    kv.delete(f"{base}/reform/assign/s{slot}")
    kv.set(f"{base}/join/s{slot}", json.dumps(   # kv-unfenced: no token yet
        {"slot": slot, "pid": os.getpid(), "t": time.time()}))
    _journal_reform("join-request", _gen, slot=slot)
    try:
        raw = kv.get(f"{base}/reform/assign/s{slot}", timeout)
    except ConsensusTimeoutError as e:
        kv.delete(f"{base}/join/s{slot}")  # kv-unfenced: retract own bid
        raise ReformError(
            f"join request {slot!r} was not assigned within "
            f"{timeout:.0f}s (no reformation boundary reached, or the "
            f"mesh is gone)", stage="join") from e
    a = json.loads(raw)
    # kv-unfenced: consuming the assignment addressed to this joiner
    kv.delete(f"{base}/reform/assign/s{slot}")
    from . import enable as _install_coord
    from . import epoch as _epoch
    from .. import obs
    from .consensus import Coordinator

    _note_gen(int(a["gen"]))
    _epoch.set_current(int(a["epoch"]), "reform:join", gen=a["gen"])
    coord = Coordinator(kv, int(a["rank"]), int(a["world"]),
                        lease_ttl=float(a.get("lease_ttl", 15.0)),
                        verdict_timeout=float(
                            a.get("verdict_timeout", 120.0)),
                        namespace=a["ns"])
    _install_coord(coord)
    if obs.enabled():
        obs.record_event("cluster.member", rank=int(a["rank"]),
                         change="join", gen=a["gen"], slot=slot)
    _journal_reform("join", int(a["gen"]), rank=int(a["rank"]),
                    new_world=int(a["world"]), slot=slot,
                    epoch=int(a["epoch"]))
    m = Membership(gen=int(a["gen"]),
                   members=[int(r) for r in a.get("members", [])],
                   joiners=[str(s) for s in a.get("joiners", [slot])],
                   epoch=int(a["epoch"]), base_ns=base,
                   old_rank=-1, new_rank=int(a["rank"]),
                   new_world=int(a["world"]))
    global _last
    result = Reformation(membership=m, coordinator=coord)
    _last = result
    return result
