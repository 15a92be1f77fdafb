"""The task-graph executor (the JAX package's ``engine/executor.py``):
dependency-chain dispatch, host overlap, priority lanes.

* **one issuer** — a single consumer thread issues every dispatch, so
  the order of a rank's collective calls is decided in one place;
* **tasks declare resources** — :meth:`Engine.submit` takes ``reads``
  / ``writes`` sets of resource tokens (any string).  Conflicting tasks
  (write/write, write/read) form a dependency chain and issue in enqueue
  order; tasks on disjoint resources may issue out of order.  A task
  that declares nothing is a **barrier** (conflicts with everything, both
  directions): the strict total order.  ``analysis.spmd.
  verify_dispatch_log`` proves the order after the fact;
* **priority lanes** — ``submit(lane=...)`` biases the pick among ready
  tasks (highest lane first, FIFO within a lane), bounded by a
  starvation deadline (``engine_starve_s``);
* **a host task pool** runs what launches no collective (checkpoint
  serialization, packing) beside the consumer's current dispatch;
* **steps are futures** — failures are scoped to one
  :class:`StepFuture` and the queue keeps draining; ``submit(after=...)``
  adds explicit edges.

Every port run is one process per rank: cross-chain reorders are a
property of this process's consumer, so ranks that issue collectives
through an engine keep the total order (``dag=False`` or tasks without
resources) or drain at agreed points.  On the card the consumer and the
host workers adopt the CUDA device current on the thread that started
them (torch's current device and current stream are per thread, and a
kernel launches on the launching thread's current stream); the consumer
launches on that device's default stream, each host worker on a stream
of its own, so a save's staging queues behind no later dispatch.  A
dispatch's future carries the event its device work ends at
(``StepFuture.device_event``), which a host task that reads the result
waits for (:func:`wait_device`).

The engine resolves its :class:`~pencilarrays_tpu_torch.engine.config.
RuntimeConfig` once at construction and again only at an explicit
:meth:`Engine.reform` (quiesce, drop held dispatches typed, resume under
a new generation).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import config as _config
from .errors import (
    EngineClosedError,
    EngineReformedError,
    EngineTaskError,
)
from .threads import spawn_thread

__all__ = ["StepFuture", "DispatchRecord", "Engine", "get_engine",
           "engines", "quiesce_all", "reform_all", "resume_all",
           "shutdown_all", "device_event", "wait_device"]

_NO_OPERAND = object()
_MAX_LOG = 4096


def _cuda_device() -> Optional[int]:
    """The calling thread's current CUDA device, or ``None`` where CUDA
    is not in use: the engine's threads adopt it when they start."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_device()
    return None


def _adopt_device(device: Optional[int], own_stream: bool = False) -> None:
    """Make ``device`` this thread's current CUDA device; with
    ``own_stream``, give the thread a stream of its own (a host worker's
    device work, such as a save's staging, then queues behind no
    dispatch)."""
    if device is not None:
        import torch

        torch.cuda.set_device(device)
        if own_stream:
            torch.cuda.set_stream(torch.cuda.Stream(device))


def device_event():
    """A CUDA event recorded on the calling thread's current stream (the
    point after the device work this thread has launched), or ``None``
    where CUDA is not in use.  Device work on another stream waits for it
    through :func:`wait_device`."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return None


def wait_device(event) -> None:
    """Order the calling thread's current CUDA stream after ``event`` (a
    :func:`device_event`; ``None`` is a no-op)."""
    if event is not None:
        import torch

        torch.cuda.current_stream().wait_event(event)


class StepFuture:
    """One submitted task's future: :meth:`result` blocks until the
    engine resolved it; typed errors re-raise here.  Callbacks run on
    the resolving engine thread and must be cheap + non-raising (a
    raising callback is swallowed and counted, never allowed to kill
    the consumer)."""

    def __init__(self, label: str = "step"):
        self.label = label
        self.device_event = None
        """For a dispatch on the card: the :func:`device_event` recorded
        on the consumer's stream when ``run`` returned.  Work on another
        stream that reads the result waits for it first
        (:func:`wait_device`): the host returns before the device
        finishes."""
        self._event = threading.Event()
        self._resolved = False
        self._result = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable] = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"step {self.label!r} not done")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        return self._error

    def add_done_callback(self, fn: Callable[["StepFuture"], None]) -> None:
        with self._cb_lock:
            if not self._resolved:
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except BaseException:
            # NEVER propagate — BaseException included: callbacks run
            # on the resolving engine thread, where an escaping
            # SystemExit would kill the consumer AND skip the event
            # set below, hanging every result() waiter
            from .. import obs

            if obs.enabled():
                obs.counter("engine.callback_errors").inc()

    def _resolve(self, result, error: Optional[BaseException]) -> None:
        with self._cb_lock:
            self._result = result
            self._error = error
            self._resolved = True
            cbs, self._callbacks = self._callbacks, []
        # the event is set only AFTER the done callbacks ran: a waiter
        # woken by result()/the event may rely on completion side
        # effects (serve fulfills its tickets in a callback — step()'s
        # "block until resolved" promise must cover them, or a
        # ticket.result(0) right after step() is a flaky TimeoutError).
        # Callbacks therefore must not call result() on their own
        # future — they read _result/error() directly.  The finally is
        # load-bearing: the event MUST fire even if callback handling
        # itself breaks, or every waiter hangs silently
        try:
            for fn in cbs:
                self._run_callback(fn)
        finally:
            self._event.set()

    def _fulfill(self, result) -> None:
        self._resolve(result, None)

    def _fail(self, error: BaseException) -> None:
        self._resolve(None, error)


@dataclass(frozen=True)
class DispatchRecord:
    """One issued dispatch, in issue order — what
    ``analysis.spmd.verify_dispatch_log`` certifies against the
    enqueue order (per dependency chain in partial-order mode) and the
    ``collective_costs`` predictions.

    v1 records carry only the first seven fields; every v2 field
    defaults so old constructors — and old pickles — still verify.
    ``barrier=True`` is the load-bearing default: a record that never
    declared resources conflicts with everything, which is exactly the
    strict total order the v1 verifier enforced."""

    enqueue_seq: int
    issue_seq: int
    label: str
    outcome: str                    # "ok" | error type name
    queued_s: float
    run_s: float
    meta: dict = field(default_factory=dict)
    lane: int = 0
    chain: str = "*"                # "*" = barrier (every chain)
    barrier: bool = True
    reads: tuple = ()
    writes: tuple = ()
    deps: tuple = ()                # enqueue_seqs this task waited on


@dataclass
class _Task:
    seq: int
    label: str
    run: Callable
    future: StepFuture
    pack_future: Optional[StepFuture]
    meta: dict
    t_enqueue: float
    reads: frozenset = frozenset()
    writes: frozenset = frozenset()
    lane: int = 0
    barrier: bool = True
    chain: str = "*"
    deps: tuple = ()


@dataclass
class _HostItem:
    fn: Callable
    future: StepFuture
    label: str
    stage: str                      # "pack" | "host"


class Engine:
    """The per-mesh executor (module docstring).

    Parameters
    ----------
    name:
        Registry / thread-name label.  :func:`get_engine` maintains one
        shared engine per name; direct construction makes a private one.
    workers:
        Host-pool width (default: the snapshot's ``engine_workers``,
        env knob ``PENCILARRAYS_TPU_ENGINE_WORKERS``).
    config:
        Explicit :class:`~pencilarrays_tpu_torch.engine.config.RuntimeConfig`
        (default: ``config.current()`` — resolved ONCE, here).
    dag:
        Out-of-order issue among resource-disjoint tasks (default: the
        snapshot's ``engine_dag``, env knob
        ``PENCILARRAYS_TPU_ENGINE_DAG``).  ``False`` treats every task
        as a barrier — the v1 strict total order.
    starve_s:
        Starvation bound for lane/readiness bias (default: the
        snapshot's ``engine_starve_s``): a task queued this long is
        issued next regardless of lane or pack readiness.
    """

    def __init__(self, name: str = "engine", *,
                 workers: Optional[int] = None,
                 config: Optional[_config.RuntimeConfig] = None,
                 dag: Optional[bool] = None,
                 starve_s: Optional[float] = None):
        self.name = name
        self.config = config if config is not None else _config.current()
        if workers is not None and int(workers) < 1:
            raise ValueError(
                "engine workers must be >= 1: the host pool runs pack "
                "stages, and a pool of 0 would wedge every submit(pack=) "
                "head-of-line wait")
        # the config path is clamped, not raised: RuntimeConfig built
        # directly (bypassing env resolution's own max(1,...)) must
        # not reintroduce the zero-worker pack wedge silently
        self._workers = int(workers) if workers is not None else \
            max(1, self.config.engine_workers)
        # explicit dag/starve_s overrides survive reform(); the config
        # path re-resolves with the fresh snapshot
        self._dag_override = dag
        self._starve_override = starve_s
        self.dag = bool(self.config.engine_dag) if dag is None else \
            bool(dag)
        self.starve_s = float(self.config.engine_starve_s) \
            if starve_s is None else max(0.0, float(starve_s))
        self._cv = threading.Condition()
        self._gen = 0
        self._closed = False
        self._paused = False
        self._busy = False              # consumer mid-dispatch
        # -- the task DAG (all under _cv) --
        # _queued: every not-yet-issued task, keyed by enqueue seq
        # (dict = insertion-ordered); _ready: the issuable subset
        # (deps resolved); _nblock: outstanding dep count per queued
        # task; _dependents: completed-task fan-out; _unresolved:
        # seqs enqueued but not yet COMPLETED (queued + in-flight) —
        # the set new deps are computed against
        self._queued: Dict[int, _Task] = {}
        self._ready: Dict[int, _Task] = {}
        self._nblock: Dict[int, int] = {}
        self._dependents: Dict[int, List[int]] = {}
        self._unresolved: set = set()
        self._res_writer: Dict[str, int] = {}
        self._res_readers: Dict[str, set] = {}
        self._last_barrier: Optional[int] = None
        self._lane_counts: Dict[int, int] = {}  # queued tasks per lane
        self._timers: list = []         # heap of (deadline, seq, fn)
        self._host_q: deque = deque()
        self._host_busy = 0
        self._dispatch_thread = None
        self._host_threads: list = []
        self._enq = itertools.count(1)
        self._timer_seq = itertools.count(1)
        self._reform_cbs: list = []
        self._issue_seq = 0
        self._log: deque = deque(maxlen=_MAX_LOG)
        self._dispatched = 0
        self._host_done = 0
        self._dispatch_busy_s = 0.0
        self._host_busy_s = 0.0
        self._out_of_order = 0          # dispatches issued before an
        self._max_issued_seq = 0        # earlier-enqueued task (the
        #                                 bench's overlap numerator)
        self._starved_issues = 0

    # -- introspection -----------------------------------------------------
    @property
    def generation(self) -> int:
        """Bumped by every :meth:`reform` (0 = the construction mesh)."""
        with self._cv:
            return self._gen

    @property
    def accepting(self) -> bool:
        """False while closed or quiesced — pump-style clients defer
        submission instead of feeding a held queue."""
        with self._cv:
            return not (self._closed or self._paused)

    def depth(self) -> int:
        with self._cv:
            return len(self._queued) + (1 if self._busy else 0)

    def on_consumer_thread(self) -> bool:
        """True when the calling thread is (or WAS) one of this
        engine's dispatch consumers — the reentrancy probe: an
        in-flight task that needs to quiesce/reform its own engine (the
        serve layer's ``elastic_step`` reforming mid-batch) must not
        deadlock waiting for itself, and its clients must not resubmit
        work that would dispatch concurrently with it.  Checked via a
        marker stamped on the thread itself, NOT ``_dispatch_thread``:
        ``reform()`` nulls that slot mid-reform, and a retired
        generation's consumer finishing its interrupted task is still
        "the consumer" for concurrency purposes."""
        return getattr(threading.current_thread(),
                       "_pa_engine_consumer", None) is self

    def dispatch_log(self) -> List[DispatchRecord]:
        """Issue-ordered dispatch records — a BOUNDED history (the last
        ``log_capacity`` dispatches; check :meth:`stats`'s
        ``log_truncated`` before claiming the log covers a whole
        run)."""
        with self._cv:
            return list(self._log)

    def stats(self) -> dict:
        with self._cv:
            lanes = dict(self._lane_counts)
            return {
                "name": self.name,
                "generation": self._gen,
                "queued": len(self._queued),
                "ready": len(self._ready),
                "lanes": lanes,
                "dag": self.dag,
                "busy": self._busy,
                "host_queued": len(self._host_q),
                "host_busy": self._host_busy,
                "dispatched": self._dispatched,
                "out_of_order": self._out_of_order,
                "starved_issues": self._starved_issues,
                "host_tasks": self._host_done,
                "dispatch_busy_s": self._dispatch_busy_s,
                "host_busy_s": self._host_busy_s,
                "workers": self._workers,
                "log_capacity": _MAX_LOG,
                "log_truncated": self._dispatched > len(self._log),
            }

    # -- submission --------------------------------------------------------
    def submit(self, run: Callable, *, pack: Optional[Callable] = None,
               label: str = "step", meta: Optional[dict] = None,
               reads=(), writes=(), lane: int = 0, after=()
               ) -> StepFuture:
        """Enqueue one device dispatch; returns its future.

        ``run`` issues the device work (the ONLY place collective
        programs may be launched) and executes on the consumer thread.
        ``pack`` (optional) builds the operand on the host pool,
        overlapped with earlier dispatches; its return value becomes
        ``run``'s single argument (without ``pack``, ``run`` is called
        with no arguments).  A ``pack`` failure fails THIS future typed
        and the consumer moves on.

        ``reads`` / ``writes`` declare the task's resource sets
        (strings — ``"plan:<fp>"``, ``"route:<key>"``, buffer names).
        Tasks that conflict (a write against any prior touch, a read
        against a prior write) issue in enqueue order; disjoint tasks
        may issue out of order.  Declaring NEITHER makes the task a
        **barrier**: it waits for everything enqueued before it and
        blocks everything after — the exact v1 total order, which is
        why every pre-v2 call site keeps its ordering bit-for-bit.
        The declaration is a *promise* the partial-order verifier
        audits: ``run`` must not touch undeclared shared state (a
        dispatched plan is checked against the declared writes).

        ``lane`` biases the pick among ready tasks (highest first,
        FIFO within); ``after`` adds explicit dependency edges on
        futures from THIS engine (already-resolved ones are no-ops).

        ``meta`` is held BY REFERENCE until ``run`` returns — a task
        whose shape is unknown at submit time (e.g.
        ``forward_async``'s pack form) may complete its own
        certification metadata from inside ``run`` — and then a
        shallow COPY is snapshotted into the dispatch log, so later
        mutation of the caller's dict cannot rewrite certification
        history."""
        rset = frozenset(reads)
        wset = frozenset(writes)
        for r in rset | wset:
            if not isinstance(r, str):
                raise TypeError(
                    f"resource tokens must be str, got {type(r).__name__}"
                    f" in task {label!r}: resources are identity-compared"
                    f" across tasks and must hash stably")
        fut = StepFuture(label)
        with self._cv:
            if self._closed:
                raise EngineClosedError(
                    f"engine {self.name!r} is closed")
            pf = None
            if pack is not None:
                pf = self._offer_host_locked(pack, label, "pack")
            seq = next(self._enq)
            barrier = not self.dag or (not rset and not wset
                                       and not after)
            task = _Task(
                seq=seq, label=label, run=run, future=fut,
                pack_future=pf, meta=meta if meta is not None else {},
                t_enqueue=time.monotonic(),
                reads=rset, writes=wset, lane=int(lane),
                barrier=barrier,
                chain="*" if barrier else
                      "|".join(sorted(wset) or sorted(rset)) or "*")
            fut._pa_engine = self
            fut._pa_seq = seq
            self._enqueue_locked(task, after)
            self._ensure_threads_locked()
            self._cv.notify_all()
            lane_depth = self._lane_counts.get(task.lane, 0)
            ready_n = len(self._ready)
        from .. import obs

        if obs.enabled():
            obs.gauge("engine.lanes", engine=self.name,
                      lane=str(task.lane),
                      state="queued").set(lane_depth)
            obs.gauge("engine.ready_tasks",
                      engine=self.name).set(ready_n)
        return fut

    def _enqueue_locked(self, task: _Task, after=()) -> None:
        """Compute the task's dependency edges against the unresolved
        set, update the resource maps, and file it queued (ready if
        nothing blocks it).  Caller holds ``_cv``."""
        seq = task.seq
        deps: set = set()
        if task.barrier:
            # a barrier conflicts with everything in flight, and
            # becomes the floor every later task must clear
            deps.update(self._unresolved)
            self._last_barrier = seq
        else:
            lb = self._last_barrier
            if lb is not None and lb in self._unresolved:
                deps.add(lb)
            for r in task.reads | task.writes:
                w = self._res_writer.get(r)
                if w is not None and w in self._unresolved:
                    deps.add(w)          # RAW / WAW
            for w_res in task.writes:
                readers = self._res_readers.get(w_res)
                if readers:
                    deps.update(s for s in readers
                                if s in self._unresolved)  # WAR
            for f in after:
                eng = getattr(f, "_pa_engine", None)
                if eng is not None and eng is not self:
                    raise ValueError(
                        f"after= future {f.label!r} belongs to engine "
                        f"{eng.name!r}, not {self.name!r}: cross-engine "
                        f"edges would deadlock two consumers on each "
                        f"other — chain via add_done_callback instead")
                s = getattr(f, "_pa_seq", None)
                if s is not None and s in self._unresolved:
                    deps.add(s)
        for w_res in task.writes:
            self._res_writer[w_res] = seq
            self._res_readers.pop(w_res, None)
        for r in task.reads - task.writes:
            self._res_readers.setdefault(r, set()).add(seq)
        task.deps = tuple(sorted(deps))
        self._unresolved.add(seq)
        for d in deps:
            self._dependents.setdefault(d, []).append(seq)
        self._nblock[seq] = len(deps)
        self._queued[seq] = task
        self._lane_counts[task.lane] = \
            self._lane_counts.get(task.lane, 0) + 1
        if not deps:
            self._ready[seq] = task

    def _complete_locked(self, task: _Task) -> None:
        """Retire a finished task from the DAG: release its dependents
        (newly unblocked ones become ready) and drop its entries from
        the resource maps so the maps stay bounded by in-flight work,
        not history.  Caller holds ``_cv``."""
        seq = task.seq
        self._unresolved.discard(seq)
        for dseq in self._dependents.pop(seq, ()):
            n = self._nblock.get(dseq)
            if n is None:
                continue            # dropped by a reform/close
            n -= 1
            self._nblock[dseq] = n
            if n == 0 and dseq in self._queued:
                self._ready[dseq] = self._queued[dseq]
        for w_res in task.writes:
            if self._res_writer.get(w_res) == seq:
                del self._res_writer[w_res]
        for r in task.reads:
            readers = self._res_readers.get(r)
            if readers is not None:
                readers.discard(seq)
                if not readers:
                    del self._res_readers[r]
        if self._last_barrier == seq:
            self._last_barrier = None

    def _clear_dag_locked(self) -> List[_Task]:
        """Drop every queued task (reform/close): returns them for the
        caller to fail typed OUTSIDE the lock.  The in-flight task, if
        any, skips its own completion bookkeeping via the generation
        check, so the whole DAG state resets here."""
        pending = list(self._queued.values())
        self._queued.clear()
        self._ready.clear()
        self._nblock.clear()
        self._dependents.clear()
        self._unresolved.clear()
        self._res_writer.clear()
        self._res_readers.clear()
        self._last_barrier = None
        self._lane_counts.clear()
        return pending

    def host_task(self, fn: Callable, *, label: str = "host"
                  ) -> StepFuture:
        """Run ``fn`` on the host pool (checkpoint serialization, probe
        readback, drift sampling — anything that never launches a
        collective), overlapped with the dispatch queue.  Failures
        surface as typed :class:`EngineTaskError` on the future."""
        with self._cv:
            if self._closed:
                raise EngineClosedError(
                    f"engine {self.name!r} is closed")
            fut = self._offer_host_locked(fn, label, "host")
            self._ensure_threads_locked()
            self._cv.notify_all()
        return fut

    def call_later(self, delay_s: float, fn: Callable, *,
                   label: str = "timer") -> None:
        """Run cheap ``fn`` on the consumer thread after ``delay_s``
        (the serve pump's deadline-coalescing tick — replaces the old
        polling daemon).  Timers are held while quiesced and DROPPED by
        a reform (their scheduling state died with the old mesh: the
        client re-pumps on its next submission)."""
        with self._cv:
            if self._closed:
                raise EngineClosedError(f"engine {self.name!r} is closed")
            heapq.heappush(self._timers, (
                time.monotonic() + max(0.0, float(delay_s)),
                next(self._timer_seq), fn))
            self._ensure_threads_locked()
            self._cv.notify_all()

    def on_reform(self, fn: Callable[["Engine"], None]
                  ) -> Callable[[], None]:
        """Register ``fn(engine)`` to run at the END of every
        :meth:`reform` — the new generation is live and accepting by
        then.  The hook streaming clients use to re-arm timers the
        reform dropped (their scheduling state died with the old mesh,
        but already-queued client work must not wait for fresh traffic
        to notice); they also run at :meth:`resume` — every transition
        back to accepting.  Callbacks survive reforms, must be cheap, and a
        raising callback is swallowed and counted, never allowed to
        fail the reform.  Returns an idempotent unsubscribe callable —
        a client outlived by a shared engine MUST call it at its own
        close, or its dead callback rides every later reform."""
        with self._cv:
            self._reform_cbs.append(fn)

        def _unsubscribe() -> None:
            with self._cv:
                try:
                    self._reform_cbs.remove(fn)
                except ValueError:
                    pass
        return _unsubscribe

    def _offer_host_locked(self, fn, label, stage) -> StepFuture:
        fut = StepFuture(label)
        self._host_q.append(_HostItem(fn=fn, future=fut, label=label,
                                      stage=stage))
        return fut

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the dispatch queue, timers' backlog and host
        pool are all idle.  Returns False on timeout.  (Pending timers
        themselves do not block a drain — they fire work later; a drain
        waits for work already *submitted*.)"""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cv:
            while (self._queued or self._busy or self._host_q
                   or self._host_busy):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(remaining)
        return True

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Pause the consumer at the next task boundary: no new device
        dispatch starts until :meth:`resume` (queued tasks are HELD,
        not failed).  Blocks until the in-flight dispatch finishes
        (bounded by ``timeout``, default the snapshot's
        ``engine_quiesce_s``); returns False if it is still running."""
        t = self.config.engine_quiesce_s if timeout is None else timeout
        deadline = time.monotonic() + t
        with self._cv:
            self._paused = True
            self._cv.notify_all()
            if getattr(threading.current_thread(),
                       "_pa_engine_consumer", None) is self:
                # the consumer quiescing itself: the busy flag it would
                # wait on is its OWN in-flight task (an elastic_step
                # reforming the mesh from inside a dispatch).  That
                # task is, by construction, not mid-device-program — it
                # is in the recovery ladder — so there is nothing to
                # wait out, and waiting would burn the full timeout
                # against ourselves
                return True
            while self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def resume(self) -> None:
        """Un-pause the consumer (the failed-reformation path: the old
        mesh is still the live one).  :meth:`on_reform` callbacks run
        here too: a client that deferred scheduling while the engine
        was quiesced (e.g. a streaming admission that skipped arming
        its tick) must be woken without waiting for fresh traffic."""
        with self._cv:
            self._paused = False
            self._cv.notify_all()
        self._run_reform_cbs()

    def _run_reform_cbs(self) -> None:
        with self._cv:
            cbs = list(self._reform_cbs)
        for fn in cbs:
            try:
                fn(self)
            except BaseException:
                # the documented never-fail contract: an interrupt
                # escaping here would abort reform_all mid-fleet,
                # leaving engines partially reformed with no record
                from .. import obs

                if obs.enabled():
                    obs.counter("engine.callback_errors").inc()

    def reform(self, config: Optional[_config.RuntimeConfig] = None,
               *, timeout: Optional[float] = None) -> int:
        """The elastic reformation boundary: quiesce, fail every
        still-queued dispatch typed (:class:`EngineReformedError` — the
        program it would have issued was compiled for the dead mesh),
        drop timers, retire the old consumer/pool threads, take a
        FRESH :class:`RuntimeConfig` snapshot, and resume under a new
        generation; :meth:`on_reform` callbacks then run against the
        live new generation.  Returns the new generation."""
        self.quiesce(timeout)
        with self._cv:
            self._gen += 1
            gen = self._gen
            # a quiesce-timeout survivor is written off HERE: its
            # consumer skips all state updates once the generation
            # moved (see _run_task), so the busy flag must not keep
            # counting it toward the new generation's depth/drain
            self._busy = False
            pending = self._clear_dag_locked()
            host_pending = [h for h in self._host_q]
            self._host_q.clear()
            self._timers.clear()
            # drop the old generation's dispatch history: its records
            # pin plan objects (and their dead-mesh compiled
            # executables) in meta, and verify paths must see only the
            # live generation (stats' log_truncated already says the
            # log no longer covers the whole run)
            self._log.clear()
            self.config = config if config is not None \
                else _config.current()
            self._workers = max(1, self.config.engine_workers)
            if self._dag_override is None:
                self.dag = bool(self.config.engine_dag)
            if self._starve_override is None:
                self.starve_s = float(self.config.engine_starve_s)
            self._dispatch_thread = None
            self._host_threads = []
            self._paused = False
            self._cv.notify_all()
        err = EngineReformedError(
            f"engine {self.name!r} reformed to generation {gen}: "
            f"queued dispatch dropped (its compiled program targeted "
            f"the previous mesh)", generation=gen)
        dropped_lanes: Dict[int, int] = {}
        for t in pending:
            dropped_lanes[t.lane] = dropped_lanes.get(t.lane, 0) + 1
            t.future._fail(err)
        for h in host_pending:
            h.future._fail(EngineTaskError(h.label, h.stage, err))
        from .. import obs

        if obs.enabled():
            obs.counter("engine.reforms").inc()
            obs.record_event("engine.reform", gen=gen, stage="complete",
                             name=self.name, dropped=len(pending),
                             dropped_host=len(host_pending),
                             dropped_lanes={str(k): v for k, v in
                                            sorted(dropped_lanes.items())})
        self._run_reform_cbs()
        return gen

    def close(self) -> None:
        """Refuse new work, fail everything queued typed, retire the
        threads.  In-flight work finishes (its future resolves)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            pending = self._clear_dag_locked()
            host_pending = list(self._host_q)
            self._host_q.clear()
            self._timers.clear()
            self._reform_cbs.clear()    # a closed engine never
            # reforms; holding client closures would only leak them
            self._cv.notify_all()
        err = EngineClosedError(f"engine {self.name!r} closed")
        for t in pending:
            t.future._fail(err)
        for h in host_pending:
            h.future._fail(EngineTaskError(h.label, h.stage, err))

    # -- the consumer + pool ----------------------------------------------
    def _ensure_threads_locked(self) -> None:
        gen = self._gen
        dev = _cuda_device()
        if self._dispatch_thread is None or not \
                self._dispatch_thread.is_alive():
            self._dispatch_thread = spawn_thread(
                self._loop_dispatch, args=(gen, dev),
                name=f"pa-engine-{self.name}-dispatch-g{gen}")
            # the on_consumer_thread marker: survives reform() nulling
            # _dispatch_thread (the retired consumer may still be
            # finishing an interrupted task)
            self._dispatch_thread._pa_engine_consumer = self
        self._host_threads = [t for t in self._host_threads
                              if t.is_alive()]
        want = self._workers
        need = min(want - len(self._host_threads),
                   len(self._host_q) + 1)
        for i in range(max(0, need)):
            self._host_threads.append(spawn_thread(
                self._loop_host, args=(gen, dev),
                name=f"pa-engine-{self.name}-host{len(self._host_threads)}"
                     f"-g{gen}"))

    def _pick_locked(self, now: float) -> Optional[_Task]:
        """Choose the next ready task, or None if every ready task is
        still waiting on its pack (the consumer then cv-waits: a pack
        completion notifies, and the starvation deadline bounds the
        wait).  Caller holds ``_cv``.

        Order of preference: (1) a STARVED task — queued past
        ``starve_s`` — lowest seq first, picked even if its pack is
        pending (the consumer then blocks on it v1-style: guaranteed
        progress is the floor, lanes only bias above it); (2) the
        pack-ready task with the highest lane, FIFO within a lane."""
        starved = None
        best = None
        starve = self.starve_s
        for seq, t in self._ready.items():
            if now - t.t_enqueue >= starve:
                if starved is None or seq < starved.seq:
                    starved = t
                continue
            if t.pack_future is not None \
                    and not t.pack_future._event.is_set():
                continue
            key = (-t.lane, seq)
            if best is None or key < best[0]:
                best = (key, t)
        if starved is not None:
            self._starved_issues += 1
            return starved
        return best[1] if best is not None else None

    def _loop_dispatch(self, gen: int, device: Optional[int]) -> None:
        _adopt_device(device)
        while True:
            timer_fn = None
            task = None
            with self._cv:
                while True:
                    if self._closed or gen != self._gen:
                        return
                    now = time.monotonic()
                    if not self._paused and self._timers \
                            and self._timers[0][0] <= now:
                        timer_fn = heapq.heappop(self._timers)[2]
                        # a firing tick is in-flight work: quiesce()
                        # must wait it out (a streaming pump mid-tick
                        # submits dispatches — reforming under it
                        # would issue dead-mesh programs)
                        self._busy = True
                        break
                    if not self._paused and self._ready:
                        task = self._pick_locked(now)
                        if task is not None:
                            del self._ready[task.seq]
                            del self._queued[task.seq]
                            self._nblock.pop(task.seq, None)
                            n = self._lane_counts.get(task.lane, 1) - 1
                            if n > 0:
                                self._lane_counts[task.lane] = n
                            else:
                                self._lane_counts.pop(task.lane, None)
                            self._busy = True
                            break
                    wait = None
                    if not self._paused:
                        bounds = []
                        if self._timers:
                            bounds.append(self._timers[0][0] - now)
                        if self._ready:
                            # every ready task awaits its pack: wake at
                            # the earliest starvation deadline (a pack
                            # completion notifies sooner)
                            bounds.append(min(
                                t.t_enqueue + self.starve_s
                                for t in self._ready.values()) - now)
                        if bounds:
                            wait = max(0.0, min(bounds))
                    self._cv.wait(wait)
            if timer_fn is not None:
                try:
                    timer_fn()
                except Exception:
                    from .. import obs

                    if obs.enabled():
                        obs.counter("engine.timer_errors").inc()
                with self._cv:
                    if gen == self._gen:    # stale ticks were written
                        self._busy = False  # off by reform()
                    self._cv.notify_all()
                continue
            self._run_task(task, gen)

    def _run_task(self, task: _Task, gen: int) -> None:
        t0 = time.monotonic()
        out, err = None, None
        operand = _NO_OPERAND
        if task.pack_future is not None:
            # usually resolved already — the DAG pick prefers
            # pack-ready tasks — but a barrier (enqueue order REQUIRED)
            # or a starved task is issued with its pack still pending,
            # and then this is the v1 head-of-line wait: a slow pack
            # stalls the queue behind it, the price of the invariant
            # (packs for later steps keep running on the pool)
            task.pack_future._event.wait()
            perr = task.pack_future.error()
            if perr is not None:
                err = perr
            else:
                operand = task.pack_future._result
        if err is None:
            from ..obs import requestflow

            try:
                # the task's request trace (dispatch meta) is ambient
                # for the whole run: guard.recover / retry / fault
                # records fired inside journal under the request's id
                # even though they execute on the consumer thread
                with requestflow.installed(task.meta.get("trace")):
                    out = (task.run() if operand is _NO_OPERAND
                           else task.run(operand))
                task.future.device_event = device_event()
            except BaseException as e:
                # NEVER re-raise on the consumer: a dead consumer
                # strands every queued future with no symptom.  The
                # waiter re-raises from the future (KeyboardInterrupt
                # included — the synchronous paths surface it).
                err = e
        t1 = time.monotonic()
        with self._cv:
            stale = gen != self._gen
            if not stale:
                self._busy = False
                self._issue_seq += 1
                self._dispatched += 1
                self._dispatch_busy_s += t1 - t0
                if task.seq < self._max_issued_seq:
                    self._out_of_order += 1
                else:
                    self._max_issued_seq = task.seq
                # the logged meta is a shallow-copy SNAPSHOT: the log
                # is immutable certification history once the dispatch
                # completes, and must not pin the caller's (possibly
                # plan-holding) dict against later mutation or reuse
                self._log.append(DispatchRecord(
                    enqueue_seq=task.seq, issue_seq=self._issue_seq,
                    label=task.label,
                    outcome="ok" if err is None else type(err).__name__,
                    queued_s=t0 - task.t_enqueue, run_s=t1 - t0,
                    meta=dict(task.meta),
                    lane=task.lane, chain=task.chain,
                    barrier=task.barrier,
                    reads=tuple(sorted(task.reads)),
                    writes=tuple(sorted(task.writes)),
                    deps=task.deps))
                self._complete_locked(task)
            self._cv.notify_all()
            lane_depth = self._lane_counts.get(task.lane, 0)
            ready_n = len(self._ready)
        from .. import obs

        if not stale and obs.enabled():
            obs.gauge("engine.lanes", engine=self.name,
                      lane=str(task.lane),
                      state="queued").set(lane_depth)
            obs.gauge("engine.ready_tasks",
                      engine=self.name).set(ready_n)
        if stale:
            # a quiesce-timeout survivor finishing after a reform: its
            # generation's accounting was already written off, and its
            # lower enqueue_seq must NOT land after new-generation log
            # records (a spurious DispatchOrderError on a healthy
            # engine) — resolve the future, touch nothing else
            if obs.enabled():
                obs.counter("engine.stale_dispatches").inc()
        if err is None:
            task.future._fulfill(out)
        else:
            task.future._fail(err)

    def _loop_host(self, gen: int, device: Optional[int]) -> None:
        _adopt_device(device, own_stream=True)
        while True:
            with self._cv:
                while True:
                    if self._closed or gen != self._gen:
                        return
                    if self._host_q:
                        item = self._host_q.popleft()
                        self._host_busy += 1
                        break
                    self._cv.wait()
            t0 = time.monotonic()
            out, err = None, None
            try:
                out = item.fn()
            except BaseException as e:
                err = EngineTaskError(item.label, item.stage, e)
            t1 = time.monotonic()
            # resolve BEFORE the notify: the consumer's "some ready
            # task's pack completed?" wake-up re-checks pack futures
            # under _cv — notifying first would let it observe this
            # pack still unresolved, wait again, and never be
            # re-notified (drain() only needs the busy decrement, which
            # still precedes its wake)
            if err is None:
                item.future._fulfill(out)
            else:
                item.future._fail(err)
            with self._cv:
                self._host_busy -= 1
                self._host_done += 1
                self._host_busy_s += t1 - t0
                self._cv.notify_all()
            # an idle worker must not keep its last item alive: the item's
            # closure holds its batch (a served batch: the tickets and
            # their results on the card) until the next item arrives
            item = out = err = None


# ---------------------------------------------------------------------------
# the per-process engine registry (one shared engine per name)
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_engines: Dict[str, Engine] = {}


def get_engine(name: str = "default") -> Engine:
    """The process's shared engine under ``name`` (built lazily).  One
    mesh should funnel through ONE engine — the ordering guarantee is
    per-queue — so clients default to the shared ``"default"`` engine
    unless they own a genuinely separate mesh."""
    with _registry_lock:
        e = _engines.get(name)
        if e is None or e._closed:
            e = Engine(name)
            _engines[name] = e
        return e


def engines() -> Dict[str, Engine]:
    with _registry_lock:
        return dict(_engines)


def quiesce_all(timeout: Optional[float] = None) -> bool:
    """Quiesce every registered engine (elastic calls this BEFORE
    membership consensus: no dispatch may be mid-flight while the mesh
    changes under it).  Returns False if any in-flight dispatch did not
    finish in time."""
    ok = True
    for e in engines().values():
        ok = e.quiesce(timeout) and ok
    return ok


def reform_all(config: Optional[_config.RuntimeConfig] = None) -> int:
    """Reform every registered engine (elastic calls this after
    re-planning: the reindexed coordinator gets fresh engines).
    Returns how many engines were reformed."""
    es = engines()
    for e in es.values():
        e.reform(config)
    return len(es)


def resume_all() -> None:
    """Resume every registered engine (the failed-reformation path:
    the old mesh is still the live one)."""
    for e in engines().values():
        e.resume()


def shutdown_all() -> None:
    for e in engines().values():
        e.close()
    with _registry_lock:
        _engines.clear()


def _reset_for_tests() -> None:
    shutdown_all()
