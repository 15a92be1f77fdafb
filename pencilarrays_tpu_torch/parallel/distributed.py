"""Process-group bootstrap and the ``mpiexec`` analog.

The reference runs SPMD under ``mpiexec`` with MPI as the wire
(``test/runtests.jl:48-53``); the port does the same with one process per
device over ``torch.distributed``:

* :func:`initialize` joins this process to a group (NCCL on the card, gloo
  on the CPU) through a ``file://`` rendezvous, so no TCP port is fixed and
  concurrent jobs on one host cannot collide;
* :class:`RankPool` starts ``nprocs`` ranks once and runs functions on all
  of them, the role ``mpiexec -n`` plays for the reference's tests;
  :func:`spawn` is the one-shot form.

Functions sent to a pool are pickled by import path, so they must be
module-level functions of an importable module.

Resilience, as in the JAX package's ``parallel/distributed.py``: the
rendezvous is the first cross-process meeting of a job, and the peer that
hosts it may not be up yet when a restarted worker arrives, so
:func:`initialize` retries transient failures under a
:class:`~pencilarrays_tpu_torch.resilience.RetryPolicy` (bounded
exponential backoff, not a hang and not a crash) and consults the
``dist.initialize`` fault point; :func:`sync_global_devices`, the named
barrier of the I/O drivers and the checkpoint manager, consults the
``barrier`` point.  With the integrity guard on, each rendezvous attempt
and each barrier wait runs under its hang watchdog: a peer that never
arrives leaves a crash bundle and a typed ``HangTimeoutError`` (a
``TimeoutError``, which the retry policy backs off against) instead of
an unexplained stall.  :func:`process_index`, :func:`process_count` and
:func:`is_multiprocess` answer for a process group (the default one unless
given), where a process is a rank; without ``torch.distributed`` they give
the trivial answers.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import re
import shutil
import tempfile
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .. import guard
from ..guard.errors import HangTimeoutError
from ..resilience import faults
from ..resilience.retry import RetryPolicy

__all__ = ["initialize", "finalize", "RankPool", "spawn", "process_index",
           "process_count", "is_multiprocess", "sync_global_devices"]

# rendezvous failures worth retrying (a peer or the store not up yet, a
# dropped connection); configuration errors fail on the first attempt
_TRANSIENT_RENDEZVOUS = re.compile(
    r"unavailable|refused|unreachable|reset|connect|timed.?out|deadline",
    re.IGNORECASE)


def initialize(backend: Optional[str] = None, *,
               init_method: Optional[str] = None, world_size: int = 1,
               rank: int = 0, timeout_s: float = 300.0,
               retry: Optional[RetryPolicy] = None) -> None:
    """Join the default process group (``MPI.Init``).

    ``backend`` defaults to ``"nccl"`` when CUDA is available, else
    ``"gloo"``.  ``init_method`` defaults to a fresh ``file://`` rendezvous,
    which is valid only for ``world_size == 1``; a multi-rank job passes
    the one file (or ``tcp://`` address) every rank shares.

    The rendezvous is retried on transient failures under ``retry``
    (default :meth:`~pencilarrays_tpu_torch.resilience.RetryPolicy.from_env`):
    a ``RuntimeError`` whose message reads like an unreachable peer or a
    timeout is raised as ``ConnectionError`` and backed off against, any
    other error fails at once; after a failed attempt any partly built
    default group is destroyed, so the next attempt can bind again."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None:
        if world_size != 1:
            raise ValueError("a multi-rank job needs a shared init_method")
        fd, path = tempfile.mkstemp(prefix="pa_torch_init_")
        os.close(fd)
        os.unlink(path)  # the file store creates it
        init_method = f"file://{path}"
    if backend == "nccl":
        # NCCL communicators bind to the current card of each rank
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())

    def _connect():
        faults.fire("dist.initialize", init_method=init_method, rank=rank)
        try:
            with guard.watchdog("dist.initialize", kind="dist",
                                init_method=init_method, rank=rank):
                dist.init_process_group(backend, init_method=init_method,
                                        world_size=world_size, rank=rank,
                                        timeout=timedelta(seconds=timeout_s))
        except HangTimeoutError:
            _reset_partial_state()
            raise
        except RuntimeError as e:
            _reset_partial_state()
            if _TRANSIENT_RENDEZVOUS.search(str(e)):
                raise ConnectionError(str(e)) from e
            raise
        except Exception:
            _reset_partial_state()
            raise

    (retry or RetryPolicy.from_env()).call(_connect, label="dist.initialize")


def _reset_partial_state() -> None:
    """Destroy a default group a failed rendezvous left behind, so a
    retry can join again (best effort)."""
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except (RuntimeError, ValueError):
            pass


def process_index(group=None) -> int:
    """This process's rank in ``group`` (the default group; 0 without
    ``torch.distributed``) — the JAX package's ``process_index``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def process_count(group=None) -> int:
    """The ranks in ``group`` (1 without ``torch.distributed``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def is_multiprocess(group=None) -> bool:
    return process_count(group) > 1


_SIDE_GROUPS: list = []


def side_group(ranks=None):
    """A new process group over ``ranks`` of the default group (default:
    every rank), for the collectives a thread other than the engine's
    consumer issues, such as the barriers of a host-pool checkpoint
    save: two threads issuing collectives on one group can interleave
    them in a different order on two ranks and deadlock.  ``new_group``
    is collective over the default group, so every rank calls this with
    the same ``ranks``, on the same thread and in the same order as its
    other group creations (up front, on the main thread).  ``None`` on
    one rank, where no collective is issued."""
    if not is_multiprocess():
        return None
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else sorted(int(r) for r in ranks)
    g = dist.new_group(ranks)
    _SIDE_GROUPS.append(g)
    return g


def is_side_group(group) -> bool:
    """Whether ``group`` was made by :func:`side_group`."""
    return any(group is g for g in _SIDE_GROUPS)


def sync_global_devices(name: str = "pa_barrier", group=None) -> None:
    """Named barrier of ``group``'s ranks (``MPI.Barrier``).  Consults
    the ``barrier`` fault point first (so drills reach it on one rank
    too), then waits in ``dist.barrier`` when the group has more than one
    rank, under the guard's hang watchdog when the guard is on."""
    faults.fire("barrier", name=name)
    if is_multiprocess(group):
        with guard.watchdog(f"barrier:{name}", kind="barrier"):
            dist.barrier(group=group)


def finalize() -> None:
    """Leave the default process group (``MPI.Finalize``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, nprocs: int, backend: str, init_file: str,
               timeout_s: float, tasks, results) -> None:
    """Body of one pool rank: join the group, then run tasks until the
    ``None`` sentinel arrives."""
    torch.set_num_threads(1)
    initialize(backend, init_method=f"file://{init_file}",
               world_size=nprocs, rank=rank, timeout_s=timeout_s)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args, kwargs = item
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:  # reported to the caller, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        finalize()


class RankPool:
    """``nprocs`` long-lived ranks in one process group.

    ``run(fn, *args)`` calls ``fn(*args)`` on every rank and returns the
    per-rank results in rank order.  A rank that raises, or a call that
    does not finish within ``timeout_s``, tears the pool down and raises
    here; the next ``run`` starts a fresh pool.  Use as a context manager,
    or call :meth:`close`."""

    def __init__(self, nprocs: int, backend: str = "gloo", *,
                 timeout_s: float = 300.0):
        if nprocs < 1:
            raise ValueError(f"nprocs must be positive, got {nprocs}")
        self.nprocs = int(nprocs)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        self._ctx = mp.get_context("spawn")
        self._procs: Optional[List] = None
        self._tasks: List = []
        self._results = None
        self._dir: Optional[str] = None

    def _start(self) -> None:
        self._dir = tempfile.mkdtemp(prefix="pa_torch_pool_")
        init_file = os.path.join(self._dir, "rendezvous")
        self._results = self._ctx.Queue()
        self._tasks = [self._ctx.Queue() for _ in range(self.nprocs)]
        self._procs = []
        for r in range(self.nprocs):
            p = self._ctx.Process(
                target=_rank_main,
                args=(r, self.nprocs, self.backend, init_file,
                      self.timeout_s, self._tasks[r], self._results),
                daemon=True)
            p.start()
            self._procs.append(p)

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        if self._procs is None:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: List[Any] = [None] * self.nprocs
        errors = []
        try:
            for _ in range(self.nprocs):
                rank, ok, value = self._results.get(timeout=self.timeout_s)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break  # the other ranks may be stuck in a collective
        except queue.Empty:
            errors.append(f"{fn.__name__} did not finish on all ranks "
                          f"within {self.timeout_s} s")
        if errors:
            self._terminate()
            raise RuntimeError("\n".join(errors))
        return out

    def _terminate(self) -> None:
        for p in self._procs or ():
            p.terminate()
        for p in self._procs or ():
            p.join(timeout=10)
        self._cleanup()

    def _cleanup(self) -> None:
        for q in self._tasks + ([self._results] if self._results else []):
            q.close()
            q.join_thread()
        self._procs, self._tasks, self._results = None, [], None
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def close(self) -> None:
        """Stop every rank (sentinel, then join; terminate stragglers)."""
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo",
          timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` once on ``nprocs`` fresh ranks (``mpiexec -n``)
    and return the per-rank results in rank order."""
    with RankPool(nprocs, backend, timeout_s=timeout_s) as pool:
        return pool.run(fn, *args)
