"""Hierarchical timers + profiler annotation — the TimerOutputs subsystem.

PyTorch counterpart of the JAX package's ``utils/timers.py``.  Reference:
every ``Pencil`` owns (or shares) a ``TimerOutput`` (``Pencils.jl:191,434``)
and the hot sections are wrapped in ``@timeit_debug timer "label"`` —
"transpose!", "pack data", "unpack data", I/O ops
(``Transpositions.jl:173-177``, ``mpi_io.jl:338-424``).  Timings are
compiled out by default and enabled with
``TimerOutputs.enable_debug_timings`` (``docs/src/PencilArrays_timers.md``).

Two channels, as in the JAX package:

* :func:`torch.profiler.record_function` annotations are ALWAYS emitted
  (the role of ``jax.named_scope``): they name the section in a
  ``torch.profiler`` trace, which is where device time must be read,
  since CUDA launches return before the device finishes.
* A host-side hierarchical :class:`TimerOutput` measuring wall time,
  attached to pencils via ``Pencil(timer=...)`` and disabled by default
  exactly like the reference's ``@timeit_debug``; enable with
  :func:`enable_debug_timings`.  As in the JAX package, a section
  measures what the host spends in it: on the card, the enqueue of its
  kernels, not their device time (read that in the profiler trace).

THREAD SAFETY: one :class:`TimerOutput` may be entered concurrently from
several threads.  Each thread times into its OWN tree rooted at a
per-thread root — the section stack is thread-local state, so concurrent
``timeit`` blocks can never corrupt each other's nesting — and
:meth:`report`/:meth:`snapshot` merge the per-thread trees on demand.
:meth:`merge` folds another timer (or a :meth:`snapshot` dict, e.g. one
shipped from a peer process) into this one for cross-timer and
cross-process aggregation.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional, Union

import torch

__all__ = [
    "TimerOutput",
    "timeit",
    "enable_debug_timings",
    "disable_debug_timings",
    "timings_enabled",
]

_ENABLED = False


def enable_debug_timings() -> None:
    """Reference ``TimerOutputs.enable_debug_timings(PencilArrays)``."""
    global _ENABLED
    _ENABLED = True


def disable_debug_timings() -> None:
    global _ENABLED
    _ENABLED = False


def timings_enabled() -> bool:
    return _ENABLED


class _Node:
    __slots__ = ("ncalls", "total", "children")

    def __init__(self):
        self.ncalls = 0
        self.total = 0.0
        self.children: Dict[str, "_Node"] = {}


def _merge_node(dst: _Node, src: _Node) -> None:
    dst.ncalls += src.ncalls
    dst.total += src.total
    # src may be a LIVE per-thread tree another thread is extending
    # (timing threads never take a lock — that is what keeps the hot
    # path free).  Snapshot the child list with a bounded retry: a
    # concurrent setdefault during the copy raises RuntimeError, never
    # corrupts.  Totals of in-flight sections read slightly stale, which
    # is inherent to reporting while timing.
    items = None
    for _ in range(100):
        try:
            items = list(src.children.items())
            break
        except RuntimeError:
            continue  # caught mid-insert; the next pass sees a superset
    if items is None:
        # pathological insert churn outlived every retry: take one
        # last C-level copy rather than silently dropping the subtree
        try:
            items = list(dict(src.children).items())
        except RuntimeError:
            items = []
    for label, child in items:
        _merge_node(dst.children.setdefault(label, _Node()), child)


def _node_to_dict(node: _Node) -> dict:
    return {
        "ncalls": node.ncalls,
        "seconds": node.total,
        "children": {label: _node_to_dict(c)
                     for label, c in node.children.items()},
    }


def _merge_dict(dst: _Node, d: dict) -> None:
    dst.ncalls += int(d.get("ncalls", 0))
    dst.total += float(d.get("seconds", 0.0))
    for label, c in (d.get("children") or {}).items():
        _merge_dict(dst.children.setdefault(label, _Node()), c)


class TimerOutput:
    """Hierarchical wall timer (host-side wall time).

    Safe for concurrent use: the active-section stack lives in
    thread-local storage (a shared stack would corrupt the nesting:
    two threads interleaving push/pop detached whole subtrees), and each
    thread accumulates into its own root.  Reporting merges the
    per-thread trees; :meth:`merge` aggregates across timers/processes.
    Reporting WHILE other threads are timing is crash-free (racy child
    lists are re-snapshotted) but reads in-flight sections slightly
    stale — a wall-clock report, not a consistent cut.
    """

    def __init__(self, name: str = "root"):
        self.name = name
        self._lock = threading.Lock()
        self._tls = threading.local()
        # (thread, root) per live timing thread; exited threads' trees
        # are folded into _retired on the next merge — thread-pool churn
        # (the I/O layer spawns pools per write) must not grow state or
        # report cost without bound, and must not LOSE finished timings
        self._roots: list = []
        self._retired = _Node()
        self._gen = 0            # bumped by reset(): stale stacks rebuild

    def _stack(self) -> list:
        tls = self._tls
        if getattr(tls, "gen", None) != self._gen:
            root = _Node()
            with self._lock:
                self._roots.append((threading.current_thread(), root))
            tls.stack = [root]
            tls.gen = self._gen
        return tls.stack

    @contextmanager
    def __call__(self, label: str):
        stack = self._stack()
        node = stack[-1].children.setdefault(label, _Node())
        stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            node.total += time.perf_counter() - t0
            node.ncalls += 1
            stack.pop()

    def reset(self) -> None:
        with self._lock:
            self._roots.clear()
            self._retired = _Node()
            self._gen += 1

    def _merged_root(self) -> _Node:
        out = _Node()
        with self._lock:
            live = []
            for thread, root in self._roots:
                if thread.is_alive():
                    live.append((thread, root))
                else:
                    # quiescent (its thread ran to completion): fold the
                    # finished tree into the retired accumulator once
                    _merge_node(self._retired, root)
            self._roots = live
            _merge_node(out, self._retired)
            roots = [r for _, r in live]
        for r in roots:
            _merge_node(out, r)
        return out

    @property
    def _root(self) -> _Node:
        """Merged view over the per-thread trees (kept for callers that
        predate the thread-local redesign; read-only by construction —
        mutations would land on a throwaway merge)."""
        return self._merged_root()

    def merge(self, other: Union["TimerOutput", dict]) -> "TimerOutput":
        """Fold ``other`` — another :class:`TimerOutput`, or a
        :meth:`snapshot` dict (the cross-process wire format: a peer
        JSON-ships its snapshot and process 0 merges) — into this
        timer.  Returns ``self`` for chaining."""
        src = other.snapshot() if isinstance(other, TimerOutput) else other
        root = self._stack()[0]
        for label, c in (src.get("children") or {}).items():
            _merge_dict(root.children.setdefault(label, _Node()), c)
        return self

    def snapshot(self) -> dict:
        """JSON-serializable merged tree ``{ncalls, seconds, children}``
        — the :meth:`merge` wire format."""
        return _node_to_dict(self._merged_root())

    # -- reporting ---------------------------------------------------------
    def _lines(self, node: _Node, depth: int, out):
        for label, child in sorted(node.children.items(),
                                   key=lambda kv: -kv[1].total):
            out.append(
                f"{'  ' * depth}{label:<{40 - 2 * depth}} "
                f"{child.ncalls:>8} {child.total * 1e3:>12.3f} ms"
            )
            self._lines(child, depth + 1, out)

    def report(self) -> str:
        out = [f"TimerOutput({self.name})  —  host wall time",
               f"{'section':<40} {'ncalls':>8} {'time':>15}"]
        self._lines(self._merged_root(), 0, out)
        return "\n".join(out)

    def __repr__(self) -> str:
        return self.report()


@contextmanager
def timeit(timer: Optional[TimerOutput], label: str):
    """``@timeit_debug timer label`` analog: always emits a
    ``torch.profiler.record_function`` range (visible in profiler
    traces); additionally records host wall time when debug timings are
    enabled and a timer is present."""
    ctx = timer(label) if (_ENABLED and timer is not None) else nullcontext()
    with torch.profiler.record_function(label.replace(" ", "_")):
        with ctx:
            yield
