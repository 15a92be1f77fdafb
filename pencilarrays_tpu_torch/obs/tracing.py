"""Span and trace layer (the JAX package's ``obs/tracing.py``).

:func:`span` names a section in every sink that is listening, and costs
one cached check where none is: a ``torch.profiler.record_function``
range while a ``torch.profiler`` runs (the role of ``jax.named_scope``:
it names the section in the trace, and a device operation there can be
put down to the span that launched it); the host
:class:`~pencilarrays_tpu_torch.utils.timers.TimerOutput` when debug
timings are on and a timer is given; and the ``span.seconds`` histogram
when observability is on.  On the card that histogram holds device
seconds: two CUDA events on the current stream, resolved without a
wait, as later spans end and at every metrics snapshot or export.  On
the CPU it holds host seconds.  There is no NVTX sink of its own:
Nsight users wrap the run in ``torch.autograd.profiler.emit_nvtx()``,
which gives every ``record_function`` range, spans included, an NVTX
range.

The port opens spans at its layer boundaries, under the JAX package's
and the reference's names, so that a profile of either reads alike:
``ns.step`` and ``ns.nonlinear`` (the Navier–Stokes model),
``plan.forward``, ``plan.backward`` and ``stage_compute`` (a
``PencilFFTPlan`` and each local transform), ``transpose!`` (one hop),
and ``pack_data``, ``exchange`` and ``unpack_data`` inside it.

:func:`profile` wraps ``torch.profiler.profile`` (the role of
``jax.profiler.trace``), exports a Chrome trace into ``logdir`` and
stamps the capture with the JAX package's metadata file.  :func:`io_op`
times, meters and journals one I/O driver operation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from ..utils import timers as _timers
from . import events as _events
from . import metrics as _metrics

__all__ = ["span", "profile", "io_op"]


@contextmanager
def io_op(event: str, driver: str, path, dataset: str,
          nbytes: Optional[int] = None, **extra):
    """Time + meter + journal one driver operation (``event`` is
    ``"io.write"`` or ``"io.read"``), the one wrapper every I/O driver
    shares.  No-op when observability is disabled.  A raising operation
    is journaled too, with ``ok: false`` and the error, and its bytes
    are not counted.  ``nbytes`` is the GLOBAL dataset size (what the
    event records); the ``io.bytes_written`` counter takes this rank's
    1/P share, so per-rank textfiles sum to the true volume."""
    from .events import enabled, record_event
    from .metrics import counter, histogram

    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    err = None
    try:
        yield
    except BaseException as e:
        err = e
        raise
    finally:
        dt = time.perf_counter() - t0
        kind = event.rsplit(".", 1)[-1]
        if nbytes is not None and err is None:
            from ..cluster import world_size

            counter("io.bytes_written", driver=driver).inc(
                nbytes // max(1, world_size()))
        histogram(f"io.{kind}_seconds", driver=driver).observe(dt)
        payload = dict(path=str(path), dataset=dataset, seconds=dt,
                       driver=driver, ok=err is None, **extra)
        if err is not None:
            payload["error"] = f"{type(err).__name__}: {err}"
        if nbytes is not None:
            payload["bytes"] = nbytes
        record_event(event, **payload)


_OFF = nullcontext()
# (label, start event, end event) of the card's spans, in the order they
# ended; a lock keeps two threads from taking the same pair
_pending: deque = deque()
_pending_lock = threading.Lock()


def span(label: str, timer=None):
    """One section annotation in every sink that is listening (module
    docstring); a drop-in superset of
    :func:`~pencilarrays_tpu_torch.utils.timers.timeit`.  With no
    profiler running, observability off and no timer to feed, it enters
    nothing."""
    timed = timer is not None and _timers._ENABLED
    if not (timed or _profiler_enabled() or _events.enabled()):
        return _OFF
    return _Span(label, timer if timed else None)


class _Span:
    """A span some sink listens to: the sinks are chosen at the enter."""

    __slots__ = ("label", "timer", "_ctx", "_t0", "_ev0")

    def __init__(self, label: str, timer):
        self.label, self.timer = label, timer
        self._ctx, self._t0, self._ev0 = [], None, None

    def __enter__(self):
        if _profiler_enabled():
            self._enter(record_function(self.label.replace(" ", "_")))
        if self.timer is not None:
            self._enter(self.timer(self.label))
        if _events.enabled():
            if torch.cuda.is_initialized():
                dev = torch.cuda.current_device()
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record(torch.cuda.current_stream(dev))
                self._ev0 = (ev0, dev)
            else:
                self._t0 = time.perf_counter()
        return None

    def _enter(self, ctx):
        ctx.__enter__()
        self._ctx.append(ctx)

    def __exit__(self, *exc):
        if self._ev0 is not None:
            ev0, dev = self._ev0
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(dev))
            _pending.append((self.label, ev0, ev1))
            _drain(wait=False)
        elif self._t0 is not None:
            _metrics.histogram("span.seconds", label=self.label).observe(
                time.perf_counter() - self._t0)
        while self._ctx:
            self._ctx.pop().__exit__(*exc)
        return False


def _drain(wait: bool) -> None:
    """Observe the device seconds of the card's finished spans, in the
    order they ended; ``wait`` waits for the rest too (a snapshot or an
    export), else the first unfinished span stops the pass."""
    with _pending_lock:
        while _pending:
            label, ev0, ev1 = _pending[0]
            if wait:
                ev0.synchronize()
                ev1.synchronize()
            elif not (ev1.query() and ev0.query()):
                return
            _pending.popleft()
            _metrics.histogram("span.seconds", label=label).observe(
                ev0.elapsed_time(ev1) / 1e3)


def drain_spans() -> None:
    """Wait for the card's open span timings and record them (every
    metrics snapshot and export calls this first)."""
    if _pending:
        _drain(wait=True)


@contextmanager
def profile(logdir: str, plan=None, **metadata):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where the card is in use) and export it as a Chrome
    trace, ``trace.json``, into ``logdir``; stamp run metadata into
    ``pa_capture_metadata.json`` there (the obs run id, ``metadata``
    kwargs and, for a :class:`~pencilarrays_tpu_torch.ops.fft.
    PencilFFTPlan`, its transforms, schedule and predicted collective
    costs).  Yields the profiler.  The ``profile`` start/stop records
    land in the journal only when observability is on."""
    import os

    import torch

    from ..resilience.fsutil import atomic_write_json
    from .events import record_event, run_id

    logdir = os.fspath(logdir)
    os.makedirs(logdir, exist_ok=True)
    stamp = {"run": run_id(), "t_wall": time.time()}
    if metadata:
        stamp["metadata"] = {k: str(v) for k, v in metadata.items()}
    if plan is not None:
        stamp["plan"] = _plan_stamp(plan)
    atomic_write_json(os.path.join(logdir, "pa_capture_metadata.json"),
                      stamp)
    record_event("profile", dir=logdir, status="start",
                 plan=stamp.get("plan", {}).get("repr"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    finally:
        record_event("profile", dir=logdir, status="stop",
                     seconds=time.perf_counter() - t0)


def _plan_stamp(plan) -> dict:
    """JSON summary of a PencilFFTPlan for capture stamping: every field
    that could be read, and an ``error`` naming each that could not (a
    capture never breaks over its stamp, and says why a field is
    missing)."""
    out = {"repr": repr(plan)}
    fields = (
        ("transforms", lambda: list(plan.transforms)),
        ("shape", lambda: list(plan.shape_physical)),
        ("topo", lambda: list(plan.topology.dims)),
        ("pipeline_chunks", lambda: plan.pipeline_chunks),
        ("steps", lambda: [s[0] for s in plan._steps]),
        ("predicted_costs", plan.collective_costs),
    )
    errors = []
    for key, read in fields:
        try:
            out[key] = read()
        except Exception as e:  # noqa: BLE001 - reported in the stamp
            errors.append(f"{key}: {type(e).__name__}: {e}")
    if errors:
        out["error"] = "; ".join(errors)
    return out
