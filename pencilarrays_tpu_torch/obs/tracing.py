"""Span and trace layer (the JAX package's ``obs/tracing.py``).

:func:`span` names a section in every sink at once: a
``torch.profiler.record_function`` range (the role of
``jax.named_scope``; it names the section in a ``torch.profiler``
trace), an NVTX range on the card, the host
:class:`~pencilarrays_tpu_torch.utils.timers.TimerOutput` when debug
timings are on, and the ``span.seconds`` histogram when observability is
on.  :func:`profile` wraps ``torch.profiler.profile`` (the role of
``jax.profiler.trace``), exports a Chrome trace into ``logdir`` and
stamps the capture with the JAX package's metadata file.  :func:`io_op`
times, meters and journals one I/O driver operation.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Optional

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


def _nvtx(label: str):
    """An NVTX range on the card (a no-op where CUDA is not in use)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.nvtx.range(label)
    return nullcontext()


@contextmanager
def span(label: str, timer=None):
    """One section annotation, every sink (module docstring); a drop-in
    superset of :func:`~pencilarrays_tpu_torch.utils.timers.timeit`."""
    from ..utils.timers import timeit
    from .events import enabled
    from .metrics import histogram

    if not enabled():
        with _nvtx(label), timeit(timer, label):
            yield
        return
    t0 = time.perf_counter()
    try:
        with _nvtx(label), timeit(timer, label):
            yield
    finally:
        histogram("span.seconds", label=label).observe(
            time.perf_counter() - t0)


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
    """JSON summary of a PencilFFTPlan for capture stamping."""
    out = {"repr": repr(plan)}
    try:
        out["transforms"] = list(plan.transforms)
        out["shape"] = list(plan.shape_physical)
        out["topo"] = list(plan.topology.dims)
        out["pipeline_chunks"] = plan.pipeline_chunks
        out["steps"] = [s[0] for s in plan._steps]
        out["predicted_costs"] = plan.collective_costs()
    except Exception:
        pass  # stamping is best-effort; never break a capture
    return out
