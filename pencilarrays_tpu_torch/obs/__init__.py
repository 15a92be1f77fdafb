"""Telemetry: metrics, the event journal, spans and profiling (the core
of the JAX package's ``obs/``).

* :mod:`~pencilarrays_tpu_torch.obs.metrics` — counters, gauges,
  histograms; JSON snapshot and Prometheus textfile exporters;
* :mod:`~pencilarrays_tpu_torch.obs.events` — the flight recorder, an
  append-only JSONL journal in the JAX package's schema;
* :mod:`~pencilarrays_tpu_torch.obs.tracing` — spans over
  ``torch.profiler``, NVTX and the host timers; ``profile`` captures;
* :mod:`~pencilarrays_tpu_torch.obs.schema` — ``lint_event``,
  ``lint_journal``;
* :mod:`~pencilarrays_tpu_torch.obs.correlate` and
  :mod:`~pencilarrays_tpu_torch.obs.requestflow` — the cross-rank and
  per-request keys stamped into every record.

Off by default and one cached probe when off; enable with
``PENCILARRAYS_TPU_OBS`` (``1``: journal under
``PENCILARRAYS_TPU_OBS_DIR`` or ``./pa_obs``; any other value is the
journal directory) or :func:`enable`.  The drift tracker, the timeline
merger, the mesh aggregator, straggler detection and the ``pa-obs``
command line are not ported yet (ROADMAP Queue 1 item 7(b)): their
entry points here raise.
"""

from __future__ import annotations

from .events import (  # noqa: F401
    ENV_VAR,
    disable,
    enable,
    enabled,
    journal_dir,
    read_journal,
    record_event,
    run_id,
)
from .metrics import (  # noqa: F401
    counter,
    gauge,
    histogram,
    registry,
    snapshot,
    to_prometheus,
    write_prometheus,
    write_snapshot,
)
from .tracing import io_op, profile, span  # noqa: F401
from .schema import lint_event, lint_journal  # noqa: F401
from .correlate import current_step, next_step, set_plan, step  # noqa: F401
from .requestflow import (  # noqa: F401
    current_trace,
    list_requests,
    reconstruct_request,
)

__all__ = [
    "ENV_VAR",
    "enabled",
    "enable",
    "disable",
    "journal_dir",
    "run_id",
    "record_event",
    "read_journal",
    "counter",
    "gauge",
    "histogram",
    "registry",
    "snapshot",
    "write_snapshot",
    "to_prometheus",
    "write_prometheus",
    "span",
    "profile",
    "io_op",
    "lint_event",
    "lint_journal",
    "current_step",
    "next_step",
    "step",
    "set_plan",
    "current_trace",
    "reconstruct_request",
    "list_requests",
    "drift_tracker",
    "drift_report",
    "record_hop_sample",
    "merge_journals",
    "to_trace",
    "write_trace",
]

_LATER = ("not ported yet: ROADMAP.md Queue 1, item 7(b), the rest of obs/ "
          "(drift, timeline, aggregate, straggler, the pa-obs command line)")


def _later(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"obs.{name}() is {_LATER}")
    fn.__name__ = name
    return fn


drift_tracker = _later("drift_tracker")
drift_report = _later("drift_report")
record_hop_sample = _later("record_hop_sample")
merge_journals = _later("merge_journals")
to_trace = _later("to_trace")
write_trace = _later("write_trace")
