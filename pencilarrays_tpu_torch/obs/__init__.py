"""Telemetry: metrics, the event journal, spans and profiling, drift,
and the mesh observability plane (the JAX package's ``obs/``).

* :mod:`~pencilarrays_tpu_torch.obs.metrics` — counters, gauges,
  histograms; JSON snapshot and Prometheus textfile exporters;
* :mod:`~pencilarrays_tpu_torch.obs.events` — the flight recorder, an
  append-only JSONL journal in the JAX package's schema;
* :mod:`~pencilarrays_tpu_torch.obs.tracing` — spans over
  ``torch.profiler`` and the host timers, with ``span.seconds`` in
  device seconds on the card; no NVTX sink of its own (Nsight users wrap
  the run in ``torch.autograd.profiler.emit_nvtx()``); ``profile``
  captures;
* :mod:`~pencilarrays_tpu_torch.obs.schema` — ``lint_event``,
  ``lint_journal``;
* :mod:`~pencilarrays_tpu_torch.obs.drift` — the cost-model drift
  tracker (predicted bytes against measured seconds per hop), which
  steers the route and decomposition planners;
* :mod:`~pencilarrays_tpu_torch.obs.correlate` and
  :mod:`~pencilarrays_tpu_torch.obs.requestflow` — the cross-rank and
  per-request keys stamped into every record, and one request's
  reconstructed timeline;
* :mod:`~pencilarrays_tpu_torch.obs.timeline` — N ranks' journals merged
  into one causally ordered, skew-corrected story, and its Chrome trace;
* :mod:`~pencilarrays_tpu_torch.obs.straggler` — which rank drags a hop;
* :mod:`~pencilarrays_tpu_torch.obs.aggregate` — every rank's metrics
  folded over a KV store (``cluster.kv.FileKV``) into one
  ``mesh_metrics.json``;
* ``python -m pencilarrays_tpu_torch.obs`` — the JAX package's
  ``pa-obs`` command line.

Off by default and one cached probe when off (a span with no profiler
running and no timer to feed enters nothing); enable with
``PENCILARRAYS_TPU_OBS`` (``1``: journal under
``PENCILARRAYS_TPU_OBS_DIR`` or ``./pa_obs``; any other value is the
journal directory) or :func:`enable`.  With the cluster layer armed too,
each rank's coordinator starts a :class:`~.aggregate.MeshAggregator`.
"""

from __future__ import annotations

from .events import (  # noqa: F401
    ENV_VAR,
    disable,
    enable,
    enabled,
    journal_dir,
    journal_to,
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
from .drift import drift_report, drift_tracker, record_hop_sample  # noqa: F401
from .schema import lint_event, lint_journal  # noqa: F401
from .correlate import current_step, next_step, set_plan, step  # noqa: F401
from .timeline import merge_journals, to_trace, write_trace  # noqa: F401
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
