"""Cost-model drift tracker: predicted bytes against measured time, per
hop (the JAX package's ``obs/drift.py``, the same report).

:func:`~pencilarrays_tpu_torch.parallel.transpositions.transpose_cost`
prices each hop's bytes; what the model cannot promise is that bytes
keep translating to the same time (a library upgrade, a topology
change, a busy link).  This tracker pairs every hop's predicted bytes
with measured seconds, fits an effective bandwidth per source class
over its hops, and gives each hop its drift ratio

    ``drift = measured_s / (predicted_bytes / fitted_bandwidth)``

(1.0: the byte model explains the timing).

Sample sources, best first (the report keeps one per hop):

* ``benchtime`` — the K-differenced device protocol
  (``utils/benchtime.py``, CUDA events on the card), via
  :func:`measure_transpose`;
* ``auto_measure`` — ``Auto(mode="measure")`` candidate timings (the same
  protocol, forward + back pairs, halved);
* ``dispatch`` — the host wall time of each observed ``transpose`` call:
  free, but on the card a LOWER bound on the hop's time (a dispatch
  returns once its kernels are enqueued), so dispatch samples are fitted
  and reconciled only among themselves and never enter the
  device-protocol fit.

The route planner and the FFT planner's decomposition verdict read the
trusted sources only (``parallel/routing.py`` ``trusted_drift_hops``).
Thread-safe; per-hop state is (count, total, min, last), and the report
uses minima, as the bench protocol does.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["DriftTracker", "drift_tracker", "record_hop_sample",
           "drift_report", "measure_transpose"]

_SOURCE_RANK = {"benchtime": 0, "auto_measure": 1, "dispatch": 2}


class DriftTracker:
    """Accumulate (hop, source) timing samples against predicted bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[tuple, dict] = {}
        self._version = 0

    def version(self) -> int:
        """Monotonic TRUSTED-sample-state counter (bumped by reset and
        by every non-``dispatch`` record): consumers that cache
        decisions derived from the report — the reshard route planner's
        edge weights — key on it so fresh device-protocol samples
        invalidate stale plans.  Per-dispatch samples deliberately do
        NOT bump it: the planner ignores them, and with obs armed every
        eager hop records one — bumping would churn the plan cache on
        every transpose.  0 means no trusted sample has ever landed."""
        with self._lock:
            return self._version

    def record(self, hop: str, predicted_bytes: int, measured_s: float,
               source: str = "dispatch") -> None:
        if source not in _SOURCE_RANK:
            raise ValueError(
                f"unknown drift source {source!r}; expected one of "
                f"{sorted(_SOURCE_RANK)}")
        measured_s = float(measured_s)
        key = (str(hop), source)
        with self._lock:
            if source != "dispatch":
                self._version += 1
            s = self._samples.get(key)
            if s is None:
                self._samples[key] = {
                    "hop": str(hop), "source": source,
                    "predicted_bytes": int(predicted_bytes),
                    "count": 1, "total_s": measured_s,
                    "min_s": measured_s, "last_s": measured_s,
                }
            else:
                s["predicted_bytes"] = int(predicted_bytes)
                s["count"] += 1
                s["total_s"] += measured_s
                s["min_s"] = min(s["min_s"], measured_s)
                s["last_s"] = measured_s

    def reset(self) -> None:
        with self._lock:
            self._version += 1
            self._samples.clear()

    @staticmethod
    def _fit(reps) -> Optional[float]:
        tot_bytes = sum(s["predicted_bytes"] for s in reps)
        tot_s = sum(s["min_s"] for s in reps)
        return (tot_bytes / tot_s) if tot_s > 0 and tot_bytes > 0 else None

    def report(self) -> dict:
        """Per-hop predicted-vs-measured reconciliation.

        For each hop the best-ranked source wins.  Bandwidths are fitted
        PER SOURCE CLASS (total predicted bytes / total min seconds,
        byte-weighted): ``fitted_bytes_per_s`` over the trustworthy
        device-protocol sources (benchtime/auto_measure) and
        ``dispatch_fitted_bytes_per_s`` over the dispatch proxies — the
        two must never mix, because an async dispatch time is a LOWER
        bound on wire time and one enqueue-timed hop in a shared fit
        would invert every other hop's verdict.  Each hop's ``drift`` is
        its measured min over the time its own class's fit predicts for
        its bytes.  Hops with zero predicted bytes (local permutes) are
        reported with ``drift: None`` — nothing on the wire to
        reconcile."""
        with self._lock:
            samples = [dict(s) for s in self._samples.values()]
        best: Dict[str, dict] = {}
        for s in samples:
            cur = best.get(s["hop"])
            if cur is None or (_SOURCE_RANK[s["source"]]
                               < _SOURCE_RANK[cur["source"]]):
                best[s["hop"]] = s
        wired = [s for s in best.values()
                 if s["predicted_bytes"] > 0 and s["min_s"] > 0]
        bw_trusted = self._fit([s for s in wired
                                if s["source"] != "dispatch"])
        bw_dispatch = self._fit([s for s in wired
                                 if s["source"] == "dispatch"])
        hops = {}
        for hop, s in sorted(best.items()):
            entry = {
                "source": s["source"],
                "predicted_bytes": s["predicted_bytes"],
                "measured_s": s["min_s"],
                "last_s": s["last_s"],
                # cumulative sum: lets the mesh aggregator window a
                # rate ((Δtotal)/(Δcount) between folds) so late-onset
                # degradation is visible despite the all-time min
                "total_s": s["total_s"],
                "count": s["count"],
                "bytes_per_s": (s["predicted_bytes"] / s["min_s"]
                                if s["min_s"] > 0 and s["predicted_bytes"]
                                else None),
                "drift": None,
            }
            bw = bw_dispatch if s["source"] == "dispatch" else bw_trusted
            if bw and s["predicted_bytes"] > 0 and s["min_s"] > 0:
                entry["drift"] = s["min_s"] / (s["predicted_bytes"] / bw)
            hops[hop] = entry
        return {"fitted_bytes_per_s": bw_trusted,
                "dispatch_fitted_bytes_per_s": bw_dispatch,
                "hops": hops}


drift_tracker = DriftTracker()


def record_hop_sample(hop: str, predicted_bytes: int, measured_s: float,
                      source: str = "dispatch") -> None:
    """Feed one sample into the process-wide tracker and journal it
    (non-``dispatch`` sources only — per-dispatch samples would flood
    the journal; they are visible through the metrics snapshot)."""
    drift_tracker.record(hop, predicted_bytes, measured_s, source)
    if source != "dispatch":
        from .events import record_event

        record_event("drift.sample", hop=hop,
                     predicted_bytes=int(predicted_bytes),
                     measured_s=float(measured_s), source=source)


def drift_report() -> dict:
    return drift_tracker.report()


def measure_transpose(src, dest, *, method=None, k0: int = 1, k1: int = 8,
                      repeats: int = 3) -> dict:
    """Measure one hop with the benchtime protocol and feed the tracker
    (source ``benchtime``).  ``src`` is a PencilArray, ``dest`` the
    target Pencil; the timed body is a forward + back pair (shape
    preserving, as the K-differenced protocol needs), halved to per-hop
    seconds.  Every rank of the topology calls it."""
    from ..parallel import transpositions as tr
    from ..utils.benchtime import device_seconds_per_iter

    pin = src.pencil
    m = tr.resolve_method(pin, dest, src.extra_dims, src.dtype,
                          method if method is not None else tr.Auto())
    R = tr.assert_compatible(pin, dest)
    nx = src.ndims_extra

    def pair(d):
        return tr._hop(tr._hop(d, pin, dest, nx, m), dest, pin, nx, m)

    t_pair = device_seconds_per_iter(pair, src.data, k0=k0, k1=k1,
                                     repeats=repeats)
    cost = tr.transpose_cost(pin, dest, src.extra_dims, src.dtype, m) \
        if R is not None else {}
    nbytes = sum(v["bytes"] for v in cost.values())
    # the dtype rides the label: the dispatch tap keys the same hop with
    # src.dtype, and source ranking only upgrades equal keys
    hop = tr._hop_label(pin, dest, m, src.dtype)
    record_hop_sample(hop, nbytes, t_pair / 2.0, source="benchtime")
    return {"hop": hop, "predicted_bytes": nbytes, "seconds": t_pair / 2.0}
