"""The precision-downgrade ladder — wire precision as a serving lever (a
copy of the JAX package's ``serve/precision.py``).

Under overload the pressure gate's sacrifices are to reject sheddable
traffic at submit, or to evict it queued.  The ladder is a rung BEFORE
both: serve the request anyway, on a cheaper wire format
(full -> ``bf16`` -> ``fp8_e4m3``), within an accuracy budget the
tenant declared up front (:class:`~pencilarrays_tpu_torch.serve.slo.SLO.
max_rel_l2`).  A degraded answer inside the tenant's own tolerance
beats a typed rejection every time — but ONLY inside that tolerance,
which is why the rung selection is driven by a *calibrated* error
envelope, not by the wire format's nominal epsilon:

* the envelope for each rung is read from ``BENCH_WIRE.json`` (the
  measured wire-precision artifact at the repo root, the one the JAX
  package reads, so both packages make the same rung decisions — env
  override
  ``PENCILARRAYS_TPU_BENCH_WIRE_PATH``, mtime-invalidated): the worst
  measured relative l2 error across every recorded section (plan
  roundtrip, Navier-Stokes and diffusion workloads), doubled as a
  safety margin;
* with no artifact captured yet, conservative fallback constants
  apply — deliberately pessimistic, so an uncalibrated service
  downgrades less, never out of tolerance;
* :func:`select_rung` picks the DEEPEST (cheapest-wire) rung whose
  envelope fits under the tenant's ``max_rel_l2`` and that is strictly
  cheaper than the plan's current wire — a plan already on ``bf16``
  either drops to fp8 (budget permitting) or is left alone.

The service journals every applied downgrade as a fsync-critical
``serve.precision`` record (schema v7) carrying the envelope it
promised and the budget it fit under, so ``pa-obs request <trace>``
reconstructs exactly what precision a degraded answer was served at
and why that was within contract.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = ["PRECISION_LADDER", "wire_error_envelope", "select_rung",
           "wire_depth"]

# the default ladder, shallowest first.  e5m2 is omitted: it costs the
# same bytes as e4m3 with half the mantissa — there is no load level at
# which it is the right trade for served FFT traffic (it exists for
# gradient-shaped dynamic range, selectable via a custom ladder).
PRECISION_LADDER: Tuple[str, ...] = ("bf16", "fp8_e4m3")

# how "deep" (cheap) each wire is: full precision 0, 16-bit wires 1,
# fp8 wires 2.  select_rung only ever moves strictly deeper.
_WIRE_DEPTH = {None: 0, "bf16": 1, "f16": 1,
               "fp8_e4m3": 2, "fp8_e5m2": 2}

# calibrated-fallback envelopes (relative l2), used only when no
# BENCH_WIRE.json exists: ~2x the worst error measured on the dev CPU
# mesh across plan roundtrips and the NS/diffusion workloads.
_FALLBACK_ENVELOPE = {"bf16": 2.5e-2, "f16": 3.0e-3,
                      "fp8_e4m3": 8.0e-2, "fp8_e5m2": 1.6e-1}

_SAFETY = 2.0   # margin over the worst measured rel-l2 in the artifact


def wire_depth(wire_dtype: Optional[str]) -> int:
    """Ladder depth of a canonical wire spelling (0 = full precision)."""
    return _WIRE_DEPTH.get(wire_dtype, 0)


def wire_error_envelope(wire_dtype: str) -> Optional[float]:
    """The calibrated worst-case relative l2 error of serving on
    ``wire_dtype``: ``_SAFETY`` x the largest ``rel_err_l2`` recorded
    for that format anywhere in ``BENCH_WIRE.json`` (plan-roundtrip and
    workload sections alike), or the conservative fallback constant
    when no artifact has been captured.  ``None`` for a format with
    neither (never downgraded onto)."""
    from ..parallel.wire import canonical_wire_dtype
    from ..utils.artifacts import load_verdict_artifact

    wire = canonical_wire_dtype(wire_dtype)
    doc = load_verdict_artifact("BENCH_WIRE.json",
                                "PENCILARRAYS_TPU_BENCH_WIRE_PATH")
    worst = None
    if isinstance(doc, dict):
        for section in doc.values():
            if not isinstance(section, dict):
                continue
            rec = section.get(wire)
            if isinstance(rec, dict) and "rel_err_l2" in rec:
                err = float(rec["rel_err_l2"])
                worst = err if worst is None else max(worst, err)
    if worst is not None and worst > 0:
        return _SAFETY * worst
    return _FALLBACK_ENVELOPE.get(wire)


def select_rung(max_rel_l2: float, current_wire: Optional[str] = None,
                ladder: Sequence[str] = PRECISION_LADDER
                ) -> Optional[Tuple[str, float]]:
    """The deepest ladder rung whose calibrated envelope fits under
    ``max_rel_l2`` AND that is strictly deeper (cheaper wire) than
    ``current_wire``.  Returns ``(wire, envelope)`` or ``None`` when no
    admissible downgrade exists (budget too tight, plan already at its
    floor, or the fp8 element types missing on this torch build — a
    rung the backend cannot represent is silently skipped, never an
    admission-path crash)."""
    from ..parallel.wire import canonical_wire_dtype

    depth = wire_depth(current_wire)
    best = None
    for rung in ladder:
        try:
            wire = canonical_wire_dtype(rung)
        except (ValueError, TypeError):
            continue
        if wire_depth(wire) <= depth:
            continue
        envelope = wire_error_envelope(wire)
        if envelope is not None and envelope <= max_rel_l2:
            best = (wire, envelope)     # keep going: deepest rung wins
    return best
