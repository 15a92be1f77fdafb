"""The two-tier intra-mesh/DCN placement cost model — one currency, two tolls.

Placement prices every candidate mesh in the SAME bytes-equivalent
currency the admission queue and the PR-4 route planner already use
(``count * latency_bytes + bytes`` — see
:class:`~pencilarrays_tpu_torch.parallel.transpositions.Auto`), extended one
tier up the network hierarchy, following the hierarchy framing of
AccFFT (arXiv:1506.07933) and the advanced-MPI FFT study
(arXiv:1804.09536): *intra*-mesh exchanges ride the fast interconnect
(NVLink on the card) and are already priced into each service's own projection, while
a *cross*-mesh move pays the data-center network (DCN) — a per-transfer
latency toll orders of magnitude above an intra-mesh hop, plus a per-byte
factor for the slower fabric.

A placement's score is the sum of three terms, all in bytes-equivalent:

* **wire** — the DCN toll of moving the request there and the result
  back: ``2 * dcn_latency_bytes + dcn_byte_factor * (bytes_in +
  bytes_out)``; a colocated back-end (``tier="colo"``) pays zero;
* **affinity** — ``compile_penalty_bytes`` if the mesh has NOT already
  compiled this plan fingerprint (:meth:`plan_key` — the compile-cache
  locality term: a cold mesh pays seconds of cuFFT planning and
  CUDA-graph capture, which is real capacity), zero if the fingerprint is warm;
* **backlog** — the mesh's projected drain, taken straight from its
  exported :class:`~pencilarrays_tpu_torch.serve.slo.LoadTracker` snapshot
  (``queued_cost_bytes + inflight_cost_bytes``), weighted by
  ``slo_drain_weight`` for deadline-carrying tenants — a tight SLO
  cares more about queue depth than about a cold compile cache.

Env knobs (all optional; documented in ``docs/Fleet.md``):
``PENCILARRAYS_TPU_FLEET_DCN_LATENCY_BYTES``,
``PENCILARRAYS_TPU_FLEET_DCN_FACTOR``,
``PENCILARRAYS_TPU_FLEET_COMPILE_PENALTY``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["FleetCost", "DCN_LATENCY_BYTES_VAR", "DCN_FACTOR_VAR",
           "COMPILE_PENALTY_VAR"]

DCN_LATENCY_BYTES_VAR = "PENCILARRAYS_TPU_FLEET_DCN_LATENCY_BYTES"
DCN_FACTOR_VAR = "PENCILARRAYS_TPU_FLEET_DCN_FACTOR"
COMPILE_PENALTY_VAR = "PENCILARRAYS_TPU_FLEET_COMPILE_PENALTY"


def _env_num(var: str, default, cast):
    try:
        return cast(os.environ[var])
    except (KeyError, ValueError):
        return default


@dataclass(frozen=True)
class FleetCost:
    """The fleet placement pricing knobs (bytes-equivalent currency).

    ``dcn_latency_bytes`` is the per-transfer DCN toll — deliberately
    32x the intra-mesh default (128 KiB in
    :class:`~pencilarrays_tpu_torch.parallel.transpositions.Auto`): a DCN
    round-trip costs what tens of intra-mesh collectives cost.
    ``compile_penalty_bytes`` prices a cold plan fingerprint (planning
    and capturing a plan is seconds of lost capacity ~ tens of MiB of traffic at
    serving rates)."""

    dcn_latency_bytes: int = 4 * 1024 * 1024
    dcn_byte_factor: float = 8.0
    compile_penalty_bytes: int = 64 * 1024 * 1024
    slo_drain_weight: float = 4.0

    @classmethod
    def from_env(cls) -> "FleetCost":
        base = cls()
        return cls(
            dcn_latency_bytes=_env_num(
                DCN_LATENCY_BYTES_VAR, base.dcn_latency_bytes, int),
            dcn_byte_factor=_env_num(
                DCN_FACTOR_VAR, base.dcn_byte_factor, float),
            compile_penalty_bytes=_env_num(
                COMPILE_PENALTY_VAR, base.compile_penalty_bytes, int),
            slo_drain_weight=base.slo_drain_weight,
        )

    def wire_bytes(self, *, nbytes_in: int, nbytes_out: int,
                   tier: str = "dcn") -> float:
        """The DCN toll of routing one request to a mesh on ``tier``
        (``"colo"`` = the router's own failure domain, toll-free;
        ``"dcn"`` = across the data-center network)."""
        if tier == "colo":
            return 0.0
        return (2.0 * self.dcn_latency_bytes
                + self.dcn_byte_factor * float(nbytes_in + nbytes_out))

    def affinity_bytes(self, *, warm: bool) -> float:
        return 0.0 if warm else float(self.compile_penalty_bytes)

    def backlog_bytes(self, *, backlog: float,
                      deadline_s: Optional[float]) -> float:
        w = self.slo_drain_weight if deadline_s is not None else 1.0
        return w * max(0.0, float(backlog))

    def score(self, *, nbytes_in: int, nbytes_out: int, tier: str,
              warm: bool, backlog: float,
              deadline_s: Optional[float] = None) -> dict:
        """Price one candidate: ``{"wire", "affinity", "backlog",
        "total"}``, all bytes-equivalent (lower is better)."""
        wire = self.wire_bytes(nbytes_in=nbytes_in,
                               nbytes_out=nbytes_out, tier=tier)
        aff = self.affinity_bytes(warm=warm)
        back = self.backlog_bytes(backlog=backlog, deadline_s=deadline_s)
        return {"wire": wire, "affinity": aff, "backlog": back,
                "total": wire + aff + back}
