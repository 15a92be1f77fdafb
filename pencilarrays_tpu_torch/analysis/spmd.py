"""Peak-memory accounting of one FFT-plan step (the JAX package's
``analysis/spmd.py`` ``step_hop_peak``; the rest of that module reads
compiled HLO and has no counterpart here)."""

from __future__ import annotations

from typing import Tuple


def step_hop_peak(step, extra_dims: Tuple[int, ...], *, method=None,
                  wire_dtype=None) -> int:
    """Peak device bytes per rank of one plan step (a ``"t"`` hop or a
    fused ``"ft"`` hop), by the route planner's one footprint model
    (``routing._hop_peak_bytes``): a chunked hop is charged its
    time-sliced footprint, a wired hop its packed in-flight share."""
    from ..parallel.routing import _hop_peak_bytes
    from ..parallel.transpositions import (AllToAll, Pipelined, Ring,
                                           _method_wire, assert_compatible)

    if step[0] not in ("t", "ft"):
        raise ValueError(f"not an exchange step: {step[0]!r}")
    src, dst, hop_dtype = step[1], step[2], step[3]
    R = assert_compatible(src, dst)
    if step[0] == "ft":
        base, c, bounds = step[7], step[8], step[9]
        return _hop_peak_bytes(src, dst, R, tuple(extra_dims), hop_dtype,
                               base, chunk_dim=c, bounds=bounds)
    m = step[4] if len(step) > 4 else method
    if not isinstance(m, (AllToAll, Ring, Pipelined)):
        # Auto-planned hops bound at the unchunked model with the wire
        m = AllToAll(wire_dtype=_method_wire(m) if m is not None
                     else wire_dtype)
    return _hop_peak_bytes(src, dst, R, tuple(extra_dims), hop_dtype, m)
