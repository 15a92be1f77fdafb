"""Typed errors of the static checks (a copy of the JAX package's
``analysis/errors.py``)."""

from typing import Optional


class AnalysisError(Exception):
    """Base of every static-analysis failure."""


class HbmBoundError(AnalysisError):
    """A schedule's predicted per-rank peak device memory exceeds the
    caller's ``hbm_limit``.  ``hop`` names the offending exchange."""

    def __init__(self, source: str, hop: str, peak_bytes: int,
                 limit_bytes: int):
        self.source = source
        self.hop = hop
        self.peak_bytes = int(peak_bytes)
        self.limit_bytes = int(limit_bytes)
        super().__init__(
            f"{source}: hop {hop} needs {peak_bytes} peak HBM bytes "
            f"per chip, over the {limit_bytes}-byte limit")


class ScheduleMismatchError(AnalysisError):
    """A compiled program's collective trace does not match the plan's
    ``collective_costs`` prediction.  ``op`` names the first diverging
    collective kind; ``predicted``/``observed`` are its
    ``{"count", "bytes"}`` entries (``None`` = the op is absent on that
    side)."""

    def __init__(self, source: str, op: str,
                 predicted: Optional[dict], observed: Optional[dict]):
        self.source = source
        self.op = op
        self.predicted = predicted
        self.observed = observed
        super().__init__(
            f"{source}: collective {op!r} diverges from prediction: "
            f"predicted {predicted!r}, compiled program has {observed!r}")


class TraceDivergenceError(AnalysisError):
    """Two programs that must agree (guard-on vs guard-off hop bodies,
    batched vs unbatched, probe plan vs built plan) compiled to
    inconsistent collective traces.  ``op`` names the first diverging
    collective kind."""

    def __init__(self, a: str, b: str, op: str, what: str,
                 left, right):
        self.sources = (a, b)
        self.op = op
        self.what = what
        super().__init__(
            f"traces diverge on {op!r} ({what}): {a} has {left!r}, "
            f"{b} has {right!r}")


class DispatchOrderError(AnalysisError):
    """An engine's issued dispatch order diverged from its enqueue
    order — total order for the v1 queue, per dependency chain for the
    v2 DAG.  The pipelined schedule is NOT the serialized schedule, and
    on a mesh a reordered collective launch is a deadlock.  Names the
    first diverging dispatch (issue position, label, and the enqueue
    sequence numbers observed vs expected); in partial-order mode
    ``chain`` names the dependency chain and ``dep_seq`` the violated
    edge's tail (the earlier-enqueued task that issued AFTER this one
    despite a resource conflict).  Ordering is guaranteed by
    construction (one consumer thread, conflicts issue FIFO), so this
    firing means the executor itself is broken — the check exists
    precisely so that claim is *proved*, not assumed."""

    def __init__(self, source: str, position: int, label: str,
                 expected_seq: int, observed_seq: int,
                 chain: Optional[str] = None,
                 dep_seq: Optional[int] = None,
                 detail: Optional[str] = None):
        self.source = source
        self.position = position
        self.label = label
        self.expected_seq = int(expected_seq)
        self.observed_seq = int(observed_seq)
        self.chain = chain
        self.dep_seq = int(dep_seq) if dep_seq is not None else None
        if chain is not None:
            msg = (f"{source}: dispatch order diverges at issue "
                   f"position {position} ({label!r}) on chain "
                   f"{chain!r}: enqueue seq {observed_seq} issued "
                   f"before its dependency seq "
                   f"{dep_seq if dep_seq is not None else expected_seq}")
        else:
            msg = (f"{source}: dispatch order diverges at issue "
                   f"position {position} ({label!r}): expected enqueue "
                   f"seq {expected_seq}, issued seq {observed_seq}")
        if detail:
            msg = f"{msg} — {detail}"
        super().__init__(msg)


class DonationError(AnalysisError):
    """A program priced with buffer donation compiled WITHOUT the
    input/output alias — the buffer the router's pricing assumed would
    be elided is still resident."""

    def __init__(self, source: str, detail: str):
        self.source = source
        super().__init__(f"{source}: {detail}")
