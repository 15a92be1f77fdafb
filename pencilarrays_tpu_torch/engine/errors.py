"""Typed errors of the task-graph executor (a copy of the JAX package's
``engine/errors.py``).

A failure is scoped to the narrowest unit it poisons, one step future,
and the queue keeps draining: a host-pool exception never wedges the
dispatch consumer, and a dispatch enqueued into a closed or reformed
engine fails typed instead of stranding its waiter.
"""

from __future__ import annotations

__all__ = ["EngineError", "EngineClosedError", "EngineTaskError",
           "EngineReformedError"]


class EngineError(RuntimeError):
    """Base class of every engine-layer error."""


class EngineClosedError(EngineError):
    """Submit after :meth:`~pencilarrays_tpu_torch.engine.Engine.close`
    (or a pending task failed because the engine closed under it)."""


class EngineTaskError(EngineError):
    """A host-pool task (a step's pack stage, or a standalone
    :meth:`~pencilarrays_tpu_torch.engine.Engine.host_task`) raised.  The
    original exception is chained as ``__cause__`` and kept on
    ``.cause``; ``.label`` names the task and ``.stage`` which pool stage
    failed (``"pack"`` | ``"host"``).  Only this task's future fails."""

    def __init__(self, label: str, stage: str, cause: BaseException):
        self.label = label
        self.stage = stage
        self.cause = cause
        super().__init__(
            f"{stage} task {label!r} failed: "
            f"{type(cause).__name__}: {cause}")
        self.__cause__ = cause


class EngineReformedError(EngineError):
    """A queued dispatch was failed by a reformation: the work it would
    have issued targeted a process group that no longer exists.
    Resubmit against the reformed one."""

    def __init__(self, msg: str, *, generation: int):
        super().__init__(msg)
        self.generation = generation
