"""The task-graph executor and its runtime configuration (the JAX
package's ``engine/``).

* :class:`Engine` (``engine/executor.py``): a task DAG with one consumer
  thread, resource-declared dependency chains, priority lanes, a host
  pool and typed per-future failures;
* :class:`RuntimeConfig` (``engine/config.py``): every env-gated knob
  parsed in one place, snapshotted at engine construction;
* :func:`run_steps_async` (``engine/pipeline.py``): a model step loop
  with checkpoints saved on the host pool;
* :func:`spawn_thread` (``engine/threads.py``): the one place threads are
  made.
"""

from __future__ import annotations

from .config import RuntimeConfig, current as current_config  # noqa: F401
from .errors import (  # noqa: F401
    EngineClosedError,
    EngineError,
    EngineReformedError,
    EngineTaskError,
)
from .executor import (  # noqa: F401
    DispatchRecord,
    Engine,
    StepFuture,
    device_event,
    engines,
    get_engine,
    quiesce_all,
    reform_all,
    resume_all,
    shutdown_all,
    wait_device,
)
from .pipeline import StepPipeline, run_steps_async  # noqa: F401
from .threads import spawn_thread, spawned  # noqa: F401

__all__ = [
    "Engine",
    "StepFuture",
    "DispatchRecord",
    "RuntimeConfig",
    "current_config",
    "get_engine",
    "engines",
    "quiesce_all",
    "reform_all",
    "resume_all",
    "shutdown_all",
    "device_event",
    "wait_device",
    "StepPipeline",
    "run_steps_async",
    "spawn_thread",
    "spawned",
    "EngineError",
    "EngineClosedError",
    "EngineTaskError",
    "EngineReformedError",
]


def _reset_for_tests() -> None:
    """Close every registered engine and drop the config cache."""
    from . import config as _config
    from . import executor as _executor

    _executor._reset_for_tests()
    _config._reset_for_tests()
