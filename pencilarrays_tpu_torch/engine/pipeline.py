"""Step-loop pipelining (the JAX package's ``engine/pipeline.py``).

:func:`run_steps_async` drives a model's step loop through the engine:

* each step is one ordered dispatch on the consumer thread; step
  ``k + 1`` is enqueued at once, so the consumer issues it the moment
  ``k`` returns;
* every ``checkpoint_every``-th state is saved by
  :meth:`~pencilarrays_tpu_torch.engine.Engine.host_task` (the
  ``CheckpointManager.save_async`` path), overlapping the next steps;
* saves are chained (each waits for the previous save's future), so one
  ``CheckpointManager`` never runs two commits at once, and each save
  waits for its own step's future, so it writes exactly the state it
  names.

Snapshot safety: JAX arrays are immutable; torch tensors are not.  The
loop hands each save the tensor the step returned and no step writes
into its input (``NavierStokesSpectral.step`` and
``DiffusionSpectral.step`` allocate their results), so a save reads a
stable state while later steps compute; a stepper that updates its
input in place must not be given to a loop that checkpoints.  On the
card the save stages on its host worker's own stream after waiting for
its step's device work (``StepFuture.device_event``), so it queues
behind none of the steps issued since.  Memory: a saved state stays
alive until its save has staged it, so the step that completes the next
checkpoint interval first waits for the previous save to end; at most
one saved state is held beside the loop's own, and where saves are
slower than an interval of steps the saves pace the loop (which they
bound anyway, being chained).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from .executor import StepFuture, get_engine, wait_device

__all__ = ["StepPipeline", "run_steps_async"]


class StepPipeline:
    """Handle on one :func:`run_steps_async` loop: ``final`` resolves to
    the last step's state, ``saves`` are the chained checkpoint futures
    (each resolves to its committed directory).  ``result()`` blocks for
    everything, steps and saves, and returns the final state."""

    def __init__(self, final: StepFuture,
                 saves: Tuple[StepFuture, ...]):
        self.final = final
        self.saves = saves

    def result(self, timeout: Optional[float] = None):
        """Blocks for the last step AND every save; a failed step
        re-raises its error here (later steps refuse to advance a stale
        state, so the failure reaches ``final``)."""
        out = self.final.result(timeout)
        for s in self.saves:
            s.result(timeout)
        return out


def run_steps_async(stepper: Callable, state, n_steps: int, *,
                    engine=None, checkpoint=None,
                    checkpoint_every: Optional[int] = None,
                    state_name: str = "state",
                    label: str = "model.step") -> StepPipeline:
    """Drive ``state = stepper(state)`` for ``n_steps`` steps through the
    engine (module docstring): one ordered dispatch per step, one
    host-pool save per ``checkpoint_every`` steps by ``checkpoint`` (a
    :class:`~pencilarrays_tpu_torch.resilience.CheckpointManager`, whose
    ``save(step, {state_name: state})`` runs on the host pool).  Returns
    a :class:`StepPipeline`."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if (checkpoint is None) != (checkpoint_every is None):
        raise ValueError(
            "pass checkpoint= and checkpoint_every= together (or "
            "neither)")
    if checkpoint_every is not None and int(checkpoint_every) < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if checkpoint is not None:
        checkpoint._check_async()
    eng = engine if engine is not None else get_engine()
    saves: List[StepFuture] = []
    prev_save: Optional[StepFuture] = None
    last: Optional[StepFuture] = None
    holder = {"state": state, "error": None}
    for k in range(1, int(n_steps) + 1):

        def run(k=k, prev=prev_save if checkpoint is not None
                and k % int(checkpoint_every) == 0 else None):
            if prev is not None:
                prev._event.wait()  # its failure surfaces on its future
            if holder["error"] is not None:
                # a prior step failed: the loop state is stale; re-raise
                # the original error on each later future so ``final``
                # carries the failure
                raise holder["error"]
            try:
                holder["state"] = stepper(holder["state"])
            except BaseException as e:
                holder["error"] = e
                raise
            return holder["state"]

        last = eng.submit(run, label=f"{label}:{k}")
        if checkpoint is not None and k % int(checkpoint_every) == 0:
            def save(k=k, step_fut=last, prev=prev_save):
                if prev is not None:
                    prev.result()
                x = step_fut.result()
                wait_device(step_fut.device_event)
                return checkpoint.save(k, {state_name: x})

            prev_save = eng.host_task(save, label=f"ckpt.save:{k}")
            saves.append(prev_save)
    return StepPipeline(last, tuple(saves))
