"""Spectral diffusion (heat equation) on a pencil decomposition.

PyTorch counterpart of the JAX package's ``models/diffusion.py``:
``du/dt = kappa * laplacian(u)`` in a periodic box, advanced EXACTLY in
spectral space (``uh(t+dt) = uh(t) * exp(-kappa k^2 dt)``).  Because the
propagator is exact, any error is the FFT stack's — a cheap end-to-end
check of the plan.
"""

from __future__ import annotations

import torch

from ..ops.fft import PencilFFTPlan
from ..parallel.arrays import PencilArray
from ..parallel.topology import Topology

__all__ = ["DiffusionSpectral"]


class DiffusionSpectral:
    """Exact spectral integrator for the periodic heat equation."""

    def __init__(self, topology: Topology, n, *, kappa: float = 1.0,
                 dtype=torch.float32, wire_dtype=None):
        if isinstance(n, int):
            n = (n, n, n)
        self.shape = tuple(n)
        self.kappa = float(kappa)
        # wire_dtype: reduced-precision exchange payloads; the spectral
        # arithmetic is unchanged
        self.plan = PencilFFTPlan(topology, self.shape, real=True,
                                  dtype=dtype, wire_dtype=wire_dtype)

    def _k2(self) -> torch.Tensor:
        total = None
        for k in self.plan.wavenumbers():  # this rank's, memory order
            total = k * k if total is None else total + k * k
        return total

    def from_physical(self, u: PencilArray) -> PencilArray:
        return self.plan.forward(u)

    def to_physical(self, uh: PencilArray) -> PencilArray:
        return self.plan.backward(uh)

    def step(self, uh: PencilArray, dt) -> PencilArray:
        """Exact propagator over ``dt`` (unconditionally stable)."""
        decay = torch.exp(-self.kappa * self._k2() * dt)
        if uh.ndims_extra:
            decay = decay.reshape(decay.shape + (1,) * uh.ndims_extra)
        return PencilArray(uh.pencil, uh.data * decay, uh.extra_dims)

    def solve(self, u0: PencilArray, t) -> PencilArray:
        """Physical initial condition -> physical solution at time ``t``."""
        return self.to_physical(self.step(self.from_physical(u0), t))

    def run_async(self, uh: PencilArray, dt, n_steps: int, *,
                  engine=None, checkpoint=None, checkpoint_every=None):
        """Spectral-state step loop through the engine's dispatch queue,
        with host-pool checkpoint saves (``"uh"``) overlapped
        (:func:`~pencilarrays_tpu_torch.engine.run_steps_async`); returns
        a :class:`~pencilarrays_tpu_torch.engine.StepPipeline`."""
        from ..engine import run_steps_async

        return run_steps_async(
            lambda s: self.step(s, dt), uh, n_steps, engine=engine,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every,
            state_name="uh", label="diffusion.step")
