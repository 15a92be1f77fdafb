"""Pseudo-spectral incompressible Navier–Stokes — the flagship workload.

PyTorch counterpart of the JAX package's ``models/spectral.py``: the
standard Fourier pseudo-spectral method on the distributed
:class:`~pencilarrays_tpu_torch.ops.fft.PencilFFTPlan`.

* state: spectral velocity ``uh`` — a complex PencilArray on the plan's
  output pencil with ``extra_dims=(3,)`` (vector components);
* nonlinear term in rotational form ``u x omega``, computed in physical
  space: one 6-component inverse transform chain (velocity and vorticity
  share every exchange) plus one 3-component forward chain;
* 2/3-rule dealiasing, Leray projection, exact integrating factor for
  viscosity, RK2 (Heun) or RK4 time stepping.

The model is written on PencilArrays with LOGICAL-order wavenumber
operands, as in the JAX package; each rank aligns them to its block.  The
operators ``|k|^2``, ``1/|k|^2`` and the dealiasing mask are computed once
per model (the JAX package recomputes them inside its jitted step, where
XLA fuses them away; eager PyTorch would launch them on every call).
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..obs.tracing import span
from ..ops import reductions
from ..ops.fft import PencilFFTPlan
from ..ops.localgrid import localgrid
from ..parallel.arrays import PencilArray
from ..parallel.pencil import LogicalOrder, MemoryOrder
from ..parallel.topology import Topology

__all__ = ["NavierStokesSpectral", "taylor_green"]

class NavierStokesSpectral:
    """Incompressible 3-D Navier–Stokes in a periodic box, pseudo-spectral.

    ``n`` is the grid points per side (or a 3-tuple), ``viscosity`` the
    kinematic viscosity, ``dtype`` the real dtype of physical fields."""

    def __init__(self, topology: Topology, n, *, viscosity: float = 1e-2,
                 dtype=torch.float32, dealias: bool = True,
                 decomposition: Optional[str] = None, wire_dtype=None):
        if isinstance(n, int):
            n = (n, n, n)
        self.shape = tuple(n)
        self.nu = float(viscosity)
        # decomposition= lets the plan pick the slab or pencil grid over
        # the topology's ranks, priced at the model's 3-component batch;
        # wire_dtype= puts every exchange on a reduced-precision wire
        self.plan = PencilFFTPlan(topology, self.shape, real=True,
                                  dtype=dtype, decomposition=decomposition,
                                  batch=3, wire_dtype=wire_dtype)
        self.dealias = dealias

    def step_async(self, uh: PencilArray, dt: float, *, engine=None,
                   stepper=None):
        """Submit ONE step as an ordered engine dispatch; returns its
        :class:`~pencilarrays_tpu_torch.engine.StepFuture` (enqueue step
        ``k + 1`` while ``k`` computes, and the consumer issues them in
        order)."""
        from ..engine import get_engine

        eng = engine if engine is not None else get_engine()
        stepper = self.step if stepper is None else stepper
        return eng.submit(lambda: stepper(uh, dt), label="ns.step")

    def run_async(self, uh: PencilArray, dt: float, n_steps: int, *,
                  engine=None, stepper=None, checkpoint=None,
                  checkpoint_every=None):
        """``n_steps`` steps through the engine's dispatch queue, saving
        every ``checkpoint_every``-th state (as ``"uh"``) by
        ``checkpoint`` on the host pool, overlapped with the next steps
        (:func:`~pencilarrays_tpu_torch.engine.run_steps_async`).  Every
        step allocates its result, so a save reads a state no later step
        writes.  Returns a :class:`~pencilarrays_tpu_torch.engine.
        StepPipeline`."""
        from ..engine import run_steps_async

        stepper = self.step if stepper is None else stepper
        return run_steps_async(
            lambda s: stepper(s, dt), uh, n_steps, engine=engine,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every,
            state_name="uh", label="ns.step")

    @cached_property
    def _ks(self):
        """Logical-order broadcast-shaped wavenumbers ``(kx, ky, kz)``."""
        return self.plan.wavenumbers(LogicalOrder)

    @cached_property
    def _operators(self):
        """``(k2, 1/k2 with the mean mode at 1, dealiasing mask)`` in
        logical order, computed once."""
        kx, ky, kz = self._ks
        k2 = kx * kx + ky * ky + kz * kz
        inv_k2 = 1.0 / torch.where(k2 == 0, torch.ones_like(k2), k2)
        if self.dealias:
            cut = [n / 3.0 for n in self.shape]
            mask = ((kx.abs() < cut[0]) & (ky.abs() < cut[1])
                    & (kz.abs() < cut[2])).to(kx.dtype)
        else:
            mask = torch.ones_like(k2)
        return k2, inv_k2, mask

    # -- fields -----------------------------------------------------------
    def allocate_state(self) -> PencilArray:
        """Zero spectral velocity (3 components in extra dims)."""
        return PencilArray.zeros(self.plan.output_pencil, (3,),
                                 self.plan.dtype_spectral)

    def from_physical(self, u: PencilArray) -> PencilArray:
        """Forward-transform a physical velocity field (components in
        ``extra_dims=(3,)``) into the divergence-free spectral state."""
        return self._project(self.plan.forward(u))

    def to_physical(self, uh: PencilArray) -> PencilArray:
        return self.plan.backward(uh)

    def _project(self, uh: PencilArray) -> PencilArray:
        """Leray projection: ``P(u) = u - k (k.u) / |k|^2``."""
        kx, ky, kz = self._ks
        _, inv_k2, _ = self._operators
        u0, u1, u2 = (uh.component(i) for i in range(3))
        corr = (u0 * kx + u1 * ky + u2 * kz) * inv_k2
        return PencilArray.stack(
            [u0 - corr * kx, u1 - corr * ky, u2 - corr * kz])

    # -- dynamics ---------------------------------------------------------
    def _nonlinear(self, uh: PencilArray) -> PencilArray:
        """Rotational-form nonlinear term, dealiased, in spectral space:
        ``P [ F(u x omega) ]``."""
        with span("ns.nonlinear"):
            kx, ky, kz = self._ks
            _, inv_k2, mask = self._operators
            u0, u1, u2 = (uh.component(i) for i in range(3))
            wx = (u2 * ky - u1 * kz) * 1j
            wy = (u0 * kz - u2 * kx) * 1j
            wz = (u1 * kx - u0 * ky) * 1j
            uw = self.plan.backward(
                PencilArray.stack([u0, u1, u2, wx, wy, wz]))
            a0, a1, a2, b0, b1, b2 = (uw.component(i) for i in range(6))
            del uw
            c = PencilArray.stack([a1 * b2 - a2 * b1,
                                   a2 * b0 - a0 * b2,
                                   a0 * b1 - a1 * b0])
            del a0, a1, a2, b0, b1, b2
            ch = self.plan.forward(c)
            chm = ch * mask[..., None]
            c0, c1, c2 = (chm.component(i) for i in range(3))
            corr = (c0 * kx + c1 * ky + c2 * kz) * inv_k2
            return PencilArray.stack(
                [c0 - corr * kx, c1 - corr * ky, c2 - corr * kz])

    def step(self, uh: PencilArray, dt: float) -> PencilArray:
        """One RK2 (Heun) step with exact viscous integrating factor."""
        with span("ns.step"):
            k2, _, _ = self._operators
            e = torch.exp(-self.nu * k2 * dt)[..., None]
            n1 = self._nonlinear(uh)
            u1 = (uh + n1 * dt) * e
            n2 = self._nonlinear(u1)
            del u1
            return (uh + n1 * (0.5 * dt)) * e + n2 * (0.5 * dt)

    def step_rk4(self, uh: PencilArray, dt: float) -> PencilArray:
        """One classical integrating-factor RK4 step (Canuto et al.)."""
        with span("ns.step"):
            k2, _, _ = self._operators
            e = torch.exp(-self.nu * k2 * (0.5 * dt))[..., None]
            a = self._nonlinear(uh)
            b = self._nonlinear((uh + a * (0.5 * dt)) * e)
            c = self._nonlinear(uh * e + b * (0.5 * dt))
            d = self._nonlinear(uh * e * e + c * e * dt)
            return (uh * e * e
                    + (a * e * e + (b + c) * e * 2.0 + d) * (dt / 6.0))

    def simulate(self, uh: PencilArray, dt: float, n_steps: int, *,
                 record_energy: bool = False, stepper=None):
        """Run ``n_steps`` steps of ``stepper`` (default :meth:`step`, RK2;
        pass ``model.step_rk4`` for 4th order).  Returns ``(state,
        energies)``: ``energies`` is a 1-D tensor of the energy after each
        step, on the state's device, when ``record_energy``, else
        ``None`` (the JAX package's ``simulate``, whose ``lax.scan`` is a
        plain loop here)."""
        stepper = self.step if stepper is None else stepper
        energies = []
        for _ in range(int(n_steps)):
            uh = stepper(uh, dt)
            if record_energy:
                energies.append(self.energy(uh).reshape(()))
        if not record_energy:
            return uh, None
        if not energies:
            return uh, torch.zeros(0, dtype=self.plan.dtype_real,
                                   device=uh.data.device)
        return uh, torch.stack(energies)

    def energy(self, uh: PencilArray) -> torch.Tensor:
        """Mean kinetic energy ``<|u|^2>/2`` over the box (physical space,
        padding masked by the global reduction)."""
        u = self.to_physical(uh)
        total = reductions.mapreduce(lambda d: d * d, torch.sum, u,
                                     identity=0)
        return 0.5 * total / u.pencil.length_global()


def taylor_green(model: NavierStokesSpectral) -> PencilArray:
    """Taylor–Green vortex initial condition as a spectral state."""
    pen = model.plan.input_pencil
    rd = np.dtype(str(model.plan.dtype_real).replace("torch.", ""))
    coords = [(np.arange(ni) * (2 * np.pi / ni)).astype(rd)
              for ni in model.shape]
    x, y, z = localgrid(pen, coords).components()
    target = pen.padded_size_local(MemoryOrder)
    ux = (torch.cos(x) * torch.sin(y) * torch.sin(z)).expand(target)
    uy = (-torch.sin(x) * torch.cos(y) * torch.sin(z)).expand(target)
    uz = torch.zeros(target, dtype=ux.dtype, device=ux.device)
    u = torch.stack([ux, uy, uz], dim=-1).to(model.plan.dtype_physical)
    return model.from_physical(PencilArray(pen, u, (3,)))
