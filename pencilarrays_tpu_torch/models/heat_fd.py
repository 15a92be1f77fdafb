"""Finite-difference heat equation on a pencil decomposition.

PyTorch counterpart of the JAX package's ``models/heat_fd.py``: the
grid-space sibling of :class:`.diffusion.DiffusionSpectral`,
``du/dt = kappa * laplacian(u)`` advanced with centred second differences
(``ops/stencil.py``) and explicit RK2.  Every step is neighbour
communication only (the stencil shifts' halo exchange), no all-to-all:
the opposite profile of the spectral stack, which is why both families
exist.

Reference tie-in: the reference integrates a distributed heat problem to
validate rank-consistent stepping (``test/ode.jl:26-74``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.stencil import fd_laplacian
from ..parallel.arrays import PencilArray, as_torch_dtype, numpy_to_torch
from ..parallel.pencil import Pencil
from ..parallel.topology import Topology

__all__ = ["HeatFD"]


class HeatFD:
    """Explicit RK2 integrator for the heat equation on a periodic (or
    zero-boundary) box, centred second-order differences."""

    def __init__(self, topology: Topology, n, *, kappa: float = 1.0,
                 lengths=None, boundary: str = "periodic",
                 decomp_dims: Optional[Sequence[int]] = None,
                 dtype=torch.float32):
        if isinstance(n, int):
            n = (n,) * max(3, len(topology.dims) + 1)
        self.shape = tuple(int(x) for x in n)
        ndim = len(self.shape)
        if lengths is None:
            lengths = (2 * math.pi,) * ndim
        self.kappa = float(kappa)
        self.boundary = boundary
        self.spacing = tuple(
            float(L) / s for L, s in zip(lengths, self.shape))
        if decomp_dims is None:
            decomp_dims = tuple(range(len(topology.dims)))
        self.pencil = Pencil(topology, self.shape, tuple(decomp_dims))
        self.dtype = as_torch_dtype(dtype)

    def allocate(self) -> PencilArray:
        return PencilArray.zeros(self.pencil, (), self.dtype)

    def from_global(self, array) -> PencilArray:
        return PencilArray.from_global(
            self.pencil, numpy_to_torch(array).to(self.dtype))

    def rhs(self, u: PencilArray) -> PencilArray:
        return fd_laplacian(u, spacing=self.spacing,
                            boundary=self.boundary) * self.kappa

    def step(self, u: PencilArray, dt: float) -> PencilArray:
        """One RK2 (midpoint) step."""
        mid = u + self.rhs(u) * (0.5 * dt)
        return u + self.rhs(mid) * dt

    def stable_dt(self, safety: float = 0.9) -> float:
        """Explicit diffusion CFL bound ``1 / (2 kappa sum h_d^-2)``."""
        s = sum(1.0 / h ** 2 for h in self.spacing)
        return safety / (2.0 * self.kappa * s)
