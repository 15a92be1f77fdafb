"""Plain pseudo-spectral Navier–Stokes step in a periodic ``2*pi`` box.

The method the program's ``NavierStokesSpectral.step`` states: the
nonlinear term in rotational form ``u x omega`` computed in physical
space, the 2/3-rule mask on the transformed product, the Leray
projection, and RK2 (Heun) with the exact viscous integrating factor::

    e   = exp(-nu |k|^2 dt)
    n1  = N(u)
    u1  = (u + dt n1) e
    out = (u + dt/2 n1) e + dt/2 N(u1)

Fields are ``(3, X/2 + 1, Y, Z)`` Fourier coefficients, computed in the
dtype they come in (complex128 for the comparison).  ``round_to`` rounds
every field the step stores to a narrower float (the check's control,
which stands for the program computing in bfloat16).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..fields import irfft3, mode_numbers, rfft3
from . import rounder


class Operators:
    """Wavenumbers, ``|k|^2``, ``1/|k|^2`` (1 at the mean mode) and the
    2/3-rule mask ``|k_i| < n_i / 3`` of a grid, in a real dtype."""

    def __init__(self, shape: Sequence[int], device, dtype, dealias=True):
        self.shape = tuple(shape)
        self.k = mode_numbers(shape, device, dtype)
        kx, ky, kz = self.k
        self.k2 = kx * kx + ky * ky + kz * kz
        self.inv_k2 = 1.0 / torch.where(self.k2 == 0,
                                        torch.ones_like(self.k2), self.k2)
        if dealias:
            n = self.shape
            self.mask = ((kx.abs() < n[0] / 3.0) & (ky.abs() < n[1] / 3.0)
                         & (kz.abs() < n[2] / 3.0)).to(dtype)
        else:
            self.mask = torch.ones_like(self.k2)

    def project(self, c: torch.Tensor) -> torch.Tensor:
        kx, ky, kz = self.k
        corr = (c[0] * kx + c[1] * ky + c[2] * kz) * self.inv_k2
        return torch.stack([c[0] - corr * kx, c[1] - corr * ky,
                            c[2] - corr * kz])


def nonlinear(uh: torch.Tensor, ops: Operators, rnd) -> torch.Tensor:
    """``P [ mask * F(u x omega) ]``."""
    kx, ky, kz = ops.k
    nx = ops.shape[0]
    u = rnd(irfft3(uh, nx))
    w = rnd(irfft3(torch.stack([(uh[2] * ky - uh[1] * kz) * 1j,
                                (uh[0] * kz - uh[2] * kx) * 1j,
                                (uh[1] * kx - uh[0] * ky) * 1j]), nx))
    c = rnd(torch.stack([u[1] * w[2] - u[2] * w[1],
                         u[2] * w[0] - u[0] * w[2],
                         u[0] * w[1] - u[1] * w[0]]))
    del u, w
    return rnd(ops.project(rnd(rfft3(c)) * ops.mask))


def step(uh: torch.Tensor, ops: Operators, nu: float, dt: float,
         round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """One RK2 step of the spectral velocity ``uh``."""
    rnd = rounder(round_to)
    uh = rnd(uh)
    e = torch.exp(-nu * ops.k2 * dt)
    n1 = nonlinear(uh, ops, rnd)
    u1 = rnd((uh + n1 * dt) * e)
    n2 = nonlinear(u1, ops, rnd)
    del u1
    return rnd((uh + n1 * (0.5 * dt)) * e + n2 * (0.5 * dt))
