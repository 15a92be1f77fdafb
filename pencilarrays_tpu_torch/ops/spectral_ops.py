"""Spectral differential operators on pencil-decomposed fields.

PyTorch counterpart of the JAX package's ``ops/spectral_ops.py``:
gradient, divergence, curl, Laplacian and a Poisson solve, each acting on
SPECTRAL PencilArrays that live on a plan's ``output_pencil``.  All are
elementwise products with broadcast-shaped wavenumber components
(``PencilFFTPlan.wavenumbers(LogicalOrder)``, aligned to each rank's
block by PencilArray arithmetic): no communication, differentiable.

Conventions: periodic box of length ``lengths[d]`` (default ``2*pi``, so
angular wavenumbers equal integer mode numbers); vector fields carry
their components in ONE trailing extra dim of size N.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..parallel.arrays import PencilArray
from ..parallel.pencil import LogicalOrder

__all__ = ["gradient", "divergence", "curl", "laplacian", "solve_poisson"]


def _angular_ks(plan, lengths):
    """Broadcast-shaped angular wavenumber components (logical order)."""
    N = len(plan.shape_physical)
    if lengths is None:
        lengths = (2.0 * math.pi,) * N
    if len(lengths) != N:
        raise ValueError(f"lengths has {len(lengths)} entries for a "
                         f"rank-{N} transform")
    ks = plan.wavenumbers(LogicalOrder)
    return tuple(k * (2.0 * math.pi / float(L))
                 for k, L in zip(ks, lengths))


def _check_spectral(plan, uh: PencilArray, ncomp: int = 0):
    if uh.pencil != plan.output_pencil:
        raise ValueError("operand must live on plan.output_pencil")
    if ncomp and uh.extra_dims != (ncomp,):
        raise ValueError(
            f"expected a vector field with extra_dims=({ncomp},), got "
            f"extra_dims={uh.extra_dims}")


def _aligned(k: torch.Tensor, fh: PencilArray) -> torch.Tensor:
    """A wavenumber component broadcastable against ``fh`` including its
    extra dims (raw operands align from the TAIL of logical shape +
    extra dims, so component and batch axes need explicit singletons)."""
    return k[(...,) + (None,) * fh.ndims_extra]


def gradient(plan, fh: PencilArray, *,
             lengths: Sequence[float] = None) -> PencilArray:
    """Spectral gradient: ``(i k_d f^)_d`` stacked into a NEW trailing
    component dim of size N (existing extra dims broadcast as batch)."""
    _check_spectral(plan, fh)
    ks = _angular_ks(plan, lengths)
    return PencilArray.stack([fh * (1j * _aligned(k, fh)) for k in ks])


def divergence(plan, uh: PencilArray, *,
               lengths: Sequence[float] = None) -> PencilArray:
    """Spectral divergence of a vector field (trailing component dim of
    size N): ``sum_d i k_d u_d^``."""
    N = len(plan.shape_physical)
    _check_spectral(plan, uh, N)
    ks = _angular_ks(plan, lengths)
    out = None
    for d, k in enumerate(ks):
        term = uh.component(d) * (1j * k)
        out = term if out is None else out + term
    return out


def curl(plan, uh: PencilArray, *,
         lengths: Sequence[float] = None) -> PencilArray:
    """Spectral curl of a 3-D vector field: ``i k x u^``."""
    if len(plan.shape_physical) != 3:
        raise ValueError("curl is defined for 3-D transforms")
    _check_spectral(plan, uh, 3)
    kx, ky, kz = _angular_ks(plan, lengths)
    ux, uy, uz = (uh.component(d) for d in range(3))
    return PencilArray.stack([
        uy * (-1j * kz) + uz * (1j * ky),
        uz * (-1j * kx) + ux * (1j * kz),
        ux * (-1j * ky) + uy * (1j * kx),
    ])


def _k2_for(plan, fh: PencilArray, lengths) -> torch.Tensor:
    """|k|^2 broadcast-aligned to ``fh`` including its extra dims."""
    k2 = None
    for k in _angular_ks(plan, lengths):
        k2 = k * k if k2 is None else k2 + k * k
    return _aligned(k2, fh)


def laplacian(plan, fh: PencilArray, *,
              lengths: Sequence[float] = None) -> PencilArray:
    """Spectral Laplacian: ``-|k|^2 f^`` (componentwise on vector fields;
    extra dims broadcast)."""
    _check_spectral(plan, fh)
    return fh * (-_k2_for(plan, fh, lengths))


def solve_poisson(plan, fh: PencilArray, *,
                  lengths: Sequence[float] = None) -> PencilArray:
    """Solve ``lap(phi) = f`` spectrally: ``phi^ = -f^/|k|^2`` with the
    zero mode (the undetermined mean) set to 0 (componentwise on vector
    fields)."""
    _check_spectral(plan, fh)
    k2 = _k2_for(plan, fh, lengths)
    inv = torch.where(k2 == 0, 0.0, -1.0 / torch.where(k2 == 0, 1.0, k2))
    return fh * inv
