"""The global norm hook of the JAX package's diffrax interop.

The reference's DiffEq extension (``ext/PencilArraysDiffEqExt.jl:5-9``)
makes a third-party adaptive integrator globally consistent by giving it
an error norm over the whole distributed state, so every rank computes
the same WRMS error and picks the same ``dt`` (``test/ode.jl:59-74``).
The JAX package passes :func:`global_wrms_norm` to diffrax's
``PIDController(norm=...)``.  diffrax is JAX-only, so the port keeps the
norm hook (for any integrator written in torch, and for
``models/ode.py``'s own RK23) and answers that diffrax is unavailable.
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.arrays import PencilArray, numpy_to_torch

__all__ = ["global_wrms_norm", "diffrax_available", "diffeqsolve"]


def diffrax_available() -> bool:
    """Always False: diffrax integrates JAX pytrees, not torch tensors."""
    return False


def _leaves(y: Any):
    if isinstance(y, PencilArray):
        yield y
    elif isinstance(y, dict):
        for v in y.values():
            yield from _leaves(v)
    elif isinstance(y, (list, tuple)):
        for v in y:
            yield from _leaves(v)
    else:
        yield y


def global_wrms_norm(y: Any) -> torch.Tensor:
    """RMS norm over a PencilArray, or a (nested) sequence or dict of
    them, treating PencilArrays GLOBALLY: padding masked, true global
    element count (the ``UNITLESS_ABS2``/``recursive_length`` overloads
    of the reference extension, ``ext/PencilArraysDiffEqExt.jl:5-9``).
    Other leaves (tensors, arrays, numbers) count with their plain sum of
    squares and length, as on every rank alike.  A collective when a
    PencilArray lives on several ranks."""
    from ..ops import reductions

    sumsq, count, device = None, 0, None
    for leaf in _leaves(y):
        if isinstance(leaf, PencilArray):
            s = reductions.mapreduce(lambda d: d.abs() ** 2, torch.sum, leaf,
                                     identity=0)
            n = leaf.length_global()
            device = leaf.device
        else:
            t = numpy_to_torch(leaf) if not isinstance(
                leaf, (int, float, complex)) else torch.tensor(leaf)
            s = (t.abs() ** 2).sum()
            n = t.numel()
        s = s.to(torch.float64)
        sumsq = s if sumsq is None else sumsq + s.to(sumsq.device)
        count += n
    if sumsq is None:
        return torch.zeros((), dtype=torch.float64)
    out = torch.sqrt(sumsq / max(count, 1))
    return out if device is None else out.to(device)


def diffeqsolve(*args, **kwargs):
    """The JAX package's ``diffrax.diffeqsolve`` wrapper has no torch
    counterpart: use ``models.ode.integrate``, or pass
    :func:`global_wrms_norm` to a torch integrator's error control."""
    raise ImportError(
        "diffrax is JAX-only and is not available to the PyTorch port; "
        "use pencilarrays_tpu_torch.models.ode.integrate, or pass "
        "interop.global_wrms_norm to a torch integrator's error control")
