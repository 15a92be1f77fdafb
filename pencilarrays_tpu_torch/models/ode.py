"""Adaptive ODE time integration over PencilArrays.

PyTorch counterpart of the JAX package's ``models/ode.py``.  Reference:
the DiffEq extension (``ext/PencilArraysDiffEqExt.jl``) makes adaptive
error norms global so every rank picks the same dt — "without it each
rank picks a different dt" (``ext:5-9``) — and ``test/ode.jl:41-74``
checks that all ranks step alike and that NaNs are detected globally.

The JAX package runs the accept/reject loop as ``lax.while_loop`` on the
device.  The port runs it on the host: each trial step computes the
global error norm and the global ``any(isnan)`` with all-reduces (so
every rank holds the same values) and reads both in one host transfer.
That read is the port's rank-consistent dt.  The step-size arithmetic
repeats the JAX package's in NumPy scalars of the same dtype.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import reductions
from ..parallel.arrays import PencilArray

__all__ = ["rk23_step", "integrate", "error_norm"]


def error_norm(err: PencilArray, u0: PencilArray, u1: PencilArray,
               rtol: float, atol: float) -> torch.Tensor:
    """WRMS error norm, global by construction (the property the reference
    delegates to ``recursive_length`` + Allreduce)."""
    scale = atol + rtol * torch.maximum(u0.data.abs(), u1.data.abs())
    ratio = err.map(lambda e: (e / scale) ** 2)
    return torch.sqrt(reductions.mean(ratio))


def rk23_step(f: Callable, u: PencilArray, t, dt):
    """One Bogacki–Shampine 3(2) step; returns ``(u3, err)``.  ``t`` and
    ``dt`` are host scalars; ``f(t, u)`` receives ``t`` as a float."""
    T = type(dt)                      # stage times in dt's precision
    h = float(dt)
    k1 = f(float(t), u)
    k2 = f(float(t + T(0.5) * dt), u.map(lambda d, a: d + 0.5 * h * a, k1))
    k3 = f(float(t + T(0.75) * dt),
           u.map(lambda d, b: d + 0.75 * h * b, k2))
    u3 = u.map(
        lambda d, a, b, c: d + h * (2 / 9 * a + 1 / 3 * b + 4 / 9 * c),
        k1, k2, k3)
    k4 = f(float(t + dt), u3)
    err = u.map(
        lambda d, a, b, c, e: h * (
            (2 / 9 - 7 / 24) * a + (1 / 3 - 1 / 4) * b
            + (4 / 9 - 1 / 3) * c - 1 / 8 * e),
        k1, k2, k3, k4)
    return u3, err


def integrate(f: Callable, u0: PencilArray, t_span: Tuple[float, float], *,
              rtol: float = 1e-5, atol: float = 1e-8, dt0: float = None,
              max_steps: int = 10_000, check_nan: bool = True):
    """Adaptive RK23 integration ``du/dt = f(t, u)`` from ``t0`` to ``t1``.

    Returns ``(u_final, stats)``, stats holding ``t``, ``dt`` (NumPy
    scalars of the time dtype), ``n_accepted``, ``n_rejected`` and
    ``nan_detected`` (blow-up: a NaN in an accepted state, found by a
    global ``any(isnan)``, or dt shrinking below ``1e-12 * max(t1 - t0,
    1)``; ``test/ode.jl:41-57``).

    The JAX package keeps ``t`` and ``dt`` in float32 unless 64-bit mode
    is on, which it needs for a float64 state (its loop fails on a
    float32 state under 64-bit mode).  The port has no such mode: ``t``
    and ``dt`` take the state's real precision, which is the JAX
    package's choice in every case it runs.  Accept/reject decisions near
    ``t1`` depend on it.
    """
    rdtype = torch.empty((), dtype=u0.dtype).real.dtype
    T = np.float64 if rdtype == torch.float64 else np.float32
    t0, t1 = float(t_span[0]), float(t_span[1])
    if dt0 is None:
        dt0 = (t1 - t0) / 100.0
    # dt underflow: once dt falls below this, the solution is blowing up
    # (or the tolerances are unreachable)
    dt_min = 1e-12 * max(t1 - t0, 1.0)
    t, dt, t_end = T(t0), T(dt0), T(t1)
    na = nr = 0
    diverged = False
    u = u0
    while t < t_end and na + nr < max_steps and not diverged:
        dt = min(dt, T(t_end - t))
        u_new, err = rk23_step(f, u, t, dt)
        enorm = error_norm(err, u, u_new, rtol, atol)
        nan = (reductions.any(u_new, pred=torch.isnan) if check_nan
               else torch.zeros((), dtype=torch.bool, device=enorm.device))
        enorm, nan = torch.stack([enorm.to(torch.float64),
                                  nan.to(torch.float64)]).tolist()
        enorm = T(enorm)
        # a non-finite trial is a rejection with the hardest dt shrink
        bad = not np.isfinite(enorm)
        accept = bool(enorm <= T(1.0)) and not bad
        fac = T(0.2) if bad else np.clip(
            T(0.9) * np.maximum(enorm, T(1e-10)) ** T(-1 / 3), T(0.2),
            T(5.0))
        if accept:
            u = u_new
            t = T(t + dt)
            na += 1
        else:
            nr += 1
        dt = T(dt * fac)
        diverged = (accept and check_nan and bool(nan)) or \
            bool(dt < T(dt_min))
    return u, {"t": t, "dt": dt, "n_accepted": na, "n_rejected": nr,
               "nan_detected": diverged}
