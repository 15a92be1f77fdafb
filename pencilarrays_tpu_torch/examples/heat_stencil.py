"""Finite-difference heat equation with halo exchange, cross-checked
against the exact spectral propagator.  ``HeatFD`` steps by centred
second differences (every shift a neighbour exchange, no all-to-all);
``DiffusionSpectral`` solves the same problem exactly through the FFT
plan.  The twin of the JAX package's ``examples/heat_stencil.py``::

    python -m pencilarrays_tpu_torch.examples.heat_stencil [--device cpu]
"""

from __future__ import annotations

import numpy as np

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.models import DiffusionSpectral, HeatFD

from . import _launch

SIZES = {"n": 512, "steps": 64}
KAPPA = 0.05


def run(device=None, n=SIZES["n"], steps=SIZES["steps"]) -> dict:
    P = pat.distributed.process_count()
    topo = pat.Topology(pat.dims_create(P, 2) if P > 1 else (1,),
                        device=device)
    model = HeatFD(topo, (n, n, n), kappa=KAPPA)
    x = np.arange(n) * 2 * np.pi / n
    g = (np.sin(x)[:, None, None] * np.cos(x)[None, :, None]
         * np.ones(n)[None, None, :]).astype(np.float32)
    u0 = model.from_global(g)
    dt = model.stable_dt()
    u = u0
    for _ in range(steps):
        u = model.step(u, dt)
    t_final = steps * dt

    # the exact spectral propagator, on its own pencil: compare the
    # gathered ground truths (or, at full width, the solution moved
    # onto the stencil's pencil)
    spectral = DiffusionSpectral(topo, (n, n, n), kappa=KAPPA)
    exact = spectral.solve(
        pat.PencilArray.from_global(spectral.plan.input_pencil, g), t_final)
    exact = pat.transpose(exact, model.pencil)
    err = float(pat.ops.maximum(abs(u - exact)))
    e0, e1 = float(pat.ops.norm(u0)), float(pat.ops.norm(u))
    # O(h^2) + O(dt^2) of the discretization, against a decaying mode of
    # amplitude 1
    if not (err < 1e-2 and e1 < e0):
        raise AssertionError(f"FD vs exact spectral {err}, energy {e0} -> "
                             f"{e1}")
    return {"n": n, "topology": list(topo.dims), "dt": dt,
            "t_final": t_final, "energy_initial": e0, "energy_final": e1,
            "max_err": err, "u": _launch.gathered(u),
            "exact": _launch.gathered(exact)}


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
