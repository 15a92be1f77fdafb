"""Spectral gradient of a distributed scalar field: forward r2c FFT,
multiply by i·kx in the output pencil's layout, inverse FFT, checked
against the analytic derivative.  The twin of the JAX package's
``examples/gradient_spectral.py`` (float64 on the CPU, float32 on the
card)::

    python -m pencilarrays_tpu_torch.examples.gradient_spectral [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import pencilarrays_tpu_torch as pat

from . import _launch

SIZES = {"shape": (512, 512, 512)}
# the bar of the analytic check, by the transform's precision
TOL = {torch.float32: 1e-3, torch.float64: 1e-10}


def run(device=None, shape=SIZES["shape"], dtype=None) -> dict:
    """d/dx of sin(3x) cos(2y) sin(z) on [0, 2π)^3 over a 2-D topology
    of every rank (1-D on one rank, as the JAX script on one device), in
    ``dtype`` (a torch dtype or its name; default float64 on the CPU,
    float32 on the card)."""
    n = tuple(shape)
    topo = pat.Topology.auto(2 if pat.distributed.process_count() >= 2
                             else 1, device=device)
    if dtype is None:
        dtype = (torch.float64 if topo.device.type == "cpu"
                 else torch.float32)
    elif isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    plan = pat.PencilFFTPlan(topo, n, real=True, dtype=dtype)
    coords = [np.arange(ni) * (2 * np.pi / ni) for ni in n]
    g = pat.localgrid(plan.input_pencil, coords)
    f = g.evaluate(lambda x, y, z: torch.sin(3 * x) * torch.cos(2 * y)
                   * torch.sin(z)).astype(dtype)
    fh = plan.forward(f)
    kx = plan.wavenumbers()[0]          # this rank's slice, memory order
    dfh = pat.PencilArray(fh.pencil, fh.data * (1j * kx), fh.extra_dims)
    dfdx = plan.backward(dfh)

    # the analytic derivative on this rank's block
    expect = g.evaluate(lambda x, y, z: 3 * torch.cos(3 * x)
                        * torch.cos(2 * y) * torch.sin(z)).astype(dtype)
    err = float(pat.ops.maximum(abs(dfdx - expect)))
    tol = TOL[dtype]
    if not err < tol:
        raise AssertionError(f"max |spectral d/dx - analytic| = {err} >= "
                             f"{tol}")
    return {"shape": list(n), "dtype": str(dtype).split(".")[-1],
            "topology": list(topo.dims), "max_err": err, "tol": tol,
            "gradient_verified": True,
            "dfdx": _launch.gathered(dfdx)}


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
