"""Adjoint optimization through the distributed stack: gradient descent
on an initial condition so that its low-pass-filtered field matches a
target.  Autograd differentiates through the r2c FFT plan (forward and
inverse, their hops) and the masked global sum; the gradient lives on
the same pencil as the field.  The twin of the JAX package's
``examples/adjoint_optimization.py``::

    python -m pencilarrays_tpu_torch.examples.adjoint_optimization [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import pencilarrays_tpu_torch as pat

from . import _launch

SIZES = {"shape": (512, 512, 512), "steps": 40}
LR = 0.4
SEED = 0            # the JAX script's numpy seed


def _topology(device):
    # the JAX script's (2, 4) mesh on 8 ranks, (1,) on one
    P = pat.distributed.process_count()
    dims = ((2, 4) if P == 8 else (1,) if P == 1
            else pat.dims_create(P, 2))
    return pat.Topology(dims, device=device)


def run(device=None, shape=SIZES["shape"], steps=SIZES["steps"]) -> dict:
    shape = tuple(shape)
    topo = _topology(device)
    plan = pat.PencilFFTPlan(topo, shape, real=True, dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    target = pat.PencilArray.from_global(
        plan.input_pencil, rng.standard_normal(shape).astype(np.float32))
    kx, ky, kz = plan.wavenumbers()
    keep = (kx.abs() < 6) & (ky.abs() < 5) & (kz.abs() < 5)

    def lowpass(u):
        """Keep only the modes |k| below the cutoff: forward, mask,
        backward."""
        uh = plan.forward(u)
        return plan.backward(pat.PencilArray(uh.pencil, uh.data * keep,
                                             uh.extra_dims))

    # the target's filtered field is a constant of the optimization
    target_lp = lowpass(target)

    def loss_and_grad(data):
        leaf = data.detach().requires_grad_()
        d = lowpass(pat.PencilArray(plan.input_pencil, leaf)) - target_lp
        loss = pat.ops.sum(d * d)
        (grad,) = torch.autograd.grad(loss, leaf)
        return float(loss.detach()), grad

    u = pat.PencilArray.zeros(plan.input_pencil, dtype=torch.float32)
    losses = []
    for _ in range(steps):
        loss, g = loss_and_grad(u.data)
        losses.append(loss)
        u = pat.PencilArray(u.pencil, u.data - LR * g, u.extra_dims)
    if not losses[-1] < 1e-3 * losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]}: not "
                             f"converged")
    grad = pat.PencilArray(u.pencil, g, u.extra_dims)
    return {"shape": list(shape), "topology": list(topo.dims),
            "losses": losses, "loss_first": losses[0],
            "loss_last": losses[-1],
            "grad_type": type(grad).__name__,
            "grad_decomposition": list(grad.pencil.decomposition),
            "converged": True, "u": _launch.gathered(u)}


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
