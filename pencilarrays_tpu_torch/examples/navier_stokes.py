"""Taylor–Green vortex with the pseudo-spectral Navier–Stokes model:
simulate, checkpoint the physical velocity, restart under another
decomposition, continue.  The twin of the JAX package's
``examples/navier_stokes.py``::

    python -m pencilarrays_tpu_torch.examples.navier_stokes [--device cpu]

The restart reads the file into the slab topology of every rank, in
(z, y, x) memory order, and moves it into the slab model's input pencil
(on one rank only the memory order changes); an exact fingerprint of
the values by global position shows that it reads what was written.  The energy follows
exp(-6νt) while the vortex is young.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.io import BinaryDriver, open_file
from pencilarrays_tpu_torch.models import NavierStokesSpectral, taylor_green

from . import _launch

SIZES = {"n": 512, "steps": 10}
NU = DT = 5e-3      # the JAX script's viscosity and time step
# |E/E0 - exp(-6 nu t)| of the young vortex (chip_smoke.py's phase 5 bar)
ENERGY_TOL = 2e-5


# the fingerprint's modulus (a prime below 2^31: each product of two
# residues fits in int64, and so does a sum of 2^32 of them)
_P = 2_147_483_647


def _fingerprint(x) -> int:
    """An exact fingerprint of ``x``'s logical values by global position,
    the same under every decomposition and memory order (a collective):
    the sum, modulo :data:`_P`, of each element's bits times a weight of
    its global index.  A value read into the wrong place changes it."""
    block = x.local_block()
    word = {4: torch.int32, 8: torch.int64}[block.element_size()]
    bits = block.contiguous().view(word).to(torch.int64) % _P
    index = torch.zeros((), dtype=torch.int64, device=block.device)
    for r, n in zip(x.range_local(), x.size_global()):
        index = index[..., None] * n + torch.arange(
            r.start, r.stop, dtype=torch.int64, device=block.device)
    weight = (index * 48271 + 1) % _P
    total = ((bits * weight) % _P).sum()
    if dist.is_initialized():
        dist.all_reduce(total)
    return int(total) % _P


def run(device=None, n=SIZES["n"], steps=SIZES["steps"]) -> dict:
    nu, dt = NU, DT
    topo = pat.Topology.auto(2, device=device)
    model = NavierStokesSpectral(topo, n, viscosity=nu, dtype=torch.float32)
    uh = taylor_green(model)
    e0 = float(model.energy(uh))
    for _ in range(steps):
        uh = model.step(uh, dt)
    e1 = float(model.energy(uh))
    u = model.to_physical(uh)

    topo2 = pat.Topology.auto(1, device=device)
    model2 = NavierStokesSpectral(topo2, n, viscosity=nu,
                                  dtype=torch.float32)
    pen_r = model2.plan.input_pencil.replace(
        permutation=pat.Permutation(2, 1, 0))
    with _launch.shared_tmpdir("pa_ns_example_") as tmp:
        path = os.path.join(tmp, "tg.bin")
        with open_file(BinaryDriver(), path, write=True, create=True) as f:
            f.write("velocity", u)
        with open_file(BinaryDriver(), path, read=True) as f:
            u2 = f.read("velocity", pen_r)
    if _fingerprint(u2) != _fingerprint(u):
        raise AssertionError("the restarted velocity differs from the "
                             "written one")
    uh2 = model2.from_physical(pat.transpose(u2, model2.plan.input_pencil))
    e2 = float(model2.energy(uh2))
    uh2 = model2.step(uh2, dt)
    e3 = float(model2.energy(uh2))

    energies = [e0, e1, e2, e3]
    times = [0.0, steps * dt, steps * dt, (steps + 1) * dt]
    devs = [abs(e / e0 - math.exp(-6 * nu * t))
            for e, t in zip(energies, times)]
    if not all(math.isfinite(e) for e in energies) or not e3 < e1 < e0:
        raise AssertionError(f"energies {energies}")
    if not max(devs) <= ENERGY_TOL:
        raise AssertionError(f"energy off exp(-6 nu t) by {max(devs)}")
    return {"n": n, "topology": list(topo.dims),
            "restart_topology": list(topo2.dims),
            "energy_step0": e0, f"energy_step{steps}": e1,
            "energy_restarted": e2, "energy_continued": e3,
            "max_energy_dev": max(devs),
            "velocity": _launch.gathered(u),
            "restarted": _launch.gathered(u2),
            "continued": _launch.gathered(model2.to_physical(uh2))}


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
