"""The port's entry points: the flagship step as a callable, and a dry
run of the flagship on n ranks with every collective priced.

* :func:`entry` returns ``(fn, args)``: one pseudo-spectral Navier–Stokes
  RK2 step at 32^3 float32 on a one-rank topology, and its Taylor–Green
  state (the JAX package's ``__graft_entry__.entry``).
* :func:`dryrun` runs, on ``dims_create(n, 2)`` ranks at the ragged
  shape (16, 12, 20): the step forward, the gradient of
  ``sum |step(u)|^2`` with one descent update, Ulysses and ring
  attention on three distinct operands, the FFT's forward against
  ``PencilFFTPlan.collective_costs``, a sweep of the meshes (2,) and
  (4, 2) by ``AllToAll`` and ``Ring`` against ``transpose_cost``, and a
  HeatFD step that must be point-to-point only.  Each section's
  collectives are recorded as they are issued
  (:mod:`~pencilarrays_tpu_torch.parallel.collectives`) and every
  comparison is asserted; the result is returned, and written as JSON
  only where the caller names a file.

::

    python -m pencilarrays_tpu_torch.entry [--dryrun N] [--device cpu]
        [--out FILE]

Without ``--dryrun`` the step is built and run once.  ``--dryrun N``
runs in this process when it is one of a group of N ranks (or N is 1),
else on N spawned ranks: NCCL over N cards, gloo with ``--device cpu``.
On one card every collective is on a size-1 axis: the dry run then
asserts that no byte crosses a rank.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional

import torch
import torch.distributed as dist

from .models import HeatFD, NavierStokesSpectral, taylor_green
from .models.attention import ring_attention, ulysses_attention
from .parallel import collectives
from .parallel.arrays import PencilArray
from .parallel.distributed import backend_for, is_root, spawn
from .parallel.pencil import Pencil
from .parallel.topology import Topology, axis_lines, dims_create
from .parallel.transpositions import AllToAll, Ring, transpose, \
    transpose_cost

__all__ = ["entry", "dryrun", "main"]

SHAPE = (16, 12, 20)          # tiny, decomposable, ragged on purpose
SWEEP_SHAPE = (16, 16, 24)    # divisible across every swept mesh
SWEEP_MESHES = ((2,), (4, 2))


def _model(topology, n):
    model = NavierStokesSpectral(topology, n, viscosity=1e-2,
                                 dtype=torch.float32)
    return model, taylor_green(model)


def entry(device=None):
    """``(fn, args)``: ``fn(data)`` is one NS RK2 step (dt = 1e-2) of a
    Taylor–Green state at 32^3 float32 on a one-rank topology, ``args``
    that state's data."""
    model, uh0 = _model(Topology((1,), device=device), 32)
    pen, extra = uh0.pencil, uh0.extra_dims

    def fn(data):
        return model.step(PencilArray(pen, data, extra), 1e-2).data

    return fn, (uh0.data,)


def _recorded(fn):
    """``fn()`` and the ``{op: {"count", "bytes"}}`` of the collectives
    this rank issued in it."""
    with collectives.recording() as rec:
        out = fn()
    return out, collectives.stats(rec["ops"])


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(torch.view_as_real(t) if t.is_complex()
                               else t).all())


def _sub_topology(dims, device):
    """A topology over the first ``prod(dims)`` ranks (None on the
    others, which still join every group creation)."""
    n = math.prod(dims)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n == world:
        return Topology(dims, device=device)
    group = dist.new_group(list(range(n)))
    if dist.get_rank() < n:
        return Topology(dims, device=device, group=group)
    for axis in range(len(dims)):
        for line in axis_lines(dims, axis):
            dist.new_group(list(line))
    return None


def _dryrun_rank(n: int, device=None) -> dict:
    """The dry run's sections on this rank (one of ``n``)."""
    dims = dims_create(n, 2) if n > 1 else (1,)
    topo = Topology(dims, device=device)
    model, uh0 = _model(topo, SHAPE)
    pen, extra = uh0.pencil, uh0.extra_dims
    out = {"n_devices": n, "mesh_dims": list(dims),
           "global_shape": list(SHAPE)}

    # the flagship step forward (every transpose an exchange on the mesh)
    step, stats = _recorded(lambda: model.step(uh0, 1e-2))
    if step.data.shape != uh0.data.shape or not _finite(step.data):
        raise AssertionError("forward: shape or finiteness")
    out["forward"] = {"collectives": stats, "ok": True}

    # the gradient of sum |step(u)|^2 through every exchange, and one
    # descent update; backward runs on this thread, where it is recorded
    def grad_step():
        leaf = uh0.data.detach().clone().requires_grad_()
        y = model.step(PencilArray(pen, leaf, extra), 1e-2).data
        loss = (y.real ** 2 + y.imag ** 2).sum()
        (g,) = torch.autograd.grad(loss, leaf)
        return uh0.data - 1e-3 * g

    with torch.autograd.set_multithreading_enabled(False):
        upd, stats = _recorded(grad_step)
    if upd.shape != uh0.data.shape or not _finite(upd):
        raise AssertionError("train_step_grad: shape or finiteness")
    out["train_step_grad"] = {"collectives": stats, "ok": True}

    # sequence-parallel attention on a 1-D mesh of the same ranks, on
    # three distinct operands
    pen_seq = Pencil(Topology((n,), device=device), (8 * n, n), (0,))
    d = PencilArray.zeros(pen_seq, (4,)).data
    q, k, v = (PencilArray(pen_seq, x, (4,))
               for x in (d, d + 1.0, d * 2.0 - 1.0))
    (a_u, a_r), stats = _recorded(lambda: (ulysses_attention(q, k, v),
                                           ring_attention(q, k, v)))
    if a_u.data.shape != d.shape or a_r.data.shape != d.shape:
        raise AssertionError("attention: output shapes")
    out["attention_seq_parallel"] = {"collectives": stats, "ok": True}

    # the FFT's byte model: measured collectives == collective_costs
    plan = model.plan
    x = plan.allocate_input(extra)
    _, measured = _recorded(lambda: plan.forward(x))
    expected = plan.collective_costs(extra)
    if measured != expected:
        raise AssertionError(f"fft_forward: {measured} != {expected}")
    out["fft_forward"] = {"measured": measured, "expected": expected,
                          "ok": True}

    # the transpose byte model on sub-meshes, by method
    sweep = []
    for sub in SWEEP_MESHES:
        if math.prod(sub) > n:
            continue
        topo_s = _sub_topology(sub, device)
        if topo_s is None:
            continue
        M = len(sub)
        pin = Pencil(topo_s, SWEEP_SHAPE, tuple(range(1, M + 1)))
        pout = Pencil(topo_s, SWEEP_SHAPE, (0,) + tuple(range(2, M + 1)))
        for name, method in (("AllToAll", AllToAll()), ("Ring", Ring())):
            x = PencilArray.zeros(pin, (), torch.float32)
            _, got = _recorded(lambda: transpose(x, pout, method=method))
            exp = transpose_cost(pin, pout, (), torch.float32, method)
            if got != exp:
                raise AssertionError(f"byte model {sub} {name}: {got} != "
                                     f"{exp}")
            sweep.append({"mesh": list(sub), "method": name,
                          "measured": got, "expected": exp, "ok": True})
    out["byte_model_sweep"] = sweep

    # one FD heat step: neighbour exchanges only
    heat = HeatFD(topo, SHAPE, kappa=0.1)
    _, stats = _recorded(lambda: heat.step(heat.allocate(),
                                           heat.stable_dt()))
    if not set(stats) <= {"collective-permute"}:
        raise AssertionError(f"stencil_halo_step: {stats}")
    out["stencil_halo_step"] = stats

    if n == 1:
        # one rank: every axis has size 1, so nothing crosses a rank
        moved = [out[s]["collectives"] for s in (
            "forward", "train_step_grad", "attention_seq_parallel")]
        moved += [out["fft_forward"]["measured"], out["stencil_halo_step"]]
        if any(moved):
            raise AssertionError(f"one rank issued collectives: {moved}")
    out["ok"] = True
    return out


def dryrun(n: int, device=None, out: Optional[str] = None) -> dict:
    """The dry run on ``n`` ranks (module docstring): in this process
    when it is one of a group of ``n`` ranks, or ``n`` is 1; else on
    ``n`` spawned ranks.  Returns rank 0's sections (every rank's must
    be ``ok``); writes them as JSON to ``out`` when given."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == n:
        result = _dryrun_rank(n, device)
    else:
        if dist.is_initialized():
            raise RuntimeError(f"dryrun({n}) in a process group of {world} "
                               f"ranks")
        results = spawn(_dryrun_rank, n, n, device,
                        backend=backend_for(device, n),
                        timeout_s=1800.0)
        if not all(r["ok"] for r in results):
            raise AssertionError("a rank's dry run failed")
        result = results[0]
    if out is not None and is_root():
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pencilarrays_tpu_torch.entry",
                                description="the flagship step, and its dry "
                                            "run on N ranks")
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="run the dry run on N ranks")
    p.add_argument("--device", default=None,
                   help="cuda (default: each rank's card) or cpu")
    p.add_argument("--out", default=None,
                   help="write the dry run's JSON here")
    args = p.parse_args(argv)
    if args.dryrun is not None:
        backend_for(args.device, args.dryrun)
        result = dryrun(args.dryrun, args.device, args.out)
        print(json.dumps(result))
        return 0 if result["ok"] else 1
    backend_for(args.device, 1)
    fn, (data,) = entry(args.device)
    y = fn(data)
    print(f"entry: one NS step of {tuple(data.shape)} "
          f"{str(data.dtype).split('.')[-1]} -> {tuple(y.shape)}, finite "
          f"{_finite(y)}")
    return 0 if _finite(y) else 1


if __name__ == "__main__":
    raise SystemExit(main())
