"""A whole run with the timed path broken underneath it comes out not
correct: once for each fault the cell can have (a step that returns its
state unchanged, part of the batch left out, the exchange left out, an
answer altered where it is produced).  The look for a card is skipped;
the run is the harness's own, on the CPU at a small size."""

import time

import pytest

from pabench import harness
from pencilarrays_tpu_torch.models import NavierStokesSpectral
from pencilarrays_tpu_torch.ops.fft import PencilFFTPlan
from pencilarrays_tpu_torch.parallel import transpositions as tr
from pencilarrays_tpu_torch.parallel.arrays import PencilArray

GRID = {"ns512_f32": [16, 16, 16], "pencil1024_f32": [12, 12, 12]}


def run(name, seed=2**31 + 17):
    wl, cfg = harness.find_cell(name)
    cfg = dict(cfg, grid=GRID[cfg["name"]])
    return harness.run_cell(wl, cfg, seed, 0.2, False, "cpu",
                            time.perf_counter())


def altered(fn):
    """``fn`` with one element of its result moved by a hundredth of the
    result's largest value."""
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        data = out.data if isinstance(out, PencilArray) else out
        data = data.clone()
        flat = data.view(-1)
        flat[7] = flat[7] + 1e-2 * data.abs().max()
        return (PencilArray(out.pencil, data, out.extra_dims)
                if isinstance(out, PencilArray) else data)
    return wrapper


def part_left_out(fn):
    """``fn`` with its last batch component left as zeros."""
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        data = out.data.clone()
        data[..., -1] = 0
        return PencilArray(out.pencil, data, out.extra_dims)
    return wrapper


class _Done:
    def wait(self):
        return True

    def is_completed(self):
        return True


def _no_exchange(dst, src, group=None, async_op=False):
    dst.zero_()          # nothing arrives
    return _Done() if async_op else None


FAULTS = {
    "ns512.rk2": {
        "unchanged": (NavierStokesSpectral, "step",
                      lambda orig: lambda self, uh, dt: uh),
        "altered": (NavierStokesSpectral, "step", altered),
        "component_left_out": (NavierStokesSpectral, "step", part_left_out),
    },
    "ns512.fft_rt": {
        "forward_altered": (PencilFFTPlan, "forward", altered),
        "backward_altered": (PencilFFTPlan, "backward", altered),
        "component_left_out": (PencilFFTPlan, "forward", part_left_out),
    },
    "cycle1024.alltoall": {
        "unchanged": (tr, "_plain_hop",
                      lambda orig: lambda data, *a: data.clone()),
        "exchange_left_out": (tr.dist, "all_to_all_single",
                              lambda orig: _no_exchange),
        "altered": (tr, "_plain_hop", altered),
    },
    "cycle1024.ring": {
        "unchanged": (tr, "_plain_hop",
                      lambda orig: lambda data, *a: data.clone()),
        "altered": (tr, "_plain_hop", altered),
    },
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    owner, attr, make = FAULTS[cell][fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    r = run(cell)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] >= 1


def test_exchange_fault_reaches_the_exchange(monkeypatch):
    """The exchange left out is the one the AllToAll cell's hops call."""
    calls = []

    def counting(dst, src, group=None, async_op=False):
        calls.append(src.numel())
        dst.copy_(src)
        return _Done() if async_op else None

    monkeypatch.setattr(tr.dist, "all_to_all_single", counting)
    r = run("cycle1024.alltoall")
    assert r["correct"] is True and len(calls) >= 4 * 3
