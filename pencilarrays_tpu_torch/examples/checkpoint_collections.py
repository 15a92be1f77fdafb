"""Collection-level checkpoint and restart.  A (u, v, w, p) state is
written as ONE dataset per driver (a trailing component dim), rewritten
in place (the binary driver ping-pongs between two file regions, so the
file stays bounded and the previous checkpoint survives a crash
mid-write) and restarted under another decomposition in one call; then
crash-safe managed checkpoints with ``keep=2``.  The twin of the JAX
package's ``examples/checkpoint_collections.py``::

    python -m pencilarrays_tpu_torch.examples.checkpoint_collections [--device cpu]

Everything is written under a temporary directory, removed afterwards.
"""

from __future__ import annotations

import os
import time

import numpy as np

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.io import (BinaryDriver, HDF5Driver, has_hdf5,
                                       open_file)
from pencilarrays_tpu_torch.resilience import CheckpointManager

from . import _launch

# two rewrites at the card's width (the JAX script rewrites 3 times):
# each 2 GiB rewrite is fsync-bound, several seconds on the card's disk.
# The second one's factor (2) differs from the first write's, and the
# ping-pong flips back once
SIZES = {"shape": (512, 512, 512), "rotations": 2}
SEED = 0            # the JAX script's numpy seed


def _same(got, want, what, rtol=1e-6):
    """``got`` within ``rtol`` of ``want`` elementwise on every rank's
    block (the script's ``assert_allclose`` of the gathered arrays)."""
    excess = abs(got - want) - abs(want) * rtol
    if bool(pat.ops.any(excess, pred=lambda d: d > 0)):
        raise AssertionError(f"{what} differs from the written state")


def run(device=None, shape=SIZES["shape"],
        rotations=SIZES["rotations"]) -> dict:
    shape = tuple(shape)
    seconds, t0 = {}, time.perf_counter()

    def lap(stage):
        # host wall seconds by stage (the I/O calls return when done)
        nonlocal t0
        t1 = time.perf_counter()
        seconds[stage] = t1 - t0
        t0 = t1

    P = pat.distributed.process_count()
    # the JAX script's (2, 4) mesh on 8 ranks; its restart is a slab of
    # every rank
    topo = pat.Topology((2, 4) if P == 8 else pat.dims_create(P, 2),
                        device=device)
    pen = pat.Pencil(topo, shape, (1, 2))
    rng = np.random.default_rng(SEED)
    arrays = [rng.standard_normal(shape).astype("f4") for _ in range(4)]
    state = tuple(pat.PencilArray.from_global(pen, a) for a in arrays)
    pen2 = pat.Pencil(pat.Topology((P,), device=device), shape, (0,))
    u0 = pat.PencilArray.from_global(pen2, arrays[0])   # u, on pen2
    del arrays
    lap("inputs")
    scale = float(max(rotations, 1))          # the last write's factor
    out = {"shape": list(shape), "topology": list(topo.dims)}
    with _launch.shared_tmpdir("pa_ckpt_example_") as workdir:
        path = os.path.join(workdir, "flow.bin")
        # -- the whole state as ONE dataset, rewritten ``rotations`` times
        with open_file(BinaryDriver(), path, write=True, create=True) as f:
            f.write("state", state)
        size_first = os.path.getsize(path)
        lap("write")
        for step in range(rotations):
            bumped = tuple(x * (1.0 + step) for x in state)
            with open_file(BinaryDriver(), path, append=True,
                           write=True) as f:
                f.write("state", bumped)
        size_final = os.path.getsize(path)
        lap("rewrites")
        if not size_final <= 2 * size_first + 4096:
            raise AssertionError("rotation must stay bounded")
        # -- restart under another decomposition, one call
        with open_file(BinaryDriver(), path, read=True) as f:
            u, v, w, p = f.read("state", pen2)
        _same(u, u0 * scale, "binary restart")
        lap("restart")
        out.update(binary_kb=size_final / 1e3,
                   binary_restart=_launch.gathered(u))

        # -- the same collection as one HDF5 dataset
        if has_hdf5():
            h5 = os.path.join(workdir, "flow.h5")
            with open_file(HDF5Driver(), h5, write=True, create=True) as f:
                f.write("state", state)
            with open_file(HDF5Driver(), h5, read=True) as f:
                u2, *_ = f.read("state", pen2)
            _same(u2, u0, "hdf5 restart", rtol=0.0)
            if _launch.is_root():
                import h5py

                with h5py.File(h5, "r") as mf:
                    if mf["state"].shape != shape + (4,):
                        raise AssertionError(mf["state"].shape)
            out["hdf5_shape"] = list(shape) + [4]
            lap("hdf5")

        # -- crash-safe managed checkpoints: atomic steps, per-block
        # checksums, retention; step 0 is collected under keep=2
        mgr = CheckpointManager(os.path.join(workdir, "ckpts"), keep=2)
        for step in range(3):
            mgr.save(step, {"state": tuple(x * (1.0 + step)
                                           for x in state)})
        lap("managed_saves")
        if mgr.steps() != [1, 2] or mgr.latest_valid() != 2:
            raise AssertionError(f"kept {mgr.steps()}, latest "
                                 f"{mgr.latest_valid()}")
        u3, *_ = mgr.restore().read("state", pen2)
        _same(u3, u0 * 3.0, "managed restart")
        lap("managed_restore")
        out.update(managed_steps=mgr.steps(),
                   latest_valid=mgr.latest_valid(),
                   managed_restart=_launch.gathered(u3))
    out.update(ok=True, seconds=seconds)
    return out


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
