"""Quick start: the README walkthrough on the port.

``make_pencil``, a permuted y-pencil transpose checked against the
gathered ground truth, the padding-masked reductions, a grid broadcast,
NumPy ufuncs on a PencilArray, a distributed r2c FFT round trip, and
pipelined hops bit-identical to the plain one.  The twin of the JAX
package's ``examples/quickstart.py``::

    python -m pencilarrays_tpu_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import pencilarrays_tpu_torch as pat

from . import _launch

SIZES = {"shape": (42, 31, 29), "n_fft": 64}
SEED = 42           # the JAX script's key (the port's own fill)


def run(device=None, shape=SIZES["shape"], n_fft=SIZES["n_fft"],
        u=None) -> dict:
    """The walkthrough on a balanced 2-D topology of every rank.  ``u``
    (a global logical-order array on every rank) replaces the port's
    own normal fill of ``SEED``."""
    shape = tuple(shape)
    root = _launch.is_root()
    topo = pat.Topology.auto(2, device=device)
    pen_x = pat.Pencil(topo, shape, (1, 2))
    if u is None:
        ux = pat.ops.normal(pen_x, SEED, dtype=torch.float32)
    else:
        ux = pat.PencilArray.from_global(pen_x, np.asarray(u))
    out = {"topology": list(topo.dims),
           "block_0_0": [[r.start, r.stop]
                         for r in pen_x.range_local((0,) * topo.ndims)],
           "mean": float(pat.ops.mean(ux)),
           "max": float(pat.ops.maximum(ux))}

    # the y-pencil, stored (y, x, z): an exchange along the first mesh axis
    pen_y = pat.Pencil(topo, shape, (0, 2),
                       permutation=pat.Permutation(1, 0, 2))
    v = pat.transpose(ux, pen_y)
    gu, gv = pat.gather(ux), pat.gather(v)
    if root and not np.array_equal(gv, gu):
        raise AssertionError("transpose x->y differs from the ground truth")
    out["transpose_verified"] = True
    out["u"] = gu
    out["norm_y"] = float(pat.ops.norm(v))

    # a grid broadcast, evaluated on each rank's block
    g = pat.localgrid(pen_x, [np.linspace(0, 1, n) for n in shape])
    w = g.evaluate(lambda x, y, z: x + 2 * y * torch.cos(z))
    out["grid"] = pat.gather(w)

    # NumPy ufuncs run on the blocks; np.sum is the masked global sum
    w2 = np.cos(w) * np.linspace(0, 1, shape[0]).reshape(-1, 1, 1) + w * 2.0
    out["numpy_sum"] = float(np.sum(w2))

    # a distributed r2c FFT and its round trip
    plan = pat.PencilFFTPlan(topo, (n_fft,) * 3, real=True,
                             dtype=torch.float32)
    f = pat.ops.normal(plan.input_pencil, SEED + 1, dtype=torch.float32)
    back = plan.backward(plan.forward(f))
    err = float(pat.ops.maximum(abs(back - f))) / float(
        pat.ops.maximum(abs(f)))
    if not err <= 1e-5:
        raise AssertionError(f"FFT round trip error {err} > 1e-5")
    out["fft_round_trip_rel_err"] = err

    # pipelined hops: the exchange in 4 chunks, bit-identical
    gvp = pat.gather(pat.transpose(ux, pen_y, method=pat.Pipelined(chunks=4)))
    if root and not np.array_equal(gvp, gv):
        raise AssertionError("Pipelined(4) hop differs from AllToAll's")
    out["pipelined_bit_identical"] = True
    return out


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
