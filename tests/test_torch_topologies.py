"""PyTorch port vs JAX package: 1-, 2- and 3-D topologies and M = N
decompositions.

Every case of ``tests/test_topologies_sweep.py`` and
``tests/test_full_decomposition.py``: the port on 8 ranks of the shared
gloo pool as ``(8,)``, ``(4, 2)``, ``(2, 4)`` and ``(2, 2, 2)``, the JAX
package on its 8-device CPU mesh, the same seeded inputs.  Data movement
is compared with JAX's padded arrays bit for bit and with the input;
reductions within 1e-12 of JAX's (float64; the ranks sum in another
order), maxima exactly; FFTs within 1e-10 of the largest JAX value
(complex128), as ``tests/test_torch_fft.py`` holds them.  The
full-decomposition restart writes on the port's M = N pencil, reads on a
``(2, 4)`` pencil of the same ranks and back; the JAX package reads the
port's file on its own ``(2, 4)`` pencil.
"""

import math

import numpy as np
import pytest

import pencilarrays_tpu as jpa
import torch_parity_tasks as tasks
import torch_rank_tasks
from pencilarrays_tpu import ops as jops

TOPOS = [(8,), (4, 2), (2, 4), (2, 2, 2)]
RTOL = 1e-12
FFT_TOL = 1e-10


@pytest.fixture(scope="module")
def pool():
    return torch_rank_tasks.shared_pool()


def _topo(devices, dims):
    return jpa.Topology(dims, devices=devices[:math.prod(dims)])


def _pen(topo, shape, spec):
    decomp, perm = spec
    return jpa.Pencil(topo, shape, decomp,
                      permutation=jpa.Permutation(*perm) if perm else None)


def ref(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _run(pool, fn, *args):
    return pool.run(fn, *args)[0]


def _jax_chain(x, pens, methods):
    """JAX's padded arrays after each hop of the chain."""
    out = []
    for pen, m in zip(pens, methods):
        x = jpa.reshard(x, pen) if m is None else jpa.transpose(
            x, pen, method=m)
        out.append(np.asarray(x.data))
    return out


@pytest.mark.parametrize("dims", TOPOS)
def test_transpose_under_every_topology(devices, pool, dims):
    """N = M + 1: slot 0 moves from dim 1 to dim 0 under AllToAll and
    Gspmd, each hop JAX's bits, and back bit for bit."""
    M = len(dims)
    N = M + 1
    shape = tuple([12, 10, 14, 9][:N])
    u = ref(shape)
    spec_a = (tuple(range(1, N)), None)
    spec_b = ((0,) + tuple(range(2, N)), None)
    topo = _topo(devices, dims)
    x = jpa.PencilArray.from_global(_pen(topo, shape, spec_a), u)
    for name in ("AllToAll", "Gspmd"):
        (want,) = _jax_chain(x, [_pen(topo, shape, spec_b)],
                             [getattr(jpa, name)()])
        r = _run(pool, tasks.chain_case, dims, shape, [spec_a, spec_b], u,
                 [(name, {})])
        (bits, got), = r["hops"]
        assert np.array_equal(got, u) and np.array_equal(bits, want)
        assert r["same"] and np.array_equal(r["back"], u)


def test_3d_topology_4d_array_chain(devices, pool):
    """M = 3 of a 4-D array: a chain through four pencils (two of them
    permuted) and back."""
    dims, shape = (2, 2, 2), (10, 9, 8, 11)
    u = ref(shape, 1)
    specs = [((1, 2, 3), (1, 2, 3, 0)), ((0, 2, 3), None),
             ((0, 1, 3), (3, 0, 1, 2)), ((0, 1, 2), None)]
    topo = _topo(devices, dims)
    pens = [_pen(topo, shape, s) for s in specs]
    x = jpa.PencilArray.from_global(pens[0], u)
    want = _jax_chain(x, pens[1:], [jpa.AllToAll()] * 3)
    r = _run(pool, tasks.chain_case, dims, shape, specs, u,
             [("AllToAll", {})] * 3)
    for (bits, got), w in zip(r["hops"], want):
        assert np.array_equal(got, u) and np.array_equal(bits, w)
    assert r["same"]


def test_full_decomposition_m_eq_n(devices, pool):
    """M = N = 3: gathered, summed, and resharded to another axis
    assignment."""
    dims, shape = (2, 2, 2), (6, 7, 9)
    u = ref(shape, 2)
    spec, spec2 = ((0, 1, 2), None), ((2, 0, 1), None)
    topo = _topo(devices, dims)
    x = jpa.PencilArray.from_global(_pen(topo, shape, spec), u)
    (want,) = _jax_chain(x, [_pen(topo, shape, spec2)], [None])
    r = _run(pool, tasks.chain_case, dims, shape, [spec, spec2], u,
             ["reshard"], False, False)
    (bits, got), = r["hops"]
    assert np.array_equal(got, u) and np.array_equal(bits, want)
    s = _run(pool, tasks.reductions_case, dims, shape, spec, u, ["sum"])
    np.testing.assert_allclose(s["sum"], float(jops.sum(x)), rtol=RTOL)
    assert np.isclose(s["sum"], u.sum())


def test_reductions_3d_topology(devices, pool):
    dims, shape = (2, 2, 2), (7, 9, 11, 5)
    u = ref(shape, 3)
    spec = ((0, 2, 3), (2, 0, 3, 1))
    x = jpa.PencilArray.from_global(_pen(_topo(devices, dims), shape, spec),
                                    u)
    r = _run(pool, tasks.reductions_case, dims, shape, spec, u,
             ["norm", "maximum"])
    np.testing.assert_allclose(r["norm"], float(jops.norm(x)), rtol=RTOL)
    assert np.isclose(r["norm"], np.linalg.norm(u.ravel()))
    assert r["maximum"] == float(jops.maximum(x)) == u.max()


def test_fft_3d_topology_4d_array(devices, pool):
    dims, shape = (2, 2, 2), (8, 10, 6, 12)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    plan = jpa.PencilFFTPlan(_topo(devices, dims), shape,
                             dtype=np.complex128)
    want = jpa.gather(plan.forward(
        jpa.PencilArray.from_global(plan.input_pencil, u)))
    got, back = _run(pool, tasks.fft_case, dims, shape, u,
                     dict(dtype="complex128"))
    assert np.abs(got - want).max() <= FFT_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, np.fft.fftn(u), rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(back, u, rtol=1e-10, atol=1e-10)


# -- tests/test_full_decomposition.py ----------------------------------------

def test_fully_decomposed_pencil_and_permutation_change(devices, pool):
    """M = N = 3 by default; a transpose that changes only the
    permutation is a local relayout with JAX's bits."""
    dims, shape = (2, 2, 2), (12, 10, 8)
    rng = np.random.default_rng(0)
    u = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    topo = _topo(devices, dims)
    pen1 = jpa.Pencil(topo, shape)
    pen2 = pen1.replace(permutation=jpa.Permutation(1, 2, 0))
    want = np.asarray(jpa.transpose(jpa.PencilArray.from_global(pen1, u),
                                    pen2).data)
    r = _run(pool, tasks.default_pencil_case, dims, shape, (1, 2, 0), u)
    assert r["decomposition"] == pen1.decomposition == (0, 1, 2)
    assert r["identity"]
    assert r["perm"] == (1, 2, 0)
    assert np.array_equal(r["gathered"], u)
    assert np.array_equal(r["bits"], want)


def test_fully_decomposed_ragged_and_reductions(devices, pool):
    dims, shape = (2, 2, 2), (7, 9, 5)
    u = ref(shape, 1)
    spec = ((0, 1, 2), None)
    x = jpa.PencilArray.from_global(_pen(_topo(devices, dims), shape, spec),
                                    u)
    r = _run(pool, tasks.fully_decomposed_case, dims, shape, spec, u)
    assert np.array_equal(r["gathered"], u)
    np.testing.assert_allclose(r["sum"], float(jops.sum(x)), rtol=RTOL)
    np.testing.assert_allclose(r["mean"], float(jops.mean(x)), rtol=RTOL)
    assert r["max"] == float(jops.maximum(x)) == u.max()
    assert r["cos_wrapped"]
    np.testing.assert_allclose(r["cos"], jpa.gather(np.cos(x)), rtol=1e-12)
    np.testing.assert_allclose(r["cos"], np.cos(u), rtol=1e-6)


def test_fully_decomposed_2d(devices, pool):
    dims, shape = (2, 4), (10, 12)
    u = ref(shape, 2)
    r = _run(pool, tasks.fully_decomposed_case, dims, shape,
             ((0, 1), None), u)
    assert np.array_equal(r["gathered"], u)


def test_fully_decomposed_transpose_rules(devices, pool):
    """No single-slot hop between M = N decompositions: transpose
    refuses as JAX does, reshard redistributes with JAX's bits."""
    dims, shape = (2, 2, 2), (8, 8, 8)
    u = ref(shape, 3)
    spec1, spec2 = ((0, 1, 2), None), ((1, 0, 2), None)
    topo = _topo(devices, dims)
    x = jpa.PencilArray.from_global(_pen(topo, shape, spec1), u)
    with pytest.raises(ValueError, match="more than one slot"):
        jpa.transpose(x, _pen(topo, shape, spec2))
    want = np.asarray(jpa.reshard(x, _pen(topo, shape, spec2)).data)
    msg, bits, got = _run(pool, tasks.refuses_case, dims, shape, spec1,
                          spec2, u)
    assert msg is not None and "more than one slot" in msg
    assert np.array_equal(got, u) and np.array_equal(bits, want)


def test_fully_decomposed_io_restart(devices, pool, tmp_path):
    """Write under M = N, restart under M < N and back, on the port; the
    JAX package reads the port's file under its own M < N pencil."""
    from pencilarrays_tpu.io import BinaryDriver, open_file

    shape = (6, 10, 8)
    u = ref(shape, 4)
    path = str(tmp_path / "full.bin")
    r = _run(pool, tasks.io_restart_case, (2, 2, 2), (2, 4), shape,
             ((0, 1, 2), None), ((1, 2), None), u, path)
    assert np.array_equal(r["back"], u)
    assert np.array_equal(r["again"], u) and r["on_pen"]
    pen2 = jpa.Pencil(_topo(devices, (2, 4)), shape, (1, 2))
    with open_file(BinaryDriver(), path, read=True) as f:
        for name in ("u", "v"):
            assert np.array_equal(jpa.gather(f.read(name, pen2)), u)
