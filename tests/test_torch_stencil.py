"""PyTorch port vs JAX package: finite-difference stencils and the halo
exchange.

``shift`` is data movement: on every port topology its result must be
the JAX package's BIT for bit (gathered; and the padded data itself,
tail padding zero, on the JAX package's own mesh), including ragged
ceil-rule blocks whose true extent is smaller than |k| or zero (n = 5
over 4 ranks: 2, 2, 1, 0 rows; n = 9 over 8).  The FD operators and
their gradient agree within 1e-12 (float64).  ``halo_exchange`` shows a
decomposed-axis shift sending boundary layers only (the counterpart of
the JAX package's HLO budget), a local-dim shift nothing.  On 1, 2, 4 and
8 gloo ranks; cases follow ``tests/test_stencil.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu.ops import stencil as JS
from pencilarrays_tpu_torch.ops import stencil as S

RTOL = 1e-12
KS = (1, -1, 3, -2)


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _jpen(devices, dims, shape, decomp, perm):
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    return jpa.Pencil(topo, shape, decomp, permutation=None if perm is None
                      else jpa.Permutation(*perm))


def _ppen(dims, shape, decomp, perm):
    return pat.Pencil(pat.Topology(dims, device="cpu"), shape, decomp,
                      permutation=None if perm is None
                      else pat.Permutation(*perm))


def _padding(pen, extra=()):
    """True on the tail padding of the padded global memory-order array."""
    padded = pen.padded_size_global()
    mask = np.zeros(padded, dtype=bool)
    for d in pen.decomposition:
        P = pen.proc_count(d)
        b = padded[d] // P
        i = np.arange(padded[d])
        true = np.array([len(pen.range_local(
            tuple(c if j == pen.decomposition.index(d) else 0
                  for j in range(pen.topology.ndims)))[d])
            for c in range(P)])
        pad = (i % b) >= true[i // b]
        shape = [1] * len(padded)
        shape[d] = padded[d]
        mask |= pad.reshape(shape)
    mask = np.transpose(mask, pen.permutation.axes()) \
        if not pen.permutation.is_identity() else mask
    return mask.reshape(mask.shape + (1,) * len(extra)) & np.ones(
        mask.shape + tuple(extra), dtype=bool)


def _shift_ops():
    return [("shift", (axis, k), {"boundary": b}) for axis in range(3)
            for k in KS for b in ("periodic", "zero")]


# (JAX mesh dims, shape, decomp, perm, port dims by rank count)
SHIFT_CASES = [
    ((4, 2), (16, 12, 8), (1, 2), None),
    ((4, 2), (10, 13, 8), (0, 1), (2, 0, 1)),
    ((4, 2), (10, 13, 8), (0, 2), (1, 2, 0)),
    ((4,), (5, 7, 3), (0,), None),          # blocks 2, 2, 1, 0 rows
    ((8,), (9, 5, 4), (0,), (1, 2, 0)),     # 2, 2, 2, 2, 1, 0, 0, 0
]
PORT_DIMS = {2: [(1, 1), (1, 2), (2, 2), (4, 2)],
             1: [(1,), (2,), (4,), (8,)]}


def _shift_params():
    out = []
    for case in SHIFT_CASES:
        for dims in PORT_DIMS[len(case[0])]:
            out.append(pytest.param(case, dims,
                                    id=f"{'x'.join(map(str, case[1]))}-"
                                       f"{case[2]}-{case[3]}-on{dims}"))
    return out


_JAX_SHIFTS = {}


def _jax_shifts(devices, case):
    """The JAX package's shift of every (axis, k, boundary), padded and
    gathered (computed once per case)."""
    if case not in _JAX_SHIFTS:
        jdims, shape, decomp, perm = case
        pen = _jpen(devices, jdims, shape, decomp, perm)
        g = np.random.default_rng(0).standard_normal(shape)
        u = jpa.PencilArray.from_global(pen, g)
        res = []
        for _, (axis, k), kw in _shift_ops():
            v = JS.shift(u, axis, k, **kw)
            res.append((np.asarray(v.data), jpa.gather(v)))
        _JAX_SHIFTS[case] = (g, res)
    return _JAX_SHIFTS[case]


@pytest.mark.parametrize("case,dims", _shift_params())
def test_shift_bit_identical_to_jax(pool, devices, case, dims):
    jdims, shape, decomp, perm = case
    g, want = _jax_shifts(devices, case)
    got = pool.run(tasks.stencil_case, dims, shape, decomp, perm, g,
                   _shift_ops())[0]
    ppen = _ppen(dims, shape, decomp, perm)
    pad = _padding(ppen)
    for (name, (axis, k), kw), ((padded, gathered), counts), (jpad, jgat) \
            in zip(_shift_ops(), got, want):
        what = (axis, k, kw["boundary"])
        assert _bits_equal(gathered, jgat), what
        assert not padded[pad].any(), what          # tail padding zero
        if dims == jdims:
            assert _bits_equal(padded, jpad), what
        # halo: only the rows a shift needs, and a local dim sends nothing
        row = np.prod(ppen.padded_size_local(pat.MemoryOrder)) // \
            ppen.padded_size_local()[axis] * 8
        for c in counts:
            assert c["calls"] <= 1 and c["bytes"] % row == 0, (what, c)
            assert c["bytes"] <= abs(k) * row * max(1, c["messages"]), \
                (what, c)
            if ppen.proc_count(axis) == 1:
                assert c == {"calls": 0, "messages": 0, "bytes": 0}, what


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (2, 2), (4, 2)])
def test_halo_budget(pool, dims):
    """Per rank and shift by 1 along a decomposed dim: one batch, one
    row to each neighbour that needs it — never a block; the Laplacian
    sends at most 4 messages (+-1 on two decomposed dims).  Along a
    padded dim the bytes stay within the JAX package's (2|k| + pad)-row
    bound."""
    shape = (16, 16, 8)
    g = np.random.default_rng(1).standard_normal(shape)
    ops = [("shift", (0, 1), {}), ("fd_laplacian", (), {"spacing": 0.1}),
           ("shift", (2, 1), {})]
    got = pool.run(tasks.stencil_case, dims, shape, (0, 1), None, g, ops)[0]
    ppen = _ppen(dims, shape, (0, 1), None)
    row = 16 // dims[1] * 8 * 8
    (_, c_shift), (_, c_lap), (_, c_local) = got
    for c in c_shift:
        assert c["bytes"] == (row if dims[0] > 1 else 0), c
        assert c["messages"] == (1 if dims[0] > 1 else 0), c
    for c in c_lap:
        assert c["messages"] <= 4 and c["calls"] <= 6, c
        assert c["bytes"] <= 2 * row + 2 * (16 // dims[0] * 8 * 8), c
    assert all(c["bytes"] == 0 for c in c_local)
    # a ceil-padded dim: n = 10 over 4, pad 2
    if dims == (4, 2):
        shape = (10, 16, 8)
        g = np.random.default_rng(2).standard_normal(shape)
        ppen = _ppen(dims, shape, (0, 1), None)
        pad = ppen.padded_global_shape[0] - 10
        row = 8 * 8 * 8
        (_, counts), = pool.run(tasks.stencil_case, dims, shape, (0, 1),
                                None, g, [("shift", (0, 1), {})])[0]
        assert max(c["bytes"] for c in counts) <= (2 + pad) * row
        assert sum(c["bytes"] for c in counts) > 0


FD_SHAPE = (12, 16, 9)
FD_H = (0.5, 0.25, 2.0)


@pytest.fixture(scope="module")
def fd_reference(devices):
    pen = _jpen(devices, (4, 2), FD_SHAPE, (0, 1), None)
    g = np.random.default_rng(2).standard_normal(FD_SHAPE)
    u = jpa.PencilArray.from_global(pen, g)
    d1 = JS.diff(u, 1, order=1, spacing=FD_H[1])
    d2 = JS.diff(u, 2, order=2, spacing=FD_H[2], boundary="zero")
    lap = JS.fd_laplacian(u, spacing=FD_H)
    div = JS.fd_divergence(JS.fd_gradient(u, spacing=FD_H), spacing=FD_H)

    def loss(d):
        w = JS.fd_laplacian(jpa.PencilArray(pen, d), spacing=0.3)
        return jnp.sum(w.data ** 2)

    grad = jax.grad(loss)(u.data)
    return g, [jpa.gather(v) for v in (d1, d2, lap, div)], (
        np.asarray(grad), jpa.gather(jpa.PencilArray(pen, grad)))


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (2, 2), (4, 2)])
def test_fd_operators_match_jax(pool, fd_reference, dims):
    g, want, (jgrad_pad, jgrad) = fd_reference
    ops = [("diff", (1,), {"order": 1, "spacing": FD_H[1]}),
           ("diff", (2,), {"order": 2, "spacing": FD_H[2],
                           "boundary": "zero"}),
           ("fd_laplacian", (), {"spacing": FD_H}),
           ("fd_divergence_of_gradient", (), {"spacing": FD_H})]
    got = pool.run(tasks.stencil_case, dims, FD_SHAPE, (0, 1), None, g,
                   ops)[0]
    for ((_, gathered), _), w in zip(got, want):
        np.testing.assert_allclose(gathered, w, rtol=RTOL, atol=1e-11)
    wantg = [(np.roll(g, -1, d) - np.roll(g, 1, d)) / (2 * FD_H[d])
             for d in range(3)]
    np.testing.assert_allclose(
        got[3][0][1], sum((np.roll(w, -1, d) - np.roll(w, 1, d)) /
                          (2 * FD_H[d]) for d, w in enumerate(wantg)),
        atol=1e-11)
    pad, gathered = pool.run(tasks.stencil_grad_case, dims, FD_SHAPE,
                             (0, 1), None, g, 0.3)[0]
    np.testing.assert_allclose(gathered, jgrad, rtol=1e-10, atol=1e-10)
    if dims == (4, 2):
        np.testing.assert_allclose(pad, jgrad_pad, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dims", [(1,), (2,), (4,), (8,)])
def test_extra_dims_and_decomposition_independent(pool, dims):
    g = np.random.default_rng(4).standard_normal((8, 6, 3))
    (res, _), = pool.run(tasks.stencil_case, dims, (8, 6), (0,), None, g,
                         [("shift", (0, 2), {})])[0]
    assert _bits_equal(res[1], np.roll(g, -2, axis=0))
    shape = (12, 10, 8)
    g = np.random.default_rng(5).standard_normal(shape)
    want = pat.gather(S.fd_laplacian(pat.PencilArray.from_global(
        _ppen((1,), shape, (0,), None), g), spacing=0.7, boundary="zero"))
    (res, _), = pool.run(tasks.stencil_case, dims, shape, (1,), None, g,
                         [("fd_laplacian", (), {"spacing": 0.7,
                                                "boundary": "zero"})])[0]
    np.testing.assert_allclose(res[1], want, atol=1e-12)


def test_fd_laplacian_converges():
    errs = []
    for n in (16, 32):
        h = 2 * np.pi / n
        x = np.arange(n) * h
        g = np.sin(x)[:, None] * np.cos(2 * x)[None, :]
        u = pat.PencilArray.from_global(_ppen((1,), (n, n), (0,), None), g)
        lap = pat.gather(S.fd_laplacian(u, spacing=h))
        errs.append(np.abs(lap + 5 * g).max())
    assert errs[1] < errs[0] / 3.0


def test_validation_errors():
    u = pat.PencilArray.zeros(_ppen((1,), (8, 8), (0,), None))
    with pytest.raises(ValueError):
        S.shift(u, 5, 1)
    with pytest.raises(ValueError):
        S.shift(u, 0, 1, boundary="reflect")
    with pytest.raises(ValueError):
        S.diff(u, 0, order=3)
    with pytest.raises(ValueError):
        S.fd_gradient(u, spacing=(1.0,))
    with pytest.raises(ValueError):
        S.fd_divergence([u], spacing=1.0)


def test_pieces_cover_every_row():
    """The exchange plan: every true row of every block gets exactly one
    source row, the one ``(i + k)`` names, for ragged extents too."""
    for n, P, k, boundary in [(5, 4, 3, "periodic"), (5, 4, -6, "periodic"),
                              (9, 8, 3, "zero"), (10, 4, -1, "periodic"),
                              (7, 3, 7, "zero"), (1, 4, 2, "periodic")]:
        b = -(-n // P)
        for p in range(P):
            seen = {}
            for j, q, s, m in S._pieces(p, b, n, k, boundary):
                for t in range(m):
                    assert j + t not in seen
                    seen[j + t] = q * b + s + t
            lo, hi = min(p * b, n), min((p + 1) * b, n)
            for g in range(lo, hi):
                src = (g + k) % n if boundary == "periodic" else g + k
                if 0 <= src < n:
                    assert seen.pop(g - p * b) == src
            assert not seen
