"""PyTorch port vs JAX package: rectilinear grids over pencils.

Each rank's coordinate components (its slice of the global vector,
zero-padded, non-singleton at the dim's memory position) must be the JAX
package's components BIT for bit; ``evaluate``, ``zip_with`` and
``meshgrid`` agree within 1e-12 (float64; the same expression, torch's
``cos`` against XLA's), padding included on the JAX package's own (2, 4)
mesh; the grid walk visits the same points in the same memory order.
On 1, 2, 4 and 8 gloo ranks; cases follow ``tests/test_localgrid.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks

DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]
RTOL = 1e-12


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _coords(shape):
    return [np.linspace(0.0, d + 1.0, n) for d, n in enumerate(shape)]


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _expected_component(pen, coords, d, rank):
    """Rank ``rank``'s component of dim ``d``, built in NumPy."""
    N = pen.ndims
    c = pen.topology.coords(rank)
    r = pen.range_local(c)[d]
    n_pad = pen.padded_size_local()[d]
    out = np.zeros(n_pad)
    out[:len(r)] = coords[d][r.start:r.stop]
    shape = [1] * N
    shape[pen.permutation.apply(tuple(range(N))).index(d)] = n_pad
    return out.reshape(shape)


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("shape,perm", [((13, 11, 10), None),
                                        ((13, 11, 10), (2, 0, 1)),
                                        ((8, 10, 12), (1, 2, 0)),
                                        ((3, 4, 2), (2, 0, 1))])
def test_grid_matches_jax(pool, devices, dims, shape, perm):
    coords = _coords(shape)
    u = np.random.default_rng(5).standard_normal(shape)
    jtopo = jpa.Topology((2, 4))
    jpen = jpa.Pencil(jtopo, shape, (1, 2), permutation=None if perm is None
                      else jpa.Permutation(*perm))
    g = jpa.localgrid(jpen, coords)
    x = jpa.PencilArray.from_global(jpen, u)
    ev = g.evaluate(lambda a, b, c: a + 2 * b * jnp.cos(c))
    ev3 = g.evaluate(lambda a, b, c: a + b + c, extra_dims=(3,))
    zw = g.zip_with(lambda v, a, b, c: v + a + 2.0 * b * jnp.cos(c), x)
    mesh = g.meshgrid()
    got = pool.run(tasks.localgrid_case, dims, shape, (1, 2), perm, coords,
                   u)[0]
    ppen = pat.Pencil(pat.Topology(dims, device="cpu"), shape, (1, 2),
                      permutation=None if perm is None
                      else pat.Permutation(*perm))
    for rank, comps in enumerate(got["components"]):
        for d in range(3):
            want = _expected_component(ppen, coords, d, rank)
            assert _bits_equal(comps[d], want), (rank, d)
            if dims == (2, 4):   # the JAX package's component, this block
                jc = np.asarray(g[d])
                pos = ppen.permutation.apply((0, 1, 2)).index(d)
                b = comps[d].shape[pos]
                i = ppen.decomposition.index(d) if d in (1, 2) else None
                start = 0 if i is None else ppen.topology.coords(rank)[i] * b
                sl = [slice(None)] * 3
                sl[pos] = slice(start, start + b)
                assert _bits_equal(comps[d], jc[tuple(sl)]), (rank, d)
    for d in range(3):
        assert _bits_equal(got["names"][d], got["components"][0][d])
    pairs = [("evaluate", ev), ("evaluate3", ev3), ("zip_with", zw)] + [
        (f"mesh{d}", jpa.PencilArray(jpen, m)) for d, m in enumerate(mesh)]
    for name, want in pairs:
        mine = got["meshgrid"][int(name[-1])] if name.startswith(
            "mesh") else got[name]
        if dims == (2, 4):
            np.testing.assert_allclose(mine, np.asarray(want.data),
                                       rtol=RTOL, atol=1e-14, err_msg=name)
        else:
            ppad = pat.Pencil(pat.Topology(dims, device="cpu"), shape,
                              (1, 2), permutation=ppen.permutation)
            assert mine.shape == ppad.padded_size_global(
                pat.MemoryOrder) + want.extra_dims, name
    X, Y, Z = np.meshgrid(*coords, indexing="ij")
    np.testing.assert_allclose(
        jpa.gather(zw), u + X + 2.0 * Y * np.cos(Z), rtol=RTOL)
    assert got["walk"] == list(g) and got["length"] == len(g)


def test_grid_single_process():
    shape = (13, 11, 10)
    coords = _coords(shape)
    pen = pat.Pencil(pat.Topology((1, 1), device="cpu"), shape, (1, 2),
                     permutation=pat.Permutation(2, 0, 1))
    g = pat.localgrid(pen, coords)
    assert g.ndims == 3 and len(g.components()) == 3
    assert g.x.shape == (1, 13, 1) and g.z.shape == (10, 1, 1)
    with pytest.raises(AttributeError):
        g.w
    np.testing.assert_array_equal(g.coordinate(0).numpy(), coords[0])
    u = g.evaluate(lambda a, b, c: a + 2 * b * torch.cos(c))
    X, Y, Z = np.meshgrid(*coords, indexing="ij")
    np.testing.assert_allclose(pat.gather(u), X + 2 * Y * np.cos(Z),
                               rtol=RTOL)
    assert list(reversed(g))[0] == list(g)[-1]
    assert "LocalRectilinearGrid" in repr(g)
    with pytest.raises(ValueError):
        pat.localgrid(pen, coords[:2])
    with pytest.raises(ValueError):
        pat.localgrid(pen, [coords[0], coords[1], np.arange(3.0)])
    with pytest.raises(ValueError, match="pencil"):
        g.zip_with(lambda a, *k: a, pat.PencilArray.zeros(
            pen.replace(decomp_dims=(0, 2))))


def test_permuted_indices_match_jax():
    from pencilarrays_tpu.utils.permuted_indices import (
        PermutedCartesianIndices as JC, PermutedLinearIndices as JL)

    for shape, perm in [((3, 4, 2), (2, 0, 1)), ((5, 2, 3), (1, 2, 0)),
                        ((4, 3), (1, 0))]:
        pc = pat.PermutedCartesianIndices(shape, pat.Permutation(*perm))
        jc = JC(shape, jpa.Permutation(*perm))
        assert list(pc) == list(jc) and len(pc) == len(jc)
        assert [pc[i] for i in range(len(pc))] == list(jc)
        pl = pat.PermutedLinearIndices(shape, pat.Permutation(*perm))
        jl = JL(shape, jpa.Permutation(*perm))
        assert [pl[i] for i in pc] == [jl[i] for i in jc] == list(
            range(len(pl)))
