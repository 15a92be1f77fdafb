"""PyTorch port vs JAX package: the rest of PencilArray.

Global logical indexing, ``logical()``, ``np.asarray`` and ``local_block``
are collectives in the port (each rank holds one block); on every rank
they must return the JAX package's answer BIT for bit.  The NumPy
protocols (``np.cos(x)``, ``np.add(raw, x)``, ``np.sum(x)``), the ``pnp``
namespace, the elementwise methods and the comparisons must agree with
the JAX package's on the padded data: data movement and fills bit for
bit, arithmetic within 1e-12 (float64).  Each case runs on 1, 2, 4 and 8
gloo ranks (topologies (1, 1), (1, 2), (2, 2), (2, 4) of one pool); the
JAX package runs on its 8-device (2, 4) mesh.  Cases follow
``tests/test_arrays.py`` and ``tests/test_broadcast.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks

DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]
RTOL = 1e-12    # float64 arithmetic against the JAX package's


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


@pytest.fixture(scope="module")
def jtopo(devices):
    return jpa.Topology((2, 4))


def global_ref(shape, extra=()):
    n = int(np.prod(shape + extra))
    return np.arange(n, dtype=np.float64).reshape(shape + extra) / 7.0


KEYS = [(3, 4, 5), (-1, -1, -1), 2, (slice(None), 3, slice(None)),
        (slice(1, 5), Ellipsis, 2), (slice(None), slice(1, 11, 2), 3),
        (slice(None, None, -1), 0, 0), (0, slice(8, None, -2), slice(None)),
        (slice(20, 30), 0, 0)]
EXTRA_KEYS = [(2, 3, 4), (slice(None), 3, slice(None), 1), (Ellipsis, 2)]


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("perm,extra", [(None, ()), ((2, 0, 1), ()),
                                        ((1, 2, 0), ()), ((2, 0, 1), (3,))])
def test_global_views_bit_identical(pool, jtopo, dims, perm, extra):
    shape = (12, 11, 10)
    u = global_ref(shape, extra)
    jpen = jpa.Pencil(jtopo, shape, (1, 2), permutation=None if perm is None
                      else jpa.Permutation(*perm))
    jx = jpa.PencilArray.from_global(jpen, u)
    keys = EXTRA_KEYS if extra else KEYS
    got = pool.run(tasks.arrays_case, dims, shape, (1, 2), perm, u, keys,
                   len(extra))[0]
    for i, key in enumerate(keys):
        want = np.asarray(jx[key])
        for rank, items in enumerate(got["items"]):
            assert _bits_equal(items[i], want), (key, rank)
    assert _bits_equal(got["logical"], np.asarray(jx.logical()))
    assert _bits_equal(got["array"], np.asarray(jx))
    assert _bits_equal(got["array"], u)
    assert _bits_equal(got["own"], got["blocks"][(0,) * 2][0])
    ptopo = pat.Topology(dims, device="cpu")
    ppen = pat.Pencil(ptopo, shape, (1, 2), permutation=None if perm is None
                      else pat.Permutation(*perm))
    for coords, (blk, blk_m) in got["blocks"].items():
        rr = ppen.range_local(coords)
        want = u[np.ix_(*[list(r) for r in rr])]
        assert _bits_equal(blk, want), coords
        assert blk_m.shape == ppen.permutation.append(len(extra)).apply(
            blk.shape) if perm else blk_m.shape == blk.shape
    if dims == (2, 4):   # the JAX package's own blocks, same mesh
        for rank in range(8):
            c = jtopo.coords(rank)
            assert _bits_equal(got["blocks"][c][0],
                               np.asarray(jx.local_block(c)))
            assert _bits_equal(got["blocks"][c][1], np.asarray(
                jx.local_block(c, jpa.MemoryOrder)))


def test_indexing_errors_and_views():
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, (12, 11, 10), (1, 2))
    u = global_ref((12, 11, 10))
    x = pat.PencilArray.from_global(pen, u)
    with pytest.raises(IndexError):
        x[50, 0, 0]
    with pytest.raises(IndexError):
        x[0, 0, 0, 0]
    with pytest.raises(NotImplementedError):
        x[[1, 2]]
    assert pat.global_view(x) is x
    assert len(x) == 12 and x.sizeof_global() == 12 * 11 * 10 * 8
    y = x.similar(pencil=pen.replace(decomp_dims=(0, 2)),
                  dtype=torch.complex64)
    assert y.pencil.decomposition == (0, 2) and y.dtype == torch.complex64
    assert x.similar().dtype == torch.float64
    v = pat.PencilArray.from_global(pen, global_ref((12, 11, 10), (3,)))
    parts = v.unstack()
    assert len(parts) == 3 and parts[1].extra_dims == ()
    np.testing.assert_array_equal(pat.gather(parts[1]),
                                  global_ref((12, 11, 10), (3,))[..., 1])
    with pytest.raises(ValueError, match="extra dims"):
        x.unstack()


PROTO_SHAPE = (13, 11, 9)


@pytest.fixture(scope="module")
def proto_ref(jtopo):
    """The JAX package's results on the permuted, ragged pencil of
    ``tests/test_broadcast.py``."""
    import pencilarrays_tpu.numpy as jpnp

    rng = np.random.default_rng(0)
    u = rng.standard_normal(PROTO_SHAPE)
    v = rng.standard_normal(PROTO_SHAPE)
    raw = np.linspace(0, 1, 9).reshape(1, 1, 9)
    pen = jpa.Pencil(jtopo, PROTO_SHAPE, (1, 2),
                     permutation=jpa.Permutation(2, 0, 1))
    x = jpa.PencilArray.from_global(pen, u)
    y = jpa.PencilArray.from_global(pen, v)
    poisoned = (x + 100.0) - 100.0
    res = dict(
        cos=np.cos(x), add=np.add(x, y), arctan2=np.arctan2(x, y),
        raw_left=np.add(raw, x), infix=x * raw + x * raw[0, 0],
        scalar=(x + 1.0) / 2.0, map=x.map(jnp.sin),
        pnp_cos=jpnp.cos(x), pnp_mul=jpnp.multiply(x, raw[0, 0]),
        pnp_where=jpnp.where(jpnp.greater(x, 0), x, 0.0),
        fill=x.fill(3.0), full=jpa.PencilArray.full(pen, 2.5, dtype=jnp.float64),
        conj=(x * 1j).conj(), real=(x * 1j).real, imag=(x * 1j).imag,
        copy=x.copy())
    out = {k: (jpa.gather(a), np.asarray(a.data)) for k, a in res.items()}
    out.update(np_sum=float(np.sum(poisoned)), np_max=float(np.max(poisoned)),
               np_mean=float(np.mean(poisoned)),
               np_min=float(np.min(poisoned)))
    return u, v, raw, out


BITS = ("fill", "full", "copy", "real", "pnp_where")


@pytest.mark.parametrize("dims", DIMS)
def test_protocols_match_jax(pool, proto_ref, dims):
    u, v, raw, want = proto_ref
    got = pool.run(tasks.protocols_case, dims, PROTO_SHAPE, (1, 2),
                   (2, 0, 1), u, v, raw)[0]
    for k, w in want.items():
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)
            continue
        # the padded layout is the JAX package's on its own (2, 4) mesh
        pairs = zip(got[k], w) if dims == (2, 4) else [(got[k][0], w[0])]
        for g, ww in pairs:
            if k in BITS:
                assert _bits_equal(g, ww), k
            else:
                assert g.shape == ww.shape and g.dtype == ww.dtype, k
                np.testing.assert_allclose(g, ww, rtol=RTOL, atol=1e-15,
                                           err_msg=k)
    assert got["eq_self"] and not got["eq_other"] and got["eq_padded"]
    assert got["allclose"] and got["equals"]
    assert got["sizeof"] == int(np.prod(PROTO_SHAPE)) * 8
    assert got["length"] == PROTO_SHAPE[0]


def test_protocol_errors():
    import pencilarrays_tpu_torch.numpy as pnp

    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, PROTO_SHAPE, (1, 2),
                     permutation=pat.Permutation(2, 0, 1))
    x = pat.PencilArray.from_global(
        pen, np.random.default_rng(1).standard_normal(PROTO_SHAPE))
    with pytest.raises(ValueError, match="broadcastable"):
        _ = x + np.zeros((2, 11, 9))
    y = pat.PencilArray.zeros(pen.replace(decomp_dims=(0, 2)),
                              dtype=x.dtype)
    with pytest.raises(ValueError, match="different pencils"):
        np.add(x, y)
    with pytest.raises(ValueError, match="different pencils"):
        pnp.add(x, y)
    with pytest.raises(TypeError):
        np.matmul(x, x)
    with pytest.raises(TypeError):
        np.modf(x)
    with pytest.raises(AttributeError, match="ops.sum"):
        pnp.sum(x)
    with pytest.raises(TypeError, match="not elementwise"):
        pnp.where(pnp.greater(x, 0))
    with pytest.raises(AttributeError, match="elementwise"):
        pnp.einsum
    assert float(pnp.cos(0.0)) == 1.0
    a3 = pat.PencilArray.from_global(pen, np.zeros(PROTO_SHAPE + (3,)))
    a1 = pat.PencilArray.from_global(pen, np.zeros(PROTO_SHAPE + (1,)))
    with pytest.raises(ValueError, match="extra_dims"):
        _ = a3 + a1
    assert not (x == x.fill(2.0))
    assert x.fill(2.0) == x.fill(2.0)
