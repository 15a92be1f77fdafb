"""PyTorch port vs JAX package: global transposes on 4 and 8 gloo ranks.

The same global input goes through the JAX package (8 virtual CPU
devices) and the port (gloo ranks, one process each).  Transposes are pure
data movement, so every rank's block must be BIT-identical to the JAX
shard of the same pencil, padding zeros included, and ``gather`` must
equal JAX's ``gather``; the padding-masked global ``sum`` must agree with
JAX's up to summation order.  Cases follow ``tests/test_transpose.py``.
"""

import jax
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.parallel.distributed import RankPool


class _Pools:
    """One live pool at a time: tests run in file order, all (2, 2) cases
    first, so switching rank counts happens once."""

    def __init__(self):
        self.n, self.pool = None, None

    def get(self, n):
        if self.n != n:
            self.close()
            self.pool, self.n = RankPool(n), n
        return self.pool

    def close(self):
        if self.pool is not None:
            self.pool.close()
        self.n, self.pool = None, None


@pytest.fixture(scope="module")
def pools():
    p = _Pools()
    yield p
    p.close()


def _global(shape, extra, dtype):
    n = int(np.prod(shape + extra))
    base = (np.arange(n, dtype=np.float64).reshape(shape + extra) + 1.0) / 3.0
    if np.issubdtype(dtype, np.complexfloating):
        base = base - 1j * base[::-1]
    return base.astype(dtype)


def _jax_pencil(topo, shape, spec):
    decomp, perm = spec
    return jpa.Pencil(topo, shape, decomp,
                      permutation=None if perm is None
                      else jpa.Permutation(*perm))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


X, Y, Z = ((1, 2), None), ((0, 2), None), ((0, 1), None)
BF16 = jax.numpy.bfloat16

# (dims, shape, extra, dtype, chain of pencils)
CASES = [
    ((2, 2), (16, 16, 16), (), np.float32, [X, Y, Z]),
    ((2, 2), (15, 14, 13), (), np.float64, [X, ((0, 2), (1, 0, 2))]),
    ((2, 2), (15, 14, 13), (), np.float64,
     [((1, 2), (2, 0, 1)), ((0, 2), (1, 2, 0))]),
    ((2, 2), (14, 21, 19), (), np.float32,
     [X, ((0, 2), (1, 0, 2)), ((0, 1), (2, 1, 0)), ((0, 2), (1, 0, 2)), X]),
    ((2, 2), (10, 11, 12), (3, 2), np.float64, [((1, 2), (2, 0, 1)), Y]),
    ((2, 2), (9, 10, 11), (), np.complex64,
     [X, ((1, 2), (2, 1, 0)), X]),
    ((2, 2), (9, 16, 9), (3,), np.complex128,
     [((1, 2), (1, 2, 0)), ((0, 2), (0, 2, 1)), Z]),
    ((2, 2), (9, 16, 9), (), np.int32, [X, ((1, 0), None)]),
    ((2, 2), (9, 16, 9), (6,), BF16, [X, ((0, 2), (2, 0, 1)), Z]),
    ((2, 4), (16, 16, 16), (), np.float32, [X, Y, Z]),
    ((2, 4), (42, 31, 29), (), np.float64, [X, Y, Z, Y, X]),
    ((2, 4), (7, 12, 13), (), np.float32, [X, ((0, 2), (1, 0, 2))]),
    ((2, 4), (11, 12, 13), (), np.float64, [((2, 1), None), ((2, 0), None)]),
    ((2, 4), (6, 7, 8, 9), (), np.complex64,
     [((1, 3), (3, 0, 1, 2)), ((2, 3), None)]),
    ((2, 4), (9, 16, 5), (), np.float64, [X, ((1, 0), None)]),
    ((2, 4), (9, 16, 13), (), np.float64, [X, ((1, 0), None)]),
    ((2, 4), (2, 16, 6), (), np.float64, [X, ((1, 0), None)]),
    ((2, 4), (9, 16, 1), (3,), np.float32, [X, ((1, 0), (2, 0, 1))]),
    ((8,), (21, 17, 14), (), np.float64,
     [((0,), None), ((1,), None), ((2,), None), ((0,), (2, 1, 0))]),
]


def _case_id(case):
    dims, shape, extra, dtype, chain = case
    return (f"{'x'.join(map(str, dims))}-{'x'.join(map(str, shape))}"
            f"{'+' + 'x'.join(map(str, extra)) if extra else ''}-"
            f"{np.dtype(dtype).name}-{len(chain) - 1}hops")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_transpose_bit_identical_to_jax(devices, pools, case):
    dims, shape, extra, dtype, chain = case
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    u = _global(shape, extra, dtype)
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    x = jpa.PencilArray.from_global(pens[0], u)
    ref = []
    for pen in pens[1:]:
        x = jpa.transpose(x, pen)
        ref.append((np.asarray(x.data), jpa.gather(x),
                    complex(jpa.ops.reductions.sum(x, dtype=np.float64
                                                   if dtype is BF16 else None))))
    padded_in = np.asarray(jpa.PencilArray.from_global(pens[0], u).data)
    bf16 = dtype is BF16
    if bf16:
        padded_in = padded_in.view(np.uint16)
    out = pools.get(len(topo)).run(tasks.transpose_chain, dims, shape, extra,
                                   chain, padded_in, bf16)[0]
    assert len(out) == len(ref)
    for (got_pad, got_glob, got_sum), (want_pad, want_glob, want_sum) in zip(
            out, ref):
        if bf16:  # the port hands bf16 back as the exact float32 values
            want_pad = want_pad.astype(np.float32)
            want_glob = want_glob.astype(np.float32)
        assert got_pad.shape == want_pad.shape
        assert got_pad.dtype == want_pad.dtype
        np.testing.assert_array_equal(_bits(got_pad), _bits(want_pad))
        np.testing.assert_array_equal(_bits(got_glob), _bits(want_glob))
        # padding masked: the sums agree up to summation order
        rtol = 1e-5 if dtype in (np.float32, np.complex64) else 1e-12
        np.testing.assert_allclose(complex(got_sum), want_sum, rtol=rtol)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_transpose_cost_matches_jax(devices, case):
    """The byte model needs no ranks: a port topology built without
    torch.distributed answers every metadata query."""
    dims, shape, extra, dtype, chain = case
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    ptopo = pat.Topology(dims, device="cpu")
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    ppens = [pat.Pencil(ptopo, shape, d, permutation=None if p is None
                        else pat.Permutation(*p)) for d, p in chain]
    want = [jpa.transpose_cost(a, b, extra, dtype)
            for a, b in zip(pens, pens[1:])]
    got = [pat.transpose_cost(a, b, extra, dtype)
           for a, b in zip(ppens, ppens[1:])]
    assert got == want
