"""PyTorch port vs JAX package: ``ManyPencilArray``.

A chain of x, y and z pencils with one live configuration: every hop of
two ``cycle`` sweeps and the walk back is data movement, so each
configuration's padded data must be the JAX package's transpose chain
BIT for bit on the same mesh, and the gathered array the input, on 1,
2, 4 and 8 gloo ranks.  Donation deletes each hop's source; stale
configurations raise.  Cases follow ``tests/test_multiarrays.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift

SHAPE = (14, 21, 19)
SPECS = [((1, 2), None), ((0, 2), (1, 0, 2)), ((0, 1), (2, 1, 0))]
DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]


@pytest.fixture(autouse=True)
def _hermetic_drift():
    """Plans and routes are drift-sensitive in both packages (a trusted
    sample left by an earlier test in the same worker changes a JAX
    plan's decomposition verdict and ``plan_key``): every case starts and
    ends with both drift trackers empty, as ``tests/test_routing.py``
    isolates its own."""
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()
    yield
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def reference(devices):
    topo = jpa.Topology((2, 4))
    pens = [jpa.Pencil(topo, SHAPE, d, permutation=None if p is None
                       else jpa.Permutation(*p)) for d, p in SPECS]
    u = np.random.default_rng(7).standard_normal(SHAPE)
    A = jpa.ManyPencilArray(*pens, dtype=jnp.float64)
    A.set(jpa.PencilArray.from_global(pens[0], u))
    seen = []
    for _ in range(2):
        for arr in A.cycle():
            seen.append((arr.pencil.decomposition, np.asarray(arr.data)))
    return u, seen


@pytest.mark.parametrize("dims", DIMS)
def test_chain_bit_identical_to_jax(pool, reference, dims):
    u, want = reference
    got = pool.run(tasks.multiarrays_case, dims, SHAPE, SPECS, u)[0]
    assert [d for d, _ in got["seen"]] == [d for d, _ in want] == [
        (1, 2), (0, 2), (0, 1)] * 2
    ptopo = pat.Topology(dims, device="cpu")
    for (d, mine), (_, theirs), (decomp, perm) in zip(
            got["seen"], want, SPECS * 2):
        if dims == (2, 4):
            assert _bits_equal(mine, theirs), d
        pen = pat.Pencil(ptopo, SHAPE, decomp, permutation=None
                         if perm is None else pat.Permutation(*perm))
        padded = np.pad(u, [(0, p - n) for n, p in zip(
            SHAPE, pen.padded_global_shape)])
        if perm is not None:
            padded = np.transpose(padded, pen.permutation.axes())
        assert _bits_equal(mine, padded), d
    assert _bits_equal(got["back"], got["seen"][0][1])
    assert got["x0_deleted"] and not got["kept_deleted"] and got["first_ok"]


def test_access_donation_and_validation():
    topo = pat.Topology((1, 1), device="cpu")
    pens = [pat.Pencil(topo, SHAPE, d, permutation=None if p is None
                       else pat.Permutation(*p)) for d, p in SPECS]
    A = pat.ManyPencilArray(*pens, dtype=torch.float64)
    assert len(A) == 3 and A.index == 0 and A.first.pencil == pens[0]
    with pytest.raises(RuntimeError, match="not live"):
        A[1]
    with pytest.raises(RuntimeError):
        _ = A.last
    a0 = A.current
    A.transpose_to(1)
    assert a0.is_deleted()
    with pytest.raises(RuntimeError, match="donated"):
        a0.data
    with pytest.raises(RuntimeError):
        A[0]
    keep = A.current
    A.transpose_to(2, donate=False)
    assert not keep.is_deleted() and A.last.pencil == pens[2]
    before = A.current
    assert A.reshard_to(0).pencil == pens[0] and A.index == 0
    assert before.is_deleted()
    with pytest.raises(IndexError):
        A.reshard_to(3)
    with pytest.raises(IndexError):
        A.transpose_to(3)
    with pytest.raises(ValueError):
        pat.ManyPencilArray()
    with pytest.raises(ValueError, match="global shape"):
        pat.ManyPencilArray(pens[0], pat.Pencil(topo, (8, 8, 8), (0, 2)))
    with pytest.raises(ValueError, match="not part"):
        B = pat.ManyPencilArray(pens[0], pens[1])
        B.set(pat.PencilArray.zeros(pat.Pencil(topo, SHAPE, (2, 1))))
    assert "ManyPencilArray" in repr(A)


@pytest.mark.parametrize("dims", DIMS, ids=["x".join(map(str, d))
                                            for d in DIMS])
def test_reshard_to_matches_jax(pool, dims):
    """``reshard_to`` jumps from the first to the last configuration in
    one ``reshard`` and lands on the data ``transpose_to`` reaches hop by
    hop, the JAX package's bits (``tests/test_routing.py``
    ``test_many_pencil_reshard_to``)."""
    u = np.random.default_rng(4).standard_normal(SHAPE)
    got = pool.run(tasks.reshard_to_case, dims, SHAPE, SPECS, u)[0]
    devs = jax.devices()[:int(np.prod(dims))]
    topo = jpa.Topology(dims, devices=devs)
    pens = [jpa.Pencil(topo, SHAPE, d, permutation=None if p is None
                       else jpa.Permutation(*p)) for d, p in SPECS]
    A = jpa.ManyPencilArray(*pens, first=jpa.PencilArray.from_global(
        pens[0], u))
    A.reshard_to(2, donate=False)
    want = np.asarray(A.current.data)
    (i_jump, jump), (i_hop, hop) = got
    assert i_jump == i_hop == 2
    assert _bits_equal(jump, want) and _bits_equal(hop, want)
