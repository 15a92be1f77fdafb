"""PyTorch port: counter-based random fills.

JAX's PRNG bits cannot be matched, so the port keeps its property
instead: each value is a function of the seed and the element's global
logical index, so the same seed gives the same global array on 1, 2, 4
and 8 gloo ranks (bit for bit, every dtype and pencil here), ``uniform``
equals an independent NumPy ``uint64`` version of its generator bit for
bit, tail padding stays zero, and the moments sit within 5 sigma of
U[0, 1), N(0, 1) and the standard complex normal (JAX's
``test_complex_normal_variance`` bar too).
"""

import numpy as np
import pytest
import torch

import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.ops import random as R
from pencilarrays_tpu_torch.ops import reductions

CASES = [((13, 11, 10), (1, 2), (2, 0, 1), ()),
         ((9, 8, 7), (0, 2), None, (2,))]
DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]


def _splitmix(z):
    """splitmix64's output function; uint64 arithmetic wraps mod 2^64."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _numpy_uniform(shape, seed):
    """The port's float32 ``uniform`` in NumPy uint64 arithmetic."""
    L = np.arange(int(np.prod(shape)), dtype=np.uint64)
    with np.errstate(over="ignore"):
        mix = _splitmix(np.uint64(seed) + np.uint64(0x9E3779B97F4A7C15))
        z = (L + np.uint64(1)) * np.uint64(0x9E3779B97F4A7C15) + mix
        bits = _splitmix(z)
    return ((bits >> np.uint64(40)).astype(np.float32)
            * np.float32(2.0 ** -24)).reshape(shape)


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


_REF = {}


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("case", CASES, ids=["perm", "extra"])
def test_same_global_array_at_any_rank_count(pool, dims, case):
    shape, decomp, perm, extra = case
    got = pool.run(tasks.random_case, dims, shape, decomp, perm, 7,
                   extra)[0]
    if case not in _REF:        # one process, no process group
        topo = pat.Topology((1, 1), device="cpu")
        pen = pat.Pencil(topo, shape, decomp, permutation=None
                         if perm is None else pat.Permutation(*perm))
        _REF[case] = {
            "u32": pat.gather(R.uniform(pen, 7, extra)),
            "u64": pat.gather(R.uniform(pen, 7, extra, torch.float64)),
            "n32": pat.gather(R.normal(pen, 7, extra)),
            "n64": pat.gather(R.normal(pen, 7, extra, torch.float64)),
            "c64": pat.gather(R.normal(pen, 7, extra, torch.complex64))}
    for k, want in _REF[case].items():
        assert got[k].dtype == want.dtype and np.array_equal(
            got[k].view(np.uint8), want.view(np.uint8)), k
    assert np.array_equal(got["u32"], _numpy_uniform(shape + extra, 7))
    # tail padding stays zero (the port's storage contract)
    assert np.count_nonzero(got["padded"]) == got["u32"].size


def test_moments_and_seeds():
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, (32, 32, 32), (1, 2))
    n = 32 ** 3
    for dtype in (torch.float32, torch.float64):
        u = R.uniform(pen, 0, dtype=dtype).data
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / n)
        assert abs(float(u.var()) - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
        z = R.normal(pen, 1, dtype=dtype).data
        assert abs(float(z.mean())) < 5 / np.sqrt(n)
        assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2 / n)
    c = R.normal(pen, 2, dtype=torch.complex64)
    var = float(reductions.mean(c.map(lambda d: d.abs() ** 2)))
    assert 0.9 < var < 1.1
    assert abs(var - 1.0) < 5 * np.sqrt(1 / n)
    assert abs(float(c.data.real.var()) - 0.5) < 5 * np.sqrt(0.5 / n)
    a = R.uniform(pen, 0).data
    assert torch.equal(a, R.uniform(pen, 0).data)
    assert not torch.equal(a, R.uniform(pen, 1).data)
    with pytest.raises(TypeError):
        R.uniform(pen, 0, dtype=torch.int32)
    with pytest.raises(TypeError):
        R.normal(pen, 0, dtype=torch.float16)
