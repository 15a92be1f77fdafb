"""PyTorch port vs JAX package: the distributed reductions.

Every reduction of ``ops/reductions.py`` over the same global arrays, on
1, 2, 4 and 8 gloo ranks against the JAX package on its 8-device mesh.
The shape is ragged under every port topology, and the port's tail
padding is overwritten with NaN first: only masking keeps it out.
Results agree within 1e-12 relative (float64; sums reduce in another
order), integer and boolean results exactly; a float result of an
integer array is float32 in the port (torch's default float) and agrees
within 1e-6.  Cases follow
``tests/test_reductions.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu import ops as jops
from pencilarrays_tpu_torch.ops import reductions as R

DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]
SHAPE = (9, 11, 13)
PERM = (2, 0, 1)
RTOL = 1e-12


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _arrays():
    rng = np.random.default_rng(3)
    u = rng.standard_normal(SHAPE)
    v = rng.standard_normal(SHAPE)
    hot = np.zeros(SHAPE)
    hot[8, 10, 12] = 1.0          # a single element in the last block
    return dict(u=u, v=v, pos=np.abs(u) + 5.0,
                near1=1.0 + 0.01 * v, hot=hot, zeros=np.zeros(SHAPE),
                ones=np.ones(SHAPE), flags=np.ones(SHAPE, dtype=bool),
                ints=np.arange(int(np.prod(SHAPE))).reshape(SHAPE) - 100,
                cplx=u + 1j * v)


def _jax_results(x):
    r = {}
    if not jnp.iscomplexobj(x.data):
        r.update(min=jops.minimum(x), max=jops.maximum(x))
    if x.dtype != jnp.bool_:
        r.update(sum=jops.sum(x), prod=jops.prod(x), mean=jops.mean(x),
                 norm2=jops.norm(x), norm1=jops.norm(x, 1),
                 norminf=jops.norm(x, np.inf), norm3=jops.norm(x, 3),
                 dot=jops.dot(x, x), count=jops.count_nonzero(x))
    r.update(any=jops.any(x), all=jops.all(x),
             any_pos=jops.any(x, pred=lambda d: jnp.real(d) > 0.5),
             all_fin=jops.all(x, pred=jnp.isfinite))
    return {k: np.asarray(v) for k, v in r.items()}


@pytest.fixture(scope="module")
def reference(devices):
    topo = jpa.Topology((2, 4))
    pen = jpa.Pencil(topo, SHAPE, (1, 2), permutation=jpa.Permutation(*PERM))
    arrays = _arrays()
    xs = {k: jpa.PencilArray.from_global(pen, a) for k, a in arrays.items()}
    want = {k: _jax_results(x) for k, x in xs.items()}
    want["dot_uv"] = np.asarray(jops.dot(xs["u"], xs["v"]))
    want["zipped"] = np.asarray(jops.mapreduce(
        lambda a, b: a * b, jnp.sum, xs["u"], xs["v"], identity=0))
    return arrays, want


def _check(got, want, what):
    if want.dtype.kind in "biu":
        assert got == want, what
    else:
        # float results of integer arrays take torch's default float32
        # (the JAX package's default float is float64 under x64)
        rtol = 1e-6 if got.dtype == np.float32 else RTOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300,
                                   err_msg=what)


@pytest.mark.parametrize("dims", DIMS)
def test_reductions_match_jax(pool, reference, dims):
    arrays, want = reference
    got = pool.run(tasks.reductions_case, dims, SHAPE, (1, 2), PERM,
                   arrays)[0]
    for name, w in want.items():
        if isinstance(w, dict):
            assert set(got[name]) == set(w), name
            for k in w:
                _check(got[name][k], w[k], f"{name}.{k}")
        else:
            _check(got[name], w, name)
    # the masking is what the answers rest on
    assert got["pos"]["min"] >= 5.0 and got["flags"]["all"]
    assert not got["zeros"]["any"] and got["hot"]["any"]
    assert got["hot"]["count"] == 1


def test_reductions_single_process():
    """A topology without torch.distributed reduces locally; the errors
    of the JAX package."""
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, SHAPE, (1, 2), permutation=pat.Permutation(*PERM))
    arrays = _arrays()
    x = pat.PencilArray.from_global(pen, arrays["u"])
    np.testing.assert_allclose(float(R.sum(x)), arrays["u"].sum(), rtol=RTOL)
    assert float(R.norm(x, math.inf)) == np.abs(arrays["u"]).max()
    lo, hi = R.extrema(x)
    assert float(lo) == arrays["u"].min() and float(hi) == arrays["u"].max()
    c = pat.PencilArray.from_global(pen, arrays["cplx"].astype(np.complex64))
    with pytest.raises(TypeError, match="no ordering"):
        R.minimum(c)
    with pytest.raises(ValueError, match="unsupported"):
        R.mapreduce(lambda d: d, torch.mean, x, identity=0)
    y = pat.PencilArray.zeros(pen.replace(decomp_dims=(0, 2)),
                              dtype=torch.float64)
    with pytest.raises(ValueError, match="share"):
        R.dot(x, y)
    assert float(np.sum(x)) == float(R.sum(x))
    assert bool(np.any(x)) and int(np.count_nonzero(x)) == x.length_global()
