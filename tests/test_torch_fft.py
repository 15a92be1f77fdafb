"""PyTorch port vs JAX package: PencilFFTPlan on 4 gloo ranks.

The port builds the same static schedule as the JAX package (same stage
chain, same pencils, same hops), moves the data with the same bit-exact
transposes and transforms each block with ``torch.fft``.  Two FFT
libraries sum in different orders, so spectra agree to a tolerance:
2e-5 x max|ref| in float32 and 1e-10 x max|ref| in float64.  Round trips
must return the input to the same tolerance, and the collective cost
model must equal the JAX plan's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import torch_rank_tasks as tasks
from pencilarrays_tpu.ops.fft import PencilFFTPlan as JaxPlan
from pencilarrays_tpu_torch.parallel.distributed import RankPool

DIMS = (2, 2)
TOL = {"float32": 2e-5, "float64": 1e-10}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


def _input(shape, real, dtype, extra=()):
    rng = np.random.default_rng(7)
    u = rng.standard_normal(shape + extra)
    if not real:
        u = u + 1j * rng.standard_normal(shape + extra)
    return u.astype(dtype)


# (shape, real, physical dtype, normalization, batch)
CASES = [
    ((12, 10, 9), False, np.complex64, "backward", None),
    ((12, 10, 9), True, np.float32, "backward", None),
    ((16, 12, 10), False, np.complex128, "backward", None),
    ((16, 12, 10), False, np.complex128, "ortho", None),
    ((16, 12, 10), False, np.complex128, "forward", None),
    ((16, 12, 10), False, np.complex128, "none", None),
    ((16, 12, 10), True, np.float64, "backward", None),
    ((16, 12, 10), True, np.float64, "ortho", None),
    ((16, 12, 10), True, np.float64, "forward", None),
    ((16, 12, 10), True, np.float64, "none", None),
    ((9, 14, 11), True, np.float32, "ortho", 2),
    ((9, 14, 11), False, np.complex128, "forward", 3),
]


@pytest.mark.parametrize(
    "case", CASES,
    ids=[f"{'r2c' if c[1] else 'c2c'}-{np.dtype(c[2]).name}-{c[3]}"
         f"{'-batch%d' % c[4] if c[4] else ''}" for c in CASES])
def test_fft_plan_matches_jax(devices, pool, case):
    shape, real, dtype, norm, batch = case
    topo = jpa.Topology(DIMS, devices=devices[:4])
    kwargs = dict(real=real, dtype=np.dtype(dtype).name, normalization=norm,
                  batch=batch)
    jplan = JaxPlan(topo, shape, real=real, dtype=jnp.dtype(dtype),
                    normalization=norm, batch=batch)
    extra = (batch,) if batch else ()
    u = _input(shape, real, dtype, extra)
    uh = jplan.forward(jpa.PencilArray.from_global(jplan.input_pencil, u))
    want = jpa.gather(uh)
    got = pool.run(tasks.fft_case, DIMS, shape, kwargs, u)[0]

    # same schedule: step kinds, decompositions and memory orders
    sched = [(s[0], s[1].decomposition,
              tuple(s[1].permutation.apply(tuple(range(len(shape))))),
              s[2].decomposition) for s in jplan._steps]
    assert got["schedule"] == sched
    assert got["out_padded"] == np.asarray(uh.data).shape
    assert got["costs"] == jplan.collective_costs()

    real_name = np.dtype(np.empty(0, dtype).real.dtype).name
    tol = TOL[real_name]
    assert got["spectrum"].shape == want.shape
    assert got["spectrum"].dtype == want.dtype
    scale = np.abs(want).max()
    assert np.abs(got["spectrum"] - want).max() <= tol * scale
    # round trip (backward(forward(u)) == scale_factor * u)
    assert got["scale_factor"] == jplan.scale_factor()
    back = got["back"] / jplan.scale_factor()
    assert back.dtype == u.dtype
    assert np.abs(back - u).max() <= tol * np.abs(u).max()


def test_fft_unported_options_raise():
    import pencilarrays_tpu_torch as pat

    topo = pat.Topology(DIMS, device="cpu")
    for kw in (dict(pipeline=2), dict(decomposition="auto"),
               dict(wire_dtype="bf16"), dict(hbm_limit=1 << 20),
               dict(transform="dct")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pat.PencilFFTPlan(topo, (8, 8, 8), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pat.Ring()
