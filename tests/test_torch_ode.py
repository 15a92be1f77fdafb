"""PyTorch port vs JAX package: adaptive RK23 integration and the global
norm hook of the diffrax interop.

The port's ``integrate`` runs its accept/reject loop on the host from one
read of global reductions per trial step; on the JAX package's
``test_ode_*`` problems it must make the SAME decisions as the JAX
package's ``lax.while_loop``: equal accepted and rejected counts and
``nan_detected``, on every rank, with ``t`` and ``dt`` in the same
precision: float64 state and time as the JAX package under 64-bit mode,
float32 as without it.  Solutions agree within 1e-10 (float64)
or 1e-5 (float32) relative.  On 1, 2, 4 and 8 gloo ranks; cases follow
``tests/test_models.py`` (``test_ode_*``) and
``tests/test_diffrax_interop.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu.interop import global_wrms_norm as jax_wrms
from pencilarrays_tpu.models.ode import integrate as jax_integrate
from pencilarrays_tpu_torch.interop import (
    diffeqsolve, diffrax_available, global_wrms_norm)

DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]
TOL = {"float64": 1e-10, "float32": 1e-5}


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _u0(problem):
    if problem == "decay":
        return np.random.default_rng(0).standard_normal((9, 11, 13))
    if problem == "unit":
        return np.full((8, 8, 8), 2.0)
    u = np.ones((8, 8, 8))
    if problem == "nan":
        u[7, 7, 7] = np.nan      # in the last block only
    return u


JAX_F = {"decay": lambda t, u: u.map(lambda d: -1.7 * d),
         "blowup": lambda t, u: u.map(lambda d: d * d * d * 10.0),
         "stiff": lambda t, u: u.map(lambda d: -1e8 * d),
         "unit": lambda t, u: u.map(lambda d: -d),
         "nan": lambda t, u: u.map(lambda d: -d)}
KWARGS = {"decay": dict(t_span=(0.0, 1.0), rtol=1e-7, atol=1e-9),
          "blowup": dict(t_span=(0.0, 10.0), rtol=1e-6, max_steps=2000),
          "stiff": dict(t_span=(0.0, 1e-7), dt0=1.0, rtol=1e-4,
                        max_steps=2000),
          "unit": dict(t_span=(0.0, 0.5)),
          "nan": dict(t_span=(0.0, 1.0), max_steps=200)}
# (problem, state dtype, JAX 64-bit mode)
CASES = [(p, "float64", True) for p in KWARGS] + \
        [(p, "float32", False) for p in KWARGS]

_JAX = {}


def _jax_run(devices, problem, dtype, x64):
    key = (problem, dtype, x64)
    if key not in _JAX:
        with jax.enable_x64(x64):
            topo = jpa.Topology((2, 4))
            u0 = _u0(problem)
            pen = jpa.Pencil(topo, u0.shape, (1, 2))
            x = jpa.PencilArray.from_global(pen, u0.astype(dtype))
            kw = dict(KWARGS[problem])
            u, stats = jax_integrate(JAX_F[problem], x, kw.pop("t_span"),
                                     **kw)
            _JAX[key] = (jpa.gather(u), {k: np.asarray(v)
                                         for k, v in stats.items()})
    return _JAX[key]


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("problem,dtype,x64", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_integrate_matches_jax(pool, devices, dims, problem, dtype, x64):
    want_u, want = _jax_run(devices, problem, dtype, x64)
    kw = dict(KWARGS[problem])
    got = pool.run(tasks.ode_case, dims, _u0(problem).shape, (1, 2),
                   _u0(problem), problem, kw, dtype)[0]
    for s in got["stats"]:          # every rank, the same decisions
        assert s["n_accepted"] == int(want["n_accepted"]), s
        assert s["n_rejected"] == int(want["n_rejected"]), s
        assert s["nan_detected"] == bool(want["nan_detected"]), s
        assert s["t_dtype"] == str(want["t"].dtype)
        assert s == got["stats"][0]
    tol = TOL[dtype]
    np.testing.assert_allclose(got["stats"][0]["t"], float(want["t"]),
                               rtol=tol)
    if not want["nan_detected"]:
        np.testing.assert_allclose(got["u"], want_u, rtol=tol, atol=tol)
    if problem in ("blowup", "nan"):
        assert got["stats"][0]["nan_detected"]


@pytest.mark.parametrize("dims", DIMS)
def test_global_wrms_norm_matches_jax(pool, devices, dims):
    shape = (11, 9, 6)
    u = np.random.default_rng(0).standard_normal(shape)
    topo = jpa.Topology((2, 4))
    x = jpa.PencilArray.from_global(jpa.Pencil(topo, shape, (1, 2)), u)
    x = (x + 7.0) - 7.0
    want = float(jax_wrms(x))
    want_mixed = float(jax_wrms({"field": x, "aux": jnp.asarray([3.0, 4.0])}))
    got = pool.run(tasks.wrms_case, dims, shape, (1, 2), u, [3.0, 4.0])[0]
    np.testing.assert_allclose(got["alone"], want, rtol=1e-12)
    np.testing.assert_allclose(got["alone"], np.sqrt(np.mean(u ** 2)),
                               rtol=1e-10)
    np.testing.assert_allclose(got["mixed"], want_mixed, rtol=1e-12)
    np.testing.assert_allclose(got["seq"], want, rtol=1e-12)


def test_diffrax_is_jax_only():
    assert diffrax_available() is False
    with pytest.raises(ImportError, match="JAX-only"):
        diffeqsolve(None, None, 0.0, 1.0, 0.1, None)
    assert float(global_wrms_norm([])) == 0.0
    pen = pat.Pencil(pat.Topology((1,), device="cpu"), (4, 4), (0,))
    x = pat.PencilArray.from_global(pen, np.full((4, 4), 2.0))
    assert float(global_wrms_norm(x)) == 2.0
    assert isinstance(global_wrms_norm(x), torch.Tensor)
