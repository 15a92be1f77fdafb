"""PyTorch port vs JAX package: spectral differential operators.

Gradient, divergence, curl, Laplacian and the Poisson solve on a float64
r2c plan, each transformed back and gathered, on 1, 2, 4 and 8 gloo
ranks against the JAX package's on its 8-device mesh: within 1e-12
relative (atol 1e-10 where the exact answer is 0), and against the
analytic answers of ``tests/test_spectral_ops.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu import ops as jops
from pencilarrays_tpu_torch import ops
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift

N = (16, 12, 10)
DIMS = [(1, 1), (1, 2), (2, 2), (2, 4)]
L = (1.0, 2 * np.pi, 2 * np.pi)


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


def _grid():
    axes = [np.arange(n) * (2 * np.pi / n) for n in N]
    return np.meshgrid(*axes, indexing="ij")


def _inputs():
    X, Y, Z = _grid()
    fields = [np.sin(2 * X) * np.cos(Y) + np.sin(3 * Z),
              np.cos(X) * np.cos(2 * Y) * np.sin(Z)]
    vec = [np.sin(Y) + np.cos(Z), np.cos(2 * Y) * np.sin(X),
           np.sin(Z + X)]
    return fields, vec


@pytest.fixture(scope="module")
def reference(devices):
    topo = jpa.Topology((2, 4))
    plan = jpa.PencilFFTPlan(topo, N, real=True, dtype=jnp.float64)
    fields, vec = _inputs()

    def fwd(f):
        return plan.forward(jpa.PencilArray.from_global(plan.input_pencil,
                                                        f))

    def back(v):
        if not v.extra_dims:
            return jpa.gather(plan.backward(v))
        return np.stack([back(jpa.PencilArray(v.pencil, v.data[..., i],
                                              v.extra_dims[:-1]))
                         for i in range(v.extra_dims[-1])], axis=-1)

    fh = fwd(fields[0])
    uh = jpa.PencilArray.stack([fwd(c) for c in vec])
    batch = jpa.PencilArray.stack([fwd(f) for f in fields])
    return dict(
        grad=back(jops.gradient(plan, fh)),
        grad_L=back(jops.gradient(plan, fh, lengths=L)),
        div_grad=back(jops.divergence(plan, jops.gradient(plan, fh))),
        lap=back(jops.laplacian(plan, fh)),
        curl=back(jops.curl(plan, uh)),
        curl_grad=back(jops.curl(plan, jops.gradient(plan, fh))),
        poisson=back(jops.solve_poisson(plan, fh)),
        lap_vec=back(jops.laplacian(plan, uh)),
        poisson_vec=back(jops.solve_poisson(plan, jops.laplacian(plan, uh))),
        grad_batch=back(jops.gradient(plan, batch)),
        grad_padded=np.asarray(jops.gradient(plan, fh).data))


@pytest.mark.parametrize("dims", DIMS)
def test_spectral_ops_match_jax(pool, reference, dims):
    fields, vec = _inputs()
    got = pool.run(tasks.spectral_ops_case, dims, N, fields, vec, L)[0]
    for k, want in reference.items():
        if k == "grad_padded" and dims != (2, 4):
            continue
        assert got[k].shape == want.shape, k
        np.testing.assert_allclose(got[k], want, rtol=1e-12, atol=1e-10,
                                   err_msg=k)
    X, Y, Z = _grid()
    np.testing.assert_allclose(got["grad"][..., 0],
                               2 * np.cos(2 * X) * np.cos(Y), atol=1e-10)
    np.testing.assert_allclose(got["grad"][..., 2], 3 * np.cos(3 * Z),
                               atol=1e-10)
    np.testing.assert_allclose(got["div_grad"], got["lap"], atol=1e-10)
    np.testing.assert_allclose(got["curl_grad"], 0.0, atol=1e-9)
    lap_true = -4 * np.sin(2 * X) * np.cos(Y) - np.sin(2 * X) * np.cos(Y) \
        - 9 * np.sin(3 * Z)
    np.testing.assert_allclose(got["lap"], lap_true, atol=1e-9)
    np.testing.assert_allclose(
        got["poisson"], -np.sin(2 * X) * np.cos(Y) / 5 - np.sin(3 * Z) / 9,
        atol=1e-10)
    for d, c in enumerate(vec):
        np.testing.assert_allclose(got["poisson_vec"][..., d], c - c.mean(),
                                   atol=1e-9)
    assert got["grad_batch"].shape == N + (2, 3)


def test_operand_validation():
    topo = pat.Topology((1, 1), device="cpu")
    plan = pat.PencilFFTPlan(topo, N, real=True, dtype=torch.float64)
    wrong = pat.PencilArray.zeros(plan.input_pencil, (), torch.complex128)
    with pytest.raises(ValueError, match="output_pencil"):
        ops.gradient(plan, wrong)
    fh = pat.PencilArray.zeros(plan.output_pencil, (), torch.complex128)
    with pytest.raises(ValueError, match="vector"):
        ops.divergence(plan, fh)
    with pytest.raises(ValueError, match="lengths"):
        ops.laplacian(plan, fh, lengths=(1.0,))
    plan2 = pat.PencilFFTPlan(pat.Topology((1,), device="cpu"), (8, 6),
                              real=True, dtype=torch.float64)
    with pytest.raises(ValueError, match="3-D"):
        ops.curl(plan2, pat.PencilArray.zeros(plan2.output_pencil, (2,),
                                              torch.complex128))
