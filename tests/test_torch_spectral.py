"""PyTorch port vs JAX package: Navier–Stokes and diffusion on 4 gloo ranks.

Both packages start from the JAX package's Taylor–Green spectral state
(carried across with ``from_numpy_padded``) and take two RK2 steps and one
RK4 step.  FFT libraries sum in different orders, so states agree to
1e-4 (float32) or 1e-10 (float64) relative in the max-norm, and energies
to the same relative tolerance.  Diffusion must match its exact
propagator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import torch_rank_tasks as tasks
from pencilarrays_tpu.models.spectral import NavierStokesSpectral
from pencilarrays_tpu.models.spectral import taylor_green as jax_taylor_green
from pencilarrays_tpu_torch.parallel.distributed import RankPool
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift

DIMS = (2, 2)
TOL = {"float32": 1e-4, "float64": 1e-10}


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
    with RankPool(4) as p:
        yield p


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_navier_stokes_matches_jax(devices, pool, dtype):
    n, dt, nu = 16, 0.05, 1e-2
    topo = jpa.Topology(DIMS, devices=devices[:4])
    model = NavierStokesSpectral(topo, n, viscosity=nu,
                                 dtype=jnp.dtype(dtype))
    uh0 = jax_taylor_green(model)
    # jitted: one compile per program instead of one per eager op
    step, step_rk4, energy = (jax.jit(f) for f in (
        model.step, model.step_rk4, model.energy))
    rk2 = step(step(uh0, dt), dt)
    rk4 = step_rk4(uh0, dt)
    energies = [float(energy(v)) for v in (uh0, rk2, rk4)]
    got = pool.run(tasks.spectral_case, DIMS, n, dtype,
                   np.asarray(uh0.data), dt, nu)[0]
    tol = TOL[dtype]
    assert _rel(got["own"], jpa.gather(uh0)) <= tol
    assert _rel(got["rk2"], jpa.gather(rk2)) <= tol
    assert _rel(got["rk4"], jpa.gather(rk4)) <= tol
    np.testing.assert_allclose(got["energy"], energies, rtol=tol)
    # the dynamics did something: energy decays, the state moved
    assert got["energy"][1] < got["energy"][0]
    assert _rel(got["rk2"], jpa.gather(uh0)) > 10 * tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_simulate_matches_jax(devices, pool, dtype):
    """``simulate`` against the JAX package's ``simulate`` (its jitted
    ``lax.scan``) from the same Taylor–Green state: the final state and
    the per-step energies, and the port's own ``step`` loop."""
    n, dt, nu, steps = 16, 0.01, 0.05, 3
    topo = jpa.Topology(DIMS, devices=devices[:4])
    model = NavierStokesSpectral(topo, n, viscosity=nu,
                                 dtype=jnp.dtype(dtype))
    uh0 = jax_taylor_green(model)
    final, energies = jax.jit(lambda s: model.simulate(
        s, dt, steps, record_energy=True))(uh0)
    got = pool.run(tasks.simulate_case, DIMS, n, dtype,
                   np.asarray(uh0.data), dt, nu, steps)[0]
    tol = TOL[dtype]
    assert _rel(got["final"], jpa.gather(final)) <= tol
    np.testing.assert_allclose(got["energies"], np.asarray(energies),
                               rtol=tol)
    assert got["energies"].shape == (steps,)
    assert got["energy_device"] == "cpu" and got["none"] is None
    assert (np.diff(got["energies"]) < 0).all()
    # a plain loop of the port's own steps
    assert _rel(got["final"], got["steps"]) <= (1e-6 if dtype == "float32"
                                                else 1e-12)


def test_diffusion_exact_propagator(devices, pool):
    n, t, kappa = (8, 10, 12), 0.3, 0.7
    x = [np.arange(m) * (2 * np.pi / m) for m in n]
    X, Y, Z = np.meshgrid(*x, indexing="ij")
    u0 = np.sin(X) * np.cos(2 * Y) + 0.5 * np.cos(3 * Z)
    exact = (np.exp(-kappa * 5 * t) * np.sin(X) * np.cos(2 * Y)
             + 0.5 * np.exp(-kappa * 9 * t) * np.cos(3 * Z))
    got = pool.run(tasks.diffusion_case, DIMS, n, u0, t, kappa)[0]
    np.testing.assert_allclose(got, exact, atol=1e-12)


# (plan options, dtype): the wire on every exchange, and the grid picked
# by the plan's slab/pencil scorer at the model's 3-component batch
NS_OPTION_CASES = [(dict(wire_dtype="bf16"), "float32"),
                   (dict(wire_dtype="fp8_e4m3"), "float64"),
                   (dict(decomposition="auto"), "float32"),
                   (dict(decomposition="slab", wire_dtype="f16"),
                    "float64")]


@pytest.mark.parametrize("case", NS_OPTION_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in c[0].items())
                              + "-" + c[1] for c in NS_OPTION_CASES])
def test_navier_stokes_options_match_jax(devices, pool, case):
    """``NavierStokesSpectral(wire_dtype=, decomposition=)``: the port's
    grid is JAX's, and two RK2 steps agree within the bars above."""
    kwargs, dtype = case
    n, dt, nu = 16, 0.05, 1e-2
    topo = jpa.Topology(DIMS, devices=devices[:4])
    model = NavierStokesSpectral(topo, n, viscosity=nu,
                                 dtype=jnp.dtype(dtype), **kwargs)
    uh0 = jax_taylor_green(model)
    step = jax.jit(model.step)
    rk2 = step(step(uh0, dt), dt)
    got = pool.run(tasks.spectral_wire_case, DIMS, n, dtype,
                   jpa.gather(uh0), dt, nu, kwargs)[0]
    assert got["topo"] == model.plan.topology.dims
    tol = TOL[dtype]
    assert _rel(got["rk2"], jpa.gather(rk2)) <= tol
    np.testing.assert_allclose(got["energy"], float(model.energy(rk2)),
                               rtol=tol)
