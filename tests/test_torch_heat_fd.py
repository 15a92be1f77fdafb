"""PyTorch port vs JAX package: the finite-difference heat model.

``HeatFD.step`` from the same global field, on 1, 2, 4 and 8 gloo ranks
against the JAX package on its (4, 2) mesh, agrees within 1e-12
(float64) after each of three steps, and with a NumPy version of the
same scheme.  A step is pure halo exchange: no all-to-all, no ring
round (``transpositions.exchange_calls`` stays 0).  Zero boundaries
drain the box.  Cases follow ``tests/test_heat_fd.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu.models import HeatFD as JaxHeatFD
from pencilarrays_tpu_torch.models import HeatFD

DIMS = [(1, 1), (1, 2), (2, 2), (4, 2)]
SHAPE = (12, 10, 8)
RTOL = 1e-12


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _np_lap(g, spacing):
    return sum((np.roll(g, -1, d) - 2 * g + np.roll(g, 1, d)) / h ** 2
               for d, h in enumerate(spacing))


def _np_step(g, dt, kappa, spacing):
    mid = g + 0.5 * dt * kappa * _np_lap(g, spacing)
    return g + dt * kappa * _np_lap(mid, spacing)


@pytest.fixture(scope="module")
def reference(devices):
    g = np.random.default_rng(0).standard_normal(SHAPE)
    topo = jpa.Topology((4, 2), devices=devices)
    model = JaxHeatFD(topo, SHAPE, kappa=0.7, dtype=jnp.float64)
    u = model.from_global(g)
    states = []
    for _ in range(3):
        u = model.step(u, model.stable_dt())
        states.append(jpa.gather(u))
    return g, model, states


@pytest.mark.parametrize("dims", DIMS)
def test_heat_fd_matches_jax(pool, reference, dims):
    g, jmodel, want = reference
    got = pool.run(tasks.heat_case, dims, SHAPE, (0, 1), g, 0.7, 3)[0]
    assert got["dt"] == jmodel.stable_dt()
    assert got["spacing"] == jmodel.spacing
    ref = g
    for mine, theirs in zip(got["states"], want):
        np.testing.assert_allclose(mine, theirs, rtol=RTOL, atol=1e-12)
        ref = _np_step(ref, got["dt"], 0.7, got["spacing"])
        np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=1e-12)
    # neighbour-only: halo batches, never an all-to-all or ring round
    assert all(c == {"all-to-all": 0, "collective-permute": 0}
               for c in got["exchange"])
    decomposed = [d for d, p in zip((0, 1), dims) if p > 1]
    for c in got["halo"]:
        # 3 steps x 2 right-hand sides x 2 shifts per decomposed dim
        assert c["calls"] == 12 * len(decomposed)
        assert c["messages"] == c["calls"]


@pytest.mark.parametrize("dims,decomp", [((8,), (0,)), ((2, 4), (1, 2)),
                                         ((4, 2), (0, 2))])
def test_decomposition_independent(pool, dims, decomp):
    g = np.random.default_rng(1).standard_normal((8, 12, 10))
    got = pool.run(tasks.heat_case, dims, (8, 12, 10), decomp, g, 0.3, 2)[0]
    topo = pat.Topology((1,), device="cpu")
    m = HeatFD(topo, (8, 12, 10), kappa=0.3, decomp_dims=(0,),
               dtype=torch.float64)
    u = m.from_global(g)
    for _ in range(2):
        u = m.step(u, m.stable_dt())
    np.testing.assert_allclose(got["states"][-1], pat.gather(u),
                               atol=1e-12)


@pytest.mark.parametrize("dims", [(1,), (4,)])
def test_zero_boundary_decays(pool, dims):
    g = np.zeros((16, 16, 16))
    g[8, 8, 8] = 1.0
    got = pool.run(tasks.heat_case, dims, (16, 16, 16), (0,), g, 1.0, 5,
                   "zero")[0]
    assert got["e1"] < got["e0"] and got["finite"]


def test_heat_fd_api():
    topo = pat.Topology((1, 1), device="cpu")
    m = HeatFD(topo, 8)
    assert m.shape == (8, 8, 8) and m.dtype == torch.float32
    assert m.pencil.decomposition == (0, 1)
    u = m.allocate()
    assert u.dtype == torch.float32 and u.data.abs().sum() == 0
    assert m.stable_dt(1.0) == pytest.approx(
        1 / (2 * 3 * (8 / (2 * np.pi)) ** 2))
    assert m.from_global(np.ones((8, 8, 8))).dtype == torch.float32
