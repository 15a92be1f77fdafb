"""PyTorch port vs JAX package: the driver entry points
(``__graft_entry__.py`` and its port, ``pencilarrays_tpu_torch.entry``).

* ``entry()``: the port's NS step at 32^3 float32 on one rank against
  the JAX package's jitted ``entry()`` function on the same state,
  within 1e-5 of the largest magnitude.
* ``dryrun(8, device="cpu")`` on the 8 gloo ranks of the shared pool:
  every section ``ok`` on every rank; the per-rank collectives of the
  step forward, its gradient and the FFT's forward equal what XLA
  compiled for the same functions on ``conftest.py``'s 8-device mesh
  (``utils/hlo.collective_stats``), and the halo step is point-to-point
  only in both.
* ``dryrun(1)``: every collective on a size-1 axis, so nothing crosses a
  rank; and ``python -m pencilarrays_tpu_torch.entry --dryrun 8 --device
  cpu`` exits 0 with every section ``ok``, writing its JSON only where
  it is told.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_rank_tasks as tasks
from pencilarrays_tpu_torch import entry as port_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("forward", "train_step_grad", "attention_seq_parallel",
            "fft_forward", "byte_model_sweep", "stencil_halo_step")


@pytest.fixture(scope="module")
def dry8():
    return tasks.shared_pool().run(tasks.dryrun_case, 8)


@pytest.fixture(scope="module")
def jax_costs(devices):
    """``collective_stats`` of the JAX package's dry-run functions,
    compiled on the 8-device mesh as ``_dryrun_impl`` compiles them."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from pencilarrays_tpu import Topology, dims_create
    from pencilarrays_tpu.models import HeatFD
    from pencilarrays_tpu.parallel.arrays import PencilArray
    from pencilarrays_tpu.utils.hlo import collective_stats

    topo = Topology(dims_create(8, 2), devices=devices)
    model, uh0 = graft._model(topo, port_entry.SHAPE, jnp.float32)
    pen, extra = uh0.pencil, uh0.extra_dims

    def forward(d):
        return model.step(PencilArray(pen, d, extra), 1e-2).data

    def grad_step(d):
        def loss(x):
            out = model.step(PencilArray(pen, x, extra), 1e-2)
            return jnp.sum(jnp.abs(out.data) ** 2)

        return d - 1e-3 * jax.grad(loss)(d)

    plan = model.plan

    def fft_forward(d):
        return plan.forward(PencilArray(plan.input_pencil, d, extra)).data

    heat = HeatFD(topo, port_entry.SHAPE, kappa=0.1)

    def heat_step(d):
        return heat.step(PencilArray(heat.pencil, d),
                         heat.stable_dt()).data

    def stats(fn, x):
        return collective_stats(jax.jit(fn).lower(x).compile().as_text())

    return {"forward": stats(forward, uh0.data),
            "train_step_grad": stats(grad_step, uh0.data),
            "fft_forward": stats(fft_forward,
                                 plan.allocate_input(extra).data),
            "fft_expected": plan.collective_costs(extra),
            "stencil_halo_step": stats(heat_step, heat.allocate().data)}


def test_entry_step_matches_jax():
    import jax

    import __graft_entry__ as graft

    jfn, (jdata,) = graft.entry()
    want = np.asarray(jax.jit(jfn)(jdata))
    fn, (data,) = port_entry.entry(device="cpu")
    # the same Taylor-Green state, but for the FFTs' float32 rounding
    assert data.shape == jdata.shape and data.dtype == torch.complex64
    ref = np.asarray(jdata)
    assert np.abs(data.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # one step of the JAX state through each package
    got = fn(torch.from_numpy(ref.copy())).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_dryrun_on_eight_ranks_is_ok(dry8):
    for rank, res in enumerate(dry8):
        assert res["ok"], rank
        assert res["mesh_dims"] == [4, 2] and res["n_devices"] == 8
        for s in SECTIONS:
            assert s in res, (rank, s)
        for s in ("forward", "train_step_grad", "attention_seq_parallel",
                  "fft_forward"):
            assert res[s]["ok"], (rank, s)
        # the (2,) mesh is ranks 0 and 1; the (4, 2) mesh every rank
        meshes = ([[2]] if rank < 2 else []) + [[4, 2]]
        assert [(e["mesh"], e["method"]) for e in res["byte_model_sweep"]] \
            == [(m, k) for m in meshes for k in ("AllToAll", "Ring")]
        assert all(e["ok"] for e in res["byte_model_sweep"])


@pytest.mark.parametrize("section", ["forward", "train_step_grad",
                                     "fft_forward"])
def test_dryrun_collectives_match_jax_hlo(dry8, jax_costs, section):
    for res in dry8:
        got = res[section]
        got = got["measured"] if section == "fft_forward" \
            else got["collectives"]
        assert got["all-to-all"] == jax_costs[section]["all-to-all"], (
            got, jax_costs[section])
        assert set(got) == set(jax_costs[section])
    assert dry8[0]["fft_forward"]["expected"] == jax_costs["fft_expected"]


def test_dryrun_halo_step_is_point_to_point(dry8, jax_costs):
    assert set(jax_costs["stencil_halo_step"]) == {"collective-permute"}
    for res in dry8:
        assert set(res["stencil_halo_step"]) == {"collective-permute"}


def test_dryrun_on_one_rank_moves_nothing(tmp_path):
    out = tmp_path / "dry1.json"
    res = port_entry.dryrun(1, device="cpu", out=str(out))
    assert res["ok"] and res["mesh_dims"] == [1]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    for s in ("forward", "train_step_grad", "attention_seq_parallel"):
        assert res[s]["collectives"] == {}, s
    assert res["fft_forward"]["measured"] == {}
    assert res["byte_model_sweep"] == [] and res["stencil_halo_step"] == {}


def test_dryrun_runs_as_a_module(tmp_path):
    out = tmp_path / "dry8.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-m", "pencilarrays_tpu_torch.entry", "--dryrun",
         "8", "--device", "cpu", "--out", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["ok"] and json.loads(out.read_text()) == res
    assert sorted(os.listdir(tmp_path)) == ["dry8.json"]
