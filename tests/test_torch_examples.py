"""PyTorch port vs JAX package: the user entry points (``examples/``).

Each of the JAX package's nine ``examples/*.py`` runs here as its users
run it (``runpy`` as ``__main__``, on the 8-device CPU mesh of
``conftest.py``), and its port, ``pencilarrays_tpu_torch.examples.<name>``,
runs at the script's own shapes and seeds: in this process on one rank,
and for the Navier–Stokes, adjoint and attention examples also on the 8
gloo ranks of the shared pool.  Each JAX script runs once per test
process (``jax_example`` keeps its values).  What the script prints or asserts is read
from its globals (or, for a script with a ``main()``, from the locals of
``main`` as it returns) and held against the port's ``run()``:

* data movement, gathers and checkpoint restarts bit for bit;
* float32 arithmetic within 1e-5 of the reference's largest magnitude,
  float64 within 1e-10;
* the training and adjoint loss series within 1e-4 of each step's loss
  (where a loss has reached the float32 round-off floor of its sum, below
  1e-6 of the first, within 1e-10 of the first).
"""

import collections
import contextlib
import functools
import io
import os
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.examples import _launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, F64 = 1e-5, 1e-10


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


@functools.lru_cache(maxsize=None)
def jax_example(name):
    """The JAX script ``examples/<name>.py`` run as ``__main__``: its
    globals, updated with the locals of its ``main()`` as it returned
    (the scripts that keep their values there), and what it printed."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    frames = []

    def tracer(frame, event, arg):
        # a finished frame keeps its locals while a reference holds it
        # (a profiler the script starts may replace this hook later)
        if (event == "call" and frame.f_code.co_name == "main"
                and frame.f_code.co_filename == path):
            frames.append(frame)

    out = io.StringIO()
    old = sys.getprofile()
    sys.setprofile(tracer)
    try:
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(path, run_name="__main__")
    finally:
        sys.setprofile(old)
    kept = dict(frames[0].f_locals) if frames else {}
    return {**g, **kept, "stdout": out.getvalue()}


def close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err, tol)


def close_scalar(got, want, scale, tol, what=""):
    assert abs(got - want) <= tol * scale, (what, got, want, scale)


def losses_agree(got, want):
    assert len(got) == len(want)
    floor = 1e-6 * want[0]
    for i, (a, b) in enumerate(zip(got, want)):
        if b >= floor:
            assert abs(a - b) <= 1e-4 * b, (i, a, b)
        else:
            assert abs(a - b) <= 1e-10 * want[0], (i, a, b)


def on(pool, ranks, name, **kwargs):
    """The port's example ``name`` on one rank here, or on the pool."""
    if ranks == 1:
        import importlib

        mod = importlib.import_module(
            f"pencilarrays_tpu_torch.examples.{name}")
        return mod.run(device="cpu", **kwargs)
    return pool.run(tasks.example_case, name, kwargs)[0]


# -- the examples --------------------------------------------------------------

def test_quickstart_matches_jax():
    import pencilarrays_tpu as pa

    j = jax_example("quickstart")
    u = np.asarray(pa.gather(j["u"]))
    got = on(None, 1, "quickstart", u=u)
    assert got["transpose_verified"] and got["pipelined_bit_identical"]
    assert np.array_equal(got["u"], u)
    m = float(np.abs(u).max())
    close_scalar(got["mean"], float(pa.ops.mean(j["u"])), m, F32, "mean")
    assert got["max"] == float(pa.ops.maximum(j["u"]))
    # the script's jitted transpose + norm
    close_scalar(got["norm_y"], float(j["step"](j["u"])),
                 float(j["step"](j["u"])), F32, "norm")
    close(got["grid"], pa.gather(j["w"]), F64, "grid broadcast")
    assert got["fft_round_trip_rel_err"] <= 1e-5


def test_gradient_spectral_matches_jax():
    import pencilarrays_tpu as pa

    j = jax_example("gradient_spectral")
    got = on(None, 1, "gradient_spectral", shape=j["n"])
    assert got["dtype"] == "float64" and j["err"] < j["tol"]
    assert got["max_err"] < j["tol"] and got["gradient_verified"]
    close(got["dfdx"], pa.gather(j["dfdx"]), F64, "d/dx")


@pytest.mark.parametrize("ranks", [1, 8])
def test_navier_stokes_matches_jax(pool, ranks):
    import pencilarrays_tpu as pa
    from pencilarrays_tpu.models import taylor_green

    j = jax_example("navier_stokes")
    shutil.rmtree(j["tmp"], ignore_errors=True)
    model, model2 = j["model"], j["model2"]
    want = {"energy_step0": float(model.energy(taylor_green(model))),
            "energy_step10": float(model.energy(j["uh"])),
            "energy_restarted": float(model2.energy(
                model2.from_physical(j["u2"]))),
            "energy_continued": float(model2.energy(j["uh2"]))}
    got = on(pool, ranks, "navier_stokes", n=32)
    if ranks == 8:
        assert got["topology"] == list(j["topo"].dims)
        assert got["restart_topology"] == list(j["topo2"].dims)
    for key, w in want.items():
        close_scalar(got[key], w, w, F32, key)
    velocity = pa.gather(model.to_physical(j["uh"]))
    close(got["velocity"], velocity, F32, "velocity at step 10")
    # the restart reads back the bits it wrote
    assert np.array_equal(got["restarted"], got["velocity"])
    close(got["restarted"], pa.gather(j["u2"]), F32, "restarted")
    close(got["continued"], pa.gather(model2.to_physical(j["uh2"])), F32,
          "continued")


@pytest.mark.parametrize("ranks", [1, 8])
def test_adjoint_optimization_matches_jax(pool, ranks):
    import jax.numpy as jnp
    import pencilarrays_tpu as pa

    j = jax_example("adjoint_optimization")
    # the script's own jitted step, from its start: its loss series
    u = pa.PencilArray.zeros(j["plan"].input_pencil, dtype=jnp.float32)
    want = []
    for _ in range(40):
        loss, g = j["loss_and_grad"](u)
        want.append(float(loss))
        u = pa.PencilArray(u.pencil, u.data - 0.4 * g.data, u.extra_dims)
    assert want[0] == float(j["l0"]) and want[-1] == float(j["l"])
    got = on(pool, ranks, "adjoint_optimization", shape=j["shape"])
    losses_agree(got["losses"], want)
    assert got["converged"] and got["grad_type"] == type(j["g"]).__name__
    if ranks == 8:
        assert got["topology"] == list(j["topo"].dims)
        assert got["grad_decomposition"] == list(j["g"].pencil.decomposition)
    close(got["u"], pa.gather(j["u"]), F32, "optimized field")


def test_heat_stencil_matches_jax():
    import pencilarrays_tpu as pa

    j = jax_example("heat_stencil")
    got = on(None, 1, "heat_stencil", n=j["n"])
    assert got["dt"] == j["dt"]
    close_scalar(got["energy_initial"], j["e0"], j["e0"], F32, "e0")
    close_scalar(got["energy_final"], j["e1"], j["e1"], F32, "e1")
    close(got["u"], pa.gather(j["out"]), F32, "FD solution")
    close(got["exact"], pa.gather(j["exact"]), F32, "spectral solution")
    close_scalar(got["max_err"], j["err"], 1.0, F32, "FD vs spectral")


def test_checkpoint_collections_match_jax():
    import pencilarrays_tpu as pa

    j = jax_example("checkpoint_collections")
    try:
        got = on(None, 1, "checkpoint_collections", shape=j["shape"],
                 rotations=3)
        assert got["ok"] and got["binary_kb"] == j["size_final"] / 1e3
        assert np.array_equal(got["binary_restart"], pa.gather(j["u"]))
        assert np.array_equal(got["managed_restart"], pa.gather(j["u3"]))
        assert got["managed_steps"] == j["mgr"].steps() == [1, 2]
        assert got["latest_valid"] == j["mgr"].latest_valid() == 2
        assert ("hdf5_shape" in got) == ("h5" in j)
    finally:
        shutil.rmtree(j["workdir"], ignore_errors=True)


def test_observability_demo_matches_jax(tmp_path):
    from pencilarrays_tpu import obs as jobs
    from pencilarrays_tpu.obs import events as jevents

    try:
        j = jax_example("observability_demo")
    finally:
        jevents._reset_for_tests()   # the script leaves its journal open
    try:
        got = on(None, 1, "observability_demo", shape=(32, 24, 20),
                 workdir=str(tmp_path))
        assert got["lint_clean"] and jobs.lint_journal(j["events"]) == []
        # the hops, route verdicts and the measured hop's drift sample
        # are the decomposition's: the script's 8-device mesh makes
        # them, one rank does not
        layout = {"hop", "auto.verdict", "drift.sample"}
        want = collections.Counter(e["ev"] for e in j["events"]
                                   if e["ev"] not in layout)
        have = {k: v for k, v in got["event_kinds"].items()
                if k not in layout}
        assert have == dict(want), (have, want)
        for key in ("snapshot", "prometheus", "trace"):
            assert os.path.getsize(got[key]) > 0, key
        assert set(got["benchtime"]) == set(j["snap"]["benchtime"])
    finally:
        shutil.rmtree(j["workdir"], ignore_errors=True)


def test_sequence_parallel_attention_matches_jax(pool):
    """On one rank and on 8 (one case: the JAX script alone takes over a
    minute on the CPU mesh)."""
    import pencilarrays_tpu as pa

    j = jax_example("sequence_parallel_attention")
    for ranks in (1, 8):
        got = on(pool, ranks, "sequence_parallel_attention", seq=j["S"],
                 heads=j["H"], head_dim=j["D"], dtypes="float32")
        assert got["zigzag_flop_share"] == (4 * ranks + 2) / (8 * ranks)
        for scheme, name in (("ulysses", "out_u"), ("ring", "out_r"),
                             ("zigzag", "out_z")):
            close(got[f"{scheme}_float32"], pa.gather(j[name]), F32,
                  (ranks, scheme))
        close(got["dense_float32"], j["expect"], F32, "dense")
        close(got["dense_causal_float32"], j["expect_c"], F32,
              "dense causal")


def test_long_context_training_matches_jax():
    j = jax_example("long_context_training")
    got = on(None, 1, "long_context_training", seq=j["S"], heads=j["H"],
             head_dim=j["D"], steps=len(j["losses"]), dtypes="float32")
    losses_agree(got["losses_float32"], j["losses"])
    for w, p in got["weights_float32"].items():
        close(p, np.asarray(j["params"][w]), F32, w)


# -- the command line ----------------------------------------------------------

def test_backend_rule():
    assert _launch.backend_for("cpu", 8) == "gloo"
    with pytest.raises(ValueError):
        _launch.backend_for("cpu", 0)
    import torch

    if not torch.cuda.is_available():
        for device, ranks in ((None, 1), ("cuda", 2)):
            with pytest.raises(RuntimeError, match="--device cpu"):
                _launch.backend_for(device, ranks)


def test_example_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pencilarrays_tpu_torch.examples.quickstart",
         "--device", "cpu", "--shape", "12,10,8", "--n-fft", "16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "transpose_verified: true" in out.stdout
    assert "pipelined_bit_identical: true" in out.stdout
