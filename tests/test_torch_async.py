"""PyTorch port vs JAX package: the async, compiled and measured paths the
engine unblocks (the cases of ``tests/test_engine.py``'s model and
checkpoint half, the compile cases of ``tests/test_fft.py`` and
``tests/test_auto_method.py``'s measure mode), on gloo ranks of the
shared pool against the JAX package on its 8-device CPU mesh.

* ``NavierStokesSpectral.step_async`` on a (2, 2) topology at 8^3 is
  bit-identical to the port's own ``step`` and within the NS tolerance
  (1e-4 relative, f32: the FFT libraries sum in different orders) of the
  JAX package's jitted ``step``;
* ``DiffusionSpectral.run_async`` with a checkpoint every 2 of 5 steps on
  2 ranks commits steps [2, 4] from the host pool; the JAX package's
  ``CheckpointManager`` restores step 2 bit-identical to the port's
  2-step sync state;
* ``forward_async``/``backward_async`` are bit-identical to the
  synchronous calls, and the dispatch log certifies each dispatch's
  exchange calls against ``collective_costs``;
* ``compile()`` is cached per ``(extra_dims, donate)``, refuses a wrong
  batch, is bit-identical to the eager chain, and ``donate=True``
  invalidates the input;
* ``Auto(mode="measure")`` on 2 and 4 ranks times the JAX package's
  candidate list, every rank runs rank 0's winner, and the report has
  the JAX package's keys;
* a consumer issuing exchanges while the host pool saves with barriers
  on a side group finishes on 2 ranks under a 120 s timeout of its own;
* a forced ``Pipelined(4)`` route (chunked hops, each chunk unpacked
  behind the next chunk's exchange) moves JAX's bits.
"""

import jax
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu.models.diffusion import DiffusionSpectral as JaxDiffusion
from pencilarrays_tpu.models.spectral import NavierStokesSpectral
from pencilarrays_tpu.models.spectral import taylor_green as jax_taylor_green
from pencilarrays_tpu.parallel import transpositions as jtr
from pencilarrays_tpu.resilience import CheckpointManager as JaxManager
from pencilarrays_tpu_torch.engine import Engine
from pencilarrays_tpu_torch.parallel.distributed import RankPool
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift


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


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_ns_step_async_matches_jax(devices, pool):
    n, dt, nu = 8, 1e-3, 1e-2
    topo = jpa.Topology((2, 2), devices=devices[:4])
    model = NavierStokesSpectral(topo, n, viscosity=nu)
    uh0 = jax_taylor_green(model)
    want = jpa.gather(jax.jit(model.step)(uh0, dt))
    got = pool.run(tasks.ns_async_case, (2, 2), n, np.asarray(uh0.data),
                   dt, nu)[0]
    assert got["same"] == [True] * 4
    assert _rel(got["out"], want) <= 1e-4
    assert _rel(got["out"], jpa.gather(uh0)) > 1e-6   # it moved


@pytest.mark.parametrize("dims", [(1,), (2,)])
def test_diffusion_run_async_checkpoints_read_by_jax(devices, pool,
                                                      tmp_path, dims):
    shape, dt = (8, 6, 4), 0.01
    u0 = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    got = pool.run(tasks.diffusion_async_case, dims, shape, u0, dt,
                   str(tmp_path))[0]
    assert got["steps"] == [2, 4] and got["saves"] == 2
    assert got["host_tasks"] >= 2 and got["dispatches"] == 5
    assert got["same"] == [(True, True)] * int(np.prod(dims))
    if np.prod(dims) > 1:
        assert "side_group" in got["refused"]
    else:
        assert got["refused"] is None
    jtopo = jpa.Topology((4, 2), devices=devices)
    jmodel = JaxDiffusion(jtopo, shape)
    mgr = JaxManager(str(tmp_path / "ck"))
    assert mgr.steps() == [2, 4] and mgr.latest_valid() == 4
    back = mgr.restore(2).read("uh", jmodel.plan.output_pencil, verify=True)
    np.testing.assert_array_equal(jpa.gather(back), got["two"])


@pytest.mark.parametrize("dims", [(1, 1), (2, 1), (2, 2)])
def test_fft_async_bit_identical(pool, dims):
    shape = (8, 6, 4)
    u = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = pool.run(tasks.fft_async_case, dims, shape, u)[0]
    assert got["same"] == [[True] * 4] * int(np.prod(dims))
    assert got["donated"]
    cert = got["cert"]
    assert cert["order_ok"] and cert["dispatches"] == 4
    assert cert["verified_traces"] == 4 and cert["wire_checked"] == 4
    assert cert["ops"] == 4 * len([v for v in got["costs"].values()
                                   if v["count"]])
    # the real transform runs along dim 0
    want = np.fft.fftn(u)[: shape[0] // 2 + 1]
    np.testing.assert_allclose(got["spectral"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_verify_dispatch_log_holds_collectives_to_the_plan():
    from pencilarrays_tpu_torch.analysis import verify_dispatch_log
    from pencilarrays_tpu_torch.analysis.errors import ScheduleMismatchError

    topo = pat.Topology((1, 1), device="cpu")
    plan = pat.PencilFFTPlan(topo, (8, 6, 4), real=True)
    e = Engine("cert")
    try:
        plan.forward_async(plan.allocate_input(), engine=e).result(30)
        rec = e.dispatch_log()[-1]
        assert rec.meta["collectives"] == {} and rec.meta["wire_bytes"] == 0
        assert verify_dispatch_log([rec])["verified_traces"] == 1
        forged = type(rec)(**{**rec.__dict__, "meta": {
            **rec.meta, "collectives": {"all-to-all": {"count": 1,
                                                       "bytes": 8}}}})
        with pytest.raises(ScheduleMismatchError, match="all-to-all"):
            verify_dispatch_log([forged])
        forged = type(rec)(**{**rec.__dict__, "meta": {
            **rec.meta, "wire_bytes": 8}})
        with pytest.raises(ScheduleMismatchError, match="wire-bytes"):
            verify_dispatch_log([forged])
    finally:
        e.close()


def test_compile_cached_checked_and_bit_identical():
    topo = pat.Topology((1, 1), device="cpu")
    plan = pat.PencilFFTPlan(topo, (8, 6, 4), real=True, batch=3)
    c = plan.compile()
    assert c is plan.compile() and c is plan.compile((3,))
    assert c.extra_dims == (3,) and not c.graphed
    assert plan.compile((2,)) is not c
    assert plan.compile(donate=True) is not c
    u = pat.PencilArray.from_global(
        plan.input_pencil, np.random.default_rng(1).standard_normal(
            (8, 6, 4, 3)).astype(np.float32))
    f = c.forward(u)
    assert f.pencil == plan.output_pencil
    np.testing.assert_array_equal(f.data.numpy(), plan.forward(u).data.numpy())
    np.testing.assert_array_equal(c.backward(f).data.numpy(),
                                  plan.backward(f).data.numpy())
    with pytest.raises(ValueError, match="extra_dims"):
        plan.compile((2,)).forward(u)
    with pytest.raises(ValueError, match="input_pencil"):
        c.forward(f)
    assert c.graph_info("forward") is None
    d = plan.compile(donate=True)
    x = pat.PencilArray(u.pencil, u.data.clone(), u.extra_dims)
    np.testing.assert_array_equal(d.forward(x).data.numpy(), f.data.numpy())
    assert x.is_deleted() and not u.is_deleted()


def test_compile_replay_and_release():
    """``replay`` hands the chain's result to its callback and returns what
    the callback does; ``release_compiled`` frees no graph on the CPU and
    keeps every executable cached (on the card each recaptures)."""
    topo = pat.Topology((1, 1), device="cpu")
    plan = pat.PencilFFTPlan(topo, (8, 6, 4), real=True)
    c = plan.compile(())
    u = pat.PencilArray.from_global(
        plan.input_pencil, np.random.default_rng(2).standard_normal(
            (8, 6, 4)).astype(np.float32))
    pen, got = c.replay(u, "forward", lambda out: (out.pencil, out.data))
    assert pen == plan.output_pencil
    np.testing.assert_array_equal(got.numpy(), plan.forward(u).data.numpy())
    with pytest.raises(ValueError, match="output_pencil"):
        c.replay(u, "backward", lambda out: out)
    assert plan.release_compiled() == 0 and c.release() == 0
    assert plan.compile(()) is c and c.pool_handle is None
    np.testing.assert_array_equal(c.forward(u).data.numpy(), got.numpy())


@pytest.mark.parametrize("dims", [(2, 1), (4, 1)])
def test_auto_measure_matches_jax_candidates(devices, pool, dims):
    shape = (12, 10, 8)
    n = int(np.prod(dims))
    u = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jtopo = jpa.Topology(dims, devices=devices[:n])
    jpin = jpa.Pencil(jtopo, shape, (1, 2))
    jm = jpa.resolve_method(jpin, jpin.replace(decomp_dims=(0, 2)), (),
                            np.float32, jpa.Auto(mode="measure"))
    want = jtr.last_measure_reports()[-1]
    got = pool.run(tasks.measure_case, dims, shape, u)[0]
    rep = got["report"]
    assert set(rep) == set(want)
    assert rep["candidates"] == want["candidates"]
    assert rep["config"] == want["config"]
    assert len(rep["seconds"]) == len(rep["candidates"]) == len(
        rep["k1_spreads"])
    assert all(t > 0 for t in rep["seconds"])
    assert any(c.startswith("Pipelined") for c in rep["candidates"])
    assert len(set(got["winners"])) == 1 and got["winners"][0] == \
        rep["winner"]
    assert rep["winner"] in want["candidates"]
    assert got["hit"] and got["again"]
    np.testing.assert_array_equal(got["glob"], u)
    assert jtr._method_label(jm) in want["candidates"]


def test_auto_measure_on_a_trivial_axis_measures_nothing():
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    topo = pat.Topology((1, 1), device="cpu")
    pin = pat.Pencil(topo, (8, 6, 4), (1, 2))
    before = len(tr.last_measure_reports())
    m = tr.resolve_method(pin, pin.replace(decomp_dims=(0, 2)), (), None,
                          pat.Auto(mode="measure", wire_dtype="bf16"))
    assert m == pat.AllToAll(wire_dtype="bf16")
    assert len(tr.last_measure_reports()) == before
    with pytest.raises(ValueError, match="mode"):
        pat.Auto(mode="guess")


def test_two_threads_issue_collectives_on_separate_groups(tmp_path):
    shape = (8, 6, 4)
    u = np.random.default_rng(5).standard_normal(shape)
    with RankPool(2, timeout_s=120) as p:
        got = p.run(tasks.two_thread_case, (2, 1), shape, u, 8,
                    str(tmp_path))[0]
    assert got["ok"] == [True, True]
    assert got["steps"] == [0, 2, 4, 6]


def test_pipelined_route_matches_jax(devices, pool):
    shape = (12, 10, 8)
    u = np.random.default_rng(9).standard_normal(shape)
    jtopo = jpa.Topology((2, 2), devices=devices[:4])
    jin = jpa.Pencil(jtopo, shape, (1, 2))
    jout = jpa.Pencil(jtopo, shape, (2, 0))
    want = np.asarray(jpa.reshard(jpa.PencilArray.from_global(jin, u), jout,
                                  method=jpa.Pipelined(4)).data)
    got = pool.run(tasks.reshard_case, (2, 2), shape, ((1, 2), None),
                   ((2, 0), None), u, [dict(method=pat.Pipelined(4))])[0][0]
    assert got["verdict"] == "routed:forced"
    assert [m for _, m in got["hops"]] == ["Pipelined", "Pipelined"]
    np.testing.assert_array_equal(got["padded"].view(np.uint8),
                                  want.view(np.uint8))
    np.testing.assert_array_equal(got["glob"], u)
