"""PyTorch port vs JAX package: PencilFFTPlan on 4 gloo ranks.

The port builds the same static schedule as the JAX package (same stage
chain, same pencils, same hops, the same fused ``"ft"`` steps with the
same chunk dims and bounds under ``pipeline=``), moves the data with the
same bit-exact transposes and transforms each block with ``torch.fft``.
Two FFT libraries sum in different orders, so spectra agree to a
tolerance: 2e-5 x max|ref| in float32 and 1e-10 x max|ref| in float64
(DCT/DST: 1e-5 in float32, and scipy's ``dctn``/``dstn`` as a second
reference).  Round trips must return the input to the same tolerance, a
pipelined or ``Ring``/``Pipelined``/``Auto`` plan the serialized plan's
spectrum to 1e-12 x max in float64, and the collective cost model must
equal the JAX plan's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sf
import torch

import pencilarrays_tpu as jpa
import torch_rank_tasks as tasks
from pencilarrays_tpu.ops.fft import PencilFFTPlan as JaxPlan
from pencilarrays_tpu_torch.parallel.distributed import RankPool
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift

DIMS = (2, 2)
TOL = {"float32": 2e-5, "float64": 1e-10}


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


def _jax_method(m):
    """The JAX package's method of the same name and fields."""
    if m is None:
        return jpa.AllToAll()
    name = type(m).__name__
    if name == "Pipelined":
        return jpa.Pipelined(m.chunks, _jax_method(m.base))
    if name == "Auto":
        return jpa.Auto(latency_bytes=m.latency_bytes)
    return getattr(jpa, name)()


def _options():
    import pencilarrays_tpu_torch as pat

    return [
        # (id, shape, dtype, port kwargs, scipy reference or None)
        ("dct-f64", (12, 10, 14), np.float64, dict(transform="dct"),
         lambda u: sf.dctn(u, norm="ortho")),
        ("dst-f64", (12, 10, 14), np.float64, dict(transform="dst"),
         lambda u: sf.dstn(u, type=2, norm="ortho")),
        ("dct-f32", (12, 10, 14), np.float32, dict(transform="dct"), None),
        ("dct-fft-fft-f64", (12, 10, 14), np.float64,
         dict(transforms=("dct", "fft", "fft")),
         lambda u: np.fft.fftn(sf.dct(u, axis=0, norm="ortho"),
                               axes=(1, 2))),
        ("dct-fft-fft-f32", (12, 10, 14), np.float32,
         dict(transforms=("dct", "fft", "fft")), None),
        ("dst-rfft-none-f64", (12, 10, 14), np.float64,
         dict(transforms=("dst", "rfft", "none")), None),
        ("pipeline2-r2c", (16, 12, 10), np.float64,
         dict(real=True, pipeline=2), None),
        ("pipeline4-r2c", (16, 12, 10), np.float64,
         dict(real=True, pipeline=4), None),
        ("pipeline3-ragged-c2c", (11, 9, 13), np.complex128,
         dict(pipeline=3), None),
        ("pipeline4-r2c-batch3-f32", (9, 14, 11), np.float32,
         dict(real=True, pipeline=4, batch=3), None),
        ("pipeline2-dct", (12, 10, 14), np.float64,
         dict(transform="dct", pipeline=2), None),
        ("pipeline2-ring", (16, 12, 10), np.float64,
         dict(real=True, pipeline=2, method=pat.Ring()), None),
        ("ring-r2c", (16, 12, 10), np.float64,
         dict(real=True, method=pat.Ring()), None),
        ("pipelined4-c2c", (11, 9, 13), np.complex128,
         dict(method=pat.Pipelined(4)), None),
        ("pipelined3ring-r2c-batch2", (9, 14, 11), np.float64,
         dict(real=True, batch=2, method=pat.Pipelined(3, pat.Ring())),
         None),
        ("auto0-r2c", (9, 14, 11), np.float64,
         dict(real=True, method=pat.Auto(latency_bytes=0)), None),
        ("auto-pipeline", (16, 12, 10), np.float64,
         dict(real=True, pipeline="auto"), None),
    ]


OPTIONS = _options()


@pytest.mark.parametrize("case", OPTIONS, ids=[c[0] for c in OPTIONS])
def test_fft_plan_options_match_jax(devices, pool, case):
    """DCT/DST kinds, ``pipeline=`` (fused hops) and every method: the
    JAX package's schedule, chunks and costs; its spectrum (and scipy's)
    within the tolerance; the serialized plan's spectrum to 1e-12 in
    float64 (chunking commutes with the transforms)."""
    name, shape, dtype, kwargs, scipy_ref = case
    topo = jpa.Topology(DIMS, devices=devices[:4])
    jkw = {k: v for k, v in kwargs.items() if k != "method"}
    if jkw.get("pipeline") == "auto":
        jkw["pipeline"] = 4       # the port's "auto" with no sweep of its own
    jplan = JaxPlan(topo, shape, dtype=jnp.dtype(dtype),
                    method=_jax_method(kwargs.get("method")), **jkw)
    extra = (kwargs["batch"],) if kwargs.get("batch") else ()
    real = not np.issubdtype(dtype, np.complexfloating)
    u = _input(shape, real, dtype, extra)
    uh = jplan.forward(jpa.PencilArray.from_global(jplan.input_pencil, u))
    want = jpa.gather(uh)
    got = pool.run(tasks.fft_case, DIMS, shape,
                   dict(kwargs, dtype=np.dtype(dtype).name), u, True)[0]
    sched = [(s[0], s[1].decomposition,
              tuple(s[1].permutation.apply(tuple(range(len(shape))))),
              s[2].decomposition) + ((s[8], tuple(s[9])) if s[0] == "ft"
                                     else ()) for s in jplan._steps]
    assert got["schedule"] == sched
    if "pipeline" in kwargs:
        assert any(s[0] == "ft" for s in sched)
        assert got["pipeline_chunks"] == jkw["pipeline"]
    assert got["costs"] == jplan.collective_costs()
    assert got["out_padded"] == np.asarray(uh.data).shape
    tol = TOL[np.dtype(np.empty(0, dtype).real.dtype).name]
    scale = np.abs(want).max()
    assert got["spectrum"].dtype == want.dtype
    assert np.abs(got["spectrum"] - want).max() <= tol * scale
    if scipy_ref is not None:
        ref = scipy_ref(u)
        assert np.abs(got["spectrum"] - ref).max() <= tol * np.abs(ref).max()
    serial_tol = 1e-12 if tol < 1e-6 else tol
    assert np.abs(got["spectrum"] - got["serial"]).max() <= serial_tol * scale
    back = got["back"] / jplan.scale_factor()
    assert back.dtype == u.dtype
    assert np.abs(back - u).max() <= tol * np.abs(u).max()


@pytest.mark.parametrize("pipeline", [2, 4])
def test_fused_hop_gradient_matches_jax(devices, pool, pipeline):
    """The gradient of ``sum(|forward(x).data|^2)`` through fused hops:
    JAX's ``jax.grad`` of the same pipelined plan, and the port's
    serialized plan (``tests/test_fft.py``'s
    ``test_pipeline_under_jit_and_grad``)."""
    shape = (16, 12, 10)
    topo = jpa.Topology(DIMS, devices=devices[:4])
    jplan = JaxPlan(topo, shape, real=True, dtype=jnp.float64,
                    pipeline=pipeline)
    x = jpa.PencilArray.from_global(
        jplan.input_pencil, np.random.default_rng(43).standard_normal(shape))

    def loss(d):
        uh = jplan.forward(jpa.PencilArray(jplan.input_pencil, d))
        return jnp.sum(jnp.abs(uh.data) ** 2)

    want = np.asarray(jax.jit(jax.grad(loss))(x.data))
    fused, serial = pool.run(tasks.fft_grad_case, DIMS, shape,
                             dict(real=True, dtype="float64",
                                  pipeline=pipeline),
                             np.asarray(x.data))[0]
    scale = np.abs(want).max()
    assert np.abs(fused - want).max() <= 1e-10 * scale
    assert np.abs(fused - serial).max() <= 1e-12 * scale


def test_pipeline_auto_and_validation(monkeypatch):
    """``pipeline="auto"``: K = 4 unless a sweep captured on the port's
    own platform says otherwise (the repo's sweep is the JAX package's,
    captured on its CPU: it routes nothing here); bad values raise, as do
    the JAX package's DCT/DST argument checks."""
    import pencilarrays_tpu_torch as pat
    import pencilarrays_tpu_torch.ops.fft as fft_mod

    topo = pat.Topology(DIMS, device="cpu")
    for bad in (0, "fast", 1.5):
        with pytest.raises(ValueError, match="pipeline"):
            pat.PencilFFTPlan(topo, (8, 8, 8), pipeline=bad)
    assert fft_mod._pipeline_sweep_verdict("torch-cpu") is None
    plan = pat.PencilFFTPlan(topo, (16, 12, 10), real=True,
                             dtype="float64", pipeline="auto")
    assert plan.pipeline_chunks == fft_mod._PIPELINE_AUTO_DEFAULT_K == 4
    assert any(s[0] == "ft" for s in plan._steps)
    monkeypatch.setattr(fft_mod, "_pipeline_sweep_verdict",
                        lambda p: {"best_k": 2} if p == "torch-cpu"
                        else None)
    plan = pat.PencilFFTPlan(topo, (16, 12, 10), real=True,
                             dtype="float64", pipeline="auto")
    assert plan.pipeline_chunks == 2
    monkeypatch.setattr(fft_mod, "_pipeline_sweep_verdict",
                        lambda p: {"best_k": 1})
    plan = pat.PencilFFTPlan(topo, (16, 12, 10), real=True,
                             dtype="float64", pipeline="auto")
    assert all(s[0] in ("t", "f") for s in plan._steps)
    p1 = pat.PencilFFTPlan(topo, (16, 12, 10), real=True, pipeline=1)
    p0 = pat.PencilFFTPlan(topo, (16, 12, 10), real=True)
    assert p1._steps == p0._steps
    # a one-rank topology has no hop to fuse
    one = pat.PencilFFTPlan(pat.Topology((1, 1), device="cpu"), (8, 8, 8),
                            real=True, pipeline=4)
    assert [s[0] for s in one._steps] == ["f"]
    with pytest.raises(ValueError, match="transform"):
        pat.PencilFFTPlan(topo, (8, 8, 8), transform="hartley")
    for r2r in ("dct", "dst"):
        with pytest.raises(ValueError, match="implicit"):
            pat.PencilFFTPlan(topo, (8, 8, 8), transform=r2r, real=True)
        with pytest.raises(ValueError, match="real dtype"):
            pat.PencilFFTPlan(topo, (8, 8, 8), transform=r2r,
                              dtype="complex64")
        assert pat.PencilFFTPlan(topo, (8, 8, 8), transform=r2r,
                                 dtype="float64").dtype_spectral == \
            torch.float64
    with pytest.raises(ValueError, match="real-input"):
        pat.PencilFFTPlan(topo, (8, 8, 8), transforms=("fft", "dct", "fft"),
                          dtype="float64")


def test_fft_plan_options_construct():
    """Every plan option of the JAX package is ported now and constructs
    (``compile``, the async calls and ``Auto(mode="measure")`` joined
    ``decomposition=``, ``wire_dtype=`` and ``hbm_limit=``); the async
    calls still take exactly one operand, as the JAX package's do."""
    import pencilarrays_tpu_torch as pat

    topo = pat.Topology(DIMS, device="cpu")
    plan = pat.PencilFFTPlan(topo, (8, 8, 8))
    assert plan.compile() is plan.compile()
    for call in (plan.forward_async, plan.backward_async):
        with pytest.raises(ValueError, match="exactly one"):
            call()
    assert pat.Auto(mode="measure").mode == "measure"
    for kw in (dict(pipeline=2), dict(pipeline="auto"),
               dict(transform="dct"), dict(transform="dst"),
               dict(method=pat.Ring()), dict(method=pat.Pipelined(3)),
               dict(method=pat.Auto()), dict(decomposition="auto"),
               dict(wire_dtype="bf16"), dict(hbm_limit=1 << 20)):
        plan = pat.PencilFFTPlan(topo, (8, 8, 8),
                                 **dict(kw, dtype="float64"))
        assert plan.collective_costs()


# -- wire, decomposition and hbm_limit (tests/test_wire.py,
# tests/test_fft.py, tests/test_reshard_hbm.py) ---------------------------

# (id, plan kwargs for both packages, the port's method, JAX's method)
PLAN_OPTION_CASES = [
    ("bf16", dict(real=True, wire_dtype="bf16"), None, None),
    ("fp8-e4m3", dict(real=True, wire_dtype="fp8_e4m3"), None, None),
    ("fp8-e5m2-pipe2", dict(real=True, wire_dtype="fp8_e5m2",
                            pipeline=2), None, None),
    ("f16-ring", dict(real=True), "ring-f16", "ring-f16"),
    ("auto-batch3", dict(real=True, decomposition="auto", batch=3),
     None, None),
    ("slab-bf16", dict(real=True, decomposition="slab", wire_dtype="bf16"),
     None, None),
    ("hbm", dict(real=True, hbm_limit="tight"), None, None),
    ("hbm-pipe2", dict(real=True, pipeline=2, hbm_limit="tight"),
     None, None),
]


def _option_kwargs(mod, kw, method, shape, topo):
    kw = dict(kw)
    if method == "ring-f16":
        kw["method"] = mod.Ring(wire_dtype="f16")
    if kw.get("hbm_limit") == "tight":
        # one byte under the largest modeled hop of the unbounded plan
        from pencilarrays_tpu.analysis import spmd

        base = {k: v for k, v in kw.items() if k != "hbm_limit"}
        kw["hbm_limit"] = spmd.predicted_peak_hbm(
            JaxPlan(topo, shape, **base))[0] - 1
    return kw


def _jax_forward(plan, u):
    return jpa.gather(plan.forward(jpa.PencilArray.from_global(
        plan.input_pencil, u)))


def _wire_close(got, want, wire, unwired):
    """A wired spectrum against the JAX package's: the two differ only
    where the FFT libraries' last-bit roundings put a value on the other
    side of a wire rounding step, so their distance is held to an eighth
    of the wire's unit roundoff ``u`` (relative, in norm).  The wire's own
    error is about ``u * sqrt(hops / 3)``: the same plan without the wire
    (``unwired``) must fail the bound, as zeros do."""
    from pencilarrays_tpu_torch.parallel import wire as pwire

    bound = torch.finfo(pwire._torch_wire(wire)).eps / 2 / 8
    norm = np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= bound * norm
    assert np.linalg.norm(unwired - want) > bound * norm


@pytest.mark.parametrize("case", PLAN_OPTION_CASES,
                         ids=[c[0] for c in PLAN_OPTION_CASES])
def test_plan_options_match_jax(devices, pool, case):
    """The port's plan is the JAX plan: the same ``plan_key`` (schedule,
    hop methods, chunking, decomposition verdict with every candidate's
    score, predicted costs, wire), the same spectrum within the FFT
    tolerance on a full-precision wire and within :func:`_wire_close`
    otherwise; ``hbm_limit`` plans give the unbounded plan's bits, and
    ``with_wire_dtype`` variants differ from it by the key alone."""
    import pencilarrays_tpu_torch as pat

    cid, kw, pmeth, jmeth = case
    shape = (16, 12, 10)
    topo = jpa.Topology(DIMS, devices=devices[:4])
    jkw = _option_kwargs(jpa, kw, jmeth, shape, topo)
    pkw = _option_kwargs(pat, kw, pmeth, shape, topo)
    jplan = JaxPlan(topo, shape, **jkw)
    extra = jplan.batch_dims
    u = _input(shape, True, np.float32, extra)
    want = jpa.gather(jplan.forward(jpa.PencilArray.from_global(
        jplan.input_pencil, u)))
    variants = ("bf16",) if cid in ("auto-batch3", "hbm") else ()
    got = pool.run(tasks.fft_wire_case, DIMS, shape, pkw, u, variants)[0]
    assert got["key"] == jplan.plan_key()
    assert got["costs"] == jplan.collective_costs()
    assert got["topo"] == jplan.topology.dims
    if jplan.decomposition_verdict is not None:
        assert got["verdict"] == jplan.decomposition_verdict
    scale = np.max(np.abs(want))
    wire = jplan.wire_dtype
    if wire is None:
        err = np.max(np.abs(got["spectrum"] - want))
        assert err <= TOL["float32"] * scale
    else:
        _wire_close(got["spectrum"], want, wire,
                    unwired=_jax_forward(jplan.with_wire_dtype(None), u))
    back_err = np.max(np.abs(got["back"] - u))
    if wire is None:
        assert back_err <= TOL["float32"] * np.max(np.abs(u))
    elif wire in ("bf16", "f16"):
        # test_wire.py:242: 4 packed exchanges, a few wire eps
        eps = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}[wire]
        assert 0 < back_err <= 8 * eps * np.max(np.abs(u))
    else:
        rel = np.linalg.norm(got["back"] - u) / np.linalg.norm(u)
        assert 0 < rel <= 0.08
    if "hbm_limit" in jkw:
        assert got["methods"] or any(s[0] == "ft" for s in got["schedule"])
        unbounded = pool.run(tasks.fft_wire_case, DIMS, shape,
                             {k: v for k, v in pkw.items()
                              if k != "hbm_limit"}, u)[0]
        np.testing.assert_array_equal(got["spectrum"], unbounded["spectrum"])
        assert got["key"] != unbounded["key"]
    for w, (spec, key) in got["variants"].items():
        jv = jplan.with_wire_dtype(w)
        assert key == jv.plan_key() != got["key"]
        _wire_close(spec, _jax_forward(jv, u), w, unwired=want)


def test_drift_corrected_verdict_matches_jax(devices):
    """Both packages hold the same trusted samples (the first hop of the
    drift-free winner far over its byte model, the runner-up's first hop
    under it): both decomposition verdicts turn ``drift_corrected`` with
    the same scores, winner and ``plan_key``.  Planned in one process
    (the port's drift rule: a one-process world)."""
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.ops import fft as pfft
    from pencilarrays_tpu_torch.parallel import transpositions as ptr

    shape, kw = (16, 12, 10), dict(real=True, decomposition="auto", batch=3)
    jtopo = jpa.Topology(DIMS, devices=devices[:4])
    ptopo = pat.Topology(DIMS, device="cpu")
    j0 = JaxPlan(jtopo, shape, **kw)
    p0 = pat.PencilFFTPlan(ptopo, shape, **kw)
    assert p0.plan_key() == j0.plan_key()
    assert not p0.decomposition_verdict["drift_corrected"]
    cands = [tuple(c["dims"]) for c in p0.decomposition_verdict[
        "candidates"]]
    samples = []
    for dims, secs in zip(cands[:2], (1.0, 1e-7)):
        probe = pat.PencilFFTPlan(pat.Topology.unconnected(dims), shape,
                                  _probe=True, real=True, batch=3)
        src, dst, dt, _, _, chunk = next(
            h for h in pfft._iter_priced_hops(probe._steps)
            if ptr.transpose_cost(h[0], h[1], (3,), h[2], pat.AllToAll()))
        cost = ptr.transpose_cost(src, dst, (3,), dt, pat.AllToAll())
        samples.append((ptr._hop_label(src, dst, pat.AllToAll(), dt),
                        sum(v["bytes"] for v in cost.values()), secs))
    for label, nbytes, secs in samples:
        jax_drift.drift_tracker.record(label, nbytes, secs,
                                       source="benchtime")
        port_drift.drift_tracker.record(label, nbytes, secs,
                                        source="benchtime")
    j1 = JaxPlan(jtopo, shape, **kw)
    p1 = pat.PencilFFTPlan(ptopo, shape, **kw)
    assert j1.decomposition_verdict["drift_corrected"]
    assert p1.decomposition_verdict == {
        k: v for k, v in j1.decomposition_verdict.items()}
    assert p1.plan_key() == j1.plan_key() != j0.plan_key()
    assert p1.decomposition_verdict["candidates"] != \
        p0.decomposition_verdict["candidates"]


def test_decomposition_and_hbm_errors_match_jax(devices):
    """Invalid ``decomposition=`` and ``hbm_limit=`` raise as in the JAX
    package; an impossible limit is a typed ``HbmBoundError`` naming the
    hop; a Gspmd method cannot carry a wire."""
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu.analysis.errors import HbmBoundError as JErr
    from pencilarrays_tpu_torch.analysis import HbmBoundError

    topo = jpa.Topology(DIMS, devices=devices[:4])
    ptopo = pat.Topology(DIMS, device="cpu")
    for bad, exc in ((dict(decomposition="cube"), ValueError),
                     (dict(hbm_limit=0), ValueError),
                     (dict(hbm_limit=64), (JErr, HbmBoundError))):
        with pytest.raises(exc) as jerr:
            JaxPlan(topo, (16, 12, 8), real=True, **bad)
        with pytest.raises(exc) as err:
            pat.PencilFFTPlan(ptopo, (16, 12, 8), real=True, **bad)
        if bad.get("hbm_limit") == 64:
            assert isinstance(err.value, HbmBoundError)
            assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="decomposition"):
        pat.PencilFFTPlan(pat.Topology((1,), device="cpu"), (8,),
                          decomposition="pencil")
    # the plan's wire and its method's agree, whichever spells it
    a = pat.PencilFFTPlan(ptopo, (16, 12, 10), real=True, wire_dtype="bf16")
    b = pat.PencilFFTPlan(ptopo, (16, 12, 10), real=True,
                          method=pat.AllToAll(wire_dtype="bfloat16"))
    assert a.plan_key() == b.plan_key() and b.wire_dtype == "bf16"
    assert a.with_wire_dtype(None).plan_key() == pat.PencilFFTPlan(
        ptopo, (16, 12, 10), real=True).plan_key()
    assert a.with_wire_dtype("bf16") is a
    with pytest.raises(ValueError, match="already carries"):
        pat.PencilFFTPlan(ptopo, (16, 12, 10), real=True, wire_dtype="f16",
                          method=pat.Ring(wire_dtype="bf16"))
