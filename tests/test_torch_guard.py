"""PyTorch port vs JAX package: the runtime integrity guard
(``guard/``; the cases of ``tests/test_guard.py`` and the guard cases of
``tests/test_wire.py``).

* Guard off, a hop runs the unguarded code; guard on, the same hop
  between two probes: the same bits, the same hop calls, on 1, 2 and 4
  gloo ranks per method (bit-identical, no tolerance).
* The ``corrupt`` drills raise the typed ``IntegrityError`` on every rank
  with the guard on; with it off the poke lands on the JAX package's
  element of the padded global array (bits equal to JAX's poke).
* ``probes_match`` gives JAX's verdicts on the same probe pairs; probe
  values agree with JAX's (float64 accumulation there, the port's
  accumulator here) within the probe tolerance ``eps(acc) * (8 + 4 log2
  n) * (abs_sum + 1)``; exact dtypes wrap as JAX's int32 sum does.
* The watchdog, the crash bundle and ``guarded_step``'s ladder behave as
  the JAX package's tests pin them.
"""

import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pencilarrays_tpu as jpa
from pencilarrays_tpu import guard as jguard
from pencilarrays_tpu.guard import integrity as jgi
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch import guard, obs
from pencilarrays_tpu_torch.guard import (
    HangTimeoutError,
    IntegrityError,
    WirePrecisionError,
)
from pencilarrays_tpu_torch.guard import integrity as gi
from pencilarrays_tpu_torch.guard.watchdog import active_count
from pencilarrays_tpu_torch.interop import to_numpy_padded
from pencilarrays_tpu_torch.obs import events as obs_events
from pencilarrays_tpu_torch.obs import metrics as obs_metrics
from pencilarrays_tpu_torch.parallel import transpositions as tr
from pencilarrays_tpu_torch.parallel import wire
from pencilarrays_tpu_torch.resilience import (
    CheckpointManager,
    RetryPolicy,
    faults,
)


@pytest.fixture(autouse=True)
def _clean_guard(monkeypatch):
    for var in (guard.ENV_VAR, guard.DIR_VAR, guard.TIMEOUT_VAR,
                guard.RTOL_VAR, guard.FINITE_VAR, obs.ENV_VAR,
                faults.ENV_VAR, "PENCILARRAYS_TPU_GUARD_WIRE_RTOL"):
        monkeypatch.delenv(var, raising=False)
    guard._reset_for_tests()
    jguard._reset_for_tests()
    faults.clear()
    obs_events._reset_for_tests()
    obs_metrics.registry.reset()
    yield
    guard._reset_for_tests()
    jguard._reset_for_tests()
    faults.clear()
    obs_events._reset_for_tests()
    obs_metrics.registry.reset()


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _load_json(path):
    with open(path) as f:
        return json.load(f)


SHAPE = (11, 9, 13)


def _mk(shape=SHAPE, seed=0, perm=None):
    topo = pat.Topology((1, 1), device="cpu")
    pen_x = pat.Pencil(topo, shape, (1, 2))
    pen_y = pat.Pencil(topo, shape, (0, 2), permutation=perm)
    truth = np.random.default_rng(seed).standard_normal(shape)
    return pen_x, pen_y, truth, pat.PencilArray.from_global(pen_x, truth)


def _jax_pencils(devices, dims, shape, src, dest):
    topo = jpa.Topology(dims, devices=devices[:math.prod(dims)])

    def pen(spec):
        decomp, perm = spec
        return jpa.Pencil(topo, shape, decomp, permutation=None
                          if perm is None else jpa.Permutation(*perm))

    return pen(src), pen(dest)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


# -- gates and the disabled path ----------------------------------------------


def test_disabled_path_uses_unguarded_hop(monkeypatch):
    assert not guard.enabled()
    pen_x, pen_y, truth, u = _mk()
    calls = []
    orig = tr._dispatch_guarded_hop
    monkeypatch.setattr(tr, "_dispatch_guarded_hop",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    out = pat.transpose(u, pen_y)
    assert calls == []
    np.testing.assert_array_equal(pat.gather(out), truth)
    guard.enable()
    pat.transpose(u, pen_y)
    assert calls == [1]


def test_gate_re_read_on_change(monkeypatch, tmp_path):
    assert not guard.enabled()
    monkeypatch.setenv(guard.ENV_VAR, str(tmp_path / "b"))
    assert guard.enabled() and guard.bundle_dir() == str(tmp_path / "b")
    monkeypatch.setenv(guard.ENV_VAR, "0")
    assert not guard.enabled()
    monkeypatch.setenv(guard.ENV_VAR, "1")
    monkeypatch.setenv(guard.DIR_VAR, str(tmp_path / "d"))
    assert guard.bundle_dir() == str(tmp_path / "d") == jguard.bundle_dir()


def test_finite_tap_sampling_counter(monkeypatch):
    monkeypatch.setenv(guard.FINITE_VAR, "3")
    ticks = [guard.finite_tick() for _ in range(6)]
    assert ticks == [False, False, True, False, False, True]
    monkeypatch.delenv(guard.FINITE_VAR)
    assert guard.finite_tick() is False


# -- guarded hops: bits on 1, 2 and 4 ranks ------------------------------------

METHODS = [pat.AllToAll(), pat.Ring(), pat.Pipelined(chunks=2)]
GUARD_CASES = [
    ("1", (1,), (11, 9, 13), ((0,), None), ((1,), (2, 0, 1))),
    ("2", (2,), (11, 9, 13), ((0,), None), ((2,), (1, 2, 0))),
    ("2x2", (2, 2), (11, 9, 13), ((1, 2), None), ((0, 2), (2, 0, 1))),
]


@pytest.mark.parametrize("case", GUARD_CASES, ids=[c[0] for c in
                                                   GUARD_CASES])
def test_guarded_hop_bit_identical(case, pool, devices, tmp_path):
    """Guarded = unguarded bits and hop calls per method; the corrupt
    drill is typed on every rank; unguarded, the poke is JAX's."""
    _, dims, shape, src, dest = case
    u = np.random.default_rng(1).standard_normal(shape)
    got = pool.run(tasks.guard_hop_case, dims, shape, src, dest, u,
                   METHODS, str(tmp_path))[0]
    jin, jout = _jax_pencils(devices, dims, shape, src, dest)
    want = np.asarray(jpa.transpose(jpa.PencilArray.from_global(jin, u),
                                    jout).data)
    jpoked = np.asarray(jgi.corrupt_eager(jnp.asarray(want), 0))
    for m, r in zip(METHODS, got):
        assert np.array_equal(_bits(r["plain"]), _bits(want)), m
        assert np.array_equal(_bits(r["guarded"]), _bits(want)), m
        assert r["hops"][0] == r["hops"][1] == 1, m
        assert r["kinds"] == ["sum"] * math.prod(dims), m
        assert np.array_equal(_bits(r["poked"]), _bits(jpoked)), m


def test_guarded_route_bit_identical(pool, tmp_path):
    dims, shape = (2, 2), (12, 16, 8)
    src, dest = ((1, 2), None), ((2, 0), None)
    u = np.random.default_rng(5).standard_normal(shape)
    got = pool.run(tasks.guard_route_case, dims, shape, src, dest, u,
                   pat.AllToAll(), str(tmp_path))[0]
    assert np.array_equal(_bits(got["plain"]), _bits(got["guarded"]))
    assert got["kinds"] == ["sum"] * 4
    assert np.isnan(got["poked"]).sum() == 1


def test_guarded_exact_dtype_bit_for_bit(tmp_path):
    pen_x, pen_y, _, _ = _mk()
    vals = np.random.default_rng(3).integers(-2 ** 30, 2 ** 30, size=SHAPE,
                                             dtype=np.int32)
    u = pat.PencilArray.from_global(pen_x, vals)
    guard.enable(str(tmp_path / "bundles"))
    np.testing.assert_array_equal(pat.gather(pat.transpose(u, pen_y)), vals)


def test_guarded_passes_nan_through(tmp_path):
    pen_x, pen_y, truth, _ = _mk()
    vals = truth.copy()
    vals[0, 0, 0] = np.nan
    u = pat.PencilArray.from_global(pen_x, vals)
    guard.enable(str(tmp_path / "bundles"))
    out = pat.gather(pat.transpose(u, pen_y))
    assert np.isnan(out[0, 0, 0])
    np.testing.assert_array_equal(out[1:], vals[1:])


# -- corrupt drills -------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS, ids=str)
def test_corrupt_exchange_raises_typed_error(method, tmp_path):
    pen_x, pen_y, truth, u = _mk()
    guard.enable(str(tmp_path / "bundles"))
    with faults.active("hop.exchange:corrupt"):
        with pytest.raises(IntegrityError) as ei:
            pat.transpose(u, pen_y, method=method)
    e = ei.value
    assert e.kind == "sum" and e.hop and e.predicted and e.observed
    assert e.bundle and os.path.isdir(e.bundle)
    mf = _load_json(os.path.join(e.bundle, "MANIFEST.json"))
    assert mf["reason"] == "sdc" and mf["format"] == \
        "pencilarrays-tpu-crash-bundle"
    assert set(mf["versions"]) == {"python", "torch", "cuda", "numpy"}
    assert os.path.exists(os.path.join(e.bundle, "stacks.txt"))
    _load_json(os.path.join(e.bundle, "metrics.json"))


def test_corrupt_exchange_unguarded_is_silent_garbage():
    pen_x, pen_y, truth, u = _mk()
    assert not guard.enabled()
    with faults.active("hop.exchange:corrupt"):
        out = pat.gather(pat.transpose(u, pen_y))
    assert not np.array_equal(out, truth) and np.isnan(out).sum() == 1


def test_corrupt_counter_addressing(tmp_path):
    pen_x, pen_y, truth, u = _mk()
    guard.enable(str(tmp_path / "bundles"))
    with faults.active("hop.exchange:corrupt@2"):
        np.testing.assert_array_equal(pat.gather(pat.transpose(u, pen_y)),
                                      truth)
        with pytest.raises(IntegrityError):
            pat.transpose(u, pen_y)


def test_corrupt_routed_reshard_raises_typed_error(tmp_path):
    topo = pat.Topology((1, 1), device="cpu")
    shape = (12, 16, 8)
    src = pat.Pencil(topo, shape, (1, 2))
    dst = pat.Pencil(topo, shape, (2, 0))
    truth = np.random.default_rng(5).standard_normal(shape)
    u = pat.PencilArray.from_global(src, truth)
    np.testing.assert_array_equal(pat.gather(pat.reshard(u, dst)), truth)
    guard.enable(str(tmp_path / "bundles"))
    for method in (pat.Auto(), pat.AllToAll()):   # Gspmd's and a route
        np.testing.assert_array_equal(
            pat.gather(pat.reshard(u, dst, method=method)), truth)
        with faults.active("hop.exchange:corrupt"):
            with pytest.raises(IntegrityError) as ei:
                pat.reshard(u, dst, method=method)
        assert ei.value.kind == "sum"
        faults.clear()


def test_corrupt_local_permute_hop_raises_typed_error(tmp_path):
    pen_x, pen_b, truth, u = _mk(perm=None)
    pen_b = pen_x.replace(permutation=pat.Permutation(2, 0, 1))
    guard.enable(str(tmp_path / "bundles"))
    np.testing.assert_array_equal(pat.gather(pat.transpose(u, pen_b)), truth)
    with faults.active("hop.exchange:corrupt"):
        with pytest.raises(IntegrityError):
            pat.transpose(u, pen_b)


def test_corrupt_reshard_fires_same_counter_guard_on_or_off():
    topo = pat.Topology((1, 1), device="cpu")
    shape = (12, 16, 8)
    src = pat.Pencil(topo, shape, (1, 2))
    dst = pat.Pencil(topo, shape, (2, 0))
    truth = np.random.default_rng(5).standard_normal(shape)
    u = pat.PencilArray.from_global(src, truth)
    with faults.active("hop.exchange:corrupt@1"):
        bad = pat.gather(pat.reshard(u, dst, method=pat.AllToAll()))
    assert np.isnan(bad).sum() == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.int32, np.uint8, np.bool_, np.int64])
def test_corrupt_block_matches_jax(dtype):
    x = np.arange(24).reshape(4, 6).astype(dtype)
    for hit in (0, 7, 23, 31):
        want = np.asarray(jgi.corrupt_eager(jnp.asarray(x), hit))
        a = gi.corrupt_eager(torch.from_numpy(x.copy()), hit).numpy()
        b = gi.corrupt_eager(torch.from_numpy(x.copy()), hit).numpy()
        assert np.array_equal(_bits(a), _bits(want)), hit
        assert np.array_equal(_bits(a), _bits(b))


def test_corrupt_array_addresses_the_global_element(devices):
    """On a PencilArray the poke lands on element ``hit % size`` of the
    flat padded global array (memory order, extra dims last): JAX's."""
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, SHAPE, (1, 2), permutation=pat.Permutation(2, 0, 1))
    u = np.random.default_rng(2).standard_normal(SHAPE + (2,))
    x = pat.PencilArray.from_global(pen, u)
    jt = jpa.Topology((1, 1), devices=devices[:1])
    jx = jpa.PencilArray.from_global(
        jpa.Pencil(jt, SHAPE, (1, 2), permutation=jpa.Permutation(2, 0, 1)),
        u)
    gi.corrupt_eager(x, 100)
    want = np.asarray(jgi.corrupt_eager(jx.data, 100))
    assert np.array_equal(_bits(to_numpy_padded(x)), _bits(want))


def test_corrupt_mode_parse():
    (r,) = faults.parse("hop.exchange:corrupt@2")
    assert r.mode == "corrupt" and r.first == 2 and r.times is None
    (r2,) = faults.parse("ckpt.restore:corrupt*3")
    assert r2.times == 3
    with pytest.raises(ValueError):
        faults.parse("hop.exchange:explode")


def test_ckpt_restore_corrupt_drill(tmp_path, devices):
    """The ``ckpt.restore`` point pokes the restored dataset: the
    restored array differs from the committed truth at exactly the
    element JAX's drill pokes (hit 1: flat index 0 of the padded global
    array)."""
    topo = pat.Topology((1,), device="cpu")
    pen = pat.Pencil(topo, SHAPE, (1,))
    truth = np.random.default_rng(7).standard_normal(SHAPE)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    mgr.save(1, {"u": pat.PencilArray.from_global(pen, truth)})
    clean = pat.gather(mgr.restore().read("u", pen))
    np.testing.assert_array_equal(clean, truth)
    with faults.active("ckpt.restore:corrupt"):
        poked = mgr.restore().read("u", pen)
    assert np.isnan(pat.gather(poked)).sum() == 1
    jpen = jpa.Pencil(jpa.Topology((1,), devices=devices[:1]), SHAPE, (1,))
    want = jgi.corrupt_eager(jpa.PencilArray.from_global(jpen, truth).data, 0)
    assert np.array_equal(_bits(to_numpy_padded(poked)),
                          _bits(np.asarray(want)))


# -- probes ---------------------------------------------------------------------


def _jax_probe(x):
    return np.asarray(jgi.probe_stats(jnp.asarray(x)), np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
def test_probe_values_match_jax_within_tolerance(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 33, 5))
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(x.shape)
    x = x.astype(dtype)
    mine = gi.reduce_probes([gi.probe_stats(torch.from_numpy(x), True)],
                            torch.from_numpy(x).dtype)[0]
    want = _jax_probe(x)
    tol = gi._default_rtol(x.size, dtype) * (abs(want[2]) + 1.0)
    assert np.all(np.abs(mine[:3] - want[:3]) <= tol), (mine, want, tol)
    assert mine[3] == 0.0
    x.reshape(-1)[5] = np.nan
    assert gi.reduce_probes([gi.probe_stats(torch.from_numpy(x), True)],
                            torch.from_numpy(x).dtype)[0][3] == 1.0


def test_exact_probes_wrap_as_int32():
    x = np.full(4096, 2 ** 30, dtype=np.int32)
    mine = gi.reduce_probes([gi.probe_stats(torch.from_numpy(x))],
                            torch.int32)[0]
    wrapped = int(np.sum(x, dtype=np.int32))     # numpy's int32 wrap
    assert mine[0] == wrapped == 0 and mine[2] == 0
    small = np.arange(-50, 50, dtype=np.int16)
    mine = gi.reduce_probes([gi.probe_stats(torch.from_numpy(small))],
                            torch.int16)[0]
    assert list(mine[:3]) == list(_jax_probe(small)[:3])


def test_probes_match_verdicts_match_jax(monkeypatch):
    """Both packages' verdicts on the same probe pairs: float64 data
    (both accumulate in float64), every dtype under the shared
    ``PENCILARRAYS_TPU_GUARD_RTOL`` override, and the wire formats."""
    rng = np.random.default_rng(0)
    p = np.array([10.0, -3.0, 500.0, 0.0])
    pairs = [(p, p), (p, p + [1e-13, 0, 0, 0]), (p, p + [1e-3, 0, 0, 0]),
             (p, [np.nan, -3.0, 500.0, 0.0]),
             ([np.nan, -3, 500, 0], [np.nan, -3, 500, 0]),
             (p, [np.inf, -3.0, 500.0, 0.0]), (p, p + [0, 0, 0, 1]),
             (p, p + [0.5, 0, 0, 0])]
    pairs += [(p, p + rng.normal(0, s, 4) * [1, 1, 1, 0])
              for s in (1e-12, 1e-6, 1e-2, 1.0)]
    for count in (10, 4096, 10 ** 9):
        for pre, post in pairs:
            for finite in (False, True):
                for wire_dtype in (None, "bf16", "fp8_e4m3"):
                    kw = dict(finite=finite, wire_dtype=wire_dtype)
                    assert gi.probes_match(pre, post, count, np.float64,
                                           **kw) == \
                        jgi.probes_match(pre, post, count, np.float64, **kw)
    monkeypatch.setenv(guard.RTOL_VAR, "1e-5")
    for dtype in (np.float32, np.complex64, np.int32):
        for pre, post in pairs:
            assert gi.probes_match(pre, post, 4096, dtype) == \
                jgi.probes_match(pre, post, 4096, dtype), (dtype, post)


def test_probe_tolerance_semantics():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000))
    p = gi.reduce_probes([gi.probe_stats(x)], x.dtype)[0]
    assert gi.probes_match(p, p, 1000, np.float64)[0]
    q = p.copy()
    q[0] += abs(q[2]) * 1e-14
    assert gi.probes_match(p, q, 1000, np.float64)[0]
    q2 = p.copy()
    q2[0] += abs(q2[2]) * 1e-3
    assert not gi.probes_match(p, q2, 1000, np.float64)[0]
    qn = p.copy()
    qn[0] = np.nan
    assert not gi.probes_match(p, qn, 1000, np.float64)[0]
    assert gi.probes_match(qn, qn, 1000, np.float64)[0]
    pi = gi.reduce_probes([gi.probe_stats(torch.arange(10, dtype=torch.int32))],
                          torch.int32)[0]
    qi = pi.copy()
    qi[0] += 1.0
    assert not gi.probes_match(pi, qi, 10, np.int32)[0]


# -- wires ----------------------------------------------------------------------


def test_guarded_wire_hop_passes_and_full_precision_detects(tmp_path):
    topo = pat.Topology((1, 1), device="cpu")
    pin = pat.Pencil(topo, (16, 12, 20), (1, 2))
    pout = pat.Pencil(topo, (16, 12, 20), (0, 2))
    u = np.random.default_rng(6).standard_normal((16, 12, 20)).astype(
        np.float32)
    x = pat.PencilArray.from_global(pin, u)
    guard.enable(str(tmp_path))
    y = pat.transpose(x, pout, method=pat.AllToAll(wire_dtype="bf16"))
    np.testing.assert_allclose(pat.gather(y), u, atol=0.02)
    np.testing.assert_array_equal(pat.gather(pat.transpose(x, pout)), u)
    out = pat.reshard(x, pat.Pencil(topo, (16, 12, 20), (0, 1)),
                      method=pat.AllToAll(wire_dtype="bf16"))
    np.testing.assert_allclose(pat.gather(out), u, atol=0.02)


def test_wire_override_far_below_quantization_raises(monkeypatch, tmp_path):
    """A wire-rtol override far below the bf16 quantization: the wired
    hop fails typed, journals ``guard.sdc`` with ``kind="wire"`` and
    writes a bundle."""
    topo = pat.Topology((1, 1), device="cpu")
    pin = pat.Pencil(topo, (16, 12, 20), (1, 2))
    pout = pat.Pencil(topo, (16, 12, 20), (0, 2))
    u = np.random.default_rng(6).standard_normal((16, 12, 20)).astype(
        np.float32)
    x = pat.PencilArray.from_global(pin, u)
    monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_WIRE_RTOL", "1e-9")
    obs.enable(str(tmp_path / "obs"))
    guard.enable(str(tmp_path / "bundles"))
    with pytest.raises(WirePrecisionError) as ei:
        pat.transpose(x, pout, method=pat.AllToAll(wire_dtype="bf16"))
    assert ei.value.wire_dtype == "bf16" and ei.value.kind == "wire"
    assert ei.value.bundle and os.path.isdir(ei.value.bundle)
    sdc = [e for e in obs.read_journal() if e["ev"] == "guard.sdc"]
    assert [e["kind"] for e in sdc] == ["wire"]
    assert obs.lint_journal(obs.read_journal()) == []


def test_wire_drift_beyond_model_raises_typed(monkeypatch, tmp_path):
    monkeypatch.setenv(guard.DIR_VAR, str(tmp_path))    # its bundle
    pre = np.array([100.0, 0.0, 1000.0, 0.0])
    drift = np.array([120.0, 0.0, 1000.0, 0.0])
    assert gi.probes_match(pre, drift, 1000, np.float32,
                           wire_dtype="bf16") == (False, "wire")
    with pytest.raises(WirePrecisionError) as ei:
        gi.check_hop_probes("hop", pre, drift, 1000, np.float32,
                            wire_dtype="bf16")
    assert ei.value.wire_dtype == "bf16"
    assert isinstance(ei.value, IntegrityError)


def test_wire_tolerance_widens_only_wire_hops():
    pre = np.array([100.0, 0.0, 1000.0, 0.0])
    small = np.array([101.0, 0.0, 1000.0, 0.0])
    assert gi.probes_match(pre, small, 1000, np.float32,
                           wire_dtype="bf16") == (True, "ok")
    assert gi.probes_match(pre, small, 1000, np.float32) == (False, "sum")
    bigger = np.array([110.0, 0.0, 1000.0, 0.0])
    assert gi.probes_match(pre, bigger, 1000, np.float32,
                           wire_dtype="bf16", wire_hops=1)[0] is False
    assert gi.probes_match(pre, bigger, 1000, np.float32,
                           wire_dtype="bf16", wire_hops=4)[0] is True


def test_wire_rtol_env_override(monkeypatch):
    assert wire.wire_rtol(None, 100) == 0.0
    base = wire.wire_rtol("bf16", 100)
    assert 2.0 ** -9 <= base <= 2.0 ** -6
    monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_WIRE_RTOL", "0.25")
    assert wire.wire_rtol("bf16", 100) == 0.25
    monkeypatch.delenv("PENCILARRAYS_TPU_GUARD_WIRE_RTOL")
    assert wire.wire_rtol("bf16", 100) == base


# -- the finiteness tap -----------------------------------------------------------


def test_finite_tap_catches_nonfinite_birth(monkeypatch, tmp_path):
    monkeypatch.setenv(guard.FINITE_VAR, "1")
    topo = pat.Topology((1,), device="cpu")
    plan = pat.PencilFFTPlan(topo, (16, 16, 16), real=True,
                             dtype=torch.float32)
    u = plan.allocate_input()
    u.data.fill_(1e37)
    guard.enable(str(tmp_path / "bundles"))
    with pytest.raises(IntegrityError) as ei:
        plan.forward(u)
    assert ei.value.kind == "nonfinite"
    u.data.fill_(1.0)
    plan.forward(u)


# -- the watchdog ---------------------------------------------------------------


def test_watchdog_fires_on_held_lock(tmp_path):
    guard.enable(str(tmp_path / "bundles"))
    held = threading.Lock()
    held.acquire()
    with pytest.raises(HangTimeoutError) as ei:
        with guard.watchdog("test-hold", timeout=0.4, kind="test"):
            held.acquire()
    e = ei.value
    assert e.label == "test-hold" and e.timeout_s == pytest.approx(0.4)
    assert e.bundle and os.path.isdir(e.bundle)
    mf = _load_json(os.path.join(e.bundle, "MANIFEST.json"))
    assert mf["reason"] == "hang" and mf["label"] == "test-hold"
    assert mf["artifacts"]["stacks"] == "ok"
    with open(os.path.join(e.bundle, "stacks.txt")) as f:
        assert "test_watchdog_fires_on_held_lock" in f.read()
    _load_json(os.path.join(e.bundle, "metrics.json"))
    assert active_count() == 0


def test_watchdog_noop_when_disabled():
    assert not guard.enabled()
    with guard.watchdog("never-armed", timeout=0.05):
        time.sleep(0.15)
    assert active_count() == 0


def test_watchdog_completes_under_deadline(tmp_path):
    guard.enable(str(tmp_path / "bundles"))
    with guard.watchdog("fast", timeout=30.0):
        x = sum(range(100))
    assert x == 4950
    assert not os.path.exists(str(tmp_path / "bundles"))


def test_watchdog_wraps_distributed_initialize(tmp_path, monkeypatch):
    import torch.distributed as dist

    from pencilarrays_tpu_torch.parallel import distributed
    from pencilarrays_tpu_torch.resilience.errors import RetryDeadlineExceeded

    assert not dist.is_initialized()
    guard.enable(str(tmp_path / "bundles"))
    monkeypatch.setenv(guard.TIMEOUT_VAR, "0.4")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: time.sleep(30))
    with pytest.raises((HangTimeoutError, RetryDeadlineExceeded)):
        distributed.initialize("gloo", retry=RetryPolicy(max_attempts=1,
                                                         deadline=5.0))
    assert not dist.is_initialized()
    assert len(os.listdir(str(tmp_path / "bundles"))) == 1


def test_hop_delay_past_the_deadline_raises(monkeypatch, tmp_path):
    """``hop.exchange:delay`` longer than a short watchdog deadline,
    under ``guarded_step``: a typed ``HangTimeoutError`` with a bundle
    (not a recoverable integrity error: it propagates)."""
    pen_x, pen_y, truth, u = _mk()
    guard.enable(str(tmp_path / "bundles"))
    monkeypatch.setenv(faults.DELAY_S_VAR, "3")
    monkeypatch.setenv(guard.TIMEOUT_VAR, "0.3")
    t0 = time.monotonic()
    with faults.active("hop.exchange:delay"):
        with pytest.raises(HangTimeoutError) as ei:
            guard.guarded_step(lambda: pat.transpose(u, pen_y),
                               label="hang-drill")
    assert time.monotonic() - t0 < 2.5
    assert ei.value.bundle and ei.value.label == "hang-drill"


# -- guarded_step -----------------------------------------------------------------


def test_guarded_step_retries_then_succeeds(tmp_path):
    pen_x, pen_y, truth, u = _mk()
    guard.enable(str(tmp_path / "bundles"))
    with faults.active("hop.exchange:corrupt*1"):
        out = guard.guarded_step(
            lambda: pat.transpose(u, pen_y),
            retry=RetryPolicy(max_attempts=3, base_delay=0.01),
            label="retry-drill")
    np.testing.assert_array_equal(pat.gather(out), truth)


def _restore_setup(tmp_path):
    pen_x, pen_y, truth, u = _mk()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = {"u": u}
    mgr.save(1, {"u": u})
    state["u"] = pat.PencilArray.from_global(pen_x, truth + 1000.0)
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        return pat.transpose(state["u"], pen_y)

    def restore(ckpt):
        state["u"] = ckpt.read("u", pen_x)

    return truth, mgr, step, restore, calls


def test_guarded_step_escalates_to_checkpoint_restore(tmp_path):
    obs.enable(str(tmp_path / "obs"))
    guard.enable(str(tmp_path / "bundles"))
    truth, mgr, step, restore, _ = _restore_setup(tmp_path)
    with faults.active("hop.exchange:corrupt*2"):
        out = guard.guarded_step(
            step, ckpt_mgr=mgr, restore=restore,
            retry=RetryPolicy(max_attempts=2, base_delay=0.01),
            label="escalate-drill")
    np.testing.assert_array_equal(pat.gather(out), truth)
    events = obs.read_journal(str(tmp_path / "obs"))
    assert obs.lint_journal(events) == []
    stages = [e["stage"] for e in events if e["ev"] == "guard.recover"]
    assert stages[0] == "error"
    assert "restore" in stages and stages[-1] == "recovered"
    assert {e["ev"] for e in events} >= {"guard.sdc", "guard.recover",
                                         "ckpt.restore"}


def test_guarded_step_reraises_without_checkpoint(tmp_path):
    pen_x, pen_y, truth, u = _mk()
    guard.enable(str(tmp_path / "bundles"))
    with faults.active("hop.exchange:corrupt"):
        with pytest.raises(IntegrityError):
            guard.guarded_step(
                lambda: pat.transpose(u, pen_y),
                retry=RetryPolicy(max_attempts=2, base_delay=0.01),
                label="no-ckpt-drill")


def test_guarded_step_passthrough_other_errors(tmp_path):
    guard.enable(str(tmp_path / "bundles"))
    with pytest.raises(ZeroDivisionError):
        guard.guarded_step(lambda: 1 // 0,
                           retry=RetryPolicy(max_attempts=3))


def test_guarded_step_deadline_escalates_immediately(tmp_path):
    obs.enable(str(tmp_path / "obs"))
    guard.enable(str(tmp_path / "bundles"))
    truth, mgr, step, restore, calls = _restore_setup(tmp_path)
    t0 = time.monotonic()
    with faults.active("hop.exchange:corrupt*1"):
        out = guard.guarded_step(
            step, ckpt_mgr=mgr, restore=restore,
            retry=RetryPolicy(max_attempts=5, base_delay=10.0,
                              max_delay=10.0, deadline=0.05),
            label="deadline-drill")
    assert time.monotonic() - t0 < 8.0
    assert calls["n"] == 2
    np.testing.assert_array_equal(pat.gather(out), truth)
    events = obs.read_journal(str(tmp_path / "obs"))
    assert obs.lint_journal(events) == []
    assert [e["stage"] for e in events if e["ev"] == "guard.recover"] == [
        "error", "restore", "recovered"]


def test_guarded_step_deadline_reraise_without_checkpoint(tmp_path):
    guard.enable(str(tmp_path / "bundles"))
    pen_x, pen_y, truth, u = _mk()
    t0 = time.monotonic()
    with faults.active("hop.exchange:corrupt*5"):
        with pytest.raises(IntegrityError):
            guard.guarded_step(
                lambda: pat.transpose(u, pen_y),
                retry=RetryPolicy(max_attempts=5, base_delay=10.0,
                                  max_delay=10.0, deadline=0.05),
                label="deadline-reraise")
    assert time.monotonic() - t0 < 8.0


def test_guarded_step_deadline_accounts_for_jitter(tmp_path, monkeypatch):
    import random as _random

    guard.enable(str(tmp_path / "bundles"))
    pen_x, pen_y, truth, u = _mk()
    policy = RetryPolicy(max_attempts=2, base_delay=1.0, max_delay=1.0,
                         deadline=1.2, jitter=0.25)
    monkeypatch.setattr(_random, "random", lambda: 1.0)
    t0 = time.monotonic()
    with faults.active("hop.exchange:corrupt*1"):
        with pytest.raises(IntegrityError):
            guard.guarded_step(lambda: pat.transpose(u, pen_y),
                               retry=policy, label="jitter-over")
    assert time.monotonic() - t0 < 0.7
    faults.reset_counters()
    monkeypatch.setattr(_random, "random", lambda: 0.0)
    with faults.active("hop.exchange:corrupt*1"):
        out = guard.guarded_step(lambda: pat.transpose(u, pen_y),
                                 retry=policy, label="jitter-under")
    np.testing.assert_array_equal(pat.gather(out), truth)


def test_delay_for_jitter_bounds():
    policy = RetryPolicy(base_delay=0.1, max_delay=1.0, jitter=0.25)
    for attempt in range(1, 9):
        nominal = min(0.1 * 2 ** (attempt - 1), 1.0)
        for _ in range(50):
            d = policy.delay_for(attempt)
            assert nominal * 0.75 - 1e-12 <= d <= nominal * 1.25 + 1e-12


def test_mesh_ladder_and_elastic_wait_for_the_cluster_layer(monkeypatch,
                                                            tmp_path):
    """The cluster layer is ported: off, or armed on one rank, both ladders
    degrade to the local one; armed at world 2 the env-built coordinator
    runs the mesh ladder with a peer over the same FileKV (an agreed
    retry of the peer's failure, both ranks rerun), and elastic_step with
    its gate off is that ladder."""
    from pencilarrays_tpu_torch import cluster
    from pencilarrays_tpu_torch.cluster.consensus import Coordinator
    from pencilarrays_tpu_torch.cluster.kv import FileKV

    for var in (cluster.ENV_VAR, cluster.RANK_VAR, cluster.WORLD_VAR):
        monkeypatch.delenv(var, raising=False)
    cluster._reset_for_tests()
    try:
        assert cluster.coordinator() is None            # layer off
        kvdir = str(tmp_path / "kv")
        monkeypatch.setenv(cluster.ENV_VAR, kvdir)
        assert cluster.coordinator() is None            # one rank
        assert guard.guarded_step(lambda: 1) == 1
        assert guard.elastic_step(lambda: 2) == 2
        monkeypatch.setenv(cluster.RANK_VAR, "0")
        monkeypatch.setenv(cluster.WORLD_VAR, "2")
        c0 = cluster.coordinator()
        assert (c0.rank, c0.world) == (0, 2)
        assert cluster.coordinator() is c0              # cached
        c1 = Coordinator(FileKV(kvdir), 1, 2, lease_ttl=15.0,
                         verdict_timeout=30.0)
        calls = {0: 0, 1: 0}
        out = {}

        def peer():
            def step():
                calls[1] += 1
                if calls[1] == 1:
                    raise IntegrityError("sdc", hop="t", kind="sum")
                return "peer"
            out[1] = guard.guarded_step(
                step, retry=RetryPolicy(max_attempts=2, base_delay=0.01),
                label="env-mesh", coordinator=c1)

        t = threading.Thread(target=peer)
        t.start()

        def mine():
            calls[0] += 1
            return "env"
        out[0] = guard.elastic_step(
            mine, retry=RetryPolicy(max_attempts=2, base_delay=0.01),
            label="env-mesh")
        t.join(60)
        c1.shutdown()
        assert out == {0: "env", 1: "peer"} and calls == {0: 2, 1: 2}
        cluster.disable()
        assert cluster.coordinator() is None            # programmatic off
    finally:
        cluster._reset_for_tests()


# -- journaling and bundles ---------------------------------------------------------


def test_guard_events_schema_and_counters(tmp_path):
    from pencilarrays_tpu.obs import schema as jax_schema

    obs.enable(str(tmp_path / "obs"))
    guard.enable(str(tmp_path / "bundles"))
    pen_x, pen_y, truth, u = _mk()
    pat.transpose(u, pen_y)
    with faults.active("hop.exchange:corrupt"):
        with pytest.raises(IntegrityError):
            pat.transpose(u, pen_y)
    events = obs.read_journal(str(tmp_path / "obs"))
    assert obs.lint_journal(events) == []
    assert jax_schema.lint_journal(str(tmp_path / "obs")) == []
    assert {"guard.sdc", "guard.bundle", "hop"} <= {e["ev"] for e in events}
    checks = {k: v for k, v in obs.snapshot()["counters"].items()
              if k.startswith("guard.checks")}
    assert checks.get("guard.checks{outcome=ok}", 0) >= 1
    assert checks.get("guard.checks{outcome=sum}", 0) >= 1


def test_bundle_contains_plan_fingerprints(tmp_path):
    guard.enable(str(tmp_path / "bundles"))
    topo = pat.Topology((1, 1), device="cpu")
    plan = pat.PencilFFTPlan(topo, (8, 8, 8), dtype=torch.complex64)
    path = guard.write_crash_bundle("test", "unit")
    plans = _load_json(os.path.join(path, "plans.json"))
    assert any(p["kind"] == "fft_plan" for p in plans)
    fp = next(p for p in plans if p["kind"] == "fft_plan")
    assert fp["schedule_sha256"].startswith(plan.plan_key())
    assert _load_json(os.path.join(path, "MANIFEST.json"))["reason"] == "test"
