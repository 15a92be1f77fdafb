"""Each driver with its reference at small sizes on the CPU: the program
passes its check, the check's bfloat16 control fails it, and the
pieces the check rests on (the seeded flow, the layouts, the trace
reduction, the metric readers) do what they state."""

import time

import numpy as np
import pytest
import torch

from pabench import fields, harness, profile_reduce
from pabench.reference import ns_step

CELLS = ["ns512.rk2", "ns512.fft_rt", "cycle1024.alltoall", "cycle1024.ring"]
SMALL = {"ns512_f32": [16, 12, 10], "pencil1024_f32": [12, 10, 8]}


def small_cell(name, grid=None):
    wl, cfg = harness.find_cell(name)
    return wl, dict(cfg, grid=grid or SMALL[cfg["name"]])


def run_small(name, seed, control=False, trace=False, grid=None):
    wl, cfg = small_cell(name, grid)
    return harness.run_cell(wl, cfg, seed, 0.2, trace, "cpu",
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 11, 2**40 + 3])
def test_program_passes_its_check(name, seed):
    r = run_small(name, seed)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"step_ms", "peak_hbm_gib", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_check(name):
    r = run_small(name, 2**31 + 99, control=True)
    assert r["correct"] is False
    ratio = min(c["value"] / c["limit"] if c["limit"] else float("inf")
                for c in r["checks"].values())
    assert ratio > 10, r["checks"]


@pytest.mark.parametrize("name", ["ns512.rk2", "cycle1024.alltoall"])
def test_traced_run_reports_per_layer_metrics_and_breakdown(name):
    r = run_small(name, 5, trace=True)
    assert r["correct"] is True
    assert "step_ms" not in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert list(r)[-1] == "checks"


def test_same_seed_same_inputs_other_seed_other_inputs():
    shape = (12, 10, 8)
    kw = dict(k_peak=2.0, k_max=4.0, u_max=1.0)
    a = fields.solenoidal_spectrum(shape, fields.generator(3, "cpu"), **kw)
    b = fields.solenoidal_spectrum(shape, fields.generator(3, "cpu"), **kw)
    c = fields.solenoidal_spectrum(shape, fields.generator(4, "cpu"), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_seeded_flow_is_real_solenoidal_and_scaled():
    shape = (16, 12, 10)
    uh = fields.solenoidal_spectrum(shape, fields.generator(2**35, "cpu"),
                                    k_peak=2.0, k_max=4.0, u_max=1.0)
    kx, ky, kz = fields.mode_numbers(shape, "cpu", torch.float32)
    div = (uh[0] * kx + uh[1] * ky + uh[2] * kz).abs().max()
    assert div < 1e-5 * uh.abs().max() * 4
    u = fields.irfft3(uh, shape[0])
    assert abs(float(u.square().sum(0).max().sqrt()) - 1.0) < 1e-5
    # a real field: transforming back and forth changes nothing
    assert torch.allclose(fields.rfft3(u), uh, atol=1e-5 * float(
        uh.abs().max()))
    assert float(uh[:, 0, 0, 0].abs().max()) == 0.0


def test_layouts_round_trip_and_match_a_plain_permute():
    ref = torch.arange(3 * 4 * 5 * 6.0).reshape(3, 4, 5, 6)
    for order in ([1, 2, 0], [0, 2, 1], [0, 1, 2], [2, 0, 1]):
        mem = fields.to_memory(ref, order)
        assert mem.shape == (*[ref.shape[1 + d] for d in order], 3)
        assert torch.equal(fields.from_memory(mem, order), ref)
        assert torch.equal(fields.logical_view(mem[..., 0], order), ref[0])


def test_reference_step_keeps_a_single_mode_exact():
    """A single Fourier mode is a steady Euler flow (``u x omega`` is a
    gradient, which the projection removes), so the step only decays it
    by the viscous factor."""
    shape = (16, 16, 16)
    uh = torch.zeros((3, 9, 16, 16), dtype=torch.complex128)
    uh[0, 0, 1, 0] = 8.0
    uh[0, 0, -1, 0] = 8.0
    ops = ns_step.Operators(shape, "cpu", torch.float64)
    out = ns_step.step(uh, ops, 0.01, 5e-3)
    assert torch.allclose(out, uh * np.exp(-0.01 * 5e-3), atol=1e-12)


def test_trace_reduction_merges_overlaps_and_names_gaps():
    device = [("k_a", 100, 50), ("k_b", 120, 60), ("k_c", 300, 20),
              ("k_a", 400, 10)]
    host = [(profile_reduce.WINDOW_SPAN, 50, 400),
            ("aten::stack", 185, 100), ("cudaLaunchKernel", 200, 10)]
    lo, hi = profile_reduce.window_bounds(host)
    iv = profile_reduce.merged(device, lo, hi)
    assert iv.tolist() == [[100, 180], [300, 320], [400, 410]]
    assert profile_reduce.busy_ns(iv) == 110
    gaps = profile_reduce.idle_gaps(iv, host, lo, hi)
    assert gaps[0] == ["aten::stack", 120 / 1e9]          # 180..300
    assert [g[1] for g in gaps] == [120e-9, 80e-9, 50e-9, 40e-9]
    assert profile_reduce.device_ops(device) == [
        ["k_a", 60e-9], ["k_b", 60e-9], ["k_c", 20e-9]]
    groups = profile_reduce.kernel_groups()
    assert profile_reduce.group_of("void permute_narrow_kernel<>", groups) \
        == "k1_permute"
    assert profile_reduce.group_of("Memcpy DtoD (Device -> Device)",
                                   groups) == "exchange"
    assert profile_reduce.group_of("regular_fft<512u>", groups) == "cufft"


def _window(**kw):
    base = dict(steps=10, seconds=1.0, span_s=1.0, busy_s=0.9,
                group_s={"k1_permute": 0.2, "exchange": 0.1, "cufft": 0.3,
                         "elementwise": 0.1, "stack_cat": 0.05},
                counters={"k1_bytes": 10**11, "exchange_calls.all-to-all": 4},
                transpose_bytes=None, peaks=harness.peaks())
    base.update(kw)
    return harness.Window(**base)


def test_metric_readers_compute_from_the_window():
    r = harness.metric_readers()
    w = _window()
    assert r["elementwise_ms"].read(w) == pytest.approx(15.0)
    assert r["cufft_ms"].read(w) == pytest.approx(30.0)
    assert r["exchange_ms"].read(w) == pytest.approx(10.0)
    assert r["k1_roofline_pct"].read(w) == pytest.approx(
        100 * (1e11 / 3.35e12) / 0.2)
    assert r["device_idle_pct"].read(w) == pytest.approx(10.0)
    assert r["transpose_roofline_pct"].read(w) is None
    w = _window(transpose_bytes=10**10)
    assert r["transpose_roofline_pct"].read(w) == pytest.approx(
        100 * (1e10 / 3.35e12) / 0.1)


def test_metric_readers_find_nothing_where_nothing_ran():
    r = harness.metric_readers()
    w = _window(group_s={}, busy_s=0.0,
                counters={"k1_bytes": 0, "exchange_calls.all-to-all": 0})
    assert all(m.read(w) is None for m in r.values())
    w = _window(counters={"k1_bytes": 10**11,
                          "exchange_calls.all-to-all": 0})
    assert r["exchange_ms"].read(w) is None
