"""PyTorch port vs JAX package: SLOs, load shedding, the autoscaler
(``serve/slo.py``, ``shed.py``, ``autoscale.py``).

Every case of the JAX package's ``tests/test_slo.py`` (but the autoscale
bench smoke: its benchmark is not ported), and the burn-rate cases of
``tests/test_requestflow.py`` (the monitor's validation and a real
coalesced batch sharing one dispatch).  Pure-Python cases run the same
script through both packages and compare what it returns (decisions,
transitions, projections, records without clocks); cases with plans run
as scenarios of ``tests/torch_serve_scenarios.py`` through both packages
(``tests/torch_serve_parity.py``: the JAX service on its CPU mesh, the
port on one rank in this process and on two ranks of the shared gloo
pool), FFT results within 2e-5 of the reference's largest magnitude and
everything else equal.
"""

import json

import pytest

from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift
from torch_serve_parity import both
from torch_serve_scenarios import SPkg, VOLATILE

ONE = (1, 1)


@pytest.fixture(autouse=True)
def _hermetic_drift():
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()
    yield
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()


def _both(script, tmp_path=None):
    """``script(P, d)`` through each package from a clean state (``d`` a
    directory of the run's own); the two results must be equal."""
    out = {}
    for which in ("jax", "torch"):
        P = SPkg(which)
        d = None
        if tmp_path is not None:
            d = tmp_path / which
            d.mkdir()
        P.reset()
        try:
            out[which] = json.loads(json.dumps(script(P, d), default=str))
        finally:
            P.reset()
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _records(P, d, ev):
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in P.events.read_journal(str(d)) if e["ev"] == ev]


# -- the SLO declaration + projection plumbing --------------------------------

def test_slo_validation():
    def script(P, _):
        SLO = P.serve.SLO
        SLO()
        SLO(deadline_s=1.0, p99_budget_s=2.0, shed_priority=3)
        out = []
        for bad in (dict(deadline_s=0.0), dict(p99_budget_s=-1.0)):
            with pytest.raises(ValueError) as ei:
                SLO(**bad)
            out.append(str(ei.value))
        with pytest.raises(TypeError) as ei:
            P.serve.PlanService(slos={"t": "not-an-slo"})
        out.append(str(ei.value))
        return out

    _both(script)


def test_load_tracker_projection_arithmetic():
    def script(P, _):
        lt = P.slo.LoadTracker()
        out = [lt.rate_bytes_per_s(), lt.projected_wait_s()]
        lt.note_arrival(1000)
        lt.note_arrival(1000)
        assert lt.snapshot()["queued_cost_bytes"] == 2000
        lt.note_taken(1000)
        lt.note_completed(1000, 1, 2.0)
        assert lt.rate_bytes_per_s() == pytest.approx(500.0)
        assert lt.drain_s() == pytest.approx(2.0)
        assert lt.projected_wait_s(250) == pytest.approx(0.5)
        out += [lt.rate_bytes_per_s(), lt.drain_s()]
        lt.note_removed(1000)
        assert lt.drain_s() == pytest.approx(0.0)
        snap = lt.snapshot()
        snap.pop("arrival_cost_per_s")      # a rate over wall clocks
        return out + [snap]

    _both(script)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_disabled_path_prices_nothing(dims, tmp_path):
    both("s_disabled_path", dims, tmp=tmp_path, pool_dims=dims)


# -- enforcement point 1: admission projection --------------------------------

@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_deadline_projection_boundary_exact_equality_admits(dims, tmp_path):
    both("s_deadline_boundary", dims, tmp=tmp_path, pool_dims=dims)


def test_blind_tracker_admits_everything(tmp_path):
    both("s_blind_tracker", ONE, tmp=tmp_path)


# -- enforcement point 2: take-side expiry shed -------------------------------

def test_expired_entry_shed_at_take_typed(tmp_path):
    both("s_expired_shed", ONE, "<tmp>", tmp=tmp_path)


def test_expiry_feeds_pump_deadline(tmp_path):
    both("s_expiry_feeds_pump", ONE, tmp=tmp_path)


def test_streaming_pump_sheds_at_slo_deadline(tmp_path):
    both("s_streaming_sheds_at_deadline", ONE, tmp=tmp_path)


# -- enforcement point 3: late completion journaled ---------------------------

def test_late_completion_journals_slo_violation(tmp_path):
    """Late by a ``hop.exchange:delay`` of 1.5 s past a 1 s deadline on
    the guarded schedule, in both packages (JAX's test is late by its
    compile past 20 ms, which a loaded host sheds before dispatch); the
    port on two ranks."""
    both("s_late_completion", (2,), "<tmp>", tmp=tmp_path, pool_dims=(2,))


# -- the pressure gate: hysteresis, shed, evict -------------------------------

def test_pressure_gate_hysteresis_no_flap(tmp_path):
    def script(P, d):
        P.obs.enable(str(d))
        gate = P.shed.PressureGate(P.serve.PressurePolicy(
            high_water_s=0.1, low_water_s=0.05))
        states = [gate.state] + [gate.update(x) for x in
                                 (0.07, 0.12, 0.07, 0.09, 0.04, 0.07)]
        assert states == ["ok", "ok", "shed", "shed", "shed", "ok", "ok"]
        assert gate.transitions == 2
        assert gate.update(None) == "ok"
        P.obs.disable()
        trans = [(e["prev"], e["state"]) for e in
                 P.events.read_journal(str(d)) if e["ev"] == "serve.pressure"]
        assert trans == [("ok", "shed"), ("shed", "ok")]
        return [states, trans, _records(P, d, "serve.pressure")]

    _both(script, tmp_path)


def test_pressure_gate_recovers_at_zero_low_water():
    def script(P, _):
        gate = P.shed.PressureGate(P.serve.PressurePolicy(
            high_water_s=1.0, low_water_s=0.0))
        out = [gate.update(2.0), gate.update(0.0)]
        assert out == ["evict", "ok"]
        return out

    _both(script)


def test_pressure_gate_evict_escalation():
    def script(P, _):
        PP = P.serve.PressurePolicy
        gate = P.shed.PressureGate(PP(high_water_s=0.1, low_water_s=0.05,
                                      evict_water_s=0.3))
        out = [gate.update(0.15), gate.evicting(), gate.update(0.35),
               gate.evicting(), gate.update(0.2), gate.update(0.01)]
        assert out == ["shed", False, "evict", True, "shed", "ok"]
        for bad in (dict(high_water_s=0.1, low_water_s=0.2),
                    dict(high_water_s=0.1, evict_water_s=0.05)):
            with pytest.raises(ValueError):
                PP(**bad)
        return out

    _both(script)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_shed_at_submit_protects_high_priority(dims, tmp_path):
    both("s_shed_at_submit", dims, "<tmp>", tmp=tmp_path, pool_dims=dims)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_evict_rung_deterministic_in_submission_sequence(dims, tmp_path):
    both("s_evict_rung", dims, "<tmp>", tmp=tmp_path, pool_dims=dims)


@pytest.mark.parametrize("dims,dims4", [(ONE, ONE), ((2, 2), (2, 2))])
def test_admission_reasons_never_conflated(dims, dims4, tmp_path):
    both("s_reasons_never_conflated", dims, dims4, tmp=tmp_path,
         pool_dims=dims4)


# -- the serve.submit fault point ---------------------------------------------

def test_serve_submit_fault_point(tmp_path):
    both("s_submit_fault_point", ONE, tmp=tmp_path)


def test_serve_submit_fault_point_delay_mode(tmp_path):
    both("s_submit_fault_delay", ONE, tmp=tmp_path)


# -- the autoscaler controller ------------------------------------------------

def test_autoscaler_requires_consecutive_windows(tmp_path):
    both("s_autoscaler_windows", ONE, "<tmp>", tmp=tmp_path)


def test_autoscaler_interrupted_streak_never_decides(tmp_path):
    both("s_autoscaler_interrupted", ONE, tmp=tmp_path)


def test_autoscaler_cooldown_rate_limits(tmp_path):
    both("s_autoscaler_cooldown", ONE, tmp=tmp_path)


def test_autoscaler_idle_scales_down(tmp_path):
    both("s_autoscaler_idle_down", "<tmp>", tmp=tmp_path)


def test_autoscaler_down_designates_highest_rank(tmp_path):
    both("s_autoscaler_highest_rank", "<tmp>", tmp=tmp_path)


def test_prewarm_plans_compiles_and_reports(tmp_path):
    both("s_prewarm", ONE, "<tmp>", tmp=tmp_path)


# -- the reform-ordering fix --------------------------------------------------

@pytest.mark.chaos
def test_restore_failure_resumes_engines_with_held_queue(tmp_path):
    both("s_restore_failure_resumes", "<tmp>", tmp=tmp_path)


@pytest.mark.chaos
def test_successful_reform_still_drops_held_dispatches(tmp_path):
    both("s_successful_reform_drops_held", "<tmp>", tmp=tmp_path)


# -- engine-reformation resubmission: no ticket stranded ----------------------

@pytest.mark.chaos
def test_reformed_engine_batch_resubmits_instead_of_stranding(tmp_path):
    both("s_reformed_batch_resubmits", ONE, tmp=tmp_path)


# -- the burn-rate monitor (tests/test_requestflow.py) ------------------------

def test_burn_monitor_validates():
    def script(P, _):
        out = []
        for kw, match in ((dict(budget=0.0), "budget"),
                          (dict(threshold=-1.0), "threshold")):
            with pytest.raises(ValueError, match=match) as ei:
                P.slo.BurnRateMonitor(**kw)
            out.append(str(ei.value))
        return out

    _both(script)


def test_burn_alert_fires_once_and_rearms():
    """The monitor's alert discipline through both packages: one alert a
    crossing, re-armed below half the threshold, the window evicting."""
    def script(P, _):
        m = P.slo.BurnRateMonitor(budget=0.1, threshold=2.0, window_s=1e6,
                                  min_events=4)
        alerts = [m.note("acme", i % 2 == 0, now=float(i))
                  for i in range(12)]
        rates = [m.burn_rate("acme", now=12.0)]
        for i in range(12, 60):
            alerts.append(m.note("acme", False, now=float(i)))
        rates.append(m.burn_rate("acme", now=60.0))
        w = P.slo.BurnRateMonitor(budget=0.5, threshold=4.0, window_s=10.0,
                                  min_events=2)
        for t in (0.0, 1.0, 2.0):
            w.note("acme", True, now=t)
        rates += [w.burn_rate("acme", now=3.0), w.burn_rate("acme", 21.0),
                  w.snapshot(now=21.0)]
        return [[a for a in alerts if a is not None], rates]

    _both(script)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_real_coalesced_batch_shares_one_dispatch(dims, tmp_path):
    both("s_real_coalesced_batch", dims, "<tmp>", tmp=tmp_path,
         pool_dims=dims)
