"""PyTorch port vs JAX package: precision as a serving lever
(``serve/precision.py``, the pressure gate's degrade rung).

Every case of the JAX package's ``tests/test_precision.py``.  The policy,
gate, envelope and rung-selection cases are pure Python: the same script
runs through both packages and the results must be equal (the envelope
reads the same ``BENCH_WIRE.json`` in both, so both pick the same rungs).
The serving cases run as scenarios of ``tests/torch_serve_scenarios.py``
on the JAX package's 2 x 4 CPU mesh and on 8 ranks of the shared gloo
pool (``tests/torch_serve_parity.py``): keys, registry entries, rung
decisions and ``serve.*`` records equal, full-precision results within
2e-5 of the reference's largest magnitude.  Beyond the JAX package, the
port's rung also serves reshard traffic on a cheaper wire
(``test_degrade_rung_serves_reshard_within_envelope``).
"""

import json

import pytest

from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift
from torch_serve_parity import both
from torch_serve_scenarios import SPkg

MESH = (2, 4)


@pytest.fixture(autouse=True)
def _hermetic_drift():
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()
    yield
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()


def _both(script, *args):
    out = {}
    for which in ("jax", "torch"):
        P = SPkg(which)
        P.reset()
        try:
            out[which] = json.loads(json.dumps(script(P, *args),
                                               default=str))
        finally:
            P.reset()
    assert out["torch"] == out["jax"], out
    return out["torch"]


# -- policy + gate ladder ------------------------------------------------------

def test_degrade_policy_validation():
    def script(P):
        PP = P.serve.PressurePolicy
        PP(high_water_s=1.0, low_water_s=0.1, degrade_water_s=0.5)
        out = []
        for bad in (dict(high_water_s=1.0, low_water_s=0.1,
                         degrade_water_s=1.0),
                    dict(high_water_s=1.0, low_water_s=0.5,
                         degrade_water_s=0.5)):
            with pytest.raises(ValueError) as ei:
                PP(**bad)
            out.append(str(ei.value))
        return out

    _both(script)


def test_gate_four_state_ladder_hysteresis():
    def script(P):
        g = P.shed.PressureGate(P.serve.PressurePolicy(
            high_water_s=1.0, low_water_s=0.1, degrade_water_s=0.5))
        out = [g.state] + [g.update(x) for x in
                           (0.3, 0.6, 0.3, 1.5, 0.7, 0.3, 0.05, 2.5, 0.7,
                            0.05, 9.9)]
        assert out == ["ok", "ok", "degrade", "degrade", "shed", "shed",
                       "shed", "ok", "evict", "shed", "ok", "evict"]
        return out + [g.transitions]

    _both(script)


def test_gate_without_degrade_mark_is_three_state():
    def script(P):
        g = P.shed.PressureGate(P.serve.PressurePolicy(high_water_s=1.0,
                                                       low_water_s=0.5))
        out = [g.update(x) for x in (0.9, 1.2, 0.9, 0.5)]
        assert out == ["ok", "shed", "shed", "ok"]
        assert g.transitions == 2
        return out

    _both(script)


def test_degrades_vs_sheds_predicates():
    def script(P):
        g = P.shed.PressureGate(P.serve.PressurePolicy(
            high_water_s=1.0, low_water_s=0.1, degrade_water_s=0.5))
        out = []
        for drain in (0.6, 1.5, 2.5):
            g.update(drain)
            out.append([g.state, g.degrades(0, 1), g.sheds(0, 1),
                        g.degrades(1, 1), g.evicting()])
        assert out[0] == ["degrade", True, False, False, False]
        assert out[1][1:3] == [True, True]
        assert out[2] == ["evict", True, True, False, True]
        return out

    _both(script)


# -- calibrated envelopes + rung selection ------------------------------------

def _artifact(tmp_path, monkeypatch, doc):
    p = tmp_path / "BENCH_WIRE.json"
    p.write_text(json.dumps(doc))
    monkeypatch.setenv("PENCILARRAYS_TPU_BENCH_WIRE_PATH", str(p))


def test_wire_error_envelope_reads_artifact(tmp_path, monkeypatch):
    _artifact(tmp_path, monkeypatch, {
        "workload_x": {"bf16": {"rel_err_l2": 0.002},
                       "fp8_e4m3": {"rel_err_l2": 0.03}},
        "workload_y": {"fp8_e4m3": {"rel_err_l2": 0.02}}})

    def script(P):
        env = P.precision.wire_error_envelope
        out = [env("fp8_e4m3"), env("bf16"), env("fp8_e5m2")]
        assert out == pytest.approx([0.06, 0.004, 0.16])
        return out

    _both(script)


def test_select_rung_is_envelope_driven(tmp_path, monkeypatch):
    _artifact(tmp_path, monkeypatch, {
        "w": {"bf16": {"rel_err_l2": 0.002},
              "fp8_e4m3": {"rel_err_l2": 0.03}}})

    def script(P):
        sel = P.precision.select_rung
        out = [sel(1e-5), sel(0.01), sel(0.5), sel(0.5, "bf16"),
               sel(0.01, "bf16"), sel(0.5, "fp8_e4m3")]
        assert out[0] is None and out[1][0] == "bf16"
        assert out[2][0] == "fp8_e4m3" and out[3][0] == "fp8_e4m3"
        assert out[4] is None and out[5] is None
        return out

    _both(script)


def test_repo_artifact_gives_both_packages_the_same_rungs():
    """With the repo's own ``BENCH_WIRE.json`` (no override) every budget
    picks the same rung and envelope in both packages."""
    def script(P):
        return [P.precision.select_rung(b, cur)
                for b in (1e-6, 1e-3, 1e-2, 5e-2, 0.1, 0.5)
                for cur in (None, "bf16", "fp8_e4m3")]

    _both(script)


# -- the serving lever end to end (8 ranks) ------------------------------------

def test_degrade_rung_serves_within_budget(tmp_path):
    both("s_degrade_within_budget", MESH, "<tmp>", tmp=tmp_path,
         pool_dims=MESH)


def test_shed_state_serves_budget_tenant_sheds_rest(tmp_path):
    both("s_shed_serves_budget", MESH, tmp=tmp_path, pool_dims=MESH)


def test_degraded_traffic_never_coalesces_with_full(tmp_path):
    both("s_degraded_never_coalesces", MESH, tmp=tmp_path, pool_dims=MESH)


def test_no_budget_no_degrade_keeps_full_precision(tmp_path):
    both("s_no_budget_no_degrade", MESH, tmp=tmp_path, pool_dims=MESH)


def test_registry_compiled_variants_keyed_apart(tmp_path):
    both("s_registry_variants", MESH, tmp=tmp_path, pool_dims=MESH)


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_degrade_rung_serves_reshard_within_envelope(dims, tmp_path):
    """The port's rung on reshard traffic: a sheddable budget tenant's
    reshard moves onto its method carrying the rung's wire (its own
    key), is served within the envelope of that wire, and journals one
    ``serve.precision`` record; the protected tenant's reshard stays
    bit-identical to ``reshard``."""
    from torch_serve_parity import run_port

    got = run_port("s_degrade_reshard", dims, "<tmp>", tmp=tmp_path,
                   pool_dims=dims)
    assert got["rel_err"] <= got["envelope"]
    assert got["rel_err"] > 0
    assert got["gold_bits"]
    assert got["wire_to"] in ("bf16", "fp8_e4m3")
