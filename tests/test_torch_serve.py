"""PyTorch port vs JAX package: the multi-tenant plan service (``serve/``).

Every case of the JAX package's ``tests/test_serve.py`` (but the bench
smoke: its benchmark is not ported) and ``tests/test_serve_depth.py``,
the ``PlanService`` cases of ``tests/test_engine.py`` (but the certify
one: ``PlanService.certify`` waits for ``analysis.spmd.certify_plan``)
and the three serve-whale cases of ``tests/test_reshard_hbm.py``.

Scenarios (``tests/torch_serve_scenarios.py``) run the JAX test's body
through both packages (``tests/torch_serve_parity.py``): the JAX service
on its 8-device CPU mesh, the port on a one-rank topology in this process
and on 2, 4 and 8 ranks of the shared gloo pool (one ``PlanService`` a
rank, the same submissions), each at the JAX case's own topology where
the two are compared.  FFT results agree within 2e-5 of the reference's
largest magnitude (``tests/test_torch_fft.py``'s tolerance), reshard
results and data movement bit for bit, and outcomes, counters, keys and
``serve.*`` records (without clocks, request and trace ids) exactly.
Inside the port, coalesced results are pinned bit-identical to its own
sequential ``plan.compile()`` calls, as JAX pins its own.  The queue's
depth cases are pure Python and run the same script through both
packages.
"""

import os
import subprocess
import sys
import time

import pytest

from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu.serve import queue as jax_queue
from pencilarrays_tpu.serve import slo as jax_slo
from pencilarrays_tpu_torch.obs import drift as port_drift
from pencilarrays_tpu_torch.serve import queue as port_queue
from pencilarrays_tpu_torch.serve import slo as port_slo
from torch_serve_parity import both, compare, run_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = (1, 1)        # the port's one-rank topology in this process


@pytest.fixture(autouse=True)
def _hermetic_drift():
    """Plans are drift-sensitive in both packages (a trusted sample left
    by an earlier test in the same worker changes a plan's key)."""
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()
    yield
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()


# -- plan_key: the public stable fingerprint ----------------------------------

@pytest.mark.parametrize("dims", [(2,), (2, 4)])
def test_plan_key_stable_and_dtype_sensitive(dims, tmp_path):
    """The keys are the JAX package's, character for character (the
    port plans on a topology without process groups)."""
    import torch_serve_scenarios as S
    from pencilarrays_tpu_torch.parallel.topology import Topology

    want = run_jax("s_plan_key_stable", dims, tmp=tmp_path)
    P = S.SPkg("torch", topo=lambda d: Topology.unconnected(d, "cpu"))
    compare(want, S.s_plan_key_stable(P, dims))


def test_plan_key_deterministic_in_subprocess(tmp_path):
    """Same inputs -> same key in a fresh process of the port (no JAX
    there), equal to the JAX plan's key."""
    import torch_serve_scenarios as S

    want = S.SPkg("jax").plan((2,), (8, 6, 4),
                              transforms=("rfft", "fft", "fft"),
                              pipeline=2).plan_key()
    script = (
        "import pencilarrays_tpu_torch as pat\n"
        "from pencilarrays_tpu_torch.parallel.topology import Topology\n"
        "t = Topology.unconnected((2,), 'cpu')\n"
        "p = pat.PencilFFTPlan(t, (8, 6, 4),\n"
        "                      transforms=('rfft', 'fft', 'fft'), "
        "pipeline=2)\n"
        "import sys\n"
        "assert 'jax' not in sys.modules\n"
        "print('KEY=' + p.plan_key())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"KEY={want}" in out.stdout, (out.stdout, want)


@pytest.mark.parametrize("dims", [ONE])
def test_plan_key_agrees_with_journal_plan_fp(dims, tmp_path):
    both("s_plan_key_journal", dims, "<tmp>", tmp=tmp_path)


@pytest.mark.parametrize("dims", [(2, 2)])
def test_reshard_key_stable(dims, tmp_path):
    import torch_serve_scenarios as S
    from pencilarrays_tpu_torch.parallel.topology import Topology

    want = run_jax("s_reshard_key", dims, tmp=tmp_path)
    P = S.SPkg("torch", topo=lambda d: Topology.unconnected(d, "cpu"))
    compare(want, S.s_reshard_key(P, dims))


# -- registry: shared executables + serve-labeled cache counters --------------

@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_registry_dedupes_plans_and_counts_per_tenant(dims, tmp_path):
    both("s_registry_counts", dims, "<tmp>", tmp=tmp_path, pool_dims=dims)


def test_registry_replace_drops_stale_executables(tmp_path):
    both("s_registry_replace", ONE, tmp=tmp_path)


# -- coalescing: batched == sequential, bit for bit (inside each package) -----

@pytest.mark.parametrize("dims", [ONE, (2,)], ids=["1rank", "2ranks"])
@pytest.mark.parametrize("real", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_coalesced_equals_sequential(dims, real, direction, tmp_path):
    """5 same-plan requests through a max_batch=4 service (one full + one
    ragged batch) are answered bit-identically to 5 sequential
    ``plan.compile()`` calls of the same package; the port's answers
    agree with JAX's within the FFT tolerance."""
    both("s_coalesced_equals_sequential", dims, real, direction,
         tmp=tmp_path, pool_dims=dims)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_pencilarray_payloads_and_cache_reuse(dims, tmp_path):
    both("s_device_payloads_cache_reuse", dims, tmp=tmp_path,
         pool_dims=dims)


@pytest.mark.parametrize("dims", [ONE, (2, 2)])
def test_reshard_requests_coalesce_bit_identically(dims, tmp_path):
    both("s_reshard_coalesce", dims, tmp=tmp_path, pool_dims=dims)


# -- admission + ordering -----------------------------------------------------

@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_admission_quotas_typed_and_released(dims, tmp_path):
    both("s_admission_quotas", dims, "<tmp>", tmp=tmp_path, pool_dims=dims)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_cost_ordering_small_before_big(dims, tmp_path):
    """On two ranks the small plan dispatches first (cheaper priced
    collectives); on one rank every hop prices zero wire bytes and both
    packages dispatch in admission order."""
    both("s_cost_ordering", dims, "<tmp>", tmp=tmp_path, pool_dims=dims)


def test_single_sample_contract_and_close(tmp_path):
    both("s_single_sample_and_close", ONE, tmp=tmp_path)


@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_close_drops_a_private_registrys_executables(dims, tmp_path):
    both("s_close_drops_private_executables", dims, tmp=tmp_path,
         pool_dims=dims)


def test_wrong_pencil_payload_fails_typed(tmp_path):
    """On two ranks (on one, the plan's input and output pencils are the
    same pencil in both packages, and no payload is stale)."""
    both("s_wrong_pencil_payload", (2,), tmp=tmp_path, pool_dims=(2,))


@pytest.mark.parametrize("dims", [(2,), (2, 2)])
def test_bad_payload_in_batch_fails_only_its_ticket(dims, tmp_path):
    both("s_bad_payload_in_batch", dims, tmp=tmp_path, pool_dims=dims)


def test_malformed_host_shape_rejected_at_submit(tmp_path):
    both("s_malformed_host_shape", ONE, tmp=tmp_path)


def test_complex_payload_to_r2c_plan_rejected_at_submit(tmp_path):
    both("s_complex_to_r2c", ONE, tmp=tmp_path)


# -- tenant isolation (a hop to poison: two ranks) ----------------------------

@pytest.mark.chaos
def test_tenant_isolation_sdc_drill(tmp_path):
    """``hop.exchange:corrupt`` poisoning alice's hop: typed
    ``IntegrityError`` on her ticket, bob's requests bit-identical to the
    unfaulted run, the lifecycle journaled, lint-clean and rendered by the
    port's ``pa-obs`` (``python -m pencilarrays_tpu_torch.obs``)."""
    both("s_isolation_sdc", (2,), "<tmp>", tmp=tmp_path, pool_dims=(2,))


@pytest.mark.chaos
def test_isolation_same_tenant_later_traffic_unpoisoned(tmp_path):
    both("s_isolation_later_traffic", (2,), "<tmp>", tmp=tmp_path,
         pool_dims=(2,))


@pytest.mark.chaos
def test_guarded_retry_recovers_transient_sdc(tmp_path):
    both("s_guarded_retry_transient", (2,), "<tmp>", tmp=tmp_path,
         pool_dims=(2,))


def test_guarded_step_meta_survives_reserved_key_names(tmp_path):
    both("s_meta_reserved_keys", "<tmp>", tmp=tmp_path)


# -- elastic rebind -----------------------------------------------------------

@pytest.mark.parametrize("dims", [ONE, (2,)])
def test_named_plan_rebuild_rebinds_queue(dims, tmp_path):
    both("s_named_plan_rebind", dims, tmp=tmp_path, pool_dims=dims)


# -- the engine's PlanService cases (single controller: one rank) -------------

def test_guarded_step_not_wedged_by_pool_failure(tmp_path):
    both("s_not_wedged_by_pool_failure", ONE, tmp=tmp_path)


def test_serve_streaming_without_daemon_thread(tmp_path):
    both("s_streaming_no_daemon", ONE, tmp=tmp_path)


def test_streaming_rearms_after_engine_reform(tmp_path):
    both("s_streaming_rearms_after_reform", ONE, tmp=tmp_path)


def test_streaming_queued_traffic_drains_after_reform(tmp_path):
    both("s_streaming_queued_after_reform", ONE, tmp=tmp_path)


def test_streaming_full_batch_dispatches_before_deadline(tmp_path):
    both("s_streaming_full_batch_fast", ONE, tmp=tmp_path)


def test_streaming_quiesced_admission_drains_on_resume(tmp_path):
    both("s_streaming_quiesced_resume", ONE, tmp=tmp_path)


def test_step_fails_tickets_when_submission_fails(tmp_path):
    both("s_step_fails_tickets", ONE, tmp=tmp_path)


def test_elastic_reform_rebuilds_engine(tmp_path):
    both("s_elastic_reform_rebuilds_engine", ONE, "<tmp>", tmp=tmp_path)


def test_serve_certify_waits_for_the_analysis_port():
    """``PlanService.certify`` needs ``analysis.spmd.certify_plan``
    (ROADMAP Queue 1 item 7(g)); the port raises instead of certifying
    nothing."""
    from pencilarrays_tpu_torch.serve import PlanService

    with pytest.raises(NotImplementedError, match="7\\(g\\)"):
        PlanService().certify()


# -- serve whales: hbm-limited reshards (8 ranks) -----------------------------

def test_serve_admits_whale_via_synthesized_route(tmp_path):
    both("s_whale_admitted", (2, 4), tmp=tmp_path, pool_dims=(2, 4))


def test_serve_rejects_infeasible_whale_typed(tmp_path):
    both("s_whale_rejected", (2, 4), tmp=tmp_path, pool_dims=(2, 4))


def test_serve_hbm_whales_do_not_coalesce(tmp_path):
    both("s_whales_do_not_coalesce", (2, 4), tmp=tmp_path,
         pool_dims=(2, 4))


# -- the queue's depth cases (pure Python, both packages) ---------------------

def _both_queues(script):
    """``script(queue_module, slo_module)`` through each package; the two
    results must be equal."""
    want = script(jax_queue, jax_slo)
    got = script(port_queue, port_slo)
    assert got == want, (want, got)
    return got


def _entry(Q, key, base, *, tenant="t", deadline=None):
    t = Q.Ticket(tenant, "fft", key)
    t.t_submit = base
    return Q._Entry(ticket=t, plan=None, direction="forward", payload=None,
                    nbytes=1, plan_name=None, deadline=deadline)


def _big(Q):
    return Q.TenantQuota(max_requests=1 << 20, max_bytes=1 << 50)


def _fill(Q, q, n_groups, per_group, base, prefix="k"):
    for g in range(n_groups):
        for _ in range(per_group):
            q.offer(_entry(Q, f"{prefix}{g}", base))


def test_idle_ticks_scan_nothing_at_depth():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=10.0,
                             default_quota=_big(Q))
        _fill(Q, q, 2000, 5, base)
        assert q.depth() == 10_000
        for _ in range(100):
            assert q.take_ready(now=base + 0.5) == []
        s = q.scan_stats()
        assert s["take_calls"] == 100 and s["groups_scanned"] == 0
        return s

    _both_queues(script)


def test_due_tick_scans_exactly_the_due_groups():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=1.0,
                             default_quota=_big(Q))
        _fill(Q, q, 50, 5, base)
        _fill(Q, q, 30, 5, base + 100.0, prefix="late")
        batches = q.take_ready(now=base + 2.0)
        assert q.scan_stats()["groups_scanned"] == 50
        assert len(batches) == 50
        assert all(b.reason == "deadline" for b in batches)
        assert q.depth() == 150
        assert q.take_ready(now=base + 2.5) == []
        return [q.scan_stats(), [(b.key, len(b.entries)) for b in batches]]

    _both_queues(script)


def test_full_group_surfaces_without_scanning_neighbors():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=10.0,
                             default_quota=_big(Q))
        _fill(Q, q, 999, 5, base)
        full = [q.offer(_entry(Q, "whale", base)) for _ in range(8)]
        assert full[-1] is True
        batches = q.take_ready(now=base + 0.01)
        assert [b.key for b in batches] == ["whale"]
        assert batches[0].reason == "full"
        assert q.scan_stats()["groups_scanned"] == 1
        return [full, q.scan_stats()]

    _both_queues(script)


def test_slo_expiry_wakes_only_the_affected_group():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=50.0,
                             default_quota=_big(Q))
        _fill(Q, q, 500, 2, base)
        q.offer(_entry(Q, "doomed", base, deadline=base + 0.1))
        q.take_ready(now=base + 0.5)
        assert q.scan_stats()["groups_scanned"] == 1
        dead = q.pop_expired()
        assert [e.ticket.key for e in dead] == ["doomed"]
        return q.scan_stats()

    _both_queues(script)


def test_next_ready_in_is_heap_backed_and_correct():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=2.0,
                             default_quota=_big(Q))
        assert q.next_ready_in(now=base) is None
        _fill(Q, q, 1000, 10, base + 5.0)
        q.offer(_entry(Q, "old", base))
        a = q.next_ready_in(now=base + 1.0)
        assert a == pytest.approx(1.0, abs=1e-6)
        q.offer(_entry(Q, "slo", base + 5.0, deadline=base + 1.2))
        b = q.next_ready_in(now=base + 1.0)
        assert b == pytest.approx(0.2, abs=1e-6)
        q.take_ready(now=base + 2.0)
        c = q.next_ready_in(now=base + 2.0)
        assert c == pytest.approx(5.0, abs=1e-6)
        return [round(a, 6), round(b, 6), round(c, 6)]

    _both_queues(script)


def test_remainder_after_full_split_reenters_the_index():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=4, max_wait_s=1.0,
                             default_quota=_big(Q))
        for _ in range(6):
            q.offer(_entry(Q, "k", base))
        first = [b.reason for b in q.take_ready(now=base + 0.01)]
        assert first == ["full"] and q.depth() == 2
        second = [len(b.entries) for b in q.take_ready(now=base + 2.0)]
        assert second == [2] and q.depth() == 0
        return [first, second]

    _both_queues(script)


def test_load_tracker_projections_hold_at_depth():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=10.0,
                             default_quota=_big(Q))
        for i in range(10_000):
            e = _entry(Q, f"k{i % 100}", base)
            e.cost_bytes = 1000
            q.offer(e)
        snap = q.load.snapshot()
        assert snap["queued_cost_bytes"] == 10_000 * 1000
        q.load.note_completed(50 * 1000, 50, 0.5)
        assert q.load.projected_wait_s() is not None
        assert q.load.drain_s() is not None
        return [snap["queued_cost_bytes"], q.load.drain_s()]

    _both_queues(script)


def test_scan_work_tracks_due_work_not_depth():
    def script(Q, _):
        def scans_at(n_groups):
            base = time.monotonic()
            q = Q.AdmissionQueue(max_batch=8, max_wait_s=10.0,
                                 default_quota=_big(Q))
            _fill(Q, q, n_groups, 5, base)
            for _ in range(50):
                q.take_ready(now=base + 0.5)
            return q.scan_stats()["groups_scanned"]

        out = [scans_at(200), scans_at(2000)]
        assert out == [0, 0]
        return out

    _both_queues(script)


def _brute_depth(q, tenant=None):
    entries = q.pending_entries()
    if tenant is None:
        return len(entries)
    return sum(1 for e in entries if e.ticket.tenant == tenant)


def test_depth_polls_scan_nothing_at_depth():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=8, max_wait_s=10.0,
                             default_quota=_big(Q))
        for g in range(1000):
            for t in ("whale", "minnow"):
                for _ in range(5):
                    q.offer(_entry(Q, f"{t}{g}", base, tenant=t))
        for _ in range(1000):
            assert q.depth() == 10_000
            assert q.depth("whale") == 5_000
            assert q.depth("minnow") == 5_000
            assert q.depth("ghost") == 0
        assert q.scan_stats()["depth_entries_scanned"] == 0
        return q.scan_stats()

    _both_queues(script)


def test_depth_index_exact_across_every_departure_path():
    def script(Q, _):
        base = time.monotonic()
        q = Q.AdmissionQueue(max_batch=4, max_wait_s=1.0,
                             default_quota=_big(Q))
        trail = []
        for _ in range(6):
            q.offer(_entry(Q, "k", base, tenant="a"))
        q.take_ready(now=base + 0.01)
        assert q.depth() == _brute_depth(q) == 2
        assert q.depth("a") == _brute_depth(q, "a") == 2
        trail.append(q.depth())
        q.take_ready(now=base + 2.0)
        assert q.depth() == _brute_depth(q) == 0 and q.depth("a") == 0
        q.offer(_entry(Q, "doomed", base, tenant="b", deadline=base + 0.1))
        q.take_ready(now=base + 0.5)
        assert [e.ticket.key for e in q.pop_expired()] == ["doomed"]
        assert q.depth() == _brute_depth(q) == 0 and q.depth("b") == 0
        q.offer(_entry(Q, "low", base, tenant="c"))
        protected = _entry(Q, "high", base, tenant="d")
        protected.shed_priority = 5
        q.offer(protected)
        evicted = q.evict_sheddable(protected_priority=1)
        assert [e.ticket.tenant for e in evicted] == ["c"]
        assert q.depth() == _brute_depth(q) == 1
        assert q.depth("c") == 0 and q.depth("d") == 1
        assert q.scan_stats()["depth_entries_scanned"] == 0
        trail.append(q.depth())
        return trail

    _both_queues(script)


def test_load_tracker_arrival_window_is_o1_and_exact():
    def script(_, L):
        tr = L.LoadTracker(window=64)
        now, costs = 1000.0, []
        for i in range(100_000):
            c = (i * 37) % 1000 + 1
            tr.note_arrival(c, now=now + i * 0.001)
            costs.append(c)
        for _ in range(1000):
            got = tr.arrival_cost_per_s()
        t0 = now + (100_000 - 64) * 0.001
        t1 = now + 99_999 * 0.001
        assert got == pytest.approx(sum(costs[-64:]) / (t1 - t0))
        assert tr.scan_stats()["arrivals_scanned"] == 0
        return got

    _both_queues(script)
