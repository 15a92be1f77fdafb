"""PyTorch port vs JAX package: the static analysis (``analysis/``).

Every case of the JAX package's ``tests/test_analysis.py`` has a
counterpart here, and the certify case of ``tests/test_engine.py``.

Pillar 1 (traces and verifiers): the JAX package traces each program
from its compiled HLO on its 8-device CPU mesh; the port records the
collectives the same program issues, run once on 4 or 8 gloo ranks of
the shared pool (``torch_rank_tasks.analysis_case``, every rank tracing,
each holding the port's trace to the port's own prediction).  Each
package's trace verifies against its own ``collective_costs`` /
``transpose_cost`` / route costs, the two predictions are equal, and the
ordered ``(kind, bytes)`` of the ops agree, but for what the two
programs legitimately do differently (:data:`TRACE_DIFFS`).  A corrupted
schedule is rejected naming the op, and a peak-memory violation naming
the hop, in both.

Pillar 2 (lint): each fixture tree of the JAX tests is written for each
package (the same files under ``pencilarrays_tpu/`` or
``pencilarrays_tpu_torch/``) and linted by that package's own linter;
the check ids and identifiers must be the same.  Where the port's check
reads the port's idiom (``plan-cache``: K1 plans, cuFFT, CUDA graphs
instead of ``jax.jit``; ``wire-cast``: ``.to``/``.type``/``.view`` casts
instead of ``.astype``/``bitcast_convert_type``), the port's fixture
says the same thing in that idiom (:data:`PORT_FIXTURES`).  The port's
tree lints clean, and ``python -m pencilarrays_tpu_torch.analysis``
exits 0 on the repo.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import pencilarrays_tpu as pa
from pencilarrays_tpu.analysis import lint as jlint
from pencilarrays_tpu.analysis import spmd as jspmd
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu.ops.fft import PencilFFTPlan
from pencilarrays_tpu.parallel.routing import plan_reshard_route
from pencilarrays_tpu.parallel.transpositions import AllToAll, Pipelined, Ring
from pencilarrays_tpu_torch.analysis import lint as plint
from pencilarrays_tpu_torch.obs import drift as port_drift

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# What the port's recorded ops legitimately carry differently from the
# JAX package's HLO-extracted ones; every other field of the ordered ops
# (the kind and the per-rank bytes of each application) is held equal.
TRACE_DIFFS = [
    ("shape", "XLA's HLO result-shape text (layouts, tuples) against "
              "the port's dtype[dims] of the buffer it sent"),
    ("replica_groups", "XLA's whole group partition against the issuing "
                       "rank's own group; a ring round carries the "
                       "(source, target) pair this rank sends along, "
                       "where XLA's collective-permute lists every pair"),
    ("async_start", "the port issues every exchange asynchronously "
                    "(all_to_all_single(async_op=True), a ring round's "
                    "batch_isend_irecv); XLA:CPU's HLO has no -start form"),
    ("ring rounds", "a Ring hop is G-1 batch_isend_irecv rounds, each "
                    "recorded as one collective-permute of its tile, as "
                    "XLA compiles G-1 collective-permutes"),
]


@pytest.fixture(autouse=True)
def _hermetic_drift():
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()
    yield
    jax_drift.drift_tracker.reset()
    port_drift.drift_tracker.reset()


def _port(name, *args):
    import torch_rank_tasks as tasks

    return tasks.shared_pool().run(tasks.analysis_case, name, *args)[0]


def _ops(trace):
    return [[o.kind, o.bytes] for o in trace.ops]


def _canon(x):
    import json

    return json.loads(json.dumps(x, sort_keys=True, default=str))


# ---------------------------------------------------------------------------
# pillar 1: trace extraction
# ---------------------------------------------------------------------------

_METHODS = {"alltoall": AllToAll(), "ring": Ring(),
            "pipelined": Pipelined(chunks=2)}


@pytest.mark.parametrize("method", ["alltoall", "ring", "pipelined"])
@pytest.mark.parametrize("extra", [(), (3,)], ids=["plain", "batched"])
def test_trace_transpose_matches_cost_model(devices, method, extra):
    topo = pa.Topology((4,), devices=devices[:4])
    pin = pa.Pencil(topo, (16, 12, 20), (1,))
    pout = pa.Pencil(topo, (16, 12, 20), (0,))
    m = _METHODS[method]
    tr = jspmd.trace_transpose(pin, pout, extra, np.complex64, m)
    pred = pa.transpose_cost(pin, pout, extra, np.complex64, m)
    assert tr.stats() == pred
    got = _port("transpose", method, extra)
    assert _canon(got["pred"]) == _canon(pred)
    assert got["ops"] == _ops(tr)


@pytest.mark.parametrize("dims", [(4,), (2, 2)], ids=["slab", "pencil"])
@pytest.mark.parametrize("real", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("extra", [(), (3,)], ids=["plain", "batched"])
def test_verify_plan_whole_matrix(devices, dims, real, extra):
    n = int(np.prod(dims))
    topo = pa.Topology(dims, devices=devices[:n])
    plan = PencilFFTPlan(topo, (8, 8, 4), real=real)
    fwd = jspmd.verify_plan(plan, extra, "forward")
    bwd = jspmd.verify_plan(plan, extra, "backward")
    assert len(fwd) > 0 and len(bwd) > 0
    got = _port("plan", dims, real, extra)
    assert _canon(got["pred"]) == _canon(plan.collective_costs(extra))
    assert got["fwd"] == _ops(fwd) and got["bwd"] == _ops(bwd)


def test_verify_routed_reshard(devices):
    topo = pa.Topology((2, 4), devices=devices)
    pin = pa.Pencil(topo, (16, 12, 8), (1, 2))
    dest = pa.Pencil(topo, (16, 12, 8), (0, 1))
    route = plan_reshard_route(pin, dest, (), np.float32)
    assert route.hops
    tr = jspmd.verify_route(route, (), np.float32)
    assert len(tr) == sum(c["count"] for h in route.hops
                          for c in h.cost.values())
    got = _port("routed")
    assert _canon(got["costs"]) == _canon([h.cost for h in route.hops])
    assert got["ops"] == _ops(tr) and got["verdict"] == route.verdict


def test_trace_compiled_plan_is_residents_trace(devices):
    topo = pa.Topology((2, 2), devices=devices[:4])
    plan = PencilFFTPlan(topo, (8, 8, 4), dtype=np.complex64, batch=3)
    cp = plan.compile()
    f = jspmd.trace_compiled_plan(cp, "forward")
    b = jspmd.trace_compiled_plan(cp, "backward")
    assert f.stats() == plan.collective_costs((3,)) == b.stats()
    got = _port("compiled")
    assert _canon(got["pred"]) == _canon(plan.collective_costs((3,)))
    assert got["fwd"] == _ops(f) and got["bwd"] == _ops(b)


# ---------------------------------------------------------------------------
# pillar 1: typed rejection
# ---------------------------------------------------------------------------


def test_corrupted_schedule_rejected_naming_op(devices):
    from pencilarrays_tpu.analysis.errors import ScheduleMismatchError

    topo = pa.Topology((2, 2), devices=devices[:4])
    plan = PencilFFTPlan(topo, (8, 8, 4), dtype=np.complex64)
    good = jspmd.trace_plan(plan, ())
    corrupted = jspmd.CollectiveTrace(source="corrupted", ops=good.ops[:-1],
                                      donated_params=good.donated_params)
    with pytest.raises(ScheduleMismatchError) as ei:
        jspmd.verify_plan(plan, (), "forward", trace=corrupted)
    want = {"dropped": [ei.value.op, ei.value.predicted, ei.value.observed]}

    class Tampered(PencilFFTPlan):
        def collective_costs(self, extra_dims=None, **kw):
            costs = PencilFFTPlan.collective_costs(self, extra_dims, **kw)
            op = next(iter(costs))
            costs[op] = {"count": costs[op]["count"] + 1,
                         "bytes": costs[op]["bytes"]}
            return costs

    plan.__class__ = Tampered
    try:
        with pytest.raises(ScheduleMismatchError) as ei:
            jspmd.verify_plan(plan, (), "forward", trace=good)
        want["tampered"] = [ei.value.op, ei.value.predicted,
                            ei.value.observed]
    finally:
        plan.__class__ = PencilFFTPlan
    assert _canon(_port("corrupted")) == _canon(want)


def test_hbm_bound_violation_names_hop(devices):
    from pencilarrays_tpu.analysis.errors import HbmBoundError

    topo = pa.Topology((2, 2), devices=devices[:4])
    plan = PencilFFTPlan(topo, (8, 8, 4), dtype=np.complex64)
    peak, label = jspmd.predicted_peak_hbm(plan)
    with pytest.raises(HbmBoundError) as ei:
        jspmd.verify_hbm(plan, peak - 1, source="drill")
    assert ei.value.hop == label
    topo8 = pa.Topology((2, 4), devices=devices)
    route = plan_reshard_route(pa.Pencil(topo8, (16, 12, 8), (1, 2)),
                               pa.Pencil(topo8, (16, 12, 8), (0, 1)),
                               (), np.float32)
    rpeak, rlabel = jspmd.predicted_peak_hbm(route)
    with pytest.raises(HbmBoundError) as ei:
        jspmd.verify_hbm(route, rpeak - 1)
    assert ei.value.hop == rlabel
    got = _port("hbm")
    assert got == {"plan": [peak, label], "route": [rpeak, rlabel]}


def test_consistency_checks(devices):
    from pencilarrays_tpu.analysis.errors import TraceDivergenceError
    from pencilarrays_tpu.ops.pallas_kernels import pallas_enabled
    from pencilarrays_tpu.parallel import transpositions as tr

    topo = pa.Topology((2, 2), devices=devices[:4])
    plan = PencilFFTPlan(topo, (8, 8, 4), dtype=np.complex64)
    t1 = jspmd.trace_plan(plan, ())
    t3 = jspmd.trace_plan(plan, (3,))
    jspmd.verify_consistent(t1, t3, bytes_ratio=3)
    with pytest.raises(TraceDivergenceError) as ei:
        jspmd.verify_consistent(t1, t3, bytes_ratio=1)
    pin = pa.Pencil(topo, (8, 8, 4), (1, 2))
    pout = pa.Pencil(topo, (8, 8, 4), (0, 2))
    R = tr.assert_compatible(pin, pout)
    m = AllToAll()
    aval = jspmd._input_aval(pin, (), np.dtype(np.float32))
    off = jspmd.trace_fn(
        tr._compiled_transpose(pin, pout, R, 0, m, False, pallas_enabled()),
        aval, source="guard-off")
    on = jspmd.trace_fn(
        tr._compiled_guarded_transpose(pin, pout, R, 0, m, False,
                                       pallas_enabled(), False),
        aval, source="guard-on")
    jspmd.verify_consistent(off, on)
    got = _port("consistency")
    assert got["t1"] == _ops(t1) and got["t3"] == _ops(t3)
    assert got["div"] == ei.value.op
    assert got["off"] == _ops(off)
    assert got["on_exchange"] == [o for o in _ops(on)
                                  if o[0] in jspmd.EXCHANGE_KINDS]


def test_donation_verified_and_missing_donation_typed(devices):
    from pencilarrays_tpu.analysis.errors import DonationError

    topo = pa.Topology((2, 4), devices=devices)
    route = plan_reshard_route(pa.Pencil(topo, (16, 12, 8), (1, 2)),
                               pa.Pencil(topo, (16, 12, 8), (0, 1)),
                               (), np.float32)
    donated = jspmd.trace_route(route, (), np.float32, donate=True)
    jspmd.verify_donation(donated)
    plain = jspmd.trace_route(route, (), np.float32, donate=False)
    with pytest.raises(DonationError):
        jspmd.verify_donation(plain)
    got = _port("donation")
    assert got == {"donated": list(donated.donated_params),
                   "plain": list(plain.donated_params)}


# ---------------------------------------------------------------------------
# pillar 1: certification sweep + journal
# ---------------------------------------------------------------------------


def test_plan_service_certify_sweep(devices, tmp_path, monkeypatch):
    from pencilarrays_tpu import obs
    from pencilarrays_tpu.cluster import elastic
    from pencilarrays_tpu.serve.service import PlanService

    jdir = str(tmp_path / "obs")
    monkeypatch.setenv(obs.ENV_VAR, jdir)
    svc = PlanService(max_batch=4)
    topo = pa.Topology((2, 2), devices=devices[:4])
    svc.register_plan("c2c", lambda ctx: PencilFFTPlan(
        topo, (8, 8, 4), dtype=np.complex64))
    svc.register_plan("r2c", lambda ctx: PencilFFTPlan(
        topo, (8, 8, 4), real=True))
    svc.registry.compiled(svc.plan("c2c"), (2,))
    try:
        report = svc.certify()
        keys = {n: svc.plan(n).plan_key() for n in ("c2c", "r2c")}
    finally:
        svc.close()
        elastic.unregister_plan("serve:c2c")
        elastic.unregister_plan("serve:r2c")
    monkeypatch.delenv(obs.ENV_VAR)
    assert report["ok"]
    got = _port("certify_sweep", str(tmp_path / "port"))
    assert got["keys"] == keys
    assert got["certified"] == report["certified"]
    assert got["targets"] == sorted(r["target"] for r in report["plans"])
    assert _canon(got["plans"]) == _canon(sorted(
        [r["target"], r["extra_dims"], r["ops"], r["predicted_bytes"]]
        for r in report["plans"]))


def test_certify_hbm_bounds_resident_batched_variant(devices):
    from pencilarrays_tpu.analysis.errors import HbmBoundError
    from pencilarrays_tpu.serve.service import PlanService

    svc = PlanService()
    topo = pa.Topology((2, 2), devices=devices[:4])
    plan = PencilFFTPlan(topo, (8, 8, 4), dtype=np.complex64)
    svc.registry.register(plan)
    svc.registry.compiled(plan, (16,))
    try:
        unbatched, _ = jspmd.predicted_peak_hbm(plan, ())
        batched, _ = jspmd.predicted_peak_hbm(plan, (16,))
        with pytest.raises(HbmBoundError):
            svc.certify(hbm_limit=unbatched)
        report = svc.certify(hbm_limit=unbatched, raise_on_error=False)
        bad = [r for r in report["plans"]
               if r["outcome"] == "HbmBoundError"]
        assert len(bad) == 1 and bad[0]["extra_dims"] == [16]
        assert svc.certify(hbm_limit=batched)["ok"]
    finally:
        svc.close()
    assert _port("certify_hbm") == {"peaks": [unbatched, batched],
                                    "bad": [16]}


def test_certify_failure_journaled_and_raised(devices, tmp_path,
                                              monkeypatch):
    from pencilarrays_tpu import obs
    from pencilarrays_tpu.analysis.errors import ScheduleMismatchError

    jdir = str(tmp_path / "obs")
    monkeypatch.setenv(obs.ENV_VAR, jdir)
    topo = pa.Topology((2, 2), devices=devices[:4])
    plan = PencilFFTPlan(topo, (8, 8, 4), dtype=np.complex64)
    real_costs = plan.collective_costs
    good = jspmd.trace_plan(plan, ())
    op = next(iter(good.stats()))

    def tampered(extra_dims=None, **kw):
        costs = real_costs(extra_dims, **kw)
        costs[op] = {"count": costs[op]["count"] + 1,
                     "bytes": costs[op]["bytes"]}
        return costs

    monkeypatch.setattr(plan, "collective_costs", tampered)
    with pytest.raises(ScheduleMismatchError) as ei:
        jspmd.certify_plan(plan, (), target="drill")
    events = [e for e in obs.read_journal(jdir)
              if e["ev"] == "analysis.check"]
    monkeypatch.delenv(obs.ENV_VAR)
    assert _port("certify_failure", str(tmp_path / "port")) == {
        "op": ei.value.op, "outcome": events[0]["outcome"]}


def test_serve_certify_engine_mode(devices):
    """``tests/test_engine.py::test_serve_certify_engine_mode``: serve
    traffic through an engine of two workers on two ranks, then prove
    the pipelined dispatch log equals the serialized schedule, each
    dispatch's collectives held to its plan's prediction."""
    from pencilarrays_tpu.engine import Engine
    from pencilarrays_tpu.serve import PlanService

    topo = pa.Topology((2,), devices=devices[:2])
    plan = PencilFFTPlan(topo, (8, 6, 4))
    rng = np.random.default_rng(3)
    engine = Engine("certify", workers=2)
    svc = PlanService(max_batch=4, max_wait_s=0.0, engine=engine)
    try:
        for _ in range(8):
            svc.submit("t0", (rng.standard_normal((8, 6, 4))
                              + 1j * rng.standard_normal((8, 6, 4))
                              ).astype(np.complex64), plan=plan)
        svc.drain()
        report = svc.certify(engine=True)
    finally:
        svc.close()
        engine.close()
    e = report["engine"]
    assert e["dispatches"] == 2 and e["verified_traces"] == 2
    got = _port("certify_engine")
    assert got == {k: e[k] for k in ("dispatches", "verified_traces",
                                     "unverified", "mode", "wire_checked",
                                     "ops")}


# ---------------------------------------------------------------------------
# pillar 2: the AST linter on fixture trees, through each package
# ---------------------------------------------------------------------------

_LINTS = {"pencilarrays_tpu": jlint, "pencilarrays_tpu_torch": plint}

_SCHEMA_PY = """
EVENT_TYPES = {"hop": ("method",), "run.start": ("pid",)}
"""

_FAULTS_PY = """
POINTS = frozenset({"io.open", "hop.exchange"})
"""

_ELASTIC_PY = """
def clear_plan_caches():
    from ..ops import fft as _fft

    for mod, names in ((_fft, ("_stage_fn",)),):
        pass
"""

# The fixtures that say the same thing in the port's idiom (file ->
# content), where a check reads the port's idiom; every other fixture is
# the JAX test's own content.
PORT_FIXTURES = {
    "ops/fft.py": """
        from functools import lru_cache
        import torch

        @lru_cache(maxsize=8)
        def _stage_fn(k):
            return torch.cuda.CUDAGraph()
        """,
    "serve/extra.py": """
        from functools import lru_cache
        import torch

        @lru_cache(maxsize=4)
        def _rogue_fn(n):
            return lambda x: torch.fft.rfftn(x, s=(n,))

        @lru_cache(maxsize=4)
        def _pure_table(n):
            return {"n": n}   # no executable: not a factory
        """,
    "ops/quant.py": """
        import torch

        def homebrew_pack(x):
            q = x.to(torch.float8_e4m3fn)
            return q.view(torch.float8_e5m2)

        def homebrew_scales(s):
            return s.view(torch.float8_e4m3fn)

        def string_spelling(x):
            return x.to(dtype="float8_e5m2")
        """,
    "parallel/wire.py": """
        import torch

        def _pack_fp8(x):
            q = x.to(torch.float8_e4m3fn)
            return q.view(torch.uint8)
        """,
    "io/benign.py": """
        import torch

        def widen(x):
            return x.to(torch.float32)
        """,
}

_JAX_FIXTURES = {
    "ops/fft.py": """
        from functools import lru_cache
        import jax

        @lru_cache(maxsize=8)
        def _stage_fn(k):
            return jax.jit(lambda x: x)
        """,
    "serve/extra.py": """
        from functools import lru_cache
        import jax

        @lru_cache(maxsize=4)
        def _rogue_fn(n):
            return jax.jit(lambda x: x * n)

        @lru_cache(maxsize=4)
        def _pure_table(n):
            return {"n": n}   # no jit: not an executable factory
        """,
    "ops/quant.py": """
        import jax
        import jax.numpy as jnp
        from jax.lax import bitcast_convert_type

        def homebrew_pack(x):
            q = x.astype(jnp.float8_e4m3fn)
            return jax.lax.bitcast_convert_type(q, jnp.uint8)

        def homebrew_scales(s):
            return bitcast_convert_type(s, jnp.uint8)

        def string_spelling(x):
            return x.astype("float8_e5m2")
        """,
    "parallel/wire.py": """
        import jax
        import jax.numpy as jnp

        def _pack_fp8(x):
            q = x.astype(jnp.float8_e4m3fn)
            return jax.lax.bitcast_convert_type(q, jnp.uint8)
        """,
    "io/benign.py": """
        import jax.numpy as jnp

        def widen(x):
            return x.astype(jnp.float32)
        """,
}


def _write(root, rel, content):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(content))
    return path


def _fixture_repo(tmp, package, extra_files=()):
    """The JAX tests' minimal repo skeleton for ``package`` (its
    schema/faults/elastic registries and docs corpus), plus the
    snippets under test."""
    fixtures = PORT_FIXTURES if package == "pencilarrays_tpu_torch" \
        else _JAX_FIXTURES
    root = str(tmp / package / "repo")
    _write(root, f"{package}/obs/schema.py", _SCHEMA_PY)
    _write(root, f"{package}/resilience/faults.py", _FAULTS_PY)
    _write(root, f"{package}/cluster/elastic.py", _ELASTIC_PY)
    _write(root, f"{package}/ops/fft.py", fixtures["ops/fft.py"])
    _write(root, "docs/Resilience.md", "| `io.open` | `hop.exchange` |")
    _write(root, "README.md", "PENCILARRAYS_TPU_OBS is documented here")
    for rel, content in extra_files:
        _write(root, f"{package}/{rel}", fixtures.get(rel, content))
    return root


def _both_lint(tmp_path, extra_files=(), check=None, docs=None):
    """Lint the fixture through each package; the ``(check, ident)``
    findings (of ``check`` only, when given) must be the same."""
    got = {}
    for package, lint in _LINTS.items():
        root = _fixture_repo(tmp_path, package, extra_files)
        if docs is not None:
            _write(root, "docs/Resilience.md", docs)
        got[package] = sorted((f.check, f.ident)
                              for f in lint.lint_tree(root)
                              if check is None or f.check == check)
    assert got["pencilarrays_tpu"] == got["pencilarrays_tpu_torch"], got
    return [ident for _, ident in got["pencilarrays_tpu"]]


def test_lint_clean_fixture_has_no_findings(tmp_path):
    assert _both_lint(tmp_path) == []


def test_lint_unregistered_journal_event(tmp_path):
    found = _both_lint(tmp_path, [("ops/thing.py", """
        def f(obs):
            obs.record_event("hop", method="x")       # registered
            obs.record_event("made.up", method="x")   # NOT
        """)], check="journal-event")
    assert found == ["made.up"]


def test_lint_undocumented_env_knob(tmp_path):
    found = _both_lint(tmp_path, [("knobs.py", """
        import os
        A = os.environ.get("PENCILARRAYS_TPU_OBS")       # documented
        B = os.environ.get("PENCILARRAYS_TPU_SECRET_K")  # NOT
        """)], check="env-knob")
    assert found == ["PENCILARRAYS_TPU_SECRET_K"]


def test_lint_unregistered_plan_cache(tmp_path):
    found = _both_lint(tmp_path, [("serve/extra.py", "")],
                       check="plan-cache")
    assert found == ["serve.extra._rogue_fn"]


def test_lint_fault_point_checks(tmp_path):
    found = _both_lint(tmp_path, [("io/x.py", """
        from ..resilience import faults

        def f():
            faults.fire("io.open")
            faults.fire("io.bogus")
        """), ("resilience/faults2.py", "")], check="fault-point",
        docs="| `io.open` |")
    assert found == ["hop.exchange", "io.bogus"]


def test_lint_unlocked_daemon_state(tmp_path):
    broken = """
        _pending = {}

        def note(k, v):
            _pending[k] = v
        """
    locked = """
        import threading

        _lock = threading.Lock()
        _pending = {}

        def note(k, v):
            with _lock:
                _pending[k] = v
        """
    readonly = """
        _TABLE = {"a": 1}

        def get(k):
            return _TABLE[k]
        """
    found = _both_lint(tmp_path, [
        ("obs/broken.py", broken), ("serve/lockedmod.py", locked),
        ("cluster/tables.py", readonly), ("parallel/free.py", broken)],
        check="unlocked-state")
    assert found == ["obs.broken._pending"]


def test_lint_thread_spawn_outside_engine(tmp_path):
    files = [("obs/rogue.py", """
        import threading

        def start_daemon():
            t = threading.Thread(target=print, daemon=True)
            t.start()
        """), ("io/sneak.py", """
        from threading import Thread

        def sneaky():
            Thread(target=print).start()
        """), ("cluster/ok.py", """
        def start(self):
            from ..engine.threads import spawn_thread

            self._t = spawn_thread(self._loop, name="pa-x")
        """), ("engine/threads.py", """
        import threading

        def spawn_thread(target, *, name):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            return t
        """)]
    found = _both_lint(tmp_path, files, check="thread-spawn")
    assert found == ["io.sneak.sneaky", "obs.rogue.start_daemon"]
    for package, lint in _LINTS.items():
        root = str(tmp_path / package / "repo")
        allow = _write(root, "allow.txt", """
            thread-spawn obs.rogue.start_daemon  # drill-only daemon
            thread-spawn io.sneak.sneaky  # legacy, tracked
            """)
        findings, _ = lint.run_lint(root, lint.Allowlist.load(allow))
        assert [f for f in findings if f.check == "thread-spawn"] == []


def test_lint_hop_peak_outside_sanctioned_modules(tmp_path):
    sanctioned = """
        def _hop_peak_bytes(pin, pout, R, extra, dtype, method=None):
            return 0

        def edge(pin, pout):
            return _hop_peak_bytes(pin, pout, 0, (), None)
        """
    found = _both_lint(tmp_path, [("ops/rogue_fft.py", """
        from ..parallel.routing import _hop_peak_bytes

        def my_own_bound(pin, pout, R):
            return _hop_peak_bytes(pin, pout, R, (), None)
        """), ("serve/sneak.py", """
        def sneaky(routing, pin, pout):
            return routing._hop_peak_bytes(pin, pout, None, (), None)
        """), ("parallel/routing.py", sanctioned),
        ("analysis/spmd.py", sanctioned), ("io/ok.py", """
        def bound(plan, limit):
            from ..analysis.spmd import step_hop_peak

            return step_hop_peak(plan, ())
        """)], check="hop-peak")
    assert found == ["ops.rogue_fft.<module>", "ops.rogue_fft.my_own_bound",
                     "serve.sneak.sneaky"]


def test_lint_trace_ctx_mint_choke_point(tmp_path):
    sanctioned = """
        def submit(requestflow):
            return requestflow.mint_trace()
        """
    found = _both_lint(tmp_path, [("io/rogue.py", """
        from ..obs.requestflow import mint_trace

        def helper():
            return mint_trace()
        """), ("fleet/router.py", sanctioned),
        ("serve/service.py", sanctioned)], check="trace-ctx")
    assert found == ["io.rogue.<module>", "io.rogue.helper"]


def test_lint_trace_ctx_wire_and_worker_propagation(tmp_path):
    found = _both_lint(tmp_path, [("fleet/router.py", """
        from . import wire

        def place(kv, tid, payload, trace):
            kv.set("k", wire.encode_request(
                tid, tenant="t", payload=payload, trace=trace))

        def rebind(kv, tid, payload):
            kv.set("k", wire.encode_request(
                tid, tenant="t", payload=payload))   # drops the trace

        def dynamic(kv, tid, kw):
            kv.set("k", wire.encode_request(tid, **kw))  # unknowable
        """), ("fleet/worker.py", """
        from ..obs import requestflow

        def take_good(service, req):
            with requestflow.installed(req.get("trace")):
                return service.submit(req["tenant"], req["payload"])

        def take_bad(service, req):
            return service.submit(req["tenant"], req["payload"])
        """)], check="trace-ctx")
    assert found == ["fleet.router.rebind", "fleet.worker.take_bad"]


def test_lint_trace_ctx_dispatch_meta_key(tmp_path):
    found = _both_lint(tmp_path, [("serve/service.py", """
        def _dispatch_meta(batch):
            return {"kind": batch.kind, "n": len(batch.entries)}
        """)], check="trace-ctx")
    assert found == ["serve.service._dispatch_meta"]
    assert _both_lint(tmp_path / "ok", [("serve/service.py", """
        def _dispatch_meta(batch):
            return {"kind": batch.kind, "trace": batch.entries[0].trace}
        """)], check="trace-ctx") == []


def test_lint_fp8_wire_casts_package_wide(tmp_path):
    found = _both_lint(tmp_path, [("ops/quant.py", ""),
                                  ("parallel/wire.py", ""),
                                  ("io/benign.py", "")], check="wire-cast")
    assert found == ["ops.quant.homebrew_pack", "ops.quant.homebrew_pack",
                     "ops.quant.homebrew_scales", "ops.quant.string_spelling"]
    assert jlint.WIRE_CAST_ALLOWLIST == plint.WIRE_CAST_ALLOWLIST == ()


def test_allowlist_roundtrip(tmp_path):
    for package, lint in _LINTS.items():
        root = _fixture_repo(tmp_path, package, [(
            "knobs.py",
            'import os\nB = os.environ.get("PENCILARRAYS_TPU_SECRET_K")\n')])
        allow = _write(root, "allow.txt", """
            # comment lines are fine
            env-knob PENCILARRAYS_TPU_SECRET_K  # internal-only drill knob
            env-knob PENCILARRAYS_TPU_NEVER_READ  # stale entry
            """)
        findings, al = lint.run_lint(root, lint.Allowlist.load(allow))
        assert findings == []
        assert al.unused() == ["env-knob PENCILARRAYS_TPU_NEVER_READ"]
        allow2 = _write(root, "allow2.txt", """
            env-knob PENCILARRAYS_TPU_SECRET_K
            """)
        findings, _ = lint.run_lint(root, lint.Allowlist.load(allow2))
        assert {"allowlist", "env-knob"} <= {f.check for f in findings}


def test_real_repo_lints_clean():
    """The port's tree: zero findings, and no stale allowlist entry."""
    findings, al = plint.run_lint(REPO_ROOT)
    assert findings == [], "\n".join(str(f) for f in findings)
    assert al.unused() == []
    assert al.path.endswith("pa-lint-torch.allow")


def test_finding_identity_is_stable():
    for lint in _LINTS.values():
        f = lint.Finding("env-knob", "a/b.py", 12, "PENCILARRAYS_TPU_X",
                         "msg")
        assert f.key == "env-knob PENCILARRAYS_TPU_X"
        assert "a/b.py:12" in str(f)
    assert jlint.CHECKS == plint.CHECKS


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------


def test_pa_lint_cli_exits_zero_on_repo():
    """The port's ``pa-lint`` over the repo, both pillars (the sweep on
    4 gloo ranks), in a subprocess as a console script would run it."""
    proc = subprocess.run(
        [sys.executable, "-m", "pencilarrays_tpu_torch.analysis", REPO_ROOT,
         "--devices", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "pa-lint: clean" in proc.stdout
    assert "0 lint finding(s)" in proc.stdout
    assert "spmd: ok       route donation" in proc.stdout


def test_pa_lint_cli_sweep_defaults_to_the_card():
    """Without ``--device`` the sweep runs on the card; a machine without
    one fails the gate instead of sweeping on the CPU unasked."""
    proc = subprocess.run(
        [sys.executable, "-m", "pencilarrays_tpu_torch.analysis", REPO_ROOT,
         "--devices", "4"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert "spmd: ERROR    spmd-sweep — no CUDA device" in proc.stdout
    assert "pa-lint: FAILED: 0 lint finding(s), 1 sweep failure(s)" \
        in proc.stdout


def test_pa_lint_cli_reports_findings(tmp_path):
    root = _fixture_repo(tmp_path, "pencilarrays_tpu_torch", [(
        "knobs.py",
        'import os\nB = os.environ.get("PENCILARRAYS_TPU_SECRET_K")\n')])
    proc = subprocess.run(
        [sys.executable, "-m", "pencilarrays_tpu_torch.analysis", root,
         "--no-spmd"],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert proc.returncode == 1
    assert "PENCILARRAYS_TPU_SECRET_K" in proc.stdout


def test_every_jax_analysis_case_has_a_counterpart():
    """The 28 cases of the JAX package's ``tests/test_analysis.py``."""
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_analysis.py")) as f:
        cases = set(re.findall(r"^def (test_\w+)\(", f.read(), re.M))
    assert len(cases) == 28
    assert cases <= set(globals())
