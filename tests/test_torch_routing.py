"""PyTorch port vs JAX package: the reshard route planner, Gspmd and
``reshard``.

* ``plan_reshard_route`` gives the JAX package's routes (hops, methods,
  priced costs, scores and charged peaks) on the graphs of
  ``tests/test_routing.py`` and ``tests/test_reshard_hbm.py``, with and
  without a wire, an explicit method, ``hbm_limit`` and ``donate``.
* Verdicts: where the two Gspmd baselines price alike, the verdicts agree.
  The JAX package prices its baseline from the partitioner's compiled HLO
  and the port prices its own one-call exchange; ``VERDICT_DIFFS`` lists
  the cases where the two baselines lead to different verdicts, with both
  scores, and the test holds that list exact.
* ``reshard`` on 1, 2, 4 and 8 gloo ranks gives the JAX package's bits on
  every path: the default, ``Gspmd()``, a forced ``AllToAll()``, a wired
  route, a time-sliced ``hbm_limit`` route with donation; and it raises
  ``HbmBoundError`` where the JAX package does.
"""

import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
from pencilarrays_tpu.parallel import routing as jrouting
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.parallel import routing as prouting
from pencilarrays_tpu_torch.parallel import transpositions as tr
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift

P201, P120 = (2, 0, 1), (1, 2, 0)

# (id, dims, shape, (src decomp, perm), (dest decomp, perm))
GRAPHS = [
    ("2x4-even-perm", (2, 4), (16, 12, 8), ((1, 2), P201), ((0, 1), P120)),
    ("4x2-even-perm", (4, 2), (16, 12, 8), ((1, 2), P201), ((0, 1), P120)),
    ("2x2-even-perm", (2, 2), (16, 12, 8), ((1, 2), P201), ((0, 1), P120)),
    ("2x4-ragged-perm", (2, 4), (13, 10, 9), ((1, 2), P201), ((0, 1), P120)),
    ("4x2-ragged-perm", (4, 2), (13, 10, 9), ((1, 2), P201), ((0, 1), P120)),
    ("2x2-ragged-perm", (2, 2), (13, 10, 9), ((1, 2), P201), ((0, 1), P120)),
    ("default-reshard", (2, 4), (11, 9, 14), ((1, 2), None), ((0, 1), P201)),
    ("slot-swap", (2, 4), (10, 12, 8), ((1, 2), None), ((2, 1), None)),
    ("fully-decomposed", (2, 4), (8, 12), ((0, 1), None), ((1, 0), None)),
    ("single-slot", (2, 4), (16, 12, 8), ((1, 2), None), ((0, 2), None)),
    ("two-hop", (2, 4), (16, 12, 8), ((1, 2), None), ((0, 1), None)),
    ("cheaper-of-two", (2, 4), (9, 8, 6, 4), ((2, 3), None), ((0, 1), None)),
    ("ragged-perm-in", (2, 4), (13, 10, 9), ((1, 2), P201), ((0, 1), None)),
    ("one-rank", (1, 1), (16, 12, 8), ((1, 2), P201), ((0, 1), P120)),
    ("slab-8", (8,), (12, 10, 9), ((0,), None), ((2,), P201)),
]

METHODS = [("Auto", jpa.Auto(), pat.Auto()),
           ("AllToAll", jpa.AllToAll(), pat.AllToAll()),
           ("Ring", jpa.Ring(), pat.Ring()),
           ("Pipelined2", jpa.Pipelined(2), pat.Pipelined(2)),
           ("Auto-bf16", jpa.Auto(wire_dtype="bf16"),
            pat.Auto(wire_dtype="bf16")),
           ("AllToAll-e4m3", jpa.AllToAll(wire_dtype="fp8_e4m3"),
            pat.AllToAll(wire_dtype="fp8_e4m3"))]

# (graph, method) whose verdict differs, for every extra dims and dtype
# tried, because the baselines differ: JAX's partitioner compiles these
# reshards to two collectives, the port's Gspmd is one call, so JAX routes
# where the port keeps its Gspmd exchange.  Scores (route, JAX's Gspmd,
# the port's Gspmd) for f32 without extra dims: 2x4-even-perm Auto-bf16
# 263488, 263680, 131840; 4x2-ragged-perm Auto 263904, 395296, 131852;
# slab-8 Auto-bf16 132192, 132352, 131792.  The test recomputes them all.
VERDICT_DIFFS = {(g, "Auto-bf16") for g in (
    "2x4-even-perm", "4x2-even-perm", "2x2-even-perm", "2x4-ragged-perm",
    "4x2-ragged-perm", "2x2-ragged-perm", "default-reshard", "two-hop",
    "cheaper-of-two", "ragged-perm-in", "slab-8")} | {
    ("4x2-ragged-perm", "Auto")}


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


def _pencils(devices, dims, shape, src, dest):
    jt = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    pt = pat.Topology(dims, device="cpu")

    def mk(mod, topo, spec):
        d, p = spec
        return mod.Pencil(topo, shape, d, permutation=None if p is None
                          else mod.Permutation(*p))

    return (mk(jpa, jt, src), mk(jpa, jt, dest), mk(pat, pt, src),
            mk(pat, pt, dest))


def _summary(route):
    label = (tr._method_label if isinstance(route, prouting.ReshardRoute)
             else jpa.parallel.transpositions._method_label)
    return dict(
        hops=[(h.src.decomposition, h.dest.decomposition,
               label(h.method), h.cost, h.score_bytes,
               h.peak_hbm_bytes) for h in route.hops],
        score=route.score_bytes, peak=route.peak_hbm_bytes,
        searched=route.searched_nodes)


def _ids(pairs):
    return [f"{g[0]}-{m[0]}" for g, m in pairs]


_PAIRS = [(g, m) for g in GRAPHS for m in METHODS
          if not (g[0] == "fully-decomposed" and "e4m3" in m[0])]


@pytest.mark.parametrize("graph,method", _PAIRS, ids=_ids(_PAIRS))
def test_route_matches_jax(devices, graph, method):
    gid, dims, shape, src, dest = graph
    _, jm, pm = method
    jin, jout, pin, pout = _pencils(devices, dims, shape, src, dest)
    for extra in ((), (3,)):
        for dt, pdt in ((np.float32, torch.float32),
                        (np.complex128, torch.complex128)):
            want = jrouting.plan_reshard_route(jin, jout, extra, dt,
                                               method=jm)
            got = prouting.plan_reshard_route(pin, pout, extra, pdt,
                                              method=pm)
            assert _summary(got) == _summary(want)
            if want.verdict.startswith("gspmd:") or want.gspmd_cost is None:
                assert got.verdict == want.verdict
                continue
            if got.gspmd_cost == want.gspmd_cost:
                assert (got.verdict, got.use_route) == (want.verdict,
                                                        want.use_route)
                continue
            scores = (got.score_bytes, want.gspmd_score_bytes,
                      got.gspmd_score_bytes)
            if (gid, method[0]) in VERDICT_DIFFS:
                assert (want.verdict, got.verdict) == ("routed", "gspmd"), \
                    scores
                assert scores[2] <= scores[0] < scores[1], scores
            else:
                assert got.verdict == want.verdict, scores
            # each verdict follows its own baseline
            assert got.use_route == (got.score_bytes < got.gspmd_score_bytes)


# test_reshard_hbm.py: (dims, shape, perms) x wire, a limit just below the
# donated single-shot route's peak
HBM_CASES = [(dims, shape, pi, po, wire)
             for dims in ((2, 4), (4, 2), (2, 2))
             for shape, pi, po in (((16, 12, 8), None, None),
                                   ((13, 10, 9), None, None),
                                   ((16, 12, 8), P201, P120),
                                   ((13, 10, 9), P201, None))
             for wire in (None, "bf16")]


@pytest.mark.parametrize("case", HBM_CASES, ids=[
    f"{'x'.join(map(str, c[0]))}-{'x'.join(map(str, c[1]))}-"
    f"{'perm' if c[2] else 'id'}{'-perm' if c[3] else ''}-{c[4]}"
    for c in HBM_CASES])
def test_chunked_routes_match_jax(devices, case):
    dims, shape, pi, po, wire = case
    jin, jout, pin, pout = _pencils(devices, dims, shape, ((1, 2), pi),
                                    ((0, 1), po))
    jm, pm = jpa.AllToAll(wire_dtype=wire), pat.AllToAll(wire_dtype=wire)
    un = jrouting.plan_reshard_route(jin, jout, (), np.float32, method=jm,
                                     donate=True)
    lim = un.peak_hbm_bytes - 1
    for donate in (True, False):
        want = jrouting.plan_reshard_route(jin, jout, (), np.float32,
                                           method=jm, hbm_limit=lim,
                                           donate=donate)
        got = prouting.plan_reshard_route(pin, pout, (), torch.float32,
                                          method=pm, hbm_limit=lim,
                                          donate=donate)
        assert _summary(got) == _summary(want)
        assert (got.verdict, got.use_route) == (want.verdict, want.use_route)


def test_hand_computed_admission_matches_jax(devices):
    """The hand-computed limits of ``test_reshard_hbm.py``: 1536 bytes
    single shot, K = 2 chunks under 1535, the 4-hop detour at 1151 and
    1024, exhaustion at 1023, and the wire's packed share."""
    jin, jout, pin, pout = _pencils(devices, (2, 4), (16, 12, 8),
                                    ((1, 2), None), ((0, 1), None))
    for wire in (None, "bf16", "fp8_e5m2"):
        for lim in (None, 1535, 1152, 1151, 1024, 1023, 960, 959):
            for donate in (True, False):
                want = jrouting.plan_reshard_route(
                    jin, jout, (), np.float32,
                    method=jpa.AllToAll(wire_dtype=wire), hbm_limit=lim,
                    donate=donate)
                got = prouting.plan_reshard_route(
                    pin, pout, (), torch.float32,
                    method=pat.AllToAll(wire_dtype=wire), hbm_limit=lim,
                    donate=donate)
                assert _summary(got) == _summary(want)
                assert got.verdict == want.verdict
    route = prouting.plan_reshard_route(pin, pout, (), torch.float32,
                                        method=pat.AllToAll(),
                                        hbm_limit=1151, donate=True)
    assert [h.dest.decomposition for h in route.hops] == [
        (1, 0), (2, 0), (2, 1), (0, 1)]
    assert route.peak_hbm_bytes == 1024
    assert prouting.reshard_key(pin, pout, torch.float32) == \
        jrouting.reshard_key(jin, jout, np.float32)


def test_drift_samples_steer_the_route(devices, monkeypatch):
    """``tests/test_routing.py``'s drift case: the same trusted samples in
    both trackers (the (2,3)->(2,1) hop far over its byte model, the
    (2,3)->(0,3) hop under it) flip both planners onto the same route,
    with the same scores; the port's search given JAX's report as its
    explicit drift dict agrees too.  Dispatch samples steer neither, and
    the port's planner drops drift in a world of more than one process."""
    shape = (9, 8, 6, 4)
    jin, jout, pin, pout = _pencils(devices, (2, 4), shape,
                                    ((2, 3), None), ((0, 1), None))
    jv21, jv03 = (jpa.Pencil(jin.topology, shape, d)
                  for d in ((2, 1), (0, 3)))
    pv21, pv03 = (pat.Pencil(pin.topology, shape, d)
                  for d in ((2, 1), (0, 3)))
    base = [(2, 1), (0, 1)]
    for plan in (jpa.plan_reshard_route(jin, jout, (), np.float32),
                 prouting.plan_reshard_route(pin, pout, (), torch.float32)):
        assert [h.dest.decomposition for h in plan.hops] == base
    samples = [((jin, jv21), (pin, pv21), 216 * 4, 1.0),
               ((jin, jv03), (pin, pv03), 240 * 4, 1e-7)]
    for (ja, jb), (pa_, pb), nbytes, secs in samples:
        jl = jpa.parallel.transpositions._hop_label(ja, jb, jpa.AllToAll(),
                                                    np.float32)
        pl = tr._hop_label(pa_, pb, pat.AllToAll(), torch.float32)
        assert jl == pl
        jax_drift.drift_tracker.record(jl, nbytes, secs, source="benchtime")
        port_drift.drift_tracker.record(pl, nbytes, secs, source="benchtime")
        # per-dispatch lower bounds: ignored by both planners
        for t in (jax_drift.drift_tracker, port_drift.drift_tracker):
            t.record(pl, nbytes, 50.0, source="dispatch")
    assert port_drift.drift_tracker.report() == \
        jax_drift.drift_tracker.report()
    want = jpa.plan_reshard_route(jin, jout, (), np.float32)
    got = prouting.plan_reshard_route(pin, pout, (), torch.float32)
    explicit = prouting.plan_reshard_route(
        pin, pout, (), torch.float32,
        _drift=jax_drift.drift_tracker.report()["hops"])
    assert [h.dest.decomposition for h in want.hops] == [(0, 3), (0, 1)]
    assert _summary(got) == _summary(want) == _summary(explicit)
    assert prouting.trusted_drift_hops()
    monkeypatch.setenv("PENCILARRAYS_TPU_CLUSTER_WORLD", "2")
    assert prouting.trusted_drift_hops() == {}
    multi = prouting.plan_reshard_route(pin, pout, (), torch.float32)
    assert [h.dest.decomposition for h in multi.hops] == base


def test_gspmd_cost_is_the_same_on_every_rank():
    """The port's Gspmd price is a function of the two pencils: the
    largest per-rank send, one call; nothing when no element moves."""
    topo = pat.Topology((2, 4), device="cpu")
    pin = pat.Pencil(topo, (13, 10, 9), (1, 2))
    pout = pat.Pencil(topo, (13, 10, 9), (0, 1))
    cost = tr.gspmd_reshard_cost(pin, pout, (3,), torch.float64)
    sends = [sum(tr._numel(x) for x in row)
             for row in tr._gspmd_plan(pin, pout)]
    assert cost == {"all-to-all": {"count": 1,
                                   "bytes": max(sends) * 3 * 8}}
    assert min(sends) < max(sends)   # ragged: ranks send unequal pieces
    assert pat.transpose_cost(pin, pin.replace(decomp_dims=(0, 2)), (),
                              torch.float32, pat.Gspmd()) == \
        tr.gspmd_reshard_cost(pin, pin.replace(decomp_dims=(0, 2)))
    assert tr.gspmd_reshard_cost(pin, pin.replace(permutation=P201)) == {}
    one = pat.Topology((1, 1), device="cpu")
    assert tr.gspmd_reshard_cost(pat.Pencil(one, (4, 4, 4), (1, 2)),
                                 pat.Pencil(one, (4, 4, 4), (0, 1))) == {}


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


@pytest.mark.parametrize("dims", [(1, 1), (2, 1), (1, 2)])
def test_hops_across_no_rank_run_as_one_permute(devices, pool, dims):
    """``execute_route`` runs each run of unwired hops over size-1 axes as
    one local permute (the JAX package's fused chain holds no collective
    there, and ``transpose_cost`` prices none): every rank issues the
    route's priced exchange calls and no other, and moves JAX's bits."""
    shape = (12, 10, 8)
    src, dest = ((1, 2), None), ((2, 0), None)
    jin, jout, pin, pout = _pencils(devices, dims, shape, src, dest)
    u = _global(shape)
    want = np.asarray(jpa.reshard(jpa.PencilArray.from_global(jin, u), jout,
                                  method=jpa.Pipelined(4)).data)
    got = pool.run(tasks.reshard_case, dims, shape, src, dest, u,
                   [dict(method=pat.Pipelined(4))])[0][0]
    np.testing.assert_array_equal(got["padded"].view(np.uint8),
                                  want.view(np.uint8))
    route = prouting.plan_reshard_route(pin, pout, (), torch.float64,
                                        method=pat.Pipelined(4))
    crossing = [h.method for h in route.hops
                if dims[tr.assert_compatible(h.src, h.dest)] > 1]
    priced = sum(h.cost.get("all-to-all", {}).get("count", 0)
                 for h in route.hops)
    assert {c[0]["all-to-all"] for c in got["calls"]} == {priced}
    assert (priced > 0) == bool(crossing)
    stages = prouting._stages(route)
    assert [m for _, _, m in stages if m is not None] == crossing
    assert all(a[2] is not None or b[2] is not None
               for a, b in zip(stages, stages[1:]))
    if not crossing:
        assert len(stages) == 1 < len(route.hops)


def _global(shape):
    n = int(np.prod(shape))
    return ((np.arange(n, dtype=np.float64).reshape(shape) + 1.0) / 3.0)


RESHARD_CASES = [
    ("1x1", (1, 1), (16, 12, 8), ((1, 2), P201), ((0, 1), P120)),
    ("2", (2,), (10, 7, 6), ((0,), None), ((2,), P201)),
    ("2x2", (2, 2), (13, 10, 9), ((1, 2), P201), ((0, 1), P120)),
    ("2x4", (2, 4), (16, 12, 8), ((1, 2), None), ((0, 1), None)),
    ("4x2-ragged", (4, 2), (13, 10, 9), ((1, 2), P201), ((0, 1), None)),
    ("2x4-swap", (2, 4), (10, 12, 8), ((1, 2), None), ((2, 1), None)),
    ("2x4-full", (2, 4), (8, 12), ((0, 1), None), ((1, 0), None)),
]


@pytest.mark.parametrize("case", RESHARD_CASES, ids=[c[0] for c in
                                                     RESHARD_CASES])
def test_reshard_bit_identical_to_jax(devices, pool, case):
    cid, dims, shape, src, dest = case
    jin, jout, pin, pout = _pencils(devices, dims, shape, src, dest)
    u = _global(shape)
    want = np.asarray(jpa.reshard(jpa.PencilArray.from_global(jin, u), jout,
                                  method=jpa.Gspmd()).data)
    full = len(dims) == len(shape)
    runs = [dict(), dict(method=pat.Gspmd()), dict(donate=True)]
    jwired = None
    if not full:
        lim = prouting.plan_reshard_route(pin, pout, (), torch.float64,
                                          method=pat.AllToAll(),
                                          donate=True).peak_hbm_bytes - 1
        runs += [dict(method=pat.AllToAll()),
                 dict(method=pat.AllToAll(wire_dtype="bf16")),
                 dict(hbm_limit=lim, donate=True)]
        jwired = np.asarray(jpa.reshard(
            jpa.PencilArray.from_global(jin, u), jout,
            method=jpa.AllToAll(wire_dtype="bf16")).data)
    got = pool.run(tasks.reshard_case, dims, shape, src, dest, u, runs)[0]
    n = int(np.prod(dims))
    for kwargs, res in zip(runs, got):
        if "hbm_limit" in kwargs and n == 1:
            # a size-1 axis is never time-sliced (nothing crosses a
            # link), so no route meets the limit, in both packages
            from pencilarrays_tpu.analysis.errors import HbmBoundError

            assert res["error"][0] == "HbmBoundError"
            with pytest.raises(HbmBoundError):
                jpa.reshard(jpa.PencilArray.from_global(jin, u), jout,
                            **kwargs)
            continue
        assert "error" not in res, (kwargs, res)
        ref = jwired if _is_wired(kwargs) else want
        np.testing.assert_array_equal(res["padded"].view(np.uint8),
                                      ref.view(np.uint8))
        if not _is_wired(kwargs):
            np.testing.assert_array_equal(res["glob"], u)
        assert res["deleted"] == bool(kwargs.get("donate"))
        if isinstance(kwargs.get("method"), pat.Gspmd) or \
                res["verdict"] in ("gspmd", "gspmd:no-route"):
            # one exchange call on more than one rank, none on one
            assert {c[0]["all-to-all"] for c in res["calls"]} == {
                1 if n > 1 else 0}
        if "hbm_limit" in kwargs and not full and n > 1:
            assert res["verdict"] == "routed:hbm"
            assert any(m == "Pipelined" for _, m in res["hops"])
    # JAX's planner, run on the same graph, picks the same hops
    for kwargs, res in zip(runs, got):
        if res.get("hops") is None or _is_wired(kwargs):
            continue
        jkw = {k: v for k, v in kwargs.items() if k != "method"}
        if "method" in kwargs:
            jkw["method"] = jpa.AllToAll()
        jroute = jrouting.plan_reshard_route(jin, jout, (), np.float64,
                                             **jkw)
        assert [(h.dest.decomposition, type(h.method).__name__)
                for h in jroute.hops] == [tuple(h) for h in res["hops"]]


def _is_wired(kwargs):
    return tr._method_wire(kwargs.get("method")) is not None


def test_reshard_errors_match_jax(devices, pool):
    """An ``hbm_limit`` no route meets raises ``HbmBoundError``, and
    ``Gspmd()`` cannot be bounded, in both packages."""
    from pencilarrays_tpu.analysis.errors import HbmBoundError as JErr

    shape = (16, 12, 8)
    jin, jout, pin, pout = _pencils(devices, (2, 4), shape,
                                    ((1, 2), None), ((0, 1), None))
    u = _global(shape)
    with pytest.raises(JErr):
        jpa.reshard(jpa.PencilArray.from_global(jin, u), jout,
                    hbm_limit=1023, donate=True)
    with pytest.raises(ValueError, match="Gspmd"):
        jpa.reshard(jpa.PencilArray.from_global(jin, u), jout,
                    method=jpa.Gspmd(), hbm_limit=1 << 30)
    got = pool.run(tasks.reshard_case, (2, 4), shape, ((1, 2), None),
                   ((0, 1), None), u,
                   [dict(hbm_limit=255, donate=True),
                    dict(method=pat.Gspmd(), hbm_limit=1 << 30)])[0]
    assert got[0]["error"][0] == "HbmBoundError"
    assert got[1]["error"][0] == "ValueError" and "Gspmd" in got[1][
        "error"][1]


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
@pytest.mark.parametrize("wire", ["bf16", "f16", "fp8_e4m3", "fp8_e5m2"])
def test_wired_route_across_no_rank_keeps_each_hops_bits(wire, guarded,
                                                         tmp_path,
                                                         monkeypatch):
    """A route whose wired hops cross no rank runs as one K1 permute and
    each hop's wire round trip in place (slab by slab, within the route's
    modeled peak): the bits of running its hops one by one, the input
    untouched, with the guard's probes too."""
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.parallel import wire as pwire

    monkeypatch.setattr(pwire, "SLAB_ELEMS", 64)
    monkeypatch.setattr(pwire, "ROUNDTRIP_SLAB_ELEMS", 96)
    if guarded:
        guard.enable(str(tmp_path / "bundles"))
    try:
        topo = pat.Topology.unconnected((1, 1), "cpu")
        for dtype, shape, extra in ((torch.float32, (24, 20, 300), ()),
                                    (torch.complex64, (8, 10, 260), (3,))):
            px = pat.Pencil(topo, shape, (1, 2),
                            permutation=pat.Permutation(1, 2, 0))
            pd = pat.Pencil(topo, shape, (2, 0),
                            permutation=pat.Permutation(2, 0, 1))
            g = torch.Generator().manual_seed(5)
            data = torch.randn(px.padded_size_local(pat.MemoryOrder) + extra,
                               generator=g, dtype=dtype)
            if not guarded:      # the guard's content sums reject NaN
                data.view(-1)[:5] = float("nan")
            keep = data.clone()
            x = pat.PencilArray(px, data, extra)
            m = pat.AllToAll(wire_dtype=wire)
            route = prouting.plan_reshard_route(px, pd, extra, dtype,
                                                method=m)
            assert [type(st[2]).__name__ for st in
                    prouting._stages(route)] == ["_LocalRun"]
            got = pat.reshard(x, pd, method=m)
            v = x
            for h in route.hops:
                v = pat.transpose(v, h.dest, method=h.method)
            assert torch.equal(got.data.view(torch.uint8),
                               v.data.view(torch.uint8))
            assert torch.equal(data.view(torch.uint8), keep.view(torch.uint8))
    finally:
        guard.disable()
