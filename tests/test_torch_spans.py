"""The port's spans at its layer boundaries (``obs.span``) and the
benchmark's attribution of device time to them (``pabench/span_reduce``).

A profiled run names every span of ``pabench/data/spans.json`` with its
nesting and moves the same bits as a plain run; a span with nothing
listening enters nothing; with observability on, ``span.seconds`` holds
host seconds on the CPU and drains the card's event pairs without a
wait; the reducer puts every device operation down once, to the
innermost span of its launch.
"""

import inspect
import json
import random
from contextlib import nullcontext
from types import SimpleNamespace

import pytest
import torch

import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pabench import harness
from pabench import profile_reduce as pr
from pabench import span_reduce as sr
from pencilarrays_tpu_torch import obs
from pencilarrays_tpu_torch.obs import events, metrics, tracing
from pencilarrays_tpu_torch.utils import timers

NAMES = sorted(sr.span_layers())


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PENCILARRAYS_TPU_OBS", raising=False)
    events._reset_for_tests()
    metrics.registry.reset()
    tracing._pending.clear()
    yield
    events._reset_for_tests()
    metrics.registry.reset()
    tracing._pending.clear()
    timers.disable_debug_timings()


@pytest.fixture(scope="module")
def profiled():
    return tasks.shared_pool(1).run(tasks.spans_case, NAMES)[0]


def _ancestors(spans):
    """Each span's name and the names of the spans enclosing it on its
    thread, outermost first."""
    out = []
    for i, (name, s, e, t) in enumerate(spans):
        outer = [(s2, -(e2 - s2), n2)
                 for j, (n2, s2, e2, t2) in enumerate(spans)
                 if j != i and t2 == t and s2 <= s and e <= e2
                 and e2 - s2 > e - s]
        out.append((name, [n for _, _, n in sorted(outer)]))
    return out


def test_every_span_appears_with_its_nesting(profiled):
    found = _ancestors(profiled["spans"])
    counts = {n: sum(1 for m, _ in found if m == n) for n in NAMES}
    # one NS step (two nonlinear terms), one round trip, a 4-hop cycle
    assert counts == {"ns.step": 1, "ns.nonlinear": 2, "plan.forward": 3,
                      "plan.backward": 3, "stage_compute": 6,
                      "transpose!": 4, "pack_data": 4, "exchange": 8,
                      "unpack_data": 4}
    for name, outer in found:
        if name in ("pack_data", "exchange", "unpack_data"):
            assert outer[-1] == "transpose!", (name, outer)
        if name == "stage_compute":
            assert outer[-1] in ("plan.forward", "plan.backward"), outer
        if name == "ns.nonlinear":
            assert outer == ["ns.step"]
    in_model = [outer for name, outer in found
                if name == "stage_compute" and "ns.nonlinear" in outer]
    assert len(in_model) == 4
    assert all(outer[:2] == ["ns.step", "ns.nonlinear"]
               for outer in in_model)


def test_profiled_run_moves_the_same_bits(profiled):
    assert len(profiled["same"]) == 7 and all(profiled["same"])


@pytest.mark.parametrize("name", NAMES)
def test_span_name_holds_no_kernel_group_substring(name):
    words = [w for _, ws in pr.kernel_groups() for w in ws]
    assert not [w for w in words if w in name], name


def test_spans_file_names_benchmark_layers():
    bench = json.loads((harness.PKG.parent / "BENCHMARK.json").read_text())
    layers = {m["layer"] for m in bench["per_layer"]}
    assert set(sr.span_layers().values()) <= layers


def _cpu_hop():
    topo = pat.Topology((1, 1), device="cpu")
    px = pat.Pencil(topo, (6, 5, 4), (1, 2))
    py = pat.Pencil(topo, (6, 5, 4), (0, 2))
    u = pat.PencilArray(px, torch.randn(px.padded_size_local(
        pat.MemoryOrder)))
    return u, py


def test_span_with_nothing_listening_enters_nothing(monkeypatch):
    entered = []

    def spy(label):
        entered.append(label)
        return nullcontext()

    monkeypatch.setattr(tracing, "record_function", spy)
    timer = pat.TimerOutput()
    assert not obs.enabled() and not timers.timings_enabled()
    assert tracing.span("x", timer=timer) is tracing._OFF
    with obs.span("pack data", timer=timer):
        pass
    u, py = _cpu_hop()
    pat.transpose(u, py)
    assert entered == [] and timer.snapshot()["children"] == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span("pack data"):
            pass
    assert entered == ["pack_data"]


def test_timings_feed_the_timer_alone(monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda label: entered.append(label) or nullcontext())
    timer = pat.TimerOutput()
    timers.enable_debug_timings()
    with obs.span("transpose!", timer=timer):
        pass
    assert entered == []
    assert timer.snapshot()["children"]["transpose!"]["ncalls"] == 1


def test_span_seconds_on_the_cpu_and_no_dispatch_seconds(tmp_path):
    obs.enable(str(tmp_path))
    u, py = _cpu_hop()
    pat.transpose(u, py)
    snap = obs.snapshot()
    obs.disable()
    hist = snap["histograms"]
    assert hist["span.seconds{label=transpose!}"]["count"] == 1
    for phase in ("pack_data", "exchange", "unpack_data"):
        assert hist[f"span.seconds{{label={phase}}}"]["count"] >= 1
    assert not [k for k in hist if k.startswith("transpose.dispatch")]
    assert snap["counters"]["transpose.dispatches{method=AllToAll}"] == 1


class _FakeEvent:
    """A CUDA event on a fake clock: ``ready`` once the test says so."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t, self.ready = None, False

    def record(self, stream=None):
        _FakeEvent.clock += 2.0
        self.t = _FakeEvent.clock

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True

    def elapsed_time(self, end):
        assert self.ready and end.ready
        return end.t - self.t


def test_card_spans_are_drained_without_a_wait(tmp_path, monkeypatch):
    made = []

    def event(enable_timing=False):
        made.append(_FakeEvent(enable_timing))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "Event", event)
    obs.enable(str(tmp_path))
    with obs.span("a"):
        pass
    key = "span.seconds{label=a}"
    assert len(tracing._pending) == 1 and len(made) == 2
    made[0].ready = made[1].ready = True
    with obs.span("b"):
        pass
    # "a" finished on the card and was taken at "b"'s end; "b" was not
    assert [p[0] for p in tracing._pending] == ["b"]
    assert metrics.registry.histogram("span.seconds", label="a").count == 1
    snap = obs.snapshot()
    obs.disable()
    assert not tracing._pending
    assert snap["histograms"][key]["last"] == pytest.approx(2.0 / 1e3)
    assert snap["histograms"]["span.seconds{label=b}"]["count"] == 1


def test_plan_stamp_names_what_it_could_not_read():
    class Plan:
        transforms = ("rfft", "fft", "fft")
        shape_physical = (8, 6, 4)
        topology = pat.Topology((1, 1), device="cpu")
        pipeline_chunks = None
        _steps = (("f",),)

        def collective_costs(self):
            raise RuntimeError("no pencils")

    stamp = tracing._plan_stamp(Plan())
    assert stamp["transforms"] == ["rfft", "fft", "fft"]
    assert stamp["steps"] == ["f"] and "predicted_costs" not in stamp
    assert stamp["error"] == "predicted_costs: RuntimeError: no pencils"
    plan = pat.PencilFFTPlan(pat.Topology((1, 1), device="cpu"), (8, 6, 4),
                             real=True)
    assert "error" not in tracing._plan_stamp(plan)


# -- the reducer, on synthetic event lists -----------------------------------

GROUPS = [("cufft", ("fft",)), ("k1_permute", ("permute_",)),
          ("elementwise", ("elementwise_kernel",))]


def test_innermost_span_of_the_launch():
    spans = [("ns.step", 0, 100, 1), ("ns.nonlinear", 10, 50, 1),
             ("plan.forward", 20, 40, 1), ("transpose!", 60, 90, 1)]
    launches = {1: (5, 1), 2: (15, 1), 3: (30, 1), 4: (70, 1),
                5: (200, 1), 6: (30, 2)}
    ops = [("elementwise_kernel_a", 101, 7, 1),
           ("elementwise_kernel_b", 102, 5, 2),
           ("regular_fft_c", 103, 11, 3),
           ("permute_flat", 104, 13, 4),
           ("elementwise_kernel_d", 105, 17, 5),
           ("elementwise_kernel_e", 106, 19, 6),
           ("Memcpy DtoD", 107, 23, 7)]
    att = sr.attribute(ops, launches, spans, GROUPS)
    ns = 1e-9
    assert att.seconds == pytest.approx({
        "ns.step": 7 * ns, "ns.nonlinear": 5 * ns, "plan.forward": 11 * ns,
        "transpose!": 13 * ns, sr.UNSPANNED: (17 + 19 + 23) * ns})
    assert att.count == {"ns.step": 1, "ns.nonlinear": 1, "plan.forward": 1,
                         "transpose!": 1, sr.UNSPANNED: 3}
    assert att.group_seconds[("plan.forward", "cufft")] == pytest.approx(
        11 * ns)
    assert att.under_seconds["ns.step"] == pytest.approx(
        (7 + 5 + 11 + 13) * ns)
    assert att.under_seconds["ns.nonlinear"] == pytest.approx(16 * ns)
    assert att.ops == 7 and att.spans_seen == 4


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_every_operation_is_put_down_once(seed):
    rng = random.Random(seed)
    spans, t = [], 0
    for _ in range(40):            # nested runs of spans on two threads
        tid = rng.choice((1, 2))
        depth = rng.randint(1, 3)
        s, e = t, t + 1000
        for d in range(depth):
            spans.append((NAMES[rng.randrange(len(NAMES))], s, e, tid))
            s, e = s + rng.randint(1, 100), e - rng.randint(1, 100)
        t += 1000 + rng.randint(0, 50)
    launches = {c: (rng.randint(0, t), rng.choice((1, 2)))
                for c in range(1, 500)}
    ops = [(rng.choice(["fft_x", "permute_y", "elementwise_kernel", "z"]),
            0, rng.randint(1, 1000), c) for c in range(1, 520)]
    att = sr.attribute(ops, launches, spans, GROUPS)
    assert att.ops == len(ops) and sum(att.count.values()) == len(ops)
    assert sum(att.seconds.values()) == pytest.approx(att.total_s)
    assert sum(att.group_seconds.values()) == pytest.approx(att.total_s)
    assert att.total_s == pytest.approx(sum(o[2] for o in ops) / 1e9)


class _Event:
    """One event of a finished ``torch.profiler`` trace, as
    ``kineto_results.events()`` yields it."""

    def __init__(self, name, start, dur, device=False, corr=0, tid=1):
        self._v = (name, start, dur, corr, tid)
        self._device = device

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._device
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False


class _Profile:
    """A finished profile of one window: ``spans`` and ``launches``
    (correlation id: host start) on thread 1, and ``ops`` (name, device
    ns, correlation id), one every 10 us on the card."""

    def __init__(self, spans, launches, ops):
        ms = 1_000_000
        ev = [_Event(pr.WINDOW_SPAN, 0, 1000 * ms)]
        ev += [_Event(n, s, e - s) for n, s, e in spans]
        ev += [_Event("cudaLaunchKernel", t, 1, corr=c)
               for c, t in launches.items()]
        t = 0
        for name, dur, corr in ops:
            ev.append(_Event(name, t, dur, device=True, corr=corr))
            t += 10_000 + dur
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: ev))


NEW_METRICS = ("model_self_ms", "model_ops", "plan_other_ms",
               "exchange_span_ms", "transpose_span_roofline_pct",
               "unspanned_pct")


def _read_window(prof, steps=2, transpose_bytes=22_000_000_000):
    """The per-layer metrics of a traced window, read as a run reads
    them: ``harness._per_layer`` on the finished profile."""
    metrics, _, _, _ = harness._per_layer(
        prof, steps, 1.0, {"k1_launches": 0, "k1_bytes": 0},
        SimpleNamespace(transpose_bytes=transpose_bytes))
    return {n: v["value"] for n, v in metrics.items()}


def test_per_layer_hands_the_readers_its_profile():
    # span_reduce.of finds the profile in this frame, by these names
    params = inspect.signature(harness._per_layer).parameters
    assert list(params)[0] == "prof"
    assert harness.__name__ == "pabench.harness"


def test_metrics_read_the_attribution():
    spans = [("ns.step", 0, 100), ("ns.nonlinear", 10, 50),
             ("plan.forward", 20, 40), ("stage_compute", 25, 35),
             ("transpose!", 60, 90), ("exchange", 70, 80)]
    launches = {1: 5, 2: 15, 3: 22, 4: 30, 5: 65, 6: 75, 7: 95, 8: 200}
    ms = 1_000_000
    ops = [("elementwise_kernel", 1 * ms, 1),
           ("elementwise_kernel", 2 * ms, 2),
           ("elementwise_kernel", 3 * ms, 3),
           ("regular_fft", 4 * ms, 4),
           ("permute_tiled", 5 * ms, 5),
           ("Memcpy DtoD", 6 * ms, 6),
           ("elementwise_kernel", 7 * ms, 7),
           ("elementwise_kernel", 8 * ms, 8)]
    got = _read_window(_Profile(spans, launches, ops))
    bound_s = 22e9 / harness.peaks()["hbm_bytes_per_s"]
    assert {n: got.get(n) for n in NEW_METRICS} == pytest.approx({
        "model_self_ms": (1 + 2 + 7) / 2, "model_ops": 1.5,
        "plan_other_ms": 3 / 2, "exchange_span_ms": 6 / 2,
        "transpose_span_roofline_pct": 100 * bound_s / (11e-3 / 2),
        "unspanned_pct": 100 * 8 / 36})
    # the kernel-name metrics beside them read the same window
    assert got["elementwise_ms"] == pytest.approx((1 + 2 + 3 + 7 + 8) / 2)
    assert got["cufft_ms"] == pytest.approx(2.0)


def test_metrics_fall_silent_without_spans():
    ms = 1_000_000
    got = _read_window(_Profile([], {1: 5}, [("regular_fft", 5 * ms, 1)]))
    assert not set(NEW_METRICS) & set(got)
    assert got["cufft_ms"] == pytest.approx(2.5)
    assert sr.of(object()) is None
