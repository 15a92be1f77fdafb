"""PyTorch port vs JAX package: the Julia-named free functions
(``compat.py``), the wrapped elementwise namespace (``numpy.py``) and the
hierarchical timers (``utils/timers.py``).

Every reference export the JAX package provides exists in the port, and
each accessor answers as the JAX package's does on the same pencil
(``tests/test_compat.py``); ``pnp`` functions give the JAX package's
values within 1e-12 (float64); the timers nest, count, merge and report
as the JAX package's (timings themselves are host wall time).
"""

import threading

import numpy as np

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import pencilarrays_tpu_torch.numpy as pnp
from pencilarrays_tpu_torch.utils import timers

EXPORTS = [
    "PencilArray", "GlobalPencilArray", "PencilArrayCollection",
    "ManyPencilArray", "pencil", "permutation", "gather", "global_view",
    "ndims_extra", "ndims_space", "extra_dims", "sizeof_global", "Pencil",
    "MPITopology", "Permutation", "NoPermutation", "MemoryOrder",
    "LogicalOrder", "decomposition", "get_comm", "timer", "topology",
    "range_local", "range_remote", "size_local", "size_global", "to_local",
    "length_local", "length_global", "TimerOutput",
    "PermutedCartesianIndices", "PermutedLinearIndices"]


def test_every_reference_export_exists():
    for name in EXPORTS:
        assert hasattr(jpa, name), f"the JAX package lacks {name}"
        assert hasattr(pat, name), f"missing export: {name}"


def test_free_functions_match_jax(devices):
    jt = jpa.Topology((2, 4))
    jpen = jpa.Pencil(jt, (12, 10, 8), (1, 2),
                      permutation=jpa.Permutation(2, 0, 1),
                      timer=jpa.TimerOutput("t"))
    pt = pat.Topology((2, 4), device="cpu")
    ppen = pat.Pencil(pt, (12, 10, 8), (1, 2),
                      permutation=pat.Permutation(2, 0, 1),
                      timer=pat.TimerOutput("t"))
    for order_j, order_p in ((jpa.LogicalOrder, pat.LogicalOrder),
                             (jpa.MemoryOrder, pat.MemoryOrder)):
        for rank in range(8):
            c = jt.coords(rank)
            assert pat.range_remote(ppen, rank, order_p) == \
                jpa.range_remote(jpen, rank, order_j)
            assert pat.range_local(ppen, c, order_p) == \
                jpa.range_local(jpen, c, order_j)
            assert pat.size_local(ppen, c, order_p) == \
                jpa.size_local(jpen, c, order_j)
            assert pat.length_local(ppen, c) == jpa.length_local(jpen, c)
            assert pat.to_local(ppen, (5, 6, 7), c, order_p) == \
                jpa.to_local(jpen, (5, 6, 7), c, order_j)
        assert pat.size_global(ppen, order_p) == jpa.size_global(jpen,
                                                                 order_j)
    assert pat.length_global(ppen) == jpa.length_global(jpen) == 960
    assert pat.decomposition(ppen) == jpa.decomposition(jpen)
    assert pat.permutation(ppen) == pat.Permutation(2, 0, 1)
    assert pat.topology(ppen) is pt and pat.timer(ppen) is ppen.timer
    assert pat.get_comm(pt) is None      # no process group here
    assert pat.MPITopology is pat.Topology
    assert pat.GlobalPencilArray is pat.PencilArray
    # a one-rank array: the accessors of PencilArray
    one = pat.Pencil(pat.Topology((1, 1), device="cpu"), (12, 10, 8),
                     (1, 2), permutation=pat.Permutation(2, 0, 1))
    u = np.random.default_rng(0).standard_normal((12, 10, 8, 3))
    x = pat.PencilArray.from_global(one, u)
    jx = jpa.PencilArray.from_global(jpa.Pencil(
        jpa.Topology((1, 1), devices=devices[:1]), (12, 10, 8), (1, 2),
        permutation=jpa.Permutation(2, 0, 1)), u)
    assert pat.pencil(x) is one
    for name in ("extra_dims", "ndims_extra", "ndims_space",
                 "sizeof_global", "length_global", "size_global"):
        assert getattr(pat, name)(x) == getattr(jpa, name)(jx), name
    assert pat.range_local(x) == jpa.range_local(jx)
    assert pat.size_local(x) == jpa.size_local(jx)
    assert pat.length_local(x) == jpa.length_local(jx)
    assert one.replace(decomp_dims=(0, 2)).timer is one.timer


def test_pnp_matches_jax(devices):
    import pencilarrays_tpu.numpy as jpnp

    shape = (13, 11, 9)
    rng = np.random.default_rng(12)
    u, v = rng.standard_normal(shape), rng.standard_normal(shape)
    jpen = jpa.Pencil(jpa.Topology((1, 1), devices=devices[:1]), shape,
                      (1, 2), permutation=jpa.Permutation(2, 0, 1))
    ppen = pat.Pencil(pat.Topology((1, 1), device="cpu"), shape, (1, 2),
                      permutation=pat.Permutation(2, 0, 1))
    jx, jy = (jpa.PencilArray.from_global(jpen, a) for a in (u, v))
    px, py = (pat.PencilArray.from_global(ppen, a) for a in (u, v))
    row = np.arange(shape[-1], dtype=np.float64)
    for name, args in [("cos", "x"), ("add", "xy"), ("arctan2", "xy"),
                       ("hypot", "xy"), ("maximum", "xy"), ("exp", "x"),
                       ("square", "x"), ("sign", "x"), ("rint", "x"),
                       ("degrees", "x"), ("logaddexp", "xy"),
                       ("multiply", "xr"), ("greater", "xy"),
                       ("isfinite", "x"), ("conj", "x")]:
        pick = {"x": (px, jx), "y": (py, jy), "r": (row, row)}
        got = getattr(pnp, name)(*(pick[a][0] for a in args))
        want = getattr(jpnp, name)(*(pick[a][1] for a in args))
        assert isinstance(got, pat.PencilArray) and got.pencil == ppen
        np.testing.assert_allclose(pat.gather(got), jpa.gather(want),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(
        pat.gather(pnp.clip(px, -0.5, 0.5)),
        jpa.gather(jpnp.clip(jx, -0.5, 0.5)))
    assert "cos" in dir(pnp)


def test_timers_match_jax():
    from pencilarrays_tpu.utils import timers as jt

    snaps = []
    for mod in (jt, timers):
        mod.enable_debug_timings()
        try:
            t = mod.TimerOutput("x")
            for _ in range(3):
                with mod.timeit(t, "transpose!"):
                    with mod.timeit(t, "pack data"):
                        pass
            with mod.timeit(None, "no timer"):
                pass
            assert mod.timings_enabled()
        finally:
            mod.disable_debug_timings()
        with mod.timeit(t, "disabled"):
            pass
        snaps.append(t.snapshot())

    def shape(d):
        return {k: (c["ncalls"], shape(c)) for k, c in d["children"].items()}

    assert shape(snaps[0]) == shape(snaps[1]) == {
        "transpose!": (3, {"pack data": (3, {})})}
    t = timers.TimerOutput("y")
    t.merge(snaps[1]).merge(timers.TimerOutput("z"))
    assert shape(t.snapshot()) == shape(snaps[1])
    assert "transpose!" in t.report() and "TimerOutput(y)" in repr(t)
    t.reset()
    assert t.snapshot()["children"] == {}


def test_timers_thread_safe():
    t = timers.TimerOutput("threads")
    timers.enable_debug_timings()
    try:
        def work():
            for _ in range(200):
                with t("a"):
                    with t("b"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        timers.disable_debug_timings()
    snap = t.snapshot()
    assert snap["children"]["a"]["ncalls"] == 1600
    assert snap["children"]["a"]["children"]["b"]["ncalls"] == 1600
