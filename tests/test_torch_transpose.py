"""PyTorch port vs JAX package: global transposes on 4 and 8 gloo ranks.

The same global input goes through the JAX package (8 virtual CPU
devices) and the port (gloo ranks, one process each), by the same method
(``AllToAll``, ``Ring``, ``Pipelined(4)``, ``Pipelined(3, Ring())``).
Transposes are pure data movement, so every rank's block must be
BIT-identical to the JAX shard of the same pencil, padding zeros
included, and ``gather`` must equal JAX's ``gather``; the padding-masked
global ``sum`` must agree with JAX's up to summation order.  The exchange
calls each rank makes must equal the cost model's count (a ring's
non-participants make none), and the cost model and ``Auto``'s verdicts
must equal the JAX package's.  Cases follow ``tests/test_transpose.py``
and ``tests/test_auto_method.py``.
"""

import jax
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.parallel import transpositions as tr
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.parallel.distributed import RankPool


class _Pools:
    """One live pool at a time: tests run in file order, all (2, 2) cases
    first, so switching rank counts happens once."""

    def __init__(self):
        self.n, self.pool = None, None

    def get(self, n):
        if self.n != n:
            self.close()
            self.pool, self.n = RankPool(n), n
        return self.pool

    def close(self):
        if self.pool is not None:
            self.pool.close()
        self.n, self.pool = None, None


@pytest.fixture(scope="module")
def pools():
    p = _Pools()
    yield p
    p.close()


def _global(shape, extra, dtype):
    n = int(np.prod(shape + extra))
    base = (np.arange(n, dtype=np.float64).reshape(shape + extra) + 1.0) / 3.0
    if np.issubdtype(dtype, np.complexfloating):
        base = base - 1j * base[::-1]
    return base.astype(dtype)


def _jax_pencil(topo, shape, spec):
    decomp, perm = spec
    return jpa.Pencil(topo, shape, decomp,
                      permutation=None if perm is None
                      else jpa.Permutation(*perm))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


X, Y, Z = ((1, 2), None), ((0, 2), None), ((0, 1), None)
BF16 = jax.numpy.bfloat16

# (dims, shape, extra, dtype, chain of pencils)
CASES = [
    ((2, 2), (16, 16, 16), (), np.float32, [X, Y, Z]),
    ((2, 2), (15, 14, 13), (), np.float64, [X, ((0, 2), (1, 0, 2))]),
    ((2, 2), (15, 14, 13), (), np.float64,
     [((1, 2), (2, 0, 1)), ((0, 2), (1, 2, 0))]),
    ((2, 2), (14, 21, 19), (), np.float32,
     [X, ((0, 2), (1, 0, 2)), ((0, 1), (2, 1, 0)), ((0, 2), (1, 0, 2)), X]),
    ((2, 2), (10, 11, 12), (3, 2), np.float64, [((1, 2), (2, 0, 1)), Y]),
    ((2, 2), (9, 10, 11), (), np.complex64,
     [X, ((1, 2), (2, 1, 0)), X]),
    ((2, 2), (9, 16, 9), (3,), np.complex128,
     [((1, 2), (1, 2, 0)), ((0, 2), (0, 2, 1)), Z]),
    ((2, 2), (9, 16, 9), (), np.int32, [X, ((1, 0), None)]),
    ((2, 2), (9, 16, 9), (6,), BF16, [X, ((0, 2), (2, 0, 1)), Z]),
    ((2, 4), (16, 16, 16), (), np.float32, [X, Y, Z]),
    ((2, 4), (42, 31, 29), (), np.float64, [X, Y, Z, Y, X]),
    ((2, 4), (7, 12, 13), (), np.float32, [X, ((0, 2), (1, 0, 2))]),
    ((2, 4), (11, 12, 13), (), np.float64, [((2, 1), None), ((2, 0), None)]),
    ((2, 4), (6, 7, 8, 9), (), np.complex64,
     [((1, 3), (3, 0, 1, 2)), ((2, 3), None)]),
    ((2, 4), (9, 16, 5), (), np.float64, [X, ((1, 0), None)]),
    ((2, 4), (9, 16, 13), (), np.float64, [X, ((1, 0), None)]),
    ((2, 4), (2, 16, 6), (), np.float64, [X, ((1, 0), None)]),
    ((2, 4), (9, 16, 1), (3,), np.float32, [X, ((1, 0), (2, 0, 1))]),
    ((2, 4), (13, 16, 9), (), np.float64, [X, ((1, 0), None)]),
    ((8,), (21, 17, 14), (), np.float64,
     [((0,), None), ((1,), None), ((2,), None), ((0,), (2, 1, 0))]),
    # n = 9 over P = 8: G = 5 of 8 ranks take part in a ring
    ((8,), (9, 9, 4), (), np.float32, [((0,), None), ((1,), None)]),
    ((8,), (9, 13, 3), (2,), np.float64,
     [((1,), None), ((0,), (2, 1, 0))]),
]

METHODS = [("AllToAll", jpa.AllToAll(), pat.AllToAll()),
           ("Ring", jpa.Ring(), pat.Ring()),
           ("Pipelined4", jpa.Pipelined(4), pat.Pipelined(4)),
           ("Pipelined3Ring", jpa.Pipelined(3, jpa.Ring()),
            pat.Pipelined(3, pat.Ring()))]


def _case_id(case):
    dims, shape, extra, dtype, chain = case
    return (f"{'x'.join(map(str, dims))}-{'x'.join(map(str, shape))}"
            f"{'+' + 'x'.join(map(str, extra)) if extra else ''}-"
            f"{np.dtype(dtype).name}-{len(chain) - 1}hops")


def _by_method(cases, methods):
    """(case, method) pairs, case-major; AllToAll keeps the bare case id."""
    pairs = [(c, m) for c in cases for m in methods]
    ids = [_case_id(c) + ("" if m[0] == "AllToAll" else "-" + m[0])
           for c, m in pairs]
    return pairs, ids


_PAIRS, _PAIR_IDS = _by_method(CASES, METHODS)


def _expected_calls(ppin, ppout, extra, dtype, method, rank):
    """The exchange calls one rank makes in a hop: the cost model's count,
    or none for a ring rank past the participants."""
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    want = {op: v["count"] for op, v in pat.transpose_cost(
        ppin, ppout, extra, dtype, method).items()}
    base = method.base if isinstance(method, pat.Pipelined) else method
    R = tr.assert_compatible(ppin, ppout)
    if isinstance(base, pat.Ring) and R is not None:
        G, _ = tr._ring_participants(ppin, ppout, R)
        if ppin.topology.coords(rank)[R] >= G:
            want = {}
    return {op: want.get(op, 0) for op in ("all-to-all",
                                           "collective-permute")}


def _port_pencils(dims, shape, chain):
    ptopo = pat.Topology(dims, device="cpu")
    return [pat.Pencil(ptopo, shape, d, permutation=None if p is None
                       else pat.Permutation(*p)) for d, p in chain]


@pytest.mark.parametrize("case,method", _PAIRS, ids=_PAIR_IDS)
def test_transpose_bit_identical_to_jax(devices, pools, case, method):
    dims, shape, extra, dtype, chain = case
    _, jmethod, pmethod = method
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    u = _global(shape, extra, dtype)
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    x = jpa.PencilArray.from_global(pens[0], u)
    ref = []
    for pen in pens[1:]:
        x = jpa.transpose(x, pen, method=jmethod)
        ref.append((np.asarray(x.data), jpa.gather(x),
                    complex(jpa.ops.reductions.sum(x, dtype=np.float64
                                                   if dtype is BF16 else None))))
    padded_in = np.asarray(jpa.PencilArray.from_global(pens[0], u).data)
    bf16 = dtype is BF16
    if bf16:
        padded_in = padded_in.view(np.uint16)
    out = pools.get(len(topo)).run(tasks.transpose_chain, dims, shape, extra,
                                   chain, padded_in, bf16, pmethod)[0]
    assert len(out) == len(ref)
    ppens = _port_pencils(dims, shape, chain)
    for i, ((got_pad, got_glob, got_sum, calls),
            (want_pad, want_glob, want_sum)) in enumerate(zip(out, ref)):
        if bf16:  # the port hands bf16 back as the exact float32 values
            want_pad = want_pad.astype(np.float32)
            want_glob = want_glob.astype(np.float32)
        assert got_pad.shape == want_pad.shape
        assert got_pad.dtype == want_pad.dtype
        np.testing.assert_array_equal(_bits(got_pad), _bits(want_pad))
        np.testing.assert_array_equal(_bits(got_glob), _bits(want_glob))
        # padding masked: the sums agree up to summation order
        rtol = 1e-5 if dtype in (np.float32, np.complex64) else 1e-12
        np.testing.assert_allclose(complex(got_sum), want_sum, rtol=rtol)
        # each rank's exchange calls are the model's count
        assert calls == [_expected_calls(ppens[i], ppens[i + 1], extra,
                                         dtype, pmethod, r)
                         for r in range(len(topo))]


COST_METHODS = METHODS + [
    ("Pipelined2", jpa.Pipelined(2), pat.Pipelined(2)),
    ("Auto", jpa.Auto(), pat.Auto()),
    ("Auto0", jpa.Auto(latency_bytes=0), pat.Auto(latency_bytes=0))]
_COST_PAIRS, _COST_IDS = _by_method(CASES, COST_METHODS)


@pytest.mark.parametrize("case,method", _COST_PAIRS, ids=_COST_IDS)
def test_transpose_cost_matches_jax(devices, case, method):
    """The byte model needs no ranks: a port topology built without
    torch.distributed answers every metadata query."""
    dims, shape, extra, dtype, chain = case
    _, jmethod, pmethod = method
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    ppens = _port_pencils(dims, shape, chain)
    want = [jpa.transpose_cost(a, b, extra, dtype, jmethod)
            for a, b in zip(pens, pens[1:])]
    got = [pat.transpose_cost(a, b, extra, dtype, pmethod)
           for a, b in zip(ppens, ppens[1:])]
    assert got == want
    # Auto's verdict, hop by hop
    want = [type(jpa.resolve_method(a, b, extra, dtype, jmethod)).__name__
            for a, b in zip(pens, pens[1:])]
    got = [type(pat.resolve_method(a, b, extra, dtype, pmethod)).__name__
           for a, b in zip(ppens, ppens[1:])]
    assert got == want


def test_chunked_cost_matches_jax(devices):
    """``chunk=(dim, bounds)``: a caller's own chunking multiplies the
    count and leaves the bytes, as in the JAX package."""
    topo = jpa.Topology((2, 4), devices=devices)
    shape = (42, 31, 29)
    jp = [_jax_pencil(topo, shape, s) for s in (X, Y)]
    pp = _port_pencils((2, 4), shape, [X, Y])
    for jm, pm in ((jpa.AllToAll(), pat.AllToAll()), (jpa.Ring(),
                                                      pat.Ring())):
        for bounds in (((0, 11), (11, 21)), ((0, 5), (5, 10), (10, 11)),
                       ((0, 11),)):
            assert pat.transpose_cost(*pp, (3,), np.float32, pm,
                                      chunk=(2, bounds)) == \
                jpa.transpose_cost(*jp, (3,), np.float32, jm,
                                   chunk=(2, bounds))


# tests/test_auto_method.py: (topology, shape, Auto) -> JAX's verdict
AUTO_CASES = [((8,), (32, 32, 4), 0), ((8,), (32, 32, 4), 128 * 1024),
              ((8,), (9, 9, 4), 0), ((8,), (9, 9, 4), 128 * 1024),
              ((2, 4), (9, 16, 9), 0), ((2, 4), (42, 31, 29), 0),
              ((8,), (9, 9, 400), 128 * 1024)]


@pytest.mark.parametrize("case", AUTO_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-"
                              f"{'x'.join(map(str, c[1]))}-L{c[2]}"
                              for c in AUTO_CASES])
def test_auto_resolves_as_jax(devices, case):
    """``Auto(mode="estimate")`` on the configurations of
    ``tests/test_auto_method.py``: the port's verdict is JAX's, and a
    concrete method passes through."""
    dims, shape, L = case
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    ptopo = pat.Topology(dims, device="cpu")
    if len(dims) == 1:
        jp = jpa.Pencil(topo, shape, (0,))
        pp = pat.Pencil(ptopo, shape, (0,))
        pairs = [(jp, jp.replace(decomp_dims=(1,)),
                  pp, pp.replace(decomp_dims=(1,)))]
    else:
        jp, pp = _jax_pencil(topo, shape, X), _port_pencils(
            dims, shape, [X])[0]
        pairs = [(jp, jp.replace(decomp_dims=d), pp, pp.replace(
            decomp_dims=d)) for d in ((1, 0), (0, 2))]
    for ja, jb, pa_, pb in pairs:
        want = jpa.resolve_method(ja, jb, (), np.float32,
                                  jpa.Auto(latency_bytes=L))
        got = pat.resolve_method(pa_, pb, (), np.float32,
                                 pat.Auto(latency_bytes=L))
        assert type(got).__name__ == type(want).__name__
        assert pat.resolve_method(pa_, pb, (), np.float32,
                                  pat.Ring()) == pat.Ring()
    if shape == (9, 9, 4) and len(dims) == 1:
        assert type(want).__name__ == ("Ring" if L == 0 else "AllToAll")


def test_method_validation():
    """The JAX package's checks (``tests/test_transpose.py``)."""
    with pytest.raises(ValueError, match="positive int"):
        pat.Pipelined(chunks=0)
    with pytest.raises(ValueError, match="positive int"):
        pat.Pipelined(chunks=2.0)
    with pytest.raises(ValueError, match="base"):
        pat.Pipelined(chunks=2, base=pat.Pipelined(2))
    with pytest.raises(ValueError, match="base"):
        pat.Pipelined(chunks=2, base=pat.Auto())
    with pytest.raises(ValueError, match="mode"):
        pat.Auto(mode="guess")
    assert pat.PointToPoint is pat.Ring
    assert pat.Auto(mode="measure") == pat.Auto(mode="measure")
    # wires, Gspmd and reshard are ported: the wire field is canonical
    assert pat.Ring(wire_dtype="bfloat16").wire_dtype == "bf16"
    assert pat.Auto(wire_dtype="float16").wire_dtype == "f16"
    assert pat.Gspmd() == pat.Gspmd()
    with pytest.raises(ValueError, match="wire_dtype"):
        pat.AllToAll(wire_dtype="int4")


GRAD_HOPS = [
    ((2, 2), (9, 10, 11), (), [X, Y]),
    ((2, 2), (15, 14, 13), (3,), [((1, 2), (2, 0, 1)), ((0, 2), (1, 2, 0))]),
    ((2, 2), (9, 16, 5), (), [X, ((1, 0), None)]),
]


@pytest.mark.parametrize("case,method", [
    (c, m) for c in GRAD_HOPS for m in METHODS[1:]],
    ids=[f"{i}-{m[0]}" for i in ("xy", "xy-perm-extra", "ragged")
         for m in METHODS[1:]])
def test_hop_gradient_by_method_matches_jax(devices, pools, case, method):
    """The backward of a Ring or Pipelined hop (the inverse hop by the
    same method) gives jax.grad's gradient bit for bit."""
    import jax.numpy as jnp

    dims, shape, extra, specs = case
    _, jmethod, pmethod = method
    topo = jpa.Topology(dims, devices=devices[:4])
    pin, pout = (_jax_pencil(topo, shape, s) for s in specs)
    rng = np.random.default_rng(6)
    x = jpa.PencilArray.from_global(
        pin, rng.standard_normal(shape + extra).astype(np.float32))
    ct = np.asarray(jpa.PencilArray.from_global(
        pout, rng.standard_normal(shape + extra).astype(np.float32)).data)

    def loss(data):
        y = jpa.transpose(jpa.PencilArray(pin, data, extra), pout,
                          method=jmethod)
        return jnp.sum(y.data * ct)

    want = np.asarray(jax.jit(jax.grad(loss))(x.data))
    got = pools.get(4).run(tasks.hop_grad_case, dims, shape, extra, specs,
                           np.asarray(x.data), ct, pmethod)[0]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


WIRES = ("bf16", "f16", "fp8_e4m3", "fp8_e5m2")
_WIRED_COST_CASES = [c for c in CASES
                     if c[3] not in (np.int32, BF16) and len(c[1]) > 2]


@pytest.mark.parametrize("case", _WIRED_COST_CASES,
                         ids=[_case_id(c) for c in _WIRED_COST_CASES])
def test_wired_transpose_cost_matches_jax(devices, case):
    """``transpose_cost`` at every wire, by every method (fp8 chunks of a
    ``Pipelined`` hop carry their own scales), and ``Auto``'s verdict
    with a wire, equal the JAX package's (``tests/test_wire.py``)."""
    dims, shape, extra, dtype, chain = case
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    ppens = _port_pencils(dims, shape, chain)
    for w in WIRES:
        for jm, pm in ((jpa.AllToAll(wire_dtype=w), pat.AllToAll(wire_dtype=w)),
                       (jpa.Ring(wire_dtype=w), pat.Ring(wire_dtype=w)),
                       (jpa.Pipelined(3, jpa.AllToAll(wire_dtype=w)),
                        pat.Pipelined(3, pat.AllToAll(wire_dtype=w))),
                       (jpa.Auto(latency_bytes=0, wire_dtype=w),
                        pat.Auto(latency_bytes=0, wire_dtype=w))):
            for (a, b), (pa_, pb) in zip(zip(pens, pens[1:]),
                                         zip(ppens, ppens[1:])):
                assert pat.transpose_cost(pa_, pb, extra, dtype, pm) == \
                    jpa.transpose_cost(a, b, extra, dtype, jm)
                got = pat.resolve_method(pa_, pb, extra, dtype, pm)
                want = jpa.resolve_method(a, b, extra, dtype, jm)
                assert (type(got).__name__, tr._method_wire(got)) == (
                    type(want).__name__,
                    jpa.parallel.transpositions._method_wire(want))
    from pencilarrays_tpu.parallel.transpositions import _hop_label
    assert tr._hop_label(ppens[0], ppens[1], pat.Ring(wire_dtype="f16"),
                         dtype) == _hop_label(pens[0], pens[1],
                                              jpa.Ring(wire_dtype="f16"),
                                              dtype)


_GSPMD_CASES = [CASES[i] for i in (1, 4, 6, 11, 13, 19, 20)]


@pytest.mark.parametrize("case", _GSPMD_CASES,
                         ids=[_case_id(c) for c in _GSPMD_CASES])
def test_gspmd_transpose_bit_identical_to_jax(devices, pools, case):
    """``transpose(method=Gspmd())``: per-peer block intersections in one
    call, the JAX package's bits, one exchange call per rank."""
    dims, shape, extra, dtype, chain = case
    topo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    u = _global(shape, extra, dtype)
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    x = jpa.PencilArray.from_global(pens[0], u)
    ref = []
    for pen in pens[1:]:
        x = jpa.transpose(x, pen, method=jpa.Gspmd())
        ref.append(np.asarray(x.data))
    padded_in = np.asarray(jpa.PencilArray.from_global(pens[0], u).data)
    out = pools.get(len(topo)).run(tasks.transpose_chain, dims, shape, extra,
                                   chain, padded_in, False, pat.Gspmd())[0]
    ppens = _port_pencils(dims, shape, chain)
    for i, ((got_pad, got_glob, _, calls), want) in enumerate(zip(out,
                                                                 ref)):
        np.testing.assert_array_equal(_bits(got_pad), _bits(want))
        np.testing.assert_array_equal(_bits(got_glob), _bits(u))
        moves = bool(tr.gspmd_reshard_cost(ppens[i], ppens[i + 1]))
        assert calls == [{"all-to-all": int(moves),
                          "collective-permute": 0}] * len(topo)


def test_gspmd_hop_gradient_matches_jax(devices, pools):
    """The backward of a Gspmd hop is the inverse Gspmd hop: jax.grad's
    gradient bit for bit."""
    import jax.numpy as jnp

    dims, shape, extra, specs = GRAD_HOPS[1]
    topo = jpa.Topology(dims, devices=devices[:4])
    pin, pout = (_jax_pencil(topo, shape, s) for s in specs)
    rng = np.random.default_rng(9)
    x = jpa.PencilArray.from_global(
        pin, rng.standard_normal(shape + extra).astype(np.float32))
    ct = np.asarray(jpa.PencilArray.from_global(
        pout, rng.standard_normal(shape + extra).astype(np.float32)).data)

    def loss(data):
        y = jpa.transpose(jpa.PencilArray(pin, data, extra), pout,
                          method=jpa.Gspmd())
        return jnp.sum(y.data * ct)

    want = np.asarray(jax.jit(jax.grad(loss))(x.data))
    got = pools.get(4).run(tasks.hop_grad_case, dims, shape, extra, specs,
                           np.asarray(x.data), ct, pat.Gspmd())[0]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
