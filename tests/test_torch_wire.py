"""PyTorch port vs JAX package: reduced-precision wire formats.

* ``wire.pack`` gives the JAX package's payload bytes, and ``wire.unpack``
  its values, bit for bit, as the JAX package's exchanges run them (traced
  into a jitted program), for every wire dtype (bf16, f16, fp8 e4m3 and
  e5m2) on f32, f64, c64 and c128 payloads: ragged tile tails, NaN of both
  signs, infinities, signed zeros, subnormals, values above the fp8 range,
  all-zero windows and windows small enough that XLA:CPU flushes their
  scale.  The accounting (``wire_itemsize``, ``wire_bytes``,
  ``cast_score_bytes``, ``wire_rtol``) gives the JAX package's numbers.
* Wired transposes (``AllToAll``, ``Ring`` and ``Pipelined`` carrying a
  wire) give the JAX package's wired transposes bit for bit on 1, 2, 4 and
  8 gloo ranks, ragged shapes included, and every rank hands its exchange
  calls exactly the bytes ``transpose_cost`` prices.
* A gradient through a wired hop raises: the JAX package's is zero.

Cases follow ``tests/test_wire.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
from pencilarrays_tpu.parallel import wire as jwire
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.parallel import transpositions as tr
from pencilarrays_tpu_torch.parallel import wire as pwire
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu_torch.obs import drift as port_drift

WIRES = ("bf16", "f16", "fp8_e4m3", "fp8_e5m2")
PAYLOADS = (np.float32, np.float64, np.complex64, np.complex128)
F32 = np.finfo(np.float32)
EDGES = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40,
                  -1e-40, 1e-45, 5e-39, 449.0, 1e5, 7e4, F32.max, -F32.max,
                  1e-300, 2e-310, -3e-320, 1e-37, 3e-36, 1e300])


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


def _edge_array(shape, dtype, rng):
    """Random values over 16 decades, edge values scattered in, and four
    special rows along the last axis: all zero, all subnormal in f32, a
    window whose f32 scale is subnormal, all subnormal in f64."""
    n = int(np.prod(shape))
    x = rng.standard_normal(n) * np.exp(rng.uniform(-18, 18, n))
    idx = rng.choice(n, size=min(n, 200), replace=False)
    x[idx] = EDGES[rng.integers(0, len(EDGES), len(idx))]
    x = x.reshape(shape)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1] = 1e-39
    rows[2] = rng.standard_normal(shape[-1]) * 1e-37
    rows[3] = rng.standard_normal(shape[-1]) * 1e-310
    with np.errstate(over="ignore"):
        if np.issubdtype(dtype, np.complexfloating):
            out = np.empty(shape, dtype)
            out.real, out.imag = x, np.roll(x, 1)
            return out
        return x.astype(dtype)


# (shape, exchange axes): tile axes with ragged tails (600, 513, 300) and
# a whole window (256)
GEOMETRIES = [((3, 5, 600), (0, 1)), ((4, 300, 2), (0, 2)),
              ((7, 2, 513), (1, 0)), ((2, 3, 256), (0, 1))]


@pytest.mark.parametrize("dtype", PAYLOADS,
                         ids=[np.dtype(d).name for d in PAYLOADS])
@pytest.mark.parametrize("wire", WIRES)
def test_pack_bit_identical_to_jax(wire, dtype):
    rng = np.random.default_rng(
        [WIRES.index(wire), PAYLOADS.index(dtype)])
    for shape, axes in GEOMETRIES:
        x = _edge_array(shape, dtype, rng)
        # the exchanges run pack traced into a jitted program
        want = np.asarray(jax.jit(lambda v: jwire.pack(v, wire, axes=axes))(
            jnp.asarray(x)))
        got = pwire.pack(torch.from_numpy(x), wire, axes=axes).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        back_want = np.asarray(jax.jit(lambda v: jwire.unpack(
            v, dtype, wire, axes=axes, orig_shape=shape))(jnp.asarray(want)))
        back = pwire.unpack(torch.from_numpy(want.copy()),
                            torch.from_numpy(x).dtype, wire, axes=axes,
                            orig_shape=shape).numpy()
        assert back.dtype == back_want.dtype
        np.testing.assert_array_equal(back.view(np.uint8),
                                      back_want.view(np.uint8))
        # a strided view packs like its contiguous copy
        t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))
        np.testing.assert_array_equal(
            pwire.pack(t.transpose(0, 1), wire, axes=axes).numpy(), want)


@pytest.mark.parametrize("dtype", PAYLOADS,
                         ids=[np.dtype(d).name for d in PAYLOADS])
@pytest.mark.parametrize("wire", [w for w in WIRES if w.startswith("fp8")])
def test_fp8_slabs_keep_jax_bytes(wire, dtype, monkeypatch):
    """An fp8 pack and unpack walked in slabs of a few elements (each
    slab writing its slice of the output) give JAX's bytes and values,
    and ``roundtrip_`` on a strided view is ``unpack(pack(x))`` in
    place."""
    monkeypatch.setattr(pwire, "SLAB_ELEMS", 37)
    monkeypatch.setattr(pwire, "ROUNDTRIP_SLAB_ELEMS", 53)
    rng = np.random.default_rng([7, WIRES.index(wire), PAYLOADS.index(dtype)])
    for shape, axes in GEOMETRIES:
        if len(shape) < 3:
            continue
        x = _edge_array(shape, dtype, rng)
        want = np.asarray(jax.jit(lambda v: jwire.pack(v, wire, axes=axes))(
            jnp.asarray(x)))
        got = pwire.pack(torch.from_numpy(x), wire, axes=axes).numpy()
        np.testing.assert_array_equal(got, want)
        back = pwire.unpack(torch.from_numpy(want.copy()),
                            torch.from_numpy(x).dtype, wire, axes=axes,
                            orig_shape=shape)
        t = pwire.fp8_tile_axis(shape, *axes)
        y = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))
        pwire.roundtrip_(y.transpose(0, 1), wire, t)
        np.testing.assert_array_equal(
            y.transpose(0, 1).contiguous().numpy().view(np.uint8),
            back.numpy().view(np.uint8))


# the edge values with no subnormal in the scale arithmetic (1e-300 is
# not one: alone in a ragged window its f32 scale underflows; and no f64
# value past f32's range, whose infinite window scale makes x86's negative
# default NaN of inf / inf)
CLEAN_EDGES = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 449.0,
                        1e5, 7e4, F32.max, -F32.max])
# wire format: (unit roundoff, half its smallest subnormal, largest finite)
_FORMAT = {"bf16": (2.0 ** -8, 2.0 ** -134, float(torch.finfo(
    torch.bfloat16).max)),
           "f16": (2.0 ** -11, 2.0 ** -25, 65504.0),
           "fp8_e4m3": (2.0 ** -4, 2.0 ** -10, 448.0),
           "fp8_e5m2": (2.0 ** -3, 2.0 ** -17, 57344.0)}


def _real_parts(x):
    return np.stack([x.real, x.imag], -1) if np.iscomplexobj(x) else x


def _window_scales(parts, t, wire, dtype):
    """Each element's fp8 window scale as the IEEE path computes it: the
    window's finite max-abs times the reciprocal of the format maximum,
    rounded to f32, 1 where that is zero (infinite where an f64 window's
    scale is past f32's range: the window then decodes as NaN, as in the
    JAX package)."""
    fmax = _FORMAT[wire][2]
    n_t = parts.shape[t]
    a = np.moveaxis(np.where(np.isfinite(parts), np.abs(parts), 0), t, -1)
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, (-n_t) % pwire.FP8_TILE)])
    amax = a.reshape(a.shape[:-1] + (-1, pwire.FP8_TILE)).max(-1)
    recip = np.float32(1 / fmax) if np.dtype(dtype) in (
        np.float32, np.complex64) else 1 / fmax
    with np.errstate(over="ignore"):
        s = (amax * recip).astype(np.float32)
    s = np.where(s > 0, s, 1).astype(np.float64)
    s = np.repeat(s, pwire.FP8_TILE, axis=-1)[..., :n_t]
    return np.moveaxis(s, -1, t)


@pytest.mark.parametrize("dtype", PAYLOADS,
                         ids=[np.dtype(d).name for d in PAYLOADS])
@pytest.mark.parametrize("wire", WIRES)
def test_pack_without_flush(wire, dtype):
    """``ftz=False``, the card's default: without a subnormal in the scale
    arithmetic it gives JAX's bytes and values; on the edge arrays every
    finite value decodes within half a wire step of itself (a step of its
    window's scale on fp8: windows XLA:CPU flushes keep their values),
    values past a 16-bit format's range as infinities, and nonfinite
    values as JAX's nonfinite patterns with their sign."""
    u, half_sub, fmax = _FORMAT[wire]
    rng = np.random.default_rng(
        [7, WIRES.index(wire), PAYLOADS.index(dtype)])
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    for shape, axes in GEOMETRIES:
        clean = rng.standard_normal(shape).astype(dtype)
        cflat = clean.reshape(-1)
        idx = rng.choice(cflat.size, size=min(cflat.size, 200),
                         replace=False)
        with np.errstate(over="ignore"):
            cflat[idx] = CLEAN_EDGES[rng.integers(0, len(CLEAN_EDGES),
                                                  len(idx))].astype(dtype)
        want = np.asarray(jax.jit(lambda v: jwire.pack(v, wire, axes=axes))(
            jnp.asarray(clean)))
        got = pwire.pack(torch.from_numpy(clean), wire, axes=axes,
                         ftz=False).numpy()
        np.testing.assert_array_equal(got, want)
        back = pwire.unpack(torch.from_numpy(got), tdt, wire, axes=axes,
                            orig_shape=shape, ftz=False).numpy()
        back_want = np.asarray(jax.jit(lambda v: jwire.unpack(
            v, dtype, wire, axes=axes, orig_shape=shape))(jnp.asarray(want)))
        np.testing.assert_array_equal(back.view(np.uint8),
                                      back_want.view(np.uint8))

        x = _edge_array(shape, dtype, rng)
        packed = pwire.pack(torch.from_numpy(x), wire, axes=axes, ftz=False)
        d = _real_parts(pwire.unpack(packed, tdt, wire, axes=axes,
                                     orig_shape=shape, ftz=False).numpy())
        d, p = d.astype(np.float64), _real_parts(x).astype(np.float64)
        fin = np.isfinite(p)
        if wire in pwire.FP8_WIRE_DTYPES:
            t = pwire.fp8_tile_axis(shape, *axes)
            scales = _window_scales(_real_parts(x), t, wire, dtype)
            step = half_sub * np.where(np.isinf(scales), 0, scales)
            over = np.isinf(scales)
            assert np.all(np.isnan(d[over]))
        else:
            step = half_sub
            over = fin & (np.abs(p) > fmax * (1 + u))
            assert np.all(np.isinf(d[over]))
            assert np.array_equal(np.signbit(d[over]), np.signbit(p[over]))
        ok = fin & ~over
        bound = (u * np.abs(p) + step) * (1 + 2.0 ** -10) + 2.0 ** -140
        assert np.all(np.abs(d[ok] - p[ok])
                      <= np.broadcast_to(bound, p.shape)[ok])
        bad = ~fin & ~over
        assert np.array_equal(np.isnan(d[bad]), np.isnan(p[bad]) | (
            wire == "fp8_e4m3"))
        assert np.array_equal(np.signbit(d[bad]), np.signbit(p[bad]))


@pytest.mark.parametrize("wire", (None,) + WIRES)
def test_wire_accounting_matches_jax(wire, monkeypatch):
    shapes = [((8, 6, 5), (0, 1)), ((4, 300, 2), (0, 2)),
              ((9, 9, 600, 3), (1, 0)), ((2, 3, 256), (0, 1))]
    for dt in (np.float32, np.float64, np.complex64, np.complex128):
        tdt = torch.from_numpy(np.zeros(1, dt)).dtype
        assert pwire.wire_itemsize(dt, wire) == jwire.wire_itemsize(dt, wire)
        assert pwire.wire_itemsize(tdt, wire) == jwire.wire_itemsize(dt,
                                                                     wire)
        for shape, axes in shapes:
            want = jwire.wire_bytes(dt, wire, shape, axes=axes)
            assert pwire.wire_bytes(dt, wire, shape, axes=axes) == want
            assert pwire.wire_bytes(tdt, wire, shape, axes=axes) == want
            assert pwire.cast_score_bytes(want, tdt, wire) == \
                jwire.cast_score_bytes(want, dt, wire)
    for count in (1, 7, 4096, 10 ** 9):
        assert pwire.wire_rtol(wire, count) == jwire.wire_rtol(wire, count)
    if wire is not None:
        # the guard's override replaces the formula in both packages
        monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_WIRE_RTOL", "0.25")
        assert pwire.wire_rtol(wire, 10) == jwire.wire_rtol(wire, 10) \
            == 0.25


def test_wire_spellings_and_errors():
    for spelling, want in (("bfloat16", "bf16"), (torch.bfloat16, "bf16"),
                           ("half", "f16"), (np.float16, "f16"),
                           (torch.float8_e4m3fn, "fp8_e4m3"),
                           ("E5M2", "fp8_e5m2"), (None, None)):
        assert pwire.canonical_wire_dtype(spelling) == want
        if spelling is None or isinstance(spelling, str):
            assert jwire.canonical_wire_dtype(spelling) == want
    with pytest.raises(ValueError, match="wire_dtype"):
        pwire.canonical_wire_dtype("int8")
    with pytest.raises(TypeError, match="inexact"):
        pwire.pack(torch.zeros(3, 4, dtype=torch.int32), "bf16")
    with pytest.raises(TypeError, match="inexact"):
        pwire.wire_itemsize(np.int32, "bf16")
    with pytest.raises(ValueError, match="tile axis"):
        pwire.pack(torch.zeros(4, 4), "fp8_e4m3", axes=(0, 1))
    with pytest.raises(ValueError, match="axes"):
        pwire.wire_bytes(np.float32, "fp8_e5m2", (4, 4, 4))
    # the method field is canonical, so spellings never split equality
    assert pat.AllToAll(wire_dtype="bfloat16") == pat.AllToAll(
        wire_dtype=torch.bfloat16)
    assert tr.with_wire(pat.Pipelined(2), "f16") == pat.Pipelined(
        2, pat.AllToAll(wire_dtype="f16"))
    assert tr.strip_wire(pat.Pipelined(2, pat.Ring(wire_dtype="f16"))) == \
        pat.Pipelined(2, pat.Ring())
    with pytest.raises(ValueError, match="already carries"):
        tr.with_wire(pat.Ring(wire_dtype="bf16"), "f16")
    with pytest.raises(ValueError, match="Gspmd"):
        tr.with_wire(pat.Gspmd(), "bf16")
    assert tr._method_label(pat.Pipelined(3, pat.Ring(wire_dtype="fp8_e4m3"))
                            ) == jpa.parallel.transpositions._method_label(
        jpa.Pipelined(3, jpa.Ring(wire_dtype="fp8_e4m3")))


X, Y, Z = ((1, 2), None), ((0, 2), None), ((0, 1), None)
S0, S1 = ((0,), None), ((1,), None)

# (dims, shape, dtype, chain of pencils)
WIRED_CASES = {
    "1x1": ((1, 1), (9, 10, 11), np.float32, [X, Y, Z]),
    "2": ((2,), (10, 7, 300), np.complex64, [S0, ((1,), (2, 0, 1))]),
    "2x2": ((2, 2), (13, 10, 9), np.float64,
            [X, ((0, 2), (1, 0, 2)), ((0, 1), (2, 1, 0))]),
    "8-ring5": ((8,), (9, 9, 260), np.float32, [S0, S1]),
    "2x4": ((2, 4), (14, 21, 19), np.complex128, [X, Y]),
}


def _methods(jm, pm):
    return {
        "a2a-bf16": (jm.AllToAll(wire_dtype="bf16"),
                     pm.AllToAll(wire_dtype="bf16")),
        "a2a-f16": (jm.AllToAll(wire_dtype="f16"),
                    pm.AllToAll(wire_dtype="f16")),
        "a2a-e4m3": (jm.AllToAll(wire_dtype="fp8_e4m3"),
                     pm.AllToAll(wire_dtype="fp8_e4m3")),
        "a2a-e5m2": (jm.AllToAll(wire_dtype="fp8_e5m2"),
                     pm.AllToAll(wire_dtype="fp8_e5m2")),
        "ring-bf16": (jm.Ring(wire_dtype="bf16"), pm.Ring(wire_dtype="bf16")),
        "ring-e4m3": (jm.Ring(wire_dtype="fp8_e4m3"),
                      pm.Ring(wire_dtype="fp8_e4m3")),
        "pipe3-e4m3": (jm.Pipelined(3, jm.AllToAll(wire_dtype="fp8_e4m3")),
                       pm.Pipelined(3, pm.AllToAll(wire_dtype="fp8_e4m3"))),
        "pipe2-ring-f16": (jm.Pipelined(2, jm.Ring(wire_dtype="f16")),
                           pm.Pipelined(2, pm.Ring(wire_dtype="f16"))),
    }


METHODS = _methods(jpa, pat)
PAIRS = ([("1x1", m) for m in METHODS]
         + [("2", m) for m in ("a2a-f16", "ring-e4m3", "pipe3-e4m3")]
         + [("2x2", m) for m in ("a2a-bf16", "a2a-e5m2", "pipe2-ring-f16")]
         + [("8-ring5", m) for m in ("a2a-e4m3", "ring-bf16", "ring-e4m3")]
         + [("2x4", m) for m in ("a2a-bf16", "pipe3-e4m3")])


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _jax_pencil(topo, shape, spec):
    decomp, perm = spec
    return jpa.Pencil(topo, shape, decomp, permutation=None if perm is None
                      else jpa.Permutation(*perm))


def _size1_moved(pin, pout, dtype, method):
    """What a rank hands its exchange on a size-1 axis, where the cost
    model prices nothing: one call of the whole packed operand per chunk
    under AllToAll, no round under Ring."""
    base = method.base if isinstance(method, pat.Pipelined) else method
    if isinstance(base, pat.Ring):
        return {}
    R = tr.assert_compatible(pin, pout)
    a, b = pin.decomposition[R], pout.decomposition[R]
    shape = tr._exchange_operand_extents(pin, pout, R)
    bounds = [(0, None)]
    c = tr._pipeline_chunk_axis(shape, a, b)
    if isinstance(method, pat.Pipelined) and c is not None:
        bounds = tr._chunk_bounds(shape[c], method.chunks)
    total = 0
    for s0, s1 in bounds:
        s = shape if s1 is None else shape[:c] + (s1 - s0,) + shape[c + 1:]
        total += pwire.wire_bytes(dtype, base.wire_dtype, s, axes=(a, b))
    return {"all-to-all": {"count": len(bounds), "bytes": total}}


def _expected(pin, pout, dtype, method, rank):
    if pin.topology.dims[tr.assert_compatible(pin, pout)] == 1:
        want = _size1_moved(pin, pout, dtype, method)
    else:
        want = pat.transpose_cost(pin, pout, (), dtype, method)
    base = method.base if isinstance(method, pat.Pipelined) else method
    R = tr.assert_compatible(pin, pout)
    if isinstance(base, pat.Ring):
        G, _ = tr._ring_participants(pin, pout, R)
        if pin.topology.coords(rank)[R] >= G:
            want = {}
    ops = ("all-to-all", "collective-permute")
    return ({op: want.get(op, {}).get("count", 0) for op in ops},
            {op: want.get(op, {}).get("bytes", 0) for op in ops})


@pytest.mark.parametrize("case,method", PAIRS,
                         ids=[f"{c}-{m}" for c, m in PAIRS])
def test_wired_transpose_bit_identical_to_jax(devices, pool, case, method):
    dims, shape, dtype, chain = WIRED_CASES[case]
    jmethod, pmethod = METHODS[method]
    n = int(np.prod(dims))
    topo = jpa.Topology(dims, devices=devices[:n])
    rng = np.random.default_rng(len(case) * 31 + len(method))
    u = _edge_array(shape, dtype, rng)
    u.reshape(-1)[:4] = 0  # the padding-free corner stays finite
    pens = [_jax_pencil(topo, shape, s) for s in chain]
    x = jpa.PencilArray.from_global(pens[0], u)
    want = []
    for pen in pens[1:]:
        x = jpa.transpose(x, pen, method=jmethod)
        want.append((np.asarray(x.data), jpa.gather(x)))
    got = pool.run(tasks.wired_chain_case, dims, shape, chain, u,
                   pmethod)[0]
    ptopo = pat.Topology(dims, device="cpu")
    ppens = [pat.Pencil(ptopo, shape, d, permutation=None if p is None
                        else pat.Permutation(*p)) for d, p in chain]
    for i, ((pad, glob, counts), (wpad, wglob)) in enumerate(zip(got, want)):
        assert pad.dtype == wpad.dtype and pad.shape == wpad.shape
        np.testing.assert_array_equal(pad.view(np.uint8), wpad.view(np.uint8))
        np.testing.assert_array_equal(glob.view(np.uint8),
                                      wglob.view(np.uint8))
        assert counts == [_expected(ppens[i], ppens[i + 1], dtype, pmethod,
                                    r) for r in range(n)]
    # the wire really quantized, on a size-1 axis too
    fin = np.isfinite(u)
    assert not np.array_equal(got[-1][1][fin], u[fin])


def test_wired_hop_gradient_raises_where_jax_gives_zero(devices, pool):
    """jax.grad through the wire's integer bitcast is zero; the port
    raises instead of returning a gradient."""
    shape = (8, 6, 5)
    topo = jpa.Topology((2, 2), devices=devices[:4])
    pin, pout = (_jax_pencil(topo, shape, s) for s in (X, Y))
    u = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    x = jpa.PencilArray.from_global(pin, u)

    def loss(d):
        y = jpa.transpose(jpa.PencilArray(pin, d), pout,
                          method=jpa.AllToAll(wire_dtype="bf16"))
        return jnp.sum(y.data)

    assert not np.any(np.asarray(jax.grad(loss)(x.data)))
    msg = pool.run(tasks.wired_grad_case, (2, 2), shape, [X, Y], u,
                   pat.AllToAll(wire_dtype="bf16"))[0]
    assert "no gradient" in msg


@pytest.mark.parametrize("dtype", PAYLOADS,
                         ids=[np.dtype(d).name for d in PAYLOADS])
@pytest.mark.parametrize("method", [
    pat.Pipelined(4), pat.AllToAll(wire_dtype="bf16"),
    pat.AllToAll(wire_dtype="f16"), pat.Ring(wire_dtype="bf16"),
    pat.Pipelined(4, pat.AllToAll(wire_dtype="bf16")),
    pat.AllToAll(wire_dtype="fp8_e4m3")],
    ids=["pipelined4", "a2a-bf16", "a2a-f16", "ring-bf16",
         "pipelined4-bf16", "a2a-fp8"])
def test_hop_order_changes_no_bits(method, dtype):
    """The hops that hold less memory move the same bits: a chunked hop
    allocates its output after the first chunk's pack and frees its input
    after the last, and a 16-bit wire casts the block before K1's pack and
    widens after K1's unpack.  Each equals the unchunked, unwired hop (of
    ``unpack(pack(x))`` for a wire), ragged chunks and edge values
    included, on one rank and as a donated input."""
    rng = np.random.default_rng(9)
    topo = pat.Topology((1, 1), device="cpu")
    shape = (11, 13, 10)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    u = torch.from_numpy(_edge_array(shape + (3,), dtype, rng))
    x = pat.PencilArray.from_global(px, u, 1)
    wire = tr._method_wire(method)
    src = x.data
    if wire is not None:
        a, b = px.decomposition[0], py.decomposition[0]
        logical = x.data.permute(tr._inv_axes(px, 1))
        src = pwire.unpack(pwire.pack(logical, wire, axes=(a, b)), x.dtype,
                           wire, axes=(a, b), orig_shape=logical.shape
                           ).permute(tr._fwd_axes(px, 1)).contiguous()
    want = pat.transpose(pat.PencilArray(px, src, (3,)), py).data
    got = pat.transpose(x, py, method=method).data
    donated = tr._hop([x.data.clone()], px, py, 1, method)
    for t in (got, donated):
        assert t.dtype == want.dtype and torch.equal(
            t.contiguous().view(torch.uint8), want.contiguous().view(
                torch.uint8))
