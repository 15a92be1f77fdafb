"""Kernel K1 (the pencil permute) of the PyTorch port.

* The plain versions (``permute_plain``, ``pack_plain``, ``unpack_plain``)
  are bit-identical to the JAX package: to ``pallas_permute`` in interpret
  mode on the ``tests/test_pallas.py`` shapes, and to ``jnp.transpose`` /
  ``jnp.pad`` for f32, f64, c64, c128, bf16 and i32.
* Every copy plan the CUDA kernel would launch is executed here by
  ``emulate`` and must reproduce the plain version bit for bit, writing
  every output element and staying inside both buffers.
* The kernel itself is held to the plain version on the card by
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pencilarrays_tpu.ops.pallas_kernels import pallas_permute
from pencilarrays_tpu_torch.ops import permute as k1

DTYPES = ["float32", "float64", "complex64", "complex128", "bfloat16",
          "int32"]


def _values(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 100
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(jnp.dtype(dtype))


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same_bits(t, a):
    a = np.ascontiguousarray(np.asarray(a))
    got = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    assert tuple(t.shape) == a.shape
    np.testing.assert_array_equal(got, a.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("shape,axes", [
    ((256, 128, 256), (2, 0, 1)),
    ((128, 256, 128), (1, 0, 2)),
    ((128, 128, 128), (2, 1, 0)),
    ((256, 128), (1, 0)),
    ((64, 8, 128, 128), (3, 2, 0, 1)),
])
def test_permute_plain_matches_pallas_interpret(shape, axes):
    x = _values(shape, "float32")
    want = pallas_permute(jnp.asarray(x), axes, interpret=True)
    _same_bits(k1.permute_plain(_to_torch(x), axes), want)


def _jax_pack(x, axes, dim, P):
    y = jnp.transpose(x, axes)
    n = y.shape[dim]
    blk = -(-n // P)
    pad = [(0, 0)] * y.ndim
    pad[dim] = (0, P * blk - n)
    y = jnp.pad(y, pad)
    shape = list(y.shape)
    shape[dim:dim + 1] = [P, blk]
    return jnp.moveaxis(y.reshape(shape), dim, 0)


def _jax_unpack(x, axes, dim, n):
    tile = list(x.shape[1:])
    tile[dim] *= x.shape[0]
    y = jnp.moveaxis(x, 0, dim).reshape(tile)
    return jnp.transpose(jax.lax.slice_in_dim(y, 0, n, axis=dim), axes)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_match_jax(dtype):
    x = _values((5, 6, 7, 3), dtype)
    xt = _to_torch(x)
    for axes in [(2, 0, 1, 3), (1, 2, 0, 3), (3, 2, 1, 0), (0, 1, 2, 3)]:
        _same_bits(k1.permute_plain(xt, axes), jnp.transpose(x, axes))
        for dim, P in [(0, 2), (1, 4), (2, 3), (3, 1)]:
            packed = _jax_pack(jnp.asarray(x), axes, dim, P)
            _same_bits(k1.pack_plain(xt, axes, dim, P), packed)
            n = packed.shape[0] * packed.shape[dim + 1] - (P - 1)
            for out_axes in [(0, 1, 2, 3), axes]:
                _same_bits(k1.unpack_plain(_to_torch(packed), out_axes, dim,
                                           n),
                           _jax_unpack(packed, out_axes, dim, n))


def _check_plan(desc, x, want):
    plan = k1.plan_copy(desc, x.element_size())
    got = k1.emulate(plan, x, x.dtype)
    assert got.shape == want.shape
    assert torch.equal(got.reshape(-1).view(torch.uint8),
                       want.reshape(-1).view(torch.uint8))
    return plan


@pytest.mark.parametrize("dtype", DTYPES + ["bool"])
@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 3, 5, 3), (9, 1, 2)])
def test_copy_plans_reproduce_plain(dtype, shape):
    if dtype == "bool":
        xt = torch.from_numpy(_values(shape, "float32") > 0)
    else:
        xt = _to_torch(_values(shape, dtype))
    for axes in itertools.permutations(range(len(shape))):
        _check_plan(k1._describe_permute(shape, axes), xt,
                    k1.permute_plain(xt, axes))
        for dim in range(len(shape)):
            for P in (1, 2, 4):
                packed = k1.pack_plain(xt, axes, dim, P)
                _check_plan(k1._describe_pack(shape, axes, dim, P), xt,
                            packed)
                n = max(0, packed.shape[0] * packed.shape[dim + 1] - (P - 1))
                for out_axes in (tuple(range(len(shape))), axes):
                    _check_plan(
                        k1._describe_unpack(tuple(packed.shape), out_axes,
                                            dim, n),
                        packed, k1.unpack_plain(packed, out_axes, dim, n))


def _tensor(shape, dtype, seed=0):
    if dtype == "bool":
        return torch.from_numpy(_values(shape, "float32", seed) > 0)
    if dtype == "uint8":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    return _to_torch(_values(shape, dtype, seed))


def _check_all(x, axes, align, instance=None):
    """permute, pack and unpack of ``x`` (P = 1, 2, 4 on every dim, ragged
    n), each plan at ``align`` executed by ``emulate`` against the plain
    version; returns the instances the plans took."""
    seen = set()

    def check(desc, src, want):
        plan = k1.plan_copy(desc, src.element_size(), align)
        got = k1.emulate(plan, src, src.dtype)
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), plan
        seen.add(plan.instance)

    shape = tuple(x.shape)
    check(k1._describe_permute(shape, axes), x, k1.permute_plain(x, axes))
    for dim in range(len(shape)):
        for P in (1, 2, 4):
            packed = k1.pack_plain(x, axes, dim, P)
            check(k1._describe_pack(shape, axes, dim, P), x, packed)
            n = max(0, packed.shape[0] * packed.shape[dim + 1] - (P - 1))
            for out_axes in (tuple(range(len(shape))), axes):
                check(k1._describe_unpack(tuple(packed.shape), out_axes, dim,
                                          n), packed,
                      k1.unpack_plain(packed, out_axes, dim, n))
    if instance is not None:
        assert instance in seen, seen
    return seen


EDGE_DTYPES = DTYPES + ["uint8", "bool"]


@pytest.mark.parametrize("dtype", EDGE_DTYPES)
@pytest.mark.parametrize("C", [1, 2, 3, 5, 6, 7, 16])
def test_narrow_plans_reproduce_plain(dtype, C):
    """Component interleave and deinterleave with pack and unpack on every
    dim: over a run of 48 x 37 = 1776 positions (whole 16-byte groups:
    several warp tiles of 32 groups, the last one short), the narrow
    instance for 4-, 8- and 16-byte elements at full alignment, the tiled one (flat tiles)
    for the rest and at 4-byte alignment; over 41 x 37 = 1517 positions
    (not a multiple of 4 or of a tile), the tiled one."""
    size = _tensor((1,), dtype).element_size()
    narrow = C > 1 and size >= 4
    for n0 in (48, 41):
        for shape, axes in (((n0, 37, C), (2, 0, 1)),
                            ((C, n0, 37), (1, 2, 0))):
            x = _tensor(shape, dtype, C)
            for align in (16, 4) if n0 == 48 else (16,):
                want = ("copy" if C == 1 else "narrow"
                        if narrow and n0 == 48 and align == 16 else "tiled")
                _check_all(x, axes, align, want)


@pytest.mark.parametrize("dtype", EDGE_DTYPES)
@pytest.mark.parametrize("shape,axes", [
    ((150, 131), (1, 0)),
    ((67, 5, 70), (2, 0, 1)),
    ((67, 70, 5), (0, 2, 1)),
    ((11, 13, 9, 6), (1, 2, 0, 3)),
])
def test_tiled_plans_reproduce_plain(dtype, shape, axes):
    """Ragged 2-D and 3-D transposes of several tiles, with pack and unpack
    on every dim, at full and 2-byte address alignment."""
    x = _tensor(shape, dtype, 1)
    for align in (16, 2):
        _check_all(x, axes, align, "tiled")


@pytest.mark.parametrize("dtype", EDGE_DTYPES)
@pytest.mark.parametrize("shape,axes", [((96, 64), (1, 0)),
                                        ((3, 64, 32), (0, 2, 1)),
                                        ((16, 8, 6), (1, 0, 2))])
def test_warp_tiles_reproduce_plain(dtype, shape, axes):
    """Transposes of whole tiles: one warp a tile of 128-byte rows for 4-,
    8- and 16-byte elements, of 8 x 8 elements for elements of 2 to 7
    16-byte words (6 components riding a hop), at full alignment; the
    ring for the rest, for pack and unpack with padding, and at 8-byte
    alignment."""
    x = _tensor(shape, dtype, 3)
    size = x.element_size()
    for align in (16, 8):
        plan = k1.plan_copy(k1._describe_permute(shape, axes), size, align)
        E = plan.elem_bytes
        assert plan.instance == "tiled"
        assert plan.warp_tiles == (align == 16 and (
            E in (4, 8, 16) or (E % 16 == 0 and E < 128)))
        if plan.warp_tiles:
            assert plan.TI == plan.TO == (128 // E if E <= 16 else 8)
        _check_all(x, axes, align, "tiled")


@pytest.mark.parametrize("align", [16, 4, 2])
def test_copy_plans_reproduce_plain_misaligned(align):
    """Straight copies: the identity permute (one flat block), an unpack on
    a size-1 axis, and copies of wide elements, at several alignments."""
    x = _tensor((6, 10, 36), "float32", 2)
    for axes in ((0, 1, 2), (1, 0, 2)):
        assert _check_all(x, axes, align) >= {"copy"}
    plan = k1.plan_copy(k1._describe_permute((6, 10, 36), (0, 1, 2)), 4,
                        align)
    assert plan.instance == "copy" and plan.flat_in
    assert plan.word_bytes == min(align, 16)


NS_STAGES = [((512, 512, 257, 6), (3, 0, 1, 2), 8),
             ((6, 512, 512, 512), (1, 2, 3, 0), 4),
             ((512, 512, 512, 3), (3, 0, 1, 2), 4),
             ((3, 512, 512, 257), (1, 2, 3, 0), 8),
             ((512, 512, 257, 3), (3, 0, 1, 2), 8),
             ((3, 512, 512, 512), (1, 2, 3, 0), 4)]


@pytest.mark.parametrize("shape,axes,itemsize", NS_STAGES)
def test_ns_stage_classes_take_narrow(shape, axes, itemsize):
    """The NS step's component moves: a warp's tile of C x 32 groups of
    16 bytes, one block on the interleaved side, C rows on the other."""
    p = k1.plan_copy(k1._describe_permute(shape, axes), itemsize)
    C = shape[-1] if axes[0] == 3 else shape[0]
    assert p.instance == "narrow"
    assert (p.TI, p.TO) == ((C, 512 // itemsize) if p.flat_in
                            else (512 // itemsize, C))
    assert p.flat_in == (axes[0] == 3) and p.flat_out == (axes[0] == 1)
    assert (p.vec_in, p.vec_out, p.word_bytes) == (16, 16, itemsize)


@pytest.mark.parametrize("shape,axes,itemsize,tile,warp", [
    ((512, 512, 512), (2, 0, 1), 4, (32, 32), True),
    ((512, 512, 512), (0, 2, 1), 4, (32, 32), True),
    ((1024, 1024, 1024), (1, 2, 0), 4, (32, 32), True),
    ((512, 512, 512, 6), (1, 2, 0, 3), 8, (8, 8), True),
    ((512, 512, 512, 3), (1, 2, 0, 3), 4, (32, 40), False),
])
def test_hop_classes_take_tiled(shape, axes, itemsize, tile, warp):
    """The hop classes: warp tiles of 32 x 32 f32, and of 8 x 8 48-byte
    elements (6 c64 components); 12-byte elements (3 f32) through the
    ring."""
    p = k1.plan_copy(k1._describe_permute(shape, axes), itemsize)
    assert p.instance == "tiled" and (p.TI, p.TO) == tile
    assert p.warp_tiles == warp
    assert (p.vec_in, p.vec_out) == (16, 16)


def test_main_path_plans():
    """The launches of the main path: a tiled 64 x 64 f32 transpose when
    the contiguous dims differ, a narrow one when one of them holds the
    components, a flat copy when they agree, extra dims folded into a
    wider element when they stay innermost."""
    p = k1.plan_copy(k1._describe_permute((512, 512, 512), (2, 0, 1)), 4)
    assert (p.instance, p.dI, p.dO, p.TI, p.TO, p.word_bytes) == (
        "tiled", 0, 1, 32, 32, 4) and p.warp_tiles
    # FFT stage of the NS step: 6 c64 components moved outermost
    p = k1.plan_copy(k1._describe_permute((512, 512, 257, 6), (3, 0, 1, 2)),
                     8)
    assert p.instance == "narrow" and p.ext == (6, 512 * 512 * 257)
    assert (p.TI, p.TO) == (6, 64)
    # a hop of a 6-component c64 field: components ride as 48-byte rows
    p = k1.plan_copy(k1._describe_permute((512, 512, 512, 6), (1, 2, 0, 3)),
                     8)
    assert (p.elem_bytes, p.word_bytes, p.instance) == (48, 16, "tiled")
    # unpack on a size-1 axis is one flat copy
    p = k1.plan_copy(k1._describe_unpack((1, 64, 64, 64), (0, 1, 2), 0, 64),
                     4)
    assert p.instance == "copy" and p.flat_in and p.ext == (1,)
    # pack with padding keeps its zero mask
    p = k1.plan_copy(k1._describe_pack((9, 16, 5), (1, 2, 0), 2, 4), 8)
    assert p.zbound == 9


def test_cpu_tensors_use_the_plain_version():
    before = k1.launches
    by = dict(k1.launches_by_instance)
    x = torch.arange(60.0).reshape(3, 4, 5)
    assert torch.equal(k1.permute(x, (2, 0, 1)), k1.permute_plain(x, (2, 0, 1)))
    assert torch.equal(k1.pack(x, (1, 0, 2), 1, 2),
                       k1.pack_plain(x, (1, 0, 2), 1, 2))
    assert k1.launches == before and k1.launches_by_instance == by


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="device"):
        k1.permute(torch.empty((2, 3), device="meta"), (1, 0))
    with pytest.raises(ValueError, match="permutation"):
        k1.permute(torch.empty((2, 3)), (0, 0))
    with pytest.raises(ValueError, match="exceeds"):
        k1.unpack(torch.empty((2, 3, 4)), (0, 1), 0, 7)



def _view(base, dim, s0, s1, offset):
    """``base`` narrowed to ``[s0, s1)`` along ``dim``, moved ``offset``
    elements into a larger buffer (its storage offset)."""
    buf = torch.zeros(base.numel() + offset, dtype=base.dtype)
    whole = buf[offset:].view(base.shape)
    whole.copy_(base)
    return whole.narrow(dim, s0, s1 - s0)


def _align(*ts):
    """The alignment the card would see for views of 16-byte aligned
    buffers: the largest power of two (<= 16) dividing each offset."""
    a = 16
    for t in ts:
        while (t.storage_offset() * t.element_size()) % a:
            a //= 2
    return a


# (shape, axes, chunk dim): a Pipelined hop's chunks of a pack's input
# and an unpack's output, along a spatial dim and along an extra dim
CHUNKS = [((12, 10, 9), (2, 0, 1), 1), ((12, 10, 9), (0, 2, 1), 0),
          ((8, 6, 10, 3), (1, 2, 0, 3), 3), ((8, 6, 10, 6), (2, 0, 1, 3), 1),
          ((16, 8, 12), (1, 0, 2), 2)]


@pytest.mark.parametrize("dtype", DTYPES + ["bool"])
@pytest.mark.parametrize("shape,axes,cdim", CHUNKS)
def test_chunk_plans_reproduce_plain(dtype, shape, axes, cdim):
    """Chunks of a block in K = 3 ceil pieces (a short tail chunk), read
    by pack and permute from a strided view and written by unpack and
    permute into a view of a larger output, with source and destination
    offsets that keep 16-byte alignment and ones that do not: every plan
    ``plan_copy`` makes for them, run by ``emulate``, is the plain
    version bit for bit, and leaves the output's other bytes alone."""
    base = _tensor(shape, dtype, 4)
    n = shape[cdim]
    step = -(-n // 3)
    bounds = [(s, min(s + step, n)) for s in range(0, n, step)]
    assert bounds[-1][1] - bounds[-1][0] < step or n % 3 == 0
    size = base.element_size()
    for s0, s1 in bounds:
        for off in (0, 16 // size if size < 16 else 1, 1):
            v = _view(base, cdim, s0, s1, off)
            assert not v.is_contiguous() or cdim == 0
            for dim, P in ((0, 2), (len(shape) - 1, 3)):
                want = k1.pack_plain(v, axes, dim, P)
                plan = k1.plan_copy(k1._describe_pack(
                    tuple(v.shape), axes, dim, P, v.stride()), size,
                    _align(v))
                got = k1.emulate(plan, v, v.dtype)
                assert torch.equal(got, want), plan
                # unpack of that chunk's tiles into its slice of a bigger
                # output, offset by `off` elements
                n_a = want.shape[0] * want.shape[dim + 1] - (P - 1)
                res = k1.unpack_plain(want, tuple(range(len(shape))), dim,
                                      n_a)
                big_shape = list(res.shape)
                big_shape[cdim] += 5
                big = _tensor(tuple(big_shape), dtype, 5)
                dst = _view(big, cdim, 2, 2 + res.shape[cdim], off)
                full = dst.as_strided((big.numel() + off,), (1,), 0)
                before = full.clone()
                plan = k1.plan_copy(k1._describe_unpack(
                    tuple(want.shape), tuple(range(len(shape))), dim, n_a,
                    None, dst.stride()), size, _align(dst))
                k1.emulate(plan, want, want.dtype, out=dst)
                assert torch.equal(dst, res), plan
                keep = torch.ones(full.shape, dtype=torch.bool)
                keep.as_strided(dst.shape, dst.stride(),
                                dst.storage_offset()).fill_(False)
                assert torch.equal(full[keep], before[keep])
            # permute from the strided chunk into a strided destination
            want = k1.permute_plain(v, axes)
            plan = k1.plan_copy(k1._describe_permute(
                tuple(v.shape), axes, v.stride()), size, _align(v))
            assert torch.equal(k1.emulate(plan, v, v.dtype), want), plan


def test_pipelined_cycle_chunks_keep_their_instances():
    """The 1024^3 f32 cycle's Pipelined(4) and Pipelined(3, Ring())
    chunks (chip_smoke.py phase 3), planned from meta views of the real
    blocks: every pack takes warp tiles, every unpack on the size-1 axis
    is a copy of 16-byte words (a whole chunk one flat block where it is
    contiguous in the output)."""
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    topo = pat.Topology((1, 1), device="cpu")
    shape = (1024, 1024, 1024)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    chain = [px, py, pz, py, px]
    flat = 0
    for K in (4, 3):
        for pin, pout in zip(chain, chain[1:]):
            R = tr.assert_compatible(pin, pout)
            ex = tr._Exchange(pin, pout, 0, pat.AllToAll())
            ext = tr._exchange_operand_extents(pin, pout, R)
            c = tr._pipeline_chunk_axis(ext, pin.decomposition[R],
                                        pout.decomposition[R])
            data = torch.empty(pin.padded_size_local(pat.MemoryOrder),
                               device="meta")
            out = torch.empty(pout.padded_size_local(pat.MemoryOrder),
                              device="meta")
            for s0, s1 in tr._chunk_bounds(ext[c], K):
                v = data.narrow(ex.fwd_in.index(c), s0, s1 - s0)
                d = k1._describe_pack(tuple(v.shape), ex.pack_axes,
                                      ex.tile_b, 1, v.stride())
                p = k1.plan_copy(d, 4, _align(v))
                assert p.instance == "tiled" and p.warp_tiles, p
                o = out.narrow(ex.fwd_out.index(c), s0, s1 - s0)
                u = k1.plan_copy(k1._describe_unpack(
                    d[0], ex.ident, ex.tile_a, ex.n_a, None, o.stride()), 4,
                    _align(o))
                assert u.instance == "copy" and u.word_bytes == 16, u
                flat += u.ext == (1,)
    assert flat == 2 * 4 + 2 * 3   # the y <-> z hops chunk the outer dim
