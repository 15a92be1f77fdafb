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


def test_main_path_plans():
    """The launches of the main path: a both-sides-coalesced tile when
    the contiguous dims differ, a straight copy when they agree, extra
    dims folded into a wider element when they stay innermost."""
    p = k1.plan_copy(k1._describe_permute((512, 512, 512), (2, 0, 1)), 4)
    assert (p.dI, p.dO, p.TI, p.TO, p.word_bytes) == (0, 1, 32, 32, 4)
    # FFT stage of the NS step: 6 c64 components moved outermost
    p = k1.plan_copy(k1._describe_permute((512, 512, 257, 6), (3, 0, 1, 2)),
                     8)
    assert p.dI >= 0 and p.ext == (6, 512 * 512 * 257)
    # a hop of a 6-component c64 field: components ride as 48-byte rows
    p = k1.plan_copy(k1._describe_permute((512, 512, 512, 6), (1, 2, 0, 3)),
                     8)
    assert (p.elem_bytes, p.word_bytes) == (48, 16) and p.dI >= 0
    # unpack on a size-1 axis is one contiguous copy
    p = k1.plan_copy(k1._describe_unpack((1, 64, 64, 64), (0, 1, 2), 0, 64),
                     4)
    assert p.dI == -1 and p.ext == (1,)
    # pack with padding keeps its zero mask
    p = k1.plan_copy(k1._describe_pack((9, 16, 5), (1, 2, 0), 2, 4), 8)
    assert p.zbound == 9


def test_cpu_tensors_use_the_plain_version():
    before = k1.launches
    x = torch.arange(60.0).reshape(3, 4, 5)
    assert torch.equal(k1.permute(x, (2, 0, 1)), k1.permute_plain(x, (2, 0, 1)))
    assert torch.equal(k1.pack(x, (1, 0, 2), 1, 2),
                       k1.pack_plain(x, (1, 0, 2), 1, 2))
    assert k1.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="device"):
        k1.permute(torch.empty((2, 3), device="meta"), (1, 0))
    with pytest.raises(ValueError, match="permutation"):
        k1.permute(torch.empty((2, 3)), (0, 0))
    with pytest.raises(ValueError, match="exceeds"):
        k1.unpack(torch.empty((2, 3, 4)), (0, 1), 0, 7)

