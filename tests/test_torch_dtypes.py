"""PyTorch port vs JAX package: every element type of the pipeline.

Every case of ``tests/test_dtypes.py`` on a ``(2, 4)`` topology (the port
on 8 ranks of the shared gloo pool, the JAX package on its 8-device CPU
mesh, the same seeded inputs), with all 11 of its ``DTYPES``.  Data
movement is bit-identical to JAX's padded arrays and to the input (bf16
compared as its 16-bit patterns); ``maximum``/``minimum`` over a ragged
shape and ``any``/``all`` of bools are exact.  The JAX file's x64 cases
(no f64/c128 value in an f32 plan's or model's program under
``jax_enable_x64``) become "an f32 plan or model stays f32": no op of the
port's f32 forward or NS step yields a float64 or complex128 tensor.  Its
downcast warning has no counterpart: the port's ``from_global`` keeps the
input's dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat
import torch_parity_tasks as tasks
import torch_rank_tasks
from pencilarrays_tpu import ops as jops
from test_dtypes import DTYPES, sample

DIMS = (2, 4)


@pytest.fixture(scope="module")
def pool():
    return torch_rank_tasks.shared_pool()


@pytest.fixture(scope="module")
def topo(devices):
    return jpa.Topology(DIMS, devices=devices)


def _bf16(dtype):
    return np.dtype(dtype).name == "bfloat16"


def _wire(u):
    """``u`` as the rank tasks take it: bf16 as its uint16 bits."""
    return (u.view(np.uint16), True) if _bf16(u.dtype) else (u, False)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_transpose_roundtrip_every_dtype(topo, pool, dtype):
    shape = (10, 11, 12)
    u = sample(shape, dtype)
    spec_a, spec_b = ((1, 2), (2, 0, 1)), ((0, 2), None)
    pen_a = jpa.Pencil(topo, shape, (1, 2),
                       permutation=jpa.Permutation(2, 0, 1))
    pen_b = jpa.Pencil(topo, shape, (0, 2))
    x = jpa.PencilArray.from_global(pen_a, u)
    data, bf16 = _wire(u)
    for name in ("AllToAll", "Gspmd"):
        want = np.asarray(jpa.transpose(x, pen_b,
                                        method=getattr(jpa, name)()).data)
        r = pool.run(tasks.chain_case, DIMS, shape, [spec_a, spec_b], data,
                     [(name, {})], bf16)[0]
        (bits, got), = r["hops"]
        assert np.array_equal(_bits(bits), _bits(want)), name
        assert np.array_equal(_bits(got), _bits(u)), name
        assert r["same"] and np.array_equal(_bits(r["back"]), _bits(u))


@pytest.mark.parametrize("dtype", [jnp.float16, jnp.bfloat16, jnp.int16,
                                   jnp.uint8],
                         ids=lambda d: np.dtype(d).name)
def test_reductions_narrow_dtypes(topo, pool, dtype):
    shape = (9, 11, 13)  # ragged: masking must hold for narrow types too
    u = sample(shape, dtype)
    x = jpa.PencilArray.from_global(jpa.Pencil(topo, shape, (1, 2)), u)
    data, bf16 = _wire(u)
    r = pool.run(tasks.reductions_case, DIMS, shape, ((1, 2), None), data,
                 ["maximum", "minimum"], (), bf16)[0]
    assert r["maximum"] == float(jops.maximum(x)) == float(u.max())
    assert r["minimum"] == float(jops.minimum(x)) == float(u.min())


def test_bool_any_all_ragged(topo, pool):
    shape = (9, 11, 13)
    spec = ((1, 2), None)
    pen = jpa.Pencil(topo, shape, (1, 2))
    u = np.ones(shape, dtype=bool)
    u2 = np.zeros(shape, dtype=bool)
    u2[8, 10, 12] = True
    for a, want in ((u, (True, True)), (u2, (True, False))):
        x = jpa.PencilArray.from_global(pen, a)
        assert (bool(jops.any(x)), bool(jops.all(x))) == want
        assert tuple(pool.run(tasks.any_all_case, DIMS, shape, spec,
                              a)[0]) == want


@pytest.fixture(scope="module")
def f32_run(pool):
    return pool.run(tasks.stays_f32_case, DIMS, (8, 6, 10), 8)[0]


def test_f32_plan_stays_f32(f32_run):
    """An f32 r2c plan in every normalization: no op of its forward
    yields a float64 or complex128 tensor; its output is c64, its real
    dtype and wavenumbers f32."""
    for norm in ("backward", "ortho", "forward", "none"):
        r = f32_run[norm]
        bad = {"float64", "complex128"} & set(r["seen"])
        assert not bad, f"norm={norm} yields {bad}"
        assert r["out"] == "torch.complex64"
        assert r["real"] == "torch.float32"
        assert r["k"] == ["torch.float32"]


def test_f32_ns_model_stays_f32(f32_run):
    r = f32_run["ns"]
    assert r["state"] == r["out"] == "torch.complex64"
    bad = {"float64", "complex128"} & set(r["seen"])
    assert not bad, f"NS step yields {bad}"


def test_from_global_keeps_the_dtype(topo):
    """The port has no x64 switch: ``from_global`` stores a float64 input
    as float64, with no warning (the JAX package, x64 off, stores it as
    float32 and warns ``stored as``)."""
    import warnings

    pen = pat.Pencil(pat.Topology((1, 1), device="cpu"), (8, 8), (0, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = pat.PencilArray.from_global(pen, np.zeros((8, 8), np.float64))
    assert str(x.dtype) == "torch.float64"
