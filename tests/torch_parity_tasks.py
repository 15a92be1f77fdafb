"""Rank functions of ``tests/test_torch_topologies.py``,
``test_torch_dtypes.py`` and ``test_torch_fuzz.py``: transposes, reshards,
reductions, FFT plans and I/O on 1-, 2- and 3-D topologies of the shared
gloo pool.

Imported by the pool's rank processes, so it imports torch, NumPy and the
port only — never JAX.  Pencils are ``(decomp_dims, perm)`` with ``perm``
a tuple or ``None``; methods are ``(name, kwargs)``.  Every function
returns NumPy results from rank 0 (``None`` from the other ranks).  A
``bfloat16`` array crosses as its ``uint16`` bit pattern (``bf16=True``).
"""

import numpy as np
import torch

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.interop import to_numpy_padded
from pencilarrays_tpu_torch.ops import reductions as R
from torch_rank_tasks import _rank0, _sub_pencil, sub_topology


def _method(spec):
    if spec is None:
        return None
    name, kw = spec
    return getattr(pat, name)(**kw)


def _input(u, bf16=False):
    t = torch.from_numpy(np.array(u, copy=True))
    return t.view(torch.bfloat16) if bf16 else t


def _bits(x):
    """The padded global array of ``x`` as raw bits (bf16 as uint16)."""
    if x.dtype == torch.bfloat16:
        x = pat.PencilArray(x.pencil, x.data.view(torch.int16),
                            x.extra_dims)
    return to_numpy_padded(x)


def _gathered(x):
    if x.dtype == torch.bfloat16:
        x = pat.PencilArray(x.pencil, x.data.view(torch.int16),
                            x.extra_dims)
    return pat.gather(x)


def chain_case(dims, shape, specs, u, methods, bf16=False, back=True):
    """From ``specs[0]``, transpose through ``specs[1:]`` (hop ``i`` by
    ``methods[i]``; ``"reshard"`` for a reshard) and back: the padded
    bits and the gathered array after each hop, the gathered array of
    the return, and whether the return equals the start bit for bit."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pens = [_sub_pencil(topo, shape, *s) for s in specs]
    x0 = pat.PencilArray.from_global(pens[0], _input(u, bf16))
    x, hops = x0, []
    for pen, m in zip(pens[1:], methods):
        x = (pat.reshard(x, pen) if m == "reshard"
             else pat.transpose(x, pen, method=_method(m)))
        assert x.pencil == pen
        hops.append((_bits(x), _gathered(x)))
    same = None
    if back:
        for pen, m in zip(reversed(pens[:-1]), reversed(methods)):
            x = (pat.reshard(x, pen) if m == "reshard"
                 else pat.transpose(x, pen, method=_method(m)))
        same = bool(torch.equal(x.data.view(torch.uint8),
                                x0.data.view(torch.uint8)))
    return _rank0(dict(hops=hops, back=_gathered(x), same=same))


def refuses_case(dims, shape, spec_a, spec_b, u):
    """A transpose between pencils differing in more than one slot
    raises (the message), and ``reshard`` moves the array instead."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pa, pb = (_sub_pencil(topo, shape, *s) for s in (spec_a, spec_b))
    x = pat.PencilArray.from_global(pa, u)
    try:
        pat.transpose(x, pb)
        msg = None
    except ValueError as e:
        msg = str(e)
    y = pat.reshard(x, pb)
    return _rank0((msg, _bits(y), pat.gather(y)))


def reductions_case(dims, shape, spec, u, names, extra=(), bf16=False):
    """The reductions ``names`` of ``u`` as Python numbers."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, *spec)
    x = pat.PencilArray.from_global(pen, _input(u, bf16), len(extra))
    out = {}
    for name in names:
        v = getattr(R, name)(x)
        out[name] = v.item()
    return _rank0(out)


def fully_decomposed_case(dims, shape, spec, u):
    """M = N: the gathered array, sum, maximum and mean, and ``np.cos``
    through the NumPy protocol (wrapped, gathered)."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen = _sub_pencil(topo, shape, *spec)
    x = pat.PencilArray.from_global(pen, u)
    y = np.cos(x)
    return _rank0(dict(
        decomposition=pen.decomposition, gathered=pat.gather(x),
        sum=R.sum(x).item(), max=R.maximum(x).item(),
        mean=R.mean(x).item(), cos_wrapped=isinstance(y, pat.PencilArray),
        cos=pat.gather(y)))


def default_pencil_case(dims, shape, perm, u):
    """A pencil of default decomposition on an M = N topology, and a
    transpose that changes only its permutation: the decomposition, the
    new permutation, the padded bits and the gathered array."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    pen1 = pat.Pencil(topo, shape)
    pen2 = pen1.replace(permutation=pat.Permutation(*perm))
    x = pat.PencilArray.from_global(pen1, u)
    y = pat.transpose(x, pen2)
    return _rank0(dict(decomposition=pen1.decomposition,
                       identity=pen1.permutation.is_identity(),
                       perm=tuple(y.pencil.permutation.apply(
                           tuple(range(len(shape))))),
                       bits=_bits(y), gathered=pat.gather(y)))


def fft_case(dims, shape, u, kwargs):
    """Forward and backward of a plan on ``u``: gathered spectrum and
    round trip."""
    topo = sub_topology(dims)
    if topo is None:
        return None
    kwargs = dict(kwargs)
    if "dtype" in kwargs:
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    plan = pat.PencilFFTPlan(topo, shape, **kwargs)
    uh = plan.forward(pat.PencilArray.from_global(plan.input_pencil, u))
    back = plan.backward(uh)
    return _rank0((pat.gather(uh), pat.gather(back)))


def io_restart_case(dims_full, dims_flat, shape, spec_full, spec_flat, u,
                    path):
    """Write ``u`` under the M = N pencil, read it under the other
    topology's pencil, append that array as ``v``, read ``v`` back into
    the M = N pencil: the gathered reads, and whether the last read
    lives on the M = N pencil."""
    from pencilarrays_tpu_torch.io import BinaryDriver, open_file

    full = sub_topology(dims_full)
    flat = sub_topology(dims_flat)
    if full is None:
        return None
    pen = _sub_pencil(full, shape, *spec_full)
    pen2 = _sub_pencil(flat, shape, *spec_flat)
    x = pat.PencilArray.from_global(pen, u)
    with open_file(BinaryDriver(), path, comm=full.group, write=True,
                   create=True) as f:
        f.write("u", x)
    with open_file(BinaryDriver(), path, comm=flat.group, read=True) as f:
        back = f.read("u", pen2)
    with open_file(BinaryDriver(), path, comm=flat.group, append=True,
                   write=True) as f:
        f.write("v", back)
    with open_file(BinaryDriver(), path, comm=full.group, read=True) as f:
        again = f.read("v", pen)
    return _rank0(dict(back=pat.gather(back), again=pat.gather(again),
                       on_pen=again.pencil == pen))


def any_all_case(dims, shape, spec, u):
    topo = sub_topology(dims)
    if topo is None:
        return None
    x = pat.PencilArray.from_global(_sub_pencil(topo, shape, *spec), u)
    return _rank0((bool(R.any(x)), bool(R.all(x))))


def stays_f32_case(dims, shape, n):
    """Every dtype an op yields (``TorchDispatchMode``) through an f32
    r2c plan's forward in each normalization, through one step of an f32
    Navier-Stokes model, and the dtypes of the plan's wavenumbers and
    the results."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pencilarrays_tpu_torch.models import (
        NavierStokesSpectral, taylor_green)

    topo = sub_topology(dims)
    if topo is None:
        return None

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.dtypes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.dtypes.add(str(t.dtype).split(".")[-1])
            return out

    res = {}
    for norm in ("backward", "ortho", "forward", "none"):
        plan = pat.PencilFFTPlan(topo, shape, real=True, dtype=torch.float32,
                                 normalization=norm)
        x = pat.PencilArray.zeros(plan.input_pencil, (), torch.float32)
        with Seen() as seen:
            uh = plan.forward(x)
        res[norm] = dict(seen=sorted(seen.dtypes), out=str(uh.dtype),
                         real=str(plan.dtype_real),
                         k=sorted({str(k.dtype) for k in
                                   plan.wavenumbers()}))
    model = NavierStokesSpectral(topo, n, viscosity=1e-2,
                                 dtype=torch.float32)
    uh = taylor_green(model)
    with Seen() as seen:
        out = model.step(uh, 1e-3)
    res["ns"] = dict(seen=sorted(seen.dtypes), state=str(uh.dtype),
                     out=str(out.dtype))
    return _rank0(res)
