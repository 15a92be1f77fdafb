"""Random fills for PencilArrays.

PyTorch counterpart of the JAX package's ``ops/random.py`` (reference
``src/random.jl``: ``rand!``/``randn!`` fill the parent array on the
device).  JAX's counter-based PRNG makes its fills deterministic per
global position, whatever the device count; its bits cannot be matched
here.  The port keeps the property with its own counter-based generator:
each value is a function of the seed and of the element's GLOBAL logical
index only (``splitmix64``: the state ``seed_mix + (L + 1) * golden``, then
its finalizer, in torch ``int64`` arithmetic, which wraps alike on the CPU
and the card).  The same seed therefore gives the same global array on
any number of ranks and on the card as on the CPU: ``uniform`` bit for
bit; ``normal`` up to the device's ``log``/``cos``/``sin`` rounding.

Tail padding stays zero, as the port's storage contract says; the JAX
package fills its padding with random values too.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..parallel.arrays import PencilArray, as_torch_dtype
from ..parallel.pencil import LogicalOrder, Pencil

__all__ = ["uniform", "normal"]

_GOLDEN = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_SLAB = 1 << 24          # elements hashed at once: bounds the int64 temporaries


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _finalize(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's output function (Steele, Lea & Flood 2014)."""
    z = (z ^ _srl(z, 30)) * _i64(_M1)
    z = (z ^ _srl(z, 27)) * _i64(_M2)
    return z ^ _srl(z, 31)


def _seed_mix(seed: int) -> int:
    """The seed's own splitmix64 output (host side, exact)."""
    m = (1 << 64) - 1
    z = (int(seed) + _GOLDEN) & m
    z = ((z ^ (z >> 30)) * _M1) & m
    z = ((z ^ (z >> 27)) * _M2) & m
    return _i64(z ^ (z >> 31))


def _bits(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """64 random bits per int64 counter (``counter >= 0``)."""
    return _finalize((counter + 1) * _i64(_GOLDEN) + _seed_mix(seed))


def _unit(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Uniform [0, 1) from the top 24 (float32) or 53 (float64) bits."""
    if dtype == torch.float64:
        return _srl(bits, 11).to(torch.float64) * 2.0 ** -53
    return _srl(bits, 40).to(torch.float32) * 2.0 ** -24


def _filled(pencil: Pencil, seed: int, extra_dims: Tuple[int, ...], dtype,
            sample) -> PencilArray:
    """A PencilArray whose true elements are ``sample(L)``, ``L`` their
    global logical linear indices (int64), generated in slabs of memory
    dim 0; tail padding zero."""
    dtype = as_torch_dtype(dtype)
    dev = pencil.topology.device
    extra = tuple(int(e) for e in extra_dims)
    N = pencil.ndims
    glob = pencil.size_global(LogicalOrder) + extra
    strides = [math.prod(glob[d + 1:]) for d in range(len(glob))]
    ranges = pencil.range_local(order=LogicalOrder) + tuple(
        range(0, e) for e in extra)
    padded = pencil.padded_size_local(LogicalOrder) + extra
    mem = pencil.permutation.apply(tuple(range(N))) + tuple(
        range(N, N + len(extra)))          # logical dim at each memory dim
    # per memory dim: the global index term of each padded position, and
    # whether the position holds true data
    terms, valid = [], []
    for pos, d in enumerate(mem):
        n, r = padded[d], ranges[d]
        i = torch.arange(n, device=dev, dtype=torch.int64)
        shape = [1] * len(mem)
        shape[pos] = n
        terms.append(((i + r.start) * strides[d]).reshape(shape))
        valid.append((i < len(r)).reshape(shape))
    shape_mem = tuple(padded[d] for d in mem)
    out = torch.zeros(shape_mem, dtype=dtype, device=dev)
    per_row = math.prod(shape_mem[1:])
    rows = max(1, _SLAB // max(per_row, 1))
    for a in range(0, shape_mem[0], rows):
        b = min(a + rows, shape_mem[0])
        L, ok = terms[0][a:b], valid[0][a:b]
        for t, v in zip(terms[1:], valid[1:]):
            L = L + t
            ok = ok & v
        out[a:b] = torch.where(ok, sample(L), torch.zeros((), dtype=dtype,
                                                           device=dev))
    return PencilArray(pencil, out, extra)


def uniform(pencil: Pencil, seed: int, extra_dims: Tuple[int, ...] = (),
            dtype=torch.float32) -> PencilArray:
    """U[0, 1) fill (reference ``rand!``), float32 or float64: the same
    bits for the same seed at any rank count, on the CPU and the card."""
    dtype = as_torch_dtype(dtype)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"uniform fills float32 or float64, not {dtype}")
    return _filled(pencil, seed, extra_dims, dtype,
                   lambda L: _unit(_bits(L, seed), dtype))


def normal(pencil: Pencil, seed: int, extra_dims: Tuple[int, ...] = (),
           dtype=torch.float32) -> PencilArray:
    """Standard-normal fill (reference ``randn!``) by Box–Muller over two
    counters per element.  Complex dtypes get the standard complex normal
    (variance 1, 0.5 per component), as Julia's ``randn`` and
    ``jax.random.normal``."""
    dtype = as_torch_dtype(dtype)
    real = torch.empty((), dtype=dtype).real.dtype
    if real not in (torch.float32, torch.float64):
        raise TypeError(f"normal fills float32/64 or complex64/128, not "
                        f"{dtype}")

    def sample(L):
        u1 = 1.0 - _unit(_bits(2 * L, seed), real)       # (0, 1]
        u2 = _unit(_bits(2 * L + 1, seed), real)
        r = torch.sqrt(-2.0 * torch.log(u1))
        phi = (2.0 * math.pi) * u2
        if dtype.is_complex:
            return torch.complex(r * torch.cos(phi), r * torch.sin(phi)) \
                * math.sqrt(0.5)
        return r * torch.cos(phi)

    return _filled(pencil, seed, extra_dims, dtype, sample)
