"""Inputs made from the seed, and the memory layouts of pencils.

Plain PyTorch: the harness's own generator, shared by the program's side
and the reference's side of a cell.  A pencil's memory order lists, for
each memory axis, the logical dim it holds (``order[k]`` is the logical
dim of memory axis ``k``); vector components are an extra dim after the
spatial ones in the program's layout and the first dim in the
reference's ``(C, X, Y, Z)`` layout.
"""

from __future__ import annotations

from typing import Sequence

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def to_memory(ref: torch.Tensor, order: Sequence[int]) -> torch.Tensor:
    """``(C, X, Y, Z)`` -> the pencil's memory order with the components
    last, contiguous."""
    return ref.permute(*[1 + d for d in order], 0).contiguous()


def from_memory(mem: torch.Tensor, order: Sequence[int]) -> torch.Tensor:
    """The pencil's memory order with the components last -> a
    ``(C, X, Y, Z)`` view."""
    return mem.permute(len(order), *[list(order).index(d)
                                     for d in range(len(order))])


def logical_view(mem: torch.Tensor, order: Sequence[int]) -> torch.Tensor:
    """A memory-order array (no extra dims) as a logical-order view."""
    return mem.permute(*[list(order).index(d) for d in range(len(order))])


def mode_numbers(shape: Sequence[int], device, dtype=torch.float64):
    """Integer wavenumbers of a real-to-complex transform over a
    ``2*pi`` box, broadcast-shaped ``(X', 1, 1)``, ``(1, Y, 1)``,
    ``(1, 1, Z)``: the first dim is the real one (``0 .. n/2``), the
    others run ``0 .. n/2 - 1, -n/2 .. -1``."""
    nx, ny, nz = shape
    kx = torch.arange(nx // 2 + 1, device=device, dtype=dtype)
    ky = torch.fft.fftfreq(ny, 1.0 / ny, device=device, dtype=dtype)
    kz = torch.fft.fftfreq(nz, 1.0 / nz, device=device, dtype=dtype)
    return kx.view(-1, 1, 1), ky.view(1, -1, 1), kz.view(1, 1, -1)


def rfft3(u: torch.Tensor) -> torch.Tensor:
    """Forward transform of ``(C, X, Y, Z)`` real fields: real along X,
    complex along Y and Z, unnormalized."""
    return torch.fft.fft(torch.fft.fft(torch.fft.rfft(u, dim=1), dim=2),
                         dim=3)


def irfft3(uh: torch.Tensor, nx: int) -> torch.Tensor:
    """Inverse of :func:`rfft3`, normalized by the number of points."""
    return torch.fft.irfft(torch.fft.ifft(torch.fft.ifft(uh, dim=3), dim=2),
                           n=nx, dim=1)


def solenoidal_spectrum(shape: Sequence[int], gen: torch.Generator, *,
                        k_peak: float, k_max: float,
                        u_max: float) -> torch.Tensor:
    """A seeded divergence-free velocity field with energy near
    ``|k| = k_peak``, none above ``k_max`` and no mean, scaled so that the
    largest speed on the grid is ``u_max``: the Fourier coefficients
    ``(3, X/2 + 1, Y, Z)`` complex64 of a real field.  White noise made on
    the device, filtered and projected, so every seed gives another flow
    of the same spectrum; scaling by the largest speed gives every seed
    the same Courant number, so a step that is stable for one seed is
    stable for all."""
    nx, ny, nz = shape
    device = gen.device
    noise = torch.randn((3, nx, ny, nz), generator=gen, device=device)
    uh = rfft3(noise)
    del noise
    kx, ky, kz = mode_numbers(shape, device, torch.float32)
    k2 = kx * kx + ky * ky + kz * kz
    envelope = torch.exp(-k2 / (k_peak * k_peak)) * (k2 <= k_max * k_max)
    envelope[0, 0, 0] = 0.0
    uh *= envelope
    div = (uh[0] * kx + uh[1] * ky + uh[2] * kz) / torch.where(
        k2 == 0, torch.ones_like(k2), k2)
    uh[0] -= div * kx
    uh[1] -= div * ky
    uh[2] -= div * kz
    del div
    speed = irfft3(uh, nx).square().sum(dim=0).max().sqrt()
    return uh * (u_max / speed)
