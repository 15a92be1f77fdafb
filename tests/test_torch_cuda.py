"""Kernel K1 on the card: the CUDA kernel against its plain version.

Needs an NVIDIA GPU and ``nvcc``; skips elsewhere (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine without them::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pencilarrays_tpu_torch.ops import permute as k1

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128,
          torch.bfloat16, torch.int32]


def _values(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 100
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (a CUDA kernel has no "
                    "CPU mode)")
    before = k1.launches
    for dtype in DTYPES:
        x = _values((33, 17, 45, 3), dtype).cuda()
        for axes in [(2, 0, 1, 3), (3, 2, 1, 0), (1, 0, 2, 3)]:
            assert _same_bits(k1.permute(x, axes), k1.permute_plain(x, axes))
            for dim, P in [(0, 4), (2, 3)]:
                got = k1.pack(x, axes, dim, P)
                assert _same_bits(got, k1.pack_plain(x, axes, dim, P))
                n = got.shape[0] * got.shape[dim + 1] - 1
                assert _same_bits(k1.unpack(got, axes, dim, n),
                                  k1.unpack_plain(got, axes, dim, n))
    torch.cuda.synchronize()
    assert k1.launches - before == len(DTYPES) * 3 * 5
