"""Kernels K1–K4 on the card: each CUDA kernel against its plain version.

Needs an NVIDIA GPU and ``nvcc``; skips elsewhere (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine without them.  The flash tests share their comparisons and
tolerances with ``chip_smoke.py``; run from the repository root::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pencilarrays_tpu_torch.ops import flash
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
    _skip_without_card()
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


@pytest.mark.cuda
def test_k1_instances_at_their_edges():
    """Each K1 instance against the plain versions at its edges
    (chip_smoke.py's k1_edges: short dims C = 1, 2, 3, 5, 6, 7, 16 both
    ways, ragged runs and tiles, pack/unpack with P = 1, 2, 4, seven
    element types, inputs off a 16-byte boundary); every instance runs."""
    _skip_without_card()
    from chip_smoke import k1_edges

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, by = k1_edges(torch, k1, gen)
    assert n > 0 and set(by) == set(k1.INSTANCES), by
    assert all(c > 0 for c in by.values()), by


@pytest.mark.cuda
def test_k1_chunk_views():
    """K1 on a Pipelined hop's chunk views against the plain versions
    (chip_smoke.py's k1_chunks: strided sources and destinations, ragged
    tail chunks, a chunk along an extra dim, storage offsets that keep
    16-byte alignment and ones that do not); the output's bytes outside
    the view stay."""
    _skip_without_card()
    from chip_smoke import k1_chunks

    gen = torch.Generator(device="cuda").manual_seed(2)
    n, by = k1_chunks(torch, k1, gen)
    assert n > 0 and by["tiled"] > 0 and by["copy"] > 0, by


@pytest.mark.cuda
def test_k1_launch_beyond_2_31_words():
    """A narrow launch over 3 x 1024^3 f32 words (12.9 GB) is bit-identical
    to the plain version."""
    _skip_without_card()
    from chip_smoke import k1_beyond_2_31

    gen = torch.Generator(device="cuda").manual_seed(1)
    assert k1_beyond_2_31(torch, k1, gen) > 2 ** 31


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (a CUDA kernel has no "
                    "CPU mode)")


def _by_instance():
    return [dict(c) for c in (flash.launches_fwd_by_instance,
                              flash.launches_dq_by_instance,
                              flash.launches_dkv_by_instance)]


def _flash_case(dtype, causal, q_off, kv_off, q, k, v):
    """flash_compare within chip_smoke.py's tolerances, with the launches
    it makes: K2 three times (its three modes), by the wgmma instance in
    bf16 and by the tf32x3 one in f32; K3 and K4 twice each in f32 (full
    and partials backward), by the tf32x3 instance, three times each in
    bf16 (full and partials with a bf16 dO by the wgmma instance, partials
    with an f32 dO by the tf32x3 one), at every head dim; above d = 256
    each by its wide kernels, and K2's retired simt instance never."""
    from chip_smoke import FLASH_TOL, flash_compare

    n0 = (flash.launches_fwd, flash.launches_dq, flash.launches_dkv)
    by0 = _by_instance()
    errs = flash_compare(torch, flash, q, k, v, causal, q_off, kv_off)
    name = str(dtype).split(".")[-1]
    for key, err in errs.items():
        assert err <= FLASH_TOL[(key, name)], (key, err)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (flash.launches_fwd - n0[0], flash.launches_dq - n0[1],
            flash.launches_dkv - n0[2]) == ((3, 3, 3) if bf16 else (3, 2, 2))
    by = [{i: c[i] - c0[i] for i in c0}
          for c, c0 in zip(_by_instance(), by0)]
    want_fwd = {"wgmma": 3 * bf16, "tf32x3": 3 * (not bf16), "simt": 0}
    want_bwd = ({"wgmma": 2, "tf32x3": 1} if bf16 else
                {"wgmma": 0, "tf32x3": 2})
    assert by == [want_fwd, want_bwd, want_bwd]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 128, 256, 264, 384, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,q_off,kv_off", [
    (False, 0, 0), (True, 0, 0), (True, 17, 9)])
def test_flash_kernels_match_plain_on_the_card(dtype, causal, q_off, kv_off,
                                               d):
    """K2 in its three output modes, K3 + K4 (full and partials backward)
    against the plain versions, each row relative to its own scale, within
    chip_smoke.py's tolerances; one launch of each kernel per call, by the
    instance the head dim and dtypes pick (see _flash_case): every
    instance of each kernel, and K2–K4's wide kernels above d = 256, is
    held to the plain version."""
    _skip_without_card()
    sq, skv, h, b = 133, 201, 2, 3
    q, k, v = (_values(s, torch.float32, seed).div(100).to(dtype).cuda()
               for seed, s in enumerate([(sq, h, b, d), (skv, h, b, d),
                                         (skv, h, b, d)]))
    _flash_case(dtype, causal, q_off, kv_off, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_storage_offset_on_the_card(dtype):
    """k and v as views whose data starts 2 or 4 bytes past a 16-byte
    boundary: K2 and K3/K4's wgmma and tf32x3 instances copy them to an
    aligned allocation (counted), and every kernel agrees with its plain
    version."""
    _skip_without_card()
    sq, skv, h, b, d = 70, 150, 2, 3, 128
    q = _values((sq, h, b, d), torch.float32, 3).div(100).to(dtype).cuda()
    k, v = (_values((skv * h * b * d + 1,), torch.float32, seed).div(100)
            .to(dtype).cuda()[1:].view(skv, h, b, d) for seed in (4, 5))
    assert k.data_ptr() % 16 != 0
    copies = flash.realigned_copies
    _flash_case(dtype, True, 17, 9, q, k, v)
    # k and v: three K2 calls and every backward call (two in f32, three
    # in bf16)
    want = 12 if dtype == torch.bfloat16 else 10
    assert flash.realigned_copies - copies == want


@pytest.mark.cuda
def test_mixed_dtypes_launch_the_kernels():
    """flash_attention with q/k/v of mixed f32/bf16 dtypes takes K2–K4
    under impl="auto", and agrees with impl="plain", at each head dim of
    chip_smoke.MIXED_DIMS (K2 by its tf32x3 instance, up to d = 256 and
    by its wide kernel above, which must round P to bf16 for a bf16
    v)."""
    _skip_without_card()
    from chip_smoke import _mixed_check
    from pencilarrays_tpu_torch.models import attention

    errs = _mixed_check(torch, flash, attention)
    assert errs["fwd"] <= 2 ** -6 and errs["bwd"] <= 2 ** -6, errs


@pytest.mark.cuda
def test_span_seconds_is_device_time(tmp_path):
    """With observability on, ``span.seconds`` over a card-side sleep reads
    the sleep (timed apart with CUDA events), not its enqueue."""
    _skip_without_card()
    from pencilarrays_tpu_torch import obs
    from pencilarrays_tpu_torch.obs import metrics

    torch.cuda.init()
    cycles = 50_000_000
    torch.cuda._sleep(cycles)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    sleep_s = a.elapsed_time(b) / 1e3
    metrics.registry.reset()
    obs.enable(str(tmp_path))
    try:
        import time

        t0 = time.perf_counter()
        with obs.span("sleep"):
            torch.cuda._sleep(cycles)
        enqueue_s = time.perf_counter() - t0
        got = obs.snapshot()["histograms"]["span.seconds{label=sleep}"]
    finally:
        obs.disable()
        metrics.registry.reset()
    assert got["count"] == 1
    assert enqueue_s < 0.2 * sleep_s
    assert got["last"] == pytest.approx(sleep_s, rel=0.1)
